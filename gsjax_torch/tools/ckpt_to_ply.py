"""Export an npz training checkpoint to the reference PLY: the counterpart
of the repository's tools/ckpt_to_ply.py.

The trainer writes point_cloud/iteration_*/point_cloud.ply only at its
save iterations; a run's newest state lives in its chkpnt*.npz. This
loads one (train/checkpoint.load_checkpoint) and writes its live
Gaussians (data/ply.save_gaussian_ply) to
<out_dir>/point_cloud/iteration_<step>/point_cloud.ply, which
tools.bench_trained and profile_stages --ply read. The orbax form is not
ported.

    python -m gsjax_torch.tools.ckpt_to_ply <chkpnt.npz> <out_dir> [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def export(checkpoint: str, out_dir: str, device=None) -> str:
    """Write the checkpoint's live Gaussians as
    <out_dir>/point_cloud/iteration_<step>/point_cloud.ply, the state
    loaded on `device` (default CUDA); returns the path."""
    from gsjax_torch.data.ply import save_gaussian_ply
    from gsjax_torch.train.checkpoint import load_checkpoint

    state, _, _ = load_checkpoint(checkpoint, device)
    step = int(state.step)
    path = os.path.join(out_dir, "point_cloud", f"iteration_{step}", "point_cloud.ply")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_gaussian_ply(path, state.params, alive=state.aux.alive)
    print(f"wrote {path} ({int(state.aux.alive.sum())} gaussians, step {step})")
    return path


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint")
    ap.add_argument("out_dir")
    ap.add_argument("--device", default=None, help="where to load it (default CUDA)")
    args = ap.parse_args(argv)
    return export(args.checkpoint, args.out_dir, args.device)


if __name__ == "__main__":
    main()
