"""Host-side training orchestration around the training step.

The port of `gsjax.train.trainer` (the reference's `training()` loop,
reference: train.py:31-132): epoch-shuffled camera sampling, the SH degree
schedule, the densify/prune cadence, opacity resets, PLY saves,
checkpoints, test-set evaluation and TensorBoard logging, with gsjax's
host schedule: windows of steps between host events, each dispatched in
power-of-two chunks through `train_steps`, and one host sync per window.

Torch specifics:
* On the card a window replays one captured CUDA graph of the step
  (train/step.py). The graph reads and writes the state's tensors at
  fixed addresses, so densify and the opacity reset copy their results
  into those tensors at the same capacity; a capacity growth or a budget
  change drops the captured graphs, as gsjax drops its executables.
* The Gaussian buffers have a static capacity; when densification fills
  it, every per-Gaussian buffer is re-padded to a larger capacity (the
  reference reallocates its tensors every densify instead, reference:
  scene/gaussian_model.py:307-327).
* The densify split noise comes from a torch.Generator, whose state the
  checkpoints carry where gsjax's carry its jax.random key.
* `debug_from` turns on torch.autograd.set_detect_anomaly (the
  reference's own flag), which a graph cannot capture: from then on the
  windows run their steps eagerly.
* Renders (the viewer's frames, `render_view`, the held-out evaluation)
  replay captured CUDA graphs on the card, as gsjax jits them
  (render/graph.py), in a registry apart from the captured steps'; they
  read the state's tensors without writing any. On the CPU they run
  eagerly.
* The viewer (`gui`, a gsjax_torch.viewer.NetworkGUI) is polled at the
  top of each window, between graph replays.
* With a `mesh` (a ("data", "tile") DeviceMesh, gsjax_torch.parallel)
  every rank runs this loop on its own replica of the state: each window
  runs the mesh-sharded step, one camera per data group (on a CUDA mesh
  replays of its captured CUDA graph, parallel/step.py; on a CPU mesh,
  whose gloo collectives cannot be captured, a Python loop);
  every rank makes the same schedule, densify and reset decisions from the
  same seeds. Only rank 0 writes files (PLY, checkpoints, snapshots,
  TensorBoard), evaluates, prints and serves the viewer.
* Under OptimizationConfig's "mcmc" strategy (3DGS-MCMC, train/mcmc.py)
  the densify boundaries relocate the dead Gaussians and grow the count
  towards `cap_max` instead of cloning, splitting and pruning, and no
  opacity reset runs. The buffers are sized once to hold cap_max (the 3/4
  rule of the capacity growth) and never grow past it. The position noise
  and the relocation draw from the Trainer's generator (the densify
  generator); each relocation leaves a record in `events` with its counts
  and device ms. The mesh does not run it (ValueError).
* Not ported: the orbax checkpoint (`use_orbax`, ROADMAP §3); passing it
  raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import random
import time

import numpy as np
import torch

from gsjax_torch.config import (
    MIN_RASTER_BUDGET,
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    RasterConfig,
    pow2_budget,
)
from gsjax_torch.model import PARAM_NAMES, GaussianAux, pad_gaussian_params
from gsjax_torch.parallel.mesh import dim_size
from gsjax_torch.render.graph import eval_views, executed_launches, render_replayed
from gsjax_torch.train.checkpoint import load_checkpoint_extra, save_checkpoint
from gsjax_torch.train.densify import densify_and_prune, reset_opacity
from gsjax_torch.train.mcmc import capacity_for, relocate_and_grow
from gsjax_torch.train.optimizer import AdamState, adam_init
from gsjax_torch.train.step import (
    TrainState,
    copy_state_,
    drop_step_graphs,
    train_steps,
)
from gsjax_torch.utils.profiler import start_session, stop_session


def _pow2_chunks(n: int) -> list[int]:
    """Binary decomposition of a window length, largest chunk first
    (100 -> [64, 32, 4]): windows run as power-of-two chunks, so the set
    of window lengths ever built stays bounded."""
    out = []
    bit = 1 << max(n.bit_length() - 1, 0)
    while n:
        if n >= bit:
            out.append(bit)
            n -= bit
        bit >>= 1
    return out


@torch.no_grad()
def grow_capacity(state: TrainState, new_cap: int) -> TrainState:
    """Re-pad every per-Gaussian buffer to new_cap with the dead-slot fill.

    Returns a new state: a new GaussianParams module, new moment and aux
    tensors (zero moments and dead slots in the new rows), the same count
    and step; the old state's tensors are not modified. A new_cap no
    larger than the capacity returns the state as it is."""
    old = state.params.capacity
    extra = new_cap - old
    if extra <= 0:
        return state

    def pad(x: torch.Tensor, fill=0.0) -> torch.Tensor:
        out = x.new_full((new_cap, *x.shape[1:]), fill)
        out[:old] = x
        return out

    params = pad_gaussian_params(
        **{k: getattr(state.params, k).detach() for k in PARAM_NAMES}, capacity=new_cap)
    opt = AdamState(
        count=state.opt.count,
        mu={k: pad(v) for k, v in state.opt.mu.items()},
        nu={k: pad(v) for k, v in state.opt.nu.items()},
    )
    aux = GaussianAux(
        alive=pad(state.aux.alive, False),
        max_radii2d=pad(state.aux.max_radii2d),
        xyz_grad_accum=pad(state.aux.xyz_grad_accum),
        denom=pad(state.aux.denom),
    )
    return TrainState(params=params, opt=opt, aux=aux, step=state.step)


class Trainer:
    def __init__(
        self,
        scene,
        model_cfg: ModelConfig,
        opt_cfg: OptimizationConfig,
        pipe_cfg: PipelineConfig = PipelineConfig(),
        raster_cfg: RasterConfig | None = None,
        start_checkpoint: str | None = None,
        tb_writer=None,
        gui=None,
        quiet: bool = False,
        profile_dir: str | None = None,
        mesh=None,
        use_orbax: bool = False,
        split_seed: int = 0,
    ):
        if use_orbax or (start_checkpoint and os.path.isdir(start_checkpoint)):
            raise NotImplementedError(
                "orbax checkpoints are not ported (ROADMAP §3): use the npz form")
        dev = scene.params.device
        if mesh is not None and mesh.device_type != dev.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot train a scene on {dev}")
        if mesh is not None and opt_cfg.mcmc:
            raise ValueError("the mcmc densify strategy runs on one device: the mesh's "
                             "sharded step has no position noise or relocation")
        # Optional ("data", "tile") DeviceMesh: trains with the mesh-sharded
        # step (gsjax_torch/parallel/step.py) instead of train_steps.
        self.mesh = mesh
        self._sharded_cache: dict = {}
        # Rank 0 alone writes files, evaluates, prints and serves the viewer.
        self.is_main = mesh is None or mesh.get_rank() == 0
        self.scene = scene
        self.gui = gui if self.is_main else None
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.pipe_cfg = pipe_cfg
        self.raster_cfg = raster_cfg or RasterConfig()
        self.tb = tb_writer if self.is_main else None
        self.quiet = quiet or not self.is_main
        # torch.profiler trace window; steps 100..110 catch a steady-state
        # window past the first captures.
        self.profile_dir = profile_dir
        self._profile_window = (100, 110)
        self._profiler = None

        self.device = dev
        self.active_sh_degree = 0
        self.spatial_lr_scale = float(scene.cameras_extent)
        self.first_iter = 0

        restored_extra: dict = {}
        if start_checkpoint:
            state, sh_deg, lr_scale, restored_extra = load_checkpoint_extra(
                start_checkpoint, dev)
            self.state = state
            self.active_sh_degree = sh_deg
            self.spatial_lr_scale = lr_scale
            self.first_iter = int(state.step)
            self._say(f"Restored checkpoint at iteration {self.first_iter}")
        else:
            self.state = TrainState(
                params=scene.params,
                opt=adam_init(scene.params),
                aux=scene.aux,
                step=torch.zeros((), dtype=torch.int32, device=dev),
            )

        bgv = [1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0]
        self.background = torch.tensor(bgv, dtype=torch.float32, device=dev)
        self._background_host = torch.tensor(bgv, dtype=torch.float32)
        # What the run did, one record per window, densify, budget change
        # and evaluation (host bookkeeping; read by callers and reports).
        self.events: list[dict] = []
        self.banks = scene.get_train_banks()
        # Per-bank shuffled view stacks (popped from the END). A private
        # Random instance (not the global module) so its state can be
        # captured into checkpoints for exact resume parity.
        self._bank_stacks: list[list[int]] = [[] for _ in self.banks]
        self._shuffler = random.Random(0)
        self._rng = np.random.default_rng(0)
        self._budget_quiet_windows = 0
        self._budget_quiet_peaks = (0, 0)
        self._last_peaks = (0, 0)
        self._last_alive = 0
        # The densify split noise's source (gsjax: jax.random.PRNGKey(0));
        # split_seed picks another draw of it (0 is gsjax's seed).
        self._generator = torch.Generator(device=dev).manual_seed(split_seed)
        if restored_extra:
            self._restore_host_state(restored_extra)
        if opt_cfg.mcmc:
            self.state = grow_capacity(self.state, capacity_for(opt_cfg.cap_max))
        # Captured steps of another state or configuration are stale.
        drop_step_graphs()

    # ---------------------------------------------------------------- utils
    def _say(self, *args) -> None:
        if self.is_main:
            print(*args)

    def n_alive(self) -> int:
        return int(self.state.aux.n_alive())

    @torch.no_grad()
    def render_view(
        self,
        camera,
        scaling_modifier: float = 1.0,
        shs_python: bool | None = None,
        cov3d_python: bool | None = None,
        fast: bool = False,
    ) -> torch.Tensor:
        """One render through the public API (viewer, eval, TensorBoard),
        on the card a replay of the captured render of its key
        (render/graph.py; gsjax jits it per key). The *_python flags select
        the standalone mirror math paths (reference pipe.convert_SHs_python
        / compute_cov3D_python, gaussian_renderer/__init__.py:57-82) and
        default to the PipelineConfig's; fast=True renders with
        RasterConfig.fast_fwd (inference only, within 4e-3 of exact; the
        viewer's frames). The image belongs to the caller."""
        shs = self.pipe_cfg.convert_SHs_python if shs_python is None else shs_python
        cov = self.pipe_cfg.compute_cov3D_python if cov3d_python is None else cov3d_python
        cfg = dataclasses.replace(self.raster_cfg, fast_fwd=True) if fast else self.raster_cfg
        return render_replayed(
            self.state.params,
            camera,
            active_sh_degree=self.active_sh_degree,
            bg_color=self.background,
            cfg=cfg,
            scaling_modifier=scaling_modifier,
            alive=self.state.aux.alive,
            convert_shs_outside=shs,
            compute_cov3d_outside=cov,
        ).image

    # ------------------------------------------------------------- main loop
    def _next_boundary(self, it: int, events) -> int:
        """Last iteration (inclusive) of the window starting at it+1: the
        nearest upcoming event at which host-side work must run."""
        opt = self.opt_cfg
        cands = [opt.iterations]
        # SH schedule boundary: the bump applies to iteration k*1000 itself
        # (reference: train.py:71-73), so windows must END at k*1000 - 1 —
        # but only while the ramp is still running.
        if self.active_sh_degree < self.state.params.max_sh_degree:
            cands.append((it // 1000 + 1) * 1000 - 1)
        if it < opt.densify_until_iter:
            d = opt.densification_interval
            cands.append((it // d + 1) * d)
            if not opt.mcmc:
                r = opt.opacity_reset_interval
                cands.append((it // r + 1) * r)
            cands.append(opt.densify_from_iter)
            cands.append(opt.densify_until_iter)
        cands.extend(e for e in events if e > it)
        if self.profile_dir is not None:
            cands.extend(w for w in self._profile_window if w > it)
        return min(c for c in cands if c > it)

    def _next_window(self, max_len: int) -> tuple[int, list[int]]:
        """Pop up to max_len views from ONE bank of the epoch stacks: the
        bank with probability proportional to its remaining views, then
        the window from that bank's shuffled stack (gsjax's window-level
        form of the reference's pop-one-random-view, train.py:76-78)."""
        if not any(self._bank_stacks):
            self._next_view_refill()
        nonempty = [b for b, s in enumerate(self._bank_stacks) if s]
        if len(nonempty) == 1:
            bank_idx = nonempty[0]
        else:
            bank_idx = self._shuffler.choices(
                nonempty,
                weights=[len(self._bank_stacks[b]) for b in nonempty],
            )[0]
        stack = self._bank_stacks[bank_idx]
        cams = [stack.pop() for _ in range(min(max_len, len(stack)))]
        return bank_idx, cams

    def _next_view_refill(self) -> None:
        self._bank_stacks = []
        for bank in self.banks:
            idxs = list(range(bank.count))
            self._shuffler.shuffle(idxs)
            self._bank_stacks.append(idxs)

    def _host_state_snapshot(self) -> dict:
        """Host-side training state that exact resume parity needs beyond
        the device TrainState: the densify generator, the background/bank
        RNGs, the mid-epoch camera stacks and the adaptive raster budgets.
        The numpy RNG and the shuffler are pickled as gsjax pickles them."""
        flat = [
            (b, i) for b, stack in enumerate(self._bank_stacks) for i in stack
        ]
        return {
            "generator": self._generator.get_state().numpy(),
            "np_rng": np.frombuffer(
                pickle.dumps(self._rng.bit_generator.state), np.uint8
            ),
            "shuffler": np.frombuffer(
                pickle.dumps(self._shuffler.getstate()), np.uint8
            ),
            "stacks": np.asarray(flat, np.int32).reshape(-1, 2),
            "budgets": np.asarray(
                [
                    self.raster_cfg.max_instances,
                    self.raster_cfg.max_rows,
                    self._budget_quiet_windows,
                    self._budget_quiet_peaks[0],
                    self._budget_quiet_peaks[1],
                    self._last_peaks[0],
                    self._last_peaks[1],
                    self._last_alive,
                ],
                np.int64,
            ),
        }

    def _restore_host_state(self, extra: dict) -> None:
        if "generator" in extra:
            self._generator.set_state(torch.from_numpy(np.array(extra["generator"])))
        elif "key" in extra:
            self._say("checkpoint holds a jax.random key: the densify generator "
                      "starts from seed 0")
        if "np_rng" in extra:
            self._rng.bit_generator.state = pickle.loads(
                extra["np_rng"].tobytes()
            )
        if "shuffler" in extra:
            self._shuffler.setstate(pickle.loads(extra["shuffler"].tobytes()))
        if "stacks" in extra:
            flat = np.asarray(extra["stacks"]).reshape(-1, 2)
            self._bank_stacks = [
                [int(i) for b2, i in flat if b2 == b]
                for b in range(len(self.banks))
            ]
        if "budgets" in extra:
            bud = np.asarray(extra["budgets"])
            self.raster_cfg = dataclasses.replace(
                self.raster_cfg,
                max_instances=int(bud[0]),
                max_rows=int(bud[1]),
            )
            self._budget_quiet_windows = int(bud[2])
            self._budget_quiet_peaks = (int(bud[3]), int(bud[4]))
            if bud.shape[0] >= 8:
                self._last_peaks = (int(bud[5]), int(bud[6]))
                self._last_alive = int(bud[7])

    def _save_checkpoint(self, path: str) -> None:
        save_checkpoint(
            path,
            self.state,
            self.active_sh_degree,
            self.spatial_lr_scale,
            extra=self._host_state_snapshot(),
        )

    def _sharded_steps_for(self, bank):
        """The mesh-sharded window of steps per (resolution, raster
        config); the SH degree is passed at call time."""
        from gsjax_torch.parallel.step import make_sharded_train_steps

        key = (bank.width, bank.height, self.raster_cfg)
        if key not in self._sharded_cache:
            self._sharded_cache[key] = make_sharded_train_steps(
                self.mesh,
                height=bank.height,
                width=bank.width,
                active_sh_degree=self.active_sh_degree,
                opt_cfg=self.opt_cfg,
                raster_cfg=self.raster_cfg,
                spatial_lr_scale=self.spatial_lr_scale,
            )
        return self._sharded_cache[key]

    def _mesh_window(self, bank, cams: list[int], bgs: torch.Tensor, w: int):
        """w sharded steps on the views cams ([w*b], b per step, one per data
        group) of one bank; returns the per-step metrics stacked to [w]
        (gsjax/train/trainer.py:527-554)."""
        b = len(cams) // w
        dev = self.device
        idxs = torch.as_tensor(cams, dtype=torch.long, device=dev)
        gt = bank.gt_rgb[idxs].to(torch.float32) / 255.0
        gt = torch.clamp(gt, 0.0, 1.0) * (bank.alpha[idxs].to(torch.float32) / 255.0)

        def wb(x):  # [w*b, ...] -> [w, b, ...]
            return x.reshape((w, b) + tuple(x.shape[1:]))

        steps_fn = self._sharded_steps_for(bank)
        self.state, m = steps_fn(
            self.state,
            wb(bank.views[idxs]),
            wb(bank.full_projs[idxs]),
            wb(bank.centers[idxs]),
            wb(bank.tan_fovx[idxs]),
            wb(bank.tan_fovy[idxs]),
            wb(gt),
            bgs,
            self.active_sh_degree,
        )
        return m

    def _window_backgrounds(self, w: int) -> torch.Tensor:
        if self.opt_cfg.random_background:
            return torch.as_tensor(self._rng.random((w, 3)), dtype=torch.float32)
        return self._background_host.expand(w, 3)

    def train(
        self,
        test_iterations=(7_000, 30_000),
        save_iterations=(7_000, 30_000),
        checkpoint_iterations=(),
        debug_from: int = -1,
        max_window: int = 50,
    ) -> None:
        opt = self.opt_cfg
        iters = opt.iterations
        ema_loss = 0.0
        # --debug_from (reference: train.py:81-82 flips pipe.debug on from
        # this iteration): anomaly detection from the window that begins
        # there; window boundaries land on events so it starts on time.
        events = sorted(
            set(test_iterations)
            | set(save_iterations)
            | set(checkpoint_iterations)
            | ({debug_from} if debug_from >= 0 else set())
        )
        if 0 <= debug_from <= self.first_iter:
            torch.autograd.set_detect_anomaly(True)
        try:
            from tqdm import tqdm

            progress = tqdm(
                range(self.first_iter, iters),
                desc="Training progress",
                disable=self.quiet,
            )
        except ImportError:
            progress = None

        iteration = self.first_iter
        while iteration < iters:
            self._poll_gui(iteration + 1, iters)

            # SH degree schedule: the next step is iteration+1; bump when it
            # crosses a multiple of 1000 (reference: train.py:71-73).
            if (iteration + 1) % 1000 == 0:
                if self.active_sh_degree < self.state.params.max_sh_degree:
                    self.active_sh_degree += 1

            end = min(self._next_boundary(iteration, events), iters)
            if self.mesh is None:
                bank_idx, cams = self._next_window(min(max_window, end - iteration))
                w = len(cams)
            else:
                # Mesh path: each step takes a batch of b same-bank cameras
                # (b = the mesh's "data" size; b = 1, w = 1 is the
                # reference loop). w is rounded down to a power of two, as
                # gsjax's compiled scan lengths are.
                b = dim_size(self.mesh, "data")
                w = min(max_window, end - iteration)
                w = 1 << (w.bit_length() - 1)
                bank_idx, cams = self._next_window(w * b)
                if len(cams) < w * b:  # cycle-pad a short epoch tail
                    cams = (cams * (-(-(w * b) // len(cams))))[: w * b]
            bank = self.banks[bank_idx]
            bgs = self._window_backgrounds(w)

            t0 = time.perf_counter()
            if self.mesh is not None:
                parts = [self._mesh_window(bank, cams, bgs, w)]
            else:
                # Power-of-two chunks, as gsjax dispatches its scans: the
                # schedule is the same, whatever each chunk costs here.
                parts = []
                off = 0
                for c in _pow2_chunks(w):
                    self.state, m = train_steps(
                        self.state,
                        bank,
                        torch.as_tensor(cams[off:off + c], dtype=torch.int32),
                        bgs[off:off + c],
                        active_sh_degree=self.active_sh_degree,
                        opt_cfg=opt,
                        raster_cfg=self.raster_cfg,
                        spatial_lr_scale=self.spatial_lr_scale,
                        **({"generator": self._generator} if opt.mcmc else {}),
                    )
                    parts.append(m)
                    off += c
            # The window's one host sync: its stacked metrics.
            metrics = {
                k: torch.cat([getattr(p, k) for p in parts]).cpu().numpy()
                for k in ("loss", "l1", "num_instances", "num_rows")
            }
            losses = metrics["loss"]
            dt = time.perf_counter() - t0
            self.events.append({"window": iteration + 1, "steps": w, "bank": bank_idx,
                                "ms": dt * 1e3})
            if not np.isfinite(losses[-1]):
                # Debug snapshot on failure (reference: README.md:143-146):
                # persist the state for offline replay.
                path = os.path.join(
                    self.scene.model_path or ".",
                    f"snapshot_it{iteration + w}.npz",
                )
                if self.is_main:
                    save_checkpoint(
                        path, self.state, self.active_sh_degree, self.spatial_lr_scale
                    )
                raise FloatingPointError(
                    f"non-finite loss in window ending at {iteration + w}; "
                    f"state dumped to {path}"
                )

            self._maybe_adapt_budgets(
                iteration + w,
                int(np.max(metrics["num_instances"])),
                int(np.max(metrics["num_rows"])),
            )

            for k in range(w):
                it_k = iteration + 1 + k
                ema_loss = 0.4 * float(losses[k]) + 0.6 * ema_loss
                if self.tb is not None:
                    self.tb.add_scalar(
                        "train_loss_patches/l1_loss", float(metrics["l1"][k]), it_k
                    )
                    self.tb.add_scalar(
                        "train_loss_patches/total_loss", float(losses[k]), it_k
                    )
                    self.tb.add_scalar("iter_time", dt / w * 1000.0, it_k)
            if progress is not None:
                progress.set_postfix({"Loss": f"{ema_loss:.7f}"})
                progress.update(w)

            iteration += w
            # Host work at this iteration, ms by kind (for the record).
            work: dict[str, float] = {}
            t_host = time.perf_counter()

            def done(kind):
                nonlocal t_host
                now = time.perf_counter()
                work[kind] = (now - t_host) * 1e3
                t_host = now

            # Held-out evaluation runs BEFORE densify/opacity-reset at the
            # same iteration (reference: training_report at train.py:105
            # precedes densification at :113-123).
            if iteration in test_iterations and self.is_main:
                self._report_test(
                    iteration, first_test=iteration == min(test_iterations)
                )
                done("test")
            if iteration in save_iterations and self.is_main:
                print(f"\n[ITER {iteration}] Saving Gaussians")
                self.scene.save(
                    iteration, self.state.params, self.state.aux.alive
                )
                done("save")

            # Densification (reference: train.py:113-123); under "mcmc"
            # relocation and growth at the same boundaries, no reset
            # (3dgs-mcmc train.py).
            if iteration < opt.densify_until_iter and opt.mcmc:
                if (
                    iteration > opt.densify_from_iter
                    and iteration % opt.densification_interval == 0
                ):
                    self._relocate(iteration)
                    done("relocate")
            elif iteration < opt.densify_until_iter:
                if (
                    iteration > opt.densify_from_iter
                    and iteration % opt.densification_interval == 0
                ):
                    self._densify(iteration)
                    done("densify")
                if iteration % opt.opacity_reset_interval == 0 or (
                    self.model_cfg.white_background
                    and iteration == opt.densify_from_iter
                ):
                    params, optst = reset_opacity(self.state.params, self.state.opt)
                    self._assign(TrainState(
                        params=params, opt=optst, aux=self.state.aux,
                        step=self.state.step))
                    done("reset")

            if 0 <= debug_from <= iteration:
                torch.autograd.set_detect_anomaly(True)

            if self.profile_dir is not None and self.is_main:
                self._profile_at(iteration)

            if iteration in checkpoint_iterations and self.is_main:
                print(f"\n[ITER {iteration}] Saving Checkpoint")
                self._save_checkpoint(
                    os.path.join(self.scene.model_path, f"chkpnt{iteration}.npz")
                )
                done("checkpoint")
            if work:
                self.events.append({"host": iteration, "ms": work})
        if progress is not None:
            progress.close()
        if self._profiler is not None:  # the run ended inside the window
            self._close_profile(iteration)

    def _poll_gui(self, iteration: int, total_iters: int) -> None:
        """Viewer polling (reference: train.py:52-66): connect if no client
        is connected, then serve its requests until one asks to train (and
        the run is not over, or the client does not keep it alive); any
        error drops the connection."""
        gui = self.gui
        if gui is None:
            return
        if gui.conn is None:
            gui.try_connect()
        while gui.conn is not None:
            try:
                image_bytes = None
                req = gui.receive(self.device)
                if req.camera is not None:
                    img = self.render_view(
                        req.camera,
                        req.scaling_modifier,
                        shs_python=req.do_shs_python,
                        cov3d_python=req.do_rot_scale_python,
                        fast=True,
                    )
                    image_bytes = gui.image_to_bytes(img)
                gui.send(image_bytes, self.model_cfg.source_path)
                if req.do_training and (iteration < total_iters or not req.keep_alive):
                    break
            except Exception:
                gui.drop()

    def _profile_at(self, iteration: int) -> None:
        """A torch.profiler trace of the windows from step 100 to 110,
        written to profile_dir as a Chrome trace. The session opens with
        the port's warm-up step (utils/profiler.start_session); its record
        in `events` holds the iterations it covered, the trace's path and
        the kernel launches the port executed while it recorded (the trace
        holds as many events of each kernel)."""
        from torch.profiler import ProfilerActivity

        lo, hi = self._profile_window
        if self._profiler is None and lo <= iteration < hi:
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = start_session(activities)
            self._profile_open = (iteration, executed_launches())
        elif self._profiler is not None and iteration >= hi:
            self._close_profile(iteration)

    def _close_profile(self, iteration: int) -> None:
        stop_session(self._profiler)
        lo, hi = self._profile_window
        path = os.path.join(self.profile_dir, f"trace_{lo}_{hi}.json")
        os.makedirs(self.profile_dir, exist_ok=True)
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        start, before = self._profile_open
        self.events.append({
            "profile": [start, iteration], "trace": path,
            "launches": {k: n - before[k] for k, n in executed_launches().items()}})

    # ------------------------------------------------------------- internals
    def _assign(self, new: TrainState) -> None:
        """Take `new` as the state: copied into the current state's
        tensors at the same capacity (a captured step keeps reading them);
        otherwise the new tensors, and the captured steps are dropped."""
        if new.params.capacity == self.state.params.capacity:
            copy_state_(self.state, new)
        else:
            self.state = new
            drop_step_graphs()

    def _densify(self, iteration: int) -> None:
        opt = self.opt_cfg
        size_threshold = (
            20 if iteration > opt.opacity_reset_interval else 0
        )  # reference: train.py:119
        # Skysphere mode: distance-scaled world-size prune threshold so the
        # far shell survives (see densify_and_prune's unbounded_center).
        center = None
        if getattr(self.model_cfg, "sky_gaussians", 0) > 0:
            center = torch.as_tensor(
                np.asarray(self.scene.scene_center, np.float32), device=self.device)
        params, aux, optst, stats = densify_and_prune(
            self.state.params,
            self.state.aux,
            self.state.opt,
            self._generator,
            unbounded_center=center,
            grad_threshold=opt.densify_grad_threshold,
            min_opacity=0.005,
            extent=float(self.scene.cameras_extent),
            max_screen_size=size_threshold,
            percent_dense=opt.percent_dense,
        )
        self._assign(TrainState(params=params, opt=optst, aux=aux, step=self.state.step))
        n_alive = int(stats.n_alive)
        n_dropped = int(stats.n_dropped)
        cap = self.state.params.capacity
        self.events.append({"densify": iteration, "capacity": cap, **{
            k: int(getattr(stats, k))
            for k in ("n_alive", "n_cloned", "n_split", "n_pruned", "n_dropped")}})
        if n_alive > 0.75 * cap or n_dropped > 0:
            new_cap = max(cap * 2, 1024)
            self._say(
                f"\n[ITER {iteration}] growing capacity {cap} -> {new_cap} "
                f"(alive={n_alive}, dropped={n_dropped})"
            )
            self.events.append({"grow": iteration, "from": cap, "to": new_cap})
            self._assign(grow_capacity(self.state, new_cap))
        self._post_densify_budget_check(iteration, n_alive)

    def _relocate(self, iteration: int) -> None:
        """3DGS-MCMC's relocation and growth (train/mcmc.py) on the state's
        tensors, timed on the device by CUDA events around both."""
        st = self.state
        cuda = self.device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        _, counts = relocate_and_grow(st.params, st.aux, st.opt, cap_max=self.opt_cfg.cap_max,
                                      generator=self._generator)
        if cuda:
            ev[1].record()
            ev[1].synchronize()
            ms = ev[0].elapsed_time(ev[1])
        else:
            ms = (time.perf_counter() - t0) * 1e3
        self.events.append({"relocate": iteration, **counts, "device_ms": ms})
        self._post_densify_budget_check(iteration, counts["n_alive"])

    def _maybe_adapt_budgets(
        self, iteration: int, peak_inst: int, peak_rows: int
    ) -> None:
        """Keep the static instance/row budgets sized to the scene
        (gsjax/train/trainer.py:689-775, the same thresholds). GROW
        PROACTIVELY at 60% occupancy: a window that actually overflows
        drops its deepest (gaussian, tile) pairs before the grow can react.
        SHRINK only after 50 windows of deep underuse, to 4x the stretch's
        peak, and never while densification is active. Either change drops
        the captured steps (one capture each)."""
        self._last_peaks = (peak_inst, peak_rows)
        cfg = self.raster_cfg
        if peak_inst > cfg.max_instances or peak_rows > cfg.max_rows:
            print(
                f"\n[ITER {iteration}] raster budget OVERFLOW "
                f"(peaks {peak_inst}/{peak_rows} vs "
                f"{cfg.max_instances}/{cfg.max_rows}) — deepest pairs of "
                "the overflowing window were dropped; growing"
            )
        new_inst, new_rows = cfg.max_instances, cfg.max_rows
        if peak_inst > 0.6 * cfg.max_instances:
            new_inst = pow2_budget(peak_inst * 2)
        if peak_rows > 0.6 * cfg.max_rows:
            new_rows = pow2_budget(peak_rows * 2)
        if new_inst == cfg.max_instances and new_rows == cfg.max_rows:
            densifying = iteration < self.opt_cfg.densify_until_iter
            underused = not densifying and (
                (
                    peak_inst < 0.35 * cfg.max_instances
                    and cfg.max_instances > MIN_RASTER_BUDGET
                ) or (
                    peak_rows < 0.35 * cfg.max_rows
                    and cfg.max_rows > MIN_RASTER_BUDGET
                )
            )
            self._budget_quiet_peaks = (
                (
                    max(self._budget_quiet_peaks[0], peak_inst),
                    max(self._budget_quiet_peaks[1], peak_rows),
                )
                if underused
                else (0, 0)
            )
            self._budget_quiet_windows = (
                self._budget_quiet_windows + 1 if underused else 0
            )
            if self._budget_quiet_windows >= 50:
                # Size from the max over the whole quiet stretch, not just
                # the last window, so a fluctuating peak doesn't re-grow.
                new_inst = min(
                    pow2_budget(self._budget_quiet_peaks[0], headroom=4.0),
                    cfg.max_instances,
                )
                new_rows = min(
                    pow2_budget(self._budget_quiet_peaks[1], headroom=4.0),
                    cfg.max_rows,
                )
                self._budget_quiet_windows = 0
                self._budget_quiet_peaks = (0, 0)
        self._apply_budgets(
            iteration, new_inst, new_rows,
            f"peaks {peak_inst}/{peak_rows}",
        )

    def _apply_budgets(
        self, iteration: int, new_inst: int, new_rows: int, why: str
    ) -> None:
        cfg = self.raster_cfg
        if (new_inst, new_rows) == (cfg.max_instances, cfg.max_rows):
            return
        print(
            f"\n[ITER {iteration}] raster budgets {cfg.max_instances}/"
            f"{cfg.max_rows} -> {new_inst}/{new_rows} ({why})"
        )
        self.raster_cfg = dataclasses.replace(
            cfg, max_instances=new_inst, max_rows=new_rows
        )
        self.events.append({"budgets": iteration, "from": [cfg.max_instances, cfg.max_rows],
                            "to": [new_inst, new_rows], "why": why})
        # The captured steps of the outgrown config are stale.
        drop_step_graphs()

    def _post_densify_budget_check(self, iteration: int, n_alive: int) -> None:
        """Densify adds points BETWEEN windows, so the next window's peaks
        jump: scale the last window's peaks by the alive-count growth (x1.2
        margin) and grow NOW if the estimate crowds the budget
        (gsjax/train/trainer.py:799-823)."""
        prev = self._last_alive or n_alive
        self._last_alive = n_alive
        if prev <= 0:
            return
        ratio = n_alive / prev
        est_inst = int(self._last_peaks[0] * ratio * 1.2)
        est_rows = int(self._last_peaks[1] * ratio * 1.2)
        cfg = self.raster_cfg
        new_inst, new_rows = cfg.max_instances, cfg.max_rows
        if est_inst > 0.6 * cfg.max_instances:
            new_inst = pow2_budget(est_inst * 2)
        if est_rows > 0.6 * cfg.max_rows:
            new_rows = pow2_budget(est_rows * 2)
        self._apply_budgets(
            iteration, new_inst, new_rows,
            f"post-densify estimate {est_inst}/{est_rows}, "
            f"alive {prev} -> {n_alive}",
        )

    def _eval_bank(self, bank, idxs: list[int]) -> tuple[list[float], list[float]]:
        """Per-view (l1, psnr) of the clipped renders of views idxs of a
        bank against their ground truths, read back in one transfer (on
        the card replays of one captured evaluation per key, gsjax's
        `_eval_bank_fn`)."""
        both = eval_views(
            self.state.params, self.state.aux.alive, bank, idxs,
            bg_color=self.background, active_sh_degree=self.active_sh_degree,
            cfg=self.raster_cfg, convert_shs_outside=self.pipe_cfg.convert_SHs_python,
            compute_cov3d_outside=self.pipe_cfg.compute_cov3D_python,
        ).cpu()
        return both[0].tolist(), both[1].tolist()

    def _report_test(self, iteration: int, first_test: bool = False) -> None:
        """Held-out evaluation (reference: train.py:156-191)."""
        for name, banks in (
            ("test", self.scene.get_test_banks()),
            ("train", self.banks),
        ):
            views = [
                (b, i) for b, bank in enumerate(banks) for i in range(bank.count)
            ]
            if name == "train":
                views = views[:: max(len(views) // 5, 1)][:5]
            if not views:
                continue
            l1s, psnrs = [], []
            for b, bank in enumerate(banks):
                idxs = [i for bb, i in views if bb == b]
                if idxs:
                    bl1, bps = self._eval_bank(bank, idxs)
                    l1s += bl1
                    psnrs += bps
            # TB images: first-5 renders, GT once at the first test
            # iteration (reference: train.py:176-179).
            if self.tb is not None:
                for b, i in views[:5]:
                    cam, gt = banks[b].pick(torch.tensor(i, device=self.device))
                    img = torch.clamp(self.render_view(cam), 0.0, 1.0)
                    self.tb.add_images(
                        f"{name}_view_{b}_{i}/render",
                        img.cpu().numpy()[None],
                        global_step=iteration,
                    )
                    if first_test:
                        self.tb.add_images(
                            f"{name}_view_{b}_{i}/ground_truth",
                            torch.clamp(gt, 0.0, 1.0).cpu().numpy()[None],
                            global_step=iteration,
                        )
            l1 = float(np.mean(l1s))
            ps = float(np.mean(psnrs))
            self._say(
                f"\n[ITER {iteration}] Evaluating {name}: L1 {l1:.6f} PSNR {ps:.3f}"
            )
            self.events.append({"eval": name, "iteration": iteration, "l1": l1,
                                "psnr": ps, "points": self.n_alive()})
            if self.tb is not None:
                self.tb.add_scalar(f"{name}/loss_viewpoint - l1_loss", l1, iteration)
                self.tb.add_scalar(f"{name}/loss_viewpoint - psnr", ps, iteration)
        if self.tb is not None:
            # Opacity histogram over live Gaussians + total points
            # (reference: train.py:188-189).
            alive = self.state.aux.alive.cpu().numpy()
            opac = self.state.params.get_opacity().detach().cpu().numpy().reshape(-1)
            self.tb.add_histogram(
                "scene/opacity_histogram", opac[alive], iteration
            )
            self.tb.add_scalar("total_points", self.n_alive(), iteration)
