"""Whether torch.profiler sessions on the card record every kernel launch
of the port, before and after a given sequence of the trainer's own calls
(fault F4 of ROADMAP.md: sessions after a trainer run in the same process
lost kernel events).

    python -m gsjax_torch.tools.probe_profiler [--before STEPS] [--sessions N]
        [--pad_ms MS] [--lead_in N] [--warmup N] [--port]

Run from the repository root: the `trainer` step drives chip_smoke.py's
trainer phase. STEPS is a comma list, run in order before the sessions:

  trainer       chip_smoke's trainer phase (cli.train for 300 iterations with
                --eval and the viewer, cli.render, cli.metrics, the resumed
                run, bench_trained)
  cli_train     cli.train alone, with that phase's flags
  no_viewer     cli_train without the viewer
  no_eval       cli_train without --eval and its test
  profile_dir   cli_train with --profile_dir: its trace's kernel events
                against the launches of the windows it covered
  captures:K    K captures of the bench step, each dropping the one before
  session       one profiler session over an eager render
  safe_state    the CLIs' safe_state (seeds, stdout)

Then N sessions of one window of 10 replays of the captured bench step and
N sessions of 20 calls of composite_forward on the bench view's instance
stream (bench.py's scene: 500k Gaussians at 1920x1080). For each session
the device events of each main kernel against the launches the port
counted while it was open (tools/common.port_launches), read from the
profiler's raw Kineto events and from its event list, the session's
timing and the launch calls whose kernel has no event (see `session`).
The profiler's environment (TEARDOWN_CUPTI, DISABLE_CUPTI_LAZY_REINIT)
is the caller's. `--port` takes each session as the port's readers do
(tools/common.whole_session: the warm-up step, then the check) and
records whether it was whole. One JSON line per session and a summary
line a form. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from gsjax_torch.tools.common import (
    DEVICE_KERNELS,
    bench_scene,
    instance_stream,
    kernel_events,
    port_launches,
    replayed_train_steps,
    require_card,
)

WINDOW_STEPS = 10
EAGER_CALLS = 20
PROFILE_ENV = ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT")
LEAD_IN_KERNEL = "spin_kernel"  # torch.cuda._sleep's


def session(fn, reps: int, pad_ms: float = 0.0, lead_in: int = 0,
            warmup: int = 0) -> dict:
    """One profiler session (CUDA and CPU activity) over `reps` runs of
    fn(), the host idle `pad_ms` after the session opens and before it
    closes: per main kernel the launches the port counted and the events
    recorded (raw Kineto events and the profiler's event list), whether
    every count agrees, and the timing of the session's device events
    against the host: the first kernel's start after the session's start
    and after the host's first launch (negative: the card's timestamps
    run early), and the launch calls (runtime events) whose kernel has no
    event, by their index in launch order. With `warmup`, that many short
    spin kernels run (the card synchronized) in a warm-up step of the
    profiler's schedule before the recorded one; with `lead_in`, that many
    run at the start of the recorded step, before fn's launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def spin(n):
        for _ in range(n):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    sched = schedule(wait=0, warmup=1, active=1, repeat=1) if warmup else None
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        if warmup:
            spin(warmup)
            prof.step()
        spin(lead_in)
        before = port_launches()
        time.sleep(pad_ms / 1e3)
        first_launch_ns = time.time_ns()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_ms / 1e3)
        if warmup:
            prof.step()
    launched = {k: n - before[k] for k, n in port_launches().items()}
    events = prof.profiler.kineto_results.events()
    device = [r for r in events if r.device_type() == DeviceType.CUDA]
    raw = [r.name() for r in device]
    listed = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    raw_k, listed_k = kernel_events(raw), kernel_events(listed)
    kernels = [k for k in DEVICE_KERNELS if launched[k] or raw_k[k]]
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ours = [r.start_ns() for r in device
            if any(DEVICE_KERNELS[k] in r.name() for k in kernels)]
    launches = sorted((r for r in events if r.device_type() == DeviceType.CPU
                       and ("LaunchKernel" in r.name() or "GraphLaunch" in r.name())),
                      key=lambda r: r.start_ns())
    done = {r.correlation_id() for r in device}
    return {"launched": {k: launched[k] for k in kernels},
            "raw": {k: raw_k[k] for k in kernels},
            "listed": {k: listed_k[k] for k in kernels},
            "raw_events": len(raw), "listed_events": len(listed),
            "whole": all(raw_k[k] == launched[k] == listed_k[k] for k in DEVICE_KERNELS),
            "first_kernel_after_start_us": (min(ours) - start_ns) / 1e3 if ours else None,
            "first_kernel_after_host_launch_us":
                (min(ours) - first_launch_ns) / 1e3 if ours else None,
            "launch_calls": len(launches),
            "launches_without_kernel": [i for i, r in enumerate(launches)
                                        if r.correlation_id() not in done],
            "lead_in_events": sum(LEAD_IN_KERNEL in n for n in raw),
            "pad_ms": pad_ms, "lead_in": lead_in, "warmup": warmup,
            "seconds": time.perf_counter() - t0}


def port_session(fn, reps: int) -> dict:
    """One session as the port takes it (tools/common.whole_session) over
    `reps` runs of fn(): whether it was whole, its main kernels' events,
    or the error that refused it."""
    from gsjax_torch.tools.common import IncompleteSession, device_event_names, whole_session

    t0 = time.perf_counter()
    try:
        with whole_session() as prof:
            for _ in range(reps):
                fn()
    except IncompleteSession as e:
        return {"whole": False, "error": str(e), "seconds": time.perf_counter() - t0}
    seen = kernel_events(device_event_names(prof))
    return {"whole": True, "raw": {k: n for k, n in seen.items() if n},
            "seconds": time.perf_counter() - t0}


def cli_argv(data: str, model: str, iterations: int, *, evaluate=True,
             profile_dir=None) -> list[str]:
    """chip_smoke's trainer phase's cli.train flags."""
    argv = ["-s", data, "-m", model, "-r", "1", "--quiet",
            "--iterations", str(iterations), "--densify_from_iter", "100",
            "--densification_interval", "100", "--opacity_reset_interval", "200",
            "--save_iterations", str(iterations),
            "--checkpoint_iterations", "200", str(iterations), "--port", "0"]
    if evaluate:
        argv += ["--eval", "--test_iterations", str(iterations)]
    else:
        argv += ["--test_iterations", str(iterations + 1)]
    if profile_dir is not None:
        argv += ["--profile_dir", profile_dir]
    return argv


def run_cli_train(params, root: str, *, viewer=True, evaluate=True, profile=False) -> dict:
    """cli.train through its main on chip_smoke's COLMAP dataset of the
    bench scene (without TensorBoard); with `profile`, the --profile_dir
    trace's kernel events against the launches its window recorded."""
    import chip_smoke
    from gsjax_torch.cli import train as train_cli
    from gsjax_torch.render.api import render
    from gsjax_torch.synthetic import orbit_camera
    from gsjax_torch.tools import trace

    data = os.path.join(root, "data")
    if not os.path.isdir(data):
        views = [orbit_camera(a, width=chip_smoke.BENCH_W, height=chip_smoke.BENCH_H,
                              device=params.device) for a in chip_smoke.SCENE_ANGLES]
        chip_smoke.write_colmap_scene(torch, data, params, views, render)
    model = os.path.join(root, f"model{len(os.listdir(root))}")
    prof_dir = os.path.join(model, "profile") if profile else None
    argv = cli_argv(data, model, chip_smoke.TRAINER_ITERATIONS, evaluate=evaluate,
                    profile_dir=prof_dir)
    real_gui = train_cli.NetworkGUI
    if not viewer:
        def no_gui(*_):
            raise OSError("the viewer is off in this probe")
        train_cli.NetworkGUI = no_gui
    try:
        with chip_smoke.without_tensorboard():
            trainer = train_cli.main(argv)
    finally:
        train_cli.NetworkGUI = real_gui
    out = {"windows": sum("window" in e for e in trainer.events),
           "viewer": trainer.gui is not None}
    if profile:
        rec = next(e for e in trainer.events if "profile" in e)
        names = trace.chrome_trace_kernels(rec["trace"])
        seen = kernel_events(names)
        out["profile"] = {"iterations": rec["profile"], "launched": rec["launches"],
                          "trace": {k: seen[k] for k in rec["launches"]},
                          "trace_kernel_events": len(names),
                          "whole": all(seen[k] == n for k, n in rec["launches"].items())}
    return out


def run_before(step: str, params, aux, camera, cfg, root: str) -> dict:
    import numpy as np

    import chip_smoke

    if step == "trainer":
        from gsjax_torch.render.api import render
        from gsjax_torch.render import kernels

        lpips = os.path.join(root, "lpips_vgg.npz")
        np.savez(lpips, **chip_smoke.lpips_random_weights(
            np.random.default_rng(chip_smoke.LPIPS_SEED)))
        chip_smoke.phase_trainer(torch, kernels, render, params, True, lpips)
        return {}
    if step in ("cli_train", "no_viewer", "no_eval", "profile_dir"):
        return run_cli_train(params, root, viewer=step != "no_viewer",
                             evaluate=step != "no_eval", profile=step == "profile_dir")
    if step.startswith("captures:"):
        from gsjax_torch.train import step as steps

        n = int(step.split(":")[1])
        for _ in range(n):
            replayed_train_steps(params, aux, camera, cfg, 2)()
        torch.cuda.synchronize()
        steps.drop_step_graphs()
        return {"captures": n}
    if step == "session":
        from gsjax_torch.tools.common import forward_frame

        frame = forward_frame(params, aux, camera, cfg)
        return {"session": session(frame, 1)}
    if step == "safe_state":
        from gsjax_torch.utils.general import safe_state

        stdout = sys.stdout
        safe_state(True)
        sys.stdout = stdout
        return {}
    raise SystemExit(f"probe_profiler: unknown step {step!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", default="", help="comma list of steps (see the module doc)")
    ap.add_argument("--sessions", type=int, default=5)
    ap.add_argument("--pad_ms", type=float, default=0.0,
                    help="host idle time after a session opens and before it closes")
    ap.add_argument("--lead_in", type=int, default=0,
                    help="spin kernels at the start of each recorded step")
    ap.add_argument("--warmup", type=int, default=0,
                    help="spin kernels in a warm-up step of the profiler's schedule")
    ap.add_argument("--port", action="store_true",
                    help="take each session as the port's readers do")
    args = ap.parse_args(argv)
    require_card("probe_profiler")
    import tempfile

    from gsjax_torch.render import kernels

    env = {k: os.environ.get(k) for k in PROFILE_ENV}
    params, aux, camera, cfg = bench_scene()
    build = os.path.join(os.getcwd(), "build")
    os.makedirs(build, exist_ok=True)
    befores = {}
    with tempfile.TemporaryDirectory(dir=build) as root:
        for step in filter(None, args.before.split(",")):
            t0 = time.perf_counter()
            befores[step] = {**run_before(step, params, aux, camera, cfg, root),
                             "seconds": time.perf_counter() - t0}
    stream = instance_stream(params, camera, cfg, aux.alive)

    def eager():
        with torch.no_grad():
            kernels.composite_forward(stream.inst, stream.tile_start, **stream.geometry)

    forms = {"replayed_window": (replayed_train_steps(params, aux, camera, cfg, WINDOW_STEPS), 1),
             "eager_composite_forward": (eager, EAGER_CALLS)}
    summary = {"before": befores, "env": env, "port": args.port, "pad_ms": args.pad_ms,
               "lead_in": args.lead_in, "warmup": args.warmup,
               "card": torch.cuda.get_device_name(0)}
    for form, (fn, reps) in forms.items():
        fn()
        torch.cuda.synchronize()
        rows = []
        for i in range(args.sessions):
            row = (port_session(fn, reps) if args.port
                   else session(fn, reps, args.pad_ms, args.lead_in, args.warmup))
            print(json.dumps({"form": form, "session": i, **row}), flush=True)
            rows.append(row)
        summary[form] = {"sessions": len(rows), "whole": sum(r["whole"] for r in rows)}
        if args.port:
            summary[form]["errors"] = [r["error"] for r in rows if not r["whole"]]
        else:
            summary[form]["empty"] = sum(r["raw_events"] == 0 for r in rows)
            summary[form]["missing_by_session"] = [
                {k: r["launched"][k] - r["raw"][k] for k in r["launched"]
                 if r["raw"][k] != r["launched"][k]} for r in rows]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
