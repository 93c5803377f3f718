"""Training traffic: the port's Trainer resumed in memory at a late
iteration and run in whole Trainer windows.

Set-up makes the state a checkpoint at `start_iteration` would restore
(the Gaussians and Adam's moments from the seed, SH at its full degree)
and a Trainer on it, then:
1. warms up: Trainer windows of `warmup_window` steps until one changes
   neither the budgets (the Trainer's own rule) nor the captured graphs;
2. puts the seed's state back into the same tensors, so the checked steps
   start from what the benchmark made;
3. runs `check_steps` steps, each a Trainer window of one step through
   the window's own call (the replayed step graph), keeping Adam's first
   moment after the first and the parameters after the last on the host.
The window then runs whole Trainer windows of at most `max_window` steps,
as many as fill --seconds at the warm-up's pace, from that same Trainer.
The Trainer stops at a window boundary through its viewer hook, which it
polls at the top of every window.

After the window the program's state is freed and the plain reference
follows the checked steps from the seed's state on the same views:
compared are each step's loss, the first step's gradient (worked out from
Adam's first moment) and the parameters' change over the steps, by the
norm of each leaf.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from gsbench import scene
from gsbench.drivers import common
from gsbench.drivers.common import (
    device_record, launches, log, norm_gap, pair_counts, ref_cam, synchronize,
)
from gsbench.reference import precision
from gsbench.reference import train as ref_train


class WindowsDone(Exception):
    """Raised by StopHook at the top of the first window past its mark."""


class StopHook:
    """Stands in the Trainer's viewer slot (polled at the top of each
    window, reference train.py's network_gui loop): after `steps` more
    steps it ends the Trainer's run at that window boundary."""

    conn = None

    def __init__(self, trainer):
        self.trainer = trainer
        self.mark, self.steps = 0, 0

    def arm(self, steps: int) -> None:
        self.mark, self.steps = len(self.trainer.events), steps

    def done(self) -> int:
        return sum(e["steps"] for e in self.trainer.events[self.mark:] if "window" in e)

    def try_connect(self) -> None:
        if self.done() >= self.steps:
            raise WindowsDone


class BenchScene:
    """What the Trainer reads of a Scene, made by the benchmark: the model,
    the train camera bank, the extent and centre; nothing is written."""

    model_path = ""

    def __init__(self, params, aux, extent: float, center, bank):
        self.params, self.aux = params, aux
        self.cameras_extent, self.scene_center = extent, center
        self._bank = bank

    def get_train_banks(self, scale: float = 1.0):
        return [self._bank]

    def get_test_banks(self, scale: float = 1.0):
        return []

    def save(self, *args, **kwargs):
        raise RuntimeError("the benchmark writes no model")


@dataclasses.dataclass
class Calls:
    """What the Trainer handed train_steps, call by call (views and the
    step metrics, on the device), while recording."""

    cams: list
    metrics: list
    recording: bool = False


def program_state(raw: dict, mu: dict, nu: dict, start: int, dev):
    """The port's TrainState of the seed's Gaussians at their capacity."""
    from gsjax_torch.model import GaussianAux, pad_gaussian_params
    from gsjax_torch.train.optimizer import AdamState
    from gsjax_torch.train.step import TrainState

    n = raw["xyz"].shape[0]
    cap = scene.capacity_for(n)

    def pad(x):
        out = x.new_zeros((cap, *x.shape[1:]))
        out[:n] = x
        return out

    params = pad_gaussian_params(**raw, capacity=cap)
    opt = AdamState(count=torch.full((), start, dtype=torch.int32, device=dev),
                    mu={k: pad(v) for k, v in mu.items()},
                    nu={k: pad(v) for k, v in nu.items()})
    return TrainState(params=params, opt=opt, aux=GaussianAux.create(cap, n, dev),
                      step=torch.full((), start, dtype=torch.int32, device=dev))


def seed_inputs(cfg: dict, seed: int, dev):
    raw = scene.gaussians(cfg, seed, dev)
    mu, nu = scene.adam_moments(cfg, seed, raw)
    return raw, mu, nu


class Run:
    """The Trainer of one run, from set-up to the end of the window."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, dev, fault: str | None):
        from gsjax_torch.config import ModelConfig, OptimizationConfig
        from gsjax_torch.scene import CameraBank
        from gsjax_torch.train import trainer as trainer_mod

        self.cfg, self.traffic, self.seed, self.dev, self.fault = cfg, traffic, seed, dev, fault
        self.start = traffic["start_iteration"]
        t0 = time.perf_counter()
        raw, mu, nu = seed_inputs(cfg, seed, dev)
        self.n = raw["xyz"].shape[0]
        state = program_state(raw, mu, nu, self.start, dev)
        del raw, mu, nu
        synchronize(dev)
        t1 = time.perf_counter()
        views = scene.camera_set(cfg, "train", dev)
        gt = scene.ground_truths(cfg, seed, views.count, dev)
        synchronize(dev)
        t2 = time.perf_counter()
        bank = CameraBank(views=views.views, full_projs=views.full_projs, centers=views.centers,
                          tan_fovx=views.tan_fovx, tan_fovy=views.tan_fovy, gt_rgb=gt,
                          alpha=torch.full((views.count, 1, views.height, views.width), 255,
                                           dtype=torch.uint8, device=dev),
                          width=views.width, height=views.height)
        center, self.extent = scene.normalization(cfg)
        self.opt_cfg = OptimizationConfig(**traffic["optimizer"])
        model_cfg = ModelConfig(sh_degree=cfg["sh_degree"], white_background=False,
                                sky_gaussians=cfg.get("sky_gaussians", 0),
                                sky_radius_scale=cfg.get("sky_radius_scale", 10.0))
        self.trainer = trainer_mod.Trainer(
            BenchScene(state.params, state.aux, self.extent, center, bank), model_cfg,
            self.opt_cfg, raster_cfg=common.raster_config(cfg), quiet=True)
        # Resumed in memory, as a checkpoint restores (Trainer.__init__'s
        # start_checkpoint branch): the state, the SH degree, the iteration.
        self.trainer.state = state
        self.trainer.active_sh_degree = cfg["sh_degree"]
        log(f"set-up: Gaussians and Adam {t1 - t0:.2f} s, camera bank {t2 - t1:.2f} s, "
            f"Trainer {time.perf_counter() - t2:.2f} s")
        self.hook = StopHook(self.trainer)
        self.trainer.gui = self.hook
        self.it = self.start
        self.calls = Calls([], [])
        self.steps_calls = 0  # train_steps calls seen, whatever was recorded
        # (wall s, [ms of each window the Trainer recorded]) of each call.
        self.host_calls: list[tuple[float, list[float]]] = []
        self._module = trainer_mod
        self._original = trainer_mod.train_steps
        self.open()

    def _recording_steps(self, state, bank, cam_indices, bgs, **kw):
        from gsjax_torch.train.step import clone_state, copy_state_

        self.steps_calls += 1
        before = clone_state(state) if self.fault == "unchanged" else None
        state, m = self._original(state, bank, cam_indices, bgs, **kw)
        if before is not None:
            copy_state_(state, before)
        if self.calls.recording:
            self.calls.cams.append(torch.as_tensor(cam_indices).tolist())
            self.calls.metrics.append((m.num_instances, self.trainer.raster_cfg.max_instances))
        return state, m

    def open(self) -> None:
        """Hand the Trainer's train_steps calls to _recording_steps."""
        self._module.train_steps = self._recording_steps
        self.wrapped = True

    def close(self) -> None:
        self._module.train_steps = self._original
        self.wrapped = False

    def windows(self, steps: int, max_window: int) -> int:
        """Run the Trainer until `steps` more steps are done, in its windows
        of at most max_window; returns the steps run."""
        self.trainer.first_iter = self.it
        self.hook.arm(steps)
        calls = self.steps_calls
        t0 = time.perf_counter()
        try:
            self.trainer.train(test_iterations=(), save_iterations=(),
                               checkpoint_iterations=(), max_window=max_window)
            raise RuntimeError("the Trainer ran to its end without polling its viewer slot")
        except WindowsDone:
            pass
        wall = time.perf_counter() - t0
        done = self.hook.done()
        if done and self.wrapped and self.steps_calls == calls:
            raise RuntimeError("the Trainer's steps did not go through train_steps: "
                               "the benchmark's readings of them would be empty")
        self.it += done
        self.host_calls.append(
            (wall, [e["ms"] for e in self.trainer.events[self.hook.mark:] if "window" in e]))
        return done

    def warm_up(self) -> float:
        """Windows until one neither changes the budgets nor captures;
        returns the last window's seconds per step."""
        from gsjax_torch.render.graph import captures

        t = self.traffic
        for k in range(t["warmup_windows_max"]):
            before = (len(captures), self.trainer.raster_cfg)
            t0 = time.perf_counter()
            done = self.windows(t["warmup_window"], t["warmup_window"])
            per_step = (time.perf_counter() - t0) / done
            if k > 0 and (len(captures), self.trainer.raster_cfg) == before:
                return per_step
        raise RuntimeError("the Trainer's budgets or graphs still changed after "
                           f"{t['warmup_windows_max']} warm-up windows")

    def restore_seed_state(self) -> None:
        from gsjax_torch.train.step import copy_state_

        raw, mu, nu = seed_inputs(self.cfg, self.seed, self.dev)
        copy_state_(self.trainer.state, program_state(raw, mu, nu, self.start, self.dev))
        self.it = self.start

    def checked_steps(self) -> dict:
        """The checked steps, one Trainer window of one step each."""
        self.calls.recording = True
        losses: dict[int, float] = {}
        self.trainer.tb = _LossRecorder(losses)
        mu1 = params = None
        for k in range(self.traffic["check_steps"]):
            self.windows(1, 1)
            st = self.trainer.state
            if k == 0:
                mu1 = {n: v[:self.n].detach().to("cpu", copy=True) for n, v in st.opt.mu.items()}
        params = {n: getattr(st.params, n)[:self.n].detach().to("cpu", copy=True)
                  for n in scene.PARAM_NAMES}
        self.trainer.tb = None
        cams = [c for call in self.calls.cams for c in call]
        self.calls = Calls([], [])
        want = list(range(self.start + 1, self.start + 1 + self.traffic["check_steps"]))
        if len(cams) != len(want) or sorted(losses) != want:
            raise RuntimeError(f"checked steps: {len(cams)} views and the losses of steps "
                               f"{sorted(losses)} seen, {want} expected")
        return {"losses": [losses[k] for k in want],
                "views": cams, "mu1": mu1, "params": params}


class _LossRecorder:
    """The Trainer's TensorBoard slot: keeps each step's total loss."""

    def __init__(self, losses: dict):
        self.losses = losses

    def add_scalar(self, tag, value, step):
        if tag == "train_loss_patches/total_loss":
            self.losses[int(step)] = float(value)


# --- the reference ----------------------------------------------------------------------


def reference_readings(cfg: dict, traffic: dict, seed: int, views_idx: list[int], dev,
                       tf32: bool = False, half: bool = False) -> dict:
    """The plain reference's steps from the seed's state on the given
    views: each loss, the first step's gradients, the parameters after."""
    raw, mu, nu = seed_inputs(cfg, seed, dev)
    views = scene.camera_set(cfg, "train", dev)
    gt = scene.ground_truths(cfg, seed, views.count, dev)
    _, extent = scene.normalization(cfg)
    start = traffic["start_iteration"]
    mu0 = {k: v.clone() for k, v in mu.items()}
    st = {"params": dict(raw), "mu": mu, "nu": nu, "count": start, "step": start}
    bg = torch.zeros(3, device=dev)
    losses, g1 = [], None
    with precision(tf32):
        for v in views_idx:
            target = gt[v].to(torch.float32) / 255.0
            loss, grads = ref_train.step(st, ref_cam(views, v), target, bg, cfg["sh_degree"],
                                         traffic["optimizer"], extent, half=half)
            losses.append(loss)
            if g1 is None:
                g1 = grads
    return {"losses": losses, "g1": g1, "params": st["params"], "p0": raw, "mu0": mu0}


def numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """The compared numbers of program (or control) readings against the
    reference's, and what they were worked out from."""
    dev = ref["p0"]["xyz"].device
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    b1 = ref_train.BETA1
    g1 = prog.get("g1")
    if g1 is None:  # from Adam's first moment after the first step
        g1 = {k: (prog["mu1"][k].to(dev).double() - b1 * ref["mu0"][k].double()) / (1.0 - b1)
              for k in ref["g1"]}
    grad_gap, grad_info = norm_gap(g1, ref["g1"])
    delta_p = {k: prog["params"][k].to(dev).double() - ref["p0"][k].double() for k in ref["g1"]}
    delta_r = {k: ref["params"][k].double() - ref["p0"][k].double() for k in ref["g1"]}
    change_gap, change_info = norm_gap(delta_p, delta_r)
    return ({"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap},
            {"grad": grad_info, "change": change_info,
             "losses": {"prog": prog["losses"], "ref": ref["losses"]}})


# --- one run --------------------------------------------------------------------------


def run(cfg: dict, traffic: dict, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, fault: str | None = None, control: bool = False) -> dict:
    from gsjax_torch.render.graph import captures
    from gsjax_torch.train.step import drop_step_graphs

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"imports and CUDA context: {time.perf_counter() - t_start:.2f} s from start")
    half = _HalfLoss() if fault == "half_batch" else None
    r = Run(cfg, traffic, seed, dev, fault)
    log(f"inputs and Trainer: {time.perf_counter() - t_start:.2f} s from start")
    try:
        per_step = r.warm_up()
        log(f"warm-up: {time.perf_counter() - t_start:.2f} s from start")
        r.restore_seed_state()
        checked = r.checked_steps()
        if not trace and fault is None:
            r.close()
        log(f"set-up: budgets {r.trainer.raster_cfg.max_instances}/{r.trainer.raster_cfg.max_rows}, "
            f"{len(captures)} captures, {per_step * 1e3:.2f} ms/step in warm-up")
        mw = traffic["max_window"]
        steps = max(1, round(seconds / (per_step * mw))) * mw
        synchronize(dev)
        t_window = time.perf_counter()
        setup_s = t_window - t_start
        caps = len(captures)
        record: dict = {"gaussians": r.n}
        r.host_calls.clear()
        mark = len(r.trainer.events)
        if not trace:
            done = r.windows(steps, mw)
            wall = time.perf_counter() - t_window
        else:
            done, wall, prof_params = _traced_window(r, steps, mw, dev, record)
        if len(captures) != caps:
            log(f"WARNING: {len(captures) - caps} capture(s) inside the window")
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        record.update(trainer_calls=list(r.host_calls), steps=done,
                      captures_in_window=len(captures) - caps)
        failed = overflowed_steps(r.trainer.events[mark:])
        log(f"window: {done} steps in {wall:.2f} s; {failed} steps overflowed; Trainer "
            f"windows (steps, ms): {[(e['steps'], round(e['ms'], 1)) for e in r.trainer.events[mark:] if 'window' in e]}")
    finally:
        r.close()
        if half is not None:
            half.mend()
    if half is not None and not half.calls:
        raise RuntimeError("the half_batch fault planted nothing: the step called no "
                           "l1_loss or ssim of gsjax_torch.train.step")
    fills = [float(m) / cap for ms, cap in r.calls.metrics for m in ms.cpu().tolist()]
    record["fills"] = fills
    del r
    drop_step_graphs()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    out = {"attempted": done, "failed": failed,
           "e2e": {"train_ms_per_step": wall / done * 1e3, "setup_s": setup_s,
                   "peak_mem_gib": peak / 2**30},
           "device": device_record(dev, peak), "record": record}
    if trace:
        record["views"] = pair_counts({k: v.to(dev) for k, v in prof_params.items()},
                                      scene.camera_set(cfg, "train", dev),
                                      record.pop("profiled_views"), cfg["sh_degree"])
        out["device"].update(busy_s=record["busy_s"], window_s=record["session_window_s"])
        out["breakdown"] = record.pop("breakdown")
    t_ref = time.perf_counter()
    ref = reference_readings(cfg, traffic, seed, checked["views"], dev)
    log(f"reference: {time.perf_counter() - t_ref:.2f} s")
    if control:  # the reference in TF32, in the program's place
        checked = reference_readings(cfg, traffic, seed, checked["views"], dev, tf32=True)
    out["numbers"], info = numbers(checked, ref)
    log(f"check: {info}")
    return out


def overflowed_steps(events: list) -> int:
    """Steps of the windows whose pairs overflowed the budgets (the
    Trainer's budget record after such a window names peaks above them):
    their deepest pairs were dropped."""
    failed, last = 0, 0
    for e in events:
        if "window" in e:
            last = e["steps"]
        elif "budgets" in e and e["why"].startswith("peaks "):
            peaks = [int(x) for x in e["why"][len("peaks "):].split("/")]
            if peaks[0] > e["from"][0] or peaks[1] > e["from"][1]:
                failed += last
    return failed


def _traced_window(r: Run, steps: int, mw: int, dev, record: dict):
    """The window with one whole profiler session over one Trainer window
    in its middle; the views and step metrics of that window recorded."""
    from gsbench import session

    t0 = time.perf_counter()
    before = max(0, (steps // mw) // 2) * mw
    done = r.windows(before, mw) if before else 0
    prof_params = {n: getattr(r.trainer.state.params, n)[:r.n].detach().to("cpu", copy=True)
                   for n in scene.PARAM_NAMES}
    r.calls.recording = True
    holder = {}

    def body():
        r.calls.cams.clear()
        r.calls.metrics.clear()
        holder["steps"] = r.windows(mw, mw)

    if dev.type == "cuda":
        sess = session.profile(body, launches)
        record.update(ops=sess.ops, session_window_s=sess.window_s,
                      busy_s=session.busy_s(sess.ops), sessions_refused=sess.refused,
                      breakdown={"device_ops": session.top_ops(sess.ops),
                                 "idle_gaps": session.idle_gaps(sess.ops)})
    else:
        t1 = time.perf_counter()
        body()
        record.update(ops=[], session_window_s=time.perf_counter() - t1, busy_s=0.0,
                      sessions_refused=[], breakdown=None)
    r.calls.recording = False
    if not r.calls.metrics:
        raise RuntimeError("no step metrics recorded in the profiled window")
    done += holder["steps"]
    record["profiled_steps"] = holder["steps"]
    record["item_s"] = record["session_window_s"] / holder["steps"]
    record["profiled_views"] = [c for call in r.calls.cams for c in call]
    rest = steps - done
    if rest > 0:
        done += r.windows(rest, mw)
    wall = time.perf_counter() - t0
    return done, wall, prof_params


class _HalfLoss:
    """A fault: the step's loss over the left half of the image alone
    (half the batch's pixels left out, the mean over the rest), planted in
    the step's loss terms until mend(); `calls` counts the terms it cut."""

    def __init__(self):
        import gsjax_torch.train.step as step_mod

        self.mod, self.calls = step_mod, 0
        self.l1, self.ssim = step_mod.l1_loss, step_mod.ssim
        step_mod.l1_loss, step_mod.ssim = self.half(self.l1), self.half(self.ssim)

    def half(self, fn):
        def cut(a, b, *k):
            self.calls += 1
            return fn(a[..., : a.shape[-1] // 2], b[..., : b.shape[-1] // 2], *k)

        return cut

    def mend(self) -> None:
        self.mod.l1_loss, self.mod.ssim = self.l1, self.ssim
