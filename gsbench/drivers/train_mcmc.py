"""Training traffic under 3DGS-MCMC: the port's Trainer resumed in memory
in the relocation phase of an MCMC run and run in whole Trainer windows,
as drivers/train.py runs late training, with:

* the optimizer: the traffic's, with the configuration's `mcmc` constants
  (densify_strategy "mcmc", cap_max, noise_lr, opacity_reg, scale_reg,
  densify_until_iter);
* the seed's state: the configuration's Gaussians and Adam moments, of
  which `assumed.dead_share` of the cap, picked by the seed, at an opacity
  drawn in `assumed.dead_opacity` (below relocation's 0.005);
* the warm-up: Trainer windows of `warmup_window` steps until one past a
  relocation changes neither the budgets nor the captured graphs;
* the checked steps: the seed's state put back at iteration `check_start`,
  so that the three one-step windows straddle the relocation at the next
  100-step boundary (after the second); the noise generator's state before
  each step and the relocation's draws are recorded;
* the reference (gsbench/reference/mcmc.py) follows the checked steps from
  the seed's state with the program's generator states and draws, and is
  compared over the seed's Gaussians as drivers/train.py compares, but for
  change_gap: the norm of each leaf's difference of changes, where
  train_late takes the difference of their norms (a draw of stale noise
  has the norm of a fresh one; the relocation's jumps dominate every
  leaf's change, and they are the same draws on both sides);
* the window's relocation records (Trainer.events) go into the record for
  relocate_ms.mcmc and dead_share.mcmc.

Faults under the timed path (the check's test): "stale_noise" (every step
draws the first step's noise again), "no_relocation" (relocation draws its
picks and reports them, and leaves the state as it was), "no_regularizers"
(the loss without its opacity and scale terms).
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from gsbench import scene
from gsbench.drivers import train as base
from gsbench.drivers.common import (
    device_record, log, pair_counts, ref_cam, synchronize,
)
from gsbench.reference import mcmc as ref_mcmc
from gsbench.reference import precision

FAULTS = ("stale_noise", "no_relocation", "no_regularizers")
# What every compared number reads when the program's draws are invalid:
# finite, so the result line stays JSON, and above every limit.
INVALID = 1e30


def plant_dead(opacity: torch.Tensor, cfg: dict, seed: int, n: int) -> None:
    """Write the seed's dead Gaussians into the [>= n, 1] opacity logits."""
    a = cfg["assumed"]
    count = int(a["dead_share"] * cfg["mcmc"]["cap_max"])
    g = scene.generator(seed + 3, opacity.device)
    idx = torch.randperm(n, generator=g, device=opacity.device)[:count]
    lo, hi = a["dead_opacity"]
    o = lo + (hi - lo) * torch.rand(count, generator=g, device=opacity.device)
    with torch.no_grad():
        opacity[idx, 0] = torch.log(o / (1.0 - o))


def seed_inputs(cfg: dict, seed: int, dev):
    raw, mu, nu = base.seed_inputs(cfg, seed, dev)
    plant_dead(raw["opacity"], cfg, seed, raw["xyz"].shape[0])
    return raw, mu, nu


def optimizer(cfg: dict, traffic: dict) -> dict:
    return {**traffic["optimizer"], **cfg["mcmc"]}


def relocates_after(opt: dict, it: int) -> bool:
    """Whether the Trainer relocates at the boundary after iteration `it`."""
    return (opt["densify_from_iter"] < it < opt["densify_until_iter"]
            and it % opt["densification_interval"] == 0)


class Faults:
    """One fault planted under the timed path until mend(); `calls` counts
    what it changed."""

    def __init__(self, fault: str | None, run: "Run"):
        from gsjax_torch.train import mcmc

        self.mcmc, self.calls = mcmc, 0
        self.original = run.original_relocate
        self.noise, self.regularizers = mcmc.position_noise, mcmc.regularizers
        self.eps = None
        if fault == "stale_noise":
            mcmc.position_noise = self.stale_noise
        elif fault == "no_regularizers":
            mcmc.regularizers = self.no_regularizers
        elif fault == "no_relocation":
            run.relocate = self.no_relocation
        elif fault is not None:
            raise ValueError(f"no fault {fault!r} in this cell: {FAULTS}")

    def stale_noise(self, params, alive, xyz_lr, noise_lr, generator, eps=None):
        self.calls += 1
        if self.eps is None:
            self.eps = torch.randn((params.capacity, 3), generator=generator, device=params.device)
        return self.noise(params, alive, xyz_lr, noise_lr, generator, eps=self.eps)

    def no_regularizers(self, params, alive, opacity_reg, scale_reg):
        self.calls += 1
        return torch.zeros((), device=params.device)

    def no_relocation(self, params, aux, opt, **kw):
        from gsjax_torch.train.step import TrainState, clone_state

        self.calls += 1
        scratch = clone_state(TrainState(params=params, opt=opt, aux=aux, step=opt.count))
        return self.original(scratch.params, scratch.aux, scratch.opt, **kw)

    def mend(self) -> None:
        self.mcmc.position_noise, self.mcmc.regularizers = self.noise, self.regularizers


class Run(base.Run):
    """drivers/train.py's Run under the configuration's MCMC constants, with
    the seed's dead Gaussians, and recording the noise generator's state
    before each checked step and the checked relocation's draws."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, dev, fault: str | None):
        from gsjax_torch.train import trainer as trainer_mod

        self.trainer_mod = trainer_mod
        self.relocate = self.original_relocate = trainer_mod.relocate_and_grow
        self.checking = False
        self.gen_states: list[torch.Tensor] = []
        self.picks: list[dict] = []
        self.check_start = traffic["check_start"]
        super().__init__(cfg, dict(traffic, optimizer=optimizer(cfg, traffic)), seed, dev,
                         None)
        plant_dead(self.trainer.state.params.opacity, cfg, seed, self.n)
        self.faults = Faults(fault, self)

    def open(self) -> None:
        super().open()
        self.trainer_mod.relocate_and_grow = self._recording_relocate

    def close(self) -> None:
        super().close()
        self.trainer_mod.relocate_and_grow = self.original_relocate

    def _recording_steps(self, state, bank, cam_indices, bgs, **kw):
        if self.checking:
            self.gen_states.append(self.trainer._generator.get_state())
        return super()._recording_steps(state, bank, cam_indices, bgs, **kw)

    def _recording_relocate(self, params, aux, opt, **kw):
        picks, counts = self.relocate(params, aux, opt, **kw)
        if self.checking:
            self.picks.append({k: v.cpu() for k, v in dataclasses.asdict(picks).items()})
        return picks, counts

    def warm_up(self) -> float:
        """Windows until one past a relocation neither changes the budgets
        nor captures; returns that window's seconds per step."""
        from gsjax_torch.render.graph import captures

        t = self.traffic
        relocated = False
        for _ in range(t["warmup_windows_max"]):
            before = (len(captures), self.trainer.raster_cfg)
            mark = len(self.trainer.events)
            t0 = time.perf_counter()
            done = self.windows(t["warmup_window"], t["warmup_window"])
            per_step = (time.perf_counter() - t0) / done
            now = any("relocate" in e for e in self.trainer.events[mark:])
            if relocated and not now and (len(captures), self.trainer.raster_cfg) == before:
                return per_step
            relocated = relocated or now
        raise RuntimeError("no relocation, or the Trainer's budgets or graphs still changed, "
                           f"after {t['warmup_windows_max']} warm-up windows")

    def restore_seed_state(self) -> None:
        super().restore_seed_state()
        st = self.trainer.state
        plant_dead(st.params.opacity, self.cfg, self.seed, self.n)
        st.step.fill_(self.check_start)
        st.opt.count.fill_(self.check_start)
        self.it = self.start = self.check_start

    def checked_steps(self) -> dict:
        from gsjax_torch.render.graph import captures

        caps = len(captures)
        self.gen_states, self.picks, self.checking = [], [], True
        try:
            out = super().checked_steps()
        finally:
            self.checking = False
        if len(captures) != caps:
            raise RuntimeError("a capture inside the checked steps: the recorded generator "
                               "states would not be the replays' own")
        out.update(gen_states=self.gen_states, picks=self.picks,
                   capacity=self.trainer.state.params.capacity)
        return out


# --- the reference ----------------------------------------------------------------------


def reference_readings(cfg: dict, traffic: dict, seed: int, prog: dict, dev,
                       tf32: bool = False, fault: str | None = None) -> dict:
    """The plain reference's steps from the seed's state on the program's
    views, with the program's generator states and relocation draws: each
    loss, the first step's gradients, the seed's Gaussians after. `fault`
    runs one of FAULTS in the reference itself (the limits' readings)."""
    raw, mu, nu = seed_inputs(cfg, seed, dev)
    n = raw["xyz"].shape[0]
    views = scene.camera_set(cfg, "train", dev)
    gt = scene.ground_truths(cfg, seed, views.count, dev)
    _, extent = scene.normalization(cfg)
    opt = optimizer(cfg, traffic)
    start = traffic["check_start"]
    mu0 = {k: v.clone() for k, v in mu.items()}
    st = {"params": dict(raw), "mu": mu, "nu": nu, "count": start, "step": start}
    bg = torch.zeros(3, device=dev)
    picks = list(prog["picks"])
    losses, g1 = [], None
    with precision(tf32):
        for k, v in enumerate(prog["views"]):
            gen = torch.Generator(device=dev)
            gen.set_state(prog["gen_states"][0 if fault == "stale_noise" else k])
            target = gt[v].to(torch.float32) / 255.0
            loss, grads = ref_mcmc.step(st, ref_cam(views, v), target, bg, cfg["sh_degree"], opt,
                                        extent, gen, prog["capacity"],
                                        regularize=fault != "no_regularizers")
            losses.append(loss)
            if g1 is None:
                g1 = grads
            if relocates_after(opt, st["step"]):
                if not picks:
                    raise RuntimeError(f"the program recorded no relocation after {st['step']}")
                p = picks.pop(0)
                if fault != "no_relocation":
                    ref_mcmc.relocate_and_grow(st, p, opt["cap_max"], prog["capacity"])
    if picks:
        raise RuntimeError(f"{len(picks)} relocation(s) the method does not make in these steps")
    return {"losses": losses, "g1": g1, "p0": raw, "mu0": mu0,
            "params": {k: v[:n] for k, v in st["params"].items()}}


def numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """drivers/train.py's loss_gap and grad_gap; change_gap the worst leaf
    of ||change_prog - change_ref|| / max(||change_ref||, the median leaf's),
    over the leaves norm_gap compares."""
    out, info = base.numbers(prog, ref)
    dev = ref["p0"]["xyz"].device
    delta_r = {k: ref["params"][k].double() - ref["p0"][k].double() for k in ref["g1"]}
    diff = {k: prog["params"][k].to(dev).double() - ref["params"][k].double() for k in delta_r}
    rn = {k: float(torch.linalg.vector_norm(v)) for k, v in delta_r.items()}
    med = statistics.median(rn.values())
    gaps = {k: float(torch.linalg.vector_norm(diff[k])) / max(rn[k], med)
            for k in rn if rn[k] >= 1e-3 * med}
    out["change_gap"] = max(gaps.values())
    info["change"] = {"gaps": gaps, "ref": rn}
    return out, info


# --- one run --------------------------------------------------------------------------


def run(cfg: dict, traffic: dict, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, fault: str | None = None, control: bool = False) -> dict:
    from gsjax_torch.render.graph import captures
    from gsjax_torch.train.step import drop_step_graphs

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"imports and CUDA context: {time.perf_counter() - t_start:.2f} s from start")
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
            done, wall, prof_params = base._traced_window(r, steps, mw, dev, record)
        if len(captures) != caps:
            log(f"WARNING: {len(captures) - caps} capture(s) inside the window")
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        events = r.trainer.events[mark:]
        record.update(trainer_calls=list(r.host_calls), steps=done,
                      captures_in_window=len(captures) - caps,
                      relocations=[e for e in events if "relocate" in e])
        failed = base.overflowed_steps(events)
        log(f"window: {done} steps in {wall:.2f} s; {failed} steps overflowed; relocations "
            f"(it, dead, added, ms): {[(e['relocate'], e['n_dead'], e['n_added'], round(e['device_ms'], 2)) for e in record['relocations']]}")
    finally:
        r.close()
        r.faults.mend()
    if fault is not None and not r.faults.calls:
        raise RuntimeError(f"the {fault} fault planted nothing: the Trainer never reached it")
    record["fills"] = [float(m) / cap for ms, cap in r.calls.metrics for m in ms.cpu().tolist()]
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
    try:
        ref = reference_readings(cfg, traffic, seed, checked, dev)
        if control:  # the reference in TF32, in the program's place
            checked = reference_readings(cfg, traffic, seed, checked, dev, tf32=True)
        out["numbers"], info = numbers(checked, ref)
    except ref_mcmc.InvalidPicks as e:
        # Draws the method cannot make: no reading of the steps holds.
        out["numbers"], info = {"loss_gap": INVALID, "grad_gap": INVALID,
                                "change_gap": INVALID}, {"invalid picks": str(e)}
    log(f"reference: {time.perf_counter() - t_ref:.2f} s")
    log(f"check: {info}")
    return out

