"""The port's 3DGS-MCMC (gsjax_torch/train/mcmc.py, the "mcmc" strategy of
the step and the Trainer) against the plain reference tests/mcmc_reference.py
on the CPU, at the repository's CPU scale (200 Gaussians, 64x48).

Tolerances, each against its own scale: a loss within 1e-6 relative and
gradients within 1e-5 of each leaf's largest (the port's CPU render against
the plain one: the two sum the same terms in other orders,
gsbench/tests/test_gsbench_reference.py); each leaf's change over the steps
within 2e-5 of its norm, by the norm of the difference (Adam divides a
gradient's rounding by its moments, and the noise's Sigma is formed in
another order: up to 4.7e-6 here, and up to 9e-5 of the largest change in
single elements); relocation and
growth within 2e-6 relative (the two sums of the scale's denominator group
the same float32 terms differently). Each test also holds the term it
checks to be far above its tolerance: a left-out regularizer, noise or
relocation fails it. The `cuda` tests (on the card, `--noconftest`) hold
the replayed step's draws to a fresh generator's.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from gsjax_torch.config import OptimizationConfig, RasterConfig
from gsjax_torch.model import PARAM_NAMES, GaussianAux, GaussianParams
from gsjax_torch.scene import CameraBank
from gsjax_torch.synthetic import orbit_camera, random_scene
from gsjax_torch.train import mcmc
from gsjax_torch.train import step as steps
from gsjax_torch.train import trainer as trainer_mod
from gsjax_torch.train.optimizer import BETA1, AdamState

torch.set_num_threads(1)
# The card's machine has another package named `tests`: load the reference by path.
_spec = importlib.util.spec_from_file_location(
    "mcmc_reference", pathlib.Path(__file__).with_name("mcmc_reference.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)
from gsbench.reference import render as ref_render  # noqa: E402

W, H, N, CAP = 64, 48, 200, 256
CFG = RasterConfig(tile_size=16, max_instances=1 << 14, max_rows=1 << 14)
BG = torch.tensor([0.2, 0.3, 0.4])
OPT = OptimizationConfig(densify_strategy="mcmc", cap_max=N)
START = 15000
LOSS_RTOL, GRAD_RTOL, PARAM_RTOL, RELOC_RTOL = 1e-6, 1e-5, 2e-5, 2e-6


@pytest.fixture(autouse=True)
def _requirements(request):
    if request.node.get_closest_marker("cuda") and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def seeded_state(device="cpu", n=N, cap=CAP, dead=20, faint=20) -> steps.TrainState:
    """random_scene's Gaussians with `dead` of them at o <= 0.005 and
    `faint` at o in [0.01, 0.03] (where the noise's gate is open), and Adam
    moments of a run resumed at START."""
    params, aux = random_scene(n, capacity=cap, seed=3, device=device)
    g = torch.Generator().manual_seed(4)
    op = params.opacity.detach().clone()
    op[:dead, 0] = torch.logit(0.001 + 0.003 * torch.rand(dead, generator=g))
    op[dead:dead + faint, 0] = torch.logit(0.01 + 0.02 * torch.rand(faint, generator=g))
    raw = {k: getattr(params, k).detach().clone() for k in PARAM_NAMES}
    raw["opacity"] = op
    mu = {k: 1e-5 * torch.randn(v.shape, generator=g) for k, v in raw.items()}
    nu = {k: (1e-5 * (0.5 + torch.rand(v.shape, generator=g))) ** 2 for k, v in raw.items()}
    for tree in (mu, nu):
        for v in tree.values():
            v[n:] = 0.0
    t = lambda x: x.to(device)  # noqa: E731
    return steps.TrainState(
        params=GaussianParams(**{k: t(v) for k, v in raw.items()}),
        opt=AdamState(count=torch.tensor(START, dtype=torch.int32, device=device),
                      mu={k: t(v) for k, v in mu.items()}, nu={k: t(v) for k, v in nu.items()}),
        aux=aux, step=torch.tensor(START, dtype=torch.int32, device=device))


def ref_state(st: steps.TrainState, n=N) -> dict:
    return {"params": {k: getattr(st.params, k).detach()[:n].clone() for k in PARAM_NAMES},
            "mu": {k: v[:n].clone() for k, v in st.opt.mu.items()},
            "nu": {k: v[:n].clone() for k, v in st.opt.nu.items()},
            "count": int(st.opt.count), "step": int(st.step)}


def cam_and_gt(k: int):
    cam = orbit_camera(0.3 + 0.4 * k, width=W, height=H, device="cpu")
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(10 + k))
    rc = ref_render.Cam(cam.view, cam.full_proj, cam.cam_center, cam.tan_fovx, cam.tan_fovy, W, H)
    return cam, gt, rc


def close(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor, rtol: float) -> bool:
    return bool((got - want).abs().max() <= rtol * scale.abs().max())


def near(got: torch.Tensor, want: torch.Tensor, rtol: float = PARAM_RTOL) -> bool:
    """||got - want|| within rtol of ||want||."""
    return float((got - want).double().norm()) <= rtol * float(want.double().norm())


def program_step(st, k, gen, opt=OPT):
    cam, gt, _ = cam_and_gt(k)
    return steps.train_step(st, cam, gt, BG, active_sh_degree=3, opt_cfg=opt, raster_cfg=CFG,
                            spatial_lr_scale=1.0, generator=gen)


def test_one_step_matches_the_reference():
    st = seeded_state()
    start, rst = ref_state(st), ref_state(st)
    gen = torch.Generator().manual_seed(7)
    rgen = torch.Generator().set_state(gen.get_state())
    mu0 = {k: v[:N].clone() for k, v in st.opt.mu.items()}
    st, m = program_step(st, 0, gen)
    _, gt, rc = cam_and_gt(0)
    loss, grads = ref.step(rst, rc, gt, BG, 3, dataclasses.asdict(OPT), 1.0, rgen, CAP)

    assert abs(float(m.loss) - loss) <= LOSS_RTOL * loss
    reg = float(ref.regularizers(start["params"], dataclasses.asdict(OPT)))
    assert reg > 1e3 * LOSS_RTOL * loss  # a left-out regularizer fails
    for k in PARAM_NAMES:
        g = (st.opt.mu[k][:N] - BETA1 * mu0[k]) / (1.0 - BETA1)
        assert close(g, grads[k], grads[k], GRAD_RTOL), k
        want = rst["params"][k] - start["params"][k]
        got = getattr(st.params, k).detach()[:N] - start["params"][k]
        assert near(got, want), k
    # The noise is far above the tolerance: a left-out noise fails.
    noise = ref.noise(rst["params"], 1.6e-5, OPT.noise_lr, torch.Generator().manual_seed(7), CAP)
    change = rst["params"]["xyz"] - start["params"]["xyz"]
    assert float(noise.norm()) > 1e3 * PARAM_RTOL * float(change.norm())


def test_three_steps_draw_three_fresh_noises(monkeypatch):
    drawn = []
    original = mcmc.position_noise

    def recording(params, alive, xyz_lr, noise_lr, generator, eps=None):
        eps = torch.randn((params.capacity, 3), generator=generator)
        drawn.append(eps)
        return original(params, alive, xyz_lr, noise_lr, generator, eps=eps)

    monkeypatch.setattr(mcmc, "position_noise", recording)
    st = seeded_state()
    start, rst = ref_state(st), ref_state(st)
    bank = _bank(3)
    gen = torch.Generator().manual_seed(11)
    rgen = torch.Generator().set_state(gen.get_state())
    st, m = steps.train_steps(st, bank, torch.arange(3, dtype=torch.int32), BG.expand(3, 3),
                              active_sh_degree=3, opt_cfg=OPT, raster_cfg=CFG,
                              spatial_lr_scale=1.0, generator=gen)
    assert len(drawn) == 3
    assert not torch.equal(drawn[0], drawn[1]) and not torch.equal(drawn[1], drawn[2])
    check = torch.Generator().set_state(rgen.get_state())
    for k in range(3):
        assert torch.equal(drawn[k], torch.randn((CAP, 3), generator=check)), k
    for k in range(3):
        cam, gt = bank.pick(k)
        rc = ref_render.Cam(cam.view, cam.full_proj, cam.cam_center, cam.tan_fovx, cam.tan_fovy,
                            W, H)
        loss, _ = ref.step(rst, rc, gt, BG, 3, dataclasses.asdict(OPT), 1.0, rgen, CAP)
        assert abs(float(m.loss[k]) - loss) <= LOSS_RTOL * loss, k
    for k in PARAM_NAMES:
        want = rst["params"][k] - start["params"][k]
        got = getattr(st.params, k).detach()[:N] - start["params"][k]
        assert near(got, want), k


def _picks(st: steps.TrainState, grow: int) -> mcmc.Picks:
    o = torch.sigmoid(st.params.opacity[:, 0].detach())
    dead = torch.nonzero(st.aux.alive & (o <= mcmc.DEAD_OPACITY))[:, 0]
    live = torch.nonzero(st.aux.alive & (o > mcmc.DEAD_OPACITY))[:, 0]
    # Sources drawn once, twice and three times, so n runs 2..4.
    src = live[torch.tensor([0, 0, 1, 1, 1, 2, 3, 4, 5, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15])
               [:dead.numel()]]
    new = torch.arange(N, N + grow)
    # Growth draws from other sources, so the relocated copies stay as made.
    return mcmc.Picks(dead, src, new, live[torch.tensor([100, 100, 130, 140, 150])[:grow]])


def test_relocation_and_growth_match_the_reference_with_injected_picks():
    st = seeded_state()
    before = ref_state(st)
    cap_max = N + 5  # growth: min(205, int(1.05 * 200)) - 200 = 5
    picks = _picks(st, 5)
    mcmc.relocate_and_grow(st.params, st.aux, st.opt, cap_max=cap_max, picks=picks)
    ref.relocate_and_grow(before, {k: getattr(picks, k) for k in ("dead", "dead_src", "new",
                                                                   "new_src")}, cap_max, CAP)
    n = N + 5
    assert int(st.aux.alive.sum()) == n and bool(st.aux.alive[:n].all())
    for k in PARAM_NAMES:
        got = getattr(st.params, k).detach()[:n]
        want = before["params"][k]
        assert close(got, want, want, RELOC_RTOL), k
        for tree, rtree in ((st.opt.mu, before["mu"]), (st.opt.nu, before["nu"])):
            assert close(tree[k][:n], rtree[k], rtree[k], RELOC_RTOL), k
        # Each dead slot holds its source's copy, with the source's (o', s').
        src_rows = got[picks.dead_src]
        assert torch.equal(got[picks.dead], src_rows), k
    assert bool((st.opt.mu["xyz"][picks.dead_src] == 0).all())
    assert bool((st.opt.nu["opacity"][picks.new] == 0).all())
    moved = (before["params"]["opacity"][picks.dead] - ref_state(seeded_state())["params"]
             ["opacity"][picks.dead]).abs().max()
    assert moved > 1.0  # a skipped relocation would fail


def test_drawn_picks_are_ones_the_reference_accepts():
    st = seeded_state()
    before = ref_state(st)
    picks, counts = mcmc.relocate_and_grow(st.params, st.aux, st.opt, cap_max=N + 9,
                                           generator=torch.Generator().manual_seed(1))
    assert counts == {"n_dead": 20, "n_added": 9, "n_alive": N + 9}
    ref.relocate_and_grow(before, dataclasses.asdict(picks), N + 9, CAP)
    o = torch.sigmoid(st.params.opacity[:N + 9, 0].detach())
    assert bool((o > mcmc.DEAD_OPACITY).all())
    with pytest.raises(ref.InvalidPicks):
        ref.relocate_and_grow(ref_state(seeded_state()), dict(
            dataclasses.asdict(picks), dead=picks.dead[:-1]), N + 9, CAP)


def test_relocation_identity_and_a_single_draw():
    g = torch.Generator().manual_seed(5)
    o = 0.01 + 0.98 * torch.rand(400, generator=g)
    s = torch.exp(torch.randn(400, 3, generator=g))
    n = torch.randint(1, mcmc.N_MAX + 1, (400,), generator=g)
    o_new, s_new = mcmc.relocation_update(o, s, n)
    # The n copies at o' composite to the source's o (before the clamp).
    unclamped = 1.0 - torch.pow(1.0 - o, 1.0 / n.to(torch.float32))
    assert torch.allclose(1.0 - torch.pow(1.0 - unclamped, n.to(torch.float32)), o, atol=2e-6)
    assert torch.equal(o_new, torch.clamp(unclamped, mcmc.DEAD_OPACITY, 1 - 2**-23))
    one = torch.ones(400, dtype=torch.int64)
    o1, s1 = mcmc.relocation_update(o, s, one)
    # n = 1 leaves (o, s) as they were, to the rounding of 1 - (1 - o): an
    # ulp of numbers below 1 in o, that over o in s.
    assert float((o1 - o).abs().max()) <= 2**-24
    assert bool(((s1 - s).abs() <= (2**-23 / o + 1e-6)[:, None] * s).all())
    # The grouped sum against the reference's term-by-term sum, n <= 12.
    small = torch.clamp(n, max=12)
    o_p, s_p = mcmc.relocation_update(o, s, small)
    o_r, s_r = ref.relocated(o, s, small)
    assert torch.allclose(o_p, o_r, rtol=RELOC_RTOL) and torch.allclose(s_p, s_r, rtol=1e-5)


def test_growth_adds_five_percent_up_to_the_cap_and_never_past_it():
    st = seeded_state(dead=0)
    cap_max = 245
    seen = []
    for _ in range(6):
        _, counts = mcmc.relocate_and_grow(st.params, st.aux, st.opt, cap_max=cap_max,
                                           generator=torch.Generator().manual_seed(len(seen)))
        seen.append(counts["n_alive"])
    assert seen == [210, 220, 231, 242, 245, 245]
    assert st.params.capacity == CAP
    assert mcmc.capacity_for(cap_max) == 1024 and mcmc.capacity_for(2_962_000) == 1 << 22


class _Scene:
    model_path = ""

    def __init__(self, st, bank):
        self.params, self.aux, self._bank = st.params, st.aux, bank
        self.cameras_extent, self.scene_center = 1.0, [0.0, 0.0, 0.0]

    def get_train_banks(self, scale=1.0):
        return [self._bank]

    def get_test_banks(self, scale=1.0):
        return []


def _bank(views: int) -> CameraBank:
    cams = [orbit_camera(0.2 * k, width=W, height=H, device="cpu") for k in range(views)]
    g = torch.Generator().manual_seed(3)
    return CameraBank(
        views=torch.stack([c.view for c in cams]), full_projs=torch.stack([c.full_proj for c in cams]),
        centers=torch.stack([c.cam_center for c in cams]),
        tan_fovx=torch.stack([c.tan_fovx for c in cams]),
        tan_fovy=torch.stack([c.tan_fovy for c in cams]),
        gt_rgb=torch.randint(0, 256, (views, 3, H, W), generator=g, dtype=torch.uint8),
        alpha=torch.full((views, 1, H, W), 255, dtype=torch.uint8), width=W, height=H)


def test_a_trainer_under_mcmc_relocates_grows_to_the_cap_and_never_resets():
    params, aux = random_scene(60, capacity=64, seed=2, device="cpu")
    st = steps.TrainState(params=params, opt=None, aux=aux, step=None)
    opt = OptimizationConfig(iterations=30, densify_from_iter=5, densification_interval=10,
                             densify_until_iter=25, opacity_reset_interval=20,
                             densify_strategy="mcmc", cap_max=66)
    t = trainer_mod.Trainer(_Scene(st, _bank(4)), trainer_mod.ModelConfig(sh_degree=1), opt,
                            raster_cfg=CFG, quiet=True)
    assert t.state.params.capacity == mcmc.capacity_for(66) == 1024
    t.train(test_iterations=(), save_iterations=(), max_window=8)
    reloc = [e for e in t.events if "relocate" in e]
    assert [e["relocate"] for e in reloc] == [10, 20]
    assert [e["n_alive"] for e in reloc] == [63, 66]
    assert all(e["device_ms"] > 0 and e["n_dead"] >= 0 for e in reloc)
    assert not any("reset" in e.get("ms", {}) for e in t.events if "host" in e)
    assert not any("densify" in e for e in t.events)
    assert t.n_alive() == 66 <= opt.cap_max


def test_a_mesh_trainer_refuses_mcmc():
    params, aux = random_scene(10, capacity=16, seed=2, device="cpu")
    mesh = type("Mesh", (), {"device_type": "cpu"})()
    with pytest.raises(ValueError, match="mcmc"):
        trainer_mod.Trainer(_Scene(steps.TrainState(params, None, aux, None), _bank(1)),
                            trainer_mod.ModelConfig(sh_degree=1), OPT, mesh=mesh)


def test_the_train_cli_takes_the_strategy_and_its_constants():
    from gsjax_torch.cli.args import extract, make_train_parser

    def parsed(*argv):
        return extract(OptimizationConfig, make_train_parser().parse_args(["-s", "x", *argv]))

    mcmc_argv = ["--densify_strategy", "mcmc", "--cap_max", "12345", "--noise_lr", "1e5"]
    cfg = parsed(*mcmc_argv)
    assert (cfg.mcmc, cfg.cap_max, cfg.noise_lr, cfg.densify_until_iter) == (True, 12345, 1e5, 25000)
    # Given (argparse's abbreviation too), densify_until_iter is kept.
    for flag in ("--densify_until_iter", "--densify_until"):
        cfg = parsed(*mcmc_argv, flag, "20000")
        assert cfg.densify_until_iter == 20000 and cfg.opacity_reg == cfg.scale_reg == 0.01
    assert parsed().densify_until_iter == 15000 and not parsed().mcmc
    assert parsed("--densify_until_iter", "15000", "--densify_strategy", "mcmc").densify_until_iter == 15000
    # The API resolves the default by strategy as the command line does.
    assert OptimizationConfig(densify_strategy="mcmc").densify_until_iter == 25000
    assert OptimizationConfig().densify_until_iter == 15000
    with pytest.raises(ValueError):
        OptimizationConfig(densify_strategy="other")


# --- on the card ------------------------------------------------------------------------


@pytest.mark.cuda
def test_each_replay_draws_what_a_fresh_generator_draws_at_its_offset():
    from gsjax_torch.render.graph import capture_graph

    params, aux = random_scene(5000, capacity=8192, seed=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(123)
    lr = torch.full((), 1e-4, device="cuda")
    out = torch.zeros((8192, 3), device="cuda")

    def body():
        out.copy_(mcmc.position_noise(params, aux.alive, lr, 5e5, gen))

    graph, _ = capture_graph(body, torch.device("cuda"), {"graph": "noise-test"},
                             generators=(gen,))
    got, states = [], []
    for _ in range(3):
        states.append(gen.get_state())
        graph.replay()
        got.append(out.clone())
    assert not torch.equal(got[0], got[1]) and not torch.equal(got[1], got[2])
    for s, o in zip(states, got):
        fresh = torch.Generator(device="cuda")
        fresh.set_state(s)
        want = mcmc.position_noise(params, aux.alive, lr, 5e5, fresh)
        assert torch.equal(o, want)


@pytest.mark.cuda
def test_a_replayed_window_equals_the_eager_steps_at_the_same_offsets():
    st = seeded_state("cuda", n=4000, cap=8192, dead=80, faint=400)
    bank = _bank(3)
    bank = CameraBank(**{f.name: (getattr(bank, f.name).cuda() if torch.is_tensor(
        getattr(bank, f.name)) else getattr(bank, f.name)) for f in dataclasses.fields(bank)})
    start = steps.clone_state(st)
    gen = torch.Generator(device="cuda").manual_seed(9)
    kw = dict(active_sh_degree=3, opt_cfg=OPT, raster_cfg=CFG, spatial_lr_scale=1.0,
              generator=gen)
    cams, bgs = torch.arange(3, dtype=torch.int32), BG.expand(3, 3)
    steps.train_steps(st, bank, cams[:1], bgs[:1], **kw)  # captures
    steps.copy_state_(st, start)
    g0 = gen.get_state()
    st, _ = steps.train_steps(st, bank, cams, bgs, **kw)
    replayed = st.params.xyz.detach()[:4000].clone()
    eager = steps.clone_state(start)
    gen.set_state(g0)
    eager, _ = steps.scan_steps(eager, bank, cams, bgs.cuda(), **kw)
    moved = (eager.params.xyz.detach()[:4000] - start.params.xyz[:4000]).abs()
    assert float(moved.max()) > 1e-4  # the noise moves the faint Gaussians
    diff = (replayed - eager.params.xyz.detach()[:4000]).abs().max()
    assert float(diff) <= 1e-3 * float(moved.max())
