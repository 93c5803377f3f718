"""The port's densification, capacity growth and sky shell against gsjax's,
on the CPU: the cases of tests/test_train_components.py::TestDensify and
TestPow2Chunks and of tests/test_sky.py, each run through both packages on
the same numpy state with gsjax's own split noise injected into the port.
Copied rows, moved moments, counts and masks must agree bit for bit; the
split children's xyz and scaling within 1e-6 (exp, log and the rotation
are separate float32 libraries' ulps). The `cuda`-marked tests hold the
card's results to the CPU's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gsjax_torch import sky
from gsjax_torch.interop import train_state_from_numpy, train_state_to_numpy
from gsjax_torch.model import PARAM_NAMES
from gsjax_torch.train import densify, trainer

try:  # The card's machine has no JAX: only the `cuda` tests run there.
    import jax
    import jax.numpy as jnp

    from gsjax.sky import add_sky_shell as jax_add_sky_shell
    from gsjax.sky import fibonacci_sphere as jax_fibonacci_sphere
    from gsjax.sky import sky_shell_arrays as jax_sky_shell_arrays
    from gsjax.train import densify as jdensify
    from gsjax.train import trainer as jtrainer
    from gsjax.train.optimizer import adam_init as jax_adam_init
    from gsjax.train.step import TrainState as JaxTrainState
    from tests.scene_utils import random_scene
    from tests.torch_parity import train_state_to_numpy as jax_state_to_numpy
except ImportError:
    jax = None

torch.set_num_threads(1)
SPLIT_ATOL = 1e-6
CAP = 64


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


@pytest.fixture(autouse=True)
def _requirements(request):
    """`cuda` tests need the card; the others need JAX, the reference."""
    if request.node.get_closest_marker("cuda"):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
    elif jax is None:
        pytest.skip("needs JAX and gsjax, the reference")


def _jax_state(nalive=20, cap=CAP, seed=7, sh_degree=3):
    params, aux = random_scene(nalive, capacity=cap, seed=seed, sh_degree=sh_degree)
    return JaxTrainState(params=params, opt=jax_adam_init(params), aux=aux,
                         step=jnp.int32(1))


def _case_clone(st):
    params = st.params.replace(scaling=jnp.full_like(st.params.scaling, -5.0))
    aux = st.aux.replace(xyz_grad_accum=jnp.zeros(CAP).at[0].set(1.0).at[3].set(1.0),
                         denom=jnp.ones(CAP))
    return st.replace(params=params, aux=aux), dict(grad_threshold=0.5, extent=10.0,
                                                    max_screen_size=0, percent_dense=0.01)


def _case_split(st):
    params = st.params.replace(scaling=jnp.full_like(st.params.scaling, jnp.log(0.5)))
    aux = st.aux.replace(xyz_grad_accum=jnp.zeros(CAP).at[1].set(1.0), denom=jnp.ones(CAP))
    return st.replace(params=params, aux=aux), dict(grad_threshold=0.5, extent=10.0,
                                                    max_screen_size=0, percent_dense=0.01)


def _case_prune_opacity(st):
    params = st.params.replace(opacity=st.params.opacity.at[5:8].set(-10.0))
    return st.replace(params=params), dict(grad_threshold=1e9, extent=10.0,
                                           max_screen_size=0, percent_dense=0.01)


def _case_prune_world_size(st):
    params = st.params.replace(scaling=st.params.scaling.at[2].set(jnp.log(5.0)))
    return st.replace(params=params), dict(grad_threshold=1e9, extent=10.0,
                                           max_screen_size=20, percent_dense=0.01)


def _case_moments(st):
    opt = st.opt.replace(mu=jax.tree.map(jnp.ones_like, st.opt.mu))
    params = st.params.replace(scaling=st.params.scaling.at[0].set(jnp.log(5.0)))
    aux = st.aux.replace(xyz_grad_accum=jnp.zeros(CAP).at[0].set(1.0), denom=jnp.ones(CAP))
    return st.replace(params=params, aux=aux, opt=opt), dict(
        grad_threshold=0.5, extent=1000.0, max_screen_size=0, percent_dense=0.0001)


def _case_overflow(st):
    st = _jax_state(nalive=60)
    aux = st.aux.replace(xyz_grad_accum=jnp.where(jnp.arange(CAP) < 60, 1.0, 0.0),
                         denom=jnp.ones(CAP))
    params = st.params.replace(scaling=jnp.full_like(st.params.scaling, -5.0))
    return st.replace(params=params, aux=aux), dict(grad_threshold=0.5, extent=10.0,
                                                    max_screen_size=0, percent_dense=0.01)


def _case_mixed(st):
    """Dead slots in the middle, random statistics and moments: clones,
    splits, both prunes and an overflow in one pass."""
    st = _jax_state(nalive=56, seed=3)
    rng = np.random.default_rng(11)
    alive = np.asarray(st.aux.alive).copy()
    alive[[4, 9, 30]] = False
    scaling = np.log(rng.uniform(0.01, 0.35, (CAP, 3))).astype(np.float32)
    opacity = np.asarray(st.params.opacity).copy()
    opacity[[2, 17]] = -8.0
    accum = rng.uniform(0.0, 2.0, CAP).astype(np.float32)
    denom = rng.integers(0, 4, CAP).astype(np.float32)
    mu = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)), st.opt.mu)
    return st.replace(
        params=st.params.replace(scaling=jnp.asarray(scaling), opacity=jnp.asarray(opacity)),
        aux=st.aux.replace(alive=jnp.asarray(alive), xyz_grad_accum=jnp.asarray(accum),
                           denom=jnp.asarray(denom)),
        opt=st.opt.replace(mu=mu),
    ), dict(grad_threshold=0.5, extent=3.0, max_screen_size=20, percent_dense=0.06)


CASES = {
    "clone": _case_clone, "split": _case_split, "prune_opacity": _case_prune_opacity,
    "prune_world_size": _case_prune_world_size, "moments": _case_moments,
    "overflow": _case_overflow, "mixed": _case_mixed,
}


def _jax_noise(key, cap):
    """gsjax's own two split draws (densify.py:126-130)."""
    key_a, key_b = jax.random.split(key)
    return np.stack([np.asarray(jax.random.normal(k, (cap, 3))) for k in (key_a, key_b)])


def _run_both(jst, kw, center=None):
    key = jax.random.PRNGKey(0)
    jp, ja, jo, js = jdensify.densify_and_prune(
        jst.params, jst.aux, jst.opt, key, min_opacity=0.005,
        unbounded_center=None if center is None else jnp.asarray(center), **kw)
    st = train_state_from_numpy(jax_state_to_numpy(jst), "cpu")
    tp, ta, to, ts = densify.densify_and_prune(
        st.params, st.aux, st.opt, min_opacity=0.005,
        unbounded_center=None if center is None else t(center),
        noise=t(_jax_noise(key, jst.params.capacity)), **kw)
    return (jp, ja, jo, js), (tp, ta, to, ts)


def _assert_densify_equal(jax_out, port_out):
    (jp, ja, jo, js), (tp, ta, to, ts) = jax_out, port_out
    for k in densify.DensifyStats.__dataclass_fields__:
        assert int(getattr(ts, k)) == int(getattr(js, k)), k
        assert getattr(ts, k).dtype == torch.int32
    for k in ("alive", "max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_array_equal(n(getattr(ta, k)), np.asarray(getattr(ja, k)), k)
    # The split children: kept | clones | [split A | split B], cut at the
    # capacity.
    lo = (int(js.n_alive) + int(js.n_pruned) + int(js.n_dropped)
          - 2 * int(js.n_split))
    hi = lo + 2 * int(js.n_split)
    for k in PARAM_NAMES:
        got, want = n(getattr(tp, k)), np.asarray(getattr(jp, k))
        if k in ("xyz", "scaling"):
            np.testing.assert_allclose(got[lo:hi], want[lo:hi], rtol=0, atol=SPLIT_ATOL)
            got, want = np.delete(got, np.s_[lo:hi], 0), np.delete(want, np.s_[lo:hi], 0)
        np.testing.assert_array_equal(got, want, k)
        for moments_t, moments_j in ((to.mu, jo.mu), (to.nu, jo.nu)):
            np.testing.assert_array_equal(n(moments_t[k]), np.asarray(getattr(moments_j, k)))
    assert int(to.count) == int(jo.count)


@pytest.mark.parametrize("case", list(CASES))
def test_densify_matches_gsjax(case):
    jst, kw = CASES[case](_jax_state())
    jax_out, port_out = _run_both(jst, kw)
    _assert_densify_equal(jax_out, port_out)
    stats = port_out[3]
    if case == "clone":
        assert int(stats.n_cloned) == 2 and int(port_out[1].n_alive()) == 22
    elif case == "split":
        assert int(stats.n_split) == 1 and int(port_out[1].n_alive()) == 21
        np.testing.assert_allclose(np.exp(n(port_out[0].scaling[19:21])), 0.5 / 1.6,
                                   rtol=1e-5)
    elif case == "prune_opacity":
        assert int(stats.n_pruned) == 3
    elif case == "overflow":
        assert int(stats.n_dropped) == 56 and int(port_out[1].n_alive()) == 64
    elif case == "moments":
        np.testing.assert_array_equal(n(port_out[2].mu["xyz"][:19]), 1.0)
        np.testing.assert_array_equal(n(port_out[2].mu["xyz"][19:]), 0.0)
    elif case == "mixed":
        assert min(int(stats.n_cloned), int(stats.n_split), int(stats.n_pruned),
                   int(stats.n_dropped)) > 0


def test_densify_generator_draws_split_noise():
    """Without injected noise the split draws come from the generator:
    the same seed gives the same children as split_noise's draws
    injected."""
    jst, kw = _case_mixed(_jax_state())
    st = train_state_from_numpy(jax_state_to_numpy(jst), "cpu")
    args = (st.params, st.aux, st.opt)
    drawn = densify.densify_and_prune(
        *args, torch.Generator().manual_seed(5), min_opacity=0.005, **kw)
    noise = densify.split_noise(CAP, torch.device("cpu"), torch.Generator().manual_seed(5))
    injected = densify.densify_and_prune(*args, min_opacity=0.005, noise=noise, **kw)
    for k in PARAM_NAMES:
        assert torch.equal(getattr(drawn[0], k), getattr(injected[0], k))


def test_reset_opacity_matches_gsjax():
    jst = _jax_state()
    jst = jst.replace(opt=jst.opt.replace(mu=jax.tree.map(jnp.ones_like, jst.opt.mu)))
    jp, jo = jdensify.reset_opacity(jst.params, jst.opt)
    st = train_state_from_numpy(jax_state_to_numpy(jst), "cpu")
    tp, to = densify.reset_opacity(st.params, st.opt)
    np.testing.assert_allclose(n(tp.opacity), np.asarray(jp.opacity), rtol=0, atol=1e-6)
    assert float(torch.sigmoid(tp.opacity.detach()).max()) <= 0.01 + 1e-6
    for k in PARAM_NAMES:
        if k != "opacity":
            assert torch.equal(getattr(tp, k), getattr(st.params, k))
        want = 0.0 if k == "opacity" else 1.0
        np.testing.assert_array_equal(n(to.mu[k]), want)


def test_unbounded_prune_spares_far_shell():
    """tests/test_sky.py:64 through both packages: the flat 0.1*extent cut
    kills a far and a near splat; the distance-scaled cut spares the far
    one."""
    extent = 5.0
    params, aux = random_scene(2, capacity=8, sh_degree=1, seed=0)
    big = float(np.log(0.2 * extent))
    xyz = params.xyz.at[0].set(jnp.array([10 * extent, 0, 0])).at[1].set(jnp.array([0.1, 0, 0]))
    params = params.replace(xyz=xyz, scaling=params.scaling.at[:2].set(big),
                            opacity=params.opacity.at[:2].set(3.0))
    jst = JaxTrainState(params=params, opt=jax_adam_init(params), aux=aux, step=jnp.int32(1))
    kw = dict(grad_threshold=1e9, extent=extent, max_screen_size=20, percent_dense=0.01)
    flat = _run_both(jst, kw)
    _assert_densify_equal(*flat)
    assert int(flat[1][3].n_alive) == 0
    shell = _run_both(jst, kw, center=np.zeros(3, np.float32))
    _assert_densify_equal(*shell)
    assert int(shell[1][3].n_alive) == 1
    assert n(shell[1][1].alive).tolist()[:2] == [True, False]


def test_pow2_chunks_binary_decomposition():
    for size in range(1, 1025):
        chunks = trainer._pow2_chunks(size)
        assert chunks == jtrainer._pow2_chunks(size)
        assert sum(chunks) == size
        assert all(c & (c - 1) == 0 for c in chunks)
        assert chunks == sorted(chunks, reverse=True)
        assert len(chunks) == bin(size).count("1")


def test_grow_capacity_matches_gsjax():
    jst, _ = _case_mixed(_jax_state())
    jgrown = jtrainer.grow_capacity(jst, 256)
    st = train_state_from_numpy(jax_state_to_numpy(jst), "cpu")
    grown = trainer.grow_capacity(st, 256)
    want, got = jax_state_to_numpy(jgrown), train_state_to_numpy(grown)
    for part in ("params", "aux"):
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype
            np.testing.assert_array_equal(got[part][k], v, f"{part}.{k}")
    for k in PARAM_NAMES:
        for m in ("mu", "nu"):
            np.testing.assert_array_equal(got["opt"][m][k], want["opt"][m][k])
    assert grown.params is not st.params and grown.params.capacity == 256
    assert trainer.grow_capacity(st, CAP) is st


def test_fibonacci_sphere_and_shell_arrays():
    d = sky.fibonacci_sphere(500)
    np.testing.assert_array_equal(d, jax_fibonacci_sphere(500))
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    assert np.linalg.norm(d.mean(axis=0)) < 0.05
    center = np.array([1.0, -2.0, 3.0], np.float32)
    got = sky.sky_shell_arrays(256, center, radius=50.0, sh_degree=3)
    want = jax_sky_shell_arrays(256, center, radius=50.0, sh_degree=3)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), k)
    r = np.linalg.norm(got["xyz"] - center, axis=1)
    np.testing.assert_allclose(r, 50.0, rtol=1e-5)
    np.testing.assert_allclose(np.exp(got["scaling"]), 2.0 * 50.0 * np.sqrt(np.pi / 256),
                               rtol=1e-5)


def test_add_sky_shell_appends_and_grows():
    jparams, jaux = random_scene(100, capacity=128, sh_degree=1)
    jp2, ja2 = jax_add_sky_shell(jparams, jaux, 100, np.zeros(3, np.float32), 30.0)
    st = train_state_from_numpy(jax_state_to_numpy(JaxTrainState(
        params=jparams, opt=jax_adam_init(jparams), aux=jaux, step=jnp.int32(0))), "cpu")
    p2, a2 = sky.add_sky_shell(st.params, st.aux, 100, np.zeros(3, np.float32), 30.0)
    assert int(a2.n_alive()) == 200 and p2.capacity == jp2.capacity == 256
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(n(getattr(p2, k)), np.asarray(getattr(jp2, k)), k)
    np.testing.assert_array_equal(n(a2.alive), np.asarray(ja2.alive))
    r = np.linalg.norm(n(p2.xyz[100:200]), axis=1)
    np.testing.assert_allclose(r, 30.0, rtol=1e-4)


# --- on the card -------------------------------------------------------------


def _numpy_state(case: str) -> tuple[dict, dict]:
    """A TrainState as numpy (the port's random scene, statistics and
    moments drawn with numpy) and the densify thresholds, for the card
    tests: "mixed" as _case_mixed, "overflow" as _case_overflow, "large"
    20,000 Gaussians in 32,768 slots."""
    from gsjax_torch.synthetic import random_scene as torch_random_scene
    from gsjax_torch.train.optimizer import adam_init
    from gsjax_torch.train.step import TrainState

    n_alive, cap = {"mixed": (56, CAP), "overflow": (60, CAP), "large": (20_000, 1 << 15)}[case]
    params, aux = torch_random_scene(n_alive, capacity=cap, seed=3, device="cpu")
    tree = train_state_to_numpy(TrainState(params, adam_init(params), aux,
                                           torch.ones((), dtype=torch.int32)))
    rng = np.random.default_rng(11)
    if case == "overflow":
        tree["params"]["scaling"][:] = -5.0
        tree["aux"]["xyz_grad_accum"][:] = (np.arange(cap) < 60).astype(np.float32)
        tree["aux"]["denom"][:] = 1.0
        return tree, dict(grad_threshold=0.5, extent=10.0, max_screen_size=0,
                          percent_dense=0.01)
    tree["aux"]["alive"][rng.choice(n_alive, n_alive // 16, replace=False)] = False
    tree["params"]["scaling"][:] = np.log(rng.uniform(0.01, 0.35, (cap, 3)))
    tree["params"]["opacity"][rng.choice(n_alive, n_alive // 25, replace=False)] = -8.0
    tree["aux"]["xyz_grad_accum"][:] = rng.uniform(0.0, 2.0, cap)
    tree["aux"]["denom"][:] = rng.integers(0, 4, cap)
    for k in PARAM_NAMES:
        tree["opt"]["mu"][k][:] = rng.standard_normal(tree["opt"]["mu"][k].shape)
    return tree, dict(grad_threshold=0.5, extent=3.0, max_screen_size=20,
                      percent_dense=0.06)


@pytest.mark.cuda
def test_create_from_pcd_card_matches_cpu():
    from gsjax_torch.model import create_from_pcd

    rng = np.random.default_rng(4)
    pts = rng.uniform(-2.0, 2.0, (3000, 3))
    cols = rng.uniform(0.0, 1.0, (3000, 3))
    got = create_from_pcd(pts, cols, 3, device="cuda")
    want = create_from_pcd(pts, cols, 3, device="cpu")
    for k in PARAM_NAMES:
        np.testing.assert_allclose(n(getattr(got[0], k)), n(getattr(want[0], k)),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert torch.equal(got[1].alive.cpu(), want[1].alive)


@pytest.mark.cuda
def test_torch_knn_card_matches_cpu():
    """Summed coordinate differences and a top-3 are IEEE-exact on both."""
    from gsjax_torch.knn import mean_knn_dist2

    pts = np.random.default_rng(5).uniform(-2.0, 2.0, (20_000, 3)).astype(np.float32)
    got = mean_knn_dist2(torch.as_tensor(pts, device="cuda"))
    assert torch.equal(got.cpu(), mean_knn_dist2(torch.as_tensor(pts)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "overflow", "large"])
def test_densify_card_matches_cpu(case):
    tree, kw = _numpy_state(case)
    cap = tree["params"]["xyz"].shape[0]
    noise = np.random.default_rng(6).standard_normal((2, cap, 3)).astype(np.float32)
    outs = []
    for dev in ("cuda", "cpu"):
        st = train_state_from_numpy(tree, dev)
        outs.append(densify.densify_and_prune(
            st.params, st.aux, st.opt, min_opacity=0.005,
            noise=torch.as_tensor(noise, device=dev), **kw))
    (cp, ca, co, cs), (hp, ha, ho, hs) = outs
    for k in densify.DensifyStats.__dataclass_fields__:
        assert int(getattr(cs, k)) == int(getattr(hs, k)), k
    assert torch.equal(ca.alive.cpu(), ha.alive)
    if case != "overflow":
        assert min(int(cs.n_cloned), int(cs.n_split), int(cs.n_pruned)) > 0
    for k in PARAM_NAMES:
        np.testing.assert_allclose(n(getattr(cp, k)), n(getattr(hp, k)), rtol=0,
                                   atol=SPLIT_ATOL, err_msg=k)
        assert torch.equal(co.mu[k].cpu(), ho.mu[k]) and torch.equal(co.nu[k].cpu(), ho.nu[k])
