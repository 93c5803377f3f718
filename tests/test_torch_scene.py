"""The port's scene path against gsjax's, on the CPU: the resolution
policy, PLY and COLMAP files (the same bytes both ways), the splits and
the NeRF++ norm, the native library and the torch 3-NN, npz checkpoints
(loaded across packages), and whole Scenes built from datasets the tests
write (Blender and COLMAP, with and without the sky shell): the same
camera order, extent, centre, bank tensors and initial parameters. The
cases of tests/test_data.py, tests/test_native.py and
tests/test_checkpoint.py, held to the JAX package."""

from __future__ import annotations

import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import gsjax.data.camera_utils as jcamera_utils
import gsjax.data.colmap as jcolmap
import gsjax.data.dataset as jdataset
import gsjax.data.ply as jply
import gsjax.train.checkpoint as jcheckpoint
from gsjax.config import ModelConfig as JaxModelConfig
from gsjax.knn import mean_knn_dist2 as jax_mean_knn_dist2
from gsjax.model import GaussianParams as JaxGaussianParams
from gsjax.scene import Scene as JaxScene
from gsjax.train.optimizer import adam_init as jax_adam_init
from gsjax.train.step import TrainState as JaxTrainState
from gsjax_torch import native, profile_stages
from gsjax_torch.config import ModelConfig
from gsjax_torch.data import camera_utils, colmap, dataset, ply
from gsjax_torch.interop import (
    camera_bank_from_numpy,
    params_from_numpy,
    train_state_to_numpy,
)
from gsjax_torch.knn import mean_knn_dist2
from gsjax_torch.model import PARAM_NAMES
from gsjax_torch.scene import Scene
from gsjax_torch.train import checkpoint
from tests.scene_utils import random_scene
from tests.torch_parity import n, t
from tests.torch_parity import train_state_to_numpy as jax_state_to_numpy

torch.set_num_threads(1)
# exp/log/sqrt of separate float32 libraries: a few ulps of log-scales ~ -3.
INIT_ATOL = 1e-6
KNN_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_native.py's


# --- resolution, PLY ----------------------------------------------------------


RESOLUTION_CASES = [
    ((800, 600, 1), (800, 600)), ((800, 600, 2), (400, 300)),
    ((800, 600, 4), (200, 150)), ((800, 600, 8), (100, 75)),
    ((3200, 2400, -1), (1600, 1200)), ((1200, 900, -1), (1200, 900)),
    ((3000, 1500, 1000), (1000, 500)), ((800, 600, 2, 2.0), (200, 150)),
]


def test_resolution_policy():
    for args, want in RESOLUTION_CASES:
        assert camera_utils.resolve_resolution(*args) == want
        assert jcamera_utils.resolve_resolution(*args) == want


def _ply_params(n_rows=7, sh=3, seed=0):
    rng = np.random.default_rng(seed)
    k = (sh + 1) ** 2
    shapes = dict(xyz=(3,), features_dc=(1, 3), features_rest=(k - 1, 3),
                  scaling=(3,), rotation=(4,), opacity=(1,))
    return {name: rng.normal(size=(n_rows, *s)).astype(np.float32)
            for name, s in shapes.items()}


def test_gaussian_ply_schema_roundtrip_and_bytes(tmp_path):
    arrays = _ply_params()
    alive = np.array([1, 0, 1, 1, 0, 1, 1], bool)
    for mask in (None, alive):
        ours, theirs = str(tmp_path / "ours.ply"), str(tmp_path / "theirs.ply")
        ply.save_gaussian_ply(ours, params_from_numpy(arrays, "cpu"),
                              None if mask is None else torch.as_tensor(mask))
        jply.save_gaussian_ply(theirs, JaxGaussianParams(**arrays), mask)
        assert open(ours, "rb").read() == open(theirs, "rb").read()
        back, jback = ply.load_gaussian_ply(theirs), jply.load_gaussian_ply(ours)
        rows = slice(None) if mask is None else mask
        for k in PARAM_NAMES:
            np.testing.assert_array_equal(back[k], arrays[k][rows])
            np.testing.assert_array_equal(jback[k], back[k])
    expect = (["x", "y", "z", "nx", "ny", "nz"] + [f"f_dc_{i}" for i in range(3)]
              + [f"f_rest_{i}" for i in range(45)] + ["opacity"]
              + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])
    assert list(ply.read_ply(ours).keys()) == expect


def test_points_ply_bytes_and_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(11, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (11, 3)).astype(np.float64)
    ours, theirs = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    ply.store_points_ply(ours, xyz, rgb)
    jply.store_points_ply(theirs, xyz, rgb)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got, want = ply.fetch_points_ply(theirs), jply.fetch_points_ply(ours)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], xyz, atol=1e-6)
    np.testing.assert_allclose(got[1] * 255.0, rgb, atol=1.0)


# --- COLMAP -------------------------------------------------------------------


def test_images_text_with_empty_points2d(tmp_path):
    p = tmp_path / "images.txt"
    p.write_text(
        "# images.txt\n"
        "1 0.1 0.2 0.3 0.9 1.0 2.0 3.0 1 a.png\n"
        "384.5 120.2 17 22.1 55.0 3\n"
        "2 0.4 0.5 0.6 0.7 4.0 5.0 6.0 1 b.png\n"
        "\n"
        "3 0.7 0.8 0.9 0.1 7.0 8.0 9.0 2 c.png\n"
        "1.0 2.0 5\n"
    )
    got, want = colmap.read_images_text(str(p)), jcolmap.read_images_text(str(p))
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for k in got:
        for f in ("id", "camera_id", "name"):
            assert getattr(got[k], f) == getattr(want[k], f)
        np.testing.assert_array_equal(got[k].qvec, want[k].qvec)
        np.testing.assert_array_equal(got[k].tvec, want[k].tvec)
    assert got[2].name == "b.png" and got[3].camera_id == 2


def _write_points3d_with_tracks(path, xyz, rgb, err, track_lens):
    """tests/test_native.py's writer: points with non-empty tracks."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i + 1, *xyz[i], *rgb[i], err[i]))
            f.write(struct.pack("<Q", track_lens[i]))
            for k in range(track_lens[i]):
                f.write(struct.pack("<ii", k, k))


def test_colmap_binary_files_match_gsjax(tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", 640, 480, np.array([500.0, 510.0, 320.0, 240.0])),
            2: colmap.ColmapCamera(2, "SIMPLE_PINHOLE", 320, 200, np.array([300.0, 160.0, 100.0]))}
    images = {i: colmap.ColmapImage(i, rng.normal(size=4), rng.normal(size=3), 1 + i % 2,
                                    f"im_{i}.png") for i in (3, 1, 2)}
    xyz, rgb, err = rng.normal(size=(137, 3)), rng.integers(0, 256, (137, 3)), rng.random(137)
    for name, write, jwrite, args in (
        ("cameras.bin", colmap.write_cameras_binary, jcolmap.write_cameras_binary, (cams,)),
        ("images.bin", colmap.write_images_binary, jcolmap.write_images_binary, (images,)),
        ("points3D.bin", colmap.write_points3d_binary, jcolmap.write_points3d_binary,
         (xyz, rgb, err)),
    ):
        write(*args, str(tmp_path / name))
        jwrite(*args, str(tmp_path / f"j_{name}"))
        assert (tmp_path / name).read_bytes() == (tmp_path / f"j_{name}").read_bytes(), name
    got, want = colmap.read_cameras_binary(str(tmp_path / "cameras.bin")), cams
    assert {k: (c.model, c.width, c.height, c.params.tolist()) for k, c in got.items()} == \
        {k: (c.model, c.width, c.height, c.params.tolist()) for k, c in want.items()}
    got = colmap.read_images_binary(str(tmp_path / "images.bin"))
    assert list(got) == [3, 1, 2] and got[2].name == "im_2.png"
    np.testing.assert_array_equal(got[1].qvec, images[1].qvec)

    tracks = str(tmp_path / "tracks.bin")
    _write_points3d_with_tracks(tracks, xyz, rgb, err, rng.integers(0, 7, 137))
    want = jcolmap.read_points3d_binary(tracks)
    if native.load_native() is not None:
        for a, b in zip(native.read_points3d_binary_native(tracks), want):
            np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(native, "read_points3d_binary_native", lambda path: None)
    for a, b, c in zip(colmap.read_points3d_binary(tracks), want, (xyz, rgb, err)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_qvec_rotmat_and_nerfpp_norm():
    rng = np.random.default_rng(3)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = colmap.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
        np.testing.assert_array_equal(colmap.rotmat2qvec(R), jcolmap.rotmat2qvec(R))
    infos, jinfos = [], []
    for i in range(12):
        center = np.array([np.cos(i), 0.0, np.sin(i)])
        kw = dict(uid=i, R=np.eye(3), T=-center, fov_x=0.8, fov_y=0.6,
                  image_path=f"im_{i:03d}.png", image_name=f"im_{i:03d}", width=64, height=48)
        infos.append(dataset.CameraInfo(**kw))
        jinfos.append(jdataset.CameraInfo(**kw))
    norm, jnorm = dataset.get_nerfpp_norm(infos), jdataset.get_nerfpp_norm(jinfos)
    assert norm["radius"] == jnorm["radius"]
    np.testing.assert_array_equal(norm["translate"], jnorm["translate"])
    centers = np.stack([-info.T for info in infos])
    diag = np.linalg.norm(centers - centers.mean(0), axis=1).max()
    np.testing.assert_allclose(norm["radius"], diag * 1.1, rtol=1e-5)


# --- native library and the 3-NN ---------------------------------------------


def _brute_knn(pts):
    """Mean of the three smallest float32 squared distances (coordinate
    differences, summed x + y + z), self excluded, unmatched slots 0."""
    d2 = None
    for a in range(3):
        d = pts[:, None, a] - pts[None, :, a]
        d2 = d * d if d2 is None else d2 + d * d
    np.fill_diagonal(d2, np.inf)
    best = np.sort(d2, axis=1)[:, :3]
    if best.shape[1] < 3:
        best = np.pad(best, ((0, 0), (0, 3 - best.shape[1])), constant_values=np.inf)
    best = np.where(np.isfinite(best), best, np.float32(0))
    return (best[:, 0] + best[:, 1] + best[:, 2]) / np.float32(3)


def test_torch_knn_is_exact():
    rng = np.random.default_rng(0)
    clustered = np.concatenate([rng.normal(0, 0.01, (500, 3)), rng.normal(5, 2.0, (700, 3))])
    line = np.stack([np.linspace(0, 1, 400), np.zeros(400), np.zeros(400)], 1)
    dupes = np.repeat(rng.uniform(-1, 1, (150, 3)), 3, axis=0)
    for pts in (rng.uniform(-3, 7, (2500, 3)), clustered, line, dupes,
                *[rng.normal(size=(k, 3)) for k in (1, 2, 3, 4, 5)]):
        pts = pts.astype(np.float32)
        got = n(mean_knn_dist2(t(pts), row_block=128, col_block=300))
        np.testing.assert_array_equal(got, _brute_knn(pts))


def test_knn_native_torch_and_gsjax_agree():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((2000, 3)).astype(np.float32)
    ours = n(mean_knn_dist2(t(pts)))
    np.testing.assert_allclose(ours, np.asarray(jax_mean_knn_dist2(pts)), **KNN_TOL)
    if native.load_native() is None:
        pytest.skip(f"native library unavailable: {native.unavailable_reason}")
    np.testing.assert_allclose(native.mean_knn_dist2_native(pts), ours, **KNN_TOL)
    tiny = np.array([[0, 0, 0], [1, 0, 0]], np.float32)
    np.testing.assert_array_equal(n(mean_knn_dist2(t(tiny))),
                                  np.asarray(jax_mean_knn_dist2(tiny)))
    np.testing.assert_allclose(native.mean_knn_dist2_native(tiny), [1.0, 1.0], atol=1e-6)


def test_native_builds_in_the_ports_own_directory():
    if native.load_native() is None:
        pytest.skip(f"native library unavailable: {native.unavailable_reason}")
    path = native.build()
    assert path.exists() and path.parent.parent == native.BUILD_ROOT
    assert "native/build" not in str(path)
    assert not [p for p in path.parent.iterdir() if p != path]  # no temporaries left


def test_native_build_passes_over_a_broken_cxx(tmp_path, monkeypatch):
    """A CXX that cannot build the library (e.g. a toolchain without
    OpenMP) is passed over for the g++ on PATH."""
    if native.load_native() is None:
        pytest.skip(f"native library unavailable: {native.unavailable_reason}")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    assert native._compilers()[0] == str(tmp_path / "no-such-g++")
    path = native.build()
    assert path.exists() and path.parent.parent == tmp_path
    assert not [p for p in path.parent.iterdir() if p != path]


# --- checkpoints --------------------------------------------------------------


def _jax_ckpt_state():
    params, aux = random_scene(50, capacity=64, sh_degree=2, seed=5)
    opt = jax_adam_init(params)
    opt = opt.replace(count=jnp.int32(7), mu=jax.tree.map(lambda x: x + 0.25, opt.mu))
    return JaxTrainState(params=params, opt=opt, aux=aux, step=jnp.int32(123))


def test_npz_save_is_atomic_and_overwrites(tmp_path):
    path = str(tmp_path / "chk.npz")
    jcheckpoint.save_checkpoint(path, _jax_ckpt_state(), 2, 3.5)
    state, _, _ = checkpoint.load_checkpoint(path, "cpu")
    checkpoint.save_checkpoint(path, state, active_sh_degree=2, spatial_lr_scale=3.5)
    checkpoint.save_checkpoint(path, state, active_sh_degree=3, spatial_lr_scale=3.5)
    _, sh, _ = checkpoint.load_checkpoint(path, "cpu")
    assert sh == 3
    assert os.listdir(tmp_path) == ["chk.npz"]
    checkpoint.save_checkpoint(str(tmp_path / "bare"), state, 1, 1.0)
    assert (tmp_path / "bare.npz").exists()


def test_npz_checkpoint_loads_across_packages(tmp_path):
    jstate = _jax_ckpt_state()
    theirs, ours = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    extra = {"stack": np.arange(5, dtype=np.int32), "key": np.array([1, 2], np.uint32)}
    jcheckpoint.save_checkpoint(theirs, jstate, 2, 3.5, extra=extra)
    state, sh, lr, got_extra = checkpoint.load_checkpoint_extra(theirs, "cpu")
    assert (sh, lr, int(state.step), int(state.opt.count)) == (2, 3.5, 123, 7)
    checkpoint.save_checkpoint(ours, state, sh, lr, extra=got_extra)
    with np.load(theirs) as a, np.load(ours) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], k)
    back, sh2, lr2, extra2 = jcheckpoint.load_checkpoint_extra(ours)
    assert (sh2, lr2) == (2, 3.5)
    for la, lb in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    np.testing.assert_array_equal(extra2["key"], extra["key"])
    want = jax_state_to_numpy(jstate)
    got = train_state_to_numpy(state)
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(got["params"][k], want["params"][k])
        np.testing.assert_array_equal(got["opt"]["mu"][k], want["opt"]["mu"][k])


# --- scenes -------------------------------------------------------------------


def _orbit_c2w(angle, radius=4.0):
    """OpenGL camera-to-world looking at the origin (y up, -z forward)."""
    pos = radius * np.array([np.sin(angle), 0.3, np.cos(angle)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, pos
    return c2w


def _image(i, w, h, rgba):
    yy, xx = np.mgrid[:h, :w]
    img = np.zeros((h, w, 4 if rgba else 3), np.uint8)
    r2 = (yy - h / 2) ** 2 + (xx - w / 2) ** 2
    img[r2 < (8 + i) ** 2] = 255
    img[..., 0] = (xx * 5 + i * 17) % 256
    if rgba:
        img[..., 3] = np.where(xx < w // 3, 128, 255)
    return img


@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    """6 train + 2 test RGBA views, 40x32, and a 300-point seed cloud."""
    root = tmp_path_factory.mktemp("blender")
    for split, count, offset in (("train", 6, 0.0), ("test", 2, 0.5)):
        os.makedirs(root / split)
        frames = []
        for i in range(count):
            Image.fromarray(_image(i, 40, 32, True)).save(root / split / f"r_{i}.png")
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": _orbit_c2w((i + offset) * 0.6).tolist()})
        (root / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.9, "frames": frames}))
    rng = np.random.default_rng(0)
    ply.store_points_ply(str(root / "points3d.ply"), rng.uniform(-0.5, 0.5, (300, 3)),
                         rng.uniform(0, 255, (300, 3)))
    return str(root)


@pytest.fixture(scope="module")
def colmap_root(tmp_path_factory):
    """9 PINHOLE views, 48x36, with a 500-point points3D.bin."""
    root = tmp_path_factory.mktemp("colmap")
    sparse = root / "sparse" / "0"
    os.makedirs(sparse)
    os.makedirs(root / "images")
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", 48, 36, np.array([40.0, 41.0, 24.0, 18.0]))}
    images = {}
    for i in range(9):
        c2w = _orbit_c2w(i * 0.5)
        c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        name = f"view_{(i * 5) % 9:02d}.png"
        images[i + 1] = colmap.ColmapImage(i + 1, colmap.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3],
                                           1, name)
        Image.fromarray(_image(i, 48, 36, False)).save(root / "images" / name)
    colmap.write_cameras_binary(cams, str(sparse / "cameras.bin"))
    colmap.write_images_binary(images, str(sparse / "images.bin"))
    rng = np.random.default_rng(1)
    colmap.write_points3d_binary(rng.uniform(-1, 1, (500, 3)), rng.integers(0, 256, (500, 3)),
                                 rng.random(500), str(sparse / "points3D.bin"))
    return str(root)


SCENES = {
    "blender": ("blender_root", dict(eval=True)),
    "blender_sky": ("blender_root", dict(sky_gaussians=800)),
    "colmap": ("colmap_root", dict(eval=True)),
}


@pytest.mark.parametrize("case", list(SCENES))
def test_scene_matches_gsjax(case, request, tmp_path):
    fixture, kw = SCENES[case]
    root = request.getfixturevalue(fixture)
    cfg = dict(source_path=root, sh_degree=2, resolution=1, **kw)
    jscene = JaxScene(JaxModelConfig(model_path=str(tmp_path / "jax"), **cfg))
    scene = Scene(ModelConfig(model_path=str(tmp_path / "torch"), **cfg), device="cpu")

    for split in ("train_cameras", "test_cameras"):
        assert ([c.image_name for c in getattr(scene.info, split)]
                == [c.image_name for c in getattr(jscene.info, split)])
    assert scene.cameras_extent == jscene.cameras_extent
    np.testing.assert_array_equal(scene.scene_center, jscene.scene_center)
    for name in ("input.ply", "cameras.json"):
        assert ((tmp_path / "torch" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name

    for banks, jbanks in ((scene.train_banks, jscene.train_banks),
                          (scene.test_banks, jscene.test_banks)):
        assert len(banks[1.0]) == len(jbanks[1.0])
        for bank, jbank in zip(banks[1.0], jbanks[1.0]):
            mirror = camera_bank_from_numpy(
                {k: np.asarray(getattr(jbank, k)) for k in (
                    "views", "full_projs", "centers", "tan_fovx", "tan_fovy", "gt_rgb",
                    "alpha")} | {"width": jbank.width, "height": jbank.height}, "cpu")
            for k in ("views", "full_projs", "centers", "tan_fovx", "tan_fovy", "gt_rgb",
                      "alpha"):
                assert torch.equal(getattr(bank, k), getattr(mirror, k)), k
            assert (bank.width, bank.height) == (jbank.width, jbank.height)
            for i in range(bank.count):
                cam, gt = bank.pick(torch.tensor(i))
                jcam, jgt = jbank.pick(i)
                np.testing.assert_array_equal(n(gt), np.asarray(jgt))
                np.testing.assert_array_equal(n(cam.full_proj), np.asarray(jcam.full_proj))

    assert scene.params.capacity == jscene.params.capacity
    np.testing.assert_array_equal(n(scene.aux.alive), np.asarray(jscene.aux.alive))
    for k in PARAM_NAMES:
        got, want = n(getattr(scene.params, k)), np.asarray(getattr(jscene.params, k))
        if k in ("scaling", "opacity"):
            np.testing.assert_allclose(got, want, rtol=0, atol=INIT_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, k)


def test_scene_save_and_reload(blender_root, tmp_path):
    cfg = ModelConfig(source_path=blender_root, model_path=str(tmp_path), sh_degree=1)
    scene = Scene(cfg, device="cpu")
    alive = scene.aux.alive.clone()
    alive[::7] = False
    scene.save(30, scene.params, alive)
    back = Scene(cfg, load_iteration=-1, device="cpu")
    jback = JaxScene(JaxModelConfig(source_path=blender_root, model_path=str(tmp_path),
                                    sh_degree=1), load_iteration=30)
    assert back.loaded_iter == 30 and int(back.aux.n_alive()) == int(alive.sum())
    for k in PARAM_NAMES:
        got = n(getattr(back.params, k))
        np.testing.assert_array_equal(got[: int(alive.sum())], n(getattr(scene.params, k))[n(alive)])
        np.testing.assert_array_equal(got, np.asarray(getattr(jback.params, k)), k)


def test_scene_defaults_to_cuda(blender_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scene(ModelConfig(source_path=blender_root, model_path=str(tmp_path)))


def test_random_init_points_ply_matches_gsjax(blender_root, tmp_path):
    """Without a seed cloud the Blender reader writes 100k random points:
    the same bytes from both packages."""
    for pkg, reader in (("torch", dataset.read_nerf_synthetic_info),
                        ("jax", jdataset.read_nerf_synthetic_info)):
        root = tmp_path / pkg
        os.makedirs(root)
        for name in ("train", "test", "transforms_train.json", "transforms_test.json"):
            os.symlink(os.path.join(blender_root, name), root / name)
        reader(str(root), False, False)
    assert ((tmp_path / "torch" / "points3d.ply").read_bytes()
            == (tmp_path / "jax" / "points3d.ply").read_bytes())


# --- profile_stages --ply -------------------------------------------------------


def test_profile_stages_ply_scene_on_cpu(tmp_path):
    from tools.bench_trained import _orbit_camera

    jparams, jaux = random_scene(300, capacity=512, sh_degree=1, seed=4)
    path = str(tmp_path / "point_cloud.ply")
    jply.save_gaussian_ply(path, jparams, jaux.alive)
    params, aux, camera, cfg, sh = profile_stages.ply_scene(
        path, orbit=0.3, width=64, height=48, device="cpu", probe_budget=1 << 16)
    assert sh == 1 and params.capacity == 1024 and int(aux.n_alive()) == 300
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(n(getattr(params, k))[:300],
                                      np.asarray(getattr(jparams, k))[:300])
    jcam = _orbit_camera(0.3, 64, 48)
    for k in ("view", "full_proj", "cam_center", "tan_fovx", "tan_fovy"):
        np.testing.assert_array_equal(n(getattr(camera, k)), np.asarray(getattr(jcam, k)))
    stages = profile_stages.Stages(params, aux, camera, cfg, sh)
    out = stages.fwd_only()
    assert torch.isfinite(out)
    assert cfg.max_instances >= 1 << 16 and cfg.max_rows >= 1 << 16
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            profile_stages.main(["--ply", path, "--orbit", "0.3"])
