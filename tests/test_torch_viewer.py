"""The port's viewer path on the CPU, held to gsjax: Camera.from_matrices
and cov6_to_mat; NetworkGUI's requests and replies over a real local
socket (the SIBR_remoteGaussian wire format, byte for byte); a served
frame against gsjax's render of the original camera; the Trainer's
viewer polling (frames served between windows, the break rule, a
dropped connection); the train CLI's listener; and gsjax's sky case
(tests/test_sky.py::test_sky_visible_in_render) through the port's
render. Servers bind port 0."""

from __future__ import annotations

import json
import socket
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.config import RasterConfig as JRasterConfig
from gsjax.core.cameras import Camera as JCamera
from gsjax.core.transforms import cov6_to_mat as jcov6_to_mat
from gsjax.render.api import render as jrender
from gsjax.sky import add_sky_shell as jadd_sky_shell
from gsjax.synthetic import orbit_camera as jorbit_camera
from gsjax.synthetic import random_scene as jrandom_scene
from gsjax.viewer.network_gui import NetworkGUI as JNetworkGUI
from gsjax_torch.cli import train as train_cli
from gsjax_torch.config import OptimizationConfig, RasterConfig
from gsjax_torch.core.cameras import Camera
from gsjax_torch.core.transforms import cov6_to_mat
from gsjax_torch.render.api import render
from gsjax_torch.sky import add_sky_shell
from gsjax_torch.synthetic import look_at_origin_camera, random_scene
from gsjax_torch.train import step as steps
from gsjax_torch.train import trainer as trainer_mod
from gsjax_torch.viewer import NetworkGUI, ViewerRequest
from tests.scene_utils import look_at_origin_camera as jlook_at_origin_camera
from tests.test_torch_trainer import TINY, port_trainer, write_blender_dataset
from tests.test_viewer import _client_message, _recv_exact, _send_msg
from tests.torch_parity import n, to_torch_params

torch.set_num_threads(1)
TIMEOUT = 30


def _flipped(msg):
    """The f32 matrices a server hands Camera.from_matrices (the message's
    columns negated back: network_gui.py:75-81)."""
    view = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
    view[:, 1] = -view[:, 1]
    view[:, 2] = -view[:, 2]
    full = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    full[:, 1] = -full[:, 1]
    return view, full


def _messages():
    cams = [(jlook_at_origin_camera(48, 32), 48, 32),
            (jorbit_camera(0.3, width=64, height=48), 64, 48),
            (jorbit_camera(-1.1, radius=2.5, width=33, height=17), 33, 17)]
    return [json.loads(json.dumps(_client_message(c, w, h))) for c, w, h in cams]


@pytest.mark.parametrize("which", range(3))
def test_from_matrices_matches_gsjax(which):
    msg = _messages()[which]
    args = (*_flipped(msg), msg["fov_x"], msg["fov_y"], msg["resolution_x"],
            msg["resolution_y"])
    got, want = Camera.from_matrices(*args, device="cpu"), JCamera.from_matrices(*args)
    for k in ("view", "full_proj", "tan_fovx", "tan_fovy"):
        assert getattr(got, k).dtype == torch.float32
        np.testing.assert_array_equal(n(getattr(got, k)), np.asarray(getattr(want, k)), k)
    np.testing.assert_allclose(n(got.cam_center), np.asarray(want.cam_center), rtol=0,
                               atol=1e-6)
    assert (got.width, got.height) == (want.width, want.height)


def test_cov6_to_mat_matches_gsjax():
    c = np.random.default_rng(0).normal(size=(5, 2, 6)).astype(np.float32)
    got = cov6_to_mat(torch.from_numpy(c))
    assert got.shape == (5, 2, 3, 3)
    np.testing.assert_array_equal(n(got), np.asarray(jcov6_to_mat(jnp.asarray(c))))


@pytest.fixture
def servers():
    """A port server and a gsjax server, each with a connected client."""
    pairs = []
    for cls in (NetworkGUI, JNetworkGUI):
        gui = cls(host="127.0.0.1", port=0)
        client = socket.create_connection(
            ("127.0.0.1", gui.listener.getsockname()[1]), timeout=TIMEOUT)
        gui.try_connect()
        assert gui.conn is not None
        pairs.append((gui, client))
    yield pairs
    for gui, client in pairs:
        client.close()
        gui.listener.close()


def test_requests_match_gsjax(servers):
    msgs = _messages()
    msgs[1].update(train=False, shs_python=True, scaling_modifier=0.5)
    msgs[2].update(keep_alive=False, rot_scale_python=True)
    msgs.append(dict(msgs[0], resolution_x=0, resolution_y=0))
    for msg in msgs:
        reqs = []
        for gui, client in servers:
            _send_msg(client, msg)
            reqs.append(gui.receive("cpu") if isinstance(gui, NetworkGUI) else gui.receive())
        got, want = reqs
        assert isinstance(got, ViewerRequest)
        for k in ("do_training", "do_shs_python", "do_rot_scale_python", "keep_alive",
                  "scaling_modifier"):
            assert getattr(got, k) == getattr(want, k), k
        if want.camera is None:
            assert got.camera is None
            continue
        for k in ("view", "full_proj", "cam_center", "tan_fovx", "tan_fovy"):
            np.testing.assert_array_equal(n(getattr(got.camera, k)),
                                          np.asarray(getattr(want.camera, k)), k)


def test_replies_match_gsjax(servers):
    """The same reply bytes: image_to_bytes of one float image (values
    below 0, above 1 and on the uint8 steps), then the source path."""
    rng = np.random.default_rng(1)
    img = rng.uniform(-0.5, 1.5, (3, 7, 5)).astype(np.float32)
    img[0, 0, :] = np.arange(5, dtype=np.float32) / 255.0
    got = NetworkGUI.image_to_bytes(torch.from_numpy(img))
    assert got == JNetworkGUI.image_to_bytes(img)
    replies = []
    for gui, client in servers:
        gui.send(got, "source/path")
        gui.send(None, "keep-alive")
        replies.append(_recv_exact(client, 7 * 5 * 3 + 4 + 11 + 4 + 10))
    assert replies[0] == replies[1]


@pytest.fixture(scope="module")
def scene50():
    """test_viewer.py's full-loop scene, and gsjax's interpret-mode render
    of the original camera (jitted: one compile), computed once."""
    params, aux = jrandom_scene(50, seed=3)
    cam = jlook_at_origin_camera(48, 32)
    cfg = JRasterConfig(max_instances=1 << 12, max_rows=1 << 12, interpret=True)
    image = jax.jit(lambda p, a: jrender(p, cam, active_sh_degree=3, bg_color=jnp.zeros(3),
                                         cfg=cfg, alive=a).image)(params, aux.alive)
    return params, aux, cam, np.asarray(image)


def test_served_frame_matches_gsjax_render(servers, scene50):
    """Client request -> the port's server and fast render of the received
    camera -> the reply bytes against gsjax's render of the original
    camera, within one uint8 level (tests/test_viewer.py:158)."""
    jparams, jaux, cam, direct = scene50
    gui, client = servers[0]
    _send_msg(client, _client_message(cam, 48, 32))
    req = gui.receive("cpu")
    with torch.no_grad():
        served = render(to_torch_params(jparams), req.camera, active_sh_degree=3,
                        bg_color=torch.zeros(3),
                        cfg=RasterConfig(max_instances=1 << 12, max_rows=1 << 12,
                                         fast_fwd=True),
                        alive=torch.from_numpy(np.array(jaux.alive)),
                        scaling_modifier=req.scaling_modifier).image
    gui.send(NetworkGUI.image_to_bytes(served), "m")
    got = np.frombuffer(_recv_exact(client, 48 * 32 * 3), np.uint8).astype(np.int16)
    want = np.frombuffer(JNetworkGUI.image_to_bytes(direct), np.uint8).astype(np.int16)
    assert np.abs(got - want).max() <= 1
    assert want.max() > 0


# --- the Trainer's viewer polling, and the train CLI's listener ------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_blender_dataset(str(tmp_path_factory.mktemp("viewer_scene")))


class Client(threading.Thread):
    """A SIBR client on its own thread: sends each (message or raw bytes,
    expected image size) in turn and reads its reply (the image, if any,
    then the source path); stops at a closed connection."""

    def __init__(self, port, requests):
        super().__init__(daemon=True)
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
        self.requests = requests
        self.replies, self.closed = [], False

    def run(self):
        try:
            for msg, nbytes in self.requests:
                if isinstance(msg, bytes):
                    self.sock.sendall(len(msg).to_bytes(4, "little") + msg)
                else:
                    _send_msg(self.sock, msg)
                if nbytes is None:  # the server drops the connection
                    self.closed = self.sock.recv(1) == b""
                    return
                image = _recv_exact(self.sock, nbytes) if nbytes else None
                path = _recv_exact(self.sock, int.from_bytes(_recv_exact(self.sock, 4),
                                                             "little"))
                self.replies.append((image, path.decode("ascii")))
        finally:
            self.sock.close()


def _frame_message(camera, width, height, **kw):
    return _client_message(camera, width, height, train=False, keep_alive=True, **kw)


def test_poll_gui_serves_frames_and_breaks(dataset, tmp_path):
    gui = NetworkGUI("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    t = port_trainer(dataset, tmp_path / "m", OptimizationConfig(), gui=gui)
    frames = []
    render_view = t.render_view
    t.render_view = lambda *a, **kw: frames.append(kw) or render_view(*a, **kw)
    before = [x.clone() for x in steps.state_tensors(t.state)]
    cam, _ = t.banks[0].pick(2)
    w, h = 32, 24
    cam = Camera.from_matrices(n(cam.view).T, n(cam.full_proj).T, 0.9, 0.9, w, h,
                               device="cpu")
    try:
        # Three frames and a keep-alive; a request to train while the run
        # has steps left ends the poll.
        client = Client(port, [(_frame_message(cam, w, h), w * h * 3)] * 3
                        + [(_frame_message(cam, 0, 0), 0),
                           (_client_message(cam, w, h), w * h * 3)])
        client.start()
        t._poll_gui(5, 10)
        client.join(TIMEOUT)
        assert not client.is_alive() and len(client.replies) == 5
        assert len(frames) == 4 and all(f["fast"] for f in frames)
        want = NetworkGUI.image_to_bytes(t.render_view(cam, fast=True))
        for image, path in client.replies:
            assert path == dataset
            if image is not None:
                diff = np.frombuffer(image, np.uint8).astype(np.int16) - np.frombuffer(
                    want, np.uint8)
                assert np.abs(diff).max() <= 1
        assert client.replies[3][0] is None
        for x, y in zip(steps.state_tensors(t.state), before):
            assert torch.equal(x, y)  # frames write nothing of the state

        # At the run's end a kept-alive client keeps the poll serving until
        # it lets go; then a malformed request drops the connection.
        gui.drop()
        client = Client(port, [(_client_message(cam, w, h), w * h * 3),
                               (_client_message(cam, w, h, keep_alive=False), w * h * 3)])
        client.start()
        t._poll_gui(10, 10)
        client.join(TIMEOUT)
        assert len(client.replies) == 2 and len(frames) == 7 and gui.conn is not None
        gui.drop()
        client = Client(port, [(b"not json", None)])
        client.start()
        t._poll_gui(5, 10)
        client.join(TIMEOUT)
        assert gui.conn is None and client.closed
    finally:
        gui.close()


def _train_argv(dataset, model, port):
    return ["-s", dataset, "-m", str(model), "--iterations", "1", "--port", str(port),
            "--data_device", "cpu", "--quiet"]


def test_train_cli_listens(dataset, tmp_path, monkeypatch):
    """cli.train starts the viewer server on --port (0: any free port) and
    serves a client from the first window; a port in use trains without
    it."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(trainer_mod, "RasterConfig", lambda: TINY)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    made = []

    def server(host, port):
        gui = NetworkGUI(host, port)
        made.append(gui)
        # A client that asks for a frame and to train on: the first poll
        # accepts it, replies with the frame and the source path, and lets
        # the window run.
        client = socket.create_connection(
            ("127.0.0.1", gui.listener.getsockname()[1]), timeout=TIMEOUT)
        _send_msg(client, _client_message(jlook_at_origin_camera(8, 8), 8, 8,
                                          keep_alive=False))
        made.append(client)
        return gui

    monkeypatch.setattr(train_cli, "NetworkGUI", server)
    trainer = train_cli.main(_train_argv(dataset, tmp_path / "a", 0))
    gui, client = made
    assert trainer.gui is gui and int(trainer.state.step) == 1
    assert len(_recv_exact(client, 8 * 8 * 3)) == 8 * 8 * 3
    reply = _recv_exact(client, 4)
    assert _recv_exact(client, int.from_bytes(reply, "little")).decode() == dataset
    client.close()
    assert gui.listener.fileno() == -1  # closed when training ends

    monkeypatch.setattr(train_cli, "NetworkGUI", NetworkGUI)
    busy = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    busy.bind(("127.0.0.1", 0))
    busy.listen()
    try:
        trainer = train_cli.main(_train_argv(dataset, tmp_path / "b",
                                             busy.getsockname()[1]))
    finally:
        busy.close()
    assert trainer.gui is None and int(trainer.state.step) == 1


# --- the sky case that waited for the viewer -------------------------------------


def test_sky_visible_in_render():
    """tests/test_sky.py::test_sky_visible_in_render through the port: the
    scene built by the port's random_scene and add_sky_shell, rendered by
    the port, within 2e-3 of gsjax's render of its own scene (both with
    2^14 rows, which the 404 Gaussians do not fill, where the case takes
    the default 2^21)."""
    params, aux = random_scene(4, capacity=512, sh_degree=0, seed=2, device="cpu")
    aux = type(aux)(alive=torch.zeros_like(aux.alive), max_radii2d=aux.max_radii2d,
                    xyz_grad_accum=aux.xyz_grad_accum, denom=aux.denom)
    params, aux = add_sky_shell(params, aux, 400, np.zeros(3, np.float32), 20.0)
    with torch.no_grad():
        img = n(render(params, look_at_origin_camera(64, 48, device="cpu"),
                       active_sh_degree=0, bg_color=torch.zeros(3),
                       cfg=RasterConfig(max_instances=2**14, max_rows=2**14),
                       alive=aux.alive).image)

    jparams, jaux = jrandom_scene(4, capacity=512, sh_degree=0, seed=2)
    jaux = jaux.replace(alive=jnp.zeros_like(jaux.alive))
    jparams, jaux = jadd_sky_shell(jparams, jaux, 400, np.zeros(3, np.float32), 20.0)
    cfg = JRasterConfig(max_instances=2**14, max_rows=2**14, interpret=True)
    want = np.asarray(jax.jit(lambda p, a: jrender(
        p, jlook_at_origin_camera(64, 48), active_sh_degree=0,
        bg_color=jnp.zeros(3, jnp.float32), cfg=cfg, alive=a).image)(jparams, jaux.alive))
    assert img.mean() > 0.3 and np.isfinite(img).all()
    np.testing.assert_allclose(img, want, rtol=0, atol=2e-3)
