"""Remote-viewer TCP server speaking the SIBR_remoteGaussian protocol.

The port of `gsjax.viewer.network_gui`, with its wire format byte for
byte (reference: gaussian_renderer/network_gui.py:26-86, train.py:52-66):
requests are length-prefixed (4-byte little-endian) JSON carrying camera
matrices, resolution and pipeline flags; a reply is the raw HxWx3 uint8
RGB frame followed by a length-prefixed ASCII source path. The client
sends row-major (transposed) matrices with SIBR's Y/Z sign flips (columns
1 and 2 of the view and column 1 of the view-projection negated), which
`receive` undoes before Camera.from_matrices takes them.

Torch specifics: `receive` builds the camera on the device it is given,
and `image_to_bytes` clamps, scales and truncates a frame on the device
it lies on, so that only the uint8 bytes cross to the host.
"""

from __future__ import annotations

import json
import socket
import traceback
from dataclasses import dataclass

import numpy as np
import torch

from gsjax_torch.core.cameras import Camera


@dataclass
class ViewerRequest:
    camera: Camera | None
    do_training: bool
    do_shs_python: bool
    do_rot_scale_python: bool
    keep_alive: bool
    scaling_modifier: float


class NetworkGUI:
    """Non-blocking listener polled from the training loop; once a client
    is connected, reads block (the reference's behaviour)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self.listener.bind((host, port))
            self.listener.listen()
        except OSError:
            self.listener.close()
            raise
        self.listener.settimeout(0)
        self.conn: socket.socket | None = None

    def try_connect(self) -> None:
        """(reference: network_gui.py:34-41)"""
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nConnected by {addr}")
            self.conn.settimeout(None)
        except OSError:
            pass

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer connection closed")
            buf += chunk
        return bytes(buf)

    def _read(self) -> dict:
        """(reference: network_gui.py:43-48)"""
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def send(self, image_bytes: bytes | None, verify: str) -> None:
        """(reference: network_gui.py:50-55)"""
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self, device: torch.device | str | None = None) -> ViewerRequest:
        """The next request, its camera on `device` (default CUDA); zero
        resolution is a keep-alive without a camera
        (reference: network_gui.py:57-86)."""
        msg = self._read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return ViewerRequest(None, False, False, False, False, 1.0)
        try:
            view = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
            view[:, 1] = -view[:, 1]
            view[:, 2] = -view[:, 2]
            full = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
            full[:, 1] = -full[:, 1]
            camera = Camera.from_matrices(
                view, full, msg["fov_x"], msg["fov_y"], width, height, device=device
            )
        except Exception:
            print("")
            traceback.print_exc()
            raise
        return ViewerRequest(
            camera=camera,
            do_training=bool(msg["train"]),
            do_shs_python=bool(msg["shs_python"]),
            do_rot_scale_python=bool(msg["rot_scale_python"]),
            keep_alive=bool(msg["keep_alive"]),
            scaling_modifier=float(msg["scaling_modifier"]),
        )

    def drop(self) -> None:
        if self.conn is not None:
            self.conn.close()
        self.conn = None

    def close(self) -> None:
        """Close the connection and the listener."""
        self.drop()
        self.listener.close()

    @staticmethod
    def image_to_bytes(image) -> bytes:
        """[3,H,W] float image -> raw HxWx3 uint8 bytes (reference:
        train.py:60): clamped to [0, 1], times 255 in f32 and truncated,
        on the image's own device; only the bytes are copied to the host."""
        img = torch.as_tensor(image)
        frame = (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
        return frame.permute(1, 2, 0).contiguous().cpu().numpy().tobytes()
