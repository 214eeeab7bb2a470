"""SIBR remote-viewer TCP bridge. Port of `sgs_tpu/viewer/network_gui.py`.

  client -> server: 4-byte LE length + JSON {resolution_x/y, train, fov_x,
  fov_y, z_near, z_far, shs_python, rot_scale_python, keep_alive,
  scaling_modifier, view_matrix (16 floats), view_projection_matrix},
  with the y/z column sign flips applied server-side;
  server -> client: raw HWC uint8 image bytes (`image_to_bytes`: clipped
  to [0, 1], times 255, truncated), then 4-byte LE length + ascii source
  path.

Module-level singleton state, as in the JAX package, so the trainers use
the same init()/try_connect()/receive()/send() call pattern. `serve` costs
one `None` check per iteration while no listener is open. The camera is
built on `device` (the trainer's).
"""

from __future__ import annotations

import json
import socket
from typing import Optional, Tuple

import numpy as np
import torch

from sgs_tpu_torch.core.camera import Camera

host = "127.0.0.1"
port = 6009

conn: Optional[socket.socket] = None
addr = None
listener: Optional[socket.socket] = None


def init(wish_host: str, wish_port: int) -> None:
    global host, port, listener
    host, port = wish_host, wish_port
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen()
    listener.settimeout(0)


def try_connect() -> None:
    global conn, addr
    if listener is None:
        return
    try:
        conn, addr = listener.accept()
        print(f"\nConnected by {addr}")
        conn.settimeout(None)
    except (BlockingIOError, OSError):
        pass


def _read_exact(n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("viewer disconnected")
        buf += chunk
    return buf


def read() -> dict:
    length = int.from_bytes(_read_exact(4), "little")
    return json.loads(_read_exact(length).decode("utf-8"))


def send(image_bytes: Optional[bytes], verify: str) -> None:
    if image_bytes is not None:
        conn.sendall(image_bytes)
    conn.sendall(len(verify).to_bytes(4, "little"))
    conn.sendall(bytes(verify, "ascii"))


def receive(device: "str | torch.device" = "cuda") -> Tuple:
    """(camera | None, do_training, shs_python, rot_scale_python,
    keep_alive, scaling_modifier) of the next message."""
    message = read()
    width = message["resolution_x"]
    height = message["resolution_y"]
    if width == 0 or height == 0:
        return None, None, None, None, None, None

    view = np.array(message["view_matrix"], np.float32).reshape(4, 4)
    view[:, 1] *= -1
    view[:, 2] *= -1
    proj = np.array(message["view_projection_matrix"], np.float32).reshape(4, 4)
    proj[:, 1] *= -1
    cam = Camera.from_matrices(
        view, proj,
        fovx=message["fov_x"], fovy=message["fov_y"],
        width=width, height=height, device=device,
    )
    return (
        cam,
        bool(message["train"]),
        bool(message["shs_python"]),
        bool(message["rot_scale_python"]),
        bool(message["keep_alive"]),
        message["scaling_modifier"],
    )


def image_to_bytes(image_chw) -> bytes:
    """(3, H, W) float (tensor or array) -> raw HWC uint8 bytes for send()."""
    if isinstance(image_chw, torch.Tensor):
        image_chw = image_chw.detach().cpu().numpy()
    img = np.clip(np.asarray(image_chw), 0.0, 1.0)
    return (img.transpose(1, 2, 0) * 255).astype(np.uint8).tobytes()


def disconnect() -> None:
    global conn
    if conn is not None:
        try:
            conn.close()
        except OSError:
            pass
        conn = None


def close() -> None:
    """Disconnect and close the listener (the trainers never do; a caller
    that runs several trainings in one process does)."""
    global listener
    disconnect()
    if listener is not None:
        listener.close()
        listener = None


def serve(render_cb, source_path: str, iteration: int, max_iterations: int,
          device: "str | torch.device" = "cuda") -> None:
    """Inline per-iteration serving: accept a pending viewer connection,
    answer render requests until the viewer releases the training loop.

    render_cb(camera, scaling_modifier) -> (3, H, W) float image.
    No-op unless init() was called.
    """
    global conn
    if listener is None:
        return
    if conn is None:
        try_connect()
    while conn is not None:
        try:
            cam, do_training, _shs_py, _rs_py, keep_alive, scaling_mod = receive(device)
            image_bytes = None
            if cam is not None:
                with torch.no_grad():
                    image_bytes = image_to_bytes(render_cb(cam, scaling_mod))
            send(image_bytes, source_path)
            if do_training and (iteration < max_iterations or not keep_alive):
                break
        except Exception:
            conn = None
