"""The port's network viewer bridge (`sgs_tpu_torch.viewer.network_gui`)
and `Camera.from_matrices` on the CPU:

- the loopback protocol and the `serve` loop, as tests/test_viewer_and_tools.py
  drives the JAX package's (`:16`, `:123`);
- the same client message through JAX's and the port's `receive` gives
  cameras within 1e-6;
- a tiny model served through the port's `serve` (the tiled path, Kernel
  A's plain version here) gives JAX's served bytes (its tiled render, as
  its trainer serves) except for 1-LSB flips.
"""

import json
import math
import socket
import threading
import time

import numpy as np
import pytest
import torch

from sgs_tpu.viewer import network_gui as jax_gui
from sgs_tpu_torch.viewer import network_gui

torch.set_num_threads(1)


def _message(view, proj, w, h, train=1, keep_alive=1, scaling_modifier=1.0):
    return {
        "resolution_x": w, "resolution_y": h, "train": train,
        "fov_x": 1.0, "fov_y": 0.8, "z_near": 0.01, "z_far": 100.0,
        "shs_python": 0, "rot_scale_python": 0, "keep_alive": keep_alive,
        "scaling_modifier": scaling_modifier,
        "view_matrix": np.asarray(view, np.float32).ravel().tolist(),
        "view_projection_matrix": np.asarray(proj, np.float32).ravel().tolist(),
    }


def _client(port, msg, got, n_bytes):
    c = socket.create_connection(("127.0.0.1", port), timeout=10)
    payload = json.dumps(msg).encode()
    c.sendall(len(payload).to_bytes(4, "little") + payload)
    img = b""
    while len(img) < n_bytes:
        img += c.recv(n_bytes - len(img))
    got["image"] = img
    ln = int.from_bytes(c.recv(4), "little")
    got["path"] = c.recv(ln).decode()
    c.close()


def _serve_one(gui, msg, render_cb, **kw):
    """One request through `gui.serve` from a client thread; returns what
    the client received."""
    gui.init("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    got = {}
    th = threading.Thread(target=_client, args=(port, msg, got, msg["resolution_x"] * msg["resolution_y"] * 3))
    th.start()
    deadline = time.time() + 20
    while time.time() < deadline and "image" not in got:
        gui.serve(render_cb, "/src/scene", iteration=1, max_iterations=10, **kw)
        time.sleep(0.01)
    th.join(timeout=10)
    gui.disconnect()
    gui.listener.close()
    gui.listener = None
    return got


def test_network_gui_loopback():
    """The TCP protocol driven as the SIBR remote viewer drives it."""
    network_gui.init("127.0.0.1", 0)
    port = network_gui.listener.getsockname()[1]
    view = np.eye(4, dtype=np.float32)
    msg = _message(view, view, 32, 24)
    received = {}
    th = threading.Thread(target=_client, args=(port, msg, received, 32 * 24 * 3))
    th.start()
    for _ in range(100):
        network_gui.try_connect()
        if network_gui.conn is not None:
            break
        time.sleep(0.05)
    assert network_gui.conn is not None
    cam, do_training, shs_py, rs_py, keep_alive, scale = network_gui.receive(device="cpu")
    assert cam is not None
    assert cam.image_width == 32 and cam.image_height == 24
    assert do_training and keep_alive and scale == 1.0
    wvt = cam.world_view_transform.numpy()  # the y/z sign flips were applied
    assert wvt[1, 1] == -1.0 and wvt[2, 2] == -1.0
    assert cam.world_view_transform.dtype == torch.float32
    fake = np.random.default_rng(0).uniform(size=(3, 24, 32)).astype(np.float32)
    network_gui.send(network_gui.image_to_bytes(torch.from_numpy(fake)), "/data/scene")
    th.join(timeout=5)
    assert received["image"] == jax_gui.image_to_bytes(fake)
    assert received["path"] == "/data/scene"
    network_gui.close()
    assert network_gui.conn is None and network_gui.listener is None


def test_network_gui_serve_loop():
    """serve() answers a render request, then releases the loop."""
    view = np.eye(4, dtype=np.float32)
    calls = {}

    def render_cb(cam, scaling_modifier):
        calls["cam"], calls["sm"] = cam, scaling_modifier
        return torch.full((3, cam.image_height, cam.image_width), 0.5)

    got = _serve_one(network_gui, _message(view, view, 16, 16, keep_alive=0, scaling_modifier=0.5),
                     render_cb, device="cpu")
    assert got["path"] == "/src/scene"
    assert calls["sm"] == 0.5 and calls["cam"].image_width == 16
    assert len(got["image"]) == 16 * 16 * 3
    assert got["image"][0] == 127  # 0.5 * 255, truncated


def test_serve_without_listener_is_a_no_op():
    assert network_gui.listener is None
    network_gui.serve(lambda *a: pytest.fail("rendered"), "/src", 1, 10)


def _viewer_matrices(theta=0.7, w=40, h=30):
    """The matrices a viewer sends for a circle_pose camera: the transposed
    world-view and full projection with the y/z columns flipped back."""
    from sgs_tpu_torch.utils.toy_scene import camera_from_c2w, circle_pose

    cam = camera_from_c2w(circle_pose(theta, radius=1.5, height=0.3), math.radians(55), w, h, "cpu")
    view = cam.world_view_transform.numpy().copy()
    proj = cam.full_proj_transform.numpy().copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    proj[:, 1] *= -1
    return view, proj


def test_receive_matches_jax():
    view, proj = _viewer_matrices()
    msg = _message(view, proj, 40, 30, scaling_modifier=0.7)
    cams = []
    for gui, kw in ((jax_gui, {}), (network_gui, {"device": "cpu"})):
        gui.init("127.0.0.1", 0)
        port = gui.listener.getsockname()[1]
        c = socket.create_connection(("127.0.0.1", port), timeout=5)
        payload = json.dumps(msg).encode()
        c.sendall(len(payload).to_bytes(4, "little") + payload)
        for _ in range(100):
            gui.try_connect()
            if gui.conn is not None:
                break
            time.sleep(0.02)
        out = gui.receive(**kw)
        cams.append(out)
        c.close()
        gui.disconnect()
        gui.listener.close()
        gui.listener = None
    (jc, *jrest), (pc, *prest) = cams
    assert jrest == prest
    for key in ("world_view_transform", "full_proj_transform", "camera_center", "tanfovx", "tanfovy"):
        np.testing.assert_allclose(getattr(pc, key).numpy(), np.asarray(getattr(jc, key)), atol=1e-6, rtol=0)
    assert (pc.image_width, pc.image_height) == (jc.image_width, jc.image_height)


def test_served_bytes_match_jax(tmp_path):
    """A tiny model rendered through each package's serve (tiled path)."""
    import jax.numpy as jnp

    from sgs_tpu.data.ply import load_gaussian_ply as jax_load
    from sgs_tpu.data.scene import pool_from_arrays
    from sgs_tpu.train.loop import eval_render as jax_eval_render
    from sgs_tpu_torch.models.gaussians import GaussianModel
    from sgs_tpu_torch.train.loop import eval_render
    from test_torch_view_cli import write_tiny_model

    _, ply = write_tiny_model(tmp_path)
    view, proj = _viewer_matrices(0.3, 40, 30)
    msg = _message(view, proj, 40, 30, keep_alive=0)
    pool = pool_from_arrays(jax_load(ply, 3), 3)
    model = GaussianModel.from_ply(ply, 3, "cpu")
    want = _serve_one(jax_gui, msg, lambda cam, sm: jax_eval_render(pool, cam, jnp.zeros(3), 3, mode="tiled"))
    got = _serve_one(network_gui, msg, lambda cam, sm: eval_render(model, cam, torch.zeros(3), 3, "tiled"),
                     device="cpu")
    a = np.frombuffer(want["image"], np.uint8).astype(int)
    b = np.frombuffer(got["image"], np.uint8).astype(int)
    assert a.shape == b.shape == (40 * 30 * 3,)
    assert np.abs(a - b).max() <= 1 and (a != b).mean() < 0.01
    assert a.std() > 5  # the model is in view
