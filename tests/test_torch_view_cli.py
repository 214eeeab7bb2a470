"""`python -m sgs_tpu_torch.view` on the CPU against the repository's
`view.py` (tests/test_viewer_and_tools.py:97): the same files; every
frame within 1 LSB of JAX's (both render through the tiled path); and the
GIF bar: decoded by PIL, each frame of the port's `orbit.gif` differs from
its PNG frame by no more, on average, than JAX's `orbit.gif` (PIL's
quantiser) differs from JAX's frames, plus 1/255. The header, frame
count, 120 ms delay and loop field are read back."""

import os

import numpy as np
import torch
from PIL import Image

from sgs_tpu_torch.data.gif import read_gif_info
from sgs_tpu_torch.data.png import read_png
from sgs_tpu_torch.data.ply import save_gaussian_ply

torch.set_num_threads(1)


def write_tiny_model(root):
    """tests/test_viewer_and_tools.py's tiny model (50 Gaussians, SH 3) with
    a little colour in its rest coefficients."""
    rng = np.random.default_rng(0)
    n, deg = 50, 3
    k = (deg + 1) ** 2
    model = os.path.join(str(root), "model")
    ply = os.path.join(model, "point_cloud", "iteration_77", "point_cloud.ply")
    save_gaussian_ply(
        ply,
        rng.normal(size=(n, 3)).astype(np.float32) * 0.3,
        rng.normal(size=(n, 1, 3)).astype(np.float32),
        rng.normal(size=(n, k - 1, 3)).astype(np.float32) * 0.1,
        rng.normal(size=(n, 1)).astype(np.float32),
        rng.uniform(-4, -2, (n, 3)).astype(np.float32),
        np.tile(np.array([[1, 0, 0, 0]], np.float32), (n, 1)),
    )
    return model, ply


def _gif_frames(path):
    im = Image.open(path)
    out = []
    for k in range(im.n_frames):
        im.seek(k)
        out.append(np.asarray(im.convert("RGB")).astype(np.float64))
    return out


def test_view_cli_matches_jax(tmp_path):
    import view as jax_view
    from sgs_tpu_torch.view import main

    model, _ = write_tiny_model(tmp_path)
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["-m", model, "--frames", "3", "--width", "48", "--image_height", "40"]
    main(argv + ["--out", port_out, "--device", "cpu"])
    jax_view.main(argv + ["--out", jax_out])
    names = ["frame_000.png", "frame_001.png", "frame_002.png", "orbit.gif"]
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(jax_out)) == names

    port_frames = [read_png(os.path.join(port_out, n)).astype(np.float64) for n in names[:3]]
    jax_frames = [np.asarray(Image.open(os.path.join(jax_out, n))).astype(np.float64) for n in names[:3]]
    for p, j in zip(port_frames, jax_frames):
        assert p.shape == j.shape == (40, 48, 3)
        assert np.abs(p - j).max() <= 1
    assert max(f.std() for f in port_frames) > 5

    port_gif, jax_gif = _gif_frames(os.path.join(port_out, "orbit.gif")), _gif_frames(
        os.path.join(jax_out, "orbit.gif"))
    assert len(port_gif) == len(jax_gif) == 3
    for pg, jg, pf, jf in zip(port_gif, jax_gif, port_frames, jax_frames):
        ours = np.abs(pg - pf).mean() / 255
        theirs = np.abs(jg - jf).mean() / 255
        assert ours <= theirs + 1 / 255, (ours, theirs)
    info = read_gif_info(os.path.join(port_out, "orbit.gif"))
    assert info == {"header": "GIF89a", "size": (48, 40), "loop": 0, "delays_ms": [120] * 3, "frames": 3}
    assert Image.open(os.path.join(port_out, "orbit.gif")).info["loop"] == 0
