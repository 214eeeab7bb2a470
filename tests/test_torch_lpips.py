"""The port's LPIPS (`metrics/lpips.py`) and the metrics CLI's LPIPS
against the JAX package's on the CPU.

Mirrors tests/test_lpips.py: on seeded random VGG16 + lin weights (that
file's `_random_weights`) the port's distance equals JAX's `lpips` within
rtol 1e-4 and atol 1e-6, and identical images give 0; the synthetic
published `.pth` pair (`_synthetic_pth_pair`) converts to the npz arrays
JAX's `convert_reference_weights` writes, bit for bit; the metrics CLI,
pointed by SGS_LPIPS_WEIGHTS at a directory holding only the `.pth` pair,
converts it and reports JAX's LPIPS per view and per method; missing
weights raise FileNotFoundError, and the metrics then report null with
JAX's message.
"""

import json
import os

import numpy as np
import pytest
import torch

import metrics as jax_metrics
from sgs_tpu.metrics import lpips as jl
from sgs_tpu_torch import metrics
from sgs_tpu_torch.data.png import write_png
from sgs_tpu_torch.metrics import lpips as tl

from test_lpips import _random_weights, _synthetic_pth_pair

torch.set_num_threads(1)


def test_synthetic_weights_are_the_tests_draw():
    """`synthetic_weights(seed)`, which chip_smoke.py's LPIPS check writes,
    draws tests/test_lpips.py's random weights bit for bit."""
    got, want = tl.synthetic_weights(3), _random_weights(3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].tobytes() == want[k].tobytes(), k


def test_lpips_matches_jax(tmp_path):
    path = str(tmp_path / "w.npz")
    np.savez(path, **tl.synthetic_weights(0))
    rng = np.random.default_rng(42)
    x = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    want = np.asarray(jl.lpips(x, y, weights_path=path))
    got = tl.lpips(torch.from_numpy(x), torch.from_numpy(y), weights_path=path)
    assert got.shape == (2,) and float(got.min()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    one = tl.lpips(torch.from_numpy(x[0]), torch.from_numpy(y[0]), weights_path=path)
    np.testing.assert_allclose(one.numpy(), want[:1], rtol=1e-4, atol=1e-6)
    same = tl.lpips(torch.from_numpy(x), torch.from_numpy(x), weights_path=path)
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-7)


def test_pth_pair_converts_as_jax_does(tmp_path):
    vgg_pth, lin_pth, arrays = _synthetic_pth_pair(tmp_path)
    assert tl.lpips_available(str(tmp_path / "lpips_vgg16.npz"))
    tl.convert_reference_weights(vgg_pth, lin_pth, str(tmp_path / "port.npz"))
    jl.convert_reference_weights(vgg_pth, lin_pth, str(tmp_path / "jax.npz"))
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files) == sorted(arrays)
    for k in want.files:
        assert got[k].dtype == want[k].dtype == np.float32 and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def _model_dir(root, rng, views=2, size=32):
    for i in range(views):
        img = (rng.uniform(0, 1, (size, size, 3)) * 255).astype(np.uint8)
        noisy = np.clip(img.astype(np.int32) + rng.integers(-20, 20, img.shape), 0, 255).astype(np.uint8)
        for sub, arr in (("renders", img), ("gt", noisy)):
            d = root / "test" / "ours_30000" / sub
            d.mkdir(parents=True, exist_ok=True)
            write_png(str(d / f"{i:05d}.png"), arr)
    return root


def _pair_dir(tmp_path, name, vgg_pth, lin_pth):
    d = tmp_path / name
    d.mkdir()
    os.link(vgg_pth, d / "vgg16-397923af.pth")
    os.link(lin_pth, d / "vgg.pth")
    return str(d / "lpips_vgg16.npz")


def test_metrics_cli_reports_jax_lpips(tmp_path, monkeypatch):
    """Both packages' metrics on the same PNGs, each converting its own
    copy of the `.pth` pair on first use."""
    vgg_pth, lin_pth, _ = _synthetic_pth_pair(tmp_path)
    rng = np.random.default_rng(7)
    port_dir = _model_dir(tmp_path / "port_model", rng)
    jax_dir = tmp_path / "jax_model"
    import shutil

    shutil.copytree(port_dir, jax_dir)
    monkeypatch.setenv("SGS_LPIPS_WEIGHTS", _pair_dir(tmp_path, "jax_w", vgg_pth, lin_pth))
    jax_metrics.evaluate([str(jax_dir)])
    npz = _pair_dir(tmp_path, "port_w", vgg_pth, lin_pth)
    monkeypatch.setenv("SGS_LPIPS_WEIGHTS", npz)
    got = metrics.evaluate([str(port_dir)], device="cpu")[str(port_dir)]["ours_30000"]
    assert os.path.exists(npz)
    want = json.load(open(jax_dir / "results.json"))["ours_30000"]
    assert got["LPIPS"] is not None and np.isfinite(got["LPIPS"]) and got["LPIPS"] > 0
    np.testing.assert_allclose(got["LPIPS"], want["LPIPS"], rtol=1e-4, atol=1e-6)
    mine = json.load(open(port_dir / "per_view.json"))["ours_30000"]["LPIPS"]
    theirs = json.load(open(jax_dir / "per_view.json"))["ours_30000"]["LPIPS"]
    assert sorted(mine) == sorted(theirs) == ["00000.png", "00001.png"]
    for name in mine:
        np.testing.assert_allclose(mine[name], theirs[name], rtol=1e-4, atol=1e-6)


def test_missing_weights(tmp_path, monkeypatch, capsys):
    missing = str(tmp_path / "missing.npz")
    assert not tl.lpips_available(missing)
    with pytest.raises(FileNotFoundError):
        tl.lpips(torch.zeros((3, 8, 8)), torch.zeros((3, 8, 8)), weights_path=missing)
    model = _model_dir(tmp_path / "model", np.random.default_rng(1), views=1)
    monkeypatch.setenv("SGS_LPIPS_WEIGHTS", missing)
    got = metrics.evaluate([str(model)], device="cpu")[str(model)]["ours_30000"]
    assert got["LPIPS"] is None
    assert json.load(open(model / "per_view.json"))["ours_30000"]["LPIPS"] == {}
    assert "[metrics] LPIPS weights not found — reporting LPIPS as null" in capsys.readouterr().out
