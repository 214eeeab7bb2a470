"""The port's entry points end to end on the CPU: `python -m
sgs_tpu_torch.render` then `python -m sgs_tpu_torch.metrics` on a small
NeRF-synthetic scene, with the metrics held to the repository's JAX
`metrics.py` run on the same PNGs (SSIM and PSNR to rtol 1e-5)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import metrics as jax_metrics
from sgs_tpu.data.ply import load_gaussian_ply, save_gaussian_ply
from sgs_tpu_torch import metrics
from sgs_tpu_torch.render import cli

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 100


@pytest.fixture
def scene(tmp_path):
    """Two flagship test views at 100x100 and a 3,000-Gaussian subset PLY."""
    src = os.path.join(ROOT, "data", "flagship800")
    with open(os.path.join(src, "transforms_test.json")) as f:
        meta = json.load(f)
    meta["frames"] = meta["frames"][:2]
    scene_dir = tmp_path / "scene"
    (scene_dir / "test").mkdir(parents=True)
    for frame in meta["frames"]:
        img = np.asarray(Image.open(os.path.join(src, frame["file_path"] + ".png")))
        small = img.reshape(SIZE, 8, SIZE, 8, 3).mean(axis=(1, 3)).astype(np.uint8)
        Image.fromarray(small).save(scene_dir / (frame["file_path"] + ".png"))
    (scene_dir / "transforms_test.json").write_text(json.dumps(meta))
    arrays = load_gaussian_ply(os.path.join(ROOT, "assets", "flagship", "point_cloud.ply"), 3)
    keep = np.sort(np.random.default_rng(1).choice(arrays["xyz"].shape[0], 3000, replace=False))
    sub = {k: v[keep] for k, v in arrays.items()}
    ply = tmp_path / "subset.ply"
    save_gaussian_ply(str(ply), sub["xyz"], sub["features_dc"], sub["features_rest"],
                      sub["opacity"], sub["scaling"], sub["rotation"])
    return scene_dir, ply, tmp_path / "model"


def test_render_then_metrics_match_jax_metrics(scene, capsys):
    scene_dir, ply, model_dir = scene
    cli.main(["-m", str(model_dir), "-s", str(scene_dir), "--ply", str(ply),
              "--iteration", "7", "--skip_train", "--device", "cpu"])
    out = model_dir / "test" / "ours_7"
    names = sorted(os.listdir(out / "renders"))
    assert names == ["00000.png", "00001.png"] == sorted(os.listdir(out / "gt"))
    render0 = np.asarray(Image.open(out / "renders" / "00000.png"))
    assert render0.shape == (SIZE, SIZE, 3) and render0.max() > 0

    metrics.main(["-m", str(model_dir), "--device", "cpu"])
    mine = json.loads((model_dir / "per_view.json").read_text())["ours_7"]
    mine_mean = json.loads((model_dir / "results.json").read_text())["ours_7"]
    assert mine_mean["LPIPS"] is None

    jax_dir = model_dir.parent / "jax_model"
    shutil.copytree(model_dir / "test", jax_dir / "test")
    jax_metrics.evaluate([str(jax_dir)])
    want = json.loads((jax_dir / "per_view.json").read_text())["ours_7"]
    for key in ("SSIM", "PSNR"):
        assert sorted(mine[key]) == names
        for name in names:
            np.testing.assert_allclose(mine[key][name], want[key][name], rtol=1e-5, err_msg=key)
    assert "Rendering" in capsys.readouterr().out
