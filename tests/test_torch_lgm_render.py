"""The committed LGM snapshot (`assets/lgm/point_cloud.ply`, the decoded
Gaussians of the JAX run at iteration 3000) through `python -m
sgs_tpu_torch.render` on `data/lgm400`'s test split on the CPU, scored by
`python -m sgs_tpu_torch.metrics`, held per view to the JAX package's
committed numbers (`assets/lgm/per_view.json`): PSNR within 0.02 dB and
SSIM within 5e-4, the bars of the flagship render check (`chip_smoke.py`
phase 4), which allow f32 reordering and a few one-level flips after
8-bit quantisation."""

import json
import os

import torch

from sgs_tpu_torch import metrics
from sgs_tpu_torch.render import cli as render_cli
from sgs_tpu_torch.utils import config

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSNR_BAR, SSIM_BAR = 0.02, 5e-4


def test_lgm_snapshot_renders_to_jax_metrics(tmp_path):
    model = tmp_path / "lgm"
    # runs/lgm_r5/cfg_args: SH degree 0, black background, eval
    config.save_cfg_args(str(model), config.ModelParams(
        sh_degree=0, source_path=os.path.join(ROOT, "data", "lgm400"), model_path=str(model),
        white_background=False, eval=True))
    render_cli.main(["-m", str(model), "--ply", os.path.join(ROOT, "assets", "lgm", "point_cloud.ply"),
                     "--sh_degree", "0", "--iteration", "3000", "--skip_train", "--device", "cpu"])
    metrics.main(["-m", str(model), "--device", "cpu"])
    mine = json.loads((model / "per_view.json").read_text())["ours_3000"]
    want = json.loads(open(os.path.join(ROOT, "assets", "lgm", "per_view.json")).read())["ours_3000"]
    assert sorted(mine["PSNR"]) == sorted(want["PSNR"]) and len(want["PSNR"]) == 8
    for name in want["PSNR"]:
        assert abs(mine["PSNR"][name] - want["PSNR"][name]) <= PSNR_BAR, name
        assert abs(mine["SSIM"][name] - want["SSIM"][name]) <= SSIM_BAR, name
