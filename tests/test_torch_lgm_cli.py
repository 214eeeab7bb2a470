"""`python -m sgs_tpu_torch.train_lgm --device cpu` end to end on the JAX
package's toy Blender scene at 40x40, 40 structures (a random init cloud
cut by `--downsample_init`), 60 iterations: the test PSNR must beat the
empty (background-only) render by 5 dB and the JAX e2e test's bar of 10
dB (tests/test_latent_model.py), rise by 3 dB from iteration 1, and the
PLY, the checkpoint and cfg_args must be written (the checkpoint loads
back and decodes to the PLY's positions)."""

import numpy as np
import pytest
import torch

from sgs_tpu_torch.data.ply import load_gaussian_ply
from sgs_tpu_torch.data.readers import read_nerf_synthetic_split
from sgs_tpu_torch.models.latent import LatentGaussianModel
from sgs_tpu_torch.ops.ssim import psnr
from sgs_tpu_torch.train.lgm_trainer import load_lgm_checkpoint
from sgs_tpu_torch.train_lgm import main as train_lgm_main
from sgs_tpu_torch.utils import config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy_scene(tmp_path_factory):
    from sgs_tpu.utils.toy_scene import make_blender_dataset

    out = str(tmp_path_factory.mktemp("toyscene"))
    make_blender_dataset(out, n_train=8, n_test=2, width=40, height=40, n_gaussians=80, seed=11)
    return out


def test_train_lgm_cli_fits_toy_scene(toy_scene, tmp_path, capsys):
    model = tmp_path / "model"
    train_lgm_main(["-s", toy_scene, "-m", str(model), "--eval", "--device", "cpu",
                    "--iterations", "60", "--downsample_init", "2500",
                    "--test_iterations", "1", "60", "--checkpoint_iterations", "60"])
    out = capsys.readouterr().out
    assert "Number of structures at initialisation : 40" in out
    test_psnr = [float(ln.split("PSNR ")[1]) for ln in out.splitlines()
                 if "Evaluating test" in ln]
    assert len(test_psnr) == 2
    views = read_nerf_synthetic_split(toy_scene, "test", False, -1, "cpu")
    empty = float(np.mean([float(psnr(torch.zeros_like(v.gt_image), v.gt_image)) for v in views]))
    assert test_psnr[1] > max(empty + 5.0, 10.0, test_psnr[0] + 3.0), (empty, test_psnr)
    assert "LGM: 60 iters in " in out and out.rstrip().endswith("Training complete.")

    snap = load_gaussian_ply(str(model / "point_cloud" / "iteration_60" / "point_cloud.ply"), 0)
    assert snap["xyz"].shape == (320, 3) and np.isfinite(snap["xyz"]).all()
    loaded, it = load_lgm_checkpoint(str(model / "chkpnt60.npz"), LatentGaussianModel(1, device="cpu"))
    assert it == 60 and loaded.num_gaussians == 320
    np.testing.assert_allclose(loaded.decode()["xyz"].detach().numpy(), snap["xyz"], rtol=1e-6, atol=1e-6)
    assert config.read_cfg_args(str(model))["sh_degree"] == 0
    for name in ("input.ply", "cameras.json"):
        assert (model / name).exists(), name
