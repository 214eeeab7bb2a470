"""End to end through the port's training CLI (`python -m
sgs_tpu_torch.train`) on the CPU: the toy Blender scene of
tests/test_train_e2e.py (made by the JAX package's synthesiser), a seeded
1,000-point random init cloud, 150 iterations with two densify steps.
Test PSNR must rise by 4 dB and pass 18 dB, the bars of
tests/test_train_e2e.py; the snapshot, checkpoint and losses.tsv are
written and the Gaussian count changes."""

import os

import numpy as np
import pytest
import torch

from sgs_tpu_torch.data.ply import load_gaussian_ply, save_point_cloud_ply
from sgs_tpu_torch.train.__main__ import main as train_main
from sgs_tpu_torch.train.checkpoint import load_checkpoint

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy_scene(tmp_path_factory):
    from sgs_tpu.utils.toy_scene import make_blender_dataset

    out = str(tmp_path_factory.mktemp("toyscene"))
    make_blender_dataset(out, n_train=12, n_test=3, width=48, height=48, n_gaussians=150, seed=3)
    rng = np.random.default_rng(0)
    pts = (rng.random((1000, 3)) * 2.6 - 1.3).astype(np.float32)
    cols = rng.integers(0, 256, (1000, 3)).astype(np.uint8)
    save_point_cloud_ply(os.path.join(out, "points3d.ply"), pts, cols)
    return out


def test_training_cli_improves_psnr(toy_scene, tmp_path):
    model = str(tmp_path / "model")
    train_main([
        "-s", toy_scene, "-m", model, "-w", "--eval", "--device", "cpu",
        "--iterations", "150", "--densify_from_iter", "40", "--densification_interval", "50",
        "--densify_until_iter", "120", "--opacity_reset_interval", "10000",
        "--position_lr_max_steps", "150", "--test_iterations", "1", "150",
        "--save_iterations", "150", "--checkpoint_iterations", "150",
    ])
    rows = open(os.path.join(model, "losses.tsv")).read().strip().splitlines()
    assert rows[0].startswith("iteration")
    first, last = rows[1].split("\t"), rows[-1].split("\t")
    psnr_first, psnr_last = float(first[2]), float(last[2])
    assert psnr_last > psnr_first + 4.0, (psnr_first, psnr_last)
    assert psnr_last > 18.0, psnr_last
    assert int(first[3]) == 1000 and int(last[3]) != 1000

    snap = load_gaussian_ply(os.path.join(model, "point_cloud", "iteration_150", "point_cloud.ply"), 3)
    state, it, _, _ = load_checkpoint(os.path.join(model, "chkpnt150.npz"), device="cpu")
    assert it == 150 and snap["xyz"].shape[0] == int(last[3]) == state.model.num_alive
    for name in ("cfg_args", "opt_args", "input.ply", "cameras.json"):
        assert os.path.exists(os.path.join(model, name)), name
