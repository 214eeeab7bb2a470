"""The port's trainer pops the same train views, in the same order, as the
JAX trainer with the same seed: both scenes shuffle their cameras with
the global `random`, and both trainers draw from `random.Random(seed)`,
including the JAX trainer's bucket-sizing `sample` calls at the start and
after every densify step. The train step itself is replaced by a recorder
in both trainers, so only the orchestration runs."""

import random

import numpy as np
import pytest
import torch

from sgs_tpu.data.scene import Scene as JaxScene
from sgs_tpu.train import trainer as jtrainer
from sgs_tpu.utils import config as jconfig
from sgs_tpu_torch.data.scene import Scene
from sgs_tpu_torch.train import trainer
from sgs_tpu_torch.utils import config

torch.set_num_threads(1)
ITERS = 60


@pytest.fixture(scope="module")
def toy_scene(tmp_path_factory):
    from sgs_tpu.utils.toy_scene import make_blender_dataset

    out = str(tmp_path_factory.mktemp("toyscene"))
    make_blender_dataset(out, n_train=12, n_test=3, width=32, height=32, n_gaussians=50, seed=5)
    rng = np.random.default_rng(1)
    from sgs_tpu_torch.data.ply import save_point_cloud_ply

    save_point_cloud_ply(f"{out}/points3d.ply", (rng.random((200, 3)) * 2 - 1).astype(np.float32),
                         rng.integers(0, 256, (200, 3)).astype(np.uint8))
    return out


def _opt(cfg):
    return cfg.OptimizationParams(iterations=ITERS, densify_from_iter=10, densification_interval=10,
                                  densify_until_iter=55, opacity_reset_interval=10_000)


def test_view_order_matches_jax(toy_scene, tmp_path, monkeypatch):
    seen_jax, seen_port = [], []

    def jax_step(state, camera, gt_image, *args, **kwargs):
        seen_jax.append(np.asarray(gt_image).tobytes())
        return state, {"loss": 0.0, "l1": 0.0, "overflow": 0, "nonfinite_grads": 0}

    def port_step(state, camera, gt_image, *args, **kwargs):
        seen_port.append(gt_image.numpy().tobytes())
        return state, {"loss": torch.tensor(0.0), "l1": torch.tensor(0.0),
                       "nonfinite_grads": torch.tensor(0)}

    monkeypatch.setattr(jtrainer, "train_step", jax_step)
    monkeypatch.setattr(trainer, "train_step", port_step)

    jdata = jconfig.ModelParams(source_path=toy_scene, model_path=str(tmp_path / "jax"), eval=True)
    random.seed(0)
    jscene = JaxScene(jdata)
    jtrainer.training(jdata, _opt(jconfig), jconfig.PipelineParams(no_tqdm=True), [], [], [],
                      scene=jscene)

    data = config.ModelParams(source_path=toy_scene, model_path=str(tmp_path / "port"), eval=True)
    random.seed(0)
    scene = Scene(data, device="cpu")
    trainer.training(data, _opt(config), config.PipelineParams(no_tqdm=True), [], [], [],
                     scene=scene, device="cpu")

    assert len(seen_jax) == len(seen_port) == ITERS
    assert seen_port == seen_jax
    assert len(set(seen_port[:12])) == 12, "each pass over the stack sees every view once"


def test_prints_no_tensorboard_line(toy_scene, tmp_path, monkeypatch, capsys):
    """The port never imports tensorboard: it prints the JAX trainer's
    line for a missing tensorboard once, where training starts, and
    trains on."""
    steps = []

    def port_step(state, camera, gt_image, *args, **kwargs):
        steps.append(1)
        return state, {"loss": torch.tensor(0.0), "l1": torch.tensor(0.0),
                       "nonfinite_grads": torch.tensor(0)}

    monkeypatch.setattr(trainer, "train_step", port_step)
    data = config.ModelParams(source_path=toy_scene, model_path=str(tmp_path / "port"), eval=True)
    trainer.training(data, config.OptimizationParams(iterations=3), config.PipelineParams(no_tqdm=True),
                     [], [], [], scene=Scene(data, device="cpu"), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines.count("Tensorboard not available: not logging progress") == 1
    assert len(steps) == 3
