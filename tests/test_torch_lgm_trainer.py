"""The LGM trainer's orchestration and I/O against the JAX package's on
the CPU, exactly (these are choices, file contents and parsed values):

- `Scene(downsample_init=10)` on `data/lgm400` picks the same 2,000 of
  its 20,000 init points, in the same order, as the JAX Scene: both draw
  `np.random.choice(..., replace=False)` from the global numpy state,
  which the CLIs seed;
- the trainer pops the same train views in the same order as JAX's
  `training_lgm` with the same seed: `random.Random(seed).randint` only,
  since JAX's LGM trainer sizes its buckets from the first train camera
  and makes no `sample` calls (the 3DGS trainer's do). The step is
  replaced by a recorder in both trainers, so only the orchestration
  runs;
- the LGM checkpoint both ways (JAX writes, the port reads; the port
  writes, JAX reads), and the committed `runs/lgm_r5/chkpnt3000.npz`
  loaded by the port and decoded by both packages to the bar of
  tests/test_torch_latent.py (rtol 2e-5, atol 1e-6).
"""

import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgs_tpu.data.scene import Scene as JaxScene
from sgs_tpu.models import latent as jlatent
from sgs_tpu.train import lgm_trainer as jtrainer
from sgs_tpu.utils import config as jconfig
from sgs_tpu_torch.data.scene import Scene
from sgs_tpu_torch.models.latent import LatentGaussianModel
from sgs_tpu_torch.train import lgm_trainer
from sgs_tpu_torch.utils import config
from test_torch_lgm_step import CHECKPOINT, ROOT, _checkpoint_arrays, _flat, _jax_model

torch.set_num_threads(1)
ITERS = 40


def test_scene_downsample_init_picks_jax_points(tmp_path):
    src = os.path.join(ROOT, "data", "lgm400")
    jdata = jconfig.ModelParams(source_path=src, model_path=str(tmp_path / "jax"), sh_degree=0)
    data = config.ModelParams(source_path=src, model_path=str(tmp_path / "port"), sh_degree=0)
    random.seed(0)
    np.random.seed(0)
    jscene = JaxScene(jdata, downsample_init=10)
    random.seed(0)
    np.random.seed(0)
    scene = Scene(data, device="cpu", downsample_init=10)
    assert len(scene.init_pcd.points) == len(jscene.init_pcd.points) == 2000
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(scene.init_pcd, f), getattr(jscene.init_pcd, f), err_msg=f)
    assert scene.pool.num_alive == 2000
    # the same shuffled views
    assert [c.image_name for c in scene.getTrainCameras()] == [
        c.image_name for c in jscene.getTrainCameras()]


@pytest.fixture(scope="module")
def toy_scene(tmp_path_factory):
    from sgs_tpu.utils.toy_scene import make_blender_dataset
    from sgs_tpu_torch.data.ply import save_point_cloud_ply

    out = str(tmp_path_factory.mktemp("toyscene"))
    make_blender_dataset(out, n_train=12, n_test=3, width=32, height=32, n_gaussians=50, seed=5)
    rng = np.random.default_rng(1)
    save_point_cloud_ply(f"{out}/points3d.ply", (rng.random((200, 3)) * 2 - 1).astype(np.float32),
                         rng.integers(0, 256, (200, 3)).astype(np.uint8))
    return out


def test_view_order_matches_jax(toy_scene, tmp_path, monkeypatch):
    seen_jax, seen_port = [], []

    def jax_make_step(*args, **kwargs):
        def step(params, opt_state, static_model, camera, gt_image, bg):
            seen_jax.append(np.asarray(gt_image).tobytes())
            return params, opt_state, jnp.float32(0.0), jnp.float32(0.0), 0
        return step

    def port_step(model, adam, camera, gt_image, *args, **kwargs):
        seen_port.append(gt_image.numpy().tobytes())
        return adam, {"loss": torch.tensor(0.0), "l1": torch.tensor(0.0),
                      "nonfinite_grads": torch.tensor(0)}

    monkeypatch.setattr(jtrainer, "make_lgm_train_step", jax_make_step)
    monkeypatch.setattr(lgm_trainer, "lgm_train_step", port_step)

    jdata = jconfig.ModelParams(source_path=toy_scene, model_path=str(tmp_path / "jax"), sh_degree=0)
    random.seed(0)
    np.random.seed(0)
    jscene = JaxScene(jdata, downsample_init=4)
    jtrainer.training_lgm(jdata, jconfig.OptimizationParams(iterations=ITERS),
                          jconfig.PipelineParams(no_tqdm=True), [], [], [], scene=jscene)

    data = config.ModelParams(source_path=toy_scene, model_path=str(tmp_path / "port"), sh_degree=0)
    random.seed(0)
    np.random.seed(0)
    scene = Scene(data, device="cpu", downsample_init=4)
    lgm_trainer.training_lgm(data, config.OptimizationParams(iterations=ITERS),
                             config.PipelineParams(no_tqdm=True), [], [], [], scene=scene,
                             device="cpu")

    assert len(seen_jax) == len(seen_port) == ITERS
    assert seen_port == seen_jax
    assert len(set(seen_port[:12])) == 12, "each pass over the stack sees every view once"


def _small_jax_model(seed=0, **config):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(30, 3)) * 0.4).astype(np.float32)
    cols = rng.uniform(size=(30, 3)).astype(np.float32)
    model = jlatent.LatentGaussianModel.create(jax.random.PRNGKey(seed), np.zeros((1, 3), np.float32),
                                               **config)
    return model.create_from_pcd(jax.random.PRNGKey(seed + 1), pts, cols)
def test_checkpoint_round_trip_both_ways(tmp_path):
    jmodel = _small_jax_model(use_positional_embedding=True, latent_size=16, hidden_size=24)
    jarrays = _flat(jax.tree_util.tree_map(np.asarray, jmodel.trainable_params()))
    config = dict(use_positional_embedding=True, latent_size=16, hidden_size=24)

    # JAX writes, the port reads
    path = str(tmp_path / "jax.npz")
    jtrainer.save_lgm_checkpoint(path, jmodel, 123)
    model, it = lgm_trainer.load_lgm_checkpoint(path, LatentGaussianModel(1, device="cpu", **config))
    assert it == 123
    got = model.jax_arrays()
    assert set(got) == set(jarrays)
    for k in jarrays:
        np.testing.assert_array_equal(got[k], jarrays[k], err_msg=k)

    # the port writes, JAX reads
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    path = str(tmp_path / "port.npz")
    lgm_trainer.save_lgm_checkpoint(path, model, 456)
    back, it = jtrainer.load_lgm_checkpoint(path, jmodel)
    assert it == 456
    back = _flat(jax.tree_util.tree_map(np.asarray, back.trainable_params()))
    for k, v in model.jax_arrays().items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].shape == jarrays[k].shape


def test_committed_checkpoint_loads_and_decodes():
    arrays = _checkpoint_arrays()
    model, it = lgm_trainer.load_lgm_checkpoint(CHECKPOINT, LatentGaussianModel(1, device="cpu"))
    assert it == 3000 and model.num_structures == 2000 and model.num_gaussians == 16_000
    assert model.decoder.layers["lin2"].weight.shape == (112, 32)
    for k, v in model.jax_arrays().items():
        np.testing.assert_array_equal(v, arrays[k], err_msg=k)
    with jax.disable_jit():
        want = _jax_model(arrays).decode()
    got = model.decode()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=2e-5,
                                   atol=1e-6, err_msg=k)

