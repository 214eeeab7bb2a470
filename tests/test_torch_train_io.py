"""Port parity of the training plumbing: Adam (tracking torch.optim.Adam
step for step to rtol 2e-5, atol 1e-6, the bar of tests/test_optim.py,
and equal to the JAX update to rtol 1e-6), the learning-rate
schedules, knn, checkpoints (JAX -> port -> JAX, key for key), PLY files
(byte for byte) and the training flags (name for name)."""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgs_tpu.data import ply as jply
from sgs_tpu.ops.knn import mean_sq_dist_3nn as jax_knn
from sgs_tpu.train import checkpoint as jckpt
from sgs_tpu.train.optim import AdamState as JaxAdam
from sgs_tpu.train.optim import adam_update as jax_adam_update
from sgs_tpu.train.optim import expon_lr_func as jax_expon
from sgs_tpu.utils import config as jconfig
from sgs_tpu_torch.data import ply
from sgs_tpu_torch.ops.knn import mean_sq_dist_3nn, mean_sq_dist_knn
from sgs_tpu_torch.train import checkpoint
from sgs_tpu_torch.train.optim import AdamState, adam_update, expon_lr_func
from sgs_tpu_torch.utils import config
from test_torch_train_step import _jax_state

torch.set_num_threads(1)


def test_adam_is_step_exact_with_torch_adam():
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(7, 3)).astype(np.float32)
    grads = [rng.normal(size=(7, 3)).astype(np.float32) for _ in range(5)]
    lr = 0.01
    tp = torch.nn.Parameter(torch.tensor(p0))
    topt = torch.optim.Adam([tp], lr=lr, eps=1e-15)
    params = {"x": torch.tensor(p0)}
    state = AdamState.init(params)
    for g in grads:
        tp.grad = torch.tensor(g)
        topt.step()
        params, state = adam_update(params, {"x": torch.tensor(g)}, state, {"x": lr})
        np.testing.assert_allclose(params["x"].numpy(), tp.detach().numpy(), rtol=2e-5, atol=1e-6)
    assert state.step["x"] == 5


def test_adam_matches_jax_with_mask():
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(6, 2)).astype(np.float32)
    mask = np.array([True, False, True, True, False, True])
    params, jparams = {"x": torch.tensor(p0)}, {"x": jnp.asarray(p0)}
    state, jstate = AdamState.init(params), JaxAdam.init(jparams)
    for i in range(4):
        g = rng.normal(size=(6, 2)).astype(np.float32)
        params, state = adam_update(params, {"x": torch.tensor(g)}, state, {"x": 0.05},
                                    update_mask=torch.tensor(mask))
        jparams, jstate = jax_adam_update(jparams, {"x": jnp.asarray(g)}, jstate,
                                          {"x": jnp.float32(0.05)}, update_mask=jnp.asarray(mask))
    np.testing.assert_allclose(params["x"].numpy(), np.asarray(jparams["x"]), rtol=1e-6)
    np.testing.assert_array_equal(params["x"].numpy()[~mask], p0[~mask])
    np.testing.assert_allclose(state.nu["x"].numpy(), np.asarray(jstate.nu["x"]), rtol=1e-6)
    zeroed = state.zero_slots("x", torch.tensor(mask))
    assert float(zeroed.mu["x"][torch.tensor(mask)].abs().sum()) == 0.0
    assert float(state.zero_field("x").nu["x"].abs().sum()) == 0.0


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4 * 4.0, lr_final=1.6e-6 * 4.0, lr_delay_mult=0.01, max_steps=30_000),
    dict(lr_init=1e-3, lr_final=1e-5, lr_delay_steps=100, lr_delay_mult=0.1, max_steps=500),
])
def test_expon_lr_equals_jax(kw):
    ours, theirs = expon_lr_func(**kw), jax_expon(**kw)
    for step in (-1, 0, 1, 50, 99, 100, 7000, 29_999, 30_000, 40_000):
        assert ours(step) == theirs(step)


def test_knn_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(300, 3)).astype(np.float32) * [1.0, 2.0, 0.5]
    pts = pts.astype(np.float32)
    want = np.asarray(jax_knn(jnp.asarray(pts)))
    got = mean_sq_dist_3nn(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    chunked = mean_sq_dist_knn(torch.from_numpy(pts), chunk=64).numpy()
    np.testing.assert_array_equal(chunked, got)


def test_checkpoint_round_trip_jax_port_jax(tmp_path):
    jstate = _jax_state(False)
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_checkpoint(a, jstate, 1234, 2, 3.5)
    state, it, deg, scale = checkpoint.load_checkpoint(a, device="cpu")
    checkpoint.save_checkpoint(b, state, it, deg, scale)
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    back, it2, deg2, scale2 = jckpt.load_checkpoint(b)
    assert (it2, deg2, scale2) == (1234, 2, 3.5)
    np.testing.assert_array_equal(np.asarray(back.pool.alive), np.asarray(jstate.pool.alive))


def test_ply_files_are_byte_equal(tmp_path):
    rng = np.random.default_rng(4)
    n = 50
    arrays = dict(
        xyz=rng.normal(size=(n, 3)), features_dc=rng.normal(size=(n, 1, 3)),
        features_rest=rng.normal(size=(n, 15, 3)), opacity=rng.normal(size=(n, 1)),
        scaling=rng.normal(size=(n, 3)), rotation=rng.normal(size=(n, 4)),
    )
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    order = ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation")
    ply.save_gaussian_ply(str(tmp_path / "a.ply"), *(arrays[k] for k in order))
    jply.save_gaussian_ply(str(tmp_path / "b.ply"), *(arrays[k] for k in order))
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()

    pts = rng.normal(size=(30, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (30, 3)).astype(np.uint8)
    ply.save_point_cloud_ply(str(tmp_path / "c.ply"), pts, cols)
    jply.save_point_cloud_ply(str(tmp_path / "d.ply"), pts, cols)
    assert (tmp_path / "c.ply").read_bytes() == (tmp_path / "d.ply").read_bytes()
    for got, want in zip(ply.load_point_cloud_ply(str(tmp_path / "c.ply")),
                         jply.load_point_cloud_ply(str(tmp_path / "d.ply"))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["ModelParams", "OptimizationParams", "PipelineParams"])
def test_flags_match_jax_name_for_name(name):
    ours, theirs = argparse.ArgumentParser(), argparse.ArgumentParser()
    config.add_dataclass_args(ours, getattr(config, name), "g")
    jconfig.add_dataclass_args(theirs, getattr(jconfig, name), "g")
    flags = lambda p: sorted(s for a in p._actions for s in a.option_strings)
    assert flags(ours) == flags(theirs)
    ours_ns, theirs_ns = ours.parse_args([]), theirs.parse_args([])
    skip = {"data_device"}  # "cuda" in the port, "tpu" in the JAX package
    assert {k: v for k, v in vars(ours_ns).items() if k not in skip} == \
        {k: v for k, v in vars(theirs_ns).items() if k not in skip}
