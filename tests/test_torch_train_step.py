"""Port parity of one training step on the CPU.

A seeded 2,000-Gaussian subset of the flagship PLY goes into a padded JAX
pool with seeded Adam moments and densification statistics (so the step
is not Adam's sign-like first step). The state is written with the JAX
checkpoint writer and read by the port's loader. Both packages then run
one `train_step` on the same flagship train view (at 96x96) and GT: JAX in
tiled mode with the Pallas backend and tight culling (the kernels in
interpret mode), op by op under `jax.disable_jit` as in
tests/test_torch_slice.py; the port with Kernels A-D's plain versions.

Tolerances: loss and L1 to rtol 1e-5; new parameters, Adam moments and
statistics to rtol 1e-4 plus an atol of 2e-4 of each field's largest
magnitude; nonfinite_grads exactly. The atol is the f32 noise floor of
these gradients: a few scaling and rotation gradients are small sums of
large cancelling terms, and the JAX package's own step, jitted against op
by op on the same state, differs there by up to 6.8e-5 of the field's
largest gradient (scaling) and by 6% on single elements (rotation).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgs_tpu.core.camera import Camera as JaxCamera
from sgs_tpu.data import readers
from sgs_tpu.data.ply import load_gaussian_ply
from sgs_tpu.data.scene import pool_from_arrays
from sgs_tpu.models.gaussians import DensifyStats as JaxStats
from sgs_tpu.models.gaussians import PARAM_FIELDS
from sgs_tpu.train import checkpoint as jckpt
from sgs_tpu.train import loop as jloop
from sgs_tpu.train.optim import AdamState as JaxAdam
from sgs_tpu.train.optim import make_lr_dict as jax_lr_dict
from sgs_tpu.utils.config import OptimizationParams as JaxOpt
from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.train import checkpoint, loop
from sgs_tpu_torch.train.optim import make_lr_dict
from sgs_tpu_torch.utils.config import OptimizationParams

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SUBSET, SIZE, VIEW, ITERATION = 2000, 96, 3, 7000
RTOL, ATOL_SCALE = 1e-4, 2e-4


def _jax_state(degenerate: bool):
    arrays = load_gaussian_ply(os.path.join(ROOT, "assets", "flagship", "point_cloud.ply"), 3)
    rng = np.random.default_rng(0)
    keep = np.sort(rng.choice(arrays["xyz"].shape[0], N_SUBSET, replace=False))
    sub = {k: v[keep] for k, v in arrays.items()}
    if degenerate:
        # one splat whose squared scale overflows f32: its covariance and
        # every gradient through it are non-finite in both packages
        sub["scaling"][7] = [50.0, 0.0, 0.0]
    pool = pool_from_arrays(sub, 3)
    params = pool.params()
    adam = JaxAdam(
        mu={k: jnp.asarray(rng.normal(0, 1e-4, v.shape).astype(np.float32)) for k, v in params.items()},
        nu={k: jnp.asarray(rng.uniform(1e-9, 1e-7, v.shape).astype(np.float32))
            for k, v in params.items()},
        step={k: jnp.int32(40) for k in params},
    )
    cap = pool.capacity
    stats = JaxStats(
        xyz_gradient_accum=jnp.asarray(rng.uniform(0, 1e-3, (cap, 1)).astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 20, (cap, 1)).astype(np.float32)),
        max_radii2d=jnp.asarray(rng.uniform(0, 30, cap).astype(np.float32)),
    )
    return jloop.TrainState(pool=pool, adam=adam, stats=stats)


def _view():
    infos = readers.read_cameras_from_transforms(
        os.path.join(ROOT, "data", "flagship800"), "transforms_train.json", False
    )
    info = infos[VIEW]
    f = 800 // SIZE
    full = np.asarray(info.image, np.float32).transpose(2, 0, 1)[:, :SIZE * f, :SIZE * f] / 255.0
    gt = full.reshape(3, SIZE, f, SIZE, f).mean(axis=(2, 4)).astype(np.float32)
    return info, gt


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_SCALE * scale, err_msg=name)


@pytest.mark.parametrize("degenerate", [False, True])
def test_train_step_matches_jax(tmp_path, degenerate):
    jstate = _jax_state(degenerate)
    path = str(tmp_path / "state.npz")
    jckpt.save_checkpoint(path, jstate, ITERATION, 3, 4.03)
    state, iteration, sh_degree, extent = checkpoint.load_checkpoint(path, device="cpu")
    assert (iteration, sh_degree) == (ITERATION, 3)

    info, gt = _view()
    jcam = JaxCamera.from_Rt(info.R, info.T, info.FovX, info.FovY, SIZE, SIZE)
    cam = Camera.from_Rt(info.R, info.T, info.FovX, info.FovY, SIZE, SIZE, device="cpu")
    jlrs = {k: jnp.float32(v) for k, v in jax_lr_dict(JaxOpt(), extent, ITERATION).items()}
    lrs = make_lr_dict(OptimizationParams(), extent, ITERATION)
    assert lrs == {k: float(v) for k, v in jax_lr_dict(JaxOpt(), extent, ITERATION).items()}

    mi, mr, mk = jloop.instance_bucket(jstate.pool, jcam, tight=True)
    with jax.disable_jit():
        jnew, jm = jloop.train_step(
            jstate, jcam, jnp.asarray(gt), jnp.zeros(3), jlrs, active_sh_degree=3,
            mode="tiled", max_instances=mi, backend="pallas", max_row_instances=mr,
            max_kernel_rows=mk,
        )
    new, m = loop.train_step(state, cam, torch.from_numpy(gt), torch.zeros(3), lrs,
                             active_sh_degree=3)

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["l1"]), float(jm["l1"]), rtol=1e-5)
    assert int(m["nonfinite_grads"]) == int(jm["nonfinite_grads"])
    assert (int(m["nonfinite_grads"]) > 0) == degenerate
    assert int(m["n_visible"]) == int(jm["n_visible"]) > 100
    for f in PARAM_FIELDS:
        _close(getattr(new.model, f), getattr(jnew.pool, f), f)
        _close(new.adam.mu[f], jnew.adam.mu[f], f"mu {f}")
        _close(new.adam.nu[f], jnew.adam.nu[f], f"nu {f}")
        assert new.adam.step[f] == int(jnew.adam.step[f])
    # the stats read the view-space tap's gradient
    _close(new.stats.xyz_gradient_accum, jnew.stats.xyz_gradient_accum, "xyz_gradient_accum")
    _close(new.stats.denom, jnew.stats.denom, "denom")
    _close(new.stats.max_radii2d, jnew.stats.max_radii2d, "max_radii2d")
    moved = new.stats.xyz_gradient_accum - state.stats.xyz_gradient_accum
    assert float(moved.abs().max()) > 0
