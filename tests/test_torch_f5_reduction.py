"""Fault F5: why the port's flagship schedule ends below the JAX run's test
PSNR. The JAX trainer's tiled rasterizer with tight culling sums each
Gaussian's instance gradients as the difference of two f32 prefix sums
over every instance of the view (`sgs_tpu/ops/pallas/flat_raster.py::
reduce_grads_presort`); Kernel C sums each Gaussian's run on its own
(`sgs_tpu_torch/ops/flat_raster.py::reduce_runs_plain`). On a real
training state the prefix differences carry the rounding of the whole
prefix, far beyond the run's own; and a non-finite instance gradient makes
the sums of nearly every later Gaussian non-finite, where Kernel C keeps it
in its own Gaussian. `sgs_tpu_torch/tools/jax_reduction.py` computes JAX's arithmetic
with PyTorch operations (for `tools/flagship_long_run.py --reduction
jax_prefix`); it is held to JAX's function here.

The state is JAX's own `runs/flagship_r5/chkpnt10000.npz`, one train view
rendered at 200x200 by the port's plain path; `tests/f5_probe.py
reduction` measures the same at 800x800."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgs_tpu.data import readers
from sgs_tpu.ops.pallas import flat_raster as jfr
from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.ops import flat_raster
from sgs_tpu_torch.render.pipeline import render
from sgs_tpu_torch.tools import jax_reduction
from sgs_tpu_torch.train import checkpoint, loop

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "runs", "flagship_r5", "chkpnt10000.npz")
SIZE, VIEW = 200, 17
CONIC = (2, 3, 4)  # the ca, cb, cc channels of the (M, 9) records


@pytest.fixture(scope="module")
def instances():
    """The presort instance gradients of one step's backward, with the
    exact (f64) per-Gaussian sums."""
    state, _, sh, _ = checkpoint.load_checkpoint(CKPT, "cpu")
    info = readers.read_cameras_from_transforms(os.path.join(ROOT, "data", "flagship800"),
                                                "transforms_train.json", False)[VIEW]
    f = 800 // SIZE
    full = np.asarray(info.image, np.float32).transpose(2, 0, 1) / 255.0
    gt = torch.from_numpy(full.reshape(3, SIZE, f, SIZE, f).mean(axis=(2, 4)).astype(np.float32))
    cam = Camera.from_Rt(info.R, info.T, info.FovX, info.FovY, SIZE, SIZE, device="cpu")
    model, cap, plain = state.model, {}, flat_raster.reduce_runs_plain

    def grab(inst, rank_start, order):
        cap.update(inst=inst.clone(), rank_start=rank_start.clone(), order=order.clone())
        return plain(inst, rank_start, order)

    def render_fn(leaves, tap):
        return render(cam, model.with_params(leaves).render_inputs(sh), torch.zeros(3), vspace_tap=tap)

    flat_raster.reduce_runs_plain = grab
    try:
        loop.view_grads(model, render_fn, gt)
    finally:
        flat_raster.reduce_runs_plain = plain
    inst, rs, order = cap["inst"], cap["rank_start"], cap["order"]
    c64 = torch.cat([torch.zeros(1, 9, dtype=torch.float64), torch.cumsum(inst.double(), 0)])
    exact = torch.empty((order.shape[0], 9), dtype=torch.float64)
    exact[order] = c64[rs[1:]] - c64[rs[:-1]]
    live = torch.zeros(order.shape[0], dtype=torch.bool)
    live[order[(rs[1:] - rs[:-1]) > 0]] = True
    return inst, rs, order, exact, live


def _jax_reduce(inst, rank_start, order, bucket):
    """JAX's reduce_grads_presort on the records laid out as its slots: one
    level-1 row per depth rank, so offs2 is rank_start."""
    m, n = inst.shape[0], order.shape[0]
    g = np.zeros((bucket, 16), np.float32)
    g[:m, :9] = inst.numpy()
    out = jfr.reduce_grads_presort(
        (jnp.asarray(g[:, 0:8]), jnp.asarray(g[:, 8:16])), jnp.arange(bucket, dtype=jnp.int32),
        (jnp.arange(n, dtype=jnp.int32), jnp.ones((n,), jnp.int32)),
        jnp.asarray(rank_start.numpy().astype(np.int32)), jnp.asarray(order.numpy().astype(np.int32)), n)
    return torch.from_numpy(np.array(out))


def c_abs_prefix(inst):
    return torch.cumsum(inst.double(), 0).abs()


def _share_off(got, exact, live, channels, frac=0.1):
    e = exact[live][:, channels]
    return float(((got[live][:, channels].double() - e).abs() > frac * e.abs()).double().mean())


@pytest.mark.parametrize("bucket", [1 << 20, 1 << 18])
def test_prefix_differences_miss_the_conic_sums(instances, bucket):
    """JAX's sums are off by more than 10% for a large share of the conic
    sums; Kernel C's for next to none; the port's emulation of JAX's
    arithmetic misses them as often as JAX's function does."""
    inst, rs, order, exact, live = instances
    assert inst.shape[0] > 50_000 and int(live.sum()) > 20_000
    jax_sums = _jax_reduce(inst, rs, order, bucket)
    emulated = jax_reduction.jax_prefix_reduce(inst, rs, order, bucket)
    port = flat_raster.reduce_runs_plain(inst, rs, order)
    s_jax, s_emul = _share_off(jax_sums, exact, live, CONIC), _share_off(emulated, exact, live, CONIC)
    s_port = _share_off(port, exact, live, CONIC)
    assert s_jax > 0.2 and abs(s_emul - s_jax) < 0.05 * s_jax, (s_jax, s_emul)
    assert s_port < 1e-3, s_port
    # the error is the prefix's rounding, not the run's: about the f32 ulp
    # of the running sum, whatever the Gaussian's own sum
    scale = float(c_abs_prefix(inst)[..., list(CONIC)].max())
    err = (jax_sums[live][:, list(CONIC)].double() - exact[live][:, list(CONIC)]).abs().max()
    assert float(err) <= 8 * np.spacing(np.float32(scale))


def test_nonfinite_instance_spreads_to_every_later_gaussian(instances):
    """One non-finite conic record: JAX's sums of that channel become
    non-finite from about the start of the record's group of 16 x 256
    records on (the exclusive group offsets are an inclusive cumsum minus
    the group's total, inf - inf), so for every Gaussian ranked after it
    and a few before; Kernel C's only for its own Gaussian."""
    inst, rs, order, _, _ = instances
    inst = inst.clone()
    lengths = rs[1:] - rs[:-1]
    ranks = torch.nonzero(lengths > 0).flatten()
    rank = int(ranks[len(ranks) // 10])
    pos = int(rs[rank])
    inst[pos, 2] = float("inf")
    jax_sums = _jax_reduce(inst, rs, order, 1 << 20)
    emulated = jax_reduction.jax_prefix_reduce(inst, rs, order, 1 << 20)
    port = flat_raster.reduce_runs_plain(inst, rs, order)
    # the prefix at a bound is non-finite once it reads a row of the group
    # past its first, or the first row's lane that holds the record
    per_row = jax_reduction.RECORDS_PER_ROW
    first_row = pos // (per_row * jax_reduction.GROUP_ROWS) * jax_reduction.GROUP_ROWS
    row, lane = rs // per_row, rs % per_row
    nan_at = (row > first_row) | ((row == first_row) & (lane > pos % per_row))
    expected = nan_at[1:] | nan_at[:-1]
    for got in (jax_sums, emulated):
        bad = ~torch.isfinite(got[order][:, 2])
        assert torch.equal(bad, expected)
        assert bool(torch.isfinite(got[:, [0, 1, 3, 4, 5, 6, 7, 8]]).all())
    assert int(expected[rank:].sum()) == expected.shape[0] - rank
    bad_port = ~torch.isfinite(port[order][:, 2])
    assert int(bad_port.sum()) == 1 and bool(bad_port[rank])


def test_use_jax_reduction_swaps_and_restores():
    plain, kernel = flat_raster.reduce_runs_plain, flat_raster.reduce_runs
    with jax_reduction.use_jax_reduction():
        assert flat_raster.reduce_runs_plain is not plain and flat_raster.reduce_runs is not kernel
    assert flat_raster.reduce_runs_plain is plain and flat_raster.reduce_runs is kernel
