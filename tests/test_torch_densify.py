"""Port parity of the pool and of densification: `from_pcd`, `grown`,
`densify_and_prune` and `reset_opacity` (sgs_tpu_torch.models) against the
JAX package's, on the same pool, statistics and split noise (JAX's draws
handed to the port). Same alive slots and slot contents; parameters to
atol 1e-6, as the JAX split child's rotated offset is an einsum whose sum
order is XLA's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgs_tpu.models.densify import densify_and_prune as jax_densify
from sgs_tpu.models.densify import reset_opacity as jax_reset
from sgs_tpu.models.gaussians import DensifyStats as JaxStats
from sgs_tpu.models.gaussians import GaussianPool
from sgs_tpu.train.optim import AdamState as JaxAdam
from sgs_tpu_torch.models import densify
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, DensifyStats, GaussianModel
from sgs_tpu_torch.train.optim import AdamState

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pools(seed, n, capacity):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    jpool = GaussianPool.from_pcd(pts, cols, 2, capacity=capacity)
    model = GaussianModel.from_pcd(pts, cols, 2, capacity=capacity, device="cpu")
    return rng, jpool, model


def _assert_same_pool(model, jpool, atol=1e-6):
    np.testing.assert_array_equal(model.alive.numpy(), np.asarray(jpool.alive))
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(model, f).numpy(), np.asarray(getattr(jpool, f)),
                                   rtol=0, atol=atol, err_msg=f)


def test_from_pcd_and_grown_match_jax():
    _, jpool, model = _pools(0, 40, 128)
    _assert_same_pool(model, jpool, atol=1e-6)
    _assert_same_pool(model.grown(256), jpool.grown(256), atol=1e-6)
    arrays = model.compact_arrays()
    want = jpool.compact_arrays()
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(arrays[f], want[f], atol=1e-6)


def _state(rng, jpool, model, scaling, hot):
    cap = jpool.capacity
    jpool = jpool.replace(scaling=jnp.asarray(scaling))
    model = model.with_params({"scaling": _t(scaling)})
    accum = np.zeros((cap, 1), np.float32)
    denom = np.zeros((cap, 1), np.float32)
    accum[hot, 0] = rng.uniform(0.6, 2.0, len(hot))
    denom[hot, 0] = 1.0
    radii = rng.uniform(0, 40, cap).astype(np.float32)
    jstats = JaxStats(xyz_gradient_accum=jnp.asarray(accum), denom=jnp.asarray(denom),
                      max_radii2d=jnp.asarray(radii))
    stats = DensifyStats(xyz_gradient_accum=_t(accum), denom=_t(denom), max_radii2d=_t(radii))
    mu = {f: rng.normal(size=np.asarray(getattr(jpool, f)).shape).astype(np.float32)
          for f in PARAM_FIELDS}
    jadam = JaxAdam(mu={f: jnp.asarray(v) for f, v in mu.items()},
                    nu={f: jnp.asarray(np.abs(v)) for f, v in mu.items()},
                    step={f: jnp.int32(9) for f in PARAM_FIELDS})
    adam = AdamState(mu={f: _t(v) for f, v in mu.items()},
                     nu={f: _t(np.abs(v)) for f, v in mu.items()}, step={f: 9 for f in PARAM_FIELDS})
    return jpool, model, jstats, stats, jadam, adam


@pytest.mark.parametrize("capacity,max_screen_size", [(96, 0.0), (48, 20.0)])
def test_densify_and_prune_match_jax(capacity, max_screen_size):
    n = 40
    rng, jpool, model = _pools(1, n, capacity)
    scaling = np.asarray(jpool.scaling).copy()
    scaling[:n] = np.log(rng.uniform(0.003, 0.06, (n, 3))).astype(np.float32)
    scaling[3] = np.log([2.0, 1.0, 0.5])  # split, then its children fail the world-size test
    opacity = np.asarray(jpool.opacity).copy()
    opacity[5, 0] = -8.0  # pruned for opacity
    jpool = jpool.replace(opacity=jnp.asarray(opacity))
    model = model.with_params({"opacity": _t(opacity)})
    hot = np.arange(0, n, 2)
    jpool, model, jstats, stats, jadam, adam = _state(rng, jpool, model, scaling, hot)

    key = jax.random.PRNGKey(11)
    noise = [np.asarray(jax.random.normal(k, (capacity, 3), jnp.float32))
             for k in jax.random.split(key, 2)]
    kw = dict(max_grad=0.5, min_opacity=0.005, extent=3.0, max_screen_size=max_screen_size,
              percent_dense=0.01)
    jnew, jadam2, jstats2, jinfo = jax_densify(jpool, jadam, jstats, key, **kw)
    new, adam2, stats2, info = densify.densify_and_prune(model, adam, stats,
                                                         noise=[_t(z) for z in noise], **kw)
    for k, v in jinfo.items():
        assert info[k] == int(v), k
    assert info["n_cloned"] > 0 and info["n_split"] > 0 and info["n_pruned"] > info["n_split"]
    if capacity == 48:
        assert info["n_dropped_overflow"] > 0
    _assert_same_pool(new, jnew)
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(adam2.mu[f].numpy(), np.asarray(jadam2.mu[f]), err_msg=f)
        np.testing.assert_array_equal(adam2.nu[f].numpy(), np.asarray(jadam2.nu[f]), err_msg=f)
    assert float(stats2.xyz_gradient_accum.abs().sum()) == 0.0
    assert stats2.max_radii2d.shape == (capacity,)

    jreset, jadam3 = jax_reset(jnew, jadam2)
    reset, adam3 = densify.reset_opacity(new, adam2)
    _assert_same_pool(reset, jreset)
    assert float(adam3.mu["opacity"].abs().sum()) == 0.0
    np.testing.assert_array_equal(adam3.mu["xyz"].numpy(), np.asarray(jadam3.mu["xyz"]))


def test_densify_draws_noise_from_a_generator():
    n = 12
    rng, _, model = _pools(2, n, 64)
    scaling = model.scaling.clone()
    scaling[:n] = 0.0  # every hot slot splits
    _, model, _, stats, _, adam = _state(rng, GaussianPool.from_pcd(
        np.zeros((n, 3), np.float32), np.zeros((n, 3), np.float32), 2, capacity=64),
        model, scaling.numpy(), np.arange(n))
    kw = dict(max_grad=0.5, min_opacity=0.005, extent=100.0, max_screen_size=0.0,
              percent_dense=0.01)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        outs.append(densify.densify_and_prune(model, adam, stats, generator=gen, **kw)[0])
    assert outs[0].num_alive == 2 * n
    np.testing.assert_array_equal(outs[0].xyz.numpy(), outs[1].xyz.numpy())
