"""The port's vectorize / PCA module (`models/vectorized.py`) against
`sgs_tpu/models/vectorized.py` on the CPU.

A seeded 600-Gaussian subset of the flagship PLY in a JAX pool padded with
dead slots (and some slots killed), carried to the port with
`from_jax_arrays`. `vectorized` and `from_vector` give JAX's bits (the
same numpy arithmetic); the round trip holds to JAX's own tolerances
(tests/test_eval_tools.py::test_vectorized_roundtrip: shape rtol 1e-4
atol 1e-5, appearance rtol 1e-5 atol 1e-6). `pca_project` against JAX's
on low-rank data (tests/test_eval_tools.py::test_pca_projection_properties),
without and with the normalisation: reconstruction within 1e-5, the
variance spectrum within 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from sgs_tpu.data.ply import load_gaussian_ply
from sgs_tpu.data.scene import pool_from_arrays
from sgs_tpu.models import vectorized as jvec
from sgs_tpu_torch.models import vectorized as vec
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, from_jax_arrays

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pools():
    arrays = load_gaussian_ply(os.path.join(ROOT, "assets", "flagship", "point_cloud.ply"), 3)
    rng = np.random.default_rng(3)
    keep = np.sort(rng.choice(arrays["xyz"].shape[0], 600, replace=False))
    pool = pool_from_arrays({k: v[keep] for k, v in arrays.items()}, 3)
    alive = np.array(pool.alive)
    alive[rng.choice(600, 50, replace=False)] = False
    pool = pool.replace(alive=alive)
    fields = {f: np.array(getattr(pool, f)) for f in (*PARAM_FIELDS, "alive")}
    return pool, from_jax_arrays(fields, 3, device="cpu")


def test_vectorized_matches_jax(pools):
    pool, model = pools
    want = jvec.vectorized(pool)
    got = vec.vectorized(model)
    assert got[0].shape == (550, 11) and got[1].shape == (550, 48)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_from_vector_matches_jax(pools):
    shape_p, app_p = jvec.vectorized(pools[0])
    want = jvec.from_vector(3, shape_p, app_p)
    got = vec.from_vector(3, shape_p, app_p, device="cpu")
    assert got.max_sh_degree == 3 and got.num_alive == got.capacity == 550
    compact = want.compact_arrays()
    for f, v in got.compact_arrays().items():
        np.testing.assert_array_equal(v, compact[f], err_msg=f)


def test_roundtrip(pools):
    shape_p, app_p = vec.vectorized(pools[1])
    shape_p2, app_p2 = vec.vectorized(vec.from_vector(3, shape_p, app_p, device="cpu"))
    np.testing.assert_allclose(shape_p2, shape_p, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(app_p2, app_p, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("normalised", [False, True])
def test_pca_project_matches_jax(normalised):
    rng = np.random.default_rng(0)
    basis = rng.normal(size=(5, 48))
    coeffs = rng.normal(size=(500, 5))
    data = (coeffs @ basis + rng.normal(size=(500, 48)) * 0.01).astype(np.float32)
    stats = {}
    if normalised:
        mean, std = vec.compute_normalization(data)
        jmean, jstd = jvec.compute_normalization(data)
        np.testing.assert_array_equal(mean, jmean)
        np.testing.assert_array_equal(std, jstd)
        stats = {"mean": mean, "std": std}
    recon, ratio = vec.pca_project(data, rank=5, **stats)
    jrecon, jratio = jvec.pca_project(data, rank=5, **stats)
    assert recon.dtype == np.float32 and recon.shape == data.shape
    assert ratio[:5].sum() > 0.99
    np.testing.assert_allclose(recon, jrecon, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ratio, jratio, atol=1e-6, rtol=0)
    np.testing.assert_allclose(recon, data, atol=0.1)
