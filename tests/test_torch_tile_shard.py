"""Port parity of `sgs_tpu_torch/parallel/tile_shard.py`, the Gaussian-shard
row-band render, on the CPU.

The band render over 4 gloo ranks (`tests/torch_dist.py`; rank bodies at
module level, no JAX in the children) is held to JAX's single-device tiled
render with its XLA backend: the reference JAX's own
`tests/test_tile_shard.py` holds JAX's sharded render to, at JAX's bars
(image atol 3e-5; parameter and tap gradients rtol 2e-3, atol 3e-6).
JAX's sharded render itself takes over two minutes to compile on the
virtual mesh, too long for Tier-1. The band helpers are held to JAX's
exactly, and the one-device stitch of the bands (the card's check in
`chip_smoke.py` phase 14) to the port's full render at the same bars.
"""

import math

import numpy as np
import pytest
import torch

import torch_dist
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS
from sgs_tpu_torch.parallel import hybrid, mesh as mesh_lib, tile_shard

torch.set_num_threads(1)
SIZE, N, CAPACITY, RANKS = 64, 96, 128, 4
BG = [0.2, 0.5, 0.7]


@pytest.mark.parametrize("height, n_dev", [(64, 8), (1080, 8), (800, 8), (800, 4), (24, 3), (17, 2)])
def test_band_height_matches_jax(height, n_dev):
    from sgs_tpu.parallel.tile_shard import band_height

    assert tile_shard.band_height(height, n_dev) == band_height(height, n_dev)


@pytest.mark.parametrize("seed, tiles_y, n_bands", [(0, 16, 4), (1, 50, 8), (2, 5, 8), (3, 7, 7),
                                                    (4, 50, 3)])
def test_balanced_band_offsets_match_jax(seed, tiles_y, n_bands):
    from sgs_tpu.parallel.tile_shard import balanced_band_offsets

    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 1000, tiles_y) * (rng.random(tiles_y) < 0.7)
    got, want = tile_shard.balanced_band_offsets(hist, n_bands), balanced_band_offsets(hist, n_bands)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def _setup():
    """tests/test_tile_shard.py's scene: 96 Gaussians in front of the
    camera with random scales and opacities, 64x64."""
    from sgs_tpu.core.projection import focal2fov, fov2focal
    from sgs_tpu.models.gaussians import GaussianPool

    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-1, 1, N), rng.uniform(-1, 1, N), rng.uniform(2.5, 6, N)], -1).astype(np.float32)
    cols = rng.uniform(size=(N, 3)).astype(np.float32)
    pool = GaussianPool.from_pcd(pts, cols, 1, capacity=CAPACITY)
    alive = np.asarray(pool.alive)
    arrays = {f: np.asarray(getattr(pool, f)) for f in PARAM_FIELDS}
    arrays["scaling"] = np.where(alive[:, None], rng.uniform(-2.8, -1.6, (CAPACITY, 3)),
                                 arrays["scaling"]).astype(np.float32)
    arrays["opacity"] = np.where(alive[:, None], rng.uniform(-0.5, 2.5, (CAPACITY, 1)),
                                 arrays["opacity"]).astype(np.float32)
    arrays["alive"] = alive
    fovx = math.radians(60)
    spec = (np.eye(3), np.zeros(3), fovx, focal2fov(fov2focal(fovx, SIZE), SIZE), SIZE, SIZE)
    target = np.random.default_rng(3).uniform(size=(3, SIZE, SIZE)).astype(np.float32)
    return arrays, spec, target


def _leaves(arrays, lo=0, hi=CAPACITY):
    return {f: torch.tensor(arrays[f][lo:hi]).requires_grad_(True) for f in PARAM_FIELDS}


def _rank_sharded_render(rank, world, arrays, spec, target):
    mesh_lib.init_distributed("cpu")
    group = torch.distributed.group.WORLD
    lo, hi = rank * CAPACITY // world, (rank + 1) * CAPACITY // world
    leaves = _leaves(arrays, lo, hi)
    tap = torch.zeros((hi - lo, 3), requires_grad=True)
    fn = tile_shard.make_sharded_render(group, SIZE, SIZE, 1)
    img = fn(leaves, torch.tensor(arrays["alive"][lo:hi]), torch_dist.cameras([spec])[0],
             torch.tensor(BG), tap)
    loss = torch.mean(torch.abs(img - torch.tensor(target)))
    grads = torch.autograd.grad(loss, [leaves[f] for f in PARAM_FIELDS] + [tap])
    return {"image": img.detach().numpy(), "grads": [g.numpy() for g in grads]}


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's single-device tiled render (XLA backend) of the scene, its L1
    loss's parameter and tap gradients."""
    import jax
    import jax.numpy as jnp

    from sgs_tpu.core.camera import Camera as JaxCamera
    from sgs_tpu.models.gaussians import GaussianPool
    from sgs_tpu.render import render

    arrays, spec, target = _setup()
    pool = GaussianPool(**{f: jnp.asarray(arrays[f]) for f in PARAM_FIELDS},
                        alive=jnp.asarray(arrays["alive"]), max_sh_degree=1)
    cam = JaxCamera.from_Rt(*spec)

    def loss_ref(params, tap):
        out = render(cam, pool.with_params(params).render_inputs(1), jnp.asarray(BG), mode="tiled",
                     vspace_tap=tap)
        return jnp.mean(jnp.abs(out["render"] - target)), out["render"]

    (_, img), (g, gt) = jax.value_and_grad(loss_ref, argnums=(0, 1), has_aux=True)(
        pool.params(), jnp.zeros((CAPACITY, 3), jnp.float32))
    return arrays, spec, target, {"image": np.asarray(img), "tap": np.asarray(gt),
                                  **{f: np.asarray(g[f]) for f in PARAM_FIELDS}}


def test_sharded_render_and_gradients_match_jax(jax_reference):
    """`make_sharded_render` over 4 gauss ranks (each with 32 of the 128
    slots, each compositing a 16-row band): the full image on every rank
    within atol 3e-5 of JAX's render, each rank's parameter and tap
    gradients (its slots) within rtol 2e-3, atol 3e-6 of JAX's.

    The camera sits at the origin, where the 32 dead slots also sit: there
    JAX's xyz gradient is NaN (the norm of a zero view direction, 0/0,
    times a zero cotangent) and the port's is 0 (PyTorch's norm has the
    zero subgradient at 0). Those rows are checked to be exactly the dead
    slots, with a zero gradient in the port."""
    arrays, spec, target, want = jax_reference
    res = torch_dist.spawn(_rank_sharded_render, RANKS, arrays, spec, target)
    for out in res:
        np.testing.assert_allclose(out["image"], want["image"], atol=3e-5)
    at_camera = ~arrays["alive"] & (np.abs(arrays["xyz"]).max(axis=1) == 0)
    for i, f in enumerate(PARAM_FIELDS + ("tap",)):
        got = np.concatenate([out["grads"][i] for out in res])
        w = want[f]
        if f == "tap":
            got, w = got[:, :2], w[:, :2]
        assert np.isfinite(got).all(), f
        jax_bad = ~np.isfinite(w).reshape(w.shape[0], -1).all(axis=1)
        if f == "xyz":
            np.testing.assert_array_equal(jax_bad, at_camera)
            assert at_camera.sum() == CAPACITY - N and not got[jax_bad].any()
        else:
            assert not jax_bad.any(), f
        np.testing.assert_allclose(got[~jax_bad], w[~jax_bad], rtol=2e-3, atol=3e-6, err_msg=f)
    assert np.abs(want["tap"][:, :2]).max() > 1e-4


def _full_and_bands(arrays, spec, target, offsets, pad, own):
    """The port's full render and its stitched bands on one device, each
    with the L1 loss's parameter and tap gradients."""
    from sgs_tpu_torch.render.pipeline import render

    cam = torch_dist.cameras([spec])[0]
    alive = torch.tensor(arrays["alive"])
    bg, tgt = torch.tensor(BG), torch.tensor(target)
    out = {}
    for name in ("full", "bands"):
        leaves = _leaves(arrays)
        tap = torch.zeros((CAPACITY, 3), requires_grad=True)
        if name == "full":
            from sgs_tpu_torch.models.gaussians import GaussianModel

            model = GaussianModel(**leaves, alive=alive, max_sh_degree=1)
            img = render(cam, model.render_inputs(1), bg, vspace_tap=tap)["render"]
        else:
            rec, _, _ = tile_shard.splat_records(leaves, alive, cam, 1, tap)
            img, _ = hybrid.render_bands(rec, offsets, pad, SIZE, SIZE, bg, own=own)
        loss = torch.mean(torch.abs(img - tgt))
        grads = torch.autograd.grad(loss, [leaves[f] for f in PARAM_FIELDS] + [tap])
        out[name] = (img.detach().numpy(), [g.numpy() for g in grads])
    return out


@pytest.mark.parametrize("layout", ["equal", "balanced"])
def test_band_stitch_matches_full_render(layout):
    """The bands rendered one after another on one device and stitched
    (`hybrid.render_bands`, the card's phase 14 (a) at a small size):
    4 equal bands, or balanced bands from the scene's row load with the
    ownership cull and compaction; image within 3e-5 of the full render,
    parameter and tap gradients within rtol 2e-3, atol 3e-6."""
    from sgs_tpu_torch.core.projection import project_gaussians
    from sgs_tpu_torch.core import transforms

    arrays, spec, target = _setup()
    if layout == "equal":
        offsets, pad = hybrid.equal_band_offsets(SIZE, RANKS)
        own = False
    else:
        cam = torch_dist.cameras([spec])[0]
        p = {f: torch.tensor(arrays[f]) for f in PARAM_FIELDS}
        cov = transforms.build_covariance(torch.exp(p["scaling"]), p["rotation"])
        proj = project_gaussians(p["xyz"], cov, cam.world_view_transform, cam.full_proj_transform,
                                 cam.tanfovx, cam.tanfovy, SIZE, SIZE)
        valid = (proj["radius"] > 0) & torch.tensor(arrays["alive"])
        hist = tile_shard.row_load_histogram(proj["mean2d"], proj["radius"], valid, SIZE, SIZE)
        offsets, pad = tile_shard.balanced_band_offsets(hist.numpy(), RANKS)
        own = True
    out = _full_and_bands(arrays, spec, target, offsets, pad, own)
    np.testing.assert_allclose(out["bands"][0], out["full"][0], atol=3e-5)
    for f, got, want in zip(PARAM_FIELDS + ("tap",), out["bands"][1], out["full"][1]):
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=3e-6, err_msg=f)


def test_row_load_histogram_matches_jax():
    """The tile-row load histogram equals JAX's on the same projected
    means, radii and validity."""
    import jax.numpy as jnp

    from sgs_tpu.parallel.tile_shard import row_load_histogram

    rng = np.random.default_rng(7)
    n, w, h = 500, 130, 250
    mean2d = np.stack([rng.uniform(-40, w + 40, n), rng.uniform(-40, h + 40, n)], -1).astype(np.float32)
    radius = rng.integers(-2, 60, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    want = np.asarray(row_load_histogram(jnp.asarray(mean2d), jnp.asarray(radius), jnp.asarray(valid), w, h))
    got = tile_shard.row_load_histogram(torch.tensor(mean2d), torch.tensor(radius), torch.tensor(valid), w, h)
    np.testing.assert_array_equal(got.numpy(), want)
