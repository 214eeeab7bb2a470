"""Port parity of `sgs_tpu_torch/parallel/hybrid.py` (camera data
parallelism x Gaussian sharding) and of the trainer's `--parallel hybrid`,
on the CPU.

The port's ranks are gloo processes (`tests/torch_dist.py`; rank bodies at
module level, no JAX in the children). JAX runs in the test process on
the 8-device virtual CPU mesh of `tests/conftest.py` with its XLA backend,
as JAX's own `tests/test_hybrid_mesh.py` does (the Pallas kernels in
interpret mode inside `shard_map` do not fit a Tier-1 test). The 2x2
render and step are held to JAX's `make_hybrid_render` and
`make_hybrid_train_step` on a (2, 2) mesh; balanced bands to JAX's
histogram and offsets exactly and to JAX's single-device render (the
reference of JAX's test); each test's docstring states its bars.
"""

import math
import os

import numpy as np
import pytest
import torch

import torch_dist
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS
from sgs_tpu_torch.parallel import mesh as mesh_lib

torch.set_num_threads(1)
SIZE, N, CAPACITY = 64, 80, 128
LR = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup():
    """tests/test_hybrid_mesh.py's scene (80 Gaussians, two cameras at
    64x64) with seeded Adam moments and statistics."""
    from sgs_tpu.core.projection import focal2fov, fov2focal
    from sgs_tpu.models.gaussians import GaussianPool

    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(-1, 1, N), rng.uniform(-1, 1, N), rng.uniform(2.5, 6, N)], -1).astype(np.float32)
    cols = rng.uniform(size=(N, 3)).astype(np.float32)
    pool = GaussianPool.from_pcd(pts, cols, 1, capacity=CAPACITY)
    fovx = math.radians(60)
    fovy = focal2fov(fov2focal(fovx, SIZE), SIZE)
    specs, gts = [], []
    for i in range(2):
        th = math.pi * i / 2
        R = np.array([[math.cos(th), 0, math.sin(th)], [0, 1, 0], [-math.sin(th), 0, math.cos(th)]])
        specs.append((R, np.array([0.0, 0.0, 3.5]), fovx, fovy, SIZE, SIZE))
        gts.append(rng.uniform(size=(3, SIZE, SIZE)).astype(np.float32))
    arrays = {f: np.asarray(getattr(pool, f)) for f in PARAM_FIELDS}
    arrays.update(alive=np.asarray(pool.alive), max_sh_degree=1, step=40)
    for f in PARAM_FIELDS:
        arrays[f"mu_{f}"] = rng.normal(0, 1e-4, arrays[f].shape).astype(np.float32)
        arrays[f"nu_{f}"] = rng.uniform(1e-9, 1e-7, arrays[f].shape).astype(np.float32)
    arrays.update(xyz_gradient_accum=rng.uniform(0, 1e-3, (CAPACITY, 1)).astype(np.float32),
                  denom=rng.integers(0, 20, (CAPACITY, 1)).astype(np.float32),
                  max_radii2d=rng.uniform(0, 30, CAPACITY).astype(np.float32))
    return arrays, specs, np.stack(gts)


def _jax_state(arrays):
    import jax.numpy as jnp

    from sgs_tpu.models.gaussians import DensifyStats, GaussianPool
    from sgs_tpu.train.loop import TrainState
    from sgs_tpu.train.optim import AdamState

    pool = GaussianPool(**{f: jnp.asarray(arrays[f]) for f in PARAM_FIELDS},
                        alive=jnp.asarray(arrays["alive"]), max_sh_degree=1)
    adam = AdamState(mu={f: jnp.asarray(arrays[f"mu_{f}"]) for f in PARAM_FIELDS},
                     nu={f: jnp.asarray(arrays[f"nu_{f}"]) for f in PARAM_FIELDS},
                     step={f: jnp.int32(arrays["step"]) for f in PARAM_FIELDS})
    stats = DensifyStats(xyz_gradient_accum=jnp.asarray(arrays["xyz_gradient_accum"]),
                         denom=jnp.asarray(arrays["denom"]), max_radii2d=jnp.asarray(arrays["max_radii2d"]))
    return TrainState(pool=pool, adam=adam, stats=stats)


def _rank_hybrid(rank, world, arrays, specs, gts):
    """On a 2x2 mesh: the hybrid render, and one step with equal bands,
    with compaction, and with padded bands (3 tile rows at offsets 0, 2)."""
    from sgs_tpu_torch.parallel import data_parallel as dp
    from sgs_tpu_torch.parallel import hybrid

    mesh_lib.init_distributed("cpu")
    mesh = mesh_lib.make_mesh((2, 2), ("data", "gauss"), "cpu")
    full = torch_dist.state_from_arrays(arrays)
    shard = hybrid.place_hybrid_state(full, mesh)
    cam_b, gt_b = dp.shard_camera_batch(dp.stack_cameras(torch_dist.cameras(specs)), torch.tensor(gts), mesh)
    camera = dp.camera_at(cam_b, 0)
    out = {}
    render = hybrid.make_hybrid_render(mesh, SIZE, SIZE, 1)
    with torch.no_grad():
        m = shard.model
        out["image"] = render(m.params(), m.alive, camera, torch.zeros(3)).numpy()
    lrs = {f: LR for f in PARAM_FIELDS}
    for name, kw, offs in (("equal", {}, None), ("compact", {"compact": True}, None),
                           ("padded", {"band_pad_tiles": 3}, [0, 2])):
        step = hybrid.make_hybrid_train_step(mesh, 1, SIZE, SIZE, **kw)
        new, met = step(shard, cam_b, gt_b, torch.zeros(3), lrs, offs)
        out[name] = {"state": torch_dist.state_arrays(hybrid.gather_hybrid_state(new, mesh)),
                     "loss": float(met["loss"]), "l1": float(met["l1"]),
                     "nonfinite": int(met["nonfinite_grads"])}
    return out


@pytest.fixture(scope="module")
def hybrid_run():
    import jax
    import jax.numpy as jnp

    from sgs_tpu.core.camera import Camera as JaxCamera
    from sgs_tpu.parallel.data_parallel import stack_cameras
    from sgs_tpu.parallel.hybrid import make_hybrid_render, make_hybrid_train_step, shard_hybrid
    from sgs_tpu.parallel.mesh import make_mesh

    arrays, specs, gts = _setup()
    mesh = make_mesh((2, 2), ("data", "gauss"))
    jstate = _jax_state(arrays)
    cam_batch = stack_cameras([JaxCamera.from_Rt(*s) for s in specs])
    params, alive, cam_b, gt_b = shard_hybrid(jstate.pool.params(), jstate.pool.alive, cam_batch,
                                              jnp.asarray(gts), mesh)
    fn = make_hybrid_render(mesh, SIZE, SIZE, 1, max_instances_per_band=8192)
    images = np.asarray(jax.jit(fn)(params, alive, cam_b, jnp.zeros(3)))
    step = make_hybrid_train_step(mesh, 1, SIZE, SIZE, max_instances_per_band=8192)
    jnew, jm = step(jstate, cam_b, gt_b, jnp.zeros(3), {f: LR for f in PARAM_FIELDS})
    want = {f: np.asarray(getattr(jnew.pool, f)) for f in PARAM_FIELDS}
    for f in PARAM_FIELDS:
        want[f"mu_{f}"] = np.asarray(jnew.adam.mu[f])
        want[f"nu_{f}"] = np.asarray(jnew.adam.nu[f])
    want.update(xyz_gradient_accum=np.asarray(jnew.stats.xyz_gradient_accum),
                denom=np.asarray(jnew.stats.denom), max_radii2d=np.asarray(jnew.stats.max_radii2d),
                loss=float(jm["loss"]), l1=float(jm["l1"]), nonfinite=int(jm["nonfinite_grads"]))
    jax.clear_caches()
    port = torch_dist.spawn(_rank_hybrid, 4, arrays, specs, gts)
    return arrays, images, want, port


def test_hybrid_render_matches_jax(hybrid_run):
    """The 2x2 hybrid render: rank (d, g) returns camera d's full image,
    within atol 3e-5 of JAX's `make_hybrid_render` over a (2, 2) mesh
    (`tests/test_hybrid_mesh.py:40`)."""
    _, images, _, port = hybrid_run
    for rank, out in enumerate(port):
        np.testing.assert_allclose(out["image"], images[rank // 2], atol=3e-5)


def _check_state(got, want, loss, l1, nonfinite):
    np.testing.assert_allclose(loss, want["loss"], rtol=1e-5)
    np.testing.assert_allclose(l1, want["l1"], rtol=1e-5)
    assert nonfinite == want["nonfinite"] == 0
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(got[f], want[f], rtol=2e-4, atol=2e-6, err_msg=f)
        for k in (f"mu_{f}", f"nu_{f}", "xyz_gradient_accum"):
            scale = float(np.abs(want[k]).max())
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=3e-6 * scale, err_msg=k)
    np.testing.assert_array_equal(got["denom"], want["denom"])
    np.testing.assert_array_equal(got["max_radii2d"], want["max_radii2d"])


@pytest.mark.parametrize("variant", ["equal", "compact"])
def test_hybrid_step_matches_jax(hybrid_run, variant):
    """One 2x2 hybrid step (camera d on data rank d, slots split over 2
    gauss ranks; with and without band compaction) against JAX's
    `make_hybrid_train_step` on a (2, 2) mesh: loss and L1 to rtol 1e-5,
    new parameters to rtol 2e-4, atol 2e-6, Adam moments and the summed
    tap norms to JAX's band bars (rtol 2e-3, atol 3e-6 of the field's
    largest magnitude), view counts and radii exactly, nonfinite_grads
    exactly. The gathered state is the same on all four ranks."""
    _, _, want, port = hybrid_run
    for out in port:
        r = out[variant]
        _check_state(r["state"], want, r["loss"], r["l1"], r["nonfinite"])
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, port[0][variant]["state"][k], err_msg=k)


@pytest.mark.parametrize("variant", ["padded", "compact"])
def test_band_variant_step_matches_equal_bands(hybrid_run, variant):
    """Bands of 3 tile rows at offsets 0 and 2 (each band's overhang
    rendered and overwritten at assembly, `tests/test_hybrid_mesh.py:168`),
    and bands binning only their own compacted records (`:249`), give the
    equal-band step's loss to rtol 1e-6, its parameters to rtol 1e-5, atol
    1e-7, and its summed tap norms to rtol 1e-4, atol 1e-8: JAX's bars
    there."""
    _, _, _, port = hybrid_run
    eq, got = port[0]["equal"], port[0][variant]
    np.testing.assert_allclose(got["loss"], eq["loss"], rtol=1e-6)
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(got["state"][f], eq["state"][f], rtol=1e-5, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(got["state"]["xyz_gradient_accum"], eq["state"]["xyz_gradient_accum"],
                               rtol=1e-4, atol=1e-8)


# ---------------------------------------------------------------- balanced bands

def _front_loaded(width=128, height=256, n=1500, capacity=2048):
    """tests/test_hybrid_mesh.py's front-loaded scene: splat density falls
    linearly from the top of the frame."""
    from sgs_tpu.core.projection import focal2fov, fov2focal
    from sgs_tpu.models.gaussians import GaussianPool

    rng = np.random.default_rng(3)
    fovx = math.radians(60)
    fovy = focal2fov(fov2focal(fovx, width), height)
    tanfovy = math.tan(fovy / 2)
    cam_z = 3.0
    v = rng.uniform(0, 1, n)
    frac = 1.0 - np.sqrt(v)
    depth = rng.uniform(2.7, 3.3, n)
    y_world = (frac * 2.0 - 1.0) * depth * tanfovy
    pts = np.stack([rng.uniform(-1, 1, n) * depth / 3.0, y_world, depth - cam_z], -1).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    pool = GaussianPool.from_pcd(pts, cols, 1, capacity=capacity)
    spec = (np.eye(3), np.array([0.0, 0.0, cam_z]), fovx, fovy, width, height)
    return pool, spec


def _rank_balanced_render(rank, world, arrays, spec, offsets, pad):
    from sgs_tpu_torch.parallel import hybrid

    mesh_lib.init_distributed("cpu")
    mesh = mesh_lib.make_mesh((1, world), ("data", "gauss"), "cpu")
    shard = hybrid.place_hybrid_state(torch_dist.state_from_arrays(arrays), mesh)
    render = hybrid.make_hybrid_render(mesh, spec[4], spec[5], 1, band_pad_tiles=pad, compact=True)
    with torch.no_grad():
        return render(shard.model.params(), shard.model.alive, torch_dist.cameras([spec])[0],
                      torch.zeros(3), offsets).numpy()


def test_balanced_bands_load_and_parity():
    """Balanced bands on the front-loaded scene (`tests/test_hybrid_mesh.py:110`):
    the row-load histogram and the 4 band offsets equal JAX's; the bands'
    max/mean load is at most 1.2 where equal bands exceed 1.5; the
    balanced, compacted render over 4 gauss ranks is within atol 3e-5 of
    JAX's single-device render."""
    import jax.numpy as jnp

    from sgs_tpu.core.camera import Camera as JaxCamera
    from sgs_tpu.core.projection import TILE, project_gaussians
    from sgs_tpu.parallel.tile_shard import balanced_band_offsets, row_load_histogram
    from sgs_tpu.render import render as jrender
    from sgs_tpu_torch.core import transforms
    from sgs_tpu_torch.core.projection import project_gaussians as port_project
    from sgs_tpu_torch.parallel import tile_shard

    width, height, n_bands = 128, 256, 4
    pool, spec = _front_loaded(width, height)
    cam = JaxCamera.from_Rt(*spec)
    proj = project_gaussians(pool.xyz, pool.get_covariance(), cam.world_view_transform,
                             cam.full_proj_transform, cam.tanfovx, cam.tanfovy, width, height)
    valid = (proj["radius"] > 0) & pool.alive
    hist_jax = np.asarray(row_load_histogram(proj["mean2d"], proj["radius"], valid, width, height))

    arrays = {f: np.asarray(getattr(pool, f)) for f in PARAM_FIELDS}
    arrays.update(alive=np.asarray(pool.alive), max_sh_degree=1, step=0,
                  xyz_gradient_accum=np.zeros((pool.capacity, 1), np.float32),
                  denom=np.zeros((pool.capacity, 1), np.float32),
                  max_radii2d=np.zeros(pool.capacity, np.float32))
    for f in PARAM_FIELDS:
        arrays[f"mu_{f}"] = arrays[f"nu_{f}"] = np.zeros_like(arrays[f])
    pcam = torch_dist.cameras([spec])[0]
    p = {f: torch.tensor(arrays[f]) for f in PARAM_FIELDS}
    pproj = port_project(p["xyz"], transforms.build_covariance(torch.exp(p["scaling"]), p["rotation"]),
                         pcam.world_view_transform, pcam.full_proj_transform, pcam.tanfovx, pcam.tanfovy,
                         width, height)
    pvalid = (pproj["radius"] > 0) & torch.tensor(arrays["alive"])
    hist = tile_shard.row_load_histogram(pproj["mean2d"], pproj["radius"], pvalid, width, height).numpy()
    np.testing.assert_array_equal(hist, hist_jax)

    offsets, pad = tile_shard.balanced_band_offsets(hist, n_bands)
    want_off, want_pad = balanced_band_offsets(hist_jax, n_bands)
    np.testing.assert_array_equal(offsets, want_off)
    assert pad == want_pad
    tiles_y = height // TILE
    nxt = np.concatenate([offsets[1:], [tiles_y]])
    loads = np.array([hist[offsets[b]:nxt[b]].sum() for b in range(n_bands)], np.float64)
    eq = tiles_y // n_bands
    loads_eq = np.array([hist[b * eq:(b + 1) * eq].sum() for b in range(n_bands)], np.float64)
    assert loads_eq.max() / loads_eq.mean() > 1.5
    assert loads.max() / loads.mean() <= 1.2

    ref = np.asarray(jrender(cam, pool.render_inputs(1), jnp.zeros(3), mode="tiled")["render"])
    images = torch_dist.spawn(_rank_balanced_render, n_bands, arrays, spec, offsets.tolist(), pad)
    for img in images:
        np.testing.assert_allclose(img, ref, atol=3e-5)


# ---------------------------------------------------------------- the trainer

def test_hybrid_view_order_matches_jax(tmp_path, monkeypatch, toy_scene_hybrid):
    """`--parallel hybrid --parallel_mesh 2x2 --hy_balance` over 4 ranks pops
    the views JAX's trainer pops on a (2, 2) mesh, in the same order,
    across four densify steps (the balance, band-bucket and record-cap
    draws at the first step, the balance and band-bucket draws after each
    densify): rank (d, g) trains camera d of each iteration's batch."""
    from test_torch_parallel import ITERS, view_order

    seen_jax, port = view_order(toy_scene_hybrid, tmp_path, monkeypatch, "hybrid", 4, mesh_str="2x2",
                                balance=True)
    assert len(seen_jax) == ITERS
    for rank, seen in enumerate(port):
        assert [s[0] for s in seen] == [b[rank // 2] for b in seen_jax]


@pytest.fixture(scope="module")
def toy_scene_hybrid(tmp_path_factory):
    from sgs_tpu.utils.toy_scene import make_blender_dataset
    from sgs_tpu_torch.data.ply import save_point_cloud_ply

    out = str(tmp_path_factory.mktemp("toyscene"))
    make_blender_dataset(out, n_train=12, n_test=3, width=32, height=32, n_gaussians=50, seed=5)
    rng = np.random.default_rng(1)
    save_point_cloud_ply(f"{out}/points3d.ply", (rng.random((200, 3)) * 2 - 1).astype(np.float32),
                         rng.integers(0, 256, (200, 3)).astype(np.uint8))
    return out


def test_torchrun_cli_hybrid_trains(tmp_path, toy_scene_hybrid):
    """`torchrun --nproc_per_node=2 -m sgs_tpu_torch.train --parallel hybrid`
    on the CPU (gloo; the mesh from torchrun's world, 1 host x 2 ranks):
    densify, the report and the checkpoint run on the sliced state, and
    the test L1 falls over 30 iterations."""
    import subprocess
    import sys

    out = tmp_path / "model"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2", "--master_port",
           str(mesh_lib.free_port()), "-m", "sgs_tpu_torch.train", "-s", toy_scene_hybrid, "-m",
           str(out), "--eval", "--device", "cpu", "--parallel", "hybrid", "--hy_balance", "--iterations",
           "30", "--test_iterations", "1", "30", "--checkpoint_iterations", "30", "--densify_from_iter",
           "10", "--densification_interval", "10"]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    rows = (out / "losses.tsv").read_text().strip().splitlines()
    assert len(rows) == 3, rows
    assert float(rows[2].split("\t")[1]) < float(rows[1].split("\t")[1]), rows
    assert (out / "chkpnt30.npz").exists()
    assert "hybrid training over {'data': 1, 'gauss': 2}" in res.stdout


@pytest.mark.slow
@pytest.mark.parametrize("mesh_str, balance, local_world", [("2x2", False, 0), ("2x2", True, 0), ("", False, 2)])
def test_hybrid_training_e2e(tmp_path, mesh_str, balance, local_world):
    """`tests/test_parallel.py:254,301` and the balanced-bands run mirrored
    on a 2x2 mesh of gloo ranks, and `:214` (two hosts) as 4 ranks with
    LOCAL_WORLD_SIZE 2, whose hybrid mesh is then (2 hosts, 2 ranks): the
    trainer under `--parallel hybrid` on a 48x48 toy scene densifies,
    re-balances, resets opacity, reports and checkpoints on the sliced
    state; the test PSNR rises from iteration 1 to 40. (JAX's `:254` runs
    rect binning, which the port does not have; it bins tightly.)"""
    from sgs_tpu_torch.utils.toy_scene import make_blender_dataset

    src = str(tmp_path / "scene")
    make_blender_dataset(src, n_train=16, n_test=2, width=48, height=48, n_gaussians=120, seed=2,
                         device="cpu")
    res = torch_dist.spawn(torch_dist.train_e2e, 4, src, str(tmp_path / "model"), "hybrid", mesh_str, balance,
                           local_world=local_world)
    rows = res[0]["rows"]
    assert float(rows[-1][2]) > float(rows[0][2]), rows
    assert all(r["finite"] and r["alive"] == res[0]["alive"] for r in res)
    assert (tmp_path / "model" / "chkpnt40.npz").exists()
