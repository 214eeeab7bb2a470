"""Port parity of `sgs_tpu_torch/parallel/` (mesh, collectives, camera-batch
data parallelism) and of the trainer's `--parallel dp`, on the CPU.

The port's ranks are gloo processes (`tests/torch_dist.py`); their bodies
are module-level functions that import no JAX, so the children import only
torch and the port. The JAX side runs in the test process, on the
8-device virtual CPU mesh of `tests/conftest.py`, with its XLA backend
(the backend JAX's own `tests/test_parallel.py` runs the DP step with):
the Pallas kernels in interpret mode inside `shard_map` do not fit a
Tier-1 test. Each test's docstring states its bars.
"""

import math
import os
import random

import numpy as np
import pytest
import torch

import torch_dist
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, DensifyStats
from sgs_tpu_torch.parallel import collectives, mesh as mesh_lib

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CAMS, SIZE, N_POINTS, CAPACITY, RANKS = 8, 24, 40, 64, 4


# ---------------------------------------------------------------- mesh

@pytest.mark.parametrize("world, local, shape", [(8, 4, (2, 4)), (4, 4, (1, 4)), (8, 8, (1, 8)),
                                                 (8, 2, (4, 2))])
def test_hybrid_mesh_shape(world, local, shape):
    """The hybrid mesh puts hosts on "data" and each host's ranks on
    "gauss": 2 hosts x 4 ranks is JAX's (data 2, gauss 4)
    (`tests/test_parallel.py::test_hybrid_mesh_multihost_shape`)."""
    assert mesh_lib.hybrid_mesh_shape(world, local) == shape


def test_hybrid_mesh_shape_rejects_uneven_hosts():
    with pytest.raises(ValueError):
        mesh_lib.hybrid_mesh_shape(6, 4)


def _rank_mesh_and_collectives(rank, world):
    dev = mesh_lib.init_distributed("cpu")
    out = {"device": str(dev)}
    try:
        mesh_lib.make_mesh((world + 1,), ("data",), "cpu")
        out["too_big"] = "no error"
    except ValueError as exc:
        out["too_big"] = str(exc)
    mesh = mesh_lib.make_mesh(None, ("data",), "cpu")
    group, r, n = mesh_lib.axis(mesh, "data")
    out["axis"] = (r, n)
    hmesh = mesh_lib.make_hybrid_mesh("cpu")
    out["hybrid"] = tuple(hmesh.shape)
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * rank
    x.requires_grad_(True)
    # gather_records: the gradient of every gathered row is summed back
    y = collectives.gather_records(x, group)
    w = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
    (gx,) = torch.autograd.grad((y * w).sum(), x)
    out["records"] = (y.detach().numpy(), gx.numpy())
    # gather_replicated: every rank computes the same loss on the gathered
    # tensor, and each rank's gradient is its own slice, not the sum
    z = collectives.gather_replicated(x, group)
    (gz,) = torch.autograd.grad((z * w).sum(), x)
    out["replicated"] = (z.detach().numpy(), gz.numpy())
    # the parallel steps' statistics: sums over the ranks, radii maxed
    from sgs_tpu_torch.parallel import data_parallel

    stats = DensifyStats(xyz_gradient_accum=torch.full((3, 1), 1.0 + rank), denom=torch.full((3, 1), 2.0),
                         max_radii2d=torch.tensor([float(rank), 5.0, 1.0 - rank]))
    red = data_parallel.reduce_stats(stats, group)
    out["stats"] = (red.xyz_gradient_accum.numpy(), red.denom.numpy(), red.max_radii2d.numpy())
    return out


def test_mesh_and_collectives_on_gloo_ranks():
    """Two ranks: `make_mesh` raises when it wants more ranks than the world
    has (as JAX's `make_mesh`); `gather_records` stacks every rank's rows
    and its backward sums each row's gradient over the ranks (the
    transpose of `all_gather(tiled=True)`); `gather_replicated` stacks the
    same way and its backward keeps the rank's own slice: with a sum, as
    a reduce-scatter would give, each rank would get `world` times it.
    `data_parallel.reduce_stats` sums the statistics over the ranks and
    maxes the radii. All exact."""
    world = 2
    res = torch_dist.spawn(_rank_mesh_and_collectives, world)
    rows = np.concatenate([np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r for r in range(world)])
    w = np.arange(rows.size, dtype=np.float32).reshape(rows.shape)
    for r, out in enumerate(res):
        assert out["device"] == "cpu"
        assert out["too_big"] == f"mesh wants {world + 1} ranks, have {world}"
        assert out["axis"] == (r, world)
        assert out["hybrid"] == (1, world)
        np.testing.assert_array_equal(out["records"][0], rows)
        np.testing.assert_array_equal(out["records"][1], world * w[3 * r:3 * r + 3])
        np.testing.assert_array_equal(out["replicated"][0], rows)
        np.testing.assert_array_equal(out["replicated"][1], w[3 * r:3 * r + 3])
        np.testing.assert_array_equal(out["stats"][0], np.full((3, 1), 3.0))
        np.testing.assert_array_equal(out["stats"][1], np.full((3, 1), 4.0))
        np.testing.assert_array_equal(out["stats"][2], [1.0, 5.0, 1.0])


def test_guard_and_stats_merge():
    """The pieces every step shares: `zero_nonfinite` counts the non-finite
    elements over all its tensors and zeroes them (the guard of JAX's
    `train_step`); `DensifyStats.merge` adds the sums and keeps the larger
    radius."""
    from sgs_tpu_torch.train.loop import zero_nonfinite

    a = torch.tensor([1.0, float("nan"), float("inf")])
    b = torch.tensor([[float("-inf"), 2.0]])
    count, (za, zb) = zero_nonfinite([a, b])
    assert int(count) == 3
    np.testing.assert_array_equal(za.numpy(), [1.0, 0.0, 0.0])
    np.testing.assert_array_equal(zb.numpy(), [[0.0, 2.0]])
    one = DensifyStats(xyz_gradient_accum=torch.tensor([[0.5], [1.0]]), denom=torch.tensor([[1.0], [0.0]]),
                       max_radii2d=torch.tensor([3.0, 7.0]))
    two = DensifyStats(xyz_gradient_accum=torch.tensor([[0.25], [0.0]]), denom=torch.tensor([[2.0], [1.0]]),
                       max_radii2d=torch.tensor([4.0, 2.0]))
    both = one.merge(two)
    np.testing.assert_array_equal(both.xyz_gradient_accum.numpy(), [[0.75], [1.0]])
    np.testing.assert_array_equal(both.denom.numpy(), [[3.0], [1.0]])
    np.testing.assert_array_equal(both.max_radii2d.numpy(), [4.0, 7.0])


# ---------------------------------------------------------------- DP step

def _setup():
    """test_parallel.py's setup (8 cameras around 40 points, 24x24) with
    seeded Adam moments and statistics, so the step is not Adam's first."""
    from sgs_tpu.core.projection import focal2fov, fov2focal
    from sgs_tpu.models.gaussians import GaussianPool

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(N_POINTS, 3)).astype(np.float32) * 0.4
    cols = rng.uniform(size=(N_POINTS, 3)).astype(np.float32)
    pool = GaussianPool.from_pcd(pts, cols, 1, capacity=CAPACITY)
    fovx = math.radians(60)
    fovy = focal2fov(fov2focal(fovx, SIZE), SIZE)
    specs, gts = [], []
    for i in range(N_CAMS):
        th = 2 * math.pi * i / N_CAMS
        R = np.array([[math.cos(th), 0, math.sin(th)], [0, 1, 0], [-math.sin(th), 0, math.cos(th)]])
        specs.append((R, np.array([0.0, 0.0, 3.0]), fovx, fovy, SIZE, SIZE))
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


LR = 1e-3


def _rank_dp_step(rank, world, arrays, specs, gts):
    from sgs_tpu_torch.parallel import data_parallel as dp

    mesh_lib.init_distributed("cpu")
    mesh = mesh_lib.make_mesh((world,), ("data",), "cpu")
    state = dp.replicate_state(torch_dist.state_from_arrays(arrays), mesh)
    cam_b, gt_b = dp.shard_camera_batch(dp.stack_cameras(torch_dist.cameras(specs)), torch.tensor(gts), mesh)
    step = dp.make_dp_train_step(mesh, active_sh_degree=1)
    new, m = step(state, cam_b, gt_b, torch.zeros(3), {f: LR for f in PARAM_FIELDS})
    return {"state": torch_dist.state_arrays(new), "loss": float(m["loss"]), "l1": float(m["l1"]),
            "nonfinite": int(m["nonfinite_grads"]), "local": int(gt_b.shape[0])}


@pytest.fixture(scope="module")
def dp_run():
    import jax
    import jax.numpy as jnp

    from sgs_tpu.core.camera import Camera as JaxCamera
    from sgs_tpu.parallel.data_parallel import (make_dp_train_step, replicate_state,
                                                shard_camera_batch, stack_cameras)
    from sgs_tpu.parallel.mesh import make_mesh

    arrays, specs, gts = _setup()
    mesh = make_mesh((RANKS,), ("data",))
    step = make_dp_train_step(mesh, active_sh_degree=1)
    cam_b, gt_b = shard_camera_batch(stack_cameras([JaxCamera.from_Rt(*s) for s in specs]),
                                     jnp.asarray(gts), mesh)
    jnew, jm = step(replicate_state(_jax_state(arrays), mesh), cam_b, gt_b, jnp.zeros(3),
                    {f: jnp.float32(LR) for f in PARAM_FIELDS})
    jax_out = {f: np.asarray(getattr(jnew.pool, f)) for f in PARAM_FIELDS}
    for f in PARAM_FIELDS:
        jax_out[f"mu_{f}"] = np.asarray(jnew.adam.mu[f])
        jax_out[f"nu_{f}"] = np.asarray(jnew.adam.nu[f])
    jax_out.update(xyz_gradient_accum=np.asarray(jnew.stats.xyz_gradient_accum),
                   denom=np.asarray(jnew.stats.denom), max_radii2d=np.asarray(jnew.stats.max_radii2d),
                   loss=float(jm["loss"]), l1=float(jm["l1"]), nonfinite=int(jm["nonfinite_grads"]))
    jax.clear_caches()
    port = torch_dist.spawn(_rank_dp_step, RANKS, arrays, specs, gts)
    return arrays, specs, gts, jax_out, port


def test_dp_ranks_agree_and_split_the_batch(dp_run):
    """Every rank ends the step with the same bits, after training 2 of the 8 cameras."""
    _, _, _, _, port = dp_run
    for out in port:
        assert out["local"] == N_CAMS // RANKS
        assert out["loss"] == port[0]["loss"]
        for k, v in out["state"].items():
            np.testing.assert_array_equal(v, port[0]["state"][k], err_msg=k)


def test_dp_step_matches_jax(dp_run):
    """The DP step over 4 gloo ranks (2 cameras each) against JAX's
    `make_dp_train_step` over a (4,) mesh on the same state, cameras and
    GTs. Bars: loss and L1 to rtol 1e-5; new parameters to JAX's DP bar
    (rtol 2e-4, atol 2e-6, `tests/test_parallel.py:89`); Adam moments and
    the summed tap-gradient norms to JAX's band bars on gradients (rtol
    2e-3, atol 3e-6 of each field's largest magnitude); view counts and
    radii exactly; nonfinite_grads exactly."""
    _, _, _, want, port = dp_run
    got = port[0]["state"]
    np.testing.assert_allclose(port[0]["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(port[0]["l1"], want["l1"], rtol=1e-5)
    assert port[0]["nonfinite"] == want["nonfinite"] == 0
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(got[f], want[f], rtol=2e-4, atol=2e-6, err_msg=f)
        for k in (f"mu_{f}", f"nu_{f}", "xyz_gradient_accum"):
            scale = float(np.abs(want[k]).max())
            np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=3e-6 * scale, err_msg=k)
    np.testing.assert_array_equal(got["denom"], want["denom"])
    np.testing.assert_array_equal(got["max_radii2d"], want["max_radii2d"])


def test_dp_step_is_the_mean_of_single_views(dp_run):
    """The port's DP step against the port's own single-view gradients
    averaged over the 8 cameras, then one Adam step (the check of
    `tests/test_parallel.py:54`, in one process): new parameters to rtol
    2e-4, atol 2e-6."""
    from sgs_tpu_torch.ops.ssim import training_loss
    from sgs_tpu_torch.render.pipeline import render
    from sgs_tpu_torch.train.optim import adam_update

    arrays, specs, gts, _, port = dp_run
    state = torch_dist.state_from_arrays(arrays)
    total = None
    for cam, gt in zip(torch_dist.cameras(specs), torch.tensor(gts)):
        leaves = {f: getattr(state.model, f).detach().requires_grad_(True) for f in PARAM_FIELDS}
        out = render(cam, state.model.with_params(leaves).render_inputs(1), torch.zeros(3))
        g = torch.autograd.grad(training_loss(out["render"], gt, 0.2), list(leaves.values()))
        total = g if total is None else [a + b for a, b in zip(total, g)]
    grads = {f: t / N_CAMS for f, t in zip(PARAM_FIELDS, total)}
    params, _ = adam_update(state.model.params(), grads, state.adam, {f: LR for f in PARAM_FIELDS},
                            update_mask=state.model.alive)
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(port[0]["state"][f], params[f].numpy(), rtol=2e-4, atol=2e-6, err_msg=f)


def test_dp_densify_stats_sum_over_ranks(dp_run):
    """The view counts add over ranks (`tests/test_parallel.py:93`): every
    alive Gaussian near the origin is seen by all 8 cameras, dead slots by
    none."""
    arrays, _, _, _, port = dp_run
    denom = port[0]["state"]["denom"][:, 0] - arrays["denom"][:, 0]
    alive = arrays["alive"]
    assert denom[alive].max() == N_CAMS
    assert denom[~alive].max() == 0


# ---------------------------------------------------------------- the trainer

ITERS = 40


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


def _opt(cfg):
    return cfg.OptimizationParams(iterations=ITERS, densify_from_iter=10, densification_interval=10,
                                  densify_until_iter=35, opacity_reset_interval=10_000)


def _rank_view_order(rank, world, scene, model_path, mode, mesh_str, balance):
    """The port's trainer with the parallel step replaced by a recorder of
    the rank's GT; returns the recorded bytes, one per iteration."""
    from sgs_tpu_torch.data.scene import Scene
    from sgs_tpu_torch.parallel import data_parallel, hybrid
    from sgs_tpu_torch.train import trainer
    from sgs_tpu_torch.utils import config

    seen = []

    def maker(*args, **kwargs):
        def step(state, cam_b, gt_b, *rest):
            seen.append([g.numpy().tobytes() for g in gt_b])
            return state, {"loss": torch.tensor(0.0), "l1": torch.tensor(0.0), "overflow": 0,
                           "nonfinite_grads": torch.tensor(0)}
        return step

    data_parallel.make_dp_train_step = maker
    hybrid.make_hybrid_train_step = maker
    data = config.ModelParams(source_path=scene, model_path=model_path, eval=True)
    random.seed(0)
    sc = Scene(data, device="cpu")
    pipe = config.PipelineParams(no_tqdm=True, parallel=mode, parallel_mesh=mesh_str, hy_balance=balance)
    trainer.training(data, _opt(config), pipe, [], [], [], scene=sc, device="cpu")
    return seen


def view_order(toy_scene, tmp_path, monkeypatch, mode, world, mesh_str="", balance=False, dp_n=None):
    """(JAX's per-iteration camera batches, the port's per-rank recorded GTs)."""
    import sgs_tpu.parallel.data_parallel as jdp
    import sgs_tpu.parallel.hybrid as jhy
    import sgs_tpu.parallel.mesh as jmesh
    from sgs_tpu.data.scene import Scene as JaxScene
    from sgs_tpu.train import trainer as jtrainer
    from sgs_tpu.utils import config as jconfig

    seen_jax = []

    def jmaker(*args, **kwargs):
        def step(state, cam_batch, gt_batch, *rest):
            seen_jax.append([np.asarray(g).tobytes() for g in np.asarray(gt_batch)])
            return state, {"loss": 0.0, "l1": 0.0, "overflow": 0, "nonfinite_grads": 0}
        return step

    monkeypatch.setattr(jdp, "make_dp_train_step", jmaker)
    monkeypatch.setattr(jhy, "make_hybrid_train_step", jmaker)
    if dp_n is not None:
        make_mesh = jmesh.make_mesh
        monkeypatch.setattr(jmesh, "make_mesh", lambda *a, **k: make_mesh((dp_n,), ("data",)))
    jdata = jconfig.ModelParams(source_path=toy_scene, model_path=str(tmp_path / "jax"), eval=True)
    random.seed(0)
    jscene = JaxScene(jdata)
    jpipe = jconfig.PipelineParams(no_tqdm=True, parallel=mode, parallel_mesh=mesh_str, hy_balance=balance)
    jtrainer.training(jdata, _opt(jconfig), jpipe, [], [], [], scene=jscene)
    port = torch_dist.spawn(_rank_view_order, world, toy_scene, str(tmp_path / "port"), mode, mesh_str,
                            balance)
    return seen_jax, port


def test_dp_view_order_matches_jax(toy_scene, tmp_path, monkeypatch):
    """`--parallel dp` over 2 ranks pops the views JAX's trainer pops over a
    (2,) mesh, in the same order, across four densify steps: each
    iteration's batch of 2, with rank d training camera d of it."""
    seen_jax, port = view_order(toy_scene, tmp_path, monkeypatch, "dp", 2, dp_n=2)
    assert len(seen_jax) == ITERS
    for d, seen in enumerate(port):
        assert len(seen) == ITERS
        assert [s[0] for s in seen] == [b[d] for b in seen_jax]
    assert len({b for batch in seen_jax[:6] for b in batch}) == 12, "a pass sees every view once"


def test_unknown_parallel_mode_raises(toy_scene, tmp_path):
    """An unknown --parallel mode raises JAX's ValueError."""
    from sgs_tpu_torch.train import trainer
    from sgs_tpu_torch.utils import config

    data = config.ModelParams(source_path=toy_scene, model_path=str(tmp_path / "m"), eval=True)
    with pytest.raises(ValueError, match="unknown --parallel mode 'bogus'"):
        trainer.training(data, _opt(config), config.PipelineParams(parallel="bogus"), [], [], [],
                         device="cpu")


def test_torchrun_cli_dp_trains(toy_scene, tmp_path):
    """`torchrun --nproc_per_node=2 -m sgs_tpu_torch.train --parallel dp`
    on the CPU (gloo): rank 0 alone writes losses.tsv, the PLY and the
    checkpoint; the test L1 falls over 30 iterations."""
    import subprocess
    import sys

    out = tmp_path / "model"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2", "--master_port",
           str(mesh_lib.free_port()), "-m", "sgs_tpu_torch.train", "-s", toy_scene, "-m", str(out),
           "--eval", "--device", "cpu", "--parallel", "dp", "--iterations", "30", "--test_iterations", "1",
           "30", "--checkpoint_iterations", "30", "--densify_from_iter", "10",
           "--densification_interval", "10"]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    rows = (out / "losses.tsv").read_text().strip().splitlines()
    assert len(rows) == 3, rows
    assert float(rows[2].split("\t")[1]) < float(rows[1].split("\t")[1]), rows
    assert (out / "chkpnt30.npz").exists()
    assert (out / "point_cloud" / "iteration_30" / "point_cloud.ply").exists()
    assert "data-parallel training over 2 ranks" in res.stdout


@pytest.mark.slow
def test_dp_training_e2e(tmp_path):
    """`tests/test_parallel.py:120` mirrored: the trainer under `--parallel
    dp` over 4 gloo ranks on a 48x48 toy scene (16 train, 2 test views)
    densifies, resets opacity, reports and checkpoints; the test PSNR
    rises from iteration 1 to 40 and every rank ends with the same count."""
    from sgs_tpu_torch.utils.toy_scene import make_blender_dataset

    src = str(tmp_path / "scene")
    make_blender_dataset(src, n_train=16, n_test=2, width=48, height=48, n_gaussians=120, seed=1,
                         device="cpu")
    res = torch_dist.spawn(torch_dist.train_e2e, RANKS, src, str(tmp_path / "model"), "dp")
    rows = res[0]["rows"]
    assert float(rows[-1][2]) > float(rows[0][2]), rows
    assert all(r["finite"] and r["alive"] == res[0]["alive"] for r in res)
    assert (tmp_path / "model" / "chkpnt40.npz").exists()
