"""Port parity of the benchmarks (`sgs_tpu_torch/bench.py`,
`tools/bench_scale.py`) and of `tools/eval_ply.py`, on the CPU.

- The scenes: the root `bench.py`'s synthetic and PLY scenes (JAX) against
  `build_synthetic_scene` / `build_ply_scene` (port): every parameter and
  the alive mask equal bit for bit, the cameras' matrices within 1e-6.
- The counts: `scripts/bench_scale.py::run_config` at N = 20,000 in both
  geometries at 1920x1080, run up to its jitted step
  (`tests/bench_counts.py`), against `tools/bench_scale.py::scene_counts`
  on the port's scene: visible, rows and instances equal exactly.
- One forward+backward of the benchmark loss on that scene (the panning
  capture) at 480x270: JAX's pool (from the same run) through
  `jax.value_and_grad` of `sgs_tpu.render.pipeline.render(mode="tiled",
  backend="xla")`, against `bench_scale.loss_and_grads` (tight binning,
  Kernels A and C's plain versions): the loss to rtol 1e-5, the image to
  the README's atol 3e-5, each parameter gradient to rtol 1e-4 plus 2e-4
  of the field's largest magnitude (`tests/test_torch_train_step.py`).
- The dry runs of `run_config` and `measure` on the CPU: the counts, no
  times, the render-only image equal to the forward+backward image.
- `eval_ply` on the LGM snapshot and `data/lgm400` at SH degree 0 against
  `scripts/eval_ply.py::main`, with JAX's render sent to its XLA route
  (the Pallas route runs in interpret mode on the CPU, far slower; the
  package's own tests hold the two equal): the printed mean PSNR to its 3
  decimals, the view and Gaussian counts equal.
- The error paths: a bad argv exits 1 in both packages; without CUDA each
  entry point raises unless asked for the CPU.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bench_counts import load_script, scale_run
from sgs_tpu.core.camera import Camera as JaxCamera
from sgs_tpu.core.projection import focal2fov as jfocal2fov, fov2focal as jfov2focal
from sgs_tpu.ops.ssim import l1_loss as jl1
from sgs_tpu.render import pipeline as jpipeline, tiled as jtiled
from sgs_tpu.train import loop as jloop
from sgs_tpu_torch import bench
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS
from sgs_tpu_torch.tools import bench_scale, eval_ply

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_PLY = os.path.join(ROOT, "assets", "flagship", "point_cloud.ply")
LGM_PLY = os.path.join(ROOT, "assets", "lgm", "point_cloud.ply")
LGM_SCENE = os.path.join(ROOT, "data", "lgm400")
N_SCALE, SMALL_W, SMALL_H = 20_000, 480, 270
RTOL, ATOL_SCALE, IMAGE_ATOL = 1e-4, 2e-4, 3e-5


def _same_pool(model, pool):
    assert model.capacity == pool.capacity
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(model, f).numpy(), np.asarray(getattr(pool, f)), err_msg=f)
    np.testing.assert_array_equal(model.alive.numpy(), np.asarray(pool.alive))


def _same_camera(cam, jcam):
    for f in ("world_view_transform", "full_proj_transform", "camera_center", "tanfovx", "tanfovy"):
        np.testing.assert_allclose(getattr(cam, f).numpy(), np.asarray(getattr(jcam, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    assert (cam.image_width, cam.image_height) == (jcam.image_width, jcam.image_height)


def test_synthetic_scene_matches_jax():
    pool, jcam = load_script("jax_bench", "bench.py")._build_synthetic_scene()
    model, cam = bench.build_synthetic_scene(device="cpu")
    _same_pool(model, pool)
    _same_camera(cam, jcam)


def test_ply_scene_matches_jax():
    pool, jcam = load_script("jax_bench", "bench.py")._build_ply_scene(FLAGSHIP_PLY)
    model, cam = bench.build_ply_scene(FLAGSHIP_PLY, device="cpu")
    assert model.capacity % 4096 == 0 and model.num_alive == 161_809
    _same_pool(model, pool)
    _same_camera(cam, jcam)


@pytest.mark.parametrize("capture", [False, True])
def test_scale_counts_match_jax(capture):
    want, pool = scale_run(N_SCALE, capture)
    model, cam = bench_scale.scale_scene(N_SCALE, capture, device="cpu")
    _same_pool(model, pool)
    got = bench_scale.scene_counts(model, cam)
    assert {k: got[k] for k in want} == want
    assert got["longest_list"] > 0


def _jax_camera(capture, width, height):
    fovx = np.radians(60)
    fovy = jfocal2fov(jfov2focal(fovx, width), height)
    return JaxCamera.from_Rt(np.eye(3), np.array([2.5 if capture else 0.0, 0.0, 4.5]), fovx, fovy,
                             width, height)


def test_forward_backward_matches_jax():
    _, pool = scale_run(N_SCALE, True, SMALL_W, SMALL_H)
    jcam = _jax_camera(True, SMALL_W, SMALL_H)
    gt = jnp.zeros((3, SMALL_H, SMALL_W), jnp.float32)
    bg = jnp.zeros(3, jnp.float32)
    mi = jloop.instance_bucket(pool, jcam, tight=False)

    def loss_fn(params):
        out = jpipeline.render(jcam, pool.with_params(params).render_inputs(3), bg, mode="tiled",
                               max_instances=mi, backend="xla")
        return jl1(out["render"], gt), (out["render"], out["overflow"])

    (jloss, (jimage, overflow)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        pool.params())
    assert int(overflow) == 0

    model, cam = bench_scale.scale_scene(N_SCALE, True, SMALL_W, SMALL_H, device="cpu")
    _same_camera(cam, jcam)
    loss, image, n_instances, grads = bench_scale.loss_and_grads(
        model, cam, torch.zeros((3, SMALL_H, SMALL_W)), torch.zeros(3))
    assert n_instances > 20_000
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(image.numpy(), np.asarray(jimage), rtol=0, atol=IMAGE_ATOL)
    for f in PARAM_FIELDS:
        want = np.asarray(jgrads[f])
        assert np.abs(want).max() > 0, f
        np.testing.assert_allclose(grads[f].numpy(), want, rtol=RTOL,
                                   atol=ATOL_SCALE * float(np.abs(want).max()), err_msg=f)


def test_run_config_dry_run_on_cpu():
    r = bench_scale.run_config(3000, True, 96, 54, device="cpu", iters=1)
    model, cam = bench_scale.scale_scene(3000, True, 96, 54, device="cpu")
    counts = bench_scale.scene_counts(model, cam)
    assert {k: r[k] for k in counts} == counts
    assert r["capacity"] is r["max_visible"] is None
    assert r["fwd_bwd_ms"] is r["fps"] is r["render_ms"] is r["peak_gib"] is None
    assert (r["n_gaussians"], r["capture"], r["device"]) == (3000, True, "cpu")


def test_measure_dry_run_on_cpu():
    model, cam = bench_scale.scale_scene(3000, False, 96, 54, device="cpu")
    r = bench.measure(model, cam, iters=1)
    assert r["fps"] is r["render_fps"] is None
    assert torch.equal(r["image"], r["render_image"])
    assert float(r["image"].max()) > 0 and np.isfinite(float(r["loss"]))


def test_eval_ply_matches_jax(monkeypatch, capsys):
    real_render = jpipeline.render

    def xla_render(cam, inputs, bg, **kwargs):
        # the XLA route bins each Gaussian's whole rect: these views have up
        # to 285,296 such instances, under 20 a slot (overflow asserted below)
        kwargs.update(backend="xla", max_instances=20 * inputs.means3d.shape[0],
                      max_row_instances=None, max_kernel_rows=None)
        return real_render(cam, inputs, bg, **kwargs)

    jeval = load_script("jax_eval_ply", os.path.join("scripts", "eval_ply.py"))
    monkeypatch.setattr(jpipeline, "render", xla_render)
    # the count pre-passes only size the Pallas route's buckets, which the
    # XLA route above does not read: skip their compiles
    for name in ("row_count", "instance_count_tight", "kernel_row_count"):
        monkeypatch.setattr(jtiled, name, lambda *args, **kwargs: 0)
    monkeypatch.setattr("sys.argv", ["eval_ply.py", LGM_PLY, LGM_SCENE, "0"])
    jeval.main()
    want = capsys.readouterr().out.strip().splitlines()[-1].split()
    eval_ply.main([LGM_PLY, LGM_SCENE, "0", "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1].split()
    assert got == want, (got, want)
    assert want[0] == "test_psnr_mean" and int(want[3]) == 8 and want[-1] == "0"


@pytest.mark.parametrize("argv", [[], [LGM_PLY], [LGM_PLY, LGM_SCENE, "two"]])
def test_eval_ply_bad_argv_exits_1(monkeypatch, argv):
    jeval = load_script("jax_eval_ply", os.path.join("scripts", "eval_ply.py"))
    monkeypatch.setattr("sys.argv", ["eval_ply.py", *argv])
    with pytest.raises(SystemExit) as want:
        jeval.main()
    with pytest.raises(SystemExit) as got:
        eval_ply.main(argv)
    assert got.value.code == want.value.code == 1


@pytest.mark.parametrize("entry", ["bench", "bench_scale", "eval_ply"])
def test_entry_points_need_cuda_unless_asked_for_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    call = {"bench": lambda: bench.main(["--headline_only"]),
            "bench_scale": lambda: bench_scale.main(["1000"]),
            "eval_ply": lambda: eval_ply.main([LGM_PLY, LGM_SCENE, "0"])}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
