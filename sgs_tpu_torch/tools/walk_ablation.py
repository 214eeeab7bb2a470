"""What each design choice of Kernel C's walk buys, on the card.

    python -m sgs_tpu_torch.tools.walk_ablation

Builds variants of `csrc/flat_raster_backward.cu`, each with one choice
of the committed design undone (or one candidate that was left out put
in) by a text substitution, into
`build/sgs_tpu_torch/ablation/`, and times each walk (CUDA events) on the
inputs of one flagship training step (test view 0 of data/flagship800,
the loss's image cotangent), alternating the committed kernel with each
variant. Every variant must give the committed kernel's bits: the choices
change the time, not the arithmetic. Prints one JSON line per variant and
the card's name and power limit. The variants exist only here: the
package builds the committed source alone.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

import torch

from sgs_tpu_torch.data.camera_utils import read_nerf_synthetic_split
from sgs_tpu_torch.models.gaussians import GaussianModel
from sgs_tpu_torch.ops import build, flat_raster
from sgs_tpu_torch.ops import ssim as ssim_ops
from sgs_tpu_torch.render.pipeline import project_and_shade
from sgs_tpu_torch.render.tiled import bin_gaussians, kernel_args

ROOT = Path(__file__).resolve().parents[2]
SOURCE = build.CSRC_DIR / "flat_raster_backward.cu"

BUTTERFLY = '''__device__ __forceinline__ float reduce_scatter9(const float (&v)[kTerms], int lane) {
  float r = 0.0f;
  const int owner = kOwner[lane >> 1];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    float s = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (k == owner) r = s;
  }
  return r;
}'''

# name -> (what it changes, [(committed text, variant text)])
VARIANTS = {
    "butterfly": ("9 xor butterflies (45 shuffles) in place of the 12-shuffle reduce-scatter",
                  [("SPLIT", BUTTERFLY)]),
    "no_vote": ("the shuffles run even when no pixel of the warp included the instance",
                [("if (__any_sync(kFull, included)) sum = reduce_scatter9(v, lane);",
                  "sum = reduce_scatter9(v, lane);")]),
    "warp_skip": ("a candidate left out: a warp skips the pair math and the vote for instances "
                  "past all its pixels' n_contrib",
                  [("if (pos < last) {", "if (pos < warp_last && pos < last) {"),
                   ("if (__any_sync(kFull, included))",
                    "if (pos < warp_last && __any_sync(kFull, included))")]),
    "batch32": ("32 records staged per pair of barriers in place of 64",
                [("constexpr int kBatch = 64;", "constexpr int kBatch = 32;")]),
}


def variant_source(name: str) -> Path:
    text = SOURCE.read_text()
    for old, new in VARIANTS[name][1]:
        if old == "SPLIT":
            i = text.index("__device__ __forceinline__ float reduce_scatter9(")
            old = text[i:text.index("\n}\n", i) + 2]
        if old not in text:
            raise RuntimeError(f"variant {name}: committed text not found: {old!r}")
        text = text.replace(old, new)
    out = build.BUILD_DIR / "ablation" / f"flat_raster_backward_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def step_inputs(dev) -> tuple:
    model = GaussianModel.from_ply(str(ROOT / "assets" / "flagship" / "point_cloud.ply"), 3, dev)
    view = read_nerf_synthetic_split(str(ROOT / "data" / "flagship800"), "test", False, -1, dev)[0]
    w, h = view.camera.image_width, view.camera.image_height
    p = project_and_shade(view.camera, model.render_inputs(3))
    bins = bin_gaussians(p["mean2d"], p["conic"], p["opacity"], p["depth"], p["radius"], p["valid"], w, h)
    args = kernel_args(bins, p["mean2d"], p["conic"], p["opacity"], p["rgb"], w, h)
    color, t_final, n_contrib = flat_raster.rasterize_tiles(*args)
    image = color.clone().requires_grad_(True)
    (dc,) = torch.autograd.grad(ssim_ops.training_loss(image, view.gt_image, 0.2), image)
    return (*args, t_final, n_contrib, dc.contiguous(), torch.zeros(3, device=dev), bins["perm"],
            bins["rank_start"], bins["order"])


def time_walk(kernel, bargs, inst, reps: int = 20) -> float:
    flat_raster.BACKWARD, committed = kernel, flat_raster.BACKWARD
    try:
        for _ in range(3):
            flat_raster.raster_backward_walk(bargs, inst)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            flat_raster.raster_backward_walk(bargs, inst)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    finally:
        flat_raster.BACKWARD = committed


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("walk_ablation: needs a CUDA device")
    dev = torch.device("cuda")
    kernels = {name: build.CudaKernel(str(variant_source(name)), flat_raster.BACKWARD.functions,
                                      extra_flags=("--fmad=false",)) for name in VARIANTS}
    build.build_all([flat_raster.KERNEL, flat_raster.BACKWARD, *kernels.values()])
    bargs = step_inputs(dev)
    inst = torch.empty((bargs[2].shape[0], flat_raster.N_GRADS), device=dev)
    flat_raster.raster_backward_walk(bargs, inst)
    want = inst.clone()
    for name, kernel in kernels.items():
        regs = [ln.split(":")[-1].strip() for ln in kernel.build_log.splitlines() if "registers" in ln]
        times = {"committed": [], name: []}
        for order in ((flat_raster.BACKWARD, kernel), (kernel, flat_raster.BACKWARD)):
            for k in order:
                times["committed" if k is flat_raster.BACKWARD else name].append(time_walk(k, bargs, inst))
        time_walk(kernel, bargs, inst, reps=1)
        same = torch.equal(inst, want)
        print(json.dumps({"variant": name, "change": VARIANTS[name][0], "walk_ms": times[name],
                          "committed_ms": times["committed"], "same_bits": same,
                          "ptxas": regs[-1] if regs else None}), flush=True)
        if not same:
            raise AssertionError(f"variant {name} changed the walk's bits")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
