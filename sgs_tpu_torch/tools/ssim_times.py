"""Device times of Kernels B and D on the inputs of one flagship step.

    python -m sgs_tpu_torch.tools.ssim_times

Times `ssim_forward(x, y)` and `ssim_backward(x, y, cot)` of the package
it is run from on test view 0 of data/flagship800 (the rendered image and
the ground truth, the loss's SSIM cotangent -0.2) with CUDA events, two
ways: calls back to back, as `chip_smoke.py` timed kernels until PR 6,
where a kernel shorter than its wrapper's host time measures the host;
and with the card kept busy while the host enqueues the calls, which
measures the device alone. It uses only functions that every version of
the port has, so a copy run from an older checkout times that checkout's
kernels. Prints one JSON line and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

import torch

from sgs_tpu_torch.data.readers import read_nerf_synthetic_split
from sgs_tpu_torch.models.gaussians import GaussianModel
from sgs_tpu_torch.ops import build, flat_raster, ssim as ssim_ops
from sgs_tpu_torch.render.pipeline import render

ROOT = Path(__file__).resolve().parents[2]
# about 10 ms of device sleep at the H100's clocks: longer than the host
# needs to enqueue 20 calls of a kernel's wrapper or of a library call
SLEEP_CYCLES = 20_000_000


def time_ms(fn, reps: int = 20, hide_host: bool = True) -> float:
    """Mean ms of `fn` over `reps` calls after three warm-ups, by CUDA
    events; with `hide_host` the card sleeps while the host enqueues."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def step_images(dev) -> tuple:
    """Flagship test view 0: the render (as the training loss sees it) and
    the ground truth."""
    model = GaussianModel.from_ply(str(ROOT / "assets" / "flagship" / "point_cloud.ply"), 3, dev)
    view = read_nerf_synthetic_split(str(ROOT / "data" / "flagship800"), "test", False, -1, dev)[0]
    image = render(view.camera, model.render_inputs(3), torch.zeros(3, device=dev))["render"]
    return image.detach().contiguous(), view.gt_image.contiguous()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssim_times: needs a CUDA device")
    dev = torch.device("cuda")
    build.build_all([flat_raster.KERNEL, ssim_ops.KERNEL, ssim_ops.BACKWARD])
    x, y = step_images(dev)
    cot = torch.tensor(-0.2, device=dev)
    b = lambda: ssim_ops.ssim_forward(x, y)
    d = lambda: ssim_ops.ssim_backward(x, y, cot)
    out = {"root": str(ROOT), "B_ms": time_ms(b), "D_ms": time_ms(d),
           "B_back_to_back_ms": time_ms(b, hide_host=False),
           "D_back_to_back_ms": time_ms(d, hide_host=False)}
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
