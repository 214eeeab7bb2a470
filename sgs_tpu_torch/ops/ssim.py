"""SSIM, PSNR, L1, L2 and the training loss. Port of `sgs_tpu/ops/ssim.py`,
with the SSIM forward kernel (Kernel B), which replaces
`sgs_tpu/ops/pallas/ssim_kernels.py::ssim_forward`, and the SSIM backward
kernel (Kernel D), which replaces `ssim_backward` there.

SSIM uses the reference windowing: an 11x11 Gaussian window (sigma 1.5,
normalised) that factors into two 1-D passes, zero padding of 5, C1 =
0.01^2, C2 = 0.03^2, and the mean over the full map. On a CUDA tensor
`ssim` launches the hand-written kernel in `csrc/ssim.cu` (one launch for
the per-block partial sums, one for their fixed-order sum); on a CPU
tensor it runs the plain version, a shift-and-add transcription of
`_ssim_jnp`. `SSIMFunction` pairs the two: Kernel B forward and Kernel D
backward on the card (D1 recomputes the windowed statistics and forms the
pointwise partials of the map, D2 runs them through the window and
combines them with x and y), the plain versions on the CPU. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sgs_tpu_torch.ops.build import FLOAT, INT, PTR, CudaKernel

WINDOW = 11
PAD = WINDOW // 2
SIGMA = 1.5
TILE = 16  # output tile of the kernel, per channel

KERNEL = CudaKernel(
    "ssim.cu",
    {
        "ssim_partials": [PTR, PTR, INT, INT, ctypes.POINTER(ctypes.c_float), PTR, PTR],
        "ssim_reduce": [PTR, INT, FLOAT, PTR, PTR],
    },
    extra_flags=("--fmad=false",),
)
BACKWARD = CudaKernel(
    "ssim_backward.cu",
    {
        "ssim_gmap": [PTR, PTR, INT, INT, ctypes.POINTER(ctypes.c_float), PTR, PTR],
        "ssim_combine": [PTR, PTR, PTR, PTR, FLOAT, INT, INT,
                         ctypes.POINTER(ctypes.c_float), PTR, PTR, PTR],
    },
    extra_flags=("--fmad=false",),
)

# f32 operations per pixel and channel: 3 products, 2 passes x 5 maps x
# 11 taps x 2, and about 17 for the SSIM map and its sum.
OPS_PER_PIXEL = 240
# Kernel D: the same 240 to recompute the statistics, about 30 for the
# pointwise partials, 2 passes x 5 maps x 11 taps x 2 and 8 to combine.
OPS_PER_PIXEL_BWD = 500
C1, C2 = 0.01**2, 0.03**2


def gaussian_window() -> torch.Tensor:
    """The normalised 1-D window in f32, computed on the CPU."""
    xs = torch.arange(WINDOW, dtype=torch.float32)
    g = torch.exp(-((xs - WINDOW // 2) ** 2) / (2.0 * SIGMA**2))
    return g / torch.sum(g)


@functools.lru_cache(maxsize=1)
def _window_arg():
    """The window as the C launcher takes it (a float[11] on the host)."""
    return (ctypes.c_float * WINDOW)(*gaussian_window().tolist())


def _conv1d_axis(x: torch.Tensor, w1d: torch.Tensor, dim: int) -> torch.Tensor:
    """Zero-padded 1-D convolution of (C, H, W) along `dim` (1 or 2)."""
    pads = [0, 0, 0, 0]
    pads[0 if dim == 2 else 2] = PAD
    pads[1 if dim == 2 else 3] = PAD
    xp = torch.nn.functional.pad(x, pads)
    length = x.shape[dim]
    out = torch.zeros_like(x)
    for k in range(WINDOW):
        out = out + w1d[k] * xp.narrow(dim, k, length)
    return out


def ssim_plain(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of a (C, H, W) pair, separable pass along W then H."""
    w1d = gaussian_window().to(img1.device)

    def conv(v):
        return _conv1d_axis(_conv1d_axis(v, w1d, 2), w1d, 1)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return torch.mean(ssim_map)


def _check_pair(x: torch.Tensor, y: torch.Tensor, fn: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn} runs on CUDA tensors, got {x.device}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[0] != 3:
            raise ValueError(f"{name}: expected (3, H, W) float32, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.shape != y.shape or x.device != y.device:
        raise ValueError("x and y must have one shape and one device")


def ssim_forward(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kernel B on (3, H, W) f32 CUDA tensors; returns a 0-d tensor."""
    _check_pair(x, y, "ssim_forward")
    _, h, w = x.shape
    n_partials = 3 * (-(-h // TILE)) * (-(-w // TILE))
    partials = torch.empty(n_partials, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch("ssim_partials", x.data_ptr(), y.data_ptr(), h, w, _window_arg(),
                  partials.data_ptr(), stream, count=False)
    KERNEL.launch("ssim_reduce", partials.data_ptr(), n_partials, float(3 * h * w),
                  out.data_ptr(), stream)
    return out


def _ssim_partials(mu1, mu2, exx, eyy, exy):
    """Pointwise dSSIM-map / d(mu_x, mu_y, E[x^2], E[y^2], E[xy]), in the
    association of `_gmap_kernel` (and of Kernel D1)."""
    n1 = 2.0 * mu1 * mu2 + C1
    n2 = 2.0 * (exy - mu1 * mu2) + C2
    d1 = mu1 * mu1 + mu2 * mu2 + C1
    d2 = (exx - mu1 * mu1) + (eyy - mu2 * mu2) + C2
    inv = 1.0 / (d1 * d2)
    m = n1 * n2 * inv
    ga = 2.0 * mu2 * (n2 - n1) * inv - m * (2.0 * mu1 / d1 - 2.0 * mu1 / d2)
    gb = 2.0 * mu1 * (n2 - n1) * inv - m * (2.0 * mu2 / d1 - 2.0 * mu2 / d2)
    gc = -m / d2
    ge = 2.0 * n1 * inv
    return ga, gb, gc, gc, ge


def _scale(cot: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """cot / (3HW) as one division (a Python divisor would run on the card
    as a multiplication by its reciprocal)."""
    cot = cot.to(torch.float32)
    return cot / torch.full_like(cot, float(3 * h * w))


def ssim_backward_plain(x: torch.Tensor, y: torch.Tensor, cot: torch.Tensor):
    """The same function as Kernel D: (dx, dy) of cot * mean SSIM."""
    _, h, w = x.shape
    w1d = gaussian_window().to(x.device)

    def conv(v):
        return _conv1d_axis(_conv1d_axis(v, w1d, 2), w1d, 1)

    ga, gb, gc, gd, ge = _ssim_partials(conv(x), conv(y), conv(x * x), conv(y * y), conv(x * y))
    a, b, c, d, e = conv(ga), conv(gb), conv(gc), conv(gd), conv(ge)
    scale = _scale(cot, h, w)
    dx = (a + 2.0 * x * c + y * e) * scale
    dy = (b + 2.0 * y * d + x * e) * scale
    return dx, dy


def ssim_backward(x: torch.Tensor, y: torch.Tensor, cot: torch.Tensor):
    """Kernel D on (3, H, W) f32 CUDA tensors and a 0-d cotangent on the
    card: returns (dx, dy)."""
    _check_pair(x, y, "ssim_backward")
    if cot.numel() != 1 or cot.device != x.device:
        raise ValueError("cot must be one value on the images' device")
    _, h, w = x.shape
    cot = cot.to(torch.float32).reshape(()).contiguous()
    gmap = torch.empty((5, 3, h, w), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dy = torch.empty_like(y)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    BACKWARD.launch("ssim_gmap", x.data_ptr(), y.data_ptr(), h, w, _window_arg(),
                    gmap.data_ptr(), stream, count=False)
    BACKWARD.launch("ssim_combine", gmap.data_ptr(), x.data_ptr(), y.data_ptr(), cot.data_ptr(),
                    float(3 * h * w), h, w, _window_arg(), dx.data_ptr(), dy.data_ptr(), stream)
    return dx, dy


class SSIMFunction(torch.autograd.Function):
    """Mean SSIM with Kernel B forward and Kernel D backward on the card;
    the plain forward and plain backward on the CPU. The counterpart of
    the custom VJP `_ssim_fused`."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        if x.device.type == "cpu":
            return ssim_plain(x, y)
        return ssim_forward(x, y)

    @staticmethod
    def backward(ctx, cot):
        x, y = ctx.saved_tensors
        if x.device.type == "cpu":
            return ssim_backward_plain(x, y, cot)
        return ssim_backward(x, y, cot)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over a (3, H, W) pair, differentiable in both: Kernels B
    and D on the card, their plain versions on the CPU."""
    return SSIMFunction.apply(img1.to(torch.float32).contiguous(),
                              img2.to(torch.float32).contiguous())


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """20*log10(1/sqrt(mse)) of a (C, H, W) pair."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def training_loss(rendered: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    """(1 - lambda) L1 + lambda (1 - SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(rendered, gt) + lambda_dssim * (1.0 - ssim(rendered, gt))
