"""SSIM, PSNR, L1, L2 and the training loss. Port of `sgs_tpu/ops/ssim.py`,
with the SSIM forward kernel (Kernel B), which replaces
`sgs_tpu/ops/pallas/ssim_kernels.py::ssim_forward`, and the SSIM backward
kernel (Kernel D), which replaces `ssim_backward` there.

SSIM uses the reference windowing: an 11x11 Gaussian window (sigma 1.5,
normalised) that factors into two 1-D passes, zero padding of 5, C1 =
0.01^2, C2 = 0.03^2, and the mean over the full map. On a CUDA tensor
`ssim` launches the hand-written kernel in `csrc/ssim.cu` (one launch:
per-tile partial sums, then the last block sums them in a fixed order);
on a CPU tensor it runs the plain version, a shift-and-add transcription
of `_ssim_jnp` whose mean is summed in the kernel's order, so the two
agree bit for bit. `SSIMFunction` pairs the two: Kernel B forward and
Kernel D backward on the card (one launch that recomputes the windowed
statistics, forms the pointwise partials of the map on the tile and a
ring, runs them through the window and combines them with x and y), the
plain versions on the CPU. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sgs_tpu_torch.ops.build import FLOAT, INT, PTR, CudaKernel
from sgs_tpu_torch.ops.flat_raster import _butterfly

WINDOW = 11
PAD = WINDOW // 2
SIGMA = 1.5
# Kernel B's output tile (per channel) and block: the 32 lanes of a warp
# along W, one strip of TILE_H // WARPS rows per warp. `ssim_plain` sums
# its map in that order.
TILE_H, TILE_W = 48, 32
THREADS = 384
WARPS = THREADS // 32

KERNEL = CudaKernel(
    "ssim.cu",
    {"ssim_forward": [PTR, PTR, INT, INT, ctypes.POINTER(ctypes.c_float), FLOAT, PTR, PTR, PTR,
                      PTR]},
    extra_flags=("--fmad=false",),
)
BACKWARD = CudaKernel(
    "ssim_backward.cu",
    {"ssim_backward": [PTR, PTR, PTR, FLOAT, INT, INT, ctypes.POINTER(ctypes.c_float), PTR, PTR,
                       PTR]},
    extra_flags=("--fmad=false",),
)

# f32 operations per pixel and channel: 3 products, 2 passes x 5 maps x
# 11 taps x 2, and about 17 for the SSIM map and its sum.
OPS_PER_PIXEL = 240
# Kernel D: the same 240 to recompute the statistics, about 30 for the
# pointwise partials, 2 passes x 5 maps x 11 taps x 2 and 8 to combine.
OPS_PER_PIXEL_BWD = 500
C1, C2 = 0.01**2, 0.03**2


# The normalised 1-D window (WINDOW taps, SIGMA 1.5) as the f32 values of
# `sgs_tpu/ops/ssim.py::_gaussian_window(11, 1.5)`, bit for bit. Computing
# it here (exp, then the f32 sum and division) lands 1 ulp below in 7 of
# the 11 taps, and a float64 window rounded to f32 can be 2 ulp off; the
# SSIM map's E[x^2] - mu^2 cancels enough to show either in the mean.
WINDOW_TAPS = tuple(float.fromhex(h) for h in (
    "0x1.0d957p-10", "0x1.f1fe04p-8", "0x1.26eb18p-5", "0x1.bff1p-4", "0x1.b43c4p-3", "0x1.106562p-2",
    "0x1.b43c4p-3", "0x1.bff1p-4", "0x1.26eb18p-5", "0x1.f1fe04p-8", "0x1.0d957p-10"))


def gaussian_window() -> torch.Tensor:
    """The normalised 1-D window in f32 on the CPU (`WINDOW_TAPS`)."""
    return torch.tensor(WINDOW_TAPS, dtype=torch.float32)


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


def _in_turn(v: torch.Tensor) -> torch.Tensor:
    """Sum the last axis one element after another from +0."""
    acc = torch.zeros_like(v[..., 0])
    for k in range(v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """Kernel B's sum over a block of THREADS values (last axis, thread
    order): each warp's 32 lanes by the butterfly, then the warps in turn."""
    return _in_turn(_butterfly(v.reshape(*v.shape[:-1], WARPS, 32))[..., 0])


def ordered_mean(ssim_map: torch.Tensor) -> torch.Tensor:
    """Mean of a (C, H, W) map in Kernel B's order: per TILE_H x TILE_W
    tile, each thread's strip of TILE_H // WARPS rows of one column in
    turn, then the block sum (lanes are columns, warps are strips); then
    the tile partials in index order (channel, tile row, tile column),
    thread t taking partials t, t + THREADS, ... in turn, then the block
    sum; then one division by C H W. Zeros pad the map to whole tiles."""
    c, h, w = ssim_map.shape
    ty, tx = -(-h // TILE_H), -(-w // TILE_W)
    m = torch.nn.functional.pad(ssim_map, (0, tx * TILE_W - w, 0, ty * TILE_H - h))
    m = m.reshape(c, ty, WARPS, TILE_H // WARPS, tx, TILE_W).permute(0, 1, 4, 2, 5, 3)
    partials = _block_sum(_in_turn(m).reshape(c, ty, tx, THREADS)).reshape(-1)
    rounds = -(-partials.shape[0] // THREADS)
    lanes = torch.nn.functional.pad(partials, (0, rounds * THREADS - partials.shape[0]))
    total = _block_sum(_in_turn(lanes.reshape(rounds, THREADS).T))
    return total / torch.full_like(total, float(c * h * w))


def ssim_plain(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of a (C, H, W) pair, the mean of `ssim_map` summed in
    Kernel B's order (`ordered_mean`)."""
    return ordered_mean(ssim_map(img1, img2))


def ssim_map(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """The (C, H, W) SSIM map of a pair, separable pass along W then H."""
    w1d = gaussian_window().to(img1.device)

    def conv(v):
        return _conv1d_axis(_conv1d_axis(v, w1d, 2), w1d, 1)

    mu1, mu2 = conv(img1), conv(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2
    return ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )


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
    partials = torch.empty(3 * (-(-h // TILE_H)) * (-(-w // TILE_W)), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    KERNEL.launch("ssim_forward", x.data_ptr(), y.data_ptr(), h, w, _window_arg(), float(3 * h * w),
                  partials.data_ptr(), KERNEL.ticket(x.device).data_ptr(), out.data_ptr(),
                  torch.cuda.current_stream(x.device).cuda_stream)
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


def ssim_backward_plain(x: torch.Tensor, y: torch.Tensor, cot: torch.Tensor, with_dy: bool = True):
    """The same function as Kernel D: (dx, dy) of cot * mean SSIM; dy is
    None unless `with_dy`."""
    _, h, w = x.shape
    w1d = gaussian_window().to(x.device)

    def conv(v):
        return _conv1d_axis(_conv1d_axis(v, w1d, 2), w1d, 1)

    ga, gb, gc, _, ge = _ssim_partials(conv(x), conv(y), conv(x * x), conv(y * y), conv(x * y))
    a, c, e = conv(ga), conv(gc), conv(ge)
    scale = _scale(cot, h, w)
    dx = (a + 2.0 * x * c + y * e) * scale
    # the partials for E[x^2] and E[y^2] are one map, so D' = C'
    dy = (conv(gb) + 2.0 * y * c + x * e) * scale if with_dy else None
    return dx, dy


def ssim_backward(x: torch.Tensor, y: torch.Tensor, cot: torch.Tensor, with_dy: bool = True):
    """Kernel D on (3, H, W) f32 CUDA tensors and a 0-d cotangent on the
    card: returns (dx, dy), dy None unless `with_dy`."""
    _check_pair(x, y, "ssim_backward")
    if cot.numel() != 1 or cot.device != x.device:
        raise ValueError("cot must be one value on the images' device")
    _, h, w = x.shape
    cot = cot.to(torch.float32).reshape(()).contiguous()
    dx = torch.empty_like(x)
    dy = torch.empty_like(y) if with_dy else None
    BACKWARD.launch("ssim_backward", x.data_ptr(), y.data_ptr(), cot.data_ptr(), float(3 * h * w),
                    h, w, _window_arg(), dx.data_ptr(), dy.data_ptr() if with_dy else None,
                    torch.cuda.current_stream(x.device).cuda_stream)
    return dx, dy


class SSIMFunction(torch.autograd.Function):
    """Mean SSIM with Kernel B forward and Kernel D backward on the card;
    the plain forward and plain backward on the CPU. The counterpart of
    the custom VJP `_ssim_fused`. The gradient for the second image is
    computed only when it needs one (in training, the ground truth does
    not)."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        if x.device.type == "cpu":
            return ssim_plain(x, y)
        return ssim_forward(x, y)

    @staticmethod
    def backward(ctx, cot):
        x, y = ctx.saved_tensors
        with_dy = ctx.needs_input_grad[1]
        if x.device.type == "cpu":
            return ssim_backward_plain(x, y, cot, with_dy)
        return ssim_backward(x, y, cot, with_dy)


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
    """20*log10(1/sqrt(mse)) per image: a scalar for a (C, H, W) pair,
    (B, 1) for a (B, C, H, W) batch, as the JAX package's `psnr`."""
    if img1.ndim == 3:
        mse = torch.mean((img1 - img2) ** 2)
    else:
        mse = torch.mean(((img1 - img2) ** 2).reshape(img1.shape[0], -1), dim=1, keepdim=True)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def training_loss(rendered: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    """(1 - lambda) L1 + lambda (1 - SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(rendered, gt) + lambda_dssim * (1.0 - ssim(rendered, gt))
