"""SSIM, PSNR and L1. Port of `sgs_tpu/ops/ssim.py`, with the SSIM forward
kernel (Kernel B) that replaces `sgs_tpu/ops/pallas/ssim_kernels.py::
ssim_forward`.

SSIM uses the reference windowing: an 11x11 Gaussian window (sigma 1.5,
normalised) that factors into two 1-D passes, zero padding of 5, C1 =
0.01^2, C2 = 0.03^2, and the mean over the full map. On a CUDA tensor
`ssim` launches the hand-written kernel in `csrc/ssim.cu` (one launch for
the per-block partial sums, one for their fixed-order sum); on a CPU
tensor it runs the plain version, a shift-and-add transcription of
`_ssim_jnp`. There is no fallback from one to the other.
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

# f32 operations per pixel and channel: 3 products, 2 passes x 5 maps x
# 11 taps x 2, and about 17 for the SSIM map and its sum.
OPS_PER_PIXEL = 240


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
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map)


def ssim_forward(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kernel B on (3, H, W) f32 CUDA tensors; returns a 0-d tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"ssim_forward runs on CUDA tensors, got {x.device}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[0] != 3:
            raise ValueError(f"{name}: expected (3, H, W) float32, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.shape != y.shape or x.device != y.device:
        raise ValueError("x and y must have one shape and one device")
    _, h, w = x.shape
    n_partials = 3 * (-(-h // TILE)) * (-(-w // TILE))
    partials = torch.empty(n_partials, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch("ssim_partials", x.data_ptr(), y.data_ptr(), h, w, _window_arg(),
                  partials.data_ptr(), stream)
    KERNEL.launch("ssim_reduce", partials.data_ptr(), n_partials, float(3 * h * w),
                  out.data_ptr(), stream)
    return out


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over a (3, H, W) pair: Kernel B on the card, the plain
    version on the CPU."""
    if img1.device.type == "cpu":
        return ssim_plain(img1.to(torch.float32), img2.to(torch.float32))
    return ssim_forward(img1.to(torch.float32).contiguous(), img2.to(torch.float32).contiguous())


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """20*log10(1/sqrt(mse)) of a (C, H, W) pair."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))
