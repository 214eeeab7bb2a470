"""Device resolution for the port's entry points.

Entry points default to the card and raise when CUDA is absent: there is
no silent CPU path. The CPU is used only when a caller asks for it, as the
tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """Return the torch.device to compute on, pinning f32 numerics.

    TF32 is switched off for matmul and cuDNN: the counterpart of the
    `Precision.HIGHEST` the JAX package pins on the TPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
