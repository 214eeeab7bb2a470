"""LPIPS perceptual distance (VGG16). Port of `sgs_tpu/metrics/lpips.py`.

A VGG16 feature extractor read at the LPIPS taps (relu1_2, relu2_2,
relu3_3, relu4_3, relu5_3), each tap unit-normalised over its channels
(the 1e-10 added to the norm), the squared difference weighted by the
learned 1x1 "lin" heads, averaged over space and summed over the taps.
Images are [0, 1] and go through richzhang's scaling layer first.

Weights are the JAX package's npz (`weights_path`, else the
SGS_LPIPS_WEIGHTS environment variable, else DEFAULT_WEIGHTS_PATH):
conv{i}_w HWIO and conv{i}_b for the 13 convolutions, lin{j}_w (1, 1, C,
1) for the 5 heads; they are loaded into OIHW `nn.Conv2d`s, so a JAX npz
loads unchanged. When the npz is missing but the published `.pth` files
sit beside its path (a torchvision `vgg16*.pth` and richzhang's `vgg.pth`
or `lpips*.pth`), they are converted to the npz first. The repository
carries no weights: `lpips_available()` is then False and the metrics
report LPIPS as null. TF32 stays off (`resolve_device`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sgs_tpu_torch.core.device import resolve_device

# VGG16 conv plan: (out_channels, pool_before) per conv layer
VGG16_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
# taps after the relu of these conv indices (relu1_2, 2_2, 3_3, 4_3, 5_3)
VGG16_TAPS = [1, 3, 6, 9, 12]
# richzhang's scaling layer, applied to [0, 1] images
LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
LPIPS_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
# torchvision VGG16 `features` indices of the 13 convolutions (the state
# dict layout of the published vgg16-397923af.pth)
TORCHVISION_VGG16_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

DEFAULT_WEIGHTS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights", "lpips_vgg16.npz",
)


def weights_path_of(weights_path: Optional[str]) -> str:
    return weights_path or os.environ.get("SGS_LPIPS_WEIGHTS") or DEFAULT_WEIGHTS_PATH


def find_pth_pair(npz_path: str):
    """(vgg_pth, lin_pth) beside `npz_path`, or None: a torchvision VGG16
    state dict (vgg16*.pth) and richzhang's v0.1 lin head (vgg.pth or
    lpips*.pth)."""
    d = os.path.dirname(npz_path)
    if not os.path.isdir(d):
        return None
    names = sorted(os.listdir(d))
    vgg = [n for n in names if n.startswith("vgg16") and n.endswith(".pth")]
    lin = [n for n in names if n.endswith(".pth") and (n == "vgg.pth" or n.startswith("lpips"))]
    if vgg and lin:
        return os.path.join(d, vgg[0]), os.path.join(d, lin[0])
    return None


def lpips_available(weights_path: Optional[str] = None) -> bool:
    path = weights_path_of(weights_path)
    return os.path.exists(path) or find_pth_pair(path) is not None


def convert_reference_weights(vgg_pth: str, lin_pth: str, out_path: str) -> None:
    """The published weight files -> the npz: torchvision's VGG16 state
    dict (`features.{i}.weight/bias`, OIHW; classifier keys ignored) and
    richzhang's lin head (`lin{j}.model.1.weight` or
    `lins.{j}.model.1.weight`, (1, C, 1, 1))."""
    sd = torch.load(vgg_pth, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        sd = sd.state_dict()
    arrays = {}
    for ci, li in enumerate(TORCHVISION_VGG16_CONV_IDX):
        w = sd[f"features.{li}.weight"].numpy()
        arrays[f"conv{ci}_w"] = w.transpose(2, 3, 1, 0).astype(np.float32)
        arrays[f"conv{ci}_b"] = sd[f"features.{li}.bias"].numpy().astype(np.float32)
    lin_sd = torch.load(lin_pth, map_location="cpu", weights_only=True)
    for j in range(5):
        for key in (f"lin{j}.model.1.weight", f"lins.{j}.model.1.weight"):
            if key in lin_sd:
                break
        else:
            raise KeyError(f"no lin{j} weight in {lin_pth}")
        arrays[f"lin{j}_w"] = lin_sd[key].numpy().transpose(2, 3, 1, 0).astype(np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **arrays)


def load_weights(weights_path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The npz's arrays, converting the `.pth` pair beside it first when
    the npz is missing; FileNotFoundError when neither is there."""
    path = weights_path_of(weights_path)
    if not os.path.exists(path):
        pair = find_pth_pair(path)
        if pair is None:
            raise FileNotFoundError(
                f"LPIPS weights not found at {path}; provide converted VGG16+lin weights "
                "(see sgs_tpu_torch/metrics/lpips.py for the .npz layout)")
        convert_reference_weights(pair[0], pair[1], path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class LPIPS(nn.Module):
    """LPIPS-VGG16 from the npz arrays: forward(x, y) with (B, 3, H, W)
    images in [0, 1] gives the (B,) distances."""

    def __init__(self, arrays: Dict[str, np.ndarray]):
        super().__init__()
        self.register_buffer("shift", torch.from_numpy(LPIPS_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(LPIPS_SCALE).view(1, 3, 1, 1))
        self.convs = nn.ModuleList()
        cin = 3
        for i, (cout, _) in enumerate(VGG16_PLAN):
            conv = nn.Conv2d(cin, cout, 3, padding=1)
            conv.weight.data = torch.from_numpy(np.ascontiguousarray(arrays[f"conv{i}_w"].transpose(3, 2, 0, 1)))
            conv.bias.data = torch.from_numpy(np.ascontiguousarray(arrays[f"conv{i}_b"]))
            self.convs.append(conv)
            cin = cout
        self.lins = nn.ModuleList()
        for j, tap in enumerate(VGG16_TAPS):
            lin = nn.Conv2d(VGG16_PLAN[tap][0], 1, 1, bias=False)
            lin.weight.data = torch.from_numpy(np.ascontiguousarray(arrays[f"lin{j}_w"].transpose(3, 2, 0, 1)))
            self.lins.append(lin)
        self.requires_grad_(False)

    def features(self, x: torch.Tensor) -> list:
        x = (x - self.shift) / self.scale
        feats = []
        for i, ((_, pool_before), conv) in enumerate(zip(VGG16_PLAN, self.convs)):
            if pool_before:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(conv(x))
            if i in VGG16_TAPS:
                feats.append(x)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        def normalize(f):
            # the eps is added to the norm, not under the root
            return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + 1e-10)

        total = 0.0
        for a, b, lin in zip(self.features(x), self.features(y), self.lins):
            total = total + torch.mean(lin((normalize(a) - normalize(b)) ** 2), dim=(1, 2, 3))
        return total


_MODELS: Dict[tuple, LPIPS] = {}


def lpips(img1: torch.Tensor, img2: torch.Tensor, net_type: str = "vgg",
          weights_path: Optional[str] = None) -> torch.Tensor:
    """(3, H, W) or (B, 3, H, W) images in [0, 1] -> LPIPS distance (B,),
    on the images' device."""
    if net_type != "vgg":
        raise NotImplementedError("only the vgg backbone is implemented")
    path = weights_path_of(weights_path)
    dev = resolve_device(img1.device)
    key = (path, str(dev))
    if key not in _MODELS:
        _MODELS[key] = LPIPS(load_weights(path)).to(dev)
    if img1.ndim == 3:
        img1, img2 = img1[None], img2[None]
    with torch.no_grad():
        return _MODELS[key](img1, img2)


def synthetic_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded random weights in the npz layout, drawn in the order of
    tests/test_lpips.py's `_random_weights`: a stand-in for checks of the
    LPIPS path while the repository carries no published weights."""
    rng = np.random.default_rng(seed)
    arrays = {}
    cin = 3
    for i, (cout, _) in enumerate(VGG16_PLAN):
        arrays[f"conv{i}_w"] = rng.normal(0, 0.08, (3, 3, cin, cout)).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.normal(0, 0.01, (cout,)).astype(np.float32)
        cin = cout
    for j, tap in enumerate(VGG16_TAPS):
        arrays[f"lin{j}_w"] = np.abs(rng.normal(0, 0.05, (1, 1, VGG16_PLAN[tap][0], 1))).astype(np.float32)
    return arrays
