"""DeepSDF-style autodecoder MLP and the NeRF positional embedding. Port of
`sgs_tpu/models/autodecoder.py`.

Configurable hidden sizes, weight normalisation on the layers named in
`norm_layers`, residual connections from layer 1 on (added before the
ReLU), an optional tanh on the output and re-injection of the input at
the layers named in `latent_in`. The positional embedding maps (..., 3)
to [x, sin(f0 x), cos(f0 x), sin(f1 x), ...] with f_k = 2^k (multires 10
gives 63 dims).

Weights are kept in `nn.Linear`'s (out, in) layout; the JAX package keeps
(in, out). `jax_named_parameters` names each tensor as the JAX parameter
tree does (`lin0/kernel`, or `lin0/v`, `lin0/g`, `lin0/b` for a
weight-normed layer) and says which ones are transposed, so parameters
and checkpoints carry across. The initialiser follows the JAX package's
distribution, not its bits: weights U(+-1/sqrt(in)), biases
U(+-1/sqrt(out)) (`nn.Linear` would draw biases from U(+-1/sqrt(in))).
The matrix products are `F.linear` in f32; TF32 is off on the card
(`resolve_device`), the counterpart of `Precision.HIGHEST`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def get_embedder(multires: int = 10) -> Tuple[Callable[[torch.Tensor], torch.Tensor], int]:
    """Returns (embed_fn, out_dim): the NeRF positional encoding."""
    freqs = (2.0 ** torch.linspace(0.0, multires - 1, multires, dtype=torch.float32)).tolist()

    def embed(x: torch.Tensor) -> torch.Tensor:
        outs = [x]
        for f in freqs:
            outs.append(torch.sin(x * f))
            outs.append(torch.cos(x * f))
        return torch.cat(outs, dim=-1)

    return embed, 3 + 3 * 2 * multires


def _uniform_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class TorchDense(nn.Module):
    """x W^T + b, W (out, in)."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((out_features, in_features), device=device))
        self.bias = nn.Parameter(torch.zeros((out_features,), device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        out_features, in_features = self.weight.shape
        _uniform_(self.weight, in_features, generator)
        _uniform_(self.bias, out_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class WeightNormDense(nn.Module):
    """Weight normalisation: W = g * v / max(||v||, 1e-12), the norm taken
    over each output's row of v (out, in)."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.v = nn.Parameter(torch.zeros((out_features, in_features), device=device))
        self.g = nn.Parameter(torch.zeros((out_features,), device=device))
        self.b = nn.Parameter(torch.zeros((out_features,), device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        out_features, in_features = self.v.shape
        _uniform_(self.v, in_features, generator)
        with torch.no_grad():
            self.g.copy_(torch.linalg.vector_norm(self.v, dim=1))
        _uniform_(self.b, out_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(self.v, dim=1)
        w = self.v * (self.g / torch.maximum(norm, norm.new_tensor(1e-12)))[:, None]
        return F.linear(x, w, self.b)


# torch attribute -> (JAX leaf name, transposed)
_JAX_LEAVES = {"weight": ("kernel", True), "bias": ("bias", False),
               "v": ("v", True), "g": ("g", False), "b": ("b", False)}


class Decoder(nn.Module):
    """The reference Decoder: latent_in re-injects the whole input at the
    given layers; a layer is weight-normed when `weight_norm` is set and
    it is in `norm_layers`."""

    def __init__(self, latent_size: int, hidden_sizes: Sequence[int], output_dim: int,
                 pos_emb_size: int = 0, norm_layers: Sequence[int] = tuple(range(8)),
                 latent_in: Sequence[int] = (), weight_norm: bool = True,
                 use_tanh: bool = False, residual: bool = True, device=None):
        super().__init__()
        self.latent_in = tuple(latent_in)
        self.use_tanh = use_tanh
        self.residual = residual
        dims = [latent_size + pos_emb_size] + list(hidden_sizes) + [output_dim]
        self.num_layers = len(dims)
        self.layers = nn.ModuleDict()
        in_dim = dims[0]
        for layer in range(self.num_layers - 1):
            if layer in self.latent_in:
                in_dim += dims[0]
            out_dim = dims[layer + 1] - (dims[0] if layer + 1 in self.latent_in else 0)
            cls = WeightNormDense if weight_norm and layer in norm_layers else TorchDense
            self.layers[f"lin{layer}"] = cls(in_dim, out_dim, device=device)
            in_dim = out_dim

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for lin in self.layers.values():
            lin.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x
        for layer in range(self.num_layers - 1):
            residual = x
            if layer in self.latent_in:
                x = torch.cat([x, inp], dim=-1)
            x = self.layers[f"lin{layer}"](x)
            if layer == self.num_layers - 2 and self.use_tanh:
                x = torch.tanh(x)
            if layer < self.num_layers - 2:
                if self.residual and layer != 0:
                    x = x + residual
                x = torch.relu(x)
        return x

    def jax_named_parameters(self) -> Iterator[Tuple[str, nn.Parameter, bool]]:
        """(JAX path such as "lin0/kernel", parameter, stored transposed)."""
        for name, p in self.named_parameters():
            _, lin, attr = name.split(".")
            leaf, transposed = _JAX_LEAVES[attr]
            yield f"{lin}/{leaf}", p, transposed

    @torch.no_grad()
    def load_jax_arrays(self, arrays: Dict[str, np.ndarray], prefix: str = "") -> None:
        """Copy JAX parameters (numpy, JAX's names under `prefix` and JAX's
        (in, out) layout) into the layers."""
        for name, p, transposed in self.jax_named_parameters():
            a = torch.as_tensor(np.array(arrays[prefix + name], np.float32))
            p.copy_(a.T if transposed else a)


def decode_latents(decoder: Decoder, latents: torch.Tensor, xyz: Optional[torch.Tensor] = None,
                   embed_fn: Optional[Callable] = None) -> torch.Tensor:
    """Decoder.forward: the positional embedding of the detached structure
    means, if given, concatenated before the latents."""
    if xyz is not None:
        inp = torch.cat([embed_fn(xyz.detach()), latents], dim=-1)
    else:
        inp = latents
    return decoder(inp)
