"""Latent / structured Gaussian model. Port of `sgs_tpu/models/latent.py`.

Per-structure parameters (means (M, 3), opacity logits (M, 1), log-scales
(M, 3), wxyz quaternions (M, 4) and latents (M, L)) and a decoder MLP
that maps each latent (after the positional embedding of the structure
mean, if asked for) to K Gaussians of D = 11 + 3(deg+1)^2 raw values.
`decode()` composes them into the flat per-Gaussian fields of the pool:
xyz = offset + mean; opacity and scale = offset + the structure's value
(before activation); rotation = standardize(normalize(q_structure) *
normalize(q_offset)); the SH features are the tail. Every Gaussian is
alive, so `render_inputs` feeds the port's renderer as it is.

The model is an `nn.Module`; `trainable_params()` names its tensors as
the JAX package's parameter tree flattens (`structure_means`, ...,
`decoder_params/lin0/kernel`), the names of the LGM checkpoint, and
`from_jax_arrays` builds a model from those arrays. Random draws (the
decoder's initialiser, latents and the random rotations of `create`)
come from an explicit `torch.Generator`: the distributions are JAX's,
the bits cannot be.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from sgs_tpu_torch.core import sh as sh_lib
from sgs_tpu_torch.core import transforms
from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.models.autodecoder import Decoder, decode_latents, get_embedder
from sgs_tpu_torch.models.gaussians import GaussianInputs

STRUCTURE_FIELDS = ("structure_latents", "structure_means", "structure_opacities",
                    "structure_rotations", "structure_scales")
DECODER_PREFIX = "decoder_params/"


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    return torch.where(q[..., 0:1] < 0, -q, q)


def quaternion_normalize_then_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ab = transforms.quat_multiply(transforms.normalize(a, eps=1e-12),
                                  transforms.normalize(b, eps=1e-12))
    return standardize_quaternion(ab)


def median(x: torch.Tensor) -> torch.Tensor:
    """`jnp.median` of a 1-D tensor: the two middle values averaged as
    (lo + hi) * 0.5 for an even count (`torch.median` returns the lower)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


class LatentGaussianModel(nn.Module):
    def __init__(self, num_structures: int, sh_degree: int = 0, latent_size: int = 32,
                 hidden_size: int = 32, gaussians_per_structure: int = 8,
                 use_positional_embedding: bool = False, positional_embedding_multires: int = 10,
                 device: "str | torch.device" = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.sh_degree = sh_degree
        self.latent_size = latent_size
        self.hidden_size = hidden_size
        self.gaussians_per_structure = gaussians_per_structure
        self.use_positional_embedding = use_positional_embedding
        self.positional_embedding_multires = positional_embedding_multires
        m = num_structures
        z = lambda *shape: nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=dev))
        self.structure_means = z(m, 3)
        self.structure_opacities = z(m, 1)
        self.structure_scales = z(m, 3)
        self.structure_rotations = z(m, 4)
        self.structure_latents = z(m, latent_size)
        pos_size = get_embedder(positional_embedding_multires)[1] if use_positional_embedding else 0
        self.decoder = Decoder(
            latent_size=latent_size, hidden_sizes=[hidden_size] * 2,
            output_dim=self.gaussian_parameters_size * gaussians_per_structure,
            pos_emb_size=pos_size, norm_layers=(),  # the reference passes norm_layers=[]
            device=dev,
        )

    @property
    def device(self) -> torch.device:
        return self.structure_means.device

    @property
    def num_structures(self) -> int:
        return self.structure_means.shape[0]

    @property
    def num_gaussians(self) -> int:
        return self.num_structures * self.gaussians_per_structure

    @property
    def gaussian_parameters_size(self) -> int:
        return 11 + 3 * (self.sh_degree + 1) ** 2

    # ------------------------------------------------------------- decode
    def decode(self, latent_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Latents -> the flat raw Gaussian fields (the pool's layout)."""
        m, k, d = self.num_structures, self.gaussians_per_structure, self.gaussian_parameters_size
        latents = self.structure_latents
        if latent_noise is not None:
            latents = latents + latent_noise.detach()
        if self.use_positional_embedding:
            embed_fn, _ = get_embedder(self.positional_embedding_multires)
            out = decode_latents(self.decoder, latents, xyz=self.structure_means, embed_fn=embed_fn)
        else:
            out = decode_latents(self.decoder, latents)
        p = out.reshape(m, k, d)
        xyz = (p[:, :, 0:3] + self.structure_means[:, None, :]).reshape(m * k, 3)
        opacity = (p[:, :, 3:4] + self.structure_opacities[:, None, :]).reshape(m * k, 1)
        scaling = (p[:, :, 4:7] + self.structure_scales[:, None, :]).reshape(m * k, 3)
        rotation = quaternion_normalize_then_multiply(
            self.structure_rotations[:, None, :], p[:, :, 7:11]).reshape(m * k, 4)
        features_dc = p[:, :, 11:14].reshape(m * k, 1, 3)
        n_rest = (self.sh_degree + 1) ** 2 - 1
        features_rest = p[:, :, 14:].reshape(m * k, n_rest, 3)
        return {"xyz": xyz, "opacity": opacity, "scaling": scaling, "rotation": rotation,
                "features_dc": features_dc, "features_rest": features_rest}

    def render_inputs(self, active_sh_degree: int,
                      latent_noise: Optional[torch.Tensor] = None) -> GaussianInputs:
        raw = self.decode(latent_noise)
        n = raw["xyz"].shape[0]
        return GaussianInputs(
            means3d=raw["xyz"],
            opacities=torch.sigmoid(raw["opacity"]),
            scales=torch.exp(raw["scaling"]),
            # decode() already emits unit quaternions; the renderer normalises again
            rotations=raw["rotation"],
            shs=torch.cat([raw["features_dc"], raw["features_rest"]], dim=1),
            sh_degree=active_sh_degree,
            alive=torch.ones((n,), dtype=torch.bool, device=raw["xyz"].device),
        )

    # ------------------------------------------------------------- constructors
    @classmethod
    def create(cls, generator: torch.Generator, structure_means_init: np.ndarray,
               device: "str | torch.device" = "cuda", **config) -> "LatentGaussianModel":
        """The constructor path: structures at the given means with random
        rotations and latents, opacity 0.1, log-scale 1, a fresh decoder."""
        m = structure_means_init.shape[0]
        model = cls(m, device=device, **config)
        dev = model.device
        f32 = dict(dtype=torch.float32, device=dev, generator=generator)
        with torch.no_grad():
            model.structure_latents.copy_(torch.randn((m, model.latent_size), **f32))
            model.structure_rotations.copy_(torch.randn((m, 4), **f32))
            model.structure_means.copy_(torch.as_tensor(np.asarray(structure_means_init, np.float32)))
            model.structure_opacities.copy_(
                transforms.inverse_sigmoid(0.1 * torch.ones((m, 1), dtype=torch.float32, device=dev)))
            model.structure_scales.fill_(1.0)
        model.decoder.reset_parameters(generator)
        return model

    def create_from_pcd(self, generator: torch.Generator, points: np.ndarray, colors: np.ndarray,
                        init_scale_clip: float = 4.0) -> "LatentGaussianModel":
        """The scene-init path: one structure per point, scales from the
        3-NN distance (clipped at init_scale_clip x its median; 0 turns the
        clip off), identity rotations, opacity 0.1, and latents drawn from
        N(0, 1) with dims 0:7 zero, 7:11 the identity quaternion and 11:14
        RGB2SH(colour). Replaces the structure parameters (their count
        becomes the number of points) and keeps the decoder; returns the
        model."""
        from sgs_tpu_torch.ops import knn

        dev = self.device
        m = points.shape[0]
        pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
        dist2 = knn.mean_sq_dist_3nn(pts)
        dist = torch.sqrt(torch.maximum(dist2, dist2.new_tensor(1e-7)))
        if init_scale_clip > 0:
            dist = torch.minimum(dist, init_scale_clip * median(dist))
        log_scale = torch.log(dist)[:, None].repeat(1, 3)
        rots = torch.zeros((m, 4), dtype=torch.float32, device=dev)
        rots[:, 0] = 1.0
        opac = transforms.inverse_sigmoid(0.1 * torch.ones((m, 1), dtype=torch.float32, device=dev))
        fused_color = sh_lib.rgb_to_sh(torch.as_tensor(np.asarray(colors, np.float32), device=dev))
        latents = torch.randn((m, self.latent_size), dtype=torch.float32, device=dev,
                              generator=generator)
        latents[:, 0:7] = 0.0
        latents[:, 7:11] = rots
        latents[:, 11:14] = fused_color
        self.structure_means = nn.Parameter(pts)
        self.structure_opacities = nn.Parameter(opac)
        self.structure_scales = nn.Parameter(log_scale)
        self.structure_rotations = nn.Parameter(rots)
        self.structure_latents = nn.Parameter(latents)
        return self

    # ------------------------------------------------------------- params
    def trainable_params(self) -> Dict[str, nn.Parameter]:
        """Every parameter under its JAX checkpoint name, in the order JAX
        flattens the tree (decoder first, then the structure fields)."""
        params = {DECODER_PREFIX + name: p for name, p, _ in self.decoder.jax_named_parameters()}
        params.update({f: getattr(self, f) for f in STRUCTURE_FIELDS})
        return dict(sorted(params.items()))

    def transposed_params(self) -> set:
        """The names of `trainable_params` stored transposed to JAX's layout."""
        return {DECODER_PREFIX + name for name, _, t in self.decoder.jax_named_parameters() if t}

    def jax_arrays(self) -> Dict[str, np.ndarray]:
        """The parameters as numpy arrays in the JAX package's names and
        layouts (the inverse of `from_jax_arrays`)."""
        transposed = self.transposed_params()
        return {k: (p.detach().T if k in transposed else p.detach()).cpu().numpy()
                for k, p in self.trainable_params().items()}

    @torch.no_grad()
    def load_jax_arrays(self, arrays: Dict[str, np.ndarray]) -> "LatentGaussianModel":
        """Copy JAX-named, JAX-laid-out arrays into the parameters (the
        structure count may change); returns the model."""
        for f in STRUCTURE_FIELDS:
            setattr(self, f, nn.Parameter(torch.as_tensor(np.array(arrays[f], np.float32),
                                                          device=self.device)))
        self.decoder.load_jax_arrays(arrays, DECODER_PREFIX)
        return self

    @classmethod
    def from_jax_arrays(cls, arrays: Dict[str, np.ndarray], device: "str | torch.device" = "cuda",
                        **config) -> "LatentGaussianModel":
        """Carry a JAX `LatentGaussianModel` across: `arrays` holds its
        `trainable_params()` flattened to the checkpoint's key names
        (without the "p:" prefix) as numpy arrays; `config` its static
        fields (sh_degree, latent_size, ...)."""
        model = cls(np.asarray(arrays["structure_means"]).shape[0], device=device, **config)
        return model.load_jax_arrays(arrays)
