"""Per-field Adam with slot surgery, and the learning-rate schedules. Port of
`sgs_tpu/train/optim.py`.

Six fields (xyz, features_dc, features_rest, scaling, rotation, opacity)
with their own learning rates, betas (0.9, 0.999) and eps 1e-15, and one
step counter per field, so densification keeps the step while zeroing the
moments of new slots. The update is written in the JAX package's
expression order, which is also torch.optim.Adam's step for step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15


def _bmask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((mask.shape[0],) + (1,) * (like.dim() - 1))


@dataclass
class AdamState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    step: Dict[str, int]

    @classmethod
    def init(cls, params: Dict[str, torch.Tensor]) -> "AdamState":
        return cls(
            mu={k: torch.zeros_like(v) for k, v in params.items()},
            nu={k: torch.zeros_like(v) for k, v in params.items()},
            step={k: 0 for k in params},
        )

    def zero_slots(self, field: str, slot_mask: torch.Tensor) -> "AdamState":
        """Zero one field's moments at the given (C,) slots."""
        m = _bmask(slot_mask, self.mu[field])
        return AdamState(
            mu={**self.mu, field: torch.where(m, 0.0, self.mu[field])},
            nu={**self.nu, field: torch.where(m, 0.0, self.nu[field])},
            step=dict(self.step),
        )

    def zero_field(self, field: str) -> "AdamState":
        """Zero one field's moments everywhere (the opacity reset)."""
        return AdamState(
            mu={**self.mu, field: torch.zeros_like(self.mu[field])},
            nu={**self.nu, field: torch.zeros_like(self.nu[field])},
            step=dict(self.step),
        )


def adam_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: AdamState, lrs: Dict[str, float],
                update_mask: Optional[torch.Tensor] = None):
    """One Adam step over every field; returns (new params, new state).

    update_mask (C,) bool: rows outside it keep their parameters and
    moments (dead pool slots)."""
    new_params, new_mu, new_nu, new_step = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        t = state.step[k] + 1
        mu = ADAM_B1 * state.mu[k] + (1.0 - ADAM_B1) * g
        nu = ADAM_B2 * state.nu[k] + (1.0 - ADAM_B2) * (g * g)
        tf = torch.tensor(float(t), dtype=torch.float32, device=p.device)
        bias1 = 1.0 - torch.pow(torch.tensor(ADAM_B1, dtype=torch.float32, device=p.device), tf)
        bias2 = 1.0 - torch.pow(torch.tensor(ADAM_B2, dtype=torch.float32, device=p.device), tf)
        denom = torch.sqrt(nu) / torch.sqrt(bias2) + ADAM_EPS
        lr = torch.tensor(lrs[k], dtype=torch.float32, device=p.device)
        p_new = p - lr * (mu / bias1) / denom
        if update_mask is not None:
            m = _bmask(update_mask, p)
            p_new = torch.where(m, p_new, p)
            mu = torch.where(m, mu, state.mu[k])
            nu = torch.where(m, nu, state.nu[k])
        new_params[k] = p_new
        new_mu[k] = mu
        new_nu[k] = nu
        new_step[k] = t
    return new_params, AdamState(mu=new_mu, nu=new_nu, step=new_step)


def expon_lr_func(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
                  lr_delay_mult: float = 1.0, max_steps: int = 1_000_000) -> Callable[[int], float]:
    """Continuous log-linear decay with an optional delay ramp (Plenoxels)."""

    def helper(step: int) -> float:
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0)
            )
        else:
            delay_rate = 1.0
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
        return delay_rate * log_lerp

    return helper


def make_lr_dict(opt_cfg, spatial_lr_scale: float, iteration: int) -> Dict[str, float]:
    """Per-field learning rates at an iteration."""
    xyz_sched = expon_lr_func(
        lr_init=opt_cfg.position_lr_init * spatial_lr_scale,
        lr_final=opt_cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt_cfg.position_lr_delay_mult,
        max_steps=opt_cfg.position_lr_max_steps,
    )
    return {
        "xyz": xyz_sched(iteration),
        "features_dc": opt_cfg.feature_lr,
        "features_rest": opt_cfg.feature_lr / 20.0,
        "opacity": opt_cfg.opacity_lr,
        "scaling": opt_cfg.scaling_lr,
        "rotation": opt_cfg.rotation_lr,
    }
