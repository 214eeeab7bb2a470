"""The LGM step's non-finite guard against JAX's on the CPU: the check of
tests/test_torch_lgm_step.py (the committed checkpoint's 250-structure
subset on a 96x96 `data/lgm400` view, JAX's gradient jitted with the
Pallas kernels in interpret mode) with one structure made degenerate, a
log-scale of 50, whose squared scale overflows f32. Both packages then
have non-finite gradient elements at the same places (compared exactly,
as is their count, which the port's step reports and zeroes); the finite
elements to the bars of that file."""

import torch

from test_torch_lgm_step import check_step

torch.set_num_threads(1)


def test_step_zeroes_nonfinite_gradients_as_jax():
    check_step(degenerate=True)
