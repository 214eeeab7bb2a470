"""PyTorch/CUDA port of sgs_tpu for one NVIDIA H100.

Mirrors the module layout of `sgs_tpu` (core/, data/, models/, render/,
ops/, train/) so each function has an obvious counterpart. The port never
imports JAX or `sgs_tpu`; only the parity tests import both. Hand-written
Hopper kernels live in `csrc/` and are built with nvcc into plain-C shared
libraries at first use (see `ops/build.py`).
"""
