"""Multi-device training on `torch.distributed`. Port of `sgs_tpu/parallel/`.

Mesh axes, as in the JAX package:
  "data"  — camera-batch data parallelism: each rank renders its own views
            of a step and the parameter gradients are averaged;
  "gauss" — Gaussian sharding: each rank projects and shades its own slice
            of the pool, the (N, 12) splat records are gathered over the
            axis, and each rank composites its own band of image rows.

Modules: `mesh` (process group, `DeviceMesh`), `collectives` (the gathers
whose backward is what `shard_map`'s transposes give JAX), `data_parallel`
(`--parallel dp`), `tile_shard` (the band render) and `hybrid`
(`--parallel hybrid`, data x gauss). Every collective names its process
group. The renders run Kernels A-D unchanged: a band is an ordinary
`width x band_height` frame whose records are shifted up by the band's
pixel offset.
"""
