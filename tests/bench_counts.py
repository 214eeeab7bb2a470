"""The JAX package's binning counts for the benchmarks' scenes, on the CPU.
Not a test: a helper that `tests/test_torch_bench.py` imports and a
command-line probe that prints the counts `chip_smoke.py` phase 16 holds
the card to.

    PYTHONPATH=. python tests/bench_counts.py [--width 1920 --height 1080]

Each function runs the JAX script's own code up to its jitted step and
records what its count pre-passes compute: the root `bench.py::_measure`
on `_build_ply_scene` (the flagship, `bench.py`'s framing), and
`scripts/bench_scale.py::run_config` (its pool built from its own draws).
`visible` is the sum of the scripts' `valid` (`radius > 0` and alive),
`rows` is `row_count`, `instances` is `instance_count_tight` (tight
binning, the scripts' row bucket, which holds every row). The jitted step
and the kernel-row pre-pass are not run: `kernel_row_count` is replaced
by a stub that also replaces `jax.jit`, so the step's decoration returns a
function that stops the script by raising `Stopped` with its argument
(the pool, for `run_config`).

The CLI prints one JSON object: the flagship at 1920x1080, the 5M
panning capture and the 5M all-visible view: 43 s of wall time and 5.4
GiB of peak resident memory on an 8-core x86-64 host (most of it the 5M
pools and their projection, op by op as the scripts run it).
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from sgs_tpu.render import tiled as jtiled  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_PLY = os.path.join(ROOT, "assets", "flagship", "point_cloud.ply")


def load_script(name: str, rel: str):
    """A script of the JAX package (not an importable module) by path."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Stopped(BaseException):
    """Raised in place of the script's jitted step; `args` holds its inputs.
    Not an `Exception`, so `bench.py`'s retries let it through."""


@contextlib.contextmanager
def recording(counts: dict):
    """Record the scripts' count pre-passes into `counts` and stop the
    script at its jitted step (module docstring)."""
    saved = (jtiled.row_count, jtiled.instance_count_tight, jtiled.kernel_row_count, jax.jit)
    row_count, instance_count_tight = saved[:2]

    def rows(mean2d, radius, valid, width, height):
        counts["visible"] = int(jnp.sum(valid & (radius > 0)))
        counts["rows"] = int(row_count(mean2d, radius, valid, width, height))
        return counts["rows"]

    def instances(*args, **kwargs):
        counts["instances"] = int(instance_count_tight(*args, **kwargs))
        return counts["instances"]

    def stop(*args, **kwargs):
        raise Stopped(*args)

    def kernel_rows(*args, **kwargs):
        jax.jit = lambda fn: stop
        return 512

    jtiled.row_count, jtiled.instance_count_tight = rows, instances
    jtiled.kernel_row_count = kernel_rows
    try:
        yield counts
    finally:
        jtiled.row_count, jtiled.instance_count_tight, jtiled.kernel_row_count, jax.jit = saved


def bench_counts(ply: str = FLAGSHIP_PLY, width: int = 1920, height: int = 1080) -> dict:
    """`bench.py`'s counts for a PLY scene at width x height."""
    jbench = load_script("jax_bench", "bench.py")
    jbench.WIDTH, jbench.HEIGHT = width, height
    pool, cam = jbench._build_ply_scene(ply)
    counts: dict = {}
    with recording(counts):
        try:
            jbench._measure(pool, cam)
        except Stopped:
            pass
    return counts


def scale_run(n: int, capture: bool, width: int = 1920, height: int = 1080) -> tuple:
    """(counts, pool) of `scripts/bench_scale.py::run_config(n, capture)`
    at width x height."""
    jbs = load_script("jax_bench_scale", os.path.join("scripts", "bench_scale.py"))
    jbs.WIDTH, jbs.HEIGHT = width, height
    counts: dict = {}
    with recording(counts):
        try:
            jbs.run_config(n, capture=capture)
        except Stopped as stopped:
            return counts, stopped.args[0]
    raise RuntimeError("run_config ended without reaching its jitted step")


def main(argv=None) -> dict:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--n", type=int, default=5_000_000)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    out = {"flagship": bench_counts(width=args.width, height=args.height)}
    for name, capture in (("capture", True), ("all_visible", False)):
        out[f"{args.n}_{name}"] = scale_run(args.n, capture, args.width, args.height)[0]
        print(json.dumps(out), file=sys.stderr, flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
