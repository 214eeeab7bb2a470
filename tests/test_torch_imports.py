"""The port imports nothing of JAX, flax, optax, PIL, tensorboard or
sgs_tpu: with those blocked, every module of sgs_tpu_torch and the
chip_smoke script still import (the card's machine has none of them)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "PIL", "sgs_tpu", "tensorboard")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import sgs_tpu_torch

names = ["sgs_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(sgs_tpu_torch.__path__, "sgs_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401  (imports only; main() is not run)

leaked = sorted(m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("imported", len(names), "modules")
"""


def test_port_imports_without_jax_or_pil():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0, res.stderr
    n = int(res.stdout.split()[1])
    assert n >= 20, res.stdout


def test_blocker_blocks():
    """The probe's finder really refuses a blocked name (here `sgs_tpu`)."""
    code = _PROBE.split("sys.meta_path.insert(0, Block())")[0] + (
        "sys.meta_path.insert(0, Block())\n"
        "try:\n    import sgs_tpu.core.sh\nexcept ImportError:\n    print('blocked')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120,
    )
    assert res.stdout.strip() == "blocked", res.stdout + res.stderr
