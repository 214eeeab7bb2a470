"""Build hand-written CUDA sources with nvcc and load them with ctypes.

Each source in `sgs_tpu_torch/csrc/` exposes `extern "C"` launchers that
take `void*` pointers, ints and a `cudaStream_t` and return
`cudaGetLastError()`. At first use it is compiled for sm_90a into a shared
library under `build/sgs_tpu_torch/` at the repository root, named by a
hash of the source, the headers it includes from its own directory, the
flags and `nvcc --version`. The library is written
under a temporary name and renamed, so concurrent builds never load a
half-written file; nvcc's own scratch files go to `build/sgs_tpu_torch/tmp`,
so a build writes nothing outside the repository. Importing this module
needs no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sgs_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ctypes argument kinds of the launchers: pointers and the stream are
# c_void_p (a plain int would be cut to 32 bits), sizes are c_int.
PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")


class CudaKernel:
    """One CUDA source: its build, its loaded library and its launch count.

    `launches` counts the wrapper calls that launched the source's kernels:
    a wrapper that launches two kernels for one result passes count=False
    to the first. Callers reset it to 0 to count one run.
    """

    def __init__(self, source: str, functions: Dict[str, Sequence], extra_flags: Iterable[str] = ()):
        self.source = CSRC_DIR / source
        self.functions = dict(functions)
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib = None
        self._tickets = {}

    def library_path(self, nvcc: str) -> Path:
        version = subprocess.run(
            [nvcc, "--version"], check=True, capture_output=True, text=True
        ).stdout
        h = hashlib.sha256()
        text = self.source.read_bytes()
        h.update(text)
        for name in re.findall(rb'^#include "([^"]+)"', text, re.M):
            h.update((self.source.parent / name.decode()).read_bytes())
        h.update("\0".join(self.flags).encode())
        h.update(version.encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _start_build(self):
        """Start nvcc if the library is not built yet; returns the job."""
        nvcc = nvcc_path()
        out = self.library_path(nvcc)
        if out.exists():
            return out, None, None, None
        scratch = BUILD_DIR / "tmp"
        scratch.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc, *self.flags, "-o", str(tmp), str(self.source)]
        env = dict(os.environ, TMPDIR=str(scratch))
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env
        )
        return out, tmp, proc, time.perf_counter()

    def _finish_build(self, job) -> Path:
        out, tmp, proc, t0 = job
        if proc is None:
            return out
        stdout, stderr = proc.communicate()
        self.build_seconds = time.perf_counter() - t0
        self.build_log = stdout + stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{self.build_log}")
        os.replace(tmp, out)
        return out

    def _load(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        for name, argtypes in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        self._lib = lib

    def lib(self):
        if self._lib is None:
            self._load(self._finish_build(self._start_build()))
        return self._lib

    def ticket(self, dev):
        """This source's block counter on `dev` for a cross-block sum:
        allocated and zeroed once; each launch's last block resets it.
        Two launches running at once on two streams must not share it; the
        port launches on one stream."""
        if dev not in self._tickets:
            import torch

            self._tickets[dev] = torch.zeros((), dtype=torch.int32, device=dev)
        return self._tickets[dev]

    def launch(self, name: str, *args, count: bool = True) -> None:
        """Call launcher `name`; raise if it reports a CUDA error."""
        rc = getattr(self.lib(), name)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.source.name}:{name} failed with CUDA error {rc}")
        if count:
            self.launches += 1


class LaunchCount:
    """The launch count of one of several kernels that share a source."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


def build_all(kernels: Sequence[CudaKernel]) -> None:
    """Build every kernel not built yet, with one nvcc per source running
    together, and load them. Waits for every nvcc it started."""
    jobs = [(k, k._start_build()) for k in kernels if k._lib is None]
    errors = []
    for k, job in jobs:
        try:
            k._load(k._finish_build(job))
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
