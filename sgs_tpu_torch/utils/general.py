"""General helpers. Port of `sgs_tpu/utils/general.py`.

`safe_state(silent, seed)` wraps `sys.stdout` so that every line printed
ends with a ` [DD/MM HH:MM:SS]` stamp (nothing is written when `silent`,
the CLIs' --quiet), and seeds `random`, numpy's global state and torch.
It returns the stream it wrapped; `stamped(silent, seed)` is the same as a
context manager that puts that stream back, so a CLI run inside another
program (`chip_smoke.py`, the tests) leaves its `sys.stdout` as it was.
"""

from __future__ import annotations

import contextlib
import random
import sys
from datetime import datetime

import numpy as np
import torch


class StampedStdout:
    """The JAX package's stdout wrapper: a stamp before each newline."""

    def __init__(self, out, silent: bool):
        self.out = out
        self.silent = silent

    def write(self, x):
        if not self.silent:
            if x.endswith("\n"):
                self.out.write(x.replace("\n", " [{}]\n".format(datetime.now().strftime("%d/%m %H:%M:%S"))))
            else:
                self.out.write(x)

    def flush(self):
        self.out.flush()

    def __getattr__(self, name):
        return getattr(self.out, name)


def safe_state(silent: bool, seed: int = 0):
    """Stamp stdout, seed random, numpy and torch; returns the old stdout."""
    old = sys.stdout
    sys.stdout = StampedStdout(old, silent)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return old


@contextlib.contextmanager
def stamped(silent: bool, seed: int = 0):
    old = safe_state(silent, seed)
    try:
        yield
    finally:
        sys.stdout = old
