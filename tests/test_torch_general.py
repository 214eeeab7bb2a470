"""`sgs_tpu_torch.utils.general.safe_state` against the JAX package's: the
same ` [DD/MM HH:MM:SS]` stamp before each newline, nothing written when
silent (--quiet), the same `random` and numpy draws after seeding, torch
seeded too, and `stamped` putting the old stdout back; the CLIs that call
it (train, train_lgm, render, get_psnr) leave sys.stdout as they found it."""

import io
import random
import re
import sys

import numpy as np
import pytest
import torch

from sgs_tpu.utils import general as jax_general
from sgs_tpu_torch.utils import general

torch.set_num_threads(1)
STAMP = re.compile(r"^(.*) \[(\d\d)/(\d\d) (\d\d):(\d\d):(\d\d)\]$")


def _printed(fn, silent, text):
    old = sys.stdout
    buf = io.StringIO()
    sys.stdout = buf
    try:
        fn(silent)
        for line in text:
            print(line)
        print("partial", end="")
        sys.stdout.flush()
    finally:
        sys.stdout = old
    return buf.getvalue()


def test_stamp_format_matches_jax():
    got = _printed(general.safe_state, False, ["line one", "line two"])
    want = _printed(jax_general.safe_state, False, ["line one", "line two"])
    strip = re.compile(r" \[\d\d/\d\d \d\d:\d\d:\d\d\]")
    assert strip.sub("", got) == strip.sub("", want) == "line one\nline two\npartial"
    lines = got.split("\n")[:2]
    for line, text in zip(lines, ["line one", "line two"]):
        m = STAMP.match(line)
        assert m and m.group(1) == text
        day, month = int(m.group(2)), int(m.group(3))
        assert 1 <= day <= 31 and 1 <= month <= 12


def test_quiet_prints_nothing():
    assert _printed(general.safe_state, True, ["hidden"]) == ""
    assert _printed(jax_general.safe_state, True, ["hidden"]) == ""


def test_seeds_like_jax():
    _printed(jax_general.safe_state, True, [])
    want = (random.random(), np.random.random(3).tolist())
    _printed(general.safe_state, True, [])
    got = (random.random(), np.random.random(3).tolist())
    assert got == want
    t = torch.rand(2)
    torch.manual_seed(0)
    assert torch.equal(t, torch.rand(2))


def test_stamped_restores_stdout():
    before = sys.stdout
    with general.stamped(True):
        assert isinstance(sys.stdout, general.StampedStdout)
        print("hidden")
    assert sys.stdout is before


@pytest.mark.parametrize("cli", ["render", "get_psnr"])
def test_cli_puts_stdout_back(cli, tmp_path):
    """A CLI that fails inside the stamped block still restores stdout."""
    before = sys.stdout
    if cli == "render":
        from sgs_tpu_torch.render.cli import main

        argv = ["-m", str(tmp_path / "none"), "-s", str(tmp_path / "none"), "--quiet", "--device", "cpu"]
    else:
        from sgs_tpu_torch.get_psnr import main

        argv = ["-s", str(tmp_path / "none"), "--start_checkpoint", "x.npz", "--quiet", "--device", "cpu"]
    with pytest.raises(Exception):
        main(argv)
    assert sys.stdout is before
