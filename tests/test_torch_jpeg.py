"""The port's JPEG decoder (`sgs_tpu_torch.data.jpeg`, the plain version)
against PIL on the CPU, bit for bit:

- on JPEGs that PIL writes in the test, drawn by hypothesis: 1-40 x 1-40
  pixels, quality 1-100, subsampling 4:4:4, 4:2:2, 4:2:0 and PIL's
  "4:1:1" (which PIL writes as 4:2:0), grayscale, restart intervals in
  blocks or rows, optimised Huffman tables;
- on every committed case in data/jpeg_cases (tests/jpeg_fixtures.py
  writes them: the samplings PIL cannot write, one scan per component, a
  16-bit quantisation table, the 4946x3286 frame), and on their PIL
  digests in digests.json;
- a progressive, a CMYK, a lossless, an arithmetic-coded, a 12-bit and a
  truncated file raise a ValueError naming the file (and the marker).
The native decoder (`ops/jpeg.py`, host C++ built with nvcc) is held to
the plain one and the digests on the card by tests/test_torch_cuda.py.
"""

import hashlib
import io
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from jpeg_fixtures import CASES, pil_bytes, sample_image
from sgs_tpu_torch.data import jpeg

torch.set_num_threads(1)
DIGESTS = json.load(open(os.path.join(CASES, "digests.json")))


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


@settings(max_examples=80, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 40), w=st.integers(1, 40), quality=st.integers(1, 100),
       sampling=st.sampled_from(["4:4:4", "4:2:2", "4:2:0", "4:1:1", "gray"]),
       restart=st.sampled_from([None, ("restart_marker_blocks", 1), ("restart_marker_blocks", 3),
                                ("restart_marker_rows", 1), ("restart_marker_rows", 2)]),
       optimize=st.booleans(), seed=st.integers(0, 2**16))
def test_plain_equals_pil(h, w, quality, sampling, restart, optimize, seed):
    gray = sampling == "gray"
    kw = {"quality": quality, "optimize": optimize}
    if not gray:
        kw["subsampling"] = sampling
    if restart:
        kw[restart[0]] = restart[1]
    data = pil_bytes(sample_image(h, w, seed, gray=gray), **kw)
    want = _pil(data)
    got = jpeg.decode_plain(data, "drawn.jpg")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_plain_equals_pil_on_committed_cases(name):
    path = os.path.join(CASES, name)
    want = np.asarray(Image.open(path))
    digest = DIGESTS[name]
    assert list(want.shape) == digest["shape"]
    assert hashlib.sha256(want.tobytes()).hexdigest() == digest["sha256"]
    got = jpeg.read_jpeg(path)
    np.testing.assert_array_equal(got, want)


def _baseline(gray=False) -> bytes:
    return pil_bytes(sample_image(12, 20, 3, gray=gray), quality=90)


def _patch_sof(data: bytes, marker: int = None, precision: int = None) -> bytes:
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("kind,match", [
    ("progressive", "progressive.*0xFFC2"),
    ("cmyk", "CMYK"),
    ("lossless", "lossless.*0xFFC3"),
    ("arithmetic", "arithmetic.*0xFFC9"),
    ("12bit", "12-bit"),
    ("truncated", "truncated"),
])
def test_unsupported_files_raise(tmp_path, kind, match):
    path = str(tmp_path / f"{kind}.jpg")
    img = sample_image(12, 20, 4)
    if kind == "progressive":
        data = pil_bytes(img, quality=90, progressive=True)
    elif kind == "cmyk":
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    elif kind == "lossless":
        data = _patch_sof(_baseline(), marker=0xC3)
    elif kind == "arithmetic":
        data = _patch_sof(_baseline(), marker=0xC9)
    elif kind == "12bit":
        data = _patch_sof(_baseline(), precision=12)
    else:
        data = _baseline()[:300]
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=match) as err:
        jpeg.read_jpeg(path)
    assert path in str(err.value)


def test_fill_bytes_and_stuffing():
    """0xFF fill bytes before a restart marker and before EOI are skipped,
    as libjpeg skips them."""
    data = pil_bytes(sample_image(40, 40, 5), quality=95, restart_marker_blocks=2)
    padded = data.replace(b"\xff\xd1", b"\xff\xff\xff\xd1").replace(b"\xff\xd9", b"\xff\xff\xd9")
    assert padded != data
    np.testing.assert_array_equal(jpeg.decode_plain(padded), _pil(data))
    np.testing.assert_array_equal(_pil(padded), _pil(data))

