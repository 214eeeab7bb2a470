"""The port's JPEG decoder (`sgs_tpu_torch.data.jpeg`, the plain version)
against PIL on the CPU, bit for bit:

- on JPEGs that PIL writes in the test, drawn by hypothesis: 1-40 x 1-40
  pixels, quality 1-100, subsampling 4:4:4, 4:2:2, 4:2:0 and PIL's
  "4:1:1" (which PIL writes as 4:2:0), grayscale, restart intervals in
  blocks or rows, optimised Huffman tables; the same progressive, with
  all its scans or only the first few (libjpeg's block smoothing then
  estimates the unknown low coefficients);
- on progressive JPEGs of drawn scan scripts (`jpeg_fixtures.random_script`:
  DC scans together or apart, AC bands of uneven width, point transforms
  up to 3, refinements in any legal order, chains left unfinished), every
  sampling the port decodes, restart intervals;
- on every committed case in data/jpeg_cases (tests/jpeg_fixtures.py
  writes them: the samplings PIL cannot write, one scan per component, a
  16-bit quantisation table, progressive files from PIL and from the
  fixtures' encoder, scans whose data ends early, the 4946x3286 frame
  baseline and progressive), and on their PIL digests in digests.json;
- progressions libjpeg only warns about (an AC scan before the DC one, a
  refinement that skips a bit, a first scan repeated) against PIL;
- the islow IDCT on blocks far out of range (its 16-bit lanes and
  saturation) against PIL;
- an arithmetic-coded progressive, a CMYK, a lossless, an arithmetic-coded,
  a 12-bit, a truncated and a truncated progressive file, and a bad
  progression, raise a ValueError naming the file (and the marker).
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

import jpeg_fixtures as fixtures
from jpeg_fixtures import CASES, encode_progressive, keep_scans, pil_bytes, random_script, sample_image
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


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 40), w=st.integers(1, 40), quality=st.integers(1, 100),
       sampling=st.sampled_from(["4:4:4", "4:2:2", "4:2:0", "4:1:1", "gray"]),
       restart=st.sampled_from([None, ("restart_marker_blocks", 1), ("restart_marker_blocks", 3),
                                ("restart_marker_rows", 1), ("restart_marker_rows", 2)]),
       keep=st.one_of(st.none(), st.integers(1, 9)), seed=st.integers(0, 2**16))
def test_plain_equals_pil_progressive(h, w, quality, sampling, restart, keep, seed):
    gray = sampling == "gray"
    kw = {"quality": quality, "progressive": True}
    if not gray:
        kw["subsampling"] = sampling
    if restart:
        kw[restart[0]] = restart[1]
    data = pil_bytes(sample_image(h, w, seed, gray=gray), **kw)
    if keep is not None:
        data = keep_scans(data, min(keep, 5 if gray else 9))
    want = _pil(data)
    got = jpeg.decode_plain(data, "drawn.jpg")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


SAMPLINGS = [[(1, 1)] * 3, [(2, 1), (1, 1), (1, 1)], [(2, 2), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)],
             [(4, 1), (1, 1), (1, 1)], [(1, 1), (2, 2), (2, 2)], [(2, 2), (1, 2), (1, 2)], [(1, 1)], [(2, 2)]]


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 40), w=st.integers(1, 40), sampling=st.sampled_from(SAMPLINGS),
       scale=st.floats(0.05, 2.5), complete=st.booleans(), restart=st.sampled_from([0, 1, 2, 5]),
       seed=st.integers(0, 2**16))
def test_plain_equals_pil_on_drawn_scripts(h, w, sampling, scale, complete, restart, seed):
    rng = np.random.default_rng(seed)
    script = random_script(rng, len(sampling), complete=complete)
    data = encode_progressive(sample_image(h, w, seed, gray=len(sampling) == 1), sampling, script,
                              quality_scale=scale, restart=restart)
    np.testing.assert_array_equal(jpeg.decode_plain(data, "drawn.jpg"), _pil(data))


@pytest.mark.parametrize("script", [
    [([0], 1, 63, 0, 0), ([0, 1, 2], 0, 0, 0, 0), ([1], 1, 63, 0, 0), ([2], 1, 63, 0, 0)],
    [([0, 1, 2], 0, 0, 0, 2), ([0, 1, 2], 0, 0, 1, 0), ([0], 1, 63, 0, 3), ([0], 1, 63, 1, 0),
     ([1], 1, 63, 0, 0), ([2], 1, 63, 0, 0)],
    [([0, 1, 2], 0, 0, 0, 1), ([0, 1, 2], 0, 0, 0, 1), ([0], 1, 63, 0, 1), ([0], 1, 63, 0, 1), ([1], 1, 63, 0, 0)],
], ids=["ac_before_dc", "refinement_skips_a_bit", "first_scan_twice"])
def test_bogus_progressions_decode_as_pil(script):
    """Scans that do not continue the coefficients' progression: libjpeg
    warns and decodes them, and so does the port."""
    data = encode_progressive(sample_image(37, 45, 3), [(2, 2), (1, 1), (1, 1)], script)
    np.testing.assert_array_equal(jpeg.decode_plain(data, "bogus.jpg"), _pil(data))


@pytest.mark.parametrize("q,rows", [(64, 8), (255, 8), (36, 1)])
def test_idct_out_of_range_equals_pil(q, rows):
    """Coefficients no encoder writes (as data that ran out leaves them):
    the 16-bit dequantisation and sums, pass 1's saturation (or, for
    blocks whose rows 1-7 are zero, its 16-bit shift) and the final clamp
    are those of the SIMD IDCT that PIL runs."""
    rng = np.random.default_rng(q)
    blocks = rng.integers(-1023, 1024, (8, 8, 8, 8))
    blocks[:, :, rows:, :] = 0
    blocks[:, :, 0, 0] = rng.integers(-1000, 1001, (8, 8))
    data = encode_progressive(np.zeros((64, 64), np.uint8), [(1, 1)], fixtures.simple_script(1),
                              blocks=[blocks.reshape(8, 8, 64)])
    i = data.index(b"\xff\xdb")
    data = data[:i + 5] + bytes([q] * 64) + data[i + 69:]  # every quantiser q
    want = _pil(data)
    assert (want == 0).mean() > 0.2 and (want == 255).mean() > 0.2
    np.testing.assert_array_equal(jpeg.decode_plain(data), want)


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


def _patch_sof(data: bytes, marker: int = None, precision: int = None, sof: int = 0xC0) -> bytes:
    i = data.index(bytes([0xFF, sof]))
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("kind,match", [
    ("progressive", "arithmetic-coded progressive.*0xFFCA"),
    ("cmyk", "CMYK"),
    ("lossless", "lossless.*0xFFC3"),
    ("arithmetic", "arithmetic.*0xFFC9"),
    ("12bit", "12-bit"),
    ("truncated", "truncated"),
    ("truncated_progressive", "truncated"),
    ("bad_progression", "bad progression"),
])
def test_unsupported_files_raise(tmp_path, kind, match):
    path = str(tmp_path / f"{kind}.jpg")
    img = sample_image(12, 20, 4)
    if kind == "progressive":  # arithmetic coding: the SOF2 marker made SOF10
        data = _patch_sof(pil_bytes(img, quality=90, progressive=True), marker=0xCA, sof=0xC2)
    elif kind == "truncated_progressive":
        data = pil_bytes(img, quality=90, progressive=True)
        data = data[:len(data) // 2]
    elif kind == "bad_progression":  # an AC scan over two components
        data = encode_progressive(img, [(1, 1)] * 3, [([0, 1, 2], 0, 0, 0, 0), ([0, 1], 1, 63, 0, 0)])
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
    if kind in ("truncated", "truncated_progressive", "bad_progression"):
        with pytest.raises(OSError):  # PIL refuses them too
            _pil(data)


def test_fill_bytes_and_stuffing():
    """0xFF fill bytes before a restart marker and before EOI are skipped,
    as libjpeg skips them."""
    data = pil_bytes(sample_image(40, 40, 5), quality=95, restart_marker_blocks=2)
    padded = data.replace(b"\xff\xd1", b"\xff\xff\xff\xd1").replace(b"\xff\xd9", b"\xff\xff\xd9")
    assert padded != data
    np.testing.assert_array_equal(jpeg.decode_plain(padded), _pil(data))
    np.testing.assert_array_equal(_pil(padded), _pil(data))

