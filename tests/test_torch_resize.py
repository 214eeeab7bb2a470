"""The port's image resize (`sgs_tpu_torch.data.resize`) against PIL's
`Image.resize(size)`, which the JAX package's `load_cam` calls: equal bit
for bit on RGB, RGBA (alpha 0, 1, 128 and 255 mixed with others) and gray
images, at the factors 2, 4 and 8, non-integer downscales, 2000 -> 1600
wide, one axis only, upscales and the same size."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from sgs_tpu_torch.data.resize import resize

torch.set_num_threads(1)


def _image(h, w, c, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    if c == 4:
        img[..., 3] = rng.choice(np.array([0, 1, 128, 255, 7, 200, 254], np.uint8), size=(h, w))
    return img


def _pil(img, size):
    pil = Image.fromarray(img[:, :, 0] if img.shape[2] == 1 else img)
    out = np.asarray(pil.resize(size))
    return out[:, :, None] if out.ndim == 2 else out


CASES = [
    ((64, 80), (40, 32)),     # factor 2
    ((64, 80), (20, 16)),     # factor 4
    ((64, 96), (12, 8)),      # factor 8
    ((50, 37), (16, 21)),     # non-integer both ways
    ((97, 130), (41, 30)),
    ((40, 40), (23, 40)),     # width only
    ((40, 40), (40, 17)),     # height only
    ((30, 30), (61, 45)),     # upscale
    ((9, 17), (3, 200)),      # down one axis, up the other
    ((33, 47), (47, 33)),     # the same size: a copy
    ((12, 2000), (1600, 10)), # 2000 -> 1600 wide, as the 1.6K downscale
]


@pytest.mark.parametrize("channels", [3, 4, 1])
@pytest.mark.parametrize("shape,size", CASES)
def test_resize_equals_pil(shape, size, channels):
    img = _image(*shape, channels, seed=shape[0] * 7 + size[0])
    got = resize(img, size)
    want = _pil(img, size)
    assert got.dtype == np.uint8 and got.shape == want.shape == (size[1], size[0], channels)
    np.testing.assert_array_equal(got, want)


def test_same_size_is_a_copy():
    img = _image(6, 5, 4, 0)
    out = resize(img, (5, 6))
    np.testing.assert_array_equal(out, img)
    out[0, 0, 0] ^= 1
    assert out[0, 0, 0] != img[0, 0, 0]


@pytest.mark.parametrize("bad", [np.zeros((4, 4, 2), np.uint8), np.zeros((4, 4, 3), np.uint16),
                                 np.zeros((4, 4), np.uint8)])
def test_other_images_raise(bad):
    with pytest.raises(ValueError, match="resize takes"):
        resize(bad, (2, 2))


@settings(max_examples=60, deadline=None, database=None)
@given(h=st.integers(1, 64), w=st.integers(1, 64), oh=st.integers(1, 64), ow=st.integers(1, 64),
       rgba=st.booleans(), seed=st.integers(0, 2**16))
def test_resize_equals_pil_any_size(h, w, oh, ow, rgba, seed):
    img = _image(h, w, 4 if rgba else 3, seed)
    np.testing.assert_array_equal(resize(img, (ow, oh)), _pil(img, (ow, oh)))
