"""The port's native image codec (`sail_tpu_torch/utils/native.py`: the
repository's `native/imagecodec.cpp` built with g++ into `build/native/`)
against the JAX package's image helpers, on the CPU.

The codec's tone map is a 4096-entry LUT indexed by sqrt(x): it equals a
numpy model of that LUT exactly, and lies within 3/255 of
`imageio.to_uint8`'s pow, the bound of the JAX package's own test of its
binding (`tests/test_utils.py::test_png_native_matches_python`; that
binding builds into `native/`, which these tests leave alone).  The
encoder alone turns a uint8 image into a PNG whose pixels are the JAX
package's Python encoder's."""
import os

import numpy as np
import pytest

from sail_tpu.utils import imageio as jimageio
from sail_tpu_torch.utils import build, imageio, native

from test_utils import decode_png_rgb

N_LUT = 4096


def _hdr(seed, shape=(37, 53, 3)):
    """Seeded HDR values over and beyond [0, 1], with the clamp's and the
    LUT's end points among them."""
    img = (np.random.RandomState(seed).rand(*shape) * 1.4 - 0.2) \
        .astype(np.float32)
    img.flat[:6] = (0.0, 1.0, -1.0, 2.0, 1e-8, 0.5)
    return img


def _lut_model(img, gamma=2.2):
    """`tonemap_u8` in numpy float32: lut[i] = (s²)^(1/γ)·255 + ½ at
    s = i/N, indexed by ⌊√x·N + ½⌋ of the clamped x."""
    s = np.arange(N_LUT + 1, dtype=np.float32) / np.float32(N_LUT)
    lut = (np.power(s * s, np.float32(1.0) / np.float32(gamma))
           * np.float32(255.0) + np.float32(0.5)).astype(np.uint8)
    x = np.clip(img, np.float32(0.0), np.float32(1.0))
    return lut[(np.sqrt(x) * np.float32(N_LUT) + np.float32(0.5))
               .astype(np.int32)]


def test_native_codec_builds_into_build_dir():
    assert native.available(), native._error
    libs = os.listdir(build.HOST_BUILD_DIR)
    assert any(n.startswith("libimagecodec-") and n.endswith(".so")
               for n in libs), libs


@pytest.mark.parametrize("gamma", [2.2, 1.0])
def test_tonemap_matches_lut_model_and_jax_bound(gamma):
    img = _hdr(1)
    got = native.tonemap_u8(img, gamma)
    np.testing.assert_array_equal(got, _lut_model(img, gamma))
    py = imageio.to_uint8(img, gamma)
    np.testing.assert_array_equal(py, jimageio.to_uint8(img, gamma))
    assert np.abs(got.astype(int) - py.astype(int)).max() <= 3


def test_native_encoder_gives_the_python_encoders_pixels():
    u8 = imageio.to_uint8(_hdr(2))
    nat = decode_png_rgb(native.encode_png(u8))
    np.testing.assert_array_equal(nat, u8)
    np.testing.assert_array_equal(
        nat, decode_png_rgb(jimageio._png_bytes_py(u8)))
    np.testing.assert_array_equal(nat,
                                  decode_png_rgb(imageio._png_bytes_py(u8)))


def test_png_bytes_takes_the_native_codec():
    img = _hdr(3, (16, 24, 3))
    data = imageio.png_bytes(img)
    assert data == native.png_bytes(img)
    np.testing.assert_array_equal(decode_png_rgb(data),
                                  native.tonemap_u8(img))


def test_python_encoder_where_the_codec_does_not_build(monkeypatch):
    """A host without the toolchain gets the Python encoder's bytes."""
    monkeypatch.setattr(native, "available", lambda: False)
    img = _hdr(4, (8, 8, 3))
    assert imageio.png_bytes(img) == jimageio._png_bytes_py(
        jimageio.to_uint8(img))
