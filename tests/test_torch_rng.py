"""The port's counter-based RNG is bit-exact with the JAX package's: same
stream ids and the same float32 uniforms for every (seed, sample, bounce,
tag, pixel), including negative and extreme int32 seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sail_tpu.core import rng as jrng
from sail_tpu_torch.core import rng as trng

torch.set_num_threads(1)

SEEDS = [0, 7, -1, -123456789, 2**31 - 1, -2**31, 1234567891]
SAMPLES = [0, 1, 63, 1000, 2**31 - 1]


def _as_int32(t) -> np.ndarray:
    """uint32 words held in int64 (or a Python int) -> the JAX package's
    int32 bit patterns."""
    return np.asarray(t, dtype=np.int64).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("tag", range(6))
def test_stream_bit_exact(tag):
    seed, sample = np.meshgrid(np.array(SEEDS, np.int64),
                               np.array(SAMPLES, np.int64), indexing="ij")
    for bounce in range(5):
        want = np.asarray(jrng.stream(jnp.asarray(seed, jnp.int32),
                                      jnp.asarray(sample, jnp.int32),
                                      bounce, tag))
        got = trng.stream(torch.from_numpy(seed), torch.from_numpy(sample),
                          bounce, tag)
        np.testing.assert_array_equal(_as_int32(got), want)
        # scalar (Python int) arguments, as the renderer passes them
        for s, n in ((SEEDS[3], SAMPLES[2]), (SEEDS[5], SAMPLES[4])):
            np.testing.assert_array_equal(
                _as_int32(trng.stream(s, n, bounce, tag)),
                np.asarray(jrng.stream(s, n, bounce, tag)))


@pytest.mark.parametrize("seed", SEEDS)
def test_pixel_uniform3_bit_exact(seed):
    """All bounces and tags of one sample on a 64² grid, through PixelNoise."""
    ii, jj = np.meshgrid(np.arange(64, dtype=np.int32),
                         np.arange(64, dtype=np.int32), indexing="ij")
    ii = ii + 960            # global rows of a tile deep in a 1024² image
    jnoise = jrng.pixel_noise(seed, 17, ii=jnp.asarray(ii), jj=jnp.asarray(jj))
    tnoise = trng.PixelNoise(seed, 17, torch.from_numpy(ii),
                             torch.from_numpy(jj))
    for bounce in range(5):
        for tag in range(6):
            want = jnoise.uniform3(bounce, tag)
            got = tnoise.uniform3(bounce, tag)
            for w, g in zip(want, got):
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_uniforms_in_unit_interval():
    ii = torch.arange(4096).reshape(64, 64)
    u = trng.pixel_uniform3(trng.stream(-5, 3, 2, trng.TAG_BSDF), ii, ii.T)
    for x in u:
        assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
