"""The port's numpy oracle (`sail_tpu_torch/oracle/cpu_tracer.py`) against
the JAX package's (`sail_tpu/oracle/cpu_tracer.py`): BASELINE configs 1–4
at 8², each package's oracle on its own package's build of the scene, with
the same uniform fields (`tests/test_oracle_parity.make_rand`).  Both are
numpy over the same host-class attributes and constants, so the camera
rays and the radiance must agree bit for bit."""
import numpy as np
import pytest

from sail_tpu import scenes as jscenes
from sail_tpu.oracle import cpu_tracer as joracle
from sail_tpu_torch import scenes as tscenes
from sail_tpu_torch.oracle import cpu_tracer as toracle

from test_oracle_parity import make_rand

SIZE = 8
CONFIGS = {"config1": ("cornell_matte", 3), "config2": ("cornell_mirror", 4),
           "config3": ("material_demo", 3),
           "config4": ("lights_and_quadrics", 3)}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_oracle_matches_jax_oracle(config):
    name, bounces = CONFIGS[config]
    jscene = getattr(jscenes, name)()
    tscene = getattr(tscenes, name)()
    rand = make_rand((SIZE, SIZE), len(tscene.lights), bounces, 0)
    jro, jrd = joracle.camera_rays(jscene.camera, SIZE, SIZE)
    tro, trd = toracle.camera_rays(tscene.camera, SIZE, SIZE)
    np.testing.assert_array_equal(tro, jro)
    np.testing.assert_array_equal(trd, jrd)
    want = joracle.trace(jscene, jro, jrd, rand, max_bounces=bounces)
    got = toracle.trace(tscene, tro, trd, rand, max_bounces=bounces)
    assert np.isfinite(got).all() and got.mean() > 0.01
    np.testing.assert_array_equal(got, want)
