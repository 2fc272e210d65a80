"""The port's host utilities and top-level API against the JAX package's:
`Matrix` and `Vector` on the cases of tests/test_matrix.py (equal values),
the PNG and PPM writers byte for byte against JAX's Python encoder,
`vec3` and `generate_rays`, and the two `__all__` lists."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sail_tpu as jsail
from sail_tpu.core import camera as jcam
from sail_tpu.utils import imageio as jimageio
import sail_tpu_torch as sail
from sail_tpu_torch.core import camera as tcam
from sail_tpu_torch.utils import imageio

torch.set_num_threads(1)


def _value(x):
    """A comparable value: elements of a Vector or Matrix, else as is."""
    if hasattr(x, "elements"):
        return ("elements", x.elements.tolist())
    if isinstance(x, (list, tuple)):
        return type(x)(_value(v) for v in x)
    if isinstance(x, dict):
        return {k: _value(v) for k, v in x.items()}
    return x


# Each case maps the module's (Matrix, Vector) to a tuple of values; the
# cases of tests/test_matrix.py.
MATRIX_CASES = {
    "vector_accessors": lambda M, V: (
        V([1.0, 2.0, 3.0]).e(1), V([1.0, 2.0, 3.0]).e(3),
        V([1.0, 2.0, 3.0]).e(0), V([1.0, 2.0, 3.0]).e(4),
        (V([1, 2, 3]).x, V([1, 2, 3]).y, V([1, 2, 3]).z),
        V([1, 2, 3]).dimensions()),
    "vector_algebra": lambda M, V: (
        V([1, 2, 2]).modulus(), V([1, 2, 2]).length(),
        V([1, 2, 2]).dot(V([3, 0, 4])), V([1, 2, 2]).add(V([3, 0, 4])),
        V([1, 2, 2]).subtract(V([3, 0, 4])), V([1, 2, 2]).multiply(2),
        V([1, 2, 2]).divide(2), V([1, 2, 2]) + V([3, 0, 4]),
        V([1, 2, 2]) - V([3, 0, 4]), V([1, 2, 2]) * 3,
        V([1, 0, 0]).cross([0, 1, 0]), V([1, 2]).cross([0, 1]),
        V([1, 2, 2]).toUnitVector(), V([0, 0, 0]).toUnitVector(),
        V([1, 0]).angleFrom(V([0, 1])), V([0, 0]).angleFrom(V([0, 1])),
        V([3, 0, 4]).distanceFrom(V([3, 0, 0])),
        V([1, 2, 2]).eql(V([1, 2, 2 + 1e-7])), V([1, 2]).eql(V([1, 2, 3]))),
    "vector_components": lambda M, V: (
        V([2.0, -1.0, 4.0]).maxComponent(), V([2.0, -1.0, 4.0]).minComponent(),
        V([2.0, -1.0, 4.0]).componentDivide(V([2, 1, 4])),
        V([2.0, -1.0, 4.0]).componentDivide(V([1, 2])),
        V([2, 4, 6, 2]).divideByW(), V.min([1, 5, 3], [2, 2, 2]),
        V.max([1, 5, 3], [2, 2, 2]), V.Zero(4), V.create([1, 2]).flatten()),
    "vector_map_dup": lambda M, V: (
        V([1, 2, 3]).dup(), V([1, 2, 3]).map(lambda x: x * 2),
        V([1, 2, 3]).map(lambda x, i: x * i), repr(V([1, 2]))),
    "matrix_accessors": lambda M, V: (
        M.I(3).e(1, 1), M.I(3).e(1, 2), M.I(3).e(0, 1), M.I(3).e(4, 1),
        M.I(3).row(2), M.I(3).col(3), M.I(3).dimensions(), M.I(3).isSquare(),
        M.I(3).isSingular(), M([1, 2, 3]).dimensions(), M.I(2).dup()),
    "matrix_multiply": lambda M, V: (
        M.Translation(V([1, 2, 3])).multiply(V([0, 0, 0, 1])),
        M.Translation(V([1, 2, 3])) @ V([0, 0, 0, 1]),
        M.Translation(V([1, 2, 3])).multiply(2).e(1, 4),
        M([[1, 2], [3, 4]]).multiply(M.I(2)),
        M([[1, 2], [3, 4]]).x(M([[0, 1], [1, 0]])),
        M([[1, 2], [3, 4]]).add(M.I(2)),
        M([[1, 2], [3, 4]]).subtract(M.I(2))),
    "matrix_rotations": lambda M, V: (
        *(rot(0.7) for rot in (M.RotationX, M.RotationY, M.RotationZ)),
        *(rot(0.7).multiply(rot(0.7).transpose()).eql(M.I(3))
          for rot in (M.RotationX, M.RotationY, M.RotationZ)),
        M.RotationX(0.7).determinant(), M.Rotation(0.7, V([0, 0, 1])),
        M.Rotation(0.7, V([1, 2, 3])), M.Rotation(0.7, V([1, 2])),
        M.Rotation(np.pi / 2).multiply(V([1, 0])),
        M.RotationZ(np.pi / 2).multiply(V([1, 0, 0]))),
    "matrix_scale_translation": lambda M, V: (
        M.Scale(V([2, 3, 4])), M.Scale(V([2, 3])),
        M.Scale(V([2, 3, 4])).multiply(V([1, 1, 1, 1])),
        M.Translation(V([5, 6, 7])), M.Translation(V([5, 6]))),
    "matrix_inverse_det_trace": lambda M, V: (
        M([[2, 0, 0], [0, 4, 0], [0, 0, 8]]).determinant(),
        M([[2, 0, 0], [0, 4, 0], [0, 0, 8]]).det(),
        M([[2, 0, 0], [0, 4, 0], [0, 0, 8]]).trace(),
        M([[2, 0, 0], [0, 4, 0], [0, 0, 8]]).tr(),
        M([[2, 0, 0], [0, 4, 0], [0, 0, 8]]).inverse(),
        M.Zero(2, 2).inverse(), M([[1, 2, 3], [2, 4, 6], [1, 1, 1]]).isSingular(),
        M([[1, 2], [3, 4], [5, 6]]).inverse(), M([[1, 2], [3, 4]]).rank(),
        M([[1, -7], [3, 4]]).max(), M([[1.4, 2.6], [3, 4]]).round(),
        M.Diagonal([1, 2]), M.create([[1, 2]])),
    "matrix_flatten_map": lambda M, V: (
        M([[1, 2], [3, 4]]).flatten(), M([[1, 2], [3, 4]]).map(lambda v: -v),
        M([[1, 2], [3, 4]]).map(lambda v, i, j: v * i + j),
        repr(M([[1, 2]]))),
    "matrix_transform_chain": lambda M, V: (
        M.Translation(V([1, 0, 0])).multiply(M.Scale(V([2, 2, 2])))
        .multiply(V([1, 1, 1, 1])),),
}


@pytest.mark.parametrize("case", sorted(MATRIX_CASES))
def test_matrix_vector_match_jax(case):
    fn = MATRIX_CASES[case]
    assert _value(fn(sail.Matrix, sail.Vector)) == _value(
        fn(jsail.Matrix, jsail.Vector))


def test_matrix_rejects_what_jax_rejects():
    for lib in (sail, jsail):
        with pytest.raises(ValueError):
            lib.Vector([[1, 2]])
        with pytest.raises(ValueError):
            lib.Matrix(np.zeros((2, 2, 2)))


def _img(seed, h=13, w=17):
    r = np.random.RandomState(seed)
    return (r.rand(h, w, 3) * 1.4 - 0.2).astype(np.float32)


@pytest.mark.parametrize("gamma", [2.2, 1.0])
def test_png_bytes_equal_jax_python_encoder(gamma, tmp_path, monkeypatch):
    """On a host without the native codec (g++), `png_bytes` and
    `write_png` give the JAX package's Python encoder's bytes; where it
    builds they take it, as JAX's do (tests/test_torch_native.py)."""
    from sail_tpu_torch.utils import native
    monkeypatch.setattr(native, "available", lambda: False)
    img = _img(0)
    want = jimageio._png_bytes_py(jimageio.to_uint8(img, gamma))
    assert imageio._png_bytes_py(imageio.to_uint8(img, gamma)) == want
    assert imageio.png_bytes(img, gamma) == want
    np.testing.assert_array_equal(imageio.to_uint8(img, gamma),
                                  jimageio.to_uint8(img, gamma))
    imageio.write_png(str(tmp_path / "a.png"), img, gamma)
    assert (tmp_path / "a.png").read_bytes() == want


def test_ppm_equals_jax(tmp_path):
    img = _img(1)
    imageio.write_ppm(str(tmp_path / "a.ppm"), img)
    jimageio.write_ppm(str(tmp_path / "b.ppm"), img)
    assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes()


def test_all_equals_jax_but_elastic_renderer():
    """The two lists are equal, `ElasticRenderer` included."""
    assert sail.__all__ == jsail.__all__
    assert "ElasticRenderer" in sail.__all__
    for name in sail.__all__:
        assert getattr(sail, name) is not None, name
    assert sail.Scale is sail.ScaleT


def test_vec3_matches_jax():
    got = sail.vec3(1, 2.5, torch.tensor(3.0), device="cpu")
    want = jsail.vec3(1, 2.5, jnp.float32(3.0))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("jitter", [False, True])
def test_generate_rays_matches_jax(jitter):
    cam = ((1.3, 0.7, -2.0), (0.1, -0.2, 0.4), (0.0, 1.0, 0.0), 40.0, 1.5)
    h, w = 6, 9
    r = np.random.RandomState(2)
    jx, jy = (r.rand(h, w).astype(np.float32) for _ in range(2))
    targs = (torch.from_numpy(jx), torch.from_numpy(jy)) if jitter else ()
    jargs = (jnp.asarray(jx), jnp.asarray(jy)) if jitter else ()
    ro, rd = tcam.generate_rays(tcam.make_camera(*cam, device="cpu"), h, w,
                                *targs, device="cpu")
    jro, jrd = jcam.generate_rays(jcam.make_camera(*cam), h, w, *jargs)
    for a, b in zip((*ro, *rd), (*jro, *jrd)):
        assert a.shape == (h, w)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)
