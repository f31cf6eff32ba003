"""Static u8 warps (affine, perspective, polar) vs the ref oracle:
bitwise for linear and nearest interpolation under both borders,
including constant-border partial footprints and large-spread maps.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from imageenhancement_mp_tpu.ref import ops as ref
from imageenhancement_mp_tpu.ops.warp import (warp_affine_planes,
                                              warp_perspective_planes)


def _img(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def test_bilinear_replicate_bitwise_vs_oracle():
    img = _img((2, 64, 80))
    M = ref.get_rotation_matrix_2d((40.0, 32.0), 15.0, 1.0)
    exp = np.stack([ref.warp_affine(p, M, (60, 72), border="replicate")
                    for p in img])
    got = np.asarray(warp_affine_planes(jnp.asarray(img), M, (60, 72),
                                        border="replicate"))
    np.testing.assert_array_equal(got, exp)


def test_nearest_replicate_bitwise_vs_oracle():
    img = _img((1, 50, 70), seed=3)
    M = ref.get_rotation_matrix_2d((35.0, 25.0), -23.0, 0.9)
    exp = ref.warp_affine(img[0], M, (50, 70), interpolation="nearest",
                          border="replicate")[None]
    got = np.asarray(warp_affine_planes(jnp.asarray(img), M, (50, 70),
                                        interpolation="nearest",
                                        border="replicate"))
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("border", ["constant", "replicate"])
@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_warp_affine_dispatch_bitwise(border, interp):
    img = _img((2, 64, 96), seed=7)
    M = ref.get_rotation_matrix_2d((48.0, 32.0), 31.0, 1.1)
    bv = 9.0 if border == "constant" else 0.0
    exp = np.stack([ref.warp_affine(p, M, (56, 88), interpolation=interp,
                                    border=border, border_value=bv)
                    for p in img])
    got = np.asarray(warp_affine_planes(
        jnp.asarray(img), M, (56, 88), interpolation=interp, border=border,
        border_value=bv))
    np.testing.assert_array_equal(got, exp)


def test_warp_affine_dispatch_shear_translate():
    img = _img((1, 60, 100), seed=11)
    M = np.array([[1.0, 0.3, -10.0], [0.1, 0.9, 5.5]])
    exp = ref.warp_affine(img[0], M, (60, 100))[None]
    got = np.asarray(warp_affine_planes(jnp.asarray(img), M, (60, 100)))
    np.testing.assert_array_equal(got, exp)


def test_warp_perspective_dispatch_bitwise():
    img = _img((1, 60, 80), seed=13)
    Mp = np.array([[1.0, 0.05, -5.0], [0.02, 0.98, 3.0],
                   [2e-4, 1e-4, 1.0]])
    for border in ("constant", "replicate"):
        exp = ref.warp_perspective(img[0], Mp, (56, 76), border=border)[None]
        got = np.asarray(warp_perspective_planes(
            jnp.asarray(img), Mp, (56, 76), border=border))
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log", [False, True])
@pytest.mark.parametrize("interp", ["linear", "nearest"])
def test_warp_polar_dispatch_bitwise(inverse, log, interp):
    """warp_polar_planes, incl. the inverse wrap-pad geometry where the
    padded source is one angle row taller on each side."""
    from imageenhancement_mp_tpu.ops.warp import warp_polar_planes

    img = _img((2, 64, 96), seed=19)
    dsize = (48, 56) if not inverse else (64, 96)
    exp = np.stack([
        ref.warp_polar(p, dsize, (50.0, 30.0), 45.0, log=log,
                       inverse=inverse, interpolation=interp)
        for p in img
    ])
    got = np.asarray(warp_polar_planes(
        jnp.asarray(img), dsize, (50.0, 30.0), 45.0, log=log,
        inverse=inverse, interpolation=interp))
    np.testing.assert_array_equal(got, exp)


def test_large_spread_map():
    # scale 1/8 rotation: the INVERSE map spreads each output block over
    # a ~800-row source window
    img = _img((1, 600, 700), seed=17)
    M = ref.get_rotation_matrix_2d((350.0, 300.0), 45.0, 0.125)
    exp = ref.warp_affine(img[0], M, (64, 72))[None]
    got = np.asarray(warp_affine_planes(jnp.asarray(img), M, (64, 72)))
    np.testing.assert_array_equal(got, exp)
