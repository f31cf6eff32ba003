"""cv2.warpAffine parity: oracle vs cv2, device vs oracle, API.

Budgets (docs/PARITY.md): BIT-EXACT for every dtype — u8/u16/f32 via
the hybrid f32 coordinate field + FMA lerp, i16 via the legacy
fixed-point coords with float tab weights; NEAREST exact.
"""

import numpy as np

from detseed import seed
import pytest

import jax.numpy as jnp

import imageenhancement_mp_tpu as ie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops.warp import warp_affine_planes

cv2 = pytest.importorskip("cv2")
cv2.setNumThreads(1)

_B = {"constant": cv2.BORDER_CONSTANT, "replicate": cv2.BORDER_REPLICATE}
_I = {"linear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST}


def _img(rng, dt, shape):
    if dt is np.float32:
        return (rng.random(shape) * 500 - 100).astype(np.float32)
    lo, hi = (0, 256) if dt is np.uint8 else (
        (0, 65536) if dt is np.uint16 else (-32768, 32768))
    return rng.integers(lo, hi, shape).astype(dt)


def _mat(rng):
    return np.array([[rng.uniform(0.3, 2), rng.uniform(-0.5, 0.5), rng.uniform(-8, 8)],
                     [rng.uniform(-0.5, 0.5), rng.uniform(0.3, 2), rng.uniform(-8, 8)]])


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_ref_vs_cv2(interp, dt):
    rng = np.random.default_rng(seed("warp", interp, dt.__name__))
    for t in range(40):
        H, W = int(rng.integers(4, 45)), int(rng.integers(4, 45))
        oh, ow = int(rng.integers(4, 45)), int(rng.integers(4, 45))
        img = _img(rng, dt, (H, W))
        M = _mat(rng)
        bmode = ["constant", "replicate"][t % 2]
        bval = float(rng.integers(0, 100))
        want = cv2.warpAffine(img, M, (ow, oh), flags=_I[interp],
                              borderMode=_B[bmode], borderValue=bval)
        got = ref.warp_affine(img, M, (oh, ow), interp, bmode, bval)
        if dt is np.float32:
            assert np.array_equal(got, want), (H, W, oh, ow)
        else:
            d = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
            assert d == 0, (H, W, oh, ow, d)


def test_border_value_saturates():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (8, 9), np.uint8)
    M = np.float64([[1, 0, -3.5], [0, 1, 2.25]])
    want = cv2.warpAffine(img, M, (9, 8), borderValue=300.7)
    got = ref.warp_affine(img, M, (8, 9), "linear", "constant", 300.7)
    assert np.array_equal(got, want)


def test_inverse_map_roundtrip():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (20, 25), np.uint8)
    M = _mat(rng)
    a = ref.warp_affine(img, M, (18, 22))
    b = ref.warp_affine(img, ref.invert_affine(M), (18, 22), inverse_map=True)
    assert np.array_equal(a, b)
    want = cv2.warpAffine(img, M, (22, 18),
                          flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
    got = ref.warp_affine(img, M, (18, 22), inverse_map=True)
    assert np.array_equal(got, want)


def test_rotation_matrix_matches_cv2():
    for center, ang, sc in [((10.5, 7.25), 33.0, 1.0), ((0, 0), -120.0, 0.7)]:
        a = ref.get_rotation_matrix_2d(center, ang, sc)
        b = cv2.getRotationMatrix2D(center, ang, sc)
        assert np.allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_device_vs_oracle(interp, dt):
    rng = np.random.default_rng(seed("warpdev", interp, dt.__name__))
    img = _img(rng, dt, (29, 34))
    M = _mat(rng)
    want = ref.warp_affine(img, M, (25, 31), interp, "constant", 7.0)
    got = np.asarray(warp_affine_planes(
        jnp.asarray(img)[None], M, (25, 31), interp, "constant", 7.0))[0]
    assert np.array_equal(got, want)


def test_api_batch_rgb_rotation():
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (2, 24, 30, 3), np.uint8)
    M = ref.get_rotation_matrix_2d((15.0, 12.0), 30.0, 0.9)
    out = np.asarray(ie.warp_affine(jnp.asarray(img), M, (24, 30)))
    assert out.shape == (2, 24, 30, 3)
    want = cv2.warpAffine(img[0], M, (30, 24))
    assert np.array_equal(out[0], want)


def test_rejects():
    img = jnp.zeros((4, 4), jnp.uint8)
    M = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    with pytest.raises(ValueError):
        ie.warp_affine(img, M, (0, 3))
    with pytest.raises(ValueError):
        ie.warp_affine(img, M, (3, 3), "area")
    with pytest.raises(ValueError):
        ie.warp_affine(img, M, (3, 3), "linear", "reflect")


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_ref_cubic_vs_cv2(dt):
    """cv2 5.0's new cubic warp kernel (docs/PARITY.md): u8/u16
    bit-exact, i16 razor +-1, f32 bitwise interior / <=1 ulp outside."""
    rng = np.random.default_rng(seed("warpcubic", dt.__name__))
    for t in range(20):
        H, W = int(rng.integers(8, 60)), int(rng.integers(8, 60))
        oh, ow = int(rng.integers(6, 55)), int(rng.integers(6, 55))
        img = _img(rng, dt, (H, W))
        M = _mat(rng)
        bmode = ["constant", "replicate"][t % 2]
        bval = float(rng.integers(0, 120))
        want = cv2.warpAffine(img, M, (ow, oh), flags=cv2.INTER_CUBIC,
                              borderMode=_B[bmode], borderValue=bval)
        got = ref.warp_affine(img, M, (oh, ow), "cubic", bmode, bval)
        if dt is np.float32:
            d = float(np.abs(got - want).max())
            assert d <= 2e-3, (H, W, oh, ow, d)
        elif dt is np.int16:
            d = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
            assert d <= 1, (H, W, oh, ow, d)
        else:
            assert np.array_equal(got, want), (H, W, oh, ow)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_ref_cubic_perspective_vs_cv2(dt):
    """Perspective cubic: cv2's SIMD-reciprocal division is
    hardware-dependent — +-1 LSB ints / ~1e-5 relative f32 budgets."""
    rng = np.random.default_rng(seed("warpcubicp", dt.__name__))
    for t in range(16):
        H, W = int(rng.integers(12, 60)), int(rng.integers(12, 60))
        oh, ow = int(rng.integers(10, 55)), int(rng.integers(10, 55))
        img = _img(rng, dt, (H, W))
        M = np.array([[rng.uniform(0.5, 1.5), rng.uniform(-0.2, 0.2), rng.uniform(-6, 6)],
                      [rng.uniform(-0.2, 0.2), rng.uniform(0.5, 1.5), rng.uniform(-6, 6)],
                      [rng.uniform(-2e-3, 2e-3), rng.uniform(-2e-3, 2e-3), 1.0]])
        bmode = ["constant", "replicate"][t % 2]
        bval = float(rng.integers(0, 120))
        want = cv2.warpPerspective(img, M, (ow, oh), flags=cv2.INTER_CUBIC,
                                   borderMode=_B[bmode], borderValue=bval)
        got = ref.warp_perspective(img, M, (oh, ow), "cubic", bmode, bval)
        if dt is np.float32:
            scale = max(1.0, float(np.abs(want).max()))
            d = float(np.abs(got - want).max()) / scale
            assert d <= 3e-5, (H, W, oh, ow, d)
        else:
            d = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
            assert d <= 1, (H, W, oh, ow, d)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_device_cubic_vs_oracle(dt):
    from imageenhancement_mp_tpu.ops.warp import warp_perspective_planes

    rng = np.random.default_rng(seed("warpcubicdev", dt.__name__))
    img = _img(rng, dt, (31, 35))
    M = _mat(rng)
    for bmode in ("constant", "replicate"):
        want = ref.warp_affine(img, M, (24, 27), "cubic", bmode, 9.0)
        got = np.asarray(warp_affine_planes(jnp.asarray(img)[None], M, (24, 27),
                                            "cubic", bmode, 9.0))[0]
        if dt is np.float32:
            # XLA may contract the weight-product chains (±1 tier)
            assert float(np.abs(got - want).max()) <= 2e-3, bmode
        else:
            d = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
            assert d <= 1, (bmode, d)
    Mp = np.array([[1.07, 0.11, -3.0], [-0.08, 0.93, 2.0],
                   [1.3e-3, -0.9e-3, 1.0]])
    want = ref.warp_perspective(img, Mp, (24, 27), "cubic", "replicate", 0.0)
    got = np.asarray(warp_perspective_planes(jnp.asarray(img)[None], Mp, (24, 27),
                                             "cubic", "replicate", 0.0))[0]
    if dt is np.float32:
        assert float(np.abs(got - want).max()) <= 2e-3
    else:
        assert int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max()) <= 1


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_ref_lanczos4_vs_cv2(dt):
    """Legacy quantized path (docs/PARITY.md): ints +-1 on <~0.3% px,
    f32 ~1 ulp — affine AND perspective share the remap tabs."""
    rng = np.random.default_rng(seed("warplancz", dt.__name__))
    for t in range(12):
        H, W = int(rng.integers(14, 55)), int(rng.integers(14, 55))
        oh, ow = int(rng.integers(10, 50)), int(rng.integers(10, 50))
        img = _img(rng, dt, (H, W))
        bmode = ["constant", "replicate"][t % 2]
        bval = float(rng.integers(0, 120))
        M = _mat(rng)
        want = cv2.warpAffine(img, M, (ow, oh), flags=cv2.INTER_LANCZOS4,
                              borderMode=_B[bmode], borderValue=bval)
        got = ref.warp_affine(img, M, (oh, ow), "lanczos4", bmode, bval)
        if dt is np.float32:
            assert float(np.abs(got - want).max()) <= 2e-3, (t, "affine")
        else:
            d = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
            assert d <= 1, (t, "affine", d)
        Mp = np.array([[rng.uniform(0.5, 1.5), rng.uniform(-0.2, 0.2), rng.uniform(-6, 6)],
                       [rng.uniform(-0.2, 0.2), rng.uniform(0.5, 1.5), rng.uniform(-6, 6)],
                       [rng.uniform(-2e-3, 2e-3), rng.uniform(-2e-3, 2e-3), 1.0]])
        want = cv2.warpPerspective(img, Mp, (ow, oh), flags=cv2.INTER_LANCZOS4,
                                   borderMode=_B[bmode], borderValue=bval)
        got = ref.warp_perspective(img, Mp, (oh, ow), "lanczos4", bmode, bval)
        if dt is np.float32:
            assert float(np.abs(got - want).max()) <= 2e-3, (t, "persp")
        else:
            d = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
            assert d <= 1, (t, "persp", d)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.float32])
def test_device_lanczos4_vs_oracle(dt):
    from imageenhancement_mp_tpu.ops.warp import warp_perspective_planes

    rng = np.random.default_rng(seed("warplanczdev", dt.__name__))
    img = _img(rng, dt, (31, 35))
    M = _mat(rng)
    want = ref.warp_affine(img, M, (24, 27), "lanczos4", "replicate", 0.0)
    got = np.asarray(warp_affine_planes(jnp.asarray(img)[None], M, (24, 27),
                                        "lanczos4", "replicate", 0.0))[0]
    if dt is np.uint8:
        assert np.array_equal(got, want)     # integer tab path: bitwise
    elif dt is np.float32:
        assert float(np.abs(got - want).max()) <= 2e-3
    else:
        assert int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max()) <= 1
    Mp = np.array([[1.07, 0.11, -3.0], [-0.08, 0.93, 2.0],
                   [1.3e-3, -0.9e-3, 1.0]])
    want = ref.warp_perspective(img, Mp, (24, 27), "lanczos4", "constant", 4.0)
    got = np.asarray(warp_perspective_planes(jnp.asarray(img)[None], Mp, (24, 27),
                                             "lanczos4", "constant", 4.0))[0]
    if dt is np.uint8:
        assert np.array_equal(got, want)
    elif dt is np.float32:
        assert float(np.abs(got - want).max()) <= 2e-3
    else:
        assert int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max()) <= 1
