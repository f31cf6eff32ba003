"""cv2.remap parity (float32 maps) — BIT-EXACT for every dtype
(docs/PARITY.md): u8/u16/f32 linear via the f32 FMA lerp, i16 via the
legacy float-tab path, NEAREST via cvRound(map)."""

import numpy as np

from detseed import seed
import pytest

import jax.numpy as jnp

import imageenhancement_mp_tpu as ie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops.warp import remap_planes

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


def _maps(rng, H, W, oh, ow):
    mx = (rng.random((oh, ow)) * (W + 4) - 2).astype(np.float32)
    my = (rng.random((oh, ow)) * (H + 4) - 2).astype(np.float32)
    return mx, my


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_ref_vs_cv2(interp, dt):
    rng = np.random.default_rng(seed("remap", interp, dt.__name__))
    for t in range(30):
        H, W = int(rng.integers(6, 50)), int(rng.integers(6, 50))
        oh, ow = int(rng.integers(6, 50)), int(rng.integers(6, 50))
        img = _img(rng, dt, (H, W))
        mx, my = _maps(rng, H, W, oh, ow)
        bmode = ["constant", "replicate"][t % 2]
        bval = float(rng.integers(0, 90))
        want = cv2.remap(img, mx, my, _I[interp], borderMode=_B[bmode],
                         borderValue=bval)
        got = ref.remap(img, mx, my, interp, bmode, bval)
        if dt is np.float32:
            assert np.array_equal(got, want), (H, W, oh, ow)
        else:
            d = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
            assert d == 0, (H, W, oh, ow, d)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_device_vs_oracle(dt):
    rng = np.random.default_rng(seed("remapdev", dt.__name__))
    img = _img(rng, dt, (29, 33))
    mx, my = _maps(rng, 29, 33, 21, 26)
    want = ref.remap(img, mx, my)
    got = np.asarray(remap_planes(jnp.asarray(img)[None],
                                  jnp.asarray(mx), jnp.asarray(my)))[0]
    if dt is np.float32:
        assert np.array_equal(got, want)
    else:
        assert np.array_equal(got, want)


def test_api_identity_map_is_noop():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (14, 19), np.uint8)
    mx, my = np.meshgrid(np.arange(19, dtype=np.float32),
                         np.arange(14, dtype=np.float32))
    out = np.asarray(ie.remap(jnp.asarray(img), mx, my))
    assert np.array_equal(out, img)


def test_api_batch_shares_maps_and_rejects():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, 20, 24, 3), np.uint8)
    mx, my = _maps(rng, 20, 24, 15, 18)
    out = np.asarray(ie.remap(jnp.asarray(img), mx, my))
    assert out.shape == (2, 15, 18, 3)
    want = cv2.remap(img[0], mx, my, cv2.INTER_LINEAR)
    assert int(np.abs(out[0].astype(np.int64) - want.astype(np.int64)).max()) <= 1
    with pytest.raises(ValueError):
        ie.remap(jnp.zeros((4, 4), jnp.uint8), mx, my, "area")


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_ref_cubic_vs_cv2(dt):
    rng = np.random.default_rng(seed("remapcubic", dt.__name__))
    for t in range(20):
        H, W = int(rng.integers(6, 50)), int(rng.integers(6, 50))
        oh, ow = int(rng.integers(6, 50)), int(rng.integers(6, 50))
        img = _img(rng, dt, (H, W))
        mx, my = _maps(rng, H, W, oh, ow)
        bmode = ["constant", "replicate"][t % 2]
        bval = float(rng.integers(0, 90))
        want = cv2.remap(img, mx, my, cv2.INTER_CUBIC, borderMode=_B[bmode],
                         borderValue=bval)
        got = ref.remap(img, mx, my, "cubic", bmode, bval)
        if dt is np.float32:
            # ~1 ulp of the f32 weight chain at the value scale
            d = float(np.abs(got - want).max())
            assert d <= 2e-3, (H, W, oh, ow, d)
        else:
            # u8 exact bar the razor-tie class; u16/i16 pinned at ±1
            d = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
            assert d <= 1, (H, W, oh, ow, d)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_device_cubic_vs_oracle(dt):
    rng = np.random.default_rng(seed("remapcubicdev", dt.__name__))
    for bmode in ("constant", "replicate"):
        img = _img(rng, dt, (27, 31))
        mx, my = _maps(rng, 27, 31, 19, 23)
        want = ref.remap(img, mx, my, "cubic", bmode, 7.0)
        got = np.asarray(remap_planes(jnp.asarray(img)[None], jnp.asarray(mx),
                                      jnp.asarray(my), "cubic", bmode, 7.0))[0]
        if dt is np.float32:
            # XLA may FMA-contract the weight chain (±1 ulp tier)
            assert float(np.abs(got - want).max()) <= 2e-3
        else:
            d = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
            assert d <= 1, (bmode, d)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_ref_lanczos4_vs_cv2(dt):
    """Quantized 1/32-cell tabs (docs/PARITY.md): ints +-1 on <~0.3% px
    (tab-correction ambiguity), f32 ~1 ulp."""
    rng = np.random.default_rng(seed("remapl4", dt.__name__))
    for t in range(14):
        H, W = int(rng.integers(10, 50)), int(rng.integers(10, 50))
        oh, ow = int(rng.integers(8, 45)), int(rng.integers(8, 45))
        img = _img(rng, dt, (H, W))
        mx, my = _maps(rng, H, W, oh, ow)
        bmode = ["constant", "replicate"][t % 2]
        bval = float(rng.integers(0, 90))
        want = cv2.remap(img, mx, my, cv2.INTER_LANCZOS4, borderMode=_B[bmode],
                         borderValue=bval)
        got = ref.remap(img, mx, my, "lanczos4", bmode, bval)
        if dt is np.float32:
            d = float(np.abs(got - want).max())
            assert d <= 2e-3, (H, W, oh, ow, d)
        else:
            d = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
            assert d <= 1, (H, W, oh, ow, d)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_device_lanczos4_vs_oracle(dt):
    rng = np.random.default_rng(seed("remapl4dev", dt.__name__))
    for bmode in ("constant", "replicate"):
        img = _img(rng, dt, (29, 33))
        mx, my = _maps(rng, 29, 33, 21, 26)
        want = ref.remap(img, mx, my, "lanczos4", bmode, 5.0)
        got = np.asarray(remap_planes(jnp.asarray(img)[None], jnp.asarray(mx),
                                      jnp.asarray(my), "lanczos4", bmode, 5.0))[0]
        if dt is np.uint8:
            # integer tab path: device == oracle bitwise on every backend
            assert np.array_equal(got, want), bmode
        elif dt is np.float32:
            assert float(np.abs(got - want).max()) <= 2e-3, bmode
        else:
            d = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
            assert d <= 1, (bmode, d)
