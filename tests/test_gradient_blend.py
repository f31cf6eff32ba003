"""spatialGradient / sqrBoxFilter / blendLinear — ref vs cv2, device vs ref."""

import numpy as np
import pytest
from detseed import seed

import jax.numpy as jnp

import imageenhancement_mp_tpu as ie
from imageenhancement_mp_tpu import ref

cv2 = pytest.importorskip("cv2")


def _ulp32(a, b):
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max()) if a.size else 0


@pytest.mark.parametrize("border,flag", [
    ("reflect101", cv2.BORDER_DEFAULT), ("replicate", cv2.BORDER_REPLICATE)])
def test_spatial_gradient_ref_vs_cv2(border, flag):
    rng = np.random.default_rng(seed("spatial_gradient", border))
    for t in range(60):
        H, W = int(rng.integers(3, 90)), int(rng.integers(3, 90))
        img = rng.integers(0, 256, (H, W), np.uint8)
        dx, dy = ref.spatial_gradient(img, border)
        wx, wy = cv2.spatialGradient(img, borderType=flag)
        assert np.array_equal(dx, wx) and np.array_equal(dy, wy), (t, H, W)


def test_spatial_gradient_device_vs_ref():
    rng = np.random.default_rng(seed("spatial_gradient_dev"))
    for border in ("reflect101", "replicate"):
        img = rng.integers(0, 256, (2, 33, 41), np.uint8)
        dx, dy = ie.spatial_gradient(jnp.asarray(img), border)
        for n in range(2):
            rx, ry = ref.spatial_gradient(img[n], border)
            assert np.array_equal(np.asarray(dx)[n], rx)
            assert np.array_equal(np.asarray(dy)[n], ry)
    # HWC input: per-channel planes
    img = rng.integers(0, 256, (21, 17, 3), np.uint8)
    dx, dy = ie.spatial_gradient(jnp.asarray(img))
    for c in range(3):
        rx, _ = ref.spatial_gradient(img[:, :, c])
        assert np.array_equal(np.asarray(dx)[:, :, c], rx)


def test_sqr_box_ref_vs_cv2():
    rng = np.random.default_rng(seed("sqr_box"))
    worst = {}
    for t in range(150):
        H, W = int(rng.integers(4, 80)), int(rng.integers(4, 80))
        kh, kw = int(rng.integers(1, 8)), int(rng.integers(1, 8))
        dt = [np.uint8, np.uint16, np.float32][t % 3]
        if dt == np.float32:
            img = ((rng.random((H, W)) - 0.2) * 300).astype(np.float32)
        else:
            img = rng.integers(0, np.iinfo(dt).max + 1, (H, W), dt)
        for norm in (True, False):
            got = ref.sqr_box_filter(img, (kh, kw), norm)
            want = cv2.sqrBoxFilter(img, cv2.CV_32F, (kw, kh), normalize=norm)
            key = (dt.__name__, norm)
            worst[key] = max(worst.get(key, 0), _ulp32(got, want))
    # pinned law: bitwise everywhere except u8 normalized (cv2's IPP
    # reciprocal path — ±1 ulp budget, docs/PARITY.md)
    for key, u in worst.items():
        assert u <= (1 if key == ("uint8", True) else 0), (key, u)


def test_sqr_box_device_vs_ref():
    rng = np.random.default_rng(seed("sqr_box_dev"))
    for dt in (np.uint8, np.uint16, np.float32):
        if dt == np.float32:
            img = (rng.random((2, 24, 31)) * 200).astype(np.float32)
        else:
            img = rng.integers(0, np.iinfo(dt).max + 1, (2, 24, 31), dt)
        for ks in (3, (5, 2)):
            for norm in (True, False):
                got = np.asarray(ie.sqr_box_filter(jnp.asarray(img), ks, norm))
                for n in range(2):
                    want = ref.sqr_box_filter(img[n], ks, norm)
                    assert _ulp32(got[n], want) == 0, (dt, ks, norm)


def test_blend_linear_ref_vs_cv2():
    rng = np.random.default_rng(seed("blend_linear"))
    for t in range(120):
        H, W = int(rng.integers(2, 70)), int(rng.integers(2, 70))
        C = int(rng.integers(1, 5))
        shape = (H, W) if C == 1 else (H, W, C)
        u8 = t % 2 == 0
        if u8:
            a = rng.integers(0, 256, shape, np.uint8)
            b = rng.integers(0, 256, shape, np.uint8)
        else:
            a = (rng.random(shape) * 255).astype(np.float32)
            b = (rng.random(shape) * 255).astype(np.float32)
        w1 = (rng.random((H, W)) * rng.choice([1.0, 8.0])).astype(np.float32)
        w2 = (rng.random((H, W)) * rng.choice([1.0, 8.0])).astype(np.float32)
        if t % 13 == 0:
            w1[:] = 0.0
            w2[:] = 0.0
        got = ref.blend_linear(a, b, w1, w2)
        want = cv2.blendLinear(a, b, w1, w2)
        if u8:
            assert np.array_equal(got, want), t
        else:
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), t


def test_blend_linear_device_vs_ref():
    rng = np.random.default_rng(seed("blend_linear_dev"))
    for shape in ((19, 23), (19, 23, 3)):
        a = rng.integers(0, 256, shape, np.uint8)
        b = rng.integers(0, 256, shape, np.uint8)
        w1 = rng.random((19, 23)).astype(np.float32)
        w2 = rng.random((19, 23)).astype(np.float32)
        got = np.asarray(ie.blend_linear(jnp.asarray(a), jnp.asarray(b), w1, w2))
        assert np.array_equal(got, ref.blend_linear(a, b, w1, w2))
        af = a.astype(np.float32)
        bf = b.astype(np.float32)
        gf = np.asarray(ie.blend_linear(jnp.asarray(af), jnp.asarray(bf), w1, w2))
        # bitwise: separately rounded products, f64 quotient snapped to
        # the f32 grid (api.py _blend_linear_jit; docs/PARITY.md)
        assert _ulp32(gf, ref.blend_linear(af, bf, w1, w2)) == 0
