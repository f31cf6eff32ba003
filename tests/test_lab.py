"""RGB<->Lab / RGB<->XYZ parity (docs/PARITY.md): cv2's u8 fixed point,
pinned EXHAUSTIVELY bit-exact in round 3 (all 2^24 inputs, both
directions, sRGB + linear variants).  CI samples the space; the
exhaustive sweeps live in the round-3 probe logs."""

import numpy as np

from detseed import seed
import pytest

import jax.numpy as jnp

import imageenhancement_mp_tpu as ie
from imageenhancement_mp_tpu import ref

cv2 = pytest.importorskip("cv2")
cv2.setNumThreads(1)


def _rand_rgb(rng, shape=(64, 83, 3)):
    return rng.integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("name,code,fn", [
    ("rgb2lab", cv2.COLOR_RGB2LAB, lambda a: ref.rgb_to_lab(a)),
    ("lrgb2lab", cv2.COLOR_LRGB2LAB, lambda a: ref.rgb_to_lab(a, srgb=False)),
    ("lab2rgb", cv2.COLOR_LAB2RGB, lambda a: ref.lab_to_rgb(a)),
    ("lab2lrgb", cv2.COLOR_LAB2LRGB, lambda a: ref.lab_to_rgb(a, srgb=False)),
    ("bgr2lab", cv2.COLOR_BGR2LAB, lambda a: ref.rgb_to_lab(a, "bgr")),
    ("lab2bgr", cv2.COLOR_LAB2BGR, lambda a: ref.lab_to_rgb(a, "bgr")),
    ("rgb2xyz", cv2.COLOR_RGB2XYZ, lambda a: ref.rgb_to_xyz(a)),
    ("xyz2rgb", cv2.COLOR_XYZ2RGB, lambda a: ref.xyz_to_rgb(a)),
])
def test_ref_vs_cv2(name, code, fn):
    rng = np.random.default_rng(seed("lab", name))
    for t in range(20):
        img = _rand_rgb(rng, (int(rng.integers(8, 90)), int(rng.integers(8, 90)), 3))
        want = cv2.cvtColor(img, code)
        got = fn(img)
        assert np.array_equal(got, want), name
    # structured edges: gray axis, extremes
    edges = np.zeros((4, 256, 3), np.uint8)
    edges[0, :, 0] = edges[0, :, 1] = edges[0, :, 2] = np.arange(256)
    edges[1, :, 0] = np.arange(256)
    edges[2, :, 1] = np.arange(256)
    edges[3, :, 2] = 255 - np.arange(256)
    assert np.array_equal(fn(edges), cv2.cvtColor(edges, code))


@pytest.mark.parametrize("code,cvcode", [
    ("rgb2lab", cv2.COLOR_RGB2LAB), ("lab2rgb", cv2.COLOR_LAB2RGB),
    ("rgb2xyz", cv2.COLOR_RGB2XYZ), ("xyz2rgb", cv2.COLOR_XYZ2RGB),
    ("bgr2lab", cv2.COLOR_BGR2LAB), ("lab2bgr", cv2.COLOR_LAB2BGR),
    ("xyz2bgr", cv2.COLOR_XYZ2BGR), ("bgr2xyz", cv2.COLOR_BGR2XYZ),
])
def test_device_vs_cv2(code, cvcode):
    rng = np.random.default_rng(seed("labdev", code))
    img = _rand_rgb(rng, (2, 47, 61, 3))
    got = np.asarray(ie.cvt_color(jnp.asarray(img), code))
    want = np.stack([cv2.cvtColor(f, cvcode) for f in img])
    assert np.array_equal(got, want), code


def test_clahe_lab_matches_cv2_recipe():
    rng = np.random.default_rng(seed("clahelab"))
    img = _rand_rgb(rng, (96, 120, 3))
    got = np.asarray(ie.clahe_lab(jnp.asarray(img), 2.0, (4, 4)))
    lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    Lcv = cv2.createCLAHE(2.0, (4, 4)).apply(lab[..., 0])
    want = cv2.cvtColor(
        np.concatenate([Lcv[..., None], lab[..., 1:]], axis=-1), cv2.COLOR_LAB2RGB)
    # the CLAHE stage carries the documented CPU-tier ±1 on L (XLA:CPU
    # FMA contraction); the Lab legs are
    # bit-exact, so wherever the L planes agree the RGB must be equal
    Ldev = np.asarray(ie.clahe(jnp.asarray(lab[..., 0]), 2.0, (4, 4)))
    dL = np.abs(Ldev.astype(np.int64) - Lcv.astype(np.int64))
    assert int(dL.max()) <= 1
    same = dL == 0
    assert np.array_equal(got[same], want[same])


def test_clahe_lab_batch_and_rejects():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (2, 40, 44, 3), np.uint8)
    out = np.asarray(ie.clahe_lab(jnp.asarray(img)))
    assert out.shape == img.shape
    with pytest.raises(TypeError):
        ie.clahe_lab(jnp.zeros((8, 8, 3), jnp.uint16))
    with pytest.raises(ValueError):
        ie.clahe_lab(jnp.zeros((8, 8), jnp.uint8))


def test_f32_lab_float_paths():
    """f32 Lab: inverse tracks cv2 at float tolerance; the forward is
    the DOCUMENTED deviation — cv2's coarse interpolated LUT vs our
    analytic value (ref/ops.py rgb_to_lab)."""
    rng = np.random.default_rng(seed("labf32"))
    img = rng.random((60, 70, 3)).astype(np.float32)
    lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    got = ref.rgb_to_lab(img)
    assert float(np.abs(got - lab).max()) <= 0.7     # cv2's own LUT error
    inv = ref.lab_to_rgb(lab)
    want = cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)
    assert float(np.abs(inv - want).max()) <= 2e-4
    xyz = ref.rgb_to_xyz(img)
    assert float(np.abs(xyz - cv2.cvtColor(img, cv2.COLOR_RGB2XYZ)).max()) <= 1e-6
    back = ref.xyz_to_rgb(xyz)
    assert float(np.abs(back - cv2.cvtColor(xyz, cv2.COLOR_XYZ2RGB)).max()) <= 3e-6


def test_f32_device_paths():
    """Device f32 cvt_color lab/xyz tracks cv2/oracle at float tolerance."""
    rng = np.random.default_rng(seed("labf32dev"))
    img = rng.random((24, 30, 3)).astype(np.float32)
    x = np.asarray(ie.cvt_color(jnp.asarray(img), "rgb2xyz"))
    assert float(np.abs(x - cv2.cvtColor(img, cv2.COLOR_RGB2XYZ)).max()) <= 1e-5
    b = np.asarray(ie.cvt_color(jnp.asarray(x), "xyz2rgb"))
    assert float(np.abs(b - cv2.cvtColor(x, cv2.COLOR_XYZ2RGB)).max()) <= 1e-5
    lab = np.asarray(ie.cvt_color(jnp.asarray(img), "rgb2lab"))
    assert float(np.abs(lab - ref.rgb_to_lab(img)).max()) <= 5e-3
    inv = np.asarray(ie.cvt_color(jnp.asarray(lab), "lab2rgb"))
    assert float(np.abs(inv - ref.lab_to_rgb(lab)).max()) <= 1e-4


# ---------------------------------------------------------------------------
# HLS (docs/PARITY.md): the SIMD-body model, exhaustively bit-exact on
# wide rows; cv2's own scalar row tail differs ±1 (like HSV2RGB), so
# forward tests use width-64 images to sit entirely in cv2's body.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,code,fn", [
    ("rgb2hls", cv2.COLOR_RGB2HLS, lambda a: ref.rgb_to_hls(a)),
    ("bgr2hls", cv2.COLOR_BGR2HLS, lambda a: ref.rgb_to_hls(a, "bgr")),
    ("hls2rgb", cv2.COLOR_HLS2RGB, lambda a: ref.hls_to_rgb(a)),
    ("hls2bgr", cv2.COLOR_HLS2BGR, lambda a: ref.hls_to_rgb(a, "bgr")),
])
def test_hls_ref_vs_cv2(name, code, fn):
    rng = np.random.default_rng(seed("hls", name))
    for t in range(12):
        img = _rand_rgb(rng, (int(rng.integers(8, 90)), 64, 3))
        want = cv2.cvtColor(img, code)
        got = fn(img)
        assert np.array_equal(got, want), name
    # gray axis + saturated extremes + the pinned hue-tie bank
    edges = np.zeros((4, 64, 3), np.uint8)
    edges[0] = np.arange(64)[:, None] * 4
    edges[1, :, 0] = np.arange(64) * 4
    edges[2, :, 1] = 255
    edges[3, :32] = [12, 23, 24]
    edges[3, 32:] = [255, 211, 244]
    assert np.array_equal(fn(edges), cv2.cvtColor(edges, code)), name


@pytest.mark.parametrize("code,cvcode", [
    ("rgb2hls", cv2.COLOR_RGB2HLS), ("hls2rgb", cv2.COLOR_HLS2RGB),
    ("bgr2hls", cv2.COLOR_BGR2HLS), ("hls2bgr", cv2.COLOR_HLS2BGR),
])
def test_hls_device_vs_cv2(code, cvcode):
    rng = np.random.default_rng(seed("hlsdev", code))
    img = _rand_rgb(rng, (2, 37, 64, 3))
    got = np.asarray(ie.cvt_color(jnp.asarray(img), code))
    want = np.stack([cv2.cvtColor(f, cvcode) for f in img])
    assert np.array_equal(got, want), code


def test_hls_roundtrip_device_vs_oracle():
    rng = np.random.default_rng(seed("hlsrt"))
    img = _rand_rgb(rng, (1, 128, 257, 3))  # odd width: oracle is layout-free
    got = np.asarray(ie.cvt_color(jnp.asarray(img), "rgb2hls"))
    assert np.array_equal(got[0], ref.rgb_to_hls(img[0]))
    back = np.asarray(ie.cvt_color(jnp.asarray(got), "hls2rgb"))
    assert np.array_equal(back[0], ref.hls_to_rgb(got[0]))


def test_luv_u8_forward_vs_cv2():
    """Packed trilinear path (docs/PARITY.md 'Luv'): +-1 LSB on
    <=3.5/1.1/1.5 % px per channel, never more."""
    rng = np.random.default_rng(seed("luvfwd"))
    for t in range(6):
        img = rng.integers(0, 256, (48, 52, 3), np.uint8)
        want = cv2.cvtColor(img, cv2.COLOR_RGB2Luv).astype(int)
        got = ref.rgb_to_luv(img).astype(int)
        d = np.abs(got - want)
        assert d.max() <= 1, t
        assert (d > 0).mean() < 0.06, (t, (d > 0).mean())


def test_luv_u8_inverse_vs_cv2():
    rng = np.random.default_rng(seed("luvinv"))
    for t in range(6):
        img = rng.integers(0, 256, (48, 52, 3), np.uint8)
        lu8 = cv2.cvtColor(img, cv2.COLOR_RGB2Luv)
        want = cv2.cvtColor(lu8, cv2.COLOR_Luv2RGB).astype(int)
        got = ref.luv_to_rgb(lu8).astype(int)
        d = np.abs(got - want)
        # dark out-of-gamut boundary triples clamp differently (<=0.02%)
        assert (d > 1).mean() < 5e-4, (t, (d > 1).mean())
        assert d.max() <= 8, (t, d.max())


def test_luv_f32_vs_cv2():
    rng = np.random.default_rng(seed("luvf32"))
    x = rng.random((32, 36, 3)).astype(np.float32)
    want = cv2.cvtColor(x, cv2.COLOR_RGB2Luv)
    got = ref.rgb_to_luv(x)
    assert float(np.abs(got - want).max()) < 0.05   # cv2's f32 transcendentals
    back = cv2.cvtColor(want, cv2.COLOR_Luv2RGB)
    gotb = ref.luv_to_rgb(want)
    assert float(np.abs(gotb - back).max()) < 1e-3


def test_luv_device_vs_oracle():
    rng = np.random.default_rng(seed("luvdev"))
    img = rng.integers(0, 256, (2, 32, 36, 3), np.uint8)
    got = np.asarray(ie.cvt_color(jnp.asarray(img), "rgb2luv"))
    want = np.stack([ref.rgb_to_luv(f) for f in img])
    assert np.array_equal(got, want)     # integer path: bitwise
    got2 = np.asarray(ie.cvt_color(jnp.asarray(want), "luv2rgb"))
    want2 = np.stack([ref.luv_to_rgb(f) for f in want])
    # device f32 transcendentals vs oracle f64 emulation: razor ties
    assert int(np.abs(got2.astype(int) - want2.astype(int)).max()) <= 1


def test_luv_f32_device_vs_cv2():
    rng = np.random.default_rng(seed("luvf32dev"))
    x = rng.random((24, 28, 3)).astype(np.float32)
    want = cv2.cvtColor(x, cv2.COLOR_RGB2Luv)
    got = np.asarray(ie.cvt_color(jnp.asarray(x), "rgb2luv"))
    assert float(np.abs(got - want).max()) < 0.05
    back = np.asarray(ie.cvt_color(jnp.asarray(want), "luv2rgb"))
    want2 = cv2.cvtColor(want, cv2.COLOR_Luv2RGB)
    assert float(np.abs(back - want2).max()) < 1e-3
