"""Tier-2 parity: JAX op layer vs the NumPy oracle (SURVEY.md §4).

Runs on the hermetic CPU backend (conftest).  Acceptance mirrors the judged
budget (BASELINE.json:5): exact everywhere except the CLAHE blend's ±1
worst case (the integer API's one remaining non-exact corner after the
round-2 FMA/fixed-point upgrades).  Batch/channel handling is covered by
running every op on all four accepted shapes.
"""

import numpy as np
import pytest

import imageenhancement_mp_tpu as ie
from imageenhancement_mp_tpu import ref


def _rand(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


def per_plane_ref(fn, img):
    """Apply a single-image oracle fn over any of the 4 accepted shapes."""
    img = np.asarray(img)
    if img.ndim == 2:
        return fn(img)
    if img.ndim == 3:
        if img.shape[-1] in (1, 2, 3, 4):
            return np.stack([fn(img[..., c]) for c in range(img.shape[-1])], axis=-1)
        return np.stack([fn(p) for p in img])
    return np.stack(
        [
            np.stack([fn(img[n, ..., c]) for c in range(img.shape[-1])], axis=-1)
            for n in range(img.shape[0])
        ]
    )


SHAPES = [(37, 53), (64, 64, 3), (4, 37, 53), (2, 33, 47, 3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_equalize_hist_exact(rng, shape):
    img = _rand(rng, shape)
    assert maxdiff(ie.equalize_hist(img), per_plane_ref(ref.equalize_hist, img)) == 0


def test_equalize_hist_constant(rng):
    img = np.full((32, 32), 99, np.uint8)
    assert maxdiff(ie.equalize_hist(img), ref.equalize_hist(img)) == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_gamma_exact(rng, shape):
    img = _rand(rng, shape)
    got = ie.gamma(img, 2.2)
    assert maxdiff(got, per_plane_ref(lambda p: ref.gamma_transform(p, 2.2), img)) == 0


def test_log_exact(rng):
    img = _rand(rng, (64, 64))
    assert maxdiff(ie.log_transform(img), ref.log_transform(img)) == 0


def test_apply_lut_exact(rng):
    img = _rand(rng, (4, 37, 53))
    lut = _rand(rng, 256)
    assert maxdiff(ie.apply_lut(img, lut), per_plane_ref(lambda p: ref.apply_lut(p, lut), img)) == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_contrast_stretch_device_exact(rng, shape):
    # round 2: the device reproduces cv2's f64 scale/shift + f32 FMA via
    # the double-float table + exact-error-term emulation — exact
    img = _rand(rng, shape)
    assert maxdiff(ie.contrast_stretch(img), per_plane_ref(ref.contrast_stretch, img)) == 0


def test_contrast_stretch_constant():
    img = np.full((16, 16), 42, np.uint8)
    assert maxdiff(ie.contrast_stretch(img), ref.contrast_stretch(img)) == 0


@pytest.mark.parametrize("k", [3, 5, 7])
def test_gaussian_auto_sigma_exact(rng, k):
    img = _rand(rng, (64, 67))
    got = ie.gaussian_blur(img, k, 0.0)
    assert maxdiff(got, ref.gaussian_blur(img, k, 0.0)) == 0


@pytest.mark.parametrize("k,sigma", [(5, 1.5), (7, 0.7), (13, 2.2)])
def test_gaussian_sigma_exact(rng, k, sigma):
    # round 2: device shares cv2's fixed-point taps with the oracle — exact
    img = _rand(rng, (64, 67))
    assert maxdiff(ie.gaussian_blur(img, k, sigma), ref.gaussian_blur(img, k, sigma)) == 0


@pytest.mark.parametrize("k,sigma", [(5, 1.5), (11, 0.0), (13, 3.0)])
def test_gaussian_u16_sigma_exact(rng, k, sigma):
    # uint16 Q16 path: int32 split accumulation + u32 carry recombination
    img = rng.integers(0, 65536, (64, 67), dtype=np.uint16)
    assert maxdiff(ie.gaussian_blur(img, k, sigma), ref.gaussian_blur(img, k, sigma)) == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_batched(rng, shape):
    img = _rand(rng, shape)
    got = ie.gaussian_blur(img, 5, 0.0)
    assert maxdiff(got, per_plane_ref(lambda p: ref.gaussian_blur(p, 5, 0.0), img)) == 0


def test_laplacian_exact(rng):
    img = _rand(rng, (64, 67))
    assert maxdiff(ie.laplacian(img), ref.laplacian(img)) == 0


def test_laplacian_sharpen_exact(rng):
    img = _rand(rng, (64, 67))
    assert maxdiff(ie.laplacian_sharpen(img), ref.laplacian_sharpen(img)) == 0


@pytest.mark.parametrize("amount", [1.0, 2.0])
def test_unsharp_integral_amount_exact(rng, amount):
    img = _rand(rng, (64, 67))
    assert maxdiff(ie.unsharp_mask(img, amount), ref.unsharp_mask(img, amount)) == 0


def test_unsharp_fractional_amount_exact(rng):
    img = _rand(rng, (64, 67))
    assert maxdiff(ie.unsharp_mask(img, 1.5), ref.unsharp_mask(img, 1.5)) == 0


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("shape", SHAPES)
def test_median_exact(rng, k, shape):
    img = _rand(rng, shape)
    got = ie.median_blur(img, k)
    assert maxdiff(got, per_plane_ref(lambda p: ref.median_blur(p, k), img)) == 0


@pytest.mark.parametrize("clip,grid", [(2.0, (8, 8)), (40.0, (8, 8)), (3.5, (4, 6))])
@pytest.mark.parametrize("hw", [(64, 64), (128, 131), (250, 250)])
def test_clahe_1lsb_vs_ref(rng, clip, grid, hw):
    img = _rand(rng, hw)
    got = ie.clahe(img, clip, grid)
    assert maxdiff(got, ref.clahe(img, clip, grid)) <= 1


def test_clahe_1lsb_vs_cv2(rng):
    cv2 = pytest.importorskip("cv2")
    cv2.setNumThreads(1)
    for hw in [(128, 131), (250, 250), (256, 259)]:
        img = _rand(rng, hw)
        want = cv2.createCLAHE(2.0, (8, 8)).apply(img)
        assert maxdiff(ie.clahe(img, 2.0, (8, 8)), want) <= 1, hw


def test_wrong_dtype_raises():
    with pytest.raises(TypeError):
        ie.equalize_hist(np.zeros((8, 8), np.float32))


# ---------------------------------------------------------------- float32

def _randf(rng, shape):
    return (rng.random(shape, dtype=np.float32) * 300.0 - 20.0).astype(np.float32)


def test_float_gaussian_vs_ref(rng):
    x = _randf(rng, (2, 64, 67))
    got = ie.gaussian_blur(x, 5, 0.0)
    want = np.stack([ref.gaussian_blur(p, 5, 0.0) for p in x])
    assert np.abs(np.asarray(got) - want).max() < 1e-3


def test_float_unsharp_vs_ref(rng):
    x = _randf(rng, (1, 64, 67))
    got = ie.unsharp_mask(x, 1.5)
    assert np.abs(np.asarray(got) - ref.unsharp_mask(x[0], 1.5)[None]).max() < 1e-2


def test_float_laplacian(rng):
    x = _randf(rng, (1, 64, 67))
    got = ie.laplacian(x)
    assert np.asarray(got).dtype == np.float32
    assert np.abs(np.asarray(got) - ref.laplacian(x[0])[None]).max() < 1e-3


def test_convert_scale_abs_f32_matches_cv2(rng):
    cv2 = pytest.importorskip("cv2")
    cv2.setNumThreads(1)
    x = (rng.random((48, 53), dtype=np.float32) * 600.0 - 100.0).astype(np.float32)
    want = cv2.convertScaleAbs(x, alpha=1.0, beta=0.0)
    got = np.asarray(ie.convert_scale_abs(x, 1.0, 0.0))
    assert got.dtype == np.uint8
    assert maxdiff(got, want) == 0


def test_float_median_stretch_gamma_log(rng):
    x = _randf(rng, (2, 33, 47))
    assert np.abs(np.asarray(ie.median_blur(x, 3)) - np.stack([ref.median_blur(p, 3) for p in x])).max() == 0
    assert np.abs(np.asarray(ie.contrast_stretch(x)) - np.stack([ref.contrast_stretch(p) for p in x])).max() < 1e-3
    xp = np.abs(x)
    # device f32 transcendentals (pow/log) can be ~1e-4 relative vs CPU
    # libm — tolerances sized for accelerators (discovered running this tier
    # on-device), scaled by the 0..255-ish value range
    assert np.abs(np.asarray(ie.gamma(xp, 2.2)) - np.stack([ref.gamma_transform(p, 2.2) for p in xp])).max() < 2e-2
    assert np.abs(np.asarray(ie.log_transform(xp)) - np.stack([ref.log_transform(p) for p in xp])).max() < 2e-2


def test_float_vs_cv2_direct(rng):
    cv2 = pytest.importorskip("cv2")
    cv2.setNumThreads(1)
    x = _randf(rng, (64, 67))
    assert np.abs(np.asarray(ie.gaussian_blur(x, 5)) - cv2.GaussianBlur(x, (5, 5), 0)).max() < 1e-3
    blur = cv2.GaussianBlur(x, (5, 5), 0)
    want = cv2.addWeighted(x, 2.0, blur, -1.0, 0)
    assert np.abs(np.asarray(ie.unsharp_mask(x, 1.0)) - want).max() < 1e-2
    assert np.abs(np.asarray(ie.median_blur(x, 3)) - cv2.medianBlur(x, 3)).max() == 0


def test_float_rejected_for_histeq(rng):
    with pytest.raises(TypeError):
        ie.equalize_hist(_randf(rng, (8, 8)))
    with pytest.raises(TypeError):
        ie.clahe(_randf(rng, (8, 8)))


@pytest.mark.parametrize("k", [9, 11])
def test_gaussian_large_k_vs_cv2(rng, k):
    cv2 = pytest.importorskip("cv2")
    cv2.setNumThreads(1)
    img = rng.integers(0, 256, (64, 67), dtype=np.uint8)
    want = cv2.GaussianBlur(img, (k, k), 0)
    assert maxdiff(ie.gaussian_blur(img, k), want) == 0
    assert maxdiff(ref.gaussian_blur(img, k), want) == 0


def test_gaussian_k13_bitexact(rng):
    cv2 = pytest.importorskip("cv2")
    cv2.setNumThreads(1)
    img = rng.integers(0, 256, (64, 67), dtype=np.uint8)
    want = cv2.GaussianBlur(img, (13, 13), 0)
    assert maxdiff(ie.gaussian_blur(img, 13), want) == 0


@pytest.mark.parametrize("out_range", [(10.0, 200.0), (50.0, 100.0)])
def test_contrast_stretch_range(rng, out_range):
    cv2 = pytest.importorskip("cv2")
    cv2.setNumThreads(1)
    img = rng.integers(30, 200, (64, 67), dtype=np.uint8)
    want = cv2.normalize(img, None, out_range[0], out_range[1], cv2.NORM_MINMAX)
    assert maxdiff(ie.contrast_stretch(img, out_range), want) == 0
    assert maxdiff(ref.contrast_stretch(img, out_range), want) == 0


@pytest.mark.parametrize("alpha,beta", [(1.2, 10.0), (0.5, -20.0), (-1.0, 255.0)])
def test_convert_scale_abs(rng, alpha, beta):
    cv2 = pytest.importorskip("cv2")
    cv2.setNumThreads(1)
    img = _rand(rng, (64, 67))
    want = cv2.convertScaleAbs(img, alpha=alpha, beta=beta)
    assert maxdiff(ie.convert_scale_abs(img, alpha, beta), want) == 0
    assert maxdiff(ref.convert_scale_abs(img, alpha, beta), want) == 0


def test_histogram_matches_bincount(rng):
    img = _rand(rng, (2, 33, 47, 3))
    h = np.asarray(ie.histogram(img))
    assert h.shape == (2, 3, 256)
    for n in range(2):
        for c in range(3):
            want = np.bincount(img[n, :, :, c].ravel(), minlength=256)
            assert np.array_equal(h[n, c], want)
    g = _rand(rng, (37, 53))
    assert np.array_equal(np.asarray(ie.histogram(g)), np.bincount(g.ravel(), minlength=256))


def test_equalize_hist_video_mode(rng):
    batch = rng.integers(0, 256, (4, 33, 47), dtype=np.uint8)
    got = np.asarray(ie.equalize_hist(batch, per_frame=False))
    hist = np.bincount(batch.ravel(), minlength=256)
    from imageenhancement_mp_tpu.ref.ops import _equalize_lut

    want = _equalize_lut(hist, batch.size)[batch]
    assert maxdiff(got, want) == 0
    # all frames share the LUT: same input value -> same output everywhere
    per = np.asarray(ie.equalize_hist(batch))
    assert not np.array_equal(got, per)  # differs from per-frame mode


def test_equalize_hist_pooled_per_channel(rng):
    """api.equalize_hist(per_frame=False): per-channel pooling across frames."""
    import imageenhancement_mp_tpu as ie
    from imageenhancement_mp_tpu.ref import ops as ref_ops

    N, H, W, C = 5, 19, 23, 3
    x = rng.integers(0, 256, (N, H, W, C), dtype=np.uint8)
    got = np.asarray(ie.equalize_hist(x, per_frame=False))
    want = np.empty_like(x)
    for c in range(C):
        stack = x[..., c]
        hist = np.bincount(stack.ravel(), minlength=256)
        lut = ref_ops._equalize_lut(hist, stack.size)
        want[..., c] = lut[stack]
    assert np.array_equal(got, want)

    # per_channel=False: one LUT pooled over every plane
    got_all = np.asarray(ie.equalize_hist(x, per_frame=False, per_channel=False))
    hist = np.bincount(x.ravel(), minlength=256)
    lut = ref_ops._equalize_lut(hist, x.size)
    assert np.array_equal(got_all, lut[x])

    # a single [H,W,C] image in pooled-per-channel mode == per-frame mode
    one = x[0]
    assert np.array_equal(
        np.asarray(ie.equalize_hist(one, per_frame=False)),
        np.asarray(ie.equalize_hist(one)),
    )


def test_channels_last_escape_hatch(rng):
    """[N,H,W<=4] grayscale batches are expressible via channels_last=False."""
    import imageenhancement_mp_tpu as ie
    from imageenhancement_mp_tpu import ref

    x = rng.integers(0, 256, (6, 32, 3), dtype=np.uint8)  # 6 narrow gray frames
    got = np.asarray(ie.equalize_hist(x, channels_last=False))
    want = np.stack([ref.equalize_hist(p) for p in x])
    assert np.array_equal(got, want)
    # default (channels_last=True) reads the same array as one [H,W,C] image
    got_hwc = np.asarray(ie.equalize_hist(x))
    want_hwc = np.stack([ref.equalize_hist(x[..., c]) for c in range(3)], axis=-1)
    assert np.array_equal(got_hwc, want_hwc)
    # filters take it too
    got_g = np.asarray(ie.gaussian_blur(x, 3, channels_last=False))
    want_g = np.stack([ref.gaussian_blur(p, 3, 0.0) for p in x])
    assert np.array_equal(got_g, want_g)


def test_contrast_stretch_arbitrary_ranges_exact(rng):
    """Device stretch is bit-exact vs cv2 for arbitrary float ranges (the
    round-2 double-float scale/shift + FMA-emulation path), u8 and u16."""
    cv2 = pytest.importorskip("cv2")
    from imageenhancement_mp_tpu.ops.pointwise import contrast_stretch_planes

    for dt, hi_v in [(np.uint8, 256), (np.uint16, 65536)]:
        for _ in range(25):
            p = rng.integers(0, hi_v, (2, 9, 11), dtype=dt)
            a = float(rng.uniform(-200, hi_v * 1.2))
            b = a + float(rng.uniform(0.0, hi_v * 1.2))
            got = np.asarray(contrast_stretch_planes(p, (a, b)))
            want = np.stack([cv2.normalize(q, None, a, b, cv2.NORM_MINMAX) for q in p])
            assert np.array_equal(got, want), (dt, a, b)
    # constant plane edge case
    const = np.full((1, 6, 6), 77, np.uint8)
    got = np.asarray(contrast_stretch_planes(const, (10.5, 200.0)))
    want = cv2.normalize(const[0], None, 10.5, 200.0, cv2.NORM_MINMAX)[None]
    assert np.array_equal(got, want)


def test_pooled_histeq_int32_overflow_guard():
    """Pooled totals past 2^31 pixels must raise at trace time, not wrap."""
    import jax
    import jax.numpy as jnp
    from imageenhancement_mp_tpu.ops.histogram import equalize_hist_global_planes

    big = jax.ShapeDtypeStruct((1100, 1080, 1920), jnp.uint8)  # 2.28e9 px
    with pytest.raises(ValueError, match="overflow"):
        jax.eval_shape(equalize_hist_global_planes, big)
    # just under the limit traces fine
    ok = jax.ShapeDtypeStruct((1000, 1080, 1920), jnp.uint8)  # 2.07e9 px
    out = jax.eval_shape(equalize_hist_global_planes, ok)
    assert out.shape == ok.shape


@pytest.mark.parametrize("kh,kw,sx,sy", [(3, 7, 0.0, 0.0), (5, 5, 1.2, 2.4), (9, 3, 0.0, 1.1), (0, 5, 2.0, 0.0)])
def test_gaussian_rect_sigma_y_exact(rng, kh, kw, sx, sy):
    """cv2's full GaussianBlur surface: rectangular ksize + sigmaY (and a
    0-dim derived from sigma) — exact vs the oracle for u8 and u16."""
    for dt, hi in [(np.uint8, 256), (np.uint16, 65536)]:
        img = rng.integers(0, hi, (48, 53), dtype=dt)
        got = ie.gaussian_blur(img, (kh, kw), sx, sy)
        want = ref.gaussian_blur(img, (kh, kw), sx, sy)
        assert maxdiff(got, want) == 0, (dt, kh, kw)


# ------------------------------------------------- addWeighted / cvt_gray


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_add_weighted_device_vs_ref(rng, dt):
    for shape in [(37, 53), (2, 33, 47, 3)]:
        if dt is np.float32:
            a = (rng.random(shape) * 2000 - 700).astype(np.float32)
            b = (rng.random(shape) * 2000 - 700).astype(np.float32)
        else:
            lo, hi = (0, 256) if dt is np.uint8 else (
                (0, 65536) if dt is np.uint16 else (-32768, 32768))
            a = rng.integers(lo, hi, shape).astype(dt)
            b = rng.integers(lo, hi, shape).astype(dt)
        al, be, ga = 1.7, -0.6, 41.25
        got = np.asarray(ie.add_weighted(a, al, b, be, ga))
        want = ref.add_weighted(a, al, b, be, ga)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


def test_add_weighted_rejects_mismatch(rng):
    a = _rand(rng, (8, 8))
    with pytest.raises(TypeError):
        ie.add_weighted(a, 1.0, a.astype(np.uint16), 1.0)
    with pytest.raises(ValueError):
        ie.add_weighted(a, 1.0, _rand(rng, (8, 9)), 1.0)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_cvt_gray_device_vs_ref(rng, dt, order):
    for shape in [(33, 47, 3), (21, 17, 4), (2, 33, 47, 3)]:
        if dt is np.float32:
            img = (rng.random(shape) * 1000 - 300).astype(np.float32)
        else:
            img = rng.integers(0, 256 if dt is np.uint8 else 65536, shape).astype(dt)
        got = np.asarray(ie.cvt_gray(img, order))
        if img.ndim == 4:
            want = np.stack([ref.cvt_gray(f, order) for f in img])
        else:
            want = ref.cvt_gray(img, order)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.array_equal(got, want)


def test_cvt_gray_feeds_equalize(rng):
    """The judged front path: color batch → grayscale → equalize_hist."""
    batch = _rand(rng, (2, 40, 50, 3))
    gray = ie.cvt_gray(batch)
    out = np.asarray(ie.equalize_hist(gray))
    want = np.stack([ref.equalize_hist(ref.cvt_gray(f)) for f in batch])
    assert np.array_equal(out, want)


def test_unsharp_f32_device_vs_ref(rng):
    """The f32 blend itself is bitwise (test_add_weighted_device_vs_ref);
    through the full unsharp the device conv's accumulation differs from
    the oracle at ULP level, so the end-to-end check uses the established
    f32-filter tolerance."""
    img = (rng.random((40, 50)) * 500 - 100).astype(np.float32)
    for amt in (0.7, 1.0, 2.5):
        got = np.asarray(ie.unsharp_mask(img, amount=amt))
        want = ref.unsharp_mask(img, amt, 5, 0.0)
        assert np.abs(got - want).max() < 1e-3


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_box_blur_device_vs_ref(rng, dt):
    for shape in SHAPES:
        if dt is np.float32:
            img = (rng.random(shape) * 900 - 300).astype(np.float32)
        else:
            lo, hi = (0, 256) if dt is np.uint8 else (
                (0, 65536) if dt is np.uint16 else (-32768, 32768))
            img = rng.integers(lo, hi, shape).astype(dt)
        for ks in (3, (5, 7), (1, 9)):
            got = np.asarray(ie.box_blur(img, ks))
            want = per_plane_ref(lambda p: ref.box_blur(p, ks), img)
            if dt is np.float32:
                assert np.abs(got - want).max() < 1e-3
            else:
                assert maxdiff(got, want) == 0


def test_box_blur_rejects_even_k(rng):
    with pytest.raises(ValueError):
        ie.box_blur(_rand(rng, (8, 8)), 4)


# ------------------------------------------------------------- bilateral


def test_bilateral_gray_device_vs_ref(rng):
    for shape in [(37, 53), (4, 37, 53)]:
        img = _rand(rng, shape)
        for d, sc, ss in [(5, 25.0, 5.0), (9, 75.0, 75.0), (0, 40.0, 3.0)]:
            got = np.asarray(ie.bilateral_filter(img, d, sc, ss))
            want = per_plane_ref(lambda p: ref.bilateral_filter(p, d, sc, ss), img)
            assert maxdiff(got, want) == 0, (shape, d, sc, ss)


def test_bilateral_color_device_vs_ref(rng):
    for shape in [(30, 31, 3), (2, 24, 25, 3)]:
        img = _rand(rng, shape)
        got = np.asarray(ie.bilateral_filter(img, 7, 40.0, 8.0))
        if img.ndim == 4:
            want = np.stack([ref.bilateral_filter(f, 7, 40.0, 8.0) for f in img])
        else:
            want = ref.bilateral_filter(img, 7, 40.0, 8.0)
        assert maxdiff(got, want) == 0


def test_bilateral_hw1_and_rejects(rng):
    img1 = _rand(rng, (20, 21, 1))
    got = np.asarray(ie.bilateral_filter(img1, 5, 30.0, 6.0))
    want = ref.bilateral_filter(img1[..., 0], 5, 30.0, 6.0)[..., None]
    assert maxdiff(got, want) == 0
    with pytest.raises(ValueError):
        ie.bilateral_filter(_rand(rng, (8, 9, 4)), 5, 30.0, 6.0)
    with pytest.raises(ValueError):
        ie.bilateral_filter(_rand(rng, (8, 9)), 5, 0.0, 6.0)
    with pytest.raises(TypeError):
        ie.bilateral_filter(np.zeros((8, 9), np.uint16), 5, 30.0, 6.0)


# ------------------------------------------------------------- threshold


@pytest.mark.parametrize("typ", ["binary", "binary_inv", "trunc", "tozero", "tozero_inv"])
def test_threshold_device_vs_ref(rng, typ):
    for dt in (np.uint8, np.uint16, np.int16, np.float32):
        if dt is np.float32:
            img = (rng.random((4, 30, 31)) * 600 - 150).astype(np.float32)
            t, mv = 80.4, 500.2
        else:
            lo, hi = (0, 256) if dt is np.uint8 else (
                (0, 65536) if dt is np.uint16 else (-32768, 32768))
            img = rng.integers(lo, hi, (4, 30, 31)).astype(dt)
            t, mv = (100.7, 210.3) if dt is np.uint8 else (1000.5, 40000.0)
        ret, got = ie.threshold(img, t, mv, typ)
        want = np.stack([ref.threshold(p, t, mv, typ)[1] for p in img])
        assert np.array_equal(np.asarray(got), want), (typ, dt)


@pytest.mark.parametrize("method", ["otsu", "triangle"])
def test_threshold_auto_device_per_plane(rng, method):
    img = _rand(rng, (2, 33, 47, 3))
    ret, got = ie.threshold(img, method=method)
    assert np.asarray(ret).shape == (2, 3)
    for n in range(2):
        for c in range(3):
            r, o = ref.threshold(img[n, :, :, c], method=method)
            assert ret[n, c] == r
            assert np.array_equal(np.asarray(got)[n, :, :, c], o)


def test_threshold_auto_rejects_non_u8(rng):
    with pytest.raises(TypeError):
        ie.threshold(np.zeros((8, 8), np.uint16), method="otsu")


# ---------------------------------------------------------- YCrCb / luma


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("code", ["rgb2ycrcb", "bgr2ycrcb", "ycrcb2rgb", "ycrcb2bgr"])
def test_cvt_color_ycrcb_device_vs_ref(rng, dt, code):
    for shape in [(33, 47, 3), (2, 24, 25, 3)]:
        if dt is np.float32:
            img = (rng.random(shape) * 3 - 1).astype(np.float32)
        else:
            img = rng.integers(0, 256 if dt is np.uint8 else 65536, shape).astype(dt)
        got = np.asarray(ie.cvt_color(img, code))
        fn = (ref.rgb_to_ycrcb if code.endswith("2ycrcb") else ref.ycrcb_to_rgb)
        order = ("bgr" if (code.startswith("b") or code.endswith("bgr")) else "rgb")
        if img.ndim == 4:
            want = np.stack([fn(f, order) for f in img])
        else:
            want = fn(img, order)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want), (dt, code, shape)


def test_equalize_luma_device_vs_ref(rng):
    for shape in [(40, 50, 3), (2, 30, 31, 3)]:
        img = _rand(rng, shape)
        got = np.asarray(ie.equalize_luma(img))

        def one(f):
            ycc = ref.rgb_to_ycrcb(f)
            y = ref.equalize_hist(ycc[..., 0])
            return ref.ycrcb_to_rgb(
                np.concatenate([y[..., None], ycc[..., 1:]], axis=-1))

        want = one(img) if img.ndim == 3 else np.stack([one(f) for f in img])
        assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        ie.equalize_luma(_rand(rng, (8, 9)))
    with pytest.raises(TypeError):
        ie.equalize_luma(np.zeros((8, 9, 3), np.uint16))


@pytest.mark.parametrize("method", ["mean", "gaussian"])
def test_adaptive_threshold_device_vs_ref(rng, method):
    for shape in [(37, 53), (2, 33, 47, 3)]:
        img = _rand(rng, shape)
        for bs, C, typ in [(3, 2.0, "binary"), (11, -4.3, "binary_inv"), (9, 0.0, "binary")]:
            got = np.asarray(ie.adaptive_threshold(img, 255.0, method, typ, bs, C))
            want = per_plane_ref(
                lambda p: ref.adaptive_threshold(p, 255.0, method, typ, bs, C), img)
            assert np.array_equal(got, want), (method, shape, bs, C, typ)


def test_adaptive_threshold_rejects(rng):
    with pytest.raises(TypeError):
        ie.adaptive_threshold(np.zeros((8, 8), np.uint16))
    with pytest.raises(ValueError):
        ie.adaptive_threshold(_rand(rng, (8, 8)), block_size=4)


@pytest.mark.parametrize("op", ["erode", "dilate", "open", "close", "gradient", "tophat", "blackhat"])
def test_morphology_device_vs_ref(rng, op):
    for dt in (np.uint8, np.int16, np.float32):
        for shape in [(37, 53), (2, 24, 25, 3)]:
            if dt is np.float32:
                img = (rng.random(shape) * 500 - 100).astype(np.float32)
            else:
                lo, hi = (0, 256) if dt is np.uint8 else (-32768, 32768)
                img = rng.integers(lo, hi, shape).astype(dt)
            got = np.asarray(ie.morphology_ex(img, op, (3, 5)))
            want = per_plane_ref(lambda p: ref.morphology(p, op, (3, 5)), img)
            assert np.array_equal(got, want), (op, dt, shape)


def test_erode_dilate_iterations_device(rng):
    img = _rand(rng, (40, 41))
    assert np.array_equal(np.asarray(ie.erode(img, 3, 3)), ref.erode(img, 3, 3))
    assert np.array_equal(np.asarray(ie.dilate(img, (2, 4), 2)), ref.dilate(img, (2, 4), 2))


def test_threshold_huge_thresh_saturates_not_overflows(rng):
    """An out-of-int32 thresh must saturate like cv2/oracle, not raise."""
    img = _rand(rng, (8, 9))
    for t in (3e9, -3e9):
        for typ in ("binary", "trunc", "tozero"):
            got = np.asarray(ie.threshold(img, t, 255.0, typ)[1])
            want = ref.threshold(img, t, 255.0, typ)[1]
            assert np.array_equal(got, want), (t, typ)


def test_box_blur_u16_overflow_guard(rng):
    with pytest.raises(ValueError, match="overflow"):
        ie.box_blur(rng.integers(0, 65536, (400, 400)).astype(np.uint16), 201)


@pytest.mark.parametrize("dx,dy,k", [(1, 0, 3), (0, 1, 5), (1, 1, 7), (2, 0, 3), (1, 0, -1)])
def test_sobel_device_vs_ref(rng, dx, dy, k):
    for dt in (np.uint8, np.uint16, np.int16):
        lo, hi = (0, 256) if dt is np.uint8 else (
            (0, 65536) if dt is np.uint16 else (-32768, 32768))
        for shape in [(37, 53), (2, 24, 25, 3)]:
            img = rng.integers(lo, hi, shape).astype(dt)
            got = np.asarray(ie.sobel(img, dx, dy, k, delta=7.0))
            want = per_plane_ref(lambda p: ref.sobel(p, dx, dy, k, 1.0, 7.0), img)
            assert got.dtype == want.dtype
            assert np.array_equal(got, want), (dt, dx, dy, k)


def test_scharr_device(rng):
    img = _rand(rng, (33, 47))
    got = np.asarray(ie.scharr(img, 0, 1))
    assert np.array_equal(got, ref.sobel(img, 0, 1, -1))


def test_sobel_f32_device_vs_ref(rng):
    img = (rng.random((40, 41)) * 500 - 100).astype(np.float32)
    got = np.asarray(ie.sobel(img, 1, 0, 5))
    want = ref.sobel(img, 1, 0, 5)
    assert np.abs(got - want).max() < 1e-2


@pytest.mark.parametrize("code", ["rgb2hsv", "bgr2hsv", "hsv2rgb", "hsv2bgr"])
def test_cvt_color_hsv_device_vs_ref(rng, code):
    for shape in [(33, 47, 3), (2, 24, 25, 3)]:
        img = rng.integers(0, 256, shape).astype(np.uint8)
        if code.startswith("hsv"):
            img[..., 0] = (img[..., 0] % 180).astype(np.uint8)
        got = np.asarray(ie.cvt_color(img, code))
        fn = ref.rgb_to_hsv if code.endswith("2hsv") else ref.hsv_to_rgb
        order = "bgr" if (code.startswith("b") or code.endswith("bgr")) else "rgb"
        want = (np.stack([fn(f, order) for f in img]) if img.ndim == 4
                else fn(img, order))
        if code.endswith("2hsv"):
            assert np.array_equal(got, want), (code, shape)
        else:
            # inverse: XLA:CPU's codegen-level FMA contraction can flip
            # ~5e-5 of pixels by ±1 vs the strict-per-op oracle (the CLAHE
            # precedent, docs/PARITY.md backend nuance)
            d = np.abs(got.astype(np.int64) - want.astype(np.int64))
            assert int(d.max()) <= 1, (code, shape)
            assert (d > 0).mean() < 1e-3
    with pytest.raises(TypeError):
        ie.cvt_color(np.zeros((8, 9, 3), np.uint16), "rgb2hsv")


def test_sobel_huge_delta_saturates_like_ref(rng):
    """A delta near ±2³¹ must saturate exactly like the oracle, never wrap
    int32 (the pre-fix device flipped sign on the brightest gradients)."""
    img = np.zeros((16, 32), np.uint16)
    img[:, ::4] = 65535
    for de in (2147400000.0, -4e9, 2.5e9):
        got = np.asarray(ie.sobel(img, 0, 1, 3, delta=de))
        want = ref.sobel(img, 0, 1, 3, 1.0, de)
        assert np.array_equal(got, want), de


def test_sobel_large_k_rejected_for_ints(rng):
    with pytest.raises(ValueError, match="float32"):
        ie.sobel(_rand(rng, (40, 41)), 1, 0, 15)
    # the same kernel works through f32 (cv2's only well-defined path there)
    imgf = _rand(rng, (40, 41)).astype(np.float32)
    out = np.asarray(ie.sobel(imgf, 1, 0, 15))
    assert out.dtype == np.float32


def test_sobel_scale_path_device_vs_ref(rng):
    img = _rand(rng, (40, 43))
    got = np.asarray(ie.sobel(img, 1, 0, 3, scale=0.37, delta=11.7))
    want = ref.sobel(img, 1, 0, 3, 0.37, 11.7)
    # device folds in f32 where the oracle uses f64 — ±1 at u8 magnitudes
    assert int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max()) <= 1


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_pyramids_device_vs_ref(rng, dt):
    for shape in [(33, 47), (2, 24, 25, 3)]:
        if dt is np.float32:
            img = (rng.random(shape) * 500 - 100).astype(np.float32)
        else:
            lo, hi = (0, 256) if dt is np.uint8 else (
                (0, 65536) if dt is np.uint16 else (-32768, 32768))
            img = rng.integers(lo, hi, shape).astype(dt)
        gd = np.asarray(ie.pyr_down(img))
        gu = np.asarray(ie.pyr_up(img))
        wd = per_plane_ref(ref.pyr_down, img)
        wu = per_plane_ref(ref.pyr_up, img)
        if dt is np.float32:
            assert np.abs(gd - wd).max() < 1e-3 and np.abs(gu - wu).max() < 1e-3
        else:
            assert np.array_equal(gd, wd) and np.array_equal(gu, wu)


def test_pyramid_roundtrip_shapes(rng):
    img = _rand(rng, (33, 47))
    down = ie.pyr_down(img)
    assert np.asarray(down).shape == (17, 24)
    up = ie.pyr_up(np.asarray(down))
    assert np.asarray(up).shape == (34, 48)


def test_filter2d_device_vs_ref(rng):
    for dt in (np.uint8, np.uint16, np.int16, np.float32):
        for shape in [(30, 33), (2, 20, 21, 3)]:
            if dt is np.float32:
                img = (rng.random(shape) * 500 - 100).astype(np.float32)
            else:
                lo, hi = (0, 255) if dt is np.uint8 else (
                    (0, 65535) if dt is np.uint16 else (-32768, 32767))
                img = rng.integers(lo, hi + 1, shape).astype(dt)
            for k in (np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float32),
                      (rng.random((3, 5)) * 0.4).astype(np.float32)):
                got = np.asarray(ie.filter2d(img, k, 3.3))
                want = per_plane_ref(lambda p: ref.filter2d(p, k, 3.3), img)
                if dt is np.float32:
                    assert np.abs(got - want).max() < 1e-2
                else:
                    # double-float device == f64 oracle (CPU backend may
                    # FMA-contract the error terms on rare boundary px)
                    assert maxdiff(got, want) <= 1


def test_filter2d_sharpen_kernel_exact_vs_cv2(rng):
    cv2 = pytest.importorskip("cv2")
    cv2.setNumThreads(1)
    img = _rand(rng, (40, 43))
    k = np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]], np.float32)
    want = cv2.filter2D(img, -1, k)
    got = np.asarray(ie.filter2d(img, k))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_laplacian_ksize_device_vs_ref(rng, k):
    for dt in (np.uint8, np.uint16, np.int16):
        lo, hi = (0, 256) if dt is np.uint8 else (
            (0, 65536) if dt is np.uint16 else (-32768, 32768))
        for shape in [(30, 33), (2, 20, 21, 3)]:
            img = rng.integers(lo, hi, shape).astype(dt)
            got = np.asarray(ie.laplacian(img, k, 4.0))
            want = per_plane_ref(lambda p: ref.laplacian(p, k, 4.0), img)
            assert got.dtype == want.dtype
            assert np.array_equal(got, want), (dt, k, shape)


def test_filter2d_delta_half_even_ties(rng):
    """round(acc + δ) must resolve δ=.5 ties by parity JOINTLY (a
    pre-rounded δ flips every odd pixel)."""
    cv2 = pytest.importorskip("cv2")
    cv2.setNumThreads(1)
    img = np.arange(16, dtype=np.uint8).reshape(4, 4)
    k1 = np.ones((1, 1), np.float32)
    for de in (0.5, 1.5, -0.5, 11.5, 0.25):
        got = np.asarray(ie.filter2d(img, k1, de))
        want = cv2.filter2D(img, -1, k1, delta=de)
        assert np.array_equal(got, want), de
    # huge magnitudes saturate like cv2, never wrap
    k = np.full((1, 1), -4210752.0, np.float32)
    im = np.full((4, 4), 255, np.uint8)
    assert np.array_equal(np.asarray(ie.filter2d(im, k, 3e9)),
                          cv2.filter2D(im, -1, k, delta=3e9))


def test_filter2d_big_integral_kernel_fallback_exact(rng):
    """Integral kernels past the int32 bound route through double-float
    and REMAIN exact vs the f64 oracle."""
    kb = rng.integers(-80, 81, (7, 7)).astype(np.float32)
    img = rng.integers(0, 65536, (20, 21)).astype(np.uint16)
    assert np.array_equal(np.asarray(ie.filter2d(img, kb, 5.0)),
                          ref.filter2d(img, kb, 5.0))


def test_laplacian_huge_delta_saturates(rng):
    """ksize≥3 delta combine must saturate like the oracle (pre-fix it
    wrapped int32 to the wrong extreme)."""
    img = np.zeros((16, 16), np.uint8)
    img[::2] = 255
    for de in (2134900927.0, -3e9, 2.5e9):
        got = np.asarray(ie.laplacian(img, 7, de))
        want = ref.laplacian(img, 7, de)
        assert np.array_equal(got, want), de
    u16 = rng.integers(0, 65536, (12, 13)).astype(np.uint16)
    got = np.asarray(ie.laplacian(u16, 7, 2.1e9))
    assert np.array_equal(got, ref.laplacian(u16, 7, 2.1e9))
