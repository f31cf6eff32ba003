"""int16 (CV_16S) paths vs cv2 directly and vs the NumPy oracle.

cv2 has a 16S path for the filters, addWeighted, normalize and
convertScaleAbs (probe round 2): median/Laplacian/addWeighted/normalize/
convertScaleAbs are pinned EXACT; GaussianBlur goes through cv2's float
filter engine whose SIMD accumulation order is not portably reproducible —
the f32 separable conv here is within ±1 LSB (200-config fuzz), the
documented i16 budget (docs/PARITY.md)."""

import numpy as np
import jax.numpy as jnp
import pytest

import imageenhancement_mp_tpu as ie
from imageenhancement_mp_tpu import ref

try:
    import cv2

    cv2.setNumThreads(1)
except ImportError:  # pragma: no cover
    cv2 = None

requires_cv2 = pytest.mark.skipif(cv2 is None, reason="cv2 unavailable")


def maxdiff(a, b):
    return int(
        np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max()
    )


def rand_i16(rng, shape):
    return rng.integers(-32768, 32768, shape, dtype=np.int16)


@requires_cv2
@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (5, 0.0), (9, 0.0), (5, 1.7), (0, 2.5)])
def test_gaussian_i16_vs_cv2_within_1(rng, ksize, sigma):
    x = rand_i16(rng, (56, 48))
    got = np.asarray(ie.gaussian_blur(x, ksize, sigma))
    k = ksize if ksize else (int(round(sigma * 4 * 2 + 1)) | 1)
    want = cv2.GaussianBlur(x, (k, k), sigma)
    assert maxdiff(got, want) <= 1
    # oracle agrees with the device within the same budget
    assert maxdiff(got, ref.gaussian_blur(x, ksize, sigma)) <= 1


@requires_cv2
@pytest.mark.parametrize("ksize", [3, 5])
def test_median_i16_exact_vs_cv2(rng, ksize):
    x = rand_i16(rng, (41, 37))
    got = np.asarray(ie.median_blur(x, ksize))
    assert maxdiff(got, cv2.medianBlur(x, ksize)) == 0
    assert maxdiff(got, ref.median_blur(x, ksize)) == 0


@requires_cv2
def test_laplacian_i16_exact(rng):
    x = rand_i16(rng, (30, 33))
    got = np.asarray(ie.laplacian(x))
    assert got.dtype == np.int32
    want32 = cv2.Laplacian(x, cv2.CV_32F, ksize=1).astype(np.int64)
    assert maxdiff(got, want32) == 0
    # sharpen saturates to int16 (cv2 ddepth=-1 convention)
    sh = np.asarray(ie.laplacian_sharpen(x))
    assert sh.dtype == np.int16
    assert maxdiff(sh, ref.laplacian_sharpen(x)) == 0


@requires_cv2
@pytest.mark.parametrize("amount", [1.0, 2.0, 0.7, 1.55])
def test_unsharp_i16_addweighted_exact(rng, amount):
    """The addWeighted chain is exact; feed cv2 OUR blur so the ±1 Gaussian
    budget doesn't mask an addWeighted discrepancy."""
    x = rand_i16(rng, (36, 44))
    blur = np.asarray(ie.gaussian_blur(x, 5, 0.0))
    want = cv2.addWeighted(x, 1.0 + amount, blur, -amount, 0)
    # reproduce via the oracle's FMA model on the same blur
    alpha = float(np.float32(1.0 + amount))
    beta = float(np.float32(-amount))
    t = np.float32(blur.astype(np.float64) * beta)
    fma = np.float32(x.astype(np.float64) * alpha + t.astype(np.float64))
    ours = np.clip(np.round(fma.astype(np.float64)), -32768, 32767).astype(np.int16)
    assert maxdiff(ours, want) == 0
    # end-to-end unsharp within the blur's ±1 (amplified ≤ 1+2a)
    got = np.asarray(ie.unsharp_mask(x, amount, 5, 0.0))
    assert maxdiff(got, cv2.addWeighted(x, 1.0 + amount, cv2.GaussianBlur(x, (5, 5), 0), -amount, 0)) <= int(1 + 2 * amount + 1)
    assert maxdiff(got, ref.unsharp_mask(x, amount, 5, 0.0)) == 0


@requires_cv2
@pytest.mark.parametrize("out_range", [(0.0, 255.0), (-100.5, 1000.25), (-32768.0, 32767.0)])
def test_contrast_stretch_i16_exact(rng, out_range):
    x = rand_i16(rng, (28, 31))
    got = np.asarray(ie.contrast_stretch(x, out_range))
    want = cv2.normalize(x, None, out_range[0], out_range[1], cv2.NORM_MINMAX)
    assert maxdiff(got, want) == 0
    assert maxdiff(got, ref.contrast_stretch(x, out_range)) == 0


@requires_cv2
def test_contrast_stretch_i16_constant_plane(rng):
    x = np.full((9, 9), -1234, np.int16)
    got = np.asarray(ie.contrast_stretch(x, (10.0, 200.0)))
    want = cv2.normalize(x, None, 10.0, 200.0, cv2.NORM_MINMAX)
    assert maxdiff(got, want) == 0


@requires_cv2
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.013, 200.0), (-0.4, -50.0)])
def test_convert_scale_abs_i16_exact(rng, alpha, beta):
    x = rand_i16(rng, (26, 29))
    got = np.asarray(ie.convert_scale_abs(x, alpha, beta))
    assert got.dtype == np.uint8
    assert maxdiff(got, cv2.convertScaleAbs(x, alpha=alpha, beta=beta)) == 0
    assert maxdiff(got, ref.convert_scale_abs(x, alpha, beta)) == 0


@requires_cv2
def test_i16_fuzz_pinned_ops(rng):
    """Random shapes/params over the EXACT i16 ops — all must be 0 LSB."""
    for _ in range(25):
        h, w = rng.integers(6, 48, 2)
        x = rand_i16(rng, (int(h), int(w)))
        k = int(rng.choice([3, 5]))
        assert maxdiff(ie.median_blur(x, k), cv2.medianBlur(x, k)) == 0
        a_, b_ = sorted(rng.uniform(-500, 1500, 2))
        assert maxdiff(
            ie.contrast_stretch(x, (a_, b_)),
            cv2.normalize(x, None, a_, b_, cv2.NORM_MINMAX),
        ) == 0
        al = float(rng.uniform(-2, 2))
        be = float(rng.uniform(-300, 300))
        assert maxdiff(
            ie.convert_scale_abs(x, al, be), cv2.convertScaleAbs(x, alpha=al, beta=be)
        ) == 0


def test_i16_rejected_where_cv2_rejects(rng):
    x = rand_i16(rng, (16, 16))
    for fn in (
        lambda: ie.equalize_hist(x),
        lambda: ie.clahe(x, 2.0, (4, 4)),
        lambda: ie.gamma(x, 2.2),
        lambda: ie.log_transform(x),
        lambda: ie.histogram(x),
        lambda: ie.apply_lut(x, np.arange(256, dtype=np.uint8)),
    ):
        with pytest.raises(TypeError):
            fn()


def test_i16_pipeline_and_spatial(rng):
    """i16 flows through make_pipeline and the spatial ops."""
    from imageenhancement_mp_tpu.pipeline import make_pipeline
    from imageenhancement_mp_tpu.parallel.sharding import make_mesh
    from imageenhancement_mp_tpu.parallel import spatial as sp

    x = rand_i16(rng, (2, 48, 40))
    pipe = make_pipeline([("median_blur", {"ksize": 3}), ("unsharp_mask", {"amount": 1.0})])
    want = np.stack([ref.unsharp_mask(ref.median_blur(p, 3), 1.0, 5, 0.0) for p in x])
    assert maxdiff(pipe(x), want) == 0

    mesh = make_mesh(8, axis_name="y")
    got = np.asarray(
        sp.shard_spatial(
            lambda p: sp.unsharp_mask_spatial(
                sp.median_blur_spatial(p, 3, axis_name="y"), 1.0, 5, 0.0, axis_name="y"
            ),
            mesh,
        )(sp.device_put_spatial(x, mesh))
    )
    assert maxdiff(got, want) == 0
    # spatial stretch with negative values
    got = np.asarray(
        sp.shard_spatial(
            lambda p: sp.contrast_stretch_spatial(p, (-50.0, 900.0), axis_name="y"),
            mesh,
        )(sp.device_put_spatial(x, mesh))
    )
    want = np.stack([ref.contrast_stretch(p, (-50.0, 900.0)) for p in x])
    assert maxdiff(got, want) == 0


@pytest.mark.parametrize("ksize", [3, 5])
def test_median_i16_planes(rng, ksize):
    """The sorting-network median takes i16 planes directly (signed
    compares, no widening)."""
    from imageenhancement_mp_tpu.ops.median import median_blur_planes

    x = rand_i16(rng, (2, 37, 53))
    got = np.asarray(median_blur_planes(x, ksize))
    want = np.stack([ref.median_blur(p, ksize) for p in x])
    assert maxdiff(got, want) == 0
