"""Separable Gaussian / unsharp planes ops at wide shapes vs the ``ref/``
oracle: dyadic and general-σ taps, rectangular kernels, integral,
fractional and saturating amounts, and a 256-entry LUT applied in the
same program (the flagship's hist-eq LUT → unsharp fusion)."""

import jax
import numpy as np
import pytest

from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops.filters import gaussian_blur_planes, unsharp_mask_planes
from imageenhancement_mp_tpu.ops.pointwise import apply_lut_planes


def maxdiff(a, b):
    return int(
        np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max()
    )


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("shape", [(2, 64, 256), (1, 96, 384)])
def test_dyadic_blur_bitexact(rng, k, shape):
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    got = gaussian_blur_planes(x, k, 0.0)
    want = np.stack([ref.gaussian_blur(p, k, 0.0) for p in x])
    assert maxdiff(got, want) == 0


@pytest.mark.parametrize("amount", [1.0, 2.0])
def test_unsharp_bitexact(rng, amount):
    x = rng.integers(0, 256, (2, 64, 256), dtype=np.uint8)
    got = unsharp_mask_planes(x, amount, 5, 0.0)
    want = np.stack([ref.unsharp_mask(p, amount, 5, 0.0) for p in x])
    assert maxdiff(got, want) == 0


def test_unsharp_fractional(rng):
    x = rng.integers(0, 256, (1, 64, 256), dtype=np.uint8)
    got = unsharp_mask_planes(x, 0.7, 5, 0.0)
    assert maxdiff(got, ref.unsharp_mask(x[0], 0.7, 5, 0.0)[None]) == 0


def test_rect_taps(rng):
    x = rng.integers(0, 256, (1, 64, 256), dtype=np.uint8)
    got = gaussian_blur_planes(x, (3, 5), 0.0)
    want = ref.gaussian_blur(x[0], (3, 5), 0.0)[None]
    assert maxdiff(got, want) == 0


@pytest.mark.parametrize("k,sigma", [(5, 1.5), (7, 0.0), (5, 2.3)])
def test_general_taps_bitexact(rng, k, sigma):
    x = rng.integers(0, 256, (2, 64, 256), dtype=np.uint8)
    got = gaussian_blur_planes(x, k, sigma)
    want = np.stack([ref.gaussian_blur(p, k, sigma) for p in x])
    assert maxdiff(got, want) == 0


def test_general_taps_unsharp(rng):
    x = rng.integers(0, 256, (1, 64, 256), dtype=np.uint8)
    got = unsharp_mask_planes(x, 1.0, 5, 1.5)
    assert maxdiff(got, ref.unsharp_mask(x[0], 1.0, 5, 1.5)[None]) == 0


def test_tall_plane(rng):
    x = rng.integers(0, 256, (1, 512, 256), dtype=np.uint8)
    got = unsharp_mask_planes(x, 1.0, 5, 0.0)
    assert maxdiff(got, ref.unsharp_mask(x[0], 1.0, 5, 0.0)[None]) == 0


def _lut_unsharp(x, luts, amount, sigma):
    return jax.jit(
        lambda v, l: unsharp_mask_planes(apply_lut_planes(v, l), amount, 5, sigma)
    )(x, luts)


@pytest.mark.parametrize("amount", [1.0, 0.5])
def test_lut_then_unsharp(rng, amount):
    x = rng.integers(0, 256, (2, 64, 256), dtype=np.uint8)
    lut = rng.integers(0, 256, (256,), dtype=np.uint8)
    got = _lut_unsharp(x, lut, amount, 0.0)
    want = np.stack([ref.unsharp_mask(lut[p], amount, 5, 0.0) for p in x])
    assert maxdiff(got, want) == 0


def test_lut_then_unsharp_general_sigma(rng):
    x = rng.integers(0, 256, (1, 64, 256), dtype=np.uint8)
    lut = rng.integers(0, 256, (256,), dtype=np.uint8)
    got = _lut_unsharp(x, lut, 1.0, 1.5)
    want = np.stack([ref.unsharp_mask(lut[p], 1.0, 5, 1.5) for p in x])
    assert maxdiff(got, want) == 0


def test_lut_per_plane(rng):
    x = rng.integers(0, 256, (3, 64, 256), dtype=np.uint8)
    luts = rng.integers(0, 256, (3, 256), dtype=np.uint8)
    got = _lut_unsharp(x, luts, 1.0, 0.0)
    want = np.stack([ref.unsharp_mask(luts[b][x[b]], 1.0, 5, 0.0) for b in range(3)])
    assert maxdiff(got, want) == 0


@pytest.mark.parametrize("shape", [(2, 64, 256), (1, 128, 384)])
def test_flagship_equalize_unsharp_wide(rng, shape):
    from imageenhancement_mp_tpu.pipeline import equalize_unsharp

    x = rng.integers(0, 256, shape, dtype=np.uint8)
    got = equalize_unsharp(x, 1.0, 5, 0.0)
    want = np.stack([ref.unsharp_mask(ref.equalize_hist(p), 1.0, 5, 0.0) for p in x])
    assert maxdiff(got, want) == 0


def test_flagship_negative_amount(rng):
    from imageenhancement_mp_tpu.pipeline import equalize_unsharp

    x = rng.integers(0, 256, (1, 64, 256), dtype=np.uint8)
    got = equalize_unsharp(x, -0.5, 5, 0.0)
    want = ref.unsharp_mask(ref.equalize_hist(x[0]), -0.5, 5, 0.0)[None]
    assert maxdiff(got, want) == 0


def test_extreme_values(rng):
    for fill in (0, 255):
        x = np.full((1, 64, 256), fill, np.uint8)
        got = unsharp_mask_planes(x, 2.0, 5, 0.0)
        want = ref.unsharp_mask(x[0], 2.0, 5, 0.0)[None]
        assert maxdiff(got, want) == 0, fill
