"""Gaussian, unsharp and median planes ops vs the ``ref/`` oracle across
odd widths, multi-stripe heights, u16/i16 and chained median → unsharp."""

import numpy as np
import pytest

from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops.filters import gaussian_blur_planes, unsharp_mask_planes
from imageenhancement_mp_tpu.ops.median import median_blur_planes


def maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("shape", [(2, 64, 67), (1, 37, 200)])
def test_gaussian_bitexact(rng, k, shape):
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    got = gaussian_blur_planes(x, k, 0.0)
    want = np.stack([ref.gaussian_blur(p, k, 0.0) for p in x])
    assert maxdiff(got, want) == 0


def test_gaussian_sigma(rng):
    x = rng.integers(0, 256, (1, 64, 67), dtype=np.uint8)
    got = gaussian_blur_planes(x, 5, 1.5)
    assert maxdiff(got, ref.gaussian_blur(x[0], 5, 1.5)[None]) == 0


@pytest.mark.parametrize("amount", [1.0, 2.0])
def test_unsharp_bitexact(rng, amount):
    x = rng.integers(0, 256, (2, 100, 131), dtype=np.uint8)
    got = unsharp_mask_planes(x, amount, 5, 0.0)
    want = np.stack([ref.unsharp_mask(p, amount, 5, 0.0) for p in x])
    assert maxdiff(got, want) == 0


def test_unsharp_tall(rng):
    x = rng.integers(0, 256, (1, 700, 131), dtype=np.uint8)
    got = unsharp_mask_planes(x, 1.0, 5, 0.0)
    assert maxdiff(got, ref.unsharp_mask(x[0], 1.0, 5, 0.0)[None]) == 0


def test_unsharp_negative_amount(rng):
    x = rng.integers(0, 256, (1, 64, 67), dtype=np.uint8)
    for amount in (-0.5, -1.0):
        got = unsharp_mask_planes(x, amount, 5, 0.0)
        assert maxdiff(got, ref.unsharp_mask(x[0], amount, 5, 0.0)[None]) == 0, amount


def test_median_bitexact(rng):
    for k in (3, 5):
        x = rng.integers(0, 256, (2, 100, 131), dtype=np.uint8)
        got = median_blur_planes(x, k)
        want = np.stack([ref.median_blur(p, k) for p in x])
        assert maxdiff(got, want) == 0, k


def test_median_tall(rng):
    x = rng.integers(0, 256, (1, 700, 131), dtype=np.uint8)
    got = median_blur_planes(x, 3)
    assert maxdiff(got, ref.median_blur(x[0], 3)[None]) == 0


def test_unsharp_fractional_amount(rng):
    x = rng.integers(0, 256, (1, 64, 131), dtype=np.uint8)
    got = unsharp_mask_planes(x, 1.5, 5, 0.0)
    assert maxdiff(got, ref.unsharp_mask(x[0], 1.5, 5, 0.0)[None]) == 0


@pytest.mark.parametrize("km,amount", [(3, 1.0), (5, 1.0), (5, 1.5)])
def test_median_unsharp_chain_bitexact(rng, km, amount):
    from imageenhancement_mp_tpu.pipeline import make_pipeline

    x = rng.integers(0, 256, (2, 64, 131), dtype=np.uint8)
    pipe = make_pipeline([("median_blur", {"ksize": km}),
                          ("unsharp_mask", {"amount": amount, "ksize": 5})],
                         channels_last=False)
    want = np.stack([ref.unsharp_mask(ref.median_blur(p, km), amount, 5, 0.0) for p in x])
    assert maxdiff(pipe(x), want) == 0


def test_median_unsharp_chain_small_image(rng):
    from imageenhancement_mp_tpu.pipeline import make_pipeline

    x = rng.integers(0, 256, (1, 10, 11), dtype=np.uint8)
    pipe = make_pipeline([("median_blur", {"ksize": 5}),
                          ("unsharp_mask", {"amount": 1.0, "ksize": 5})],
                         channels_last=False)
    want = ref.unsharp_mask(ref.median_blur(x[0], 5), 1.0, 5, 0.0)[None]
    assert maxdiff(pipe(x), want) == 0


def test_median_u16(rng):
    planes = rng.integers(0, 65536, (2, 53, 67), dtype=np.uint16)
    for k in (3, 5):
        got = np.asarray(median_blur_planes(planes, k))
        want = np.stack([ref.median_blur(p, k) for p in planes])
        assert got.dtype == np.uint16
        assert np.array_equal(got, want), k


def test_median_u16_small(rng):
    planes = rng.integers(0, 65536, (1, 40, 44), dtype=np.uint16)
    got = np.asarray(median_blur_planes(planes, 5))
    want = np.stack([ref.median_blur(p, 5) for p in planes])
    assert np.array_equal(got, want)
