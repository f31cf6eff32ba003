"""adaptiveThreshold(GAUSSIAN_C) planes op vs the ``ref/`` oracle (itself
fuzz-pinned vs cv2 — ref/ops.py adaptive_threshold) across block sizes,
threshold types, C values and odd widths."""

import numpy as np
import pytest

from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops.threshold import adaptive_threshold_planes


def maxdiff(a, b):
    return int(
        np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max()
    )


@pytest.mark.parametrize("bs", [3, 5, 11])
@pytest.mark.parametrize("type_", ["binary", "binary_inv"])
def test_athresh_gaussian(rng, bs, type_):
    x = rng.integers(0, 256, (2, 64, 256), dtype=np.uint8)
    got = adaptive_threshold_planes(x, 255.0, "gaussian", type_, bs, 2.0)
    want = np.stack(
        [ref.adaptive_threshold(p, 255.0, "gaussian", type_, bs, 2.0) for p in x]
    )
    assert maxdiff(got, want) == 0


@pytest.mark.parametrize("C", [-3.5, 0.0, 7.2])
def test_athresh_gaussian_C(rng, C):
    x = rng.integers(0, 256, (1, 96, 384), dtype=np.uint8)
    got = adaptive_threshold_planes(x, 200.0, "gaussian", "binary", 11, C)
    want = ref.adaptive_threshold(x[0], 200.0, "gaussian", "binary", 11, C)[None]
    assert maxdiff(got, want) == 0


def test_athresh_tall(rng):
    x = rng.integers(0, 256, (1, 256, 256), dtype=np.uint8)
    got = adaptive_threshold_planes(x, 255.0, "gaussian", "binary", 11, 2.0)
    want = ref.adaptive_threshold(x[0], 255.0, "gaussian", "binary", 11, 2.0)[None]
    assert maxdiff(got, want) == 0


def test_athresh_batch(rng):
    x = rng.integers(0, 256, (2, 64, 256), dtype=np.uint8)
    got = adaptive_threshold_planes(x, 255.0, "gaussian", "binary", 11, 2.0)
    want = np.stack(
        [ref.adaptive_threshold(p, 255.0, "gaussian", "binary", 11, 2.0) for p in x]
    )
    assert maxdiff(got, want) == 0


def test_athresh_odd_width(rng):
    x = rng.integers(0, 256, (1, 50, 131), dtype=np.uint8)
    got = adaptive_threshold_planes(x, 255.0, "gaussian", "binary", 11, 2.0)
    want = ref.adaptive_threshold(x[0], 255.0, "gaussian", "binary", 11, 2.0)[None]
    assert maxdiff(got, want) == 0
