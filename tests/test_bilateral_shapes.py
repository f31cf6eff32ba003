"""Bilateral filter planes op vs the ``ref/`` oracle across widths,
disc radii and tall multi-stripe planes."""

import numpy as np
import pytest

from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.ops.bilateral import bilateral_planes


def maxdiff(a, b):
    return int(
        np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max()
    )


@pytest.mark.parametrize("d,sc,ss", [(5, 50.0, 50.0), (9, 75.0, 75.0)])
def test_bilateral_vs_ref(rng, d, sc, ss):
    x = rng.integers(0, 256, (2, 64, 256), dtype=np.uint8)
    got = bilateral_planes(x, d, sc, ss)
    want = np.stack([ref.bilateral_filter(p, d, sc, ss) for p in x])
    assert maxdiff(got, want) == 0


def test_bilateral_tall(rng):
    x = rng.integers(0, 256, (1, 128, 384), dtype=np.uint8)
    got = bilateral_planes(x, 9, 30.0, 30.0)
    want = ref.bilateral_filter(x[0], 9, 30.0, 30.0)[None]
    assert maxdiff(got, want) == 0


def test_bilateral_odd_width(rng):
    x = rng.integers(0, 256, (1, 50, 131), dtype=np.uint8)
    got = bilateral_planes(x, 5, 50.0, 50.0)
    want = ref.bilateral_filter(x[0], 5, 50.0, 50.0)[None]
    assert maxdiff(got, want) == 0
