"""u16 and u8 CLAHE planes op at divisible and odd geometries, pinned
against the ref/ oracle."""

import numpy as np
import pytest

from imageenhancement_mp_tpu import ref


def maxdiff(a, b):
    return int(
        np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max()
    )


def _clahe(x, clip, grid):
    from imageenhancement_mp_tpu.ops.clahe import clahe_planes

    return clahe_planes(x, clip, grid)


@pytest.mark.parametrize("clip", [2.0, 40.0])
def test_clahe_u16_vs_ref(rng, clip):
    x = rng.integers(0, 65536, (1, 16, 256), dtype=np.uint16)
    got = _clahe(x, clip, (2, 2))
    want = np.stack([ref.clahe(p, clip, (2, 2)) for p in x])
    # FMA-contraction budget (±1) of the stage-C blend (docs/PARITY.md)
    assert maxdiff(got, want) <= 1


def test_clahe_u16_batch(rng):
    x = rng.integers(0, 65536, (2, 16, 256), dtype=np.uint16)
    got = _clahe(x, 2.5, (2, 2))
    want = np.stack([ref.clahe(p, 2.5, (2, 2)) for p in x])
    assert maxdiff(got, want) <= 1


def test_clahe_u16_narrow_range(rng):
    # values concentrated in a few bins: exercises clip/redistribute
    x = (rng.integers(0, 512, (1, 16, 256)) + 30000).astype(np.uint16)
    got = _clahe(x, 3.0, (2, 2))
    want = np.stack([ref.clahe(p, 3.0, (2, 2)) for p in x])
    assert maxdiff(got, want) <= 1


@pytest.mark.parametrize(
    "shape,grid,cl",
    [
        ((2, 64, 256), (8, 2), 2.0),
        ((1, 30, 256), (2, 2), 40.0),  # odd tile rows: hu=8, hl=7
        ((1, 64, 384), (4, 3), 3.5),
    ],
)
def test_clahe_u8_divisible_grids(rng, shape, grid, cl):
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    got = _clahe(x, cl, grid)
    want = np.stack([ref.clahe(p, cl, grid) for p in x])
    assert maxdiff(got, want) <= 1  # FMA-contraction budget


def test_clahe_u16_odd_geometry(rng):
    # non-divisible size: cv2's REFLECT_101 pad of both dims
    x = rng.integers(0, 65536, (1, 20, 250), dtype=np.uint16)
    got = _clahe(x, 2.0, (2, 2))
    want = np.stack([ref.clahe(p, 2.0, (2, 2)) for p in x])
    assert maxdiff(got, want) <= 1
