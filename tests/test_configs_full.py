"""Full-size judged configs (BASELINE.json:6-12) on a GPU.

Run on a card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/test_configs_full.py``; without one the ``gpu`` fixture skips them.
The CPU suite covers the same code paths at reduced sizes.
"""

import numpy as np
import pytest

import imageenhancement_mp_tpu as ie
from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.models.presets import get_preset
from imageenhancement_mp_tpu.pipeline import equalize_unsharp

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu")]


def maxdiff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


def test_config1_histeq_512(rng):
    img = rng.integers(0, 256, (512, 512), dtype=np.uint8)
    assert maxdiff(ie.equalize_hist(img), ref.equalize_hist(img)) == 0


def test_config2_gamma_stretch_batch32_1080p_rgb(rng):
    batch = rng.integers(0, 256, (32, 1080, 1920, 3), dtype=np.uint8)
    out = np.asarray(get_preset("gamma_stretch")(batch))
    n, c = 5, 1  # spot-check a few planes (full check is minutes of numpy)
    want = ref.contrast_stretch(ref.gamma_transform(batch[n, :, :, c], 2.2))
    assert maxdiff(out[n, :, :, c], want) == 0


def test_config3_unsharp_1080p(rng):
    batch = rng.integers(0, 256, (8, 1080, 1920), dtype=np.uint8)
    out = np.asarray(ie.unsharp_mask(batch, 1.0, 5))
    want = ref.unsharp_mask(batch[3], 1.0, 5, 0.0)
    assert maxdiff(out[3], want) == 0


def test_config4_clahe_4k_rgb(rng):
    img = rng.integers(0, 256, (2160, 3840, 3), dtype=np.uint8)
    out = np.asarray(ie.clahe(img, 2.0, (8, 8)))
    want = ref.clahe(img[:, :, 1], 2.0, (8, 8))
    assert maxdiff(out[:, :, 1], want) <= 1


def test_config5_pipeline_4k(rng):
    batch = rng.integers(0, 256, (2, 2160, 3840), dtype=np.uint8)
    out = np.asarray(get_preset("denoise_clahe_sharpen")(batch))
    want = ref.unsharp_mask(
        ref.clahe(ref.median_blur(batch[0], 5), 2.0, (8, 8)), 1.0, 5, 0.0
    )
    assert maxdiff(out[0], want) <= 2


def test_north_star_fused_1080p(rng):
    batch = rng.integers(0, 256, (8, 1080, 1920), dtype=np.uint8)
    out = np.asarray(equalize_unsharp(batch, 1.0, 5, 0.0))
    want = ref.unsharp_mask(ref.equalize_hist(batch[5]), 1.0, 5, 0.0)
    assert maxdiff(out[5], want) == 0


def test_u16_clahe_4k(rng):
    img = rng.integers(0, 65536, (2160, 3840), dtype=np.uint16)
    out = np.asarray(ie.clahe(img, 2.0, (8, 8)))
    want = ref.clahe(img, 2.0, (8, 8))
    assert maxdiff(out, want) <= 1


def test_clahe_vs_cv2_on_gpu(rng):
    """CLAHE on the card is bit-exact vs cv2 itself at these sizes (the
    ±1 blend budget of docs/PARITY.md is not needed here)."""
    cv2 = pytest.importorskip("cv2")
    cv2.setNumThreads(1)
    for hw, clip, grid in [((512, 512), 2.0, (8, 8)), ((250, 251), 3.5, (4, 6))]:
        img = rng.integers(0, 256, hw, dtype=np.uint8)
        want = cv2.createCLAHE(clip, (grid[1], grid[0])).apply(img)
        assert maxdiff(ie.clahe(img, clip, grid), want) == 0, (hw, clip, grid)
