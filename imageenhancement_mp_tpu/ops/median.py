"""Median filtering via fixed-size sorting networks.

Reference equivalent: ``cv2.medianBlur`` (SURVEY.md §2 #9; border =
replicate).  No data-dependent control flow — the median of a 3×3/5×5
window is computed by a *selection network* of elementwise min/max pairs
over the B×H×W-shaped window planes, fully vectorized.  The 9-input network below is the classic 19-comparator median network
(Paeth); the 25-input one is the standard extension via column-sort +
merge-exchange used in median-filter literature.
"""

from __future__ import annotations

import jax.numpy as jnp

from imageenhancement_mp_tpu.kernels.networks import median9, median25

__all__ = ["median_blur_planes"]


def _windows(planes: jnp.ndarray, k: int) -> list[jnp.ndarray]:
    pad = k // 2
    H, W = planes.shape[-2], planes.shape[-1]
    p = jnp.pad(planes, ((0, 0), (pad, pad), (pad, pad)), mode="edge")
    return [p[:, dy : dy + H, dx : dx + W] for dy in range(k) for dx in range(k)]


def median_blur_planes(planes: jnp.ndarray, ksize: int = 3) -> jnp.ndarray:
    """``cv2.medianBlur`` on uint8/uint16/float32 planes — exact; border = replicate."""
    if ksize % 2 == 0 or ksize < 3:
        raise ValueError("ksize must be odd and >= 3")
    ws = _windows(planes, ksize)
    if ksize == 3:
        return median9(ws)
    if ksize == 5:
        return median25(ws)
    # larger windows: one XLA sort over a stacked tap axis (a comparator
    # network would trace k^4 ops and explode compile time)
    stacked = jnp.stack(ws, axis=-1)
    return jnp.sort(stacked, axis=-1)[..., (ksize * ksize) // 2]
