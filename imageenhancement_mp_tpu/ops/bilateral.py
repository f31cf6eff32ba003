"""Bilateral filter: edge-preserving denoise, ``cv2.bilateralFilter`` parity.

Pinned arithmetic (probes vs OpenCV 5.0.0 — tests/test_ref_vs_cv2.py):

* radius = ``d//2`` (d > 0) else ``round(1.5·σ_space)``, min 1; the
  neighborhood is the DISC ``sqrt(i²+j²) ≤ radius``; border REFLECT_101.
* weights: ``w = exp(r²·(−0.5/σ_s²)) · color_w[diff]`` with
  ``color_w[i] = f32(exp(i²·(−0.5/σ_c²)))``; diff = |v−c| (gray) or the
  L1 distance |Δr|+|Δg|+|Δb| (color, one joint weight — cv2 does NOT
  filter channels independently here).
* accumulate ``num += v·w``, ``den += w`` in f32 in disc scan order;
  ``out = sat_u8(cvRound(num/den))``.

Parity: bit-exact vs cv2's reference C++ path (``setUseOptimized(False)``)
for grayscale; color is within ±1 on ~1e-5 of pixels (cv2's SIMD
accumulation order).  cv2's DEFAULT dispatch on x86 uses IPP, whose own
output differs from cv2's reference path by ±1 on ~20 % of pixels — so
±1 is the tightest contract any build-portable implementation can state.
σ ≤ 0 is rejected: OpenCV 5.0's behavior there is data-dependent
(probed: the effective color weight varies with image content) and so
cannot be pinned.

Device mapping: one pass per disc offset — shifted slice, |diff|, 256-entry
LUT gather, two FMAs — all fused by XLA into one loop over the padded
block.  Compute-
bound in the gather at ~(disc size) passes; still 100×+ the single-thread
CPU reference (bench row).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = ["bilateral_planes", "bilateral_color", "bilateral_offsets"]

_MAX_RADIUS = 25  # (2·25+1)² = 2601 unrolled offsets: compile-time guard


def bilateral_offsets(d: int, sigma_color: float, sigma_space: float, cn: int = 1):
    """Host-side: ((i, j, space_w) disc offsets, f32 color LUT, radius)."""
    if sigma_color <= 0 or sigma_space <= 0:
        raise ValueError(
            "sigma_color and sigma_space must be > 0 (OpenCV 5.0's behavior "
            "for non-positive sigmas is data-dependent and unpinnable)"
        )
    radius = int(round(sigma_space * 1.5)) if d <= 0 else int(d) // 2
    radius = max(radius, 1)
    if radius > _MAX_RADIUS:
        raise ValueError(f"radius {radius} too large (max {_MAX_RADIUS})")
    gc = -0.5 / (sigma_color * sigma_color)
    gs = -0.5 / (sigma_space * sigma_space)
    color_w = np.exp(np.arange(256 * cn, dtype=np.float64) ** 2 * gc).astype(np.float32)
    offs = []
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = np.sqrt(i * i + j * j)
            if r > radius:
                continue
            offs.append((i, j, float(np.float32(np.exp(r * r * gs)))))
    return offs, color_w, radius


def _accumulate(p, c, offs, cw, r, H, W, joint: bool):
    from imageenhancement_mp_tpu.ops.pointwise import apply_lut_planes

    num = jnp.zeros(c.shape, jnp.float32)
    den = jnp.zeros(c.shape[:-1] if joint else c.shape, jnp.float32)
    for i, j, w0 in offs:
        v = p[..., r + i : r + i + H, r + j : r + j + W, :] if joint else (
            p[..., r + i : r + i + H, r + j : r + j + W])
        if joint:
            # joint diff spans 0..255·3: a 766-entry table gather
            diff = jnp.abs(v - c).sum(axis=-1).astype(jnp.int32)
            w = jnp.float32(w0) * cw[diff]
        else:
            # gray diff is u8: a 256-entry table gather
            diff = jnp.abs(v - c).astype(jnp.uint8)
            w = jnp.float32(w0) * apply_lut_planes(diff, cw)
        num = num + v * (w[..., None] if joint else w)
        den = den + w
    return num, den


def bilateral_planes(
    planes: jnp.ndarray, d: int = 5, sigma_color: float = 50.0, sigma_space: float = 50.0
) -> jnp.ndarray:
    """``cv2.bilateralFilter`` on grayscale ``[B, H, W]`` uint8 planes."""
    if planes.dtype != jnp.uint8:
        raise TypeError(f"bilateral_filter takes uint8 (like cv2's 8u path), got {planes.dtype}")
    offs, color_w, r = bilateral_offsets(d, sigma_color, sigma_space, cn=1)
    H, W = planes.shape[-2], planes.shape[-1]
    cw = jnp.asarray(color_w)
    p = jnp.pad(planes, ((0, 0), (r, r), (r, r)), mode="reflect").astype(jnp.float32)
    c = p[:, r : r + H, r : r + W]
    num, den = _accumulate(p, c, offs, cw, r, H, W, joint=False)
    return jnp.clip(jnp.round(num / den), 0, 255).astype(jnp.uint8)


def bilateral_color(
    img: jnp.ndarray, d: int = 5, sigma_color: float = 50.0, sigma_space: float = 50.0
) -> jnp.ndarray:
    """``cv2.bilateralFilter`` on ``[..., H, W, 3]`` uint8 — cv2's JOINT
    color semantics: one weight per pixel from the L1 color distance."""
    if img.dtype != jnp.uint8:
        raise TypeError(f"bilateral_filter takes uint8 (like cv2's 8u path), got {img.dtype}")
    if img.shape[-1] != 3:
        raise ValueError(f"color bilateral needs C=3 (like cv2), got {img.shape}")
    offs, color_w, r = bilateral_offsets(d, sigma_color, sigma_space, cn=3)
    H, W = img.shape[-3], img.shape[-2]
    cw = jnp.asarray(color_w)
    pad = ((0, 0),) * (img.ndim - 3) + ((r, r), (r, r), (0, 0))
    p = jnp.pad(img, pad, mode="reflect").astype(jnp.float32)
    c = p[..., r : r + H, r : r + W, :]
    num, den = _accumulate(p, c, offs, cw, r, H, W, joint=True)
    return jnp.clip(jnp.round(num / den[..., None]), 0, 255).astype(jnp.uint8)
