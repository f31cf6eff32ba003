"""Sub-pixel patch extraction: ``cv2.getRectSubPix`` parity on device
(contract pinned in ref/ops.py ``get_rect_sub_pix``).

Device mapping: one jitted program extracts N patches from one image in a
single batched gather — the (h+1)×(w+1) tap window per center is four
shifted views of one ``jnp.take`` on flattened indices, and the bilinear
weights are scalar f32 per center (vmapped).  cv2 5.0 dispatches by
channel count AND output depth with three different summation orders
(see the oracle docstring); each is reproduced with explicitly ordered
f32 ops (XLA does not contract f32 mul+add) or ``utils.fma.fma32`` for
the contracted 1-channel f32 kernel.

The u8→u8 path is OpenCV's own Q16 fixed point (``scale_fixpt`` /
``cast_8u``) — bit-exact vs the oracle everywhere, and vs default cv2
for 3ch / IPP-off 1ch (the default build's 1ch IPP kernel flips a thin
near-half tie band: documented ±1, docs/PARITY.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from imageenhancement_mp_tpu.utils.fma import fma32

__all__ = ["get_rect_sub_pix_planes"]


def _prod32(p, w):
    """Separately rounded f32 product ``RN(p·w)``.  XLA fast-math
    contracts the surrounding sums into FMAs, so route the product
    through the one rounding XLA must honor (f64 product snapped to the
    f32 grid via reduce_precision — the blend_linear idiom, api.py)."""
    return jax.lax.reduce_precision(
        p.astype(jnp.float64) * w.astype(jnp.float64), 8, 23
    ).astype(jnp.float32)


def _taps(img2d, ix, iy, w: int, h: int):
    """Replicate-clamped (h+1)×(w+1) tap window starting at (ix, iy)."""
    H, W = img2d.shape
    xs = jnp.clip(ix + jnp.arange(w + 1, dtype=jnp.int32), 0, W - 1)
    ys = jnp.clip(iy + jnp.arange(h + 1, dtype=jnp.int32), 0, H - 1)
    flat = ys[:, None] * W + xs[None, :]
    return jnp.take(img2d.reshape(-1), flat, axis=0)


def get_rect_sub_pix_planes(img, centers, patch_w: int, patch_h: int,
                            out_f32: bool):
    """Extract ``centers.shape[0]`` patches of static size (w, h) from
    one ``[H, W]`` or ``[H, W, C]`` image at sub-pixel centers
    ``[N, 2]`` (x, y) f32.  Returns ``[N, h, w]`` / ``[N, h, w, C]``.

    cv2 requires each center inside the image; overhanging patch taps
    replicate-clamp (ref/ops.py ``get_rect_sub_pix`` border note).
    """
    w, h = int(patch_w), int(patch_h)
    multi = img.ndim == 3
    C = img.shape[2] if multi else 1
    f32 = jnp.float32
    u8_in = img.dtype == jnp.uint8
    if not u8_in and img.dtype != jnp.float32:
        raise TypeError(f"getRectSubPix supports u8/f32, got {img.dtype}")

    def one(center):
        cx = center[0].astype(f32)
        cy = center[1].astype(f32)
        x0 = cx - f32((w - 1) * 0.5)
        y0 = cy - f32((h - 1) * 0.5)
        ix = jnp.floor(x0).astype(jnp.int32)
        iy = jnp.floor(y0).astype(jnp.int32)
        a = x0 - ix.astype(f32)
        b = y0 - iy.astype(f32)
        a11 = (f32(1) - a) * (f32(1) - b)
        a12 = a * (f32(1) - b)
        a21 = (f32(1) - a) * b
        a22 = a * b
        if multi:
            P = jnp.stack([_taps(img[..., c], ix, iy, w, h)
                           for c in range(C)], axis=-1)
        else:
            P = _taps(img, ix, iy, w, h)
        p00 = P[:h, :w]
        p01 = P[:h, 1:]
        p10 = P[1:, :w]
        p11 = P[1:, 1:]
        if not out_f32:
            # OpenCV Q16 fixed point; weight products stay in the f32
            # law above, cvRound = round-half-even (jnp.round).
            ws = [jnp.round(x * f32(65536.0)).astype(jnp.int32)
                  for x in (a11, a12, a21, a22)]
            q = [p.astype(jnp.int32) for p in (p00, p01, p10, p11)]
            s = q[0] * ws[0] + q[1] * ws[1] + q[2] * ws[2] + q[3] * ws[3]
            return jnp.clip((s + 32768) >> 16, 0, 255).astype(jnp.uint8)
        fp = [p.astype(f32) for p in (p00, p01, p10, p11)]
        pr = [_prod32(fp[i], wt) for i, wt in
              enumerate((a11, a12, a21, a22))]
        if multi:
            # scalar Cn template: plain left-to-right f32 sums
            return ((pr[0] + pr[1]) + pr[2]) + pr[3]
        if u8_in:
            # getRectSubPix_8u32f: paired sums
            return (pr[0] + pr[1]) + (pr[2] + pr[3])
        # SIMD 32f kernel: contracted FMA chain
        return fma32(fp[3], a22, fma32(fp[2], a21, fma32(fp[1], a12,
                                                         fp[0] * a11)))

    return jax.vmap(one)(centers.astype(f32))
