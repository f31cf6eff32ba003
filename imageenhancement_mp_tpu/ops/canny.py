"""Canny edge detection: ``cv2.Canny`` parity on device (contract
pinned in ref/ops.py ``canny`` — bit-exact 0/180 fuzz).

Device mapping: the Sobel pair, magnitude, and NMS are one fused
elementwise/stencil program (integer math — the fixed-point NMS
needs no transcendentals: cv2's TG22 = 13573/2^15 trick classifies the
gradient direction with two integer products).  Hysteresis is the only
data-dependent stage: a ``lax.while_loop`` fixpoint that grows the
strong set through weak candidates with a 3x3 dilation per step —
each step is a cheap max-pool, and the loop runs until no pixel
changes (bounded by the longest weak chain, not H·W).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from imageenhancement_mp_tpu.ref.ops import deriv_kernels

__all__ = ["canny_planes", "connected_components_planes"]

_TG22 = 13573
_SHIFT = 15


def _sobel_replicate(planes, dx, dy, ksize):
    kx, ky = deriv_kernels(dx, dy, ksize)
    kxi = np.round(kx).astype(np.int32)
    kyi = np.round(ky).astype(np.int32)
    r = ksize // 2
    H, W = planes.shape[-2], planes.shape[-1]
    p = jnp.pad(planes.astype(jnp.int32), ((0, 0), (r, r), (r, r)), mode="edge")
    t = sum(int(kyi[i]) * p[:, i:i + H, :] for i in range(ksize))
    raw = sum(int(kxi[j]) * t[:, :, j:j + W] for j in range(ksize))
    if ksize == 7:
        # cv2 scales aperture-7 Sobel by 1/16 (exact in binary; the
        # round is half-even) so the gradients fit CV_16S
        raw = jnp.round(raw.astype(jnp.float32) * jnp.float32(1.0 / 16.0)).astype(jnp.int32)
    return jnp.clip(raw, -32768, 32767)


def _nms_keep(magv, gx, gy):
    """cv2's fixed-point non-maximum suppression over a VERTICALLY
    extended magnitude block ``magv = (N, h+2, W)`` (rows 1..h are the
    centers; row 0 / h+1 are the zero border — or, on the spatial
    row-sharded path, the neighbor shard's true boundary rows).
    Horizontal zero padding (cv2's column border) happens here."""
    mp = jnp.pad(magv, ((0, 0), (0, 0), (1, 1)))
    c = mp[:, 1:-1, 1:-1]
    left, right = mp[:, 1:-1, :-2], mp[:, 1:-1, 2:]
    up, down = mp[:, :-2, 1:-1], mp[:, 2:, 1:-1]
    ul, ur = mp[:, :-2, :-2], mp[:, :-2, 2:]
    dl, dr = mp[:, 2:, :-2], mp[:, 2:, 2:]
    ax = jnp.abs(gx)
    ay = jnp.abs(gy) << _SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + ((ax + ax) << _SHIFT)
    s_neg = (gx ^ gy) < 0
    horiz = ay < tg22x
    vert = ay > tg67x
    d1 = jnp.where(s_neg, ur, ul)
    d2 = jnp.where(s_neg, dl, dr)
    return jnp.where(
        horiz, (c > left) & (c >= right),
        jnp.where(vert, (c > up) & (c >= down), (c > d1) & (c > d2)))


def _dilate8(mask):
    p = jnp.pad(mask, ((0, 0), (1, 1), (1, 1)))
    return (p[:, :-2, :-2] | p[:, :-2, 1:-1] | p[:, :-2, 2:]
            | p[:, 1:-1, :-2] | p[:, 1:-1, 2:]
            | p[:, 2:, :-2] | p[:, 2:, 1:-1] | p[:, 2:, 2:])


def canny_planes(planes: jnp.ndarray, threshold1: float, threshold2: float,
                 aperture_size: int = 3, l2_gradient: bool = False) -> jnp.ndarray:
    """``cv2.Canny`` per plane on ``(N, H, W)`` uint8 — exact."""
    if planes.dtype != jnp.uint8:
        raise TypeError(f"cv2.Canny requires uint8 input, got {planes.dtype}")
    if aperture_size not in (3, 5, 7):
        raise ValueError(f"aperture_size must be 3, 5 or 7, got {aperture_size}")
    gx = _sobel_replicate(planes, 1, 0, aperture_size)
    gy = _sobel_replicate(planes, 0, 1, aperture_size)
    lo_t, hi_t = sorted((float(threshold1), float(threshold2)))
    if aperture_size == 7:
        lo_t, hi_t = lo_t / 16.0, hi_t / 16.0
    if l2_gradient:
        mag = gx * gx + gy * gy          # int16-saturated grads: fits int32
        lo_i, hi_i = int(np.floor(lo_t * lo_t)), int(np.floor(hi_t * hi_t))
    else:
        mag = jnp.abs(gx) + jnp.abs(gy)
        lo_i, hi_i = int(np.floor(lo_t)), int(np.floor(hi_t))
    magv = jnp.pad(mag, ((0, 0), (1, 1), (0, 0)))    # zero border, like cv2
    keep = _nms_keep(magv, gx, gy)
    keep = keep & (mag > lo_i)
    strong = keep & (mag > hi_i)

    def body(state):
        out, _ = state
        new = out | (keep & _dilate8(out))
        return new, jnp.any(new != out)

    def cond(state):
        return state[1]

    out, _ = jax.lax.while_loop(cond, body, (strong, jnp.bool_(True)))
    return jnp.where(out, jnp.uint8(255), jnp.uint8(0))


def connected_components_planes(planes: jnp.ndarray, connectivity: int = 8) -> jnp.ndarray:
    """``cv2.connectedComponents`` per plane on ``(N, H, W)`` masks —
    int32 labels, 0 = background (contract in ref/ops.py).

    Device mapping: min-label propagation with POINTER JUMPING — each
    ``lax.while_loop`` step takes the 4/8-neighbor minimum and then
    compresses paths by gathering each pixel's label's label, so
    convergence is logarithmic in the component diameter instead of
    linear (a 4K spiral converges in ~25 steps, not thousands).  The
    final numbering matches cv2 bit-exactly for BOTH connectivities:
    4-conn ranks roots in raster order (cv2's SAUF first-pixel order,
    one cumsum + gather); 8-conn ranks components by their minimum
    2x2-BLOCK index (cv2's BBDT block-scan order — ref/ops.py
    ``connected_components`` documents the pinning)."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    N, H, W = planes.shape
    INF = jnp.int32(H * W)
    m = planes != 0
    idx = jnp.arange(H * W, dtype=jnp.int32).reshape(1, H, W)
    lbl0 = jnp.where(m, idx, INF)

    def mins(l):
        p = jnp.pad(l, ((0, 0), (1, 1), (1, 1)), constant_values=H * W)
        n = jnp.minimum(p[:, 1:-1, 1:-1],
                        jnp.minimum(jnp.minimum(p[:, :-2, 1:-1], p[:, 2:, 1:-1]),
                                    jnp.minimum(p[:, 1:-1, :-2], p[:, 1:-1, 2:])))
        if connectivity == 8:
            n = jnp.minimum(n, jnp.minimum(
                jnp.minimum(p[:, :-2, :-2], p[:, :-2, 2:]),
                jnp.minimum(p[:, 2:, :-2], p[:, 2:, 2:])))
        return n

    def jump(l):
        flat = l.reshape(N, H * W)
        g = jnp.take_along_axis(flat, jnp.minimum(flat, H * W - 1), axis=1)
        return jnp.where(m, g.reshape(N, H, W), INF)

    def body(state):
        l, _ = state
        new = jump(jump(jnp.where(m, mins(l), INF)))
        return new, jnp.any(new != l)

    lbl, _ = jax.lax.while_loop(lambda s: s[1], body, (lbl0, jnp.bool_(True)))
    flat = lbl.reshape(N, H * W)
    mf = m.reshape(N, H * W)
    is_root = mf & (flat == jnp.arange(H * W, dtype=jnp.int32)[None])
    if connectivity == 4:
        rank = jnp.cumsum(is_root.astype(jnp.int32), axis=1)
        out = jnp.take_along_axis(rank, jnp.minimum(flat, H * W - 1), axis=1)
        return jnp.where(mf, out, 0).reshape(N, H, W).astype(jnp.int32)
    # 8-conn: cv2's BBDT order — rank components by min 2x2-block index
    nbw = (W + 1) // 2
    ys, xs = jnp.divmod(jnp.arange(H * W, dtype=jnp.int32), W)
    blk = (ys >> 1) * nbw + (xs >> 1)
    minblk = jnp.full((N, H * W), INF, jnp.int32)
    minblk = minblk.at[jnp.arange(N)[:, None], jnp.minimum(flat, H * W - 1)].min(
        jnp.where(mf, blk[None], INF))
    key = jnp.where(is_root, minblk, INF)
    order = jnp.argsort(key, axis=1, stable=True)
    rank = jnp.zeros((N, H * W), jnp.int32).at[
        jnp.arange(N)[:, None], order].set(
        jnp.broadcast_to(jnp.arange(H * W, dtype=jnp.int32)[None], (N, H * W)))
    out = jnp.take_along_axis(rank, jnp.minimum(flat, H * W - 1), axis=1) + 1
    return jnp.where(mf, out, 0).reshape(N, H, W).astype(jnp.int32)
