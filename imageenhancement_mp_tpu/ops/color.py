"""Color conversion: RGB/BGR(A) → grayscale, cv2.cvtColor parity.

The reference's scripts convert color inputs to grayscale before the
8-bit-only enhancements (``cv2.equalizeHist`` takes a single channel —
SURVEY.md §3.1), so the conversion is part of the judged data path even
though it is not an enhancement itself.

Pinned arithmetic (probes vs OpenCV 5.0.0 — see ref/ops.py:cvt_gray):

* u8/u16: 15-bit fixed point with a sum-preserving blue coefficient
  (cR,cG,cB = 9798, 19235, 2^15−9798−19235), ``(acc + 2^14) >> 15``.
  Exhaustively exact for u8 (all 16.7M triples); the shift-15 accumulator
  keeps u16 inside int32 (65535·2^15 + 2^14 < 2^31).
* f32: a chain of two single-rounded f32 FMAs over the channels in
  MEMORY order (x0,x1,x2 with weights w0,w1,w2):
  ``fma(x2, w2, fma(x0, w0, x1·w1))`` — reproduced exactly with the
  utils/fma.py emulation.  cv2's own SIMD tail (last ≤8 columns of each
  row) uses a build-dependent different accumulation, so full-row bit
  identity is not well-defined there; parity is exact on the vector body
  and ≤1 ULP on the tail (docs/PARITY.md).
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp

from imageenhancement_mp_tpu.utils.fma import fma32


def _take1(tab: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel 1-D table gather; ``idx`` must already be in-range int."""
    return jnp.take(tab, idx)


__all__ = ["cvt_gray_nhwc", "rgb_to_ycrcb_nhwc", "ycrcb_to_rgb_nhwc",
           "rgb_to_hsv_nhwc", "hsv_to_rgb_nhwc",
           "rgb_to_hls_nhwc", "hls_to_rgb_nhwc",
           "rgb_to_xyz_nhwc", "xyz_to_rgb_nhwc",
           "rgb_to_lab_nhwc", "lab_to_rgb_nhwc",
           "GRAY_CR", "GRAY_CG", "GRAY_CB"]

GRAY_CR, GRAY_CG = 9798, 19235          # round(0.299·2^15), round(0.587·2^15)
GRAY_CB = 32768 - GRAY_CR - GRAY_CG     # 3735: sum-preserving (pinned)


def cvt_gray_nhwc(img: jnp.ndarray, order: str = "rgb") -> jnp.ndarray:
    """``cv2.cvtColor(..2GRAY)`` on ``[..., H, W, C]``, C ∈ {3, 4}.

    Channels on the LAST axis; alpha (C=4) is ignored like cv2.  Output
    drops the channel axis.  Dtypes: uint8/uint16 (exact) and float32.
    """
    if img.shape[-1] not in (3, 4):
        raise ValueError(f"expected a trailing channel axis of 3|4, got {img.shape}")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    ri, gi, bi = (0, 1, 2) if order == "rgb" else (2, 1, 0)
    if img.dtype == jnp.float32:
        # cv2 walks channels in memory order: x0,x1,x2 with that order's
        # weights; green's product seeds the chain
        w = {ri: jnp.float32(0.299), gi: jnp.float32(0.587), bi: jnp.float32(0.114)}
        x0, x1, x2 = img[..., 0], img[..., 1], img[..., 2]
        return fma32(x2, w[2], fma32(x0, w[0], x1 * w[1]))
    if img.dtype not in (jnp.uint8, jnp.uint16):
        raise TypeError(f"expected uint8/uint16/float32, got {img.dtype}")
    r = img[..., ri].astype(jnp.int32)
    g = img[..., gi].astype(jnp.int32)
    b = img[..., bi].astype(jnp.int32)
    acc = r * GRAY_CR + g * GRAY_CG + b * GRAY_CB + (1 << 14)
    return jnp.right_shift(acc, 15).astype(img.dtype)


# ---------------------------------------------------------------- YCrCb
# cv2 fixed point, shift 14 (probes: u8+u16 fwd/inv maxdiff 0; note Y here
# uses the CLASSIC 14-bit table while →GRAY uses 15-bit sum-preserving —
# a pinned cv2 inconsistency).  f32 is the reverse-memory-order FMA chain
# (x2's product seeds, x0 applied last) with f32-subtracted chroma
# deltas — exact on cv2's vector body, tail ≤ a-few-ULP like cvt_gray.
YCRCB_SHIFT = 14
YCRCB_CR, YCRCB_CG = 4899, 9617                 # round(0.299/0.587 · 2^14)
YCRCB_CB = (1 << 14) - YCRCB_CR - YCRCB_CG      # 1868: sum-preserving
YCRCB_C713 = 11682                              # round(0.713 · 2^14)
YCRCB_C564 = 9241                               # round(0.564 · 2^14)
YCRCB_INV = (22987, 11698, 5636, 29049)         # 1.403, 0.714, 0.344, 1.773


def _delta(dtype):
    return {jnp.dtype(jnp.uint8): 128, jnp.dtype(jnp.uint16): 32768}[jnp.dtype(dtype)]


def rgb_to_ycrcb_nhwc(img: jnp.ndarray, order: str = "rgb") -> jnp.ndarray:
    """``cv2.cvtColor(..., COLOR_{RGB,BGR}2YCrCb)`` on ``[..., H, W, 3]``."""
    if img.shape[-1] != 3:
        raise ValueError(f"expected a trailing channel axis of 3, got {img.shape}")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    ri, gi, bi = (0, 1, 2) if order == "rgb" else (2, 1, 0)
    if img.dtype == jnp.float32:
        w = {ri: jnp.float32(0.299), gi: jnp.float32(0.587), bi: jnp.float32(0.114)}
        x0, x1, x2 = img[..., 0], img[..., 1], img[..., 2]
        y = fma32(x0, w[0], fma32(x1, w[1], x2 * w[2]))
        half = jnp.float32(0.5)
        cr = fma32(img[..., ri] - y, jnp.float32(0.713), jnp.broadcast_to(half, y.shape))
        cb = fma32(img[..., bi] - y, jnp.float32(0.564), jnp.broadcast_to(half, y.shape))
        return jnp.stack([y, cr, cb], axis=-1)
    if img.dtype not in (jnp.uint8, jnp.uint16):
        raise TypeError(f"expected uint8/uint16/float32, got {img.dtype}")
    r = img[..., ri].astype(jnp.int32)
    g = img[..., gi].astype(jnp.int32)
    b = img[..., bi].astype(jnp.int32)
    half = 1 << (YCRCB_SHIFT - 1)
    y = jnp.right_shift(r * YCRCB_CR + g * YCRCB_CG + b * YCRCB_CB + half, YCRCB_SHIFT)
    d = _delta(img.dtype)
    cr = jnp.right_shift((r - y) * YCRCB_C713 + half, YCRCB_SHIFT) + d
    cb = jnp.right_shift((b - y) * YCRCB_C564 + half, YCRCB_SHIFT) + d
    maxv = 2 * d - 1
    return jnp.stack(
        [jnp.clip(v, 0, maxv) for v in (y, cr, cb)], axis=-1
    ).astype(img.dtype)


def ycrcb_to_rgb_nhwc(img: jnp.ndarray, order: str = "rgb") -> jnp.ndarray:
    """``cv2.cvtColor(..., COLOR_YCrCb2{RGB,BGR})`` on ``[..., H, W, 3]``."""
    if img.shape[-1] != 3:
        raise ValueError(f"expected a trailing channel axis of 3, got {img.shape}")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    c1, c2, c3, c4 = YCRCB_INV
    if img.dtype == jnp.float32:
        y, cr, cb = img[..., 0], img[..., 1], img[..., 2]
        dcr = cr - jnp.float32(0.5)
        dcb = cb - jnp.float32(0.5)
        f1, f2, f3, f4 = (jnp.float32(v) for v in (1.403, -0.714, -0.344, 1.773))
        r = fma32(dcr, f1, y)
        g = fma32(dcr, f2, fma32(dcb, f3, y))
        b = fma32(dcb, f4, y)
        out = [r, g, b]
    elif img.dtype in (jnp.uint8, jnp.uint16):
        d = _delta(img.dtype)
        maxv = 2 * d - 1
        half = 1 << (YCRCB_SHIFT - 1)
        y = img[..., 0].astype(jnp.int32)
        dcr = img[..., 1].astype(jnp.int32) - d
        dcb = img[..., 2].astype(jnp.int32) - d
        r = y + jnp.right_shift(dcr * c1 + half, YCRCB_SHIFT)
        g = y + jnp.right_shift(dcr * (-c2) + dcb * (-c3) + half, YCRCB_SHIFT)
        b = y + jnp.right_shift(dcb * c4 + half, YCRCB_SHIFT)
        out = [jnp.clip(v, 0, maxv) for v in (r, g, b)]
    else:
        raise TypeError(f"expected uint8/uint16/float32, got {img.dtype}")
    if order == "bgr":
        out = out[::-1]
    return jnp.stack(out, axis=-1).astype(img.dtype)


# ------------------------------------------------------------------ HSV
# cv2 u8 HSV (ref/ops.py): forward = exact 12-bit fixed point (sdiv/hdiv
# gather tables); inverse = cv2's f32 sector chain with the SIMD body's
# TRUNCATING final ·255 (cv2's own scalar tail rounds — build-dependent
# ±1 there, docs/PARITY.md).
from imageenhancement_mp_tpu.ref.ops import _HSV_SECTOR as HSV_SECTOR


def rgb_to_hsv_nhwc(img: jnp.ndarray, order: str = "rgb") -> jnp.ndarray:
    """``cv2.cvtColor(..2HSV)`` on uint8 ``[..., H, W, 3]`` (H ∈ 0..179)."""
    import numpy as np

    if img.dtype != jnp.uint8:
        raise TypeError(f"HSV is uint8-only here (cv2's 8u path), got {img.dtype}")
    if img.shape[-1] != 3:
        raise ValueError(f"expected a trailing channel axis of 3, got {img.shape}")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    from imageenhancement_mp_tpu.ref.ops import _hsv_tables

    sdiv_np, hdiv_np = _hsv_tables()
    sdiv = jnp.asarray(sdiv_np.astype(np.int32))
    hdiv = jnp.asarray(hdiv_np.astype(np.int32))
    ri, gi, bi = (0, 1, 2) if order == "rgb" else (2, 1, 0)
    r = img[..., ri].astype(jnp.int32)
    g = img[..., gi].astype(jnp.int32)
    b = img[..., bi].astype(jnp.int32)
    from imageenhancement_mp_tpu.ref.ops import _HSV_SHIFT

    v = jnp.maximum(jnp.maximum(r, g), b)
    vmin = jnp.minimum(jnp.minimum(r, g), b)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)
    s = jnp.right_shift(diff * sdiv[v] + half, _HSV_SHIFT)
    h_raw = jnp.where(v == r, g - b,
                      jnp.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = jnp.right_shift(h_raw * hdiv[diff] + half, _HSV_SHIFT)
    h = jnp.where(h < 0, h + 180, h)
    return jnp.stack([h, s, v], axis=-1).astype(jnp.uint8)


def hsv_to_rgb_nhwc(img: jnp.ndarray, order: str = "rgb") -> jnp.ndarray:
    """``cv2.cvtColor(COLOR_HSV2..)`` on uint8 — the SIMD-body model."""
    if img.dtype != jnp.uint8:
        raise TypeError(f"HSV is uint8-only here (cv2's 8u path), got {img.dtype}")
    if img.shape[-1] != 3:
        raise ValueError(f"expected a trailing channel axis of 3, got {img.shape}")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    from imageenhancement_mp_tpu.utils.fma import two_prod

    def rmul(a, b):
        # force an explicitly ROUNDED f32 product (two_prod's error-term
        # structure defeats XLA:CPU's FMA contraction, which otherwise
        # fuses v*(1 - s*f) and flips ±1 vs the pinned model — the same
        # trick the stretch/addWeighted emulation relies on)
        return two_prod(a, b)[0]

    h = img[..., 0].astype(jnp.float32) * jnp.float32(6.0 / 180.0)
    s = img[..., 1].astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    v = img[..., 2].astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    fl = jnp.floor(h)
    sector = jnp.mod(fl.astype(jnp.int32), 6)
    f = h - fl
    one = jnp.float32(1.0)
    tab = [v,
           rmul(v, one - s),
           rmul(v, one - rmul(s, f)),
           rmul(v, one - rmul(s, one - f))]
    out = []
    for comp in range(3):
        val = tab[0]
        for k in range(6):
            val = jnp.where(sector == k, tab[HSV_SECTOR[k][comp]], val)
        out.append(jnp.clip(jnp.floor(rmul(val, jnp.float32(255.0))), 0, 255))
    if order == "bgr":
        out = out[::-1]
    return jnp.stack(out, axis=-1).astype(jnp.uint8)


def rgb_to_hls_nhwc(img: jnp.ndarray, order: str = "rgb") -> jnp.ndarray:
    """``cv2.cvtColor(..2HLS)`` on uint8 — EXHAUSTIVELY bit-exact
    (ref/ops.py rgb_to_hls pins the law).

    Round 4: the 65536-entry (v,vmin)/(a,b)-pair tables are replaced by
    direct arithmetic — every table entry was itself a plain f32
    formula, and the two divisions (60/diff, diff/denom) reproduce
    cv2's correctly-rounded f32 quotient via ``utils.fma.df_div``
    (verified exhaustively over all 65536 grid pairs against the pinned
    tables — tests/test_color_arith.py).  Products that XLA:CPU could
    FMA-contract go through ``two_prod``.  This removes the per-pixel
    wide-table gathers (a 512-vreg chain / XLA scalar loop — the slow
    class in docs/DESIGN.md §11) from the path entirely: the op is now
    pure elementwise arithmetic."""
    from imageenhancement_mp_tpu.utils.fma import df_div, two_prod

    if img.dtype != jnp.uint8:
        raise TypeError(f"HLS is uint8-only here (cv2's 8u path), got {img.dtype}")
    if img.shape[-1] != 3:
        raise ValueError(f"expected a trailing channel axis of 3, got {img.shape}")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    ri, gi, bi = (0, 1, 2) if order == "rgb" else (2, 1, 0)
    f = img.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    R, G, B = f[..., ri], f[..., gi], f[..., bi]
    v = jnp.maximum(jnp.maximum(R, G), B)
    vmin = jnp.minimum(jnp.minimum(R, G), B)
    diff = v - vmin
    z = jnp.zeros_like(diff)
    live = diff > 0
    vsum = v + vmin
    l = vsum * jnp.float32(0.5)
    denom = jnp.where(l < 0.5, vsum, jnp.float32(2.0) - vsum)
    den2 = jnp.where(denom == 0, jnp.float32(1), denom)
    sval = jnp.where(live, df_div(diff, z, den2, z)[0], jnp.float32(0))
    L8 = jnp.round(two_prod(l, jnp.float32(255.0))[0]).astype(jnp.int32)
    S8 = jnp.clip(jnp.round(two_prod(sval, jnp.float32(255.0))[0]),
                  0, 255).astype(jnp.int32)
    d60 = df_div(jnp.float32(60.0) + z, z,
                 jnp.where(live, diff, jnp.float32(1)), z)[0]
    # branch select with cv2's r-first tie order
    is_r = v == R
    is_g = jnp.logical_and(~is_r, v == G)
    X = jnp.where(is_r, G - B, jnp.where(is_g, B - R, R - G))
    C = jnp.where(is_r, jnp.float32(0.0),
                  jnp.where(is_g, jnp.float32(120.0), jnp.float32(240.0)))
    h = fma32(X, d60, C)
    # the body re-FMAs a negative hue with +360 (single rounding)
    h = jnp.where(h < 0, fma32(X, d60, jnp.float32(360.0)), h)
    H8 = jnp.where(v == vmin, 0,
                   jnp.round(h * jnp.float32(0.5)).astype(jnp.int32))
    return jnp.stack([jnp.clip(H8, 0, 255).astype(jnp.uint8),
                      L8.astype(jnp.uint8), S8.astype(jnp.uint8)], -1)


def hls_to_rgb_nhwc(img: jnp.ndarray, order: str = "rgb") -> jnp.ndarray:
    """``cv2.cvtColor(HLS2..)`` on uint8 — EXHAUSTIVELY bit-exact
    (ref/ops.py hls_to_rgb; the sector chain's tie profile is
    insensitive to FMA contraction, so plain f32 arithmetic on the
    (L,S)-pair p1/p2 tables suffices)."""
    if img.dtype != jnp.uint8:
        raise TypeError(f"HLS is uint8-only here (cv2's 8u path), got {img.dtype}")
    if img.shape[-1] != 3:
        raise ValueError(f"expected a trailing channel axis of 3, got {img.shape}")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    from imageenhancement_mp_tpu.ref.ops import _HLS_SECTOR
    from imageenhancement_mp_tpu.utils.fma import two_prod

    # Round 4: the 65536-entry (L,S)-pair tables are plain f32 formulas
    # with NO division — computed directly per pixel (two_prod guards
    # the products against XLA:CPU FMA contraction; exhaustively equal
    # to the pinned tables, tests/test_color_arith.py).
    c = jnp.float32(1.0 / 255.0)
    L = img[..., 1].astype(jnp.float32) * c
    S = img[..., 2].astype(jnp.float32) * c
    p2 = jnp.where(L <= 0.5, two_prod(L, jnp.float32(1.0) + S)[0],
                   (L + S) - two_prod(L, S)[0])
    p1 = jnp.float32(2.0) * L - p2
    h6 = img[..., 0].astype(jnp.float32) * jnp.float32(6.0 / 180.0)
    h6 = jnp.where(h6 >= 6, h6 - jnp.float32(6.0), h6)
    sec = jnp.floor(h6).astype(jnp.int32)
    hf = h6 - sec.astype(jnp.float32)
    d = p2 - p1
    t2 = p1 + two_prod(d, jnp.float32(1.0) - hf)[0]
    t3 = p1 + two_prod(d, hf)[0]
    tab = [p2, p1, t2, t3]
    gray = img[..., 2] == 0
    out = []
    for comp in range(3):  # b, g, r
        val = tab[0]
        for k in range(6):
            val = jnp.where(sec == k, tab[_HLS_SECTOR[k][comp]], val)
        val = jnp.where(gray, L, val)
        out.append(jnp.clip(
            jnp.round(two_prod(val, jnp.float32(255.0))[0]), 0, 255))
    rgb = [out[2], out[1], out[0]]
    if order == "bgr":
        rgb = rgb[::-1]
    return jnp.stack(rgb, -1).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# XYZ / Lab (cv2.cvtColor RGB<->XYZ, RGB<->Lab) — u8 fixed point, pinned
# EXHAUSTIVELY bit-exact (every 2^24 input, both directions; ref/ops.py
# rgb_to_lab/lab_to_rgb carry the algorithm documentation)
# ---------------------------------------------------------------------------

def _lab_device_tabs():
    """Baked jnp copies of the oracle's integer tables."""
    from imageenhancement_mp_tpu.ref.ops import _lab_tabs

    gamma_b, cbrt_b, y_b, ify_b, adiv, bdiv, minab, abxz, invg = _lab_tabs()
    as32 = lambda a: jnp.asarray(a.astype("int32"))
    return (as32(gamma_b), as32(cbrt_b), as32(y_b), as32(ify_b),
            as32(adiv), as32(bdiv), int(minab), as32(abxz), as32(invg))


def rgb_to_xyz_nhwc(img: jnp.ndarray, order: str = "rgb") -> jnp.ndarray:
    """``cv2.cvtColor(RGB2XYZ)`` — u8 2^12 coeffs, half-up shift
    (exhaustively exact; ref/ops.py rgb_to_xyz); f32 = the matrix
    product (float tolerance)."""
    if img.shape[-1] != 3:
        raise TypeError("rgb_to_xyz requires [..,3]")
    import numpy as _np

    from imageenhancement_mp_tpu.ref.ops import _XYZ_FWD

    ri, gi, bi = (0, 1, 2) if order == "rgb" else (2, 1, 0)
    if img.dtype == jnp.float32:
        Mf = _XYZ_FWD.astype(_np.float32)
        ch = [img[..., ri], img[..., gi], img[..., bi]]
        return jnp.stack([ch[0] * Mf[k, 0] + ch[1] * Mf[k, 1]
                          + ch[2] * Mf[k, 2] for k in range(3)], -1)
    if img.dtype != jnp.uint8:
        raise TypeError("rgb_to_xyz requires uint8 or float32 [..,3]")
    C = _np.round(_XYZ_FWD * 4096).astype(_np.int32)
    r = img[..., ri].astype(jnp.int32)
    g = img[..., gi].astype(jnp.int32)
    b = img[..., bi].astype(jnp.int32)
    chans = [jnp.right_shift(r * int(C[k, 0]) + g * int(C[k, 1])
                             + b * int(C[k, 2]) + 2048, 12) for k in range(3)]
    return jnp.stack([jnp.clip(c, 0, 255) for c in chans], -1).astype(jnp.uint8)


def xyz_to_rgb_nhwc(img: jnp.ndarray, order: str = "rgb") -> jnp.ndarray:
    """``cv2.cvtColor(XYZ2RGB)`` — u8 2^12 coeffs (exhaustively exact);
    f32 = the inverse matrix product."""
    if img.shape[-1] != 3:
        raise TypeError("xyz_to_rgb requires [..,3]")
    import numpy as _np

    from imageenhancement_mp_tpu.ref.ops import _XYZ_INV

    if img.dtype == jnp.float32:
        Mf = _XYZ_INV.astype(_np.float32)
        ch = [img[..., 0], img[..., 1], img[..., 2]]
        out = jnp.stack([ch[0] * Mf[k, 0] + ch[1] * Mf[k, 1]
                         + ch[2] * Mf[k, 2] for k in range(3)], -1)
        return out[..., ::-1] if order == "bgr" else out
    if img.dtype != jnp.uint8:
        raise TypeError("xyz_to_rgb requires uint8 or float32 [..,3]")
    C = _np.round(_XYZ_INV * 4096).astype(_np.int32)
    x = img[..., 0].astype(jnp.int32)
    y = img[..., 1].astype(jnp.int32)
    z = img[..., 2].astype(jnp.int32)
    chans = [jnp.clip(jnp.right_shift(x * int(C[k, 0]) + y * int(C[k, 1])
                                      + z * int(C[k, 2]) + 2048, 12), 0, 255)
             for k in range(3)]
    out = jnp.stack(chans, -1).astype(jnp.uint8)
    return out[..., ::-1] if order == "bgr" else out


def rgb_to_lab_nhwc(img: jnp.ndarray, order: str = "rgb",
                    srgb: bool = True) -> jnp.ndarray:
    """``cv2.cvtColor(RGB2LAB)`` — u8 via cv2's table fixed point,
    exhaustively bit-exact (``srgb=False`` == COLOR_LRGB2LAB, the
    linear-RGB variant, also exhaustive-exact); f32 via the analytic
    CIE formulas (the documented deviation from cv2's coarse
    interpolated-LUT f32 path — ref/ops.py rgb_to_lab)."""
    if img.shape[-1] != 3:
        raise TypeError("rgb_to_lab requires [..,3]")
    if img.dtype == jnp.float32:
        import numpy as _np

        from imageenhancement_mp_tpu.ref.ops import _LAB_WHITE, _XYZ_FWD

        ri, gi, bi = (0, 1, 2) if order == "rgb" else (2, 1, 0)
        r = jnp.stack([img[..., ri], img[..., gi], img[..., bi]], -1)
        if srgb:
            r = jnp.where(r > 0.04045, ((r + 0.055) / 1.055) ** 2.4, r / 12.92)
        Mw = (_XYZ_FWD / _LAB_WHITE[:, None]).astype(_np.float32)
        xyz = [r[..., 0] * Mw[k, 0] + r[..., 1] * Mw[k, 1]
               + r[..., 2] * Mw[k, 2] for k in range(3)]
        f = [jnp.where(t > 0.008856, jnp.cbrt(t),
                       jnp.float32(7.787) * t + jnp.float32(16.0 / 116.0))
             for t in xyz]
        L = jnp.where(xyz[1] > 0.008856, 116.0 * f[1] - 16.0, 903.3 * xyz[1])
        return jnp.stack([L, 500.0 * (f[0] - f[1]), 200.0 * (f[1] - f[2])], -1)
    if img.dtype != jnp.uint8:
        raise TypeError("rgb_to_lab requires uint8 or float32 [..,3]")
    gamma_b, cbrt_b = _lab_device_tabs()[:2]
    ri, gi, bi = (0, 1, 2) if order == "rgb" else (2, 1, 0)
    if srgb:
        R = _take1(gamma_b, img[..., ri].astype(jnp.int32))
        G = _take1(gamma_b, img[..., gi].astype(jnp.int32))
        B = _take1(gamma_b, img[..., bi].astype(jnp.int32))
    else:
        R = img[..., ri].astype(jnp.int32) << 3
        G = img[..., gi].astype(jnp.int32) << 3
        B = img[..., bi].astype(jnp.int32) << 3
    from imageenhancement_mp_tpu.ref.ops import _LAB_C_FWD

    C = _LAB_C_FWD
    def cb(k):
        acc = (R * int(C[k, 0]) + G * int(C[k, 1]) + B * int(C[k, 2]) + 2048)
        return _take1(cbrt_b, jnp.clip(jnp.right_shift(acc, 12), 0, 3071))
    fX, fY, fZ = cb(0), cb(1), cb(2)
    Lscale = (116 * 255 + 50) // 100
    Lshift = -((16 * 255 * (1 << 15) + 50) // 100)
    L = jnp.right_shift(Lscale * fY + Lshift + (1 << 14), 15)
    a = jnp.right_shift(500 * (fX - fY) + (128 << 15) + (1 << 14), 15)
    b = jnp.right_shift(200 * (fY - fZ) + (128 << 15) + (1 << 14), 15)
    return jnp.stack([jnp.clip(L, 0, 255), jnp.clip(a, 0, 255),
                      jnp.clip(b, 0, 255)], -1).astype(jnp.uint8)


def lab_to_rgb_nhwc(img: jnp.ndarray, order: str = "rgb",
                    srgb: bool = True) -> jnp.ndarray:
    """``cv2.cvtColor(LAB2RGB)`` — u8 via cv2's integer inverse,
    exhaustively bit-exact (``srgb=False`` == COLOR_LAB2LRGB: the
    linear output truncates ``(v*255) >> 12``); f32 via the analytic
    float inverse (ref/ops.py lab_to_rgb)."""
    if img.shape[-1] != 3:
        raise TypeError("lab_to_rgb requires [..,3]")
    if img.dtype == jnp.float32:
        import numpy as _np

        from imageenhancement_mp_tpu.ref.ops import _LAB_WHITE, _XYZ_INV

        L, a, b = img[..., 0], img[..., 1], img[..., 2]
        fy = (L + 16.0) / 116.0
        fx, fz = fy + a / 500.0, fy - b / 200.0

        def fi(t):
            return jnp.where(t * t * t > 0.008856, t * t * t,
                             (t - jnp.float32(16.0 / 116.0)) / 7.787)

        x = fi(fx) * jnp.float32(_LAB_WHITE[0])
        y = jnp.where(L > 8.0, fy * fy * fy, L / 903.3)
        z = fi(fz) * jnp.float32(_LAB_WHITE[2])
        Mi = _XYZ_INV.astype(_np.float32)
        rgb = [jnp.maximum(x * Mi[k, 0] + y * Mi[k, 1] + z * Mi[k, 2], 0.0)
               for k in range(3)]
        if srgb:
            rgb = [jnp.where(c > 0.0031308,
                             1.055 * c ** jnp.float32(1 / 2.4) - 0.055,
                             12.92 * c) for c in rgb]
        out = jnp.stack([jnp.clip(c, 0.0, 1.0) for c in rgb], -1)
        return out[..., ::-1] if order == "bgr" else out
    if img.dtype != jnp.uint8:
        raise TypeError("lab_to_rgb requires uint8 or float32 [..,3]")
    (_, _, y_b, ify_b, adiv, bdiv, minab, abxz, invg) = _lab_device_tabs()
    LL = img[..., 0].astype(jnp.int32)
    aa = img[..., 1].astype(jnp.int32)
    bb = img[..., 2].astype(jnp.int32)
    y = _take1(y_b, LL)
    ify = _take1(ify_b, LL)
    n_ab = abxz.shape[0]
    x = _take1(abxz, jnp.clip(ify + _take1(adiv, aa) - minab, 0, n_ab - 1))
    z = _take1(abxz, jnp.clip(ify - _take1(bdiv, bb) - minab, 0, n_ab - 1))
    from imageenhancement_mp_tpu.ref.ops import _LAB_C_INV

    C = _LAB_C_INV
    chans = []
    for k in range(3):
        v = jnp.right_shift(x * int(C[k, 0]) + y * int(C[k, 1])
                            + z * int(C[k, 2]) + (1 << 13), 14)
        v = jnp.clip(v, 0, 4095)
        chans.append(_take1(invg, v) if srgb
                     else jnp.right_shift(v * 255, 12))
    out = jnp.stack(chans, -1).astype(jnp.uint8)
    return out[..., ::-1] if order == "bgr" else out


@lru_cache(maxsize=None)
def _luv_host_tabs():
    import numpy as np

    from imageenhancement_mp_tpu.ref.ops import _luv_u8_tabs

    tab, T = _luv_u8_tabs()
    return tab.astype(np.int32), T.reshape(-1, 3).astype(np.int32)


def rgb_to_luv_nhwc(img: jnp.ndarray, order: str = "rgb") -> jnp.ndarray:
    """``cv2.cvtColor(RGB2Luv)`` on ``(N, H, W, 3)`` uint8 — the packed
    trilinear path (ref/ops.py ``_luv_u8_tabs``; structure pinned,
    budget ±1 LSB on ≲3.5 %/1.1 %/1.5 % px per channel).  Pure integer
    math around three LUT gathers; device == oracle bitwise."""
    if order == "bgr":
        img = img[..., ::-1]
    if img.dtype == jnp.float32:
        # float path: device f32 transcendentals vs the oracle's f64
        # emulation — ~1e-3 absolute on the [0,100]/[-134,220] scales
        f = jnp.float32
        x = img
        g = jnp.where(x <= f(0.04045), x / f(12.92),
                      ((x + f(0.055)) / f(1.055)) ** f(2.4))
        r_, g_, b_ = g[..., 0], g[..., 1], g[..., 2]
        X = f(0.412453)*r_ + f(0.357580)*g_ + f(0.180423)*b_
        Y = f(0.212671)*r_ + f(0.715160)*g_ + f(0.072169)*b_
        Z = f(0.019334)*r_ + f(0.119193)*g_ + f(0.950227)*b_
        from imageenhancement_mp_tpu.ref.ops import _LUV_UN, _LUV_VN
        L = jnp.where(Y > f(0.008856), f(116)*jnp.cbrt(Y) - f(16), f(903.3)*Y)
        d = X + f(15)*Y + f(3)*Z
        dd = jnp.maximum(d, f(1e-30))
        up = jnp.where(d > 0, f(4)*X/dd, f(0))
        vp = jnp.where(d > 0, f(9)*Y/dd, f(0))
        return jnp.stack([L, f(13)*L*(up - f(_LUV_UN)),
                          f(13)*L*(vp - f(_LUV_VN))], -1)
    if img.dtype != jnp.uint8:
        raise TypeError("rgb_to_luv_nhwc requires uint8/float32 NHWC input")
    tab_np, T_np = _luv_host_tabs()
    tab = jnp.asarray(tab_np)
    T = jnp.asarray(T_np)                        # (33*33*33, 3)
    c = _take1(tab, img.astype(jnp.int32))     # (N,H,W,3)
    t = c >> 9
    f = (c & 511).astype(jnp.int32)
    t1 = jnp.minimum(t + 1, 32)
    def corner(dp, dq, dr):
        ix = t1[..., 0] if dp else t[..., 0]
        iy = t1[..., 1] if dq else t[..., 1]
        iz = t1[..., 2] if dr else t[..., 2]
        idx3 = (ix * 33 + iy) * 33 + iz
        return jnp.stack([_take1(T[:, ch], idx3) for ch in range(3)], -1)
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    R = jnp.asarray([256, 0, 256], jnp.int32)    # per-channel stage rounding
    P = jnp.asarray([0, 32, 32], jnp.int32)      # per-channel post rounding
    m = {}
    for dq in (0, 1):
        for dr in (0, 1):
            m[dq, dr] = ((512 - fx) * corner(0, dq, dr)
                         + fx * corner(1, dq, dr) + R) >> 9
    my0 = ((512 - fy) * m[0, 0] + fy * m[1, 0] + R) >> 9
    my1 = ((512 - fy) * m[0, 1] + fy * m[1, 1] + R) >> 9
    val = ((512 - fz) * my0 + fz * my1 + R) >> 9
    return jnp.clip((val + P) >> 6, 0, 255).astype(jnp.uint8)


def luv_to_rgb_nhwc(img: jnp.ndarray, order: str = "rgb") -> jnp.ndarray:
    """``cv2.cvtColor(Luv2RGB)`` on ``(N, H, W, 3)`` uint8 — unpack +
    the f32 float path with the oracle's in-gamut u'/v' clamp
    (ref/ops.py ``luv_to_rgb``), cvRound.  Device f32 transcendentals
    vs the oracle's f64 emulation: ±1 LSB razor ties."""
    from imageenhancement_mp_tpu.ref.ops import (_LUV_UN, _LUV_VN,
                                                 _LUV_UP_RANGE, _LUV_VP_RANGE)

    if img.dtype not in (jnp.uint8, jnp.float32):
        raise TypeError("luv_to_rgb_nhwc requires uint8/float32 NHWC input")
    f32 = jnp.float32
    isf = img.dtype == jnp.float32
    if isf:
        L, u, v = img[..., 0], img[..., 1], img[..., 2]
    else:
        L = img[..., 0].astype(f32) * f32(100.0 / 255.0)
        u = img[..., 1].astype(f32) * f32(354.0 / 255.0) - f32(134.0)
        v = img[..., 2].astype(f32) * f32(262.0 / 255.0) - f32(140.0)
    Y = jnp.where(L > 8.0, ((L + f32(16)) / f32(116)) ** 3, L / f32(903.3))
    denom = jnp.maximum(f32(13) * L, f32(1e-6))
    if isf:
        # float path: no gamut clamp (cv2's f32 inverse doesn't clamp)
        up = u / denom + f32(_LUV_UN)
        vp = v / denom + f32(_LUV_VN)
    else:
        up = jnp.clip(u / denom + f32(_LUV_UN), *_LUV_UP_RANGE)
        vp = jnp.clip(v / denom + f32(_LUV_VN), *_LUV_VP_RANGE)
    vp = jnp.where(vp == 0, f32(1e-30), vp)
    X = f32(2.25) * Y * up / vp
    Z = Y * (f32(3) - f32(0.75) * up - f32(5) * vp) / vp
    r_ = f32(3.240479) * X - f32(1.53715) * Y - f32(0.498535) * Z
    g_ = f32(-0.969256) * X + f32(1.875991) * Y + f32(0.041556) * Z
    b_ = f32(0.055648) * X - f32(0.204043) * Y + f32(1.057311) * Z
    rgb = jnp.clip(jnp.stack([r_, g_, b_], -1), 0.0, None)
    rgb = jnp.where(rgb <= 0.0031308, f32(12.92) * rgb,
                    f32(1.055) * jnp.maximum(rgb, f32(1e-12)) ** f32(1 / 2.4)
                    - f32(0.055))
    if isf:
        return rgb[..., ::-1] if order == "bgr" else rgb
    out = jnp.clip(jnp.round(rgb * f32(255.0)), 0, 255).astype(jnp.uint8)
    return out[..., ::-1] if order == "bgr" else out
