"""Thresholding: ``cv2.threshold`` parity (fixed + Otsu/Triangle auto).

The fixed-threshold op is a pure elementwise compare/select — one fused
pass.  The auto methods (Otsu, Triangle) need the image histogram and
a sequential 256-step scan in cv2's exact double arithmetic; the
histogram runs on device (ops/histogram.py) and
the tiny scan runs on host via the exact transcriptions in ref/ops.py
(1 KB fetch per plane — cv2's own API is host-synchronous here too: it
RETURNS the computed threshold).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from imageenhancement_mp_tpu.ref.ops import _THRESH_TYPES

__all__ = ["threshold_planes", "adaptive_threshold_planes", "THRESH_TYPES"]

THRESH_TYPES = _THRESH_TYPES


def threshold_planes(planes: jnp.ndarray, thresh=0.0, maxval: float = 255.0,
                     type: str = "binary") -> jnp.ndarray:
    """``cv2.threshold`` per plane (exact; see ref/ops.py ``threshold``).

    ``thresh``: a float (shared) or an array of per-plane thresholds
    ``[B]`` (the batched generalization of cv2's scalar — used by the
    Otsu/Triangle API path).
    """
    if type not in _THRESH_TYPES:
        raise ValueError(f"type must be one of {_THRESH_TYPES}, got {type!r}")
    if planes.dtype == jnp.float32:
        t = jnp.float32(thresh) if np.isscalar(thresh) else thresh.astype(jnp.float32)
        mv = jnp.float32(maxval)
        zero = jnp.float32(0)
        minv, maxv_d = None, None
    elif planes.dtype in (jnp.uint8, jnp.uint16, jnp.int16):
        from imageenhancement_mp_tpu.utils.ranges import int_bounds

        minv, maxv_d = int_bounds(planes.dtype)
        if np.isscalar(thresh):
            # clamp into the dtype's neighborhood BEFORE int32: comparisons
            # beyond the value range are constant anyway, and cv2/oracle
            # saturate rather than overflow (ref/ops.py threshold)
            t = jnp.int32(int(np.clip(np.floor(float(thresh)), minv - 1, maxv_d + 1)))
        else:
            t = thresh.astype(jnp.int32)
        mv = jnp.int32(int(np.clip(np.round(float(maxval)), minv, maxv_d)))
        zero = jnp.int32(0)
    else:
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    x = planes if planes.dtype == jnp.float32 else planes.astype(jnp.int32)
    if not np.isscalar(thresh):
        t = t[:, None, None]  # per-plane thresholds over [B, H, W]
    if type == "binary":
        out = jnp.where(x > t, mv, zero)
    elif type == "binary_inv":
        out = jnp.where(x > t, zero, mv)
    elif type == "trunc":
        if (planes.dtype != jnp.float32 and np.isscalar(thresh)
                and np.floor(float(thresh)) < minv):
            # cv2's pinned special case: below-range thresh → TRUNC zeros
            out = jnp.zeros_like(x)
        else:
            out = jnp.minimum(x, t)
            if planes.dtype != jnp.float32:
                out = jnp.clip(out, minv, maxv_d)
    elif type == "tozero":
        out = jnp.where(x > t, x, zero)
    else:  # tozero_inv
        out = jnp.where(x > t, zero, x)
    return out.astype(planes.dtype)


def _round_df(s, e):
    """Round a double-float (s + e) to the nearest integer, half-to-even,
    matching ``np.round`` of the f64 value it represents."""
    r0 = jnp.round(s)
    d = (s - r0) + e  # s−r0 exact (Sterbenz); one rounding on +e
    adj = jnp.where(d > 0.5, 1.0, jnp.where(d < -0.5, -1.0, 0.0))
    odd = jnp.mod(r0, 2.0) != 0
    adj = jnp.where((d == 0.5) & odd, 1.0, adj)
    adj = jnp.where((d == -0.5) & odd, -1.0, adj)
    return (r0 + adj).astype(jnp.int32)


def _df_sep_conv_round(planes, taps64):
    """round(f64 separable conv) with REPLICATE border, emulated on device
    in double-float f32 (Dekker/Knuth error terms — utils/fma.py).  For
    dyadic taps (σ=0, k ≤ 7) the low parts are zero and this is exact by
    construction; for f64 exp-based taps the ~2⁻⁴⁰ residual is far below
    the rounding boundary (fuzz-verified vs cv2)."""
    from imageenhancement_mp_tpu.utils.fma import two_prod, two_sum

    k = len(taps64)
    r = k // 2
    # host-side double-float split of the f64 taps (NumPy: traceable-safe)
    hi = [float(np.float32(t)) for t in taps64]
    lo = [float(np.float32(t - float(np.float32(t)))) for t in taps64]
    hi = [jnp.float32(t) for t in hi]
    lo = [jnp.float32(t) for t in lo]
    H, W = planes.shape[-2], planes.shape[-1]
    p = jnp.pad(planes, ((0, 0), (r, r), (r, r)), mode="edge").astype(jnp.float32)

    def df_conv(get):
        s = None
        for i in range(k):
            v = get(i)
            ph, pe = two_prod(v, hi[i])
            pl = v * lo[i]  # |v·lo| < 2^-20: one rounding is far below need
            if s is None:
                s, e = ph, pe + pl
            else:
                s, te = two_sum(s, ph)
                e = e + (te + (pe + pl))
        return s, e

    # vertical pass: keep (s, e) rows; horizontal pass consumes both parts
    vs, ve = df_conv(lambda i: p[:, i : i + H, :])

    def df_conv2():
        s = None
        for i in range(k):
            a, ae0 = two_prod(vs[:, :, i : i + W], hi[i])
            al = vs[:, :, i : i + W] * lo[i] + ve[:, :, i : i + W] * hi[i]
            if s is None:
                s, e = a, ae0 + al
            else:
                s, te = two_sum(s, a)
                e = e + (te + (ae0 + al))
        return s, e

    return _round_df(*df_conv2())


def adaptive_threshold_planes(
    planes: jnp.ndarray,
    maxval: float = 255.0,
    method: str = "mean",
    type: str = "binary",
    block_size: int = 3,
    C: float = 0.0,
) -> jnp.ndarray:
    """``cv2.adaptiveThreshold`` per plane — exact (uint8, like cv2).

    Pinned semantics (probes, 0 mismatches over 160+ fuzz configs):
    local mean over ``block_size`` with BORDER_REPLICATE — the box mean
    uses the blur f32-reciprocal model, the gaussian mean cv2's FLOAT
    kernel (σ=0 taps; NOT the u8 fixed-point GaussianBlur — a pinned
    quirk); ``idelta = ceil(C)`` for binary, ``floor(C)`` for
    binary_inv; ``dst = src > mean − idelta ? maxval : 0`` (inverted for
    binary_inv), maxval saturated like threshold.
    """
    if planes.dtype != jnp.uint8:
        raise TypeError(f"adaptive_threshold takes uint8 (like cv2), got {planes.dtype}")
    if type not in ("binary", "binary_inv"):
        raise ValueError(f"type must be binary|binary_inv, got {type!r}")
    if method not in ("mean", "gaussian"):
        raise ValueError(f"method must be mean|gaussian, got {method!r}")
    bs = int(block_size)
    if bs < 3 or bs % 2 == 0:
        raise ValueError(f"block_size must be odd and >= 3, got {bs}")
    H, W = planes.shape[-2], planes.shape[-1]
    if method == "mean":
        r = bs // 2
        p = jnp.pad(planes.astype(jnp.int32), ((0, 0), (r, r), (r, r)), mode="edge")
        rows = sum(p[:, j : j + H, :] for j in range(bs))
        S = sum(rows[:, :, j : j + W] for j in range(bs))
        mean = jnp.round(S.astype(jnp.float32) * jnp.float32(1.0 / (bs * bs))).astype(jnp.int32)
    else:
        from imageenhancement_mp_tpu.ref.ops import gaussian_kernel

        taps = [float(t) for t in gaussian_kernel(bs, 0.0)]
        mean = _df_sep_conv_round(planes, taps)
    idelta = int(np.ceil(C)) if type == "binary" else int(np.floor(C))
    mv = jnp.int32(int(np.clip(np.round(float(maxval)), 0, 255)))
    hit = planes.astype(jnp.int32) > mean - idelta
    out = jnp.where(hit, mv, 0) if type == "binary" else jnp.where(hit, 0, mv)
    return out.astype(jnp.uint8)
