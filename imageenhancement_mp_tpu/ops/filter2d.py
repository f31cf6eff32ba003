"""Custom-kernel correlation: ``cv2.filter2D`` parity.

The generic hook behind bespoke sharpening/embossing masks (the pinned
contract lives in ref/ops.py ``filter2d``).  Device mapping: the kernel is
STATIC, so the correlation unrolls into kh·kw shifted adds that XLA
fuses into one pass:

* integer-valued kernels on integer images → exact int32 accumulation
  (guarded against overflow);
* float kernels on integer images → DOUBLE-FLOAT f32 accumulation
  (Dekker/Knuth error terms) reproducing cv2's f64-equivalent u8 path
  bit-exactly, with the half-even double-float round from
  ops/threshold.py;
* float32 images → plain f32 accumulation (cv2's float path).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from imageenhancement_mp_tpu.ops.threshold import _round_df
from imageenhancement_mp_tpu.utils.fma import two_prod, two_sum
from imageenhancement_mp_tpu.utils.ranges import int_bounds

__all__ = ["filter2d_planes"]

_MAX_K = 15  # per-axis kernel bound (unroll limit)


def filter2d_planes(planes: jnp.ndarray, kernel, delta: float = 0.0) -> jnp.ndarray:
    """``cv2.filter2D(img, -1, kernel, delta)`` per plane (see module doc)."""
    if planes.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    k = np.asarray(kernel, np.float64)
    if k.ndim != 2:
        raise ValueError(f"kernel must be 2-D, got shape {k.shape}")
    kh, kw = k.shape
    if kh > _MAX_K or kw > _MAX_K:
        raise ValueError(f"kernel {kh}x{kw} exceeds the {_MAX_K}x{_MAX_K} unroll bound")
    H, W = planes.shape[-2], planes.shape[-1]
    pad = ((0, 0), (kh // 2, kh - 1 - kh // 2), (kw // 2, kw - 1 - kw // 2))
    taps = [(dy, dx, float(k[dy, dx]))
            for dy in range(kh) for dx in range(kw) if k[dy, dx] != 0.0]
    if not taps:  # all-zero kernel: acc ≡ 0, output is the delta constant
        if planes.dtype == jnp.float32:
            return jnp.full(planes.shape, jnp.float32(delta))
        minv, maxv = int_bounds(planes.dtype)
        const = int(np.clip(np.round(float(delta)), minv, maxv))
        return jnp.full(planes.shape, const, planes.dtype)
    if planes.dtype == jnp.float32:
        p = jnp.pad(planes, pad, mode="reflect")
        acc = sum(jnp.float32(t) * p[:, dy : dy + H, dx : dx + W]
                  for dy, dx, t in taps)
        return (acc + jnp.float32(delta)).astype(jnp.float32)
    minv, maxv = int_bounds(planes.dtype)
    integral = all(t == int(t) for _, _, t in taps)
    bound = sum(abs(int(t)) if integral else 0 for _, _, t in taps) * max(abs(minv), maxv)
    if integral and bound < 2**30:
        p = jnp.pad(planes.astype(jnp.int32), pad, mode="reflect")
        acc = sum(int(t) * p[:, dy : dy + H, dx : dx + W] for dy, dx, t in taps)
        # round(acc + δ) JOINTLY, half-to-even (pre-rounding δ is wrong:
        # round(x + 0.5) depends on x's parity) — acc is integral, so the
        # rounded result is acc + floor(δ) + carry, where the δ=.5 tie
        # resolves by the parity of acc + floor(δ)
        dint = int(np.floor(float(delta)))
        dfrac = float(delta) - dint
        if abs(dint) >= 2**30:
            # |δ| dwarfs |acc| (< 2³⁰): every pixel saturates the same way
            return jnp.full(planes.shape, minv if dint < 0 else maxv, planes.dtype)
        if dfrac > 0.5:
            carry = jnp.int32(1)
        elif dfrac < 0.5:
            carry = jnp.int32(0)
        else:
            carry = ((acc + dint) & 1).astype(jnp.int32)  # half-even tie
        out = acc + dint + carry  # |acc|<2³⁰, |dint|<2³⁰: no wrap
        return jnp.clip(out, minv, maxv).astype(planes.dtype)
    # double-float accumulation: exact f64 emulation for cv2's u8 float
    # path; within the documented ±1 of cv2's own f32 path for 16-bit.
    # Integral kernels whose int32 bound overflows also land here and
    # REMAIN exact: the double-float residual is ~2⁻⁴⁰·|acc|, far below
    # the 0.5 rounding threshold even at 2³¹ magnitudes
    p = jnp.pad(planes, pad, mode="reflect").astype(jnp.float32)
    s = e = None
    for dy, dx, t in taps:
        hi = jnp.float32(t)
        lo = jnp.float32(t - float(np.float32(t)))
        v = p[:, dy : dy + H, dx : dx + W]
        ph, pe = two_prod(v, hi)
        pl = v * lo
        if s is None:
            s, e = ph, pe + pl
        else:
            s, te = two_sum(s, ph)
            e = e + (te + (pe + pl))
    # fold delta into the double-float before the single rounding
    dhi = jnp.float32(float(np.float32(delta)))
    dlo = jnp.float32(float(delta) - float(np.float32(delta)))
    s, te = two_sum(s, jnp.broadcast_to(dhi, s.shape))
    e = e + te + dlo
    out = _round_df(s, e)
    return jnp.clip(out, minv, maxv).astype(planes.dtype)
