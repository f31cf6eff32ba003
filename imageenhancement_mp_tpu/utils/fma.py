"""Exact f32 FMA emulation (no hardware FMA, no f64) — shared by the ops.

cv2's integer SIMD paths (convertScaleAbs, normalize's convertTo,
addWeighted) compute **single-rounded** f32 FMAs.  JAX f32 mul+add rounds
twice, flipping ties (±1 LSB after cvRound).  ``fma32`` reproduces the
single rounding exactly: Dekker two-product + Knuth two-sum give the exact
error terms, and adding them back yields the correctly rounded result
(0 mismatches vs the f64-reference FMA in 10M+ fuzz cases; see
docs/PARITY.md).  Plain arithmetic only.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "two_prod", "two_sum", "fma32", "df_add", "df_mul", "df_div", "df_sqrt",
]


def two_prod(x, y):
    """Dekker two-product: exact ``x·y = p + e`` in f32 (no FMA hardware)."""
    p = x * y
    c = jnp.float32(4097.0)  # 2^12 + 1: f32 Veltkamp split constant
    xx = x * c
    xh = xx - (xx - x)
    xl = x - xh
    yy = y * c
    yh = yy - (yy - y)
    yl = y - yh
    e = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl
    return p, e


def two_sum(x, y):
    """Knuth two-sum: exact ``x + y = s + e`` in f32, any signs."""
    s = x + y
    yp = s - x
    e = (x - (s - yp)) + (y - yp)
    return s, e


def fma32(x, scale, shift):
    """Single-rounded f32 FMA ``RN(x·scale + shift)`` (cv2's SIMD rounding)."""
    p, pe = two_prod(x, scale)
    s, se = two_sum(p, shift)
    return s + (pe + se)


def _quick_two_sum(a, b):
    """Dekker fast two-sum: exact ``a + b = s + e`` given ``|a| >= |b|``."""
    s = a + b
    return s, b - (s - a)


def df_add(ah, al, bh, bl):
    """Accurate double-float addition (IEEE-style dd-add).

    Exact for integer-valued operands whose sum stays under ~2^48 — the
    basis of the device-side exact reductions in ``ops/stats.py``; for
    general floats the result is within ~2^-47 relative."""
    s, e = two_sum(ah, bh)
    t, f = two_sum(al, bl)
    e = e + t
    s, e = _quick_two_sum(s, e)
    e = e + f
    return _quick_two_sum(s, e)


def df_mul(ah, al, bh, bl):
    """Double-float product (~2^-47 relative; al·bl term dropped)."""
    p, e = two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    return _quick_two_sum(p, e)


def df_div(ah, al, bh, bl):
    """Double-float division ``a / b`` (~2^-45 relative).

    One f32 reciprocal seed + a df Newton correction
    ``q ← q0 + q0·(1 − b·q0)``: the residual is formed with exact
    two_prod error terms so the correction removes the seed's full f32
    error.  Division by a df zero follows f32 semantics (±inf/nan)."""
    q0 = ah / bh
    # r = a − b·q0 exactly in df
    ph, pl = df_mul(bh, bl, q0, jnp.zeros_like(q0))
    rh, rl = df_add(ah, al, -ph, -pl)
    return df_add(q0, jnp.zeros_like(q0), rh / bh, rl / bh)


def df_sqrt(ah, al):
    """Double-float square root (~2^-45 relative; ``a >= 0``).

    f32 seed + one Heron step with exact residual:
    ``y ← y0 + (a − y0²) / (2·y0)``."""
    y0 = jnp.sqrt(ah)
    p, pe = two_prod(y0, y0)
    rh, rl = df_add(ah, al, -p, -pe)
    d = jnp.where(y0 > 0, jnp.float32(0.5) / y0, jnp.zeros_like(y0))
    return df_add(y0, jnp.zeros_like(y0), rh * d, rl * d)
