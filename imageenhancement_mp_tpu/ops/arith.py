"""Core per-element arithmetic: cv2.add/subtract/multiply/divide/
absdiff/bitwise/min/max/compare on device (contracts in ref/ops.py).

Device mapping: pure elementwise programs on RAW arrays (no plane
canonicalization needed — elementwise ops are shape-agnostic), fused by
XLA into single passes.  The only care is cv2's saturate_cast quirk:
cvRound of an out-of-int32 value yields INT_MIN, so huge positive
products saturate to the dtype MIN, not max — the u16 multiply path
reproduces this with an exact double-float product (u16·u16 exceeds
f32's 24-bit mantissa).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from imageenhancement_mp_tpu.utils.fma import two_prod
from imageenhancement_mp_tpu.utils.ranges import int_bounds

__all__ = ["arith_arrays"]

_INT_DTS = (jnp.uint8, jnp.uint16, jnp.int16)
_CMP = {"eq": jnp.equal, "gt": jnp.greater, "ge": jnp.greater_equal,
        "lt": jnp.less, "le": jnp.less_equal, "ne": jnp.not_equal}


def _check(a, b=None):
    if a.dtype not in _INT_DTS + (jnp.float32,):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {a.dtype}")
    if b is not None and (b.dtype != a.dtype or b.shape != a.shape):
        raise ValueError("inputs must share dtype and shape")


def _sat(v32, dtype):
    """int-dtype saturate of an exact-int f32 value (|v| < 2^24)."""
    minv, maxv = int_bounds(dtype)
    return jnp.clip(v32, minv, maxv).astype(dtype)


def arith_arrays(op: str, a: jnp.ndarray, b: jnp.ndarray = None,
                 scale: float = 1.0) -> jnp.ndarray:
    """Dispatch one elementwise cv2 arithmetic op on raw arrays."""
    if op == "bitwise_not":
        _check(a)
        if a.dtype == jnp.float32:
            raise TypeError("bitwise ops support integer dtypes")
        return ~a
    _check(a, b)
    is_f32 = a.dtype == jnp.float32
    if op in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        if is_f32:
            raise TypeError("bitwise ops support integer dtypes")
        return {"bitwise_and": a & b, "bitwise_or": a | b,
                "bitwise_xor": a ^ b}[op]
    if op == "minimum":
        return jnp.minimum(a, b)
    if op == "maximum":
        return jnp.maximum(a, b)
    if op in _CMP:
        return jnp.where(_CMP[op](a, b), jnp.uint8(255), jnp.uint8(0))
    if op in ("add", "subtract", "absdiff"):
        if is_f32:
            r = a + b if op == "add" else a - b
            return jnp.abs(r) if op == "absdiff" else r
        # int32 holds every exact sum/difference
        ai, bi = a.astype(jnp.int32), b.astype(jnp.int32)
        r = ai + bi if op == "add" else ai - bi
        if op == "absdiff":
            r = jnp.abs(r)
        return _sat(r, a.dtype)
    if op == "multiply":
        if is_f32:
            return (a * b) * jnp.float32(scale)
        # exact product as a double-float (u16*u16 needs 32 bits), then
        # the f64-equivalent scale and cv2's INT_MIN overflow rule
        af, bf = a.astype(jnp.float32), b.astype(jnp.float32)
        ph, pl = two_prod(af, bf)
        sh = jnp.float32(np.float32(scale))
        sl = jnp.float32(float(scale) - float(np.float32(scale)))
        vh, vl = two_prod(ph, sh)
        vl = vl + ph * sl + pl * jnp.float32(scale)
        from imageenhancement_mp_tpu.ops.threshold import _round_df

        r = _round_df(vh, vl)
        v = vh + vl
        r = jnp.where((v >= jnp.float32(2.0 ** 31)) | (v < jnp.float32(-(2.0 ** 31))),
                      jnp.float32(-(2.0 ** 31)), r)
        minv, maxv = int_bounds(a.dtype)
        return jnp.clip(r, minv, maxv).astype(a.dtype)
    if op == "divide":
        if is_f32:
            return (a * jnp.float32(scale)) / b
        # a*scale exactly as double-float, then f32 division: the
        # quotient fits f32 to ~1e-7 relative — razor half-even ties
        # carry a ±1 budget vs the f64 oracle (docs/PARITY.md)
        af, bf = a.astype(jnp.float32), b.astype(jnp.float32)
        sh = jnp.float32(np.float32(scale))
        sl = jnp.float32(float(scale) - float(np.float32(scale)))
        nh, nl = two_prod(af, sh)
        nl = nl + af * sl
        safe = jnp.where(bf == 0, jnp.float32(1), bf)
        q = nh / safe + nl / safe
        q = jnp.where(bf == 0, jnp.float32(0), q)
        minv, maxv = int_bounds(a.dtype)
        return jnp.clip(jnp.round(q), minv, maxv).astype(a.dtype)
    raise ValueError(f"unknown arithmetic op {op!r}")
