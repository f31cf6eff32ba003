"""Gaussian pyramids: ``cv2.pyrDown`` / ``cv2.pyrUp`` parity.

Multi-scale enhancement primitives (pinned in ref/ops.py: REFLECT_101,
the [1,4,6,4,1] separable kernel, DESCALE shifts — exact for u8/u16/i16,
f32 at float tolerance).

Device mapping: the conv is 10 shifted int32 adds; the decimation/zero-stuff
are strided slices/scatter-free interleaves that XLA fuses with the conv
— one fused pass each way.  Pyramid levels change H×W, so these
ops are not row-shardable with a static mesh split (use batch DP).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["pyr_down_planes", "pyr_up_planes"]

_K = (1, 4, 6, 4, 1)


def _check(planes):
    if planes.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")


def pyr_down_planes(planes: jnp.ndarray) -> jnp.ndarray:
    """``cv2.pyrDown`` per plane → ``[B, ceil(H/2), ceil(W/2)]``."""
    _check(planes)
    H, W = planes.shape[-2], planes.shape[-1]
    if planes.dtype == jnp.float32:
        p = jnp.pad(planes, ((0, 0), (2, 2), (2, 2)), mode="reflect")
        v = sum(jnp.float32(k) * p[:, i : i + H, :] for i, k in enumerate(_K))
        a = sum(jnp.float32(k) * v[:, :, i : i + W] for i, k in enumerate(_K))
        return (a[:, ::2, ::2] * jnp.float32(1.0 / 256.0)).astype(jnp.float32)
    p = jnp.pad(planes.astype(jnp.int32), ((0, 0), (2, 2), (2, 2)), mode="reflect")
    v = sum(k * p[:, i : i + H, :] for i, k in enumerate(_K))
    a = sum(k * v[:, :, i : i + W] for i, k in enumerate(_K))
    return jnp.right_shift(a + 128, 8)[:, ::2, ::2].astype(planes.dtype)


def pyr_up_planes(planes: jnp.ndarray) -> jnp.ndarray:
    """``cv2.pyrUp`` per plane → ``[B, 2H, 2W]``."""
    _check(planes)
    B, H, W = planes.shape
    if planes.dtype == jnp.float32:
        up = jnp.zeros((B, 2 * H, 2 * W), jnp.float32).at[:, ::2, ::2].set(planes)
        p = jnp.pad(up, ((0, 0), (2, 2), (2, 2)), mode="reflect")
        v = sum(jnp.float32(k) * p[:, i : i + 2 * H, :] for i, k in enumerate(_K))
        a = sum(jnp.float32(k) * v[:, :, i : i + 2 * W] for i, k in enumerate(_K))
        return (a * jnp.float32(1.0 / 64.0)).astype(jnp.float32)
    up = jnp.zeros((B, 2 * H, 2 * W), jnp.int32).at[:, ::2, ::2].set(
        planes.astype(jnp.int32)
    )
    p = jnp.pad(up, ((0, 0), (2, 2), (2, 2)), mode="reflect")
    v = sum(k * p[:, i : i + 2 * H, :] for i, k in enumerate(_K))
    a = sum(k * v[:, :, i : i + 2 * W] for i, k in enumerate(_K))
    return jnp.right_shift(a + 32, 6).astype(planes.dtype)
