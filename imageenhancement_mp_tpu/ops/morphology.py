"""Morphology: erode/dilate (rect kernels) + the morphologyEx family.

``cv2.erode`` / ``cv2.dilate`` with rectangular structuring elements are
exact min/max window filters (pinned by probe, all dtypes): the border is
BORDER_CONSTANT at the operation's identity (+∞/dtype-max for erode,
−∞/dtype-min for dilate), so edge windows just ignore outside pixels.
``iterations=n`` applies the op n times; morphologyEx compositions
(probes): open = dilateⁿ(erodeⁿ), close = erodeⁿ(dilateⁿ), gradient =
sat(dilate − erode), tophat = sat(src − open), blackhat = sat(close − src).

Device mapping: kh+kw shifted min/max ops in one fused pass (read + write
of the plane); XLA fuses chains end-to-end.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = ["erode_planes", "dilate_planes", "morphology_planes", "MORPH_OPS"]

MORPH_OPS = ("erode", "dilate", "open", "close", "gradient", "tophat", "blackhat")


def _ksize2(ksize):
    if isinstance(ksize, (tuple, list)):
        kh, kw = int(ksize[0]), int(ksize[1])
    else:
        kh = kw = int(ksize)
    if kh < 1 or kw < 1:
        raise ValueError(f"ksize dims must be >= 1, got {(kh, kw)}")
    return kh, kw


def _identity(dtype, op: str):
    from imageenhancement_mp_tpu.utils.ranges import int_bounds

    if dtype == jnp.float32:
        return jnp.inf if op == "min" else -jnp.inf
    lo, hi = int_bounds(dtype)
    return hi if op == "min" else lo


def _minmax_filter(planes, kh, kw, op: str):
    H, W = planes.shape[-2], planes.shape[-1]
    pad = _identity(planes.dtype, op)
    p = jnp.pad(
        planes, ((0, 0), (kh // 2, kh - 1 - kh // 2), (kw // 2, kw - 1 - kw // 2)),
        mode="constant", constant_values=pad,
    )
    f = jnp.minimum if op == "min" else jnp.maximum
    acc = None
    for dy in range(kh):
        v = p[:, dy : dy + H, :]
        acc = v if acc is None else f(acc, v)
    out = None
    for dx in range(kw):
        v = acc[:, :, dx : dx + W]
        out = v if out is None else f(out, v)
    return out


def _minmax_filter_mask(planes, mask, op: str):
    """min/max over an arbitrary 0/1 kernel mask (identity-const pad —
    equivalent to cv2's border for extremum filters)."""
    mask = np.asarray(mask)
    kh, kw = mask.shape
    H, W = planes.shape[-2], planes.shape[-1]
    pad = _identity(planes.dtype, op)
    p = jnp.pad(
        planes, ((0, 0), (kh // 2, kh - 1 - kh // 2), (kw // 2, kw - 1 - kw // 2)),
        mode="constant", constant_values=pad,
    )
    f = jnp.minimum if op == "min" else jnp.maximum
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            if mask[dy, dx]:
                v = p[:, dy:dy + H, dx:dx + W]
                acc = v if acc is None else f(acc, v)
    return planes if acc is None else acc


def _check_dtype(planes):
    if planes.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")


def erode_planes(planes: jnp.ndarray, ksize=3, iterations: int = 1,
                 kernel=None) -> jnp.ndarray:
    """``cv2.erode`` per plane — exact min filter (rect ``ksize`` or an
    arbitrary 0/1 ``kernel`` mask)."""
    _check_dtype(planes)
    if kernel is not None:
        for _ in range(max(1, int(iterations))):
            planes = _minmax_filter_mask(planes, kernel, "min")
        return planes
    kh, kw = _ksize2(ksize)
    for _ in range(max(1, int(iterations))):
        planes = _minmax_filter(planes, kh, kw, "min")
    return planes


def dilate_planes(planes: jnp.ndarray, ksize=3, iterations: int = 1,
                  kernel=None) -> jnp.ndarray:
    """``cv2.dilate`` per plane — exact max filter (see ``erode_planes``)."""
    _check_dtype(planes)
    if kernel is not None:
        for _ in range(max(1, int(iterations))):
            planes = _minmax_filter_mask(planes, kernel, "max")
        return planes
    kh, kw = _ksize2(ksize)
    for _ in range(max(1, int(iterations))):
        planes = _minmax_filter(planes, kh, kw, "max")
    return planes


def _sat_sub(a, b, dtype):
    if dtype == jnp.float32:
        return a - b
    lo = _identity(dtype, "max")  # the dtype's min value
    hi = _identity(dtype, "min")  # the dtype's max value
    return jnp.clip(a.astype(jnp.int32) - b.astype(jnp.int32), lo, hi).astype(dtype)


def morphology_planes(
    planes: jnp.ndarray, op: str = "open", ksize=3, iterations: int = 1,
    kernel=None
) -> jnp.ndarray:
    """``cv2.morphologyEx`` (rect kernel) per plane — exact compositions."""
    if op not in MORPH_OPS:
        raise ValueError(f"op must be one of {MORPH_OPS}, got {op!r}")
    def E(x):
        return erode_planes(x, ksize, iterations, kernel)

    def D(x):
        return dilate_planes(x, ksize, iterations, kernel)

    if op == "erode":
        return E(planes)
    if op == "dilate":
        return D(planes)
    if op == "open":
        return D(E(planes))
    if op == "close":
        return E(D(planes))
    if op == "gradient":
        return _sat_sub(D(planes), E(planes), planes.dtype)
    if op == "tophat":
        return _sat_sub(planes, D(E(planes)), planes.dtype)
    return _sat_sub(E(D(planes)), planes, planes.dtype)  # blackhat
