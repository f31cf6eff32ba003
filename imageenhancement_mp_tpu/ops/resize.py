"""Geometric resize: ``cv2.resize`` parity on device (ref/ops.py
``resize`` holds the pinned contract; all index/coefficient tables are
built HOST-SIDE in NumPy via ``ref.resize_lin_tables`` so the device op
and the oracle share constants bit-for-bit).

Device mapping (all shapes static, tables baked into the program):

* nearest — two static gathers (``jnp.take``); bandwidth-bound copy.
* linear u8 — the pinned 2^11 fixed-point pipeline in int32: a static
  gather per axis + shifted multiplies; XLA fuses it into one pass.
  The vertical mul-high ``(x*b) >> 16`` needs |x| <= 2^15 and
  |b| <= 2^12, so the products stay inside int32.
* linear u16/i16/f32 — cv2's float path (f32 lerp per axis).
* area (downscale) — TWO MATMULS: ``out = round(Wy @ img @ Wx)`` with
  the per-axis area-weight matrices; matrix products instead of a
  gather loop.
* area (integer factors) — reshape-mean; the 2x2 fast path keeps
  cv2's ``(sum + 2) >> 2`` half-up quirk.
* area (any upscale axis) — the linear machinery with AREA coords.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from imageenhancement_mp_tpu.ref.ops import (cubic_weights, lanczos4_weights,
                                             resize_cubic_tables,
                                             resize_lanczos_tables,
                                             resize_lin_tables)
from imageenhancement_mp_tpu.utils.ranges import int_bounds

__all__ = ["resize_planes", "flip_planes", "rotate_planes", "transpose_planes"]

_RESIZE_SCALE = 1 << 11


def _fixed_coeffs(frac: np.ndarray):
    c2 = np.round(frac.astype(np.float64) * _RESIZE_SCALE).astype(np.int32)
    return _RESIZE_SCALE - c2, c2


def _linear_u8(planes, oh, ow, area, ytab=None):
    """``ytab``: optional externally built vertical tables
    ``(iy0, iy1, cy1, cy2)`` — indices LOCAL to ``planes``' rows, values
    may be traced (the spatial row-sharded path slices the global
    tables per shard and rebases them onto its halo-extended block)."""
    H, W = planes.shape[-2], planes.shape[-1]
    if ytab is None:
        iy0, iy1, ry = resize_lin_tables(H, oh, area)
        cy1, cy2 = _fixed_coeffs(ry)
    else:
        iy0, iy1, cy1, cy2 = ytab
    ix0, ix1, rx = resize_lin_tables(W, ow, area)
    cx1, cx2 = _fixed_coeffs(rx)
    a = planes.astype(jnp.int32)
    sh = (jnp.take(a, ix0, axis=-1) * cx1[None, None, :]
          + jnp.take(a, ix1, axis=-1) * cx2[None, None, :])   # scale 2^11
    x0 = jnp.take(sh, iy0, axis=-2) >> 4                      # scale 2^7
    x1 = jnp.take(sh, iy1, axis=-2) >> 4
    t = ((x0 * cy1[None, :, None]) >> 16) + ((x1 * cy2[None, :, None]) >> 16)
    return jnp.clip((t + 2) >> 2, 0, 255).astype(jnp.uint8)


def _linear_float(planes, oh, ow, area, ytab=None):
    H, W = planes.shape[-2], planes.shape[-1]
    if ytab is None:
        iy0, iy1, ry = resize_lin_tables(H, oh, area)
    else:
        iy0, iy1, ry = ytab
    ix0, ix1, rx = resize_lin_tables(W, ow, area)
    a = planes.astype(jnp.float32)
    one = jnp.float32(1)
    h = (jnp.take(a, ix0, axis=-1) * (one - rx)[None, None, :]
         + jnp.take(a, ix1, axis=-1) * rx[None, None, :]).astype(jnp.float32)
    v = (jnp.take(h, iy0, axis=-2) * (one - ry)[None, :, None]
         + jnp.take(h, iy1, axis=-2) * ry[None, :, None]).astype(jnp.float32)
    return v


def _cubic_tables(n, on, fixed):
    idx, r = resize_cubic_tables(n, on)
    if fixed:
        c = np.stack([np.round(cubic_weights(float(t)) * 2048).astype(np.int32)
                      for t in r])
    else:
        c = np.stack([cubic_weights(float(t)) for t in r]).astype(np.float32)
    return idx, c


def _cubic(planes, oh, ow, ytab=None):
    """Bicubic: u8 keeps the oracle's integer horizontal pass (scale
    2^11, |S| < 2^20 — exact in int32 AND in f32's 24-bit mantissa);
    the vertical accumulation runs in f32 because the full 2^22-scale
    integer sum can exceed int32 (budget 1 LSB vs the int64 oracle on
    razor ties; cv2's own u8 vertical is f32 too).  Other dtypes: the
    oracle's f32 path verbatim."""
    H, W = planes.shape[-2], planes.shape[-1]
    if planes.dtype == jnp.uint8:
        xi, xc = _cubic_tables(W, ow, fixed=True)
        yi, yc = ytab if ytab is not None else _cubic_tables(H, oh, fixed=True)
        a = planes.astype(jnp.int32)
        S = sum(jnp.take(a, xi[:, k], axis=-1) * xc[:, k][None, None, :]
                for k in range(4))
        Sf = S.astype(jnp.float32)
        v = sum(jnp.take(Sf, yi[:, k], axis=-2)
                * yc[:, k].astype(np.float32)[None, :, None]
                for k in range(4))
        out = jnp.round(v * jnp.float32(1.0 / (1 << 22)))
        return jnp.clip(out, 0, 255).astype(jnp.uint8)
    xi, xc = _cubic_tables(W, ow, fixed=False)
    yi, yc = ytab if ytab is not None else _cubic_tables(H, oh, fixed=False)
    a = planes.astype(jnp.float32)
    S = sum(jnp.take(a, xi[:, k], axis=-1) * xc[:, k][None, None, :]
            for k in range(4)).astype(jnp.float32)
    v = sum(jnp.take(S, yi[:, k], axis=-2) * yc[:, k][None, :, None]
            for k in range(4)).astype(jnp.float32)
    return _round_cast(v, planes.dtype)


def _lanczos_tables(n, on, fixed):
    idx, r = resize_lanczos_tables(n, on)
    if fixed:
        c = np.stack([np.round(lanczos4_weights(float(t)).astype(np.float64)
                               * 2048).astype(np.int32) for t in r])
    else:
        c = np.stack([lanczos4_weights(float(t)) for t in r]).astype(np.float32)
    return idx, c


def _lanczos(planes, oh, ow, ytab=None):
    """Lanczos-4: u8 runs the EXACT integer pipeline inside int32 by
    centering the pixels at 128 — |Σc·(v−128)| ≤ 128·Σ|c| ≤ 128·3072
    per axis, so the 2^22-scale vertical sum stays ≤ 1.2e9 — and
    restoring the mean with the PER-COLUMN/ROW tap-sum tables (the
    rounded fixed-point taps don't sum to exactly 2048 everywhere).
    Bit-exact vs the int64 oracle; on adversarial ringing beyond 2^31
    the int32 arithmetic wraps mod 2^32 exactly like cv2's own int
    vertical.  Other dtypes: the oracle's f32 path verbatim."""
    H, W = planes.shape[-2], planes.shape[-1]
    if planes.dtype == jnp.uint8:
        xi, xc = _lanczos_tables(W, ow, fixed=True)
        yi, yc = ytab if ytab is not None else _lanczos_tables(H, oh, fixed=True)
        hsum = xc.sum(axis=1).astype(np.int32)            # per output col
        vsum = yc.sum(axis=1).astype(jnp.int32)           # per output row
        a = planes.astype(jnp.int32) - 128
        S = sum(jnp.take(a, xi[:, k], axis=-1) * xc[:, k][None, None, :]
                for k in range(8))                        # S_true − 128·hsum
        S = S + (128 * (hsum - 2048))[None, None, :]      # = S_true − 128·2048
        v = sum(jnp.take(S, yi[:, k], axis=-2) * yc[:, k][None, :, None]
                for k in range(8))                        # v_true − 2^18·vsum
        v = v + ((1 << 18) * vsum + (1 << 21))[None, :, None]
        return jnp.clip(v >> 22, 0, 255).astype(jnp.uint8)
    xi, xc = _lanczos_tables(W, ow, fixed=False)
    yi, yc = ytab if ytab is not None else _lanczos_tables(H, oh, fixed=False)
    a = planes.astype(jnp.float32)
    S = sum(jnp.take(a, xi[:, k], axis=-1) * xc[:, k][None, None, :]
            for k in range(8)).astype(jnp.float32)
    v = sum(jnp.take(S, yi[:, k], axis=-2) * yc[:, k][None, :, None]
            for k in range(8)).astype(jnp.float32)
    return _round_cast(v, planes.dtype)


def _round_cast(v, dtype):
    if dtype == jnp.float32:
        return v
    minv, maxv = int_bounds(dtype)
    # half-even on the f32 accumulator (cv2's cvRound); jnp.round is
    # half-even.  The oracle rounds the same value at f64 — identical
    # for any f32 input since f32 halves are exactly representable.
    return jnp.clip(jnp.round(v), minv, maxv).astype(dtype)


def _area_weights(n: int, on: int) -> np.ndarray:
    """(on, n) float32 area-overlap weight matrix, rows scaled 1/scale."""
    scale = n / on
    w = np.zeros((on, n), np.float64)
    for d in range(on):
        lo, hi = d * scale, min((d + 1) * scale, n)
        cells = np.arange(int(np.floor(lo)), min(int(np.ceil(hi)), n))
        w[d, cells] = np.minimum(cells + 1, hi) - np.maximum(cells, lo)
    return w


def resize_planes(planes: jnp.ndarray, dsize, interpolation: str = "linear") -> jnp.ndarray:
    """``cv2.resize`` per plane on ``(N, H, W)``; ``dsize`` is (oh, ow)."""
    if planes.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    oh, ow = int(dsize[0]), int(dsize[1])
    if oh < 1 or ow < 1:
        raise ValueError(f"invalid output size {(oh, ow)}")
    H, W = planes.shape[-2], planes.shape[-1]
    if interpolation == "nearest":
        ys = np.minimum((np.arange(oh) * (H / oh)).astype(np.int64), H - 1)
        xs = np.minimum((np.arange(ow) * (W / ow)).astype(np.int64), W - 1)
        return jnp.take(jnp.take(planes, ys, axis=-2), xs, axis=-1)
    if interpolation == "linear":
        if planes.dtype == jnp.uint8:
            return _linear_u8(planes, oh, ow, area=False)
        return _round_cast(_linear_float(planes, oh, ow, area=False), planes.dtype)
    if interpolation == "cubic":
        return _cubic(planes, oh, ow)
    if interpolation == "lanczos4":
        return _lanczos(planes, oh, ow)
    if interpolation == "area":
        if H % oh == 0 and W % ow == 0 and H >= oh and W >= ow:
            f1, f2 = H // oh, W // ow
            s = planes.reshape(planes.shape[0], oh, f1, ow, f2)
            if planes.dtype == jnp.float32:
                return (s.sum((2, 4)) * jnp.float32(1.0 / (f1 * f2))).astype(jnp.float32)
            minv, maxv = int_bounds(planes.dtype)
            si = s.astype(jnp.int32).sum((2, 4))
            if (f1, f2) == (2, 2):
                out = (si + 2) >> 2
            else:
                out = jnp.round(si.astype(jnp.float32) * jnp.float32(1.0 / (f1 * f2)))
            return jnp.clip(out, minv, maxv).astype(planes.dtype)
        if H >= oh and W >= ow:
            wy = _area_weights(H, oh)                     # (oh, H)
            wx = _area_weights(W, ow).T                   # (W, ow)
            cell = np.float32(1.0 / ((H / oh) * (W / ow)))
            a = planes.astype(jnp.float32)
            # two matmuls; f32 weights match the oracle's cell
            # scale.  Precision HIGHEST: the default matmul precision
            # truncates f32 operands (bf16 passes) and costs ~2.6e-3
            # relative error — 100+ LSB at uint16 magnitudes
            v = jnp.einsum("oh,nhw,wp->nop", wy.astype(np.float32), a,
                           wx.astype(np.float32),
                           precision=jax.lax.Precision.HIGHEST) * cell
            return _round_cast(v, planes.dtype)
        if planes.dtype == jnp.uint8:
            return _linear_u8(planes, oh, ow, area=True)
        return _round_cast(_linear_float(planes, oh, ow, area=True), planes.dtype)
    raise ValueError(f"unknown interpolation {interpolation!r}")


def flip_planes(planes: jnp.ndarray, code: int = 0) -> jnp.ndarray:
    """``cv2.flip`` per plane: 0 rows, >0 cols, <0 both — exact."""
    if code == 0:
        return planes[:, ::-1, :]
    if code > 0:
        return planes[:, :, ::-1]
    return planes[:, ::-1, ::-1]


def transpose_planes(planes: jnp.ndarray) -> jnp.ndarray:
    """``cv2.transpose`` per plane — exact."""
    return jnp.swapaxes(planes, -1, -2)


def rotate_planes(planes: jnp.ndarray, code: str = "90cw") -> jnp.ndarray:
    """``cv2.rotate`` per plane (90cw | 180 | 90ccw) — exact."""
    if code == "90cw":
        return jnp.swapaxes(planes, -1, -2)[:, :, ::-1]
    if code == "180":
        return planes[:, ::-1, ::-1]
    if code == "90ccw":
        return jnp.swapaxes(planes, -1, -2)[:, ::-1, :]
    raise ValueError(f"unknown rotation {code!r} (90cw|180|90ccw)")
