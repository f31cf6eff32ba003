"""Affine warps: ``cv2.warpAffine`` parity on device (contract pinned
in ref/ops.py ``warp_affine``) — BIT-EXACT for every dtype.

Device mapping: the destination->source coordinate field is affine, so the
device never materialises an (oh, ow) coordinate constant — it rebuilds
cv2 5.0's exact f32 hybrid coordinate field (ref/ops.py
``warp_affine_coords_f32``) from two tiny per-ROW f32 tables plus a
single-rounded on-device FMA (``utils.fma.fma32``), then gathers the 4
taps with ``jnp.take`` on flattened indices.  Everything else is
elementwise math that XLA fuses around the gather.

* LINEAR u8/u16/f32 — cv2 5.0's float path: hybrid f32 coords (SIMD
  body ``fma(a, x, f32(b·y + c))``, scalar tail
  ``f32(fma(a, x, f32(b·y)) + c)`` on the last ``ow %% 16`` columns),
  then the row-column FMA lerp.  ``fma32`` reproduces the single
  rounding without hardware FMA, so the device matches cv2 bitwise.
* LINEAR i16 — cv2's legacy fixed-point coords (AB_BITS=10, 1/32
  subpixel) with FLOAT tab weights and sequential f32 accumulation.
* NEAREST — i16 rounds the AB fixed-point map; other dtypes cvRound
  the f32 hybrid coords.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from imageenhancement_mp_tpu.ref.ops import (invert_affine, warp_affine_coords_int,
                                             warp_affine_nn_coords_int, warp_tab_int)
from imageenhancement_mp_tpu.utils.fma import fma32
from imageenhancement_mp_tpu.utils.ranges import int_bounds

__all__ = ["warp_affine_planes", "warp_perspective_planes", "remap_planes",
           "undistort_planes", "warp_polar_planes"]


def _coords_f32_device(Mi, oh: int, ow: int):
    """cv2's exact f32 coordinate field, rebuilt on device from per-row
    host tables (f64 row math is exact on host; the per-column FMA is
    ``fma32``).  Returns f32 ``(oh, ow)`` arrays ``(sx, sy)``."""
    Mf = np.asarray(Mi, np.float64).astype(np.float32)
    ys = np.arange(oh, dtype=np.float32)
    xs = jnp.asarray(np.arange(ow, dtype=np.float32))[None, :]
    body = jnp.asarray(np.arange(ow) < ow - (ow % 16))[None, :]
    out = []
    for r in (0, 1):
        a, b, c = Mf[r]
        crow = jnp.asarray((b * ys + c).astype(np.float32))[:, None]
        brow = jnp.asarray((b * ys).astype(np.float32))[:, None]
        a = jnp.float32(a)
        sb = fma32(xs, a, crow)
        st = fma32(xs, a, brow) + jnp.float32(c)
        # clamp far-outside coords so the int32 casts below cannot
        # overflow (identity inside ±2e9; those pixels are all border)
        out.append(jnp.clip(jnp.where(body, sb, st), -2e9, 2e9))
    return out[0], out[1]


def _bilinear_fma_device(sample, tx, ty):
    """cv2 5.0's float bilinear: lerp rows then columns, one
    single-rounded f32 FMA per step (``_bilinear_f32_fma`` on device).
    ``sample(dy, dx)`` returns the f32 tap planes."""
    p00, p01 = sample(0, 0), sample(0, 1)
    p10, p11 = sample(1, 0), sample(1, 1)
    top = fma32(tx[None], p01 - p00, p00)
    bot = fma32(tx[None], p11 - p10, p10)
    return fma32(ty[None], bot - top, top)


def _bilinear_tab_seq_device(sample, fx, fy):
    """cv2's legacy 16S bilinear: float tab weights from the 1/32
    fraction, sequential f32 accumulation (matches
    ``_bilinear_tab_f32_seq``; all four weights are exact multiples of
    1/1024 so the products/ordering are the only roundings)."""
    one = jnp.float32(1)
    w0 = ((one - fx) * (one - fy))[None]
    w1 = (fx * (one - fy))[None]
    w2 = ((one - fx) * fy)[None]
    w3 = (fx * fy)[None]
    acc = sample(0, 0) * w0 + sample(0, 1) * w1
    acc = acc + sample(1, 0) * w2
    return acc + sample(1, 1) * w3


def _cubic_w_dev(t):
    """cv2's 4-tap bicubic weights (A=-0.75) at f32 fractions, in cv2's
    evaluation order with w3 closing the partition of unity — the device
    twin of ref/ops.py ``_cubic_w_f32``.  Every constant is f32-exact;
    XLA may FMA-contract the chains — documented ±1 tier."""
    f = jnp.float32
    A = f(-0.75)
    t1 = t + f(1)
    w0 = ((A * t1 - f(5) * A) * t1 + f(8) * A) * t1 - f(4) * A
    w1 = (((A + f(2)) * t - (A + f(3))) * t) * t + f(1)
    u = f(1) - t
    w2 = (((A + f(2)) * u - (A + f(3))) * u) * u + f(1)
    w3 = ((f(1) - w0) - w1) - w2
    return [w0, w1, w2, w3]


def _cubic_16tap_device(sample, tx, ty):
    """f32 4x4 separable accumulation in the oracle's order: rows inner
    (``row += wx[b]·tap``), columns outer (``acc += wy[a]·row``)."""
    wx = _cubic_w_dev(tx)
    wy = _cubic_w_dev(ty)
    acc = jnp.float32(0)
    for a in range(4):
        row = jnp.float32(0)
        for b in range(4):
            row = row + wx[b][None] * sample(a - 1, b - 1)
        acc = acc + wy[a][None] * row
    return acc


def _cubic_keys_w_dev(t):
    """cv2 5.0's NEW warp-kernel cubic weights (ref/ops.py
    ``_cubic_w_keys_f32``) on device: factored forms with ``fma32`` for
    the single-rounded FMA in w1."""
    f = jnp.float32
    A = f(-0.75)
    u = f(1) - t
    tt = t * t
    uu = u * u
    w0 = A * (t * uu)
    w1 = fma32(tt, fma32(t, A + f(2), -(A + f(3))), f(1))
    w3 = A * (u * tt)
    w2 = ((f(1) - w0) - w1) - w3
    return [w0, w1, w2, w3]


def _cubic_keys_16tap_device(sample, tx, ty):
    """The pinned fma row-chain accumulation of cv2 5.0's cubic warp
    kernel: ``row = fma(wx_b, v, row)`` inner, ``acc = fma(wy_a, row,
    acc)`` outer (``_warp_cubic_sample``'s order, via ``fma32``)."""
    wx = _cubic_keys_w_dev(tx)
    wy = _cubic_keys_w_dev(ty)
    acc = None
    for a in range(4):
        r = wx[0][None] * sample(a - 1, -1)
        for b in range(1, 4):
            r = fma32(wx[b][None], sample(a - 1, b - 1), r)
        acc = wy[a][None] * r if acc is None else fma32(wy[a][None], r, acc)
    return acc


def _lanczos4_tab_device(planes, X_np, Y_np, H, W, border, border_value,
                         minv, maxv, is_f32, out_dtype):
    """Shared device lanczos4 sampler for the static-M warps: baked
    int32 quantized coords (host), pinned remap tabs, u8 integer path /
    f32 factored rows (ref/ops.py ``_warp_lanczos4_sample``)."""
    from imageenhancement_mp_tpu.ref.ops import _lanczos4_remap_tabs

    w1_np, itab_np = _lanczos4_remap_tabs()
    clip32 = lambda a: np.clip(a, -2**31, 2**31 - 1).astype(np.int32)
    ix0 = jnp.asarray(clip32(X_np >> 5))
    iy0 = jnp.asarray(clip32(Y_np >> 5))
    fx = (X_np & 31).astype(np.int32)
    fy = (Y_np & 31).astype(np.int32)
    if out_dtype == jnp.uint8:
        cellw = jnp.asarray(itab_np[fy, fx])                 # (oh, ow, 8, 8)
        acc = jnp.zeros((planes.shape[0], *fx.shape), jnp.int32)
        for a in range(8):
            for b in range(8):
                v = _gather(planes, iy0 + a - 3, ix0 + b - 3, H, W, border,
                            border_value, minv, maxv).astype(jnp.int32)
                acc = acc + v * cellw[..., a, b][None]
        return jnp.clip((acc + (1 << 14)) >> 15, 0, 255).astype(out_dtype)
    wx = jnp.asarray(w1_np[fx])                              # (oh, ow, 8)
    wy = jnp.asarray(w1_np[fy])
    acc = jnp.zeros((planes.shape[0], *fx.shape), jnp.float32)
    for a in range(8):
        row = jnp.zeros((planes.shape[0], *fx.shape), jnp.float32)
        for b in range(8):
            v = _gather(planes, iy0 + a - 3, ix0 + b - 3, H, W, border,
                        border_value, minv, maxv).astype(jnp.float32)
            row = row + wx[..., b][None] * v
        acc = acc + wy[..., a][None] * row
    if is_f32:
        return acc
    return jnp.clip(jnp.round(acc), minv, maxv).astype(out_dtype)


def _gather(planes, iy, ix, H, W, border, border_value, minv, maxv):
    """4-tap-safe sample: clamp indices, mask constant-border taps."""
    cy = jnp.clip(iy, 0, H - 1)
    cx = jnp.clip(ix, 0, W - 1)
    flat = planes.reshape(planes.shape[0], H * W)
    v = jnp.take(flat, (cy * W + cx).reshape(-1), axis=1).reshape(
        planes.shape[0], *iy.shape)
    if border == "constant":
        inside = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
        fill = jnp.asarray(border_value, v.dtype)
        v = jnp.where(inside[None], v, fill)
    return v


def warp_affine_planes(planes: jnp.ndarray, M, dsize, interpolation: str = "linear",
                       border: str = "constant", border_value: float = 0.0,
                       inverse_map: bool = False) -> jnp.ndarray:
    """``cv2.warpAffine`` per plane on ``(N, H, W)``; ``dsize`` is (oh, ow).

    ``M`` is static (a 2x3 matrix as nested tuples/array) — the
    coordinate tables are baked at trace time."""
    if planes.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    oh, ow = int(dsize[0]), int(dsize[1])
    if oh < 1 or ow < 1:
        raise ValueError(f"invalid output size {(oh, ow)}")
    if border not in ("constant", "replicate"):
        raise ValueError(f"unknown border {border!r} (constant|replicate)")
    if interpolation not in ("nearest", "linear", "cubic", "lanczos4"):
        raise ValueError(f"unknown interpolation {interpolation!r} "
                         "(nearest|linear|cubic|lanczos4)")
    H, W = planes.shape[-2], planes.shape[-1]
    Mi = (np.asarray(M, np.float64).reshape(2, 3) if inverse_map
          else invert_affine(np.asarray(M, np.float64)))
    is_f32 = planes.dtype == jnp.float32
    minv, maxv = (0, 0) if is_f32 else int_bounds(planes.dtype)
    if not is_f32:
        # cv2 saturates borderValue into the dtype BEFORE blending (the
        # constant-border buffer is stored at the work type); also keeps
        # the dtype cast inside _gather from wrapping
        border_value = float(np.clip(np.round(float(border_value)), minv, maxv))

    if interpolation == "lanczos4":
        X, Y = warp_affine_coords_int(Mi, oh, ow)      # legacy AB fixpoint
        return _lanczos4_tab_device(planes, X, Y, H, W, border, border_value,
                                    minv, maxv, is_f32, planes.dtype)
    if interpolation == "cubic":
        # cv2 5.0's new cubic kernel: plain-f32 coords (baked host-side,
        # M is static), factored fma weights, fma row chains — oracle
        # tier u8/u16 BIT-EXACT, i16 razor +-1, f32 exact except
        # fully-outside pixels (<=1 ulp); same f32 path for ALL dtypes
        from imageenhancement_mp_tpu.ref.ops import warp_affine_coords_cubic_f32

        sx_np, sy_np = warp_affine_coords_cubic_f32(Mi, oh, ow)
        sx, sy = jnp.asarray(sx_np), jnp.asarray(sy_np)
        ixf, iyf = jnp.floor(sx), jnp.floor(sy)
        ix0, iy0 = ixf.astype(jnp.int32), iyf.astype(jnp.int32)
        acc = _cubic_keys_16tap_device(
            lambda dy, dx: _gather(planes, iy0 + dy, ix0 + dx, H, W, border,
                                   border_value, minv, maxv).astype(jnp.float32),
            sx - ixf, sy - iyf)
        if is_f32:
            return acc
        return jnp.clip(jnp.round(acc), minv, maxv).astype(planes.dtype)
    if planes.dtype == jnp.int16:
        if interpolation == "nearest":
            niy, nix = warp_affine_nn_coords_int(Mi, oh, ow)   # oracle's maps
            v = _gather(planes, jnp.asarray(niy.astype(np.int32)),
                        jnp.asarray(nix.astype(np.int32)), H, W,
                        border, border_value, minv, maxv)
            return v
        X, Y = warp_affine_coords_int(Mi, oh, ow)        # (oh, ow) int64 host
        T = (1 << 5) - 1
        iy0 = jnp.asarray((Y >> 5).astype(np.int32))
        ix0 = jnp.asarray((X >> 5).astype(np.int32))
        fx = jnp.asarray(((X & T) / 32.0).astype(np.float32))
        fy = jnp.asarray(((Y & T) / 32.0).astype(np.float32))
        acc = _bilinear_tab_seq_device(
            lambda dy, dx: _gather(planes, iy0 + dy, ix0 + dx, H, W, border,
                                   border_value, minv, maxv).astype(jnp.float32),
            fx, fy)
        return jnp.clip(jnp.round(acc), minv, maxv).astype(planes.dtype)

    sx, sy = _coords_f32_device(Mi, oh, ow)
    if interpolation == "nearest":
        iy = jnp.round(sy).astype(jnp.int32)
        ix = jnp.round(sx).astype(jnp.int32)
        v = _gather(planes, iy, ix, H, W, border, border_value, minv, maxv)
        return v if is_f32 else v.astype(planes.dtype)
    ixf, iyf = jnp.floor(sx), jnp.floor(sy)
    ix0, iy0 = ixf.astype(jnp.int32), iyf.astype(jnp.int32)
    tx, ty = sx - ixf, sy - iyf
    acc = _bilinear_fma_device(
        lambda dy, dx: _gather(planes, iy0 + dy, ix0 + dx, H, W, border,
                               border_value, minv, maxv).astype(jnp.float32),
        tx, ty)
    if is_f32:
        return acc
    return jnp.clip(jnp.round(acc), minv, maxv).astype(planes.dtype)


def remap_planes(planes: jnp.ndarray, map_x: jnp.ndarray, map_y: jnp.ndarray,
                 interpolation: str = "linear", border: str = "constant",
                 border_value: float = 0.0) -> jnp.ndarray:
    """``cv2.remap`` per plane on ``(N, H, W)`` with RUNTIME float32
    maps (traced inputs — unlike ``warp_affine_planes`` the coordinates
    are data, so nothing is baked at trace time).

    Same contracts as the oracle (ref/ops.py ``remap``), BIT-EXACT:
    u8/u16/f32 LINEAR use the continuous f32 subpixels with the
    single-rounded FMA lerp (``fma32``); i16 uses the legacy quantized
    coords with float tab weights; NEAREST cvRounds the map.  CUBIC
    (all dtypes) is the continuous-f32 16-tap path: oracle-tier vs cv2
    is u8 exact / u16+i16 ±1 / f32 ~1 ulp, and the device replays the
    oracle's f32 sequence (XLA may FMA-contract the weight chains —
    ±1 LSB)."""
    if planes.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    if border not in ("constant", "replicate"):
        raise ValueError(f"unknown border {border!r} (constant|replicate)")
    if interpolation not in ("nearest", "linear", "cubic", "lanczos4"):
        raise ValueError(f"unknown interpolation {interpolation!r} "
                         "(nearest|linear|cubic|lanczos4)")
    H, W = planes.shape[-2], planes.shape[-1]
    mx = jnp.clip(map_x.astype(jnp.float32), -2e9, 2e9)   # int32-cast safety
    my = jnp.clip(map_y.astype(jnp.float32), -2e9, 2e9)
    is_f32 = planes.dtype == jnp.float32
    minv, maxv = (0, 0) if is_f32 else int_bounds(planes.dtype)
    if not is_f32:
        border_value = float(np.clip(np.round(float(border_value)), minv, maxv))
    if interpolation == "nearest":
        iy = jnp.round(my).astype(jnp.int32)
        ix = jnp.round(mx).astype(jnp.int32)
        v = _gather(planes, iy, ix, H, W, border, border_value, minv, maxv)
        return v if is_f32 else v.astype(planes.dtype)
    if interpolation == "cubic":
        ixf, iyf = jnp.floor(mx), jnp.floor(my)
        ix0, iy0 = ixf.astype(jnp.int32), iyf.astype(jnp.int32)
        tx, ty = mx - ixf, my - iyf
        acc = _cubic_16tap_device(
            lambda dy, dx: _gather(planes, iy0 + dy, ix0 + dx, H, W, border,
                                   border_value, minv, maxv).astype(jnp.float32),
            tx, ty)
        if is_f32:
            return acc
        return jnp.clip(jnp.round(acc), minv, maxv).astype(planes.dtype)
    if interpolation == "lanczos4":
        # cv2's QUANTIZED lanczos path (1/32 fraction cells, pinned
        # tabs — ref/ops.py _lanczos4_remap_tabs): u8 through the 2^15
        # int tab, others through f32 factored row chains.  Budgets:
        # u8/u16/i16 +-1 on <~0.3% px, f32 ~1 ulp (docs/PARITY.md)
        from imageenhancement_mp_tpu.ref.ops import _lanczos4_remap_tabs

        w1_np, itab_np = _lanczos4_remap_tabs()
        X = jnp.round(jnp.clip(mx, -6e7, 6e7) * jnp.float32(32)).astype(jnp.int32)
        Y = jnp.round(jnp.clip(my, -6e7, 6e7) * jnp.float32(32)).astype(jnp.int32)
        ix0, iy0 = X >> 5, Y >> 5
        fx, fy = X & 31, Y & 31
        if planes.dtype == jnp.uint8:
            itab = jnp.asarray(itab_np.reshape(32 * 32, 64))
            cellw = jnp.take(itab, fy * 32 + fx, axis=0)       # (oh, ow, 64)
            acc = jnp.zeros((planes.shape[0], *fx.shape), jnp.int32)
            for a in range(8):
                for b in range(8):
                    v = _gather(planes, iy0 + a - 3, ix0 + b - 3, H, W, border,
                                border_value, minv, maxv).astype(jnp.int32)
                    acc = acc + v * cellw[..., a * 8 + b][None]
            out = (acc + (1 << 14)) >> 15
            return jnp.clip(out, 0, 255).astype(planes.dtype)
        w1 = jnp.asarray(w1_np)                                # (32, 8)
        wx = jnp.take(w1, fx, axis=0)                          # (oh, ow, 8)
        wy = jnp.take(w1, fy, axis=0)
        acc = jnp.zeros((planes.shape[0], *fx.shape), jnp.float32)
        for a in range(8):
            row = jnp.zeros((planes.shape[0], *fx.shape), jnp.float32)
            for b in range(8):
                v = _gather(planes, iy0 + a - 3, ix0 + b - 3, H, W, border,
                            border_value, minv, maxv).astype(jnp.float32)
                row = row + wx[..., b][None] * v
            acc = acc + wy[..., a][None] * row
        if is_f32:
            return acc
        return jnp.clip(jnp.round(acc), minv, maxv).astype(planes.dtype)
    if planes.dtype == jnp.int16:
        X = jnp.round(jnp.clip(mx, -6e7, 6e7) * jnp.float32(32)).astype(jnp.int32)
        Y = jnp.round(jnp.clip(my, -6e7, 6e7) * jnp.float32(32)).astype(jnp.int32)
        ix0, iy0 = X >> 5, Y >> 5
        fx = (X & 31).astype(jnp.float32) * jnp.float32(1 / 32)
        fy = (Y & 31).astype(jnp.float32) * jnp.float32(1 / 32)
        acc = _bilinear_tab_seq_device(
            lambda dy, dx: _gather(planes, iy0 + dy, ix0 + dx, H, W, border,
                                   border_value, minv, maxv).astype(jnp.float32),
            fx, fy)
        return jnp.clip(jnp.round(acc), minv, maxv).astype(planes.dtype)
    ixf, iyf = jnp.floor(mx), jnp.floor(my)
    ix0, iy0 = ixf.astype(jnp.int32), iyf.astype(jnp.int32)
    tx, ty = mx - ixf, my - iyf
    acc = _bilinear_fma_device(
        lambda dy, dx: _gather(planes, iy0 + dy, ix0 + dx, H, W, border,
                               border_value, minv, maxv).astype(jnp.float32),
        tx, ty)
    if is_f32:
        return acc
    return jnp.clip(jnp.round(acc), minv, maxv).astype(planes.dtype)


def undistort_planes(planes: jnp.ndarray, K, dist, new_K=None) -> jnp.ndarray:
    """``cv2.undistort`` per plane on ``(N, H, W)`` — contract in
    ref/ops.py ``undistort``: cv2's quantized-map path (f64 distortion
    maps rounded to 1/32 subpixels).  K/dist are static, so the
    quantized integer coordinate fields are baked host-side.
    BIT-EXACT for every dtype: u8 through the 32x32 INT tab at 2^15,
    u16/i16/f32 through the float tab with sequential f32
    accumulation."""
    from imageenhancement_mp_tpu.ref.ops import _undistort_maps64

    if planes.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    H, W = planes.shape[-2], planes.shape[-1]
    mx, my = _undistort_maps64(K, dist, (H, W), new_K)
    X = np.round(mx * 32).astype(np.int64)
    Y = np.round(my * 32).astype(np.int64)
    ix0 = jnp.asarray((X >> 5).astype(np.int32))
    iy0 = jnp.asarray((Y >> 5).astype(np.int32))
    is_f32 = planes.dtype == jnp.float32
    minv, maxv = (0, 0) if is_f32 else int_bounds(planes.dtype)
    if planes.dtype != jnp.uint8:
        fx = jnp.asarray(((X & 31) / 32.0).astype(np.float32))
        fy = jnp.asarray(((Y & 31) / 32.0).astype(np.float32))
        acc = _bilinear_tab_seq_device(
            lambda dy, dx: _gather(planes, iy0 + dy, ix0 + dx, H, W,
                                   "constant", 0.0, minv, maxv).astype(jnp.float32),
            fx, fy)
        if is_f32:
            return acc
        return jnp.clip(jnp.round(acc), minv, maxv).astype(planes.dtype)
    tab = warp_tab_int()[Y & 31, X & 31].astype(np.int32)   # (H, W, 2, 2)
    acc = None
    for dy in range(2):
        for dx in range(2):
            v = _gather(planes, iy0 + dy, ix0 + dx, H, W,
                        "constant", 0.0, minv, maxv).astype(jnp.int32)
            term = v * jnp.asarray(tab[:, :, dy, dx])[None]
            acc = term if acc is None else acc + term
    out = (acc + (1 << 14)) >> 15
    return jnp.clip(out, minv, maxv).astype(planes.dtype)


def warp_perspective_planes(planes: jnp.ndarray, M, dsize,
                            interpolation: str = "linear",
                            border: str = "constant",
                            border_value: float = 0.0,
                            inverse_map: bool = False) -> jnp.ndarray:
    """``cv2.warpPerspective`` per plane on ``(N, H, W)`` — BIT-EXACT
    for every dtype (ref/ops.py ``warp_perspective`` holds the pinned
    contract).

    ``M`` is static, and the perspective division happens at trace time
    on the host (f64-emulated f32, exactly cv2's arithmetic) — the
    pinned-exact f32 coordinate maps are baked into the program like
    ``undistort``'s quantized fields, so the device never runs a
    division whose rounding XLA might approximate."""
    from imageenhancement_mp_tpu.ref.ops import (invert_perspective,
                                                 warp_perspective_coords_f32,
                                                 warp_perspective_coords_int,
                                                 warp_perspective_nn_coords_int)

    if planes.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    oh, ow = int(dsize[0]), int(dsize[1])
    if oh < 1 or ow < 1:
        raise ValueError(f"invalid output size {(oh, ow)}")
    if border not in ("constant", "replicate"):
        raise ValueError(f"unknown border {border!r} (constant|replicate)")
    if interpolation not in ("nearest", "linear", "cubic", "lanczos4"):
        raise ValueError(f"unknown interpolation {interpolation!r} "
                         "(nearest|linear|cubic|lanczos4)")
    H, W = planes.shape[-2], planes.shape[-1]
    Mi = (np.asarray(M, np.float64).reshape(3, 3) if inverse_map
          else invert_perspective(M))
    is_f32 = planes.dtype == jnp.float32
    minv, maxv = (0, 0) if is_f32 else int_bounds(planes.dtype)
    if not is_f32:
        border_value = float(np.clip(np.round(float(border_value)), minv, maxv))

    clip32 = lambda a: np.clip(a, -2**31, 2**31 - 1).astype(np.int32)
    if interpolation == "lanczos4":
        from imageenhancement_mp_tpu.ref.ops import warp_perspective_coords_int

        X, Y = warp_perspective_coords_int(Mi, oh, ow)
        return _lanczos4_tab_device(planes, X, Y, H, W, border, border_value,
                                    minv, maxv, is_f32, planes.dtype)
    if interpolation == "cubic":
        # same f32 cubic kernel for every dtype; perspective coords use
        # cv2's fma-num / f32-div law (the SIMD reciprocal division is
        # hardware-dependent): u8 +-1 ~0.01%, u16/i16 +-1 ~1.5%,
        # f32 <=6e-3 at 655-scale vs cv2
        from imageenhancement_mp_tpu.ref.ops import warp_perspective_coords_cubic_f32

        sx_np, sy_np = warp_perspective_coords_cubic_f32(Mi, oh, ow)
        sx, sy = jnp.asarray(sx_np), jnp.asarray(sy_np)
        ixf, iyf = jnp.floor(sx), jnp.floor(sy)
        ix0, iy0 = ixf.astype(jnp.int32), iyf.astype(jnp.int32)
        acc = _cubic_keys_16tap_device(
            lambda dy, dx: _gather(planes, iy0 + dy, ix0 + dx, H, W, border,
                                   border_value, minv, maxv).astype(jnp.float32),
            sx - ixf, sy - iyf)
        if is_f32:
            return acc
        return jnp.clip(jnp.round(acc), minv, maxv).astype(planes.dtype)
    if planes.dtype == jnp.int16:
        if interpolation == "nearest":
            niy, nix = warp_perspective_nn_coords_int(Mi, oh, ow)
            return _gather(planes, jnp.asarray(clip32(niy)),
                           jnp.asarray(clip32(nix)), H, W,
                           border, border_value, minv, maxv)
        X, Y = warp_perspective_coords_int(Mi, oh, ow)
        iy0 = jnp.asarray(clip32(Y >> 5))
        ix0 = jnp.asarray(clip32(X >> 5))
        fx = jnp.asarray(((X & 31) / 32.0).astype(np.float32))
        fy = jnp.asarray(((Y & 31) / 32.0).astype(np.float32))
        acc = _bilinear_tab_seq_device(
            lambda dy, dx: _gather(planes, iy0 + dy, ix0 + dx, H, W, border,
                                   border_value, minv, maxv).astype(jnp.float32),
            fx, fy)
        return jnp.clip(jnp.round(acc), minv, maxv).astype(planes.dtype)
    sx_np, sy_np = warp_perspective_coords_f32(Mi, oh, ow)
    sx_np = np.clip(sx_np, -2e9, 2e9)
    sy_np = np.clip(sy_np, -2e9, 2e9)
    sx = jnp.asarray(sx_np)
    sy = jnp.asarray(sy_np)
    if interpolation == "nearest":
        iy = jnp.round(sy).astype(jnp.int32)
        ix = jnp.round(sx).astype(jnp.int32)
        v = _gather(planes, iy, ix, H, W, border, border_value, minv, maxv)
        return v if is_f32 else v.astype(planes.dtype)
    ixf, iyf = jnp.floor(sx), jnp.floor(sy)
    ix0, iy0 = ixf.astype(jnp.int32), iyf.astype(jnp.int32)
    tx, ty = sx - ixf, sy - iyf
    acc = _bilinear_fma_device(
        lambda dy, dx: _gather(planes, iy0 + dy, ix0 + dx, H, W, border,
                               border_value, minv, maxv).astype(jnp.float32),
        tx, ty)
    if is_f32:
        return acc
    return jnp.clip(jnp.round(acc), minv, maxv).astype(planes.dtype)


def warp_polar_planes(planes: jnp.ndarray, dsize, center, max_radius: float,
                      log: bool = False, inverse: bool = False,
                      interpolation: str = "linear") -> jnp.ndarray:
    """``cv2.warpPolar`` (+ ``WARP_FILL_OUTLIERS``) on ``(N, H, W)``
    planes with STATIC geometry: the coordinate maps are cv2's exact
    host reproduction (ref/ops.py ``_warp_polar_maps``), baked at trace
    time and applied by the bit-exact ``remap_planes`` body.

    Semantics identical to the previous ``api.warp_polar`` wiring
    (host maps + device remap, border constant 0; inverse wrap-pads
    one angle row each side) — bitwise-covered by tests/test_warp_polar.
    Reference semantics: SURVEY.md §2 warp family (cv2.warpPolar).
    """
    from imageenhancement_mp_tpu.ref.ops import _warp_polar_maps

    H, W = planes.shape[-2], planes.shape[-1]
    mx, my = _warp_polar_maps((H, W), dsize, center, float(max_radius),
                              bool(log), bool(inverse))
    src = planes
    if inverse:
        # cv2's one-row angular BORDER_WRAP pad (the maps already
        # target the padded grid)
        src = jnp.concatenate(
            [planes[:, H - 1:H], planes, planes[:, 0:1]], axis=1)
    return remap_planes(src, jnp.asarray(mx), jnp.asarray(my),
                        interpolation, "constant", 0.0)
