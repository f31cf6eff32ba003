"""Point operations: LUT application, gamma/log transforms, contrast stretch.

Reference equivalents: ``cv2.LUT``, power-law/log transforms, and
``cv2.normalize(NORM_MINMAX)`` (SURVEY.md §2 #1-3).  Gamma/log LUTs are
static 256-entry tables built host-side in float64 (exact, compile-time
constants); contrast stretch builds its LUT on device from the per-plane
min/max with f32 scale/shift math mirroring cv2's normalize path.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from imageenhancement_mp_tpu.utils.fma import fma32 as _fma32
from imageenhancement_mp_tpu.utils.fma import two_prod as _two_prod
from imageenhancement_mp_tpu.utils.fma import two_sum as _two_sum


__all__ = [
    "add_weighted_arrays",
    "apply_lut_planes",
    "convert_scale_abs_planes",
    "gamma_lut_host",
    "log_lut_host",
    "gamma_planes",
    "log_planes",
    "contrast_stretch_planes",
    "stretch_luts_from_minmax",
]


def apply_lut_planes(planes: jnp.ndarray, lut: jnp.ndarray) -> jnp.ndarray:
    """``cv2.LUT`` ≡ gather (SURVEY.md §8.6).

    ``lut``: [S] shared or [B, S] per plane; S = 256 (u8 planes) or 65536
    (u16).  Output dtype = table dtype."""
    idx = planes.astype(jnp.int32)
    if lut.ndim == 1:
        return lut[idx]
    return jax.vmap(lambda l, p: l[p])(lut, idx)


def gamma_lut_host(gamma: float) -> np.ndarray:
    """Static power-law LUT ``s = 255·(r/255)^γ`` in f64 (exact; SURVEY.md §2 #1)."""
    r = np.arange(256, dtype=np.float64) / 255.0
    return np.clip(np.round(255.0 * np.power(r, gamma)), 0, 255).astype(np.uint8)


def log_lut_host() -> np.ndarray:
    """Static log LUT ``s = c·log(1+r)``, ``c = 255/log 256`` (SURVEY.md §2 #2)."""
    c = 255.0 / np.log(256.0)
    return np.clip(np.round(c * np.log1p(np.arange(256, dtype=np.float64))), 0, 255).astype(
        np.uint8
    )


def gamma_planes(planes: jnp.ndarray, gamma: float) -> jnp.ndarray:
    """uint8/uint16: LUT path (exact).  float32: direct ``255·(r/255)^γ``."""
    if planes.dtype == jnp.int16:
        raise TypeError("gamma is defined for uint8/uint16/float32 (not int16)")
    if planes.dtype == jnp.float32:
        r = jnp.maximum(planes, 0.0) * (1.0 / 255.0)
        return (255.0 * jnp.power(r, jnp.float32(gamma))).astype(jnp.float32)
    if planes.dtype == jnp.uint16:
        from imageenhancement_mp_tpu.ref.ops import gamma_lut16

        return apply_lut_planes(planes, jnp.asarray(gamma_lut16(gamma)))
    return apply_lut_planes(planes, jnp.asarray(gamma_lut_host(gamma)))


def log_planes(planes: jnp.ndarray) -> jnp.ndarray:
    """uint8/uint16: LUT path (exact).  float32: direct ``c·log(1+r)``."""
    if planes.dtype == jnp.int16:
        raise TypeError("log_transform is defined for uint8/uint16/float32 (not int16)")
    if planes.dtype == jnp.float32:
        c = jnp.float32(255.0 / np.log(256.0))
        return c * jnp.log1p(jnp.maximum(planes, 0.0))
    if planes.dtype == jnp.uint16:
        from imageenhancement_mp_tpu.ref.ops import log_lut16

        return apply_lut_planes(planes, jnp.asarray(log_lut16()))
    return apply_lut_planes(planes, jnp.asarray(log_lut_host()))


def convert_scale_abs_planes(
    planes: jnp.ndarray, alpha: float = 1.0, beta: float = 0.0
) -> jnp.ndarray:
    """``cv2.convertScaleAbs`` per plane — ``saturate_u8(round(|α·x+β|))``.

    cv2 ALWAYS returns 8-bit regardless of input depth (verified probe).
    Integer inputs use exact static LUTs built with cv2's single-rounded
    f32 FMA semantics; float32 reproduces the same single-rounded FMA on
    device via the exact-error-term emulation (utils/fma.py).
    """
    if planes.dtype == jnp.float32:
        out = jnp.abs(jnp.round(_fma32(planes, jnp.float32(alpha), jnp.float32(beta))))
        return jnp.clip(out, 0, 255).astype(jnp.int32).astype(jnp.uint8)
    from imageenhancement_mp_tpu.ref.ops import convert_scale_abs_lut

    if planes.dtype == jnp.int16:
        lut = jnp.asarray(convert_scale_abs_lut(alpha, beta, 65536, offset=-32768))
        return lut[planes.astype(jnp.int32) + 32768]
    n = 65536 if planes.dtype == jnp.uint16 else 256
    return apply_lut_planes(planes, jnp.asarray(convert_scale_abs_lut(alpha, beta, n)))


def add_weighted_arrays(
    src1: jnp.ndarray,
    alpha: float,
    src2: jnp.ndarray,
    beta: float,
    gamma: float = 0.0,
) -> jnp.ndarray:
    """``cv2.addWeighted(src1, α, src2, β, γ)`` — exact, all dtypes.

    Elementwise over any matching shapes.  Pinned arithmetic
    (ref/ops.py:add_weighted — 0 mismatches in 1300 fuzz configs): two
    single-rounded f32 FMAs, ``f32(src1·f32(α) + f32(src2·f32(β) + f32(γ)))``,
    then cvRound + saturate for integer dtypes (float32 returns the f32
    accumulator unrounded).  Reproduced on device with the exact
    utils/fma.py emulation.
    """
    if src2.dtype != src1.dtype:
        raise TypeError(f"src dtypes differ: {src1.dtype} vs {src2.dtype}")
    if src2.shape != src1.shape:
        raise ValueError(f"src shapes differ: {src1.shape} vs {src2.shape}")
    if src1.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {src1.dtype}")
    al, be, ga = jnp.float32(alpha), jnp.float32(beta), jnp.float32(gamma)
    a32 = src1.astype(jnp.float32)
    b32 = src2.astype(jnp.float32)
    acc = _fma32(a32, al, _fma32(b32, be, jnp.broadcast_to(ga, b32.shape)))
    if src1.dtype == jnp.float32:
        return acc
    from imageenhancement_mp_tpu.utils.ranges import int_bounds

    minv, maxv = int_bounds(src1.dtype)
    return jnp.clip(jnp.round(acc), minv, maxv).astype(src1.dtype)


def _stretch_scale_tables(a: float, b: float, dmax: int):
    """Host-built double-float tables of cv2's f64 ``scale = (β−α)·(1/d)``
    for every possible integer range ``d = max − min ≤ dmax`` (the key
    insight: d has ≤ dmax values, so the f64 arithmetic JAX can't do on
    device is a static table lookup).  Returns (hi, lo) f32 pairs with
    hi = f32(scale64), lo = f32(scale64 − hi)."""
    d = np.arange(dmax + 1, dtype=np.float64)
    d[0] = 1.0  # constant plane: handled by the d==0 select
    scale64 = (b - a) * (1.0 / d)  # cv2's reciprocal-multiply convention
    sh = scale64.astype(np.float32)
    sl = (scale64 - sh.astype(np.float64)).astype(np.float32)
    return sh, sl


def contrast_stretch_planes(
    planes: jnp.ndarray, out_range: tuple[float, float] = (0.0, 255.0)
) -> jnp.ndarray:
    """``cv2.normalize(MINMAX, α, β)`` per plane (SURVEY.md §8.5) — exact
    for uint8/uint16 across arbitrary float ranges.

    cv2 computes ``scale/shift`` in f64 and applies a single-rounded f32
    FMA per element; JAX has no f64, so the f64 parts are reproduced with
    a static per-``d`` double-float scale table plus double-float shift
    arithmetic, and the per-entry FMA with an exact-error-term emulation.
    Constant plane → α.  float32: no rounding (cv2 float path).
    """
    # cv2 sorts the output range: src-min maps to min(α,β) (verified probe)
    a, b = sorted((float(out_range[0]), float(out_range[1])))
    if planes.dtype == jnp.float32:

        def onef(p: jnp.ndarray) -> jnp.ndarray:
            lo = p.min()
            hi = p.max()
            out = (p - lo) * ((b - a) / jnp.maximum(hi - lo, jnp.float32(1e-45))) + a
            return jnp.where(hi == lo, jnp.float32(a), out).astype(jnp.float32)

        return jax.vmap(onef)(planes)

    if planes.dtype == jnp.int16:
        minv, maxv = -32768, 32767
    else:
        minv, maxv = 0, (65535 if planes.dtype == jnp.uint16 else 255)
    lo = jnp.min(planes, axis=(-2, -1)).astype(jnp.int32)
    hi = jnp.max(planes, axis=(-2, -1)).astype(jnp.int32)
    luts = stretch_luts_from_minmax(lo, hi, a, b, maxv, planes.dtype, minv)
    if planes.dtype == jnp.uint8:
        return apply_lut_planes(planes, luts)
    return jax.vmap(lambda l, p: l[p.astype(jnp.int32) - minv])(luts, planes)


def stretch_luts_from_minmax(
    lo: jnp.ndarray, hi: jnp.ndarray, a: float, b: float, maxv: int, dtype,
    minv: int = 0,
) -> jnp.ndarray:
    """cv2-exact normalize(MINMAX) LUTs from per-plane min/max vectors.

    ``lo``/``hi``: ``[B] int32`` (actual plane values — may be negative for
    int16, whose value domain starts at ``minv = −32768``).  Returns
    ``[B, maxv−minv+1]`` LUTs in ``dtype``, indexed by ``value − minv``.
    Split out of :func:`contrast_stretch_planes` so the spatially-sharded
    path (parallel/spatial.py) can pool min/max across shards with
    ``pmin``/``pmax`` and reuse the exactness-critical double-float math.
    ``a``/``b`` must already be sorted (``a ≤ b``).
    """
    sh_np, sl_np = _stretch_scale_tables(a, b, maxv - minv)
    sh_tab = jnp.asarray(sh_np)
    sl_tab = jnp.asarray(sl_np)
    # α as a static double-float pair
    ah = np.float32(a)
    al = np.float32(a - float(ah))
    fill = jnp.int32(round(max(min(a, float(maxv)), float(minv))))

    def one(lo_i: jnp.ndarray, hi_i: jnp.ndarray) -> jnp.ndarray:
        d = hi_i - lo_i
        scale = sh_tab[d]  # f32(scale64), cv2's per-element scale
        # shift64 = α − lo·scale64, reproduced in double-float
        lof = lo_i.astype(jnp.float32)  # exact (|integer| ≤ 65535)
        p1, e1 = _two_prod(lof, scale)
        s1, se1 = _two_sum(jnp.float32(ah), -p1)
        shift = s1 + ((jnp.float32(al) - e1 - lof * sl_tab[d]) + se1)
        i = jnp.arange(minv, maxv + 1, dtype=jnp.float32)
        lut = jnp.clip(jnp.round(_fma32(i, scale, shift)), minv, maxv).astype(
            jnp.int32
        )
        return jnp.where(d == 0, fill, lut).astype(dtype)

    return jax.vmap(one)(lo, hi)


def integral_planes(planes: jnp.ndarray, sq: bool = False):
    """``cv2.integral``/``integral2`` per plane: (N, H+1, W+1)
    zero-padded cumulative sums.  u8 → exact int32 (fits for any
    practical frame); u16/i16/f32 → f32 sums (the oracle's f64 at
    ~1e-7 relative; docs/PARITY.md)."""
    if planes.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    acc = jnp.int32 if planes.dtype == jnp.uint8 else jnp.float32
    s = jnp.cumsum(jnp.cumsum(planes.astype(acc), axis=-2), axis=-1)
    s = jnp.pad(s, ((0, 0), (1, 0), (1, 0)))
    if not sq:
        return s
    p = planes.astype(jnp.float32)
    s2 = jnp.cumsum(jnp.cumsum(p * p, axis=-2), axis=-1)
    s2 = jnp.pad(s2, ((0, 0), (1, 0), (1, 0)))
    return s, s2


def apply_color_map_planes(planes: jnp.ndarray, colormap: str = "jet") -> jnp.ndarray:
    """``cv2.applyColorMap`` per plane: (N, H, W) u8 → (N, H, W, 3) RGB
    via the extracted 256-entry table (bitwise)."""
    if planes.dtype != jnp.uint8:
        raise TypeError("applyColorMap requires uint8 input")
    from imageenhancement_mp_tpu.ref.colormaps import colormap_table

    tab = jnp.asarray(colormap_table(colormap))
    return jnp.take(tab, planes.astype(jnp.int32), axis=0)


def calc_back_project_planes(planes: jnp.ndarray, hist, scale: float = 1.0) -> jnp.ndarray:
    """``cv2.calcBackProject`` per plane (u8, [0,256) range) — exact
    LUT gather: bin = v·bins/256, out = saturate(round(hist[bin]·scale)).
    The table is built host-side in f64 so device rounding matches."""
    if planes.dtype != jnp.uint8:
        raise TypeError("calcBackProject requires uint8 input")
    h = np.asarray(hist, np.float64).ravel()
    bins = len(h)
    # fold bin mapping + scale + rounding into one 256-entry u8 LUT
    idx = (np.arange(256, dtype=np.int64) * bins) // 256
    lut = np.clip(np.round(h[idx] * float(scale)), 0, 255).astype(np.uint8)
    return jnp.take(jnp.asarray(lut), planes.astype(jnp.int32), axis=0)
