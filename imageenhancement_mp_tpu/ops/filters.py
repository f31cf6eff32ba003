"""Spatial filters: Gaussian blur, Laplacian sharpen, unsharp mask.

Reference equivalents: ``cv2.GaussianBlur``, ``cv2.Laplacian(ksize=1)``,
``cv2.addWeighted`` (SURVEY.md §2 #6-8).  Design: separable
convolutions expressed as shifted adds in f32 — all intermediate values are
integers < 2^24, so f32 arithmetic is *bit-exact* (SURVEY.md §8.2):

* auto-σ taps are cv2's hardcoded binomials ·256 (integers);
* the separable accumulation stays integral (max 255·65536 + 2^15 < 2^24);
* the uint8 output is ``(acc + 2^15) >> 16`` = ``floor((acc + 2^15)/2^16)``,
  exact in f32 since the scale is a power of two.

Shifted adds (jnp.pad + slicing) fuse into a handful of elementwise ops under
XLA and avoid the conv→im2col path entirely.
"""

from __future__ import annotations

import jax.numpy as jnp

from imageenhancement_mp_tpu.ref.ops import (
    gaussian_axes,
    gaussian_kernel,
    gaussian_kernel_fixed,
    gaussian_taps_u16,
)

__all__ = [
    "box_blur_planes",
    "gaussian_blur_planes",
    "sobel_planes",
    "laplacian_planes",
    "laplacian_sharpen_planes",
    "unsharp_mask_planes",
]


def _sep_conv_f32(
    x: jnp.ndarray, taps_v: tuple[float, ...], taps_h: tuple[float, ...] | None = None
) -> jnp.ndarray:
    """Separable [B,H,W] conv with REFLECT_101 border, f32 accumulation."""
    if taps_h is None:
        taps_h = taps_v
    kh, kw = len(taps_v), len(taps_h)
    ph, pw = kh // 2, kw // 2
    H, W = x.shape[-2], x.shape[-1]
    p = jnp.pad(x, ((0, 0), (ph, ph), (pw, pw)), mode="reflect").astype(jnp.float32)
    v = sum(taps_v[j] * p[:, j : j + H, :] for j in range(kh))
    return sum(taps_h[j] * v[:, :, j : j + W] for j in range(kw))


def gaussian_blur_planes(
    planes: jnp.ndarray,
    ksize=5,
    sigma: float = 0.0,
    sigma_y: float = 0.0,
) -> jnp.ndarray:
    """``cv2.GaussianBlur`` on uint8/uint16/float32 planes.

    ``ksize``: int (square) or (rows, cols) — cv2's full surface incl.
    rectangular kernels, ``sigma_y`` (≤0 follows ``sigma``), and 0-sized
    dims derived from σ (ref/ops.py ``gaussian_axes``).
    uint8/uint16: bit-exact for ANY σ — cv2's fixed-point taps (Q8 for u8,
    Q16 for u16; cumulative-quantized, ref/ops.py ``_cdf_fixed_taps``) with
    exact integer accumulation and one final rounding shift.
    int16 (CV_16S): cv2 uses its FLOAT filter path here; the f32 separable
    conv below is within ±1 LSB of cv2 (ref/ops.py ``gaussian_blur``
    docstring; docs/PARITY.md).
    float32: f32 separable conv (cv2's float path; no rounding).
    """
    kh, kw, sy, sx = gaussian_axes(sigma=sigma, sigma_y=sigma_y, ksize=ksize,
                                   depth_u8=planes.dtype == jnp.uint8)
    if kh == 1 and kw == 1:
        return planes  # cv2: k=1 is the identity for any sigma (probe)
    if planes.dtype == jnp.float32:
        tv = tuple(float(t) for t in gaussian_kernel(kh, sy))
        th = tuple(float(t) for t in gaussian_kernel(kw, sx))
        return _sep_conv_f32(planes.astype(jnp.float32), tv, th).astype(jnp.float32)
    if planes.dtype == jnp.int16:
        import numpy as np

        tv = tuple(float(np.float32(t)) for t in gaussian_kernel(kh, sy))
        th = tuple(float(np.float32(t)) for t in gaussian_kernel(kw, sx))
        acc = _sep_conv_f32(planes, tv, th)
        return jnp.clip(jnp.round(acc), -32768, 32767).astype(jnp.int16)
    if planes.dtype == jnp.uint16:
        if sx <= 0 and sy <= 0 and kh <= 9 and kw <= 9:
            # dyadic /256 taps: the cheaper Q8 split-accumulation suffices
            return _gauss_u16_fixed(planes, kh, kw)
        return _gauss_u16_q16(planes, kh, kw, sy, sx)
    tv = tuple(int(t) for t in gaussian_kernel_fixed(kh, sy))
    th = tuple(int(t) for t in gaussian_kernel_fixed(kw, sx))
    acc = _sep_conv_f32(planes, tv, th)
    out = jnp.floor((acc + 32768.0) * (1.0 / 65536.0))
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def _gauss_u16_fixed(planes: jnp.ndarray, kh: int, kw: int | None = None) -> jnp.ndarray:
    """uint16 σ=0 fixed point, bit-exact without 64-bit math.

    The horizontal accumulation Σtaps·v reaches 2^32 (v ≤ 2^24, Σtaps=256),
    overflowing int32, so v is split v = v_hi·2^12 + v_lo and the exact
    rounded shift is reassembled as
    ``((A + ((B + 2^15) >> 12)) >> 4`` with A = Σtaps·v_hi, B = Σtaps·v_lo
    (both < 2^21; the low remainder cannot carry across the final >> 4).
    """
    if kw is None:
        kw = kh
    tv = tuple(int(t) for t in gaussian_kernel_fixed(kh))
    tw = tuple(int(t) for t in gaussian_kernel_fixed(kw))
    ph, pw = kh // 2, kw // 2
    H, W = planes.shape[-2], planes.shape[-1]
    p = jnp.pad(planes, ((0, 0), (ph, ph), (pw, pw)), mode="reflect").astype(
        jnp.int32
    )
    v = sum(tv[j] * p[:, j : j + H, :] for j in range(kh))  # <= 2^24
    v_hi = v >> 12
    v_lo = v & 4095
    A = sum(tw[j] * v_hi[:, :, j : j + W] for j in range(kw))
    B = sum(tw[j] * v_lo[:, :, j : j + W] for j in range(kw))
    out = (A + ((B + 32768) >> 12)) >> 4
    return jnp.clip(out, 0, 65535).astype(jnp.uint16)


def _gauss_u16_q16(
    planes: jnp.ndarray, kh: int, kw: int, sigma_y: float, sigma_x: float
) -> jnp.ndarray:
    """uint16 Gaussian with cv2's Q16 taps — bit-exact without 64-bit math.

    The exact accumulator reaches 2^48 (Σtaps = 2^16, pixels ≤ 2^16,
    two separable passes), so the value is carried as four int32 partial
    sums at known power-of-two scales and the final ``(h + 2^31) >> 32``
    is reassembled with uint32 carry propagation:

      vertical:  x = xh·2^8 + xl       → Vh = Σt·xh, Vl = Σt·xl  (< 2^24)
      horizontal: V• = a•·2^12 + b•    → S1..S4 = Σt·a/b          (< 2^28)
      h = S1·2^20 + S2·2^8 + S3·2^12 + S4  (recombined in two u32 words)
    """
    tv = tuple(int(t) for t in gaussian_taps_u16(kh, sigma_y))
    tw = tuple(int(t) for t in gaussian_taps_u16(kw, sigma_x))
    ph, pw = kh // 2, kw // 2
    H, W = planes.shape[-2], planes.shape[-1]
    p = jnp.pad(planes, ((0, 0), (ph, ph), (pw, pw)), mode="reflect").astype(
        jnp.int32
    )
    xh = p >> 8
    xl = p & 255
    Vh = sum(tv[j] * xh[:, j : j + H, :] for j in range(kh))
    Vl = sum(tv[j] * xl[:, j : j + H, :] for j in range(kh))
    ah, bh = Vh >> 12, Vh & 4095
    al, bl = Vl >> 12, Vl & 4095
    S1 = sum(tw[j] * ah[:, :, j : j + W] for j in range(kw)).astype(jnp.uint32)
    S2 = sum(tw[j] * bh[:, :, j : j + W] for j in range(kw)).astype(jnp.uint32)
    S3 = sum(tw[j] * al[:, :, j : j + W] for j in range(kw)).astype(jnp.uint32)
    S4 = sum(tw[j] * bl[:, :, j : j + W] for j in range(kw)).astype(jnp.uint32)
    t1, h1 = S1 << 20, S1 >> 12
    t2, h2 = S2 << 8, S2 >> 24
    t3, h3 = S3 << 12, S3 >> 20
    lo = t1 + t2
    c1 = (lo < t1).astype(jnp.uint32)
    lo2 = lo + t3
    c2 = (lo2 < t3).astype(jnp.uint32)
    lo3 = lo2 + S4
    c3 = (lo3 < S4).astype(jnp.uint32)
    hi = h1 + h2 + h3 + c1 + c2 + c3
    out = hi + (lo3 >= jnp.uint32(1 << 31)).astype(jnp.uint32)
    return jnp.clip(out, 0, 65535).astype(jnp.uint16)


def laplacian_planes(planes: jnp.ndarray, ksize: int = 1, delta: float = 0.0) -> jnp.ndarray:
    """``cv2.Laplacian`` — exact.  ``ksize=1``: the 4-neighbor stencil;
    ``ksize≥3``: Sobel-based ``d²x + d²y`` with raw integer sums and ONE
    final saturation (per-term saturation diverges at k=7 — pinned).
    uint8 → int16; uint16/int16 → int32; float32 → float32."""
    import numpy as np

    if ksize != 1:
        from imageenhancement_mp_tpu.ref.ops import deriv_kernels

        kx2, ky2 = deriv_kernels(2, 0, ksize)
        H, W = planes.shape[-2], planes.shape[-1]

        if planes.dtype == jnp.float32:
            def rawf(kx, ky):
                ph, pw = len(ky) // 2, len(kx) // 2
                pd = jnp.pad(planes, ((0, 0), (ph, ph), (pw, pw)), mode="reflect")
                v = sum(jnp.float32(float(t)) * pd[:, i : i + H, :]
                        for i, t in enumerate(ky) if float(t) != 0.0)
                return sum(jnp.float32(float(t)) * v[:, :, i : i + W]
                           for i, t in enumerate(kx) if float(t) != 0.0)

            acc = rawf(kx2, ky2) + rawf(ky2, kx2)
            return (acc + jnp.float32(delta)).astype(jnp.float32)
        maxval = _max_abs_val(planes.dtype)
        B = 2 * int(np.abs(ky2).sum()) * int(np.abs(kx2).sum()) * maxval
        if B >= 2**31:
            raise ValueError(
                f"laplacian ksize {ksize} exceeds the exact int32 range "
                f"for {planes.dtype}; convert to float32"
            )
        x = planes.astype(jnp.int32)
        acc = _raw_sep_conv_int(x, kx2, ky2, H, W) + _raw_sep_conv_int(x, ky2, kx2, H, W)
        out = _combine_delta_int32(acc, B, int(np.round(float(delta))))
        if planes.dtype == jnp.uint8:
            return jnp.clip(out, -32768, 32767).astype(jnp.int16)
        return out.astype(jnp.int32)
    if delta:
        raise ValueError("delta is only supported for ksize >= 3 (cv2 parity scope)")
    acc = jnp.float32 if planes.dtype == jnp.float32 else jnp.int32
    p = jnp.pad(planes, ((0, 0), (1, 1), (1, 1)), mode="reflect").astype(acc)
    lap = (
        p[:, :-2, 1:-1]
        + p[:, 2:, 1:-1]
        + p[:, 1:-1, :-2]
        + p[:, 1:-1, 2:]
        - 4 * p[:, 1:-1, 1:-1]
    )
    if planes.dtype == jnp.float32:
        return lap
    return lap.astype(jnp.int16 if planes.dtype == jnp.uint8 else jnp.int32)


def _int_bounds(dtype) -> tuple[int, int]:
    from imageenhancement_mp_tpu.utils.ranges import int_bounds

    return int_bounds(dtype)


def box_blur_planes(planes: jnp.ndarray, ksize=3) -> jnp.ndarray:
    """``cv2.blur`` (normalized box filter) per plane — REFLECT_101 border.

    ``ksize``: int or (rows, cols), odd dims ≥ 1.  Integer dtypes are
    bit-exact to cv2's SIMD model: exact int32 separable window sums, then
    ``cvRound(f32(f32(S)·f32(1/area)))`` (cv2's scalar row tail uses a
    double scale instead — ref/ops.py ``box_blur`` docstring,
    docs/PARITY.md).  float32: f32 separable sums vs the oracle's f64
    (ULP-level tolerance, like the float conv paths).

    Device mapping: kh+kw shifted integer adds in one fused pass (read +
    write of the plane); XLA fuses the
    normalize multiply into the final add.
    """
    if isinstance(ksize, (tuple, list)):
        kh, kw = int(ksize[0]), int(ksize[1])
    else:
        kh = kw = int(ksize)
    if kh < 1 or kw < 1 or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"ksize dims must be odd and >= 1, got {(kh, kw)}")
    if kh == 1 and kw == 1:
        return planes
    H, W = planes.shape[-2], planes.shape[-1]
    area = kh * kw
    if planes.dtype == jnp.float32:
        p = jnp.pad(planes, ((0, 0), (kh // 2, kh // 2), (kw // 2, kw // 2)),
                    mode="reflect")
        rows = sum(p[:, j : j + H, :] for j in range(kh))
        S = sum(rows[:, :, j : j + W] for j in range(kw))
        return (S * jnp.float32(1.0 / area)).astype(jnp.float32)
    if planes.dtype not in (jnp.uint8, jnp.uint16, jnp.int16):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    minv, maxv = _int_bounds(planes.dtype)
    if area * max(abs(minv), maxv) >= 2**31:
        raise ValueError(
            f"box ksize {(kh, kw)} overflows the int32 window sums for "
            f"{planes.dtype} (area·maxval ≥ 2³¹); use a smaller kernel"
        )
    p = jnp.pad(planes.astype(jnp.int32),
                ((0, 0), (kh // 2, kh // 2), (kw // 2, kw // 2)), mode="reflect")
    rows = sum(p[:, j : j + H, :] for j in range(kh))
    S = sum(rows[:, :, j : j + W] for j in range(kw))
    prod = S.astype(jnp.float32) * jnp.float32(1.0 / area)
    return jnp.clip(jnp.round(prod), minv, maxv).astype(planes.dtype)


def laplacian_sharpen_planes(planes: jnp.ndarray) -> jnp.ndarray:
    """Sharpen = src − Laplacian(src); saturating for integer dtypes
    (SURVEY.md §2 #7)."""
    if planes.dtype == jnp.float32:
        return planes - laplacian_planes(planes)
    minv, maxv = _int_bounds(planes.dtype)
    lap = laplacian_planes(planes).astype(jnp.int32)
    return jnp.clip(planes.astype(jnp.int32) - lap, minv, maxv).astype(planes.dtype)


def _add_weighted_fma(src_f32, blur_f32, amount: float):
    """cv2's integer addWeighted for fractional weights: two single-rounded
    f32 FMAs, reproduced exactly with the utils/fma.py emulation."""
    from imageenhancement_mp_tpu.utils.fma import fma32

    alpha = jnp.float32(1.0 + amount)
    beta = jnp.float32(-amount)
    t = blur_f32 * beta  # f32(blur·β): one rounding — an FMA with 0 addend
    return jnp.round(fma32(src_f32, alpha, t))


def unsharp_mask_planes(
    planes: jnp.ndarray,
    amount: float = 1.0,
    ksize: int = 5,
    sigma: float = 0.0,
) -> jnp.ndarray:
    """``cv2.addWeighted(src, 1+a, blur, −a, 0)`` — exact for u8/u16 and
    any ``amount``: integral amounts stay in exact int32; fractional
    amounts reproduce cv2's two single-rounded f32 FMAs
    (``round(f32(src·f32(1+a) + f32(blur·f32(−a))))`` — ref/ops.py probe).
    """
    if planes.dtype == jnp.float32:
        # cv2's f32 addWeighted is the same two-FMA chain as the integer
        # path, just without the round/saturate (ref/ops.py:add_weighted
        # probe — a plain src + a·(src−blur) differs in the last ULP)
        blur = gaussian_blur_planes(planes, ksize, sigma)
        t = blur * jnp.float32(-amount)  # f32(blur·β): FMA with 0 addend
        from imageenhancement_mp_tpu.utils.fma import fma32

        return fma32(planes, jnp.float32(1.0 + amount), t)
    if planes.dtype in (jnp.uint16, jnp.int16):
        minv, maxv = _int_bounds(planes.dtype)
        blur = gaussian_blur_planes(planes, ksize, sigma).astype(jnp.int32)
        src = planes.astype(jnp.int32)
        if amount == int(amount):
            out = src + int(amount) * (src - blur)
        else:
            out = _add_weighted_fma(
                src.astype(jnp.float32), blur.astype(jnp.float32), amount
            )
        return jnp.clip(out, minv, maxv).astype(planes.dtype)
    blur = gaussian_blur_planes(planes, ksize, sigma)
    src = planes.astype(jnp.float32)
    if amount == int(amount):
        out = src + int(amount) * (src - blur.astype(jnp.float32))
    else:
        out = _add_weighted_fma(src, blur.astype(jnp.float32), amount)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def _max_abs_val(dtype) -> int:
    """Largest |value| of an integer image dtype (int16 → 32768)."""
    minv, maxv = _int_bounds(dtype)
    return max(abs(minv), maxv)


def _raw_sep_conv_int(planes_i32, kx, ky, H, W):
    """Raw int32 separable correlation (REFLECT_101), zero taps skipped."""
    ph, pw = len(ky) // 2, len(kx) // 2
    p = jnp.pad(planes_i32, ((0, 0), (ph, ph), (pw, pw)), mode="reflect")
    v = sum(int(t) * p[:, i : i + H, :] for i, t in enumerate(ky) if int(t) != 0)
    return sum(int(t) * v[:, :, i : i + W] for i, t in enumerate(kx) if int(t) != 0)


def _combine_delta_int32(acc, B: int, idelta: int):
    """``clip(acc + idelta, INT32_MIN, INT32_MAX)`` without int32 wrap.

    ``|acc| ≤ B < 2³¹``: pre-clip acc into ``[INT32_MIN−δ, INT32_MAX−δ]``
    (bounds narrowed to ±B so they are representable), THEN add."""
    import numpy as np

    idelta = int(np.clip(idelta, -(2**31), 2**31 - 1))
    lo_eff = max(-(2**31) - idelta, -B)
    hi_eff = min(2**31 - 1 - idelta, B)
    if lo_eff > hi_eff:  # |δ| so large every pixel saturates the same way
        const = -(2**31) if idelta < 0 else 2**31 - 1
        return jnp.full(acc.shape, const, jnp.int32)
    return jnp.clip(acc, lo_eff, hi_eff) + idelta


def sobel_planes(
    planes: jnp.ndarray, dx: int = 1, dy: int = 0, ksize: int = 3,
    scale: float = 1.0, delta: float = 0.0,
) -> jnp.ndarray:
    """``cv2.Sobel`` / ``cv2.Scharr`` (``ksize=-1``) per plane.

    REFLECT_101; output widens like our Laplacian: u8→i16 (saturating,
    = cv2's CV_16S — exact for scale=1 incl. any delta), u16/i16→i32
    (cv2 only offers a FLOAT destination for 16-bit inputs; our exact
    integers agree with cv2's f32 to 0.5 ULP — a strictly-more-precise
    extension), f32→f32 (cv2's float path, accumulation-order ULP
    tolerance).  ``scale ≠ 1`` folds the scale into the float kernel
    like cv2 (scattered ±1 vs cv2's SIMD order for u8; f32-precision
    relative at 16-bit magnitudes — docs/PARITY.md).  Integer inputs are
    limited to kernels whose exact int32 sums fit (u8 ≤ 11, 16-bit ≤ 7
    for first derivatives); beyond that convert to float32 — at those
    magnitudes no exact integer path exists in cv2 either.
    """
    from imageenhancement_mp_tpu.ref.ops import deriv_kernels

    import numpy as np

    kx, ky = deriv_kernels(dx, dy, ksize)
    H, W = planes.shape[-2], planes.shape[-1]
    ph, pw = len(ky) // 2, len(kx) // 2
    if planes.dtype != jnp.float32:
        maxval = _max_abs_val(planes.dtype)
        if int(np.abs(ky).sum()) * int(np.abs(kx).sum()) * maxval >= 2**31:
            # beyond exact-int32 range the f32 device path would be off by
            # HUNDREDS at these magnitudes (f32 ulp ≈ 512 at 4e9), and cv2's
            # own integer destinations overflow here too — refuse rather
            # than silently degrade; callers wanting huge kernels convert
            # to float32 (cv2's only well-defined path at these sizes)
            raise ValueError(
                f"sobel ksize {ksize} exceeds the exact int32 range for "
                f"{planes.dtype}; convert to float32 for kernels this large"
            )
    float_path = planes.dtype == jnp.float32 or scale != 1.0
    if float_path:
        p = jnp.pad(planes, ((0, 0), (ph, ph), (pw, pw)), mode="reflect").astype(jnp.float32)
        kxf = kx.astype(np.float64) * float(scale)
        v = sum(jnp.float32(float(t)) * p[:, i : i + H, :] for i, t in enumerate(ky))
        acc = sum(jnp.float32(float(t)) * v[:, :, i : i + W] for i, t in enumerate(kxf))
        if planes.dtype == jnp.float32:
            return (acc + jnp.float32(delta)).astype(jnp.float32)
        out = jnp.round(acc + jnp.float32(delta))
        if planes.dtype == jnp.uint8:
            return jnp.clip(out, -32768, 32767).astype(jnp.int16)
        return jnp.clip(out, -(2.0**31), 2.0**31 - 1).astype(jnp.int32)
    acc = _raw_sep_conv_int(planes.astype(jnp.int32), kx, ky, H, W)
    B = int(np.abs(ky).sum()) * int(np.abs(kx).sum()) * maxval
    out = _combine_delta_int32(acc, B, int(np.round(float(delta))))
    if planes.dtype == jnp.uint8:
        return jnp.clip(out, -32768, 32767).astype(jnp.int16)
    return out.astype(jnp.int32)


def box_filter_planes(planes: jnp.ndarray, ksize=3, normalize: bool = True) -> jnp.ndarray:
    """``cv2.boxFilter``: normalized == ``box_blur_planes``; raw sums
    otherwise (int32 for integer dtypes, f32 for float — exact,
    REFLECT_101)."""
    if normalize:
        return box_blur_planes(planes, ksize)
    if planes.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    kh, kw = (int(ksize[0]), int(ksize[1])) if isinstance(ksize, (tuple, list)) \
        else (int(ksize), int(ksize))
    acc = jnp.float32 if planes.dtype == jnp.float32 else jnp.int32
    H, W = planes.shape[-2], planes.shape[-1]
    p = jnp.pad(planes.astype(acc),
                ((0, 0), (kh // 2, kh - 1 - kh // 2), (kw // 2, kw - 1 - kw // 2)),
                mode="reflect")
    s = sum(p[:, i:i + H, :] for i in range(kh))
    return sum(s[:, :, j:j + W] for j in range(kw))


def corner_harris_planes(planes: jnp.ndarray, block_size: int = 2,
                         ksize: int = 3, k: float = 0.04) -> jnp.ndarray:
    """``cv2.cornerHarris`` per plane (u8 → f32 response): f32 Sobel
    derivatives scaled by ``1/(2^(ksize-1)·block·255)``, unnormalized
    block sums, ``det − k·trace²`` — f32-ulp parity (ref/ops.py)."""
    if planes.dtype != jnp.uint8:
        raise TypeError("cornerHarris requires uint8 input")
    from imageenhancement_mp_tpu.ops.resize import _round_cast  # noqa: F401 (doc)

    f = planes.astype(jnp.float32)
    dx = sobel_planes(f, 1, 0, ksize)
    dy = sobel_planes(f, 0, 1, ksize)
    sc = jnp.float32(1.0 / ((1 << (ksize - 1)) * block_size * 255))
    dx = dx * sc
    dy = dy * sc
    cxx = box_filter_planes(dx * dx, block_size, normalize=False)
    cyy = box_filter_planes(dy * dy, block_size, normalize=False)
    cxy = box_filter_planes(dx * dy, block_size, normalize=False)
    return (cxx * cyy - cxy * cxy - jnp.float32(k) * (cxx + cyy) ** 2
            ).astype(jnp.float32)


def spatial_gradient_planes(planes: jnp.ndarray, border: str = "reflect101"):
    """``cv2.spatialGradient`` per plane — exact integer Sobel-3 pair
    (u8 → i16 dx, dy; REFLECT_101 or REPLICATE border, ref/ops.py)."""
    if planes.dtype != jnp.uint8:
        raise TypeError("spatialGradient requires uint8 input")
    mode = "reflect" if border == "reflect101" else "edge"
    H, W = planes.shape[-2], planes.shape[-1]
    p = jnp.pad(planes.astype(jnp.int32), ((0, 0), (1, 1), (1, 1)), mode=mode)
    sy = p[:, 0:H, :] + 2 * p[:, 1:H + 1, :] + p[:, 2:H + 2, :]
    dx = (sy[:, :, 2:W + 2] - sy[:, :, 0:W]).astype(jnp.int16)
    sx = p[:, :, 0:W] + 2 * p[:, :, 1:W + 1] + p[:, :, 2:W + 2]
    dy = (sx[:, 2:H + 2, :] - sx[:, 0:H, :]).astype(jnp.int16)
    return dx, dy


def sqr_box_filter_planes(planes: jnp.ndarray, ksize=3,
                          normalize: bool = True) -> jnp.ndarray:
    """``cv2.sqrBoxFilter`` per plane (→ f32).  Must run under
    ``jax.enable_x64`` (the api wrapper does): squares and window sums
    in s64/f64, f64 ``1/area`` scale, one f32 cast — the pinned law
    (ref/ops.py; u8 normalized is ±1 ulp vs cv2's IPP kernel)."""
    if planes.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
        raise TypeError(f"expected uint8/uint16/int16/float32, got {planes.dtype}")
    kh, kw = (int(ksize[0]), int(ksize[1])) if isinstance(ksize, (tuple, list)) \
        else (int(ksize), int(ksize))
    acc = jnp.float64 if planes.dtype == jnp.float32 else jnp.int64
    sq = planes.astype(acc) ** 2
    H, W = planes.shape[-2], planes.shape[-1]
    p = jnp.pad(sq, ((0, 0), (kh // 2, kh - 1 - kh // 2),
                     (kw // 2, kw - 1 - kw // 2)), mode="reflect")
    s = sum(p[:, i:i + H, :] for i in range(kh))
    s = sum(s[:, :, j:j + W] for j in range(kw))
    if normalize:
        return (s.astype(jnp.float64) * (1.0 / (kh * kw))).astype(jnp.float32)
    return s.astype(jnp.float32)


def corner_min_eigen_val_planes(planes: jnp.ndarray, block_size: int = 3,
                                ksize: int = 3) -> jnp.ndarray:
    """``cv2.cornerMinEigenVal`` per plane (u8 → f32): smaller
    structure-tensor eigenvalue, cornerHarris scaling — f32-ulp parity
    class (ref/ops.py corner_min_eigen_val)."""
    if planes.dtype != jnp.uint8:
        raise TypeError("cornerMinEigenVal requires uint8 input")
    f = planes.astype(jnp.float32)
    dx = sobel_planes(f, 1, 0, ksize)
    dy = sobel_planes(f, 0, 1, ksize)
    sc = jnp.float32(1.0 / ((1 << (ksize - 1)) * block_size * 255))
    dx = dx * sc
    dy = dy * sc
    a = box_filter_planes(dx * dx, block_size, normalize=False) * jnp.float32(0.5)
    c = box_filter_planes(dy * dy, block_size, normalize=False) * jnp.float32(0.5)
    b = box_filter_planes(dx * dy, block_size, normalize=False)
    return ((a + c) - jnp.sqrt((a - c) * (a - c) + b * b)).astype(jnp.float32)


def stack_blur_planes(planes, ksize) -> "jnp.ndarray":
    """``cv2.stackBlur`` on u8 planes ``[B, H, W]`` (budgeted op).

    Triangle kernel per axis = box(r+1) ∘ box(r+1): two integer running
    sums per axis (O(1) per radius, the stackBlur trick), REPLICATE
    border, then the pinned per-pass descale (Klingemann truncation
    tables for r ≤ 4, half-even rounding for r ≥ 5) — the same law as
    the oracle ref/stackblur.py; cv2's SIMD edge-scheduling deltas are
    the documented budget (docs/PARITY.md "stackBlur")."""
    from imageenhancement_mp_tpu.ref.stackblur import _MUL, _SHR

    kh, kw = (ksize, ksize) if isinstance(ksize, int) else (int(ksize[0]), int(ksize[1]))
    if kh < 1 or kw < 1 or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("ksize dims must be odd and >= 1")
    if kh // 2 > 63 or kw // 2 > 63:
        raise ValueError("radius > 63 not supported (fixed-point table)")
    if planes.dtype != jnp.uint8:
        raise TypeError("stack_blur is uint8 only (budgeted op)")

    def descale(S, r):
        if r <= 4:
            return (S * _MUL[r]) >> _SHR[r]
        den = (r + 1) * (r + 1)
        q = (2 * S + den) // (2 * den)
        tie = (2 * S + den) % (2 * den) == 0
        return jnp.where(tie & (q % 2 == 1), q - 1, q)

    def pass_last(x, r):
        if r == 0:
            return x.astype(jnp.uint8)
        p = jnp.pad(x.astype(jnp.int32), ((0, 0), (0, 0), (r, r)), mode="edge")
        c = jnp.pad(jnp.cumsum(p, axis=-1), ((0, 0), (0, 0), (1, 0)))
        b1 = c[..., r + 1 :] - c[..., : -(r + 1)]
        c2 = jnp.pad(jnp.cumsum(b1, axis=-1), ((0, 0), (0, 0), (1, 0)))
        S = c2[..., r + 1 :] - c2[..., : -(r + 1)]
        return jnp.clip(descale(S, r), 0, 255).astype(jnp.uint8)

    out = pass_last(planes, kw // 2)
    out = pass_last(out.transpose(0, 2, 1), kh // 2)
    return out.transpose(0, 2, 1)
