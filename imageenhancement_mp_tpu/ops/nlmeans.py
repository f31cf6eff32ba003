"""Non-local means denoising: ``cv2.fastNlMeansDenoising`` (+ the
``Colored`` and ``Multi`` variants' building blocks) on device —
contract pinned BIT-EXACT in ref/ops.py ``fast_nl_means_denoising``.

Device mapping: a ``lax.fori_loop`` over the T·s² search candidates (T
temporal frames × s² spatial offsets; T=1 for the single-image op);
each step takes one shifted view (dynamic_slice on the padded stack),
forms the integer squared-difference map against the TARGET frame's
template (summed over the pixel's channels — cv2 treats multichannel
images as VECTOR pixels with one joint SSD), box-sums it over the t×t
template with two cumulative sums, gathers the fixed-point weight from
the host-built LUT (the live prefix after cv2's 0.001 cutoff is tiny —
a few thousand entries), and accumulates the shared Σw plus
per-channel Σw·v in int32.  All integer work; the final division
replicates cv2's ``(Σwv + Σw/2) // Σw`` in exact integer form.

Accumulator bounds: Σw ≤ T·s²·FPM ≤ INT_MAX/255 by cv2's own FPM
choice (FPM = INT_MAX // (T·s²·255), cn-independent — only the exp's
variance normalisation h²·cn sees the channel count), and
|Σw·(v−128)| ≤ 128·Σw ≤ INT_MAX/2 — inside the same int32 budget cv2
relies on.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from imageenhancement_mp_tpu.ref.ops import _nlm_weight_lut

__all__ = ["fast_nl_means_planes", "fast_nl_means_vec",
           "fast_nl_means_multi_vec", "fast_nl_means_u16_vec"]


def _lut_take(lut: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Weight-LUT gather."""
    return jnp.take(lut, idx)


def fast_nl_means_multi_vec(stack: jnp.ndarray, h: float = 10.0,
                            template_window: int = 7,
                            search_window: int = 21,
                            norm_type: str = "l2") -> jnp.ndarray:
    """``cv2.fastNlMeansDenoisingMulti`` core on ``(T, N, H, W, C)``
    uint8 vector pixels: denoise the CENTER frame (index T//2) of each
    batch element using candidates from every frame of the temporal
    window.  C ∈ {1,2,3,4}; ONE joint SSD over the channels drives a
    shared weight applied to every channel."""
    if stack.dtype != jnp.uint8:
        raise TypeError("fastNlMeansDenoising requires uint8 input")
    t, s = int(template_window), int(search_window)
    if t % 2 == 0 or s % 2 == 0:
        raise ValueError("window sizes must be odd")
    T, N, H, W, C = stack.shape
    if T % 2 == 0:
        raise ValueError("temporal window must be odd")
    if C not in (1, 2, 3, 4):
        raise ValueError(f"fastNlMeansDenoising supports 1-4 channels, got {C}")
    th, sh = t // 2, s // 2
    border = sh + th
    if norm_type not in ("l1", "l2"):
        raise ValueError(f"norm_type must be 'l1' or 'l2', got {norm_type!r}")
    w, bs, _ = _nlm_weight_lut(float(h), t, s, C, temporal=T, norm=norm_type)
    cut = len(w) - 1
    lut = jnp.asarray(w.astype(np.int32))
    p = jnp.pad(stack.astype(jnp.int32),
                ((0, 0), (0, 0), (border, border), (border, border), (0, 0)),
                mode="reflect")
    a = p[T // 2, :, border - th:border + H + th, border - th:border + W + th]

    def body(k, state):
        est, wsum = state
        f = k // (s * s)
        r = k % (s * s)
        dy = r // s
        dx = r % s
        b = jax.lax.dynamic_slice(
            p, (f, 0, border - th + dy - sh, border - th + dx - sh, 0),
            (1, N, H + 2 * th, W + 2 * th, C))[0]
        if norm_type == "l1":
            d2 = jnp.abs(a - b).sum(axis=-1)
        else:
            d2 = ((a - b) * (a - b)).sum(axis=-1)
        # int32 cumsums WRAP on large frames, but the windowed
        # difference below recovers the true t×t sum (< 2^31) exactly
        # by modular arithmetic — the classic integral-image trick
        c = jnp.cumsum(jnp.cumsum(d2, axis=1), axis=2)
        c = jnp.pad(c, ((0, 0), (1, 0), (1, 0)))
        ssd = (c[:, t:, t:] - c[:, :-t, t:] - c[:, t:, :-t] + c[:, :-t, :-t])
        ww = _lut_take(lut, jnp.minimum(ssd >> bs, cut))
        v = jax.lax.dynamic_slice(
            p, (f, 0, border + dy - sh, border + dx - sh, 0),
            (1, N, H, W, C))[0]
        # accumulate v-128 so Σw·v never crosses int32 even at Σw max
        return est + ww[..., None] * (v - 128), wsum + ww

    est0 = jnp.zeros((N, H, W, C), jnp.int32)
    ws0 = jnp.zeros((N, H, W), jnp.int32)
    est, wsum = jax.lax.fori_loop(0, T * s * s, body, (est0, ws0))
    # exact (Σwv + Σw/2) // Σw without the marginal int32 overflow at
    # v≈255 constants: v was biased by −128 in the loop (floor-div
    # distributes exactly over multiples of the divisor)
    ws = jnp.maximum(wsum, 1)
    num = est + (wsum >> 1)[..., None]
    out = 128 + jnp.floor_divide(num, ws[..., None])
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def fast_nl_means_vec(img: jnp.ndarray, h: float = 10.0,
                      template_window: int = 7,
                      search_window: int = 21,
                      norm_type: str = "l2") -> jnp.ndarray:
    """``cv2.fastNlMeansDenoising`` on ``(N, H, W, C)`` uint8 vector
    pixels (C ∈ {1,2,3,4}): ONE joint SSD over the channels drives a
    shared weight applied to every channel — cv2's multichannel
    semantics, NOT per-plane denoising."""
    return fast_nl_means_multi_vec(img[None], h, template_window,
                                   search_window, norm_type)


def fast_nl_means_planes(planes: jnp.ndarray, h: float = 10.0,
                         template_window: int = 7,
                         search_window: int = 21) -> jnp.ndarray:
    """``cv2.fastNlMeansDenoising`` per plane on ``(N, H, W)`` uint8."""
    out = fast_nl_means_vec(planes[..., None], h, template_window,
                            search_window)
    return out[..., 0]


def fast_nl_means_u16_vec(img: jnp.ndarray, h: float = 10.0,
                          template_window: int = 7,
                          search_window: int = 21) -> jnp.ndarray:
    """``cv2.fastNlMeansDenoising`` on ``(N, H, W, C)`` uint16 vector
    pixels — cv2 supports 16U only with NORM_L1, where the pinned
    fixed-point multiplier is INT_MAX itself and cv2 dispatches 64-bit
    accumulators (ref/ops.py ``_nlm_weight_lut``).  MUST be traced and
    called under ``jax.experimental.enable_x64`` (the api wrapper does
    this): Σw ≤ s²·2³¹ and Σw·v ≤ s²·2⁴⁷ need int64.  The SAD
    integral images stay int32 (the modular windowed-difference trick:
    true t×t sums ≤ t²·4·65535 < 2³¹)."""
    if img.dtype != jnp.uint16:
        raise TypeError("fast_nl_means_u16_vec requires uint16 input")
    t, s = int(template_window), int(search_window)
    if t % 2 == 0 or s % 2 == 0:
        raise ValueError("window sizes must be odd")
    N, H, W, C = img.shape
    if C not in (1, 2, 3, 4):
        raise ValueError(f"fastNlMeansDenoising supports 1-4 channels, got {C}")
    th, sh = t // 2, s // 2
    border = sh + th
    w, bs, _ = _nlm_weight_lut(float(h), t, s, C, norm="l1", maxval=65535)
    cut = len(w) - 1
    lut = jnp.asarray(w.astype(np.int64))
    p = jnp.pad(img.astype(jnp.int32),
                ((0, 0), (border, border), (border, border), (0, 0)),
                mode="reflect")
    a = p[:, border - th:border + H + th, border - th:border + W + th]

    def body(k, state):
        est, wsum = state
        dy = k // s
        dx = k % s
        b = jax.lax.dynamic_slice(
            p, (0, border - th + dy - sh, border - th + dx - sh, 0),
            (N, H + 2 * th, W + 2 * th, C))
        sad = jnp.abs(a - b).sum(axis=-1)
        c = jnp.cumsum(jnp.cumsum(sad, axis=1), axis=2)
        c = jnp.pad(c, ((0, 0), (1, 0), (1, 0)))
        win = (c[:, t:, t:] - c[:, :-t, t:] - c[:, t:, :-t] + c[:, :-t, :-t])
        ww = _lut_take(lut, jnp.minimum(win >> bs, cut))
        v = jax.lax.dynamic_slice(
            p, (0, border + dy - sh, border + dx - sh, 0), (N, H, W, C))
        return (est + ww[..., None] * v.astype(jnp.int64), wsum + ww)

    est0 = jnp.zeros((N, H, W, C), jnp.int64)
    ws0 = jnp.zeros((N, H, W), jnp.int64)
    est, wsum = jax.lax.fori_loop(0, s * s, body, (est0, ws0))
    ws = jnp.maximum(wsum, 1)
    out = jnp.floor_divide(est + (wsum >> 1)[..., None], ws[..., None])
    return jnp.clip(out, 0, 65535).astype(jnp.uint16)
