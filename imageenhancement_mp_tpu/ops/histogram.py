"""256-bin histograms and histogram equalization.

The reference's hist-eq is ``cv2.equalizeHist`` (C++ scalar loops over one
image; SURVEY.md §3.1).  A scatter-add over 256 bins serializes on
duplicate indices, so the histogram is reformulated as a *nibble-split
one-hot matmul* (SURVEY.md §7 "hard parts"):

    v = hi·16 + lo  (4-bit split)
    onehot16(hi) : [P, 16]   onehot16(lo) : [P, 16]
    H[hi, lo] = Σ_p onehot16(hi)ᵀ · onehot16(lo)     (a [16,P]@[P,16] matmul)
    hist = H.reshape(256)                            (row-major: v = hi*16+lo)

32 compares per pixel instead of 256, and the contraction over pixels
is a matrix product with int32 accumulation — exact for any plane < 2^31
pixels.

The LUT build (SURVEY.md §8.1) is 256 elements.  cv2's equalizeHist
multiplies the int cdf by a FLOAT lutScale = 255/(N − hist[i0]); mirroring
that convention (int→f32 conversion, f32 product, half-even round) in
``equalize_lut`` is bit-exact vs cv2 without needing JAX x64 mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["histogram_256", "equalize_lut", "equalize_hist_planes", "equalize_hist_global_planes"]


def _hist_nibble_matmul(plane: jnp.ndarray) -> jnp.ndarray:
    """Exact histogram via one-hot outer product (16×16 for u8, 256×256 for u16)."""
    half = 256 if plane.dtype == jnp.uint16 else 16
    shift = 8 if plane.dtype == jnp.uint16 else 4
    v = plane.reshape(-1).astype(jnp.int32)
    hi = v >> shift
    lo = v & (half - 1)
    bins = jnp.arange(half, dtype=jnp.int32)
    # int8 one-hots with int32 accumulation
    a = (hi[:, None] == bins[None, :]).astype(jnp.int8)
    b = (lo[:, None] == bins[None, :]).astype(jnp.int8)
    h = jax.lax.dot_general(
        a,
        b,
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return h.reshape(half * half)


def _hist_scatter(plane: jnp.ndarray) -> jnp.ndarray:
    nbins = 65536 if plane.dtype == jnp.uint16 else 256
    v = plane.reshape(-1).astype(jnp.int32)
    return jnp.zeros((nbins,), jnp.int32).at[v].add(1)


def histogram_256(planes: jnp.ndarray, method: str | None = None) -> jnp.ndarray:
    """Per-plane exact histogram: u8 → ``[B, 256]``, u16 → ``[B, 65536]`` i32.

    ``method`` picks the u8 implementation; by default the platform does:
    ``"kernel"`` (the Pallas/Triton kernel of kernels/hist.py) on a GPU,
    ``"nibble_matmul"`` elsewhere.  ``"scatter"`` is the plain scatter-add.
    u16 always uses scatter — the byte-split one-hots would materialize
    512 B/pixel ([P,256] ×2), which OOMs on full-resolution planes.
    """
    if method is None:
        if planes.dtype == jnp.uint16:
            method = "scatter"
        elif jax.default_backend() == "gpu":
            method = "kernel"
        else:
            method = "nibble_matmul"
    if method == "kernel":
        from imageenhancement_mp_tpu.kernels.hist import hist256_gpu

        return hist256_gpu(planes)
    fn = {"nibble_matmul": _hist_nibble_matmul, "scatter": _hist_scatter}[method]
    return jax.vmap(fn)(planes)


def equalize_lut(hist: jnp.ndarray, total: int) -> jnp.ndarray:
    """cv2.equalizeHist LUT from a histogram ``[256] i32`` (SURVEY.md §8.1).

    ``lut[i] = clip(round(f32(cdf[i] − cdf[i0])·f32(255/(N − hist[i0]))), 0, 255)``
    with i0 the first nonzero bin; a constant image maps to the identity LUT
    (cv2 short-circuits with ``dst.setTo(i0)``).  The scale is FLOAT32 —
    cv2's equalizeHist multiplies the int cdf by a float scale; mirroring
    that (conversion + f32 product + half-even round) is bit-exact.
    """
    cdf = jnp.cumsum(hist)
    # first nonzero bin: argmax of (hist > 0) returns the first True
    i0 = jnp.argmax(hist > 0)
    h0 = hist[i0]
    denom = jnp.maximum(total - h0, 1)
    scale = jnp.float32(255.0) / denom.astype(jnp.float32)
    lut = jnp.clip(
        jnp.round((cdf - cdf[i0]).astype(jnp.float32) * scale), 0, 255
    ).astype(jnp.uint8)
    identity = jnp.arange(256, dtype=jnp.uint8)
    return jnp.where(h0 == total, identity, lut)


def _check_pool_total(total: int) -> None:
    # the pooled cdf lives in int32: past 2^31 pixels the LUT silently wraps
    if total > jnp.iinfo(jnp.int32).max:
        raise ValueError(
            f"pooled histogram covers {total} pixels, which overflows the "
            "int32 cdf (max 2^31-1 ≈ 1040 1080p frames across the mesh); "
            "split the batch into smaller pooling groups"
        )


def _equalize_global_group(
    planes: jnp.ndarray, method: str | None, axis_name: str | None
) -> jnp.ndarray:
    """One pooled LUT over a ``[B, H, W]`` group (psum-pooled across shards)."""
    total = planes.shape[0] * planes.shape[-1] * planes.shape[-2]
    hist = histogram_256(planes, method).sum(axis=0)
    if axis_name is not None:
        total = total * jax.lax.axis_size(axis_name)
        hist = jax.lax.psum(hist, axis_name)
    _check_pool_total(total)
    lut = equalize_lut(hist, total)
    from imageenhancement_mp_tpu.ops.pointwise import apply_lut_planes

    return apply_lut_planes(planes, lut)


def equalize_hist_global_planes(
    planes: jnp.ndarray,
    method: str | None = None,
    axis_name: str | None = None,
    channels: int = 1,
) -> jnp.ndarray:
    """Video-consistent hist-eq: ONE LUT per channel from the histogram
    pooled across all frames (avoids frame-to-frame flicker when equalizing
    video batches).

    ``channels`` (static) says the ``[B, H, W]`` stack is ``B = N·channels``
    planes in (frame-major, channel-minor) order — the canonical
    ``as_planes`` layout for ``[N, H, W, C]``.  Each channel pools its own
    histogram across the N frames (R, G and B get separate LUTs); pass
    ``channels=1`` to pool one histogram over every plane.

    Inside ``shard_map`` pass ``axis_name`` to pool across shards with a
    ``psum`` — the framework's cross-chip collective path (the per-plane
    ops need none; this is the op that genuinely does).
    """
    if planes.dtype != jnp.uint8:
        raise TypeError(f"equalizeHist is 8-bit only (cv2 parity), got {planes.dtype}")
    if channels <= 1:
        return _equalize_global_group(planes, method, axis_name)
    b, h, w = planes.shape
    if b % channels:
        raise ValueError(f"plane count {b} not divisible by channels={channels}")
    # per-channel pooling WITHOUT vmapping the histogram (keeps the
    # histogram kernel un-batched): one [B, 256] pass, then group-sum — plane
    # i belongs to channel i % C in the frame-major canonical layout
    n = b // channels
    total = n * h * w
    hists = histogram_256(planes, method)  # [B, 256]
    per_ch = hists.reshape(n, channels, 256).sum(axis=0)  # [C, 256]
    if axis_name is not None:
        total = total * jax.lax.axis_size(axis_name)
        per_ch = jax.lax.psum(per_ch, axis_name)
    _check_pool_total(total)
    luts = jax.vmap(functools.partial(equalize_lut, total=total))(per_ch)
    plane_luts = luts[jnp.arange(b) % channels]  # [B, 256]
    from imageenhancement_mp_tpu.ops.pointwise import apply_lut_planes

    return apply_lut_planes(planes, plane_luts)


def equalize_hist_planes(
    planes: jnp.ndarray, method: str | None = None
) -> jnp.ndarray:
    """``cv2.equalizeHist`` on a stack of planes ``[B, H, W] u8`` — exact."""
    if planes.dtype != jnp.uint8:
        raise TypeError(f"equalizeHist is 8-bit only (cv2 parity), got {planes.dtype}")
    total = planes.shape[-1] * planes.shape[-2]
    hists = histogram_256(planes, method)
    luts = jax.vmap(functools.partial(equalize_lut, total=total))(hists)
    from imageenhancement_mp_tpu.ops.pointwise import apply_lut_planes

    return apply_lut_planes(planes, luts)
