"""Spatial sharding: one frame's ROWS split across the device mesh.

Batch DP (parallel/sharding.py) scales *throughput*; spatial sharding
scales the *frame*: the height dimension is sharded over a mesh axis so a
single giant frame (gigapixel scans, stitched aerial tiles) — or a
latency-critical stream of them — uses every chip at once.  The reference
is single-image/single-process (SURVEY.md §2), so nothing here mirrors it;
this is the answer to "the image no longer fits one device",
built from the three collective patterns the domain actually needs:

* **stencil ops** (Gaussian/median/unsharp/Laplacian) exchange their
  ``r = k//2`` boundary rows with mesh neighbors via ``jax.lax.ppermute``
  between devices (classic halo exchange; the edge shards synthesize the cv2
  border — REFLECT_101 for convs, replicate for median — from their own
  rows, so global border semantics are preserved bit-for-bit);
* **histogram ops** (hist-eq, contrast stretch) pool per-shard statistics
  with ``psum`` / ``pmin`` / ``pmax`` (1 KB per chip per frame);
* **CLAHE** computes tile LUTs for its local tile rows, ``all_gather``s
  the tiny ``[gh·gw, S]`` LUT table (64 KB for u8), and blends locally
  with globally-indexed interpolation coordinates.

Every op here is **bit-identical** to its single-device planes twin —
the collectives move exact integers (histograms, min/max, LUT tables,
halo rows), never rounded intermediates (tests/test_spatial.py proves
equality on the virtual 8-device mesh).

Composability: the local functions take ``axis_name`` and run inside
``shard_map``; :func:`shard_spatial` builds the jitted sharded program.
A 2-D ``Mesh(('batch', 'y'))`` composes batch DP × spatial sharding —
pass ``batch_axis='batch'`` and the spatial collectives stay scoped to
each batch-shard's row group.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from imageenhancement_mp_tpu.ref.ops import gaussian_axes

__all__ = [
    "shard_spatial",
    "device_put_spatial",
    "halo_exchange",
    "gaussian_blur_spatial",
    "box_blur_spatial",
    "bilateral_spatial",
    "adaptive_threshold_spatial",
    "erode_spatial",
    "dilate_spatial",
    "morphology_spatial",
    "sobel_spatial",
    "filter2d_spatial",
    "unsharp_mask_spatial",
    "median_blur_spatial",
    "laplacian_sharpen_spatial",
    "equalize_hist_spatial",
    "contrast_stretch_spatial",
    "clahe_spatial",
    "resize_spatial",
    "warp_affine_spatial",
    "remap_spatial",
    "canny_spatial",
    "SPATIAL_OP_REGISTRY",
    "make_spatial_pipeline",
]


def shard_spatial(
    planes_fn: Callable,
    mesh: Mesh,
    axis_name: str = "y",
    batch_axis: str | None = None,
) -> Callable:
    """Shard a planes-level function ``[B,H,W]→[B,H,W]`` over frame rows.

    ``planes_fn`` receives the local ``[B, H/n, W]`` block and must use the
    ``*_spatial`` ops (closing over ``axis_name``) for anything that needs
    cross-shard data; purely pointwise ops (gamma/log LUTs) can be called
    as-is.  ``H`` must be divisible by the mesh's ``axis_name`` size.
    ``batch_axis`` additionally shards the leading planes dim (2-D mesh:
    batch DP × spatial).  Returns a jitted callable.
    """
    sharded = jax.shard_map(
        planes_fn,
        mesh=mesh,
        in_specs=P(batch_axis, axis_name, None),
        out_specs=P(batch_axis, axis_name, None),
        check_vma=False,
    )
    return jax.jit(sharded)


def device_put_spatial(
    planes, mesh: Mesh, axis_name: str = "y", batch_axis: str | None = None
):
    """Place host planes ``[B,H,W]`` onto the mesh, rows sharded."""
    return jax.device_put(planes, NamedSharding(mesh, P(batch_axis, axis_name, None)))


def halo_exchange(
    local: jnp.ndarray, r: int, axis_name: str = "y", mode: str = "reflect",
    const_val=0,
) -> jnp.ndarray:
    """Extend a local ``[B, h, W]`` row block by ``r`` halo rows per side.

    Interior halos are the neighbor shards' boundary rows, moved with two
    ``ppermute`` shifts between devices; the global top/bottom shards synthesize
    the cv2 border instead — ``mode="reflect"`` (BORDER_REFLECT_101, rows
    ``r..1`` / ``h-2..h-1-r``) or ``mode="edge"`` (replicate).  Requires
    ``h ≥ r+1`` for reflect (the REFLECT_101 border reads local row ``r``)
    but only ``h ≥ r`` for edge (replicate reads rows 0/−1, and interior
    halos come from the immediate neighbor's ``r`` rows).
    """
    if r <= 0:
        return local
    h = local.shape[1]
    h_min = r + 1 if mode == "reflect" else r
    if h < h_min:
        raise ValueError(
            f"shard height {h} too small for halo radius {r} with mode "
            f"{mode!r} (need h ≥ {h_min}); use fewer shards or a smaller kernel"
        )
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    # my bottom rows become the lower neighbor's TOP halo, and vice versa;
    # the edge shards receive zeros (no pair) and select their border rows
    from_above = jax.lax.ppermute(
        local[:, -r:, :], axis_name, [(i, i + 1) for i in range(n - 1)]
    )
    from_below = jax.lax.ppermute(
        local[:, :r, :], axis_name, [(i + 1, i) for i in range(n - 1)]
    )
    if mode == "reflect":
        self_top = local[:, r:0:-1, :]
        self_bot = local[:, -2 : -r - 2 : -1, :]
    elif mode == "edge":
        self_top = jnp.repeat(local[:, :1, :], r, axis=1)
        self_bot = jnp.repeat(local[:, -1:, :], r, axis=1)
    elif mode == "const":
        fill = jnp.full((local.shape[0], r, local.shape[2]), const_val, local.dtype)
        self_top = self_bot = fill
    else:
        raise ValueError(f"mode must be 'reflect', 'edge' or 'const', got {mode!r}")
    top = jnp.where(idx == 0, self_top, from_above)
    bot = jnp.where(idx == n - 1, self_bot, from_below)
    return jnp.concatenate([top, local, bot], axis=1)


def _stencil_spatial(local, op: Callable, r: int, mode: str, axis_name: str,
                     const_val=0):
    """Halo-exchange → run the single-device op on the extended block →
    crop.  Exact because the op's own border handling only influences the
    ``r`` outermost output rows, which are cropped; every kept output row
    sees true (halo or local) data only."""
    if r == 0:
        return op(local)
    ext = halo_exchange(local, r, axis_name, mode, const_val=const_val)
    return op(ext)[:, r:-r, :]


def gaussian_blur_spatial(
    local: jnp.ndarray,
    ksize=5,
    sigma: float = 0.0,
    sigma_y: float = 0.0,
    axis_name: str = "y",
) -> jnp.ndarray:
    """``cv2.GaussianBlur`` on row-sharded planes — bit-identical to
    :func:`ops.filters.gaussian_blur_planes` on the gathered frame."""
    from imageenhancement_mp_tpu.ops.filters import gaussian_blur_planes

    kh, _, _, _ = gaussian_axes(
        sigma=sigma, sigma_y=sigma_y, ksize=ksize, depth_u8=local.dtype == jnp.uint8
    )
    op = partial(gaussian_blur_planes, ksize=ksize, sigma=sigma, sigma_y=sigma_y)
    return _stencil_spatial(local, op, kh // 2, "reflect", axis_name)


def unsharp_mask_spatial(
    local: jnp.ndarray,
    amount: float = 1.0,
    ksize: int = 5,
    sigma: float = 0.0,
    axis_name: str = "y",
) -> jnp.ndarray:
    """Unsharp mask on row-sharded planes (halo = the blur's radius)."""
    from imageenhancement_mp_tpu.ops.filters import unsharp_mask_planes

    kh, _, _, _ = gaussian_axes(
        sigma=sigma, sigma_y=sigma, ksize=ksize, depth_u8=local.dtype == jnp.uint8
    )
    op = partial(unsharp_mask_planes, amount=amount, ksize=ksize, sigma=sigma)
    return _stencil_spatial(local, op, kh // 2, "reflect", axis_name)


def median_blur_spatial(
    local: jnp.ndarray, ksize: int = 3, axis_name: str = "y"
) -> jnp.ndarray:
    """``cv2.medianBlur`` on row-sharded planes (replicate border)."""
    from imageenhancement_mp_tpu.ops.median import median_blur_planes

    op = partial(median_blur_planes, ksize=ksize)
    return _stencil_spatial(local, op, ksize // 2, "edge", axis_name)


def box_blur_spatial(
    local: jnp.ndarray, ksize=3, axis_name: str = "y"
) -> jnp.ndarray:
    """``cv2.blur`` on row-sharded planes (halo = kh//2 rows)."""
    from imageenhancement_mp_tpu.ops.filters import box_blur_planes

    kh = int(ksize[0]) if isinstance(ksize, (tuple, list)) else int(ksize)
    op = partial(box_blur_planes, ksize=ksize)
    return _stencil_spatial(local, op, kh // 2, "reflect", axis_name)


def bilateral_spatial(
    local: jnp.ndarray, d: int = 5, sigma_color: float = 50.0,
    sigma_space: float = 50.0, axis_name: str = "y"
) -> jnp.ndarray:
    """``cv2.bilateralFilter`` on row-sharded grayscale planes (halo =
    the disc radius)."""
    from imageenhancement_mp_tpu.ops.bilateral import bilateral_offsets, bilateral_planes

    _, _, r = bilateral_offsets(d, sigma_color, sigma_space)
    op = partial(bilateral_planes, d=d, sigma_color=sigma_color, sigma_space=sigma_space)
    return _stencil_spatial(local, op, r, "reflect", axis_name)


def _morph_one_spatial(local, op: str, kh: int, kw: int, axis_name: str):
    from imageenhancement_mp_tpu.ops.morphology import _identity, _minmax_filter

    if kh % 2 == 0:
        raise ValueError("spatial morphology needs an odd kernel height")
    return _stencil_spatial(
        local, lambda p: _minmax_filter(p, kh, kw, op), kh // 2, "const",
        axis_name, const_val=_identity(local.dtype, op),
    )


def erode_spatial(local: jnp.ndarray, ksize=3, iterations: int = 1,
                  axis_name: str = "y") -> jnp.ndarray:
    """``cv2.erode`` on row-sharded planes (per-iteration halo; the const
    halo rows are the op's identity at the global edges, matching cv2's
    BORDER_CONSTANT)."""
    from imageenhancement_mp_tpu.ops.morphology import _ksize2

    kh, kw = _ksize2(ksize)
    for _ in range(max(1, int(iterations))):
        local = _morph_one_spatial(local, "min", kh, kw, axis_name)
    return local


def dilate_spatial(local: jnp.ndarray, ksize=3, iterations: int = 1,
                   axis_name: str = "y") -> jnp.ndarray:
    """``cv2.dilate`` on row-sharded planes (see erode_spatial)."""
    from imageenhancement_mp_tpu.ops.morphology import _ksize2

    kh, kw = _ksize2(ksize)
    for _ in range(max(1, int(iterations))):
        local = _morph_one_spatial(local, "max", kh, kw, axis_name)
    return local


def morphology_spatial(local: jnp.ndarray, op: str = "open", ksize=3,
                       iterations: int = 1, axis_name: str = "y") -> jnp.ndarray:
    """``cv2.morphologyEx`` on row-sharded planes — each stage stenciled
    separately (cv2 pads every intermediate with that stage's identity,
    so a fused halo would be wrong at the global edges)."""
    from imageenhancement_mp_tpu.ops.morphology import MORPH_OPS, _sat_sub

    if op not in MORPH_OPS:
        raise ValueError(f"op must be one of {MORPH_OPS}, got {op!r}")
    er = partial(erode_spatial, ksize=ksize, iterations=iterations, axis_name=axis_name)
    di = partial(dilate_spatial, ksize=ksize, iterations=iterations, axis_name=axis_name)
    if op == "erode":
        return er(local)
    if op == "dilate":
        return di(local)
    if op == "open":
        return di(er(local))
    if op == "close":
        return er(di(local))
    if op == "gradient":
        return _sat_sub(di(local), er(local), local.dtype)
    if op == "tophat":
        return _sat_sub(local, di(er(local)), local.dtype)
    return _sat_sub(er(di(local)), local, local.dtype)


def sobel_spatial(
    local: jnp.ndarray, dx: int = 1, dy: int = 0, ksize: int = 3,
    scale: float = 1.0, delta: float = 0.0, axis_name: str = "y",
) -> jnp.ndarray:
    """``cv2.Sobel``/``Scharr`` on row-sharded planes (halo = ky radius)."""
    from imageenhancement_mp_tpu.ops.filters import sobel_planes
    from imageenhancement_mp_tpu.ref.ops import deriv_kernels

    _, ky = deriv_kernels(dx, dy, ksize)
    op = partial(sobel_planes, dx=dx, dy=dy, ksize=ksize, scale=scale, delta=delta)
    return _stencil_spatial(local, op, len(ky) // 2, "reflect", axis_name)


def filter2d_spatial(
    local: jnp.ndarray, kernel, delta: float = 0.0, axis_name: str = "y"
) -> jnp.ndarray:
    """``cv2.filter2D`` on row-sharded planes (halo = kh//2 rows)."""
    import numpy as np

    from imageenhancement_mp_tpu.ops.filter2d import filter2d_planes

    kh = int(np.asarray(kernel).shape[0])
    op = partial(filter2d_planes, kernel=kernel, delta=delta)
    return _stencil_spatial(local, op, kh // 2, "reflect", axis_name)


def adaptive_threshold_spatial(
    local: jnp.ndarray, maxval: float = 255.0, method: str = "mean",
    type: str = "binary", block_size: int = 3, C: float = 0.0,
    axis_name: str = "y",
) -> jnp.ndarray:
    """``cv2.adaptiveThreshold`` on row-sharded planes (halo = bs//2 rows
    of REPLICATE border — mode "edge" matches cv2's border here)."""
    from imageenhancement_mp_tpu.ops.threshold import adaptive_threshold_planes

    op = partial(adaptive_threshold_planes, maxval=maxval, method=method,
                 type=type, block_size=block_size, C=C)
    return _stencil_spatial(local, op, int(block_size) // 2, "edge", axis_name)


def laplacian_sharpen_spatial(local: jnp.ndarray, axis_name: str = "y") -> jnp.ndarray:
    """Laplacian sharpen on row-sharded planes (3×3 stencil, halo 1)."""
    from imageenhancement_mp_tpu.ops.filters import laplacian_sharpen_planes

    return _stencil_spatial(local, laplacian_sharpen_planes, 1, "reflect", axis_name)


def equalize_hist_spatial(
    local: jnp.ndarray, method: str | None = None, axis_name: str = "y"
) -> jnp.ndarray:
    """``cv2.equalizeHist`` per frame on row-sharded planes.

    Each shard histograms its rows (``histogram_256``), a ``psum`` pools the 256 bins across the mesh, and
    every shard maps its rows through the identical full-frame LUT —
    1 KB between devices per plane.
    """
    from imageenhancement_mp_tpu.ops.histogram import equalize_lut, histogram_256

    if local.dtype != jnp.uint8:
        raise TypeError(f"equalizeHist is 8-bit only (cv2 parity), got {local.dtype}")
    n = jax.lax.axis_size(axis_name)
    total = local.shape[-2] * local.shape[-1] * n
    if total > jnp.iinfo(jnp.int32).max:
        raise ValueError(
            f"frame covers {total} pixels, which overflows the int32 cdf; "
            "equalizeHist parity is defined up to 2^31-1 pixels per frame"
        )
    hists = jax.lax.psum(histogram_256(local, method), axis_name)
    luts = jax.vmap(partial(equalize_lut, total=total))(hists)
    from imageenhancement_mp_tpu.ops.pointwise import apply_lut_planes

    return apply_lut_planes(local, luts)


def contrast_stretch_spatial(
    local: jnp.ndarray,
    out_range: tuple[float, float] = (0.0, 255.0),
    axis_name: str = "y",
) -> jnp.ndarray:
    """``cv2.normalize(MINMAX)`` per frame on row-sharded planes.

    Per-shard min/max reduce, ``pmin``/``pmax`` across the mesh, then the
    same double-float LUT build as the single-device path (exact u8/u16;
    float32 uses cv2's float path).
    """
    from imageenhancement_mp_tpu.ops.pointwise import stretch_luts_from_minmax

    a, b = sorted((float(out_range[0]), float(out_range[1])))
    if local.dtype == jnp.float32:
        lo = jax.lax.pmin(jnp.min(local, axis=(-2, -1)), axis_name)
        hi = jax.lax.pmax(jnp.max(local, axis=(-2, -1)), axis_name)

        def onef(p, lo_i, hi_i):
            out = (p - lo_i) * ((b - a) / jnp.maximum(hi_i - lo_i, jnp.float32(1e-45))) + a
            return jnp.where(hi_i == lo_i, jnp.float32(a), out).astype(jnp.float32)

        return jax.vmap(onef)(local, lo, hi)
    if local.dtype == jnp.int16:
        minv, maxv = -32768, 32767
    else:
        minv, maxv = 0, (65535 if local.dtype == jnp.uint16 else 255)
    lo = jax.lax.pmin(jnp.min(local, axis=(-2, -1)).astype(jnp.int32), axis_name)
    hi = jax.lax.pmax(jnp.max(local, axis=(-2, -1)).astype(jnp.int32), axis_name)
    luts = stretch_luts_from_minmax(lo, hi, a, b, maxv, local.dtype, minv)
    return jax.vmap(lambda l, p: l[p.astype(jnp.int32) - minv])(luts, local)


def clahe_spatial(
    local: jnp.ndarray,
    clip_limit: float = 40.0,
    tile_grid: tuple[int, int] = (8, 8),
    axis_name: str = "y",
) -> jnp.ndarray:
    """``cv2.createCLAHE`` on row-sharded planes.

    Each shard owns ``gh/n`` tile rows: stages A+B (per-tile histogram →
    clipped LUT) are shard-local; one ``all_gather`` shares the
    ``[gh·gw, S]`` LUT table (64 KB for u8 — the only cross-shard state
    the blend needs); stage C blends locally with globally-indexed row
    coordinates.  Bit-identical to :func:`ops.clahe.clahe_planes`.

    Sharded CLAHE requires divisible geometry: ``gh % n == 0``,
    ``(H/n) % (gh/n) == 0`` and ``W % gw == 0`` (cv2's non-divisible
    REFLECT_101 pad quirk is only supported on the single-device path —
    pad explicitly before sharding if needed).
    """
    from imageenhancement_mp_tpu.ops.clahe import (
        _interp_coords,
        _tile_hists,
        blend_tile_luts,
        clahe_tile_luts,
    )

    if local.dtype not in (jnp.uint8, jnp.uint16):
        raise TypeError(f"CLAHE supports uint8/uint16 (cv2 parity), got {local.dtype}")
    hist_size = 65536 if local.dtype == jnp.uint16 else 256
    B, h, W = local.shape
    n = jax.lax.axis_size(axis_name)
    gh, gw = tile_grid
    if gh % n:
        raise ValueError(
            f"spatial CLAHE needs tile rows {gh} divisible by mesh size {n}"
        )
    ghl = gh // n
    if h % ghl or W % gw:
        raise ValueError(
            f"spatial CLAHE needs divisible geometry: local rows {h} % {ghl} == 0 "
            f"and width {W} % {gw} == 0 (pad the frame before sharding)"
        )
    th, tw = h // ghl, W // gw
    area = th * tw

    # stages A+B: local tile rows only
    hists = _tile_hists(local, ghl, gw, th, tw, hist_size)
    luts = clahe_tile_luts(
        hists.reshape(B * ghl * gw, hist_size), area, clip_limit, hist_size
    ).reshape(B, ghl * gw, hist_size)
    # the one collective: every shard needs its neighbors' tile-row LUTs
    # for the bilinear blend near the shard boundary
    luts = jax.lax.all_gather(luts, axis_name, axis=1, tiled=True)  # [B, gh*gw, S]

    # blend coords: BOTH axes static host-side in strict NumPy f32 —
    # computing y·(1/th)−0.5 on device flips razor fracs on backends with
    # excess f32 precision (XLA:CPU, docs/DESIGN.md §12) whenever 1/th is
    # inexact (any th ∉ powers of 2).  axis_size is static under
    # shard_map, so the GLOBAL row table is host-computable; each shard
    # dynamic-slices its h rows at axis_index·h.
    x0, x1, fx = _interp_coords(W, tw, gw)
    x0 = jnp.asarray(x0)
    x1 = jnp.asarray(x1)
    fx = jnp.asarray(fx)[None, :]
    y0g, y1g, fyg = _interp_coords(h * n, th, gh)
    row0 = jax.lax.axis_index(axis_name) * h
    y0 = jax.lax.dynamic_slice(jnp.asarray(y0g, jnp.int32), (row0,), (h,))
    y1 = jax.lax.dynamic_slice(jnp.asarray(y1g, jnp.int32), (row0,), (h,))
    fy = jax.lax.dynamic_slice(jnp.asarray(fyg), (row0,), (h,))[:, None]

    return jax.vmap(
        lambda img, lt: blend_tile_luts(
            img, lt.reshape(-1), y0, y1, fy, x0, x1, fx, gw, hist_size
        )
    )(local, luts)


def _local_op(fn):
    """Adapt a purely-pointwise planes op (no cross-row/cross-shard state)
    to the spatial registry signature — it ignores ``axis_name``."""

    def run(local, axis_name: str = "y", **kw):
        del axis_name
        return fn(local, **kw)

    return run


def _equalize_hist_global_spatial(local, axis_name: str = "y", **kw):
    """Video-consistent pooled hist-eq over rows × frames × shards: the
    existing psum path pools across any named axis, so spatial reuse is
    direct (channels= grouping still applies along the local planes dim)."""
    from imageenhancement_mp_tpu.ops.histogram import equalize_hist_global_planes

    return equalize_hist_global_planes(local, axis_name=axis_name, **kw)


def _threshold_pointwise(planes, **kw):
    from imageenhancement_mp_tpu.ops.threshold import threshold_planes

    return threshold_planes(planes, **kw)


def _spatial_registry():
    from imageenhancement_mp_tpu.ops.pointwise import (
        convert_scale_abs_planes,
        gamma_planes,
        log_planes,
    )

    return {
        # pointwise: no cross-shard state, the planes op runs as-is
        "gamma": _local_op(gamma_planes),
        "log_transform": _local_op(log_planes),
        "convert_scale_abs": _local_op(convert_scale_abs_planes),
        "threshold": _local_op(_threshold_pointwise),
        # pooled statistics / halo ops: the spatial twins
        "contrast_stretch": contrast_stretch_spatial,
        "equalize_hist": equalize_hist_spatial,
        "equalize_hist_global": _equalize_hist_global_spatial,
        "clahe": clahe_spatial,
        "gaussian_blur": gaussian_blur_spatial,
        "box_blur": box_blur_spatial,
        "bilateral": bilateral_spatial,
        "adaptive_threshold": adaptive_threshold_spatial,
        "erode": erode_spatial,
        "dilate": dilate_spatial,
        "morphology": morphology_spatial,
        "sobel": sobel_spatial,
        "filter2d": filter2d_spatial,
        "laplacian_sharpen": laplacian_sharpen_spatial,
        "unsharp_mask": unsharp_mask_spatial,
        "median_blur": median_blur_spatial,
        # geometry (round 3): output-row redistribution
        "resize": resize_spatial,
        "warp_affine": warp_affine_spatial,
        "remap": remap_spatial,
        "canny": canny_spatial,
    }


SPATIAL_OP_REGISTRY: dict = {}


def make_spatial_pipeline(
    stages,
    mesh: Mesh,
    axis_name: str = "y",
    batch_axis: str | None = None,
) -> Callable:
    """Row-sharded twin of ``pipeline.make_pipeline``: the same stage specs
    (``name`` or ``(name, kwargs)`` drawn from ``pipeline.OP_REGISTRY``),
    compiled into ONE shard_map program over the mesh.

    Operates on planes ``[B, H, W]`` (use ``utils.shapes.as_planes`` for
    HWC inputs); ``H`` must be divisible by the ``axis_name`` mesh size.
    Example — the judged config-5 chain across 8 chips::

        pipe = make_spatial_pipeline([
            ("median_blur", {"ksize": 5}),
            ("clahe", {"clip_limit": 2.0, "tile_grid": (8, 8)}),
            ("unsharp_mask", {"amount": 1.0}),
        ], mesh)
        out = pipe(device_put_spatial(planes, mesh))
    """
    norm: list[tuple[str, tuple[tuple[str, object], ...]]] = []
    for s in stages:
        name, kwargs = (s, {}) if isinstance(s, str) else s
        if name not in SPATIAL_OP_REGISTRY:
            raise KeyError(
                f"unknown spatial op {name!r}; available: {sorted(SPATIAL_OP_REGISTRY)}"
            )
        norm.append((name, tuple(sorted(dict(kwargs).items()))))
    norm_t = tuple(norm)

    def run(local):
        for name, kw in norm_t:
            local = SPATIAL_OP_REGISTRY[name](local, axis_name=axis_name, **dict(kw))
        return local

    return shard_spatial(run, mesh, axis_name=axis_name, batch_axis=batch_axis)


# ---------------------------------------------------------------------------
# Geometry ops (round 3): OUTPUT-row redistribution over the mesh
# ---------------------------------------------------------------------------
#
# Stencils shard the INPUT rows and keep output rows aligned; geometry ops
# resample, so each shard owns an equal block of OUTPUT rows instead and
# fetches whatever input rows those need:
#
# * resize — input needs are PROPORTIONAL (output block [s·oh/n, …) reads
#   input ≈ [s·H/n, …) ± taps for every uniform scale), so a bounded halo
#   exchange suffices; the halo radius is computed statically from the
#   pinned coordinate tables and the per-shard tables are rebased onto the
#   halo-extended block (bit-identical arithmetic to the planes op).
# * warpAffine / remap — an affine map (or arbitrary runtime maps) can pull
#   input rows from anywhere, so the input is all_gather'd between devices and
#   each shard computes ONLY its own output rows (compute sharded n-ways,
#   coordinates sliced from the exact hybrid-f32 row tables).
# * canny — stencil stages use halos; the hysteresis flood is a CROSS-SHARD
#   FIXPOINT: flood locally to convergence, exchange one boundary row,
#   and repeat while a psum says any shard still grew.


def _row_slice(tab, idx, oloc):
    """Dynamic per-shard row slice of a host-built (oh, ...) table."""
    return jax.lax.dynamic_slice_in_dim(jnp.asarray(tab), idx * oloc, oloc, 0)


def _geom_split(local, dsize, axis_name):
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    h = local.shape[1]
    oh, ow = int(dsize[0]), int(dsize[1])
    if oh % n:
        raise ValueError(
            f"spatial geometry needs the output height {oh} divisible by the "
            f"{n}-shard mesh axis (pad dsize or reshard)")
    return n, idx, h, h * n, oh, ow, oh // n


def _vhalo(ylo, yhi, n, h, oloc):
    """Static halo radius: how far any shard's output block reaches past
    its own input share (from the global per-output-row input spans)."""
    r = 0
    for s in range(n):
        o0, o1 = s * oloc, (s + 1) * oloc
        r = max(r, s * h - int(ylo[o0:o1].min()),
                int(yhi[o0:o1].max()) - ((s + 1) * h - 1))
    return max(r, 0)


def resize_spatial(local, dsize, interpolation: str = "linear",
                   axis_name: str = "y"):
    """``cv2.resize`` on row-sharded planes — bit-identical to
    :func:`ops.resize.resize_planes` on the gathered frame (each shard
    produces output rows ``[idx·oh/n, (idx+1)·oh/n)``)."""
    from imageenhancement_mp_tpu.ops.resize import (_area_weights, _cubic,
                                                    _cubic_tables, _fixed_coeffs,
                                                    _linear_float, _linear_u8,
                                                    _round_cast, resize_planes)
    from imageenhancement_mp_tpu.ref.ops import resize_lin_tables
    from imageenhancement_mp_tpu.utils.ranges import int_bounds

    n, idx, h, H, oh, ow, oloc = _geom_split(local, dsize, axis_name)
    W = local.shape[2]
    dt = local.dtype

    if interpolation == "nearest":
        ys = np.minimum((np.arange(oh) * (H / oh)).astype(np.int64), H - 1)
        xs = np.minimum((np.arange(ow) * (W / ow)).astype(np.int64), W - 1)
        r = _vhalo(ys, ys, n, h, oloc)
        ext = halo_exchange(local, r, axis_name, "edge")
        iy = _row_slice(ys.astype(np.int32), idx, oloc) - (idx * h - r)
        return jnp.take(jnp.take(ext, iy, axis=-2), xs, axis=-1)

    if interpolation == "cubic":
        fixed = dt == jnp.uint8
        yi, yc = _cubic_tables(H, oh, fixed=fixed)
        r = _vhalo(yi.min(axis=1), yi.max(axis=1), n, h, oloc)
        ext = halo_exchange(local, r, axis_name, "edge")
        yi_l = _row_slice(yi.astype(np.int32), idx, oloc) - (idx * h - r)
        yc_l = _row_slice(yc, idx, oloc)
        return _cubic(ext, oh, ow, ytab=(yi_l, yc_l))

    if interpolation == "lanczos4":
        from imageenhancement_mp_tpu.ops.resize import (_lanczos,
                                                        _lanczos_tables)

        fixed = dt == jnp.uint8
        yi, yc = _lanczos_tables(H, oh, fixed=fixed)
        r = _vhalo(yi.min(axis=1), yi.max(axis=1), n, h, oloc)
        ext = halo_exchange(local, r, axis_name, "edge")
        yi_l = _row_slice(yi.astype(np.int32), idx, oloc) - (idx * h - r)
        yc_l = _row_slice(yc, idx, oloc)
        return _lanczos(ext, oh, ow, ytab=(yi_l, yc_l))

    if interpolation == "area":
        if H % oh == 0 and W % ow == 0 and H >= oh and W >= ow:
            # integer factors: cell rows never straddle a shard boundary
            # (h = (H//oh)·oloc), so the planes op IS the local op
            return resize_planes(local, (oloc, ow), "area")
        if H >= oh and W >= ow:
            # general downscale: the two-matmul path with the shard's
            # Wy rows; Wy zero-padded by r columns per side so the slice
            # aligns with the halo-extended block (zero weight on any
            # synthesized halo row — exactness preserved)
            wy = _area_weights(H, oh)
            nz_lo = np.array([np.flatnonzero(row)[0] for row in wy])
            nz_hi = np.array([np.flatnonzero(row)[-1] for row in wy])
            r = _vhalo(nz_lo, nz_hi, n, h, oloc)
            ext = halo_exchange(local, r, axis_name, "edge")
            wy_pad = np.zeros((oh, H + 2 * r), np.float32)
            wy_pad[:, r:H + r] = wy.astype(np.float32)
            wy_loc = jax.lax.dynamic_slice(
                jnp.asarray(wy_pad), (idx * oloc, idx * h), (oloc, h + 2 * r))
            wx = _area_weights(W, ow).T.astype(np.float32)
            cell = np.float32(1.0 / ((H / oh) * (W / ow)))
            v = jnp.einsum("oh,nhw,wp->nop", wy_loc, ext.astype(jnp.float32),
                           wx, precision=jax.lax.Precision.HIGHEST) * cell
            return _round_cast(v, dt)
        # any-upscale-axis fallback: the linear machinery with AREA coords
        area_flag = True
    elif interpolation == "linear":
        area_flag = False
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")

    iy0, iy1, ry = resize_lin_tables(H, oh, area_flag)
    r = _vhalo(np.minimum(iy0, iy1), np.maximum(iy0, iy1), n, h, oloc)
    ext = halo_exchange(local, r, axis_name, "edge")
    off = idx * h - r
    l0 = _row_slice(iy0.astype(np.int32), idx, oloc) - off
    l1 = _row_slice(iy1.astype(np.int32), idx, oloc) - off
    if dt == jnp.uint8:
        cy1, cy2 = _fixed_coeffs(ry)
        return _linear_u8(ext, oh, ow, area_flag,
                          ytab=(l0, l1, _row_slice(cy1, idx, oloc),
                                _row_slice(cy2, idx, oloc)))
    ry_l = _row_slice(ry.astype(np.float32), idx, oloc)
    return _round_cast(_linear_float(ext, oh, ow, area_flag,
                                     ytab=(l0, l1, ry_l)), dt)


def _warp_coords_rows(Mi, oh, ow, idx, oloc):
    """The exact hybrid-f32 warp coordinate field for output rows
    ``[idx·oloc, (idx+1)·oloc)`` (ref/ops.py ``warp_affine_coords_f32``
    semantics, rebuilt per shard via ``fma32``)."""
    from imageenhancement_mp_tpu.utils.fma import fma32

    Mf = np.asarray(Mi, np.float64).astype(np.float32)
    ys = np.arange(oh, dtype=np.float32)
    xs = jnp.asarray(np.arange(ow, dtype=np.float32))[None, :]
    body = jnp.asarray(np.arange(ow) < ow - (ow % 16))[None, :]
    out = []
    for r in (0, 1):
        a, b, c = Mf[r]
        crow = _row_slice((b * ys + c).astype(np.float32), idx, oloc)[:, None]
        brow = _row_slice((b * ys).astype(np.float32), idx, oloc)[:, None]
        sb = fma32(xs, jnp.float32(a), crow)
        st = fma32(xs, jnp.float32(a), brow) + jnp.float32(c)
        out.append(jnp.clip(jnp.where(body, sb, st), -2e9, 2e9))
    return out[0], out[1]


def warp_affine_spatial(local, M, dsize, interpolation: str = "linear",
                        border: str = "constant", border_value: float = 0.0,
                        inverse_map: bool = False, axis_name: str = "y"):
    """``cv2.warpAffine`` on row-sharded planes — bit-identical to
    :func:`ops.warp.warp_affine_planes` on the gathered frame.

    The input is ``all_gather``'d (an affine map can read rows from
    anywhere); each shard samples only its own output-row block with the
    exact per-row coordinate tables, so compute scales n-ways.
    cubic/lanczos4 ride the same row split (cubic through the warp
    kernel's own law, lanczos4 through remap's tab path with exactly
    re-quantizable maps) — u8 bit-identical to the single-chip op;
    float accumulation chains may differ by XLA's FMA-contraction
    tier."""
    from imageenhancement_mp_tpu.ops.warp import (_bilinear_tab_seq_device,
                                                  _gather, remap_planes)
    from imageenhancement_mp_tpu.ref.ops import (invert_affine,
                                                 warp_affine_coords_int,
                                                 warp_affine_nn_coords_int)
    from imageenhancement_mp_tpu.utils.ranges import int_bounds

    n, idx, h, H, oh, ow, oloc = _geom_split(local, dsize, axis_name)
    W = local.shape[2]
    if border not in ("constant", "replicate"):
        raise ValueError(f"unknown border {border!r} (constant|replicate)")
    if interpolation not in ("nearest", "linear", "cubic", "lanczos4"):
        raise ValueError(f"unknown interpolation {interpolation!r}")
    Mi = (np.asarray(M, np.float64).reshape(2, 3) if inverse_map
          else invert_affine(np.asarray(M, np.float64)))
    full = jax.lax.all_gather(local, axis_name, axis=1, tiled=True)
    if interpolation == "cubic":
        # warp cubic's OWN law (plain-f32 coords + the keys kernel) —
        # remap's cubic uses different weights, so don't delegate
        from imageenhancement_mp_tpu.ops.warp import _cubic_keys_16tap_device
        from imageenhancement_mp_tpu.ref.ops import warp_affine_coords_cubic_f32
        from imageenhancement_mp_tpu.utils.ranges import int_bounds as _ib

        is_f32 = local.dtype == jnp.float32
        minv, maxv = (0, 0) if is_f32 else _ib(local.dtype)
        bv = (float(border_value) if is_f32 else
              float(np.clip(np.round(float(border_value)), minv, maxv)))
        sx_np, sy_np = warp_affine_coords_cubic_f32(Mi, oh, ow)
        sx = _row_slice(sx_np, idx, oloc)
        sy = _row_slice(sy_np, idx, oloc)
        ixf, iyf = jnp.floor(sx), jnp.floor(sy)
        ix0, iy0 = ixf.astype(jnp.int32), iyf.astype(jnp.int32)
        acc = _cubic_keys_16tap_device(
            lambda dy, dx: _gather(full, iy0 + dy, ix0 + dx, H, W, border,
                                   bv, minv, maxv).astype(jnp.float32),
            sx - ixf, sy - iyf)
        if is_f32:
            return acc
        return jnp.clip(jnp.round(acc), minv, maxv).astype(local.dtype)
    if interpolation == "lanczos4":
        # delegate to remap's lanczos path with exactly re-quantizable
        # maps: X/32 is f32-exact, so remap's round(m*32) rebuilds X
        X, Y = warp_affine_coords_int(Mi, oh, ow)
        Xl = _row_slice(np.clip(X, -2**25, 2**25).astype(np.float32) / np.float32(32),
                        idx, oloc)
        Yl = _row_slice(np.clip(Y, -2**25, 2**25).astype(np.float32) / np.float32(32),
                        idx, oloc)
        return remap_planes(full, Xl, Yl, "lanczos4", border, border_value)
    if local.dtype == jnp.int16:
        minv, maxv = int_bounds(local.dtype)
        bv = float(np.clip(np.round(float(border_value)), minv, maxv))
        if interpolation == "nearest":
            niy, nix = warp_affine_nn_coords_int(Mi, oh, ow)
            clip32 = lambda a: np.clip(a, -2**31, 2**31 - 1).astype(np.int32)
            return _gather(full, _row_slice(clip32(niy), idx, oloc),
                           _row_slice(clip32(nix), idx, oloc),
                           H, W, border, bv, minv, maxv)
        X, Y = warp_affine_coords_int(Mi, oh, ow)
        clip32 = lambda a: np.clip(a, -2**31, 2**31 - 1).astype(np.int32)
        Xl = _row_slice(clip32(X), idx, oloc)
        Yl = _row_slice(clip32(Y), idx, oloc)
        iy0, ix0 = Yl >> 5, Xl >> 5
        fx = (Xl & 31).astype(jnp.float32) * jnp.float32(1 / 32)
        fy = (Yl & 31).astype(jnp.float32) * jnp.float32(1 / 32)
        acc = _bilinear_tab_seq_device(
            lambda dy, dx: _gather(full, iy0 + dy, ix0 + dx, H, W, border, bv,
                                   minv, maxv).astype(jnp.float32), fx, fy)
        return jnp.clip(jnp.round(acc), minv, maxv).astype(local.dtype)
    sx, sy = _warp_coords_rows(Mi, oh, ow, idx, oloc)
    return remap_planes(full, sx, sy, interpolation, border, border_value)


def remap_spatial(local, map_x, map_y, interpolation: str = "linear",
                  border: str = "constant", border_value: float = 0.0,
                  axis_name: str = "y"):
    """``cv2.remap`` on row-sharded planes.  ``map_x``/``map_y`` are the
    LOCAL output-row blocks of the maps (shard them like the output);
    the input frame is ``all_gather``'d since runtime maps can read any
    row.  Bit-identical to ``remap_planes`` on the gathered frame."""
    from imageenhancement_mp_tpu.ops.warp import remap_planes

    full = jax.lax.all_gather(local, axis_name, axis=1, tiled=True)
    return remap_planes(full, map_x, map_y, interpolation, border, border_value)


def warp_polar_spatial(local, dsize, center, max_radius, log: bool = False,
                       inverse: bool = False, interpolation: str = "linear",
                       axis_name: str = "y"):
    """``cv2.warpPolar`` on row-sharded planes — each shard computes its
    own block of OUTPUT rows from its slice of the pinned coordinate
    maps (ref/ops.py _warp_polar_maps); the input frame is
    ``all_gather``'d like ``remap_spatial`` (polar reads are globally
    scattered), with the inverse's one-row angular wrap pad applied on
    the gathered frame.  Bit-identical to the single-chip op."""
    from imageenhancement_mp_tpu.ops.warp import remap_planes
    from imageenhancement_mp_tpu.ref.ops import _warp_polar_maps

    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    h = local.shape[1]
    H, W = h * n, local.shape[2]
    dw, dh = int(dsize[0]), int(dsize[1])
    if dh % n:
        raise ValueError(f"output height {dh} must divide the {n}-shard axis")
    mx, my = _warp_polar_maps((H, W), dsize, center, float(max_radius),
                              bool(log), bool(inverse))
    oloc = dh // n
    mx_l = _row_slice(mx, idx, oloc)
    my_l = _row_slice(my, idx, oloc)
    full = jax.lax.all_gather(local, axis_name, axis=1, tiled=True)
    if inverse:
        full = jnp.concatenate([full[:, -1:], full, full[:, :1]], axis=1)
    return remap_planes(full, mx_l, my_l, interpolation, "constant", 0.0)


def canny_spatial(local, threshold1: float, threshold2: float,
                  aperture_size: int = 3, l2_gradient: bool = False,
                  axis_name: str = "y"):
    """``cv2.Canny`` on row-sharded planes — bit-identical to
    :func:`ops.canny.canny_planes` on the gathered frame.

    Sobel and NMS use halo exchanges (replicate resp. zero borders, like
    cv2); the hysteresis flood is the cross-shard FIXPOINT: flood
    locally with the log-diameter while_loop, ppermute ONE boundary row
    each way, and repeat while a psum reports any shard still grew."""
    from imageenhancement_mp_tpu.ops.canny import (_dilate8, _nms_keep,
                                                   _sobel_replicate)

    if local.dtype != jnp.uint8:
        raise TypeError(f"cv2.Canny requires uint8 input, got {local.dtype}")
    if aperture_size not in (3, 5, 7):
        raise ValueError(f"aperture_size must be 3, 5 or 7, got {aperture_size}")
    r = aperture_size // 2
    ext = halo_exchange(local, r, axis_name, "edge")
    gx = _sobel_replicate(ext, 1, 0, aperture_size)[:, r:-r, :]
    gy = _sobel_replicate(ext, 0, 1, aperture_size)[:, r:-r, :]
    lo_t, hi_t = sorted((float(threshold1), float(threshold2)))
    if aperture_size == 7:
        lo_t, hi_t = lo_t / 16.0, hi_t / 16.0
    if l2_gradient:
        mag = gx * gx + gy * gy
        lo_i, hi_i = int(np.floor(lo_t * lo_t)), int(np.floor(hi_t * hi_t))
    else:
        mag = jnp.abs(gx) + jnp.abs(gy)
        lo_i, hi_i = int(np.floor(lo_t)), int(np.floor(hi_t))
    magv = halo_exchange(mag, 1, axis_name, "const", const_val=0)
    keep = _nms_keep(magv, gx, gy) & (mag > lo_i)
    strong = keep & (mag > hi_i)

    def outer(state):
        out, _ = state

        def inner(st):
            o, _ = st
            new = o | (keep & _dilate8(o))
            return new, jnp.any(new != o)

        out2, _ = jax.lax.while_loop(lambda s: s[1], inner,
                                     (out, jnp.bool_(True)))
        extm = halo_exchange(out2, 1, axis_name, "const", const_val=False)
        new = out2 | (keep & _dilate8(extm)[:, 1:-1, :])
        grew = jax.lax.psum(jnp.any(new != out2).astype(jnp.int32), axis_name)
        return new, grew > 0

    out, _ = jax.lax.while_loop(lambda s: s[1], outer,
                                (strong, jnp.bool_(True)))
    return jnp.where(out, jnp.uint8(255), jnp.uint8(0))


SPATIAL_OP_REGISTRY.update(_spatial_registry())
