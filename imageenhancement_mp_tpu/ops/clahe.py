"""CLAHE: contrast-limited adaptive histogram equalization.

Reference equivalent: ``cv2.createCLAHE(clip, grid).apply`` (SURVEY.md §2 #5,
§3.2, §8.3).  Three stages, mirroring the rebuild design:

  A. per-tile 256-bin histograms — tiles reshaped to ``[B·gh·gw, th·tw]``
     and histogrammed in one batched ``histogram_256`` call (exact);
  B. clip + redistribute + CDF + LUT — a tiny ``[T, 256]`` vectorized stage
     (int32 clip/redistribute; the LUT scale is f32, mirroring cv2);
  C. per-pixel bilinear blend of the 4 neighboring tile LUTs — one gather
     from the flattened ``[gh·gw·256]`` LUT table per corner, f32 blend,
     single final round (keeps the ±1 LSB budget; SURVEY.md §7).

Pinned cv2 quirks honored here (probes this session):
  * if any dim is non-divisible by the grid, BOTH dims are padded by
    ``tiles − size % tiles`` with REFLECT_101 (a divisible dim gains a full
    extra ``tiles`` pixels);
  * interpolation coords are ``y/tile − 0.5`` (no half-pixel offset), blend
    weights taken BEFORE index clamping;
  * ``clipAbs = max(int(clip·area/256), 1)``; residual redistribution adds
    +1 at bins ``0, step, 2·step, …`` with ``step = max(256//residual, 1)``.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["clahe_planes", "clahe_tile_luts", "blend_tile_luts"]


def _tile_hists(
    padded: jnp.ndarray, gh: int, gw: int, th: int, tw: int, hist_size: int = 256
) -> jnp.ndarray:
    """``[B, H, W]`` -> ``[B, gh·gw, hist_size]`` i32 per-tile histograms.

    uint8: every tile of every plane goes through ``histogram_256`` in one
    batched call.  uint16: a scatter-add per tile (the byte-split one-hots
    would be ~512 B/px).
    """
    B = padded.shape[0]
    tiles = (
        padded.reshape(B, gh, th, gw, tw)
        .transpose(0, 1, 3, 2, 4)
        .reshape(B * gh * gw, th * tw)
    )
    if hist_size == 256:
        from imageenhancement_mp_tpu.ops.histogram import histogram_256

        h = histogram_256(tiles)
    else:
        h = jax.vmap(
            lambda t: jnp.zeros((hist_size,), jnp.int32).at[t.astype(jnp.int32)].add(1)
        )(tiles)
    return h.reshape(B, gh * gw, hist_size)


def clahe_tile_luts(
    hists: jnp.ndarray, area: int, clip_limit: float, hist_size: int = 256
) -> jnp.ndarray:
    """Stage B: ``[T, S] i32`` hists -> ``[T, S]`` LUTs (SURVEY.md §8.3).

    ``hist_size`` S is 256 for uint8, 65536 for uint16 (cv2 convention).
    """
    h = hists
    maxv = hist_size - 1
    if clip_limit > 0:
        clip_abs = max(int(clip_limit * area / hist_size), 1)
        excess = jnp.sum(jnp.maximum(h - clip_abs, 0), axis=1, keepdims=True)
        h = jnp.minimum(h, clip_abs)
        h = h + excess // hist_size
        resid = excess % hist_size  # [T, 1]
        step = jnp.maximum(hist_size // jnp.maximum(resid, 1), 1)
        i = jnp.arange(hist_size, dtype=jnp.int32)[None, :]
        bump = ((i % step) == 0) & ((i // step) < resid)
        h = h + bump.astype(jnp.int32)
    cdf = jnp.cumsum(h, axis=1)
    # f32 scale, mirroring cv2's float lutScale (see ops/histogram.py)
    scale = jnp.float32(float(maxv)) / jnp.float32(area)
    lut = jnp.clip(jnp.round(cdf.astype(jnp.float32) * scale), 0, maxv)
    return lut.astype(jnp.uint8 if hist_size == 256 else jnp.uint16)


def _interp_coords(n: int, tile: int, ntiles: int):
    """Host-side (static) bilinear coords: idx0, idx1, frac per pixel row/col."""
    # mirror cv2's f32 evaluation: txf = x * (1.0f/tile) - 0.5f
    inv = np.float32(1.0) / np.float32(tile)
    f = np.arange(n, dtype=np.float32) * inv - np.float32(0.5)
    i0f = np.floor(f).astype(np.int64)
    frac = (f - i0f).astype(np.float32)
    i0 = np.clip(i0f, 0, ntiles - 1).astype(np.int32)
    i1 = np.clip(i0f + 1, 0, ntiles - 1).astype(np.int32)
    return i0, i1, frac


def blend_tile_luts(
    img: jnp.ndarray,
    flat_luts: jnp.ndarray,
    y0, y1, fy_col,
    x0, x1, fx_row,
    gw: int,
    hist_size: int,
) -> jnp.ndarray:
    """Stage C: bilinear blend of the 4 neighboring tile LUTs for one image.

    ``flat_luts``: the flattened ``[gh·gw·hist_size]`` LUT table;
    ``y0/y1/fy_col``: per-row tile indices + f32 fraction (column vectors
    ``[H, 1]`` for ``fy_col``); ``x0/x1/fx_row`` likewise per column.
    Shared by the single-device path and the spatially-sharded path
    (parallel/spatial.py), so the exactness-critical f32 association lives
    in exactly one place.
    """
    v = img.astype(jnp.int32)
    # flat index: (ty*gw + tx)*hist_size + v
    base00 = (y0[:, None] * gw + x0[None, :]) * hist_size
    base01 = (y0[:, None] * gw + x1[None, :]) * hist_size
    base10 = (y1[:, None] * gw + x0[None, :]) * hist_size
    base11 = (y1[:, None] * gw + x1[None, :]) * hist_size
    l00 = flat_luts[base00 + v].astype(jnp.float32)
    l01 = flat_luts[base01 + v].astype(jnp.float32)
    l10 = flat_luts[base10 + v].astype(jnp.float32)
    l11 = flat_luts[base11 + v].astype(jnp.float32)
    # same association as the oracle/cv2 float path.  XLA's CPU and GPU
    # codegen contract mul+add into FMA through these f32 chains
    # (optimization_barrier and --xla_allow_excess_precision=false do NOT
    # disable it), so the blend carries a ±1 budget (docs/PARITY.md).
    top = (1.0 - fx_row) * l00 + fx_row * l01
    bot = (1.0 - fx_row) * l10 + fx_row * l11
    out = (1.0 - fy_col) * top + fy_col * bot
    return jnp.clip(jnp.round(out), 0, hist_size - 1).astype(img.dtype)


def clahe_planes(
    planes: jnp.ndarray, clip_limit: float = 40.0, tile_grid: tuple[int, int] = (8, 8)
) -> jnp.ndarray:
    """``cv2.createCLAHE`` on uint8/uint16 planes ``[B, H, W]``.

    Within ±1 LSB of cv2: the stage-C blend can flip one LSB where XLA
    contracts ``mul+add`` into FMA, changing the f32 rounding sequence
    (docs/PARITY.md).  uint16 uses cv2's 65536-bin histogram."""
    if planes.dtype not in (jnp.uint8, jnp.uint16):
        raise TypeError(f"CLAHE supports uint8/uint16 (cv2 parity), got {planes.dtype}")
    hist_size = 65536 if planes.dtype == jnp.uint16 else 256
    B, H, W = planes.shape
    gh, gw = tile_grid
    if H % gh == 0 and W % gw == 0:
        th, tw = H // gh, W // gw
        pad_h = pad_w = 0
    else:
        pad_h = gh - (H % gh)
        pad_w = gw - (W % gw)
        th, tw = (H + pad_h) // gh, (W + pad_w) // gw
    area = th * tw

    y0, y1, fy = _interp_coords(H, th, gh)
    x0, x1, fx = _interp_coords(W, tw, gw)

    y0 = jnp.asarray(y0)
    y1 = jnp.asarray(y1)
    x0 = jnp.asarray(x0)
    x1 = jnp.asarray(x1)
    fy = jnp.asarray(fy)[:, None]
    fx = jnp.asarray(fx)[None, :]

    padded = (
        planes
        if pad_h == 0 and pad_w == 0
        else jnp.pad(planes, ((0, 0), (0, pad_h), (0, pad_w)), mode="reflect")
    )
    hists = _tile_hists(padded, gh, gw, th, tw, hist_size)
    luts = clahe_tile_luts(
        hists.reshape(B * gh * gw, hist_size), area, clip_limit, hist_size
    ).reshape(B, gh * gw * hist_size)
    return jax.vmap(
        lambda img, flat: blend_tile_luts(
            img, flat, y0, y1, fy, x0, x1, fx, gw, hist_size
        )
    )(planes, luts)
