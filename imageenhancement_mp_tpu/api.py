"""Public function-per-enhancement API (SURVEY.md §1b).

Mirrors the reference's per-op signatures (BASELINE.json:5) over batched
arrays: every function accepts ``[H,W]``, ``[H,W,C]``, ``[N,H,W]`` or
``[N,H,W,C]`` uint8 and applies the enhancement per plane (per image ×
channel), exactly like per-image/per-channel OpenCV calls — but jit-compiled
and vmap-batched on device.

The whole wrapper body (shape canonicalization + op + restore) runs inside
one jitted program per (op, static-params, input-shape), so the HWC↔planes
transposes fuse into the op instead of being separate device passes.

Every function takes ``channels_last=True``: set it False to force a 3-D
input to be read as ``[N, H, W]`` grayscale frames even when W ≤ 4 (the
one ambiguous case — see utils/shapes.py).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from imageenhancement_mp_tpu.ops import OP_REGISTRY, apply_lut_planes, laplacian_planes
from imageenhancement_mp_tpu.utils.shapes import as_planes, treat_as_hwc

__all__ = [
    "adaptive_threshold",
    "add_weighted",
    "apply_lut",
    "bilateral_filter",
    "blend_linear",
    "box_blur",
    "convert_scale_abs",
    "cvt_color",
    "cvt_gray",
    "dilate",
    "distance_transform",
    "equalize_luma",
    "erode",
    "filter2d",
    "morphology_ex",
    "pyr_down",
    "pyr_up",
    "resize",
    "flip",
    "flood_fill",
    "rotate",
    "transpose",
    "warp_affine",
    "warp_perspective",
    "get_perspective_transform",
    "get_affine_transform",
    "remap",
    "match_template",
    "min_max_loc",
    "get_rect_sub_pix",
    "corner_sub_pix",
    "calc_optical_flow_pyr_lk",
    "hough_lines_p",
    "find_contours",
    "contour_area",
    "arc_length",
    "bounding_rect",
    "contour_moments",
    "moments",
    "hu_moments",
    "match_shapes",
    "convex_hull",
    "is_contour_convex",
    "point_polygon_test",
    "convexity_defects",
    "approx_poly_dp",
    "min_area_rect",
    "box_points",
    "min_enclosing_circle",
    "fit_line",
    "fit_ellipse",
    "mean_shift",
    "pyr_mean_shift_filtering",
    "cam_shift",
    "get_gaussian_kernel",
    "get_deriv_kernels",
    "add",
    "subtract",
    "absdiff",
    "multiply",
    "divide",
    "bitwise_and",
    "bitwise_or",
    "bitwise_xor",
    "bitwise_not",
    "minimum",
    "maximum",
    "compare",
    "integral",
    "apply_color_map",
    "mean_std_dev",
    "psnr",
    "norm",
    "compare_hist",
    "canny",
    "connected_components",
    "undistort",
    "init_undistort_rectify_map",
    "fast_nl_means_denoising",
    "sep_filter2d",
    "box_filter",
    "calc_back_project",
    "get_structuring_element",
    "gabor_kernel",
    "corner_harris",
    "corner_min_eigen_val",
    "good_features_to_track",
    "get_rotation_matrix_2d",
    "histogram",
    "hough_lines",
    "gamma",
    "log_transform",
    "contrast_stretch",
    "equalize_hist",
    "clahe",
    "clahe_lab",
    "gaussian_blur",
    "laplacian",
    "laplacian_sharpen",
    "scharr",
    "sobel",
    "spatial_gradient",
    "sqr_box_filter",
    "threshold",
    "unsharp_mask",
    "median_blur",
]


def _check_u8(img) -> None:
    if img.dtype != jnp.uint8:
        raise TypeError(f"expected uint8 image array, got {img.dtype}")


def _check_image_dtype(img, allow_i16: bool = False) -> None:
    ok = (jnp.uint8, jnp.uint16, jnp.float32) + ((jnp.int16,) if allow_i16 else ())
    if img.dtype not in ok:
        raise TypeError(
            f"expected uint8/uint16{'/int16' if allow_i16 else ''}/float32 "
            f"image array, got {img.dtype}"
        )


@lru_cache(maxsize=None)
def _jitted(op_name: str, static_items: tuple, channels_last: bool) -> callable:
    planes_fn = OP_REGISTRY[op_name] if op_name in OP_REGISTRY else None
    kwargs = dict(static_items)

    @jax.jit
    def run(img):
        planes, restore = as_planes(img, channels_last=channels_last)
        return restore(planes_fn(planes, **kwargs))

    return run


_U8_ONLY = {"equalize_hist", "equalize_hist_global"}  # cv2.equalizeHist is 8-bit only
_NO_FLOAT = {"clahe"}                                 # cv2 CLAHE: uint8/uint16 only
# ops where cv2 has a CV_16S path (filters, addWeighted, normalize,
# convertScaleAbs) — everything else rejects int16 like cv2 does
_I16_OK = {
    "gaussian_blur",
    "box_blur",
    "median_blur",
    "erode",
    "dilate",
    "morphology",
    "sobel",
    "filter2d",
    "box_filter",
    "pyr_down",
    "pyr_up",
    "resize",
    "flip",
    "rotate",
    "transpose",
    "warp_affine",
    "warp_perspective",
    "warp_polar",
    "match_template",
    "undistort",
    "laplacian_sharpen",
    "unsharp_mask",
    "contrast_stretch",
    "convert_scale_abs",
}


def _apply(op_name: str, img, channels_last: bool = True, **static):
    if op_name in _U8_ONLY:
        _check_u8(img)
    elif op_name in _NO_FLOAT:
        if img.dtype not in (jnp.uint8, jnp.uint16):
            raise TypeError(f"expected uint8 or uint16 image array, got {img.dtype}")
    else:
        _check_image_dtype(img, allow_i16=op_name in _I16_OK)
    return _jitted(op_name, tuple(sorted(static.items())), bool(channels_last))(img)


@lru_cache(maxsize=None)
def _hist_jit(channels_last: bool):
    from imageenhancement_mp_tpu.ops.histogram import histogram_256

    @jax.jit
    def run(img):
        planes, _ = as_planes(img, channels_last=channels_last)
        return histogram_256(planes)

    return run


@lru_cache(maxsize=None)
def _apply_lut_jit(channels_last: bool):
    @jax.jit
    def run(img, lut):
        planes, restore = as_planes(img, channels_last=channels_last)
        return restore(apply_lut_planes(planes, lut))

    return run


def apply_lut(img, lut, channels_last: bool = True):
    """``cv2.LUT``: gather through a 256-entry table (exact).

    ``lut`` may be ``[256]`` (shared) or ``[B, 256]`` with one table per
    plane (B = N·C in canonical plane order).
    """
    _check_u8(img)
    return _apply_lut_jit(bool(channels_last))(img, jnp.asarray(lut, jnp.uint8))


def gamma(img, gamma_value: float, channels_last: bool = True):
    """Power-law transform ``s = 255·(r/255)^γ`` via static LUT (exact)."""
    return _apply("gamma", img, channels_last, gamma=float(gamma_value))


def log_transform(img, channels_last: bool = True):
    """Log transform ``s = (255/log 256)·log(1+r)`` via static LUT (exact)."""
    return _apply("log_transform", img, channels_last)


def convert_scale_abs(img, alpha: float = 1.0, beta: float = 0.0, channels_last: bool = True):
    """``cv2.convertScaleAbs(src, alpha, beta)`` per plane.

    Always returns uint8 saturated at 255, like cv2, for any input dtype
    (exact for integer inputs; float32 ±1 at f32 round ties)."""
    return _apply("convert_scale_abs", img, channels_last, alpha=float(alpha), beta=float(beta))


def histogram(img, channels_last: bool = True):
    """Per-plane histogram (``cv2.calcHist`` ≡ bincount — exact).

    256 bins for uint8, 65536 for uint16; int32 counts shaped like the
    input's plane structure: [S], [C,S], [N,S], or [N,C,S].
    """
    if img.dtype not in (jnp.uint8, jnp.uint16):
        raise TypeError(f"expected uint8 or uint16 image array, got {img.dtype}")
    h = _hist_jit(bool(channels_last))(img)
    nd = img.ndim
    if nd == 2:
        return h[0]
    if nd == 3:
        return h  # [C, S] or [N, S] — plane order matches as_planes
    n, _, _, c = img.shape
    return h.reshape(n, c, h.shape[-1])


def contrast_stretch(img, out_range: tuple[float, float] = (0.0, 255.0), channels_last: bool = True):
    """``cv2.normalize(NORM_MINMAX, α, β)`` per plane (exact)."""
    return _apply(
        "contrast_stretch", img, channels_last,
        out_range=(float(out_range[0]), float(out_range[1])),
    )


def equalize_hist(img, per_frame: bool = True, per_channel: bool = True, channels_last: bool = True):
    """``cv2.equalizeHist`` (exact, 8-bit).

    ``per_frame=True`` (default) equalizes each plane independently like
    per-image cv2 calls.  ``per_frame=False`` pools the histogram/LUT
    across the batch — flicker-free equalization for video batches (see
    also parallel.equalize_hist_global_sharded for the multi-chip psum
    version).  In pooled mode, ``per_channel=True`` (default) pools each
    channel separately across frames so R/G/B get their own LUTs;
    ``per_channel=False`` pools ONE histogram over every plane (channels
    share a LUT — only meaningful for channel-comparable data).
    """
    if per_frame:
        return _apply("equalize_hist", img, channels_last)
    channels = 1
    if per_channel and (img.ndim == 4 or treat_as_hwc(img, channels_last)):
        channels = img.shape[-1]
    return _apply("equalize_hist_global", img, channels_last, channels=channels)


def clahe(img, clip_limit: float = 40.0, tile_grid: tuple[int, int] = (8, 8), channels_last: bool = True):
    """``cv2.createCLAHE(clip_limit, grid)`` per plane (±1 LSB, usually exact).

    ``tile_grid`` is (rows, cols); cv2's Size argument is (cols, rows).
    """
    return _apply(
        "clahe", img, channels_last,
        clip_limit=float(clip_limit), tile_grid=tuple(tile_grid),
    )


def gaussian_blur(img, ksize=5, sigma: float = 0.0, sigma_y: float = 0.0, channels_last: bool = True):
    """``cv2.GaussianBlur(Size(kw,kh), σX, σY)`` — cv2's full surface.

    ``ksize``: int (square) or (rows, cols) — NOTE cv2's Size argument is
    (cols, rows); a 0 dimension is derived from its σ like cv2.
    ``sigma_y`` ≤ 0 follows ``sigma`` (cv2 convention).
    Bit-exact for any odd ksize and ANY σ on uint8/uint16 (cv2's
    cumulative-quantized fixed-point taps — docs/PARITY.md).
    """
    ks = int(ksize) if isinstance(ksize, (int, np.integer)) else (int(ksize[0]), int(ksize[1]))
    return _apply(
        "gaussian_blur", img, channels_last,
        ksize=ks, sigma=float(sigma), sigma_y=float(sigma_y),
    )


@lru_cache(maxsize=None)
def _lap_jit(channels_last: bool, ksize: int = 1, delta: float = 0.0):
    @jax.jit
    def run(img):
        planes, restore = as_planes(img, channels_last=channels_last)
        return restore(laplacian_planes(planes, ksize, delta))

    return run


def laplacian(img, ksize: int = 1, delta: float = 0.0, channels_last: bool = True):
    """``cv2.Laplacian`` (exact; u8→int16, u16/i16→int32, f32→f32).
    ``ksize=1``: the 4-neighbor stencil; ``ksize≥3``: the Sobel-based
    form with raw-sum single saturation (pinned — docs/PARITY.md)."""
    _check_image_dtype(img, allow_i16=True)
    return _lap_jit(bool(channels_last), int(ksize), float(delta))(img)


def laplacian_sharpen(img, channels_last: bool = True):
    """Sharpen = saturate_u8(src − Laplacian(src)) (exact)."""
    return _apply("laplacian_sharpen", img, channels_last)


def unsharp_mask(img, amount: float = 1.0, ksize: int = 5, sigma: float = 0.0, channels_last: bool = True):
    """``cv2.addWeighted(src, 1+a, GaussianBlur(src), −a, 0)`` — exact for
    any ``amount`` and any σ on u8/u16 (cv2's two-FMA f32 chain,
    docs/PARITY.md)."""
    return _apply(
        "unsharp_mask", img, channels_last,
        amount=float(amount), ksize=int(ksize), sigma=float(sigma),
    )


def median_blur(img, ksize: int = 3, channels_last: bool = True):
    """``cv2.medianBlur`` (exact; border = replicate; any odd ksize ≥ 3 —
    k∈{3,5} matches cv2 for u8/u16, larger k verified for u8)."""
    return _apply("median_blur", img, channels_last, ksize=int(ksize))


_CVT_CODES = (
    "rgb2gray", "bgr2gray", "rgba2gray", "bgra2gray",
    "rgb2ycrcb", "bgr2ycrcb", "ycrcb2rgb", "ycrcb2bgr",
    "rgb2hsv", "bgr2hsv", "hsv2rgb", "hsv2bgr",
    "rgb2hls", "bgr2hls", "hls2rgb", "hls2bgr",
    "rgb2xyz", "bgr2xyz", "xyz2rgb", "xyz2bgr",
    "rgb2lab", "bgr2lab", "lab2rgb", "lab2bgr",
    "rgb2luv", "bgr2luv", "luv2rgb", "luv2bgr",
)


@lru_cache(maxsize=None)
def _cvt_color_jit(code: str):
    from imageenhancement_mp_tpu.ops.color import (
        cvt_gray_nhwc,
        hls_to_rgb_nhwc,
        hsv_to_rgb_nhwc,
        lab_to_rgb_nhwc,
        rgb_to_hls_nhwc,
        rgb_to_hsv_nhwc,
        rgb_to_lab_nhwc,
        rgb_to_xyz_nhwc,
        rgb_to_ycrcb_nhwc,
        xyz_to_rgb_nhwc,
        ycrcb_to_rgb_nhwc,
        luv_to_rgb_nhwc,
        rgb_to_luv_nhwc,
    )

    @jax.jit
    def run(img):
        if code.endswith("2gray"):
            return cvt_gray_nhwc(img, "bgr" if code.startswith("b") else "rgb")
        if code.endswith("2ycrcb"):
            return rgb_to_ycrcb_nhwc(img, "bgr" if code.startswith("b") else "rgb")
        if code.endswith("2hsv"):
            return rgb_to_hsv_nhwc(img, "bgr" if code.startswith("b") else "rgb")
        if code.endswith("2hls"):
            return rgb_to_hls_nhwc(img, "bgr" if code.startswith("b") else "rgb")
        if code.startswith("hls"):
            return hls_to_rgb_nhwc(img, "bgr" if code.endswith("bgr") else "rgb")
        if code.endswith("2xyz"):
            return rgb_to_xyz_nhwc(img, "bgr" if code.startswith("b") else "rgb")
        if code.endswith("2lab"):
            return rgb_to_lab_nhwc(img, "bgr" if code.startswith("b") else "rgb")
        if code.endswith("2luv"):
            return rgb_to_luv_nhwc(img, "bgr" if code.startswith("b") else "rgb")
        if code.startswith("luv"):
            return luv_to_rgb_nhwc(img, "bgr" if code.endswith("bgr") else "rgb")
        if code.startswith("hsv"):
            return hsv_to_rgb_nhwc(img, "bgr" if code.endswith("bgr") else "rgb")
        if code.startswith("xyz"):
            return xyz_to_rgb_nhwc(img, "bgr" if code.endswith("bgr") else "rgb")
        if code.startswith("lab"):
            return lab_to_rgb_nhwc(img, "bgr" if code.endswith("bgr") else "rgb")
        return ycrcb_to_rgb_nhwc(img, "bgr" if code.endswith("bgr") else "rgb")

    return run


def cvt_color(img, code: str):
    """``cv2.cvtColor`` — codes: ``{rgb,bgr,rgba,bgra}2gray``,
    ``{rgb,bgr}2ycrcb``, ``ycrcb2{rgb,bgr}``, ``{rgb,bgr}2hsv``,
    ``hsv2{rgb,bgr}``, ``{rgb,bgr}2hls``, ``hls2{rgb,bgr}``,
    ``{rgb,bgr}2{xyz,lab}``, ``{xyz,lab}2{rgb,bgr}`` on ``[..,H,W,C]``.
    Gray/YCrCb: u8/u16 exact (pinned fixed point), f32 exact on cv2's
    SIMD vector body.  HSV: u8 only; forward exact (12-bit fixed
    point), inverse = cv2's SIMD-body model (its own scalar tail
    differs ±1 — docs/PARITY.md).  HLS/XYZ/Lab: u8 EXHAUSTIVELY
    bit-exact both directions (all 2^24 inputs).  Luv: u8 via cv2's
    packed trilinear path (structure pinned; ±1 LSB on ≲3.5 % px fwd,
    ≲0.02 % >1 inv — the softfloat LUT-build residue, docs/PARITY.md);
    f32 both directions via the float formulas (~1e-4 relative)."""
    _check_image_dtype(img)
    code = str(code).lower()
    if code not in _CVT_CODES:
        raise ValueError(f"code must be one of {_CVT_CODES}, got {code!r}")
    if img.ndim not in (3, 4):
        raise ValueError(f"expected [H,W,C] or [N,H,W,C], got {img.shape}")
    return _cvt_color_jit(code)(img)


@lru_cache(maxsize=None)
def _equalize_luma_jit(order: str):
    from imageenhancement_mp_tpu.ops.color import rgb_to_ycrcb_nhwc, ycrcb_to_rgb_nhwc
    from imageenhancement_mp_tpu.ops.histogram import equalize_hist_planes

    @jax.jit
    def run(img):
        ycc = rgb_to_ycrcb_nhwc(img, order)
        y = equalize_hist_planes(ycc[..., 0].reshape((-1,) + ycc.shape[-3:-1]))
        y = y.reshape(ycc.shape[:-1])
        return ycrcb_to_rgb_nhwc(
            jnp.concatenate([y[..., None], ycc[..., 1:]], axis=-1), order
        )

    return run


def equalize_luma(img, order: str = "rgb"):
    """The classic COLOR histogram equalization: RGB → YCrCb, equalize the
    luma plane, convert back — contrast without hue shifts (per-channel
    ``equalize_hist`` distorts colors).  uint8 ``[H,W,3]`` / ``[N,H,W,3]``;
    every stage is the exact pinned cv2 arithmetic."""
    if img.dtype != jnp.uint8:
        raise TypeError(f"equalize_luma is uint8 (cv2.equalizeHist is 8-bit), got {img.dtype}")
    if img.ndim not in (3, 4) or img.shape[-1] != 3:
        raise ValueError(f"expected [H,W,3] or [N,H,W,3], got {img.shape}")
    return _equalize_luma_jit(str(order))(img)


@lru_cache(maxsize=None)
def _clahe_lab_jit(order: str, clip_limit: float, tile_grid):
    from imageenhancement_mp_tpu.ops.clahe import clahe_planes
    from imageenhancement_mp_tpu.ops.color import lab_to_rgb_nhwc, rgb_to_lab_nhwc

    @jax.jit
    def run(img):
        lab = rgb_to_lab_nhwc(img, order)
        L = clahe_planes(lab[..., 0].reshape((-1,) + lab.shape[-3:-1]),
                         clip_limit=clip_limit, tile_grid=tile_grid)
        L = L.reshape(lab.shape[:-1])
        return lab_to_rgb_nhwc(
            jnp.concatenate([L[..., None], lab[..., 1:]], axis=-1), order)

    return run


def clahe_lab(img, clip_limit: float = 2.0, tile_grid: tuple[int, int] = (8, 8),
              order: str = "rgb"):
    """COLOR CLAHE the canonical way: RGB -> Lab (cv2's exhaustively
    pinned u8 fixed point), CLAHE on the L (lightness) plane only,
    convert back — local contrast without the hue/chroma shifts that
    per-channel CLAHE causes.  The Lab legs are bit-exact vs cv2 and
    the CLAHE core is the pinned cv2 algorithm, so the composite equals
    the cv2 recipe ``cvtColor -> CLAHE-on-L -> cvtColor`` bitwise
    (modulo CLAHE's documented +/-1 CPU-tier caveat).

    uint8 ``[H,W,3]`` / ``[N,H,W,3]``; ``tile_grid`` is (rows, cols).
    """
    if img.dtype != jnp.uint8:
        raise TypeError(f"clahe_lab is uint8 (cv2 Lab u8 path), got {img.dtype}")
    if img.ndim not in (3, 4) or img.shape[-1] != 3:
        raise ValueError(f"expected [H,W,3] or [N,H,W,3], got {img.shape}")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    return _clahe_lab_jit(str(order), float(clip_limit), tuple(tile_grid))(img)


@lru_cache(maxsize=None)
def _thresh_jit(maxval: float, type: str, channels_last: bool, thresh):
    """thresh: a float (static, shared) or None (per-plane array argument)."""
    from imageenhancement_mp_tpu.ops.threshold import threshold_planes

    if thresh is None:

        @jax.jit
        def run(img, t):
            planes, restore = as_planes(img, channels_last=channels_last)
            return restore(threshold_planes(planes, t, maxval, type))

    else:

        @jax.jit
        def run(img):
            planes, restore = as_planes(img, channels_last=channels_last)
            return restore(threshold_planes(planes, thresh, maxval, type))

    return run


def threshold(img, thresh: float = 0.0, maxval: float = 255.0, type: str = "binary",
              method: str | None = None, channels_last: bool = True):
    """``cv2.threshold(img, thresh, maxval, type)`` — exact; returns
    ``(ret, dst)`` like cv2.

    ``type``: binary | binary_inv | trunc | tozero | tozero_inv.
    ``method``: None | "otsu" | "triangle" — compute the threshold from
    each plane's histogram (uint8 only, like cv2; exact transcriptions of
    cv2's double recurrences).  On a batch, every plane gets its own
    threshold — ``ret`` is then an array shaped like the plane structure
    ([C], [N], or [N,C]) instead of cv2's scalar.
    """
    _check_image_dtype(img, allow_i16=True)
    if method is None:
        ret = float(thresh) if img.dtype == jnp.float32 else float(np.floor(float(thresh)))
        out = _thresh_jit(float(maxval), str(type), bool(channels_last), float(thresh))(img)
        return ret, out
    if method not in ("otsu", "triangle"):
        raise ValueError(f"method must be None, 'otsu' or 'triangle', got {method!r}")
    if img.dtype != jnp.uint8:
        raise TypeError(f"{method} threshold is uint8-only, like cv2")
    from imageenhancement_mp_tpu.ref.ops import otsu_threshold, triangle_threshold

    hists = np.asarray(_hist_jit(bool(channels_last))(img))  # [B, 256], plane order
    plane_px = int(np.prod(img.shape)) // hists.shape[0]  # static: no d2h
    scan = otsu_threshold if method == "otsu" else triangle_threshold
    ts = np.array(
        [scan(h, plane_px) if method == "otsu" else scan(h) for h in hists],
        dtype=np.int32,
    )
    out = _thresh_jit(float(maxval), str(type), bool(channels_last), None)(
        img, jnp.asarray(ts)
    )
    nd = img.ndim
    if nd == 2:
        ret = float(ts[0])
    elif nd == 3:
        ret = ts.astype(np.float64)  # [C] or [N], plane order == as_planes
    else:
        n, _, _, c = img.shape
        ret = ts.reshape(n, c).astype(np.float64)
    return ret, out


def sobel(img, dx: int = 1, dy: int = 0, ksize: int = 3, scale: float = 1.0,
          delta: float = 0.0, channels_last: bool = True):
    """``cv2.Sobel`` (``ksize=-1`` = Scharr) — REFLECT_101.  u8→int16
    (= cv2 CV_16S, exact for scale=1 incl. any delta); u16/i16→int32
    (exact — cv2 only offers a float destination there, and our integers
    agree with its f32 to 0.5 ULP); f32→f32.  ``scale ≠ 1`` follows
    cv2's float-kernel fold (scattered ±1 — docs/PARITY.md).  Integer
    inputs: ksize limited to the exact int32 range (u8 ≤ 11, 16-bit ≤ 7
    for first derivatives) — convert to f32 for larger kernels."""
    _check_image_dtype(img, allow_i16=True)
    return _apply(
        "sobel", img, channels_last,
        dx=int(dx), dy=int(dy), ksize=int(ksize),
        scale=float(scale), delta=float(delta),
    )


def scharr(img, dx: int = 1, dy: int = 0, scale: float = 1.0,
           delta: float = 0.0, channels_last: bool = True):
    """``cv2.Scharr`` — the 3×3 [3,10,3] derivative (see ``sobel``)."""
    return sobel(img, dx, dy, -1, scale, delta, channels_last)


def filter2d(img, kernel, delta: float = 0.0, channels_last: bool = True):
    """``cv2.filter2D(img, -1, kernel, delta=δ)`` — custom-kernel
    correlation (anchor kh//2, REFLECT_101).  Integer-valued kernels are
    exact on every dtype; float kernels exact on u8 (cv2's f64-equivalent
    path, via double-float device emulation) and ±1 on u16/i16 (cv2's own
    f32 accumulation); f32 at float tolerance.  Kernels ≤ 15×15."""
    _check_image_dtype(img, allow_i16=True)
    k = np.asarray(kernel, np.float64)
    if k.ndim != 2:
        raise ValueError(f"kernel must be 2-D, got shape {k.shape}")
    key = tuple(tuple(float(v) for v in row) for row in k)
    return _apply("filter2d", img, channels_last, kernel=key, delta=float(delta))


def pyr_down(img, channels_last: bool = True):
    """``cv2.pyrDown``: REFLECT_101 [1,4,6,4,1] blur + 2× decimation →
    ``ceil(H/2) × ceil(W/2)`` (exact u8/u16/i16; f32 at float tol)."""
    _check_image_dtype(img, allow_i16=True)
    return _apply("pyr_down", img, channels_last)


def pyr_up(img, channels_last: bool = True):
    """``cv2.pyrUp``: 2× zero-stuff + [1,4,6,4,1] blur → ``2H × 2W``
    (exact u8/u16/i16; f32 at float tol)."""
    _check_image_dtype(img, allow_i16=True)
    return _apply("pyr_up", img, channels_last)


def resize(img, dsize, interpolation: str = "linear", channels_last: bool = True):
    """``cv2.resize(img, (ow, oh), interpolation)`` — NOTE ``dsize`` is
    ``(oh, ow)`` row-major like the rest of this library.

    ``interpolation``: ``"nearest"`` (index-exact away from cv2's
    measure-zero boundary snaps — ref/ops.py ``resize``), ``"linear"``
    (u8 BIT-EXACT fixed-point; u16/i16 cv2-float-path ±1; f32 1-ulp),
    ``"area"`` (integer-factor exact incl. the 2x2 half-up fast path;
    general downscale runs as two weight matmuls)."""
    _check_image_dtype(img, allow_i16=True)
    return _apply("resize", img, channels_last,
                  dsize=(int(dsize[0]), int(dsize[1])),
                  interpolation=str(interpolation))


def flip(img, code: int = 0, channels_last: bool = True):
    """``cv2.flip``: 0 = vertical (rows), positive = horizontal (cols),
    negative = both — exact, any dtype."""
    _check_image_dtype(img, allow_i16=True)
    return _apply("flip", img, channels_last, code=int(code))


def rotate(img, code: str = "90cw", channels_last: bool = True):
    """``cv2.rotate``: ``90cw`` | ``180`` | ``90ccw`` — exact."""
    _check_image_dtype(img, allow_i16=True)
    return _apply("rotate", img, channels_last, code=str(code))


def transpose(img, channels_last: bool = True):
    """``cv2.transpose`` — exact."""
    _check_image_dtype(img, allow_i16=True)
    return _apply("transpose", img, channels_last)


def warp_affine(img, M, dsize, interpolation: str = "linear",
                border: str = "constant", border_value: float = 0.0,
                inverse_map: bool = False, channels_last: bool = True):
    """``cv2.warpAffine(img, M, (ow, oh), ...)`` — ``dsize`` is (oh, ow)
    row-major.  ``M`` is a static 2x3 matrix (recompiles per matrix).

    BIT-EXACT for every dtype (docs/PARITY.md round-3 re-pin): the
    hybrid f32 coordinate field + single-FMA lerp for u8/u16/f32, the
    legacy fixed-point coords with float tab weights for int16.
    CUBIC (INTER_CUBIC, cv2 5.0's new warp kernel, pinned): u8/u16
    BIT-EXACT, i16 razor +-1 (<0.05%), f32 bitwise on all interior +
    partial-border pixels (fully-outside <=1 ulp).  LANCZOS4 (legacy
    quantized tabs): u8/u16/i16 +-1 on <0.3% px, f32 ~1 ulp.
    ``border``: constant (with ``border_value``, saturated like cv2) or
    replicate.  ``inverse_map`` = cv2's WARP_INVERSE_MAP."""
    _check_image_dtype(img, allow_i16=True)
    Mt = tuple(tuple(float(v) for v in row)
               for row in np.asarray(M, np.float64).reshape(2, 3))
    return _apply("warp_affine", img, channels_last, M=Mt,
                  dsize=(int(dsize[0]), int(dsize[1])),
                  interpolation=str(interpolation), border=str(border),
                  border_value=float(border_value),
                  inverse_map=bool(inverse_map))


def warp_perspective(img, M, dsize, interpolation: str = "linear",
                     border: str = "constant", border_value: float = 0.0,
                     inverse_map: bool = False, channels_last: bool = True):
    """``cv2.warpPerspective(img, M, (ow, oh), ...)`` — ``dsize`` is
    (oh, ow) row-major.  ``M`` is a static 3x3 homography (recompiles
    per matrix).

    BIT-EXACT for every dtype (docs/PARITY.md): the perspective-divided
    hybrid f32 coordinate field + single-FMA lerp for u8/u16/f32 (the
    division happens at trace time in exactly cv2's f32 arithmetic);
    int16 uses cv2's legacy per-pixel f64 quantized path.  CUBIC
    (cv2 5.0's new warp kernel): cv2 divides with a hardware-dependent
    SIMD reciprocal, so the budgets are u8 +-1 on ~0.01% px, u16/i16
    +-1 on ~1.5% px, f32 <=1e-5 relative (docs/PARITY.md).  LANCZOS4
    (legacy quantized tabs): ints +-1 on <0.3% px, f32 ~1 ulp.  Matrix
    inversion is cv2's f64 cofactor expansion.
    ``get_perspective_transform``/``get_affine_transform`` build
    matrices from point pairs like cv2."""
    _check_image_dtype(img, allow_i16=True)
    Mt = tuple(tuple(float(v) for v in row)
               for row in np.asarray(M, np.float64).reshape(3, 3))
    return _apply("warp_perspective", img, channels_last, M=Mt,
                  dsize=(int(dsize[0]), int(dsize[1])),
                  interpolation=str(interpolation), border=str(border),
                  border_value=float(border_value),
                  inverse_map=bool(inverse_map))


def get_perspective_transform(src, dst):
    """``cv2.getPerspectiveTransform`` (4 point pairs -> 3x3 f64)."""
    from imageenhancement_mp_tpu.ref.ops import get_perspective_transform as g
    return g(src, dst)


def get_affine_transform(src, dst):
    """``cv2.getAffineTransform`` (3 point pairs -> 2x3 f64)."""
    from imageenhancement_mp_tpu.ref.ops import get_affine_transform as g
    return g(src, dst)


@lru_cache(maxsize=None)
def _remap_jit(interpolation: str, border: str, border_value: float,
               channels_last: bool):
    from imageenhancement_mp_tpu.ops import remap_planes

    @jax.jit
    def run(img, mx, my):
        planes, restore = as_planes(img, channels_last=channels_last)
        return restore(remap_planes(planes, mx, my, interpolation, border,
                                    border_value))

    return run


def remap(img, map_x, map_y, interpolation: str = "linear",
          border: str = "constant", border_value: float = 0.0,
          channels_last: bool = True):
    """``cv2.remap`` with float32 coordinate maps (runtime arrays — one
    compile per (interpolation, border) combination, any maps).

    Same budgets as ``warp_affine``: u8/f32 exact (razor ±1), u16/i16
    ±1, NEAREST exact.  CUBIC (INTER_CUBIC, all dtypes): u8 exact
    (razor-tie ±1 class), u16/i16 ±1, f32 ~1 ulp vs cv2; on the CPU
    backend the device may differ from the oracle by ±1 LSB (XLA FMA
    contraction).  LANCZOS4: cv2's
    quantized 1/32-cell tabs pinned bitwise — u8 through the 2^15 int
    tab (device == oracle bitwise), u8/u16/i16 ±1 vs cv2 on ≲0.3 % px
    (tab-correction ambiguity), f32 ~1 ulp.  The maps are shared
    across every plane of a batch (cv2 semantics for multi-channel
    images)."""
    _check_image_dtype(img, allow_i16=True)
    return _remap_jit(str(interpolation), str(border), float(border_value),
                      bool(channels_last))(
        img, jnp.asarray(map_x, jnp.float32), jnp.asarray(map_y, jnp.float32))


def warp_polar(img, dsize, center, max_radius: float, log: bool = False,
               inverse: bool = False, interpolation: str = "linear",
               channels_last: bool = True):
    """``cv2.warpPolar`` (with ``WARP_FILL_OUTLIERS``) — BIT-EXACT:
    cv2's coordinate maps are reproduced on the host (forward: f32
    radius table × f64 rays + f32 center; inverse: f32 cartToPolar with
    the pinned single-FMA fastAtan2 polynomial and cv2's one-row
    angular BORDER_WRAP pad — ref/ops.py _warp_polar_maps) and fed to
    the bit-exact ``remap``.  ``log=True`` = semilog
    (``WARP_POLAR_LOG``); ``inverse=True`` maps a polar image back to
    cartesian (``WARP_INVERSE_MAP``).  One documented budget: the
    semilog inverse's log32f is build-dependent inside cv2 itself —
    u8/u16 stay bit-exact, f32-linear within 6e-6 (ref docstring).

    The geometry is static, so the whole op — wrap pad, map bake,
    gather — lives in one jitted planes fn (ops/warp.py
    ``warp_polar_planes``)."""
    return _apply("warp_polar", img, channels_last,
                  dsize=(int(dsize[0]), int(dsize[1])),
                  center=(float(center[0]), float(center[1])),
                  max_radius=float(max_radius), log=bool(log),
                  inverse=bool(inverse), interpolation=str(interpolation))


@lru_cache(maxsize=None)
def _arith_jit(op: str, scale: float, two_args: bool):
    from imageenhancement_mp_tpu.ops import arith_arrays

    if two_args:
        @jax.jit
        def run(a, b):
            return arith_arrays(op, a, b, scale)
    else:
        @jax.jit
        def run(a):
            return arith_arrays(op, a)
    return run


def _arith(op, a, b=None, scale=1.0):
    _check_image_dtype(a, allow_i16=True)
    if b is None:
        return _arith_jit(op, float(scale), False)(a)
    return _arith_jit(op, float(scale), True)(a, b)


def add(a, b):
    """``cv2.add`` — saturating elementwise sum (exact)."""
    return _arith("add", a, b)


def subtract(a, b):
    """``cv2.subtract`` — saturating difference (exact)."""
    return _arith("subtract", a, b)


def absdiff(a, b):
    """``cv2.absdiff`` — |a−b| saturated (exact)."""
    return _arith("absdiff", a, b)


def multiply(a, b, scale: float = 1.0):
    """``cv2.multiply(a, b, scale)`` — exact incl. cv2's INT_MIN
    overflow quirk (huge products saturate to the dtype MIN); f32
    fractional scales at 1 ulp (docs/PARITY.md)."""
    return _arith("multiply", a, b, scale)


def divide(a, b, scale: float = 1.0):
    """``cv2.divide(a, b, scale)`` — b==0 → 0 for integer dtypes (f32:
    IEEE ±inf/nan); razor half-even ties ±1 on device."""
    return _arith("divide", a, b, scale)


def bitwise_and(a, b):
    """``cv2.bitwise_and`` — exact (integer dtypes)."""
    return _arith("bitwise_and", a, b)


def bitwise_or(a, b):
    """``cv2.bitwise_or`` — exact."""
    return _arith("bitwise_or", a, b)


def bitwise_xor(a, b):
    """``cv2.bitwise_xor`` — exact."""
    return _arith("bitwise_xor", a, b)


def bitwise_not(a):
    """``cv2.bitwise_not`` — exact."""
    return _arith("bitwise_not", a)


def minimum(a, b):
    """``cv2.min`` — exact."""
    return _arith("minimum", a, b)


def maximum(a, b):
    """``cv2.max`` — exact."""
    return _arith("maximum", a, b)


def compare(a, b, op: str = "gt"):
    """``cv2.compare`` — uint8 0/255 mask; op: eq/gt/ge/lt/le/ne."""
    if op not in ("eq", "gt", "ge", "lt", "le", "ne"):
        raise ValueError(f"unknown compare op {op!r}")
    return _arith(op, a, b)


@lru_cache(maxsize=None)
def _integral_jit(sq: bool, channels_last: bool):
    from imageenhancement_mp_tpu.ops import integral_planes

    @jax.jit
    def run(img):
        planes, _ = as_planes(img, channels_last=channels_last)
        return integral_planes(planes, sq)

    return run


def integral(img, sq: bool = False, channels_last: bool = True):
    """``cv2.integral`` / ``cv2.integral2`` per plane — (B, H+1, W+1)
    in canonical plane order.  u8 exact int32; u16/i16/f32 f32 sums
    (~1e-7 relative of the f64 oracle — docs/PARITY.md)."""
    _check_image_dtype(img, allow_i16=True)
    return _integral_jit(bool(sq), bool(channels_last))(img)


@lru_cache(maxsize=None)
def _colormap_jit(colormap: str, channels_last: bool):
    from imageenhancement_mp_tpu.ops import apply_color_map_planes

    @jax.jit
    def run(img):
        planes, _ = as_planes(img, channels_last=channels_last)
        return apply_color_map_planes(planes, colormap)

    return run


def apply_color_map(img, colormap: str = "jet", channels_last: bool = True):
    """``cv2.applyColorMap`` — u8 gray → RGB via cv2's tables
    (extracted bitwise from cv2 5.0; ref/colormaps.py lists the 22
    names).  Returns RGB (cv2 returns BGR)."""
    _check_u8(img)
    return _colormap_jit(str(colormap), bool(channels_last))(img)


@lru_cache(maxsize=None)
def _stats_jit(kind: str, **static):
    from imageenhancement_mp_tpu.ops import stats as _st

    if kind == "psnr":

        @jax.jit
        def run(a, b):
            return _st.psnr_planes(
                a.reshape(1, 1, -1), b.reshape(1, 1, -1), static["max_val"]
            )

    elif kind == "norm1":

        @jax.jit
        def run(a):
            return _st.norm_planes(a.reshape(1, 1, -1), static["norm_type"])[0]

    elif kind == "norm2":

        @jax.jit
        def run(a, b):
            return _st.norm_planes(
                a.reshape(1, 1, -1), static["norm_type"], b.reshape(1, 1, -1)
            )[0]

    elif kind == "msd":

        @jax.jit
        def run(a):
            m, s = _st.mean_std_dev_planes(a.reshape(1, 1, -1))
            return m[0], s[0]

    elif kind == "mml":

        @jax.jit
        def run(a):
            return _st.min_max_loc_plane(a)

    else:  # moments

        @jax.jit
        def run(a):
            return _st.moments_plane(a, static["binary_image"])

    return run


def psnr(a, b, max_val: float = 255.0):
    """``cv2.PSNR`` — DEVICE reduction returning a 0-d f32 jax scalar
    (``inf`` on identical inputs, like cv2).  The squared-error sum is
    exact (double-float, ops/stats.py); the final log10 rounds once to
    f32 (~1e-6 relative of the f64 oracle ``ref.psnr``).  No d2h — safe
    inside streaming loops (docs/DESIGN.md §9 d2h poison)."""
    if a.shape != b.shape:
        raise ValueError("inputs must share shape")
    return _stats_jit("psnr", max_val=float(max_val))(a, b)


def norm(a, norm_type: str = "l2", b=None):
    """``cv2.norm(a[, b])`` — l1 | l2 | inf as a DEVICE reduction → 0-d
    f32 jax scalar.  l1/l2 sums are exact double-float for u8 (u16/f32
    within ~2^-45); sqrt rounds once to f32.  ``inf`` is exact.  The f64
    host oracle remains ``ref.norm``."""
    if norm_type not in ("l1", "l2", "inf"):
        raise ValueError(f"unknown norm {norm_type!r} (l1|l2|inf)")
    if b is None:
        return _stats_jit("norm1", norm_type=str(norm_type))(a)
    if a.shape != b.shape:
        raise ValueError("inputs must share shape")
    return _stats_jit("norm2", norm_type=str(norm_type))(a, b)


def mean_std_dev(img):
    """``cv2.meanStdDev`` — DEVICE reduction → (mean, population std) 0-d
    f32 jax scalars.  Pixel/pixel² sums are exact double-float for
    u8/u16; the mean/variance completion rounds once to f32 (~1e-6
    relative of the f64 oracle ``ref.mean_std_dev``).  No d2h."""
    return _stats_jit("msd")(img)


def compare_hist(h1, h2, method: str = "correl"):
    """``cv2.compareHist`` (host helper, f64): correl | chisqr |
    intersect | bhattacharyya."""
    from imageenhancement_mp_tpu.ref.ops import compare_hist as _ch

    return _ch(np.asarray(h1), np.asarray(h2), method)


def match_template(img, templ, method: str = "ccoeff_normed",
                   channels_last: bool = True):
    """``cv2.matchTemplate`` — f32 result ``(H-th+1, W-tw+1)`` per
    plane; the template is static (baked as the conv kernel).

    Float-tolerance parity (worst 3e-6 relative vs cv2 incl. the
    SQDIFF_NORMED [0,1] clamp — docs/PARITY.md)."""
    _check_image_dtype(img, allow_i16=True)
    t = np.asarray(templ)
    tt = tuple(tuple(float(v) for v in row) for row in t)
    return _apply("match_template", img, channels_last, templ=tt,
                  method=str(method))


def min_max_loc(arr):
    """``cv2.minMaxLoc`` on a 2-D response map — DEVICE reduction
    returning ``(min_val, max_val, (min_x, min_y), (max_x, max_y))``
    where every entry is a 0-d jax scalar (f32 values, i32 coords, cv2's
    first-occurrence tie rule and (x, y) point order).  No d2h; the f64
    host oracle remains ``ref.min_max_loc``."""
    mn, mx, ix, iy, ax, ay = _stats_jit("mml")(arr)
    return mn, mx, (ix, iy), (ax, ay)


@lru_cache(maxsize=None)
def _subpix_jit(patch_w: int, patch_h: int, out_f32: bool):
    from imageenhancement_mp_tpu.ops.subpix import get_rect_sub_pix_planes

    @jax.jit
    def run(img, centers):
        return get_rect_sub_pix_planes(img, centers, patch_w, patch_h,
                                       out_f32)

    return run


def get_rect_sub_pix(img, patch_size, centers, patch_type: str = None):
    """``cv2.getRectSubPix``, batched over centers — extracts one patch
    of static size ``(w, h)`` per row of ``centers`` ``[N, 2]`` (x, y)
    from one ``[H, W]`` / ``[H, W, C]`` u8 or f32 image; returns
    ``[N, h, w(, C)]`` (a single ``(cx, cy)`` pair returns one patch).

    Parity is per-(channels, depth) kernel law (ref/ops.py
    ``get_rect_sub_pix``): f32 and u8→f32 bit-exact; u8→u8 bit-exact
    on OpenCV's own Q16 kernel (3ch default / 1ch IPP-off) with the
    default build's 1ch IPP tie band documented ±1 (docs/PARITY.md).
    Centers must lie inside the image (as cv2 requires)."""
    if img.dtype not in (jnp.uint8, jnp.float32):
        raise TypeError(f"getRectSubPix supports u8/f32, got {img.dtype}")
    if img.ndim not in (2, 3):
        raise ValueError("get_rect_sub_pix expects one [H,W] or [H,W,C] image")
    if patch_type is None:
        patch_type = "f32" if img.dtype == jnp.float32 else "u8"
    if patch_type not in ("u8", "f32"):
        raise ValueError(f"patch_type must be 'u8' or 'f32', got {patch_type!r}")
    if img.dtype == jnp.float32 and patch_type == "u8":
        raise ValueError("f32 source only extracts f32 patches (as cv2)")
    w, h = int(patch_size[0]), int(patch_size[1])
    c = jnp.asarray(centers, jnp.float32)
    single = c.ndim == 1
    if single:
        c = c[None]
    if patch_type == "f32":
        # products route through f64 reduce_precision (ops/subpix.py
        # _prod32) — needs x64 enabled during trace
        with jax.enable_x64(True):
            out = _subpix_jit(w, h, True)(img, c)
    else:
        out = _subpix_jit(w, h, patch_type == "f32")(img, c)
    return out[0] if single else out


def corner_sub_pix(img, corners, win_size, zero_zone=(-1, -1),
                   max_count: int = 100, epsilon: float = 0.0):
    """``cv2.cornerSubPix`` — sub-pixel corner refinement (host helper
    over the pinned law, like ``min_max_loc``: a handful of corners ×
    a tiny iterative 2×2 solve is latency-bound, not throughput work —
    pair it with ``good_features_to_track`` for the detect→refine
    chain).  Bitwise vs cv2 while the refinement window stays interior
    (100 % of interior corners); a window that reaches the border can
    settle on a neighbouring fixpoint, bounded by the drift gate
    (ref/ops.py ``corner_sub_pix``, docs/PARITY.md)."""
    from imageenhancement_mp_tpu.ref.ops import corner_sub_pix as _csp

    return _csp(np.asarray(img), np.asarray(corners, np.float32),
                win_size, zero_zone, max_count, epsilon)


@lru_cache(maxsize=None)
def _lk_jit(shape_a, shape_b, ww, wh, max_level, max_count, epsilon,
            min_eig, exact):
    from imageenhancement_mp_tpu.ops.lk import calc_optical_flow_pyr_lk_planes
    from imageenhancement_mp_tpu.ops.pyramid import pyr_down_planes

    def levels_of(shape):
        # buildOpticalFlowPyramid clamp: stop when the NEXT level's
        # width or height would be <= winSize (ref/ops.py)
        lv = [shape]
        for _ in range(max_level):
            h, w = lv[-1]
            nw, nh = (w + 1) // 2, (h + 1) // 2
            if nw <= ww or nh <= wh:
                break
            lv.append((nh, nw))
        return len(lv) - 1

    ml = min(max_level, levels_of(shape_a), levels_of(shape_b))

    @jax.jit
    def run(prev_img, next_img, pts):
        def pyramid(img):
            levels = [img]
            for _ in range(ml):
                levels.append(pyr_down_planes(levels[-1][None])[0])
            return levels

        return calc_optical_flow_pyr_lk_planes(
            pyramid(prev_img), pyramid(next_img), pts, (ww, wh), ml,
            max_count, epsilon, min_eig, exact)

    return run


def calc_optical_flow_pyr_lk(prev_img, next_img, prev_pts,
                             win_size=(21, 21), max_level: int = 3,
                             max_count: int = 30, epsilon: float = 0.01,
                             min_eig_threshold: float = 1e-4,
                             exact: bool = True):
    """``cv2.calcOpticalFlowPyrLK`` — pyramidal Lucas-Kanade sparse
    tracking of N points between two grayscale u8 frames, one jitted
    program (device pyramid + vmapped Q14 fixed-point tracker).
    Returns ``(next_pts f32 [N,2], status u8 [N], err f32 [N])``.

    ``exact=True`` reproduces cv2's SIMD lane accumulation: status
    bitwise always, 99.6 % of points (and their err) bitwise, the rest
    ≤ 1e-4 px (deep-iteration ulp ties — 200-config/3000-point sweep,
    docs/PARITY.md); device == oracle bitwise everywhere.
    ``exact=False`` uses free-order reductions — the fast path,
    same algorithm, sub-0.1 px agreement (ops/lk.py)."""
    _check_u8(prev_img)
    _check_u8(next_img)
    if prev_img.ndim != 2 or next_img.ndim != 2:
        raise ValueError("calc_optical_flow_pyr_lk expects [H,W] grayscale")
    pts = jnp.asarray(prev_pts, jnp.float32).reshape(-1, 2)
    fn = _lk_jit(tuple(prev_img.shape), tuple(next_img.shape),
                 int(win_size[0]), int(win_size[1]), int(max_level),
                 int(max_count), float(epsilon), float(min_eig_threshold),
                 bool(exact))
    # exact delta.ddot and 1/D are f64 laws (ops/lk.py); without x64
    # they silently demote to f32 and flip rare ties
    # (the f64 scalars are per-point per-iteration only)
    with jax.enable_x64(True):
        return fn(jnp.asarray(prev_img), jnp.asarray(next_img), pts)


def canny(img, threshold1: float, threshold2: float, aperture_size: int = 3,
          l2_gradient: bool = False, channels_last: bool = True):
    """``cv2.Canny`` — bit-exact (0/180 fuzz: L1/L2 × aperture 3/5/7).

    uint8 input only, like cv2; returns 0/255 uint8 edges.  Replicate-
    border Sobel, cv2's fixed-point NMS, 8-connected hysteresis (a
    ``lax.while_loop`` fixpoint on device)."""
    _check_u8(img)
    return _apply("canny", img, channels_last,
                  threshold1=float(threshold1), threshold2=float(threshold2),
                  aperture_size=int(aperture_size),
                  l2_gradient=bool(l2_gradient))


def connected_components(img, connectivity: int = 8, channels_last: bool = True):
    """``cv2.connectedComponents`` — int32 labels (0 = background).

    Numbering bit-exact vs cv2 for BOTH connectivities: 4-conn ranks
    components in first-pixel raster order (SAUF), 8-conn in cv2's
    BBDT order = the component's first 2x2 block in block-raster order
    (docs/PARITY.md).  Pointer-jumping while_loop: log-diameter
    convergence on device."""
    _check_u8(img)
    return _apply("connected_components", img, channels_last,
                  connectivity=int(connectivity))


def sep_filter2d(img, kernel_x, kernel_y, delta: float = 0.0,
                 channels_last: bool = True):
    """``cv2.sepFilter2D(img, -1, kx, ky, delta)`` — composed as
    ``filter2d`` with the outer product ``ky⊗kx`` (cv2's own two-pass
    matches up to association: ±1 int razor / one f32 ulp)."""
    kx = np.asarray(kernel_x, np.float64).ravel()
    ky = np.asarray(kernel_y, np.float64).ravel()
    return filter2d(img, np.outer(ky, kx), delta, channels_last)


def box_filter(img, ksize=3, normalize: bool = True, channels_last: bool = True):
    """``cv2.boxFilter`` — normalized == ``box_blur``; raw window sums
    otherwise (int32/f32, exact)."""
    _check_image_dtype(img, allow_i16=True)
    ks = (int(ksize[0]), int(ksize[1])) if isinstance(ksize, (tuple, list)) else int(ksize)
    return _apply("box_filter", img, channels_last, ksize=ks,
                  normalize=bool(normalize))


def calc_back_project(img, hist, scale: float = 1.0, channels_last: bool = True):
    """``cv2.calcBackProject([img],[0],hist,[0,256],scale)`` — exact
    folded LUT gather (u8; any bin count)."""
    _check_u8(img)
    ht = tuple(float(v) for v in np.asarray(hist, np.float64).ravel())
    return _apply("calc_back_project", img, channels_last, hist=ht,
                  scale=float(scale))


@lru_cache(maxsize=None)
def _nlm_jit(h: float, t: int, s: int, channels_last: bool, norm: str = "l2"):
    from imageenhancement_mp_tpu.ops.nlmeans import fast_nl_means_vec
    from imageenhancement_mp_tpu.utils.shapes import as_vec

    @jax.jit
    def run(img):
        vec, restore = as_vec(img, channels_last=channels_last)
        return restore(fast_nl_means_vec(vec, h, t, s, norm))

    return run


@lru_cache(maxsize=None)
def _nlm_u16_jit(h: float, t: int, s: int, channels_last: bool):
    from imageenhancement_mp_tpu.ops.nlmeans import fast_nl_means_u16_vec
    from imageenhancement_mp_tpu.utils.shapes import as_vec

    @jax.jit
    def run(img):
        batched, restore = as_vec(img, channels_last=channels_last)
        return restore(fast_nl_means_u16_vec(batched, h, t, s))

    def call(img):
        with jax.enable_x64(True):
            return run(img)

    return call


def fast_nl_means_denoising(img, h: float = 10.0, template_window: int = 7,
                            search_window: int = 21, channels_last: bool = True,
                            norm_type: str = "l2"):
    """``cv2.fastNlMeansDenoising`` — BIT-EXACT (0-LSB deterministic
    fuzz over h, t, s and cn∈{1,2,3,4}; docs/PARITY.md pins the weight
    LUT: ``round(FPM·exp(−SSD·scale/(h²·cn)))``).  uint8.

    Multichannel inputs follow cv2's VECTOR-pixel semantics: one joint
    SSD over the channels drives a shared weight (NOT per-plane
    denoising).  A 3-D input with last dim ≤ 4 is one [H,W,C] image
    (the as_planes ambiguity rule).  uint16 input is supported with
    norm_type='l1' (cv2's own 16U constraint) — BIT-EXACT through the
    INT_MAX fixed-point LUT with s64 accumulation on device."""
    t, s = int(template_window), int(search_window)
    if t % 2 == 0 or s % 2 == 0:
        raise ValueError("window sizes must be odd")
    if norm_type not in ("l1", "l2"):
        raise ValueError(f"norm_type must be 'l1' or 'l2', got {norm_type!r}")
    if img.dtype == jnp.uint16:
        # cv2 supports 16U only with NORM_L1 (FPM = INT_MAX, 64-bit
        # accumulators — docs/PARITY.md)
        if norm_type != "l1":
            raise ValueError("uint16 fastNlMeansDenoising requires norm_type='l1'"
                             " (cv2's own constraint)")
        return _nlm_u16_jit(float(h), t, s, bool(channels_last))(img)
    _check_u8(img)
    return _nlm_jit(float(h), t, s, bool(channels_last), str(norm_type))(img)


@lru_cache(maxsize=None)
def _nlm_colored_jit(h: float, hc: float, t: int, s: int, order: str):
    from imageenhancement_mp_tpu.ops.color import lab_to_rgb_nhwc, rgb_to_lab_nhwc
    from imageenhancement_mp_tpu.ops.nlmeans import fast_nl_means_vec

    @jax.jit
    def run(img):
        lab = rgb_to_lab_nhwc(img, order, srgb=False)
        batched = lab if lab.ndim == 4 else lab[None]
        L = fast_nl_means_vec(batched[..., :1], h, t, s)
        ab = fast_nl_means_vec(batched[..., 1:3], hc, t, s)
        out = lab_to_rgb_nhwc(jnp.concatenate([L, ab], -1), order, srgb=False)
        return out if lab.ndim == 4 else out[0]

    return run


def fast_nl_means_denoising_colored(img, h: float = 3.0, h_color: float = 3.0,
                                    template_window: int = 7,
                                    search_window: int = 21,
                                    order: str = "rgb"):
    """``cv2.fastNlMeansDenoisingColored`` — BIT-EXACT (pinned
    decomposition, docs/PARITY.md): convert with the LINEAR-RGB Lab
    variant (COLOR_LBGR2Lab — no sRGB gamma stage, exhaustively exact
    tables), denoise L alone with ``h``, denoise the (a,b) pair as one
    2-channel vector image with ``h_color`` (joint SSD, shared
    weights), convert back.  uint8 ``[H,W,3]`` / ``[N,H,W,3]``."""
    if img.dtype != jnp.uint8:
        raise TypeError(f"fastNlMeansDenoisingColored is uint8, got {img.dtype}")
    if img.ndim not in (3, 4) or img.shape[-1] != 3:
        raise ValueError(f"expected [H,W,3] or [N,H,W,3], got {img.shape}")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    t, s = int(template_window), int(search_window)
    if t % 2 == 0 or s % 2 == 0:
        raise ValueError("window sizes must be odd")
    return _nlm_colored_jit(float(h), float(h_color), t, s, str(order))(img)


@lru_cache(maxsize=None)
def _nlm_multi_jit(h: float, t: int, s: int):
    from imageenhancement_mp_tpu.ops.nlmeans import fast_nl_means_multi_vec

    @jax.jit
    def run(stack):
        vec = stack if stack.ndim == 4 else stack[..., None]
        out = fast_nl_means_multi_vec(vec[:, None], h, t, s)[0]
        return out if stack.ndim == 4 else out[..., 0]

    return run


def _temporal_stack(frames, idx, tw):
    tw, idx = int(tw), int(idx)
    if tw % 2 == 0:
        raise ValueError("temporalWindowSize must be odd")
    if hasattr(frames, "ndim"):
        n = frames.shape[0]
    else:
        n = len(frames)
    lo = idx - tw // 2
    if lo < 0 or idx + tw // 2 >= n:
        raise ValueError("temporal window exceeds the frame list")
    if hasattr(frames, "ndim"):
        stack = frames[lo:lo + tw]
    else:
        stack = jnp.stack([jnp.asarray(f) for f in frames[lo:lo + tw]])
    if stack.dtype != jnp.uint8:
        raise TypeError("fastNlMeansDenoisingMulti requires uint8 frames")
    return stack


def fast_nl_means_denoising_multi(frames, img_to_denoise_index: int,
                                  temporal_window_size: int, h: float = 3.0,
                                  template_window: int = 7,
                                  search_window: int = 21):
    """``cv2.fastNlMeansDenoisingMulti`` — BIT-EXACT temporal NLMeans
    (docs/PARITY.md): the search set is every spatial offset in every
    frame of the odd ``temporal_window_size`` window centred on
    ``img_to_denoise_index``; templates always come from the target
    frame; FPM = INT_MAX//(T·s²·255).  ``frames`` is a ``[T,H,W]`` /
    ``[T,H,W,C]`` uint8 stack (or a list of frames); returns the
    denoised target frame."""
    stack = _temporal_stack(frames, img_to_denoise_index,
                            temporal_window_size)
    if stack.ndim not in (3, 4) or (
            stack.ndim == 4 and stack.shape[-1] not in (1, 2, 3, 4)):
        raise ValueError(f"expected [T,H,W] or [T,H,W,C<=4] frames, "
                         f"got {stack.shape}")
    t, s = int(template_window), int(search_window)
    if t % 2 == 0 or s % 2 == 0:
        raise ValueError("window sizes must be odd")
    return _nlm_multi_jit(float(h), t, s)(stack)


@lru_cache(maxsize=None)
def _nlm_colored_multi_jit(h: float, hc: float, t: int, s: int, order: str):
    from imageenhancement_mp_tpu.ops.color import lab_to_rgb_nhwc, rgb_to_lab_nhwc
    from imageenhancement_mp_tpu.ops.nlmeans import fast_nl_means_multi_vec

    @jax.jit
    def run(stack):
        lab = rgb_to_lab_nhwc(stack, order, srgb=False)[:, None]
        L = fast_nl_means_multi_vec(lab[..., :1], h, t, s)
        ab = fast_nl_means_multi_vec(lab[..., 1:3], hc, t, s)
        return lab_to_rgb_nhwc(jnp.concatenate([L, ab], -1)[0], order,
                               srgb=False)

    return run


def fast_nl_means_denoising_colored_multi(frames, img_to_denoise_index: int,
                                          temporal_window_size: int,
                                          h: float = 3.0,
                                          h_color: float = 3.0,
                                          template_window: int = 7,
                                          search_window: int = 21,
                                          order: str = "rgb"):
    """``cv2.fastNlMeansDenoisingColoredMulti`` — BIT-EXACT: every
    window frame converted with the LINEAR-RGB Lab variant, temporal
    NLMeans on L with ``h`` and on the (a,b) 2-channel vector pairs
    with ``h_color``, target converted back.  ``frames`` is a
    ``[T,H,W,3]`` uint8 stack (or list); returns the denoised target."""
    stack = _temporal_stack(frames, img_to_denoise_index,
                            temporal_window_size)
    if stack.ndim != 4 or stack.shape[-1] != 3:
        raise ValueError(f"expected [T,H,W,3] frames, got {stack.shape}")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    t, s = int(template_window), int(search_window)
    if t % 2 == 0 or s % 2 == 0:
        raise ValueError("window sizes must be odd")
    return _nlm_colored_multi_jit(float(h), float(h_color), t, s,
                                  str(order))(stack)


@lru_cache(maxsize=None)
def _photo_jit(op: str, a: float, b: float, extra: str):
    from imageenhancement_mp_tpu.ops import photo

    @jax.jit
    def run(img):
        batched = img if img.ndim == 4 else img[None]
        if op == "epf":
            out = photo.edge_preserving_filter_nhwc(batched, extra, a, b)
        elif op == "detail":
            out = photo.detail_enhance_nhwc(batched, a, b, extra)
        else:
            out = photo.stylization_nhwc(batched, a, b)
        return out if img.ndim == 4 else out[0]

    return run


def _check_rgb_u8(img, name):
    if img.dtype != jnp.uint8:
        raise TypeError(f"{name} is uint8, got {img.dtype}")
    if img.ndim not in (3, 4) or img.shape[-1] != 3:
        raise ValueError(f"expected [H,W,3] or [N,H,W,3], got {img.shape}")


def edge_preserving_filter(img, flags: str = "recursive",
                           sigma_s: float = 60.0, sigma_r: float = 0.4):
    """``cv2.edgePreservingFilter`` — the Gastal domain transform.
    ``flags='recursive'`` (RECURS_FILTER) is BIT-EXACT vs cv2 (rare ±1
    powf-ulp px); ``'normconv'`` (NORMCONV_FILTER) is ±1 on ~3 % px
    (docs/PARITY.md).  On device the RF recursion runs as lax.scan
    chains (the oracle's f32 sequence); the NC
    variant is fully data-parallel (cumsum + searchsorted + SAT).
    uint8 ``[H,W,3]`` / ``[N,H,W,3]``."""
    _check_rgb_u8(img, "edgePreservingFilter")
    if flags not in ("recursive", "normconv"):
        raise ValueError(f"flags must be 'recursive' or 'normconv', got {flags!r}")
    return _photo_jit("epf", float(sigma_s), float(sigma_r), str(flags))(img)


def detail_enhance(img, sigma_s: float = 10.0, sigma_r: float = 0.15,
                   order: str = "rgb"):
    """``cv2.detailEnhance`` — RF-filter the Lab L plane, boost the
    detail layer 3x (pinned composition incl. cv2's L/255 scaling
    quirk).  Budget ±3 vs cv2 on ~16 % px — entirely the documented
    analytic-vs-interpolated f32 Lab difference (docs/PARITY.md).
    uint8 ``[H,W,3]`` / ``[N,H,W,3]``."""
    _check_rgb_u8(img, "detailEnhance")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    return _photo_jit("detail", float(sigma_s), float(sigma_r), str(order))(img)


def stylization(img, sigma_s: float = 60.0, sigma_r: float = 0.45):
    """``cv2.stylization`` — NC domain-transform abstraction + Sobel
    edge darkening (pinned composition; ±1 inherited from the NC
    stage's ~3 %).  uint8 ``[H,W,3]`` / ``[N,H,W,3]``."""
    _check_rgb_u8(img, "stylization")
    return _photo_jit("styl", float(sigma_s), float(sigma_r), "")(img)


@lru_cache(maxsize=None)
def _pencil_jit(ss: float, sr: float, sf: float, order: str):
    from imageenhancement_mp_tpu.ops import photo

    @jax.jit
    def run(img):
        batched = img if img.ndim == 4 else img[None]
        g, c = photo.pencil_sketch_nhwc(batched, ss, sr, sf, order)
        return (g, c) if img.ndim == 4 else (g[0], c[0])

    def call(img):
        # x64 scope: the CPU backend's exact-derivative leg rounds its
        # products through f64 reduce_precision (ops/photo.py)
        with jax.enable_x64(True):
            return run(img)

    return call


def pencil_sketch(img, sigma_s: float = 60.0, sigma_r: float = 0.07,
                  shade_factor: float = 0.02, order: str = "rgb"):
    """``cv2.pencilSketch`` — ``(gray, color)`` domain-transform pencil
    drawing.  gray is BIT-EXACT vs cv2 (940 fuzz configs); color is
    exact on cv2's SIMD body, ±1 on its build-dependent scalar row tail
    (last ``W mod 8`` px — the HLS/HSV tail budget class,
    docs/PARITY.md).  Full pinned law in ref/ops.py pencil_sketch.
    uint8 ``[H,W,3]`` / ``[N,H,W,3]`` → ``(u8 [..H,W], u8 [..H,W,3])``."""
    _check_rgb_u8(img, "pencilSketch")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"order must be 'rgb' or 'bgr', got {order!r}")
    return _pencil_jit(float(sigma_s), float(sigma_r), float(shade_factor),
                       str(order))(img)


@lru_cache(maxsize=None)
def _accum_jit(op: str, alpha: float, masked: bool):
    from imageenhancement_mp_tpu.utils.fma import two_prod, two_sum

    def rmul(a, b):
        return two_prod(a, b)[0]   # forced f32 rounding (no contraction)

    @jax.jit
    def run(src, acc, *m):
        s = src.astype(jnp.float32)
        if op == "acc":
            new = acc + s
        elif op == "sq":
            new = acc + rmul(s, s)
        elif op == "w":
            al = jnp.float32(alpha)
            be = jnp.float32(1.0 - np.float64(alpha))
            # two_sum forces the final add to round once (XLA:CPU would
            # otherwise keep excess precision through the chain)
            new = two_sum(rmul(acc, be), rmul(s, al))[0]
        else:  # product: src is a tuple handled by run2
            new = acc + s
        if masked:
            mm = m[0] != 0
            if mm.ndim == acc.ndim - 1:
                mm = mm[..., None]
            new = jnp.where(mm, new, acc)
        return new.astype(jnp.float32)

    return run


@lru_cache(maxsize=None)
def _accum_prod_jit(masked: bool):
    from imageenhancement_mp_tpu.utils.fma import two_prod

    @jax.jit
    def run(src1, src2, acc, *m):
        new = acc + two_prod(src1.astype(jnp.float32),
                             src2.astype(jnp.float32))[0]
        if masked:
            mm = m[0] != 0
            if mm.ndim == acc.ndim - 1:
                mm = mm[..., None]
            new = jnp.where(mm, new, acc)
        return new.astype(jnp.float32)

    return run


def _check_acc(acc):
    if acc.dtype != jnp.float32:
        raise TypeError(f"accumulator must be float32, got {acc.dtype}")


def accumulate(src, acc, mask=None):
    """``cv2.accumulate`` — EXACT functional form: returns the new f32
    accumulator ``acc + f32(src)`` (masked pixels keep ``acc``)."""
    _check_acc(acc)
    fn = _accum_jit("acc", 0.0, mask is not None)
    return fn(src, acc) if mask is None else fn(src, acc, mask)


def accumulate_square(src, acc, mask=None):
    """``cv2.accumulateSquare`` — EXACT: ``acc + f32(src)²``."""
    _check_acc(acc)
    fn = _accum_jit("sq", 0.0, mask is not None)
    return fn(src, acc) if mask is None else fn(src, acc, mask)


def accumulate_product(src1, src2, acc, mask=None):
    """``cv2.accumulateProduct`` — EXACT: ``acc + f32(src1)·f32(src2)``."""
    _check_acc(acc)
    fn = _accum_prod_jit(mask is not None)
    return fn(src1, src2, acc) if mask is None else fn(src1, src2, acc, mask)


def accumulate_weighted(src, acc, alpha: float, mask=None):
    """``cv2.accumulateWeighted`` — the video running average
    ``acc·f32(1−α) + src·f32(α)`` in plain per-op f32 (cv2's NATIVE
    path; cv2's default IPP dispatch deviates ~2e-3 from cv2's own
    native path — ref/ops.py accumulate_weighted).  On the CPU test
    backend XLA contracts the chain (±1 ulp, the docs/PARITY.md
    backend nuance)."""
    _check_acc(acc)
    fn = _accum_jit("w", float(alpha), mask is not None)
    return fn(src, acc) if mask is None else fn(src, acc, mask)


@lru_cache(maxsize=None)
def _mertens_jit(wcon: float, wsat: float, wexp: float):
    from imageenhancement_mp_tpu.ops.photo import merge_mertens_nhwc

    @jax.jit
    def run(stack):
        return merge_mertens_nhwc(stack, wcon, wsat, wexp)

    return run


def merge_mertens(images, contrast_weight: float = 1.0,
                  saturation_weight: float = 1.0,
                  exposure_weight: float = 0.0):
    """``cv2.createMergeMertens(...).process`` — multi-exposure HDR
    fusion (Mertens): per-frame contrast/saturation/well-exposedness
    weights, Laplacian-pyramid blend.  ``images``: a ``[T,H,W,3]`` u8
    stack or list of frames; returns the fused f32 ``[H,W,3]``
    (≈[0,1], may over/undershoot like cv2 — scale by 255 and clip to
    display).  Composition pinned within ~2e-5 of cv2 (the f32
    pyramid float noise; ref/ops.py merge_mertens)."""
    if hasattr(images, "ndim"):
        stack = images
    else:
        stack = jnp.stack([jnp.asarray(f) for f in images])
    if stack.ndim != 4 or stack.shape[-1] != 3:
        raise ValueError(f"expected [T,H,W,3] frames, got {stack.shape}")
    if stack.dtype != jnp.uint8:
        raise TypeError(f"merge_mertens expects uint8 frames, got {stack.dtype}")
    return _mertens_jit(float(contrast_weight), float(saturation_weight),
                        float(exposure_weight))(stack)


@lru_cache(maxsize=None)
def _tonemap_jit(gamma: float):
    @jax.jit
    def run(img):
        mn = img.min()
        mx = img.max()
        x = (img - mn) / jnp.maximum(mx - mn, jnp.float32(1e-38))
        out = jnp.power(x, jnp.float32(1.0 / gamma)).astype(jnp.float32)
        return jnp.where(mx > mn, out, jnp.zeros_like(out))

    return run


def tonemap(img, gamma: float = 1.0):
    """``cv2.createTonemap(gamma).process`` — global min/max normalize
    + ``pow(1/gamma)`` (the display map for ``merge_mertens`` output;
    pinned ≤6e-8, and a constant frame maps to zeros instead of cv2's
    NaN).  f32 ``[H,W,3]``."""
    if img.dtype != jnp.float32:
        raise TypeError(f"tonemap expects float32 HDR input, got {img.dtype}")
    return _tonemap_jit(float(gamma))(img)


def _decolor_eval_jit():
    from imageenhancement_mp_tpu.ops.color import lab_to_rgb_nhwc, rgb_to_lab_nhwc

    @jax.jit
    def run(rgb, wei):
        f = jnp.float32
        x = rgb.astype(f) * f(1.0 / 255.0)
        R_, G_, B_ = x[..., 0], x[..., 1], x[..., 2]
        idx = 0
        gray = jnp.zeros_like(R_)
        # the 9 degree-<=2 monomials in the oracle's comb order
        for r in range(3):
            for g in range(3):
                for b in range(3):
                    if 0 < r + g + b <= 2:
                        gray = gray + wei[idx] * (R_ ** r) * (G_ ** g) * (B_ ** b)
                        idx += 1
        mn = gray.min()
        mx = gray.max()
        gray = jnp.where(mx > mn, (gray - mn) / (mx - mn), gray * 0)
        g8 = jnp.clip(jnp.round(gray * f(255.0)), 0, 255).astype(jnp.uint8)
        lab = rgb_to_lab_nhwc(rgb[None], "rgb")
        lab = lab.at[..., 0].set(g8[None])
        boost = lab_to_rgb_nhwc(lab, "rgb")[0]
        return g8, boost

    return run


def decolor(img, order: str = "rgb"):
    """``cv2.decolor`` — Lu/Xu/Jia contrast-preserving decolorization.
    Returns ``(grayscale u8 [H,W], color_boost u8 [H,W,3])``.

    Hybrid op: the 9 polynomial weights solve on host over the
    <=800-sum work image (ref/ops.py ``decolor_weights`` — the EM loop
    with cv2's pinned σ/σ² split); the full-resolution evaluation +
    min-max normalize + u8 Lab L-replacement boost run on device (the
    Lab legs are the exhaustively exact integer tables).  Budget: gray
    ±1 LSB on ≲5 % px (the analytic-vs-interpolated f32 Lab leg in the
    solver's contrast target); boost bit-exact GIVEN the gray (≤5
    through the Lab roundtrip where the gray flips ±1); the device f32
    polynomial is razor ±1 vs the f64 oracle."""
    from imageenhancement_mp_tpu.ref.ops import decolor_weights

    img = jnp.asarray(img)
    if img.dtype != jnp.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise TypeError("decolor expects a uint8 [H,W,3] image")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"unknown channel order {order!r}")
    rgb = img[..., ::-1] if order == "bgr" else img
    rgb_np = np.asarray(rgb)
    wei, _ = decolor_weights(rgb_np.astype(np.float32) / np.float32(255.0))
    g8, boost = _decolor_eval_jit()(rgb, jnp.asarray(wei, jnp.float32))
    if order == "bgr":
        boost = boost[..., ::-1]
    return g8, boost


@lru_cache(maxsize=None)
def _tvl1_jit(lam: float, niters: int):
    from imageenhancement_mp_tpu.ops.photo import denoise_tvl1_stack

    @jax.jit
    def run(stack):
        return denoise_tvl1_stack(stack, lam, niters)

    return run


def denoise_tvl1(observations, lam: float = 1.0, niters: int = 30):
    """``cv2.denoise_TVL1`` — the Chambolle-Pock primal-dual TV-L1
    denoiser on one or more noisy uint8 [H,W] observations (pinned
    BIT-EXACT modulo a single-pixel razor class — ref/ops.py
    ``denoise_tvl1``; the f32 device iterations reproduce the f64
    oracle's u8 outputs on every tested config).

    ``observations``: a list of [H,W] uint8 arrays or one stacked
    [K,H,W] array."""
    if isinstance(observations, (list, tuple)):
        stack = jnp.stack([jnp.asarray(o) for o in observations])
    else:
        stack = jnp.asarray(observations)
        if stack.ndim == 2:
            stack = stack[None]
    if stack.dtype != jnp.uint8 or stack.ndim != 3:
        raise TypeError("denoise_tvl1 expects uint8 [H,W] observations")
    if int(niters) < 1 or float(lam) <= 0:
        raise ValueError("niters must be >= 1 and lam > 0")
    return _tvl1_jit(float(lam), int(niters))(stack)


def _tonemap_reinhard_jit(gamma, intensity, light_adapt, color_adapt):
    from imageenhancement_mp_tpu.ops.photo import tonemap_reinhard_nhwc

    @jax.jit
    def run(img):
        return tonemap_reinhard_nhwc(img[None], gamma, intensity,
                                     light_adapt, color_adapt)[0]

    return run


def tonemap_reinhard(img, gamma: float = 1.0, intensity: float = 0.0,
                     light_adapt: float = 1.0, color_adapt: float = 0.0):
    """``cv2.createTonemapReinhard(...).process`` — pinned ~2e-7 vs cv2
    (ref/ops.py ``tonemap_reinhard``; the residual is the normalize
    constants' unpinnable last bit + f32 transcendental ulps).
    f32 ``[H,W,3]`` HDR in, f32 [0,1] out."""
    if img.dtype != jnp.float32:
        raise TypeError(f"tonemap_reinhard expects float32 HDR, got {img.dtype}")
    return _tonemap_reinhard_jit(float(gamma), float(intensity),
                                 float(light_adapt), float(color_adapt))(img)


def _tonemap_drago_jit(gamma, saturation, bias):
    from imageenhancement_mp_tpu.ops.photo import tonemap_drago_nhwc

    @jax.jit
    def run(img):
        return tonemap_drago_nhwc(img[None], gamma, saturation, bias)[0]

    return run


def tonemap_drago(img, gamma: float = 1.0, saturation: float = 1.0,
                  bias: float = 0.85):
    """``cv2.createTonemapDrago(...).process`` — structure pinned exact
    (ref/ops.py ``tonemap_drago``); ≤5e-7 vs cv2 when the global-min
    pixel's normalize residue sign matches (cv2's fractional pow NaNs a
    NEGATIVE residue — build-dependent last bit; when it flips, the
    renormalization shifts globally by up to ~0.05).  f32 ``[H,W,3]``."""
    if img.dtype != jnp.float32:
        raise TypeError(f"tonemap_drago expects float32 HDR, got {img.dtype}")
    return _tonemap_drago_jit(float(gamma), float(saturation), float(bias))(img)


def _tonemap_mantiuk_jit(gamma, scale, saturation):
    from imageenhancement_mp_tpu.ops.photo import tonemap_mantiuk_nhwc

    @jax.jit
    def run(img):
        return tonemap_mantiuk_nhwc(img[None], gamma, scale, saturation)[0]

    return run


def tonemap_mantiuk(img, gamma: float = 1.0, scale: float = 0.7,
                    saturation: float = 1.0):
    """``cv2.createTonemapMantiuk(...).process`` — cv2's gradient-domain
    contrast operator reduced to its closed form (the contrast response
    map is algebraically linear, so the 100-iteration CG solves
    ``A x = k·A x0`` whose solution is the power law
    ``L' = L^(scale^(1/0.4185))`` — ref/ops.py ``tonemap_mantiuk``).
    ≤ ~3e-3 vs cv2 (its own CG stopping tolerance).  f32 ``[H,W,3]``."""
    if img.dtype != jnp.float32:
        raise TypeError(f"tonemap_mantiuk expects float32 HDR, got {img.dtype}")
    return _tonemap_mantiuk_jit(float(gamma), float(scale),
                                float(saturation))(img)


def undistort(img, K, dist, new_K=None, channels_last: bool = True):
    """``cv2.undistort`` — BIT-EXACT u8 (cv2's quantized-map 32x32-tab
    path), u16/i16 ±1, f32 float-tab.  ``K``/``dist`` are static
    (recompile per calibration, which is how cameras work)."""
    _check_image_dtype(img, allow_i16=True)
    Kt = tuple(tuple(float(v) for v in row)
               for row in np.asarray(K, np.float64).reshape(3, 3))
    dt = tuple(float(v) for v in np.asarray(dist, np.float64).ravel())
    nk = (None if new_K is None else
          tuple(tuple(float(v) for v in row)
                for row in np.asarray(new_K, np.float64).reshape(3, 3)))
    return _apply("undistort", img, channels_last, K=Kt, dist=dt, new_K=nk)


def init_undistort_rectify_map(K, dist, size, new_K=None):
    """``cv2.initUndistortRectifyMap`` (host helper, bit-exact f32
    maps; ``size`` is (H, W)) — feed the result to ``ie.remap``."""
    from imageenhancement_mp_tpu.ref.ops import init_undistort_rectify_map as _im

    return _im(K, dist, size, new_K)


def get_rotation_matrix_2d(center, angle_deg: float, scale: float = 1.0):
    """``cv2.getRotationMatrix2D`` (host-side f64 helper)."""
    from imageenhancement_mp_tpu.ref.ops import get_rotation_matrix_2d as _rot

    return _rot(center, angle_deg, scale)


def _kernel_static(kernel):
    if kernel is None:
        return None
    k = np.asarray(kernel)
    return tuple(tuple(int(bool(v)) for v in row) for row in k)


def erode(img, ksize=3, iterations: int = 1, kernel=None, channels_last: bool = True):
    """``cv2.erode`` — exact min filter; rect ``ksize`` (int or
    (rows, cols), even allowed) or an arbitrary 0/1 ``kernel`` mask
    (use ``get_structuring_element`` for ellipse/cross).  u8/u16/i16/f32."""
    _check_image_dtype(img, allow_i16=True)
    ks = (int(ksize[0]), int(ksize[1])) if isinstance(ksize, (tuple, list)) else int(ksize)
    return _apply("erode", img, channels_last, ksize=ks, iterations=int(iterations),
                  kernel=_kernel_static(kernel))


def dilate(img, ksize=3, iterations: int = 1, kernel=None, channels_last: bool = True):
    """``cv2.dilate`` — exact max filter (see ``erode``)."""
    _check_image_dtype(img, allow_i16=True)
    ks = (int(ksize[0]), int(ksize[1])) if isinstance(ksize, (tuple, list)) else int(ksize)
    return _apply("dilate", img, channels_last, ksize=ks, iterations=int(iterations),
                  kernel=_kernel_static(kernel))


def morphology_ex(img, op: str = "open", ksize=3, iterations: int = 1,
                  kernel=None, channels_last: bool = True):
    """``cv2.morphologyEx`` — exact: erode | dilate | open | close |
    gradient | tophat | blackhat; rect or arbitrary 0/1 kernels."""
    _check_image_dtype(img, allow_i16=True)
    ks = (int(ksize[0]), int(ksize[1])) if isinstance(ksize, (tuple, list)) else int(ksize)
    return _apply("morphology", img, channels_last, op=str(op), ksize=ks,
                  iterations=int(iterations), kernel=_kernel_static(kernel))


def get_structuring_element(shape: str, ksize):
    """``cv2.getStructuringElement`` (host helper, bit-exact): rect |
    ellipse | cross; ``ksize`` = (rows, cols)."""
    from imageenhancement_mp_tpu.ref.ops import get_structuring_element as _gse

    return _gse(shape, ksize)


def gabor_kernel(ksize, sigma: float, theta: float, lambd: float,
                 gamma: float = 1.0, psi: float = np.pi / 2):
    """``cv2.getGaborKernel`` (host helper, 1e-15 vs cv2); pair with
    ``ie.filter2d`` for Gabor banks."""
    from imageenhancement_mp_tpu.ref.ops import gabor_kernel as _gk

    return _gk(ksize, sigma, theta, lambd, gamma, psi)


def corner_harris(img, block_size: int = 2, ksize: int = 3, k: float = 0.04,
                  channels_last: bool = True):
    """``cv2.cornerHarris`` — f32 response at f32-ulp tolerance
    (~8e-7 rel; docs/PARITY.md)."""
    _check_u8(img)
    return _apply("corner_harris", img, channels_last,
                  block_size=int(block_size), ksize=int(ksize), k=float(k))


def adaptive_threshold(img, maxval: float = 255.0, method: str = "mean",
                       type: str = "binary", block_size: int = 3, C: float = 0.0,
                       channels_last: bool = True):
    """``cv2.adaptiveThreshold(img, maxval, method, type, blockSize, C)``
    — exact (uint8).  ``method``: mean | gaussian; ``type``: binary |
    binary_inv.  Local mean over BORDER_REPLICATE; gaussian uses cv2's
    float-kernel path (docs/PARITY.md)."""
    _check_u8(img)
    return _apply(
        "adaptive_threshold", img, channels_last,
        maxval=float(maxval), method=str(method), type=str(type),
        block_size=int(block_size), C=float(C),
    )


@lru_cache(maxsize=None)
def _bilateral_jit(d: int, sc: float, ss: float, color: bool, channels_last: bool):
    from imageenhancement_mp_tpu.ops.bilateral import bilateral_color, bilateral_planes

    @jax.jit
    def run(img):
        if color:
            return bilateral_color(img, d, sc, ss)
        planes, restore = as_planes(img, channels_last=channels_last)
        return restore(bilateral_planes(planes, d, sc, ss))

    return run


def bilateral_filter(img, d: int = 5, sigma_color: float = 50.0,
                     sigma_space: float = 50.0, channels_last: bool = True):
    """``cv2.bilateralFilter(img, d, σ_color, σ_space)`` — edge-preserving
    denoise, uint8.  Grayscale shapes filter per plane (bit-exact vs
    cv2's reference path); C=3 color uses cv2's JOINT semantics (one
    weight per pixel from the L1 color distance; ±1 on ~1e-5 px).  σ ≤ 0
    raises — unpinnable in cv2 5.0 (docs/PARITY.md)."""
    _check_u8(img)
    color = (img.ndim in (3, 4)) and (
        treat_as_hwc(img, channels_last) if img.ndim == 3 else True
    ) and img.shape[-1] == 3
    if img.ndim == 4 and img.shape[-1] not in (1, 3):
        raise ValueError(f"bilateral_filter needs C in (1, 3) like cv2, got {img.shape}")
    if not color and img.ndim == 3 and treat_as_hwc(img, channels_last):
        if img.shape[-1] != 1:
            raise ValueError(f"bilateral_filter needs C in (1, 3) like cv2, got {img.shape}")
    return _bilateral_jit(
        int(d), float(sigma_color), float(sigma_space), color, bool(channels_last)
    )(img)


def box_blur(img, ksize=3, channels_last: bool = True):
    """``cv2.blur(img, Size(kw, kh))`` — normalized box (mean) filter,
    REFLECT_101 border.  ``ksize``: int or (rows, cols), odd dims ≥ 1.
    u8/u16/i16 bit-exact to cv2's SIMD model (cv2's own scalar row tail
    is build-dependent — docs/PARITY.md); f32 at float-conv tolerance."""
    ks = (int(ksize[0]), int(ksize[1])) if isinstance(ksize, (tuple, list)) else int(ksize)
    return _apply("box_blur", img, channels_last, ksize=ks)


@lru_cache(maxsize=None)
def _add_weighted_jit(alpha: float, beta: float, gamma: float):
    from imageenhancement_mp_tpu.ops.pointwise import add_weighted_arrays

    @jax.jit
    def run(a, b):
        return add_weighted_arrays(a, alpha, b, beta, gamma)

    return run


def add_weighted(src1, alpha: float, src2, beta: float, gamma: float = 0.0):
    """``cv2.addWeighted(src1, α, src2, β, γ)`` — exact for u8/u16/i16
    (cvRound + saturate) and bit-identical f32 (cv2's two-FMA chain,
    docs/PARITY.md).  Elementwise: both inputs share any accepted shape."""
    _check_image_dtype(src1, allow_i16=True)
    return _add_weighted_jit(float(alpha), float(beta), float(gamma))(src1, src2)


@lru_cache(maxsize=None)
def _cvt_gray_jit(order: str):
    from imageenhancement_mp_tpu.ops.color import cvt_gray_nhwc

    @jax.jit
    def run(img):
        return cvt_gray_nhwc(img, order)

    return run


def cvt_gray(img, order: str = "rgb"):
    """``cv2.cvtColor(img, COLOR_{RGB,BGR}[A]2GRAY)`` on ``[H,W,C]`` or
    ``[N,H,W,C]``, C ∈ {3,4} (alpha ignored).  u8/u16 exact (15-bit
    sum-preserving fixed point, pinned exhaustively); f32 exact on cv2's
    SIMD vector body, ≤1 ULP on its build-dependent row tail
    (docs/PARITY.md).  The channel axis is dropped: color batches feed
    straight into the 8-bit-only ops (``equalize_hist`` et al.)."""
    _check_image_dtype(img)
    if img.ndim not in (3, 4):
        raise ValueError(f"expected [H,W,C] or [N,H,W,C], got {img.shape}")
    return _cvt_gray_jit(str(order))(img)


def align_mtb(frames, max_bits: int = 6, exclude_range: int = 4,
              cut: bool = True):
    """``cv2.createAlignMTB(...).process`` — median-threshold-bitmap
    alignment of an exposure stack to its middle frame, BIT-EXACT vs
    cv2 (10/10 + 240-shift fuzz; the pinned quirks: floor-sized
    decimation pyramid, getMedian's +1, x-outer tie order).  A host
    control op (the greedy pyramid search is inherently sequential);
    feed the result to ``merge_mertens``.  ``frames``: list or
    ``[T,H,W,3]`` u8 stack; returns a list of aligned frames (cropped
    to the common region when ``cut`` — cv2's own Python binding can't
    deliver the crop, but its C++ contract does)."""
    from imageenhancement_mp_tpu.ref.ops import align_mtb as _align

    if hasattr(frames, "ndim"):
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"expected [T,H,W,3], got {frames.shape}")
        frames = [np.asarray(f) for f in np.asarray(frames)]
    return _align(frames, int(max_bits), int(exclude_range), bool(cut))


@lru_cache(maxsize=None)
def _debevec_jit(times: tuple):
    from imageenhancement_mp_tpu.ops.photo import merge_debevec_nhwc

    @jax.jit
    def run(stack):
        return merge_debevec_nhwc(stack, times)

    return run


def merge_debevec(frames, times):
    """``cv2.createMergeDebevec().process`` — HDR radiance recovery
    (Debevec): joint triangle-weighted log-average of the exposures
    (the pinned law incl. the 1e-6 weight floor and g(0):=0 —
    ref/ops.py).  ``frames``: ``[T,H,W,3]`` u8 stack or list;
    ``times``: exposure seconds per frame.  Returns f32 radiance; run
    ``tonemap`` (or merge with ``merge_mertens`` instead) to display.
    ~2e-6 relative of cv2."""
    if hasattr(frames, "ndim"):
        stack = frames
    else:
        stack = jnp.stack([jnp.asarray(f) for f in frames])
    if stack.ndim != 4 or stack.shape[-1] != 3:
        raise ValueError(f"expected [T,H,W,3] frames, got {stack.shape}")
    if stack.dtype != jnp.uint8:
        raise TypeError(f"merge_debevec expects uint8 frames, got {stack.dtype}")
    t = tuple(float(v) for v in np.asarray(times).ravel())
    if len(t) != stack.shape[0]:
        raise ValueError("times must match the number of frames")
    return _debevec_jit(t)(stack)


@lru_cache(maxsize=None)
def _phasecorr_jit(H: int, W: int, M: int, N: int, windowed: bool):
    @jax.jit
    def run(a, b, *win):
        a = a.astype(jnp.float64) if False else a.astype(jnp.float32)
        b = b.astype(jnp.float32)
        if windowed:
            a = a * win[0]
            b = b * win[0]
        pa = jnp.zeros((M, N), jnp.float32).at[:H, :W].set(a)
        pb = jnp.zeros((M, N), jnp.float32).at[:H, :W].set(b)
        P = jnp.fft.fft2(pa) * jnp.conj(jnp.fft.fft2(pb))
        mag = jnp.abs(P)
        C = jnp.fft.fftshift(jnp.real(jnp.fft.ifft2(
            jnp.where(mag == 0, 0, P / jnp.where(mag == 0, 1, mag)))))
        flat = jnp.argmax(C)
        py, px = flat // N, flat % N
        # clamped 5x5 weighted centroid via a gather
        ys = jnp.clip(py + jnp.arange(-2, 3), 0, M - 1)
        xs = jnp.clip(px + jnp.arange(-2, 3), 0, N - 1)
        box = C[ys][:, xs]
        # clamping duplicates edge rows; zero the duplicates like cv2's
        # clamped BOX (cv2 iterates unique clamped indices)
        uy = jnp.concatenate([jnp.array([True]), ys[1:] != ys[:-1]])
        ux = jnp.concatenate([jnp.array([True]), xs[1:] != xs[:-1]])
        mask2 = uy[:, None] & ux[None, :]
        box = jnp.where(mask2, box, 0.0)
        s = box.sum()
        se = s + jnp.float32(1.2e-38)
        cy = (box * ys[:, None]).sum() / se
        cx = (box * xs[None, :]).sum() / se
        return jnp.stack([N / 2.0 - cx, M / 2.0 - cy]), s

    return run


def phase_correlate(src1, src2, window=None):
    """``cv2.phaseCorrelate`` — FFT sub-pixel translation between two
    equal-size single-channel frames (law pinned in ref/ops.py
    phase_correlate; pair with ``ref.create_hanning_window``).  Returns
    ``((dx, dy), response)``.  The device runs the whole pipeline as
    one jitted complex-FFT program (f32 spectra: shifts track the f64
    oracle to ~1e-2 px; use the oracle for survey-grade accuracy)."""
    from imageenhancement_mp_tpu.ref.ops import _optimal_dft_size

    H, W = src1.shape
    if src2.shape != (H, W):
        raise ValueError("phase_correlate expects equal-shape 2-D inputs")
    M, N = _optimal_dft_size(H), _optimal_dft_size(W)
    fn = _phasecorr_jit(H, W, M, N, window is not None)
    if window is None:
        sh, resp = fn(jnp.asarray(src1), jnp.asarray(src2))
    else:
        sh, resp = fn(jnp.asarray(src1), jnp.asarray(src2),
                      jnp.asarray(window, jnp.float32))
    sh = np.asarray(sh)
    return (float(sh[0]), float(sh[1])), float(resp)


@lru_cache(maxsize=None)
def _spatial_gradient_jit(border: str, channels_last: bool):
    from imageenhancement_mp_tpu.ops.filters import spatial_gradient_planes

    @jax.jit
    def run(img):
        planes, restore = as_planes(img, channels_last=channels_last)
        dx, dy = spatial_gradient_planes(planes, border)
        return restore(dx), restore(dy)

    return run


def spatial_gradient(img, border: str = "reflect101", channels_last: bool = True):
    """``cv2.spatialGradient`` — exact: the (dx, dy) Sobel-3 pair in one
    jitted program (uint8 in, int16 out; border reflect101 | replicate —
    cv2's only two).  Probe: bitwise == the two cv2.Sobel calls."""
    _check_u8(img)
    if border not in ("reflect101", "replicate"):
        raise ValueError("border must be 'reflect101' or 'replicate'")
    return _spatial_gradient_jit(str(border), bool(channels_last))(img)


@lru_cache(maxsize=None)
def _sqr_box_jit(ksize, normalize: bool, channels_last: bool):
    from imageenhancement_mp_tpu.ops.filters import sqr_box_filter_planes

    @jax.jit
    def run(img):
        planes, restore = as_planes(img, channels_last=channels_last)
        return restore(sqr_box_filter_planes(planes, ksize, normalize))

    def call(img):
        with jax.enable_x64(True):
            return run(img)

    return call


def sqr_box_filter(img, ksize=3, normalize: bool = True,
                   channels_last: bool = True):
    """``cv2.sqrBoxFilter`` (ddepth → CV_32F) — REFLECT_101 window sums
    of squares; s64/f64 on device (x64 scope, like the u16 NLMeans).
    Bitwise vs cv2 everywhere except u8 ``normalize=True`` (±1 ulp on
    ≲1 % px — cv2's IPP reciprocal kernel; docs/PARITY.md)."""
    _check_image_dtype(img, allow_i16=True)
    ks = (int(ksize[0]), int(ksize[1])) if isinstance(ksize, (tuple, list)) else int(ksize)
    return _sqr_box_jit(ks, bool(normalize), bool(channels_last))(img)


@lru_cache(maxsize=None)
def _blend_linear_jit(u8: bool):
    @jax.jit
    def run(a, b, w1, w2):
        w1 = w1.astype(jnp.float32)
        w2 = w2.astype(jnp.float32)
        den = w1 + w2 + jnp.float32(1e-5)
        if a.ndim == 3:
            w1, w2, den = w1[..., None], w2[..., None], den[..., None]
        # cv2 rounds each product separately; XLA's CPU and GPU codegen
        # contract mul+add into fma regardless of barriers/bitcasts
        # (probed), and elide plain f64→f32→f64 convert round-trips.
        # reduce_precision is the one rounding XLA must honor: the exact
        # f64 product snapped to the f32 grid feeds an un-contractable
        # add, making the result bitwise.
        p1 = jax.lax.reduce_precision(
            a.astype(jnp.float64) * w1.astype(jnp.float64), 8, 23
        ).astype(jnp.float32)
        p2 = jax.lax.reduce_precision(
            b.astype(jnp.float64) * w2.astype(jnp.float64), 8, 23
        ).astype(jnp.float32)
        num = p1 + p2
        # XLA's f32 divide is reciprocal-based (≤2 ulp); divide in f64
        # instead — double rounding f64→f32 of a quotient of two f32s
        # is provably exact (2p+2-bit innocuous-double-rounding bound).
        # The quotient is snapped to the f32 grid by reduce_precision
        # before the convert: XLA:GPU's f64→f32 convert of the quotient
        # alone came out up to 2 ulp off (probed on an H100).
        out = jax.lax.reduce_precision(
            num.astype(jnp.float64) / den.astype(jnp.float64), 8, 23
        ).astype(jnp.float32)
        if u8:
            return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)
        return out

    def call(a, b, w1, w2):
        with jax.enable_x64(True):
            return run(a, b, w1, w2)

    return call


def blend_linear(src1, src2, weights1, weights2):
    """``cv2.blendLinear`` — bitwise-pinned f32 law
    ``(src1·w1 + src2·w2)/(w1 + w2 + 1e-5)``; u8 rounds half-even and
    saturates, f32 returns the raw quotient.  ``weights*`` are [H,W]
    f32 shared across channels (ref/ops.py blend_linear).  Device:
    bitwise on the CPU and GPU backends, u8 and f32 (docs/PARITY.md)."""
    if src1.shape != src2.shape:
        raise ValueError("sources must share shape")
    if src1.dtype not in (jnp.uint8, jnp.float32):
        raise TypeError(f"blendLinear supports uint8/float32, got {src1.dtype}")
    return _blend_linear_jit(src1.dtype == jnp.uint8)(
        src1, src2, jnp.asarray(weights1), jnp.asarray(weights2))


@lru_cache(maxsize=None)
def _distance_transform_jit(dt: str, mask: int, dst: str, channels_last: bool):
    from imageenhancement_mp_tpu.ops.distance import distance_transform_planes

    @jax.jit
    def run(img):
        planes, restore = as_planes(img, channels_last=channels_last)
        return restore(distance_transform_planes(planes, dt, mask, dst))

    return run


def distance_transform(img, distance_type: str = "l2", mask_size: int = 3,
                       dst_type: str = "f32", channels_last: bool = True):
    """``cv2.distanceTransform`` — two-pass chamfer as a sheared-wavefront
    ``lax.scan`` (O(2H+W) sequential steps, not O(H·W)).  Zero pixels are
    sources.  BITWISE vs cv2 for L1 | C | L2-mask5; L2-mask3 follows
    cv2's portable float law (default-build IPP route deviates ≤1e-6
    relative — docs/PARITY.md).  ``dst_type='u8'`` (L1 only, like cv2)
    saturate-casts the f32 field."""
    _check_u8(img)
    dt = str(distance_type).lower()
    if dt not in ("l1", "l2", "c"):
        raise ValueError(f"distance_type must be l1|l2|c, got {distance_type!r}")
    if int(mask_size) not in (3, 5):
        raise ValueError(f"mask_size must be 3 or 5, got {mask_size}")
    if dst_type not in ("f32", "u8"):
        raise ValueError(f"dst_type must be f32|u8, got {dst_type!r}")
    if dst_type == "u8" and dt != "l1":
        raise ValueError("dst_type='u8' requires distance_type='l1' (cv2)")
    return _distance_transform_jit(dt, int(mask_size), str(dst_type),
                                   bool(channels_last))(img)


@lru_cache(maxsize=None)
def _flood_region_jit(shape, conn: int, fixed: bool):
    from imageenhancement_mp_tpu.ops.floodfill import flood_region

    @jax.jit
    def run(img, blocked, sy, sx, lo, up):
        return flood_region(img, blocked, (sy, sx), lo, up, conn, fixed)

    return run


def flood_fill(img, seed_point, new_val, lo_diff=0, up_diff=0,
               connectivity: int = 4, fixed_range: bool = False,
               mask=None, mask_only: bool = False, mask_fill: int = 1):
    """``cv2.floodFill`` — returns ``(n, image, mask, rect)`` exactly
    like cv2 (filled count, filled image, (H+2, W+2) mask with the
    border ring set to 1 and ``mask_fill`` in filled cells, (x, y, w, h)
    rect).  ``seed_point`` is (x, y).  The region is grown on device as
    a ``lax.while_loop`` fixpoint (schedule-independent — acceptance
    depends only on original pixel values; ref/ops.py flood_fill pins
    the semantics, 150-config fuzz exact incl. masks/blocked/color)."""
    arr = np.asarray(img)
    if arr.dtype not in (np.uint8, np.uint16, np.float32):
        raise TypeError(f"floodFill supports uint8/uint16/float32, got {arr.dtype}")
    gray = arr.ndim == 2
    if not gray and (arr.ndim != 3 or arr.shape[2] > 4):
        raise ValueError(f"expected [H,W] or [H,W,C<=4], got {arr.shape}")
    H, W = arr.shape[:2]
    C = 1 if gray else arr.shape[2]
    x0, y0 = int(seed_point[0]), int(seed_point[1])
    if not (0 <= x0 < W and 0 <= y0 < H):
        raise ValueError(f"seed {seed_point} outside {W}x{H} image")
    conn = int(connectivity) or 4
    if conn not in (4, 8):
        raise ValueError("connectivity must be 4 or 8")
    out_mask = (np.zeros((H + 2, W + 2), np.uint8) if mask is None
                else np.array(mask, np.uint8, copy=True))
    if out_mask.shape != (H + 2, W + 2):
        raise ValueError("mask must be (H+2, W+2) uint8")
    blocked = out_mask[1:-1, 1:-1] != 0
    out_mask[0, :] = 1
    out_mask[-1, :] = 1
    out_mask[:, 0] = 1
    out_mask[:, -1] = 1
    lo = np.broadcast_to(np.abs(np.asarray(lo_diff, np.float32)).reshape(-1), (C,))
    up = np.broadcast_to(np.abs(np.asarray(up_diff, np.float32)).reshape(-1), (C,))
    run = _flood_region_jit((H, W, C), conn, bool(fixed_range))
    region, n, rect = run(
        jnp.asarray(arr.reshape(H, W, C), jnp.float32),
        jnp.asarray(blocked), jnp.int32(y0), jnp.int32(x0),
        jnp.asarray(lo), jnp.asarray(up))
    region = np.asarray(region)
    n = int(n)
    out = arr.copy()
    if n == 0:
        return 0, out, out_mask, (0, 0, 0, 0)
    rect = tuple(int(v) for v in rect)
    out_mask[1:-1, 1:-1][region] = np.uint8(mask_fill if mask_fill else 1)
    if not mask_only:
        nv = np.broadcast_to(np.asarray(new_val, np.float64).reshape(-1), (C,))
        if arr.dtype == np.uint8:
            fillv = np.clip(np.rint(nv), 0, 255).astype(np.uint8)
        elif arr.dtype == np.uint16:
            fillv = np.clip(np.rint(nv), 0, 65535).astype(np.uint16)
        else:
            fillv = nv.astype(arr.dtype)
        out[region] = fillv[0] if gray else fillv
    return n, out, out_mask, rect


def corner_min_eigen_val(img, block_size: int = 3, ksize: int = 3,
                         channels_last: bool = True):
    """``cv2.cornerMinEigenVal`` — f32 response at f32-ulp-class
    tolerance (~5e-7 rel; the min-eigen subtraction cancels on edges so
    absolute ulp counts are meaningless — docs/PARITY.md)."""
    _check_u8(img)
    return _apply("corner_min_eigen_val", img, channels_last,
                  block_size=int(block_size), ksize=int(ksize))


def good_features_to_track(img, max_corners: int = 0,
                           quality_level: float = 0.01,
                           min_distance: float = 10.0, mask=None,
                           block_size: int = 3, gradient_size: int = 3,
                           use_harris: bool = False, k: float = 0.04):
    """``cv2.goodFeaturesToTrack`` — [N, 2] f32 (x, y) corners.

    The response map (minEigenVal or Harris) runs on device; the pinned
    selection chain (threshold → 3x3 NMS → stable response-desc sort →
    grid min-distance greedy, 120-config fuzz EXACT given cv2's own
    response) runs on host over the fetched map.  End-to-end parity is
    f32-ulp-class: razor ties at threshold/NMS boundaries may flip vs
    cv2 (docs/PARITY.md)."""
    _check_u8(img)
    if np.asarray(img).ndim != 2:
        raise ValueError("goodFeaturesToTrack expects a single [H,W] image")
    resp = np.asarray(
        corner_harris(img, block_size, gradient_size, k) if use_harris
        else corner_min_eigen_val(img, block_size, gradient_size))
    from imageenhancement_mp_tpu.ref.ops import good_features_to_track as _gft

    return _gft(np.asarray(img), int(max_corners), float(quality_level),
                float(min_distance), None if mask is None else np.asarray(mask),
                int(block_size), int(gradient_size), bool(use_harris),
                float(k), response=resp)


@lru_cache(maxsize=None)
def _hough_acc_jit(shape, tabkey, numrho: int):
    from imageenhancement_mp_tpu.ops.hough import hough_accumulator
    tabcos, tabsin = _HOUGH_TABS[tabkey]

    @jax.jit
    def run(img):
        return hough_accumulator(img, tabcos, tabsin, numrho)

    def call(img):
        with jax.enable_x64(True):
            return run(img)

    return call


_HOUGH_TABS = {}


def find_contours(img, mode: str = "list", method: str = "simple"):
    """``cv2.findContours`` — (contours, hierarchy); content, ORDER and
    hierarchy bit-exact vs cv2 for all four modes x both methods
    (0/640 fuzz).  Host helper: Suzuki-Abe border following is an
    inherently sequential erase-as-you-walk scan (ref/ops.py
    ``find_contours``); pair it with device thresholds/morphology for
    the segmentation front."""
    from imageenhancement_mp_tpu.ref.ops import find_contours as _fc

    return _fc(np.asarray(img), mode, method)


def contour_area(points, oriented: bool = False):
    """``cv2.contourArea`` — bit-exact Green's-theorem area."""
    from imageenhancement_mp_tpu.ref.ops import contour_area as _f

    return _f(points, oriented)


def arc_length(points, closed: bool):
    """``cv2.arcLength`` — bit-exact (f32-sqrt buffered law)."""
    from imageenhancement_mp_tpu.ref.ops import arc_length as _f

    return _f(points, closed)


def bounding_rect(points):
    """``cv2.boundingRect`` — (x, y, w, h), exact."""
    from imageenhancement_mp_tpu.ref.ops import bounding_rect as _f

    return _f(points)


def contour_moments(points):
    """``cv2.moments`` on a point-list contour (Green closed forms;
    ≤1e-11 rel — cv2's fp-contract class, docs/PARITY.md)."""
    from imageenhancement_mp_tpu.ref.ops import contour_moments as _f

    return _f(points)


def moments(img, binary_image: bool = False):
    """``cv2.moments`` on a grayscale image (raw m, central mu,
    normalized nu keys like cv2).  Raw m are bitwise-equal to cv2;
    mu/nu/Hu land within ~1e-12 relative (cv2 builds use FMA contraction
    in the completion formulas — docs/PARITY.md evaluation-order class).

    Host f64 form (it feeds the exact hu_moments/match_shapes chain);
    inside device pipelines use :func:`moments_device` — this one
    fetches the image to the host (d2h poison, docs/DESIGN.md §9)."""
    from imageenhancement_mp_tpu.ref.ops import moments as _f

    return _f(np.asarray(img), binary_image)


def moments_device(img, binary_image: bool = False):
    """``cv2.moments`` as a DEVICE reduction → dict of 0-d f32 jax
    scalars (same 24 keys as cv2/:func:`moments`).  All x^p·y^q·I sums
    run in double-float (~2^-45 relative of the f64 oracle — within
    cv2's own build-to-build mu/nu FMA budget class); each returned
    entry rounds once to f32.  No d2h — safe inside streaming loops."""
    from imageenhancement_mp_tpu.ops.stats import MOMENT_KEYS

    v = _stats_jit("moments", binary_image=bool(binary_image))(img)
    return {k: v[i] for i, k in enumerate(MOMENT_KEYS)}


def hu_moments(m):
    """``cv2.HuMoments`` — the seven invariants from a ``moments()`` /
    ``contour_moments()`` dict (exact closed forms)."""
    from imageenhancement_mp_tpu.ref.ops import hu_moments as _f

    return _f(m)


def match_shapes(a, b, method: str = "i1"):
    """``cv2.matchShapes`` on grayscale images — log-Hu distances for
    methods I1/I2/I3 with cv2's 1e-5/eps significance gates."""
    from imageenhancement_mp_tpu.ref.ops import match_shapes as _f

    return _f(np.asarray(a), np.asarray(b), method)


def convex_hull(points, clockwise: bool = False,
                return_points: bool = True):
    """``cv2.convexHull`` — bit-exact for distinct points (indices and
    order); duplicate points: same polygon, tie order build-dependent
    (docs/PARITY.md)."""
    from imageenhancement_mp_tpu.ref.ops import convex_hull as _f

    return _f(points, clockwise, return_points)


def is_contour_convex(points):
    """``cv2.isContourConvex`` — exact."""
    from imageenhancement_mp_tpu.ref.ops import is_contour_convex as _f

    return _f(points)


def point_polygon_test(contour, pt, measure_dist: bool = False):
    """``cv2.pointPolygonTest`` — exact crossing test / signed f64
    distance."""
    from imageenhancement_mp_tpu.ref.ops import point_polygon_test as _f

    return _f(contour, pt, measure_dist)


def convexity_defects(contour, hull_indices):
    """``cv2.convexityDefects`` — bit-exact [N,4] defects."""
    from imageenhancement_mp_tpu.ref.ops import convexity_defects as _f

    return _f(contour, hull_indices)


def mean_shift(prob_image, window, max_count: int = 100,
               epsilon: float = 1.0):
    """``cv2.meanShift`` — bit-exact window tracking on a back-
    projection map (integer centroid dynamics); pairs with
    ``calc_back_project``.  Returns (iterations, (x, y, w, h))."""
    from imageenhancement_mp_tpu.ref.ops import mean_shift as _f

    return _f(np.asarray(prob_image), window, max_count, epsilon)


def cam_shift(prob_image, window, max_count: int = 100,
              epsilon: float = 1.0):
    """``cv2.CamShift`` — meanShift + oriented-box estimate.  The
    rotated box is f32-exact vs cv2; the returned search window
    matches in ~89 % of configs (cv2's window-extent micro-rule is
    unpinned — ±small-int extents; docs/PARITY.md)."""
    from imageenhancement_mp_tpu.ref.ops import cam_shift as _f

    return _f(np.asarray(prob_image), window, max_count, epsilon)


@lru_cache(maxsize=None)
def _pms_jit(sp: float, sr: float, max_level: int, max_count: int,
             epsilon: float, batched: bool):
    from imageenhancement_mp_tpu.ops.meanshift import pyr_mean_shift_planes

    def run(img):
        return pyr_mean_shift_planes(img, sp, sr, max_level, max_count,
                                     epsilon)

    return jax.jit(jax.vmap(run) if batched else run)


def pyr_mean_shift_filtering(img, sp: float, sr: float, max_level: int = 1,
                             max_count: int = 5, epsilon: float = 1.0):
    """``cv2.pyrMeanShiftFiltering`` — color mean-shift segmentation,
    BIT-EXACT on device (dense masked-lane iteration, int32-resolved
    ``cvRound(sum/count)`` razor ties; ops/meanshift.py, docs/PARITY.md
    "Mean-shift segmentation").  ``img`` is u8 ``[H,W,3]`` or batched
    ``[N,H,W,3]``; termcrit mirrors cv2 (COUNT+EPS, 5, 1.0)."""
    img = jnp.asarray(img)
    _check_u8(img)
    if img.ndim not in (3, 4) or img.shape[-1] != 3:
        raise ValueError("pyr_mean_shift_filtering expects [H,W,3] or "
                         "[N,H,W,3] uint8")
    if not 0 <= int(max_level) <= 8:
        raise ValueError("max_level must be in [0, 8]")
    fn = _pms_jit(float(sp), float(sr), int(max_level), int(max_count),
                  float(epsilon), img.ndim == 4)
    return fn(img)


def get_gaussian_kernel(ksize: int, sigma: float = 0.0):
    """``cv2.getGaussianKernel`` — bit-exact f64 column kernel."""
    from imageenhancement_mp_tpu.ref.ops import get_gaussian_kernel as _f

    return _f(int(ksize), float(sigma))


def get_deriv_kernels(dx: int, dy: int, ksize: int,
                      normalize: bool = False):
    """``cv2.getDerivKernels`` — bit-exact Sobel/Scharr taps."""
    from imageenhancement_mp_tpu.ref.ops import get_deriv_kernels as _f

    return _f(int(dx), int(dy), int(ksize), bool(normalize))


def min_area_rect(points):
    """``cv2.minAreaRect`` — ((cx,cy),(w,h),angle); corners agree with
    cv2 to ≤1e-3 px (f64 rotating calipers vs cv2's f32 chain)."""
    from imageenhancement_mp_tpu.ref.ops import min_area_rect as _f

    return _f(points)


def box_points(rect):
    """``cv2.boxPoints`` — the 4 corners of a rotated rect."""
    from imageenhancement_mp_tpu.ref.ops import box_points as _f

    return _f(rect)


def min_enclosing_circle(points):
    """``cv2.minEnclosingCircle`` — ((cx,cy),r), ≤1e-3 vs cv2."""
    from imageenhancement_mp_tpu.ref.ops import min_enclosing_circle as _f

    return _f(points)


def fit_line(points, dist_type: str = "l2", param: float = 0.0,
             reps: float = 0.01, aeps: float = 0.01):
    """``cv2.fitLine`` — L2 closed form ~1e-6 vs cv2; robust types are
    the documented IRLS approximation (ref/ops.py ``fit_line``)."""
    from imageenhancement_mp_tpu.ref.ops import fit_line as _f

    return _f(points, dist_type, param, reps, aeps)


def fit_ellipse(points):
    """``cv2.fitEllipse`` — direct least squares; center/axes/angle
    agree with cv2 to ≲0.03 aggregate on clean samples."""
    from imageenhancement_mp_tpu.ref.ops import fit_ellipse as _f

    return _f(points)


def approx_poly_dp(curve, epsilon, closed: bool):
    """``cv2.approxPolyDP`` — BIT-EXACT polygon simplification (cv2
    5.0's distance-to-segment law; 0/11784 fuzz, int + f32 curves)."""
    from imageenhancement_mp_tpu.ref.ops import approx_poly_dp as _f

    return _f(curve, float(epsilon), bool(closed))


def hough_lines_p(img, rho: float = 1.0, theta: float = np.pi / 180,
                  threshold: int = 100, min_line_length: int = 0,
                  max_line_gap: int = 0, lines_max: int = 2 ** 31 - 1):
    """``cv2.HoughLinesP`` — probabilistic Hough segments, BIT-EXACT
    [N, 4] int32 (x1, y1, x2, y2) incl. cv2's local RNG stream and
    erase-as-you-walk accumulator (160-config fuzz, 0 mismatches).

    Host helper by design: the algorithm is inherently sequential —
    each random candidate mutates the mask and accumulator the next
    candidate reads (ref/ops.py ``hough_lines_p``; the standard
    ``hough_lines`` keeps the device-accumulator path)."""
    from imageenhancement_mp_tpu.ref.ops import hough_lines_p as _hlp

    return _hlp(np.asarray(img), float(rho), float(theta), int(threshold),
                int(min_line_length), int(max_line_gap), int(lines_max))


def hough_lines(img, rho: float = 1.0, theta: float = np.pi / 180,
                threshold: int = 100, min_theta: float = 0.0,
                max_theta: float = np.pi):
    """``cv2.HoughLines`` (standard) — BIT-EXACT [N, 2] (rho, theta)
    f32 lines (100-config fuzz 0 mismatches; full pinned law in
    ref/ops.py hough_lines).  The vote accumulator runs on device; the
    tiny threshold/NMS/sort selection runs on the fetched accumulator
    via the same pinned host logic."""
    from imageenhancement_mp_tpu.ref.ops import (_hough_numangle,
                                                 _hough_select)

    arr = np.asarray(img)
    if arr.dtype != np.uint8 or arr.ndim != 2:
        raise TypeError("HoughLines expects a single [H,W] uint8 image")
    H, W = arr.shape
    f32 = np.float32
    numangle = _hough_numangle(float(min_theta), float(max_theta), float(theta))
    numrho = int(np.rint(((W + H) * 2 + 1) / rho))
    irho = 1.0 / float(rho)
    ang = np.empty(numangle)
    a = f32(min_theta)
    step = f32(theta)
    for i in range(numangle):
        ang[i] = np.float64(a)
        a = f32(a + step)
    key = (round(float(min_theta), 12), round(float(theta), 12),
           round(float(rho), 12), numangle)
    _HOUGH_TABS[key] = ((np.cos(ang) * irho).astype(f32),
                        (np.sin(ang) * irho).astype(f32))
    acc = np.asarray(_hough_acc_jit((H, W), key, numrho)(jnp.asarray(arr)))
    pad = np.zeros((numangle + 2, numrho + 2), np.int32)
    pad[1:-1, 1:-1] = acc
    return _hough_select(pad, numangle, numrho, int(threshold), float(rho),
                         float(min_theta), float(theta))


def inpaint(img, mask, inpaint_radius: float = 3.0, flags: str = "telea"):
    """``cv2.inpaint`` (Telea fast-marching) on a grayscale u8 image.

    Host helper BY DESIGN, like findContours/HoughLinesP: the FMM is a
    priority-queue greedy fill where every painted pixel feeds the next
    pop's neighborhood — inherently sequential (ref/inpaint.py).

    **The one budgeted op in this API**: the oracle transcribes cv2's
    band/ring FMM structure, Eikonal solve, and Telea weight law, but the
    exact outside-T capture rule resists black-box extraction (two rounds
    of delta/2-px-mask weight probes — docs/PARITY.md "inpaint").
    Measured agreement: ≥95 % of pixels exact, mean ≈3–5 LSB over masked
    pixels on random content (tests/test_inpaint.py pins the budget)."""
    if flags != "telea":
        raise ValueError(
            "only INPAINT_TELEA is implemented (flags='telea'); cv2's "
            "INPAINT_NS iterative solver is not transcribed yet")
    from imageenhancement_mp_tpu.ref.inpaint import inpaint_telea

    return inpaint_telea(np.asarray(img), np.asarray(mask),
                         float(inpaint_radius))


def stack_blur(img, ksize, channels_last: bool = True):
    """``cv2.stackBlur`` — u8, ``ksize`` int or (rows, cols), odd.

    DEVICE op (two integer running-sum passes per axis + the pinned
    fixed-point descale).  Budgeted: cv2's row edges are SIMD-lane
    scheduled (docs/PARITY.md); interior ±1, edge columns up to ~±5 at
    large radii.  Kernel dims must not exceed the image dims."""
    kh, kw = (ksize, ksize) if isinstance(ksize, int) else (int(ksize[0]), int(ksize[1]))
    return _apply("stack_blur", img, channels_last, ksize=(kh, kw))


def seamless_clone(src, dst, mask, p, flags: str = "normal"):
    """``cv2.seamlessClone`` (NORMAL_CLONE) — Poisson image editing.

    DEVICE op: the Dirichlet Poisson solve runs as type-1 sine
    transforms (odd-extension FFTs) over the separable 5-point-Laplacian
    eigenvalues — one jitted program per patch shape; geometry (mask
    bbox, paste rect at center ``p`` (x, y)) is host-static.

    Contract: cv2's own seamlessClone is NONDETERMINISTIC (repeated
    identical calls differ by up to ~75 LSB over the ROI —
    docs/PARITY.md), so parity is defined against the op's MATHEMATICAL
    definition: the f64 oracle ``ref.seamless.seamless_clone`` solves
    known fields to ~1e-13, cloning src onto itself is the identity,
    and the device path tracks the oracle to ~1 LSB; agreement with
    cv2's outputs lands within cv2's own run-to-run spread."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    m = np.asarray(mask) != 0
    if src.dtype != np.uint8 or dst.dtype != np.uint8:
        raise TypeError("seamless_clone: uint8 images only")
    if flags != "normal":
        raise ValueError("only NORMAL_CLONE is implemented (flags='normal')")
    ys, xs = np.nonzero(m)
    if ys.size == 0:
        return jnp.asarray(dst)
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    h, w = y1 - y0, x1 - x0
    cx, cy = int(p[0]), int(p[1])
    dy0, dx0 = cy - h // 2, cx - w // 2
    if dy0 < 0 or dx0 < 0 or dy0 + h > dst.shape[0] or dx0 + w > dst.shape[1]:
        raise ValueError("pasted ROI falls outside dst")
    from imageenhancement_mp_tpu.ops.seamless import seamless_clone_patch

    def planes(a, sl_y, sl_x):
        a = a[sl_y, sl_x]
        return a[None] if a.ndim == 2 else np.moveaxis(a, -1, 0)

    sp = planes(src, slice(y0, y1), slice(x0, x1))
    dp = planes(dst, slice(dy0, dy0 + h), slice(dx0, dx0 + w))
    blended = np.asarray(seamless_clone_patch(
        jnp.asarray(sp), jnp.asarray(dp), m[y0:y1, x0:x1]))
    out = dst.copy()
    patch = blended[0] if src.ndim == 2 else np.moveaxis(blended, 0, -1)
    out[dy0:dy0 + h, dx0:dx0 + w] = patch
    return jnp.asarray(out)
