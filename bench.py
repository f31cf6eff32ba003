"""Benchmark harness (BASELINE.json:2): GPix/s per device + max-LSB parity.

Prints ONE JSON line last:
    {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, "device": {...}}

Headline metric: fused hist-eq + unsharp throughput on 1080p grayscale
(north star, BASELINE.json:2).  vs_baseline is the speedup over the
reference backend: OpenCV 5.0.0, 1 CPU thread, 0.607 GPix/s on the same
pipeline (BASELINE.md).

Timing (phase 1) is the blocked wall-clock median over ``--iters`` calls
after a warm-up; parity against the ``ref/`` oracle runs afterwards
(phase 2).  Every line names the device (``device_kind``, platform, count)
and, on a GPU, the card's nvidia-smi name and power limit.  Extra rows
(all five judged configs and more) go to stderr; run with --all.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

BASELINES = {  # GPix/s, reference backend: OpenCV 5.0.0 single-thread (BASELINE.md)
    "histeq+unsharp 1080p gray b8": 0.607,
    "histeq+unsharp 4K gray b2": 0.294,
    "equalize_hist 512x512": 1.657,
    "gamma+stretch 1080p rgb b32": 0.939,  # LUT gamma + per-channel normalize
    "unsharp 1080p gray b8": 0.963,
    "gaussian5 1080p gray b8": 1.339,
    "gaussian5 4K gray b2": 0.874,
    "median3 1080p gray b8": 1.729,
    "median5 1080p gray b8": 0.750,
    "median5 4K gray b2": 0.722,
    "clahe 4K rgb": 0.156,  # per-channel cv2 CLAHE on 4K RGB
    "median5>clahe>unsharp 4K gray b2": 0.122,
    "box5 4K gray b2": 3.581,  # cv2.blur running sums are fast on CPU
    "resize/lin 4K->1440p gray b2": 3.055,   # cv2 u8 bilinear (non-integer scale)
    "resize/area 4K->1440p gray b2": 0.512,  # cv2 general area path
    "canny 4K gray b2": 0.0413,              # cv2.Canny 60/160 single-thread
    "nlmeans 1080p gray": 0.0004,            # cv2.fastNlMeansDenoising h=10 7/21
    "warp/rot15 4K gray b2": 0.264,          # cv2.warpAffine rotation
    "bilateral9 4K gray b2": 0.0674,  # cv2.bilateralFilter d=9 (IPP path)
    "sobel3 4K gray b2": 1.883,  # cv2.Sobel CV_16S
    "open3 4K gray b2": 3.853,  # cv2.morphologyEx MORPH_OPEN 3x3
    "athresh/gauss11 4K gray b2": 0.243,  # cv2.adaptiveThreshold GAUSSIAN_C
    "resize/lanczos4 4K->1440p gray b2": 0.250,  # cv2 INTER_LANCZOS4
    "warp_polar 4K gray b2": 0.242,   # cv2.warpPolar linear fwd
    "cvt/hls 1080p rgb b8": 1.671,    # cv2.cvtColor RGB2HLS (elements/s)
    "warp/cubic 4K gray b2": 0.111,   # cv2.warpAffine INTER_CUBIC
    "warp/lanczos4 4K gray b2": 0.033,  # cv2.warpAffine INTER_LANCZOS4
    "remap/cubic 4K gray b2": 0.113,  # cv2.remap INTER_CUBIC (swirl maps)
    "tonemap/reinhard 1080p rgb": 0.021,  # cv2.createTonemapReinhard
    "tonemap/drago 1080p rgb": 0.028,     # cv2.createTonemapDrago
    "tonemap/mantiuk 1080p rgb": 0.0055,  # cv2.createTonemapMantiuk (100-iter CG)
    "cvt/luv 1080p rgb b8": 0.132,    # cv2.cvtColor RGB2Luv (packed path)
    "dist/l2m3 1080p gray": 0.0957,  # cv2.distanceTransform L2 mask3
    "clahe/u16 4K gray b2": 0.049,
    "median5/u16 4K gray b2": 0.395,
    "gaussian5/u16 4K gray b2": 0.497,
    "median5/i16 4K gray b2": 0.430,
    "gaussian5/i16 4K gray b2": 1.367,
}


# MINIMUM-TRAFFIC model per suite row: bytes moved over HBM per *input
# element* by an ideal implementation (perfect fusion, each pass reading/
# writing each element exactly once; gather windows counted once).  This
# gives effective GB/s = GPix/s x bytes/px per row.  Rows absent here
# get no GB/s column.
BYTES_PER_PX = {
    # u8 in -> u8 out, one global-state pass (hist/minmax) + apply pass
    "histeq+unsharp 1080p gray b8": 3.0,  # hist read + apply read + write
    "histeq+unsharp 4K gray b2": 3.0,
    "equalize_hist 512x512": 3.0,
    "gamma+stretch 1080p rgb b32": 3.0,   # minmax read + LUT read + write
    "clahe 4K rgb": 3.0,                  # tile-hist read + blend read + write
    "median5>clahe>unsharp 4K gray b2": 7.0,  # med(2) + clahe(3) + unsharp(2)
    "clahe/u16 4K gray b2": 6.0,          # 3 passes x 2-byte elements
    # single-pass u8 stencils / pointwise: read + write
    "unsharp 1080p gray b8": 2.0,
    "gaussian5 1080p gray b8": 2.0,
    "gaussian5 4K gray b2": 2.0,
    "median3 1080p gray b8": 2.0,
    "median5 1080p gray b8": 2.0,
    "median5 4K gray b2": 2.0,
    "box5 4K gray b2": 2.0,
    "bilateral9 4K gray b2": 2.0,
    "open3 4K gray b2": 2.0,              # erode+dilate fused w/ halo
    "athresh/gauss11 4K gray b2": 2.0,    # threshold fused into conv epilogue
    "nlmeans 1080p gray": 2.0,
    "cvt/hls 1080p rgb b8": 2.0,
    "cvt/luv 1080p rgb b8": 2.0,
    "sobel3 4K gray b2": 3.0,             # u8 read + i16 write
    # geometry: source read + (smaller) dest write, per input px
    "resize/lin 4K->1440p gray b2": 1.444,
    "resize/area 4K->1440p gray b2": 1.444,
    "resize/lanczos4 4K->1440p gray b2": 1.444,
    "warp/rot15 4K gray b2": 2.0,
    "warp/cubic 4K gray b2": 2.0,
    "warp/lanczos4 4K gray b2": 2.0,
    "warp_polar 4K gray b2": 1.444,       # dest 1920x2160 per 3840x2160 src
    "remap/cubic 4K gray b2": 10.0,       # 2 f32 maps (8) + src + dest
    # u16/i16 stencils: 2-byte read + write
    "median5/u16 4K gray b2": 4.0,
    "gaussian5/u16 4K gray b2": 4.0,
    "median5/i16 4K gray b2": 4.0,
    "gaussian5/i16 4K gray b2": 4.0,
    # f32 HDR: per-element f32 traffic, log-mean pass + apply pass
    "tonemap/reinhard 1080p rgb": 12.0,
    "tonemap/drago 1080p rgb": 12.0,
    "tonemap/mantiuk 1080p rgb": 12.0,
    # u8 read + f32 write + one f32 read-write relaxation sweep
    "dist/l2m3 1080p gray": 13.0,
    # canny: data-dependent fixpoint — model the 3 fixed passes only
    # (grad+nms+thresh fused, hysteresis rw, final map); real traffic is
    # iteration-count dependent, so its roofline-% is an upper bound
    "canny 4K gray b2": 6.0,
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true", help="run all judged configs")
    ap.add_argument(
        "--rows",
        default=None,
        metavar="REGEX",
        help="run only the suite rows whose name matches REGEX (implies the "
        "--all suite)",
    )
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--no-parity", action="store_true", help="skip parity phase")
    ap.add_argument(
        "--json-out",
        default=None,
        help="also write the full per-config table as JSON to this path",
    )
    ap.add_argument(
        "--profile",
        metavar="DIR",
        default=None,
        help="capture a jax.profiler trace of the headline config into DIR",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import imageenhancement_mp_tpu as ie
    from imageenhancement_mp_tpu import ref
    from imageenhancement_mp_tpu.models.presets import get_preset
    from imageenhancement_mp_tpu.pipeline import equalize_unsharp
    from imageenhancement_mp_tpu.profiling import gpu_name_and_power, time_op
    from imageenhancement_mp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    card = gpu_name_and_power() if dev.platform == "gpu" else "no GPU"
    tag = f"[{dev.device_kind} ({dev.platform} x{device['count']}); {card}]"
    print(f"device: {tag}", file=sys.stderr)
    rng = np.random.default_rng(0)

    b1080 = rng.integers(0, 256, (8, 1080, 1920), dtype=np.uint8)
    b4k = rng.integers(0, 256, (2, 2160, 3840), dtype=np.uint8)

    def gray_oracle(op):
        """Per-plane oracle over a [N,H,W] batch."""
        return lambda x: np.stack([op(p) for p in x])

    def rgb_oracle(op):
        """Per-plane oracle over a [N,H,W,C] batch."""
        return lambda x: np.stack(
            [
                np.stack([op(x[n, :, :, c]) for c in range(x.shape[-1])], axis=-1)
                for n in range(x.shape[0])
            ]
        )

    suite = [
        (
            "histeq+unsharp 1080p gray b8",
            lambda x: equalize_unsharp(x, 1.0, 5, 0.0),
            b1080,
            gray_oracle(lambda p: ref.unsharp_mask(ref.equalize_hist(p), 1.0, 5, 0.0)),
        )
    ]

    if args.all or args.rows:
        i512 = rng.integers(0, 256, (512, 512), dtype=np.uint8)
        b32 = rng.integers(0, 256, (32, 1080, 1920, 3), dtype=np.uint8)
        rgb4k = rng.integers(0, 256, (1, 2160, 3840, 3), dtype=np.uint8)
        pipe2 = get_preset("gamma_stretch")
        pipe5 = get_preset("denoise_clahe_sharpen")
        suite += [
            (
                "histeq+unsharp 4K gray b2",
                lambda x: equalize_unsharp(x, 1.0, 5, 0.0),
                b4k,
                gray_oracle(lambda p: ref.unsharp_mask(ref.equalize_hist(p), 1.0, 5, 0.0)),
            ),
            ("equalize_hist 512x512", ie.equalize_hist, i512, lambda x: ref.equalize_hist(x)),
            (
                "gamma+stretch 1080p rgb b32",
                pipe2,
                b32,
                rgb_oracle(lambda p: ref.contrast_stretch(ref.gamma_transform(p, 2.2))),
            ),
            (
                "unsharp 1080p gray b8",
                lambda x: ie.unsharp_mask(x, 1.0, 5),
                b1080,
                gray_oracle(lambda p: ref.unsharp_mask(p, 1.0, 5, 0.0)),
            ),
            (
                "gaussian5 1080p gray b8",
                lambda x: ie.gaussian_blur(x, 5),
                b1080,
                gray_oracle(lambda p: ref.gaussian_blur(p, 5, 0.0)),
            ),
            (
                "median3 1080p gray b8",
                lambda x: ie.median_blur(x, 3),
                b1080,
                gray_oracle(lambda p: ref.median_blur(p, 3)),
            ),
            (
                "median5 1080p gray b8",
                lambda x: ie.median_blur(x, 5),
                b1080,
                gray_oracle(lambda p: ref.median_blur(p, 5)),
            ),
            (
                "gaussian5 4K gray b2",
                lambda x: ie.gaussian_blur(x, 5),
                b4k,
                gray_oracle(lambda p: ref.gaussian_blur(p, 5, 0.0)),
            ),
            (
                "median5 4K gray b2",
                lambda x: ie.median_blur(x, 5),
                b4k,
                gray_oracle(lambda p: ref.median_blur(p, 5)),
            ),
            (
                "clahe 4K rgb",
                lambda x: ie.clahe(x, 2.0, (8, 8)),
                rgb4k,
                rgb_oracle(lambda p: ref.clahe(p, 2.0, (8, 8))),
            ),
            (
                "median5>clahe>unsharp 4K gray b2",
                pipe5,
                b4k,
                gray_oracle(
                    lambda p: ref.unsharp_mask(
                        ref.clahe(ref.median_blur(p, 5), 2.0, (8, 8)), 1.0, 5, 0.0
                    )
                ),
            ),
            (
                "box5 4K gray b2",
                lambda x: ie.box_blur(x, 5),
                b4k,
                gray_oracle(lambda p: ref.box_blur(p, 5)),
            ),
            (
                "bilateral9 4K gray b2",
                lambda x: ie.bilateral_filter(x, 9, 75.0, 75.0),
                b4k,
                gray_oracle(lambda p: ref.bilateral_filter(p, 9, 75.0, 75.0)),
            ),
            (
                "resize/lin 4K->1440p gray b2",
                lambda x: ie.resize(x, (1440, 2560)),
                b4k,
                gray_oracle(lambda p: ref.resize(p, (1440, 2560))),
            ),
            (
                "resize/area 4K->1440p gray b2",
                lambda x: ie.resize(x, (1440, 2560), "area"),
                b4k,
                gray_oracle(lambda p: ref.resize(p, (1440, 2560), "area")),
            ),
            (
                "nlmeans 1080p gray",
                lambda x: ie.fast_nl_means_denoising(x, 10.0),
                rng.integers(0, 256, (1, 1080, 1920), dtype=np.uint8),
                # the NumPy oracle is O(441*HW), so parity runs the SAME op
                # on a 160x160 crop, device vs oracle (phase-2 special case)
                "nlmeans-crop",
            ),
            (
                "canny 4K gray b2",
                lambda x: ie.canny(x, 60.0, 160.0),
                b4k,
                gray_oracle(lambda p: ref.canny(p, 60.0, 160.0)),
            ),
            (
                "warp/rot15 4K gray b2",
                lambda x: ie.warp_affine(
                    x, ref.get_rotation_matrix_2d((1920.0, 1080.0), 15.0, 1.0),
                    (2160, 3840)),
                b4k,
                gray_oracle(lambda p: ref.warp_affine(
                    p, ref.get_rotation_matrix_2d((1920.0, 1080.0), 15.0, 1.0),
                    (2160, 3840))),
            ),
            (
                "sobel3 4K gray b2",
                lambda x: ie.sobel(x, 1, 0, 3),
                b4k,
                gray_oracle(lambda p: ref.sobel(p, 1, 0, 3)),
            ),
            (
                "open3 4K gray b2",
                lambda x: ie.morphology_ex(x, "open", 3),
                b4k,
                gray_oracle(lambda p: ref.morphology(p, "open", 3)),
            ),
            (
                "athresh/gauss11 4K gray b2",
                lambda x: ie.adaptive_threshold(x, 255.0, "gaussian", "binary", 11, 2.0),
                b4k,
                gray_oracle(
                    lambda p: ref.adaptive_threshold(p, 255.0, "gaussian", "binary", 11, 2.0)
                ),
            ),
            (
                "resize/lanczos4 4K->1440p gray b2",
                lambda x: ie.resize(x, (1440, 2560), "lanczos4"),
                b4k,
                gray_oracle(lambda p: ref.resize(p, (1440, 2560), "lanczos4")),
            ),
            (
                "warp_polar 4K gray b2",
                lambda x: ie.warp_polar(x, (1920, 2160), (1920.0, 1080.0), 1900.0),
                b4k,
                gray_oracle(
                    lambda p: ref.warp_polar(p, (1920, 2160), (1920.0, 1080.0), 1900.0)
                ),
            ),
            (
                "cvt/hls 1080p rgb b8",
                lambda x: ie.cvt_color(x, "rgb2hls"),
                rng.integers(0, 256, (8, 1080, 1920, 3), dtype=np.uint8),
                lambda x: np.stack([ref.rgb_to_hls(np.asarray(f)) for f in x]),
            ),
        ]
        # round-3 geometry/HDR additions
        rotM = ref.get_rotation_matrix_2d((1920.0, 1080.0), 15.0, 1.0)
        yy4, xx4 = np.mgrid[0:2160, 0:3840].astype(np.float32)
        swirl_x = jnp.asarray((xx4 + 3.0 * np.sin(yy4 / 7.0)).astype(np.float32))
        swirl_y = jnp.asarray((yy4 + 2.0 * np.cos(xx4 / 9.0)).astype(np.float32))
        swirl_x_np = np.asarray(swirl_x)
        swirl_y_np = np.asarray(swirl_y)
        hdr1080 = (np.random.default_rng(5).random((1080, 1920, 3)).astype(np.float32)
                   * 20 + 0.01)
        suite += [
            (
                "warp/cubic 4K gray b2",
                lambda x: ie.warp_affine(x, rotM, (2160, 3840), "cubic"),
                b4k,
                gray_oracle(lambda p: ref.warp_affine(p, rotM, (2160, 3840), "cubic")),
            ),
            (
                "warp/lanczos4 4K gray b2",
                lambda x: ie.warp_affine(x, rotM, (2160, 3840), "lanczos4"),
                b4k,
                gray_oracle(lambda p: ref.warp_affine(p, rotM, (2160, 3840), "lanczos4")),
            ),
            (
                "remap/cubic 4K gray b2",
                lambda x: ie.remap(x, swirl_x, swirl_y, "cubic"),
                b4k,
                gray_oracle(lambda p: ref.remap(p, swirl_x_np, swirl_y_np, "cubic")),
            ),
            # f32 HDR operators: parity covered by tests/selftest (f32
            # outputs don't fit the int LSB check) — timing rows only
            (
                "tonemap/reinhard 1080p rgb",
                lambda x: ie.tonemap_reinhard(x, 2.2),
                hdr1080,
                None,
            ),
            (
                "tonemap/drago 1080p rgb",
                lambda x: ie.tonemap_drago(x, 2.2),
                hdr1080,
                None,
            ),
            (
                "tonemap/mantiuk 1080p rgb",
                lambda x: ie.tonemap_mantiuk(x, 2.2),
                hdr1080,
                None,
            ),
            (
                "cvt/luv 1080p rgb b8",
                lambda x: ie.cvt_color(x, "rgb2luv"),
                rng.integers(0, 256, (8, 1080, 1920, 3), dtype=np.uint8),
                lambda x: np.stack([ref.rgb_to_luv(np.asarray(f)) for f in x]),
            ),
            (
                # random u8 has ~0.4 % zero pixels — a realistic sparse
                # source field; i32 bit views so max-LSB counts ulps
                "dist/l2m3 1080p gray",
                lambda x: jax.lax.bitcast_convert_type(
                    ie.distance_transform(x, "l2", 3), jnp.int32),
                rng.integers(0, 256, (1, 1080, 1920), dtype=np.uint8),
                lambda x: np.stack(
                    [ref.distance_transform(np.asarray(f), "l2", 3)
                     for f in x]).view(np.int32),
            ),
        ]
        # uint16 tier (the headline extension; baselines measured BASELINE.md)
        b4k16 = rng.integers(0, 65536, (2, 2160, 3840), dtype=np.uint16)
        suite += [
            (
                "clahe/u16 4K gray b2",
                lambda x: ie.clahe(x, 2.0, (8, 8)),
                b4k16,
                gray_oracle(lambda p: ref.clahe(p, 2.0, (8, 8))),
            ),
            (
                "median5/u16 4K gray b2",
                lambda x: ie.median_blur(x, 5),
                b4k16,
                gray_oracle(lambda p: ref.median_blur(p, 5)),
            ),
            (
                "gaussian5/u16 4K gray b2",
                lambda x: ie.gaussian_blur(x, 5),
                b4k16,
                gray_oracle(lambda p: ref.gaussian_blur(p, 5, 0.0)),
            ),
        ]
        # int16 (CV_16S) tier — median is the XLA sorting network;
        # gaussian is the documented float path (oracle = same f32 conv)
        b4ks16 = rng.integers(-32768, 32768, (2, 2160, 3840), dtype=np.int16)
        suite += [
            (
                "median5/i16 4K gray b2",
                lambda x: ie.median_blur(x, 5),
                b4ks16,
                gray_oracle(lambda p: ref.median_blur(p, 5)),
            ),
            (
                "gaussian5/i16 4K gray b2",
                lambda x: ie.gaussian_blur(x, 5),
                b4ks16,
                gray_oracle(lambda p: ref.gaussian_blur(p, 5, 0.0)),
            ),
        ]

    if args.rows:
        import re

        pat = re.compile(args.rows)
        suite = [row for row in suite if pat.search(row[0])]
        if not suite:
            ap.error(f"--rows {args.rows!r} matched no suite rows")

    # ---------------- phase 1: timing (no device->host transfers) ----------
    results = {}
    handles = {}
    for name, fn, x, _ in suite:
        xd = jax.device_put(x, dev)
        handles[name] = (fn, xd)
        secs = time_op(fn, xd, iters=args.iters, warmup=2)
        g = np.prod(x.shape) / secs / 1e9
        results[name] = g
        base = BASELINES.get(name)
        bpp = BYTES_PER_PX.get(name)
        print(
            f"{name:40s} {g:8.3f} GPix/s"
            + (f"  ({g/base:7.1f}x baseline)" if base else "")
            + (f"  [{g * bpp:6.1f} GB/s]" if bpp else "")
            + f"  {tag}",
            file=sys.stderr,
        )

    if args.profile and "histeq+unsharp 1080p gray b8" in handles:
        fn, xd = handles["histeq+unsharp 1080p gray b8"]
        with jax.profiler.trace(args.profile):
            for _ in range(5):
                jax.block_until_ready(fn(xd))
        print(f"profiler trace written to {args.profile}  {tag}", file=sys.stderr)

    # ---------------- phase 2: parity (transfers OK; slow per-call) --------
    parity = {}
    if not args.no_parity:
        for name, fn, x, oracle in suite:
            if oracle is None:
                continue
            if oracle == "nlmeans-crop":
                crop = np.ascontiguousarray(x[:, :160, :160])
                got = np.asarray(
                    ie.fast_nl_means_denoising(jax.device_put(crop, dev), 10.0))
                want = np.stack(
                    [ref.fast_nl_means_denoising(p, 10.0) for p in crop])
            else:
                f, xd = handles[name]
                got = np.asarray(f(xd))
                want = oracle(x)
            lsb = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
            parity[name] = lsb
            print(f"{name:40s} max-LSB={lsb}  {tag}", file=sys.stderr)

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(
                {
                    "device": device,
                    "card": card,
                    "rows": [
                        {
                            "name": name,
                            "gpix_per_s": round(float(g), 3),
                            "vs_baseline": (
                                round(float(g) / BASELINES[name], 1)
                                if name in BASELINES
                                else None
                            ),
                            "max_lsb": parity.get(name),
                            "model_bytes_per_px": BYTES_PER_PX.get(name),
                            "eff_gbps": (
                                round(float(g) * BYTES_PER_PX[name], 1)
                                if name in BYTES_PER_PX
                                else None
                            ),
                        }
                        for name, g in results.items()
                    ],
                },
                f,
                indent=1,
            )
        print(f"full table written to {args.json_out}  {tag}", file=sys.stderr)

    headline = results.get("histeq+unsharp 1080p gray b8")
    if headline is not None:
        print(
            json.dumps(
                {
                    "metric": "fused_histeq_unsharp_1080p_gray",
                    "value": round(float(headline), 4),
                    "unit": "GPix/s/device",
                    "vs_baseline": round(float(headline) / BASELINES["histeq+unsharp 1080p gray b8"], 2),
                    "device": device,
                    "card": card,
                }
            )
        )
    # parity gate: every oracled row must stay within the judged ±1 LSB
    rc = 0
    bad = {k: v for k, v in parity.items() if v > 1}
    if bad:
        print(f"GATE FAIL: parity over ±1 LSB: {bad}  {tag}", file=sys.stderr)
        rc = 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
