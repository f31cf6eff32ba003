"""Demo CLI: ``python -m imageenhancement_mp_tpu.cli <image> --op clahe ...``

The reference's entry points are per-technique demo scripts (load image →
apply one enhancement → save; SURVEY.md §3.5).  This thin CLI is the
equivalent: host-side image IO (cv2/Pillow/.npy), one op or pipeline on
device, save the result.  Not on the perf path.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _load(path: str) -> tuple[np.ndarray, bool]:
    """Load an image; returns ``(array, rgb_order)`` where ``rgb_order``
    records the channel order the backend produced (cv2 -> BGR, PIL -> RGB,
    .npy -> treated as RGB) so _save can write colors correctly."""
    if path.endswith(".npy"):
        return np.load(path), True
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        return img, False
    except ImportError:
        try:
            from PIL import Image
        except ImportError:
            raise SystemExit(
                "error: reading non-.npy images needs opencv-python or Pillow "
                "(pip install 'imageenhancement-mp-tpu[io]')"
            )
        return np.asarray(Image.open(path)), True


def _save(path: str, img: np.ndarray, rgb_order: bool = False) -> None:
    """Write an image; ``rgb_order`` says color channels are R,G,B (the
    native FrameLoader convention) rather than cv2's B,G,R."""
    if path.endswith(".npy"):
        np.save(path, img)
        return
    try:
        import cv2

        if rgb_order and img.ndim == 3 and img.shape[-1] >= 3:
            img = img[..., ::-1]  # cv2.imwrite expects BGR
        cv2.imwrite(path, img)
    except ImportError:
        try:
            from PIL import Image
        except ImportError:
            raise SystemExit(
                "error: writing non-.npy images needs opencv-python or Pillow "
                "(pip install 'imageenhancement-mp-tpu[io]')"
            )
        if not rgb_order and img.ndim == 3 and img.shape[-1] >= 3:
            img = img[..., ::-1]  # PIL expects RGB
        Image.fromarray(img).save(path)


def _apply_ops(ie, out, specs, rgb_order: bool = True):
    """Apply a spec list to one array; returns the result or raises ValueError.

    ``rgb_order`` records the loaded channel order so ``gray`` converts
    with the right coefficients (cv2-loaded frames are BGR)."""
    for spec in specs:
        name, _, rest = spec.partition(":")
        ps = rest.split(":") if rest else []
        if name == "gray":
            if out.ndim < 3 or out.shape[-1] not in (3, 4):
                raise ValueError("gray needs a color image (C=3|4)")
            out = ie.cvt_gray(out, "rgb" if rgb_order else "bgr")
        elif name == "eqluma":
            if out.ndim < 3 or out.shape[-1] != 3:
                raise ValueError("eqluma needs a color image (C=3)")
            out = ie.equalize_luma(out, "rgb" if rgb_order else "bgr")
        elif name == "gamma":
            out = ie.gamma(out, float(ps[0]) if ps else 2.2)
        elif name == "log":
            out = ie.log_transform(out)
        elif name == "stretch":
            out = ie.contrast_stretch(out)
        elif name == "histeq":
            out = ie.equalize_hist(out)
        elif name == "clahe":
            clip = float(ps[0]) if ps else 40.0
            grid = (int(ps[1]), int(ps[2])) if len(ps) >= 3 else (8, 8)
            out = ie.clahe(out, clip, grid)
        elif name == "gauss":
            out = ie.gaussian_blur(out, int(ps[0]) if ps else 5, float(ps[1]) if len(ps) > 1 else 0.0)
        elif name == "lapsharp":
            out = ie.laplacian_sharpen(out)
        elif name == "unsharp":
            out = ie.unsharp_mask(out, float(ps[0]) if ps else 1.0, int(ps[1]) if len(ps) > 1 else 5)
        elif name == "median":
            out = ie.median_blur(out, int(ps[0]) if ps else 3)
        elif name == "box":
            out = ie.box_blur(out, int(ps[0]) if ps else 3)
        elif name == "thresh":
            _, out = ie.threshold(
                out, float(ps[0]) if ps else 127.0,
                float(ps[1]) if len(ps) > 1 else 255.0,
                ps[2] if len(ps) > 2 else "binary",
            )
        elif name == "sharpen2d":
            # the classic 5-point sharpening mask via the generic filter2d
            out = ie.filter2d(out, ((0, -1, 0), (-1, 5, -1), (0, -1, 0)))
        elif name == "flip":
            out = ie.flip(out, int(ps[0]) if ps else 1)
        elif name == "rotate":
            out = ie.rotate(out, ps[0] if ps else "90cw")
        elif name == "canny":
            out = ie.canny(out, float(ps[0]) if ps else 50.0,
                           float(ps[1]) if len(ps) > 1 else 150.0)
        elif name == "warprot":
            # warprot:angle[:scale] — rotate about the center via warpAffine
            import numpy as _np
            ang = float(ps[0]) if ps else 15.0
            sc = float(ps[1]) if len(ps) > 1 else 1.0
            h, w = out.shape[0], out.shape[1]
            M = ie.get_rotation_matrix_2d((w / 2, h / 2), ang, sc)
            out = ie.warp_affine(out, M, (h, w))
        elif name == "resize":
            if len(ps) < 2:
                raise ValueError("resize needs resize:H:W[:interp]")
            out = ie.resize(out, (int(ps[0]), int(ps[1])),
                            ps[2] if len(ps) > 2 else "linear")
        elif name == "pyrdown":
            out = ie.pyr_down(out)
        elif name == "epf":
            out = ie.edge_preserving_filter(
                out, ps[0] if ps else "recursive",
                float(ps[1]) if len(ps) > 1 else 60.0,
                float(ps[2]) if len(ps) > 2 else 0.4)
        elif name == "detail":
            out = ie.detail_enhance(out,
                                    float(ps[0]) if ps else 10.0,
                                    float(ps[1]) if len(ps) > 1 else 0.15)
        elif name == "stylize":
            out = ie.stylization(out,
                                 float(ps[0]) if ps else 60.0,
                                 float(ps[1]) if len(ps) > 1 else 0.45)
        elif name == "pencil":
            g, c = ie.pencil_sketch(out,
                                    float(ps[0]) if ps else 60.0,
                                    float(ps[1]) if len(ps) > 1 else 0.07,
                                    float(ps[2]) if len(ps) > 2 else 0.02)
            out = c if len(ps) > 3 and ps[3] == "color" else g
        elif name == "nlmeans":
            out = ie.fast_nl_means_denoising(
                out, float(ps[0]) if ps else 10.0,
                int(ps[1]) if len(ps) > 1 else 7,
                int(ps[2]) if len(ps) > 2 else 21)
        elif name == "warppolar":
            h, w = out.shape[0], out.shape[1]
            out = ie.warp_polar(
                out, (int(ps[0]) if ps else w, int(ps[1]) if len(ps) > 1 else h),
                (w / 2, h / 2),
                float(ps[2]) if len(ps) > 2 else min(h, w) / 2)
        elif name == "warprot":
            h, w = out.shape[0], out.shape[1]
            out = ie.warp_affine(
                out, __import__('imageenhancement_mp_tpu.ref', fromlist=['ref']).get_rotation_matrix_2d((w / 2, h / 2),
                                                   float(ps[0]) if ps else 15.0,
                                                   float(ps[1]) if len(ps) > 1 else 1.0),
                (h, w), ps[2] if len(ps) > 2 else "cubic")
        elif name == "tonemap":
            # HDR display map on a u8 frame treated as radiance
            hdr = (out.astype("float32") / 255.0) if out.dtype != "float32" else out
            import jax.numpy as _jnp
            which = ps[0] if ps else "drago"
            if which == "reinhard":
                t = ie.tonemap_reinhard(_jnp.asarray(hdr),
                                        float(ps[1]) if len(ps) > 1 else 1.0)
            else:
                t = ie.tonemap_drago(_jnp.asarray(hdr),
                                     float(ps[1]) if len(ps) > 1 else 1.0)
            import numpy as _np
            out = _np.clip(_np.round(_np.asarray(t) * 255.0), 0, 255).astype("uint8")
        elif name == "pyrup":
            out = ie.pyr_up(out)
        elif name == "sobel":
            # classic displayable gradient: |Sobel| scaled back to u8
            g = ie.sobel(out, int(ps[0]) if ps else 1,
                         int(ps[1]) if len(ps) > 1 else 0,
                         int(ps[2]) if len(ps) > 2 else 3)
            out = ie.convert_scale_abs(g)
        elif name in ("erode", "dilate", "open", "close", "gradient", "tophat", "blackhat"):
            out = ie.morphology_ex(out, name, int(ps[0]) if ps else 3,
                                   int(ps[1]) if len(ps) > 1 else 1)
        elif name == "athresh":
            out = ie.adaptive_threshold(
                out, 255.0, ps[0] if ps else "mean",
                ps[1] if len(ps) > 1 else "binary",
                int(ps[2]) if len(ps) > 2 else 11,
                float(ps[3]) if len(ps) > 3 else 2.0,
            )
        elif name in ("otsu", "triangle"):
            _, out = ie.threshold(
                out, 0.0, float(ps[0]) if ps else 255.0,
                ps[1] if len(ps) > 1 else "binary", method=name,
            )
        elif name == "bilateral":
            out = ie.bilateral_filter(
                out, int(ps[0]) if ps else 5,
                float(ps[1]) if len(ps) > 1 else 50.0,
                float(ps[2]) if len(ps) > 2 else 50.0,
            )
        else:
            raise ValueError(f"unknown op {name!r}")
        out = np.asarray(out)
    return out


def _batch_mode(args, ie) -> int:
    """Stream many files: native prefetch -> per-frame pipeline -> native
    write-behind into outdir (encode/disk IO overlaps device compute on
    both ends).

    Per-frame decode failures are yielded as FrameError sentinels (not
    raised through the generator), so one corrupt file never aborts the
    rest of the batch; encode/write failures surface the same way from
    the writer's flush().
    """
    from pathlib import Path

    from imageenhancement_mp_tpu.io import FrameError, FrameWriter

    outdir = Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    native_exts = {".pgm", ".ppm", ".png", ".jpg", ".jpeg"}
    use_native = all(Path(p).suffix.lower() in native_exts for p in args.input)
    if use_native:
        from imageenhancement_mp_tpu.io import FrameLoader

        frames = ((f, True) for f in FrameLoader(args.input, threads=4, on_error="sentinel"))
    else:
        from imageenhancement_mp_tpu.io.loader import bounded_map

        def safe_load(path):
            try:
                return _load(path)
            except SystemExit:
                raise  # missing IO backend: not a per-frame condition
            except Exception as e:
                return FrameError(str(path), cause=e), False

        frames = bounded_map(safe_load, args.input, threads=4)
    specs = args.op or ["histeq"]
    n = failed = 0
    writer = None  # created lazily: the first-use g++ build is not free
    try:
        for path, (frame, rgb_order) in zip(args.input, frames):
            if isinstance(frame, FrameError):
                print(f"error: frame decode failed: {frame}", file=sys.stderr)
                failed += 1
                continue
            if frame.dtype not in (np.uint8, np.uint16) or frame.ndim < 2:
                print(f"skipping {path}: unsupported decoded form", file=sys.stderr)
                failed += 1
                continue
            try:
                out = _apply_ops(ie, frame, specs, rgb_order=rgb_order)
            except (ValueError, TypeError) as e:
                print(f"error: {path}: {e}", file=sys.stderr)
                return 2
            dst = outdir / (Path(path).stem + "_out" + Path(path).suffix)
            out = np.asarray(out)
            if dst.suffix.lower() in native_exts and (
                out.ndim == 2 or (out.ndim == 3 and out.shape[-1] <= 4)
            ):
                # async write-behind; FrameWriter takes RGB(A) order.  A
                # BGR(A) frame swaps only its first three channels — alpha
                # stays in place.
                img = out
                if not rgb_order and out.ndim == 3 and out.shape[-1] >= 3:
                    img = out[..., [2, 1, 0, *range(3, out.shape[-1])]]
                if writer is None:
                    writer = FrameWriter(threads=4)
                writer.save(dst, img)
            else:
                _save(str(dst), out, rgb_order=rgb_order)
            n += 1
    finally:
        if writer is not None:
            for err in writer.flush():
                print(f"error: frame write failed: {err}", file=sys.stderr)
                failed += 1
                n -= 1
            writer.close()
    print(f"wrote {n} files to {outdir}" + (f" ({failed} failed)" if failed else ""))
    return 0 if n and not failed else (1 if failed else 2)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="imageenhancement_mp_tpu",
        description="cv2-exact image enhancement in JAX (demo CLI)",
    )
    p.add_argument(
        "input",
        nargs="+",
        help="input image(s) (.png/.jpg/.pgm/.ppm/.npy); multiple files "
        "stream through the pipeline with prefetch + dispatch-ahead",
    )
    p.add_argument(
        "-o",
        "--output",
        default="out.png",
        help="output path (single input) or output directory (multiple)",
    )
    p.add_argument(
        "--op",
        action="append",
        default=None,
        help="op to apply, repeatable to build a pipeline "
        "(gray | eqluma | gamma:2.2 | log | stretch | histeq | clahe[:clip[:gh[:gw]]] | "
        "gauss[:k[:sigma]] | box[:k] | bilateral[:d[:sc[:ss]]] | lapsharp | "
        "unsharp[:amount[:k]] | median[:k] | thresh[:t[:mv[:type]]] | "
        "otsu[:mv[:type]] | triangle[:mv[:type]] | "
        "athresh[:method[:type[:bs[:C]]]] | "
        "erode|dilate|open|close|gradient|tophat|blackhat[:k[:iters]] | "
        "sobel[:dx[:dy[:k]]] | pyrdown | pyrup | sharpen2d | "
        "epf[:flags[:ss[:sr]]] | detail[:ss[:sr]] | stylize[:ss[:sr]] | "
        "pencil[:ss[:sr[:shade[:color]]]] | "
        "nlmeans[:h[:t[:s]]] | warppolar[:dw[:dh[:maxr]]] | "
        "warprot[:deg[:scale[:interp]]] | tonemap[:drago|reinhard[:gamma]])",
    )
    args = p.parse_args(argv)

    from imageenhancement_mp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import imageenhancement_mp_tpu as ie

    if len(args.input) > 1:
        return _batch_mode(args, ie)

    img, rgb_order = _load(args.input[0])
    if img.dtype not in (np.uint8, np.uint16):
        print(f"error: expected uint8/uint16 input, got {img.dtype}", file=sys.stderr)
        return 2
    try:
        out = _apply_ops(ie, np.asarray(img), args.op or ["histeq"], rgb_order=rgb_order)
    except (ValueError, TypeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    _save(args.output, out, rgb_order=rgb_order)
    print(f"wrote {args.output} {out.shape} {out.dtype}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
