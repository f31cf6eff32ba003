"""Device selftest: run every op on the attached backend vs the oracle.

Operational health check for deployments (the closest analog of "failure
detection" for a stateless image library — SURVEY.md §5): verifies that the
attached accelerator + compiler stack reproduces the reference semantics
within each op's budget before serving traffic.

Run: ``python -m imageenhancement_mp_tpu.selftest [--size HxW] [--seed N]``
(``JAX_PLATFORMS=cpu`` for the CPU backend).  Exit code 0 = all ops
within budget, 1 = any violation.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def run_selftest(size=(128, 131), seed=0, verbose=True) -> bool:
    import jax

    import imageenhancement_mp_tpu as ie
    from imageenhancement_mp_tpu import ref

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size, dtype=np.uint8)
    lut = rng.integers(0, 256, 256, dtype=np.uint8)

    # (name, device fn, oracle fn, max LSB budget)
    checks = [
        ("apply_lut", lambda: ie.apply_lut(img, lut), lambda: ref.apply_lut(img, lut), 0),
        ("gamma 2.2", lambda: ie.gamma(img, 2.2), lambda: ref.gamma_transform(img, 2.2), 0),
        ("log", lambda: ie.log_transform(img), lambda: ref.log_transform(img), 0),
        ("stretch", lambda: ie.contrast_stretch(img), lambda: ref.contrast_stretch(img), 0),
        ("scale_abs", lambda: ie.convert_scale_abs(img, 1.3, -7.0),
         lambda: ref.convert_scale_abs(img, 1.3, -7.0), 0),
        ("histogram", lambda: ie.histogram(img), lambda: ref.calc_hist(img), 0),
        ("equalize", lambda: ie.equalize_hist(img), lambda: ref.equalize_hist(img), 0),
        ("clahe", lambda: ie.clahe(img, 2.0, (8, 8)), lambda: ref.clahe(img, 2.0, (8, 8)), 1),
        ("gauss5", lambda: ie.gaussian_blur(img, 5), lambda: ref.gaussian_blur(img, 5, 0.0), 0),
        ("gauss5/s1.5", lambda: ie.gaussian_blur(img, 5, 1.5),
         lambda: ref.gaussian_blur(img, 5, 1.5), 0),
        ("laplacian", lambda: ie.laplacian(img), lambda: ref.laplacian(img), 0),
        ("lap_sharpen", lambda: ie.laplacian_sharpen(img), lambda: ref.laplacian_sharpen(img), 0),
        ("unsharp", lambda: ie.unsharp_mask(img, 1.0), lambda: ref.unsharp_mask(img, 1.0), 0),
        ("median3", lambda: ie.median_blur(img, 3), lambda: ref.median_blur(img, 3), 0),
        ("median5", lambda: ie.median_blur(img, 5), lambda: ref.median_blur(img, 5), 0),
    ]
    img2 = rng.integers(0, 256, size, dtype=np.uint8)
    wblend1 = (rng.random(size) * 4).astype(np.float32)
    wblend2 = (rng.random(size) * 4).astype(np.float32)
    mh, mw = min(40, size[0]), min(44, size[1])  # temporal-NLMeans crop
    rgb = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
    checks += [
        ("add_weighted", lambda: ie.add_weighted(img, 1.7, img2, -0.6, 41.25),
         lambda: ref.add_weighted(img, 1.7, img2, -0.6, 41.25), 0),
        ("cvt_gray", lambda: ie.cvt_gray(rgb), lambda: ref.cvt_gray(rgb), 0),
        ("box5", lambda: ie.box_blur(img, 5), lambda: ref.box_blur(img, 5), 0),
        # budget 1: the device accumulate chain may FMA-contract vs the
        # oracle's strict per-op f32 (seen: 1 px at 4K scale; cv2's own
        # -ffp-contract build has the same property — docs/PARITY.md)
        ("bilateral", lambda: ie.bilateral_filter(img, 5, 30.0, 6.0),
         lambda: ref.bilateral_filter(img, 5, 30.0, 6.0), 1),
        ("thresh/otsu", lambda: ie.threshold(img, method="otsu")[1],
         lambda: ref.threshold(img, method="otsu")[1], 0),
    ]

    def _quant_mt(r):
        # quantize the f32 response to 1e-3 so the LSB check applies
        return np.round(np.asarray(r) * 1000).astype(np.int32)

    def _swirl_maps(size):
        h, w = size
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        mx = (xx + 3.0 * np.sin(yy / 7.0)).astype(np.float32)
        my = (yy + 2.0 * np.cos(xx / 9.0)).astype(np.float32)
        return mx, my

    def _persp_matrix(size):
        h, w = size
        src = [(0, 0), (w - 1.0, 0), (w - 1.0, h - 1.0), (0, h - 1.0)]
        dst = [(3.5, 2.0), (w - 5.0, 4.5), (w - 2.0, h - 3.0), (1.0, h - 6.5)]
        return ref.get_perspective_transform(src, dst)

    def _luma_oracle():
        ycc = ref.rgb_to_ycrcb(rgb)
        y = ref.equalize_hist(ycc[..., 0])
        return ref.ycrcb_to_rgb(np.concatenate([y[..., None], ycc[..., 1:]], axis=-1))

    checks += [
        ("eq_luma", lambda: ie.equalize_luma(rgb), _luma_oracle, 0),
        ("athresh/gauss", lambda: ie.adaptive_threshold(img, 255.0, "gaussian", "binary", 11, 2.0),
         lambda: ref.adaptive_threshold(img, 255.0, "gaussian", "binary", 11, 2.0), 0),
        ("morph/open", lambda: ie.morphology_ex(img, "open", (3, 5)),
         lambda: ref.morphology(img, "open", (3, 5)), 0),
        ("sobel5", lambda: ie.sobel(img, 1, 1, 5), lambda: ref.sobel(img, 1, 1, 5), 0),
        ("hsv/fwd", lambda: ie.cvt_color(rgb, "rgb2hsv"),
         lambda: ref.rgb_to_hsv(rgb), 0),
        # inverse budget 1: covers XLA's codegen FMA contraction
        # (docs/PARITY.md backend nuance)
        ("hsv/inv", lambda: ie.cvt_color(ref.rgb_to_hsv(rgb), "hsv2rgb"),
         lambda: ref.hsv_to_rgb(ref.rgb_to_hsv(rgb)), 1),
        # Lab/XYZ: exhaustively pinned integer tables — bit-exact both ways
        ("lab/fwd", lambda: ie.cvt_color(rgb, "rgb2lab"),
         lambda: ref.rgb_to_lab(rgb), 0),
        ("lab/inv", lambda: ie.cvt_color(ref.rgb_to_lab(rgb), "lab2rgb"),
         lambda: ref.lab_to_rgb(ref.rgb_to_lab(rgb)), 0),
        ("xyz/fwd", lambda: ie.cvt_color(rgb, "rgb2xyz"),
         lambda: ref.rgb_to_xyz(rgb), 0),
        # color CLAHE on the Lab L plane (budget 3: the CLAHE blend's
        # ±1-on-L FMA caveat amplifies ~3x through the cubic Lab->RGB leg)
        ("clahe_lab", lambda: ie.clahe_lab(rgb, 2.0, (4, 4)),
         lambda: ref.lab_to_rgb(np.concatenate(
             [ref.clahe(ref.rgb_to_lab(rgb)[..., 0], 2.0, (4, 4))[..., None],
              ref.rgb_to_lab(rgb)[..., 1:]], axis=-1)), 3),
        ("pyr_down", lambda: ie.pyr_down(img), lambda: ref.pyr_down(img), 0),
        ("pyr_up", lambda: ie.pyr_up(img), lambda: ref.pyr_up(img), 0),
        ("filter2d", lambda: ie.filter2d(img, ((0, -1, 0), (-1, 5, -1), (0, -1, 0))),
         lambda: ref.filter2d(img, np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]])), 0),
        # bit-exact u8 bilinear (the pinned fixed-point pipeline) and
        # the matmul area downscale
        ("resize/lin", lambda: ie.resize(img, (size[0] * 3 // 4, size[1] * 5 // 7)),
         lambda: ref.resize(img, (size[0] * 3 // 4, size[1] * 5 // 7)), 0),
        ("resize/area", lambda: ie.resize(img, (size[0] * 3 // 7, size[1] * 2 // 5), "area"),
         lambda: ref.resize(img, (size[0] * 3 // 7, size[1] * 2 // 5), "area"), 1),
        # budget 1: device f32 vertical vs the int64 oracle (razor ties)
        ("resize/cubic", lambda: ie.resize(img, (size[0] * 5 // 8, size[1] * 9 // 7), "cubic"),
         lambda: ref.resize(img, (size[0] * 5 // 8, size[1] * 9 // 7), "cubic"), 1),
        ("rotate90", lambda: ie.rotate(img, "90cw"), lambda: ref.rotate(img, "90cw"), 0),
        ("canny", lambda: ie.canny(img, 60.0, 160.0),
         lambda: ref.canny(img, 60.0, 160.0), 0),
        ("nlmeans", lambda: ie.fast_nl_means_denoising(img, 12.0, 5, 9),
         lambda: ref.fast_nl_means_denoising(img, 12.0, 5, 9), 0),
        # runtime-map warp: bit-exact (fma32 lerp == cv2's FMA path)
        ("remap", lambda: ie.remap(img, *_swirl_maps(size)),
         lambda: ref.remap(img, *_swirl_maps(size)), 0),
        # 16-tap cubic: the documented razor-tie class keeps budget 1
        ("remap/cubic", lambda: ie.remap(img, *_swirl_maps(size), "cubic"),
         lambda: ref.remap(img, *_swirl_maps(size), "cubic"), 1),
        # u8 int-tab lanczos: device == oracle bitwise (budget 0)
        ("remap/lancz", lambda: ie.remap(img, *_swirl_maps(size), "lanczos4"),
         lambda: ref.remap(img, *_swirl_maps(size), "lanczos4"), 0),
        # float-result op: compare at tolerance via the quantized trick
        ("match_tpl", lambda: _quant_mt(ie.match_template(img, img2[:7, :9], "ccoeff_normed")),
         lambda: _quant_mt(ref.match_template(img, img2[:7, :9], "ccoeff_normed")), 1),
        # bit-exact: device rebuilds cv2's hybrid f32 coords via fma32
        ("warp/rot30", lambda: ie.warp_affine(
            img, ref.get_rotation_matrix_2d((size[1] / 2, size[0] / 2), 30.0, 0.9),
            size),
         lambda: ref.warp_affine(
            img, ref.get_rotation_matrix_2d((size[1] / 2, size[0] / 2), 30.0, 0.9),
            size), 0),
        # cv2 5.0's new cubic warp kernel: u8 bit-exact (budget 0)
        ("warp/cubic", lambda: ie.warp_affine(
            img, ref.get_rotation_matrix_2d((size[1] / 2, size[0] / 2), 20.0, 1.1),
            size, "cubic"),
         lambda: ref.warp_affine(
            img, ref.get_rotation_matrix_2d((size[1] / 2, size[0] / 2), 20.0, 1.1),
            size, "cubic"), 0),
        # perspective cubic: the SIMD-reciprocal divide is hardware-
        # dependent (budget 1 covers the contraction tier)
        ("warp/pcubic", lambda: ie.warp_perspective(img, _persp_matrix(size), size,
                                                    "cubic"),
         lambda: ref.warp_perspective(img, _persp_matrix(size), size, "cubic"), 1),
        # lanczos4 warp: u8 int-tab path — device == oracle bitwise
        ("warp/lancz", lambda: ie.warp_affine(
            img, ref.get_rotation_matrix_2d((size[1] / 2, size[0] / 2), -25.0, 0.95),
            size, "lanczos4"),
         lambda: ref.warp_affine(
            img, ref.get_rotation_matrix_2d((size[1] / 2, size[0] / 2), -25.0, 0.95),
            size, "lanczos4"), 0),
        # perspective warp: bit-exact (hybrid f32 coords + f32 divide via fma32)
        ("warp/persp", lambda: ie.warp_perspective(img, _persp_matrix(size), size),
         lambda: ref.warp_perspective(img, _persp_matrix(size), size), 0),
        # round-3 wave 2: HLS (exhaustively pinned SIMD-body model),
        # Lanczos4 (centered int32 pipeline), polar warps (pinned
        # fastAtan2/magnitude maps), vector/temporal/colored NLMeans
        # Luv packed-trilinear path: device == oracle bitwise (fwd);
        # inverse's f32 transcendentals are razor +-1 vs the f64 oracle
        ("luv/fwd", lambda: ie.cvt_color(rgb, "rgb2luv"),
         lambda: ref.rgb_to_luv(rgb), 0),
        ("luv/inv", lambda: ie.cvt_color(ref.rgb_to_luv(rgb), "luv2rgb"),
         lambda: ref.luv_to_rgb(ref.rgb_to_luv(rgb)), 1),
        ("hls/fwd", lambda: ie.cvt_color(rgb, "rgb2hls"),
         lambda: ref.rgb_to_hls(rgb), 0),
        ("hls/inv", lambda: ie.cvt_color(ref.rgb_to_hls(rgb), "hls2rgb"),
         lambda: ref.hls_to_rgb(ref.rgb_to_hls(rgb)), 0),
        ("resize/lanczos", lambda: ie.resize(img, (size[0] * 5 // 8, size[1] * 9 // 7), "lanczos4"),
         lambda: ref.resize(img, (size[0] * 5 // 8, size[1] * 9 // 7), "lanczos4"), 0),
        ("warp_polar", lambda: ie.warp_polar(
            img, (size[1] * 3 // 4, 64), (size[1] / 2, size[0] / 2), 40.0),
         lambda: ref.warp_polar(
            img, (size[1] * 3 // 4, 64), (size[1] / 2, size[0] / 2), 40.0), 0),
        ("warp_polar/inv", lambda: ie.warp_polar(
            img, (size[1], size[0]), (size[1] / 2, size[0] / 2), 40.0,
            log=True, inverse=True),
         lambda: ref.warp_polar(
            img, (size[1], size[0]), (size[1] / 2, size[0] / 2), 40.0,
            log=True, inverse=True), 0),
        ("nlmeans/color", lambda: ie.fast_nl_means_denoising_colored(
            rgb[:min(48, size[0]), :min(52, size[1])], 10.0, 14.0, 3, 9),
         lambda: ref.fast_nl_means_denoising_colored(
            np.asarray(rgb)[:min(48, size[0]), :min(52, size[1])],
            10.0, 14.0, 3, 9), 0),
        ("decolor", lambda: ie.decolor(rgb)[0],
         lambda: ref.decolor(np.asarray(rgb))[0], 1),
        ("tvl1", lambda: ie.denoise_tvl1([img, img2], 1.0, 20),
         lambda: ref.denoise_tvl1([img, img2], 1.0, 20), 1),
        ("nlmeans/u16", lambda: ie.fast_nl_means_denoising(
            (img.astype(np.uint16) * 257), 900.0, 5, 9, norm_type="l1"),
         lambda: ref.fast_nl_means_denoising(
            (img.astype(np.uint16) * 257), 900.0, 5, 9, "l1"), 0),
        ("nlmeans/multi", lambda: ie.fast_nl_means_denoising_multi(
            np.stack([img[:mh, :mw], img2[:mh, :mw], img[size[0] - mh:, size[1] - mw:]]),
            1, 3, 15.0, 3, 9),
         lambda: ref.fast_nl_means_denoising_multi(
            [np.asarray(img)[:mh, :mw], np.asarray(img2)[:mh, :mw],
             np.asarray(img)[size[0] - mh:, size[1] - mw:]], 1, 3, 15.0, 3, 9), 0),
        # photo domain-transform family (budget 1: device powf / tree
        # cumsum vs the oracle's libm/sequential f32 — docs/PARITY.md)
        ("photo/epf_rf", lambda: ie.edge_preserving_filter(rgb[:mh, :mw], "recursive", 55.0, 0.35),
         lambda: ref.edge_preserving_filter(np.asarray(rgb)[:mh, :mw], "recursive", 55.0, 0.35), 1),
        ("photo/styliz", lambda: ie.stylization(rgb[:mh, :mw], 60.0, 0.45),
         lambda: ref.stylization(np.asarray(rgb)[:mh, :mw], 60.0, 0.45), 1),
        ("photo/pencil", lambda: np.concatenate(
            [a[..., None] if a.ndim == 2 else a
             for a in map(np.asarray, ie.pencil_sketch(rgb[:mh, :mw]))], -1),
         lambda: np.concatenate(
            [a[..., None] if a.ndim == 2 else a
             for a in ref.pencil_sketch(np.asarray(rgb)[:mh, :mw])], -1), 0),
        ("spatgrad", lambda: np.stack([np.asarray(a) for a in ie.spatial_gradient(img)]),
         lambda: np.stack(ref.spatial_gradient(np.asarray(img))), 0),
        # f32 outputs bit-viewed as i32: budget counts ulps, not LSBs
        ("sqr_box5", lambda: np.asarray(ie.sqr_box_filter(img, 5)).view(np.int32),
         lambda: ref.sqr_box_filter(np.asarray(img), 5).view(np.int32), 0),
        ("blend/u8", lambda: ie.blend_linear(img, img2, wblend1, wblend2),
         lambda: ref.blend_linear(np.asarray(img), np.asarray(img2),
                                  wblend1, wblend2), 0),
        ("blend/f32", lambda: np.asarray(ie.blend_linear(
            img.astype(np.float32), img2.astype(np.float32),
            wblend1, wblend2)).view(np.int32),
         lambda: ref.blend_linear(img.astype(np.float32),
                                  img2.astype(np.float32),
                                  wblend1, wblend2).view(np.int32), 0),
        ("dist/l2m3", lambda: np.asarray(ie.distance_transform(
            (img > 12).astype(np.uint8), "l2", 3)).view(np.int32),
         lambda: ref.distance_transform(
            (np.asarray(img) > 12).astype(np.uint8), "l2", 3).view(np.int32), 0),
        ("dist/l1u8", lambda: ie.distance_transform(
            (img > 12).astype(np.uint8), "l1", dst_type="u8"),
         lambda: ref.distance_transform(
            (np.asarray(img) > 12).astype(np.uint8), "l1", 3, "u8"), 0),
        ("floodfill", lambda: ie.flood_fill(
            np.asarray(img), (size[1] // 2, size[0] // 2), 200, 35, 35)[1],
         lambda: ref.flood_fill(
            np.asarray(img), (size[1] // 2, size[0] // 2), 200, 35, 35)[1], 0),
        # corner features: compare the SELECTED corner list (device
        # response + pinned host selection) vs the all-oracle chain —
        # integer pixel coordinates, so budget 0 is meaningful
        ("goodfeats", lambda: ie.good_features_to_track(
            np.asarray(img), 25, 0.05, 7.0),
         lambda: ref.good_features_to_track(
            np.asarray(img), 25, 0.05, 7.0), 0),
        ("houghlines", lambda: np.asarray(ie.hough_lines(
            (np.asarray(img) > 200).astype(np.uint8) * 255,
            1.0, np.pi / 180, 12)).view(np.int32),
         lambda: ref.hough_lines(
            (np.asarray(img) > 200).astype(np.uint8) * 255,
            1.0, np.pi / 180, 12).view(np.int32), 0),
    ]
    img16 = rng.integers(0, 65536, size, dtype=np.uint16)
    checks += [
        ("gauss5/u16", lambda: ie.gaussian_blur(img16, 5),
         lambda: ref.gaussian_blur(img16, 5, 0.0), 0),
        ("gauss13/u16/s2", lambda: ie.gaussian_blur(img16, 13, 2.0),
         lambda: ref.gaussian_blur(img16, 13, 2.0), 0),
        ("median3/u16", lambda: ie.median_blur(img16, 3),
         lambda: ref.median_blur(img16, 3), 0),
        ("median5/u16", lambda: ie.median_blur(img16, 5),
         lambda: ref.median_blur(img16, 5), 0),
        ("clahe/u16", lambda: ie.clahe(img16, 2.0, (4, 4)),
         lambda: ref.clahe(img16, 2.0, (4, 4)), 1),
        ("unsharp/u16", lambda: ie.unsharp_mask(img16, 1.0),
         lambda: ref.unsharp_mask(img16, 1.0), 0),
    ]

    imgs16 = rng.integers(-32768, 32768, size, dtype=np.int16)
    checks += [
        ("median5/i16", lambda: ie.median_blur(imgs16, 5),
         lambda: ref.median_blur(imgs16, 5), 0),
        ("stretch/i16", lambda: ie.contrast_stretch(imgs16, (-20.5, 512.0)),
         lambda: ref.contrast_stretch(imgs16, (-20.5, 512.0)), 0),
        # i16 Gaussian: device vs oracle use the same f32 conv — budget 1
        # covers backend FMA-contraction differences (docs/PARITY.md)
        ("gauss5/i16", lambda: ie.gaussian_blur(imgs16, 5),
         lambda: ref.gaussian_blur(imgs16, 5, 0.0), 1),
        ("lap_sharp/i16", lambda: ie.laplacian_sharpen(imgs16),
         lambda: ref.laplacian_sharpen(imgs16), 0),
    ]

    # spatial sharding on a 1-device mesh (exercises the halo self-border,
    # psum/all_gather collectives and the shard_map program end-to-end;
    # multi-device equality is covered by tests/test_spatial.py)
    def _spatial_config5():
        from imageenhancement_mp_tpu.parallel.sharding import make_mesh
        from imageenhancement_mp_tpu.parallel import spatial as sp

        mesh = make_mesh(1, axis_name="y")
        pipe = sp.make_spatial_pipeline(
            [("median_blur", {"ksize": 3}),
             ("clahe", {"clip_limit": 2.0, "tile_grid": (4, 4)}),
             ("unsharp_mask", {"amount": 1.0})],
            mesh,
        )
        crop = img[: size[0] - size[0] % 4, : size[1] - size[1] % 4]
        return pipe(sp.device_put_spatial(crop[None], mesh))[0]

    def _spatial_oracle():
        crop = img[: size[0] - size[0] % 4, : size[1] - size[1] % 4]
        return ref.unsharp_mask(ref.clahe(ref.median_blur(crop, 3), 2.0, (4, 4)), 1.0)

    checks += [("spatial/cfg5", _spatial_config5, _spatial_oracle, 3)]

    # pooled (video-mode) equalization: per-channel LUTs across frames
    vid = rng.integers(0, 256, (3, *size, 2), dtype=np.uint8)

    def _pooled_oracle():
        from imageenhancement_mp_tpu.ref.ops import _equalize_lut

        out = np.empty_like(vid)
        for c in range(vid.shape[-1]):
            stack = vid[..., c]
            hist = np.bincount(stack.ravel(), minlength=256)
            out[..., c] = _equalize_lut(hist, stack.size)[stack]
        return out

    checks += [
        ("equalize/pool", lambda: ie.equalize_hist(vid, per_frame=False), _pooled_oracle, 0),
    ]

    # getRectSubPix: batched sub-pixel patches, all four kernel laws
    sp_cs = np.stack([rng.uniform(4, size[1] - 5, 12),
                      rng.uniform(4, size[0] - 5, 12)], axis=1).astype(np.float32)
    sp_f = (rng.random(size) * 255).astype(np.float32)

    def _subpix_oracle(src, pt):
        return np.stack([
            ref.get_rect_sub_pix(src, (5, 4), (float(cx), float(cy)),
                                 patch_type=pt).reshape(
                (4, 5) if src.ndim == 2 else (4, 5, 3))
            for cx, cy in sp_cs])

    checks += [
        ("subpix/u8", lambda: ie.get_rect_sub_pix(img, (5, 4), sp_cs),
         lambda: _subpix_oracle(img, "u8"), 0),
        ("subpix/u8rgb", lambda: ie.get_rect_sub_pix(rgb, (5, 4), sp_cs),
         lambda: _subpix_oracle(rgb, "u8"), 0),
    ]

    checks += [
        # f32 patches compared as raw bit patterns: 0 = bit-identical
        ("subpix/f32",
         lambda: np.asarray(ie.get_rect_sub_pix(sp_f, (5, 4), sp_cs)
                            ).view(np.int32),
         lambda: _subpix_oracle(sp_f, "f32").view(np.int32), 0),
    ]

    # pyramidal Lucas-Kanade: device tracker == oracle bitwise
    lk_next = np.roll(img, (2, -1), (0, 1))
    lk_pts = np.stack([rng.uniform(12, size[1] - 13, 8),
                       rng.uniform(12, size[0] - 13, 8)], 1).astype(np.float32)

    def _lk_dev():
        p, s, e = ie.calc_optical_flow_pyr_lk(img, lk_next, lk_pts, (11, 11), 2)
        return np.concatenate([np.asarray(p).view(np.int32).reshape(-1),
                               np.asarray(s).astype(np.int32),
                               np.asarray(e).view(np.int32)])

    def _lk_ref():
        p, s, e = ref.calc_optical_flow_pyr_lk(img, lk_next, lk_pts,
                                               (11, 11), 2, 30, 0.01)
        st = np.asarray(s)
        ed = np.asarray(e).copy()
        pd, sd_, edd = ie.calc_optical_flow_pyr_lk(img, lk_next, lk_pts,
                                                   (11, 11), 2)
        ed[st != 1] = np.asarray(edd)[st != 1]  # err defined only for st=1
        return np.concatenate([p.view(np.int32).reshape(-1),
                               st.astype(np.int32), ed.view(np.int32)])

    checks += [("lk/track", _lk_dev, _lk_ref, 0)]

    # pyrMeanShiftFiltering: dense device mean-shift == oracle bitwise
    checks += [
        ("meanshift/pyr",
         lambda: ie.pyr_mean_shift_filtering(rgb, 3.0, 20.0, 1),
         lambda: ref.pyr_mean_shift_filtering(rgb, 3.0, 20.0, 1), 0),
    ]

    dev = jax.devices()[0]
    if verbose:
        print(f"selftest on {dev.device_kind} ({dev.platform}), image {size}", file=sys.stderr)
    ok = True
    for name, dev_fn, ref_fn, budget in checks:
        got = np.asarray(dev_fn()).astype(np.int64)
        want = np.asarray(ref_fn()).astype(np.int64)
        lsb = int(np.abs(got - want).max())
        passed = lsb <= budget
        ok &= passed
        if verbose:
            print(
                f"  {name:12s} max-LSB={lsb} (budget {budget}) "
                f"{'OK' if passed else 'FAIL'}",
                file=sys.stderr,
            )
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="imageenhancement_mp_tpu.selftest")
    ap.add_argument("--size", default="128x131")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from imageenhancement_mp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    h, w = (int(v) for v in args.size.split("x"))
    ok = run_selftest((h, w), args.seed)
    print("SELFTEST PASS" if ok else "SELFTEST FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
