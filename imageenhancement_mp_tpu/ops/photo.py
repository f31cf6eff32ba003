"""cv2.photo domain-transform family on device (contract pinned in
ref/ops.py: edge_preserving_filter / detail_enhance / stylization).

Device mapping:

* The RECURS (RF) variant is a first-order IIR along each axis.  We run
  it as ``lax.scan`` chains (forward + backward per axis, 3 iterations)
  so the f32 op sequence matches the oracle's sequential recursion; where
  XLA contracts a mul+add into FMA the result can differ by ±1
  (docs/PARITY.md backend nuance).  The
  scan carries a ``[N,H,C]`` column; throughput is latency-bound but
  the op is O(HW) total work.
* The NORMCONV (NC) variant is data-parallel: transformed-domain
  coordinates by ``cumsum``, box bounds by ``searchsorted`` per row
  (vmapped), box means from SAT differences — no sequential chain at
  all, so it runs elementwise at full width.
* ``detail_enhance`` composes the RF filter with the f32 analytic
  Lab legs from ops/color; ``stylization`` composes the NC filter with
  a Sobel-magnitude edge-darkening pass (the pinned
  ``sqrt(fma(gx,gx,gy²))`` magnitude law).

The one device-vs-oracle caveat: ``V = a**dHdx`` uses the device's f32
``pow`` (the oracle uses libm powf); a 1-ulp difference there can
amplify through the recursion to ±1 LSB on isolated pixels — the same
budget class as cv2's own build variance.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from imageenhancement_mp_tpu.utils.fma import fma32

__all__ = ["denoise_tvl1_stack", "tonemap_reinhard_nhwc", "tonemap_drago_nhwc",
           "dt_derivatives", "dt_rf", "dt_nc",
           "edge_preserving_filter_nhwc", "detail_enhance_nhwc",
           "stylization_nhwc", "pencil_sketch_nhwc"]

_F32 = jnp.float32


def _sigma_h(sigma_s: float, i: int, n: int) -> float:
    return float(sigma_s * np.sqrt(3.0) * (2.0 ** (n - i - 1))
                 / np.sqrt(4.0 ** n - 1))


def dt_derivatives(I: jnp.ndarray, sigma_s: float, sigma_r: float):
    """Domain-transform derivatives of f32 ``[N,H,W,C]`` (L1 over C)."""
    ratio = _F32(float(sigma_s) / float(sigma_r))
    dIx = jnp.abs(jnp.diff(I, axis=2)).sum(-1)
    dIy = jnp.abs(jnp.diff(I, axis=1)).sum(-1)
    return (_F32(1.0) + ratio * dIx), (_F32(1.0) + ratio * dIy)


def _rf_axis(J: jnp.ndarray, V: jnp.ndarray):
    """One forward+backward RF sweep along axis 2 of ``[N,H,W,C]``;
    ``V``: ``[N,H,W-1]`` feedback coefficients between columns."""
    Jw = jnp.moveaxis(J, 2, 0)                    # [W, N, H, C]
    Vw = jnp.moveaxis(V, 2, 0)[..., None]         # [W-1, N, H, 1]

    def fwd(carry, xs):
        j, v = xs
        out = j + v * (carry - j)
        return out, out

    _, tail = jax.lax.scan(fwd, Jw[0], (Jw[1:], Vw))
    Jw = jnp.concatenate([Jw[:1], tail], axis=0)

    def bwd(carry, xs):
        j, v = xs
        out = j + v * (carry - j)
        return out, out

    _, head = jax.lax.scan(bwd, Jw[-1], (Jw[:-1][::-1], Vw[::-1]))
    Jw = jnp.concatenate([head[::-1], Jw[-1:]], axis=0)
    return jnp.moveaxis(Jw, 0, 2)


def dt_rf(J: jnp.ndarray, dHdx: jnp.ndarray, dVdy: jnp.ndarray,
          sigma_s: float, iters: int = 3) -> jnp.ndarray:
    """The recursive domain-transform filter on f32 ``[N,H,W,C]``."""
    for i in range(iters):
        a = _F32(np.exp(-np.sqrt(2.0) / _sigma_h(sigma_s, i, iters)))
        Vx = jnp.power(a, dHdx)
        Vy = jnp.power(a, dVdy)
        J = _rf_axis(J, Vx)
        J = jnp.swapaxes(_rf_axis(jnp.swapaxes(J, 1, 2), jnp.swapaxes(Vy, 1, 2)),
                         1, 2)
    return J


def _nc_axis(J: jnp.ndarray, ct: jnp.ndarray, radius):
    """NC box mean along axis 2: ``J [N,H,W,C]``, ``ct [N,H,W]``."""
    N, H, W, C = J.shape
    flat_ct = ct.reshape(N * H, W)
    lo = jax.vmap(lambda p: jnp.searchsorted(p, p - radius, side="left"))(flat_ct)
    hi = jax.vmap(lambda p: jnp.searchsorted(p, p + radius, side="left"))(flat_ct)
    hi = jnp.minimum(hi, W).reshape(N, H, W)
    lo = lo.reshape(N, H, W)
    sat = jnp.concatenate(
        [jnp.zeros((N, H, 1, C), _F32), jnp.cumsum(J, axis=2, dtype=_F32)],
        axis=2)
    num = (jnp.take_along_axis(sat, hi[..., None], 2)
           - jnp.take_along_axis(sat, lo[..., None], 2))
    cnt = jnp.maximum(hi - lo, 1).astype(_F32)
    return (num / cnt[..., None]).astype(_F32)


def dt_nc(J: jnp.ndarray, dHdx: jnp.ndarray, dVdy: jnp.ndarray,
          sigma_s: float, iters: int = 3) -> jnp.ndarray:
    """The normalized-convolution domain-transform filter."""
    N, H, W, C = J.shape
    ctH = jnp.concatenate([jnp.zeros((N, H, 1), _F32),
                           jnp.cumsum(dHdx, axis=2, dtype=_F32)], axis=2)
    ctV = jnp.concatenate([jnp.zeros((N, 1, W), _F32),
                           jnp.cumsum(dVdy, axis=1, dtype=_F32)], axis=1)
    for i in range(iters):
        radius = _F32(_sigma_h(sigma_s, i, iters) * np.sqrt(3.0))
        J = _nc_axis(J, ctH, radius)
        J = jnp.swapaxes(
            _nc_axis(jnp.swapaxes(J, 1, 2), jnp.swapaxes(ctV, 1, 2), radius),
            1, 2)
    return J


def _to_u8(J: jnp.ndarray) -> jnp.ndarray:
    return jnp.clip(jnp.round(J * _F32(255.0)), 0, 255).astype(jnp.uint8)


def edge_preserving_filter_nhwc(img: jnp.ndarray, flags: str = "recursive",
                                sigma_s: float = 60.0,
                                sigma_r: float = 0.4) -> jnp.ndarray:
    """``cv2.edgePreservingFilter`` on uint8 ``[N,H,W,3]``."""
    I = img.astype(_F32) * _F32(1.0 / 255.0)
    dHdx, dVdy = dt_derivatives(I, sigma_s, sigma_r)
    fn = dt_rf if flags == "recursive" else dt_nc
    return _to_u8(fn(I, dHdx, dVdy, sigma_s))


def detail_enhance_nhwc(img: jnp.ndarray, sigma_s: float = 10.0,
                        sigma_r: float = 0.15,
                        order: str = "rgb") -> jnp.ndarray:
    """``cv2.detailEnhance`` on uint8 ``[N,H,W,3]`` (analytic f32 Lab
    legs — the documented ±3 deviation vs cv2's interpolated-LUT Lab)."""
    from imageenhancement_mp_tpu.ops.color import (lab_to_rgb_nhwc,
                                                   rgb_to_lab_nhwc)

    I = img.astype(_F32) * _F32(1.0 / 255.0)
    lab = rgb_to_lab_nhwc(I, order)
    L = (lab[..., :1] * _F32(1.0 / 255.0)).astype(_F32)
    dHdx, dVdy = dt_derivatives(L, sigma_s, sigma_r)
    res = dt_rf(L, dHdx, dVdy, sigma_s)
    Lout = ((res + _F32(3.0) * (L - res)) * _F32(255.0)).astype(_F32)
    out = lab_to_rgb_nhwc(jnp.concatenate([Lout, lab[..., 1:]], -1), order)
    return _to_u8(out)


def stylization_nhwc(img: jnp.ndarray, sigma_s: float = 60.0,
                     sigma_r: float = 0.45) -> jnp.ndarray:
    """``cv2.stylization`` on uint8 ``[N,H,W,3]``."""
    I = img.astype(_F32) * _F32(1.0 / 255.0)
    dHdx, dVdy = dt_derivatives(I, sigma_s, sigma_r)
    res = dt_nc(I, dHdx, dVdy, sigma_s)
    # Sobel-3 gradients with REFLECT_101 border, per channel
    p = jnp.pad(res, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
    smooth_y = p[:, :-2] + _F32(2.0) * p[:, 1:-1] + p[:, 2:]
    gx = smooth_y[:, :, 2:] - smooth_y[:, :, :-2]
    smooth_x = p[:, :, :-2] + _F32(2.0) * p[:, :, 1:-1] + p[:, :, 2:]
    gy = smooth_x[:, 2:] - smooth_x[:, :-2]
    # pinned magnitude law: sqrt(fma(gx, gx, gy*gy)), summed over C
    from imageenhancement_mp_tpu.utils.fma import fma32

    acc = fma32(gx, gx, gy * gy)
    mag = jnp.sqrt(acc).astype(_F32).sum(-1).astype(_F32)
    mag = (_F32(1.0) - mag).astype(_F32)
    return _to_u8(res * mag[..., None])


def _seq_cumsum(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Strictly sequential f32 cumsum (bitwise ``np.cumsum`` order).

    ``jnp.cumsum`` lowers to a tree prefix whose rounding can differ
    from the oracle's sequential chain by ulps — harmless for the NC
    box MEANS (±1-class) but fatal for pencilSketch's pen COUNTS,
    where one flipped ``searchsorted`` boundary moves gray by
    ``round(255·shade_factor)``."""
    xm = jnp.moveaxis(x, axis, 0)

    def step(c, v):
        c = (c + v).astype(_F32)
        return c, c

    _, out = jax.lax.scan(step, jnp.zeros(xm.shape[1:], _F32), xm)
    return jnp.moveaxis(out, 0, axis)


def _pen_axis(ct: jnp.ndarray, radius) -> jnp.ndarray:
    """cv2 pencilSketch neighbour counts along the last axis of ``ct``
    (ref/ops.py _dt_pen: searchsorted-left bounds, full-coverage
    position-0 zero quirk)."""
    n = ct.shape[-1]
    flat = ct.reshape(-1, n)
    lo = jax.vmap(lambda p: jnp.searchsorted(p, p - radius, side="left"))(flat)
    hi = jax.vmap(lambda p: jnp.searchsorted(p, p + radius, side="left"))(flat)
    hi = jnp.minimum(hi, n)
    cnt = (hi - lo).astype(_F32)
    cnt = cnt.at[:, 0].set(jnp.where(hi[:, 0] == n, _F32(0.0), cnt[:, 0]))
    return cnt.reshape(ct.shape)


def _dt_derivatives_exact(I: jnp.ndarray, sigma_s: float, sigma_r: float):
    """`dt_derivatives` with the mul and add separately rounded (XLA
    fast-math otherwise contracts ``1 + ratio·dIx`` into an fma — the
    blendLinear fix, api.py)."""
    ratio = float(np.float32(float(sigma_s) / float(sigma_r)))
    dIx = jnp.abs(jnp.diff(I, axis=2)).sum(-1)
    dIy = jnp.abs(jnp.diff(I, axis=1)).sum(-1)
    def leg(d):
        p = jax.lax.reduce_precision(jnp.float64(ratio) * d.astype(jnp.float64),
                                     8, 23)
        return jax.lax.reduce_precision(np.float64(1.0) + p, 8, 23).astype(_F32)

    with jax.enable_x64(True):
        return leg(dIx), leg(dIy)


def pencil_sketch_nhwc(img: jnp.ndarray, sigma_s: float = 60.0,
                       sigma_r: float = 0.07, shade_factor: float = 0.02,
                       order: str = "rgb"):
    """``cv2.pencilSketch`` on uint8 ``[N,H,W,3]`` → ``(gray [N,H,W],
    color [N,H,W,3])`` u8 (full pinned law: ref/ops.py pencil_sketch)."""
    I = img.astype(_F32) * _F32(1.0 / 255.0)
    N, H, W, _ = I.shape
    dHdx, dVdy = _dt_derivatives_exact(I, sigma_s, sigma_r)
    ctH = jnp.concatenate([jnp.zeros((N, H, 1), _F32),
                           _seq_cumsum(dHdx, 2)], axis=2)
    ctV = jnp.concatenate([jnp.zeros((N, 1, W), _F32),
                           _seq_cumsum(dVdy, 1)], axis=1)
    radius = _F32(_sigma_h(sigma_s, 0, 3) * np.sqrt(3.0))
    penx = _pen_axis(ctH, radius)
    peny = jnp.swapaxes(_pen_axis(jnp.swapaxes(ctV, 1, 2), radius), 1, 2)
    sk = ((penx + peny) * _F32(float(np.float32(shade_factor)))).astype(_F32)
    gray = jnp.clip(jnp.round(sk * _F32(255.0)), 0, 255).astype(jnp.uint8)
    if order == "rgb":
        R, G, B = I[..., 0], I[..., 1], I[..., 2]
    else:
        B, G, R = I[..., 0], I[..., 1], I[..., 2]
    Y0 = fma32(B, _F32(0.114), fma32(G, _F32(0.587), R * _F32(0.299)))
    Cr = fma32(R - Y0, _F32(0.713), _F32(0.5))
    Cb = fma32(B - Y0, _F32(0.564), _F32(0.5))
    crm = Cr - _F32(0.5)
    cbm = Cb - _F32(0.5)
    Rp = fma32(crm, _F32(1.403), sk)
    Gp = fma32(crm, _F32(-0.714), fma32(cbm, _F32(-0.344), sk))
    Bp = fma32(cbm, _F32(1.773), sk)
    chans = [Rp, Gp, Bp] if order == "rgb" else [Bp, Gp, Rp]
    color = jnp.clip(jnp.round(jnp.stack(chans, -1) * _F32(255.0)),
                     0, 255).astype(jnp.uint8)
    return gray, color


def merge_mertens_nhwc(stack: jnp.ndarray, wcon: float, wsat: float,
                       wexp: float) -> jnp.ndarray:
    """Mertens exposure fusion on a ``[T,H,W,3]`` u8 stack → f32
    ``[H,W,3]`` (composition pinned in ref/ops.py merge_mertens)."""
    from imageenhancement_mp_tpu.ops.pyramid import (pyr_down_planes,
                                                     pyr_up_planes)
    from imageenhancement_mp_tpu.ops.filters import laplacian_planes

    T, H, W, C = stack.shape
    I = stack.astype(_F32) * _F32(1.0 / 255.0)
    # cv2's f32 RGB2GRAY on the array as-is (the pinned quirk)
    gray = (I[..., 0] * _F32(0.299) + I[..., 1] * _F32(0.587)
            + I[..., 2] * _F32(0.114)).astype(_F32)
    contrast = jnp.abs(laplacian_planes(gray, 1)).astype(_F32)
    mean = (I.sum(-1) * _F32(1.0 / 3.0)).astype(_F32)
    sat = jnp.sqrt((((I - mean[..., None]) ** 2).sum(-1)
                    * _F32(1.0 / 3.0))).astype(_F32)
    expo = jnp.exp(-(((I - _F32(0.5)) ** 2) * _F32(1.0 / 0.08))
                   ).astype(_F32).prod(-1).astype(_F32)
    w = (jnp.power(contrast, _F32(wcon)) * jnp.power(sat, _F32(wsat))
         * jnp.power(expo, _F32(wexp))).astype(_F32) + _F32(1e-12)
    w = (w / w.sum(0)).astype(_F32)                    # [T,H,W]
    maxlevel = int(np.log(min(H, W)) / np.log(2.0))

    def down(x):   # [T,H,W,C] or [T,H,W]
        if x.ndim == 4:
            flat = jnp.moveaxis(x, -1, 1).reshape(-1, x.shape[1], x.shape[2])
            d = pyr_down_planes(flat)
            return jnp.moveaxis(d.reshape(x.shape[0], x.shape[3],
                                          d.shape[-2], d.shape[-1]), 1, -1)
        return pyr_down_planes(x)

    def up(x, hw):
        flat = jnp.moveaxis(x, -1, 1).reshape(-1, x.shape[1], x.shape[2])
        u = pyr_up_planes(flat)[:, :hw[0], :hw[1]]
        return jnp.moveaxis(u.reshape(x.shape[0], x.shape[3],
                                      hw[0], hw[1]), 1, -1)

    gp_i, gp_w = [I], [w]
    for _ in range(maxlevel):
        gp_i.append(down(gp_i[-1]))
        gp_w.append(down(gp_w[-1]))
    res = []
    for l in range(maxlevel + 1):
        lap = gp_i[l] if l == maxlevel else (
            gp_i[l] - up(gp_i[l + 1], gp_i[l].shape[1:3]))
        res.append((lap * gp_w[l][..., None]).sum(0).astype(_F32))
    out = res[maxlevel]
    for l in range(maxlevel - 1, -1, -1):
        u = up(out[None], res[l].shape[0:2])[0]
        out = (res[l] + u).astype(_F32)
    return out


def merge_debevec_nhwc(stack: jnp.ndarray, times) -> jnp.ndarray:
    """Debevec HDR merge on a ``[T,H,W,3]`` u8 stack → f32 radiance
    (law pinned in ref/ops.py merge_debevec)."""
    z = np.arange(256, dtype=np.float64)
    wt = jnp.asarray((np.minimum(z, 255.0 - z) + 1e-6).astype(np.float32))
    g = jnp.asarray(np.log(np.maximum(z, 1.0)).astype(np.float32))
    lt = np.log(np.asarray(times, np.float32)).astype(np.float32)
    idx = stack.astype(jnp.int32)
    wj = jnp.take(wt, idx).mean(-1, keepdims=True).astype(_F32)
    gz = jnp.take(g, idx)
    num = (wj * (gz - lt[:, None, None, None])).astype(_F32).sum(0)
    den = wj.sum(0)
    return jnp.exp((num / den).astype(_F32)).astype(_F32)


def _norm_minmax_f32(x: jnp.ndarray) -> jnp.ndarray:
    """cv2.normalize MINMAX per batch element (ref/ops.py
    ``_normalize_minmax_f32``): f32 fma with constants from the f64
    1/(max-min).  No f64 on device — the f32-rounded constants sit in
    the same unpinnable last-bit tier cv2's own builds occupy."""
    f = jnp.float32
    mn = x.min(axis=(1, 2, 3), keepdims=True)
    mx = x.max(axis=(1, 2, 3), keepdims=True)
    scale = jnp.where(mx - mn > f(1e-12), f(1) / (mx - mn), f(0))
    return fma32(x, scale, -mn * scale)


def _gray_f32(img: jnp.ndarray) -> jnp.ndarray:
    f = jnp.float32
    return (img[..., 0] * f(0.299) + img[..., 1] * f(0.587)
            + img[..., 2] * f(0.114))


def tonemap_reinhard_nhwc(img: jnp.ndarray, gamma: float = 1.0,
                          intensity: float = 0.0, light_adapt: float = 1.0,
                          color_adapt: float = 0.0) -> jnp.ndarray:
    """``cv2.createTonemapReinhard`` on ``(N, H, W, 3)`` f32 HDR —
    contract in ref/ops.py ``tonemap_reinhard`` (pinned ~2e-7 vs cv2).
    Pure reductions + elementwise map; everything fuses."""
    f = jnp.float32
    img = _norm_minmax_f32(img.astype(f))
    gray = _gray_f32(img)
    log_img = jnp.log(jnp.maximum(gray, f(1e-4)))
    log_mean = log_img.mean(axis=(1, 2), keepdims=True)
    log_min = log_img.min(axis=(1, 2), keepdims=True)
    log_max = log_img.max(axis=(1, 2), keepdims=True)
    key = (log_max - log_mean) / jnp.maximum(log_max - log_min, f(1e-30))
    map_key = f(0.3) + f(0.7) * jnp.power(key, f(1.4))
    inten = f(np.exp(-float(intensity)))
    chan_mean = img.mean(axis=(1, 2), keepdims=True)          # (N,1,1,3)
    gray_mean = gray.mean(axis=(1, 2), keepdims=True)[..., None]
    ca, la = f(color_adapt), f(light_adapt)
    glob = ca * chan_mean + (f(1) - ca) * gray_mean
    adapt = ca * img + (f(1) - ca) * gray[..., None]
    adapt = la * adapt + (f(1) - la) * glob
    adapt = jnp.power(inten * adapt, map_key[..., None])
    out = img * (f(1) / (adapt + img))
    if gamma != 1.0:
        out = jnp.power(_norm_minmax_f32(out), f(1.0 / gamma))
    else:
        out = _norm_minmax_f32(out)
    return out


def tonemap_drago_nhwc(img: jnp.ndarray, gamma: float = 1.0,
                       saturation: float = 1.0,
                       bias: float = 0.85) -> jnp.ndarray:
    """``cv2.createTonemapDrago`` on ``(N, H, W, 3)`` f32 HDR —
    contract in ref/ops.py ``tonemap_drago``.  The final normalize
    masks non-finite values like cv2's minMaxLoc NaN skipping (the
    fractional pow of a negative normalize residue NaNs the global-min
    pixel — a pinned cv2 quirk)."""
    f = jnp.float32
    img = _norm_minmax_f32(img.astype(f))
    gray = _gray_f32(img)
    log_img = jnp.log(jnp.maximum(gray, f(1e-4)))
    mean = jnp.exp(log_img.sum(axis=(1, 2), keepdims=True)
                   / f(log_img.shape[1] * log_img.shape[2]))
    grays = gray / mean
    gmax = grays.max(axis=(1, 2), keepdims=True)
    expo = f(float(np.log(np.float32(bias)) / np.log(np.float32(0.5))))
    div = jnp.log(f(2) + f(8) * jnp.power(grays / gmax, expo))
    mp = jnp.log(grays + f(1)) * (f(1) / div)
    ratio = img / grays[..., None]
    ch = ratio if saturation == 1.0 else jnp.power(ratio, f(saturation))
    out = ch * mp[..., None]
    fin = jnp.isfinite(out)
    big = jnp.float32(3.4e38)
    mn = jnp.where(fin, out, big).min(axis=(1, 2, 3), keepdims=True)
    mx = jnp.where(fin, out, -big).max(axis=(1, 2, 3), keepdims=True)
    scale = jnp.where(mx - mn > f(1e-12), f(1) / (mx - mn), f(0))
    out = fma32(out, scale, -mn * scale)
    if gamma != 1.0:
        out = jnp.power(out, f(1.0 / gamma))
    return out


def tonemap_mantiuk_nhwc(img: jnp.ndarray, gamma: float = 1.0,
                         scale: float = 0.7,
                         saturation: float = 1.0) -> jnp.ndarray:
    """``cv2.createTonemapMantiuk`` on ``(N, H, W, 3)`` f32 HDR —
    contract in ref/ops.py ``tonemap_mantiuk``: the contrast response
    map is algebraically linear, so cv2's 100-iteration gradient-domain
    CG solve reduces to the power law ``L' = L^(scale^(1/0.4185))`` —
    one pointwise pass instead of ~200 pyramid traversals.
    Budget ≤ ~3e-3 = cv2's own CG stopping tolerance.  Constant-
    luminance inputs (where cv2 asserts) return zeros via the normalize
    guard — the jitted path cannot raise data-dependently."""
    f = jnp.float32
    img = _norm_minmax_f32(img.astype(f))
    gray = _gray_f32(img)
    log_img = jnp.log(jnp.maximum(gray, f(1e-4)))
    k = f(float(np.float32(scale)) ** (1.0 / float(np.float32(0.4185))))
    new_gray = jnp.exp(k * log_img)
    ratio = jnp.where(gray[..., None] > 0, img / gray[..., None], f(0))
    ch = ratio if saturation == 1.0 else jnp.power(ratio, f(saturation))
    out = ch * new_gray[..., None]
    fin = jnp.isfinite(out)
    big = jnp.float32(3.4e38)
    mn = jnp.where(fin, out, big).min(axis=(1, 2, 3), keepdims=True)
    mx = jnp.where(fin, out, -big).max(axis=(1, 2, 3), keepdims=True)
    sc = jnp.where(mx - mn > f(1e-12), f(1) / (mx - mn), f(0))
    out = fma32(out, sc, -mn * sc)
    if gamma != 1.0:
        out = jnp.power(out, f(1.0 / gamma))
    return out


def denoise_tvl1_stack(obs: jnp.ndarray, lam: float = 1.0,
                       niters: int = 30) -> jnp.ndarray:
    """``cv2.denoise_TVL1`` on a ``(K, H, W)`` uint8 observation stack —
    contract in ref/ops.py ``denoise_tvl1``.  A ``lax.fori_loop`` over
    the primal-dual iterations; each step is pure stencil math, so
    XLA fuses the whole update.  f32 iterations reproduce the f64
    oracle's u8 outputs exactly on the tested configs (the scheme is
    contractive); the razor class is the oracle's own ±1 tie."""
    if obs.dtype != jnp.uint8:
        raise TypeError("denoise_tvl1_stack expects uint8 (K, H, W)")
    f = jnp.float32
    K, H, W = obs.shape
    L2, tau, theta = f(8.0), f(0.02), f(1.0)
    sigma = f(1.0) / (L2 * tau)
    ob = obs.astype(f) / f(255.0)
    X0 = ob[0]
    Px0 = jnp.zeros((H, W), f)
    Py0 = jnp.zeros((H, W), f)
    Rs0 = jnp.zeros((K, H, W), f)
    lamf = f(lam)
    rowsel = jnp.minimum(jnp.arange(H) + 1, H - 1)

    def body(i, state):
        X, Px, Py, Rs = state
        cs = jnp.where(i == 0, f(1) + sigma, sigma)
        Xnext = X[rowsel, :]
        dxs = (X[:, 1:] - X[:, :-1]) * cs + Px[:, :-1]
        dx = jnp.pad(dxs, ((0, 0), (0, 1)))
        dy = (Xnext - X) * cs + Py
        m = f(1.0) / jnp.maximum(jnp.sqrt(dxs ** 2 + dy[:, :-1] ** 2), f(1.0))
        Px = jnp.concatenate([dxs * m, jnp.zeros((H, 1), f)], axis=1)
        ml = f(1.0) / jnp.maximum(jnp.abs(dy[:, -1]), f(1.0))
        Py = jnp.concatenate([dy[:, :-1] * m, (dy[:, -1] * ml)[:, None]], axis=1)
        Rs = jnp.clip(Rs + sigma * (X[None] - ob), -lamf, lamf)
        div = jnp.zeros((H, W), f)
        div = div.at[:, 1:].add(Px[:, 1:] - Px[:, :-1])
        div = div.at[1:, :].add(Py[1:, :] - Py[:-1, :])
        X1 = X + tau * div - tau * Rs.sum(axis=0)
        Xn = X1 + theta * (X1 - X)
        return Xn, Px, Py, Rs

    X, _, _, _ = jax.lax.fori_loop(0, int(niters), body, (X0, Px0, Py0, Rs0))
    return jnp.clip(jnp.round(X * f(255.0)), 0, 255).astype(jnp.uint8)
