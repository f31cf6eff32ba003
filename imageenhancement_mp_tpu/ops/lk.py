"""Pyramidal Lucas-Kanade sparse optical flow on device (contract
pinned in ref/ops.py ``calc_optical_flow_pyr_lk``; device == oracle
bitwise, oracle vs cv2: status always bitwise, 99.6 % of points
bitwise, residual ≤ 1e-4 px — docs/PARITY.md).

Device mapping: all N points are tracked in parallel (vmap) — per pyramid
level one jitted program gathers each point's (h+1)×(w+1) tap windows
with ``lax.dynamic_slice`` from the padded level (REFLECT_101 image,
CONSTANT-0 Scharr derivatives), runs the Q14 fixed-point interpolation
in int32, and iterates the 2×2 solve a static ``max_count`` times with
per-point freeze masks (mask-frozen state reproduces cv2's break
semantics exactly).  Levels unroll in Python (≤ 4 typical).

Two accumulation modes:

* ``exact=True`` (default): reproduces cv2's SIMD lane structure —
  8-wide blocks into a 4-lane f32 accumulator via single-rounded FMA
  (``utils.fma.fma32``), scalar f32 tail, ``(l0+l2)+(l1+l3)`` reduce —
  as a ``lax.scan`` over the window in block order.  Bit-exact vs the
  ORACLE everywhere (the oracle carries the cv2 budget: status always
  bitwise, 99.6 % of points bitwise, residual ≤ 1e-4 px on
  deep-iteration ulp ties — docs/PARITY.md); sequential over ~2·win²
  scan steps per iteration.
* ``exact=False``: same algorithm with free-order f32 tree reductions —
  fully parallel (the fast path); tracks identically to sub-0.1 px
  with rare convergence-boundary tie flips.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from imageenhancement_mp_tpu.utils.fma import fma32

__all__ = ["calc_optical_flow_pyr_lk_planes"]

_W_BITS = 14
_FLT_SCALE = np.float32(1.0 / (1 << 20))


def _div32(a, b):
    """Correctly rounded f32 quotient: XLA lowers f32 divide to a
    reciprocal multiply (<=2 ulp, blend_linear note); dividing in f64
    and casting double-rounds innocuously (2p+2 bound) — exact on every
    backend."""
    return (jnp.asarray(a, jnp.float64)
            / jnp.asarray(b, jnp.float64)).astype(jnp.float32)


def _prod32(a, b):
    """Separately rounded f32 product (the subpix/blend_linear idiom):
    XLA fast-math contracts f32 mul+add chains into FMAs, flipping solve
    ties vs cv2's plain-float arithmetic; the f64 product snapped to the
    f32 grid is the one rounding XLA must honor."""
    return jax.lax.reduce_precision(
        jnp.asarray(a, jnp.float64) * jnp.asarray(b, jnp.float64), 8, 23
    ).astype(jnp.float32)


def _pad_level(img2d):
    """int32 (image REFLECT_101, derivs CONSTANT 0) padded by win."""
    return img2d


def _scharr_deriv_dev(img2d):
    """cv2 calcSharrDeriv on device: int32 [H,W,2] (dx, dy)."""
    H, W = img2d.shape
    s = img2d.astype(jnp.int32)
    up = jnp.concatenate([s[1:2], s[:-1]], 0) if H > 1 else s
    dn = jnp.concatenate([s[1:], s[-2:-1]], 0) if H > 1 else s
    t0 = (up + dn) * 3 + s * 10
    t1 = dn - up

    def hsh(A):
        l = jnp.concatenate([A[:, 1:2], A[:, :-1]], 1) if W > 1 else A
        r = jnp.concatenate([A[:, 1:], A[:, -2:-1]], 1) if W > 1 else A
        return l, r

    l0, r0 = hsh(t0)
    l1, r1 = hsh(t1)
    return jnp.stack([r0 - l0, (l1 + r1) * 3 + t1 * 10], -1)


def _reflect101_pad(img2d, ww, wh):
    return jnp.pad(img2d, ((wh, wh), (ww, ww)), mode="reflect")


def _lane_sum_exact(A, B, ww, wh):
    """cv2's v_muladd lane accumulation of Σ A·B (i32 windows) —
    sequential scan in cv2's evaluation order (ref simd_sum)."""
    f32 = jnp.float32
    nb = ww // 8 if ww >= 8 else 0
    vw = nb * 8
    red = jnp.float32(0.0)
    if nb:
        Av = A[:, :vw].reshape(wh, nb, 2, 4).reshape(-1, 4).astype(f32)
        Bv = B[:, :vw].reshape(wh, nb, 2, 4).reshape(-1, 4).astype(f32)

        def step(lanes, ab):
            a, b = ab
            return fma32(a, b, lanes), None

        lanes, _ = lax.scan(step, jnp.zeros(4, f32), (Av, Bv))
        red = (lanes[0] + lanes[2]) + (lanes[1] + lanes[3])
    tail = jnp.float32(0.0)
    if vw < ww:
        Pt = (A[:, vw:] * B[:, vw:]).reshape(-1).astype(f32)

        def tstep(t, p):
            return t + p, None

        tail, _ = lax.scan(tstep, jnp.float32(0.0), Pt)
    return tail + red


def _lane_sum_fast(A, B, ww, wh):
    return jnp.sum((A * B).astype(jnp.float32))


def calc_optical_flow_pyr_lk_planes(prev_levels, next_levels, prev_pts,
                                    win_size, max_level: int,
                                    max_count: int, epsilon: float,
                                    min_eig_threshold: float,
                                    exact: bool = True):
    """Track ``prev_pts`` [N,2] f32 through pyramid level lists (u8
    [H,W] per level, finest first).  Returns (next_pts f32 [N,2],
    status u8 [N], err f32 [N]).  See module docstring."""
    f32 = jnp.float32
    ww, wh = int(win_size[0]), int(win_size[1])
    lane_sum = _lane_sum_exact if exact else _lane_sum_fast
    half = jnp.array([(ww - 1) * 0.5, (wh - 1) * 0.5], np.float32)
    crit_cnt = min(max(int(max_count), 0), 100)
    eps = min(max(float(epsilon), 0.0), 10.0)
    eps *= eps
    max_level = min(int(max_level), len(prev_levels) - 1,
                    len(next_levels) - 1)
    N = prev_pts.shape[0]
    out = jnp.zeros((N, 2), f32)
    status = jnp.ones((N,), jnp.uint8)
    err = jnp.zeros((N,), f32)

    def level_step(level, I2, J2, out, status, err):
        H, W = I2.shape
        HB, WB = J2.shape
        I = _reflect101_pad(I2, ww, wh).astype(jnp.int32)
        J = _reflect101_pad(J2, ww, wh).astype(jnp.int32)
        DI = jnp.pad(_scharr_deriv_dev(I2), ((wh, wh), (ww, ww), (0, 0)))

        def weights(a, b):
            one = f32(1)
            iw00 = jnp.round((one - a) * (one - b)
                             * (1 << _W_BITS)).astype(jnp.int32)
            iw01 = jnp.round(a * (one - b) * (1 << _W_BITS)).astype(jnp.int32)
            iw10 = jnp.round((one - a) * b * (1 << _W_BITS)).astype(jnp.int32)
            iw11 = (1 << _W_BITS) - iw00 - iw01 - iw10
            return iw00, iw01, iw10, iw11

        def interp(Wnd, iws, shift):
            s = (Wnd[:-1, :-1] * iws[0] + Wnd[:-1, 1:] * iws[1]
                 + Wnd[1:, :-1] * iws[2] + Wnd[1:, 1:] * iws[3])
            return (s + (1 << (shift - 1))) >> shift

        def one(pt, nxt0, st_in, err_in):
            prevPt = pt * f32(1.0 / (1 << level))
            nextPt = jnp.where(level == max_level, prevPt, nxt0 * f32(2.0))
            pPt = prevPt - half
            ip = jnp.floor(pPt).astype(jnp.int32)
            p_out = ((ip[0] < -ww) | (ip[0] >= W)
                     | (ip[1] < -wh) | (ip[1] >= H))
            a = pPt[0] - ip[0].astype(f32)
            b = pPt[1] - ip[1].astype(f32)
            iws = weights(a, b)
            base = (jnp.clip(ip[1] + wh, 0, H + wh - 1),
                    jnp.clip(ip[0] + ww, 0, W + ww - 1))
            Iw = lax.dynamic_slice(I, base, (wh + 1, ww + 1))
            Dw = lax.dynamic_slice(DI, (*base, jnp.int32(0)),
                                   (wh + 1, ww + 1, 2))
            ival = interp(Iw, iws, _W_BITS - 5)
            dval = interp(Dw, iws, _W_BITS)
            ixv = dval[..., 0]
            iyv = dval[..., 1]
            A11 = lane_sum(ixv, ixv, ww, wh) * _FLT_SCALE
            A12 = lane_sum(ixv, iyv, ww, wh) * _FLT_SCALE
            A22 = lane_sum(iyv, iyv, ww, wh) * _FLT_SCALE
            D0 = _prod32(A11, A22) - _prod32(A12, A12)
            t = A11 - A22
            minEig = _div32((A22 + A11)
                            - jnp.sqrt(_prod32(t, t)
                                       + _prod32(f32(4.0) * A12, A12)),
                            f32(2 * ww * wh))
            bad = (minEig < f32(min_eig_threshold)) | (D0 < f32(1.1920929e-07))
            Dk = _div32(f32(1.0), D0)
            nPt0 = nextPt - half

            def body(j, carry):
                nPt, outp, st, active, broke, prevD = carry
                inp = jnp.floor(nPt).astype(jnp.int32)
                outside = ((inp[0] < -ww) | (inp[0] >= WB)
                           | (inp[1] < -wh) | (inp[1] >= HB))
                hit = active & outside
                st = jnp.where(hit & (level == 0), 0, st)
                broke = broke | hit
                active = active & ~outside
                aa = nPt[0] - inp[0].astype(f32)
                bb = nPt[1] - inp[1].astype(f32)
                jws = weights(aa, bb)
                jbase = (jnp.clip(inp[1] + wh, 0, HB + wh - 1),
                         jnp.clip(inp[0] + ww, 0, WB + ww - 1))
                Jw = lax.dynamic_slice(J, jbase, (wh + 1, ww + 1))
                jval = interp(Jw, jws, _W_BITS - 5)
                diff = jval - ival
                b1 = lane_sum(diff, ixv, ww, wh) * _FLT_SCALE
                b2 = lane_sum(diff, iyv, ww, wh) * _FLT_SCALE
                dx = _prod32(_prod32(A12, b2) - _prod32(A22, b1), Dk)
                dy = _prod32(_prod32(A12, b1) - _prod32(A11, b2), Dk)
                delta = jnp.stack([dx, dy])
                nPt2 = jnp.where(active, nPt + delta, nPt)
                outp2 = jnp.where(active, nPt2 + half, outp)
                if jax.config.jax_enable_x64:
                    # Point2f::ddot — two separately rounded f64
                    # products + one f64 add, like cv2; reduce_precision
                    # blocks f64 fma contraction (blend_linear note).
                    rp64 = lambda v: jax.lax.reduce_precision(v, 11, 52)
                    dd = (rp64(dx.astype(jnp.float64)
                               * dx.astype(jnp.float64))
                          + rp64(dy.astype(jnp.float64)
                                 * dy.astype(jnp.float64)))
                    # the damper sums in f32, then compares against the
                    # DOUBLE literal 0.01 (f32(0.01) is below it)
                    sx = (dx + prevD[0]).astype(jnp.float64)
                    sy = (dy + prevD[1]).astype(jnp.float64)
                else:
                    dd = dx * dx + dy * dy
                    sx = dx + prevD[0]
                    sy = dy + prevD[1]
                conv = dd <= eps
                flip = ((j > 0) & (jnp.abs(sx) < 0.01)
                        & (jnp.abs(sy) < 0.01))
                outp3 = jnp.where(active & ~conv & flip,
                                  outp2 - delta * f32(0.5), outp2)
                stop = conv | (~conv & flip)
                prevD2 = jnp.where(active, delta, prevD)
                active2 = active & ~stop
                return (nPt2, outp3, st, active2, broke, prevD2)

            init = (nPt0, nextPt, st_in, ~(p_out | bad),
                    jnp.asarray(False), jnp.zeros(2, f32))
            nPtF, outF, stF, _, brokeF, _ = lax.fori_loop(
                0, crit_cnt, body, init)
            stF = jnp.where(p_out & (level == 0), 0, stF)
            stF = jnp.where(bad & ~p_out & (level == 0), 0, stF)
            errF = jnp.where((p_out | bad) & (level == 0),
                             jnp.where(p_out, f32(0.0), err_in), err_in)
            outF = jnp.where(p_out | bad, nextPt, outF)
            # final error (level 0, status alive, not broken outside)
            if level == 0:
                nPtE = outF - half
                ipe = jnp.floor(nPtE).astype(jnp.int32)
                eout = ((ipe[0] < -ww) | (ipe[0] >= WB)
                        | (ipe[1] < -wh) | (ipe[1] >= HB))
                ae = nPtE[0] - ipe[0].astype(f32)
                be = nPtE[1] - ipe[1].astype(f32)
                ews = weights(ae, be)
                ebase = (jnp.clip(ipe[1] + wh, 0, HB + wh - 1),
                         jnp.clip(ipe[0] + ww, 0, WB + ww - 1))
                Jw = lax.dynamic_slice(J, ebase, (wh + 1, ww + 1))
                jval = interp(Jw, ews, _W_BITS - 5)
                adiff = jnp.abs((jval - ival).astype(f32)).reshape(-1)

                def estep(tcar, v):
                    return tcar + v, None

                esum, _ = lax.scan(estep, f32(0.0), adiff)
                if not exact:
                    esum = jnp.sum(adiff)
                ev = _div32(esum, f32(32 * ww * wh))
                live = (stF == 1) & ~brokeF & ~p_out & ~bad
                stF = jnp.where(live & eout, 0, stF)
                errF = jnp.where(live & eout, f32(0.0),
                                 jnp.where(live & ~eout, ev, errF))
            return outF, stF, errF

        return jax.vmap(one)(prev_pts, out, status, err)

    for level in range(max_level, -1, -1):
        out, status, err = level_step(level, prev_levels[level],
                                      next_levels[level], out, status, err)
    return out, status.astype(jnp.uint8), err
