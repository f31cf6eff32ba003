"""``cv2.pyrMeanShiftFiltering`` on device — bit-exact integer dynamics.

Law pinned in ``ref/ops.py::pyr_mean_shift_filtering`` / docs/PARITY.md
"Mean-shift segmentation".  Device mapping: the per-pixel moving-window
iteration runs DENSELY over all pixels (masked lanes are cheap; sparse
work-lists are not) as a ``lax.fori_loop`` whose body scans
the static K×K window footprint with flat dynamic gathers — the gathers
are the data-dependent core of mean shift and cannot be turned into
convs.  All five ``cvRound(sum · (1./count))`` updates per iteration
are resolved in pure int32:

* non-ties by integer ratio rounding — provably equal to cv2's f64
  reciprocal-product chain, whose relative error ≤ 2^-52 puts the
  result within 2^-40 of the true ratio while every non-tie sits at
  distance ≥ 1/(2·count) ≥ 2^-9 from a half-integer boundary;
* exact ties ``2n ≡ count (mod 2·count)`` by comparing
  ``n·m_d mod 2^32`` (``m_d`` = the 53-bit mantissa of ``fl64(1/d)``,
  host-precomputed for every count d ≤ K²) against the representable
  boundary ``(2X+1)·2^(e_d−1)`` — the boundary is ≡ 0 mod 2^32 and the
  true difference ``n·(m_d − 2^e/d)`` is < 2^20 in magnitude, so the
  wrapped 32-bit product IS the signed difference.  |diff| within a
  half-ulp of the 53-bit product means the f64 chain lands exactly on
  X+0.5 and ``cvRound`` ties to even.

The pyramid propagation mask (8-neighbour flags at ``(2i+1, 2j−1)``,
3×3 dilate) is static-strided scatter + shifted-OR — fully fused.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from imageenhancement_mp_tpu.ops.pyramid import pyr_down_planes, pyr_up_planes

__all__ = ["pyr_mean_shift_planes"]


def _recip_tables(dmax: int):
    """Host tables for d ∈ [1, dmax]: low 32 bits of fl64(1/d)'s 53-bit
    mantissa m_d and the exponent e_d with 1/d = m_d·2^(−e_d)."""
    d = np.arange(1, dmax + 1, dtype=np.float64)
    mant, ex = np.frexp(1.0 / d)
    m = np.rint(mant * 2.0 ** 53).astype(np.uint64)  # in [2^52, 2^53)
    m32 = np.concatenate([[0], m & 0xFFFFFFFF]).astype(np.uint32)
    e = np.concatenate([[0], 53 - ex]).astype(np.int32)
    return jnp.asarray(m32), jnp.asarray(e)


def _cv_round_div(n, d, m32_t, e_t):
    """``cvRound(n · fl64(1/d))`` for int32 n ≥ 0, d ≥ 1 — exact."""
    q0 = n // d
    r = n - q0 * d
    t2 = 2 * r
    # exact-tie branch: n/d = q0 + 0.5 exactly
    v = 2 * q0 + 1
    bl = jnp.frexp(v.astype(jnp.float32))[1].astype(jnp.int32)  # bitlen
    s = e_t[d] + bl - jnp.int32(54)
    D = (n.astype(jnp.uint32) * m32_t[d]).astype(jnp.int32)
    one = jnp.int32(1)
    half_up = jnp.where(s >= 1, jnp.left_shift(one, jnp.maximum(s - 1, 0)), 0)
    sb = jnp.where(v == 1, s - 1, s)  # power-of-two boundary: half-ulp below
    half_dn = jnp.where(sb >= 1, jnp.left_shift(one, jnp.maximum(sb - 1, 0)), 0)
    tie_res = jnp.where(D > half_up, q0 + 1,
                        jnp.where(D < -half_dn, q0, q0 + (q0 & 1)))
    return jnp.where(t2 == d, tie_res,
                     jnp.where(t2 > d, q0 + 1, q0))


def _bound(base, frac):
    """rint(base + frac) for int32 base and static frac ∈ [0, 1)."""
    if frac == 0.5:
        return base + (base & 1)
    return base + (1 if frac > 0.5 else 0)


def _ms_iterate(src_i32, sp_l: float, isr2: int, max_count: int, ethr: int):
    """Dense mean-shift colors [H,W,3] from every pixel of ``src_i32``."""
    H, W, _ = src_i32.shape
    src_flat = src_i32.reshape(H * W, 3)
    K = 2 * int(math.ceil(sp_l)) + 1
    m32_t, e_t = _recip_tables(K * K)
    n_lo, f_lo = int(math.floor(-sp_l)), -sp_l - math.floor(-sp_l)
    n_hi, f_hi = int(math.floor(sp_l)), sp_l - math.floor(sp_l)
    yy, xx = jnp.mgrid[0:H, 0:W]
    yy, xx = yy.astype(jnp.int32), xx.astype(jnp.int32)

    def body(_, state):
        x, y, c, active = state
        minx = jnp.maximum(_bound(x + n_lo, f_lo), 0)
        miny = jnp.maximum(_bound(y + n_lo, f_lo), 0)
        maxx = jnp.minimum(_bound(x + n_hi, f_hi), W - 1)
        maxy = jnp.minimum(_bound(y + n_hi, f_hi), H - 1)

        def scan_body(carry, off):
            cnt, s0, s1, s2, sx, sy = carry
            oy, ox = off // K, off % K
            ysw = miny + oy
            xsw = minx + ox
            valid = (ysw <= maxy) & (xsw <= maxx)
            idx = jnp.clip(ysw, 0, H - 1) * W + jnp.clip(xsw, 0, W - 1)
            v = src_flat[idx]
            dd = v - c
            sel = valid & ((dd * dd).sum(-1) <= isr2)
            si = sel.astype(jnp.int32)
            return (cnt + si,
                    s0 + si * v[..., 0], s1 + si * v[..., 1],
                    s2 + si * v[..., 2],
                    sx + si * xsw, sy + si * ysw), None

        z = jnp.zeros((H, W), jnp.int32)
        (cnt, s0, s1, s2, sx, sy), _ = lax.scan(
            scan_body, (z, z, z, z, z, z),
            jnp.arange(K * K, dtype=jnp.int32))
        dsafe = jnp.maximum(cnt, 1)
        x1 = _cv_round_div(sx, dsafe, m32_t, e_t)
        y1 = _cv_round_div(sy, dsafe, m32_t, e_t)
        c1 = jnp.stack([_cv_round_div(s, dsafe, m32_t, e_t)
                        for s in (s0, s1, s2)], axis=-1)
        dc = c1 - c
        stop = ((x1 == x) & (y1 == y)) | \
            ((jnp.abs(x1 - x) + jnp.abs(y1 - y) + (dc * dc).sum(-1)) <= ethr)
        alive = cnt > 0
        upd = active & alive
        x = jnp.where(upd, x1, x)
        y = jnp.where(upd, y1, y)
        c = jnp.where(upd[..., None], c1, c)
        return (x, y, c, active & alive & ~stop)

    state = lax.fori_loop(
        0, max_count, body,
        (xx, yy, src_i32, jnp.ones((H, W), bool)))
    return state[2]


def pyr_mean_shift_planes(img, sp: float, sr: float, max_level: int,
                          max_count: int, epsilon: float):
    """``cv2.pyrMeanShiftFiltering(img, sp, sr, maxLevel, termcrit)``
    for a u8 ``[H,W,3]`` image — bitwise-equal to the oracle/cv2."""
    isr2 = int(np.rint(float(sr) * float(sr)))
    isr22 = max(isr2, 16)
    mc = min(max(int(max_count), 1), 100)
    eps = max(float(epsilon), 0.0)
    ethr = min(int(math.floor(eps)), 2 ** 31 - 1)
    src_pyr = [img]
    for _ in range(int(max_level)):
        a = src_pyr[-1]
        src_pyr.append(
            pyr_down_planes(jnp.moveaxis(a, -1, 0)).transpose(1, 2, 0))
    dst = None
    for level in range(int(max_level), -1, -1):
        src = src_pyr[level].astype(jnp.int32)
        H, W = src.shape[:2]
        sp_l = max(float(np.float32(float(sp) / (1 << level))), 1.0)
        ms = _ms_iterate(src, sp_l, isr2, mc, ethr)
        if level < int(max_level):
            h1, w1 = dst.shape[:2]
            up = pyr_up_planes(jnp.moveaxis(dst, -1, 0))[:, :H, :W]
            up = up.transpose(1, 2, 0).astype(jnp.int32)
            m = jnp.zeros((H, W), bool)
            if h1 > 2 and w1 > 2:
                u = dst.astype(jnp.int32)
                t = u[1:-1, 1:-1]
                flag = jnp.zeros((h1 - 2, w1 - 2), bool)
                for di in (-1, 0, 1):
                    for dj in (-1, 0, 1):
                        if di == 0 and dj == 0:
                            continue
                        dd = u[1 + di:h1 - 1 + di, 1 + dj:w1 - 1 + dj] - t
                        flag = flag | ((dd * dd).sum(-1) >= isr22)
                # scatter-free placement of flag(i,j) at (2i+1, 2j−1):
                # a strided-slice scatter of bools was seen to miscompile
                # (flags correct, scattered mask wrong from row 35 of a
                # 128×131 image) — build the
                # interleaved grid with stack+reshape instead.
                a = jnp.pad(flag, ((1, 1), (1, 1)))        # [h1, w1]
                a = jnp.pad(a[:, 1:], ((0, 0), (0, 1)))    # col j → 2j−1
                z = jnp.zeros_like(a)
                rows = jnp.stack([z, a], axis=1).reshape(2 * h1, w1)
                m2 = jnp.stack([jnp.zeros_like(rows), rows],
                               axis=2).reshape(2 * h1, 2 * w1)
                m = m2[:H, :W]
                mp = jnp.pad(m, 1)
                acc = m
                for di in range(3):
                    for dj in range(3):
                        acc = acc | mp[di:di + H, dj:dj + W]
                m = acc
            out = jnp.where(m[..., None], ms, up)
        else:
            out = ms
        dst = out.astype(jnp.uint8)
    return dst
