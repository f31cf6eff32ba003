"""``cv2.distanceTransform`` on device — sheared-wavefront chamfer.

The reference algorithm is a two-pass sequential raster DP (forward +
backward), which looks hostile to a SIMD machine: every pixel depends on
its already-updated left/up neighbors.  The vectorized formulation used
here exploits two facts:

* Rounding to f32 is monotone, and ``min`` commutes with monotone maps,
  so ANY schedule that evaluates each candidate with the same single
  rounded f32 add produces bit-identical results to the raster order.
* Under the shear q = shear·i + j (shear 2 for the 3x3 mask, 3 for 5x5)
  every DP dependency of column q lives in columns q−1 … q−depth.

So each pass becomes one ``lax.scan`` over the sheared columns carrying
a ``depth``-column window; each step is a handful of vectorized f32
adds + mins over an H-vector, giving O(shear·H + W)
sequential steps instead of O(H·W).  The backward pass is the same scan
on the 180°-rotated field.

Parity: ref/ops.py distance_transform (bitwise; L2 mask-3 IPP nuance in
docs/PARITY.md).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

_FLT_MAX = np.float32(3.4028235e38)

_DIST_MASKS = {
    ("l1", 3): (np.float32(1.0), np.float32(2.0), None),
    ("c", 3): (np.float32(1.0), np.float32(1.0), None),
    ("l2", 3): (np.float32(0.955), np.float32(1.3693), None),
    ("l2", 5): (np.float32(1.0), np.float32(1.4), np.float32(2.1969)),
}


def _neighbors(a, b, c):
    # (rows_up, dj, weight) — cv2's forward candidate set
    n = [(0, -1, a), (1, 0, a), (1, -1, b), (1, 1, b)]
    if c is not None:
        n += [(1, -2, c), (1, 2, c), (2, -1, c), (2, 1, c)]
    return n


_BLOCK = 32  # sheared columns retired per scan step (amortizes step cost)


def _chamfer_pass(d: jnp.ndarray, neigh, shear: int) -> jnp.ndarray:
    """One forward chamfer pass over [B, H, W] planes via a column scan.

    Columns are processed in blocks of ``_BLOCK`` per scan step — the
    intra-block dependency chain is unrolled inside the step body, so
    the arithmetic (one rounded f32 add per candidate edge, mins) is
    identical to the column-at-a-time scan; only the schedule changes,
    which by the monotone-rounding argument cannot change any bit."""
    B, H, W = d.shape
    Q = shear * (H - 1) + W
    depth = max(shear * pi - dj for pi, dj, _ in neigh)
    K = _BLOCK
    # pad so (Q-1) columns after the seed column form whole blocks
    nblk = -(-(Q - 1) // K)
    Qp = 1 + nblk * K

    rows = np.arange(H)
    cols = shear * rows[:, None] + np.arange(W)[None, :]
    # sheared field [B, H, Qp] + validity of each sheared cell
    S = jnp.full((B, H, Qp), _FLT_MAX, jnp.float32)
    S = S.at[:, rows[:, None], cols].set(d)
    valid = np.zeros((H, Qp), bool)
    valid[rows[:, None], cols] = True

    # xs: per-step init block [K, B, H] and validity [K, H]
    xs_init = jnp.moveaxis(S[:, :, 1:], 2, 0).reshape(nblk, K, B, H)
    xs_valid = jnp.asarray(valid[:, 1:].T).reshape(nblk, K, H)

    # carry: the last `depth` columns, newest last  [depth, B, H]
    first = S[:, :, :1]
    pad = jnp.full((depth - 1, B, H), _FLT_MAX, jnp.float32)
    carry0 = jnp.concatenate([pad, jnp.moveaxis(first, 2, 0)], axis=0)

    shifts = [(pi, shear * pi - dj, jnp.float32(w)) for pi, dj, w in neigh]

    def step(carry, x):
        blk_init, blk_valid = x
        window = [carry[i] for i in range(depth)]  # oldest..newest
        outs = []
        for k in range(K):
            v = blk_init[k]
            for pi, dq, w in shifts:
                src = window[depth - dq]
                if pi:
                    src = jnp.concatenate(
                        [jnp.full((B, pi), _FLT_MAX, jnp.float32),
                         src[:, :-pi]], axis=1)
                v = jnp.minimum(v, src + w)
            v = jnp.where(blk_valid[k][None, :], v, _FLT_MAX)
            window = window[1:] + [v]
            outs.append(v)
        return jnp.stack(window), jnp.stack(outs)

    _, out = lax.scan(step, carry0, (xs_init, xs_valid))
    # out: [nblk, K, B, H] → prepend the seed column, unshear
    out = out.reshape(nblk * K, B, H)
    allcols = jnp.concatenate([jnp.moveaxis(first, 2, 0), out], axis=0)
    allcols = jnp.moveaxis(allcols, 0, 2)              # [B, H, Qp]
    return allcols[:, rows[:, None], cols]


def distance_transform_planes(planes: jnp.ndarray, distance_type: str = "l2",
                              mask_size: int = 3,
                              dst_type: str = "f32") -> jnp.ndarray:
    """``cv2.distanceTransform`` per plane (u8 in, f32 out; u8 out for
    L1).  Semantics + budgets pinned in ref/ops.py distance_transform."""
    if planes.dtype != jnp.uint8:
        raise TypeError("distanceTransform requires uint8 input")
    dt = str(distance_type).lower()
    m = 3 if dt in ("l1", "c") else int(mask_size)
    a, b, c = _DIST_MASKS[(dt, m)]
    shear = 2 if c is None else 3
    neigh = _neighbors(a, b, c)
    d = jnp.where(planes == 0, jnp.float32(0), _FLT_MAX).astype(jnp.float32)
    d = _chamfer_pass(d, neigh, shear)
    d = _chamfer_pass(d[:, ::-1, ::-1], neigh, shear)[:, ::-1, ::-1]
    if dst_type == "u8":
        return jnp.clip(d, 0, 255).astype(jnp.uint8)
    return d
