"""Device ``seamlessClone`` (NORMAL_CLONE): FFT-DST Poisson editing.

The Poisson solve is a natural device op: two type-1 sine transforms
(odd-extension complex FFTs), an eigenvalue divide, and two inverse
transforms — one fused XLA program per (patch shape).  Geometry (the
mask bounding box / paste rect) is host-static like every other static
parameter; the per-pixel math mirrors ref/seamless.py (f32 spectra →
~1-LSB-class agreement with the f64 oracle, pinned by tests).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["seamless_clone_patch"]


def _dst1j(a: jnp.ndarray, axis: int) -> jnp.ndarray:
    a = jnp.moveaxis(a, axis, -1)
    n = a.shape[-1]
    z = jnp.zeros(a.shape[:-1] + (1,), a.dtype)
    ext = jnp.concatenate([z, a, z, -a[..., ::-1]], axis=-1)
    sp = jnp.fft.rfft(ext, axis=-1)
    out = -jnp.imag(sp)[..., 1 : n + 1] / 2.0
    return jnp.moveaxis(out, -1, axis)


@lru_cache(maxsize=None)
def _clone_jit(h: int, w: int):
    hh, ww = h - 2, w - 2
    jj = np.arange(1, hh + 1)
    kk = np.arange(1, ww + 1)
    ev = jnp.asarray(
        2.0 * np.cos(np.pi * jj / (hh + 1))[:, None]
        + 2.0 * np.cos(np.pi * kk / (ww + 1))[None, :]
        - 4.0,
        jnp.float32,
    )

    def one(s, d, m):
        s = s.astype(jnp.float32)
        d = d.astype(jnp.float32)

        def fgrad(a):
            gx = jnp.pad(a[:, 1:] - a[:, :-1], ((0, 0), (0, 1)))
            gy = jnp.pad(a[1:, :] - a[:-1, :], ((0, 1), (0, 0)))
            return gx, gy

        sgx, sgy = fgrad(s)
        dgx, dgy = fgrad(d)
        gx = jnp.where(m, sgx, dgx)
        gy = jnp.where(m, sgy, dgy)
        lap = (
            jnp.pad(gx[:, 1:] - gx[:, :-1], ((0, 0), (1, 0)))
            + jnp.pad(gx[:, :1], ((0, 0), (0, w - 1)))
            + jnp.pad(gy[1:, :] - gy[:-1, :], ((1, 0), (0, 0)))
            + jnp.pad(gy[:1, :], ((0, h - 1), (0, 0)))
        )
        rhs = lap[1:-1, 1:-1]
        rhs = rhs.at[0, :].add(-d[0, 1:-1])
        rhs = rhs.at[-1, :].add(-d[-1, 1:-1])
        rhs = rhs.at[:, 0].add(-d[1:-1, 0])
        rhs = rhs.at[:, -1].add(-d[1:-1, -1])
        t = _dst1j(_dst1j(rhs, 0), 1) / ev
        f = _dst1j(_dst1j(t, 0), 1) * jnp.float32(4.0 / ((hh + 1) * (ww + 1)))
        out = d.at[1:-1, 1:-1].set(f)
        return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)

    return jax.jit(jax.vmap(one, in_axes=(0, 0, None)))


def seamless_clone_patch(src_patch, dst_patch, mask_patch):
    """Blend ``[C, h, w]`` u8 src/dst patches under a ``[h, w]`` bool mask."""
    c, h, w = src_patch.shape
    return _clone_jit(h, w)(src_patch, dst_patch, jnp.asarray(mask_patch))
