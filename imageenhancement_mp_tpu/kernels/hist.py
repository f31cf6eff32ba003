"""Pallas (Triton route) GPU kernel: exact 256-bin histogram of u8 planes.

Same exact formulation as the XLA form in ``ops/histogram.py``
(``hist[hi·16+lo] = Σ onehot(hi)ᵀ·onehot(lo)``), but the one-hots never
leave the block:

    grid = (plane b, pixel tile t)       every block is independent
    a[16, T] = (iota == x >> 4)          bf16, built in registers
    b[T, 16] = (x & 15 == iota)          bf16
    acc[16, 16] += a @ b                 tensor-core dot, f32 accumulation
    part[b, t] = acc                     one [16, 16] partial per block

and one XLA sum over ``t`` gives the histogram.  No atomics, so the
result is deterministic.  The f32 accumulation is exact: the operands are
0/1 and a block counts ``T·CHUNKS`` < 2^24 pixels.  Pixels past the end
of a plane are loaded as 0 and land in bin 0; the wrapper subtracts their
known count.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["hist256_gpu"]

T = 1024  # pixels per dot: [16, T] × [T, 16]
CHUNKS = 16  # dots per block (T·CHUNKS pixels per block)


def _hist_kernel(x_ref, out_ref, *, n: int):
    b = pl.program_id(0)
    t = pl.program_id(1)
    bins = jnp.arange(16, dtype=jnp.int32)

    def body(i, acc):
        idx = (t * CHUNKS + i) * T + jnp.arange(T, dtype=jnp.int32)
        x = plgpu.load(x_ref.at[b * n + idx], mask=idx < n, other=0)
        x = x.astype(jnp.int32)
        oh_hi = jnp.where(bins[:, None] == (x >> 4)[None, :], 1.0, 0.0)
        oh_lo = jnp.where((x & 15)[:, None] == bins[None, :], 1.0, 0.0)
        return acc + pl.dot(oh_hi.astype(jnp.bfloat16), oh_lo.astype(jnp.bfloat16))

    acc = jax.lax.fori_loop(0, CHUNKS, body, jnp.zeros((16, 16), jnp.float32))
    out_ref[...] = acc.astype(jnp.int32)


def hist256_gpu(planes: jnp.ndarray, interpret: bool = False) -> jnp.ndarray:
    """Exact per-plane histogram: ``[B, ...] u8 → [B, 256] i32``.

    Every axis after the first is flattened into the plane's pixels, so
    ``[B, H, W]`` planes and ``[B, P]`` pixel rows (CLAHE tiles) both work.
    ``interpret=True`` runs the kernel in the Pallas interpreter (tests).
    """
    if planes.dtype != jnp.uint8:
        raise TypeError(f"hist256_gpu expects uint8, got {planes.dtype}")
    B = planes.shape[0]
    n = 1
    for d in planes.shape[1:]:
        n *= int(d)
    per_block = T * CHUNKS
    n_tiles = -(-n // per_block)
    parts = pl.pallas_call(
        functools.partial(_hist_kernel, n=n),
        grid=(B, n_tiles),
        out_shape=jax.ShapeDtypeStruct((B, n_tiles, 16, 16), jnp.int32),
        out_specs=pl.BlockSpec((None, None, 16, 16), lambda b, t: (b, t, 0, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="hist256",
    )(planes.reshape(B * n))
    hist = parts.sum(axis=1).reshape(B, 256)  # hist[v] = H[v >> 4, v & 15]
    pad = n_tiles * per_block - n
    if pad:
        hist = hist.at[:, 0].add(jnp.int32(-pad))
    return hist
