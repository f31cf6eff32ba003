"""Pipeline composition: fuse enhancement chains into one jitted program.

The reference applies enhancements as sequential per-image OpenCV calls
(BASELINE.json:5); here a chain like ``median → CLAHE → unsharp``
(config 5, BASELINE.json:11) composes into a single XLA program — one
compile, no host round-trips between stages, elementwise stages fused by
XLA.  Stages that need global state (histograms, CLAHE tile LUTs) become
program-internal reductions, not HBM round-trips to the host.

Also hosts the flagship fused op of the north-star metric
(BASELINE.json:2): ``equalize_hist → unsharp_mask`` as one program.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp

from imageenhancement_mp_tpu.ops import OP_REGISTRY
from imageenhancement_mp_tpu.ops.filters import unsharp_mask_planes
from imageenhancement_mp_tpu.ops.histogram import equalize_hist_planes
from imageenhancement_mp_tpu.utils.shapes import as_planes

__all__ = ["OP_REGISTRY", "make_pipeline", "equalize_unsharp", "stream_frames"]

Stage = tuple[str, dict[str, Any]]


def _normalize_stages(stages: Sequence[Stage | str], registry) -> tuple:
    """Validate + freeze stage specs."""
    norm: list[tuple[str, tuple[tuple[str, Any], ...]]] = []
    for s in stages:
        if isinstance(s, str):
            name, kwargs = s, {}
        else:
            name, kwargs = s
        if name not in registry:
            raise KeyError(f"unknown op {name!r}; available: {sorted(registry)}")
        norm.append((name, tuple(sorted(dict(kwargs).items()))))
    return tuple(norm)


def _planes_count(shape: tuple, channels_last: bool) -> int:
    """Leading dim of the canonical [B,H,W] planes stack for ``shape``."""
    nd = len(shape)
    if nd == 2:
        return 1
    if nd == 3:
        hwc = channels_last and shape[-1] in (1, 2, 3, 4)
        return shape[-1] if hwc else shape[0]
    if nd == 4:
        return shape[0] * shape[-1]
    raise ValueError(f"expected 2-4 dims ([N,]H,W[,C]), got shape {shape}")


def make_pipeline(
    stages: Sequence[Stage | str],
    channels_last: bool = True,
    mesh=None,
    shard: str = "batch",
    axis_name: str | None = None,
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Compose named stages into one jitted callable over batched images.

    ``stages``: sequence of ``name`` or ``(name, kwargs)``; kwargs must be
    static (hashable).  ``channels_last=False`` reads 3-D inputs as
    ``[N, H, W]`` grayscale even when W ≤ 4 (utils/shapes.py).
    Example (config 5)::

        pipe = make_pipeline([
            ("median_blur", {"ksize": 5}),
            ("clahe", {"clip_limit": 2.0, "tile_grid": (8, 8)}),
            ("unsharp_mask", {"amount": 1.0}),
        ])
        out = pipe(batch_u8)   # [N,H,W[,C]] uint8

    **Multi-chip** (the front door to ``imageenhancement_mp_tpu.parallel``):
    pass a ``jax.sharding.Mesh`` and the SAME stage specs compile into one
    ``shard_map`` program over it —

    * ``shard="batch"`` (default): planes sharded on the leading dim
      (embarrassingly parallel per plane, zero collectives; the canonical
      plane count N·C must be divisible by the mesh size).  Collective
      stages still pool correctly (e.g. ``equalize_hist_global`` psums its
      histogram across shards).
    * ``shard="spatial"``: one frame's ROWS sharded across the mesh
      (stencils exchange ppermute halos, CLAHE all_gathers tile LUTs,
      geometry redistributes output rows — parallel/spatial.py); H must be
      divisible by the mesh size.  Stage names come from
      ``SPATIAL_OP_REGISTRY`` (a subset of ``OP_REGISTRY``).

    ``axis_name`` defaults to the mesh's first axis.  Feed sharded inputs
    with ``stream_frames(..., mesh=mesh)`` or
    ``parallel.device_put_sharded_batch`` — unsharded device/host arrays
    also work (XLA inserts the initial scatter).  Every sharded program is
    bit-identical to its single-device twin (tests/test_sharding.py,
    __graft_entry__.dryrun_multichip).
    """
    if mesh is not None and shard == "spatial":
        from imageenhancement_mp_tpu.parallel.spatial import (
            make_spatial_pipeline,
        )

        ax = axis_name or mesh.axis_names[0]
        sp = make_spatial_pipeline(stages, mesh, axis_name=ax)

        @jax.jit
        def run_spatial_jit(img: jnp.ndarray) -> jnp.ndarray:
            planes, restore = as_planes(img, channels_last=channels_last)
            return restore(sp(planes))

        def run_spatial(img: jnp.ndarray) -> jnp.ndarray:
            if img.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
                raise TypeError(
                    f"expected uint8/uint16/int16/float32 image array, got {img.dtype}"
                )
            n = mesh.shape[ax]
            h = img.shape[-3] if (
                img.ndim == 4 or (img.ndim == 3
                                  and channels_last and img.shape[-1] in (1, 2, 3, 4))
            ) else img.shape[-2]
            if h % n:
                raise ValueError(
                    f"spatial sharding needs H divisible by the mesh "
                    f"({ax}={n}); got H={h}")
            return run_spatial_jit(img)

        return run_spatial

    norm_t = _normalize_stages(stages, OP_REGISTRY)

    def chain(planes: jnp.ndarray) -> jnp.ndarray:
        for name, kw in norm_t:
            planes = OP_REGISTRY[name](planes, **dict(kw))
        return planes

    if mesh is None:
        inner = chain
    else:
        if shard != "batch":
            raise ValueError(f"shard must be 'batch' or 'spatial', got {shard!r}")
        from jax.sharding import PartitionSpec as P

        ax = axis_name or mesh.axis_names[0]
        inner = jax.shard_map(
            chain, mesh=mesh, in_specs=P(ax), out_specs=P(ax), check_vma=False
        )

    @jax.jit
    def run_jit(img: jnp.ndarray) -> jnp.ndarray:
        planes, restore = as_planes(img, channels_last=channels_last)
        return restore(inner(planes))

    def run(img: jnp.ndarray) -> jnp.ndarray:
        if img.dtype not in (jnp.uint8, jnp.uint16, jnp.int16, jnp.float32):
            raise TypeError(
                f"expected uint8/uint16/int16/float32 image array, got {img.dtype}"
            )
        if mesh is not None:
            n = mesh.shape[axis_name or mesh.axis_names[0]]
            b = _planes_count(img.shape, channels_last)
            if b % n:
                raise ValueError(
                    f"batch sharding needs the plane count (N·C={b}) divisible "
                    f"by the mesh ({n} devices); pad the batch or use "
                    f"shard='spatial' for single/narrow batches")
        return run_jit(img)

    return run


@partial(jax.jit, static_argnames=("amount", "ksize", "sigma"))
def _equalize_unsharp_jit(img, amount, ksize, sigma):
    planes, restore = as_planes(img)
    eq = equalize_hist_planes(planes)
    # XLA fuses the LUT gather, the separable conv and the unsharp
    # epilogue (tests/test_fusion_guard.py)
    return restore(unsharp_mask_planes(eq, amount, ksize, sigma))


def stream_frames(pipe: Callable, frames, depth: int = 2, mesh=None,
                  shard: str = "batch", axis_name: str | None = None,
                  channels_last: bool = True):
    """Stream frames/batches through a pipeline with transfer/compute overlap.

    Config 5 (BASELINE.json:11): "streaming batched 4K frames via
    double-buffered DMA".  Two levels of double buffering:

    ``jax.device_put`` is asynchronous and JAX dispatch is non-blocking,
    so with ``depth`` batches in flight the H2D transfer of batch t+1 and
    the compute of batch t overlap (classic double buffer at ``depth=2``).

    **Multi-chip**: pass the same ``mesh``/``shard``/``axis_name`` given to
    ``make_pipeline`` and each batch is ``device_put`` DIRECTLY onto its
    shards (H2D fans out per device — no gather-then-scatter hop through
    device 0), matching the program's input sharding.

    Yields device arrays in order; convert with np.asarray when needed.
    """
    from collections import deque

    if mesh is None:
        put = jax.device_put
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        ax = axis_name or mesh.axis_names[0]

        def put(frame):
            nd = getattr(frame, "ndim", len(frame.shape))
            hwc = nd == 4 or (
                nd == 3 and channels_last and frame.shape[-1] in (1, 2, 3, 4))
            if shard == "spatial":
                # rows live at axis -3 (HWC layouts) or -2 (plane layouts)
                spec = [None] * nd
                spec[nd - (3 if hwc else 2)] = ax
            else:
                spec = [None] * nd
                if nd == 4 or (nd == 3 and not hwc):
                    spec[0] = ax  # batch dim; single images stay replicated
            return jax.device_put(frame, NamedSharding(mesh, P(*spec)))

    q: deque = deque()
    for frame in frames:
        q.append(pipe(put(frame)))
        if len(q) >= depth:
            yield q.popleft()
    while q:
        yield q.popleft()


def equalize_unsharp(
    img: jnp.ndarray, amount: float = 1.0, ksize: int = 5, sigma: float = 0.0
) -> jnp.ndarray:
    """North-star fused pipeline: hist-eq → unsharp (BASELINE.json:2).

    One jitted program: the per-plane histogram, a tiny LUT build, then
    one XLA fusion of LUT gather + separable conv + unsharp epilogue.
    """
    if img.dtype != jnp.uint8:
        raise TypeError(f"expected uint8 image array, got {img.dtype}")
    return _equalize_unsharp_jit(img, float(amount), int(ksize), float(sigma))
