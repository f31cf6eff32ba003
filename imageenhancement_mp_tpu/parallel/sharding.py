"""Multi-device batch data parallelism via jax.sharding + shard_map.

The reference is single-process/single-image (SURVEY.md §2: no distributed
anything), so the only parallelism axis with meaning here is the batch of
images.  The scale-out is a 1-D device Mesh over a ``batch``
axis: planes are sharded on their leading dimension, every enhancement is
embarrassingly parallel per plane (all per-plane state — histograms, min/
max, CLAHE tile LUTs — is local to a shard), so the sharded program needs
NO collectives and all "communication" is the initial shard placement.
``shard_map`` is used rather than relying on XLA's automatic partitioner so
the histogram kernel inside the pipeline stays whole per shard.
"""

from __future__ import annotations

from typing import Callable

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_pipeline", "device_put_sharded_batch", "equalize_hist_global_sharded"]


def make_mesh(n_devices: int | None = None, axis_name: str = "batch") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    return jax.make_mesh((n_devices,), (axis_name,), devices=devs[:n_devices])


def shard_pipeline(
    planes_fn: Callable, mesh: Mesh, axis_name: str = "batch"
) -> Callable:
    """Shard a planes-level pipeline ``[B,H,W]→[B,H,W]`` over the mesh batch axis.

    B must be divisible by the mesh size.  Returns a jitted callable.
    """
    sharded = jax.shard_map(
        planes_fn,
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(axis_name),
        check_vma=False,
    )
    return jax.jit(sharded)


def equalize_hist_global_sharded(mesh: Mesh, axis_name: str = "batch", channels: int = 1):
    """Sharded video-consistent hist-eq: per-shard histograms pool across
    the mesh with a ``psum`` between devices, every frame maps through the same
    global LUT.  Returns a jitted ``[B,H,W] u8 -> [B,H,W] u8`` callable
    (B divisible by the mesh size).

    ``channels > 1`` says each shard's planes are frame-major/channel-minor
    ``B = N·channels`` stacks; each channel pools its own histogram across
    frames AND shards (matching ``api.equalize_hist(per_frame=False)``)."""
    from imageenhancement_mp_tpu.ops.histogram import equalize_hist_global_planes

    def fn(planes):
        return equalize_hist_global_planes(planes, axis_name=axis_name, channels=channels)

    sharded = jax.shard_map(
        fn, mesh=mesh, in_specs=P(axis_name), out_specs=P(axis_name), check_vma=False
    )
    return jax.jit(sharded)


def device_put_sharded_batch(batch, mesh: Mesh, axis_name: str = "batch"):
    """Place a host batch onto the mesh, sharded along the leading dim."""
    ndim = getattr(batch, "ndim", len(batch.shape))
    spec = P(axis_name, *([None] * (ndim - 1)))
    return jax.device_put(batch, NamedSharding(mesh, spec))
