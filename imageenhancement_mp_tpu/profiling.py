"""Timing helpers: blocked wall-clock device timing with warm-up and
median-of-iters, throughput conversion, and the card's identity.

Always block on the result each iteration — medians over blocked calls
are stable, means over async dispatch are not.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

__all__ = ["time_op", "throughput_gpixs", "gpu_name_and_power"]


def time_op(
    fn: Callable, *args, iters: int = 10, warmup: int = 3, reduce: str = "median"
) -> float:
    """Wall-clock seconds per call of ``fn(*args)`` (device-blocked).

    ``reduce``: "median" (default) or "min" (timeit-style floor).
    """
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.min(ts) if reduce == "min" else np.median(ts))


def throughput_gpixs(shape, secs: float) -> float:
    """Pixels/second in GPix/s for an array of ``shape`` processed in ``secs``."""
    return float(np.prod(shape)) / secs / 1e9


def gpu_name_and_power() -> str:
    """The card's ``name, power.limit`` as nvidia-smi reports them.

    Read by a child process that does not import JAX.  Raises
    ``FileNotFoundError`` / ``CalledProcessError`` when nvidia-smi is
    missing or fails.
    """
    import subprocess

    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]
