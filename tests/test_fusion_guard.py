"""Fusion regression guard for the flagship pipeline (hist-eq → unsharp).

Its throughput depends on XLA keeping the hist-eq LUT gather, the
separable conv, and the unsharp epilogue inside a handful of fused passes
over pixel-scale data.  Nothing in the op code asserts that — an XLA
version bump that splits the fusion would slow the flagship silently.  This
test compiles the flagship and bounds the number of *materializing*
pixel-scale instructions in the entry computation (each one is a round
trip through device memory).  A fully-unfused pipeline has 25+ (one per
primitive); the fused program has 7 on the CPU backend and 2 on the H100
(the histogram is one Pallas kernel there; counted from the compiled HLO
on the card).
"""

import math
import re

import jax
import numpy as np
import pytest

from imageenhancement_mp_tpu.pipeline import equalize_unsharp

FREE_OPS = {"parameter", "bitcast", "reshape", "get-tuple-element", "tuple", "constant"}

# materializing-pixel-scale-instruction budgets per backend family
BOUNDS = {"cpu": 10, "gpu": 4}


def _count_pixel_scale_materializations(compiled_text: str, npix: int) -> list[tuple[str, int]]:
    entry = compiled_text[compiled_text.index("ENTRY"):]
    hits = []
    for m in re.finditer(r"^\s+(?:ROOT )?%?\S+ = (\S+?)\[([\d,]*)\][^ ]* (\S+?)\(", entry, re.M):
        _dtype, dims, op = m.groups()
        n = math.prod(int(d) for d in dims.split(",")) if dims else 0
        if op not in FREE_OPS and n >= npix:
            hits.append((op, n))
    return hits


def test_flagship_stays_fused():
    x = np.zeros((4, 256, 512), np.uint8)
    txt = jax.jit(lambda a: equalize_unsharp(a, 1.0, 5, 0.0)).lower(x).compile().as_text()
    hits = _count_pixel_scale_materializations(txt, x.size)
    platform = jax.devices()[0].platform
    bound = BOUNDS[platform]
    assert len(hits) <= bound, (
        f"flagship compiled to {len(hits)} pixel-scale materializing "
        f"instructions on {platform} (budget {bound}): {hits} — XLA fusion "
        "of the hist-LUT gather + conv + unsharp epilogue regressed; "
        "expect the bench headline to drop too"
    )
    # the LUT application must be a gather (not a 256-way select chain) and
    # appear exactly once at pixel scale inside the whole program
    assert txt.count("gather(") >= 1
