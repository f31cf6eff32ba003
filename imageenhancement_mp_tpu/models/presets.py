"""Enhancement pipeline presets ("model zoo" of this framework).

The reference has no neural models — its "models" are enhancement recipes
(BASELINE.json:6-12).  Each preset is a named, judged configuration that
compiles to a single XLA program via pipeline.make_pipeline.
"""

from __future__ import annotations

from imageenhancement_mp_tpu.pipeline import make_pipeline

# The five judged configs (BASELINE.json:6-12)
PRESETS: dict[str, list] = {
    # config 1/2: point ops
    "histeq": [("equalize_hist", {})],
    "gamma_stretch": [("gamma", {"gamma": 2.2}), ("contrast_stretch", {})],
    # config 3: fused spatial filters
    "sharpen": [("unsharp_mask", {"amount": 1.0, "ksize": 5})],
    # config 4
    "clahe": [("clahe", {"clip_limit": 2.0, "tile_grid": (8, 8)})],
    # config 5: full streaming pipeline
    "denoise_clahe_sharpen": [
        ("median_blur", {"ksize": 5}),
        ("clahe", {"clip_limit": 2.0, "tile_grid": (8, 8)}),
        ("unsharp_mask", {"amount": 1.0, "ksize": 5}),
    ],
    # two-stage denoise+sharpen (stateless chain)
    "denoise_sharpen": [
        ("median_blur", {"ksize": 5}),
        ("unsharp_mask", {"amount": 1.0, "ksize": 5}),
    ],
    # north-star pipeline (BASELINE.json:2)
    "histeq_unsharp": [("equalize_hist", {}), ("unsharp_mask", {"amount": 1.0, "ksize": 5})],
}


def get_preset(name: str, mesh=None, shard: str = "batch",
               axis_name: str | None = None):
    """Build the jitted pipeline for a named preset.

    ``mesh``/``shard``/``axis_name`` pass through to
    ``pipeline.make_pipeline`` — the same preset compiles into one
    shard_map program over a multi-chip mesh (batch DP or row-sharded
    spatial; bit-identical to the single-device program)."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return make_pipeline(PRESETS[name], mesh=mesh, shard=shard,
                         axis_name=axis_name)
