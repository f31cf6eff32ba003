"""Spatial (row) sharding on the virtual 8-device mesh: every sharded op
must equal its single-device planes twin (the collectives move exact
integers — halo rows, histograms, min/max, LUT tables — so shard-equality
is bitwise except where XLA:CPU's FMA contraction gives the CLAHE blend
its documented ±1 CPU-tier budget; docs/PARITY.md)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from imageenhancement_mp_tpu.ops.clahe import clahe_planes
from imageenhancement_mp_tpu.ops.filters import (
    gaussian_blur_planes,
    laplacian_sharpen_planes,
    unsharp_mask_planes,
)
from imageenhancement_mp_tpu.ops.histogram import equalize_hist_planes
from imageenhancement_mp_tpu.ops.median import median_blur_planes
from imageenhancement_mp_tpu.ops.pointwise import contrast_stretch_planes
from imageenhancement_mp_tpu.parallel.sharding import make_mesh
from imageenhancement_mp_tpu.parallel import spatial as sp


def maxdiff(a, b):
    return int(
        np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max()
    )


def run_spatial(fn, planes, n=8, **kw):
    mesh = make_mesh(n, axis_name="y")
    x = sp.device_put_spatial(planes, mesh)
    return np.asarray(sp.shard_spatial(fn, mesh, **kw)(x))


def test_halo_exchange_matches_global_pad(rng):
    """The halo-extended blocks, stitched, must equal np.pad of the frame."""
    planes = rng.integers(0, 256, (2, 40, 24), dtype=np.uint8)
    for r, mode, np_mode in [(1, "reflect", "reflect"), (2, "edge", "edge")]:
        mesh = make_mesh(8, axis_name="y")
        x = sp.device_put_spatial(planes, mesh)
        ext = np.asarray(
            sp.shard_spatial(lambda p: sp.halo_exchange(p, r, "y", mode), mesh)(x)
        )
        # shard_spatial stitches along rows: shard i contributes rows with
        # its halos inline, so reshape to [B, n, h+2r, W] via the sharded
        # output layout [B, n*(h+2r), W]
        h = planes.shape[1] // 8
        ext = ext.reshape(2, 8, h + 2 * r, 24)
        want = np.pad(planes, ((0, 0), (r, r), (0, 0)), mode=np_mode)
        for i in range(8):
            np.testing.assert_array_equal(ext[:, i], want[:, i * h : i * h + h + 2 * r])


@pytest.mark.parametrize(
    "ksize,sigma",
    [(3, 0.0), (5, 0.0), (7, 0.0), (5, 1.7), (0, 2.0)],
)
def test_gaussian_spatial_bitexact(rng, ksize, sigma):
    planes = rng.integers(0, 256, (2, 128, 40), dtype=np.uint8)
    got = run_spatial(
        lambda p: sp.gaussian_blur_spatial(p, ksize, sigma, axis_name="y"), planes
    )
    want = np.asarray(gaussian_blur_planes(jnp.asarray(planes), ksize, sigma))
    assert maxdiff(got, want) == 0


def test_gaussian_spatial_u16_q16(rng):
    planes = rng.integers(0, 65536, (1, 96, 32), dtype=np.uint16)
    got = run_spatial(
        lambda p: sp.gaussian_blur_spatial(p, 5, 1.3, axis_name="y"), planes
    )
    want = np.asarray(gaussian_blur_planes(jnp.asarray(planes), 5, 1.3))
    assert maxdiff(got, want) == 0


@pytest.mark.parametrize("ksize", [3, 5])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_median_spatial_bitexact(rng, ksize, dtype):
    hi = 256 if dtype == np.uint8 else 65536
    planes = rng.integers(0, hi, (2, 48, 36), dtype=dtype)
    got = run_spatial(
        lambda p: sp.median_blur_spatial(p, ksize, axis_name="y"), planes
    )
    want = np.asarray(median_blur_planes(jnp.asarray(planes), ksize))
    assert maxdiff(got, want) == 0


@pytest.mark.parametrize("amount", [1.0, 0.7])
def test_unsharp_spatial_bitexact(rng, amount):
    planes = rng.integers(0, 256, (2, 64, 44), dtype=np.uint8)
    got = run_spatial(
        lambda p: sp.unsharp_mask_spatial(p, amount, 5, 0.0, axis_name="y"), planes
    )
    want = np.asarray(unsharp_mask_planes(jnp.asarray(planes), amount, 5, 0.0))
    assert maxdiff(got, want) == 0


def test_laplacian_sharpen_spatial_bitexact(rng):
    planes = rng.integers(0, 256, (3, 32, 28), dtype=np.uint8)
    got = run_spatial(lambda p: sp.laplacian_sharpen_spatial(p, "y"), planes)
    want = np.asarray(laplacian_sharpen_planes(jnp.asarray(planes)))
    assert maxdiff(got, want) == 0


def test_equalize_hist_spatial_bitexact(rng):
    planes = rng.integers(0, 256, (3, 56, 33), dtype=np.uint8)
    got = run_spatial(lambda p: sp.equalize_hist_spatial(p, axis_name="y"), planes)
    want = np.asarray(equalize_hist_planes(jnp.asarray(planes)))
    assert maxdiff(got, want) == 0


@pytest.mark.parametrize(
    "dtype,out_range",
    [(np.uint8, (0.0, 255.0)), (np.uint8, (30.5, 200.25)), (np.uint16, (0.0, 65535.0))],
)
def test_contrast_stretch_spatial_bitexact(rng, dtype, out_range):
    hi = 256 if dtype == np.uint8 else 65536
    planes = rng.integers(3, hi - 2, (2, 40, 24), dtype=dtype)
    got = run_spatial(
        lambda p: sp.contrast_stretch_spatial(p, out_range, axis_name="y"), planes
    )
    want = np.asarray(contrast_stretch_planes(jnp.asarray(planes), out_range))
    assert maxdiff(got, want) == 0


def test_contrast_stretch_spatial_f32(rng):
    planes = rng.normal(100.0, 40.0, (2, 40, 24)).astype(np.float32)
    got = run_spatial(
        lambda p: sp.contrast_stretch_spatial(p, (0.0, 255.0), axis_name="y"), planes
    )
    want = np.asarray(contrast_stretch_planes(jnp.asarray(planes), (0.0, 255.0)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_clahe_spatial_matches_single_device(rng, dtype):
    hi = 256 if dtype == np.uint8 else 65536
    planes = rng.integers(0, hi, (2, 64, 48), dtype=dtype)
    got = run_spatial(
        lambda p: sp.clahe_spatial(p, 2.0, (8, 8), axis_name="y"), planes
    )
    want = np.asarray(clahe_planes(jnp.asarray(planes), 2.0, (8, 8)))
    # the CLAHE blend carries the documented ±1 CPU-tier budget (XLA:CPU
    # FMA contraction can differ between the two compiled programs)
    assert maxdiff(got, want) <= 1


def test_clahe_spatial_multiple_tile_rows_per_shard(rng):
    """gh=16 over 8 shards → 2 tile rows per shard (ghl > 1 path)."""
    planes = rng.integers(0, 256, (1, 128, 32), dtype=np.uint8)
    got = run_spatial(
        lambda p: sp.clahe_spatial(p, 3.0, (16, 4), axis_name="y"), planes
    )
    want = np.asarray(clahe_planes(jnp.asarray(planes), 3.0, (16, 4)))
    assert maxdiff(got, want) <= 1


def test_config5_pipeline_spatial(rng):
    """The judged config-5 chain (median → CLAHE → unsharp) row-sharded:
    one halo exchange per stencil + the CLAHE all_gather, one program."""
    planes = rng.integers(0, 256, (2, 64, 40), dtype=np.uint8)

    def chain_local(p):
        p = sp.median_blur_spatial(p, 3, axis_name="y")
        p = sp.clahe_spatial(p, 2.0, (8, 8), axis_name="y")
        return sp.unsharp_mask_spatial(p, 1.0, 5, 0.0, axis_name="y")

    got = run_spatial(chain_local, planes)
    p = median_blur_planes(jnp.asarray(planes), 3)
    p = clahe_planes(p, 2.0, (8, 8))
    want = np.asarray(unsharp_mask_planes(p, 1.0, 5, 0.0))
    # a ±1 CLAHE CPU-tier flip amplifies through unsharp by ≤ (1+a)+a = 3
    assert maxdiff(got, want) <= 3


def test_flagship_spatial_bitexact(rng):
    """hist-eq (psum) → unsharp (halo): the north-star pipeline sharded."""
    planes = rng.integers(0, 256, (2, 64, 52), dtype=np.uint8)

    def chain_local(p):
        p = sp.equalize_hist_spatial(p, axis_name="y")
        return sp.unsharp_mask_spatial(p, 1.0, 5, 0.0, axis_name="y")

    got = run_spatial(chain_local, planes)
    want = np.asarray(
        unsharp_mask_planes(equalize_hist_planes(jnp.asarray(planes)), 1.0, 5, 0.0)
    )
    assert maxdiff(got, want) == 0


def test_batch_dp_times_spatial_2d_mesh(rng):
    """2-D mesh: batch DP × spatial on Mesh(('batch','y')) = (2, 4)."""
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = jax.sharding.Mesh(devs, ("batch", "y"))
    planes = rng.integers(0, 256, (4, 32, 40), dtype=np.uint8)
    x = sp.device_put_spatial(planes, mesh, axis_name="y", batch_axis="batch")

    def chain_local(p):
        p = sp.equalize_hist_spatial(p, axis_name="y")
        return sp.gaussian_blur_spatial(p, 5, axis_name="y")

    got = np.asarray(
        sp.shard_spatial(chain_local, mesh, axis_name="y", batch_axis="batch")(x)
    )
    want = np.asarray(
        gaussian_blur_planes(equalize_hist_planes(jnp.asarray(planes)), 5)
    )
    assert maxdiff(got, want) == 0


def test_halo_radius_too_large_raises(rng):
    planes = rng.integers(0, 256, (1, 16, 24), dtype=np.uint8)  # h=2 per shard
    with pytest.raises(ValueError, match="too small for halo radius"):
        run_spatial(lambda p: sp.gaussian_blur_spatial(p, 7, axis_name="y"), planes)


def test_clahe_spatial_indivisible_raises(rng):
    planes = rng.integers(0, 256, (1, 64, 48), dtype=np.uint8)
    with pytest.raises(ValueError, match="divisible by mesh size"):
        run_spatial(lambda p: sp.clahe_spatial(p, 2.0, (4, 4), axis_name="y"), planes)
    with pytest.raises(ValueError, match="divisible geometry"):
        run_spatial(lambda p: sp.clahe_spatial(p, 2.0, (8, 5), axis_name="y"), planes)


def test_make_spatial_pipeline_matches_make_pipeline(rng):
    """The same stage specs, row-sharded, must match pipeline.make_pipeline."""
    from imageenhancement_mp_tpu.pipeline import make_pipeline
    from imageenhancement_mp_tpu.parallel.spatial import make_spatial_pipeline

    specs = [
        ("median_blur", {"ksize": 3}),
        ("clahe", {"clip_limit": 2.0, "tile_grid": (8, 8)}),
        ("unsharp_mask", {"amount": 1.0}),
    ]
    planes = rng.integers(0, 256, (2, 64, 40), dtype=np.uint8)
    mesh = make_mesh(8, axis_name="y")
    got = np.asarray(
        make_spatial_pipeline(specs, mesh)(sp.device_put_spatial(planes, mesh))
    )
    want = np.asarray(make_pipeline(specs)(planes))
    # CLAHE's documented ±1 CPU-tier budget amplifies ≤3 through unsharp
    assert maxdiff(got, want) <= 3


def test_make_spatial_pipeline_pointwise_and_pooled(rng):
    from imageenhancement_mp_tpu.pipeline import make_pipeline
    from imageenhancement_mp_tpu.parallel.spatial import make_spatial_pipeline

    specs = [("gamma", {"gamma": 2.2}), "equalize_hist", "contrast_stretch"]
    planes = rng.integers(0, 256, (3, 40, 28), dtype=np.uint8)
    mesh = make_mesh(8, axis_name="y")
    got = np.asarray(
        make_spatial_pipeline(specs, mesh)(sp.device_put_spatial(planes, mesh))
    )
    want = np.asarray(make_pipeline(specs)(planes))
    assert maxdiff(got, want) == 0


def test_make_spatial_pipeline_unknown_op():
    from imageenhancement_mp_tpu.parallel.spatial import make_spatial_pipeline

    mesh = make_mesh(8, axis_name="y")
    with pytest.raises(KeyError, match="unknown spatial op"):
        make_spatial_pipeline(["nope"], mesh)


def test_median_spatial_shard_height_equals_radius(rng):
    """Replicate-border halo exchange only needs h >= r: median5 (r=2) on
    2-row shards must work and match the single-device op."""
    planes = rng.integers(0, 256, (1, 16, 24), dtype=np.uint8)  # h=2 per shard
    got = run_spatial(lambda p: sp.median_blur_spatial(p, 5, axis_name="y"), planes)
    want = np.asarray(median_blur_planes(jnp.asarray(planes), 5))
    assert maxdiff(got, want) == 0


@pytest.mark.parametrize("ksize", [3, (5, 7)])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
def test_box_blur_spatial_bitexact(rng, ksize, dtype):
    lo, hi = (0, 256) if dtype == np.uint8 else (-32768, 32768)
    planes = rng.integers(lo, hi, (2, 64, 36)).astype(dtype)
    from imageenhancement_mp_tpu.ops.filters import box_blur_planes

    got = run_spatial(lambda p: sp.box_blur_spatial(p, ksize, axis_name="y"), planes)
    want = np.asarray(box_blur_planes(jnp.asarray(planes), ksize))
    assert maxdiff(got, want) == 0


def test_bilateral_spatial_bitexact(rng):
    planes = rng.integers(0, 256, (2, 64, 36), dtype=np.uint8)
    from imageenhancement_mp_tpu.ops.bilateral import bilateral_planes

    got = run_spatial(
        lambda p: sp.bilateral_spatial(p, 5, 30.0, 6.0, axis_name="y"), planes
    )
    want = np.asarray(bilateral_planes(jnp.asarray(planes), 5, 30.0, 6.0))
    assert maxdiff(got, want) == 0


def test_adaptive_threshold_spatial_bitexact(rng):
    planes = rng.integers(0, 256, (2, 64, 36), dtype=np.uint8)
    from imageenhancement_mp_tpu.ops.threshold import adaptive_threshold_planes

    got = run_spatial(
        lambda p: sp.adaptive_threshold_spatial(p, 255.0, "gaussian", "binary", 11, 2.0,
                                                axis_name="y"), planes
    )
    want = np.asarray(adaptive_threshold_planes(jnp.asarray(planes), 255.0, "gaussian",
                                                "binary", 11, 2.0))
    assert maxdiff(got, want) == 0


@pytest.mark.parametrize("op", ["erode", "dilate", "open", "gradient", "blackhat"])
def test_morphology_spatial_bitexact(rng, op):
    planes = rng.integers(0, 256, (2, 64, 36), dtype=np.uint8)
    from imageenhancement_mp_tpu.ops.morphology import morphology_planes

    got = run_spatial(
        lambda p: sp.morphology_spatial(p, op, (3, 5), 2, axis_name="y"), planes
    )
    want = np.asarray(morphology_planes(jnp.asarray(planes), op, (3, 5), 2))
    assert maxdiff(got, want) == 0, op


def test_sobel_spatial_bitexact(rng):
    planes = rng.integers(0, 256, (2, 64, 36), dtype=np.uint8)
    from imageenhancement_mp_tpu.ops.filters import sobel_planes

    got = run_spatial(lambda p: sp.sobel_spatial(p, 1, 1, 5, axis_name="y"), planes)
    want = np.asarray(sobel_planes(jnp.asarray(planes), 1, 1, 5))
    assert maxdiff(got, want) == 0


def test_filter2d_spatial_bitexact(rng):
    planes = rng.integers(0, 256, (2, 64, 36), dtype=np.uint8)
    from imageenhancement_mp_tpu.ops.filter2d import filter2d_planes

    k = ((0, -1, 0), (-1, 5, -1), (0, -1, 0))
    got = run_spatial(lambda p: sp.filter2d_spatial(p, k, 2.5, axis_name="y"), planes)
    want = np.asarray(filter2d_planes(jnp.asarray(planes), k, 2.5))
    assert maxdiff(got, want) == 0
