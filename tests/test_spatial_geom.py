"""Round-3 spatial geometry: resize/warpAffine/remap/canny on the
8-device mesh must equal their single-device planes twins bitwise
(output-row redistribution — docs/DESIGN.md; parallel/spatial.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

from detseed import seed
from imageenhancement_mp_tpu.ops.canny import canny_planes
from imageenhancement_mp_tpu.ops.resize import resize_planes
from imageenhancement_mp_tpu.ops.warp import remap_planes, warp_affine_planes
from imageenhancement_mp_tpu.parallel.sharding import make_mesh
from imageenhancement_mp_tpu.parallel import spatial as sp
from imageenhancement_mp_tpu.ref.ops import get_rotation_matrix_2d


def run_spatial(fn, planes, n=8):
    mesh = make_mesh(n, axis_name="y")
    x = sp.device_put_spatial(planes, mesh)
    return np.asarray(sp.shard_spatial(fn, mesh)(x))


def _img(rng, dt, shape):
    if dt is np.float32:
        return (rng.random(shape) * 500 - 100).astype(np.float32)
    lo, hi = (0, 256) if dt is np.uint8 else (
        (0, 65536) if dt is np.uint16 else (-32768, 32768))
    return rng.integers(lo, hi, shape).astype(dt)


@pytest.mark.parametrize("interp,dsize", [
    ("nearest", (40, 28)), ("linear", (40, 28)), ("linear", (96, 80)),
    ("cubic", (56, 44)), ("lanczos4", (56, 44)), ("area", (32, 18)), ("area", (16, 12)),
    ("area", (96, 70)),
])
@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.float32])
def test_resize_spatial_bitexact(interp, dsize, dt):
    rng = np.random.default_rng(seed("rsp", interp, dsize, dt.__name__))
    planes = _img(rng, dt, (2, 64, 36))
    want = np.asarray(resize_planes(jnp.asarray(planes), dsize, interp))
    got = run_spatial(lambda p: sp.resize_spatial(p, dsize, interp), planes)
    if dt is np.uint8 or interp == "nearest":
        # integer fixed-point / gather paths: bitwise on every backend
        assert np.array_equal(got, want), (interp, dsize, dt)
    else:
        # f32 lerp paths: XLA:CPU contracts mul+add into FMA differently
        # across compilation contexts (the documented CLAHE-tier caveat,
        # docs/PARITY.md "backend nuance")
        d = np.abs(got.astype(np.float64) - want.astype(np.float64))
        lim = 1.0 if dt is not np.float32 else 1e-2 * max(1.0, np.abs(want).max())
        assert float(d.max()) <= lim, (interp, dsize, dt, d.max())


@pytest.mark.parametrize("interp", ["linear", "nearest"])
@pytest.mark.parametrize("dt", [np.uint8, np.int16, np.float32])
def test_warp_spatial_bitexact(interp, dt):
    rng = np.random.default_rng(seed("wsp", interp, dt.__name__))
    planes = _img(rng, dt, (2, 48, 40))
    M = get_rotation_matrix_2d((20.0, 24.0), 25.0, 0.9)
    for border, bv in (("constant", 7.0), ("replicate", 0.0)):
        want = np.asarray(warp_affine_planes(
            jnp.asarray(planes), M, (64, 52), interp, border, bv))
        got = run_spatial(
            lambda p: sp.warp_affine_spatial(p, M, (64, 52), interp, border, bv),
            planes)
        assert np.array_equal(got, want), (interp, dt, border)


@pytest.mark.parametrize("dt", [np.uint8, np.uint16, np.int16, np.float32])
def test_remap_spatial_bitexact(dt):
    rng = np.random.default_rng(seed("remsp", dt.__name__))
    planes = _img(rng, dt, (2, 48, 40))
    oh, ow = 32, 36
    mx = (rng.random((oh, ow)) * 44 - 2).astype(np.float32)
    my = (rng.random((oh, ow)) * 52 - 2).astype(np.float32)
    want = np.asarray(remap_planes(jnp.asarray(planes), jnp.asarray(mx),
                                   jnp.asarray(my)))
    # maps shard like the output rows
    mesh = make_mesh(8, axis_name="y")
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    x = sp.device_put_spatial(planes, mesh)
    mxs = jax.device_put(mx, NamedSharding(mesh, P("y", None)))
    mys = jax.device_put(my, NamedSharding(mesh, P("y", None)))
    f = jax.shard_map(lambda p, a, b: sp.remap_spatial(p, a, b),
                      mesh=mesh,
                      in_specs=(P(None, "y", None), P("y", None), P("y", None)),
                      out_specs=P(None, "y", None))
    got = np.asarray(jax.jit(f)(x, mxs, mys))
    assert np.array_equal(got, want), dt


@pytest.mark.parametrize("ap,l2", [(3, False), (3, True), (5, False), (7, True)])
def test_canny_spatial_bitexact(ap, l2):
    rng = np.random.default_rng(seed("csp", ap, l2))
    # smooth-ish structure so hysteresis has real weak-edge chains that
    # cross shard boundaries
    base = rng.integers(0, 256, (2, 8, 6)).astype(np.uint8)
    planes = np.stack([np.kron(b, np.ones((8, 8), np.uint8)) for b in base])
    noise = rng.integers(0, 30, planes.shape).astype(np.uint8)
    planes = np.clip(planes.astype(np.int32) + noise, 0, 255).astype(np.uint8)
    want = np.asarray(canny_planes(jnp.asarray(planes), 40.0, 120.0, ap, l2))
    got = run_spatial(lambda p: sp.canny_spatial(p, 40.0, 120.0, ap, l2), planes)
    assert np.array_equal(got, want), (ap, l2)


def test_resize_rejects_undivisible_output():
    planes = np.zeros((1, 64, 32), np.uint8)
    with pytest.raises(ValueError):
        run_spatial(lambda p: sp.resize_spatial(p, (42, 20)), planes)


def test_warp_polar_spatial_bitexact():
    from imageenhancement_mp_tpu.ops.warp import remap_planes
    from imageenhancement_mp_tpu.ref.ops import _warp_polar_maps
    rng = np.random.default_rng(seed("wpsp"))
    planes = rng.integers(0, 256, (2, 64, 48), np.uint8)
    for log, inv, dsz in [(False, False, (40, 64)), (True, False, (40, 64)),
                          (False, True, (48, 64)), (True, True, (48, 64))]:
        mx, my = _warp_polar_maps((64, 48), dsz, (23.5, 30.25), 28.0, log, inv)
        src = jnp.asarray(planes)
        if inv:
            src = jnp.concatenate([src[:, -1:], src, src[:, :1]], axis=1)
        want = np.asarray(remap_planes(src, mx, my, "linear", "constant", 0.0))
        got = run_spatial(lambda p: sp.warp_polar_spatial(
            p, dsz, (23.5, 30.25), 28.0, log, inv), planes)
        assert np.array_equal(got, want), (log, inv)


@pytest.mark.parametrize("interp", ["cubic", "lanczos4"])
@pytest.mark.parametrize("dt", [np.uint8, np.float32])
def test_warp_affine_spatial_cubic_lanczos(interp, dt):
    rng = np.random.default_rng(seed("spatialwarp", interp, dt.__name__))
    planes = _img(rng, dt, (2, 64, 72))
    M = get_rotation_matrix_2d((36.0, 32.0), 25.0, 0.95)
    want = np.asarray(warp_affine_planes(jnp.asarray(planes), M, (64, 72),
                                         interp, "replicate"))
    got = run_spatial(
        lambda p: sp.warp_affine_spatial(p, M, (64, 72), interp, "replicate"),
        planes)
    if dt is np.uint8:
        assert np.array_equal(got, want), interp
    else:
        # XLA FMA-contraction tier
        d = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
        assert d <= 1e-2 * max(1.0, float(np.abs(want).max())), (interp, d)
