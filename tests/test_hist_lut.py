"""Histogram / LUT tier: the GPU histogram kernel (kernels/hist.py) in the
Pallas interpreter, the ``histogram_256`` choice of implementation, and
the LUT-driven ops (hist-eq, gamma+stretch, CLAHE) vs the oracles."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.kernels import hist as khist
from imageenhancement_mp_tpu.ops.histogram import (
    _hist_nibble_matmul,
    _hist_scatter,
    histogram_256,
)
from detseed import seed


def _bincount(x):
    return np.stack([np.bincount(p.ravel(), minlength=256) for p in x.reshape(x.shape[0], -1)])


@pytest.mark.parametrize(
    "shape",
    [(1, 8, 16), (3, 64, 80), (2, 999), (5, 7, 13), (1, 1, 1),
     # exactly one block, one block + 1 pixel, several blocks per plane
     (1, khist.T * khist.CHUNKS), (2, khist.T * khist.CHUNKS + 1), (2, 3 * khist.T * khist.CHUNKS - 5)],
)
def test_hist_kernel_interpret(shape):
    rng = np.random.default_rng(seed("hist256"))
    x = rng.integers(0, 256, shape, np.uint8)
    got = np.asarray(khist.hist256_gpu(jnp.asarray(x), interpret=True))
    assert got.dtype == np.int32 and got.shape == (shape[0], 256)
    assert np.array_equal(got, _bincount(x)), shape


@pytest.mark.parametrize("fill", [0, 255])
def test_hist_kernel_constant_planes(fill):
    # all pixels in one bin, with the pad pixels of the last block also in
    # bin 0: the pad correction must leave exactly n (or 0) there
    x = np.full((2, 37, 41), fill, np.uint8)
    got = np.asarray(khist.hist256_gpu(jnp.asarray(x), interpret=True))
    assert np.array_equal(got, _bincount(x))


def test_hist_kernel_rejects_non_u8():
    with pytest.raises(TypeError):
        khist.hist256_gpu(jnp.zeros((1, 4, 4), jnp.uint16), interpret=True)


def test_hist_kernel_matches_xla_forms():
    """The kernel, the nibble matmul and the scatter are the same math."""
    rng = np.random.default_rng(seed("hist_ab"))
    x = jnp.asarray(rng.integers(0, 256, (3, 50, 61), np.uint8))
    a = np.asarray(khist.hist256_gpu(x, interpret=True))
    b = np.asarray(jax.vmap(_hist_nibble_matmul)(x))
    c = np.asarray(jax.vmap(_hist_scatter)(x))
    assert np.array_equal(a, b) and np.array_equal(b, c)


def test_histogram_256_default_method(monkeypatch):
    """The platform picks the implementation: the kernel on a GPU, the
    nibble matmul elsewhere; u16 always scatters."""
    calls = []
    real = khist.hist256_gpu
    monkeypatch.setattr(khist, "hist256_gpu",
                        lambda p: calls.append(p.shape) or real(p, interpret=True))
    x = jnp.asarray(np.random.default_rng(seed("hist_default")).integers(
        0, 256, (2, 20, 30), np.uint8))
    want = _bincount(np.asarray(x))
    assert np.array_equal(np.asarray(histogram_256(x)), want)
    assert calls == []  # CPU backend: the XLA form
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert np.array_equal(np.asarray(histogram_256(x)), want)
    assert calls == [(2, 20, 30)]
    u16 = jnp.asarray(np.arange(600, dtype=np.uint16).reshape(1, 20, 30))
    h16 = np.asarray(histogram_256(u16))
    assert h16.shape == (1, 65536) and h16[0, :600].tolist() == [1] * 600
    assert calls == [(2, 20, 30)]


def test_apply_lut_dtypes():
    from imageenhancement_mp_tpu.ops.pointwise import apply_lut_planes

    rng = np.random.default_rng(seed("lutapply"))
    x = rng.integers(0, 256, (3, 37, 53), np.uint8)
    for dt, hi in [(np.uint8, 256), (np.uint16, 65536), (np.int32, 1 << 24)]:
        lut = rng.integers(0, hi, (256,)).astype(dt)
        got = np.asarray(apply_lut_planes(jnp.asarray(x), jnp.asarray(lut)))
        assert got.dtype == dt and np.array_equal(got, lut[x]), dt
    lutf = (rng.random(256) * 2000 - 700).astype(np.float32)
    got = np.asarray(apply_lut_planes(jnp.asarray(x), jnp.asarray(lutf)))
    assert np.array_equal(got, lutf[x])
    # per-plane LUTs
    luts = rng.integers(0, 256, (3, 256), np.uint8)
    got = np.asarray(apply_lut_planes(jnp.asarray(x), jnp.asarray(luts)))
    want = np.stack([l[p] for l, p in zip(luts, x)])
    assert np.array_equal(got, want)


def test_equalize_hist_vs_oracle():
    from imageenhancement_mp_tpu.ops.histogram import equalize_hist_planes

    rng = np.random.default_rng(seed("histeq_pallas"))
    x = rng.integers(0, 256, (3, 100, 131), np.uint8)
    got = np.asarray(jax.jit(equalize_hist_planes)(x))
    want = np.stack([ref.equalize_hist(p) for p in x])
    assert np.array_equal(got, want)


def test_gamma_stretch_vs_oracle():
    from imageenhancement_mp_tpu.ops.pointwise import (
        contrast_stretch_planes,
        gamma_planes,
    )

    rng = np.random.default_rng(seed("gs_pallas"))
    x = rng.integers(3, 200, (2, 64, 80), np.uint8)
    got = np.asarray(
        jax.jit(lambda v: contrast_stretch_planes(gamma_planes(v, 2.2)))(x)
    )
    want = np.stack([ref.contrast_stretch(ref.gamma_transform(p, 2.2)) for p in x])
    assert np.array_equal(got, want)


def test_clahe_vs_oracle():
    from imageenhancement_mp_tpu.ops.clahe import clahe_planes

    rng = np.random.default_rng(seed("clahe_pallas"))
    # ±1 budget: the stage-C blend association contracts to FMA in XLA's
    # codegen (docs/PARITY.md)
    for shape, grid, cl in [
        ((3, 64, 64), (8, 8), 2.0),
        ((2, 40, 48), (8, 8), 2.0),
        ((2, 80, 96), (5, 6), 3.5),
        ((1, 33, 80), (3, 5), 40.0),
    ]:
        x = rng.integers(0, 256, shape, np.uint8)
        got = np.asarray(jax.jit(lambda v: clahe_planes(v, cl, grid))(x))
        want = np.stack([ref.clahe(p, cl, grid) for p in x])
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, (shape, grid)


def test_clahe_with_hist_kernel(monkeypatch):
    """CLAHE stage A through the kernel (interpreted) equals the XLA form."""
    from imageenhancement_mp_tpu.ops.clahe import clahe_planes

    rng = np.random.default_rng(seed("clahe_kernel"))
    x = jnp.asarray(rng.integers(0, 256, (2, 64, 96), np.uint8))
    want = np.asarray(clahe_planes(x, 2.0, (4, 6)))
    real = khist.hist256_gpu
    monkeypatch.setattr(khist, "hist256_gpu", lambda p: real(p, interpret=True))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert np.array_equal(np.asarray(clahe_planes(x, 2.0, (4, 6))), want)


def test_equalize_constant_and_shapes():
    from imageenhancement_mp_tpu.ops.histogram import equalize_hist_planes

    rng = np.random.default_rng(seed("eq_fused"))
    for shape in [(2, 64, 80), (1, 100, 131), (3, 33, 41), (1, 8, 8)]:
        x = rng.integers(0, 256, shape, np.uint8)
        got = np.asarray(jax.jit(equalize_hist_planes)(jnp.asarray(x)))
        want = np.stack([ref.equalize_hist(p) for p in x])
        assert np.array_equal(got, want), shape
    c = np.full((1, 20, 20), 77, np.uint8)  # constant → identity LUT
    got = np.asarray(jax.jit(equalize_hist_planes)(jnp.asarray(c)))
    assert np.array_equal(got, c)
