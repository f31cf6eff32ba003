"""cv2.accumulate* family parity (docs/PARITY.md): accumulate/Square/
Product EXACT; accumulateWeighted = cv2's NATIVE plain-f32 law (cv2's
default IPP dispatch is ~2e-3 off cv2's own native path)."""

import numpy as np

from detseed import seed
import pytest

import jax.numpy as jnp

import imageenhancement_mp_tpu as ie
from imageenhancement_mp_tpu import ref

cv2 = pytest.importorskip("cv2")
cv2.setNumThreads(1)


def _setup(rng, ch=None):
    shape = (int(rng.integers(10, 50)), int(rng.integers(10, 50)))
    if ch:
        shape = shape + (ch,)
    acc = ((rng.random(shape) - 0.2) * 500).astype(np.float32)
    src = rng.integers(0, 256, shape).astype(np.uint8)
    mask = (rng.random(shape[:2]) > 0.4).astype(np.uint8) * 255
    return acc, src, mask


@pytest.mark.parametrize("ch", [None, 3])
def test_exact_rows_vs_cv2(ch):
    rng = np.random.default_rng(seed("accum", ch or 0))
    for t in range(6):
        acc, src, mask = _setup(rng, ch)
        for m in (None, mask):
            a = acc.copy(); cv2.accumulate(src, a, m)
            assert np.array_equal(ref.accumulate(src, acc, m), a)
            assert np.array_equal(
                np.asarray(ie.accumulate(jnp.asarray(src), jnp.asarray(acc),
                                         None if m is None else jnp.asarray(m))), a)
            a = acc.copy(); cv2.accumulateSquare(src, a, m)
            assert np.array_equal(ref.accumulate_square(src, acc, m), a)
            assert np.array_equal(
                np.asarray(ie.accumulate_square(jnp.asarray(src), jnp.asarray(acc),
                                                None if m is None else jnp.asarray(m))), a)
            src2 = rng.integers(0, 256, src.shape).astype(np.uint8)
            a = acc.copy(); cv2.accumulateProduct(src, src2, a, m)
            assert np.array_equal(ref.accumulate_product(src, src2, acc, m), a)
            assert np.array_equal(
                np.asarray(ie.accumulate_product(jnp.asarray(src), jnp.asarray(src2),
                                                 jnp.asarray(acc),
                                                 None if m is None else jnp.asarray(m))), a)


def test_weighted_native_law():
    rng = np.random.default_rng(seed("accw"))
    cv2.setUseOptimized(False)
    try:
        bad = tot = 0
        for t in range(8):
            acc, src, mask = _setup(rng)
            al = float(rng.uniform(0.001, 0.999))
            a = acc.copy(); cv2.accumulateWeighted(src, a, al)
            got = ref.accumulate_weighted(src, acc, al)
            dev = np.asarray(ie.accumulate_weighted(jnp.asarray(src),
                                                    jnp.asarray(acc), al))
            # XLA:CPU codegen FMA-contracts the product+add chain (the
            # documented backend nuance, docs/PARITY.md) — 1-ulp there;
            ulp = np.spacing(np.abs(got))
            assert np.abs(dev.astype(np.float64)
                          - got.astype(np.float64)).max() <= ulp.max()
            tot += a.size
            bad += int((got != a).sum())
        # cv2's native build may FMA-contract; tolerate its tiny wobble.
        # (If this cv2 has LATCHED its IPP dispatch — see the memory-note
        # quirk — the deviation is larger; the law is still the contract.)
        assert bad / tot < 2e-3, bad / tot
    finally:
        cv2.setUseOptimized(True)


def test_rejects():
    with pytest.raises(TypeError):
        ie.accumulate(jnp.zeros((4, 4), jnp.uint8), jnp.zeros((4, 4), jnp.uint8))
