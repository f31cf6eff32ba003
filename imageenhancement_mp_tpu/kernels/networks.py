"""Branch-free selection networks behind the median ops (ops/median.py).

All functions take a list of equal-shaped arrays (the k² window taps) and
return the elementwise median using only jnp.minimum/maximum — fully
vectorized, no data-dependent control flow (SURVEY.md §2 #9).

* median of 9 — Paeth's optimal 19-comparator network (Graphics Gems).
* median of 25 — forgetful selection (the GPU-median-filter construction):
  start with a 14-element window (⌈25/2⌉+2); repeatedly discard the
  window's min and max and insert the next input.  Any 14-subset's min has
  at most 11 of the original 25 below it (the 11 elements outside the
  subset), so it can never be the 13th-smallest; inductively the true
  median always survives, and after 11 rounds it is the middle of the
  final 3.  ~165 compare-exchanges with ≤14 live arrays, vs ~300 CEs and
  25 live arrays for odd-even transposition — the live-set reduction
  keeps the fused program's register/cache footprint small.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["median9", "median25", "median_odd_even"]


def _cex(w, i, j):
    lo = jnp.minimum(w[i], w[j])
    hi = jnp.maximum(w[i], w[j])
    w[i], w[j] = lo, hi


def median9(w):
    """Median of 9 arrays — Paeth's 19-comparator network."""
    w = list(w)
    for i, j in [
        (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
        (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
        (4, 2), (6, 4), (4, 2),
    ]:
        _cex(w, i, j)
    return w[4]


def median25(vals):
    """Median of 25 arrays — forgetful selection (≤14 live arrays)."""
    assert len(vals) == 25
    window = list(vals[:14])
    for k in range(14, 25):
        # push min to window[0]
        for i in range(1, len(window)):
            _cex(window, 0, i)
        # push max of the rest to window[1]
        for i in range(2, len(window)):
            lo = jnp.minimum(window[1], window[i])
            hi = jnp.maximum(window[1], window[i])
            window[i], window[1] = lo, hi
        window = window[2:] + [vals[k]]
    # final window of 3: the median is its middle element
    _cex(window, 0, 1)
    _cex(window, 1, 2)
    _cex(window, 0, 1)
    return window[1]


def median_odd_even(vals):
    """Generic odd-even transposition median (any odd count; O(n²) CEs)."""
    w = list(vals)
    n = len(w)
    for r in range(n):
        for i in range(r % 2, n - 1, 2):
            _cex(w, i, i + 1)
    return w[n // 2]
