"""Template matching: ``cv2.matchTemplate`` parity on device
(contract pinned in ref/ops.py ``match_template`` — float tolerance,
worst 3e-6 relative vs cv2 incl. the SQDIFF_NORMED [0,1] clamp).

Device mapping: this is the repo's pure matrix-unit op.  The cross-correlation is
one ``lax.conv_general_dilated`` with the template as the kernel, and
the window statistics (Σ I, Σ I²) are two more convs with a ones
kernel — XLA lowers all three onto the systolic array and fuses the
elementwise normalization epilogue.  Precision HIGHEST (f32 operands,
no bf16 passes) keeps the relative error at f32-accumulation level.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["match_template_planes"]

_METHODS = ("sqdiff", "sqdiff_normed", "ccorr", "ccorr_normed",
            "ccoeff", "ccoeff_normed")


def _corr(planes_f, kernel):
    """(N, H, W) f32 ⊛ (th, tw) kernel -> (N, oh, ow) valid corr."""
    lhs = planes_f[:, None]                       # NCHW
    rhs = kernel[None, None]                      # OIHW
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST)
    return out[:, 0]


def match_template_planes(planes: jnp.ndarray, templ, method: str = "ccoeff_normed") -> jnp.ndarray:
    """``cv2.matchTemplate`` per plane on ``(N, H, W)``; the template is
    static (baked into the program as the conv kernel)."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; one of {_METHODS}")
    T = np.asarray(templ, np.float32)
    if T.ndim != 2:
        raise ValueError(f"template must be 2-D, got shape {T.shape}")
    th, tw = T.shape
    H, W = planes.shape[-2], planes.shape[-1]
    if th > H or tw > W:
        raise ValueError("template larger than image")
    I = planes.astype(jnp.float32)
    ccorr = _corr(I, jnp.asarray(T))
    n = float(th * tw)
    sT = float(T.astype(np.float64).sum())
    sT2 = float((T.astype(np.float64) ** 2).sum())
    if method == "ccorr":
        return ccorr
    ones = jnp.ones((th, tw), jnp.float32)
    sI = _corr(I, ones)
    sI2 = _corr(I * I, ones)
    if method == "sqdiff":
        return jnp.float32(sT2) - 2 * ccorr + sI2
    if method == "sqdiff_normed":
        den = jnp.sqrt(jnp.float32(sT2) * sI2)
        r = jnp.where(den > 0, (jnp.float32(sT2) - 2 * ccorr + sI2)
                      / jnp.maximum(den, jnp.float32(1e-30)), jnp.float32(1))
        return jnp.clip(r, 0.0, 1.0)              # cv2's [0,1] clamp
    if method == "ccorr_normed":
        den = jnp.sqrt(jnp.float32(sT2) * sI2)
        return jnp.where(den > 0,
                         ccorr / jnp.maximum(den, jnp.float32(1e-30)),
                         jnp.float32(1))
    num = ccorr - sI * jnp.float32(sT / n)
    if method == "ccoeff":
        return num
    varT = jnp.float32(max(sT2 - sT * sT / n, 0.0))
    varI = jnp.maximum(sI2 - sI * sI * jnp.float32(1.0 / n), 0.0)
    den = jnp.sqrt(varT * varI)
    return jnp.where(den > 0, num / jnp.maximum(den, jnp.float32(1e-30)),
                     jnp.float32(0))
