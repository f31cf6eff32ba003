"""Smoke test of the main path on one GPU: every judged configuration at
its full size, checked against the NumPy oracle in ``ref/``.

Run from the repository root::

    python chip_smoke.py            # one GPU, all phases
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Phases (one line each, in order): device, flagship (hist-eq → unsharp on
8×1080p), config 5 streamed (median → CLAHE → unsharp over 4K batches),
the other configurations, the device selftest, and the histogram kernel
against its plain XLA form.  ``--multi`` runs the config-5 preset
batch-sharded and row-sharded over four cards and the psum-pooled
hist-eq, each bitwise against the same program on one card.

Any failure raises and the process exits non-zero; the last line of
standard output is one JSON object only when every phase passed.
Inputs are seeded; nothing is downloaded.

``--rehearse`` accepts a CPU backend and ``--scale N`` divides every
spatial size by N; both are for rehearsing without a card
(``JAX_PLATFORMS=cpu python chip_smoke.py --rehearse --scale 16``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import jax
import numpy as np

from imageenhancement_mp_tpu import ref
from imageenhancement_mp_tpu.profiling import gpu_name_and_power
from imageenhancement_mp_tpu.utils.compile_cache import enable_compile_cache


class SmokeFailure(RuntimeError):
    """A phase produced a wrong result."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def max_lsb(a, b) -> int:
    a = np.asarray(a).astype(np.int64)
    b = np.asarray(b).astype(np.int64)
    check(a.shape == b.shape, f"shape {a.shape} != {b.shape}")
    return int(np.abs(a - b).max())


def device_check(devices, rehearse: bool, need: int) -> dict:
    """The device record of the last line; refuses anything but a GPU
    (unless rehearsing) and fewer than ``need`` devices."""
    d = devices[0]
    if d.platform != "gpu" and not rehearse:
        raise SmokeFailure(
            f"no GPU: JAX reports platform {d.platform!r}; this smoke test "
            "only runs on a GPU")
    check(len(devices) >= need, f"needs {need} devices, JAX sees {len(devices)}")
    return {"platform": d.platform, "kind": d.device_kind, "count": need}


def result_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


def dim(n: int, scale: int) -> int:
    """``n / scale`` rounded down to a multiple of 8 (at least 8)."""
    return max(8, n // scale // 8 * 8)


def memory_line(fn, *args) -> str:
    m = jax.jit(fn).lower(*args).compile().memory_analysis()
    if m is None:
        return "memory analysis: not reported by this backend"
    return (f"memory analysis: args {m.argument_size_in_bytes} B, "
            f"output {m.output_size_in_bytes} B, temp {m.temp_size_in_bytes} B, "
            f"code {m.generated_code_size_in_bytes} B")


def say(*parts) -> None:
    print(*parts, flush=True)


def phase_flagship(rng, s):
    from imageenhancement_mp_tpu.pipeline import equalize_unsharp

    x = rng.integers(0, 256, (8, dim(1080, s), dim(1920, s)), dtype=np.uint8)
    t = time.perf_counter()
    out = np.asarray(equalize_unsharp(x, 1.0, 5, 0.0))
    secs = time.perf_counter() - t
    lsb = max(
        max_lsb(out[i], ref.unsharp_mask(ref.equalize_hist(x[i]), 1.0, 5, 0.0))
        for i in (0, 5)
    )
    check(lsb == 0, f"flagship max-LSB {lsb} (budget 0)")
    say(f"flagship equalize_unsharp {x.shape} u8: max-LSB {lsb} (budget 0), "
        f"first call {secs:.2f} s (compile included); "
        + memory_line(lambda v: equalize_unsharp(v, 1.0, 5, 0.0), x))


def phase_config5(rng, s):
    from imageenhancement_mp_tpu.models.presets import get_preset
    from imageenhancement_mp_tpu.pipeline import stream_frames

    pipe = get_preset("denoise_clahe_sharpen")
    shape = (2, dim(2160, s), dim(3840, s))
    batches = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(3)]
    t = time.perf_counter()
    outs = [np.asarray(o) for o in stream_frames(pipe, batches, depth=2)]
    secs = time.perf_counter() - t
    check(len(outs) == 3, f"stream_frames yielded {len(outs)} batches, expected 3")
    p = batches[-1][1]
    want = ref.unsharp_mask(ref.clahe(ref.median_blur(p, 5), 2.0, (8, 8)), 1.0, 5, 0.0)
    lsb = max_lsb(outs[-1][1], want)
    check(lsb <= 2, f"config 5 max-LSB {lsb} (budget 2)")
    say(f"config5 denoise_clahe_sharpen streamed 3x{shape} u8 (depth 2): "
        f"max-LSB {lsb} (budget 2), {secs:.2f} s (compile included); "
        + memory_line(pipe, batches[0]))


def phase_other_configs(rng, s):
    import imageenhancement_mp_tpu as ie
    from imageenhancement_mp_tpu.models.presets import get_preset

    img = rng.integers(0, 256, (dim(512, s), dim(512, s)), dtype=np.uint8)
    lsb = max_lsb(ie.equalize_hist(img), ref.equalize_hist(img))
    check(lsb == 0, f"equalize_hist max-LSB {lsb} (budget 0)")
    say(f"config1 equalize_hist {img.shape}: max-LSB {lsb} (budget 0)")

    batch = rng.integers(0, 256, (32, dim(1080, s), dim(1920, s), 3), dtype=np.uint8)
    out = np.asarray(get_preset("gamma_stretch")(batch))
    want = ref.contrast_stretch(ref.gamma_transform(batch[5, :, :, 1], 2.2))
    lsb = max_lsb(out[5, :, :, 1], want)
    check(lsb == 0, f"gamma_stretch max-LSB {lsb} (budget 0)")
    say(f"config2 gamma_stretch {batch.shape}: max-LSB {lsb} (budget 0, plane 5 ch 1)")
    del batch, out

    rgb = rng.integers(0, 256, (dim(2160, s), dim(3840, s), 3), dtype=np.uint8)
    out = np.asarray(ie.clahe(rgb, 2.0, (8, 8)))
    lsb = max_lsb(out[:, :, 1], ref.clahe(rgb[:, :, 1], 2.0, (8, 8)))
    check(lsb <= 1, f"clahe max-LSB {lsb} (budget 1)")
    say(f"config4 clahe {rgb.shape} clip 2.0 grid 8x8: max-LSB {lsb} (budget 1, ch 1)")


def phase_selftest():
    from imageenhancement_mp_tpu.selftest import run_selftest

    with contextlib.redirect_stderr(sys.stdout):
        ok = run_selftest()
    check(ok, "selftest: a check exceeded its budget")
    say("selftest: every check within its budget")


def phase_hist_kernel(rng, s, interpret):
    """The GPU histogram kernel, bitwise against the plain XLA form."""
    import jax.numpy as jnp

    from imageenhancement_mp_tpu.kernels.hist import hist256_gpu
    from imageenhancement_mp_tpu.ops.histogram import _hist_nibble_matmul

    frames = jnp.asarray(rng.integers(0, 256, (8, dim(1080, s), dim(1920, s)), dtype=np.uint8))
    # the CLAHE stage-A batch of 4K RGB with an 8x8 grid: 3·64 tiles
    tiles = jnp.asarray(rng.integers(
        0, 256, (3 * 64, dim(2160, s) // 8 * (dim(3840, s) // 8)), dtype=np.uint8))
    kernel = jax.jit(lambda v: hist256_gpu(v, interpret=interpret))
    plain = jax.jit(jax.vmap(_hist_nibble_matmul))
    for name, x in (("frames", frames), ("clahe tiles", tiles)):
        got = np.asarray(kernel(x))
        want = np.asarray(plain(x))
        check(np.array_equal(got, want), f"histogram kernel != nibble matmul on {name}")
        say(f"histogram kernel {name} {tuple(x.shape)}: bitwise equal to the XLA form")


def phase_multi(rng, s, n):
    """Sharded programs over ``n`` cards, each bitwise vs one card."""
    from imageenhancement_mp_tpu.models.presets import get_preset
    from imageenhancement_mp_tpu.ops.histogram import equalize_hist_global_planes
    from imageenhancement_mp_tpu.parallel.sharding import (
        device_put_sharded_batch,
        equalize_hist_global_sharded,
        make_mesh,
    )
    from imageenhancement_mp_tpu.pipeline import stream_frames

    single = get_preset("denoise_clahe_sharpen")
    for shard, shape in (("batch", (8, dim(2160, s), dim(3840, s))),
                         ("spatial", (2, dim(4320, s), dim(7680, s)))):
        mesh = make_mesh(n, axis_name="batch" if shard == "batch" else "y")
        pipe = get_preset("denoise_clahe_sharpen", mesh=mesh, shard=shard)
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        t = time.perf_counter()
        got = np.asarray(list(stream_frames(pipe, [x], mesh=mesh, shard=shard))[0])
        secs = time.perf_counter() - t
        want = np.asarray(single(jax.device_put(x, jax.devices()[0])))
        check(np.array_equal(got, want),
              f"config5 {shard}-sharded over {n} cards differs from one card "
              f"(max-LSB {max_lsb(got, want)})")
        say(f"config5 {shard}-sharded over {n} cards {shape}: bitwise equal to one card "
            f"({secs:.2f} s sharded, compile included)")

    mesh = make_mesh(n)
    x = rng.integers(0, 256, (8, dim(1080, s), dim(1920, s)), dtype=np.uint8)
    got = np.asarray(equalize_hist_global_sharded(mesh)(device_put_sharded_batch(x, mesh)))
    want = np.asarray(jax.jit(equalize_hist_global_planes)(jax.device_put(x, jax.devices()[0])))
    check(np.array_equal(got, want),
          f"equalize_hist_global_sharded over {n} cards differs from one card")
    say(f"equalize_hist_global_sharded over {n} cards {x.shape}: bitwise equal to one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the four-card sharded phase only")
    ap.add_argument("--rehearse", action="store_true",
                    help="accept a CPU backend (rehearsal only)")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every spatial size by this (rehearsal)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cache = enable_compile_cache()
    need = 4 if args.multi else 1
    device = device_check(jax.devices(), args.rehearse, need)
    card = gpu_name_and_power() if device["platform"] == "gpu" else "no GPU (rehearsal)"
    say(f"device: {device['platform']} {device['kind']} x{len(jax.devices())}; "
        f"nvidia-smi: {card}; compile cache {cache}")

    rng = np.random.default_rng(args.seed)
    s = max(1, args.scale)
    if args.multi:
        phase_multi(rng, s, need)
    else:
        phase_flagship(rng, s)
        phase_config5(rng, s)
        phase_other_configs(rng, s)
        phase_selftest()
        phase_hist_kernel(rng, s, interpret=device["platform"] != "gpu")
    if args.rehearse:
        say(json.dumps({"rehearsal": True, "device": device}))
    else:
        say(result_line(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
