"""End-to-end streaming demo: native loader → device pipeline → native writer.

Generates a few synthetic PGM frames, then streams them through the judged
config-5 pipeline (median → CLAHE → unsharp) with:

  * disk IO prefetch on native C++ worker threads (io.FrameLoader),
  * H2D-transfer/compute overlap (pipeline.stream_frames),
  * encode + write-behind on native C++ worker threads (io.FrameWriter).

Run: ``python examples/enhance_stream.py [--frames N] [--size HxW] [--outdir D]``
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo checkout


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", default="1080x1920")
    ap.add_argument("--batch", type=int, default=2, help="frames per device batch")
    ap.add_argument("--outdir", default=None, help="write enhanced frames here (PGM)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run the pipeline sharded over an N-device mesh "
                    "(batch DP or --shard spatial).  On a single-device host, "
                    "test with JAX_PLATFORMS=cpu XLA_FLAGS="
                    "--xla_force_host_platform_device_count=8")
    ap.add_argument("--shard", choices=("batch", "spatial"), default="batch")
    args = ap.parse_args()
    h, w = (int(v) for v in args.size.split("x"))

    from imageenhancement_mp_tpu.io import FrameLoader, FrameWriter
    from imageenhancement_mp_tpu.models.presets import get_preset
    from imageenhancement_mp_tpu.pipeline import stream_frames
    from imageenhancement_mp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    # synthesize frames on disk
    tmp = Path(tempfile.mkdtemp(prefix="ie_demo_"))
    rng = np.random.default_rng(0)
    paths = []
    for i in range(args.frames):
        f = tmp / f"frame{i:04d}.pgm"
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        with open(f, "wb") as fh:
            fh.write(b"P5\n%d %d\n255\n" % (w, h))
            fh.write(img.tobytes())
        paths.append(f)
    print(f"wrote {len(paths)} {h}x{w} frames to {tmp}")

    loader = FrameLoader(paths, threads=4)
    print(f"loader backend: {'native C++' if loader.native else 'python fallback'}")

    def batches():
        buf = []
        for frame in loader:
            buf.append(frame)
            if len(buf) == args.batch:
                yield np.stack(buf)
                buf.clear()
        if buf:
            yield np.stack(buf)

    import jax

    mesh = None
    if args.mesh:
        from imageenhancement_mp_tpu.parallel.sharding import make_mesh

        mesh = make_mesh(args.mesh, axis_name="batch" if args.shard == "batch"
                         else "y")
        if args.shard == "batch" and args.batch % args.mesh:
            ap.error(f"--batch {args.batch} must be divisible by --mesh {args.mesh}")
        if args.shard == "batch" and args.frames % args.batch:
            ap.error(f"--frames {args.frames} must be divisible by --batch "
                     f"{args.batch} under batch sharding (no partial batches)")
        if args.shard == "spatial" and h % args.mesh:
            ap.error(f"frame height {h} must be divisible by --mesh {args.mesh}")
        print(f"mesh: {args.mesh} devices, {args.shard}-sharded "
              f"({[d.platform for d in jax.devices()][0]})")
    pipe = get_preset("denoise_clahe_sharpen", mesh=mesh, shard=args.shard)

    # warm up the compile cache so the timing below reflects steady state
    jax.block_until_ready(pipe(np.zeros((args.batch, h, w), np.uint8)))

    t0 = time.perf_counter()
    n_px = 0
    outs = []
    for out in stream_frames(pipe, batches(), depth=2, mesh=mesh,
                             shard=args.shard):
        outs.append(out)  # keep on device; d2h transfers are deferred
        n_px += int(np.prod(out.shape))
    jax.block_until_ready(outs[-1])
    dt = time.perf_counter() - t0
    print(
        f"enhanced {args.frames} frames ({n_px/1e6:.1f} MPix) in {dt*1e3:.1f} ms "
        f"-> {n_px/dt/1e9:.2f} GPix/s end-to-end (incl. disk IO)"
    )

    if args.outdir:
        outdir = Path(args.outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        with FrameWriter(threads=4) as writer:
            print(f"writer backend: {'native C++' if writer.native else 'python fallback'}")
            k = 0
            for out in outs:  # d2h now; encode+write proceeds behind us
                for frame in np.asarray(out):
                    writer.save(outdir / f"frame{k:04d}_out.pgm", frame)
                    k += 1
        for err in writer.failures:
            print(f"write failed: {err}", file=sys.stderr)
        print(f"wrote {k - len(writer.failures)} enhanced frames to {outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
