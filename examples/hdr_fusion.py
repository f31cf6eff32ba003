"""End-to-end HDR pipeline demo: align → merge → tonemap, all on device.

Synthesizes a bracketed exposure stack (or loads .npy frames you pass),
aligns it with the bit-exact MTB aligner, fuses it two ways — Mertens
exposure fusion (no times needed) and Debevec radiance recovery — and
tonemaps for display.

Run: ``python examples/hdr_fusion.py [out_prefix]``
"""

import sys

import numpy as np

import imageenhancement_mp_tpu as ie


def synth_stack(h=480, w=640, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    scene = (120 + 90 * np.sin(yy / 37.0) * np.cos(xx / 53.0)
             + 60 * np.sin((xx + yy) / 91.0))
    scene = np.dstack([scene, scene * 0.9 + 10, scene * 1.1 - 8])
    times = np.array([1 / 60.0, 1 / 15.0, 1 / 4.0], np.float32)
    frames = []
    for i, t in enumerate(times):
        dy, dx = int(rng.integers(-4, 5)), int(rng.integers(-4, 5))
        shifted = np.roll(scene, (dy, dx), (0, 1))
        frames.append(np.clip(shifted * (t * 18) + rng.normal(0, 2, scene.shape),
                              0, 255).astype(np.uint8))
    return frames, times


def main(argv=None):
    from imageenhancement_mp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    prefix = (argv or sys.argv[1:] or ["/tmp/hdr"])[0]
    frames, times = synth_stack()

    aligned = ie.align_mtb(frames)                       # bit-exact MTB
    stack = np.stack(aligned)

    fused = np.asarray(ie.merge_mertens(stack))          # exposure fusion
    mertens_u8 = np.clip(np.round(fused * 255.0), 0, 255).astype(np.uint8)

    radiance = ie.merge_debevec(stack, times)            # true HDR
    debevec_u8 = np.clip(np.round(
        np.asarray(ie.tonemap(radiance, 2.2)) * 255.0), 0, 255).astype(np.uint8)
    drago_u8 = np.clip(np.round(
        np.asarray(ie.tonemap_drago(radiance, 1.0, 1.0, 0.85)) * 255.0),
        0, 255).astype(np.uint8)
    np.save(f"{prefix}_drago.npy", drago_u8)

    np.save(f"{prefix}_mertens.npy", mertens_u8)
    np.save(f"{prefix}_debevec.npy", debevec_u8)
    print(f"aligned {len(frames)} frames -> {mertens_u8.shape}; "
          f"wrote {prefix}_mertens.npy and {prefix}_debevec.npy")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
