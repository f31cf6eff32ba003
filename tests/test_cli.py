"""Demo CLI end-to-end (SURVEY.md §3.5 script-entry equivalent)."""

import os
import subprocess
import sys

import pytest

import numpy as np

ENV = {**os.environ, "JAX_PLATFORMS": "cpu"}

from imageenhancement_mp_tpu import ref


def _run_cli(tmp_path, img, ops):
    inp = tmp_path / "in.npy"
    out = tmp_path / "out.npy"
    np.save(inp, img)
    r = subprocess.run(
        [sys.executable, "-m", "imageenhancement_mp_tpu.cli", str(inp), "-o", str(out)]
        + [a for op in ops for a in ("--op", op)],
        capture_output=True,
        text=True,
        timeout=300,
        env=ENV,
    )
    assert r.returncode == 0, r.stderr[-500:]
    return np.load(out)


def test_cli_pipeline(tmp_path, rng):
    img = rng.integers(0, 256, (48, 56), dtype=np.uint8)
    got = _run_cli(tmp_path, img, ["median:3", "unsharp:1.0"])
    want = ref.unsharp_mask(ref.median_blur(img, 3), 1.0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_cli_unknown_op(tmp_path, rng):
    inp = tmp_path / "in.npy"
    np.save(inp, rng.integers(0, 256, (8, 8), dtype=np.uint8))
    r = subprocess.run(
        [sys.executable, "-m", "imageenhancement_mp_tpu.cli", str(inp), "--op", "bogus"],
        capture_output=True,
        text=True,
        timeout=120,
        env=ENV,
    )
    assert r.returncode == 2
    assert "unknown op" in r.stderr


def test_selftest_passes_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "imageenhancement_mp_tpu.selftest", "--size", "48x53"],
        capture_output=True,
        text=True,
        timeout=300,
        env=ENV,
    )
    assert r.returncode == 0, r.stderr[-400:]
    assert "SELFTEST PASS" in r.stdout


def test_cli_batch_mode(tmp_path, rng):
    ins = []
    for i in range(3):
        p = tmp_path / f"b{i}.npy"
        np.save(p, rng.integers(0, 256, (24, 31), dtype=np.uint8))
        ins.append(str(p))
    outdir = tmp_path / "outs"
    r = subprocess.run(
        [sys.executable, "-m", "imageenhancement_mp_tpu.cli", *ins,
         "-o", str(outdir), "--op", "stretch"],
        capture_output=True, text=True, timeout=300, env=ENV,
    )
    assert r.returncode == 0, r.stderr[-400:]
    assert len(list(outdir.glob("*.npy"))) == 3


def test_cli_u16_input_clean_error(tmp_path, rng):
    # histeq rejects u16: must exit 2 with a clean message, not a traceback
    inp = tmp_path / "u16.npy"
    np.save(inp, rng.integers(0, 65536, (16, 16), dtype=np.uint16))
    r = subprocess.run(
        [sys.executable, "-m", "imageenhancement_mp_tpu.cli", str(inp)],
        capture_output=True, text=True, timeout=120, env=ENV,
    )
    assert r.returncode == 2
    assert "error:" in r.stderr and "Traceback" not in r.stderr


def test_cli_batch_color_roundtrip(tmp_path, rng):
    cv2 = pytest.importorskip("cv2")
    # red ramp written via cv2 (BGR) -> batch identity-ish op -> read back
    img = np.zeros((16, 16, 3), np.uint8)
    img[..., 2] = np.arange(16, dtype=np.uint8)[None, :] * 10  # red in BGR
    paths = []
    for i in range(2):
        p = tmp_path / f"c{i}.png"
        assert cv2.imwrite(str(p), img)
        paths.append(str(p))
    outdir = tmp_path / "o"
    r = subprocess.run(
        [sys.executable, "-m", "imageenhancement_mp_tpu.cli", *paths,
         "-o", str(outdir), "--op", "median:3"],
        capture_output=True, text=True, timeout=300, env=ENV,
    )
    assert r.returncode == 0, r.stderr[-400:]
    back = cv2.imread(str(outdir / "c0_out.png"))
    # red channel must still carry the ramp (no R/B swap)
    assert back[..., 2].max() > 100 and back[..., 0].max() == 0


def test_cli_batch_recovers_from_corrupt_frame(tmp_path, rng):
    """One corrupt file mid-batch must not abort the remaining frames."""
    def write_pgm(p, a):
        with open(p, "wb") as f:
            f.write(b"P5\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
            f.write(a.tobytes())

    ins = []
    for i in range(4):
        p = tmp_path / f"r{i}.pgm"
        if i == 1:
            p.write_bytes(b"P5\ngarbage")
        else:
            write_pgm(p, rng.integers(0, 256, (16, 20), dtype=np.uint8))
        ins.append(str(p))
    outdir = tmp_path / "outs"
    r = subprocess.run(
        [sys.executable, "-m", "imageenhancement_mp_tpu.cli", *ins,
         "-o", str(outdir), "--op", "stretch"],
        capture_output=True, text=True, timeout=300, env=ENV,
    )
    assert r.returncode == 1, (r.returncode, r.stderr[-400:])
    assert sorted(f.name for f in outdir.glob("*.pgm")) == [
        "r0_out.pgm", "r2_out.pgm", "r3_out.pgm"]
    assert "wrote 3 files" in r.stdout and "(1 failed)" in r.stdout
    assert "r1.pgm" in r.stderr


def test_cli_single_image_pillow_color_order(tmp_path, rng, monkeypatch):
    """With only Pillow available, single-image color IO must round-trip
    without an R/B swap (the loader returns RGB; _save must not assume BGR)."""
    pytest.importorskip("PIL")
    from PIL import Image

    img = np.zeros((12, 12, 3), np.uint8)
    img[..., 0] = 200  # red in RGB
    inp = tmp_path / "in.png"
    Image.fromarray(img).save(inp)
    out = tmp_path / "out.png"
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['cv2'] = None; "  # simulate Pillow-only env
         "import imageenhancement_mp_tpu.cli as c; "
         "raise SystemExit(c.main(sys.argv[1:]))",
         str(inp), "-o", str(out), "--op", "median:3"],
        capture_output=True, text=True, timeout=300, env=ENV,
    )
    assert r.returncode == 0, r.stderr[-500:]
    back = np.asarray(Image.open(out))
    assert back[..., 0].min() >= 190 and back[..., 2].max() == 0


def test_cli_batch_bgra_channel_order(tmp_path, rng):
    """Mixed-ext batch forces the cv2 fallback loader (BGRA order); the
    write-behind path must swap only B<->R — alpha stays in place."""
    cv2 = pytest.importorskip("cv2")
    rgba = rng.integers(0, 256, (20, 24, 4), dtype=np.uint8)
    png = tmp_path / "a.png"
    cv2.imwrite(str(png), rgba)  # cv2 takes BGRA; file stores RGBA faithfully
    npy = tmp_path / "b.npy"
    np.save(npy, rng.integers(0, 256, (20, 24), dtype=np.uint8))
    outdir = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-m", "imageenhancement_mp_tpu.cli", str(png), str(npy),
         "-o", str(outdir), "--op", "gamma:1.0"],  # identity op
        capture_output=True, text=True, timeout=300, env=ENV,
    )
    assert r.returncode == 0, r.stderr[-500:]
    got = cv2.imread(str(outdir / "a_out.png"), cv2.IMREAD_UNCHANGED)  # BGRA
    np.testing.assert_array_equal(got, rgba)  # all four channels in place


def test_cli_gray_then_equalize(tmp_path, rng):
    """--op gray converts RGB (npy loads as RGB) then feeds the 8-bit-only
    equalize — the reference's canonical front path."""
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    got = _run_cli(tmp_path, img, ["gray", "histeq"])
    want = ref.equalize_hist(ref.cvt_gray(img, "rgb"))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_cli_gray_rejects_gray_input(tmp_path, rng):
    inp = tmp_path / "in.npy"
    np.save(inp, rng.integers(0, 256, (8, 9), dtype=np.uint8))
    r = subprocess.run(
        [sys.executable, "-m", "imageenhancement_mp_tpu.cli", str(inp),
         "-o", str(tmp_path / "o.npy"), "--op", "gray"],
        capture_output=True, text=True, timeout=300, env=ENV,
    )
    assert r.returncode == 2
    assert "gray needs a color image" in r.stderr


def test_cli_resize(tmp_path, rng):
    """resize:H:W[:interp] — u8 bilinear is the pinned bit-exact path."""
    img = rng.integers(0, 256, (40, 50), dtype=np.uint8)
    got = _run_cli(tmp_path, img, ["resize:23:31"])
    np.testing.assert_array_equal(got, ref.resize(img, (23, 31), "linear"))
    got = _run_cli(tmp_path, img, ["resize:20:25:area"])
    np.testing.assert_array_equal(got, ref.resize(img, (20, 25), "area"))
