"""chip_smoke.py's contract pieces that need no card: it refuses a CPU,
its sizes and its last line."""

import json
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


class _Dev:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


def test_device_check_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.device_check(jax.devices(), rehearse=False, need=1)


def test_device_check_counts_and_rehearsal():
    gpu = [_Dev("gpu", "NVIDIA H100 80GB HBM3")] * 4
    assert chip_smoke.device_check(gpu, False, 1) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    assert chip_smoke.device_check(gpu, False, 4)["count"] == 4
    with pytest.raises(chip_smoke.SmokeFailure, match="needs 4 devices"):
        chip_smoke.device_check(gpu[:1], False, 4)
    assert chip_smoke.device_check(jax.devices(), True, 1)["platform"] == "cpu"


def test_result_line_format():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = chip_smoke.result_line(dev)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": dev}
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')


def test_dim_rounds_to_tile_multiples():
    assert chip_smoke.dim(1080, 1) == 1080 and chip_smoke.dim(4320, 1) == 4320
    assert chip_smoke.dim(4320, 16) == 264 and chip_smoke.dim(100, 64) == 8


def test_script_exits_nonzero_on_cpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr
