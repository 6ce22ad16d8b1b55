"""chip_smoke.py and bench.py off the card: both refuse to run without a
GPU, and their device-agnostic helpers run CPU-vs-CPU at small size."""

import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_on_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, script)],
                       capture_output=True, text=True, env=env,
                       timeout=300, cwd=REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not any(line.startswith("{") for line in r.stdout.splitlines())


def test_parity_helpers_cpu_vs_cpu():
    import chip_smoke
    cpu = jax.devices("cpu")[0]
    results = chip_smoke.run_parity(cpu, cpu, h=64, w=96)
    names = [r[0] for r in results]
    assert names == list(chip_smoke.SCORE_CASES) + [
        "scene_sweeps.depth", "scene_sweeps.cost"]
    for name, mx, frac, _limit, ok, _secs in results:
        assert ok and mx == 0.0 and frac == 0.0, name


def test_ba_check_cpu_vs_cpu():
    import chip_smoke
    cpu = jax.devices("cpu")[0]
    c_a, c_b, rel = chip_smoke.run_ba_check(cpu, cpu, n_cams=30,
                                            n_pts=2000)
    assert c_a == c_b and rel == 0.0 and c_a > 0


def test_bench_run_tiny():
    """bench.run's lower -> compile -> call path at a tiny size: the line
    names the device and carries no baseline ratio."""
    import bench
    out = bench.run(4, 48, 64, 3, "auto", rounds=2)
    json.dumps(out)
    assert out["platform"] == "cpu" and out["device_count"] >= 1
    assert out["value"] > 0 and "vs_baseline" not in out
    assert 0.0 <= out["acc_2pct"] <= 1.0
    assert len(out["round_s_all"]) == 2
