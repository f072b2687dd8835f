"""The parts of chip_smoke.py that need no GPU: the refusal to run
elsewhere, the shape of its result line, and its comparison rules."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_without_gpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.check_device()


def test_script_exits_nonzero_and_prints_no_result_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_result_line_shape():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line(Dev(), 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }


def _lanes(t, ids):
    return np.asarray(t, np.float32), np.asarray(ids, np.int32)


def test_closest_accepts_ties_and_shared_misses():
    inf = np.inf
    exact = _lanes([1.0, 2.0, inf] * 1000, [5, 6, -1] * 1000)
    # lane 1: another triangle at the same time (an edge shared by two)
    fast = _lanes([1.0, 2.0 * (1 + 1e-7), inf] * 1000, [5, 7, -1] * 1000)
    chip_smoke.compare_closest("ties", exact, fast)


def test_closest_rejects_a_different_triangle_at_another_time():
    exact = _lanes([1.0, 2.0] * 1000, [5, 6] * 1000)
    fast = _lanes([1.0, 2.5] + [1.0, 2.0] * 999, [5, 7] + [5, 6] * 999)
    with pytest.raises(AssertionError, match="beyond ties"):
        chip_smoke.compare_closest("wrong", exact, fast)


def test_closest_bounds_hit_miss_flips():
    n = 10_000
    t = np.ones(n, np.float32)
    ids = np.zeros(n, np.int32)
    t_fast = t.copy()
    t_fast[:2] = np.inf  # 2e-4 of lanes: silhouette flips, tolerated
    chip_smoke.compare_closest("few flips", _lanes(t, ids), _lanes(t_fast, ids))
    t_fast[:10] = np.inf  # 1e-3: too many
    with pytest.raises(AssertionError, match="flips"):
        chip_smoke.compare_closest("many flips", _lanes(t, ids), _lanes(t_fast, ids))


def test_occlusion_disagreement_only_at_the_limit():
    n = 1000
    limit = np.full(n, 10.0, np.float32)
    t_closest = np.full(n, 5.0, np.float32)
    occ = np.ones(n, bool)
    flipped = occ.copy()
    flipped[0] = False
    t_tie = t_closest.copy()
    t_tie[0] = 10.0  # the blocker sits at the limit: either answer is right
    chip_smoke.compare_occlusion("tie", occ, flipped, t_tie, limit)
    with pytest.raises(AssertionError, match="occlusion mismatches"):
        chip_smoke.compare_occlusion("wrong", occ, flipped, t_closest, limit)


def test_failed_phase_is_recorded_not_raised(capsys):
    failures = []

    def boom():
        raise ValueError("broken phase")

    assert chip_smoke.run_phase("boom", boom, failures=failures) is None
    assert failures == ["boom"]
    assert "phase boom: FAILED" in capsys.readouterr().out
