"""Regression tests for the driver entry wrapper (__graft_entry__.py).

The wrapper, not the dryrun body, is where a multi-device dry run can
hang: if the parent probed ``jax.devices()`` and the default backend's
start-up hung, the whole run would die at its caller's timeout. These
tests pin the two contracts that prevent it:

1. the parent process performs NO jax backend operation before forking —
   the subprocess path must work even if every backend probe would hang;
2. a hung subprocess is killed at the deadline and surfaces a diagnosable
   heartbeat tail instead of outliving its caller's budget.
"""

import io
import os
import subprocess
import sys

import pytest

import __graft_entry__ as g


class _FakeProc:
    """Stands in for subprocess.Popen: scripted output + exit behavior."""

    def __init__(self, out: str, rc: int = 0, hang: bool = False):
        self.stdout = io.StringIO(out)
        self.returncode = None
        self._rc = rc
        self._hang = hang
        self.killed = False

    def poll(self):
        if self._hang and not self.killed:
            return None
        self.returncode = -9 if self.killed else self._rc
        return self.returncode

    def kill(self):
        self.killed = True


def test_parent_makes_no_jax_backend_call(monkeypatch):
    """The subprocess path must never touch a jax backend in the parent.

    Every backend-initializing jax API is replaced with a tripwire; any
    call could hang on a stuck backend and fails the test.
    """
    import jax

    def _tripwire(*a, **k):  # pragma: no cover - failure path
        raise AssertionError(
            "parent process touched a jax backend API (this hangs when "
            "the default backend's start-up hangs)"
        )

    for api in ("devices", "local_devices", "device_count", "default_backend", "device_put"):
        monkeypatch.setattr(jax, api, _tripwire)
    monkeypatch.delenv("RPT_TPU_DRYRUN_INPROC", raising=False)

    captured = {}

    def fake_popen(cmd, **kw):
        captured["cmd"] = cmd
        captured["env"] = kw["env"]
        return _FakeProc("dryrun phase: provision\nDRYRUN_MULTICHIP_OK\n")

    g._dryrun_subprocess(8, popen=fake_popen, timeout_s=5.0)
    assert captured["cmd"][0] == sys.executable
    assert "--xla_force_host_platform_device_count=8" in captured["env"]["XLA_FLAGS"]
    assert captured["env"]["JAX_PLATFORMS"] == "cpu"
    # the child must not inherit the in-process shortcut
    assert "RPT_TPU_DRYRUN_INPROC" not in captured["env"]


def test_dryrun_dispatch_uses_subprocess_without_inproc_flag(monkeypatch):
    """dryrun_multichip without the conftest flag must go straight to the
    subprocess path (never _dryrun_body in the parent)."""
    monkeypatch.delenv("RPT_TPU_DRYRUN_INPROC", raising=False)
    calls = []
    monkeypatch.setattr(g, "_dryrun_subprocess", lambda n, **kw: calls.append(n))
    monkeypatch.setattr(
        g, "_dryrun_body", lambda n: (_ for _ in ()).throw(AssertionError("in-parent body"))
    )
    g.dryrun_multichip(8)
    assert calls == [8]


def test_hung_subprocess_killed_at_deadline():
    """A subprocess that never exits is killed and reported fast."""
    proc = _FakeProc("dryrun phase: surface render_sharded (+3.0s)\n", hang=True)
    with pytest.raises(RuntimeError, match="deadline"):
        g._dryrun_subprocess(8, popen=lambda *a, **k: proc, timeout_s=1.0)
    assert proc.killed
    # the error carries the heartbeat tail for diagnosis


def test_failed_subprocess_reports_tail():
    proc = _FakeProc("dryrun phase: provision\nboom\n", rc=1)
    with pytest.raises(RuntimeError, match="rc=1"):
        g._dryrun_subprocess(8, popen=lambda *a, **k: proc, timeout_s=5.0)


def test_missing_ok_marker_is_failure():
    proc = _FakeProc("dryrun phase: provision\n", rc=0)
    with pytest.raises(RuntimeError, match="failed"):
        g._dryrun_subprocess(8, popen=lambda *a, **k: proc, timeout_s=5.0)


@pytest.mark.skipif(
    os.environ.get("RPT_TPU_SLOW_TESTS", "0") != "1",
    reason="full subprocess dryrun is slow; run with RPT_TPU_SLOW_TESTS=1",
)
def test_real_subprocess_dryrun():  # pragma: no cover - opt-in
    g._dryrun_subprocess(8)


def test_bench_watchdog_trips_fast_on_hang(capsys):
    """Simulated hang: a hanging first device op must exit rc=2 with a
    machine-readable JSON line, well under an outer timeout."""
    import json
    import time as _time

    import bench

    t0 = _time.perf_counter()
    with pytest.raises(SystemExit) as exc:
        bench.check_backend(timeout_s=0.5, op=lambda: _time.sleep(60))
    assert exc.value.code == 2
    assert _time.perf_counter() - t0 < 10
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["error"] == "backend_unavailable"


def test_bench_watchdog_passes_healthy_backend():
    import bench

    elapsed = bench.check_backend(timeout_s=30.0, op=lambda: None)
    assert elapsed < 30.0


def test_entry_probe_raises_fast_on_hang():
    """entry() is a library hook called in its caller's process: a hung
    backend init must raise (diagnosable traceback), not exit or hang."""
    import time as _time

    t0 = _time.perf_counter()
    with pytest.raises(RuntimeError, match="backend_unavailable"):
        g._probe_backend(timeout_s=0.5, op=lambda: _time.sleep(60))
    assert _time.perf_counter() - t0 < 10


def test_entry_probe_wraps_probe_errors():
    def _boom():
        raise ValueError("device lost")

    with pytest.raises(RuntimeError, match="device lost"):
        g._probe_backend(timeout_s=5.0, op=_boom)


def test_entry_probe_passes_healthy_backend():
    g._probe_backend(timeout_s=30.0, op=lambda: None)
