"""Importing the library must never initialize a jax backend.

A caller must be able to choose the platform (``jax_platforms=cpu``, a
device count, a memory fraction) after importing, and a process whose
default backend is slow, busy or broken must still import cleanly. Any
module-level device value (e.g. ``jnp.int32(...)``) initializes the
default backend at import and breaks both — ``tiled.KEY_MAX`` once did.
This test pins the invariant the hard way: import every rpt_tpu module
in a clean subprocess and assert the backend registry is still empty.
"""

import subprocess
import sys

_PROBE = r"""
import pkgutil, sys

import rpt_tpu

# import every submodule, not just what __init__ pulls in
for m in pkgutil.walk_packages(rpt_tpu.__path__, prefix="rpt_tpu."):
    __import__(m.name)

import bench  # entry points: same invariant (watchdog must run first)
import bench_extra
import chip_smoke
import __graft_entry__  # noqa: F401

from jax._src import xla_bridge

sys.exit(3 if xla_bridge._backends else 0)
"""


def test_import_initializes_no_backend():
    # NB: deliberately NOT inheriting the conftest's cpu forcing — the
    # invariant must hold with the environment's default platform.
    import os

    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "RPT_TPU_DRYRUN_INPROC")
    }
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env,
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert proc.returncode == 0, (
        f"rc={proc.returncode}: importing rpt_tpu/bench initialized a jax "
        f"backend (or crashed)\n--- stdout ---\n{proc.stdout[-2000:]}\n"
        f"--- stderr ---\n{proc.stderr[-2000:]}"
    )
