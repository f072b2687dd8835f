"""Where the persistent compilation cache lives (`rpt_tpu.dtypes`)."""

import os
import subprocess
import sys

import pytest

from rpt_tpu import dtypes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins_on_every_platform():
    for platforms in ("", "cpu", "cuda"):
        env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}
        assert dtypes.compile_cache_dir(env, platforms) == "/somewhere/else"


def test_default_is_a_fixed_dir_inside_the_checkout():
    d = dtypes.compile_cache_dir({}, "cuda")
    assert d == dtypes.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert dtypes.compile_cache_dir({}, "") == d


def test_cpu_runs_get_an_isa_keyed_subdir():
    d = dtypes.compile_cache_dir({}, "cpu")
    assert os.path.dirname(d) == dtypes.DEFAULT_CACHE_DIR
    assert os.path.basename(d).startswith("cpu-")
    assert dtypes.compile_cache_dir({}, "cpu") == d  # stable across calls


_PROBE = "import jax, rpt_tpu; print(jax.config.jax_compilation_cache_dir)"


@pytest.mark.parametrize("explicit", [True, False])
def test_import_configures_jax(tmp_path, explicit):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("RPT_TPU_NO_COMPILE_CACHE", None)
    if explicit:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout.strip().splitlines()[-1]
    if explicit:
        assert out == str(tmp_path / "cache")
    else:
        assert out == dtypes.compile_cache_dir({}, "cpu")
    assert os.path.isdir(out)
