"""Test harness: force CPU with a virtual 8-device mesh so multi-device
sharding logic is testable without accelerator hardware (SURVEY.md §4).

NB: some installed pytest plugin imports jax before this conftest runs, so
plain env vars are too late — but XLA backends initialize *lazily*, so
``jax.config`` + XLA_FLAGS set here (before first device use) still apply.
"""

import os

# Raise the stack soft limit to the hard limit: the full suite compiles
# hundreds of XLA:CPU programs in ONE process and sporadically segfaulted
# inside backend_compile (LLVM recursion on the main thread) on big
# traversal graphs late in the run — observed twice in round 4, different
# tests each time, never reproducible solo.
try:
    import resource

    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    if _soft != _hard:
        resource.setrlimit(resource.RLIMIT_STACK, (_hard, _hard))
except Exception:  # pragma: no cover - best effort
    pass

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
# Tell __graft_entry__.dryrun_multichip the CPU platform is provisioned
# in-process (outside tests it must subprocess WITHOUT probing jax).
os.environ["RPT_TPU_DRYRUN_INPROC"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

assert len(jax.devices()) >= 8, "expected 8 virtual CPU devices for sharding tests"
