"""Global dtype policy for the framework, and the persistent compile cache.

The reference (`/root/reference/src/color.rs:2` and every shape) computes in
f64. Accelerators run f32 at full rate and f64 far slower, so the design is
f32 throughout with scale-aware epsilons (see `rpt_tpu.intersect`). Set
``RPT_TPU_F64=1`` to enable f64 for parity debugging on CPU.
"""

from __future__ import annotations

import hashlib
import os

import jax
import jax.numpy as jnp

_F64 = os.environ.get("RPT_TPU_F64", "0") == "1"

if _F64:
    jax.config.update("jax_enable_x64", True)

#: Cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset: a fixed
#: path inside the checkout (the path is part of every cache key, so a
#: directory that moves never hits), shared by every process of the checkout.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compile_cache_dir(environ=os.environ, platforms: str = "") -> str:
    """Where the persistent compilation cache lives.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set. Otherwise
    `DEFAULT_CACHE_DIR`; runs on XLA:CPU (``platforms`` starting with
    "cpu") get a subdirectory keyed by the host CPU's feature set, because
    XLA:CPU entries embed the compiling machine's ISA and would load on a
    host that lacks it with only a warning.
    """
    explicit = environ.get("JAX_COMPILATION_CACHE_DIR")
    if explicit:
        return explicit
    if not platforms.startswith("cpu"):
        return DEFAULT_CACHE_DIR
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith("flags")), "")
    except OSError:  # pragma: no cover - non-linux
        flags = ""
    fp = hashlib.sha1((flags + jax.__version__).encode()).hexdigest()[:10]
    return os.path.join(DEFAULT_CACHE_DIR, f"cpu-{fp}")


# scene/shape changes retrigger XLA compiles that take minutes for the big
# traversal graphs; cache them across processes
if os.environ.get("RPT_TPU_NO_COMPILE_CACHE", "0") != "1":
    _platforms = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    _cache_dir = compile_cache_dir(platforms=_platforms)
    try:
        os.makedirs(_cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", _cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    except OSError:  # pragma: no cover - cache is best-effort
        pass

#: Float dtype used for all geometry/radiometry computation.
DTYPE = jnp.float64 if _F64 else jnp.float32

#: Integer dtype for indices (BVH nodes, triangle ids, material ids).
ITYPE = jnp.int32

#: "No hit" time: actual inf, as the reference's f64::INFINITY (`shape.rs:87`).
INF = float("inf")


def asf(x):
    """Convert to the global float dtype."""
    return jnp.asarray(x, dtype=DTYPE)
