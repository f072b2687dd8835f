"""Counter-based RNG and sampling routines.

The reference threads a per-thread ``StdRng`` seeded from entropy through
every routine (`renderer.rs:163`, nondeterministic). The wavefront design
replaces this with threefry counter keys: every ray carries a key; bounces
and purposes derive subkeys by ``fold_in``. Renders are bit-reproducible
given a seed — strictly stronger than the reference.

Each sampler reproduces the *distribution* used by the reference
(`material.rs:173-219`, `camera.rs:74`, `photon.rs:736-743`), vectorized
over ray batches.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .dtypes import DTYPE
from .vec import Vec3, from_local

TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
INV_4PI = 1.0 / (4.0 * math.pi)


def keys_for(key: jax.Array, n: int) -> jax.Array:
    """Derive n per-ray keys from a base key: shape (n, 2) uint32."""
    return jax.random.split(key, n)


def fold(keys: jax.Array, data: int) -> jax.Array:
    """Fold a static tag into a batch of keys (purpose separation)."""
    return jax.vmap(lambda k: jax.random.fold_in(k, data))(keys)


def uniform(keys: jax.Array, lo=0.0, hi=1.0) -> jax.Array:
    """One uniform float per key, in [lo, hi)."""
    u = jax.vmap(lambda k: jax.random.uniform(k, dtype=DTYPE))(keys)
    return lo + (hi - lo) * u


def uniform2(keys: jax.Array):
    """Two independent uniforms per key."""
    u = jax.vmap(lambda k: jax.random.uniform(k, (2,), dtype=DTYPE))(keys)
    return u[:, 0], u[:, 1]


def uniform3(keys: jax.Array):
    u = jax.vmap(lambda k: jax.random.uniform(k, (3,), dtype=DTYPE))(keys)
    return u[:, 0], u[:, 1], u[:, 2]


def unit_disc(r1, r2):
    """Uniform point on the unit disc (rand_distr::UnitDisc, `camera.rs:74`)."""
    r = jnp.sqrt(r1)
    phi = TWO_PI * r2
    return r * jnp.cos(phi), r * jnp.sin(phi)


def unit_circle(r1):
    """Uniform point on the unit circle (rand_distr::UnitCircle,
    `monomial_surface.rs:110`)."""
    phi = TWO_PI * r1
    return jnp.cos(phi), jnp.sin(phi)


def cosine_hemisphere(r1, r2, n: Vec3) -> tuple[Vec3, jax.Array]:
    """Cosine-weighted hemisphere around ``n``; returns (dir, pdf).

    Distribution of `material.rs:173-197`: phi = 2 pi r1,
    theta = acos(sqrt(r2)), pdf = cos(theta)/pi, local y-up frame
    rotated onto the normal.
    """
    phi = TWO_PI * r1
    cos_t = jnp.sqrt(r2)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - r2))
    local = Vec3(sin_t * jnp.cos(phi), cos_t, sin_t * jnp.sin(phi))
    return from_local(local, n).normalize(), cos_t * INV_PI


def phong_lobe(r1, r2, shininess, axis: Vec3) -> tuple[Vec3, jax.Array]:
    """cos^n lobe around ``axis``; returns (dir, pdf).

    Distribution of `material.rs:199-219`: theta = acos(r2^(1/(s+1))),
    pdf = (s+1)/(2 pi) cos^s(theta).
    """
    phi = TWO_PI * r1
    cos_t = r2 ** (1.0 / (shininess + 1.0))
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    local = Vec3(sin_t * jnp.cos(phi), cos_t, sin_t * jnp.sin(phi))
    pdf = (shininess + 1.0) / TWO_PI * cos_t**shininess
    return from_local(local, axis).normalize(), pdf


def uniform_hemisphere(r1, r2, n: Vec3) -> tuple[Vec3, jax.Array]:
    """Uniform hemisphere around ``n``; pdf = 1/(2 pi).

    Distribution of the photon-emission sampler (`photon.rs:736-743`):
    cos(theta) = 1 - r2 is uniform, so directions are uniform on the
    hemisphere.
    """
    phi = TWO_PI * r1
    cos_t = 1.0 - r2
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    local = Vec3(sin_t * jnp.cos(phi), cos_t, sin_t * jnp.sin(phi))
    return from_local(local, n).normalize(), jnp.full_like(r1, 0.5 * INV_PI)


def uniform_sphere(r1, r2) -> Vec3:
    """Uniform direction on the unit sphere.

    Replaces the reference's normalized-cube sampler (`medium.rs:87-94`),
    which is *not* uniform despite dividing by the 1/(4 pi) pdf — we use the
    exact uniform-sphere distribution matching the claimed pdf (intent
    parity; the cube-corner bias is a known reference bug).
    """
    z = 1.0 - 2.0 * r1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = TWO_PI * r2
    return Vec3(r * jnp.cos(phi), z, r * jnp.sin(phi))
