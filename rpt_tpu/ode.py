"""Particle systems and RK4 integration.

Parity: `/root/reference/src/ode/*`. ``ParticleState`` is a pytree of
(n, ) component arrays (positions + velocities as `Vec3`); systems define
``time_derivative``; ``rk4_integrate`` runs classic fixed-step RK4 with a
remainder step (particle_system.rs:10-25) — as a ``lax.scan`` on device
(the reference loops on the host).

Force models are vectorized: the reference's O(n^2) Python-style pair loops
(particle_system.rs:46-63, 72-129) become dense (n, n) pair tensors — tiny
n makes this trivially fast as fused elementwise device code.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .dtypes import DTYPE
from .vec import Vec3, where


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ParticleState:
    """Positions + velocities (particle_state.rs:5-10)."""

    pos: Vec3
    vel: Vec3

    @staticmethod
    def of(pos, vel) -> "ParticleState":
        return ParticleState(Vec3.from_array(np.asarray(pos)), Vec3.from_array(np.asarray(vel)))

    def __add__(self, other: "ParticleState") -> "ParticleState":
        return ParticleState(self.pos + other.pos, self.vel + other.vel)

    def __mul__(self, s) -> "ParticleState":
        return ParticleState(self.pos * s, self.vel * s)

    __rmul__ = __mul__

    def __truediv__(self, s) -> "ParticleState":
        return ParticleState(self.pos * (1.0 / s), self.vel * (1.0 / s))


class ParticleSystem:
    """Base: subclasses implement `time_derivative(state) -> ParticleState`
    (particle_system.rs:5-8)."""

    def time_derivative(self, state: ParticleState) -> ParticleState:
        raise NotImplementedError

    def rk4_integrate(self, state: ParticleState, time: float, step: float) -> ParticleState:
        """Classic RK4 with fixed step + remainder (particle_system.rs:10-25)."""
        n_steps = int(np.floor(time / step)) if time > step else 0
        remainder = time - n_steps * step

        def one(state, h):
            k1 = self.time_derivative(state)
            k2 = self.time_derivative(state + k1 * (h / 2.0))
            k3 = self.time_derivative(state + k2 * (h / 2.0))
            k4 = self.time_derivative(state + k3 * h)
            return state + (k1 + k2 * 2.0 + k3 * 2.0 + k4) * (h / 6.0)

        if n_steps > 0:
            state, _ = jax.lax.scan(lambda s, _: (one(s, step), None), state, None, length=n_steps)
        return one(state, remainder)


class SimpleCircleSystem(ParticleSystem):
    """d(pos)/dt = (-y, x, 0) (particle_system.rs:27-40)."""

    def time_derivative(self, state: ParticleState) -> ParticleState:
        p = state.pos
        return ParticleState(Vec3(-p.y, p.x, jnp.zeros_like(p.z)), Vec3.zeros(p.shape))


def _pairwise(pos: Vec3):
    """(n, n) pair displacement d_ij = pos_i - pos_j and distance."""
    dx = pos.x[:, None] - pos.x[None, :]
    dy = pos.y[:, None] - pos.y[None, :]
    dz = pos.z[:, None] - pos.z[None, :]
    d = Vec3(dx, dy, dz)
    dist = jnp.sqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-30))
    return d, dist


class SolidGravitySystem(ParticleSystem):
    """Pairwise r^-2 attraction with r^-5 core repulsion
    (particle_system.rs:43-63)."""

    def time_derivative(self, state: ParticleState) -> ParticleState:
        d, dist = _pairwise(state.pos)
        n = state.pos.x.shape[0]
        eye = jnp.eye(n, dtype=bool)
        # force on j from i (reference: acc[j] += dir*(r^-2 - 1e-4 r^-5))
        mag = jnp.where(eye, 0.0, dist**-2 - 1e-4 * dist**-5)
        unit = d / dist
        acc = Vec3(
            -jnp.sum(unit.x * mag, axis=1),
            -jnp.sum(unit.y * mag, axis=1),
            -jnp.sum(unit.z * mag, axis=1),
        )
        return ParticleState(state.vel, acc)


class MarblesSystem(ParticleSystem):
    """Marbles in a monomial-surface glass over a table
    (particle_system.rs:66-129): pair spring+damping contacts, glass
    contact via `closest_point`, table plane, air resistance."""

    def __init__(self, radius: float):
        self.radius = radius

    def time_derivative(self, state: ParticleState) -> ParticleState:
        pos, vel = state.pos, state.vel
        n = pos.x.shape[0]
        radius = self.radius
        acc = Vec3(jnp.zeros(n, DTYPE), jnp.full(n, -1.0, DTYPE), jnp.zeros(n, DTYPE))

        # marble-marble springs (particle_system.rs:74-85)
        d, dist = _pairwise(pos)
        eye = jnp.eye(n, dtype=bool)
        touching = (~eye) & (dist < 2.0 * radius)
        mag = jnp.where(touching, 5.0 * (2.0 * radius - dist) / radius, 0.0)
        unit = d / dist
        # reference: force = -dir * mag applied to acc[j] (+) and acc[i] (-)
        # where dir points i->j... net per-particle sum:
        acc = acc + Vec3(
            jnp.sum(unit.x * mag, axis=1),
            jnp.sum(unit.y * mag, axis=1),
            jnp.sum(unit.z * mag, axis=1),
        )
        # contact damping: -0.5 * vel per touching pair (both sides)
        n_touch = jnp.sum(touching, axis=1).astype(DTYPE)
        acc = acc + vel * (-0.5 * n_touch)

        # glass surface contact (particle_system.rs:87-104)
        closest = monomial_closest_point(2.0, pos)
        cvec = pos - closest
        clen = cvec.length()
        normal = cvec / jnp.maximum(clen, 1e-20)
        ratio = (radius - clen) / radius
        nvel = vel.dot(normal)
        damp_zone = (ratio > -0.1) & (ratio < 0.0)
        push_zone = ratio >= 0.0
        acc = acc + where(damp_zone, normal * (-30.0 * nvel**3), Vec3.zeros(n))
        acc = acc + where(push_zone, normal * (100.0 * ratio), Vec3.zeros(n))

        # table plane (particle_system.rs:106-118)
        t_ratio = ((radius - 0.06) - pos.y) / radius
        t_nvel = vel.y
        off_glass = pos.length() > 0.1
        t_damp = off_glass & (t_ratio > -0.1) & (t_ratio < 0.0)
        t_push = off_glass & (t_ratio >= 0.0)
        up = Vec3(jnp.zeros(n, DTYPE), jnp.ones(n, DTYPE), jnp.zeros(n, DTYPE))
        acc = acc + where(t_damp, up * (-20.0 * t_nvel), Vec3.zeros(n))
        acc = acc + where(t_push, up * (300000.0 * t_ratio), Vec3.zeros(n))

        # air resistance (particle_system.rs:119-122)
        acc = acc + vel * (-1.0 / 5.0)
        return ParticleState(vel, acc)


def monomial_closest_point(height: float, point: Vec3, samples: int = 201) -> Vec3:
    """Closest point on y = height*(x^2+z^2)^2 via the reference's 2D grid
    search (monomial_surface.rs:128-151; 201 samples = `closest_point`,
    20001 = `closest_point_precise`), vectorized over points."""
    length = point.length()
    px = jnp.hypot(point.x, point.z)
    py = point.y
    xs = jnp.linspace(-1.0, 1.0, samples, dtype=DTYPE)
    ys = height * xs**4
    d2 = (px[:, None] - xs[None, :]) ** 2 + (py[:, None] - ys[None, :]) ** 2
    best = jnp.argmin(d2, axis=1)
    xf = xs[best]
    # back to 3D: scale the (x, z) unit direction by xf
    inv = 1.0 / jnp.maximum(jnp.hypot(point.x, point.z), 1e-30)
    xz_x = xf * point.x * inv
    xz_z = xf * point.z * inv
    out = Vec3(xz_x, height * (xz_x**2 + xz_z**2) ** 2, xz_z)
    # degenerate near-origin case (monomial_surface.rs:129-132)
    return where(length < 1e-12, point, out)


def monomial_closest_point_precise(height: float, point: Vec3) -> Vec3:
    """20001-sample variant (monomial_surface.rs:154-177)."""
    return monomial_closest_point(height, point, samples=20001)
