"""Participating media.

Parity: `/root/reference/src/medium.rs`. The reference models heterogeneous
media as boxed closures over position; here the fields are jax-traceable
callables ``Vec3 -> array`` that get traced straight into the integrator
kernels (fusing into the shading code). Distance sampling and transmittance
follow the reference exactly — including evaluating extinction at the *ray
origin only* (medium.rs:126-130), i.e. homogeneous free-flight math even for
position-dependent fields.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import jax.numpy as jnp

from . import sampling
from .color import hex_color
from .ray import Ray
from .vec import Vec3, where


@dataclass(frozen=True)
class Medium:
    """Fields are callables over position (medium.rs:9-27); ``phase`` takes
    (wo, wi) and ``sample_ph`` takes (wo, keys) -> (wi, pdf)."""

    absorption: Callable
    scattering: Callable
    emission: Callable
    color: Callable
    phase: Callable
    sample_ph: Callable
    #: set when `phase` is a direction-independent constant (isotropic
    #: presets) — lets estimators use dense Pallas sweeps
    phase_const: float | None = None

    def extinction(self, pos: Vec3):
        """sigma_t = sigma_a + sigma_s (medium.rs:56-60)."""
        return self.absorption(pos) + self.scattering(pos)

    def transmittence(self, ray: Ray, t_max):
        """Beer-Lambert using extinction at the ray origin (medium.rs:126-130).
        (Spelling kept from the reference.)"""
        return jnp.exp(-self.extinction(ray.origin) * t_max)

    def sample_d(self, ray: Ray, keys):
        """Exponential free-flight sampling; returns (dist, pdf, cdf)
        (medium.rs:133-146)."""
        u = sampling.uniform(sampling.fold(keys, 0x5D), 0.0, 1.0)
        ext = self.extinction(ray.origin)
        dist = -jnp.log(jnp.maximum(u, 1e-38)) / ext
        transmittence = jnp.exp(-ext * dist)
        return dist, ext * transmittence, 1.0 - transmittence

    # presets -------------------------------------------------------------
    @staticmethod
    def homogeneous_isotropic(absorption: float, scattering: float) -> "Medium":
        """Uniform tan fog, isotropic phase (medium.rs:80-96).

        The reference's ``sample_ph`` normalizes a uniform cube point but
        claims pdf 1/(4 pi); we sample the exact uniform-sphere distribution
        the pdf describes (see `rpt_tpu.sampling.uniform_sphere`).
        """
        tan = hex_color(0xD2B48C)

        def sample_ph(wo: Vec3, keys):
            r1, r2 = sampling.uniform2(sampling.fold(keys, 0x9A))
            return sampling.uniform_sphere(r1, r2), jnp.full_like(r1, sampling.INV_4PI)

        return Medium(
            absorption=lambda p: jnp.full_like(p.x, absorption),
            scattering=lambda p: jnp.full_like(p.x, scattering),
            emission=lambda p: jnp.zeros_like(p.x),
            color=lambda p: tan.broadcast_to(p.shape),
            phase=lambda wo, wi: jnp.full_like(wo.x, sampling.INV_4PI),
            sample_ph=sample_ph,
            phase_const=sampling.INV_4PI,
        )

    @staticmethod
    def colored_glowing_fog(absorption: float, scattering: float) -> "Medium":
        """Emissive two-color fog (medium.rs:99-121).

        NB: the reference writes this preset's phase as ``1/4 * pi``
        (= pi/4, medium.rs:111,118) rather than 1/(4 pi) — a published
        constant of the preset, reproduced for parity.
        """
        red, blue = hex_color(0xFF0000), hex_color(0x0000FF)
        phase_const = 0.25 * math.pi  # sic, medium.rs:111

        def color(p: Vec3) -> Vec3:
            return where(p.y > 250.0, red.broadcast_to(p.shape), blue.broadcast_to(p.shape))

        def sample_ph(wo: Vec3, keys):
            r1, r2 = sampling.uniform2(sampling.fold(keys, 0x9A))
            return sampling.uniform_sphere(r1, r2), jnp.full_like(r1, phase_const)

        return Medium(
            absorption=lambda p: jnp.full_like(p.x, absorption),
            scattering=lambda p: jnp.full_like(p.x, scattering),
            emission=lambda p: jnp.full_like(p.x, 10.0),
            color=color,
            phase=lambda wo, wi: jnp.full_like(wo.x, phase_const),
            sample_ph=sample_ph,
            phase_const=phase_const,
        )

    @staticmethod
    def henyey_greenstein(absorption: float, scattering: float, g: float,
                          color=None) -> "Medium":
        """Homogeneous medium with a Henyey-Greenstein phase function.

        Extension (not in the reference): anisotropic scattering
        with asymmetry parameter g in (-1, 1).
        """
        col = color if color is not None else hex_color(0xD2B48C)

        def phase(wo: Vec3, wi: Vec3):
            # Note wo/wi both point away from the scattering point
            # (medium.rs:63-65), so cos(theta) between the transport
            # directions is -wo . wi... the HG convention used here:
            cos_t = (-wo).dot(wi)
            denom = (1.0 + g * g + 2.0 * g * cos_t) ** 1.5
            return sampling.INV_4PI * (1.0 - g * g) / jnp.maximum(denom, 1e-12)

        def sample_ph(wo: Vec3, keys):
            r1, r2 = sampling.uniform2(sampling.fold(keys, 0x9A))
            if abs(g) < 1e-6:
                return sampling.uniform_sphere(r1, r2), jnp.full_like(r1, sampling.INV_4PI)
            sq = (1.0 - g * g) / (1.0 + g - 2.0 * g * r1)
            cos_t = -(1.0 + g * g - sq * sq) / (2.0 * g)
            cos_t = jnp.clip(cos_t, -1.0, 1.0)
            sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
            phi = sampling.TWO_PI * r2
            local = Vec3(sin_t * jnp.cos(phi), cos_t, sin_t * jnp.sin(phi))
            from .vec import from_local

            wi = from_local(local, -wo).normalize()
            return wi, phase(wo, wi)

        return Medium(
            absorption=lambda p: jnp.full_like(p.x, absorption),
            scattering=lambda p: jnp.full_like(p.x, scattering),
            emission=lambda p: jnp.zeros_like(p.x),
            color=lambda p: col.broadcast_to(p.shape),
            phase=phase,
            sample_ph=sample_ph,
        )
