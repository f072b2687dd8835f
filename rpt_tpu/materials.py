"""Materials: the reference's 4-way BSDF enum, compiled to a table + masks.

Parity: `/root/reference/src/material.rs:8-289`. The reference dispatches a
Rust enum per ray; the wavefront design stores one row per distinct
material in a small table, tags every hit with a material id, and evaluates
``sample_f``/``bsdf`` branchlessly across the wavefront — all four lobes are
computed for every lane and selected by the kind mask (cheap: the lobes are a
handful of transcendentals each, and this avoids gather/scatter
re-sorting).

Behavioral quirks reproduced deliberately (they shape the reference images):

* ``bsdf`` returns 0 unless BOTH ``wi`` and ``wo`` are above the surface
  (material.rs:267-273) — so refracted directions through ``Transmissive``
  carry no throughput; glass transmits only via its Schlick reflection lobe.
* ``Mirror``/``Transmissive`` ``bsdf`` = (1,1,1) for any above-surface pair
  (material.rs:286-287), so NEE deposits full unscaled light on them.
* ``is_mirror`` is true for Mirror AND Transmissive (material.rs:135-141).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from . import sampling
from .dtypes import DTYPE
from .vec import Vec3, reflect, where

LAMBERTIAN = 0
PHONG = 1
MIRROR = 2
TRANSMISSIVE = 3


@dataclass(frozen=True)
class Material:
    """Host-side material description (one enum variant of material.rs:8-23)."""

    kind: int = LAMBERTIAN
    albedo: tuple = (0.5, 0.5, 0.5)  # default grey lambertian (material.rs:25-32)
    emittance: float = 0.0
    shininess: float = 0.0
    ior: float = 1.0

    # constructors mirroring material.rs:36-97 ---------------------------
    @staticmethod
    def diffuse(color: Vec3) -> "Material":
        return Material(LAMBERTIAN, _tup(color))

    @staticmethod
    def specular(color: Vec3, roughness: float) -> "Material":
        return Material(PHONG, _tup(color), shininess=roughness)

    @staticmethod
    def mirror() -> "Material":
        return Material(MIRROR, (0.0, 0.0, 0.0))

    @staticmethod
    def transmissive(ior: float) -> "Material":
        return Material(TRANSMISSIVE, (0.0, 0.0, 0.0), ior=ior)

    @staticmethod
    def clear(index: float, _roughness: float = 0.0) -> "Material":
        return Material(TRANSMISSIVE, (0.0, 0.0, 0.0), ior=index)

    @staticmethod
    def transparent(color: Vec3, index: float, _roughness: float = 0.0) -> "Material":
        return Material(TRANSMISSIVE, _tup(color), ior=index)

    @staticmethod
    def metallic(color: Vec3, roughness: float) -> "Material":
        return Material(PHONG, _tup(color), shininess=roughness)

    @staticmethod
    def light(color: Vec3, emittance: float) -> "Material":
        return Material(LAMBERTIAN, _tup(color), emittance=emittance)

    # queries mirroring material.rs:100-141 ------------------------------
    def emittance_value(self) -> float:
        return self.emittance if self.kind in (LAMBERTIAN, PHONG) else 0.0

    def color_value(self) -> tuple:
        return self.albedo if self.kind in (LAMBERTIAN, PHONG) else (0.0, 0.0, 0.0)

    def is_mirror(self) -> bool:
        return self.kind in (MIRROR, TRANSMISSIVE)


def _tup(c) -> tuple:
    if isinstance(c, Vec3):
        return (float(c.x), float(c.y), float(c.z))
    return tuple(float(v) for v in c)


# -------------------------------------------------------------------------
# Compiled material table


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MaterialTable:
    """Device-side SoA table; every hit carries an int32 row index."""

    kind: jax.Array  # (M,) int32
    albedo: Vec3  # (M,)
    emittance: jax.Array  # (M,)
    shininess: jax.Array  # (M,)
    ior: jax.Array  # (M,)

    @staticmethod
    def build(materials: list[Material]) -> "MaterialTable":
        if not materials:
            materials = [Material()]
        return MaterialTable(
            jnp.asarray(np.array([m.kind for m in materials], np.int32)),
            Vec3.from_array(np.array([m.albedo for m in materials], np.float64)),
            jnp.asarray(np.array([m.emittance for m in materials]), DTYPE),
            jnp.asarray(np.array([m.shininess for m in materials]), DTYPE),
            jnp.asarray(np.array([m.ior for m in materials]), DTYPE),
        )

    def lookup(self, ids) -> "MaterialLanes":
        ids = jnp.maximum(ids, 0)  # -1 (miss) reads row 0; callers mask misses
        from .vec import take

        return MaterialLanes(
            jnp.take(self.kind, ids),
            take(self.albedo, ids),
            jnp.take(self.emittance, ids),
            jnp.take(self.shininess, ids),
            jnp.take(self.ior, ids),
        )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MaterialLanes:
    """Per-ray material parameters (gathered rows of MaterialTable)."""

    kind: jax.Array
    albedo: Vec3
    emittance: jax.Array
    shininess: jax.Array
    ior: jax.Array

    # queries (material.rs:100-141), vectorized --------------------------
    def emittance_query(self) -> jax.Array:
        return jnp.where(self.kind <= PHONG, self.emittance, 0.0)

    def color_query(self) -> Vec3:
        zero = Vec3.zeros(jnp.shape(self.kind))
        return where(self.kind <= PHONG, self.albedo, zero)

    def is_mirror(self) -> jax.Array:
        return self.kind >= MIRROR


def _schlick(ni, nt, cos_theta_i):
    """material.rs:159-162."""
    r0 = ((ni - nt) / (ni + nt)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_theta_i) ** 5


def sample_f(mat: MaterialLanes, normal: Vec3, wo: Vec3, keys):
    """Sample a bounce direction per lane; returns (wi, pdf, valid).

    Vectorized port of material.rs:166-263. ``valid`` is False on total
    internal reflection (the reference returns ``None``, terminating the
    path).
    """
    r1, r2 = sampling.uniform2(sampling.fold(keys, 0xB5DF))
    rr = sampling.uniform(sampling.fold(keys, 0xF7E5))

    # Lambertian: cosine hemisphere around the normal (material.rs:173-197)
    wi_lam, pdf_lam = sampling.cosine_hemisphere(r1, r2, normal)

    # Phong: cos^n lobe around the mirror direction (material.rs:199-219)
    reflected = -reflect(wo, normal)
    wi_phong, pdf_phong = sampling.phong_lobe(r1, r2, mat.shininess, reflected)

    # Mirror: perfect reflection, pdf 1 (material.rs:221)
    wi_mirror = -reflect(wo, normal.normalize())

    # Transmissive: Schlick-ratio RR between reflection and refraction
    # (material.rs:222-260)
    inside = normal.dot(wo) < 0.0
    n_eff = where(inside, -normal, normal)
    cos_i = jnp.clip(wo.dot(n_eff), 0.0, 1.0)
    ior = mat.ior
    ni = jnp.where(inside, ior, 1.0)
    nt = jnp.where(inside, 1.0, ior)
    schlick_ratio = jnp.clip(_schlick(ni, nt, cos_i), 0.0, 1.0)
    reflect_branch = rr < schlick_ratio
    # snell_solve (material.rs:144-146); negative discriminant = TIR
    eta = ni / nt
    disc = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = disc < 0.0
    cos_t = jnp.sqrt(jnp.maximum(disc, 0.0))
    # refract_ray (material.rs:148-157)
    refracted = (-wo) * eta + n_eff * (eta * cos_i - cos_t)
    wi_trans = where(reflect_branch, -reflect(wo, normal), refracted)
    valid_trans = reflect_branch | ~tir

    kind = mat.kind
    one = jnp.ones_like(pdf_lam)
    wi = where(
        kind == LAMBERTIAN,
        wi_lam,
        where(kind == PHONG, wi_phong, where(kind == MIRROR, wi_mirror, wi_trans)),
    )
    pdf = jnp.where(kind == LAMBERTIAN, pdf_lam, jnp.where(kind == PHONG, pdf_phong, one))
    valid = jnp.where(kind == TRANSMISSIVE, valid_trans, True)
    return wi, pdf, valid


def bsdf(mat: MaterialLanes, normal: Vec3, wo: Vec3, wi: Vec3) -> Vec3:
    """Evaluate the BSDF per lane — port of material.rs:266-289."""
    n_dot_wi = normal.dot(wi)
    n_dot_wo = normal.dot(wo)
    above = (n_dot_wi >= 0.0) & (n_dot_wo >= 0.0)

    f_lam = mat.albedo * sampling.INV_PI

    norm = mat.albedo * ((mat.shininess + 2.0) / sampling.TWO_PI)
    reflected = (-reflect(wi, normal)).normalize()
    f_phong = norm * jnp.clip(reflected.dot(wo), 0.0, 1.0) ** mat.shininess

    ones = Vec3.ones(jnp.shape(n_dot_wi))
    kind = mat.kind
    f = where(kind == LAMBERTIAN, f_lam, where(kind == PHONG, f_phong, ones))
    zero = Vec3.zeros(jnp.shape(n_dot_wi))
    return where(above, f, zero)
