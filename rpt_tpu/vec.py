"""Structure-of-arrays 3-vector math.

Design note: the reference stores geometry as arrays-of-structs of
``glm::DVec3`` (`/root/reference/src/shape.rs:50-56`). An ``(N, 3)`` array
makes every dot product an axis=-1 reduction over a tiny minor dimension.
We instead keep each component as its own flat ``(N,)`` array — every
vector op is then a pure element-wise op over contiguous lanes, and XLA
fuses whole shading expressions into single kernels.

``Vec3`` is a registered pytree dataclass so it flows through ``jit``,
``vmap``, ``lax.scan`` and shardings unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .dtypes import DTYPE


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Vec3:
    """A 3-vector (or batch of 3-vectors) stored as separate components."""

    x: jax.Array
    y: jax.Array
    z: jax.Array

    # ---- constructors -------------------------------------------------
    @staticmethod
    def of(x, y, z) -> "Vec3":
        return Vec3(jnp.asarray(x, DTYPE), jnp.asarray(y, DTYPE), jnp.asarray(z, DTYPE))

    @staticmethod
    def full(value, shape=()) -> "Vec3":
        v = jnp.full(shape, value, DTYPE)
        return Vec3(v, v, v)

    @staticmethod
    def zeros(shape=()) -> "Vec3":
        return Vec3.full(0.0, shape)

    @staticmethod
    def ones(shape=()) -> "Vec3":
        return Vec3.full(1.0, shape)

    @staticmethod
    def from_array(a) -> "Vec3":
        """From an (..., 3) array (API boundary only — not used in kernels)."""
        a = jnp.asarray(a, DTYPE)
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> jax.Array:
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    def to_numpy(self) -> np.ndarray:
        return np.stack([np.asarray(self.x), np.asarray(self.y), np.asarray(self.z)], axis=-1)

    # ---- shape helpers -------------------------------------------------
    @property
    def shape(self):
        return jnp.shape(self.x)

    def broadcast_to(self, shape) -> "Vec3":
        return Vec3(
            jnp.broadcast_to(self.x, shape),
            jnp.broadcast_to(self.y, shape),
            jnp.broadcast_to(self.z, shape),
        )

    def reshape(self, *shape) -> "Vec3":
        return self.map(lambda c: c.reshape(*shape))

    def __getitem__(self, idx) -> "Vec3":
        return Vec3(self.x[idx], self.y[idx], self.z[idx])

    def map(self, f) -> "Vec3":
        return Vec3(f(self.x), f(self.y), f(self.z))

    # ---- arithmetic ----------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        """Scalar broadcast, or component-wise (Hadamard) product for Vec3
        operands — matches glm ``component_mul`` used throughout the
        reference renderer (`renderer.rs:230`)."""
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # ---- geometry ------------------------------------------------------
    def dot(self, o: "Vec3") -> jax.Array:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_squared(self) -> jax.Array:
        return self.dot(self)

    def length(self) -> jax.Array:
        return jnp.sqrt(self.length_squared())

    def normalize(self, eps: float = 0.0) -> "Vec3":
        inv = jax.lax.rsqrt(jnp.maximum(self.length_squared(), eps if eps else 1e-38))
        return self * inv

    def abs(self) -> "Vec3":
        return Vec3(jnp.abs(self.x), jnp.abs(self.y), jnp.abs(self.z))

    def sum(self) -> jax.Array:
        return self.x + self.y + self.z

    def max_component(self) -> jax.Array:
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def min_component(self) -> jax.Array:
        return jnp.minimum(self.x, jnp.minimum(self.y, self.z))

    def clip(self, lo, hi) -> "Vec3":
        return self.map(lambda c: jnp.clip(c, lo, hi))

    def minimum(self, o) -> "Vec3":
        if isinstance(o, Vec3):
            return Vec3(jnp.minimum(self.x, o.x), jnp.minimum(self.y, o.y), jnp.minimum(self.z, o.z))
        return self.map(lambda c: jnp.minimum(c, o))

    def maximum(self, o) -> "Vec3":
        if isinstance(o, Vec3):
            return Vec3(jnp.maximum(self.x, o.x), jnp.maximum(self.y, o.y), jnp.maximum(self.z, o.z))
        return self.map(lambda c: jnp.maximum(c, o))

    def isfinite(self) -> jax.Array:
        return jnp.isfinite(self.x) & jnp.isfinite(self.y) & jnp.isfinite(self.z)


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    """Component-wise select: ``mask ? a : b``."""
    return Vec3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    """glm::mix — linear interpolation (used by HDRI bilinear sampling,
    `environment.rs:39-51`)."""
    return a + (b - a) * t


def reflect(v: Vec3, n: Vec3) -> Vec3:
    """glm::reflect_vec(v, n) = v - 2*(v·n)*n."""
    return v - n * (2.0 * v.dot(n))


def take(v: Vec3, idx, **kwargs) -> Vec3:
    """Gather: v[idx] for integer index arrays."""
    return Vec3(
        jnp.take(v.x, idx, **kwargs),
        jnp.take(v.y, idx, **kwargs),
        jnp.take(v.z, idx, **kwargs),
    )


def orthonormal_basis(n: Vec3):
    """Branchless orthonormal basis around unit vector ``n`` (Duff et al. 2017).

    Replaces the reference's ``nalgebra::Rotation3::rotation_between((0,1,0), n)``
    (`material.rs:186-194`): any frame that maps the local +Y axis to ``n`` is
    equivalent for sampling azimuthally-symmetric lobes. Returns ``(t, b)``
    such that ``(t, n, b)`` is right-handed orthonormal; a local direction
    ``(lx, ly, lz)`` maps to ``t*lx + n*ly + b*lz``.
    """
    sign = jnp.where(n.z >= 0.0, 1.0, -1.0).astype(n.z.dtype)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    t = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    u = Vec3(b, sign + n.y * n.y * a, -n.y)
    return t, u


def from_local(local: Vec3, n: Vec3) -> Vec3:
    """Map a local-frame direction (y-up, as sampled by the reference's
    hemisphere routines, `material.rs:179-183`) into the frame of normal ``n``."""
    t, b = orthonormal_basis(n)
    return t * local.x + n * local.y + b * local.z


# Affine transforms -------------------------------------------------------
# A 3x4 affine transform is stored as 12 scalars (row-major linear part +
# translation). Host-side these come from numpy 4x4 matrices.


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Mat3:
    """Row-major 3x3 matrix with array entries (batched like Vec3)."""

    m00: jax.Array
    m01: jax.Array
    m02: jax.Array
    m10: jax.Array
    m11: jax.Array
    m12: jax.Array
    m20: jax.Array
    m21: jax.Array
    m22: jax.Array

    @staticmethod
    def from_numpy(m) -> "Mat3":
        m = np.asarray(m)
        return Mat3(*[jnp.asarray(m[..., i, j], DTYPE) for i in range(3) for j in range(3)])

    def apply(self, v: Vec3) -> Vec3:
        return Vec3(
            self.m00 * v.x + self.m01 * v.y + self.m02 * v.z,
            self.m10 * v.x + self.m11 * v.y + self.m12 * v.z,
            self.m20 * v.x + self.m21 * v.y + self.m22 * v.z,
        )

    def __getitem__(self, idx) -> "Mat3":
        return Mat3(*[getattr(self, f)[idx] for f in _MAT3_FIELDS])


_MAT3_FIELDS = [f.name for f in dataclasses.fields(Mat3)]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Affine:
    """Affine transform: linear 3x3 + translation, batched like Vec3."""

    linear: Mat3
    translation: Vec3

    @staticmethod
    def from_numpy(m4) -> "Affine":
        """From a (..., 4, 4) homogeneous matrix."""
        m4 = np.asarray(m4)
        return Affine(
            Mat3.from_numpy(m4[..., :3, :3]),
            Vec3.from_array(m4[..., :3, 3]),
        )

    def apply_point(self, p: Vec3) -> Vec3:
        return self.linear.apply(p) + self.translation

    def apply_dir(self, d: Vec3) -> Vec3:
        return self.linear.apply(d)

    def __getitem__(self, idx) -> "Affine":
        return Affine(self.linear[idx], self.translation[idx])


def mat3_take(m: Mat3, idx) -> Mat3:
    return Mat3(*[jnp.take(getattr(m, f), idx) for f in _MAT3_FIELDS])


def affine_take(a: Affine, idx) -> Affine:
    return Affine(mat3_take(a.linear, idx), take(a.translation, idx))
