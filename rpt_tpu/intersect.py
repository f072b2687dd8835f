"""Vectorized ray-primitive intersection and scene closest-hit.

Ports the per-shape `intersect` methods of `/root/reference/src/shape/*.rs`
to wavefront kernels: every function takes a batch of N rays and tests them
against one primitive (analytic prims, looped/merged per prim — scenes have
few) or the whole triangle BVH (ordered short-stack traversal, all rays in
lock-step inside ``lax.while_loop`` phases with survivor compaction).

Scene-level closest hit mirrors the reference's *deliberate* linear scan
over objects (`renderer.rs:411-425` — planes have infinite extent and don't
fit an acceleration structure); here the "scan" is a masked min over
per-type batches, plus the BVH for all mesh triangles.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

from .dtypes import DTYPE, INF
from .ray import Hit, Ray, closer
from .vec import _MAT3_FIELDS, Affine, Mat3, Vec3, take, where


# ---------------------------------------------------------------------------
# Compiled geometry tables (built by rpt_tpu.scene)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PrimSet:
    """A batch of one analytic primitive type, each with its own transform.

    Mirrors ``Transformed<T>`` (shape.rs:102-126): rays are inverse-
    transformed into object space; normals map by M^-T.
    """

    world_to_obj: Affine  # (P,)
    normal_mat: Mat3  # (P,) = inverse-transpose of the linear part
    obj_to_world: Affine  # (P,)
    det: jax.Array  # (P,) determinant of the linear part
    material: jax.Array  # (P,) int32
    param: jax.Array  # (P,) extra parameter (monomial height)

    @property
    def n(self) -> int:
        return int(self.material.shape[0])


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PlaneSet:
    normal: Vec3  # (P,)
    value: jax.Array  # (P,)
    material: jax.Array  # (P,) int32

    @property
    def n(self) -> int:
        return int(self.material.shape[0])


# Packed-row layout constants. Design notes (from the part this was first
# tuned for; to be re-measured on the GPU):
# * a gather cost about the same per ROW whether the row held 1 or 128
#   floats — so each traversal step fetches exactly ONE node row (both
#   children's boxes -> ordered near-first descent) and ONE leaf row
#   (8 triangles).
# * Extracting single columns from a gathered (n, W) row cost a cross-lane
#   shuffle EACH — so rows are laid out COMPONENT-MAJOR in blocks that are
#   consumed as contiguous lane slices, and the triangle math is vectorized
#   across the 8 slots.
# * Per-lane stack push/pop uses dense one-hot masking over the (n, DEPTH)
#   stack instead of scatter/gather (dense elementwise ops beat scatters).
# Shading attributes (normals, material) are fetched once per ray AFTER
# traversal.
NODE_ROW = 16
# node row layout (child-major groups, consumed as TWO coarse lane slices
# + one (n,2,3) reshape-reduce — column extraction of gathered rows costs
# a cross-lane op per column, so minimize slice count):
#   [0:6]  = Lmin.xyz, Rmin.xyz
#   [6:12] = Lmax.xyz, Rmax.xyz
#   [12:16] = Lptr, Rptr, Lmeta, Rmeta
LEAF_TRIS = 8
LEAF_ROW = 80
# leaf row layout: 10 component blocks of 8 slots:
#   [v1.x*8][v1.y*8][v1.z*8][e1.x*8][e1.y*8][e1.z*8][e2.x*8][e2.y*8][e2.z*8][id*8]
SHADE_ROW = 12  # [n1.xyz, n2.xyz, n3.xyz, material, pad, pad]
STACK_DEPTH = 48  # default; real trees carry an exact bound (BVHTables.stack_depth)
# meta codes: 0 = internal child (ptr = node row), >0 = leaf child with
# `meta` triangles (ptr = leaf row), <0 = empty child.


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BVHTables:
    """Pair-packed BVH (built by `rpt_tpu.accel.bvh.pack_bvh`).

    ``nodes``: (K, NODE_ROW) f32 — indices stored as exact small floats.
    ``leaves``: (L, LEAF_ROW) f32 — up to 8 triangles as v1/e1/e2, plus
    their triangle indices (-1 padding).
    ``shade``: (T, SHADE_ROW) f32 — per-triangle vertex normals + material.
    ``stack_depth``: static exact bound on traversal stack occupancy,
    computed host-side in pack_bvh (deepest internal node + 1); sizing the
    one-hot stack to the tree keeps the dense stack ops minimal and makes
    overflow impossible by construction.
    """

    nodes: jax.Array
    leaves: jax.Array
    shade: jax.Array
    stack_depth: int = field(default=STACK_DEPTH, metadata=dict(static=True))


# ---------------------------------------------------------------------------
# Per-type intersectors. Convention: return a Hit (time=inf on miss); the
# caller merges with `closer`.


def _local_hit_to_world(prims: PrimSet, i, local_n: Vec3, t, ok) -> Hit:
    nmat = prims.normal_mat[i]
    world_n = nmat.apply(local_n).normalize()
    time = jnp.where(ok, t, INF)
    mat = jnp.broadcast_to(prims.material[i], jnp.shape(t)).astype(jnp.int32)
    return Hit(time, world_n, mat)


def _foreach_prim(n: int, body_hit, best: Hit) -> Hit:
    """Merge per-prim hits. Few prims unroll into the graph; many prims run
    as a fori_loop with traced prim index (keeps HLO size bounded for
    scenes like fractal_spheres' ~10^3 analytic spheres)."""
    if n <= 8:
        for i in range(n):
            best = closer(best, body_hit(i))
        return best
    return jax.lax.fori_loop(0, n, lambda i, b: closer(b, body_hit(i)), best)


def intersect_spheres(prims: PrimSet, ray: Ray, t_min, best: Hit) -> Hit:
    """Unit sphere quadratic (shape/sphere.rs:14-46), per transformed prim."""

    def body(i):
        local = ray.transform(prims.world_to_obj[i])
        a = local.dir.length_squared()
        b = local.dir.dot(local.origin)
        c = local.origin.length_squared() - 1.0
        disc = b * b - a * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t_minus = (-b - sq) / a
        t_plus = (-b + sq) / a
        t = jnp.where(t_minus < t_min, t_plus, t_minus)
        ok = (disc >= 0.0) & (t >= t_min)
        local_n = local.at(t)  # = normal of the unit sphere
        return _local_hit_to_world(prims, i, local_n.normalize(), t, ok)

    return _foreach_prim(prims.n, body, best)


def intersect_cubes(prims: PrimSet, ray: Ray, t_min, best: Hit) -> Hit:
    """Unit-cube slab test with per-axis entry/exit normals
    (shape/cube.rs:22-74)."""

    def body(i):
        local = ray.transform(prims.world_to_obj[i])

        def interval(o, d):
            x1 = (-0.5 - o) / d
            x2 = (0.5 - o) / d
            return jnp.minimum(x1, x2), jnp.maximum(x1, x2), jnp.where(x1 > x2, 1.0, -1.0)

        x1, x2, sx = interval(local.origin.x, local.dir.x)
        y1, y2, sy = interval(local.origin.y, local.dir.y)
        z1, z2, sz = interval(local.origin.z, local.dir.z)
        # entry: the largest near-plane; reference tie-breaking
        # (cube.rs:40-48): x wins if strictly greater than both, else y
        # if strictly greater than z, else z.
        x_first = (x1 > y1) & (x1 > z1)
        y_first = (~x_first) & (y1 > z1)
        z_first = ~(x_first | y_first)
        start = jnp.where(x_first, x1, jnp.where(y_first, y1, z1))
        zero = jnp.zeros_like(x1)
        start_n = Vec3(
            jnp.where(x_first, sx, zero),
            jnp.where(y_first, sy, zero),
            jnp.where(z_first, sz, zero),
        )
        x_last = (x2 < y2) & (x2 < z2)
        y_last = (~x_last) & (y2 < z2)
        z_last = ~(x_last | y_last)
        end = jnp.where(x_last, x2, jnp.where(y_last, y2, z2))
        end_n = Vec3(
            jnp.where(x_last, -sx, zero),
            jnp.where(y_last, -sy, zero),
            jnp.where(z_last, -sz, zero),
        )
        ok = (start <= end) & (end >= t_min)
        inside = start < t_min
        t = jnp.where(inside, end, start)
        ok &= ~_slides_on_face(prims.world_to_obj[i], ray.origin, local, t)
        local_n = where(inside, end_n, start_n)
        return _local_hit_to_world(prims, i, local_n, t, ok)

    return _foreach_prim(prims.n, body, best)


def _slides_on_face(w: Affine, world_o: Vec3, local: Ray, t) -> jax.Array:
    """True where the ray origin and the candidate hit both lie within f32
    rounding of the same face plane of the unit cube: the segment slides
    along the surface and never enters the solid (same f32 deviation as
    `intersect_planes`, which see). Rounding puts such computed origins
    randomly just inside or just outside, and "inside" returned the far
    exit — a photon on a box face was occluded from a gather point on the
    same face by the box itself, or not, at the whim of one ulp (the GPU's
    fused multiply-adds flipped ~7% of the lampshade's gather pixels
    against the CPU). The tolerance scales with the magnitude of the
    computation that produced each local coordinate, |W||o| + |b|."""
    a = w.linear
    mag = Mat3(*[jnp.abs(getattr(a, f)) for f in _MAT3_FIELDS]).apply(
        world_o.map(jnp.abs)
    ) + w.translation.map(jnp.abs)
    hit = local.at(t)
    tol = 32.0 * jnp.finfo(DTYPE).eps
    slides = jnp.zeros(jnp.shape(t), bool)
    for o_c, h_c, m_c in zip((local.origin.x, local.origin.y, local.origin.z),
                             (hit.x, hit.y, hit.z), (mag.x, mag.y, mag.z)):
        for face in (-0.5, 0.5):
            slides |= ((jnp.abs(o_c - face) <= tol * m_c)
                       & (jnp.abs(h_c - face) <= tol * (m_c + jnp.abs(h_c))))
    return slides


def intersect_planes(planes: PlaneSet, ray: Ray, t_min, best: Hit) -> Hit:
    """x . normal = value (shape/plane.rs:17-32); normal flipped against the
    ray.

    f32 deviation: the reference rejects near-parallel rays with
    ``|cosine| < 1e-8`` (plane.rs:19-22), which in f64 also rejects every
    ray that *starts on* the plane and travels along it (its direction
    noise is ~1e-16). In f32 that noise is ~1e-7..1e-4 — above 1e-8 — so
    a grazing ray between two points on the plane computed t = tiny/tiny,
    a random value in (t_min, dist): 27% of floor-photon visibility
    rechecks (photon.rs:353-361) were spuriously "occluded" by the very
    plane both endpoints sat on. An origin numerically ON the plane can
    never be legitimately occluded by that plane (an infinite plane is
    re-hit only at t=0), so reject when |value - n.o| is within f32
    rounding. The threshold scale is the L1 magnitude of the origin plus
    |value| — a computed position coordinate carries absolute noise
    ~eps*||o||, NOT ~eps*|that coordinate| (a floor through 0 has its
    noise exactly where the normal-weighted component vanishes); see
    `_origin_on_plane`. Measured floor-photon residuals <= 6 eps*||o||
    (triangles get the same guard)."""

    def body(i):
        n = planes.normal[i].broadcast_to(ray.origin.shape)
        cosine = n.dot(ray.dir)
        num = planes.value[i] - n.dot(ray.origin)
        t = num / cosine
        # the plane normal is NOT normalized (x.normal = value, raw):
        # weight the origin magnitude by ||n||_1 so num's units match
        n_l1 = jnp.abs(n.x) + jnp.abs(n.y) + jnp.abs(n.z)
        scale = n_l1 * (
            jnp.abs(ray.origin.x)
            + jnp.abs(ray.origin.y)
            + jnp.abs(ray.origin.z)
        ) + jnp.abs(planes.value[i])
        on_plane = jnp.abs(num) <= (32.0 * jnp.finfo(DTYPE).eps) * scale
        ok = (jnp.abs(cosine) >= 1e-8) & (t >= t_min) & ~on_plane
        normal = -n.normalize() * jnp.sign(cosine)
        mat = jnp.broadcast_to(planes.material[i], jnp.shape(t)).astype(jnp.int32)
        return Hit(jnp.where(ok, t, INF), normal, mat)

    return _foreach_prim(planes.n, body, best)


def intersect_monomials(prims: PrimSet, ray: Ray, t_min, best: Hit) -> Hit:
    """Newton + 60-step bisection for y = h (x^2+z^2)^2
    (shape/monomial_surface.rs:22-107) — already fixed-iteration, so it maps
    to wavefronts directly; vectorized with masks."""

    def body(i):
        local = ray.transform(prims.world_to_obj[i])
        h = prims.param[i]
        o, d = local.origin, local.dir

        def dist(t):
            x = o.x + t * d.x
            y = o.y + t * d.y
            z = o.z + t * d.z
            return y - h * (x * x + z * z) ** 2

        coef0 = o.x * o.x + o.z * o.z
        coef1 = 2.0 * (o.x * d.x + o.z * d.z)
        coef2 = d.x * d.x + d.z * d.z

        def deriv(t):
            dy = (
                2.0 * coef0 * coef1
                + 2.0 * t * (coef1 * coef1 + 2.0 * coef0 * coef2)
                + 3.0 * t * t * 2.0 * coef1 * coef2
                + 4.0 * t * t * t * coef2 * coef2
            )
            return d.y - h * dy

        def deriv2(t):
            dy = (
                2.0 * (coef1 * coef1 + 2.0 * coef0 * coef2)
                + 6.0 * t * 2.0 * coef1 * coef2
                + 12.0 * t * t * coef2 * coef2
            )
            return -h * dy

        # local bbox [-1,0,-1] .. [1,h,1] slab test
        b_min, b_max = _aabb_interval(
            local, Vec3.of(-1.0, 0.0, -1.0), Vec3(jnp.ones_like(h), h, jnp.ones_like(h))
        )
        feasible = jnp.maximum(b_min, t_min) <= jnp.minimum(b_max, best.time)

        maximize = dist(t_min) < 0.0
        # Newton ascent toward the maximum of dist(t) (10 iterations)
        cur = (b_min + b_max) / 2.0
        stop = jnp.zeros_like(maximize)
        for _ in range(10):
            f = dist(cur)
            stop = stop | (f > 0.0)
            step = deriv(cur) / deriv2(cur)
            cur = jnp.where(stop | ~maximize, cur, cur - step)
        t_max = jnp.where(maximize, cur, 10000.0)
        feasible &= ~(maximize & (t_max < t_min))
        feasible &= (dist(t_min) < 0.0) != (dist(t_max) < 0.0)

        l = jnp.full_like(t_max, t_min)
        r = t_max
        for _ in range(60):
            m = (l + r) / 2.0
            go_right = (dist(m) >= 0.0) == maximize
            r = jnp.where(go_right, m, r)
            l = jnp.where(go_right, l, m)

        pos = local.at(r)
        rad2 = pos.x * pos.x + pos.z * pos.z
        ok = feasible & (rad2 <= 1.0)
        local_n = Vec3(h * 4.0 * pos.x * rad2, -jnp.ones_like(rad2), h * 4.0 * pos.z * rad2)
        local_n = local_n.normalize()
        flip = local_n.dot(local.dir) > 0.0
        local_n = where(flip, -local_n, local_n)
        return _local_hit_to_world(prims, i, local_n, r, ok)

    return _foreach_prim(prims.n, body, best)


def _slab_interval(o: Vec3, inv: Vec3, p_min: Vec3, p_max: Vec3):
    """NaN-safe slab intersection interval (kdtree.rs:57-71).

    When a ray direction component is 0 and the origin lies exactly on a
    slab plane, 0*inf produces NaN; treat that axis as non-constraining
    (the reference's f64 arithmetic yields +-inf there and axis-aligned
    Cornell geometry makes this case common)."""
    t1 = (p_min - o) * inv
    t2 = (p_max - o) * inv
    lo = t1.minimum(t2).map(lambda c: jnp.where(jnp.isnan(c), -INF, c))
    hi = t1.maximum(t2).map(lambda c: jnp.where(jnp.isnan(c), INF, c))
    return lo.max_component(), hi.min_component()


def _aabb_interval(ray: Ray, p_min: Vec3, p_max: Vec3):
    inv = Vec3.ones(ray.dir.shape) / ray.dir
    return _slab_interval(ray.origin, inv, p_min, p_max)


# ---------------------------------------------------------------------------
# Triangle BVH traversal


def _origin_on_plane(num, pn, v1, o):
    """True where the ray origin lies within f32 rounding of a triangle's
    supporting plane (same f32 deviation as `intersect_planes`, which see:
    the reference's |cosine|>=1e-8 guard only rejects on-plane grazing
    rays under f64 noise levels). A grazing ray between two points ON a
    mesh floor computed t = tiny/tiny — 50.7% of noisy floor-photon
    visibility rechecks (photon.rs:353-361) were spuriously self-occluded.
    ``num = pn.(v1-o)`` with
    pn normalized.

    Threshold scale: the absolute f32 error of a COMPUTED position
    coordinate is ~eps x the magnitude of the computation that produced
    it (ray.at sums scale-of-scene products), NOT eps x that coordinate —
    a photon on a floor at y=0 has y-noise ~eps*||o||, so the scale must
    be the L1 magnitude of the points, never the normal-weighted
    components (which vanish exactly where the noise lives)."""
    scale = (
        jnp.abs(o.x) + jnp.abs(o.y) + jnp.abs(o.z)
        + jnp.abs(v1.x) + jnp.abs(v1.y) + jnp.abs(v1.z)
    )
    return jnp.abs(num) <= (32.0 * jnp.finfo(DTYPE).eps) * scale


def _leaf_intersect(leaves, do_leaf, leaf_idx, count, ray, t_min, time, tri, bu, bv, bw):
    """Gather one leaf row per lane (masked) and test its 8 triangles."""
    leaf = jnp.take(leaves, jnp.where(do_leaf, leaf_idx, 0), axis=0)  # (n, 80)
    return _leaf_rows_test(leaf, do_leaf, count, ray, t_min, time, tri, bu, bv, bw)


def _leaf_rows_test(leaf, do_leaf, count, ray, t_min, time, tri, bu, bv, bw):
    """Test the 8 triangles of materialized (n, LEAF_ROW) rows, vectorized
    across the slot axis.

    Same algebra as mesh.rs:50-83 (plane hit + barycentric) with
    d0 = e1 = v2-v1, d1 = e2 = v3-v1, on (n, 8) arrays; the per-lane best
    slot is selected with a one-hot reduction.
    """
    # one relayout, then component extraction is a cheap sublane slice.
    # slot count derives from the row width: 8 for tri-leaf rows, 64 for
    # fat cluster rows (the fat-leaf cluster BVH of big meshes)
    leaf3 = leaf.reshape(leaf.shape[0], 10, leaf.shape[1] // 10)

    def block(c):  # -> (n, 8)
        return leaf3[:, c, :]

    def vec(c0):
        return Vec3(block(c0), block(c0 + 1), block(c0 + 2))

    v1, e1, e2 = vec(0), vec(3), vec(6)
    tri_id = block(9).astype(jnp.int32)

    def bcast(x):  # (n,) -> (n, 1)
        return x[:, None]

    o = Vec3(bcast(ray.origin.x), bcast(ray.origin.y), bcast(ray.origin.z))
    d = Vec3(bcast(ray.dir.x), bcast(ray.dir.y), bcast(ray.dir.z))

    pn = e1.cross(e2).normalize()
    cosine = pn.dot(d)
    num = pn.dot(v1 - o)
    t = num / cosine
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
    ok = (
        (jnp.abs(cosine) >= 1e-8)
        & ~_origin_on_plane(num, pn, v1, o)
        & (t >= t_min)
        & (t < bcast(time))
        & (tri_id >= 0)
        & (slot_ids < bcast(count))
        & bcast(do_leaf)
    )
    p = o + d * t
    d2 = p - v1
    d00 = e1.dot(e1)
    d01 = e1.dot(e2)
    d11 = e2.dot(e2)
    d20 = d2.dot(e1)
    d21 = d2.dot(e2)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    ok &= (u >= 0.0) & (v >= 0.0) & (w >= 0.0)

    t_masked = jnp.where(ok, t, INF)
    best = jnp.min(t_masked, axis=1)
    sel = t_masked == best[:, None]
    # break ties toward the lowest slot
    sel &= jnp.cumsum(sel, axis=1) == 1

    def pick(x):
        return jnp.sum(jnp.where(sel, x, 0), axis=1)

    better = best < time
    time = jnp.where(better, best, time)
    tri = jnp.where(better, pick(tri_id), tri)
    bu = jnp.where(better, pick(u), bu)
    bv = jnp.where(better, pick(v), bv)
    bw = jnp.where(better, pick(w), bw)
    return time, tri, bu, bv, bw


# staged survivor compaction: (bounded steps at full width) -> (bounded
# steps at 1/2 width) -> (fixpoint at 1/8 width). Active-lane decay on the
# dragon workload: ~36% after 24 steps, ~3% after 48 — each stage must be
# wide enough for the survivors of the previous one, or the fixpoint stage
# loops over leftovers.
COMPACT_STAGES = ((24, 2), (24, 8))


def _traverse(bvh: BVHTables, ray: Ray, t_min, limit, best_time, any_hit: bool,
              active=None):
    """Ordered short-stack traversal over pair-packed nodes, with staged
    survivor compaction.

    Each step fetches ONE node row containing both children's boxes, tests
    both, descends into the nearer hit child and pushes the farther onto a
    per-ray stack. This is the wavefront analog of the reference's
    front-to-back kd descent with t-based pruning (kdtree.rs:154-226).

    The loop cost is set by the SLOWEST lane (~7x the mean step count), so
    after a bounded number of steps the surviving lanes are argsort-
    compacted to the front and the loop continues at reduced width; the
    final stage repeats under an outer fixpoint loop (exact for any
    survivor count).

    Returns (time, tri_id, u, v, w). ``limit`` bounds useful hits (shadow
    distance or +inf); with ``any_hit`` lanes stop as soon as any hit
    < limit is found (occlusion queries don't need the closest).
    """
    n = ray.origin.shape[0] if ray.origin.shape else ()
    inv_dir = Vec3.ones(ray.dir.shape) / ray.dir
    nodes, leaves = bvh.nodes, bvh.leaves
    stack_depth = bvh.stack_depth

    def make_body(ray, inv_dir, limit):
        width = ray.origin.shape[0]
        depth_iota = jax.lax.broadcasted_iota(jnp.int32, (width, stack_depth), 1)
        o6 = jnp.concatenate([ray.origin.to_array()] * 2, axis=1)
        inv6 = jnp.concatenate([inv_dir.to_array()] * 2, axis=1)
        return lambda state: _traverse_step(
            state, ray, inv_dir, limit, nodes, leaves, t_min, any_hit, depth_iota,
            o6=o6, inv6=inv6,
        )

    def run_bounded(state, ray, inv_dir, limit, max_steps):
        body = make_body(ray, inv_dir, limit)

        def cond(carry):
            return jnp.any(carry[0][0] >= 0) & (carry[1] < max_steps)

        state, _ = jax.lax.while_loop(
            cond, lambda c: (body(c[0]), c[1] + 1), (state, jnp.int32(0))
        )
        return state

    def run_to_end(state, ray, inv_dir, limit):
        body = make_body(ray, inv_dir, limit)
        return jax.lax.while_loop(lambda s: jnp.any(s[0] >= 0), body, state)

    z = jnp.zeros(n, DTYPE)
    # lanes whose limit can't admit any hit (e.g. masked-off shadow rays
    # with limit -1) — or that the caller masked off — never enter the
    # loop; the staged compaction then shrinks the wavefront immediately,
    # so a mostly-masked full-width call costs ~its active fraction
    live0 = jnp.broadcast_to(limit, (n,)) > t_min
    if active is not None:
        live0 = live0 & active
    cur0 = jnp.where(live0, 0, -1).astype(jnp.int32)
    state = (
        cur0,
        jnp.zeros(n, jnp.int32),
        jnp.zeros((n, stack_depth), jnp.int32),
        best_time,
        jnp.full(n, -1, jnp.int32),
        z,
        z,
        z,
    )

    # small wavefronts/trees: the argsort+gather compaction machinery costs
    # more than just finishing the loop (tiny trees traverse in ~depth steps)
    if n < 4096 or bvh.nodes.shape[0] < 1024:
        state = run_to_end(state, ray, inv_dir, limit)
        return state[3], state[4], state[5], state[6], state[7]

    def gather_sub(sel):
        sub_ray = Ray(take(ray.origin, sel), take(ray.dir, sel))
        sub_inv = take(inv_dir, sel)
        sub_limit = limit[sel] if jnp.ndim(limit) else limit
        return sub_ray, sub_inv, sub_limit

    # stage 1: bounded at full width
    state = run_bounded(state, ray, inv_dir, limit, COMPACT_STAGES[0][0])

    # stage 2: bounded at reduced width
    w2 = max(2048, n // COMPACT_STAGES[0][1])
    order = jnp.argsort(state[0] < 0)
    sel2 = order[:w2]
    sub_ray, sub_inv, sub_limit = gather_sub(sel2)
    sub_state = tuple(a[sel2] for a in state)
    sub_state = run_bounded(sub_state, sub_ray, sub_inv, sub_limit, COMPACT_STAGES[1][0])
    state = tuple(a.at[sel2].set(b) for a, b in zip(state, sub_state))

    # final stage: fixpoint at 1/16 width
    w3 = max(2048, n // COMPACT_STAGES[1][1])

    def outer_cond(state):
        return jnp.any(state[0] >= 0)

    def outer_body(state):
        order = jnp.argsort(state[0] < 0)  # active lanes first (stable)
        sel = order[:w3]
        sub_ray, sub_inv, sub_limit = gather_sub(sel)
        sub_state = tuple(a[sel] for a in state)
        sub_state = run_to_end(sub_state, sub_ray, sub_inv, sub_limit)
        return tuple(a.at[sel].set(b) for a, b in zip(state, sub_state))

    state = jax.lax.while_loop(outer_cond, outer_body, state)
    return state[3], state[4], state[5], state[6], state[7]


def _traverse_step(state, ray, inv_dir, limit, nodes, leaves, t_min, any_hit, depth_iota,
                   o6=None, inv6=None):
    n = ray.origin.shape[0]
    cur, sp, stack, time, tri, bu, bv, bw = state
    active = cur >= 0
    row = jnp.take(nodes, jnp.maximum(cur, 0), axis=0)  # ONE gather

    if o6 is None:
        o6 = jnp.concatenate([ray.origin.to_array()] * 2, axis=1)
        inv6 = jnp.concatenate([inv_dir.to_array()] * 2, axis=1)

    # slab test: two coarse slices, child-major (n, 2, 3) reduce
    t1 = (row[:, 0:6] - o6) * inv6
    t2 = (row[:, 6:12] - o6) * inv6
    lo = jnp.minimum(t1, t2)
    hi = jnp.maximum(t1, t2)
    lo = jnp.where(jnp.isnan(lo), -INF, lo)
    hi = jnp.where(jnp.isnan(hi), INF, hi)
    enter = lo.reshape(n, 2, 3).max(-1)  # (n, 2)
    exit_ = hi.reshape(n, 2, 3).min(-1)

    pm = row[:, 12:16].astype(jnp.int32)  # [Lptr, Rptr, Lmeta, Rmeta]
    ptr = pm[:, 0:2]
    meta = pm[:, 2:4]

    cutoff = jnp.minimum(time, limit)
    hit2 = (
        (enter <= exit_)
        & (exit_ >= t_min)
        & (enter <= cutoff[:, None])
        & (meta >= 0)
        & active[:, None]
    )

    l_hit, r_hit = hit2[:, 0], hit2[:, 1]
    l_enter, r_enter = enter[:, 0], enter[:, 1]
    lptr, rptr = ptr[:, 0], ptr[:, 1]
    lmeta, rmeta = meta[:, 0], meta[:, 1]

    # leaf children: one masked leaf-row gather each
    time, tri, bu, bv, bw = _leaf_intersect(
        leaves, l_hit & (lmeta > 0), lptr, lmeta, ray, t_min, time, tri, bu, bv, bw
    )
    time, tri, bu, bv, bw = _leaf_intersect(
        leaves, r_hit & (rmeta > 0), rptr, rmeta, ray, t_min, time, tri, bu, bv, bw
    )

    # internal children: ordered descent + push the farther one
    want_l = l_hit & (lmeta == 0)
    want_r = r_hit & (rmeta == 0)
    both = want_l & want_r
    l_near = l_enter <= r_enter
    first = jnp.where(want_l & (~want_r | l_near), lptr, rptr)
    second = jnp.where(l_near, rptr, lptr)

    # dense one-hot stack ops instead of XLA scatter/gather.
    # stack depth is an exact host-computed bound (pack_bvh), so overflow
    # is impossible for well-formed trees; the guards below additionally
    # make the step safe (drop push / terminate lane) rather than silently
    # clobbering slots or redirecting to the root on a zero one-hot sum.
    depth = stack.shape[1]
    can_push = both & (sp < depth)
    at_sp = depth_iota == jnp.minimum(sp, depth - 1)[:, None]
    stack = jnp.where(at_sp & can_push[:, None], second[:, None], stack)
    sp_after_push = sp + can_push

    descend = want_l | want_r
    do_pop = active & ~descend
    at_top = depth_iota == (sp_after_push - 1)[:, None]
    popped = jnp.sum(jnp.where(at_top, stack, 0), axis=1)
    pop_ok = (sp_after_push > 0) & (sp_after_push <= depth)
    new_cur = jnp.where(
        ~active, cur, jnp.where(descend, first, jnp.where(pop_ok, popped, -1))
    )
    new_sp = jnp.where(do_pop, jnp.maximum(sp_after_push - 1, 0), sp_after_push)
    if any_hit:
        new_cur = jnp.where(time < limit, -1, new_cur)
    return new_cur, new_sp, stack, time, tri, bu, bv, bw


DENSE_TRI_ROWS = 8  # scenes with <= 8 leaf rows (64 tris) skip the BVH


def dense_tri_hit(bvh: BVHTables, ray: Ray, t_min, best: Hit) -> Hit:
    """Gather-free path for tiny meshes (e.g. Cornell's 14 wall triangles):
    every leaf row is a static slice broadcast against the wavefront — pure
    fused elementwise math, no traversal loop."""
    n = ray.origin.shape[0] if ray.origin.shape else ()
    n_rows = bvh.leaves.shape[0]
    time = best.time
    tri = jnp.full(n, -1, jnp.int32)
    z = jnp.zeros(n, DTYPE)
    bu = bv = bw = z
    ones = jnp.ones(n, bool)
    counts = jnp.full(n, LEAF_TRIS, jnp.int32)
    for row_i in range(n_rows):
        leaf_row = jax.lax.broadcast_in_dim(
            bvh.leaves[row_i], (n, bvh.leaves.shape[1]), (1,)
        )
        time, tri, bu, bv, bw = _leaf_rows_test(
            leaf_row, ones, counts, ray, t_min, time, tri, bu, bv, bw
        )
    return _finish_hit(bvh, best, time, tri, bu, bv, bw)


def _finish_hit(bvh: BVHTables, best: Hit, time, tri, u, v, w) -> Hit:
    improved = time < best.time
    srow = jnp.take(bvh.shade, jnp.maximum(tri, 0), axis=0)
    n1 = Vec3(srow[:, 0], srow[:, 1], srow[:, 2])
    n2 = Vec3(srow[:, 3], srow[:, 4], srow[:, 5])
    n3 = Vec3(srow[:, 6], srow[:, 7], srow[:, 8])
    normal = (n1 * u + n2 * v + n3 * w).normalize()
    mat = srow[:, 9].astype(jnp.int32)
    return Hit(
        jnp.where(improved, time, best.time),
        where(improved, normal, best.normal),
        jnp.where(improved, mat, best.material),
    )


# tile path engages only for big meshes and wide wavefronts, where the
# cluster machinery beats per-ray descent (PERF.md)
TILED_MIN_RAYS = 4096


# NB: a dense per-ray super-sphere miss cull was tried here and removed —
# every bounce/shadow ray starts ON the mesh inside its own super-sphere,
# so it culled ~nothing (PERF.md, incoherent-wavefront wall).


def bvh_closest_hit(bvh: BVHTables, ray: Ray, t_min, best: Hit,
                    clusters=None, coherent: bool = True) -> Hit:
    """Closest-hit query (see `mesh_closest`); shading attributes for the
    winning triangle are fetched at the end."""
    if bvh.leaves.shape[0] <= DENSE_TRI_ROWS:
        return dense_tri_hit(bvh, ray, t_min, best)
    time, tri, u, v, w = mesh_closest(bvh, ray, t_min, best.time, clusters, coherent)
    return _finish_hit(bvh, best, time, tri, u, v, w)


def mesh_closest(bvh: BVHTables, ray: Ray, t_min, best_time, clusters=None,
                 coherent: bool = True):
    """Closest triangle hit -> ``(time, tri, u, v, w)``; ``tri`` is -1
    where no triangle beats ``best_time``. Big meshes + wide COHERENT
    wavefronts (camera rays — ``coherent`` is the caller's static hint)
    take the tile-binned fat-cluster path (rpt_tpu.tiled) with an exact
    per-ray certificate, then the deferred wide-tree traversal finishes
    uncertified lanes. Incoherent wavefronts (bounce rays) skip the tile
    pass entirely — hemisphere tiles certify 0% — and go straight to the
    deferred traversal. Without clusters, or on narrow wavefronts, the
    exact short-stack `_traverse` answers."""
    n = ray.origin.shape[0] if ray.origin.shape else ()
    if clusters is not None and n and n >= TILED_MIN_RAYS:
        from .deferred import deferred_traverse

        if coherent:
            from .tiled import tiled_traverse

            time, tri, u, v, w, certified = tiled_traverse(
                clusters, ray, t_min, INF, best_time, any_hit=False
            )
            t2, tr2, u2, v2, w2 = deferred_traverse(
                clusters, ray, t_min, INF, time, any_hit=False,
                active=~certified,
            )
            improved = ~certified & (t2 < time)
            time = jnp.where(improved, t2, time)
            tri = jnp.where(improved, tr2, tri)
            u = jnp.where(improved, u2, u)
            v = jnp.where(improved, v2, v)
            w = jnp.where(improved, w2, w)
            return time, tri, u, v, w
        return deferred_traverse(
            clusters, ray, t_min, INF, best_time, any_hit=False
        )
    return _traverse(
        bvh, ray, t_min, jnp.full(n, INF, DTYPE), best_time, any_hit=False
    )


def tiled_anyhit_prepass(clusters, ray: Ray, t_min, limit_arr, live):
    """Coherent occlusion prepass: argsort the wavefront into tiles
    (origin Morton + direction octant — shadow directions converge on
    one light, so sorted tiles get tight beams) and run the tile-binned
    any-hit. Returns ``(occ, cert)`` in the caller's lane order; lanes
    with ``~cert & ~occ`` still need an exact traversal."""
    from .tiled import coherence_key, tiled_traverse

    n = ray.origin.shape[0]
    key = jnp.where(
        live, coherence_key(ray.origin, ray.dir, mask=live),
        jnp.int32(0x7FFFFFFF),
    )
    order = jnp.argsort(key)
    s_ray = Ray(take(ray.origin, order), take(ray.dir, order))
    s_limit = jnp.where(live, limit_arr, -1.0)[order]
    time_s, _, _, _, _, cert_s = tiled_traverse(
        clusters, s_ray, t_min, s_limit, jnp.full(n, INF, DTYPE),
        any_hit=True,
    )
    occ = jnp.zeros(n, bool).at[order].set(time_s < s_limit)
    cert = jnp.zeros(n, bool).at[order].set(cert_s)
    return occ, cert


def bvh_any_hit(bvh: BVHTables, ray: Ray, t_min, limit, clusters=None,
                coherent: bool = True, skip=None) -> jax.Array:
    """True where some triangle lies at t in [t_min, limit) — early-exit
    occlusion query for shadow rays.

    ``coherent`` is the caller's STATIC hint: camera-level (L0) shadow
    wavefronts tile well after the coherence sort (79-96% certified), but
    bounce-level shadow origins are scattered and certify 0% — for those
    the tile pass is pure cost, so incoherent wavefronts go straight to
    the deferred traversal. ``skip`` marks lanes already known occluded
    (e.g. by an analytic prim); they are excluded from traversal."""
    n = ray.origin.shape[0] if ray.origin.shape else ()
    if bvh.leaves.shape[0] <= DENSE_TRI_ROWS:
        h = dense_tri_hit(bvh, ray, t_min, Hit.none(ray.origin.shape))
        return h.time < limit
    if clusters is not None and n and n >= TILED_MIN_RAYS:
        from .deferred import deferred_traverse

        limit_arr = jnp.broadcast_to(limit, (n,)).astype(DTYPE)
        live = limit_arr > t_min
        if skip is not None:
            live = live & ~skip
        if coherent:
            occ, cert = tiled_anyhit_prepass(clusters, ray, t_min,
                                             limit_arr, live)
            active = live & ~cert & ~occ
        else:
            occ = jnp.zeros(n, bool)
            active = live
        t2, _, _, _, _ = deferred_traverse(
            clusters, ray, t_min, limit_arr, jnp.full(n, INF, DTYPE),
            any_hit=True, active=active,
        )
        return occ | (t2 < limit_arr)
    time, _, _, _, _ = _traverse(
        bvh, ray, t_min, limit, jnp.full(n, INF, DTYPE), any_hit=True
    )
    return time < limit


# ---------------------------------------------------------------------------
# Scene-level closest hit


def closest_hit(scene, tables, ray: Ray, t_min=None, coherent: bool = True) -> Hit:
    """Masked-min over all primitive batches + the triangle BVH — the
    wavefront analog of `Renderer::get_closest_hit` (renderer.rs:416-425).

    ``scene`` is the static CompiledScene (structure), ``tables`` its device
    arrays (pytree). ``coherent`` is a static hint from the caller: True
    for camera-style wavefronts (tile fast path pays off), False for
    bounce/scatter wavefronts (straight to the deferred traversal).
    """
    if t_min is None:
        t_min = scene.t_min
    best = _prim_best(scene, tables, ray, t_min)
    if scene.n_tris:
        best = bvh_closest_hit(
            tables["bvh"], ray, t_min, best, clusters=tables.get("clusters"),
            coherent=coherent,
        )
    return best


def _prim_best(scene, tables, ray: Ray, t_min) -> Hit:
    """Masked-min closest hit over the analytic primitive batches."""
    best = Hit.none(ray.origin.shape)
    if scene.n_spheres:
        best = intersect_spheres(tables["spheres"], ray, t_min, best)
    if scene.n_cubes:
        best = intersect_cubes(tables["cubes"], ray, t_min, best)
    if scene.n_planes:
        best = intersect_planes(tables["planes"], ray, t_min, best)
    if scene.n_monomials:
        best = intersect_monomials(tables["monomials"], ray, t_min, best)
    return best


def prim_occluded(scene, tables, ray: Ray, limit, t_min=None) -> jax.Array:
    """Occlusion by analytic primitives only (the mesh is NOT tested) —
    used by the pooled integrator schedule to resolve prim-shadowed lanes
    before the coherent tile prepass."""
    if t_min is None:
        t_min = scene.t_min
    return _prim_best(scene, tables, ray, t_min).time < limit


def occluded(scene, tables, ray: Ray, limit, t_min=None,
             coherent: bool = True) -> jax.Array:
    """True where any geometry lies at t in [t_min, limit) along the ray —
    the shadow query. Analytic prims reuse the closest-hit testers (cheap);
    the triangle BVH uses the early-exit any-hit traversal. ``coherent``
    is a static hint (see ``bvh_any_hit``); lanes a prim already occludes
    skip the BVH."""
    if t_min is None:
        t_min = scene.t_min
    occ = _prim_best(scene, tables, ray, t_min).time < limit
    if scene.n_tris:
        # any-hit prefers the CT=16 table set when built (drain-phase
        # row cost halves with no best-pruning ramp to lose; PERF.md r5)
        cl = tables.get("clusters_ah") or tables.get("clusters")
        occ = occ | bvh_any_hit(
            tables["bvh"], ray, t_min, limit, clusters=cl,
            coherent=coherent, skip=occ,
        )
    return occ


def _hit_slice(h: Hit, n: int) -> Hit:
    return Hit(
        h.time[:n],
        Vec3(h.normal.x[:n], h.normal.y[:n], h.normal.z[:n]),
        h.material[:n],
    )


def mixed_closest_occluded(scene, tables, ray: Ray, limit, n_closest: int,
                           t_min=None):
    """ONE pooled traversal serving closest-hit lanes [0, n_closest) and
    occlusion lanes [n_closest, N). ``limit`` must be INF on closest
    lanes and the shadow limit (or -1 for disabled lanes) on occlusion
    lanes. Returns ``(Hit over the closest slice, occluded bool over the
    occlusion slice)``.

    Rationale: each deferred-traversal call pays in-graph machinery
    regardless of work, and the integrator used to issue separate
    closest + occlusion calls per
    level. Pooling a level's shadow rays with the NEXT level's bounce
    closest-hit (they are independent given the previous hit) shares
    that cost; per-lane results are unchanged (the traversal is exact
    per lane regardless of pooling), so radiance is bit-identical.
    Reference analog: the per-pixel recursion interleaves these same
    queries (renderer.rs:286-321 + 362-409); pooling is wavefront
    scheduling.
    """
    if t_min is None:
        t_min = scene.t_min
    n = ray.origin.shape[0]
    best = _prim_best(scene, tables, ray, t_min)
    occ_prim = best.time < limit
    if not scene.n_tris:
        return _hit_slice(best, n_closest), occ_prim[n_closest:]
    bvh = tables["bvh"]
    clusters = tables.get("clusters")
    if bvh.leaves.shape[0] <= DENSE_TRI_ROWS:
        h = dense_tri_hit(bvh, ray, t_min, best)
        return _hit_slice(h, n_closest), (h.time < limit)[n_closest:]
    if clusters is not None and n >= TILED_MIN_RAYS:
        from .deferred import deferred_traverse

        is_ah = jnp.arange(n) >= n_closest
        active = ~is_ah | ((limit > t_min) & ~occ_prim)
        best_in = jnp.where(is_ah, INF, best.time)
        time, tri, u, v, w = deferred_traverse(
            clusters, ray, t_min, limit, best_in, any_hit="mixed",
            active=active,
        )
        hit = _finish_hit(
            bvh, _hit_slice(best, n_closest), time[:n_closest],
            tri[:n_closest], u[:n_closest], v[:n_closest], w[:n_closest],
        )
        return hit, (occ_prim | (time < limit))[n_closest:]
    # small/narrow fallback: exact short-stack closest over all lanes
    time, tri, u, v, w = _traverse(
        bvh, ray, t_min, jnp.full(n, INF, DTYPE), best.time, any_hit=False,
    )
    hit = _finish_hit(
        bvh, _hit_slice(best, n_closest), time[:n_closest], tri[:n_closest],
        u[:n_closest], v[:n_closest], w[:n_closest],
    )
    return hit, (occ_prim | (time < limit))[n_closest:]
