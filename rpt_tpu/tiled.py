"""Tile-binned fat-cluster traversal — the big-mesh fast path.

Replaces per-ray tree descent (``intersect._traverse``) for large meshes.
Rationale: the tri-level BVH issues ~9M tiny dependent row fetches per
dragon wavefront, and where a random gather costs about the same per row
whatever its width (true of the part this was first tuned for), that
count sets the cost no matter how good the tree is. Fat cluster rows
stream, and dense ray x triangle math is cheap, so this path:

1. groups 256 consecutive rays into a **tile** (the renderer emits pixels
   in Morton order, so consecutive rays are spatially coherent);
2. culls all clusters per tile with **interval arithmetic** over the
   tile's origin/direction boxes vs each cluster's bounding sphere — one
   dense (T, C) pass, no gathers, no tree;
3. walks each tile's candidates in conservative-entry-t order via a
   monotone threshold over quantized ``(t << idbits) | cluster`` keys (no
   top-k, no sort: one masked min-reduction per round);
4. per round fetches ONE fat row per tile and tests all 256x64
   ray-triangle pairs densely (same plane+barycentric algebra as the
   8-wide leaf test, mesh.rs:50-83);
5. certifies each ray exactly: done when its best hit precedes the
   dequantized lower bound of every unprocessed candidate. Uncertified
   rays (incoherent tiles, round-cap overflows) fall back to the exact
   short-stack traversal — the composite is exact for any ray mix.

Tiles are compacted in stages (like the per-ray traversal) so finished
tiles stop paying for the wavefront's stragglers.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .accel.clusters import CLUSTER_TRIS, SUPER_CLUSTERS, ClusterTables
from .dtypes import DTYPE, INF
from .ray import Ray
from .vec import Vec3

TILE = 256
# plain int, NOT jnp.int32: a module-level device constant would
# initialize the default jax backend at import time, before any caller
# can choose the platform (tests/test_import_no_backend.py pins this).
# Python ints are weakly typed, so every use below stays int32.
KEY_MAX = 0x7FFFFFFF
# bounded full/quarter-width stages, then a capped fixpoint at 1/8 width
ROUND_STAGES = ((12, 1), (24, 4))
FIX_DIV = 8
FIX_CAP = 192
# tiles accepting more candidates than this are skipped (uncertified):
# they could never exhaust within the round caps anyway
HOPELESS_CANDIDATES = 96


def _cull_keys(sph, o_c, o_r, axis, cos_t, t_min, limit_hi, qbits, idbits):
    """Per-(tile, cluster) conservative entry-t lower bound, quantized into
    monotone traversal keys.

    The tile is bounded by an origin sphere (center ``o_c``, radius
    ``o_r``) and a direction cone (unit ``axis``, cos half-angle
    ``cos_t``; cos_t <= 0 degenerates to the full sphere — still
    conservative). Cone-vs-sphere with the cluster radius inflated by
    o_r. (A per-axis interval-arithmetic bound was measured 60x looser —
    the independent-axis max of m.d inflates the beam radius by ~|m|
    times the direction spread.)

    All (T, C) dense math; no gathers. Returns (keys, t0, tscale) where
    ``t0 + (key >> idbits) * tscale`` is a certified lower bound on the
    entry t (unit-direction parametrization) of that cluster for EVERY
    ray in the tile.
    """
    m0 = sph[None, :, 0] - o_c[:, 0][:, None]  # (T, C)
    m1 = sph[None, :, 1] - o_c[:, 1][:, None]
    m2 = sph[None, :, 2] - o_c[:, 2][:, None]
    mm = m0 * m0 + m1 * m1 + m2 * m2
    mlen = jnp.sqrt(mm)
    md = (m0 * axis[:, 0][:, None] + m1 * axis[:, 1][:, None]
          + m2 * axis[:, 2][:, None])
    cphi = jnp.clip(md / jnp.maximum(mlen, 1e-20), -1.0, 1.0)
    sphi = jnp.sqrt(jnp.maximum(1.0 - cphi * cphi, 0.0))
    ct = cos_t[:, None]
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    # max/min of m.d over directions within the cone (angle phi +- theta)
    inside = cphi >= ct
    max_md = mlen * jnp.where(inside, 1.0, cphi * ct + sphi * st)
    wrap = ct <= -cphi  # cone reaches past the opposite pole
    min_md = mlen * jnp.where(wrap, -1.0, cphi * ct - sphi * st)

    r = sph[None, :, 3] + o_r[:, None]
    dist2_lb = jnp.maximum(mm - max_md * max_md, 0.0)
    # metric entry bound: a sphere at distance |m| can't be hit before
    # |m| - r, for ANY direction — always >= the directional projection
    # bound (min_md - r), and unlike it stays tight when the cone is wide
    # (wide cones made min_md -> -|m|, which let t_lb collapse to t_min
    # and disabled both the limit cull and the exhaustion certificate)
    t_lb = jnp.maximum(mlen - r, t_min)
    valid = (dist2_lb <= r * r) & (max_md + r >= 0.0) & (t_lb <= limit_hi[:, None])

    t_masked = jnp.where(valid, t_lb, INF)
    t0 = t_masked.min(axis=1)  # (T,)
    any_valid = t0 < INF
    t0 = jnp.where(any_valid, t0, 0.0)
    t1 = jnp.where(valid, t_lb, -INF).max(axis=1)
    t1 = jnp.where(any_valid, t1, 1.0)
    qmax = (1 << qbits) - 1
    tscale = jnp.maximum(t1 - t0, 1e-20) / qmax
    q = jnp.floor((t_lb - t0[:, None]) / tscale[:, None])
    q = jnp.clip(q, 0, qmax).astype(jnp.int32)
    cid = jax.lax.broadcasted_iota(jnp.int32, q.shape, 1)
    keys = jnp.where(valid, (q << idbits) | cid, KEY_MAX)
    return keys, t0, tscale, valid.sum(axis=1)


def _tile_tri_test(fat_rows, o, dn, t_min, limit, best_t, best_pack, cid,
                   test_mask):
    """Dense (T, TILE, 64) plane+barycentric test of one fat cluster row
    per tile against all its rays. Same algebra as the 8-wide leaf test
    (mesh.rs:50-83); t is in unit-direction parametrization.

    The loop carries only (best_t, best_pack) where pack encodes
    cluster*64+slot — profiling showed the earlier per-round one-hot
    pick of tri/u/v/w (a cumsum tie-break + 4 select-reduces over
    (T, 256, 64)) cost ~4.7 ms/round, ~90% of the loop. Triangle id and
    barycentrics are recovered once after the loop (_recover_hit)."""
    T = fat_rows.shape[0]
    # slots per cluster row from the static row width (10 component
    # blocks) — keeps the whole pipeline parametric in CLUSTER_TRIS
    ct = fat_rows.shape[-1] // 10
    f3 = fat_rows.reshape(T, 10, ct)

    def blk(c):  # (T, 1, 64)
        return f3[:, c, :][:, None, :]

    def vec(c0):
        return Vec3(blk(c0), blk(c0 + 1), blk(c0 + 2))

    v1, e1, e2 = vec(0), vec(3), vec(6)

    def rr(x):  # (T, TILE) -> (T, TILE, 1)
        return x[:, :, None]

    ov = Vec3(rr(o.x), rr(o.y), rr(o.z))
    dv = Vec3(rr(dn.x), rr(dn.y), rr(dn.z))

    pn = e1.cross(e2).normalize()
    cosine = pn.dot(dv)
    num = pn.dot(v1 - ov)
    t = num / cosine
    # padding slots are all-zero rows -> pn = 0 -> cosine = 0 -> rejected
    from .intersect import _origin_on_plane

    ok = (
        (jnp.abs(cosine) >= 1e-8)
        & ~_origin_on_plane(num, pn, v1, ov)
        & (t >= t_min)
        & (t < rr(jnp.minimum(best_t, limit)))
        & rr(test_mask)
    )
    p = ov + dv * t
    d2 = p - v1
    d00 = e1.dot(e1)
    d01 = e1.dot(e2)
    d11 = e2.dot(e2)
    d20 = d2.dot(e1)
    d21 = d2.dot(e2)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    ok &= (1.0 - v - w >= 0.0) & (v >= 0.0) & (w >= 0.0)

    t_masked = jnp.where(ok, t, INF)
    slot_t = t_masked.min(axis=2)  # (T, TILE)
    slot_i = jnp.argmin(t_masked, axis=2).astype(jnp.int32)
    better = slot_t < best_t
    pack = cid[:, None] * ct + slot_i
    best_t = jnp.where(better, slot_t, best_t)
    best_pack = jnp.where(better, pack, best_pack)
    return best_t, best_pack


def _recover_hit(rec, best_t, best_pack, o, dn, t_min):
    """One narrow (48 B) recovery-row gather per ray to decode the winning
    (cluster, slot) into (tri_id, u, v, w) — same algebra as the in-loop
    test, evaluated for exactly one triangle per ray."""
    hit = best_pack >= 0
    rows = jnp.take(rec, jnp.maximum(best_pack, 0), axis=0)  # (n, 12)
    v1 = Vec3(rows[:, 0], rows[:, 1], rows[:, 2])
    e1 = Vec3(rows[:, 3], rows[:, 4], rows[:, 5])
    e2 = Vec3(rows[:, 6], rows[:, 7], rows[:, 8])
    tri = jnp.where(hit, rows[:, 9].astype(jnp.int32), -1)

    p = o + dn * best_t
    d2 = p - v1
    d00 = e1.dot(e1)
    d01 = e1.dot(e2)
    d11 = e2.dot(e2)
    d20 = d2.dot(e1)
    d21 = d2.dot(e2)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / jnp.where(denom == 0.0, 1.0, denom)
    w = (d00 * d21 - d01 * d20) / jnp.where(denom == 0.0, 1.0, denom)
    u = 1.0 - v - w
    z = jnp.zeros_like(v)
    return tri, jnp.where(hit, u, z), jnp.where(hit, v, z), jnp.where(hit, w, z)


def tiled_traverse(ct: ClusterTables, ray: Ray, t_min, limit, best_time,
                   any_hit: bool):
    """Returns (time, tri, u, v, w, certified) over the wavefront; ``time``
    is in the caller's raw-direction parametrization. Uncertified lanes
    (round cap hit before the exactness certificate) must be finished by
    the caller."""
    n = ray.origin.shape[0]
    n_tiles = -(-n // TILE)
    pad = n_tiles * TILE - n

    def padded(x, fill_last=True):
        if pad == 0:
            return x
        tail = jnp.broadcast_to(x[-1:], (pad,) + x.shape[1:])
        return jnp.concatenate([x, tail])

    o = ray.origin.map(padded)
    d = ray.dir.map(padded)
    dlen = d.length()
    safe = dlen > 0.0
    # skip renormalizing already-unit dirs (see perray_traverse)
    unit = jnp.abs(dlen - 1.0) < 1e-6
    dn = d * jnp.where(unit, 1.0, 1.0 / jnp.where(safe, dlen, 1.0))
    dlen = jnp.where(unit, 1.0, dlen)
    best0 = padded(jnp.broadcast_to(best_time, (n,)))
    limit_r = padded(jnp.broadcast_to(limit, (n,)).astype(DTYPE))

    def tiles(x):
        return x.reshape(n_tiles, TILE)

    o = o.map(tiles)
    dn = dn.map(tiles)
    dlen = tiles(dlen)
    # unit-direction parametrization for all culling-space comparisons
    best_u = tiles(best0) * dlen
    limit_u = tiles(limit_r) * dlen
    safe = tiles(safe)

    o_lo = jnp.stack([c.min(axis=1) for c in (o.x, o.y, o.z)], axis=1)
    o_hi = jnp.stack([c.max(axis=1) for c in (o.x, o.y, o.z)], axis=1)
    o_c = 0.5 * (o_lo + o_hi)
    o_r = 0.5 * jnp.sqrt(((o_hi - o_lo) ** 2).sum(axis=1))
    d_sum = jnp.stack([c.sum(axis=1) for c in (dn.x, dn.y, dn.z)], axis=1)
    axis = d_sum / jnp.maximum(
        jnp.sqrt((d_sum**2).sum(axis=1, keepdims=True)), 1e-20
    )
    cos_t = jnp.min(
        dn.x * axis[:, 0][:, None] + dn.y * axis[:, 1][:, None]
        + dn.z * axis[:, 2][:, None],
        axis=1,
    )
    cos_t = jnp.clip(cos_t - 1e-6, -1.0, 1.0)  # f32 safety margin

    c_pad = ct.sph.shape[0]
    idbits = max(1, math.ceil(math.log2(c_pad)))
    qbits = 31 - idbits
    keys, t0, tscale, n_cand = _cull_keys(
        ct.sph, o_c, o_r, axis, cos_t, t_min, limit_u.max(axis=1), qbits, idbits
    )

    # incoherent tiles (wide cone and/or fat origin sphere) accept so many
    # candidates that no certificate can fire before the round caps — skip
    # them outright (their rays return uncertified and take the caller's
    # exact fallback) instead of burning rounds on them
    hopeless = (n_cand > HOPELESS_CANDIDATES)[:, None]

    state = (
        jnp.full((n_tiles,), -1, jnp.int32),  # thresh
        best_u,
        jnp.full((n_tiles, TILE), -1, jnp.int32),  # packed cluster*64+slot
        ~safe | hopeless,  # done (= stop processing; NOT the same as certified)
    )

    id_mask = (1 << idbits) - 1

    def make_body(keys, t0, tscale, o, dn, dlen, limit_u):
        def body(state):
            thresh, best_u, pack, done = state
            masked = jnp.where(keys > thresh[:, None], keys, KEY_MAX)
            key_next = masked.min(axis=1)  # (T,)
            exhausted = key_next == KEY_MAX
            cid = key_next & id_mask
            t_next = t0 + (key_next >> idbits).astype(DTYPE) * tscale
            t_next = jnp.where(exhausted, INF, t_next)

            if any_hit:
                done = done | (best_u < limit_u) | (t_next[:, None] >= limit_u)
            else:
                done = done | (best_u <= t_next[:, None])
            tile_live = jnp.any(~done, axis=1) & ~exhausted

            fat_rows = jnp.take(ct.fat, jnp.where(tile_live, cid, 0), axis=0)
            best_u, pack = _tile_tri_test(
                fat_rows, o, dn, t_min, limit_u, best_u, pack, cid,
                tile_live[:, None] & ~done,
            )
            thresh = jnp.where(tile_live, key_next, thresh)
            # exhausted tiles are fully certified
            done = done | exhausted[:, None]
            return thresh, best_u, pack, done

        return body

    def live(state):
        return jnp.any(~state[3])

    consts = (keys, t0, tscale, o, dn, dlen, limit_u)

    def run_bounded(state, consts, max_rounds):
        body = make_body(consts[0], consts[1], consts[2], consts[3], consts[4],
                         consts[5], consts[6])
        state, _ = jax.lax.while_loop(
            lambda c: live(c[0]) & (c[1] < max_rounds),
            lambda c: (body(c[0]), c[1] + 1),
            (state, jnp.int32(0)),
        )
        return state

    def gather_tiles(consts, sel):
        keys, t0, tscale, o, dn, dlen, limit_u = consts
        return (
            keys[sel], t0[sel], tscale[sel],
            Vec3(o.x[sel], o.y[sel], o.z[sel]),
            Vec3(dn.x[sel], dn.y[sel], dn.z[sel]),
            dlen[sel], limit_u[sel],
        )

    if n_tiles <= 8:
        state = run_bounded(state, consts, ROUND_STAGES[0][0] + ROUND_STAGES[1][0] + FIX_CAP)
    else:
        state = run_bounded(state, consts, ROUND_STAGES[0][0])
        # compact live tiles to the front, continue at reduced width
        w2 = max(8, n_tiles // ROUND_STAGES[1][1])
        tile_done = jnp.all(state[3], axis=1)
        order = jnp.argsort(tile_done)
        sel2 = order[:w2]
        sub_state = tuple(a[sel2] for a in state)
        sub_state = run_bounded(sub_state, gather_tiles(consts, sel2), ROUND_STAGES[1][0])
        state = tuple(a.at[sel2].set(b) for a, b in zip(state, sub_state))

        w3 = max(8, n_tiles // FIX_DIV)

        def fix_cond(carry):
            state, r = carry
            return live(state) & (r < FIX_CAP)

        def fix_body(carry):
            state, r = carry
            tile_done = jnp.all(state[3], axis=1)
            order = jnp.argsort(tile_done)
            sel = order[:w3]
            sub = tuple(a[sel] for a in state)
            sub = run_bounded(sub, gather_tiles(consts, sel), 16)
            state = tuple(a.at[sel].set(b) for a, b in zip(state, sub))
            return state, r + 16

        state, _ = jax.lax.while_loop(fix_cond, fix_body, (state, jnp.int32(0)))

    _, best_u, pack, done = state
    certified = done & ~hopeless
    flat = lambda x: x.reshape(-1)[:n]
    pack_f = flat(pack)
    best_u_f = flat(best_u)
    dlen_f = flat(dlen)
    if any_hit:
        # occlusion queries only consume `time < limit`; skip the
        # shading-attribute recovery entirely
        tri = jnp.where(pack_f >= 0, 0, -1)
        u = v = w = jnp.zeros((n,), DTYPE)
    else:
        o_f = ray.origin
        dn_f = Vec3(flat(dn.x), flat(dn.y), flat(dn.z))
        tri, u, v, w = _recover_hit(ct.rec, best_u_f, pack_f, o_f, dn_f, t_min)
    # back to the caller's raw-direction parametrization; lanes the tile
    # path never improved (pack still -1) return the incoming best EXACTLY
    # (the unit-space roundtrip would otherwise perturb it by an ulp and
    # fool the caller's `time < best.time` improvement check)
    time = jnp.where(
        pack_f >= 0,
        best_u_f / jnp.where(dlen_f > 0.0, dlen_f, 1.0),
        flat(tiles(best0)),
    )
    return time, tri, u, v, w, flat(certified)


def _part1by2(x):
    """Spread 9 bits to every 3rd bit of 27 (int32)."""
    x = x & 0x1FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def coherence_key(o: Vec3, d: Vec3, mask=None):
    """Origin-major Morton key (9 bits/axis over the wavefront's own
    bounds) with a 3-bit direction-octant suffix — 30 bits total.

    Sorting a wavefront by this key makes 256 consecutive lanes share a
    small origin cell and a direction octant, which is exactly what the
    tile beam cull needs. Shadow wavefronts (scattered surface origins,
    directions converging on one light) become tileable this way; bounce
    wavefronts don't (hemisphere cones stay hopeless — measured).

    ``mask`` excludes lanes (e.g. dead far-away rays) from the bounds."""
    def bound(c, red, fill):
        return red(jnp.where(mask, c, fill)) if mask is not None else red(c)

    lo = Vec3(
        bound(o.x, jnp.min, INF), bound(o.y, jnp.min, INF), bound(o.z, jnp.min, INF)
    )
    hi = Vec3(
        bound(o.x, jnp.max, -INF), bound(o.y, jnp.max, -INF), bound(o.z, jnp.max, -INF)
    )
    span = jnp.maximum(
        jnp.maximum(hi.x - lo.x, hi.y - lo.y), jnp.maximum(hi.z - lo.z, 1e-20)
    )

    def q(c, l):
        return jnp.clip(((c - l) / span) * 512.0, 0.0, 511.0).astype(jnp.int32)

    m = (
        (_part1by2(q(o.x, lo.x)) << 2)
        | (_part1by2(q(o.y, lo.y)) << 1)
        | _part1by2(q(o.z, lo.z))
    )
    octant = (
        ((d.x > 0).astype(jnp.int32) << 2)
        | ((d.y > 0).astype(jnp.int32) << 1)
        | (d.z > 0).astype(jnp.int32)
    )
    return (m << 3) | octant


# ---------------------------------------------------------------------------
# Per-ray two-level rounds: the INCOHERENT-wavefront path.
#
# Tiles only amortize work rays actually share; bounce/secondary rays from
# surface points share nothing (hemisphere cones accept thousands of
# clusters, and a per-ray MISS can only be proven by exhausting them —
# measured 0% certification). This path instead walks each ray's OWN
# candidates exactly, in metric order, with dense per-ray state:
#
# * an (n, S) int32 key matrix orders candidate SUPER-spheres by the exact
#   per-ray conservative entry bound (|m| - r), walked with the same
#   monotone-threshold min-reduce trick as the tile rounds;
# * expanding a super is ONE 1 KB gather of its 64 cluster spheres,
#   producing an (n, 64) cluster-key row (no queue, no overflow);
# * clusters of the current super are tested against the ray's 64-slot
#   fat row (reusing the tile tri-test with a singleton tile axis);
# * a lane is done when its best hit precedes BOTH the next unexpanded
#   super's bound and the next untested cluster's bound — exact, and
#   reached quickly for misses too (supers exhaust in a few rounds).

# tuned to the measured live-lane decay on bounce wavefronts (flat ~100%
# for ~7 rounds — overlapping super volumes — then halving every ~6)
PERRAY_STAGES = ((8, 1), (8, 2))
PERRAY_FIX_DIV = 4
PERRAY_FIX_CAP = 256


def perray_traverse(ct: ClusterTables, ray: Ray, t_min, limit, best_time,
                    any_hit: bool, active=None):
    """Exact closest-hit/any-hit over the cluster tables, one ray at a
    time (no coherence assumption). Returns (time, tri, u, v, w, done);
    lanes with done=False hit the round cap (pathological candidate
    counts) and must be finished by the caller. ``active`` masks lanes
    that need work at all (others return their input best, done=True)."""
    n = ray.origin.shape[0]
    dlen = ray.dir.length()
    safe = dlen > 0.0
    # skip renormalizing already-unit dirs: the 1-ulp perturbation of
    # d * (1/|d|) flips exact edge hits vs the stack traversal (w ~ 1e-15
    # cases measured), and nearly all callers pass unit directions
    unit = jnp.abs(dlen - 1.0) < 1e-6
    inv = jnp.where(unit, 1.0, 1.0 / jnp.where(safe, dlen, 1.0))
    dn = ray.dir * inv
    dlen = jnp.where(unit, 1.0, dlen)
    best_u0 = jnp.broadcast_to(best_time, (n,)) * jnp.where(safe, dlen, 1.0)
    limit_u = jnp.broadcast_to(limit, (n,)).astype(DTYPE) * jnp.where(safe, dlen, 1.0)
    if active is None:
        active = jnp.ones(n, bool)
    active = active & safe & (limit_u > t_min)

    s_pad = ct.sup.shape[0]
    sbits = max(1, math.ceil(math.log2(s_pad)))
    sqbits = 31 - sbits
    cbits = max(1, math.ceil(math.log2(ct.sph.shape[0])))
    cqbits = 31 - cbits

    # ---- per-ray super keys (n, S) -------------------------------------
    mx = ct.sup[None, :, 0] - ray.origin.x[:, None]
    my = ct.sup[None, :, 1] - ray.origin.y[:, None]
    mz = ct.sup[None, :, 2] - ray.origin.z[:, None]
    b = mx * dn.x[:, None] + my * dn.y[:, None] + mz * dn.z[:, None]
    mm = mx * mx + my * my + mz * mz
    r = ct.sup[None, :, 3]
    t_lb = jnp.maximum(jnp.sqrt(mm) - r, t_min)
    valid = (
        (mm - b * b <= r * r)
        & (b + r >= 0.0)
        & (t_lb <= jnp.minimum(limit_u, best_u0)[:, None])
        & active[:, None]
    )
    t_masked = jnp.where(valid, t_lb, INF)
    t0 = t_masked.min(axis=1)
    has = t0 < INF
    t0 = jnp.where(has, t0, 0.0)
    t1 = jnp.where(valid, t_lb, -INF).max(axis=1)
    t1 = jnp.where(has, t1, 1.0)
    # shared per-ray quantization range for both key levels (cluster
    # bounds within a super can exceed the super-level max; clamp is fine
    # — dequantization floors, so bounds stay conservative)
    sqmax = (1 << sqbits) - 1
    sscale = jnp.maximum(t1 - t0, 1e-20) / sqmax
    q = jnp.clip(jnp.floor((t_lb - t0[:, None]) / sscale[:, None]), 0, sqmax)
    sid_iota = jax.lax.broadcasted_iota(jnp.int32, valid.shape, 1)
    keys_s = jnp.where(valid, (q.astype(jnp.int32) << sbits) | sid_iota, KEY_MAX)

    cqmax = (1 << cqbits) - 1
    cscale = jnp.maximum(t1 - t0, 1e-20) / cqmax

    smask = (1 << sbits) - 1
    cmask = (1 << cbits) - 1

    state = (
        jnp.full((n,), -1, jnp.int32),              # thresh_s
        jnp.full((n, SUPER_CLUSTERS), KEY_MAX, jnp.int32),  # keys_c (current super)
        jnp.full((n,), -1, jnp.int32),              # thresh_c
        best_u0,
        jnp.full((n,), -1, jnp.int32),              # pack
        ~active,                                    # done
    )

    def make_body(keys_s, t0, sscale, cscale, o, dn, limit_u):
        def body(state):
            thresh_s, keys_c, thresh_c, best_u, pack, done = state
            masked_s = jnp.where(keys_s > thresh_s[:, None], keys_s, KEY_MAX)
            s_key = masked_s.min(axis=1)
            s_exh = s_key == KEY_MAX
            t_s = jnp.where(s_exh, INF, t0 + (s_key >> sbits).astype(DTYPE) * sscale)

            masked_c = jnp.where(keys_c > thresh_c[:, None], keys_c, KEY_MAX)
            c_key = masked_c.min(axis=1)
            c_exh = c_key == KEY_MAX
            t_c = jnp.where(c_exh, INF, t0 + (c_key >> cbits).astype(DTYPE) * cscale)

            bound = jnp.minimum(t_s, t_c)
            if any_hit:
                done = done | (best_u < limit_u) | (bound >= limit_u)
            else:
                done = done | (best_u <= bound)

            # expand the next super on lanes with no pending cluster
            adv = ~done & c_exh & ~s_exh
            sid = s_key & smask
            blk = jnp.take(ct.supblk, jnp.where(adv, sid, 0), axis=0)  # (n, 256)
            cx = blk[:, 0:SUPER_CLUSTERS]
            cy = blk[:, SUPER_CLUSTERS: 2 * SUPER_CLUSTERS]
            cz = blk[:, 2 * SUPER_CLUSTERS: 3 * SUPER_CLUSTERS]
            cr = blk[:, 3 * SUPER_CLUSTERS:]
            mx = cx - o.x[:, None]
            my = cy - o.y[:, None]
            mz = cz - o.z[:, None]
            bdt = mx * dn.x[:, None] + my * dn.y[:, None] + mz * dn.z[:, None]
            mm = mx * mx + my * my + mz * mz
            ct_lb = jnp.maximum(jnp.sqrt(mm) - cr, t_min)
            cvalid = (
                (mm - bdt * bdt <= cr * cr)
                & (bdt + cr >= 0.0)
                & (ct_lb <= jnp.minimum(limit_u, best_u)[:, None])
                & adv[:, None]
            )
            cq = jnp.clip(jnp.floor((ct_lb - t0[:, None]) / cscale[:, None]), 0, cqmax)
            cid_g = sid[:, None] * SUPER_CLUSTERS + jax.lax.broadcasted_iota(
                jnp.int32, cvalid.shape, 1
            )
            new_keys_c = jnp.where(
                cvalid, (cq.astype(jnp.int32) << cbits) | cid_g, KEY_MAX
            )
            keys_c = jnp.where(adv[:, None], new_keys_c, keys_c)
            thresh_c = jnp.where(adv, -1, thresh_c)
            thresh_s = jnp.where(adv, s_key, thresh_s)

            # test the next pending cluster — re-extracted AFTER expansion,
            # so a lane that just expanded a super tests its first cluster
            # in the same round (one cluster per round otherwise doubles
            # the round count: rounds ~= supers + clusters per ray)
            masked_c = jnp.where(keys_c > thresh_c[:, None], keys_c, KEY_MAX)
            c_key = masked_c.min(axis=1)
            test = ~done & (c_key != KEY_MAX)
            cid = c_key & cmask
            fat_rows = jnp.take(ct.fat, jnp.where(test, cid, 0), axis=0)
            o1 = Vec3(o.x[:, None], o.y[:, None], o.z[:, None])
            d1 = Vec3(dn.x[:, None], dn.y[:, None], dn.z[:, None])
            best_u1, pack1 = _tile_tri_test(
                fat_rows, o1, d1, t_min, limit_u[:, None], best_u[:, None],
                pack[:, None], cid, test[:, None],
            )
            best_u = best_u1[:, 0]
            pack = pack1[:, 0]
            thresh_c = jnp.where(test, c_key, thresh_c)
            return thresh_s, keys_c, thresh_c, best_u, pack, done

        return body

    def live(state):
        return jnp.any(~state[5])

    consts = (keys_s, t0, sscale, cscale, ray.origin, dn, limit_u)

    def run_bounded(state, consts, max_rounds):
        body = make_body(*consts)
        state, _ = jax.lax.while_loop(
            lambda c: live(c[0]) & (c[1] < max_rounds),
            lambda c: (body(c[0]), c[1] + 1),
            (state, jnp.int32(0)),
        )
        return state

    def gather_lanes(consts, sel):
        keys_s, t0, sscale, cscale, o, dn, limit_u = consts
        return (
            keys_s[sel], t0[sel], sscale[sel], cscale[sel],
            Vec3(o.x[sel], o.y[sel], o.z[sel]),
            Vec3(dn.x[sel], dn.y[sel], dn.z[sel]),
            limit_u[sel],
        )

    if n <= 4096:
        state = run_bounded(state, consts,
                            PERRAY_STAGES[0][0] + PERRAY_STAGES[1][0] + PERRAY_FIX_CAP)
    else:
        state = run_bounded(state, consts, PERRAY_STAGES[0][0])
        w2 = max(2048, n // PERRAY_STAGES[1][1])
        order = jnp.argsort(state[5])  # not-done lanes first
        sel2 = order[:w2]
        sub = tuple(a[sel2] for a in state)
        sub = run_bounded(sub, gather_lanes(consts, sel2), PERRAY_STAGES[1][0])
        state = tuple(a.at[sel2].set(b) for a, b in zip(state, sub))

        w3 = max(2048, n // PERRAY_FIX_DIV)

        def fix_cond(carry):
            return live(carry[0]) & (carry[1] < PERRAY_FIX_CAP)

        def fix_body(carry):
            state, rr = carry
            order = jnp.argsort(state[5])
            sel = order[:w3]
            sub = tuple(a[sel] for a in state)
            sub = run_bounded(sub, gather_lanes(consts, sel), 16)
            state = tuple(a.at[sel].set(b) for a, b in zip(state, sub))
            return state, rr + 16

        state, _ = jax.lax.while_loop(fix_cond, fix_body, (state, jnp.int32(0)))

    _, _, _, best_u, pack, done = state
    if any_hit:
        tri = jnp.where(pack >= 0, 0, -1)
        u = v = w = jnp.zeros((n,), DTYPE)
    else:
        tri, u, v, w = _recover_hit(ct.rec, best_u, pack, ray.origin, dn, t_min)
    time = jnp.where(
        pack >= 0,
        best_u / jnp.where(safe, dlen, 1.0),
        jnp.broadcast_to(best_time, (n,)),
    )
    return time, tri, u, v, w, done
