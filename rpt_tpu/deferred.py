"""Deferred-leaf wide-tree traversal — the INCOHERENT-wavefront path.

Replaces the tri-level short-stack fallback (``intersect._traverse``) for
big meshes. Rationale (PERF.md, from the part this was first tuned for):

* where a random row gather costs about the same for ANY row width up to
  512 B, traversal cost is the NUMBER of fetches, not bytes. A wide
  (8/16-ary) cluster tree collapses 3-4 binary levels into one 256-512 B
  row that costs the same to fetch as a 64 B pair row.
* Fat 64-tri cluster rows (1.25-2.5 KB) amortize the gather wall for the
  actual triangle tests, but only when fetched by compacted batches of
  lanes that NEED them.

Design (DESCENT-FIRST two-phase; a host replay of the dragon bounce
wavefront gave +7% node visits, the same 2.7 fat tests/ray, and
candidate-buffer occupancy p99 = 10 against the interleaved schedule):

1. **Phase A — descent to completion.** Walk the wide tree with box-only
   pruning, appending every leaf-hit row as ONE packed candidate group
   ``row_id << W | child_mask``; no fat rows are read. Lanes that finish
   (or fill their buffer — rare at 16 slots) drop out, and the whole
   wavefront compacts down a width ladder as they do, so the lock-step
   tail never pays full width.
2. **Phase B — drain to fixpoint.** Each round a pending lane re-derives
   its nearest group's child bounds (one wide-row refetch), tests the
   nearest surviving cluster's fat row densely, clears that child bit,
   and prunes every group whose entry bound can no longer beat its best.
   Also ladder-compacted: round K runs only on lanes still holding
   beatable candidates. Any-hit lanes stop at the first hit.
3. **Cleanup.** Lanes that stalled on a full buffer (none on the dragon
   wavefronts; possible in adversarial scenes) finish in a classic
   alternating descend/drain fixpoint — a no-op when no lane stalled.

An interleaved schedule (short descent bursts alternating with capped
test bursts, tiered widths) pays the fixed cost per traversal step and
per test round many times over; that cost is sequential-depth-bound, so
the fewer, longer, compacted phases of the two-phase design win. Exact:
every reachable cluster is tested or provably pruned.

Reference analog: the ordered kd descent with t-pruning
(`/root/reference/src/kdtree.rs:154-226`); the wide-node deferral and
two-phase schedule are wavefront-specific.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from .accel.clusters import ClusterTables
from .dtypes import DTYPE, INF
from .ray import Ray
from .tiled import _recover_hit, _tile_tri_test
from .vec import Vec3

# Candidate-group buffer depth. Descent-first needs the buffer to hold a
# whole traversal's groups: dragon bounce wavefront occupancy is mean
# 2.2 / p99 10 / max 15 (host replay); overflow lanes stall and finish in
# the cleanup fixpoint (correct, just slower).
CAND_SLOTS = int(os.environ.get("RPT_TPU_CAND_SLOTS", "16"))
# alternating-fallback burst lengths (small wavefronts + cleanup only)
DESCENT_STEPS = int(os.environ.get("RPT_TPU_DESCENT_STEPS", "6"))
TEST_ROUNDS = int(os.environ.get("RPT_TPU_TEST_ROUNDS", "3"))
# Stage compaction ratio. DIV=16 balances per-rung boundary costs
# (full-width argsort + packed-block gather per rung: 262k->16k->4k is 3
# rungs vs DIV=4's 4) against the extra iterations the widest stage must
# run before its active count fits the next rung. Swept on the earlier
# target; the GPU re-sweep is on the ROADMAP.
LADDER_DIV = int(os.environ.get("RPT_TPU_LADDER_DIV", "16"))
MIN_STAGE = int(os.environ.get("RPT_TPU_MIN_STAGE", "4096"))  # narrowest ladder stage
# Narrow ladder stages are bound by the SEQUENTIAL fixed cost of each
# while_loop iteration, whatever the width below ~32k: running K steps
# per iteration cuts the boundary count K-fold. Steps are no-ops
# for finished lanes, so overshoot only costs (K-1) wasted cheap steps.
UNROLL_WIDTH = int(os.environ.get("RPT_TPU_UNROLL_WIDTH", "32768"))
UNROLL_K = int(os.environ.get("RPT_TPU_UNROLL_K", "4"))
# Dense top-of-tree seeding (zero-gather broadcast tests of the top two
# row-levels; see _dense_top_seed). DEFAULT OFF — measured net-negative
# on the earlier target, full and depth-capped alike: the ~2 gathers/ray
# it saves were swamped by its seeded stack (M = 2*tree_top+1 extra
# columns) widening the packed i32 block that EVERY ladder rung boundary
# gathers and scatters, plus tree_top+1 full-width broadcast slab
# tests. Unmeasured on the GPU (ROADMAP). Seeding stays available
# per-scene.
# "0" = off (default), "1" = full dense seed (all internal root
# children get direct stack entries — M = 2*tree_top+1 extra stack
# columns), N>=2 = DEPTH-
# CAPPED seed: only each lane's nearest N internal root children get
# entry pairs; the rest merge into ONE root-restart entry (re-descends
# those subtrees through the normal gather path when popped). Caps the
# seeded stack at 2N+2 columns, keeping the ~2 gathers/ray the seed
# saves without the packed-block bloat that sank the full seed.
_ts = os.environ.get("RPT_TPU_TOP_SEED", "0")
TOP_SEED = _ts != "0"
TOP_SEED_CAP = None if _ts in ("0", "1") else max(1, int(_ts))

# Root-segment cull: one broadcast slab test of the static root row
# retires lanes whose [t_min, cutoff] segment misses every root child
# before the ladder runs. Exact (the root row's children bound the whole
# mesh) and CPU-exactness-tested, but measured slightly negative on the
# dragon bench on the earlier target: its shadow lanes start on the mesh
# and rarely cull, so the extra full-width test is pure overhead there.
# Default off; enable for scenes whose shadow/closest wavefronts aim far
# off the mesh bbox.
ROOT_CULL = os.environ.get("RPT_TPU_ROOT_CULL", "0") == "1"


def _tree_wide(tree) -> int:
    """Children per wide-tree row, inferred from the static row width
    (rows are [mins 3W][maxs 3W][ptr W][meta W] = 8W floats)."""
    return tree.shape[1] // 8


def _wide_row_test(tree, row_id, mask_bits, o3w, inv3w, t_min, cutoff, live):
    """Fetch one wide row per lane and slab-test its W children.

    Returns (enter, ptr, meta, hit) as (n, W) arrays; ``hit`` respects
    ``mask_bits`` (packed child subset) and the per-lane ``cutoff``."""
    n = row_id.shape[0]
    wide = _tree_wide(tree)
    w3 = 3 * wide
    row = jnp.take(tree, jnp.maximum(row_id, 0), axis=0)
    t1 = (row[:, 0:w3] - o3w) * inv3w
    t2 = (row[:, w3 : 2 * w3] - o3w) * inv3w
    lo = jnp.minimum(t1, t2)
    hi = jnp.maximum(t1, t2)
    lo = jnp.where(jnp.isnan(lo), -INF, lo)
    hi = jnp.where(jnp.isnan(hi), INF, hi)
    enter = lo.reshape(n, 3, wide).max(1)  # (n, W)
    exit_ = hi.reshape(n, 3, wide).min(1)
    ptr = row[:, 6 * wide : 7 * wide].astype(jnp.int32)
    meta = row[:, 7 * wide : 8 * wide].astype(jnp.int32)
    slot8 = jax.lax.broadcasted_iota(jnp.int32, (n, wide), 1)
    in_mask = ((mask_bits[:, None] >> slot8) & 1) == 1
    hit = (
        (enter <= exit_)
        & (exit_ >= t_min)
        & (enter <= cutoff[:, None])
        & (meta >= 0)
        & in_mask
        & live[:, None]
    )
    return enter, ptr, meta, hit, slot8


def _rep3(v: Vec3, wide: int):
    """[x*W | y*W | z*W] slab blocks for a Vec3 of lanes."""
    return jnp.concatenate(
        [jnp.repeat(v.to_array()[:, i : i + 1], wide, axis=1) for i in range(3)],
        axis=1,
    )


def _n_cand(state):
    return jnp.sum(state[5] < INF, axis=1)


def _descend_mask(state):
    cur, _, _, _, _, cand_t, _, done = state
    return (cur >= 0) & (_n_cand(state) < CAND_SLOTS) & ~done


def _ah_lanes(limit_u, any_hit):
    """Per-lane any-hit mask. ``any_hit`` is True, False, or "mixed";
    mixed pools occlusion lanes (finite limit) with closest-hit lanes
    (limit INF) in ONE wavefront so the per-traversal-call machinery is
    paid once."""
    if any_hit == "mixed":
        return limit_u < INF
    return jnp.ones_like(limit_u, bool) if any_hit else None


def _pending_mask(state, limit_u, any_hit):
    cur, _, _, best_u, _, cand_t, _, done = state
    cutoff = jnp.minimum(best_u, limit_u)
    pend = jnp.any(cand_t < cutoff[:, None], axis=1) & ~done
    ah = _ah_lanes(limit_u, any_hit)
    if ah is not None:
        pend &= ~(ah & (best_u < limit_u))
    return pend


def _broadcast_row_test(row, o3w, inv3w, t_min, cutoff, live, wide):
    """_wide_row_test for ONE static row slice broadcast against the
    wavefront — zero gathers. ``row`` is a (8W,) device vector."""
    n = o3w.shape[0]
    w3 = 3 * wide
    t1 = (row[None, 0:w3] - o3w) * inv3w
    t2 = (row[None, w3 : 2 * w3] - o3w) * inv3w
    lo = jnp.minimum(t1, t2)
    hi = jnp.maximum(t1, t2)
    lo = jnp.where(jnp.isnan(lo), -INF, lo)
    hi = jnp.where(jnp.isnan(hi), INF, hi)
    enter = lo.reshape(n, 3, wide).max(1)
    exit_ = hi.reshape(n, 3, wide).min(1)
    ptr = row[6 * wide : 7 * wide].astype(jnp.int32)[None, :]
    meta = row[7 * wide : 8 * wide].astype(jnp.int32)[None, :]
    slot8 = jax.lax.broadcasted_iota(jnp.int32, (n, wide), 1)
    hit = (
        (enter <= exit_)
        & (exit_ >= t_min)
        & (enter <= cutoff[:, None])
        & (meta >= 0)
        & live[:, None]
    )
    return enter, ptr, meta, hit, slot8


def _dense_top_seed(tree, top_internal, uray, inv_dir, t_min, limit_u,
                    best_u0, active, depth, cap=None):
    """Consume the top TWO wide-row levels with ZERO gathers.

    Rows 0..top_internal are static slices (BFS packing puts the root's
    internal children at rows 1..top_internal), so their slab tests
    broadcast against the whole wavefront — the per-lane gather wall
    (~12 ns/lane/row) only starts at level 2. Every lane used to spend
    1 + (entered L1 rows) ≈ 3+ of its ~10 lock-step gather steps here.

    Seeds the traversal state: per entered L1 row, a DIRECT stack entry
    for its nearest internal child (full mask — its row is gathered on
    pop as usual) plus one parent-rest entry for the remaining hit
    children (re-gathered only when popped); root leaf children become a
    root-rest entry. Entries are per-lane sorted far-to-near so pops
    stay nearest-first. Exact: every hit child at seed time is covered
    by exactly one entry, and pops re-apply the live cutoff."""
    n = uray.origin.shape[0]
    wide = _tree_wide(tree)
    full = (1 << wide) - 1
    o3w = _rep3(uray.origin, wide)
    inv3w = _rep3(inv_dir, wide)
    cutoff = jnp.minimum(best_u0, limit_u)

    entries_e = []  # per-lane sort key: enter distance (-INF = no entry)
    entries_v = []  # packed (row << W) | mask
    NEG = jnp.float32(-INF)

    e0, p0, m0, h0, slot8 = _broadcast_row_test(
        tree[0], o3w, inv3w, t_min, cutoff, active, wide
    )
    leaf0 = h0 & (m0 > 0)
    bits0 = jnp.sum(jnp.where(leaf0, 1 << slot8, 0), axis=1)
    e_leaf0 = jnp.min(jnp.where(leaf0, e0, INF), axis=1)
    entries_e.append(jnp.where(bits0 != 0, e_leaf0, NEG))
    entries_v.append(bits0)  # (0 << wide) | bits0

    int0 = h0 & (m0 == 0)
    if cap is not None:
        # Depth-capped seeding: rank each lane's hit internal root
        # children by entry distance ((distance, slot) lexicographic so
        # ranks are unique); only ranks < cap get entry pairs, the rest
        # merge into ONE root-restart entry (popping it re-tests the
        # static root row with exactly those slots and descends them
        # through the normal gather path — exact, every hit child still
        # covered exactly once).
        ei0 = jnp.where(int0, e0, INF)
        lt = (ei0[:, :, None] < ei0[:, None, :]) | (
            (ei0[:, :, None] == ei0[:, None, :])
            & (slot8[:, :, None] < slot8[:, None, :])
        )
        rank = jnp.sum(
            lt & int0[:, :, None] & int0[:, None, :], axis=1
        ).astype(jnp.int32)
        kept = int0 & (rank < cap)
        spilled = int0 & (rank >= cap)
        spill_bits = jnp.sum(jnp.where(spilled, 1 << slot8, 0), axis=1)
        spill_e = jnp.min(jnp.where(spilled, e0, INF), axis=1)
        entries_e.append(jnp.where(spill_bits != 0, spill_e, NEG))
        entries_v.append(spill_bits)  # (0 << wide) | bits — root restart
        pair_e = [jnp.full(n, NEG, e0.dtype) for _ in range(2 * cap)]
        pair_v = [jnp.zeros(n, jnp.int32) for _ in range(2 * cap)]
    else:
        kept = int0
    for r in range(1, top_internal + 1):
        par = kept & (p0 == r)
        par_hit = jnp.any(par, axis=1)
        er, pr, mr, hr, slot8r = _broadcast_row_test(
            tree[r], o3w, inv3w, t_min, cutoff, par_hit, wide
        )
        int_r = hr & (mr == 0)
        ei = jnp.where(int_r, er, INF)
        ni = jnp.argmin(ei, axis=1).astype(jnp.int32)
        has_int = jnp.any(int_r, axis=1)
        near_ptr = jnp.sum(jnp.where(slot8r == ni[:, None], pr, 0), axis=1)
        near_e = jnp.min(ei, axis=1)
        near_e_ent = jnp.where(has_int, near_e, NEG)
        near_v_ent = (near_ptr << wide) | full
        rest = hr & ~(int_r & (slot8r == ni[:, None]))
        rest_bits = jnp.sum(jnp.where(rest, 1 << slot8r, 0), axis=1)
        rest_e = jnp.min(jnp.where(rest, er, INF), axis=1)
        rest_e_ent = jnp.where(rest_bits != 0, rest_e, NEG)
        rest_v_ent = (r << wide) | rest_bits
        if cap is None:
            entries_e.append(near_e_ent)
            entries_v.append(near_v_ent)
            entries_e.append(rest_e_ent)
            entries_v.append(rest_v_ent)
        else:
            # accumulate this row's pair into its per-lane rank slot
            r_rank = jnp.sum(jnp.where(par, rank, 0), axis=1)
            for j in range(cap):
                sel = par_hit & (r_rank == j)
                pair_e[2 * j] = jnp.where(sel, near_e_ent, pair_e[2 * j])
                pair_v[2 * j] = jnp.where(sel, near_v_ent, pair_v[2 * j])
                pair_e[2 * j + 1] = jnp.where(
                    sel, rest_e_ent, pair_e[2 * j + 1]
                )
                pair_v[2 * j + 1] = jnp.where(
                    sel, rest_v_ent, pair_v[2 * j + 1]
                )
    if cap is not None:
        entries_e.extend(pair_e)
        entries_v.extend(pair_v)

    E = jnp.stack(entries_e, axis=1)  # (n, M)
    V = jnp.stack(entries_v, axis=1).astype(jnp.int32)
    M = E.shape[1]
    order = jnp.argsort(-E, axis=1)  # valid far->near, then -INF tail
    Vs = jnp.take_along_axis(V, order, axis=1)
    v_count = jnp.sum(E > NEG, axis=1).astype(jnp.int32)
    top_i = jnp.maximum(v_count - 1, 0)
    cur = jnp.where(
        v_count > 0,
        jnp.take_along_axis(Vs, top_i[:, None], axis=1)[:, 0],
        -1,
    )
    sp = jnp.maximum(v_count - 1, 0)
    stack = jnp.concatenate(
        [Vs, jnp.zeros((n, depth), jnp.int32)], axis=1
    )
    return cur, sp, stack


def _make_descent_step(tree, ray, inv_dir, t_min, limit_u):
    """One wide-node step for every can-descend lane: one <=512 B gather,
    at most one one-hot stack push + one one-hot candidate append; leaf
    rows are never fetched."""
    n = ray.origin.shape[0]
    wide = _tree_wide(tree)
    full = (1 << wide) - 1
    o3w = _rep3(ray.origin, wide)
    inv3w = _rep3(inv_dir, wide)
    cslot_iota = jax.lax.broadcasted_iota(jnp.int32, (n, CAND_SLOTS), 1)

    def step(state):
        cur, sp, stack, best_u, pack, cand_t, cand_id, done = state
        depth = stack.shape[1]
        depth_iota = jax.lax.broadcasted_iota(jnp.int32, (n, depth), 1)
        active = _descend_mask(state)
        row_id = cur >> wide
        mask = cur & full
        cutoff = jnp.minimum(best_u, limit_u)
        enter, ptr, meta, hit, slot8 = _wide_row_test(
            tree, row_id, mask, o3w, inv3w, t_min, cutoff, active
        )

        # ---- candidate group append (all leaf hits, one slot) ----------
        # Append at the FIRST FREE slot, not at the finite count: drains
        # INF-out slots mid-buffer, so finite entries need not form a
        # prefix. The active gate (n_cand < CAND_SLOTS) guarantees a free
        # slot exists.
        leaf_hit = hit & (meta > 0)
        any_leaf = jnp.any(leaf_hit, axis=1)
        g_t = jnp.maximum(jnp.min(jnp.where(leaf_hit, enter, INF), axis=1), t_min)
        g_bits = jnp.sum(jnp.where(leaf_hit, 1 << slot8, 0), axis=1)
        g_id = (row_id << wide) | g_bits
        free = jnp.argmax(cand_t >= INF, axis=1).astype(jnp.int32)
        at = (cslot_iota == free[:, None]) & any_leaf[:, None]
        cand_t = jnp.where(at, g_t[:, None], cand_t)
        cand_id = jnp.where(at, g_id[:, None], cand_id)

        # ---- internal children: descend nearest, push the rest --------
        int_hit = hit & (meta == 0)
        ei = jnp.where(int_hit, enter, INF)
        ni = jnp.argmin(ei, axis=1).astype(jnp.int32)
        has_int = jnp.any(int_hit, axis=1)
        next_ptr = jnp.sum(jnp.where(slot8 == ni[:, None], ptr, 0), axis=1)
        rest_bits = jnp.sum(jnp.where(int_hit, 1 << slot8, 0), axis=1) & ~(
            jnp.where(has_int, 1 << ni, 0)
        )
        push_entry = (row_id << wide) | rest_bits
        do_push = active & (rest_bits != 0) & (sp < depth)
        at_sp = depth_iota == jnp.minimum(sp, depth - 1)[:, None]
        stack = jnp.where(at_sp & do_push[:, None], push_entry[:, None], stack)
        sp_after = sp + do_push

        do_pop = active & ~has_int
        at_top = depth_iota == (sp_after - 1)[:, None]
        popped = jnp.sum(jnp.where(at_top, stack, 0), axis=1)
        pop_ok = (sp_after > 0) & (sp_after <= depth)
        new_cur = jnp.where(
            ~active, cur,
            jnp.where(
                has_int, (next_ptr << wide) | full,
                jnp.where(pop_ok, popped, -1),
            ),
        )
        new_sp = jnp.where(do_pop, jnp.maximum(sp_after - 1, 0), sp_after)
        return (new_cur, new_sp, stack, best_u, pack, cand_t, cand_id, done)

    return step


def _make_prune(limit_u, any_hit):
    def prune(state):
        cur, sp, stack, best_u, pack, cand_t, cand_id, done = state
        cutoff = jnp.minimum(best_u, limit_u)
        keep = cand_t < cutoff[:, None]
        ah = _ah_lanes(limit_u, any_hit)
        if ah is not None:
            keep &= ~(ah & (best_u < limit_u))[:, None]
        cand_t = jnp.where(keep, cand_t, INF)
        return (cur, sp, stack, best_u, pack, cand_t, cand_id, done)

    return prune


def _make_test_round(ct: ClusterTables, ray, dn, inv_dir, t_min, limit_u,
                     any_hit: bool):
    """One drain round: each pending lane re-derives its nearest group's
    child bounds (wide-row refetch), tests the nearest surviving
    cluster's fat row, and clears that child bit. Prunes first."""
    n = ray.origin.shape[0]
    wide = _tree_wide(ct.tree)
    full = (1 << wide) - 1
    o1 = Vec3(ray.origin.x[:, None], ray.origin.y[:, None], ray.origin.z[:, None])
    d1 = Vec3(dn.x[:, None], dn.y[:, None], dn.z[:, None])
    o3w = _rep3(ray.origin, wide)
    inv3w = _rep3(inv_dir, wide)
    cslot_iota = jax.lax.broadcasted_iota(jnp.int32, (n, CAND_SLOTS), 1)
    prune = _make_prune(limit_u, any_hit)

    def round_(state):
        state = prune(state)
        cur, sp, stack, best_u, pack, cand_t, cand_id, done = state
        sel_t = jnp.min(cand_t, axis=1)
        sel_i = jnp.argmin(cand_t, axis=1).astype(jnp.int32)
        at_sel = cslot_iota == sel_i[:, None]
        test = (sel_t < INF) & ~done
        entry = jnp.sum(jnp.where(at_sel, cand_id, 0), axis=1)
        row_id = entry >> wide
        lmask = entry & full
        cutoff = jnp.minimum(best_u, limit_u)
        enter, ptr, meta, hit, slot8 = _wide_row_test(
            ct.tree, row_id, lmask, o3w, inv3w, t_min, cutoff, test
        )
        ei = jnp.where(hit, enter, INF)
        ci = jnp.argmin(ei, axis=1).astype(jnp.int32)
        has = jnp.any(hit, axis=1)
        cid = jnp.sum(jnp.where(slot8 == ci[:, None], ptr, 0), axis=1)

        fat_rows = jnp.take(ct.fat, jnp.where(has, cid, 0), axis=0)
        best1, pack1 = _tile_tri_test(
            fat_rows, o1, d1, t_min, limit_u[:, None], best_u[:, None],
            pack[:, None], cid, has[:, None],
        )
        best_u = best1[:, 0]
        pack = pack1[:, 0]

        # clear the tested child; group bound = min enter of the rest
        rest = jnp.sum(jnp.where(hit, 1 << slot8, 0), axis=1) & ~(
            jnp.where(has, 1 << ci, 0)
        )
        rest_t = jnp.min(
            jnp.where(hit & (slot8 != ci[:, None]), enter, INF), axis=1
        )
        new_t = jnp.where(rest != 0, jnp.maximum(rest_t, t_min), INF)
        new_id = (row_id << wide) | rest
        upd = test[:, None] & at_sel
        cand_t = jnp.where(upd, new_t[:, None], cand_t)
        cand_id = jnp.where(upd, new_id[:, None], cand_id)
        return (cur, sp, stack, best_u, pack, cand_t, cand_id, done)

    return round_


def _descent_burst(tree, ray, inv_dir, t_min, limit_u, state, max_steps):
    """Alternating-fallback descent burst: up to ``max_steps`` steps."""
    step = _make_descent_step(tree, ray, inv_dir, t_min, limit_u)

    def cond(carry):
        state, i = carry
        return jnp.any(_descend_mask(state)) & (i < max_steps)

    state, _ = jax.lax.while_loop(
        cond, lambda c: (step(c[0]), c[1] + 1), (state, jnp.int32(0))
    )
    return state


def _test_burst(ct: ClusterTables, ray, dn, inv_dir, t_min, limit_u, state,
                any_hit: bool, rounds: int | None = None):
    """Alternating-fallback drain burst: up to ``rounds`` rounds."""
    rounds = TEST_ROUNDS if rounds is None else rounds
    round_ = _make_test_round(ct, ray, dn, inv_dir, t_min, limit_u, any_hit)

    def cond(carry):
        state, i = carry
        return jnp.any(_pending_mask(state, limit_u, any_hit)) & (i < rounds)

    state, _ = jax.lax.while_loop(
        cond, lambda c: (round_(c[0]), c[1] + 1), (state, jnp.int32(0))
    )
    return _make_prune(limit_u, any_hit)(state)


def _pack_blocks(state, uray, inv_dir, limit_u):
    """Pack the 8-tuple state + ray fields + limit into ONE f32 and ONE
    i32 matrix. Rung-boundary compaction then costs 2 gathers + 2
    scatters total, instead of ~20 separate ops — the per-op FIXED cost
    (not bytes) dominated the ladder machinery on the earlier target."""
    cur, sp, stack, best_u, pack, cand_t, cand_id, done = state
    fblk = jnp.concatenate(
        [
            best_u[:, None], cand_t,
            uray.origin.x[:, None], uray.origin.y[:, None],
            uray.origin.z[:, None],
            uray.dir.x[:, None], uray.dir.y[:, None], uray.dir.z[:, None],
            inv_dir.x[:, None], inv_dir.y[:, None], inv_dir.z[:, None],
            limit_u[:, None],
        ],
        axis=1,
    )
    iblk = jnp.concatenate(
        [
            cur[:, None], sp[:, None], pack[:, None],
            done[:, None].astype(jnp.int32), stack, cand_id,
        ],
        axis=1,
    )
    return fblk, iblk


def _unpack_blocks(fblk, iblk, depth):
    cs = CAND_SLOTS
    best_u = fblk[:, 0]
    cand_t = fblk[:, 1 : 1 + cs]
    o = Vec3(fblk[:, 1 + cs], fblk[:, 2 + cs], fblk[:, 3 + cs])
    d = Vec3(fblk[:, 4 + cs], fblk[:, 5 + cs], fblk[:, 6 + cs])
    inv = Vec3(fblk[:, 7 + cs], fblk[:, 8 + cs], fblk[:, 9 + cs])
    limit_u = fblk[:, 10 + cs]
    cur = iblk[:, 0]
    sp = iblk[:, 1]
    pack = iblk[:, 2]
    done = iblk[:, 3].astype(bool)
    stack = iblk[:, 4 : 4 + depth]
    cand_id = iblk[:, 4 + depth : 4 + depth + cs]
    state = (cur, sp, stack, best_u, pack, cand_t, cand_id, done)
    return state, Ray(o, d), inv, limit_u


def _run_ladder(state, uray, inv_dir, limit_u, mask_fn, make_runner):
    """Generic width ladder: run ``runner`` (built per stage from the
    stage's ray fields) until the active-lane count fits the next stage,
    compact actives to that width, repeat. Cross-rung state moves as two
    packed matrices (see _pack_blocks); returns the full-width state."""
    n = state[0].shape[0]
    depth = state[2].shape[1]
    sel_abs = None
    sray, sinv, slim = uray, inv_dir, limit_u
    st = state
    full_f = full_i = None
    w = n
    while True:
        next_w = max(MIN_STAGE, w // LADDER_DIV)
        last = next_w >= w
        thresh = 0 if last else next_w
        step1 = make_runner(sray, sinv, slim)
        k = UNROLL_K if w <= UNROLL_WIDTH else 1

        def runner(s, step1=step1, k=k):
            for _ in range(k):
                s = step1(s)
            return s

        def cond(s, thresh=thresh, slim=slim):
            return jnp.sum(mask_fn(s, slim)) > thresh

        st = jax.lax.while_loop(cond, runner, st)
        fblk, iblk = _pack_blocks(st, sray, sinv, slim)
        if sel_abs is None:
            full_f, full_i = fblk, iblk
        else:
            full_f = full_f.at[sel_abs].set(fblk)
            full_i = full_i.at[sel_abs].set(iblk)
        if last:
            break
        prio = jnp.argsort(~mask_fn(st, slim))[:next_w]
        sel_abs = prio if sel_abs is None else sel_abs[prio]
        st, sray, sinv, slim = _unpack_blocks(fblk[prio], iblk[prio], depth)
        w = next_w
    state, _, _, _ = _unpack_blocks(full_f, full_i, depth)
    return state


def deferred_traverse(ct: ClusterTables, ray: Ray, t_min, limit, best_time,
                      any_hit: bool, active=None):
    """Exact closest-hit / any-hit over the fat-cluster tables via the
    wide cluster tree. Returns (time, tri, u, v, w) in the caller's raw
    parametrization; lanes outside ``active`` (or that can't improve)
    return their input ``best_time`` untouched."""
    n = ray.origin.shape[0]
    dlen = ray.dir.length()
    safe = dlen > 0.0
    unit = jnp.abs(dlen - 1.0) < 1e-6
    inv = jnp.where(unit, 1.0, 1.0 / jnp.where(safe, dlen, 1.0))
    dn = ray.dir * inv
    dlen = jnp.where(unit, 1.0, dlen)
    scale = jnp.where(safe, dlen, 1.0)
    best_u0 = jnp.broadcast_to(best_time, (n,)) * scale
    limit_u = jnp.broadcast_to(limit, (n,)).astype(DTYPE) * scale
    if active is None:
        active = jnp.ones(n, bool)
    active = active & safe & (limit_u > t_min)

    uray = Ray(ray.origin, dn)
    inv_dir = Vec3.ones(dn.shape) / dn
    depth = ct.tree_depth

    # Root-segment cull (exact, zero gathers; flag-gated — see ROOT_CULL
    # above): a lane whose [t_min, cutoff] segment misses EVERY child box
    # of the static root row cannot hit the mesh — retire it before the
    # ladder machinery runs.
    if ROOT_CULL and n >= MIN_STAGE:
        wide0 = _tree_wide(ct.tree)
        _, _, _, h0, _ = _broadcast_row_test(
            ct.tree[0], _rep3(uray.origin, wide0), _rep3(inv_dir, wide0),
            t_min, jnp.minimum(best_u0, limit_u), active, wide0,
        )
        active = active & jnp.any(h0, axis=1)

    if TOP_SEED and n >= MIN_STAGE and ct.tree_top > 0:
        # consume the top two row-levels densely (zero gathers)
        cur0, sp0, stack0 = _dense_top_seed(
            ct.tree, ct.tree_top, uray, inv_dir, t_min, limit_u, best_u0,
            active, depth, cap=TOP_SEED_CAP,
        )
    else:
        cur0 = jnp.where(
            active, (1 << _tree_wide(ct.tree)) - 1, -1
        ).astype(jnp.int32)  # cur = root | full mask
        sp0 = jnp.zeros(n, jnp.int32)
        stack0 = jnp.zeros((n, depth), jnp.int32)

    depth = stack0.shape[1]  # seeded stacks are wider than tree_depth
    state = (
        cur0,                                             # cur
        sp0,                                              # sp
        stack0,                                           # stack
        best_u0,                                          # best_u
        jnp.full(n, -1, jnp.int32),                       # pack
        jnp.full((n, CAND_SLOTS), INF, DTYPE),            # cand_t
        jnp.zeros((n, CAND_SLOTS), jnp.int32),            # cand_id
        ~active,                                          # done
    )

    def finish(state, limit_u):
        cur, sp, stack, best_u, pack, cand_t, cand_id, done = state
        done = done | ((cur < 0) & ~jnp.any(cand_t < INF, axis=1))
        ah = _ah_lanes(limit_u, any_hit)
        if ah is not None:
            done = done | (ah & (best_u < limit_u))
        return (cur, sp, stack, best_u, pack, cand_t, cand_id, done)

    def alternating_phase(state, uray=uray, inv_dir=inv_dir, limit_u=limit_u):
        state = _descent_burst(
            ct.tree, uray, inv_dir, t_min, limit_u, state, DESCENT_STEPS
        )
        state = _test_burst(
            ct, uray, uray.dir, inv_dir, t_min, limit_u, state, any_hit
        )
        return finish(state, limit_u)

    def pending_any(state):
        return jnp.any(~state[7])

    if n < MIN_STAGE:
        # small wavefronts: classic alternating fixpoint (every phase
        # makes progress on some pending lane, so it terminates)
        state = jax.lax.while_loop(pending_any, alternating_phase, state)
        best_u, pack = state[3], state[4]
    else:
        # --- Phase A: descent to completion (box-only pruning) ----------
        def make_descender(sray, sinv, slim):
            return _make_descent_step(ct.tree, sray, sinv, t_min, slim)

        state = _run_ladder(
            state, uray, inv_dir, limit_u,
            lambda s, lim: _descend_mask(s), make_descender,
        )

        # --- Phase B: drain to fixpoint (ordered, best-pruned) ----------
        def make_drainer(sray, sinv, slim):
            return _make_test_round(
                ct, sray, sray.dir, sinv, t_min, slim, any_hit
            )

        state = _run_ladder(
            state, uray, inv_dir, limit_u,
            lambda s, lim: _pending_mask(s, lim, any_hit), make_drainer,
        )
        # unbeatable leftovers stay finite in cand_t; prune before the
        # done check so the cleanup fixpoint is a true no-op
        state = _make_prune(limit_u, any_hit)(state)
        state = finish(state, limit_u)

        # --- Cleanup: rare buffer-overflow stalls (usually a no-op) -----
        # A few hundred lanes stall per dragon wavefront; rather than run
        # the alternating fixpoint at full width, compact the not-done
        # lanes to MIN_STAGE per cycle.
        fblk0, iblk0 = _pack_blocks(state, uray, inv_dir, limit_u)

        def cleanup_body(blocks):
            fblk, iblk = blocks
            sel = jnp.argsort(iblk[:, 3])[:MIN_STAGE]  # not-done lanes first
            sub, sub_ray, sub_inv, sub_lim = _unpack_blocks(
                fblk[sel], iblk[sel], depth
            )
            sub = _descent_burst(
                ct.tree, sub_ray, sub_inv, t_min, sub_lim, sub, DESCENT_STEPS
            )
            sub = _test_burst(
                ct, sub_ray, sub_ray.dir, sub_inv, t_min, sub_lim, sub, any_hit
            )
            cur, sp, stack, best_u, pack, cand_t, cand_id, done = sub
            done = done | ((cur < 0) & ~jnp.any(cand_t < INF, axis=1))
            ah = _ah_lanes(sub_lim, any_hit)
            if ah is not None:
                done = done | (ah & (best_u < sub_lim))
            sub = (cur, sp, stack, best_u, pack, cand_t, cand_id, done)
            sf, si = _pack_blocks(sub, sub_ray, sub_inv, sub_lim)
            return fblk.at[sel].set(sf), iblk.at[sel].set(si)

        fblk0, iblk0 = jax.lax.while_loop(
            lambda b: jnp.any(b[1][:, 3] == 0), cleanup_body, (fblk0, iblk0)
        )
        state, _, _, _ = _unpack_blocks(fblk0, iblk0, depth)
        best_u, pack = state[3], state[4]
    if any_hit is True:
        tri = jnp.where(pack >= 0, 0, -1)
        u = v = w = jnp.zeros((n,), DTYPE)
    else:  # closest or mixed: recover the winning triangle's attributes
        tri, u, v, w = _recover_hit(ct.rec, best_u, pack, ray.origin, dn, t_min)
    time = jnp.where(
        pack >= 0,
        best_u / jnp.where(safe, dlen, 1.0),
        jnp.broadcast_to(best_time, (n,)).astype(DTYPE),
    )
    return time, tri, u, v, w
