"""Fat triangle clusters for the tile-binned and deferred traversals.

The tri-level short-stack traversal issues ~9M tiny random row fetches per
dragon wavefront. When XLA's gather costs about the same per row whatever
the row's width (as it did on the part this was first tuned for), FAT rows
amortize that per-row cost and sorting/binning is cheap — so the redesign
trades many tiny dependent fetches for a few fat coherent ones:

* the mesh is cut into **clusters** of <= 64 triangles (tight SAH
  subtrees), each packed into ONE 2.5 KB row (component-major slots, same
  layout discipline as the 8-tri leaf rows);
* a **tile** of 256 coherent rays culls clusters with dense interval
  arithmetic (no tree, no gathers) and fetches candidate fat rows ONCE
  per tile, testing all 256x64 ray-triangle pairs densely.

This module is the host-side build: cut the FlatBVH into clusters and
pack the fat rows + bounding spheres. Replaces the subtree flattening
role of the reference's kd-tree build (`kdtree.rs:238-348`) for the
tile path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import numpy as np

from .bvh import FlatBVH

import os

# Fat-row slot count. 32 -> 1.25 KB rows halve the drain phase's fat-row
# bandwidth vs 64 (2.5 KB) for ~1 extra tree level of node fetches; the
# value was tuned on the earlier target and awaits a GPU re-sweep
# (ROADMAP). Overridable for sweeps; every consumer derives the slot count from the
# static row shapes, so the value is build-time only.
CLUSTER_TRIS = int(os.environ.get("RPT_TPU_CLUSTER_TRIS", "32"))
CLUSTER_ROW = 10 * CLUSTER_TRIS  # v1/e1/e2 component blocks + id block
C_PAD = 128  # cluster count padded for dense (tiles, C) math


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ClusterTables:
    """Fat-cluster tables (device arrays).

    ``fat``: (C, CLUSTER_ROW) f32 — 10 component-major blocks of 64 slots:
    [v1.x*64][v1.y*64][v1.z*64][e1.*64 x3][e2.*64 x3][id*64]; id block
    holds PERMUTED triangle ids (indices into the shared shade table),
    -1 padding.
    ``sph``: (C, 4) f32 — bounding sphere [cx, cy, cz, r]; padding rows
    get far-away spheres that never pass culling.
    ``rec``: (C*64, 12) f32 — per-(cluster, slot) recovery rows
    [v1(3) e1(3) e2(3) id pad pad]: one narrow gather decodes the winning
    slot after the round loop (cheaper than gathering the 2.5 KB fat row
    per ray, and it skips a 656 MB relayout).
    ``sup``: (S, 4) f32 — super-spheres, each bounding 64 consecutive
    clusters. Small enough (S ~ C/64) for an exact per-RAY dense
    line-sphere test: the per-ray rounds path orders candidate supers
    from an (n, S) key matrix, and miss-heavy wavefronts prove "no hit
    anywhere" without touching the tree.
    ``supblk``: (S, 256) f32 — each super's 64 cluster spheres,
    component-major [cx*64|cy*64|cz*64|r*64]: ONE 1 KB gather expands a
    super into its cluster candidates.
    ``tree``: (K, NODE_ROW) f32 — pair-packed BVH whose leaves are whole
    clusters (``pack_cluster_bvh``); the deferred-leaf traversal
    (rpt_tpu.deferred) descends these 64 B rows only, deferring all fat
    2.5 KB reads to compacted test bursts.
    ``tree_depth``: static exact stack bound for that tree.
    ``n_clusters``: real (unpadded) cluster count, static.
    """

    fat: jax.Array
    sph: jax.Array
    rec: jax.Array
    sup: jax.Array
    supblk: jax.Array
    tree: jax.Array
    n_clusters: int = field(default=0, metadata=dict(static=True))
    tree_depth: int = field(default=8, metadata=dict(static=True))
    # number of INTERNAL children of the wide root; BFS packing places
    # them at rows 1..tree_top — the deferred traversal's dense top-seed
    # phase broadcasts those static row slices against the whole
    # wavefront instead of gathering them per lane (deferred.py)
    tree_top: int = field(default=0, metadata=dict(static=True))

SUPER_CLUSTERS = 64  # clusters per super-sphere


def cut_clusters(bvh: FlatBVH, max_tris: int = CLUSTER_TRIS) -> list[np.ndarray]:
    """Cut the tree into disjoint subtrees of <= max_tris triangles,
    returning each cluster's PERMUTED-order triangle slots. Covers every
    triangle exactly once."""
    count = bvh.count.astype(np.int64)
    left, right = bvh.left, bvh.right
    internal = count == 0

    # subtree triangle counts: bounded fixpoint (tree depth <= 64 for sane
    # trees; loop until stable for degenerate ones)
    sub = count.copy()
    for _ in range(256):
        new = np.where(internal, sub[left] + sub[right], sub)
        if np.array_equal(new, sub):
            break
        sub = new

    clusters: list[np.ndarray] = []
    stack = [0]
    while stack:
        i = stack.pop()
        if sub[i] <= max_tris:
            # collect leaf runs under i
            slots = []
            s2 = [i]
            while s2:
                j = s2.pop()
                if count[j] > 0:
                    slots.append(np.arange(bvh.first[j], bvh.first[j] + count[j]))
                else:
                    s2 += [left[j], right[j]]
            clusters.append(np.concatenate(slots))
        else:
            stack += [left[i], right[i]]
    return clusters


def pack_clusters(bvh: FlatBVH, verts: np.ndarray,
                  max_tris: int = CLUSTER_TRIS) -> tuple[np.ndarray, np.ndarray, int]:
    """Pack fat cluster rows + bounding spheres.

    ``verts``: (T, 3, 3) in ORIGINAL order; ``bvh.perm`` is applied here
    (ids stored are permuted slots, matching the shade table order built
    by ``pack_bvh``). Returns (fat, sph, n_clusters) numpy arrays.
    ``max_tris`` sets the fat-row slot count for THIS table set (every
    traversal consumer derives it from the static row shapes, so two
    differently-sized sets can coexist — e.g. a CT=16 any-hit set next
    to the CT=32 closest-hit set).
    """
    ct = int(max_tris)
    crow = 10 * ct
    v = np.asarray(verts, np.float64).reshape(-1, 3, 3)[bvh.perm]
    clusters = cut_clusters(bvh, ct)
    c = len(clusters)
    c_pad = max(C_PAD, -(-c // C_PAD) * C_PAD)

    # (C, 64) slot matrix, then everything vectorizes
    slot_mat = np.full((c_pad, ct), -1, np.int64)
    for ci, slots in enumerate(clusters):
        slot_mat[ci, : len(slots)] = slots
    valid = slot_mat >= 0
    tri = v[np.where(valid, slot_mat, 0)]  # (C, 64, 3, 3)
    v1 = tri[:, :, 0]
    e1 = tri[:, :, 1] - v1
    e2 = tri[:, :, 2] - v1

    fat = np.zeros((c_pad, 10, ct), np.float64)
    for comp, vals in enumerate(
        (v1[..., 0], v1[..., 1], v1[..., 2], e1[..., 0], e1[..., 1], e1[..., 2],
         e2[..., 0], e2[..., 1], e2[..., 2])
    ):
        fat[:, comp] = np.where(valid, vals, 0.0)
    fat[:, 9] = slot_mat
    fat = fat.reshape(c_pad, crow).astype(np.float32)

    # padding clusters: far away, zero radius -> never pass culling
    sph = np.zeros((c_pad, 4), np.float32)
    sph[:, 0:3] = 1e30
    # real clusters always have >= 1 valid slot, so nan-reduces are safe
    pts = np.where(valid[:c, :, None, None], tri[:c], np.nan).reshape(c, -1, 3)
    center = 0.5 * (np.nanmin(pts, axis=1) + np.nanmax(pts, axis=1))
    r = np.sqrt(np.nanmax(np.nan_to_num((pts - center[:, None]) ** 2,
                                        nan=0.0).sum(-1), axis=1))
    sph[:c, 0:3] = center
    # inflate for f32 rounding in the device-side interval culling
    sph[:c, 3] = r * (1.0 + 1e-5) + 1e-6

    rec = np.zeros((c_pad * ct, 12), np.float32)
    rec[:, 0:3] = np.where(valid[..., None], v1, 0.0).reshape(-1, 3)
    rec[:, 3:6] = np.where(valid[..., None], e1, 0.0).reshape(-1, 3)
    rec[:, 6:9] = np.where(valid[..., None], e2, 0.0).reshape(-1, 3)
    rec[:, 9] = slot_mat.reshape(-1)

    # super-spheres over groups of SUPER_CLUSTERS consecutive clusters
    # (tree order = spatially coherent); padding supers never pass
    s = -(-c // SUPER_CLUSTERS)
    s_pad = max(128, -(-s // 128) * 128)
    sup = np.zeros((s_pad, 4), np.float32)
    sup[:, 0:3] = 1e30
    cc = sph[:c, 0:3].astype(np.float64)
    cr = sph[:c, 3].astype(np.float64)
    for si in range(s):
        seg = slice(si * SUPER_CLUSTERS, min((si + 1) * SUPER_CLUSTERS, c))
        lo = (cc[seg] - cr[seg, None]).min(0)
        hi = (cc[seg] + cr[seg, None]).max(0)
        center = 0.5 * (lo + hi)
        rad = (np.linalg.norm(cc[seg] - center, axis=1) + cr[seg]).max()
        sup[si, 0:3] = center
        sup[si, 3] = rad * (1.0 + 1e-5) + 1e-6

    # per-super cluster-sphere blocks, component-major
    sph_full = np.zeros((s_pad * SUPER_CLUSTERS, 4), np.float32)
    sph_full[:, 0:3] = 1e30
    sph_full[: len(sph)] = sph
    supblk = (
        sph_full.reshape(s_pad, SUPER_CLUSTERS, 4)
        .transpose(0, 2, 1)
        .reshape(s_pad, 4 * SUPER_CLUSTERS)
        .copy()
    )

    # cluster AABBs + tri counts for the fat-leaf cluster BVH
    bb_lo = np.nanmin(pts, axis=1)
    bb_hi = np.nanmax(pts, axis=1)
    tri_counts = valid[:c].sum(1)
    return fat, sph, rec, sup, supblk, (bb_lo, bb_hi, tri_counts), c


WIDE = int(os.environ.get("RPT_TPU_TREE_WIDE", "16"))  # children per wide-tree node
WIDE_ROW = 8 * WIDE  # [minx*8][miny*8][minz*8][maxx*8][maxy*8][maxz*8][ptr*8][meta*8]


def pack_wide_cluster_tree(bb_lo, bb_hi, tri_counts, wide: int = WIDE):
    """Collapse the binary cluster BVH into a ``wide``-ary tree of
    ``wide``-child rows (256 B at wide=8, 512 B at wide=16).

    Rationale: where a random gather costs about the same per row for any
    row <= 512 B (true of the part this was first tuned for; unmeasured on
    the GPU), one 256-512 B fetch testing 8-16 children costs what one
    64 B pair-packed fetch testing two does.
    Incoherent bounce rays touch ~25 binary cluster nodes (fat boxes
    prune weakly); the wide collapse cuts fetches ~2-3x and shrinks the
    slow-lane tail the same way.

    Row layout (component-major, consumed as coarse lane slices), W=wide:
      [0:3W)   mins  (x*W | y*W | z*W)
      [3W:6W)  maxs
      [6W:7W)  ptr   (leaf: cluster id; internal: wide node id)
      [7W:8W)  meta  (>0: leaf with that many tris, 0: internal, -1: empty)

    Returns (rows, stack_depth) where stack_depth is the exact bound on
    (row, mask) stack occupancy (<= one push per tree level).
    """
    from .bvh import build_bvh

    bvh = build_bvh(bb_lo, bb_hi, leaf_size=1)
    count = bvh.count.astype(np.int64)
    left, right = bvh.left.astype(np.int64), bvh.right.astype(np.int64)
    internal = count == 0
    # subtree primitive counts (bounded fixpoint, as cut_clusters)
    sub = count.copy()
    for _ in range(256):
        new = np.where(internal, sub[left] + sub[right], sub)
        if np.array_equal(new, sub):
            break
        sub = new

    def expand(i):
        """Binary node -> up to ``wide`` subtree roots (greedy: split the
        biggest remaining internal root until the slots are used)."""
        if not internal[i]:
            return [i]
        roots = [left[i], right[i]]
        while len(roots) < wide:
            cand = [r for r in roots if internal[r]]
            if not cand:
                break
            big = max(cand, key=lambda r: sub[r])
            roots.remove(big)
            roots += [left[big], right[big]]
        return roots

    rows_children = []  # per wide node: list of binary root ids
    wide_id = {}
    queue = [0]
    wide_id[0] = 0
    rows_children.append(None)
    head = 0
    while head < len(queue):
        b = queue[head]
        head += 1
        ch = expand(b)
        rows_children[wide_id[b]] = ch
        for c in ch:
            if internal[c]:
                wide_id[c] = len(rows_children)
                rows_children.append(None)
                queue.append(c)

    k = len(rows_children)
    if k > (1 << (31 - wide)):
        # packed row_id << wide | mask cursors must fit int32
        raise ValueError(
            f"wide-{wide} cluster tree too large ({k} rows) for packed "
            "int32 cursors; use a narrower tree"
        )
    rows = np.zeros((k, 8 * wide), np.float32)
    rows[:, 0 : 3 * wide] = 1e30  # empty slots: inverted boxes never hit
    rows[:, 3 * wide : 6 * wide] = -1e30
    rows[:, 7 * wide : 8 * wide] = -1.0  # meta: empty
    for wi, ch in enumerate(rows_children):
        for s, c in enumerate(ch):
            for a in range(3):
                rows[wi, a * wide + s] = bvh.bb_min[c][a]
                rows[wi, 3 * wide + a * wide + s] = bvh.bb_max[c][a]
            if internal[c]:
                rows[wi, 6 * wide + s] = wide_id[c]
                rows[wi, 7 * wide + s] = 0.0
            else:
                cl = bvh.perm[bvh.first[c]]  # leaf_size=1: one cluster
                rows[wi, 6 * wide + s] = cl
                rows[wi, 7 * wide + s] = tri_counts[cl]

    # exact stack bound: deepest wide node + 1 (<= one push per level)
    depth = np.zeros(k, np.int64)
    changed = True
    while changed:
        changed = False
        for wi, ch in enumerate(rows_children):
            for c in ch:
                if internal[c]:
                    ci = wide_id[c]
                    if depth[ci] < depth[wi] + 1:
                        depth[ci] = depth[wi] + 1
                        changed = True
    stack_depth = max(8, int(-(-(int(depth.max()) + 2) // 8) * 8))
    top_internal = sum(1 for c in rows_children[0] if internal[c])
    return rows, stack_depth, top_internal


def pack_cluster_bvh(bb_lo, bb_hi, tri_counts):
    """Build a pair-packed BVH whose LEAVES are whole fat clusters.

    The tree has ~C nodes instead of ~T/4 (dragon: 39k vs 144k), so the
    per-ray node-fetch count — the issue-rate-bound cost of traversing
    incoherent wavefronts (PERF.md) — drops ~2.5x, and each leaf visit
    fetches ONE fat 64-tri row instead of up to 8 small leaf rows.
    Node rows use the exact NODE_ROW layout of `pack_bvh`; leaf ptr is
    the CLUSTER id (row into ClusterTables.fat), meta its triangle count.

    Returns (nodes, stack_depth).
    """
    from ..intersect import NODE_ROW
    from .bvh import build_bvh
    from .bvh import pack_bvh as _  # noqa: F401  (layout contract lives there)

    bvh = build_bvh(bb_lo, bb_hi, leaf_size=1)
    k = bvh.n_nodes
    leaf_mask = bvh.count > 0
    internal_mask = ~leaf_mask
    internal_ids = np.cumsum(internal_mask) - 1
    ii_all = np.nonzero(internal_mask)[0]

    if len(ii_all) == 0:
        nodes = np.zeros((1, NODE_ROW), np.float32)
        nodes[0, 0:3] = bvh.bb_min[0] if k else 0.0
        nodes[0, 3:6] = 1e30
        nodes[0, 6:9] = bvh.bb_max[0] if k else 0.0
        nodes[0, 9:12] = -1e30
        nodes[0, 12] = bvh.perm[bvh.first[0]] if k else 0
        nodes[0, 13] = 0
        nodes[0, 14] = tri_counts[bvh.perm[bvh.first[0]]] if k else -1
        nodes[0, 15] = -1
    else:
        nodes = np.zeros((len(ii_all), NODE_ROW), np.float32)
        for side, child in ((0, bvh.left[ii_all]), (1, bvh.right[ii_all])):
            is_leaf = leaf_mask[child]
            cluster = bvh.perm[bvh.first[child]]  # leaf_size=1: one cluster
            ptr = np.where(is_leaf, cluster, internal_ids[child])
            meta = np.where(is_leaf, tri_counts[cluster], 0)
            nodes[:, 3 * side: 3 * side + 3] = bvh.bb_min[child]
            nodes[:, 6 + 3 * side: 9 + 3 * side] = bvh.bb_max[child]
            nodes[:, 12 + side] = ptr
            nodes[:, 14 + side] = meta

    from .bvh import _required_stack_depth

    return nodes, _required_stack_depth(nodes)
