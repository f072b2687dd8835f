"""Two-level uniform-grid k-nearest-neighbor queries for photon maps.

Replaces the reference's `kd_tree::KdTree::nearests` photon lookups
(`/root/reference/src/photon.rs:329-342,401-413`): recursive kd descent
per query does not map onto lock-step wavefronts. This design is dense and
multi-pass, sized for CLUSTERED photon clouds (a lamp concentrates most
photons in a small volume while strays land on distant walls — no single
cell size serves both):

* a **fine grid** calibrated to the dense bulk: cell size chosen so the
  99th-percentile 27-cell candidate count stays within a bounded packed
  window. A query packs the 27 neighboring cells' contiguous index runs
  into one tight (n, total_cap) window (gathering only real rows — no
  per-cell-cap padding) and takes the k nearest with ``lax.top_k``.
* queries whose k-th distance exceeds the 3x3x3 box's guaranteed h-ball
  re-run against the fine grid's **5x5x5 box** (coverage 2h).
* queries still uncovered (sparse-region strays) re-run against a
  **coarse grid** calibrated so its 27-cell box holds >= k photons for
  >= 99.5% of samples — compacted to the flagged lanes first, since
  coarse windows are wide.

Every pass's window bound comes from sampled totals at build time;
overflows lose the FARTHEST cells' candidates and the residual
approximation (k-th distance beyond the last pass's coverage ball) is
measured in tests/test_photon.py, never silently ignored.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..dtypes import DTYPE
from ..vec import Vec3

MAX_CELLS = 4_000_000
FINE_WINDOW = 768  # target bound on the fine 27-cell packed window

# RPT_TPU_PHOTON_PROFILE=1: print wall time of each build sub-phase to
# stderr (forces device syncs at the boundaries — measurement only).
import functools as _functools
import os as _os
import sys as _sys
import time as _ptime

_PROF = bool(_os.environ.get("RPT_TPU_PHOTON_PROFILE"))


def _prof(label, t0, *sync):
    if _PROF:
        if sync:
            jax.block_until_ready(sync)
        print(f"  grid-prof {label}: {_ptime.perf_counter() - t0:.2f}s",
              file=_sys.stderr)
    return _ptime.perf_counter()


@dataclass(frozen=True)
class PhotonGridStatic:
    """Host-side two-level grid metadata (static for jit).

    Fine grid: ``origin/inv_h/dims/h/total_cap`` (27-cell window) and
    ``total_cap2`` (5x5x5 window). Coarse grid: ``inv_h2/dims2/h2/
    total_cap3`` (shares ``origin``); ``total_cap3 == 0`` disables the
    coarse pass (uniform clouds where the fine grid already covers).
    ``h`` / ``2h`` / ``h2`` are the passes' guaranteed-coverage radii: a
    k-th distance within the radius proves that pass's result exact."""

    origin: tuple
    inv_h: float
    dims: tuple  # (nx, ny, nz)
    n_photons: int
    truncation_rate: float  # sampled: fraction not covered by ANY pass
    total_cap: int = 768
    h: float = 0.0
    total_cap2: int = 0
    inv_h2: float = 1.0
    dims2: tuple = (1, 1, 1)
    h2: float = 0.0
    total_cap3: int = 0


def _cell_coords(pos: np.ndarray, origin, inv_h, dims):
    c = np.floor((pos - origin) * inv_h).astype(np.int64)
    return np.clip(c, 0, np.asarray(dims) - 1)


def _box_totals(qc: np.ndarray, counts: np.ndarray, dims, rad: int):
    """Per sampled query: photon count in the (2rad+1)^3 cell box."""
    totals = np.zeros(len(qc), np.int64)
    for dx in range(-rad, rad + 1):
        for dy in range(-rad, rad + 1):
            for dz in range(-rad, rad + 1):
                nb = qc + [dx, dy, dz]
                ok = ((nb >= 0) & (nb < dims)).all(1)
                ids = (nb[:, 0] * dims[1] + nb[:, 1]) * dims[2] + nb[:, 2]
                totals += np.where(ok, counts[np.clip(ids, 0, counts.size - 1)], 0)
    return totals


def _grid_for(positions, lo, span, h):
    # keep h >= span/512 so the per-axis 512-cell cap never makes
    # _cell_coords collapse the tail of an axis into its last cell
    h = max(h, float(np.max(span)) / 512.0)
    dims = np.minimum(np.maximum((span / h).astype(np.int64) + 1, 1), 512)
    while int(np.prod(dims)) > MAX_CELLS:
        h *= 1.5
        dims = np.minimum(np.maximum((span / h).astype(np.int64) + 1, 1), 512)
    inv_h = 1.0 / h
    cc = _cell_coords(positions, lo, inv_h, dims)
    cell_id = (cc[:, 0] * dims[1] + cc[:, 1]) * dims[2] + cc[:, 2]
    counts = np.bincount(cell_id, minlength=int(np.prod(dims)))
    return h, dims, inv_h, cell_id, counts


def _window(totals, k, n, hi):
    w = int(np.percentile(totals, 99.0) * 1.3 + 8) if totals.size else hi
    return int(np.clip(-(-w // 8) * 8, min(k, n) + 8, hi))


def _device_cell_ids(pos_dev, origin, inv_h, dims):
    """Device cell ids for the full cloud (f32 arithmetic — the host path
    bins in f64; the two can differ on photons landing within f32 eps of
    a cell boundary, which shifts k-NN candidate windows by at most one
    boundary photon — measured equivalent within the pipeline's sampled
    tolerance, tests/test_photon.py::test_device_grid_build_agrees)."""
    o = jnp.asarray(origin, jnp.float32)
    d = jnp.asarray(dims, jnp.int32)
    c = jnp.floor((pos_dev - o) * jnp.float32(inv_h)).astype(jnp.int32)
    c = jnp.clip(c, 0, d - 1)
    return (c[:, 0] * d[1] + c[:, 1]) * d[2] + c[:, 2]


def _bucket(n: int) -> int:
    """Pad photon-cloud sizes to a power of two (min 8192) so every
    device executable in the build/query pipeline is shared across
    clouds, seeds and scenes: every NEW shape costs a compile, while
    executing a 2M-row sort costs milliseconds — fixed shapes turn the
    whole build into compile-cache hits."""
    return max(8192, 1 << (int(n) - 1).bit_length())


@jax.jit
def _cloud_stats_device(pos_pad, n_real, calib_idx):
    """Masked lo/hi of the real rows + the calibration subsample, in one
    dispatch (the subsample selection mirrors the host path's
    ``positions[::step][:CAL_MAX]`` exactly via ``calib_idx``)."""
    lane = jnp.arange(pos_pad.shape[0], dtype=jnp.int32)[:, None]
    real = lane < n_real
    big = jnp.float32(3.4e38)
    lo = jnp.min(jnp.where(real, pos_pad, big), axis=0)
    hi = jnp.max(jnp.where(real, pos_pad, -big), axis=0)
    calib = jnp.take(pos_pad, calib_idx, axis=0)
    return lo, hi, calib


def _bucket_cells(nc: int) -> int:
    """Bucket the cell-run table length (power-of-4 steps, min 4096,
    capped at MAX_CELLS): the searchsorted query width is baked into the
    executable, so bucketing shares it across scenes while tiny test
    clouds avoid paying a 4M-entry table."""
    b = 4096
    while b < nc and b < MAX_CELLS:
        b *= 4
    return min(b, MAX_CELLS) if nc <= MAX_CELLS else MAX_CELLS


@_functools.partial(jax.jit, static_argnums=(3,))
def _fused_build_device(pos_pad, payload_pad, n_real, ncap, o, inv_h, dims_v,
                        inv_h2, dims2_v, ids1, ok1, ids2, ok2, ids3, ok3):
    """The ENTIRE device-side grid build in one XLA program: both grids'
    cell ids, stable argsorts, bucketed-length (ncap+1, static) cell-run
    starts (sort-based — no scatter-add bincount), the coarse->fine slot map,
    the three sampled box-total calibration reads, and the payload
    reorder. Padded rows get cell id ncap so they sort after every real
    cell and the run table ignores them. One executable serves every
    cloud of the same (row, cell) bucket (dims/origin/cell sizes are
    traced)."""
    nb = pos_pad.shape[0]
    lane = jnp.arange(nb, dtype=jnp.int32)
    pad = lane >= n_real

    def cids(inv, dv):
        c = jnp.floor((pos_pad - o) * inv).astype(jnp.int32)
        c = jnp.clip(c, 0, dv - 1)
        cid = (c[:, 0] * dv[1] + c[:, 1]) * dv[2] + c[:, 2]
        return jnp.where(pad, ncap, cid)

    q = jnp.arange(ncap + 1, dtype=jnp.int32)
    cid = cids(inv_h, dims_v)
    order = jnp.argsort(cid, stable=True)
    starts = jnp.searchsorted(cid[order], q).astype(jnp.int32)
    cid2 = cids(inv_h2, dims2_v)
    order2 = jnp.argsort(cid2, stable=True)
    starts2 = jnp.searchsorted(cid2[order2], q).astype(jnp.int32)
    # coarse-slot -> fine-slot map: inverse-permute the fine order
    # (argsort of a permutation — pure sort+gather, no scatter)
    map2 = jnp.argsort(order).astype(jnp.int32)[order2]

    def boxsum(st, ids, ok):
        v = st[ids + 1] - st[ids]
        return jnp.sum(jnp.where(ok, v, 0), axis=0)

    totals = boxsum(starts, ids1, ok1)
    totals5 = boxsum(starts, ids2, ok2)
    t2 = boxsum(starts2, ids3, ok3)
    sorted_rows = jnp.take(payload_pad, order, axis=0)
    live = (lane < n_real)[:, None]  # pads sort last -> sorted tail
    pos4 = jnp.where(
        live,
        jnp.concatenate(
            [sorted_rows[:, 0:3], jnp.zeros((nb, 1), jnp.float32)], axis=1
        ),
        jnp.float32(1e30),
    )
    pos4_2 = jnp.take(pos4, map2, axis=0)
    return (order.astype(jnp.int32), starts, starts2, map2, totals,
            totals5, t2, sorted_rows, pos4, pos4_2)


def _box_ids_host(qc: np.ndarray, dims, rad: int, ncap: int):
    """Host-side (B, Q) neighbor-cell id/validity tables for the sampled
    box-total reads inside ``_fused_build_device``."""
    r = np.arange(-rad, rad + 1)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    nb = qc[None, :, :] + offs[:, None, :]
    ok = ((nb >= 0) & (nb < np.asarray(dims))).all(-1)
    ids = (nb[..., 0] * dims[1] + nb[..., 1]) * dims[2] + nb[..., 2]
    return (np.clip(ids, 0, ncap - 1).astype(np.int32), ok)


def build_photon_grid(positions, k: int, cap: int = 24,
                      sample_queries: np.ndarray | None = None,
                      payload_rows=None, n_real: int | None = None):
    """Build the two-level photon grid, calibrated for k-NN.

    Returns (static, tables); tables = {"starts", "order", "starts2",
    "map2"} device arrays. Photon payload arrays must be sorted by
    ``order`` by the caller; ``map2`` maps coarse-sorted slots to
    fine-sorted slots (the coarse pass returns indices through it).
    ``cap`` is kept for API compatibility (unused).

    ``positions`` may be a host ndarray (exact f64 binning — the CPU/test
    path) or a device array: then calibration runs on a pulled subsample
    and the full-cloud sort/bin/map construction stays ON DEVICE (the
    multi-M-row device->host pull + host argsort would dominate the
    build), padded to a power-of-two bucket and fused into ONE dispatch
    (`_fused_build_device`) so the executable is shared across
    clouds/seeds/scenes rather than compiled per shape. Device tables are
    BUCKETED: ``order``/``map2`` have bucket length with pads sorted
    last, ``starts``/``starts2`` are fixed length ``MAX_CELLS + 1``.
    ``payload_rows`` (device (n, R) rows) additionally returns
    ``rows``/``pos4``/``pos4_2`` — the payload sorted by ``order`` — from
    the same fused dispatch."""
    on_device = isinstance(positions, jax.Array) and not isinstance(
        positions, np.ndarray
    )
    _t = _ptime.perf_counter()
    if on_device:
        pos_dev = positions.reshape(-1, 3).astype(jnp.float32)
        # n_real marks the valid prefix of a fixed-cap buffer (the
        # count-independent-shape shoot contract); rows beyond it are
        # garbage and masked as pads everywhere below
        n_dev = pos_dev.shape[0] if n_real is None else int(n_real)
        if n_dev == 0:
            positions = np.zeros((0, 3), np.float64)
        else:
            nb = _bucket(n_dev)
            if pos_dev.shape[0] >= nb:
                pos_pad = pos_dev[:nb]
            else:
                pos_pad = jnp.concatenate(
                    [pos_dev,
                     jnp.zeros((nb - pos_dev.shape[0], 3), jnp.float32)]
                )
            # calibration subsample: byte-identical selection to the host
            # path's positions[::step][:200_000]
            step = max(1, n_dev // 200_000)
            calib_idx = jnp.asarray(
                np.arange(0, n_dev, step, dtype=np.int32)[:200_000]
            )
            lo_d, hi_d, calib_d = _cloud_stats_device(
                pos_pad, jnp.int32(n_dev), calib_idx
            )
            # pull raw f32 and cast on the host
            positions = np.asarray(calib_d).astype(np.float64)
            lo_dev = np.asarray(lo_d).astype(np.float64)
            hi_dev = np.asarray(hi_d).astype(np.float64)
        _t = _prof("subsample-pull", _t)
    positions = np.asarray(positions, np.float64).reshape(-1, 3)
    n = n_dev if on_device else len(positions)
    if n == 0:
        static = PhotonGridStatic((0, 0, 0), 1.0, (1, 1, 1), 0, 0.0)
        z = jnp.zeros(2, jnp.int32)
        return static, {
            "starts": z, "order": jnp.zeros(0, jnp.int32),
            "starts2": z, "map2": jnp.zeros(0, jnp.int32),
        }

    lo = lo_dev if on_device else positions.min(0)
    hi = hi_dev if on_device else positions.max(0)
    span = np.maximum(hi - lo, 1e-9)
    vol = float(np.prod(span))
    k_eff = min(k, n)

    if sample_queries is None:
        # positions may be the pulled subsample (device path) — step by
        # its OWN length so we still draw ~512 spread-out queries
        sample_queries = positions[:: max(1, len(positions) // 512)][:512]
    sq = np.asarray(sample_queries, np.float64)

    # Calibration loops bin a SUBSAMPLE of the cloud (counts rescaled):
    # only the h search uses it, so the choice is statistically identical
    # for the 99th-percentile stats it reads, and the full-cloud passes
    # drop from ~2x24 to 2 (multi-second savings on multi-M-photon maps).
    # All correctness-relevant quantities (window caps, coverage, sort)
    # are computed from the FULL grid at the chosen h below.
    CAL_MAX = 200_000
    if on_device:  # positions already IS the pulled subsample
        calib = positions
        cal_scale = n / len(calib)
    elif n > CAL_MAX:
        calib = positions[:: n // CAL_MAX][:CAL_MAX]
        cal_scale = n / len(calib)
    else:
        calib = positions
        cal_scale = 1.0

    # ---- fine grid: bound the dense bulk's 27-cell window --------------
    h = max((vol * 2.5 * k / (27.0 * n)) ** (1.0 / 3.0), 1e-9)
    for _ in range(24):
        h_eff, dims, inv_h, _, counts_s = _grid_for(calib, lo, span, h)
        qc = _cell_coords(sq, lo, inv_h, dims)
        totals = _box_totals(qc, counts_s, dims, 1) * cal_scale
        p99 = np.percentile(totals, 99.0) if totals.size else 0
        if p99 > FINE_WINDOW and np.min(dims) < 512 and h_eff == h:
            h = h_eff / 1.35
            continue
        if p99 <= FINE_WINDOW // 4 and float(np.mean(totals < k_eff)) > 0.5:
            h = h_eff * 1.35
            continue
        h = h_eff
        break
    _t = _prof("fine-calibrate", _t)
    if on_device:
        h, dims, inv_h, _, _ = _grid_for(calib, lo, span, h)
        qc = _cell_coords(sq, lo, inv_h, dims)
    else:
        h, dims, inv_h, cell_id, counts = _grid_for(positions, lo, span, h)
        qc = _cell_coords(sq, lo, inv_h, dims)
        totals = _box_totals(qc, counts, dims, 1)
        totals5 = _box_totals(qc, counts, dims, 2)

    # ---- coarse grid: cover the sparse strays --------------------------
    # sampled queries the fine passes likely can't certify: the runtime
    # flag is (k-th distance > 2h), i.e. < k photons in the 2h-ball; the
    # ball fills ~27% of the 5x5x5 box, so box count < ~4k approximates
    # the flagged set (the coarse window must be sized for ALL of them);
    # on the device path totals come back AFTER the fused build dispatch
    h2 = h * 2.0
    for _ in range(24):
        h2_eff, dims2, inv_h2, _, counts2_s = _grid_for(calib, lo, span, h2)
        qc2 = _cell_coords(sq, lo, inv_h2, dims2)
        t2 = _box_totals(qc2, counts2_s, dims2, 1) * cal_scale
        trunc = float(np.mean(t2 < k_eff))
        if trunc <= 0.005 or np.max(dims2) <= 2:
            h2 = h2_eff
            break
        h2 = h2_eff * 1.5
    _t = _prof("coarse-calibrate", _t)
    if on_device:
        h2, dims2, inv_h2, _, _ = _grid_for(calib, lo, span, h2)
        qc2 = _cell_coords(sq, lo, inv_h2, dims2)
        # ---- ONE fused device dispatch for the whole build ------------
        if payload_rows is not None:
            pay = payload_rows.astype(jnp.float32)
            if pay.shape[0] >= nb:
                pay_pad = pay[:nb]
            else:
                pay_pad = jnp.concatenate(
                    [pay,
                     jnp.zeros((nb - pay.shape[0], pay.shape[1]),
                               jnp.float32)]
                )
        else:
            pay_pad = pos_pad
        ncap = _bucket_cells(max(int(np.prod(dims)), int(np.prod(dims2))))
        ids1, ok1 = _box_ids_host(qc, dims, 1, ncap)
        ids2, ok2 = _box_ids_host(qc, dims, 2, ncap)
        ids3, ok3 = _box_ids_host(qc2, dims2, 1, ncap)
        (order, starts, starts2, map2, totals_d, totals5_d, t2_d,
         sorted_rows, pos4, pos4_2) = _fused_build_device(
            pos_pad, pay_pad, jnp.int32(n_dev), ncap,
            jnp.asarray(lo, jnp.float32), jnp.float32(inv_h),
            jnp.asarray(dims, jnp.int32), jnp.float32(inv_h2),
            jnp.asarray(dims2, jnp.int32),
            jnp.asarray(ids1), jnp.asarray(ok1),
            jnp.asarray(ids2), jnp.asarray(ok2),
            jnp.asarray(ids3), jnp.asarray(ok3),
        )
        totals = np.asarray(totals_d, np.int64)
        totals5 = np.asarray(totals5_d, np.int64)
        t2 = np.asarray(t2_d, np.int64)
        _t = _prof("fused-build", _t)
        total_cap = _window(totals, k, n, 1024)
        total_cap2 = _window(totals5, k, n, 2048)
    else:
        h2, dims2, inv_h2, cell_id2, counts2 = _grid_for(positions, lo, span, h2)
        qc2 = _cell_coords(sq, lo, inv_h2, dims2)
        t2 = _box_totals(qc2, counts2, dims2, 1)
        total_cap = _window(totals, k, n, 1024)
        total_cap2 = _window(totals5, k, n, 2048)
    flagged = totals5 < 4 * k_eff
    trunc = float(np.mean(t2 < k_eff))
    # window from the plausibly-flagged samples (the only coarse users)
    t2f = t2[flagged] if flagged.any() else t2
    total_cap3 = _window(t2f, k, n, 2048)
    if trunc > 0.01:
        import sys

        print(
            f"rpt_tpu: photon k-NN uncovered for {trunc:.1%} of sample "
            f"queries even at coarse cell {h2:.3g}",
            file=sys.stderr,
        )

    if not on_device:
        order = np.argsort(cell_id, kind="stable")
        starts = np.searchsorted(
            cell_id[order], np.arange(int(np.prod(dims)) + 1)
        )
        order2 = np.argsort(cell_id2, kind="stable")
        starts2 = np.searchsorted(
            cell_id2[order2], np.arange(int(np.prod(dims2)) + 1)
        )
        # coarse-slot -> fine-slot map: fine_slot_of_photon[order2]
        fine_slot = np.empty(n, np.int64)
        fine_slot[order] = np.arange(n)
        map2 = fine_slot[order2]

    static = PhotonGridStatic(
        tuple(lo), float(inv_h), tuple(int(d) for d in dims), n, trunc,
        total_cap, float(h), total_cap2, float(inv_h2),
        tuple(int(d) for d in dims2), float(h2), int(total_cap3),
    )
    tables = {
        "starts": jnp.asarray(starts, jnp.int32),
        "order": jnp.asarray(order, jnp.int32),
        "starts2": jnp.asarray(starts2, jnp.int32),
        "map2": jnp.asarray(map2, jnp.int32),
    }
    if on_device and payload_rows is not None:
        tables["rows"] = sorted_rows
        tables["pos4"] = pos4
        tables["pos4_2"] = pos4_2
    return static, tables


def _packed_topk(starts, pos_rows, query, k, rad, w, live, cells, dims,
                 origin, h):
    """Pack the (2rad+1)^2 neighbor columns' contiguous z-runs into a
    tight (n, w) candidate window and take the k nearest. ``pos_rows``
    are (P, 4) [x, y, z, pad] rows in THIS grid's sort order.

    Returns (idx, d2, r_cov): ``r_cov`` is the per-lane EXACT covered
    radius — the distance from the query point to the searched box's
    boundary (negative when the query lies outside the box, e.g. clamped
    cells for queries beyond the photon bbox). A k-th distance within
    r_cov proves the result exact; anything else must escalate."""
    n = query.x.shape[0]
    cx, cy, cz = cells
    nx, ny, nz = dims
    ox, oy, oz = origin

    def cov_axis(q, c, d, o):
        lo_box = o + jnp.maximum(c - rad, 0).astype(DTYPE) * h
        hi_box = o + (jnp.minimum(c + rad, d - 1) + 1).astype(DTYPE) * h
        return jnp.minimum(q - lo_box, hi_box - q)

    r_cov = jnp.minimum(
        cov_axis(query.x, cx, nx, ox),
        jnp.minimum(cov_axis(query.y, cy, ny, oy), cov_axis(query.z, cz, nz, oz)),
    )

    def axis_gap(q, c, d_off, o):
        # distance from q to the (c+d_off) column band along one axis
        lo_band = o + (c + d_off).astype(DTYPE) * h
        hi_band = lo_band + h
        return jnp.where(
            d_off == 0, 0.0, jnp.where(d_off < 0, q - hi_band, lo_band - q)
        )

    # columns CENTER-FIRST so window overflow sacrifices the farthest
    # columns; the per-lane certificate then shrinks to the first dropped
    # column's distance instead of collapsing to zero
    offsets = sorted(
        ((dx, dy) for dx in range(-rad, rad + 1) for dy in range(-rad, rad + 1)),
        key=lambda p: (max(abs(p[0]), abs(p[1])), abs(p[0]) + abs(p[1])),
    )
    col_s = []
    col_len = []
    col_dist = []
    for dx, dy in offsets:
        x = cx + dx
        y = cy + dy
        in_bounds = (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & live
        z0 = jnp.maximum(cz - rad, 0)
        z1 = jnp.minimum(cz + rad, nz - 1)
        base = (x * ny + y) * nz
        s = jnp.take(starts, jnp.clip(base + z0, 0, starts.shape[0] - 1))
        e = jnp.take(starts, jnp.clip(base + z1 + 1, 0, starts.shape[0] - 1))
        col_s.append(s)
        col_len.append(jnp.where(in_bounds, jnp.maximum(e - s, 0), 0))
        gx = jnp.maximum(axis_gap(query.x, cx, jnp.int32(dx), ox), 0.0)
        gy = jnp.maximum(axis_gap(query.y, cy, jnp.int32(dy), oy), 0.0)
        col_dist.append(jnp.sqrt(gx * gx + gy * gy))
    # ---- BLOCKED window assembly -------------------------------------
    # Each column is a CONTIGUOUS run [s, e) in this grid's sort order,
    # so candidates are fetched as aligned 8-photon component-major
    # blocks ([x*8|y*8|z*8|pad*8] = 32 f32): 8x fewer gather rows, and
    # the gather output tiles at (., 32) -> 4x padding instead of the
    # per-element (., 4) rows' 32x (a (n*w, 4) f32 gather padded to
    # (n*w, 128) OOM'd real photon wavefronts).
    p8 = -(-pos_rows.shape[0] // 8)
    pad = p8 * 8 - pos_rows.shape[0]
    if pad:
        pos_rows = jnp.concatenate(
            [pos_rows, jnp.full((pad, 4), 1e30, pos_rows.dtype)]
        )
    pos_blk = (
        pos_rows.reshape(p8, 8, 4).transpose(0, 2, 1).reshape(p8, 32)
    )
    nb = len(col_s)
    b_s = [col_s[j] >> 3 for j in range(nb)]
    b_len = [
        jnp.where(
            col_len[j] > 0,
            ((col_s[j] + col_len[j] + 7) >> 3) - b_s[j],
            0,
        )
        for j in range(nb)
    ]
    blens = jnp.stack(b_len, axis=1)
    boffs = jnp.cumsum(blens, axis=1) - blens  # exclusive prefix
    btotal = boffs[:, -1] + blens[:, -1]
    wb = w // 8 + 2 * nb  # element window in blocks + alignment spill

    biota = jax.lax.broadcasted_iota(jnp.int32, (n, wb), 1)
    bidx = jnp.zeros((n, wb), jnp.int32)
    sel_s = jnp.zeros((n, wb), jnp.int32)
    sel_e = jnp.zeros((n, wb), jnp.int32)
    for j in range(nb):
        o = boffs[:, j][:, None]
        m = (biota >= o) & (biota < o + b_len[j][:, None])
        bidx = jnp.where(m, b_s[j][:, None] + (biota - o), bidx)
        sel_s = jnp.where(m, col_s[j][:, None], sel_s)
        sel_e = jnp.where(m, (col_s[j] + col_len[j])[:, None], sel_e)
    ok_blk = biota < jnp.minimum(btotal, wb)[:, None]

    # overflow certificate: min distance over columns not fully kept
    dropped = jnp.stack(
        [boffs[:, j] + b_len[j] > wb for j in range(nb)], axis=1
    )
    dist_mat = jnp.stack(col_dist, axis=1)
    r_over = jnp.min(jnp.where(dropped, dist_mat, jnp.inf), axis=1)
    r_cov = jnp.minimum(r_cov, r_over)

    blk = jnp.take(pos_blk, bidx.reshape(-1), axis=0).reshape(n, wb, 4, 8)
    slot8 = jax.lax.broadcasted_iota(jnp.int32, (n, wb, 8), 2)
    g = (bidx * 8)[:, :, None] + slot8  # global photon element ids
    valid_e = (
        (g >= sel_s[:, :, None]) & (g < sel_e[:, :, None])
        & ok_blk[:, :, None]
    )
    d2 = (
        (blk[:, :, 0, :] - query.x[:, None, None]) ** 2
        + (blk[:, :, 1, :] - query.y[:, None, None]) ** 2
        + (blk[:, :, 2, :] - query.z[:, None, None]) ** 2
    )
    d2 = jnp.where(valid_e, d2, jnp.inf).reshape(n, wb * 8)
    idx_e = g.reshape(n, wb * 8)
    neg_d2, top_pos = jax.lax.top_k(-d2, k)
    return jnp.take_along_axis(idx_e, top_pos, axis=1), -neg_d2, r_cov


def _fine_cells(static, query):
    nx, ny, nz = static.dims
    ox, oy, oz = static.origin
    inv_h = static.inv_h

    def coord(v, o, d):
        return jnp.clip(jnp.floor((v - o) * inv_h).astype(jnp.int32), 0, d - 1)

    return coord(query.x, ox, nx), coord(query.y, oy, ny), coord(query.z, oz, nz)


def knn_query(static: PhotonGridStatic, tables, pos_rows, query: Vec3, k: int):
    """k-NN per query lane over the two-level grid.

    ``pos_rows``: (P, 4) f32 rows [x, y, z, pad] sorted in FINE grid
    order (each candidate costs ONE row gather). ``tables`` may carry
    ``pos4_2`` (coarse-order positions) to enable the stray pass.
    Returns (idx (n, k) into the fine-sorted arrays, d2 (n, k), valid).
    """
    n = query.x.shape[0]
    if static.n_photons == 0:
        return (
            jnp.zeros((n, k), jnp.int32),
            jnp.full((n, k), jnp.inf, DTYPE),
            jnp.zeros((n, k), bool),
        )
    cells = _fine_cells(static, query)
    live = jnp.ones(n, bool)

    def certified(d2k, r_cov):
        kth = d2k[:, k - 1]
        return jnp.isfinite(kth) & (r_cov > 0.0) & (kth <= r_cov * r_cov)

    top_idx, top_d2, rc1 = _packed_topk(
        tables["starts"], pos_rows, query, k, 1, static.total_cap, live,
        cells, static.dims, static.origin, static.h,
    )
    best_cov = rc1
    flagged = ~certified(top_d2, rc1)

    if static.total_cap2 > 0:
        idx2, d2_2, rc2 = _packed_topk(
            tables["starts"], pos_rows, query, k, 2, static.total_cap2,
            flagged, cells, static.dims, static.origin, static.h,
        )
        cert2 = certified(d2_2, rc2)
        take2 = flagged & (cert2 | (d2_2[:, k - 1] < top_d2[:, k - 1]))
        top_idx = jnp.where(take2[:, None], idx2, top_idx)
        top_d2 = jnp.where(take2[:, None], d2_2, top_d2)
        best_cov = jnp.where(take2, rc2, best_cov)
        flagged = flagged & ~(take2 & cert2)

    pos4_2 = tables.get("pos4_2")
    if static.total_cap3 > 0 and pos4_2 is not None:
        # stray pass on the coarse grid, compacted to flagged lanes first
        # (coarse windows are wide; masked full-width gathers would cost
        # n x total_cap3 row fetches regardless of the flag). The batch
        # LOOPS until every flagged lane is served — a single batch would
        # silently leave overflow lanes (> W flagged) with uncovered
        # fine-grid results, breaking the "never silently ignored" promise.
        W = n if n < 4096 else max(4096, n // 4)
        nx2, ny2, nz2 = static.dims2
        ox, oy, oz = static.origin
        inv_h2 = static.inv_h2

        def coord2(v, o, d):
            return jnp.clip(
                jnp.floor((v - o) * inv_h2).astype(jnp.int32), 0, d - 1
            )

        def stray_batch(carry):
            top_idx, top_d2, rem = carry
            order = jnp.argsort(~rem)
            sel = order[:W]
            subq = Vec3(query.x[sel], query.y[sel], query.z[sel])
            cells2 = (
                coord2(subq.x, ox, nx2), coord2(subq.y, oy, ny2),
                coord2(subq.z, oz, nz2),
            )
            idx3c, d2_3, rc3 = _packed_topk(
                tables["starts2"], pos4_2, subq, k, 1, static.total_cap3,
                rem[sel], cells2, static.dims2, static.origin, static.h2,
            )
            idx3 = jnp.take(tables["map2"], jnp.maximum(idx3c, 0))
            # adopt the coarse result where it certifies or tightens the bound
            cert3 = jnp.isfinite(d2_3[:, k - 1]) & (rc3 > 0.0) & (
                d2_3[:, k - 1] <= rc3 * rc3
            )
            better = rem[sel] & (cert3 | (d2_3[:, k - 1] < top_d2[sel, k - 1]))
            top_idx = top_idx.at[sel].set(
                jnp.where(better[:, None], idx3, top_idx[sel])
            )
            top_d2 = top_d2.at[sel].set(
                jnp.where(better[:, None], d2_3, top_d2[sel])
            )
            rem = rem.at[sel].set(False)
            return top_idx, top_d2, rem

        if W >= n:
            top_idx, top_d2, _ = stray_batch((top_idx, top_d2, flagged))
        else:
            top_idx, top_d2, _ = jax.lax.while_loop(
                lambda c: jnp.any(c[2]), stray_batch, (top_idx, top_d2, flagged)
            )

    valid = jnp.isfinite(top_d2)
    return top_idx, top_d2, valid
