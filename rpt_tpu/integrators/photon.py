"""Photon mapping: shooting, map building, and the three radiance estimates.

Port of `/root/reference/src/photon.rs` to the wavefront model:

* **Shooting** (photon.rs:655-946): photons shot from the FIRST object
  light (reproducing the reference's FIXME at :725-727), uniform-hemisphere
  emission, recursive bounce with the reference's hardcoded diffuse RR
  p_d = 0.7 (:821-833) on surfaces and sigma_s/sigma_t RR in media. The
  per-ray recursion becomes a bounded scan; deposits stream into fixed-
  capacity device buffers via cursor + prefix-sum scatters (capacity misses
  are counted, never silent).
* **Maps** (photon.rs:185-305): kd-trees become uniform-grid k-NN
  (`rpt_tpu.accel.grid`); the BVH over photon spheres/beams becomes
  chunked dense sweeps (the beam map is tiny after the 0.1% thinning,
  and the sphere sweep is one pass of dense elementwise math).
* **Estimates** (photon.rs:316-628): surface disk estimate with the
  reference's per-photon occlusion recheck (:353-361), point/sphere/beam
  volume estimates with the exact kernels (1/(pi r^2); (4/3) pi r^3;
  eq. 38 of Jarosz et al. with k2(x) = (3/pi)(1-x)^2 and double
  transmittance).

Deliberately-reproduced reference quirks: the emitted term inside the
surface estimate is divided by pi r^2 along with the photon sum (:344-369);
photon deposit happens only on the RR-survive branch (:838-873); volume
photons deposit the PRE-attenuation power (:906-912); the photon camera
pass does no recursion (`_num_bounces` unused, :977-985).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .. import sampling
from ..accel.grid import PhotonGridStatic, build_photon_grid, knn_query
from ..dtypes import DTYPE, INF
from ..intersect import closest_hit, occluded
from ..materials import bsdf, sample_f
from ..ray import Ray
from ..vec import Vec3, take, where

PHOTON_MAP = "photon_map"
POINT_BEAM = "point_beam"
BEAM_BEAM = "beam_beam"

PHOTON_ROW = 12  # [pos(3), dir(3), power(3), start(3)]
PHOTON_CHUNK = 32  # k-NN photons vectorized per scan chunk (surface_estimate)
BEAM_THIN = 0.001  # photon.rs:780 — beam maps keep 0.1% of volume photons


def _find_object_light(scene):
    """First Light::Object (photon.rs:725-798; panics if none)."""
    for i, l in enumerate(scene.lights):
        if l.kind == "object":
            return i, l
    raise RuntimeError("Only found non-object lights while photon mapping")


# ---------------------------------------------------------------------------
# Pass 1: shooting


def shoot_photons_device(scene, tables, key, photon_count: int,
                         watts: float, kind: str, max_depth: int = 48,
                         chunk: int = 1 << 19):
    """Shoot photons; returns ``(surface_rows, n_surface, volume_rows,
    n_volume)`` with DEVICE float32 (cap, PHOTON_ROW) row buffers whose
    first n rows are valid — only the deposit COUNTS cross the
    device->host link per chunk (the rows, ~100 MB per chunk, stay on
    the device). Deposits beyond the per-chunk capacity are counted
    and reported.

    Shapes are COUNT-INDEPENDENT: chunks are equal-sized (one launch
    executable instead of one per remainder size) and chunk results land
    in fixed-cap buffers via dynamic_update_slice at the running count
    (per-count slices + concat would recompile per seed). When
    ``photon_count`` doesn't divide into equal chunks, nchunks*n_eq >=
    photon_count photons are emitted and per-photon power is scaled by
    the true emission count (same convention as the sharded shoot,
    parallel.py) — single-chunk counts are bit-identical to the old
    path."""
    li, light = _find_object_light(scene)
    nchunks = max(1, -(-photon_count // chunk))
    n_eq = -(-photon_count // nchunks)
    power_scalar = watts / (nchunks * n_eq)

    launch = _shoot_launch(scene, li, power_scalar, kind, max_depth, n_eq)
    s_buf = jnp.zeros((nchunks * launch.s_cap, PHOTON_ROW), jnp.float32)
    v_buf = jnp.zeros((nchunks * launch.v_cap, PHOTON_ROW), jnp.float32)
    s_n = v_n = 0
    dropped = 0
    for ci in range(nchunks):
        k = jax.random.fold_in(key, ci * n_eq)
        s_rows, s_count, v_rows, v_count = launch.fn(tables, k)
        s_count = int(s_count)
        v_count = int(v_count)
        dropped += max(0, s_count - launch.s_cap) + max(0, v_count - launch.v_cap)
        # valid prefixes stay contiguous: the next chunk's block starts
        # exactly where this chunk's valid rows end, overwriting the
        # garbage tail; only [total_n, ...) is garbage at the end, and
        # every consumer masks by the returned counts
        s_buf = jax.lax.dynamic_update_slice(s_buf, s_rows, (jnp.int32(s_n), 0))
        v_buf = jax.lax.dynamic_update_slice(v_buf, v_rows, (jnp.int32(v_n), 0))
        s_n += min(s_count, launch.s_cap)
        v_n += min(v_count, launch.v_cap)
    if dropped:
        print(f"rpt_tpu: photon deposit capacity dropped {dropped} photons", file=sys.stderr)
    return s_buf, s_n, v_buf, v_n


def shoot_photons(scene, tables, key, photon_count: int, watts: float,
                  kind: str, max_depth: int = 48, chunk: int = 1 << 19):
    """shoot_photons_device pulled to host float32 arrays (bit-identical
    rows; kept for host-side callers and tests)."""
    s_buf, s_n, v_buf, v_n = shoot_photons_device(
        scene, tables, key, photon_count, watts, kind, max_depth, chunk
    )
    return np.asarray(s_buf)[:s_n], np.asarray(v_buf)[:v_n]


@dataclass
class _Launch:
    fn: object  # jitted
    n: int
    s_cap: int
    v_cap: int
    raw: object = None  # unjitted body (for shard_map wrapping)


def _shoot_launch(scene, light_index: int, power_scalar: float, kind: str,
                  max_depth: int, n: int) -> _Launch:
    lstat = scene.lights[light_index]
    medium = scene.media[0] if scene.media else None
    s_cap = int(n * 4)
    v_cap = int(n * 10) if medium is not None else 16

    def launch(tables, key):
        from ..lights import sample_shape

        ltab = tables["lights"][light_index]
        keys = sampling.keys_for(key, n)
        target = Vec3.zeros(n)
        pos, nrm, _pdf = sample_shape(lstat, ltab, target, sampling.fold(keys, 1))
        r1, r2 = sampling.uniform2(sampling.fold(keys, 2))
        direction, _ = sampling.uniform_hemisphere(r1, r2, nrm)
        # power = watts/count * material.color() (photon.rs:763 — NOT
        # scaled by emittance)
        color = Vec3.of(*lstat.color).broadcast_to((n,))
        power = color * power_scalar

        materials = tables["materials"]

        def level(carry, b):
            ray, keys_state, power, alive = carry
            nw = ray.origin.shape[0]  # stage width (lanes compact between stages)
            zero = Vec3.zeros(nw)
            kb = sampling.fold(keys_state, jnp.asarray(b))
            wo = -ray.dir.normalize()

            # photon wavefronts scatter from the light in all directions:
            # never coherent enough for the tile path
            hit = closest_hit(scene, tables, ray, coherent=False)
            if medium is not None:
                d, _pdf_d, _cdf = medium.sample_d(ray, sampling.fold(kb, 1))
                vol_event = alive & (d < jnp.where(hit.valid, hit.time, INF))
            else:
                d = jnp.zeros(nw, DTYPE)
                vol_event = jnp.zeros(nw, bool)
            surf_event = alive & hit.valid & ~vol_event

            # ---- volume interaction (photon.rs:877-915) ----------------
            if medium is not None:
                collision = where(vol_event, ray.at(d), zero)
                med_color = medium.color(collision)
                scat = medium.scattering(collision)
                ext = medium.extinction(collision)
                rr_prob = scat / ext
                u_v = sampling.uniform(sampling.fold(kb, 2))
                wi_v, ph_p = medium.sample_ph(wo, sampling.fold(kb, 3))
                ph = medium.phase(wo, wi_v)
                vol_continue = vol_event & (u_v < rr_prob)
                vol_power_next = power * med_color * (rr_prob * ph / jnp.maximum(ph_p, 1e-20))
            else:
                collision = zero
                wi_v = wo
                vol_continue = jnp.zeros(nw, bool)
                vol_power_next = power

            # ---- surface interaction (photon.rs:813-874) ---------------
            mat = materials.lookup(hit.material)
            spos = where(surf_event, ray.at(hit.time), zero)
            p_d = 0.7  # hardcoded diffuse RR (photon.rs:821-833)
            u_s = sampling.uniform(sampling.fold(kb, 4))
            wi_s, pdf_s, valid_s = sample_f(mat, hit.normal, wo, sampling.fold(kb, 5))
            f = bsdf(mat, hit.normal, wo, wi_s)
            cos_raw = wi_s.dot(hit.normal)
            cosine_term = jnp.where(cos_raw > 0.0, cos_raw, 1.0)  # photon.rs:846-850
            surf_continue = surf_event & (u_s < p_d) & valid_s
            surf_power_next = power * f * (cosine_term / (jnp.maximum(pdf_s, 1e-20) * p_d))
            # deposit only on the survive branch, and never on mirrors
            # (photon.rs:838-873)
            surf_deposit = surf_event & (u_s < p_d) & valid_s & ~mat.is_mirror()

            # ---- emit per-level deposits -------------------------------
            out = (
                surf_deposit,
                vol_event,
                where(vol_event, collision, spos),  # deposit position
                wo,  # stored direction (photon.rs:860,909)
                power,  # PRE-attenuation power
                ray.origin,  # beam start
            )

            cont = vol_continue | surf_continue
            new_power = where(vol_event, vol_power_next, surf_power_next)
            new_power = where(cont, new_power, zero)
            new_ray = Ray(
                where(vol_event, collision, spos),
                where(vol_event, wi_v, wi_s),
            )
            return (new_ray, keys_state, new_power, cont), out

        # --- staged wavefront with survivor compaction -------------------
        # RR kills ~20-30% of photons per level, but a flat scan pays full
        # width for all max_depth levels. Instead: run levels at the
        # current width WHILE the survivor count exceeds the next
        # (static) ladder width, then argsort-compact the alive lanes and
        # continue narrower. Adaptive: survival-heavy (volumetric) scenes
        # simply run more levels before each compaction. Deposits scatter
        # into the capped buffers inside the level body (cursor carry),
        # so compaction never touches them.
        def deposit(buf, cursor, mask, rows, cap):
            slot = cursor + jnp.cumsum(mask) - 1
            idx = jnp.where(mask, jnp.minimum(slot, cap - 1), cap)
            buf = buf.at[idx].set(rows.astype(jnp.float32), mode="drop")
            return buf, cursor + jnp.sum(mask)

        def level_deposit(state):
            b, ray, lane_keys, power, alive, s_buf, s_cursor, v_buf, v_cursor = state
            (new_ray, _, new_power, cont), (
                s_mask, v_mask, dpos, ddir, dpow, dstart
            ) = level((ray, lane_keys, power, alive), b)
            rows = jnp.stack(
                [dpos.x, dpos.y, dpos.z, ddir.x, ddir.y, ddir.z,
                 dpow.x, dpow.y, dpow.z, dstart.x, dstart.y, dstart.z],
                axis=1,
            )
            s_buf, s_cursor = deposit(s_buf, s_cursor, s_mask, rows, s_cap)
            v_buf, v_cursor = deposit(v_buf, v_cursor, v_mask, rows, v_cap)
            return (b + 1, new_ray, lane_keys, new_power, cont,
                    s_buf, s_cursor, v_buf, v_cursor)

        s_buf0 = jnp.zeros((s_cap, PHOTON_ROW), jnp.float32)
        v_buf0 = jnp.zeros((v_cap, PHOTON_ROW), jnp.float32)
        state = (jnp.int32(0), Ray(pos, direction), keys, power,
                 jnp.ones(n, bool), s_buf0, jnp.int32(0), v_buf0, jnp.int32(0))

        widths = []
        w = n
        while w > 4096:
            w = max(4096, w // 4)
            widths.append(w)

        for next_w in widths:
            def cond(state, next_w=next_w):
                return (state[0] < max_depth) & (jnp.sum(state[4]) > next_w)

            state = jax.lax.while_loop(cond, level_deposit, state)
            b, ray_s, lane_keys, power_s, alive, s_buf, s_cursor, v_buf, v_cursor = state
            sel = jnp.argsort(~alive)[:next_w]
            state = (
                b,
                Ray(take(ray_s.origin, sel), take(ray_s.dir, sel)),
                jax.tree_util.tree_map(lambda a: a[sel], lane_keys),
                take(power_s, sel),
                alive[sel],
                s_buf, s_cursor, v_buf, v_cursor,
            )

        def cond_last(state):
            return (state[0] < max_depth) & jnp.any(state[4])

        state = jax.lax.while_loop(cond_last, level_deposit, state)
        _, _, _, _, _, s_buf, s_count, v_buf, v_count = state
        return s_buf, s_count, v_buf, v_count

    return _Launch(jax.jit(launch), n, s_cap, v_cap, raw=launch)


# ---------------------------------------------------------------------------
# Pass 2: map building


@dataclass
class PhotonMapData:
    """Photon map: device arrays are pytree data; grid metadata/kind are
    static aux (so jitted camera passes specialize on structure only)."""

    kind: str
    surface_static: PhotonGridStatic
    surface: dict  # grid tables + "rows": (S, PHOTON_ROW), "pos4": (S, 4)
    volume: dict | None = None
    spheres: dict | None = None  # pos4 (V,4), radius, dir Vec3, power Vec3
    beams: dict | None = None
    volume_static: PhotonGridStatic | None = None
    n_spheres: int = 0
    n_beams: int = 0


jax.tree_util.register_dataclass(
    PhotonMapData,
    data_fields=["surface", "volume", "spheres", "beams"],
    meta_fields=["kind", "surface_static", "volume_static", "n_spheres", "n_beams"],
)


def _grid_sort(rows, k: int, n_real: int | None = None):
    """Grid build + payload reorder. ``rows`` on device -> everything
    (bin, argsort, reorder, pos4 packing) stays on device; host ndarray
    -> the original exact-f64 host path (CPU/tests). ``n_real`` marks
    the valid prefix of a fixed-cap device row buffer (the shoot's
    count-independent-shape contract)."""
    on_device = isinstance(rows, jax.Array) and not isinstance(rows, np.ndarray)
    if on_device and (rows.shape[0] == 0 or n_real == 0):
        rows = np.zeros((0, PHOTON_ROW), np.float32)
        on_device = False
        n_real = None
    if on_device:
        # payload sort rides the fused build dispatch (bucketed shapes;
        # tables come back padded — pads sort last, starts <= n always)
        static, tabs = build_photon_grid(rows[:, 0:3], k=k, payload_rows=rows,
                                         n_real=n_real)
        return static, {
            "starts": tabs["starts"],
            "starts2": tabs["starts2"],
            "map2": tabs["map2"],
            "rows": tabs["rows"],
            "pos4": tabs["pos4"],
            "pos4_2": tabs["pos4_2"],
        }
    if n_real is not None:
        rows = np.asarray(rows)[:n_real]
    static, tabs = build_photon_grid(rows[:, 0:3], k=k)
    order = np.asarray(tabs["order"])
    map2 = np.asarray(tabs["map2"])
    sorted_rows = rows[order] if len(rows) else rows
    pos4 = np.zeros((max(len(rows), 1), 4), np.float32)
    pos4[: len(rows), :3] = sorted_rows[:, 0:3] if len(rows) else 0
    # coarse-grid-order positions for the stray pass (indices map back to
    # the fine order through tabs["map2"] inside knn_query)
    pos4_2 = pos4[map2] if len(rows) else pos4
    return static, {
        "starts": tabs["starts"],
        "starts2": tabs["starts2"],
        "map2": tabs["map2"],
        "rows": jnp.asarray(sorted_rows if len(rows) else np.zeros((1, PHOTON_ROW), np.float32)),
        "pos4": jnp.asarray(pos4),
        "pos4_2": jnp.asarray(pos4_2),
    }


def build_photon_map(scene, tables, surface_rows: np.ndarray, volume_rows: np.ndarray,
                     kind: str, gather_size: int, gather_size_volume: int,
                     rng: np.random.Generator, n_surface: int | None = None,
                     n_volume: int | None = None) -> PhotonMapData:
    """``n_surface``/``n_volume`` mark the valid prefixes of fixed-cap
    device row buffers (the count-independent-shape shoot contract);
    None means the arrays are exactly sized."""
    s_static, s_tabs = _grid_sort(surface_rows, gather_size, n_surface)
    data = PhotonMapData(kind, s_static, s_tabs)

    if kind == PHOTON_MAP:
        v_static, v_tabs = _grid_sort(volume_rows, gather_size_volume, n_volume)
        data.volume_static = v_static
        data.volume = v_tabs
    elif kind == POINT_BEAM:
        # adaptive radius: distance to the 10th NN (photon.rs:216-226)
        v_static, v_tabs = _grid_sort(volume_rows, 10, n_volume)
        v = np.asarray(v_tabs["rows"])
        nv = len(volume_rows) if n_volume is None else n_volume
        if nv:
            radius = _knn_radius_device(v_static, v_tabs, nv, k=10)
            print(
                "Finished calculating Photon radiuses "
                f"{(float(radius[:nv].mean()), float(radius[:nv].max()), float(radius[:nv].min()))}"
            )
        else:
            radius = np.zeros(1, np.float32)
        # pad to a multiple of the sweep chunk: zero-radius spheres are
        # inert, and padding keeps dynamic_slice in bounds (an OOB start
        # would CLAMP and double-count a window of spheres)
        chunk = 4096
        pad = max(chunk, -(-max(nv, 1) // chunk) * chunk)
        pos4 = np.zeros((pad, 4), np.float32)
        rad = np.zeros(pad, np.float32)
        dirs = np.zeros((pad, 3), np.float32)
        pows = np.zeros((pad, 3), np.float32)
        if nv:
            pos4[:nv, :3] = v[:nv, 0:3]
            rad[:nv] = radius[:nv]
            dirs[:nv] = v[:nv, 3:6]
            pows[:nv] = v[:nv, 6:9]
        data.spheres = {
            "pos4": jnp.asarray(pos4),
            "radius": jnp.asarray(rad, DTYPE),
            "dir": Vec3.from_array(dirs),
            "power": Vec3.from_array(pows),
        }
        data.n_spheres = nv
    elif kind == BEAM_BEAM:
        # thin volume photons to 0.1% with power x1000 (photon.rs:773-793)
        volume_rows = np.asarray(volume_rows)  # host logic below
        if n_volume is not None:
            volume_rows = volume_rows[:n_volume]
        keep = rng.random(len(volume_rows)) < BEAM_THIN
        b = volume_rows[keep]
        if len(b) == 0:
            b = np.zeros((0, PHOTON_ROW), np.float32)
        start = b[:, 9:12]
        end = b[:, 0:3]
        seg = end - start
        length = np.linalg.norm(seg, axis=-1)
        direction = seg / np.maximum(length, 1e-12)[:, None]
        nb = len(b)
        pad = max(nb, 1)

        def col(a, default=0.0):
            out = np.full((pad,), default, np.float32)
            out[:nb] = a
            return jnp.asarray(out)

        data.beams = {
            "start": Vec3(col(start[:, 0]), col(start[:, 1]), col(start[:, 2])),
            "dir": Vec3(col(direction[:, 0]), col(direction[:, 1]), col(direction[:, 2])),
            "length": col(length),
            "radius": col(np.full(nb, 3.0), 3.0),  # fixed radius (photon.rs:277)
            "power": Vec3(
                col(b[:, 6] / BEAM_THIN), col(b[:, 7] / BEAM_THIN), col(b[:, 8] / BEAM_THIN)
            ),
        }
        data.n_beams = nb
        avg = float(np.full(nb, 3.0).mean()) if nb else 0.0
        print(f"Finished calculating photon beam radiuses {(avg, 3.0 if nb else 0.0, 3.0 if nb else 0.0)}")
    return data


def _knn_radius_device(static, tabs, n: int, k: int, chunk: int = 1 << 15) -> np.ndarray:
    # chunk bounds the (chunk * window/8, 32) blocked k-NN gather: at
    # 2^18 queries with a 1024-wide window would allocate ~20 GB
    """Per-photon distance to its k-th NN (including itself), device-side."""
    rows = tabs["pos4"]
    out = np.zeros(rows.shape[0], np.float32)

    @jax.jit
    def q(pos4, q4):
        query = Vec3(q4[:, 0], q4[:, 1], q4[:, 2])
        _, d2, valid = knn_query(static, tabs, pos4, query, k)
        dmax = jnp.max(jnp.where(valid, d2, 0.0), axis=1)
        return jnp.sqrt(dmax)

    rows_h = np.asarray(rows)  # ONE pull (was re-pulled per chunk)
    for i in range(0, n, chunk):
        sl = rows_h[i : i + chunk]
        out[i : i + len(sl)] = np.asarray(q(rows, jnp.asarray(sl)))
    return out


# ---------------------------------------------------------------------------
# Pass 3: camera estimates


def surface_estimate(scene, tables, pmap: PhotonMapData, ray: Ray, hit, keys,
                     gather_size: int, occlusion_check: bool = True) -> Vec3:
    """Disk density estimate on surfaces (photon.rs:327-375)."""
    n = ray.origin.shape[0]
    zero = Vec3.zeros(n)
    hitmask = hit.valid
    pos = where(hitmask, ray.at(hit.time), zero)
    wo = -ray.dir.normalize()
    mat = tables["materials"].lookup(hit.material)

    if pmap.surface_static.n_photons == 0:
        return zero

    idx, d2, valid = knn_query(
        pmap.surface_static, pmap.surface, pmap.surface["pos4"], pos, gather_size
    )
    max_d2 = jnp.max(jnp.where(valid, d2, 0.0), axis=1)

    rows = jnp.take(pmap.surface["rows"], idx.reshape(-1), axis=0).reshape(
        n, gather_size, PHOTON_ROW
    )

    color = mat.color_query() * mat.emittance_query()

    # Photons accumulate in CHUNKS of <= PHOTON_CHUNK via one lax.scan:
    # each chunk vectorizes over (n * kc) lanes, so the visibility
    # recheck (photon.rs:353-361) is ONE occlusion wavefront per chunk.
    # (A Python loop would unroll gather_size (up to 100) copies of
    # the full occlusion-traversal graph — minutes of XLA compile — and
    # dispatch them sequentially at run time.)
    kc = min(gather_size, PHOTON_CHUNK)
    k_pad = -(-gather_size // kc) * kc
    if k_pad != gather_size:
        rows = jnp.concatenate(
            [rows, jnp.zeros((n, k_pad - gather_size, PHOTON_ROW), rows.dtype)],
            axis=1,
        )
        valid = jnp.concatenate(
            [valid, jnp.zeros((n, k_pad - gather_size), bool)], axis=1
        )
    rows_c = rows.reshape(n, k_pad // kc, kc, PHOTON_ROW).transpose(1, 0, 2, 3)
    valid_c = valid.reshape(n, k_pad // kc, kc).transpose(1, 0, 2)

    nm = n * kc

    def bc(a):
        return jnp.broadcast_to(a[:, None], (n, kc)).reshape(nm)

    mat_f = jax.tree_util.tree_map(bc, mat)
    normal_f = Vec3(bc(hit.normal.x), bc(hit.normal.y), bc(hit.normal.z))
    wo_f = Vec3(bc(wo.x), bc(wo.y), bc(wo.z))
    pos_f = Vec3(bc(pos.x), bc(pos.y), bc(pos.z))
    hitmask_f = bc(hitmask)

    def chunk(acc, inp):
        rws, vld = inp  # (n, kc, ROW), (n, kc)

        def fl(i):
            return rws[:, :, i].reshape(nm)

        p_pos = Vec3(fl(0), fl(1), fl(2))
        p_dir = Vec3(fl(3), fl(4), fl(5))
        p_pow = Vec3(fl(6), fl(7), fl(8))
        ok = vld.reshape(nm) & hitmask_f
        if occlusion_check:
            disp = pos_f - p_pos
            dist = disp.length()
            sray = Ray(p_pos, disp / jnp.maximum(dist, 1e-20))
            # dead lanes get limit -1: every traversal rejects in O(1).
            # photon->gather-point rays have scattered origins: the tile
            # pass certifies ~0% on such wavefronts (shadow_components),
            # so skip it (coherent=False)
            limit = jnp.where(ok, dist * (1.0 - scene.shadow_eps), -1.0)
            ok &= ~occluded(scene, tables, sray, limit, coherent=False)
        f = bsdf(mat_f, normal_f, wo_f, p_dir)
        contrib = f * p_pow * jnp.clip(p_dir.dot(normal_f), 0.0, 1.0)
        c = where(ok, contrib, Vec3.zeros(nm)).to_array()
        return acc + c.reshape(n, kc, 3).sum(axis=1), None

    acc_arr, _ = jax.lax.scan(
        chunk, jnp.zeros((n, 3), DTYPE), (rows_c, valid_c)
    )
    color = color + Vec3(acc_arr[:, 0], acc_arr[:, 1], acc_arr[:, 2])
    inv = jnp.where(max_d2 > 0.0, 1.0 / (math.pi * max_d2), 0.0)
    return where(hitmask, color * inv, zero)


def volume_estimate_point(scene, tables, pmap: PhotonMapData, medium, ray: Ray, hit,
                          keys, gather_size: int, gather_size_volume: int,
                          occlusion_check: bool = True) -> Vec3:
    """Point-query volume estimate (photon.rs:384-437): free-flight sample,
    sphere density at the collision, else attenuated surface estimate."""
    n = ray.origin.shape[0]
    zero = Vec3.zeros(n)
    d, d_pdf, d_cdf = medium.sample_d(ray, sampling.fold(keys, 0x7))
    in_volume = ~hit.valid | (d < hit.time)

    collision = where(in_volume, ray.at(d), zero)
    wo = -ray.dir.normalize()
    med_color = medium.color(collision)
    ext = medium.extinction(collision)

    if pmap.volume_static is not None and pmap.volume_static.n_photons > 0:
        idx, d2, valid = knn_query(
            pmap.volume_static, pmap.volume, pmap.volume["pos4"], collision, gather_size_volume
        )
        max_d2 = jnp.max(jnp.where(valid, d2, 0.0), axis=1)
        rows = jnp.take(pmap.volume["rows"], idx.reshape(-1), axis=0).reshape(
            n, gather_size_volume, PHOTON_ROW
        )
        # vectorized over all (n * k) photon-lane pairs (a Python loop
        # would unroll the graph k times)
        kv = gather_size_volume
        nm = n * kv

        def bc(a):
            return jnp.broadcast_to(a[:, None], (n, kv)).reshape(nm)

        p_dir = Vec3(*(rows[:, :, 3 + i].reshape(nm) for i in range(3)))
        p_pow = Vec3(*(rows[:, :, 6 + i].reshape(nm) for i in range(3)))
        wo_f = Vec3(bc(wo.x), bc(wo.y), bc(wo.z))
        med_color_f = Vec3(bc(med_color.x), bc(med_color.y), bc(med_color.z))
        ph = medium.phase(wo_f, p_dir)
        contrib = where(
            valid.reshape(nm), p_pow * med_color_f * ph, Vec3.zeros(nm)
        ).to_array()
        acc_arr = contrib.reshape(n, kv, 3).sum(axis=1)
        acc = Vec3(acc_arr[:, 0], acc_arr[:, 1], acc_arr[:, 2])
        denom = (4.0 / 3.0) * math.pi * jnp.maximum(max_d2, 1e-30) ** 1.5
        vol_color = acc / denom / ext
        vol_color = vol_color * (medium.transmittence(ray, d) / jnp.maximum(d_pdf, 1e-30))
        vol_color = where(max_d2 > 0.0, vol_color, zero)
    else:
        vol_color = zero

    surf = surface_estimate(
        scene, tables, pmap, ray, hit, keys, gather_size, occlusion_check
    )
    surf_att = surf * (
        medium.transmittence(ray, jnp.where(hit.valid, hit.time, 0.0))
        / jnp.maximum(1.0 - d_cdf, 1e-30)
    )
    return where(in_volume, vol_color, where(hit.valid, surf_att, zero))


def _k2(x):
    """Silverman-like blur kernel k2 (photon.rs:466-469)."""
    t = 1.0 - x
    return (3.0 / math.pi) * t * t


def volume_estimate_spheres(pmap: PhotonMapData, medium, ray: Ray, hit,
                            chunk: int = 4096) -> Vec3:
    """Beam-query x point-photon estimate (photon.rs:439-501): perpendicular
    disk test against every photon sphere, dense chunked sweep (replaces
    the reference's BVH traverse). XLA fuses each chunk's pair math and
    row sums into one pass; a hand-written Pallas kernel measured slower
    on the H100 (PERF.md)."""
    n = ray.origin.shape[0]
    zero = Vec3.zeros(n)
    if pmap.n_spheres == 0:
        return zero
    dummy = Vec3.zeros(n)
    med_color = medium.color(dummy)
    ext = medium.extinction(dummy)
    hit_time = jnp.where(hit.valid, hit.time, INF)

    pos4 = pmap.spheres["pos4"]
    radius = pmap.spheres["radius"]
    pdir = pmap.spheres["dir"]
    ppow = pmap.spheres["power"]
    total = pos4.shape[0]
    n_chunks = (pmap.n_spheres + chunk - 1) // chunk

    def body(ci, acc):
        s = ci * chunk
        p4 = jax.lax.dynamic_slice(pos4, (s, 0), (chunk, 4))
        rad = jax.lax.dynamic_slice(radius, (s,), (chunk,))
        dirx = jax.lax.dynamic_slice(pdir.x, (s,), (chunk,))
        diry = jax.lax.dynamic_slice(pdir.y, (s,), (chunk,))
        dirz = jax.lax.dynamic_slice(pdir.z, (s,), (chunk,))
        powx = jax.lax.dynamic_slice(ppow.x, (s,), (chunk,))
        powy = jax.lax.dynamic_slice(ppow.y, (s,), (chunk,))
        powz = jax.lax.dynamic_slice(ppow.z, (s,), (chunk,))
        in_range = (jax.lax.broadcasted_iota(jnp.int32, (1, chunk), 1) + s) < pmap.n_spheres

        # (n, chunk) pair math
        ocx = p4[None, :, 0] - ray.origin.x[:, None]
        ocy = p4[None, :, 1] - ray.origin.y[:, None]
        ocz = p4[None, :, 2] - ray.origin.z[:, None]
        oc_norm2 = ocx * ocx + ocy * ocy + ocz * ocz
        dd = ocx * ray.dir.x[:, None] + ocy * ray.dir.y[:, None] + ocz * ray.dir.z[:, None]
        # dist^2 from the photon center to the disk point ray.at(dd)
        dist2 = jnp.maximum(oc_norm2 - dd * dd, 0.0)
        r2 = rad[None, :] * rad[None, :]
        ok = in_range & (dd > 0.0) & (dist2 < r2) & (
            jnp.sqrt(oc_norm2) <= hit_time[:, None]
        )
        weight = jnp.where(ok, _k2(dist2 / jnp.maximum(r2, 1e-30)) / jnp.maximum(r2, 1e-30), 0.0)
        # phase(wi=-photon.dir, -ray.dir) — isotropic media make this a
        # constant; evaluate with the photon direction per the reference
        ph = medium.phase(
            Vec3(-dirx[None, :], -diry[None, :], -dirz[None, :]).broadcast_to(weight.shape),
            Vec3(
                -ray.dir.x[:, None], -ray.dir.y[:, None], -ray.dir.z[:, None]
            ).broadcast_to(weight.shape),
        )
        transmittance = jnp.exp(-ext[:, None] * dd)
        w = weight * ph * transmittance
        return Vec3(
            acc.x + jnp.sum(w * powx[None, :], axis=1),
            acc.y + jnp.sum(w * powy[None, :], axis=1),
            acc.z + jnp.sum(w * powz[None, :], axis=1),
        )

    acc = jax.lax.fori_loop(0, n_chunks, body, zero)
    return acc * med_color


def volume_estimate_beams(pmap: PhotonMapData, medium, ray: Ray, hit) -> Vec3:
    """Beam x beam estimate, eq. 38 of Jarosz et al. (photon.rs:503-593).

    After the 0.1% thinning the beam set is tiny (~10^3), so a dense sweep
    over all beams replaces the reference's BVH."""
    n = ray.origin.shape[0]
    zero = Vec3.zeros(n)
    if pmap.n_beams == 0:
        return zero
    b = pmap.beams
    dummy = Vec3.zeros(n)
    med_color = medium.color(dummy)
    ext = medium.extinction(dummy)
    hit_time = jnp.where(hit.valid, hit.time, INF)

    acc = Vec3.zeros(n)
    nb = b["start"].x.shape[0]

    def body(bi, acc):
        bstart = take(b["start"], bi)
        bdir = take(b["dir"], bi)
        blen = b["length"][bi]
        brad = b["radius"][bi]
        bpow = take(b["power"], bi)
        valid_beam = bi < pmap.n_beams

        l = bstart.broadcast_to(ray.origin.shape) - ray.origin
        u = l.cross(bdir.broadcast_to(ray.origin.shape)).normalize()
        nn = bdir.broadcast_to(ray.origin.shape).cross(u).normalize()
        t = nn.dot(l) / nn.dot(ray.dir)
        qc = ray.at(t)
        # t > 0 is a deliberate deviation from photon.rs' beam-beam loop,
        # which accepts behind-origin intersections (exp(-ext*t), t<0,
        # amplifies transmittance) — see PARITY.md
        ok = valid_beam & (t < hit_time) & (t > 0.0)

        cosb = ray.dir.dot(bdir.broadcast_to(ray.origin.shape))
        inv_sin = 1.0 / jnp.sqrt(jnp.maximum(1.0 - cosb * cosb, 1e-12))
        beam_t = bdir.broadcast_to(ray.origin.shape).dot(qc - bstart.broadcast_to(ray.origin.shape))
        ok &= (beam_t >= 0.0) & (beam_t <= blen)
        bc = bstart.broadcast_to(ray.origin.shape) + bdir.broadcast_to(ray.origin.shape) * beam_t
        dist = (qc - bc).length()
        ok &= dist < brad

        ph = medium.phase(-bdir.broadcast_to(ray.origin.shape), -ray.dir)
        contrib = (
            bpow.broadcast_to(ray.origin.shape)
            * med_color
            * (
                ext
                * ph
                * inv_sin
                * jnp.exp(-ext * t)
                * jnp.exp(-ext * beam_t)
                * _k2(dist / jnp.maximum(brad, 1e-20))
                / (2.0 * jnp.maximum(brad, 1e-20))
            )
        )
        return acc + where(ok, contrib, zero)

    acc = jax.lax.fori_loop(0, nb, body, acc)
    return acc


def estimate_indirect(scene, tables, pmap: PhotonMapData, ray: Ray, keys,
                      gather_size: int, gather_size_volume: int,
                      occlusion_check: bool = True) -> Vec3:
    """Dispatch on (hit?, medium?, map kind) — photon.rs:600-627."""
    n = ray.origin.shape[0]
    zero = Vec3.zeros(n)
    medium = scene.media[0] if scene.media else None
    hit = closest_hit(scene, tables, ray)

    if medium is None:
        surf = surface_estimate(
            scene, tables, pmap, ray, hit, keys, gather_size, occlusion_check
        )
        env = scene.env_color(tables, ray.dir)
        return where(hit.valid, surf, env)

    if pmap.kind == PHOTON_MAP:
        # surface term handled inside (photon.rs:610-613); full miss with a
        # medium still evaluates the volume estimate (photon.rs:603)
        return volume_estimate_point(
            scene, tables, pmap, medium, ray, hit, keys,
            gather_size, gather_size_volume, occlusion_check,
        )

    if pmap.kind == POINT_BEAM:
        vol = volume_estimate_spheres(pmap, medium, ray, hit)
    else:
        vol = volume_estimate_beams(pmap, medium, ray, hit)
    surf = surface_estimate(
        scene, tables, pmap, ray, hit, keys, gather_size, occlusion_check
    )
    t_surf = medium.transmittence(ray, jnp.where(hit.valid, hit.time, 0.0))
    return vol + where(hit.valid, surf * t_surf, zero)
