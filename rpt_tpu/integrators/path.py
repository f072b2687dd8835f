"""Wavefront path tracing.

Ports ``Renderer::trace_ray`` (`/root/reference/src/renderer.rs:187-322`)
from a per-ray recursion to whole-wavefront iteration:

* **Surface branch** (no media, renderer.rs:286-321): bounded by
  ``max_bounces``; emission only at bounce 0; NEE at every hit; per-level
  per-channel firefly clamp of 100 applied to the *sub-path* result
  (renderer.rs:311-313). Because the clamp wraps the recursive return
  value, a forward throughput product cannot express it — we run a forward
  ``lax.scan`` collecting per-level (contribution, factor) pairs and fold
  them *backwards*: ``L_b = contrib_b + min(factor_b * L_{b+1}, 100)``.
  This reproduces the recursion exactly.

* **Media branch** (renderer.rs:188-285): Russian roulette p=0.8 at every
  level, *ignoring* ``max_bounces`` and with no clamp — so plain forward
  throughput accumulation in a fixed-cap scan (cap = ``media_max_depth``;
  truncation error ~0.8^cap, far below Monte Carlo noise). Exactly one of
  {medium event, surface event, miss} happens per level, selected by the
  sampled free-flight distance vs the closest hit (miss uses
  background_dist = 400, renderer.rs:199).

Shadow-ray semantics: the reference accepts a light sample only when the
closest hit lies *exactly* at the light distance within 1e-12
(renderer.rs:396) — which requires the light's geometry to be a scene
object (the dual-add pattern) and f64 exactness. We use the standard
occlusion test (no occluder strictly closer than the light), which is
equivalent for dual-added lights, matches upstream rpt for light-only
geometry, and is robust in f32.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from .. import sampling
from ..dtypes import DTYPE, INF
from ..intersect import closest_hit, occluded
from ..materials import bsdf, sample_f
from ..ray import Ray
from ..vec import Vec3, where

FIREFLY_CLAMP = 100.0  # renderer.rs:18
BACKGROUND_DIST = 400.0  # renderer.rs:199
RR_P = 0.8  # renderer.rs:193
# Concatenate all lights' shadow rays into one occlusion wavefront:
# zero-contribution gating retires ~a third of the pooled lanes at entry,
# and the per-traversal-call machinery is shared instead of paid per
# light. Chosen on the earlier target; unmeasured on the GPU.
SHADOW_BATCH = os.environ.get("RPT_TPU_SHADOW_BATCH", "1") == "1"
# Pool level b's shadow rays with level b+1's bounce closest-hit into ONE
# mixed traversal per scan iteration (intersect.mixed_closest_occluded).
# Measured net-negative on the dragon bench on the earlier target: mixing
# deep closest lanes with shallow any-hit lanes in one ladder costs more
# lock-step width than the shared per-call machinery saves. Kept opt-in
# (radiance is bit-identical — goldens pass either way) for narrow
# wavefronts where fixed costs dominate; unmeasured on the GPU.
POOLED_SCHEDULE = os.environ.get("RPT_TPU_POOLED_SCHEDULE", "0") == "1"


def _sanitize(pos: Vec3, mask) -> Vec3:
    zero = Vec3.zeros(jnp.shape(mask))
    return where(mask, pos, zero)


# dead lanes trace this ray instead of garbage from sanitized origins:
# far outside every scene, pointing away — every traversal path (analytic,
# tiled culling, tree root box) rejects it in O(1). Results of dead lanes
# are discarded anyway; only their COST matters (a dead lane carrying a
# stale/zeroed origin inside the mesh was measured to re-traverse the
# whole BVH every level).
_DEAD_POS = 1e7


def _dead_ray_fields(n):
    far = jnp.full(n, jnp.asarray(_DEAD_POS, DTYPE))
    up = jnp.ones(n, DTYPE)
    return Vec3(far, far, far), Vec3(jnp.zeros(n, DTYPE), up, jnp.zeros(n, DTYPE))


def sample_lights(scene, tables, mat, pos: Vec3, n: Vec3, wo: Vec3, keys,
                  mask=None, coherent: bool = True) -> Vec3:
    """renderer.rs:362-409 — NEE for a surface point. ``mask`` marks lanes
    whose result is consumed; shadow queries are disabled on the rest.
    All lights' shadow rays run as ONE batched occlusion query (shared
    traversal fixed costs + pooled ladder compaction); the RNG stream is
    per-light as before."""
    from ..lights import illuminate

    color = Vec3.zeros(jnp.shape(pos.x))
    pending = []  # (wi, contrib, dist) per non-ambient light
    for li, (lstat, ltab) in enumerate(zip(scene.lights, tables["lights"])):
        if lstat.kind == "ambient":
            color = color + ltab["color"].broadcast_to(pos.shape) * mat.color_query()
            continue
        lkeys = sampling.fold(keys, 0x1100 + li)
        intensity, wi, dist = illuminate(lstat, ltab, pos, lkeys)
        f = bsdf(mat, n, wo, wi)
        pending.append((wi, f * intensity * wi.dot(n), dist))
    for visible, (_, contrib, _) in zip(
        _shadow_visible_batch(scene, tables, pos, pending, mask, coherent),
        pending,
    ):
        color = color + where(visible, contrib, Vec3.zeros(jnp.shape(pos.x)))
    return color


def _nonzero_contrib(contrib: Vec3):
    """Shadow lanes whose NEE contribution is already zero (light below
    the horizon, black BSDF lobe, backfacing area-light sample) have a
    visibility result that is multiplied by zero — skip their occlusion
    traversal entirely. Pure cost optimization: where(visible, 0, 0) == 0
    either way, so the radiance estimate is bit-identical."""
    return (contrib.x != 0.0) | (contrib.y != 0.0) | (contrib.z != 0.0)


def sample_lights_for_media(scene, tables, medium, pos: Vec3, wo: Vec3, keys,
                            mask=None, coherent: bool = True) -> Vec3:
    """renderer.rs:325-359 — NEE for a medium scattering point."""
    from ..lights import illuminate

    scat = medium.scattering(pos)
    ext = medium.extinction(pos)
    medium_color = medium.color(pos)
    color = Vec3.zeros(jnp.shape(pos.x))
    pending = []
    for li, (lstat, ltab) in enumerate(zip(scene.lights, tables["lights"])):
        if lstat.kind == "ambient":
            color = color + ltab["color"].broadcast_to(pos.shape) * medium_color
            continue
        lkeys = sampling.fold(keys, 0x1100 + li)
        intensity, wi, dist = illuminate(lstat, ltab, pos, lkeys)
        ph = medium.phase(wo, wi)
        pending.append((wi, intensity * medium_color * ((scat / ext) * ph), dist))
    for visible, (_, contrib, _) in zip(
        _shadow_visible_batch(scene, tables, pos, pending, mask, coherent),
        pending,
    ):
        color = color + where(visible, contrib, Vec3.zeros(jnp.shape(pos.x)))
    return color


def _shadow_visible(scene, tables, pos: Vec3, wi: Vec3, dist, mask=None,
                    coherent: bool = True):
    """True where no occluder lies strictly between ``pos`` and the light.
    Lanes with ``mask`` False get limit -1: every traversal path rejects
    them in O(1) (their visibility result is discarded by the caller).

    ``scene.nee_mode == "exact"`` instead reproduces renderer.rs:395-396
    literally: accept only when the CLOSEST hit lies at the light distance
    (which rejects every sample of a light whose geometry is not also in
    scene.objects) — used to quantify the deviation, see PARITY.md."""
    if scene.nee_mode == "exact":
        hit = closest_hit(scene, tables, Ray(pos, wi))
        ok = hit.valid & (jnp.abs(hit.time - dist) < scene.shadow_eps * dist)
        if mask is not None:
            ok &= mask
        return ok
    limit = dist * (1.0 - scene.shadow_eps)
    if mask is not None:
        limit = jnp.where(mask, limit, -1.0)
    return ~occluded(scene, tables, Ray(pos, wi), limit, coherent=coherent)


def _shadow_visible_batch(scene, tables, pos: Vec3, pending, mask,
                          coherent: bool):
    """Visibility for every light's shadow ray from the same surface
    points, CONCATENATED into one occlusion wavefront: per-light passes
    each pay the traversal's sequential fixed costs (dozens of rounds)
    and compact their survivor ladders separately; one n*L-lane query
    shares both. Falls back to
    per-light queries for the exact-NEE parity mode."""
    if not pending:
        return []
    if scene.nee_mode == "exact":
        return [
            _shadow_visible(scene, tables, pos, wi, dist, mask, coherent)
            for wi, _, dist in pending
        ]
    if not SHADOW_BATCH or len(pending) == 1:
        return [
            _shadow_visible(
                scene, tables, pos, wi, dist,
                _nonzero_contrib(contrib) if mask is None
                else mask & _nonzero_contrib(contrib),
                coherent,
            )
            for wi, contrib, dist in pending
        ]
    n = jnp.shape(pos.x)[0]
    L = len(pending)

    def cat(parts):
        return jnp.concatenate(parts)

    bpos = Vec3(*(cat([getattr(pos, c)] * L) for c in "xyz"))
    bwi = Vec3(*(cat([getattr(wi, c) for wi, _, _ in pending]) for c in "xyz"))
    limits = []
    for _, contrib, dist in pending:
        lmask = _nonzero_contrib(contrib)
        if mask is not None:
            lmask &= mask
        limits.append(jnp.where(lmask, dist * (1.0 - scene.shadow_eps), -1.0))
    occ = occluded(scene, tables, Ray(bpos, bwi), cat(limits),
                   coherent=coherent)
    return [~occ[i * n : (i + 1) * n] for i in range(L)]


# ---------------------------------------------------------------------------
# Surface-only branch (renderer.rs:286-321)


def trace_surface(scene, tables, ray: Ray, keys, max_bounces: int,
                  return_stats: bool = False):
    """Radiance for a wavefront of camera rays, no participating media.

    With ``return_stats``, also returns the number of traced ray segments
    (camera/bounce + shadow) for Mrays/sec accounting.

    Scheduling: by default each level runs its closest-hit then one
    batched occlusion query for all lights (SHADOW_BATCH). The opt-in
    POOLED_SCHEDULE further merges level b's shadows with level b+1's
    closest into one mixed traversal — bit-identical radiance, but
    measured slower on the dragon bench (see POOLED_SCHEDULE note).
    """
    n = ray.origin.shape[0]
    materials = tables["materials"]
    n_shadow = sum(1 for l in scene.lights if l.kind != "ambient")
    if (POOLED_SCHEDULE and scene.nee_mode != "exact" and n_shadow > 0
            and max_bounces >= 1):
        return _trace_surface_pooled(
            scene, tables, ray, keys, max_bounces, return_stats
        )

    def level(carry, b, coherent: bool, is_b0: bool):
        ray, keys_state, alive = carry
        kb = sampling.fold(keys_state, jnp.asarray(b))
        # ``coherent`` is static: camera rays (level 0) take the coherent
        # tile path, bounce wavefronts skip it
        hit = closest_hit(scene, tables, ray, coherent=coherent)
        hitmask = alive & hit.valid
        missmask = alive & ~hit.valid

        mat = materials.lookup(hit.material)
        pos = _sanitize(ray.at(hit.time), hitmask)
        wo = -ray.dir.normalize()

        zero = Vec3.zeros(n)
        if is_b0:  # emission only at bounce 0 (renderer.rs:295-299)
            emit = mat.color_query() * mat.emittance_query()
            emit = where(hitmask, emit, zero)
        else:
            emit = zero
        nee = sample_lights(scene, tables, mat, pos, hit.normal, wo,
                            sampling.fold(kb, 2), mask=hitmask,
                            coherent=coherent)
        env = scene.env_color(tables, ray.dir)
        contrib = emit + where(hitmask, nee, zero) + where(missmask, env, zero)

        wi, pdf, valid = sample_f(mat, hit.normal, wo, sampling.fold(kb, 3))
        f = bsdf(mat, hit.normal, wo, wi)
        bounce_ok = hitmask & valid & (b < max_bounces)
        safe_pdf = jnp.maximum(pdf, 1e-20)
        factor = f * (jnp.abs(wi.dot(hit.normal)) / safe_pdf)
        factor = where(bounce_ok, factor, zero)

        dead_pos, dead_dir = _dead_ray_fields(n)
        new_ray = Ray(where(bounce_ok, pos, dead_pos), where(bounce_ok, wi, dead_dir))
        segments = jnp.sum(alive) + jnp.sum(hitmask) * n_shadow
        return (new_ray, keys_state, bounce_ok), (contrib, factor, segments)

    # Level 0 is unrolled (it alone takes the coherent tile path and emits);
    # levels 1..max_bounces all trace the SAME incoherent graph, so they
    # run as ONE lax.scan over the level index — the traversal subgraph
    # (tiled+deferred, by far the largest part of the program) compiles
    # once instead of once per bounce (full unrolling grew compile time
    # ~60% per bounce).
    carry, out0 = level((ray, keys, jnp.ones(n, bool)), 0, True, True)
    if max_bounces >= 1:
        carry, outs = jax.lax.scan(
            lambda c, b: level(c, b, False, False),
            carry,
            jnp.arange(1, max_bounces + 1),
        )
        contribs, factors, segments = jax.tree_util.tree_map(
            lambda x0, xs: jnp.concatenate([x0[None], xs]), out0, outs
        )
    else:
        contribs, factors, segments = jax.tree_util.tree_map(
            lambda x0: x0[None], out0
        )

    # backward clamp fold: L_b = contrib_b + min(factor_b * L_{b+1}, 100)
    def back(L, level_data):
        contrib, factor = level_data
        indirect = (factor * L).minimum(FIREFLY_CLAMP)
        return contrib + indirect, None

    L0, _ = jax.lax.scan(back, Vec3.zeros(n), (contribs, factors), reverse=True)
    if return_stats:
        return L0, jnp.sum(segments)
    return L0


def _nee_setup(scene, tables, mat, pos: Vec3, nrm: Vec3, wo: Vec3, kb,
               hitmask):
    """Per-light shadow-ray ingredients (direction, unshadowed
    contribution, gated limit) + the ambient term — everything of
    renderer.rs:362-409's NEE except the visibility query, which runs
    pooled one level later (see trace_surface). RNG stream identical to
    sample_lights."""
    from ..lights import illuminate

    keys = sampling.fold(kb, 2)
    amb = Vec3.zeros(jnp.shape(pos.x))
    sh = []
    for li, (lstat, ltab) in enumerate(zip(scene.lights, tables["lights"])):
        if lstat.kind == "ambient":
            amb = amb + ltab["color"].broadcast_to(pos.shape) * mat.color_query()
            continue
        lkeys = sampling.fold(keys, 0x1100 + li)
        intensity, wi, dist = illuminate(lstat, ltab, pos, lkeys)
        f = bsdf(mat, nrm, wo, wi)
        contrib = f * intensity * wi.dot(nrm)
        lmask = hitmask & _nonzero_contrib(contrib)
        limit = jnp.where(lmask, dist * (1.0 - scene.shadow_eps), -1.0)
        # resolved/pre_occ are filled by the L0 tile prepass (pooled
        # schedule); levels 1+ leave them all-False
        no = jnp.zeros(jnp.shape(limit), bool)
        sh.append((wi, contrib, limit, no, no))
    return amb, tuple(sh)


def _trace_surface_pooled(scene, tables, ray: Ray, keys, max_bounces: int,
                          return_stats: bool):
    """The pooled schedule behind trace_surface: iteration b runs ONE
    mixed traversal (level b-1's shadow rays + level b's bounce closest),
    and level b-1's NEE sum is assembled from it in the same operation
    order as the naive schedule — radiance is bit-identical."""
    from ..intersect import mixed_closest_occluded

    n = ray.origin.shape[0]
    materials = tables["materials"]
    n_shadow = sum(1 for l in scene.lights if l.kind != "ambient")
    zero = Vec3.zeros(n)
    dead_pos, dead_dir = _dead_ray_fields(n)

    def shade(ray, hit, alive, kb, is_b0: bool, b):
        """Everything level b does EXCEPT its NEE visibility: emission,
        env, shadow-ray setup, bounce sampling."""
        hitmask = alive & hit.valid
        missmask = alive & ~hit.valid
        mat = materials.lookup(hit.material)
        pos = _sanitize(ray.at(hit.time), hitmask)
        wo = -ray.dir.normalize()
        if is_b0:  # emission only at bounce 0 (renderer.rs:295-299)
            emit = mat.color_query() * mat.emittance_query()
            emit = where(hitmask, emit, zero)
        else:
            emit = zero
        envterm = where(missmask, scene.env_color(tables, ray.dir), zero)
        amb, sh = _nee_setup(scene, tables, mat, pos, hit.normal, wo, kb,
                             hitmask)
        wi, pdf, valid = sample_f(mat, hit.normal, wo, sampling.fold(kb, 3))
        f = bsdf(mat, hit.normal, wo, wi)
        bounce_ok = hitmask & valid & (b < max_bounces)
        safe_pdf = jnp.maximum(pdf, 1e-20)
        factor = f * (jnp.abs(wi.dot(hit.normal)) / safe_pdf)
        factor = where(bounce_ok, factor, zero)
        new_ray = Ray(where(bounce_ok, pos, dead_pos),
                      where(bounce_ok, wi, dead_dir))
        segments = jnp.sum(alive) + jnp.sum(hitmask) * n_shadow
        base = (emit, envterm, amb, hitmask, pos)
        return new_ray, bounce_ok, sh, base, factor, segments

    def assemble(base, sh, occs):
        """Level contribution, in sample_lights'/level()'s exact
        operation order. Lanes the L0 tile prepass resolved take their
        pre-computed occlusion instead of the pooled result."""
        emit, envterm, amb, hitmask, _ = base
        nee = amb
        for (wi, contrib, limit, resolved, pre_occ), occ in zip(sh, occs):
            occ_eff = jnp.where(resolved, pre_occ, occ)
            nee = nee + where(~occ_eff, contrib, zero)
        return emit + where(hitmask, nee, zero) + envterm

    def cat3(parts):
        return Vec3(*(jnp.concatenate([getattr(p, c) for p in parts])
                      for c in "xyz"))

    def body(carry, b):
        bounce_ray, keys_state, alive, sh, base = carry
        kb = sampling.fold(keys_state, b)
        pos_prev = base[4]
        ray3 = Ray(
            cat3([bounce_ray.origin] + [pos_prev] * len(sh)),
            cat3([bounce_ray.dir] + [wi for wi, *_ in sh]),
        )
        limit3 = jnp.concatenate(
            [jnp.full(n, INF, DTYPE)] + [sh_l[2] for sh_l in sh]
        )
        hit, occflat = mixed_closest_occluded(scene, tables, ray3, limit3, n)
        occs = [occflat[i * n : (i + 1) * n] for i in range(len(sh))]
        contrib_prev = assemble(base, sh, occs)
        new_ray, bounce_ok, sh2, base2, factor, segments = shade(
            bounce_ray, hit, alive, kb, False, b
        )
        return (
            (new_ray, keys_state, bounce_ok, sh2, base2),
            (contrib_prev, factor, segments),
        )

    # level 0: coherent tile path, unrolled
    kb0 = sampling.fold(keys, jnp.asarray(0))
    hit0 = closest_hit(scene, tables, ray, coherent=True)
    new_ray, bounce_ok, sh, base, factor0, seg0 = shade(
        ray, hit0, jnp.ones(n, bool), kb0, True, 0
    )

    # L0 shadow rays are COHERENT after the tile sort (79-96% certified,
    # PERF.md) — resolve them with the tile prepass here, unrolled; only
    # the residual joins iteration 1's pooled traversal. Without this the
    # pooled schedule regressed 2.72 -> 2.55 (the L0 shadow bulk swamped
    # the saved machinery).
    from ..intersect import DENSE_TRI_ROWS, TILED_MIN_RAYS

    clusters = tables.get("clusters")
    Lh = len(sh)
    use_prepass = (
        scene.n_tris
        and clusters is not None
        and tables["bvh"].leaves.shape[0] > DENSE_TRI_ROWS
        and Lh * n >= TILED_MIN_RAYS
    )
    if use_prepass:
        from ..intersect import prim_occluded, tiled_anyhit_prepass

        pos0 = base[4]
        bpos = cat3([pos0] * Lh)
        bwi = cat3([wi for wi, *_ in sh])
        blim = jnp.concatenate([s[2] for s in sh])
        pocc = prim_occluded(scene, tables, Ray(bpos, bwi), blim)
        live = (blim > scene.t_min) & ~pocc
        tocc, tcert = tiled_anyhit_prepass(
            clusters, Ray(bpos, bwi), scene.t_min, blim, live
        )
        pre_occ_all = pocc | tocc
        resolved_all = ~live | tcert | tocc
        sh = tuple(
            (
                wi, contrib,
                jnp.where(resolved_all[i * n : (i + 1) * n], -1.0, limit),
                resolved_all[i * n : (i + 1) * n],
                pre_occ_all[i * n : (i + 1) * n],
            )
            for i, (wi, contrib, limit, _, _) in enumerate(sh)
        )

    carry = (new_ray, keys, bounce_ok, sh, base)
    carry, (contribs_s, factors_s, segments_s) = jax.lax.scan(
        body, carry, jnp.arange(1, max_bounces + 1)
    )

    # final level's shadows: one standalone batched occlusion query
    _, _, _, sh_last, base_last = carry
    L = len(sh_last)
    bpos = cat3([base_last[4]] * L)
    bwi = cat3([wi for wi, *_ in sh_last])
    blim = jnp.concatenate([sh_l[2] for sh_l in sh_last])
    occ = occluded(scene, tables, Ray(bpos, bwi), blim, coherent=False)
    occs_last = [occ[i * n : (i + 1) * n] for i in range(L)]
    contrib_last = assemble(base_last, sh_last, occs_last)

    contribs = jax.tree_util.tree_map(
        lambda s, l: jnp.concatenate([s, l[None]]), contribs_s, contrib_last
    )
    factors = jax.tree_util.tree_map(
        lambda f0, fs: jnp.concatenate([f0[None], fs]), factor0, factors_s
    )
    segments = jnp.concatenate([seg0[None], segments_s])

    def back(L_, level_data):
        contrib, factor = level_data
        indirect = (factor * L_).minimum(FIREFLY_CLAMP)
        return contrib + indirect, None

    L0, _ = jax.lax.scan(back, Vec3.zeros(n), (contribs, factors),
                         reverse=True)
    if return_stats:
        return L0, jnp.sum(segments)
    return L0


# ---------------------------------------------------------------------------
# Media branch (renderer.rs:188-285)


def trace_volumetric(scene, tables, ray: Ray, keys, max_depth: int = 32,
                     return_stats: bool = False):
    """Radiance with a participating medium (scene.media[0] only, matching
    the reference's TODO at renderer.rs:189)."""
    n = ray.origin.shape[0]
    materials = tables["materials"]
    medium = scene.media[0]
    zero = Vec3.zeros(n)
    n_shadow = sum(1 for l in scene.lights if l.kind != "ambient")

    def level(carry, b):
        ray, keys_state, throughput, L, alive = carry
        kb = sampling.fold(keys_state, jnp.asarray(b))

        d, _d_pdf, _d_cdf = medium.sample_d(ray, sampling.fold(kb, 1))
        hit = closest_hit(scene, tables, ray)
        has_hit = hit.valid
        max_dist = jnp.where(has_hit, hit.time, BACKGROUND_DIST)
        medium_event = alive & (d < max_dist)
        surface_event = alive & ~medium_event & has_hit
        escape_event = alive & ~medium_event & ~has_hit

        wo = -ray.dir.normalize()
        collision = _sanitize(ray.at(d), medium_event)
        surf_pos = _sanitize(ray.at(hit.time), surface_event)
        mat = materials.lookup(hit.material)

        # --- per-level emitted/NEE contribution -------------------------
        emit_surf = where((b == 0) & surface_event, mat.color_query() * mat.emittance_query(), zero)
        emm = medium.emission(collision)
        med_color_c = medium.color(collision)
        emit_med = where((b == 0) & medium_event, med_color_c * emm, zero)
        # miss contributes env only when the flight distance reached past
        # the background (renderer.rs:198-205)
        env = where(
            escape_event & (d >= BACKGROUND_DIST), scene.env_color(tables, ray.dir), zero
        )

        # shared shadow ray: position depends on the event kind
        nee_pos = where(medium_event, collision, surf_pos)
        nee_surf = sample_lights(scene, tables, mat, nee_pos, hit.normal, wo,
                                 sampling.fold(kb, 2), mask=surface_event)
        nee_med = sample_lights_for_media(
            scene, tables, medium, nee_pos, wo, sampling.fold(kb, 3),
            mask=medium_event,
        )

        contrib = (
            emit_surf
            + emit_med
            + env
            + where(surface_event, nee_surf, zero)
            + where(medium_event, nee_med, zero)
        )
        L = L + throughput * contrib

        # --- Russian roulette continuation (p = 0.8) --------------------
        u = sampling.uniform(sampling.fold(kb, 4))
        survive = u < RR_P

        # surface continuation (renderer.rs:222-234)
        wi_s, pdf_s, valid_s = sample_f(mat, hit.normal, wo, sampling.fold(kb, 5))
        f = bsdf(mat, hit.normal, wo, wi_s)
        surf_factor = f * (jnp.abs(wi_s.dot(hit.normal)) / (jnp.maximum(pdf_s, 1e-20) * RR_P))

        # medium continuation (renderer.rs:262-281)
        abs_c = medium.absorption(collision)
        scat_c = medium.scattering(collision)
        ext_c = abs_c + scat_c
        wi_m, ph_p = medium.sample_ph(wo, sampling.fold(kb, 6))
        ph = medium.phase(wo, wi_m)
        med_factor = med_color_c * ((scat_c / ext_c) * ph / (jnp.maximum(ph_p, 1e-20) * RR_P))

        cont = survive & (medium_event | (surface_event & valid_s))
        throughput = throughput * where(medium_event, med_factor, surf_factor)
        throughput = where(cont, throughput, zero)
        dead_pos, dead_dir = _dead_ray_fields(n)
        new_ray = Ray(
            where(cont, where(medium_event, collision, surf_pos), dead_pos),
            where(cont, where(medium_event, wi_m, wi_s), dead_dir),
        )
        segments = jnp.sum(alive) + jnp.sum(medium_event | surface_event) * n_shadow
        return (new_ray, keys_state, throughput, L, cont), segments

    init = (ray, keys, Vec3.ones(n), zero, jnp.ones(n, bool))
    (_, _, _, L, _), segments = jax.lax.scan(level, init, jnp.arange(max_depth))
    if return_stats:
        return L, jnp.sum(segments)
    return L
