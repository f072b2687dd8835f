"""Smoke test of the renderer's main path on one NVIDIA GPU.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Phases (one GPU), each at the reference's own workload sizes through the
normal entry points:

1. device     -- JAX's default backend must be the GPU; no CPU fallback.
2. goldens    -- the six `tests/test_golden.py` renders, under its tolerances.
3. traversal  -- on the 871k-triangle dragon: tiled + deferred engines vs
                 the exact short-stack traversal, camera and bounce
                 wavefronts, closest hit and occlusion.
4. dragon     -- 512^2, 8 spp, 2 bounces (bench.py); cornell 512^2, 100 spp.
5. photons    -- lampshade point photons x beam query, and point x point.
6. sphere     -- the beam-query sphere sweep at the run's real shapes,
                 timed and checked against a float64 numpy reference.

Every phase prints its result and times (compile and steady seconds
apart) and the device's peak memory. Any failed phase makes the exit code
non-zero. The card's name and power limit (nvidia-smi) come on a line
before the last; the last line is one JSON object naming the device.
The persistent compile cache lives where `rpt_tpu.dtypes` puts it, so a
second run compiles less.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "examples"))
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import rpt_tpu as rpt  # noqa: E402

# dragon mean radiance sum (bench.py keys: seed 0, last of three launches)
DRAGON_RADIANCE = 3.2181
DRAGON_RADIANCE_RTOL = 0.01  # f32 summation order and Monte Carlo flips only
# traversal exactness: two engines may pick different triangles only where
# their hit times tie within this tolerance (the one tests/test_tiled.py
# uses), and may disagree on hit/miss (silhouette edges) on at most this
# share of lanes (also test_tiled's)
TIE_RTOL = 1e-5
TIE_ATOL = 1e-5
MAX_FLIP_SHARE = 3e-4
# the --multi comparison: per-pixel sums of the sharded and the one-card
# render differ only in float summation order
SHARD_RTOL = 1e-4
# photon deposit counts and power of two independent shoots of N photons
# differ by Monte Carlo noise ~ 1/sqrt(N); allow ten times that (1% at 1M)
SHOOT_MC_SCALE = 10.0


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peak_gib() -> float:
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0) / 2**30


def timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def check_device() -> jax.Device:
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (JAX's default backend is {backend!r}); "
            "this script runs only on the GPU"
        )
    return jax.devices()[0]


def result_line(dev: jax.Device, count: int) -> str:
    return json.dumps(
        {"ok": True, "device": {"platform": dev.platform,
                                "kind": dev.device_kind, "count": count}}
    )


# ---------------------------------------------------------------------------
# phase 2: goldens


def phase_goldens():
    import test_golden

    failed = []
    for name in ("sphere", "cornell", "volumetric_pathtrace",
                 "photon_map_surface", "photon_point_beam",
                 "photon_beam_beam"):
        t0 = time.perf_counter()
        try:
            getattr(test_golden, f"test_golden_{name}")()
        except AssertionError as e:
            log(f"  golden {name}: FAILED {e} ({time.perf_counter() - t0:.1f}s)")
            failed.append(name)
            continue
        log(f"  golden {name}: ok ({time.perf_counter() - t0:.1f}s)")
    assert not failed, f"goldens outside tests/test_golden.py's tolerances: {failed}"


# ---------------------------------------------------------------------------
# phase 3: traversal exactness


@functools.partial(jax.jit, static_argnames=("coherent",))
def _closest(bvh, clusters, ray, t_min, coherent=True):
    from rpt_tpu.intersect import mesh_closest

    n = ray.origin.shape[0]
    inf = jnp.full(n, jnp.inf, jnp.float32)
    return mesh_closest(bvh, ray, t_min, inf, clusters, coherent)[:2]


@functools.partial(jax.jit, static_argnames=("coherent",))
def _occluded(bvh, clusters, ray, t_min, limit, coherent=True):
    from rpt_tpu.intersect import bvh_any_hit

    return bvh_any_hit(bvh, ray, t_min, limit, clusters=clusters, coherent=coherent)


@jax.jit
def _normals(bvh, time_, tri):
    from rpt_tpu.intersect import _finish_hit
    from rpt_tpu.ray import Hit

    n = time_.shape[0]
    z = jnp.zeros(n, jnp.float32)
    # barycentrics 1/3 each: the face-average shading normal
    return _finish_hit(bvh, Hit.none((n,)), time_, tri, z + 1 / 3, z + 1 / 3,
                       z + 1 / 3).normal


def compare_closest(label, exact, fast):
    """Hit ids must agree except for ties; hit/miss flips are bounded."""
    (t_e, id_e), (t_f, id_f) = (tuple(np.asarray(a) for a in exact),
                                tuple(np.asarray(a) for a in fast))
    hit_e, hit_f = np.isfinite(t_e), np.isfinite(t_f)
    flips = hit_e != hit_f
    both = hit_e & hit_f
    diff_id = both & (id_e != id_f)
    with np.errstate(invalid="ignore"):  # inf - inf on shared misses
        tie = np.abs(t_e - t_f) <= TIE_ATOL + TIE_RTOL * np.abs(t_e)
    bad = diff_id & ~tie
    n = len(t_e)
    log(f"  {label}: {n} lanes, {hit_e.sum()} hits, id ties "
        f"{diff_id.sum()} ({diff_id.mean():.2e}), hit/miss flips {flips.sum()} "
        f"({flips.mean():.2e}), non-tie id mismatches {bad.sum()}")
    assert bad.sum() == 0, f"{label}: {bad.sum()} hit ids differ beyond ties"
    assert flips.mean() <= MAX_FLIP_SHARE, f"{label}: {flips.sum()} hit/miss flips"
    assert hit_e.sum() > n // 1000, f"{label}: too few hits to mean anything"


def compare_occlusion(label, occ_exact, occ_fast, t_closest, limit):
    occ_e, occ_f = np.asarray(occ_exact), np.asarray(occ_fast)
    t_c, lim = np.asarray(t_closest), np.asarray(limit)
    diff = occ_e != occ_f
    with np.errstate(invalid="ignore"):
        tie = np.abs(t_c - lim) <= TIE_ATOL + TIE_RTOL * np.abs(lim)
    bad = diff & ~tie
    log(f"  {label}: {len(occ_e)} lanes, {occ_e.sum()} occluded, disagreements "
        f"{diff.sum()} ({diff.mean():.2e}), beyond ties {bad.sum()}")
    assert bad.mean() <= MAX_FLIP_SHARE, f"{label}: {bad.sum()} occlusion mismatches"


def phase_traversal(scene, camera, width: int):
    from rpt_tpu import sampling
    from rpt_tpu.ray import Ray
    from rpt_tpu.renderer import _pixel_grid
    from rpt_tpu.vec import Vec3, where

    tables = scene.tables
    bvh, clusters = tables["bvh"], tables.get("clusters")
    assert clusters is not None, "the dragon mesh should carry cluster tables"
    cl_ah = tables.get("clusters_ah") or clusters
    t_min = scene.t_min
    xn, yn, pixel_ids, _ = _pixel_grid(width, width)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(5), i))(
        jnp.asarray(pixel_ids, jnp.int32))
    cam = jax.jit(camera.cast_ray)(jnp.asarray(xn, jnp.float32),
                                   jnp.asarray(yn, jnp.float32),
                                   sampling.fold(keys, 3))

    t0 = time.perf_counter()
    exact = _closest(bvh, None, cam, t_min)
    jax.block_until_ready(exact)
    t_first = time.perf_counter() - t0
    exact, t_exact = timed(_closest, bvh, None, cam, t_min)
    fast, _ = timed(_closest, bvh, clusters, cam, t_min, True)
    fast, t_fast = timed(_closest, bvh, clusters, cam, t_min, True)
    log(f"  camera closest: exact {t_exact * 1e3:.1f} ms (first call "
        f"{t_first:.1f}s), tiled+deferred {t_fast * 1e3:.1f} ms")
    compare_closest("camera closest", exact, fast)

    # cosine bounce from every camera hit (misses bounce from the eye)
    t_hit, tri = exact
    hit = jnp.isfinite(t_hit)
    nrm = _normals(bvh, t_hit, tri)
    nrm = nrm * jnp.where(nrm.dot(cam.dir) > 0, -1.0, 1.0)
    nrm = where(hit, nrm, Vec3.of(0.0, 1.0, 0.0).broadcast_to(t_hit.shape))
    org = cam.at(jnp.where(hit, t_hit, 0.0))
    r1, r2 = sampling.uniform2(sampling.fold(keys, 7))
    bdir, _ = sampling.cosine_hemisphere(r1, r2, nrm)
    bounce = Ray(org, bdir)
    exact_b, t_exact_b = timed(_closest, bvh, None, bounce, t_min)
    fast_b, _ = timed(_closest, bvh, clusters, bounce, t_min, False)
    fast_b, t_fast_b = timed(_closest, bvh, clusters, bounce, t_min, False)
    log(f"  bounce closest: exact {t_exact_b * 1e3:.1f} ms, deferred "
        f"{t_fast_b * 1e3:.1f} ms")
    compare_closest("bounce closest", exact_b, fast_b)

    # shadow rays toward the big spherical light, from both wavefronts
    bounce_org = bounce.at(jnp.where(jnp.isfinite(exact_b[0]), exact_b[0], 0.0))
    for label, origin, coherent in (("camera-hit shadow", org, True),
                                    ("bounce-hit shadow", bounce_org, False)):
        to = Vec3.of(0.0, 20.0, 3.0).broadcast_to(t_hit.shape) - origin
        dist = to.length()
        sray = Ray(origin, to / dist)
        limit = dist * (1.0 - scene.shadow_eps)
        occ_e, t_oe = timed(_occluded, bvh, None, sray, t_min, limit, coherent)
        occ_f, _ = timed(_occluded, bvh, cl_ah, sray, t_min, limit, coherent)
        occ_f, t_of = timed(_occluded, bvh, cl_ah, sray, t_min, limit, coherent)
        t_c, _ = _closest(bvh, None, sray, t_min)
        log(f"  {label}: exact {t_oe * 1e3:.1f} ms, fast {t_of * 1e3:.1f} ms")
        compare_occlusion(label, occ_e, occ_f, t_c, limit)


# ---------------------------------------------------------------------------
# phase 4: dragon and cornell


def phase_dragon(scene, expect_radiance: float | None = DRAGON_RADIANCE,
                 width: int = 512, spp: int = 8):
    import bench

    r = bench.measure_dragon(scene, width=width, spp=spp)
    log(f"  dragon {width}^2 x {spp} spp x {bench.MAX_BOUNCES} bounces: "
        f"compile {r['compile_s']:.1f}s, first run {r['first_run_s']:.3f}s, "
        f"steady {r['best_s']:.3f}s best of 3, {r['segments']} segments, "
        f"{r['mrays_per_s']:.2f} Mrays/s, mean radiance {r['mean_radiance']:.4f}, "
        f"matrix products in the compiled program {r['matmuls']}, "
        f"peak {peak_gib():.2f} GiB")
    assert r["finite"], "dragon image is not finite"
    assert r["matmuls"] == 0, "a matrix product (TF32 on the GPU) entered the launch"
    if expect_radiance is not None:
        rel = abs(r["mean_radiance"] - expect_radiance) / expect_radiance
        assert rel <= DRAGON_RADIANCE_RTOL, (
            f"dragon mean radiance {r['mean_radiance']:.4f} vs "
            f"{expect_radiance} ({rel:.2%} > {DRAGON_RADIANCE_RTOL:.0%})")
    return r


def phase_cornell(width: int = 512, spp: int = 100):
    from cornell import build_scene, camera

    r = rpt.Renderer(build_scene(), camera()).width(width).height(width).seed(1)
    r.num_samples(spp).max_bounces(2)
    buf = rpt.Buffer(width, width, r.filter_)
    t0 = time.perf_counter()
    r.sample(spp, buf)
    first = time.perf_counter() - t0
    rays0, secs0 = r.ray_counter.rays, r.ray_counter.seconds
    r.sample(spp, buf)
    steady = r.ray_counter.seconds - secs0
    mrays = (r.ray_counter.rays - rays0) / steady / 1e6
    img = buf.raw()
    log(f"  cornell {width}^2 x {spp} spp x 2 bounces: compile "
        f"{first - steady:.1f}s (first call {first:.1f}s), steady {steady:.3f}s, "
        f"{mrays:.2f} Mrays/s, mean {img.mean():.4f}, peak {peak_gib():.2f} GiB")
    assert np.isfinite(img).all() and img.mean() > 0, "cornell image is not finite"


# ---------------------------------------------------------------------------
# phase 5: photons


def lampshade_renderer(size, spp, gather, gather_volume, photons,
                       absorb=1e-4, scat=1e-3):
    from _lampshade import build_scene, camera

    watts = 200_000.0 / (130.0 * 105.0)
    scene = build_scene(rpt.Material.light(rpt.hex_color(0xFFFEFA), watts))
    scene.add(rpt.Medium.homogeneous_isotropic(absorb, scat))
    return (rpt.Renderer(scene, camera()).width(size).height(size).max_bounces(10)
            .num_samples(spp).gather_size(gather).gather_size_volume(gather_volume)
            .watts(watts * photons).seed(1))


def run_photons(label, renderer, photons, kind):
    """Two renders: the first compiles, the second is steady state."""
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        img = renderer.photon_render(photons, kind)
        runs.append((time.perf_counter() - t0, dict(renderer.phase_seconds)))
        assert np.isfinite(renderer._last_buffer.raw()).all(), f"{label}: not finite"
    (w0, p0), (w1, p1) = runs
    split = " / ".join(f"{k} {p1[k]:.2f}s (compile {p0[k] - p1[k]:.1f}s)"
                       for k in ("shoot", "build", "trace"))
    log(f"  {label}: steady wall {w1:.2f}s ({split}); first wall {w0:.1f}s; "
        f"mean {renderer._last_buffer.raw().mean():.4f}; peak {peak_gib():.2f} GiB")
    return img


def phase_photons(size=128, spp=10, photons=1_000_000):
    log(f"  point x beam: examples/volumetric_beamphoton_lampshade.py settings "
        f"with spp cut from 50 to {spp}")
    pb = lampshade_renderer(size, spp, 20, 3, photons)
    run_photons(f"lampshade point x beam {size}^2 x {spp} spp, {photons} photons",
                pb, photons, "point_beam")
    pm = lampshade_renderer(size, spp, 100, 30, photons)
    run_photons(f"lampshade point x point {size}^2 x {spp} spp, {photons} photons",
                pm, photons, "photon_map")
    return pb


# ---------------------------------------------------------------------------
# phase 6: the sphere sweep


def _sphere_reference(o, d, t_hit, ext, pos, rad, pw, phase_const, chunk=1 << 16):
    """float64 numpy sweep: the plain reference both device versions meet."""
    o, d, t_hit = (np.asarray(a, np.float64) for a in (o, d, t_hit))
    out = np.zeros((len(o), 3))
    for s in range(0, len(rad), chunk):
        p, r, w = (np.asarray(a[s:s + chunk], np.float64) for a in (pos, rad, pw))
        oc = p[None] - o[:, None]
        oc2 = (oc * oc).sum(-1)
        dd = (oc * d[:, None]).sum(-1)
        dist2 = np.maximum(oc2 - dd * dd, 0.0)
        r2 = np.maximum(r * r, 1e-30)[None]
        ok = (dd > 0) & (dist2 < r2) & (np.sqrt(oc2) <= t_hit[:, None]) & (r > 0)[None]
        k = np.where(ok, (3 / np.pi) * (1 - dist2 / r2) ** 2 / r2
                     * np.exp(-ext * dd) * phase_const, 0.0)
        out += k @ w
    return out


def phase_sphere_sweep(renderer, reps: int = 5):
    """The point x beam sweep at the run's real shapes: timed alone, and
    checked against the float64 reference on a slice of the rays."""
    from rpt_tpu import sampling
    from rpt_tpu.integrators import photon as ph
    from rpt_tpu.intersect import closest_hit
    from rpt_tpu.ray import Hit
    from rpt_tpu.renderer import _pixel_grid
    from rpt_tpu.vec import Vec3

    scene, pmap = renderer.compiled, renderer._last_photon_map
    medium = scene.media[0]
    size = renderer.width_
    n_sph = pmap.n_spheres
    xn, yn, pixel_ids, _ = _pixel_grid(size, size)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(9), i))(
        jnp.asarray(pixel_ids, jnp.int32))

    @jax.jit
    def camera_wavefront(tables):
        ray = renderer.camera.cast_ray(jnp.asarray(xn, jnp.float32),
                                       jnp.asarray(yn, jnp.float32),
                                       sampling.fold(keys, 3))
        return ray, closest_hit(scene, tables, ray).time

    ray, t_hit = camera_wavefront(scene.tables)
    hit = Hit(t_hit, Vec3.zeros(t_hit.shape), jnp.zeros(t_hit.shape, jnp.int32))
    sweep = jax.jit(lambda pm, r, h: ph.volume_estimate_spheres(pm, medium, r, h).to_array())
    _, first = timed(sweep, pmap, ray, hit)
    out, steady = min((timed(sweep, pmap, ray, hit) for _ in range(reps)),
                      key=lambda a: a[1])
    log(f"  sweep alone, {t_hit.shape[0]} rays x {n_sph} spheres "
        f"(table {pmap.spheres['pos4'].shape[0]}): {steady * 1e3:.2f} ms "
        f"(first call {first:.1f}s)")

    out = np.asarray(out)
    o, d = np.asarray(ray.origin.to_array()), np.asarray(ray.dir.to_array())
    t_inf = np.where(np.isfinite(np.asarray(t_hit)), np.asarray(t_hit), np.inf)
    med = np.asarray(medium.color(Vec3.zeros(t_hit.shape)).to_array())
    ext = float(np.asarray(medium.extinction(Vec3.zeros((1,))))[0])
    sel = np.arange(0, len(o), max(1, len(o) // 256))
    sp = pmap.spheres
    ref = _sphere_reference(
        o[sel], d[sel], t_inf[sel], ext, np.asarray(sp["pos4"])[:n_sph, :3],
        np.asarray(sp["radius"])[:n_sph], np.asarray(sp["power"].to_array())[:n_sph],
        float(medium.phase_const)) * med[sel]
    err = np.abs(out[sel] - ref).max() / max(np.abs(ref).max(), 1e-30)
    log(f"  sweep vs float64 reference on {len(sel)} rays: max diff / max {err:.2e}")
    assert np.isfinite(out).all() and (ref > 0).any()
    assert err < 1e-3, f"sweep disagrees with the reference ({err:.2e})"


# ---------------------------------------------------------------------------
# --multi: four cards


def phase_multi(n_cards: int = 4, dragon_scene=None, size=512, spp=8,
                photons=1 << 18, lamp_size=128, lamp_spp=10):
    """The sharded paths on an (dp=2, sp=2) mesh of ``n_cards`` against the
    same calls on a one-card mesh. Every sharded call compiles afresh, so
    the one-card and n-card versions of each call run in two threads and
    their compiles overlap."""
    from concurrent.futures import ThreadPoolExecutor

    import bench
    from rpt_tpu.integrators.photon import build_photon_map
    from rpt_tpu.parallel import (make_mesh, photon_render_sharded, render_sharded,
                                  shoot_photons_sharded)

    devs = jax.devices()
    assert len(devs) >= n_cards, f"need {n_cards} devices, have {len(devs)}"
    meshes = {"1 card": make_mesh(1, sp=1, devices=devs[:1]),
              f"{n_cards} cards": make_mesh(n_cards, sp=2, devices=devs)}
    one, many = meshes
    key = jax.random.key(0)

    def both(label, fn, *args):
        """fn(*args, mesh) on every mesh at once -> {mesh name: result}."""
        def run(name):
            t0 = time.perf_counter()
            out = fn(*args, meshes[name])
            log(f"  {label} on {name} (mesh {dict(meshes[name].shape)}): "
                f"{time.perf_counter() - t0:.1f}s with compile")
            return out

        with ThreadPoolExecutor(len(meshes)) as pool:
            return dict(zip(meshes, pool.map(run, meshes)))

    def compare(label, outs):
        a, b = (np.asarray(outs[k], np.float64) for k in (many, one))
        assert np.isfinite(a).all() and np.isfinite(b).all(), f"{label}: not finite"
        rel = np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30)
        worst = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        log(f"  {label}: rel L1 diff {rel:.2e}, max diff / max {worst:.2e}")
        assert rel <= SHARD_RTOL, f"{label}: sharded and one-card sums differ ({rel:.2e})"

    scene = dragon_scene if dragon_scene is not None else bench.build_scene().compile()
    lamp = lampshade_renderer(lamp_size, lamp_spp, 100, 30, photons)
    cs = lamp.compiled
    with ThreadPoolExecutor(2) as pool:
        dragon = pool.submit(
            both, f"dragon render_sharded {size}^2 x {spp} spp",
            lambda mesh: render_sharded(scene, bench.dragon_camera(), size, size,
                                        spp, 2, mesh, key))
        shots = pool.submit(
            both, f"shoot_photons_sharded {photons} photons",
            lambda mesh: shoot_photons_sharded(cs, key, photons, lamp.watts_,
                                               "photon_map", mesh))
        dragon, shots = dragon.result(), shots.result()
    compare("dragon render_sharded", dragon)

    (s1, v1), (sn, vn) = shots[one], shots[many]
    tol = SHOOT_MC_SCALE / math.sqrt(photons)
    for label, a, b in (("surface count", len(sn), len(s1)),
                        ("volume count", len(vn), len(v1)),
                        ("surface power", sn[:, 6:9].sum(), s1[:, 6:9].sum()),
                        ("volume power", vn[:, 6:9].sum(), v1[:, 6:9].sum())):
        rel = abs(a - b) / max(abs(b), 1e-30)
        log(f"  shoot {label}: {n_cards} cards {a:.6g} vs 1 card {b:.6g}, rel diff "
            f"{rel:.2e} (limit {tol:.2e})")
        assert rel <= tol, f"shoot {label} differs by {rel:.2%}"

    pmap = build_photon_map(cs, cs.tables, s1, v1, "photon_map", 100, 30,
                            np.random.default_rng(17))
    imgs = both(f"photon_render_sharded {lamp_size}^2 x {lamp_spp} spp",
                lambda mesh: photon_render_sharded(
                    cs, lamp.camera, lamp_size, lamp_size, lamp_spp, pmap,
                    "photon_map", 100, 30, mesh, key))
    compare("lampshade photon_render_sharded", imgs)


# ---------------------------------------------------------------------------


def run_phase(name, fn, *args, failures, **kw):
    log(f"phase {name}: start")
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kw)
    except Exception:  # noqa: BLE001 - reported, and the exit code says so
        traceback.print_exc()
        sys.stderr.flush()
        log(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f}s)")
        failures.append(name)
        return None
    log(f"phase {name}: ok ({time.perf_counter() - t0:.1f}s, "
        f"peak {peak_gib():.2f} GiB)")
    return out


PHASES = ("goldens", "traversal", "dragon", "photons", "sphere")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    dev = check_device()
    card = card_line()
    log(f"phase device: ok ({dev.platform}, {dev.device_kind}, "
        f"{len(jax.devices())} visible; compile cache "
        f"{jax.config.jax_compilation_cache_dir})")
    failures: list[str] = []

    if args.multi:
        run_phase("multi", phase_multi, failures=failures)
    else:
        wanted = set(args.phases.split(","))
        unknown = wanted - set(PHASES)
        if unknown:
            ap.error(f"unknown phases {sorted(unknown)}")
        dragon = None
        if "goldens" in wanted:
            run_phase("goldens", phase_goldens, failures=failures)
        if wanted & {"traversal", "dragon"}:
            import bench

            t0 = time.perf_counter()
            dragon = bench.build_scene().compile()
            log(f"dragon scene: {dragon.n_tris} triangles, host build "
                f"{time.perf_counter() - t0:.1f}s")
        if "traversal" in wanted:
            run_phase("traversal", phase_traversal, dragon, bench.dragon_camera(),
                      512, failures=failures)
        if "dragon" in wanted:
            run_phase("dragon", phase_dragon, dragon, failures=failures)
            run_phase("cornell", phase_cornell, failures=failures)
        pb = None
        if wanted & {"photons", "sphere"}:
            pb = run_phase("photons", phase_photons, failures=failures)
        if "sphere" in wanted and pb is not None:
            run_phase("sphere", phase_sphere_sweep, pb, failures=failures)

    log(f"total {time.perf_counter() - t_start:.1f}s")
    log(card)
    if failures:
        log(f"FAILED phases: {', '.join(failures)}")
        return 1
    print(result_line(dev, len(jax.devices())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
