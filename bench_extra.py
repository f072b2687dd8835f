"""Secondary benchmarks (PERF.md artifacts): the analytic-prim fast path
(sphere scene), the dense-tri path (cornell), and a photon-map workload.
Prints one JSON line per metric; bench.py remains the driver headline.
"""

import json
import math
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import rpt_tpu as rpt


def _mrays(renderer, spp, bounces):
    renderer.num_samples(spp).max_bounces(bounces)
    buffer = rpt.Buffer(renderer.width_, renderer.height_, renderer.filter_)
    # warmup with the SAME spp: the launch is jit-cached per sample count,
    # so a 1-sample warmup leaves the timed call paying a fresh compile
    renderer.sample(spp, buffer)
    rc0 = renderer.ray_counter.rays
    t0 = time.perf_counter()
    renderer.sample(spp, buffer)
    dt = time.perf_counter() - t0
    rays = renderer.ray_counter.rays - rc0
    return rays / dt / 1e6, dt


def sphere_metric():
    scene = rpt.Scene()
    scene.add(rpt.Object(rpt.sphere()))
    scene.add(rpt.Object(rpt.plane((0, 1, 0), -1.0)).material(
        rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))))
    scene.add(rpt.Light.Object(rpt.Object(
        rpt.sphere().scale((2, 2, 2)).translate((0, 12, 0))).material(
        rpt.Material.light(rpt.hex_color(0xFFFFFF), 40.0))))
    cam = rpt.Camera.look_at((-2.5, 4, 6.5), (0, -0.25, 0), (0, 1, 0), math.pi / 4)
    r = rpt.Renderer(scene, cam).width(960).height(540).seed(1)
    mrays, dt = _mrays(r, 100, 2)
    return {"metric": "sphere_960x540_analytic_mrays_per_sec", "value": round(mrays, 1),
            "unit": "Mrays/s", "vs_baseline": None}


def cornell_metric():
    sys.path.insert(0, "examples")
    from cornell import build_scene, camera

    r = rpt.Renderer(build_scene(), camera()).width(512).height(512).seed(1)
    mrays, dt = _mrays(r, 100, 2)
    return {"metric": "cornell_512_mrays_per_sec", "value": round(mrays, 1),
            "unit": "Mrays/s", "vs_baseline": None}


def photon_metric():
    sys.path.insert(0, "examples")
    from _lampshade import build_scene, camera

    watts = 200_000.0 / (130.0 * 105.0)
    scene = build_scene(rpt.Material.light(rpt.hex_color(0xFFFEFA), watts))
    scene.add(rpt.Medium.homogeneous_isotropic(1e-4, 1e-3))
    photons = 1_000_000
    r = (rpt.Renderer(scene, camera()).width(128).height(128).max_bounces(10)
         .num_samples(10).gather_size(100).gather_size_volume(30)
         .watts(watts * photons).seed(1))
    t0 = time.perf_counter()
    img = r.photon_map_render(photons)
    dt = time.perf_counter() - t0
    assert np.isfinite(img).all()
    ph = {k: round(v, 1) for k, v in getattr(r, "phase_seconds", {}).items()}
    return {"metric": "photonmap_lampshade_128_1Mphotons_wall_s", "value": round(dt, 1),
            "unit": "s", "vs_baseline": None, "phases": ph}


if __name__ == "__main__":
    for fn in (sphere_metric, cornell_metric, photon_metric):
        print(json.dumps(fn()), flush=True)
