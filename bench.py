"""Benchmark: Mrays/sec/chip on the dragon-scale mesh scene at 512x512.

Mirrors the workload of the reference's `examples/dragon.rs:25-74`
(specular ~871k-triangle mesh + plane + ambient + two spherical area
lights, 2 bounces). The Stanford dragon OBJ is downloaded at run time by
the reference; with no network access we use a deterministic procedural
mesh of the same triangle count (`rpt_tpu.meshes.displaced_blob`), or the
real OBJ from ``data/dragon.obj`` if present.

Prints ONE JSON line: {"metric", "value", "unit", "device"}.
"""

import json
import math
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import rpt_tpu as rpt
from rpt_tpu import sampling
from rpt_tpu.dtypes import DTYPE
from rpt_tpu.integrators.path import trace_surface
from rpt_tpu.meshes import displaced_blob

WIDTH = HEIGHT = 512
SPP = 8
MAX_BOUNCES = 2


def check_backend(timeout_s: float | None = None, op=None) -> float:
    """Watchdog the first device op against a hung or failing backend.

    Run a tiny device op in a worker thread with a deadline; on timeout or
    error, emit ONE machine-readable JSON line and exit rc=2 fast, so a
    backend that never comes up leaves a diagnosable "backend
    unavailable" record instead of an outer timeout. Returns the probe's
    elapsed seconds on success.

    ``timeout_s``/``op`` are injection points for the outage-simulation
    test (tests/test_graft_entry.py / test_bench_watchdog).
    """
    import threading

    if timeout_s is None:
        # generous next to a healthy first dispatch (backend start-up is
        # seconds), short next to an outer run limit
        timeout_s = float(os.environ.get("RPT_TPU_BACKEND_TIMEOUT", "240"))
    done = threading.Event()
    errors: list[BaseException] = []

    def _probe():
        try:
            if op is None:
                x = jax.device_put(np.ones((8,), np.float32))
                np.asarray(x)  # full host->device->host round trip
            else:
                op()
        except BaseException as e:  # noqa: BLE001 - reported, not swallowed
            errors.append(e)
        finally:
            done.set()

    t0 = time.perf_counter()
    threading.Thread(target=_probe, daemon=True).start()
    ok = done.wait(timeout_s)
    if not ok or errors:
        detail = repr(errors[0]) if errors else f"device probe hung >{timeout_s:.0f}s"
        print(json.dumps({"error": "backend_unavailable", "detail": detail}))
        sys.stderr.write(f"# backend watchdog tripped: {detail}\n")
        sys.exit(2)
    return time.perf_counter() - t0


def load_dragon_mesh():
    path = os.path.join(os.path.dirname(__file__), "data", "dragon.obj")
    if os.path.exists(path):
        from rpt_tpu.io import load_obj

        return load_obj(path)
    # 660 x 661 grid -> ~871k triangles, matching the dragon's scale
    return displaced_blob(660, 661)


def build_scene() -> rpt.Scene:
    dragon = load_dragon_mesh()
    scene = rpt.Scene()
    scene.add(
        rpt.Object(
            dragon.scale((3.4, 3.4, 3.4)).rotate_y(math.pi / 2)
        ).material(rpt.Material.specular(rpt.hex_color(0xB7CA79), 0.1))
    )
    scene.add(
        rpt.Object(rpt.plane((0.0, 1.0, 0.0), -1.0)).material(
            rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))
        )
    )
    scene.add(rpt.Light.Ambient((0.01, 0.01, 0.01)))
    scene.add(
        rpt.Light.Object(
            rpt.Object(rpt.sphere().scale((2.0, 2.0, 2.0)).translate((0.0, 20.0, 3.0))).material(
                rpt.Material.light((1.0, 1.0, 1.0), 160.0)
            )
        )
    )
    scene.add(
        rpt.Light.Object(
            rpt.Object(
                rpt.sphere().scale((0.05, 0.05, 0.05)).translate((-1.0, 0.71, 0.0))
            ).material(rpt.Material.light(rpt.hex_color(0xFFAAAA), 400.0))
        )
    )
    return scene


def run_extra_metrics(budget_s: float) -> None:
    """Append the secondary workload metrics (sphere analytic path,
    cornell dense-tri path, photon map) to stderr, AFTER the dragon
    headline is already printed+flushed.

    Parse safety: a caller reads ONE JSON object from bench.py's stdout,
    so extras go to STDERR as `# extra {json}` lines.

    Budget safety: a hard SIGALRM backstop exits 0 after ``budget_s``
    (the headline is already out); each metric is also try/excepted so
    one failure can't mask the others.
    """
    import signal

    def _give_up(signum, frame):
        sys.stderr.write(f"# extra metrics hit the {budget_s:.0f}s budget; exiting\n")
        sys.stderr.flush()
        os._exit(0)

    signal.signal(signal.SIGALRM, _give_up)
    signal.alarm(int(budget_s))
    try:
        import bench_extra

        metrics = [bench_extra.sphere_metric, bench_extra.cornell_metric]
        if os.environ.get("RPT_TPU_BENCH_PHOTON", "1") == "1":
            metrics.append(bench_extra.photon_metric)
        for fn in metrics:
            try:
                sys.stderr.write(f"# extra {json.dumps(fn())}\n")
            except Exception as e:  # noqa: BLE001 - recorded, not fatal
                sys.stderr.write(
                    f"# extra {json.dumps({'metric': fn.__name__, 'error': repr(e)})}\n"
                )
            sys.stderr.flush()
    finally:
        signal.alarm(0)


def dragon_camera() -> rpt.Camera:
    return rpt.Camera.look_at(
        (-2.5, 4.0, 6.5), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), math.pi / 6
    )


def make_launch(scene, camera, width: int = WIDTH, height: int = HEIGHT,
                spp: int = SPP, max_bounces: int = MAX_BOUNCES):
    """Jitted fn(tables, key, s0) -> (radiance sum (H*W, 3), traced segment
    count) over ``spp`` samples, through the same `trace_surface` as
    `Renderer.render`."""
    n_pix = width * height
    dim = float(max(width, height))
    # Morton pixel order: consecutive wavefront lanes are spatially
    # coherent, which the tile-binned traversal converts into shared
    # cluster fetches (rpt_tpu.tiled)
    from rpt_tpu.renderer import _pixel_grid

    xn_np, yn_np, pixel_ids, _ = _pixel_grid(width, height)

    @jax.jit
    def launch(tables, key, s0):
        xn = jnp.asarray(xn_np, DTYPE)
        yn = jnp.asarray(yn_np, DTYPE)
        pix_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.asarray(pixel_ids, jnp.int32)
        )

        def one(acc, s):
            acc_img, acc_segs = acc
            keys = sampling.fold(pix_keys, s0 + s)
            jx = sampling.uniform(sampling.fold(keys, 1), -1.0 / dim, 1.0 / dim)
            jy = sampling.uniform(sampling.fold(keys, 2), -1.0 / dim, 1.0 / dim)
            ray = camera.cast_ray(xn + jx, yn + jy, sampling.fold(keys, 3))
            color, segs = trace_surface(
                scene, tables, ray, sampling.fold(keys, 4), max_bounces, return_stats=True
            )
            return (acc_img + color.to_array(), acc_segs + segs), None

        (img, segs), _ = jax.lax.scan(
            one, (jnp.zeros((n_pix, 3), DTYPE), jnp.zeros((), jnp.int32)), jnp.arange(spp)
        )
        return img, segs

    return launch


def measure_dragon(scene=None, reps: int = 3, width: int = WIDTH,
                   spp: int = SPP) -> dict:
    """Compile the dragon launch, then time ``reps`` launches of ``spp``
    samples each (sample indices continue across launches). Returns the
    best launch's Mrays/s from the traced segment count, the compile
    seconds, the matrix products left in the compiled program, and the
    last launch's mean radiance sum."""
    if scene is None:
        scene = build_scene().compile()
    launch = make_launch(scene, dragon_camera(), width, width, spp)
    key = jax.random.key(0)
    t0 = time.perf_counter()
    compiled = launch.lower(scene.tables, key, jnp.asarray(0, jnp.int32)).compile()
    compile_s = time.perf_counter() - t0
    hlo = compiled.as_text()
    t0 = time.perf_counter()
    img, segs = compiled(scene.tables, key, jnp.asarray(0, jnp.int32))
    int(segs)  # device->host sync
    first_s = time.perf_counter() - t0

    best = float("inf")
    for r in range(reps):
        t0 = time.perf_counter()
        img, segs = compiled(scene.tables, key, jnp.asarray((r + 1) * spp, jnp.int32))
        int(segs)
        best = min(best, time.perf_counter() - t0)
    total_rays = int(segs)
    img = np.asarray(img)
    return {
        "segments": total_rays,
        "best_s": best,
        "compile_s": compile_s,
        "first_run_s": first_s,
        "mrays_per_s": total_rays / best / 1e6,
        "mean_radiance": float(img.mean()),
        "finite": bool(np.isfinite(img).all()),
        "matmuls": hlo.count(" dot(") + hlo.count("gemm"),
    }


def main():
    probe_s = check_backend()
    sys.stderr.write(f"# backend probe ok in {probe_s:.1f}s\n")
    t_setup = time.perf_counter()
    scene = build_scene().compile()
    scene_s = time.perf_counter() - t_setup
    r = measure_dragon(scene)
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": "dragon_512_mrays_per_sec_per_chip",
                "value": round(r["mrays_per_s"], 2),
                "unit": "Mrays/s",
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )
    print(
        f"# {r['segments']} ray segments in {r['best_s']:.3f}s best-of-3; "
        f"scene build {scene_s:.1f}s; compile {r['compile_s']:.1f}s; "
        f"mean radiance {r['mean_radiance']:.4f}",
        file=sys.stderr,
    )
    sys.stdout.flush()
    sys.stderr.flush()
    extra_budget = float(os.environ.get("RPT_TPU_BENCH_EXTRA_BUDGET", "900"))
    if extra_budget > 0:
        run_extra_metrics(extra_budget)


if __name__ == "__main__":
    main()
