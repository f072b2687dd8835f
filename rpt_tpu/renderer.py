"""Renderer: the builder-style front end and the jitted render launches.

Parity: `/root/reference/src/renderer.rs:23-184`. Same fields and defaults
(renderer.rs:60-75); ``render``/``iterative_render`` mirror
renderer.rs:137-156. Execution model: one jitted launch traces one sample
for every pixel as a single wavefront (camera ray generation + integrator
scan); ``lax.scan`` over the per-call sample count; the host accumulates
per-call means into the ``Buffer`` (exactly one buffer sample per
``sample()`` call, as the reference does).
"""

from __future__ import annotations

import functools

import time as _time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from . import sampling
from .buffer import Buffer, Filter
from .camera import Camera
from .dtypes import DTYPE
from .integrators.path import trace_surface, trace_volumetric

from .scene import CompiledScene, Scene



@jax.jit
def _masked_power_avg(rows, n):
    """Mean |power| over the valid prefix of a fixed-cap photon buffer."""
    w = (jnp.arange(rows.shape[0]) < n).astype(jnp.float32)
    s = jnp.sum(jnp.linalg.norm(rows[:, 6:9], axis=1) * w)
    return s / jnp.maximum(n.astype(jnp.float32), 1.0)


@dataclass
class Renderer:
    """Builder object (renderer.rs:23-134). Chainable setters return self
    for reference-style call chains."""

    scene: Scene
    camera: Camera
    width_: int = 800
    height_: int = 600
    exposure_value_: float = 0.0
    filter_: Filter = Filter()
    stepsize_: float = 0.0
    max_bounces_: int = 0
    num_samples_: int = 1
    gather_size_: int = 50
    gather_size_volume_: int = 50
    watts_: float = 100.0
    seed_: int = 0
    media_max_depth_: int = 32

    def __post_init__(self):
        self._compiled: CompiledScene | None = None
        self.ray_counter = RayCounter()

    # builder setters ----------------------------------------------------
    def width(self, v):
        self.width_ = int(v)
        return self

    def height(self, v):
        self.height_ = int(v)
        return self

    def exposure_value(self, v):
        self.exposure_value_ = float(v)
        return self

    def filter(self, f: Filter):
        self.filter_ = f
        return self

    def stepsize(self, v):
        self.stepsize_ = float(v)
        return self

    def max_bounces(self, v):
        self.max_bounces_ = int(v)
        return self

    def num_samples(self, v):
        self.num_samples_ = int(v)
        return self

    def gather_size(self, v):
        self.gather_size_ = int(v)
        return self

    def gather_size_volume(self, v):
        self.gather_size_volume_ = int(v)
        return self

    def watts(self, v):
        self.watts_ = float(v)
        return self

    def seed(self, v):
        self.seed_ = int(v)
        return self

    def media_max_depth(self, v):
        self.media_max_depth_ = int(v)
        return self

    def profile(self, trace_dir: str):
        """Capture a jax.profiler trace of the next render into
        ``trace_dir`` (viewable with tensorboard/xprof). The reference has
        no profiler (SURVEY.md §5.1); this is the device-side equivalent
        of its wall-clock callbacks."""
        self._profile_dir = trace_dir
        return self

    # ------------------------------------------------------------------
    @property
    def compiled(self) -> CompiledScene:
        if self._compiled is None:
            self._compiled = self.scene.compile()
        return self._compiled

    def _apply_preview(self):
        """RPT_TPU_PREVIEW=<scale> shrinks resolution/samples for smoke
        runs (CI / example sanity checks) without touching driver code."""
        import os

        scale = os.environ.get("RPT_TPU_PREVIEW")
        if scale:
            s = max(1, int(scale))
            self.width_ = max(8, self.width_ // s)
            self.height_ = max(8, self.height_ // s)
            cap = int(os.environ.get("RPT_TPU_PREVIEW_SAMPLES", "4"))
            self.num_samples_ = max(1, min(self.num_samples_, cap))

    def render(self) -> np.ndarray:
        """Path trace and return an (H, W, 3) sRGB u8 image
        (renderer.rs:137-141)."""
        self._apply_preview()
        buffer = Buffer(self.width_, self.height_, self.filter_)
        self.sample(self.num_samples_, buffer)
        return buffer.image()

    def iterative_render(self, callback_interval: int, callback):
        """Progressive render; callback(iteration, buffer) every
        ``callback_interval`` samples (renderer.rs:144-156)."""
        self._apply_preview()
        callback_interval = min(callback_interval, self.num_samples_)
        buffer = Buffer(self.width_, self.height_, self.filter_)
        iteration = 0
        while iteration < self.num_samples_:
            steps = min(self.num_samples_ - iteration, callback_interval)
            self.sample(steps, buffer)
            iteration += steps
            callback(iteration, buffer)
        return buffer

    def sample(self, iterations: int, buffer: Buffer):
        """Trace ``iterations`` paths per pixel; add ONE sample (their mean,
        exposure-scaled) to the buffer — mirroring renderer.rs:158-184."""
        scene = self.compiled
        fn = _render_launch(
            scene,
            self.camera,
            self.width_,
            self.height_,
            self.max_bounces_,
            self.media_max_depth_,
            int(iterations),
        )
        key = jax.random.key(self.seed_)
        t0 = _time.perf_counter()
        profile_dir = getattr(self, "_profile_dir", None)
        if profile_dir:
            self._profile_dir = None
            with jax.profiler.trace(profile_dir):
                out = fn(scene.tables, key, jnp.asarray(self._sample_index, jnp.int32))
                jax.block_until_ready(out)
        else:
            out = fn(scene.tables, key, jnp.asarray(self._sample_index, jnp.int32))
        total = np.asarray(out).astype(np.float64)
        self._sample_index += iterations
        elapsed = _time.perf_counter() - t0
        self.ray_counter.record(scene, self.width_, self.height_, iterations,
                                self.max_bounces_, self.media_max_depth_, elapsed)
        mean = total / iterations * (2.0**self.exposure_value_)
        buffer.add_samples(mean.reshape(self.height_, self.width_, 3))

    _sample_index: int = 0

    # ------------------------------------------------------------------
    # Photon mapping (photon.rs:642-720)

    def photon_map_render(self, photon_count: int) -> np.ndarray:
        """Point-photon / point-query photon mapping (photon.rs:650-652)."""
        return self.photon_render(photon_count, "photon_map")

    def photon_point_query_beam_render(self, photon_count: int) -> np.ndarray:
        """Point-photon / beam-query (photon.rs:642-644)."""
        return self.photon_render(photon_count, "point_beam")

    def photon_beam_query_beam_render(self, photon_count: int) -> np.ndarray:
        """Beam-photon / beam-query (photon.rs:646-648)."""
        return self.photon_render(photon_count, "beam_beam")

    def photon_render(self, photon_count: int, kind: str,
                      occlusion_check: bool = True) -> np.ndarray:
        import os

        from .integrators import photon as ph

        self._apply_preview()
        if os.environ.get("RPT_TPU_PREVIEW"):
            cap = int(os.environ.get("RPT_TPU_PREVIEW_PHOTONS", "5000"))
            photon_count = min(photon_count, cap)
        scene = self.compiled
        key = jax.random.key(self.seed_)
        print("Shooting photons")
        t0 = _time.perf_counter()
        surface, n_s, volume, n_v = ph.shoot_photons_device(
            scene, scene.tables, jax.random.fold_in(key, 1), photon_count,
            self.watts_, kind,
        )
        jax.block_until_ready((surface, volume))
        t_shoot = _time.perf_counter() - t0
        print(f"PhotonList(surface: {n_s}, volume: {n_v})")
        for name, rows, nn in (("surface", surface, n_s), ("vol", volume, n_v)):
            # masked mean |power| computed on device (rows are fixed-cap
            # buffers — count-shaped slices would recompile per seed);
            # only the scalar crosses the link
            avg = (float(_masked_power_avg(rows, jnp.int32(nn)))
                   if nn else float("nan"))
            print(f"{name} avg: {avg}")

        print("Building kdtree")
        t0 = _time.perf_counter()
        rng = np.random.default_rng(self.seed_ + 17)
        pmap = ph.build_photon_map(
            scene, scene.tables, surface, volume, kind,
            self.gather_size_, self.gather_size_volume_, rng,
            n_surface=n_s, n_volume=n_v,
        )
        jax.block_until_ready(pmap)
        t_build = _time.perf_counter() - t0

        print("Tracing rays")
        t0 = _time.perf_counter()
        # Bound the work of one dispatch: the camera pass runs in sample
        # groups sized inversely to the pixel count (~10 spp at 128^2,
        # 1 spp at 512^2). Per-sample RNG streams use absolute indices,
        # so grouping never changes the estimate.
        group = int(os.environ.get(
            "RPT_TPU_PHOTON_SPP_GROUP",
            str(max(1, (10 * 16384) // max(self.width_ * self.height_, 1))),
        ))
        ckey = jax.random.fold_in(key, 2)
        mean = None
        s0 = 0
        while s0 < self.num_samples_:
            g = min(group, self.num_samples_ - s0)
            fn = _photon_launch(
                scene, self.camera, self.width_, self.height_, kind,
                self.gather_size_, self.gather_size_volume_, g,
                occlusion_check,
            )
            out = np.asarray(
                fn(scene.tables, pmap, ckey, jnp.int32(s0))
            ).astype(np.float64)
            mean = out if mean is None else mean + out
            s0 += g
        mean = mean / self.num_samples_ * (2.0**self.exposure_value_)
        t_trace = _time.perf_counter() - t0
        # shoot/build/trace wall split for PERF.md + bench_extra
        self.phase_seconds = {"shoot": t_shoot, "build": t_build, "trace": t_trace}
        print(
            f"photon phases: shoot {t_shoot:.1f}s build {t_build:.1f}s "
            f"trace {t_trace:.1f}s"
        )
        buffer = Buffer(self.width_, self.height_, self.filter_)
        buffer.add_samples(mean.reshape(self.height_, self.width_, 3))
        self._last_buffer = buffer
        self._last_photon_map = pmap
        return buffer.image()


class RayCounter:
    """Rays/sec instrumentation (the reference has none; SURVEY §5.1)."""

    def __init__(self):
        self.rays = 0
        self.seconds = 0.0

    def record(self, scene, width, height, iterations, max_bounces, media_depth, elapsed):
        paths = width * height * iterations
        # camera segments + one shadow segment per non-ambient light per hit
        n_shadow = sum(1 for l in scene.lights if l.kind != "ambient")
        if scene.media:
            segs = 1.0 / (1.0 - 0.8)  # expected path length under RR p=0.8
        else:
            segs = max_bounces + 1
        self.rays += int(paths * segs * (1 + n_shadow))
        self.seconds += elapsed

    @property
    def mrays_per_sec(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds else 0.0


def _morton2(px: np.ndarray, py: np.ndarray) -> np.ndarray:
    """Interleave 16-bit pixel coords -> 32-bit Morton codes."""

    def expand(v):
        v = (v | (v << 8)) & np.uint32(0x00FF00FF)
        v = (v | (v << 4)) & np.uint32(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint32(0x33333333)
        v = (v | (v << 1)) & np.uint32(0x55555555)
        return v

    return (expand(py.astype(np.uint32)) << np.uint32(1)) | expand(px.astype(np.uint32))


def _pixel_grid(width: int, height: int):
    """Pixel NDC coordinates in MORTON order, so consecutive wavefront
    lanes are spatially coherent (the tile-binned traversal groups 256
    consecutive rays into a beam — rpt_tpu.tiled). Per-pixel RNG streams
    fold by pixel id, so the rendered image is identical to raster order.

    Returns (xn, yn, pixel_ids, inv) with inv[pixel] = wavefront lane.
    """
    n_pix = width * height
    xs = np.arange(n_pix, dtype=np.int64)
    px = xs % width
    py = xs // width
    perm = np.argsort(_morton2(px, py), kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = xs
    dim = float(max(width, height))
    # NDC mapping (renderer.rs:174-176): y flipped, aspect via max(w, h)
    xn = (2.0 * px[perm].astype(np.float64) + 1.0 - width) / dim
    yn = (2.0 * (height - py[perm]).astype(np.float64) - 1.0 - height) / dim
    return xn, yn, perm, inv


def build_launch(scene: CompiledScene, camera: Camera, width: int, height: int,
                 max_bounces: int, media_max_depth: int, n_samples: int):
    """Build a (jittable, un-jitted) render launch: ``n_samples`` paths per
    pixel, summed on device (one ``lax.scan`` over samples; one wavefront
    per sample).

    Returns fn(tables, key, sample_index0) -> (H*W, 3) radiance sum.
    """
    n_pix = width * height
    dim = float(max(width, height))
    xn_np, yn_np, pixel_ids, inv_np = _pixel_grid(width, height)

    def launch(tables, key, sample_index0):
        xn = jnp.asarray(xn_np, DTYPE)
        yn = jnp.asarray(yn_np, DTYPE)
        pix_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.asarray(pixel_ids, jnp.int32)
        )

        def one_sample(acc, s):
            keys = sampling.fold(pix_keys, sample_index0 + s)
            jx = sampling.uniform(sampling.fold(keys, 1), -1.0 / dim, 1.0 / dim)
            jy = sampling.uniform(sampling.fold(keys, 2), -1.0 / dim, 1.0 / dim)
            ray = camera.cast_ray(xn + jx, yn + jy, sampling.fold(keys, 3))
            trace_keys = sampling.fold(keys, 4)
            if scene.media:
                color = trace_volumetric(scene, tables, ray, trace_keys, media_max_depth)
            else:
                color = trace_surface(scene, tables, ray, trace_keys, max_bounces)
            return acc + color.to_array().astype(jnp.float32), None

        acc0 = jnp.zeros((n_pix, 3), jnp.float32)
        total, _ = jax.lax.scan(one_sample, acc0, jnp.arange(n_samples))
        return jnp.take(total, jnp.asarray(inv_np, jnp.int32), axis=0)

    return launch


@functools.lru_cache(maxsize=16)
def _photon_launch(scene: CompiledScene, camera: Camera, width: int, height: int,
                   kind: str, gather_size: int, gather_size_volume: int,
                   n_samples: int, occlusion_check: bool):
    """Photon-map camera pass (photon.rs:950-985): one estimate_indirect per
    pixel sample (no camera recursion). Returns a jitted
    fn(tables, pmap, key) -> (H*W, 3) radiance sum, cached per
    configuration like `_render_launch` (a recompile costs far more than a
    launch)."""
    from .integrators.photon import estimate_indirect

    n_pix = width * height
    dim = float(max(width, height))
    xn_np, yn_np, pixel_ids, inv_np = _pixel_grid(width, height)
    # k-NN gather windows cost ~(window/8) 512 B block rows per query
    # lane; an unchunked 512x512 wavefront with a 2048-wide window would
    # allocate tens of GB. lax.map over pixel chunks bounds peak memory.
    CH = 16384

    def launch(tables, pmap, key, s0):
        xn = jnp.asarray(xn_np, DTYPE)
        yn = jnp.asarray(yn_np, DTYPE)
        pix_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
            jnp.asarray(pixel_ids, jnp.int32)
        )

        def one_sample(acc, s):
            keys = sampling.fold(pix_keys, s)
            jx = sampling.uniform(sampling.fold(keys, 1), -1.0 / dim, 1.0 / dim)
            jy = sampling.uniform(sampling.fold(keys, 2), -1.0 / dim, 1.0 / dim)
            ray = camera.cast_ray(xn + jx, yn + jy, sampling.fold(keys, 3))
            ekeys = sampling.fold(keys, 4)
            if n_pix > CH:
                n_pad = -(-n_pix // CH) * CH
                pad = n_pad - n_pix

                def padf(a):
                    return jnp.concatenate([a, a[:pad]]) if pad else a

                ray_c, keys_c = jax.tree_util.tree_map(
                    lambda a: padf(a).reshape((n_pad // CH, CH) + a.shape[1:]),
                    (ray, ekeys),
                )
                out = jax.lax.map(
                    lambda rc: estimate_indirect(
                        scene, tables, pmap, rc[0], rc[1],
                        gather_size, gather_size_volume, occlusion_check,
                    ).to_array().astype(jnp.float32),
                    (ray_c, keys_c),
                )
                color = out.reshape(n_pad, 3)[:n_pix]
            else:
                color = estimate_indirect(
                    scene, tables, pmap, ray, ekeys,
                    gather_size, gather_size_volume, occlusion_check,
                ).to_array().astype(jnp.float32)
            return acc + color, None

        acc0 = jnp.zeros((n_pix, 3), jnp.float32)
        # absolute sample indices s0..s0+n_samples: groups of a multi-
        # group render continue the same per-sample RNG streams, so the
        # radiance sum is invariant to the grouping (up to f32 order)
        total, _ = jax.lax.scan(one_sample, acc0, s0 + jnp.arange(n_samples))
        return jnp.take(total, jnp.asarray(inv_np, jnp.int32), axis=0)

    return jax.jit(launch)


@functools.lru_cache(maxsize=16)
def _render_launch(scene: CompiledScene, camera: Camera, width: int, height: int,
                   max_bounces: int, media_max_depth: int, n_samples: int):
    """Jitted `build_launch`, cached per (scene structure, camera, size,
    bounces, samples)."""
    return jax.jit(
        build_launch(scene, camera, width, height, max_bounces, media_max_depth, n_samples)
    )
