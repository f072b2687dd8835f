"""Multi-device execution: pixel/sample sharding over a device mesh.

The reference's entire parallelism model is rayon work-stealing over image
rows and photon indices (`renderer.rs:159-169`, `photon.rs:663-674`) on one
shared-memory host. The device-mesh equivalent (SURVEY.md §2.3, §5.8):

* **dp axis** — pixel blocks sharded across devices (the analog of row
  parallelism). Scene tables are replicated (they are small: even the
  dragon's triangles are ~60 MB).
* **sp axis** — samples-per-pixel sharded across devices; the per-pixel
  frame accumulation is a ``psum`` over 'sp'.

The mesh shape follows the algorithm alone: the devices of one host are
joined all to all, so no axis order is favoured.
* Photon shooting shards the photon index over the full mesh and
  ``all_gather``s deposited photons (see `rpt_tpu.integrators.photon`).

Everything is expressed with ``shard_map`` over a ``jax.sharding.Mesh`` —
XLA inserts the collectives.
"""

from __future__ import annotations


from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from . import sampling
from .dtypes import DTYPE
from .integrators.path import trace_surface, trace_volumetric


def make_mesh(n_devices: int | None = None, sp: int = 1, devices=None) -> Mesh:
    """Build a (dp, sp) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices]).reshape(n_devices // sp, sp)
    return Mesh(devices, ("dp", "sp"))


def render_sharded(scene, camera, width: int, height: int, num_samples: int,
                   max_bounces: int, mesh: Mesh, key, media_max_depth: int = 32):
    """Render with pixels sharded over 'dp' and samples over 'sp'.

    Returns the (H*W, 3) radiance *sum* over ``num_samples`` (host numpy).
    Pixel count is padded to a multiple of dp; samples must divide by sp.
    """
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    assert num_samples % sp == 0, "num_samples must divide the sp axis"
    n_pix = width * height
    pad = (-n_pix) % dp
    n_padded = n_pix + pad
    dim = float(max(width, height))

    xs = np.arange(n_padded, dtype=np.int64)
    px = (xs % width).astype(np.float64)
    py = (xs // width).astype(np.float64)
    xn = jnp.asarray((2.0 * px + 1.0 - width) / dim, DTYPE)
    yn = jnp.asarray((2.0 * (height - py) - 1.0 - height) / dim, DTYPE)
    pix_ids = jnp.asarray(xs, jnp.int32)

    local_samples = num_samples // sp

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp"), P(), P()),
        out_specs=P("dp"),
        # the integrator scans mix dp-varying pixel state with sp-varying
        # sample keys; skip the varying-manual-axes bookkeeping
        check_vma=False,
    )
    def launch(xn, yn, pix_ids, tables, key):
        sp_idx = jax.lax.axis_index("sp")
        pix_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(pix_ids)

        def one_sample(acc, s):
            keys = sampling.fold(pix_keys, sp_idx * local_samples + s)
            jx = sampling.uniform(sampling.fold(keys, 1), -1.0 / dim, 1.0 / dim)
            jy = sampling.uniform(sampling.fold(keys, 2), -1.0 / dim, 1.0 / dim)
            ray = camera.cast_ray(xn + jx, yn + jy, sampling.fold(keys, 3))
            tkeys = sampling.fold(keys, 4)
            if scene.media:
                color = trace_volumetric(scene, tables, ray, tkeys, media_max_depth)
            else:
                color = trace_surface(scene, tables, ray, tkeys, max_bounces)
            return acc + color.to_array().astype(jnp.float32), None

        acc0 = jnp.zeros((xn.shape[0], 3), jnp.float32)
        total, _ = jax.lax.scan(one_sample, acc0, jnp.arange(local_samples))
        # frame accumulation across the sample axis
        return jax.lax.psum(total, "sp")

    out = launch(xn, yn, pix_ids, scene.tables, key)
    return np.asarray(out)[:n_pix]


def photon_render_sharded(scene, camera, width: int, height: int,
                          num_samples: int, pmap, kind: str, gather_size: int,
                          gather_size_volume: int, mesh: Mesh, key,
                          occlusion_check: bool = True):
    """Photon-map camera pass with pixels sharded over 'dp' and samples
    over 'sp'; the photon map is replicated (it is small — §5.8). The
    device-mesh analog of the reference's row-parallel camera pass
    (photon.rs:704-717).

    Returns the (H*W, 3) radiance *sum* over ``num_samples`` (host numpy).
    """
    from .integrators.photon import estimate_indirect

    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    assert num_samples % sp == 0, "num_samples must divide the sp axis"
    n_pix = width * height
    pad = (-n_pix) % dp
    n_padded = n_pix + pad
    dim = float(max(width, height))

    xs = np.arange(n_padded, dtype=np.int64)
    px = (xs % width).astype(np.float64)
    py = (xs // width).astype(np.float64)
    xn = jnp.asarray((2.0 * px + 1.0 - width) / dim, DTYPE)
    yn = jnp.asarray((2.0 * (height - py) - 1.0 - height) / dim, DTYPE)
    pix_ids = jnp.asarray(xs, jnp.int32)

    local_samples = num_samples // sp

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp"), P(), P(), P()),
        out_specs=P("dp"),
        check_vma=False,
    )
    def launch(xn, yn, pix_ids, tables, pmap, key):
        sp_idx = jax.lax.axis_index("sp")
        pix_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(pix_ids)

        def one_sample(acc, s):
            keys = sampling.fold(pix_keys, sp_idx * local_samples + s)
            jx = sampling.uniform(sampling.fold(keys, 1), -1.0 / dim, 1.0 / dim)
            jy = sampling.uniform(sampling.fold(keys, 2), -1.0 / dim, 1.0 / dim)
            ray = camera.cast_ray(xn + jx, yn + jy, sampling.fold(keys, 3))
            color = estimate_indirect(
                scene, tables, pmap, ray, sampling.fold(keys, 4),
                gather_size, gather_size_volume, occlusion_check,
            )
            return acc + color.to_array().astype(jnp.float32), None

        acc0 = jnp.zeros((xn.shape[0], 3), jnp.float32)
        total, _ = jax.lax.scan(one_sample, acc0, jnp.arange(local_samples))
        return jax.lax.psum(total, "sp")

    out = launch(xn, yn, pix_ids, scene.tables, pmap, key)
    return np.asarray(out)[:n_pix]


def shoot_photons_sharded(scene, key, photon_count: int, watts: float, kind: str,
                          mesh: Mesh, max_depth: int = 48):
    """Photon shooting sharded by photon index over the whole mesh
    (the analog of rayon's parallel photon loop, photon.rs:663-674).

    Each device shoots photon_count/n_devices photons from its own key
    stream; deposit buffers are gathered across devices (the sharded
    output, pulled to the host).
    Returns host (surface_rows, volume_rows) float32 arrays.
    """
    from .integrators.photon import _find_object_light, _shoot_launch

    n_dev = int(np.prod(list(mesh.shape.values())))
    per_dev = -(-photon_count // n_dev)
    li, _ = _find_object_light(scene)
    # n_dev * per_dev photons are actually emitted (rounded up), so scale
    # per-photon power by the true emission count — otherwise total flux
    # exceeds `watts` whenever photon_count % n_dev != 0
    launch = _shoot_launch(scene, li, watts / (n_dev * per_dev), kind, max_depth, per_dev)
    axes = tuple(mesh.shape.keys())

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(axes), P(axes), P(axes), P(axes)),
        check_vma=False,
    )
    def run(tables, key):
        dev = jax.lax.axis_index(axes)
        k = jax.random.fold_in(key, dev)
        s_buf, s_count, v_buf, v_count = launch.raw(tables, k)
        return s_buf, s_count[None], v_buf, v_count[None]

    s_buf, s_counts, v_buf, v_counts = run(scene.tables, key)
    s_buf = np.asarray(s_buf).reshape(n_dev, launch.s_cap, -1)
    v_buf = np.asarray(v_buf).reshape(n_dev, launch.v_cap, -1)
    s_counts = np.minimum(np.asarray(s_counts), launch.s_cap)
    v_counts = np.minimum(np.asarray(v_counts), launch.v_cap)
    surface = np.concatenate([s_buf[i, : s_counts[i]] for i in range(n_dev)])
    volume = np.concatenate([v_buf[i, : v_counts[i]] for i in range(n_dev)])
    return surface, volume
