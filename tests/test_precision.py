"""No matrix product enters the device path: on the GPU a float32 product
may run in TF32 unless asked otherwise, so the launches must contain none
(the traversal, shading and photon estimates are elementwise work and
reductions). Checked on the lowered programs, which do not depend on the
platform."""

import math
import os
import sys

import jax
import jax.numpy as jnp

import rpt_tpu as rpt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))


def test_dragon_launch_has_no_matrix_product():
    import bench
    from rpt_tpu.meshes import displaced_blob

    scene = rpt.Scene()
    scene.add(rpt.Object(displaced_blob(101, 102).scale((3.4, 3.4, 3.4))).material(
        rpt.Material.specular(rpt.hex_color(0xB7CA79), 0.1)))
    scene.add(rpt.Object(rpt.plane((0.0, 1.0, 0.0), -1.0)))
    scene.add(rpt.Light.Object(rpt.Object(
        rpt.sphere().scale((2.0, 2.0, 2.0)).translate((0.0, 20.0, 3.0))).material(
        rpt.Material.light((1.0, 1.0, 1.0), 160.0))))
    cs = scene.compile()
    assert "clusters" in cs.tables  # the tiled + deferred engines are traced
    launch = bench.make_launch(cs, bench.dragon_camera(), 64, 64, 1)
    text = launch.lower(cs.tables, jax.random.key(0), jnp.int32(0)).as_text()
    assert "dot_general" not in text


def test_point_beam_launch_has_no_matrix_product():
    from _lampshade import build_scene, camera
    from rpt_tpu.renderer import _photon_launch

    watts = 200_000.0 / (130.0 * 105.0)
    scene = build_scene(rpt.Material.light(rpt.hex_color(0xFFFEFA), watts))
    scene.add(rpt.Medium.homogeneous_isotropic(1e-4, 1e-3))
    r = (rpt.Renderer(scene, camera()).width(16).height(16).num_samples(1)
         .gather_size(20).gather_size_volume(3).watts(watts * 2000).seed(3))
    r.photon_point_query_beam_render(2000)
    fn = _photon_launch(r.compiled, r.camera, 16, 16, "point_beam", 20, 3, 1, True)
    text = fn.lower(r.compiled.tables, r._last_photon_map, jax.random.key(0),
                    jnp.int32(0)).as_text()
    assert "dot_general" not in text
    assert math.isfinite(float(r._last_buffer.raw().mean()))
