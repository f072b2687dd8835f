"""Golden-image regression tests: tiny deterministic renders compared
against checked-in references (the pixel-diff harness of SURVEY.md §7.9;
goldens were produced by this framework on CPU and verified visually
against the reference's published images)."""

import math
import os

import numpy as np
import pytest

import rpt_tpu as rpt

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _sphere_renderer():
    scene = rpt.Scene()
    scene.add(rpt.Object(rpt.sphere()))
    scene.add(
        rpt.Object(rpt.plane((0, 1, 0), -1.0)).material(
            rpt.Material.diffuse(rpt.hex_color(0xAAAAAA))
        )
    )
    scene.add(
        rpt.Light.Object(
            rpt.Object(rpt.sphere().scale((2, 2, 2)).translate((0, 12, 0))).material(
                rpt.Material.light(rpt.hex_color(0xFFFFFF), 40.0)
            )
        )
    )
    camera = rpt.Camera.look_at((-2.5, 4, 6.5), (0, -0.25, 0), (0, 1, 0), math.pi / 4)
    return rpt.Renderer(scene, camera).width(64).height(36).max_bounces(2).num_samples(16).seed(42)


def _cornell_renderer():
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    from cornell import build_scene, camera

    return (
        rpt.Renderer(build_scene(), camera()).width(48).height(48).max_bounces(2)
        .num_samples(24).seed(42)
    )


def _check(name, renderer, tol_mean=0.015, tol_p99=0.12):
    path = os.path.join(GOLDEN_DIR, f"{name}.npy")
    buffer = rpt.Buffer(renderer.width_, renderer.height_, renderer.filter_)
    renderer.sample(renderer.num_samples_, buffer)
    img = buffer.raw()
    if not os.path.exists(path):
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        np.save(path, img.astype(np.float32))
        pytest.skip(f"golden {name} created; re-run to compare")
    ref = np.load(path).astype(np.float64)
    diff = np.abs(img - ref)
    scale = max(ref.mean(), 1e-6)
    assert diff.mean() / scale < tol_mean, (name, diff.mean() / scale)
    assert np.percentile(diff, 99) / scale < tol_p99, (name, np.percentile(diff, 99) / scale)


def test_golden_sphere():
    _check("sphere_64x36_16spp", _sphere_renderer())


def test_golden_cornell():
    _check("cornell_48x48_24spp", _cornell_renderer())


# ---------------------------------------------------------------------------
# Volumetric + photon-estimator goldens: tiny
# deterministic lampshade configs so a regression in the media branch or in
# any of the three photon kernels fails a test instead of shipping.


def _lampshade_renderer(absorb=1e-4, scat=1e-3, watts=200_000.0 / (130.0 * 105.0)):
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
    from _lampshade import build_scene, camera

    scene = build_scene(rpt.Material.light(rpt.hex_color(0xFFFEFA), watts))
    scene.add(rpt.Medium.homogeneous_isotropic(absorb, scat))
    return (
        rpt.Renderer(scene, camera()).width(32).height(32).max_bounces(6)
        .seed(42).watts(watts * 4000)
    )


def test_golden_volumetric_pathtrace():
    r = _lampshade_renderer().num_samples(6).media_max_depth(8)
    _check("lampshade_path_32_6spp", r, tol_mean=0.03, tol_p99=0.25)


def _check_img(name, img, tol_mean=0.02, tol_p99=0.2):
    path = os.path.join(GOLDEN_DIR, f"{name}.npy")
    img = np.asarray(img, np.float64)
    if not os.path.exists(path):
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        np.save(path, img.astype(np.float32))
        pytest.skip(f"golden {name} created; re-run to compare")
    ref = np.load(path).astype(np.float64)
    diff = np.abs(img - ref)
    scale = max(ref.mean(), 1e-6)
    assert diff.mean() / scale < tol_mean, (name, diff.mean() / scale)
    assert np.percentile(diff, 99) / scale < tol_p99, (name, np.percentile(diff, 99) / scale)


def test_golden_photon_map_surface():
    r = _lampshade_renderer().num_samples(2).gather_size(20).gather_size_volume(3)
    _check_img("lampshade_photonmap_32", r.photon_map_render(4000))


def test_golden_photon_point_beam():
    r = _lampshade_renderer().num_samples(2).gather_size(20).gather_size_volume(3)
    _check_img("lampshade_pointbeam_32", r.photon_point_query_beam_render(4000))


def test_golden_photon_beam_beam():
    r = _lampshade_renderer().num_samples(2).gather_size(20).gather_size_volume(3)
    _check_img("lampshade_beambeam_32", r.photon_beam_query_beam_render(4000))
