"""Intersection kernels vs closed-form expectations (SURVEY.md §4: the
reference has no such tests; formulas cite shape/*.rs)."""

import jax.numpy as jnp
import numpy as np
import pytest

import rpt_tpu as rpt
from rpt_tpu.intersect import closest_hit
from rpt_tpu.ray import Ray
from rpt_tpu.vec import Vec3


def _ray(origins, dirs):
    o = np.asarray(origins, np.float64).reshape(-1, 3)
    d = np.asarray(dirs, np.float64).reshape(-1, 3)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return Ray(Vec3.from_array(o), Vec3.from_array(d))


def _scene_of(*objects):
    s = rpt.Scene()
    for o in objects:
        s.add(o)
    return s.compile()


def test_sphere_hit():
    cs = _scene_of(rpt.Object(rpt.sphere()))
    ray = _ray([[0, 0, 5], [0, 3, 5], [2, 0, 5]], [[0, 0, -1]] * 3)
    h = closest_hit(cs, cs.tables, ray)
    t = np.asarray(h.time)
    assert np.isclose(t[0], 4.0, atol=1e-4)
    assert not np.isfinite(t[1])  # passes above
    assert not np.isfinite(t[2])  # passes beside
    n = h.normal.to_numpy()[0]
    assert np.allclose(n, [0, 0, 1], atol=1e-5)


def test_sphere_transformed():
    # scaled 2x, translated +y: ellipsoid surface at y in [10, 14]
    obj = rpt.Object(rpt.sphere().scale((2, 2, 2)).translate((0, 12, 0)))
    cs = _scene_of(obj, rpt.Object(rpt.plane((0, 1, 0), -1.0)))
    ray = _ray([[0, 12, 10]], [[0, 0, -1]])
    h = closest_hit(cs, cs.tables, ray)
    assert np.isclose(np.asarray(h.time)[0], 8.0, atol=1e-3)
    # from below
    ray = _ray([[0, 0, 0]], [[0, 1, 0]])
    h = closest_hit(cs, cs.tables, ray)
    assert np.isclose(np.asarray(h.time)[0], 10.0, atol=1e-3)
    assert np.allclose(h.normal.to_numpy()[0], [0, -1, 0], atol=1e-4)


def test_plane_two_sided():
    cs = _scene_of(rpt.Object(rpt.plane((0, 1, 0), -1.0)))
    ray = _ray([[0, 1, 0], [0, -3, 0]], [[0, -1, 0], [0, 1, 0]])
    h = closest_hit(cs, cs.tables, ray)
    t = np.asarray(h.time)
    assert np.allclose(t, 2.0, atol=1e-5)
    n = h.normal.to_numpy()
    # normal flipped against ray dir (plane.rs:27)
    assert np.allclose(n[0], [0, 1, 0], atol=1e-6)
    assert np.allclose(n[1], [0, -1, 0], atol=1e-6)


def test_cube_entry_exit():
    cs = _scene_of(rpt.Object(rpt.cube()))
    ray = _ray([[0, 0, 5], [0.2, 0.1, 0]], [[0, 0, -1], [0, 0, 1]])
    h = closest_hit(cs, cs.tables, ray)
    t = np.asarray(h.time)
    assert np.isclose(t[0], 4.5, atol=1e-5)
    n = h.normal.to_numpy()
    assert np.allclose(n[0], [0, 0, 1], atol=1e-6)
    # ray starting inside: exit face normal points along +z (cube.rs:62-66)
    assert np.isclose(t[1], 0.5, atol=1e-5)
    assert np.allclose(n[1], [0, 0, 1], atol=1e-6)


def test_mesh_triangle():
    mesh = rpt.polygon(
        [(0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (0.0, 1.0, 0.0)]
    )
    cs = _scene_of(rpt.Object(mesh))
    ray = _ray([[0.5, 0.5, 3], [2.0, 0.5, 3]], [[0, 0, -1]] * 2)
    h = closest_hit(cs, cs.tables, ray)
    t = np.asarray(h.time)
    assert np.isclose(t[0], 3.0, atol=1e-5)
    assert not np.isfinite(t[1])


def test_mesh_closest_of_many():
    rng = np.random.default_rng(3)
    # 200 parallel unit quads stacked in z; closest must win
    quads = []
    for z in rng.permutation(np.linspace(1, 50, 200)):
        quads.append(rpt.polygon([(0, 0, z), (1, 0, z), (1, 1, z), (0, 1, z)]))
    v = np.concatenate([q.vertices for q in quads])
    cs = _scene_of(rpt.Object(rpt.Mesh(v)))
    ray = _ray([[0.5, 0.5, 60]], [[0, 0, -1]])
    h = closest_hit(cs, cs.tables, ray)
    assert np.isclose(np.asarray(h.time)[0], 10.0, atol=1e-4)


def test_monomial_surface():
    cs = _scene_of(rpt.Object(rpt.monomial_surface(1.0)))
    # vertical ray down the cup wall at x=0.5: surface y = (0.25)^2 = 0.0625
    ray = _ray([[0.5, 2.0, 0.0]], [[0, -1, 0]])
    h = closest_hit(cs, cs.tables, ray)
    assert np.isclose(np.asarray(h.time)[0], 2.0 - 0.0625, atol=1e-3)
    # outside the unit radius: no hit
    ray = _ray([[1.5, 2.0, 0.0]], [[0, -1, 0]])
    h = closest_hit(cs, cs.tables, ray)
    assert not np.isfinite(np.asarray(h.time)[0])


def test_bvh_matches_brute_force():
    rng = np.random.default_rng(7)
    n = 300
    tri = rng.uniform(-5, 5, (n, 3, 3))
    tri[:, 1] = tri[:, 0] + rng.uniform(-0.7, 0.7, (n, 3))
    tri[:, 2] = tri[:, 0] + rng.uniform(-0.7, 0.7, (n, 3))
    cs = _scene_of(rpt.Object(rpt.Mesh(tri)))
    m = 500
    o = rng.uniform(-8, 8, (m, 3))
    d = rng.normal(size=(m, 3))
    ray = _ray(o, d)
    h = closest_hit(cs, cs.tables, ray)
    t_bvh = np.asarray(h.time)

    # brute force in numpy (same algorithm as mesh.rs:50-83)
    t_ref = np.full(m, np.inf)
    dn = d / np.linalg.norm(d, axis=1, keepdims=True)
    for k in range(n):
        v1, v2, v3 = tri[k]
        d0, d1 = v2 - v1, v3 - v1
        pn = np.cross(d0, d1)
        pn = pn / np.linalg.norm(pn)
        cos = dn @ pn
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((v1 - o) @ pn) / cos
        p = o + t[:, None] * dn
        d2 = p - v1
        d00, d01, d11 = d0 @ d0, d0 @ d1, d1 @ d1
        d20, d21 = d2 @ d0, d2 @ d1
        denom = d00 * d11 - d01 * d01
        v = (d11 * d20 - d01 * d21) / denom
        w = (d00 * d21 - d01 * d20) / denom
        u = 1 - v - w
        ok = (np.abs(cos) >= 1e-8) & (t >= cs.t_min) & (u >= 0) & (v >= 0) & (w >= 0)
        t_ref = np.where(ok & (t < t_ref), t, t_ref)

    both_hit = np.isfinite(t_ref) & np.isfinite(t_bvh)
    assert (np.isfinite(t_ref) == np.isfinite(t_bvh)).mean() > 0.995
    assert np.allclose(t_ref[both_hit], t_bvh[both_hit], rtol=2e-3, atol=2e-3)


def _floor_graze_case(n_tris_side):
    """Noisy on-floor endpoint pairs: photons deposited ON a mesh floor
    carry ~eps*||o|| of off-plane noise, making photon->gather-point
    visibility rays graze their own floor. The f32 transliteration of the
    reference's |cosine| >= 1e-8 guard (mesh.rs:50-83 via plane.rs:19-22)
    computed t = tiny/tiny on such rays — 50.7% spurious self-occlusion
    measured before the _origin_on_plane guard (round 4)."""
    L = 10.0
    xs = np.linspace(0.0, L, n_tris_side + 1)
    quads = []
    for i in range(n_tris_side):
        for j in range(n_tris_side):
            a = (xs[i], 0.0, xs[j])
            b = (xs[i], 0.0, xs[j + 1])
            c = (xs[i + 1], 0.0, xs[j + 1])
            d = (xs[i + 1], 0.0, xs[j])
            quads += [[a, b, c], [a, c, d]]
    scene = rpt.Scene()
    scene.add(rpt.Object(rpt.Mesh(np.array(quads, float))).material(
        rpt.Material.diffuse((0.7,) * 3)))
    cs = scene.compile()

    rng = np.random.default_rng(3)
    m = 4096
    def pts():
        return np.stack([
            rng.uniform(0.5, L - 0.5, m),
            rng.normal(0.0, 2e-6, m),  # realistic deposited-position noise
            rng.uniform(0.5, L - 0.5, m),
        ], 1)
    a, b = pts(), pts()
    disp = b - a
    dist = np.linalg.norm(disp, axis=1)
    return cs, _ray(a, disp), dist


@pytest.mark.parametrize("n_side", [1, 32])  # dense path / BVH leaf path
def test_floor_photon_pairs_not_self_occluded(n_side):
    from rpt_tpu.intersect import occluded

    cs, ray, dist = _floor_graze_case(n_side)
    limit = jnp.asarray(dist * (1.0 - 1e-3), jnp.float32)
    occ = np.asarray(occluded(cs, cs.tables, ray, limit, coherent=False))
    assert occ.mean() == 0.0, f"{occ.mean():.1%} spurious floor self-occlusion"


def test_on_plane_guard_keeps_legit_occluders():
    """The guard must not reject REAL hits: rays starting just above the
    floor pointing down through it must still be occluded, and rays from
    the floor toward a blocking wall must still see the wall."""
    from rpt_tpu.intersect import occluded

    L = 10.0
    floor = [[(0, 0, 0), (0, 0, L), (L, 0, L)], [(0, 0, 0), (L, 0, L), (L, 0, 0)]]
    wall = [[(5, -1, 0), (5, -1, L), (5, 2, L)], [(5, -1, 0), (5, 2, L), (5, 2, 0)]]
    scene = rpt.Scene()
    scene.add(rpt.Object(rpt.Mesh(np.array(floor + wall, float))).material(
        rpt.Material.diffuse((0.7,) * 3)))
    cs = scene.compile()

    m = 256
    rng = np.random.default_rng(5)
    # (a) from 2 cm above the floor (the scene t_min is scale-derived,
    # ~3e-3 here), straight down: must hit the floor
    o = np.stack([rng.uniform(1, 9, m), np.full(m, 2e-2), rng.uniform(1, 9, m)], 1)
    d = np.tile([[0.0, -1.0, 0.0]], (m, 1))
    occ = np.asarray(occluded(cs, cs.tables, _ray(o, d),
                              jnp.full(m, 1.0, jnp.float32), coherent=False))
    assert occ.all()
    # (b) from ON the floor (left of the wall), horizontally across it:
    # the wall at x=5 must occlude even though the origin sits on the floor
    o2 = np.stack([rng.uniform(1, 4, m), rng.normal(0, 2e-6, m), rng.uniform(1, 9, m)], 1)
    d2 = np.tile([[1.0, 0.0, 0.0]], (m, 1))
    occ2 = np.asarray(occluded(cs, cs.tables, _ray(o2, d2),
                               jnp.full(m, 8.0, jnp.float32), coherent=False))
    assert occ2.all()


def _lampshade_box():
    """The lampshade's large box: scaled, rotated, translated (the same
    transform examples/_lampshade.py builds)."""
    return (rpt.cube().scale((165.0, 330.0, 165.0))
            .rotate_y(2 * np.pi * (-253.0 / 360.0)).translate((368.0, 165.0, 351.0)))


def _on_face_points(box, rng, m, noise):
    """World points on the box's local +x face, with deposited-position
    noise."""
    local = np.stack([np.full(m, 0.5), rng.uniform(-0.45, 0.45, m),
                      rng.uniform(-0.45, 0.45, m)], 1)
    m4 = np.asarray(box.matrix)
    world = local @ m4[:3, :3].T + m4[:3, 3]
    return world + rng.normal(0.0, noise, world.shape), m4


def test_box_face_pairs_not_self_occluded():
    """Photon -> gather-point visibility rays between two points on the
    same face of a transformed box slide along the face: never occluded by
    that box, whatever side of the face rounding put each endpoint."""
    from rpt_tpu.intersect import occluded

    box = _lampshade_box()
    cs = _scene_of(rpt.Object(box))
    rng = np.random.default_rng(7)
    a, _ = _on_face_points(box, rng, 4096, 5e-5)
    b, _ = _on_face_points(box, rng, 4096, 5e-5)
    disp = b - a
    dist = np.linalg.norm(disp, axis=1)
    occ = np.asarray(occluded(cs, cs.tables, _ray(a, disp),
                              jnp.asarray(dist * (1 - 1e-3), jnp.float32),
                              coherent=False))
    assert occ.mean() == 0.0, f"{occ.mean():.1%} spurious box-face self-occlusion"


def test_box_face_guard_keeps_legit_occluders():
    """Rays from a face into the box, and rays through the box from
    outside, are still occluded."""
    from rpt_tpu.intersect import occluded

    box = _lampshade_box()
    cs = _scene_of(rpt.Object(box))
    rng = np.random.default_rng(8)
    m = 256
    a, m4 = _on_face_points(box, rng, m, 5e-5)
    inward = -m4[:3, 0] / np.linalg.norm(m4[:3, 0])  # local -x in world
    d = inward + rng.normal(0.0, 0.3, (m, 3))
    occ = np.asarray(occluded(cs, cs.tables, _ray(a, d),
                              jnp.full(m, 1e3, jnp.float32), coherent=False))
    assert occ.all()
    # from 1 unit outside the face, straight through the box
    occ = np.asarray(occluded(cs, cs.tables, _ray(a - inward, np.tile(inward, (m, 1))),
                              jnp.full(m, 1e3, jnp.float32), coherent=False))
    assert occ.all()
