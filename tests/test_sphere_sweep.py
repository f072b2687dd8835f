"""The beam-query x point-photon sweep of `volume_estimate_spheres`
against a float64 numpy reference, with rays that hit and miss and sphere
counts that fill, part-fill and underfill the sweep's chunks (the padding
past the real spheres must contribute nothing)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rpt_tpu as rpt
from rpt_tpu.integrators import photon as ph
from rpt_tpu.ray import Hit, Ray
from rpt_tpu.vec import Vec3

CHUNK = 128


def _problem(n, p, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 100, (p, 3)).astype(np.float32)
    radius = rng.uniform(5.0, 10.0, p).astype(np.float32)
    direction = rng.normal(size=(p, 3)).astype(np.float32)
    power = rng.uniform(0, 1, (p, 3)).astype(np.float32)
    o = rng.uniform(0, 100, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hit_t = np.where(rng.random(n) < 0.5, rng.uniform(20, 200, n), np.inf).astype(np.float32)
    return pos, radius, direction, power, o, d, hit_t


def _reference(pos, radius, power, o, d, hit_t, ext, phase):
    oc = pos[None, :, :].astype(np.float64) - o[:, None, :]
    oc2 = (oc * oc).sum(-1)
    dd = (oc * d[:, None, :]).sum(-1)
    dist2 = np.maximum(oc2 - dd * dd, 0)
    r2 = radius[None, :].astype(np.float64) ** 2
    ok = (dd > 0) & (dist2 < r2) & (np.sqrt(oc2) <= hit_t[:, None])
    x = dist2 / r2
    w = np.where(ok, (3 / np.pi) * (1 - x) ** 2 / r2 * np.exp(-ext * dd) * phase, 0)
    return w @ power


def _sphere_map(pos, radius, direction, power, pad_value):
    """Spheres padded past the real count as `build_photon_map` pads
    them; ``pad_value`` fills the padding so the sweep's in-range mask,
    not zero radii alone, must drop it."""
    nv = len(radius)
    pad = max(CHUNK, -(-nv // CHUNK) * CHUNK)

    def padded(a, width=None):
        out = np.full((pad,) if width is None else (pad, width), pad_value, np.float32)
        out[:nv] = a
        return out

    pos4 = padded(np.concatenate([pos, np.zeros((nv, 1), np.float32)], 1), 4)
    return ph.PhotonMapData(
        ph.POINT_BEAM, None, {},
        spheres={
            "pos4": jnp.asarray(pos4),
            "radius": jnp.asarray(padded(radius)),
            "dir": Vec3.from_array(padded(direction, 3)),
            "power": Vec3.from_array(padded(power, 3)),
        },
        n_spheres=nv,
    )


@pytest.mark.parametrize("n,p,pad_value", [
    (333, CHUNK * 2, 0.0),  # whole chunks
    (257, CHUNK * 2 + 44, 50.0),  # last chunk part-full, live-looking padding
    (64, CHUNK - 100, 50.0),  # fewer spheres than one chunk
])
def test_sweep_matches_numpy(n, p, pad_value):
    pos, radius, direction, power, o, d, hit_t = _problem(n, p, seed=p)
    medium = rpt.Medium.homogeneous_isotropic(4e-4, 6e-4)
    pmap = _sphere_map(pos, radius, direction, power, pad_value)
    ray = Ray(Vec3.from_array(jnp.asarray(o)), Vec3.from_array(jnp.asarray(d)))
    hit = Hit(jnp.asarray(hit_t), Vec3.zeros((n,)), jnp.zeros(n, jnp.int32))
    out = jax.jit(
        lambda pm, r, h: ph.volume_estimate_spheres(pm, medium, r, h, chunk=CHUNK).to_array()
    )(pmap, ray, hit)
    assert out.shape == (n, 3)
    tan = np.asarray(rpt.hex_color(0xD2B48C).to_array(), np.float64)
    ref = _reference(pos, radius, power, o, d, hit_t, 1e-3, 1 / (4 * math.pi)) * tan
    assert (ref > 0).any()
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-7)


def test_no_spheres_gives_zero():
    pmap = ph.PhotonMapData(ph.POINT_BEAM, None, {}, spheres=None, n_spheres=0)
    ray = Ray(Vec3.zeros((5,)), Vec3.from_array(jnp.tile(jnp.asarray([[0.0, 0, 1]]), (5, 1))))
    hit = Hit.none((5,))
    out = ph.volume_estimate_spheres(
        pmap, rpt.Medium.homogeneous_isotropic(1e-4, 1e-3), ray, hit)
    np.testing.assert_array_equal(np.asarray(out.to_array()), 0.0)
