"""Independent f64 oracle renderer — shares NO code with rpt_tpu.

A direct numpy transcription of the reference's recursive integrator
(`/root/reference/src/renderer.rs:187-322` surface branch,
`camera.rs:65-82`, `light.rs:34-45`, `material.rs:173-197/266-289`,
closed-form shapes from `shape/*.rs`) used to anchor the wavefront
integrator against an implementation that cannot share its bugs.
f64 throughout, own RNG, recursive bounce
structure (vectorized over rays only — no wavefront machinery, no
compaction, no masking framework).

One deliberate, documented deviation shared with rpt_tpu (PARITY.md /
integrators/path.py docstring): NEE visibility is the standard
"no occluder strictly before the light" test instead of the reference's
|closest_hit - dist| < 1e-12 equality, which only admits dual-added
light geometry under f64 exactness.
"""

from __future__ import annotations

import numpy as np

FIREFLY_CLAMP = 100.0  # renderer.rs:18
SHADOW_EPS = 1e-3  # fractional back-off like rpt_tpu's scene.shadow_eps
T_MIN = 1e-4


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(a):
    # zero vectors (dead-lane directions) normalize to zero, not nan/0:
    # the suite runs RuntimeWarnings as errors, so masked lanes must not
    # trip 0/0 — a real nan in a compared lane still propagates.
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    return a / np.where(n > 0.0, n, 1.0)


# --- shapes (closed-form, f64) --------------------------------------------


class OSphere:
    """Sphere of radius r at center c (sphere.rs:14-46 in local frame)."""

    def __init__(self, center, radius, mat):
        self.c = np.asarray(center, np.float64)
        self.r = float(radius)
        self.mat = mat

    def intersect(self, o, d, t_min, t_best):
        oc = (o - self.c) / self.r
        dn = d / self.r
        a = _dot(dn, dn)
        b = _dot(dn, oc)
        c = _dot(oc, oc) - 1.0
        disc = b * b - a * c
        # dead lanes carry d = 0 (a = 0): guard the quadratic's divisor
        # and the inf*0 position product so masked lanes never raise
        # RuntimeWarnings — the suite runs with them as errors, so a real
        # nan/inf reaching a COMPARED lane stays detectable.
        ok = (disc >= 0.0) & (a > 0.0)
        a_safe = np.where(a > 0.0, a, 1.0)
        sq = np.sqrt(np.maximum(disc, 0.0))
        t_minus = (-b - sq) / a_safe
        t_plus = (-b + sq) / a_safe
        t = np.where(t_minus < t_min, t_plus, t_minus)
        ok &= (t >= t_min) & (t < t_best)
        p = o + np.where(ok, t, 0.0)[:, None] * d
        nrm = _norm(np.where(ok[:, None], p - self.c, [[1.0, 0, 0]]))
        return np.where(ok, t, np.inf), nrm

    def sample(self, target, rng):
        """Transformed sphere light sample (sphere.rs:53-65 through
        shape.rs:140-151 with uniform scale r + translate c)."""
        m = target.shape[0]
        # UnitDisc
        ang = rng.uniform(0, 2 * np.pi, m)
        rad = np.sqrt(rng.uniform(0, 1, m))
        x, y = rad * np.cos(ang), rad * np.sin(ang)
        z = np.sqrt(np.maximum(1.0 - x * x - y * y, 0.0))
        tl = (target - self.c) / self.r  # local target
        n = _norm(tl)
        use_a = np.abs(n[:, 0]) > 1e-300  # is_normal surrogate
        n1 = np.where(
            use_a[:, None],
            np.stack([n[:, 1], -n[:, 0], np.zeros(m)], 1),
            np.stack([np.zeros(m), -n[:, 2], n[:, 1]], 1),
        )
        n1 = _norm(n1)
        n2 = np.cross(n1, n)
        p_local = x[:, None] * n1 + y[:, None] * n2 + z[:, None] * n
        pdf_local = z / np.pi
        # world: point scaled+translated; normal unchanged (uniform scale);
        # pdf divided by area scale r^2 (parallelepiped base, shape.rs:148)
        v = self.c + self.r * p_local
        return v, p_local, pdf_local / (self.r * self.r)


class OPlane:
    def __init__(self, normal, value, mat):
        self.n = np.asarray(normal, np.float64)
        self.v = float(value)
        self.mat = mat

    def intersect(self, o, d, t_min, t_best):
        cosine = _dot(d, self.n)
        ok = np.abs(cosine) >= 1e-8
        t = (self.v - _dot(o, self.n)) / np.where(ok, cosine, 1.0)
        ok &= (t >= t_min) & (t < t_best)
        t = np.where(ok, t, np.inf)
        nrm = -_norm(self.n)[None, :] * np.sign(cosine)[:, None]
        return t, nrm


class OTris:
    """Triangle soup with flat normals (mesh.rs:50-83); doubles as an
    area light (uniform triangle pick, kdtree.rs:141-147 pdf/n)."""

    def __init__(self, tris, mat):
        self.v = np.asarray(tris, np.float64)  # (T, 3, 3)
        self.mat = mat
        d0 = self.v[:, 1] - self.v[:, 0]
        d1 = self.v[:, 2] - self.v[:, 0]
        self.fn = _norm(np.cross(d0, d1))
        self.area = 0.5 * np.linalg.norm(np.cross(d0, d1), axis=-1)

    def intersect(self, o, d, t_min, t_best):
        n = o.shape[0]
        best_t = np.full(n, np.inf)
        best_n = np.tile([[0.0, 0.0, 1.0]], (n, 1))
        for i in range(len(self.v)):
            v1, v2, v3 = self.v[i]
            pn = self.fn[i]
            cosine = _dot(d, pn[None, :])
            ok = np.abs(cosine) >= 1e-8
            t = _dot((v1 - o), pn[None, :]) / np.where(ok, cosine, 1.0)
            ok &= (t >= t_min) & (t < np.minimum(t_best, best_t))
            p = o + t[:, None] * d
            d0, d1 = v2 - v1, v3 - v1
            d2 = p - v1
            d00, d01, d11 = d0 @ d0, d0 @ d1, d1 @ d1
            d20 = _dot(d2, d0[None, :])
            d21 = _dot(d2, d1[None, :])
            denom = d00 * d11 - d01 * d01
            bv = (d11 * d20 - d01 * d21) / denom
            bw = (d00 * d21 - d01 * d20) / denom
            bu = 1.0 - bv - bw
            ok &= (bu >= 0) & (bv >= 0) & (bw >= 0)
            upd = ok & (t < best_t)
            best_t = np.where(upd, t, best_t)
            best_n = np.where(upd[:, None], pn[None, :], best_n)
        return best_t, best_n

    def sample(self, target, rng):
        m = target.shape[0]
        idx = rng.integers(0, len(self.v), m)
        u = rng.uniform(0, 1, m)
        v = rng.uniform(0, 1, m)
        flip = u + v > 1.0  # fold instead of the reference's rejection loop
        u = np.where(flip, 1.0 - u, u)
        v = np.where(flip, 1.0 - v, v)
        w = 1.0 - u - v
        tv = self.v[idx]
        # mesh.rs:85-99 writes u*v1 + v*v2 + w*v3
        p = u[:, None] * tv[:, 0] + v[:, None] * tv[:, 1] + w[:, None] * tv[:, 2]
        n = self.fn[idx]
        pdf = (1.0 / self.area[idx]) / len(self.v)
        return p, n, pdf


class OMat:
    def __init__(self, albedo=(0.5, 0.5, 0.5), emittance=0.0):
        self.albedo = np.asarray(albedo, np.float64)
        self.emittance = float(emittance)

    def bsdf(self, n, wo, wi):
        above = (_dot(n, wi) > 0) & (_dot(n, wo) > 0)
        return np.where(above[:, None], self.albedo[None, :] / np.pi, 0.0)

    def sample_f(self, n, wo, rng):
        m = n.shape[0]
        r1 = rng.uniform(0, 1, m)
        r2 = rng.uniform(0, 1, m)
        phi = 2 * np.pi * r1
        ct = np.sqrt(r2)  # cos(acos(sqrt(r2)))
        st = np.sqrt(np.maximum(1 - r2, 0))
        local = np.stack([st * np.cos(phi), ct, st * np.sin(phi)], 1)
        pdf = ct / np.pi
        # rotate y-hat -> n (any azimuth: the lobe is azimuthally symmetric)
        up = np.tile([[0.0, 1.0, 0.0]], (m, 1))
        alt = np.tile([[1.0, 0.0, 0.0]], (m, 1))
        t = np.where(np.abs(n[:, 1:2]) > 0.999, alt, up)
        t1 = _norm(np.cross(t, n))
        t2 = np.cross(n, t1)
        wi = local[:, 0:1] * t1 + local[:, 1:2] * n + local[:, 2:3] * t2
        return _norm(wi), pdf, np.ones(m, bool)


class OScene:
    def __init__(self, objects, lights, env=(0.0, 0.0, 0.0)):
        self.objects = objects  # shapes with .mat
        self.lights = lights  # shapes with .mat (area lights)
        self.env = np.asarray(env, np.float64)

    def closest_hit(self, o, d, t_min=T_MIN):
        n = o.shape[0]
        bt = np.full(n, np.inf)
        bn = np.zeros((n, 3))
        bi = np.full(n, -1)
        for i, obj in enumerate(self.objects):
            t, nrm = obj.intersect(o, d, t_min, bt)
            upd = t < bt
            bt = np.where(upd, t, bt)
            bn = np.where(upd[:, None], nrm, bn)
            bi = np.where(upd, i, bi)
        return bt, bn, bi

    def occluded(self, o, d, limit):
        bt, _, _ = self.closest_hit(o, d)
        return bt < limit

    def sample_lights(self, mat_table, mat_idx, pos, nrm, wo, rng):
        m = pos.shape[0]
        color = np.zeros((m, 3))
        for light in self.lights:
            v, ln, pdf = light.sample(pos, rng)
            disp = v - pos
            dist = np.linalg.norm(disp, axis=-1)
            wi = disp / dist[:, None]
            cos_l = np.maximum(-_dot(disp, ln), 0.0) / dist
            sa = np.maximum(cos_l, 0.0) / (dist * dist)
            emit = light.mat.albedo * light.mat.emittance
            intensity = emit[None, :] * (sa / pdf)[:, None]
            vis = ~self.occluded(pos, wi, dist * (1.0 - SHADOW_EPS))
            f = np.zeros((m, 3))
            for mi, mat in enumerate(mat_table):
                sel = mat_idx == mi
                if sel.any():
                    f[sel] = mat.bsdf(nrm[sel], wo[sel], wi[sel])
            color += np.where(
                vis[:, None], f * intensity * _dot(wi, nrm)[:, None], 0.0
            )
        return color

    def trace(self, o, d, bounce, max_bounces, rng):
        """renderer.rs:286-321 surface branch, recursive, f64."""
        m = o.shape[0]
        bt, bn, bi = self.closest_hit(o, d)
        hit = np.isfinite(bt)
        out = np.where(hit[:, None], 0.0, self.env[None, :])
        pos = o + np.where(hit, bt, 0.0)[:, None] * d
        wo = -_norm(d)

        mat_table = [obj.mat for obj in self.objects]
        emit = np.zeros((m, 3))
        nee = np.zeros((m, 3))
        if bounce == 0:
            for mi, mat in enumerate(mat_table):
                emit[bi == mi] = mat.albedo * mat.emittance
        nee = self.sample_lights(mat_table, bi, pos, bn, wo, rng)
        out += np.where(hit[:, None], emit + nee, 0.0)

        if bounce < max_bounces:
            wi = np.zeros((m, 3))
            pdf = np.ones(m)
            f = np.zeros((m, 3))
            for mi, mat in enumerate(mat_table):
                sel = bi == mi
                if sel.any():
                    wi_s, pdf_s, _ = mat.sample_f(bn[sel], wo[sel], rng)
                    wi[sel] = wi_s
                    pdf[sel] = pdf_s
                    f[sel] = mat.bsdf(bn[sel], wo[sel], wi_s)
            sub = self.trace(pos, wi, bounce + 1, max_bounces, rng)
            indirect = (
                f * sub * (np.abs(_dot(wi, bn)) / np.maximum(pdf, 1e-300))[:, None]
            )
            out += np.where(hit[:, None], np.minimum(indirect, FIREFLY_CLAMP), 0.0)
        return out


def render(scene, eye, target, up, fov, width, height, spp, max_bounces, seed=0):
    """camera.rs:44-55 look_at + :65-82 cast_ray + renderer.rs:173-184 NDC."""
    eye = np.asarray(eye, np.float64)
    direction = _norm(np.asarray(target, np.float64) - eye)
    upv = np.asarray(up, np.float64)
    # look_at re-orthogonalizes up
    right = _norm(np.cross(direction, upv))
    upv = _norm(np.cross(right, direction))
    dpl = 1.0 / np.tan(fov / 2.0)

    rng = np.random.default_rng(seed)
    dim = float(max(width, height))
    xs = np.arange(width * height)
    px = (xs % width).astype(np.float64)
    py = (xs // width).astype(np.float64)
    xn = (2.0 * px + 1.0 - width) / dim
    yn = (2.0 * (height - py) - 1.0 - height) / dim

    acc = np.zeros((width * height, 3))
    for _ in range(spp):
        jx = rng.uniform(-1.0 / dim, 1.0 / dim, xn.shape)
        jy = rng.uniform(-1.0 / dim, 1.0 / dim, yn.shape)
        d = (
            dpl * direction[None, :]
            + (xn + jx)[:, None] * right[None, :]
            + (yn + jy)[:, None] * upv[None, :]
        )
        d = _norm(d)
        o = np.tile(eye, (len(xs), 1))
        acc += scene.trace(o, d, 0, max_bounces, rng)
    return acc / spp


# --- volumetric branch (renderer.rs:188-285) --------------------------------


class OMedium:
    """Homogeneous isotropic fog (medium.rs:80-96): constant absorption/
    scattering, tan albedo 0xD2B48C, phase 1/(4 pi), origin-only extinction
    free-flight sampling (medium.rs:126-146).

    One documented deviation shared with rpt_tpu (medium.py docstring): the
    reference's ``sample_ph`` normalizes a uniform point in the cube
    [-1,1]^3 while claiming pdf 1/(4 pi); both rpt_tpu and this oracle
    sample the exact uniform-sphere distribution that pdf describes (here
    via Gaussian normalization — a different construction from rpt_tpu's
    inverse-CDF sampler, preserving independence).
    """

    def __init__(self, absorption, scattering, emission=0.0):
        self.abs = float(absorption)
        self.scat = float(scattering)
        self.emission = float(emission)
        c = 0xD2B48C
        self.color = np.array(
            [(((c >> s) & 0xFF) / 255.0) ** 2.2 for s in (16, 8, 0)], np.float64
        )
        self.ext = self.abs + self.scat
        self.phase = 1.0 / (4.0 * np.pi)

    def sample_d(self, m, rng):
        u = rng.uniform(0.0, 1.0, m)
        return -np.log(np.maximum(u, 1e-300)) / self.ext

    def sample_ph(self, m, rng):
        v = rng.normal(size=(m, 3))
        return _norm(v), np.full(m, self.phase)


BACKGROUND_DIST = 400.0  # renderer.rs:198
RR_P = 0.8  # renderer.rs:192


def _sample_lights_for_media(scene, medium, pos, wo, rng):
    """renderer.rs:330-359: per light, (scat/ext) * intensity * medium_color
    * phase; same standard-visibility deviation as sample_lights."""
    m = pos.shape[0]
    color = np.zeros((m, 3))
    for light in scene.lights:
        v, ln, pdf = light.sample(pos, rng)
        disp = v - pos
        dist = np.linalg.norm(disp, axis=-1)
        wi = disp / dist[:, None]
        cos_l = np.maximum(-_dot(disp, ln), 0.0) / dist
        sa = np.maximum(cos_l, 0.0) / (dist * dist)
        emit = light.mat.albedo * light.mat.emittance
        intensity = emit[None, :] * (sa / pdf)[:, None]
        vis = ~scene.occluded(pos, wi, dist * (1.0 - SHADOW_EPS))
        contrib = (medium.scat / medium.ext) * intensity * medium.color[None, :] * medium.phase
        color += np.where(vis[:, None], contrib, 0.0)
    return color


def trace_volumetric(scene, medium, o, d, bounce, rng, depth_cap=64):
    """renderer.rs:188-285 media branch, recursive, f64, vectorized over
    rays with dead lanes compacted out. Note the reference quirks kept
    exactly: free-flight distance vs closest-hit competition; env only when
    d >= 400 on a miss; bounce-0-only emission for BOTH surface and medium
    events; Russian roulette p=0.8 with NO firefly clamp and NO
    max_bounces cap on the surface sub-branch; no transmittance or
    distance-pdf weighting anywhere (the estimator is what it is)."""
    m = o.shape[0]
    out = np.zeros((m, 3))
    if m == 0 or bounce >= depth_cap:
        return out

    dist = medium.sample_d(m, rng)
    bt, bn, bi = scene.closest_hit(o, d)
    has_hit = np.isfinite(bt)
    max_dist = np.where(has_hit, bt, BACKGROUND_DIST)
    medium_event = dist < max_dist
    surface_event = ~medium_event & has_hit
    escape_event = ~medium_event & ~has_hit

    wo = -_norm(d)
    out[escape_event & (dist >= BACKGROUND_DIST)] = scene.env[None, :]

    mat_table = [obj.mat for obj in scene.objects]

    # surface event: bounce-0 emission + NEE (renderer.rs:207-221)
    pos = o + np.where(has_hit, bt, 0.0)[:, None] * d
    emit = np.zeros((m, 3))
    if bounce == 0:
        for mi, mat in enumerate(mat_table):
            emit[bi == mi] = mat.albedo * mat.emittance
    nee = scene.sample_lights(mat_table, bi, pos, bn, wo, rng)
    out += np.where(surface_event[:, None], emit + nee, 0.0)

    # medium event: bounce-0 emission + media NEE (renderer.rs:244-260)
    collision = o + dist[:, None] * d
    med_nee = _sample_lights_for_media(scene, medium, collision, wo, rng)
    med_emit = medium.emission * medium.color[None, :] if bounce == 0 else 0.0
    out += np.where(medium_event[:, None], med_emit + med_nee, 0.0)

    # Russian roulette continuation (renderer.rs:222,262)
    survive = rng.uniform(0.0, 1.0, m) < RR_P

    # surface continuation factor f * |wi.n| / (pdf * rr_p)
    wi = np.zeros((m, 3))
    pdf = np.ones(m)
    f = np.zeros((m, 3))
    for mi, mat in enumerate(mat_table):
        sel = bi == mi
        if sel.any():
            wi_s, pdf_s, _ = mat.sample_f(bn[sel], wo[sel], rng)
            wi[sel] = wi_s
            pdf[sel] = pdf_s
            f[sel] = mat.bsdf(bn[sel], wo[sel], wi_s)
    surf_factor = f * (np.abs(_dot(wi, bn)) / (np.maximum(pdf, 1e-300) * RR_P))[:, None]

    # medium continuation factor (scat/ext) * color * phase / (ph_p * rr_p)
    wi_m, ph_p = medium.sample_ph(m, rng)
    med_factor = (
        (medium.scat / medium.ext)
        * medium.color[None, :]
        * (medium.phase / (ph_p * RR_P))[:, None]
    )

    cont = survive & (medium_event | surface_event)
    idx = np.flatnonzero(cont)
    if idx.size:
        no = np.where(medium_event[idx, None], collision[idx], pos[idx])
        nd = np.where(medium_event[idx, None], wi_m[idx], wi[idx])
        sub = trace_volumetric(scene, medium, no, nd, bounce + 1, rng, depth_cap)
        factor = np.where(
            medium_event[idx, None], med_factor[idx], surf_factor[idx]
        )
        out[idx] += factor * sub
    return out


def render_volumetric(scene, medium, eye, target, up, fov, width, height, spp,
                      seed=0):
    """Camera loop identical to ``render`` but through the media branch."""
    eye = np.asarray(eye, np.float64)
    direction = _norm(np.asarray(target, np.float64) - eye)
    upv = np.asarray(up, np.float64)
    right = _norm(np.cross(direction, upv))
    upv = _norm(np.cross(right, direction))
    dpl = 1.0 / np.tan(fov / 2.0)

    rng = np.random.default_rng(seed)
    dim = float(max(width, height))
    xs = np.arange(width * height)
    px = (xs % width).astype(np.float64)
    py = (xs // width).astype(np.float64)
    xn = (2.0 * px + 1.0 - width) / dim
    yn = (2.0 * (height - py) - 1.0 - height) / dim

    acc = np.zeros((width * height, 3))
    for _ in range(spp):
        jx = rng.uniform(-1.0 / dim, 1.0 / dim, xn.shape)
        jy = rng.uniform(-1.0 / dim, 1.0 / dim, yn.shape)
        dvec = (
            dpl * direction[None, :]
            + (xn + jx)[:, None] * right[None, :]
            + (yn + jy)[:, None] * upv[None, :]
        )
        dvec = _norm(dvec)
        o = np.tile(eye, (len(xs), 1))
        acc += trace_volumetric(scene, medium, o, dvec, 0, rng)
    return acc / spp


# --- photon-map estimates (photon.rs:316-437) --------------------------------


def _knn_exact(points, queries, k):
    """Exact brute-force k-NN (independent of rpt_tpu's calibrated grid).
    Returns (idx (m,k), d2 (m,k), valid (m,k))."""
    m = queries.shape[0]
    p = points.shape[0]
    if p == 0:
        return (np.zeros((m, k), np.int64), np.zeros((m, k)), np.zeros((m, k), bool))
    d2 = ((queries[:, None, :] - points[None, :, :]) ** 2).sum(-1)  # (m, p)
    kk = min(k, p)
    idx = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
    dd = np.take_along_axis(d2, idx, axis=1)
    order = np.argsort(dd, axis=1)
    idx = np.take_along_axis(idx, order, axis=1)
    dd = np.take_along_axis(dd, order, axis=1)
    if kk < k:
        idx = np.pad(idx, ((0, 0), (0, k - kk)))
        dd = np.pad(dd, ((0, 0), (0, k - kk)))
    valid = np.zeros((m, k), bool)
    valid[:, :kk] = True
    return idx, dd, valid


def photon_surface_estimate(scene, photons, o, d, k):
    """Disk density estimate (photon.rs:327-375): k-NN gather, per-photon
    occlusion recheck, bsdf * power * clamp(dir.n), all divided by
    pi * max_d2 (including the emitted term — reference quirk kept).
    ``photons`` is an (P, >=9) array [pos, dir, power]. Rays that miss
    return 0 (the caller applies env/medium dispatch)."""
    m = o.shape[0]
    bt, bn, bi = scene.closest_hit(o, d)
    hit = np.isfinite(bt)
    pos = o + np.where(hit, bt, 0.0)[:, None] * d
    wo = -_norm(d)
    out = np.zeros((m, 3))
    if photons.shape[0] == 0:
        return out

    idx, d2, valid = _knn_exact(photons[:, 0:3], pos, k)
    max_d2 = (d2 * valid).max(axis=1)

    mat_table = [obj.mat for obj in scene.objects]
    emit = np.zeros((m, 3))
    for mi, mat in enumerate(mat_table):
        emit[bi == mi] = mat.albedo * mat.emittance
    acc = emit.copy()
    for j in range(idx.shape[1]):
        pj = photons[idx[:, j]]
        p_pos, p_dir, p_pow = pj[:, 0:3], pj[:, 3:6], pj[:, 6:9]
        disp = pos - p_pos
        dist = np.linalg.norm(disp, axis=-1)
        sdir = disp / np.maximum(dist, 1e-300)[:, None]
        # occlusion recheck photon -> gather point (photon.rs:353-361);
        # same standard-visibility epsilon policy as rpt_tpu
        vis = ~scene.occluded(p_pos, sdir, dist * (1.0 - SHADOW_EPS))
        f = np.zeros((m, 3))
        for mi, mat in enumerate(mat_table):
            sel = bi == mi
            if sel.any():
                f[sel] = mat.bsdf(bn[sel], wo[sel], p_dir[sel])
        w = np.clip(_dot(p_dir, bn), 0.0, 1.0)
        ok = valid[:, j] & vis & hit
        acc += np.where(ok[:, None], f * p_pow * w[:, None], 0.0)
    inv = np.where(max_d2 > 0.0, 1.0 / (np.pi * np.maximum(max_d2, 1e-300)), 0.0)
    return np.where(hit[:, None], acc * inv[:, None], 0.0)


def _k2(x):
    """Blur kernel k2 (photon.rs:466-469 / :525-528). Clamped at x=2:
    every consumer masks lanes to x < 1 (dist < radius), but masked
    lanes can carry dist/1e-300 ratios whose square overflows f64 —
    the clamp only touches lanes whose product is zeroed anyway."""
    return (3.0 / np.pi) * (1.0 - np.minimum(x, 2.0)) ** 2


def photon_beam_sphere_estimate(scene, medium, ph_pos, ph_dir, ph_pow, ph_rad,
                                o, d):
    """PointMapForBeamEstimate (photon.rs:439-501), f64: perpendicular
    disk test of the camera beam against every photon sphere. Reference
    quirks kept: the hit-time cull compares the photon-CENTER distance
    |pos - origin| to hit.time (:478-482, not the disk distance);
    transmittance uses the disk distance; phase is evaluated at
    (-photon.dir, -ray.dir). The caller passes the SAME adaptive radii
    the wavefront uses (radius construction is covered by the
    device-vs-host k-NN agreement test)."""
    m = o.shape[0]
    bt, _, _ = scene.closest_hit(o, d)
    hit_time = np.where(np.isfinite(bt), bt, np.inf)
    out = np.zeros((m, 3))
    for j in range(ph_pos.shape[0]):
        oc = ph_pos[j][None, :] - o
        dd = _dot(oc, d)
        dist2 = ((o + dd[:, None] * d - ph_pos[j][None, :]) ** 2).sum(-1)
        r2 = ph_rad[j] * ph_rad[j]
        ok = (np.linalg.norm(oc, axis=-1) <= hit_time) & (dd > 0.0) & (dist2 < r2)
        weight = _k2(dist2 / max(r2, 1e-300)) / max(r2, 1e-300)
        trans = np.exp(-medium.ext * dd)
        contrib = (
            trans[:, None]
            * (ph_pow[j][None, :] * medium.color[None, :])
            * medium.phase
            * weight[:, None]
        )
        out += np.where(ok[:, None], contrib, 0.0)
    return out


def photon_beam_beam_estimate(scene, medium, b_start, b_dir, b_len, b_rad,
                              b_pow, o, d, t_positive=False):
    """BeamMapForBeamEstimate, eq. 38 (photon.rs:503-593), f64: closest
    approach of the camera beam to each photon beam. ``t_positive``
    mirrors rpt_tpu's documented deviation (PARITY.md): the reference
    accepts behind-origin intersections (t<0), whose exp(-ext*t)
    transmittance AMPLIFIES power; pass True to compare against rpt_tpu."""
    m = o.shape[0]
    bt, _, _ = scene.closest_hit(o, d)
    hit_time = np.where(np.isfinite(bt), bt, np.inf)
    out = np.zeros((m, 3))
    for j in range(b_start.shape[0]):
        l = b_start[j][None, :] - o
        u = _norm(np.cross(l, b_dir[j][None, :]))
        nn = _norm(np.cross(b_dir[j][None, :], u))
        t = _dot(nn, l) / _dot(nn, d)
        qc = o + t[:, None] * d
        ok = t < hit_time
        if t_positive:
            ok &= t > 0.0
        cosb = _dot(d, b_dir[j][None, :])
        inv_sin = 1.0 / np.sqrt(np.maximum(1.0 - cosb * cosb, 1e-300))
        beam_t = _dot(b_dir[j][None, :], qc - b_start[j][None, :])
        ok &= (beam_t >= 0.0) & (beam_t <= b_len[j])
        bc = b_start[j][None, :] + beam_t[:, None] * b_dir[j][None, :]
        dist = np.linalg.norm(qc - bc, axis=-1)
        ok &= dist < b_rad[j]
        # masked lanes can carry t ~ -1e30 (behind-origin / parallel-beam
        # degeneracies); exp(-ext*t) would overflow f64 there even though
        # the `ok` mask zeroes the product. Clamp the exponent arguments on
        # masked lanes so the suite stays clean under -W error and a real
        # inf/NaN leaking into a COMPARED lane is detectable.
        t_safe = np.where(ok, t, 0.0)
        beam_t_safe = np.where(ok, beam_t, 0.0)
        contrib = (
            medium.ext
            * (b_pow[j][None, :] * medium.color[None, :])
            * medium.phase
            * inv_sin[:, None]
            * np.exp(-medium.ext * t_safe)[:, None]
            * np.exp(-medium.ext * beam_t_safe)[:, None]
            * _k2(dist / max(b_rad[j], 1e-300))[:, None]
            / (2.0 * max(b_rad[j], 1e-300))
        )
        out += np.where(ok[:, None], contrib, 0.0)
    return out


def photon_volume_point_estimate(scene, medium, s_photons, v_photons, o, d,
                                 k_surf, k_vol, rng=None, dist=None, surf=None):
    """Point-query volume estimate (photon.rs:384-437): free-flight sample
    competes with the surface hit; sphere density (4/3 pi r^3) at the
    collision / extinction * transmittance / d_pdf; otherwise the surface
    estimate attenuated by transmittance / (1 - d_cdf).

    Reference quirk kept exactly on both sides: the surface branch divides
    by ``1 - cdf(d)`` at the SAMPLED distance d (photon.rs:435-437,
    medium.rs:143), not at the hit time. Conditional on d >= t_hit the
    weight is exp(ext*(d - t_hit)) — a Pareto(1) tail whose expectation is
    INFINITE, so two independent samplings of this estimator have sample
    means that never converge to each other. Tests must therefore pass the
    wavefront's own sampled ``dist`` (and may pass a precomputed ``surf``
    image, which is deterministic) so the comparison is per-sample exact
    rather than distributional."""
    m = o.shape[0]
    if dist is None:
        dist = medium.sample_d(m, rng)
    t = np.exp(-medium.ext * dist)
    d_pdf = medium.ext * t
    d_cdf = 1.0 - t
    bt, _, _ = scene.closest_hit(o, d)
    hit = np.isfinite(bt)
    in_volume = ~hit | (dist < bt)

    collision = o + dist[:, None] * d
    wo = -_norm(d)
    vol = np.zeros((m, 3))
    if v_photons.shape[0] > 0:
        idx, d2, valid = _knn_exact(v_photons[:, 0:3], collision, k_vol)
        max_d2 = (d2 * valid).max(axis=1)
        acc = np.zeros((m, 3))
        for j in range(idx.shape[1]):
            pj = v_photons[idx[:, j]]
            p_pow = pj[:, 6:9]
            # isotropic phase: constant, independent of directions
            acc += np.where(valid[:, j, None], p_pow * medium.color[None, :] * medium.phase, 0.0)
        denom = (4.0 / 3.0) * np.pi * np.maximum(max_d2, 1e-300) ** 1.5
        vol = acc / denom[:, None] / medium.ext
        vol = vol * (np.exp(-medium.ext * dist) / np.maximum(d_pdf, 1e-300))[:, None]
        vol = np.where((max_d2 > 0.0)[:, None], vol, 0.0)

    if surf is None:
        surf = photon_surface_estimate(scene, s_photons, o, d, k_surf)
    surf_att = surf * (
        np.exp(-medium.ext * np.where(hit, bt, 0.0)) / np.maximum(1.0 - d_cdf, 1e-300)
    )[:, None]
    return np.where(in_volume[:, None], vol, np.where(hit[:, None], surf_att, 0.0))
