"""CPU coverage for the deferred traversal's ladder + cleanup machinery.

The rung-compaction / pack-unpack / cleanup-stall code
(`deferred.py:432-652`) previously asserted per-lane identity only on
wavefronts where the cleanup fixpoint was a no-op, and only with the
default TOP_SEED setting. Here:

* the >MIN_STAGE ladder path runs with TOP_SEED forced ON and OFF;
* the candidate buffer is starved (CAND_SLOTS=2) with minimal bursts
  (DESCENT_STEPS=1, TEST_ROUNDS=1) so lanes genuinely overflow into the
  cleanup fixpoint (`cleanup_body`, deferred.py:628-651) — the test first
  PROVES stalls occur by replaying phase A+B with the module's own
  helpers, then asserts the full traversal is still exact per-lane.

Exactness reference: the short-stack traversal (`intersect._traverse`),
itself validated against f64 brute force (test_intersect / PERF.md).
Parity anchor: kdtree.rs:154-226 (the recursion both engines replace).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import rpt_tpu as rpt
import rpt_tpu.deferred as deferred
from rpt_tpu.intersect import _traverse
from rpt_tpu.meshes import displaced_blob
from rpt_tpu.ray import Ray
from rpt_tpu.vec import Vec3


@pytest.fixture(scope="module")
def big_scene():
    mesh = displaced_blob(101, 102, amplitude=0.35, seed=7)  # ~20k tris
    scene = rpt.Scene()
    scene.add(rpt.Object(mesh))
    cs = scene.compile()
    assert "clusters" in cs.tables
    return cs


def wide_rays(n_side=97):
    """9409 rays (> MIN_STAGE=4096, NOT a power of the ladder ratio):
    ring of origins, three quarters at the blob, one quarter at the sky."""
    ys, xs = np.mgrid[0:n_side, 0:n_side]
    u = (xs.ravel() + 0.5) / n_side * 2.0 - 1.0
    v = (ys.ravel() + 0.5) / n_side * 2.0 - 1.0
    origin = np.stack([3.0 * np.ones_like(u), 0.4 * v, 3.0 * u], 1)
    target = np.stack([0.35 * u, 0.35 * v, np.zeros_like(u)], 1)
    target[::4] += np.array([0.0, 60.0, 0.0])
    d = target - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Ray(
        Vec3(*(jnp.asarray(origin[:, i]) for i in range(3))),
        Vec3(*(jnp.asarray(d[:, i]) for i in range(3))),
    ), len(d)


def _assert_exact(big_scene, ray, n):
    # FRESH jit wrappers per call (never module-level): these tests
    # monkeypatch trace-time constants (TOP_SEED, CAND_SLOTS, ...), and a
    # shared jit cache would silently reuse the previous test's trace.
    # Tables go in as ARGUMENTS, as production calls them — eager calls
    # embed the 20k-tri tables as HLO constants, whose giant one-off
    # modules XLA:CPU sporadically segfaulted on (see test_tiled.py).
    jt = jax.jit(
        lambda bvh, r, lim, b, ah: _traverse(bvh, r, 1e-4, lim, b, any_hit=ah),
        static_argnums=(4,),
    )
    jd = jax.jit(
        lambda ct, r, lim, b, ah: deferred.deferred_traverse(
            ct, r, 1e-4, lim, b, ah
        ),
        static_argnums=(4,),
    )
    bvh = big_scene.tables["bvh"]
    clusters = big_scene.tables["clusters"]
    inf = jnp.full((n,), np.inf, jnp.float32)
    t_ref, *_ = jt(bvh, ray, inf, inf, False)
    t_new, *_ = jd(clusters, ray, inf, inf, False)
    t_ref, t_new = np.asarray(t_ref), np.asarray(t_new)
    mask_agree = np.isfinite(t_ref) == np.isfinite(t_new)
    assert mask_agree.all(), f"hit masks differ on {(~mask_agree).sum()} lanes"
    both = np.isfinite(t_ref) & np.isfinite(t_new)
    assert both.sum() > n // 4
    np.testing.assert_allclose(t_new[both], t_ref[both], rtol=1e-5, atol=1e-5)
    # occlusion flavor through the same machinery
    limit = jnp.full((n,), 3.2, jnp.float32)
    t_ao, *_ = jt(bvh, ray, limit, inf, True)
    t_an, *_ = jd(clusters, ray, limit, inf, True)
    np.testing.assert_array_equal(
        np.asarray(t_ao) < 3.2, np.asarray(t_an) < 3.2
    )


@pytest.mark.parametrize("top_seed", [True, False])
def test_ladder_exact_with_and_without_top_seed(big_scene, top_seed,
                                                monkeypatch):
    """deferred.py:546-557: the dense top-of-tree seed and the classic
    root init must give identical results through the full ladder."""
    monkeypatch.setattr(deferred, "TOP_SEED", top_seed)
    ray, n = wide_rays()
    assert n >= deferred.MIN_STAGE
    _assert_exact(big_scene, ray, n)


def _stall_count_after_phases(clusters, ray, n, t_min=1e-4):
    """Replay deferred_traverse up to the end of phase B using the
    module's own helpers (deferred.py:546-619) and return how many lanes
    enter the cleanup fixpoint. White-box by design: if the phase
    structure changes, update this alongside it. Runs under a fresh jit
    (tables as arguments) for the same reasons as _assert_exact."""
    body = jax.jit(lambda ct, r: _stall_body(ct, r, n, t_min))
    return int(np.asarray(body(clusters, ray)))


def _stall_body(clusters, ray, n, t_min):
    dn = ray.dir  # wide_rays directions are unit-length already
    inv_dir = Vec3.ones(dn.shape) / dn
    limit_u = jnp.full((n,), deferred.INF, deferred.DTYPE)
    best_u0 = jnp.full((n,), deferred.INF, deferred.DTYPE)
    active = jnp.ones(n, bool)
    depth = clusters.tree_depth
    uray = Ray(ray.origin, dn)
    if deferred.TOP_SEED and clusters.tree_top > 0:
        cur0, sp0, stack0 = deferred._dense_top_seed(
            clusters.tree, clusters.tree_top, uray, inv_dir, t_min, limit_u,
            best_u0, active, depth,
        )
    else:
        cur0 = jnp.where(
            active, (1 << deferred._tree_wide(clusters.tree)) - 1, -1
        ).astype(jnp.int32)
        sp0 = jnp.zeros(n, jnp.int32)
        stack0 = jnp.zeros((n, depth), jnp.int32)
    state = (
        cur0, sp0, stack0, best_u0,
        jnp.full(n, -1, jnp.int32),
        jnp.full((n, deferred.CAND_SLOTS), deferred.INF, deferred.DTYPE),
        jnp.zeros((n, deferred.CAND_SLOTS), jnp.int32),
        ~active,
    )
    state = deferred._run_ladder(
        state, uray, inv_dir, limit_u,
        lambda s, lim: deferred._descend_mask(s),
        lambda sray, sinv, slim: deferred._make_descent_step(
            clusters.tree, sray, sinv, t_min, slim
        ),
    )
    state = deferred._run_ladder(
        state, uray, inv_dir, limit_u,
        lambda s, lim: deferred._pending_mask(s, lim, False),
        lambda sray, sinv, slim: deferred._make_test_round(
            clusters, sray, sray.dir, sinv, t_min, slim, False
        ),
    )
    state = deferred._make_prune(limit_u, False)(state)
    cur, _, _, _, _, cand_t, _, done = state
    done = done | ((cur < 0) & ~jnp.any(cand_t < deferred.INF, axis=1))
    return jnp.sum(~done)


def test_cleanup_stall_path_exact(big_scene, monkeypatch):
    """Starve the candidate buffer so the cleanup fixpoint
    (deferred.py:628-651) must run — compaction, pack/unpack round-trips,
    and scatter-back all live — and assert per-lane exactness."""
    monkeypatch.setattr(deferred, "CAND_SLOTS", 2)
    monkeypatch.setattr(deferred, "DESCENT_STEPS", 1)
    monkeypatch.setattr(deferred, "TEST_ROUNDS", 1)
    ray, n = wide_rays()
    clusters = big_scene.tables["clusters"]
    stalled = _stall_count_after_phases(clusters, ray, n)
    assert stalled > 0, (
        "starved configuration produced no stalls — the cleanup path is "
        "not being exercised; tighten the starvation knobs"
    )
    _assert_exact(big_scene, ray, n)


def test_pack_unpack_roundtrip():
    """_pack_blocks/_unpack_blocks (deferred.py:432-475) must be a
    lossless bijection on every state field."""
    rng = np.random.default_rng(11)
    n, depth, cs = 64, 9, deferred.CAND_SLOTS
    state = (
        jnp.asarray(rng.integers(-1, 1 << 20, n), jnp.int32),
        jnp.asarray(rng.integers(0, depth, n), jnp.int32),
        jnp.asarray(rng.integers(0, 1 << 20, (n, depth)), jnp.int32),
        jnp.asarray(rng.uniform(0, 9, n), jnp.float32),
        jnp.asarray(rng.integers(-1, 9, n), jnp.int32),
        jnp.asarray(
            np.where(rng.uniform(size=(n, cs)) < 0.5, np.inf,
                     rng.uniform(0, 5, (n, cs))), jnp.float32),
        jnp.asarray(rng.integers(0, 1 << 20, (n, cs)), jnp.int32),
        jnp.asarray(rng.uniform(size=n) < 0.3),
    )
    uray = Ray(
        Vec3(*(jnp.asarray(rng.normal(size=n), jnp.float32) for _ in range(3))),
        Vec3(*(jnp.asarray(rng.normal(size=n), jnp.float32) for _ in range(3))),
    )
    inv = Vec3.ones(uray.dir.shape) / uray.dir
    limit = jnp.asarray(rng.uniform(1, 9, n), jnp.float32)
    fblk, iblk = deferred._pack_blocks(state, uray, inv, limit)
    state2, uray2, inv2, limit2 = deferred._unpack_blocks(fblk, iblk, depth)
    for a, b in zip(state, state2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for v_a, v_b in ((uray.origin, uray2.origin), (uray.dir, uray2.dir),
                     (inv, inv2)):
        for c in "xyz":
            np.testing.assert_array_equal(
                np.asarray(getattr(v_a, c)), np.asarray(getattr(v_b, c))
            )
    np.testing.assert_array_equal(np.asarray(limit), np.asarray(limit2))
