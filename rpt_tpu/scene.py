"""Scene description and compilation to flat device tables.

Parity: `/root/reference/src/scene.rs` and `src/object.rs`. ``Scene.add``
accepts objects, lights, media, environments, and the (geometry, material)
dual-add that registers emissive geometry as both a visible object and a
light at once (scene.rs:57-75).

``compile()`` lowers the object list into SoA device tables grouped by
primitive type: mesh triangles are baked to world space and packed into one
flattened rope-BVH; analytic primitives keep inverse/normal transforms per
``Transformed`` semantics (shape.rs:102-126). The result is a static
``CompiledScene`` (Python structure, closed over by jitted kernels) plus a
``tables`` pytree of device arrays (passed as kernel arguments).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from .accel.bvh import build_bvh, pack_bvh
from .dtypes import DTYPE

# meshes at/above this size also get fat-cluster tables (tile fast path)
CLUSTERS_MIN_TRIS = 16384
from .environment import ColorEnvironment, Hdri
from .intersect import BVHTables, PlaneSet, PrimSet
from .lights import (
    AmbientLight,
    CompiledLight,
    DirectionalLight,
    Light,
    ObjectLight,
    PointLight,
    compile_light,
)
from .materials import Material, MaterialTable
from .medium import Medium
from .shapes import (
    Cube,
    Mesh,
    ShapeGroup,
    MonomialSurface,
    Plane,
    Sphere,
    Transformed,
    transform_mesh,
    unwrap,
)
from .vec import Affine, Mat3, Vec3


class Object:
    """Shape + material (object.rs:10-32)."""

    def __init__(self, shape, material: Material | None = None):
        self.shape = shape
        self._material = material or Material()

    def material(self, material: Material) -> "Object":
        return Object(self.shape, material)


_LIGHT_TYPES = (PointLight, AmbientLight, DirectionalLight, ObjectLight)


class Scene:
    """Mutable scene builder (scene.rs:12-31)."""

    def __init__(self):
        self.objects: list[Object] = []
        self.lights: list = []
        self.media: list[Medium] = []
        self.environment = ColorEnvironment()

    def add(self, node):
        """SceneAdd overloads (scene.rs:39-81), including the object+light
        dual add for (geometry, material) tuples (scene.rs:57-75)."""
        if isinstance(node, Object):
            self.objects.append(node)
        elif isinstance(node, _LIGHT_TYPES):
            self.lights.append(node)
        elif isinstance(node, Medium):
            self.media.append(node)
        elif isinstance(node, (ColorEnvironment, Hdri)):
            self.environment = node
        elif isinstance(node, tuple) and len(node) == 2 and isinstance(node[1], Material):
            geometry, material = node
            self.objects.append(Object(geometry, material))
            self.lights.append(Light.Object(Object(geometry, material)))
        else:
            raise TypeError(f"Cannot add {type(node).__name__} to scene")

    def compile(self) -> "CompiledScene":
        return compile_scene(self)


@dataclass(frozen=True)
class CompiledScene:
    """Static structure of a compiled scene. Jitted kernels close over this;
    the array payload lives in ``tables`` (a pytree argument)."""

    n_spheres: int
    n_planes: int
    n_cubes: int
    n_monomials: int
    n_tris: int
    lights: tuple  # tuple[CompiledLight, ...]
    media: tuple  # tuple[Medium, ...] (callables traced into kernels)
    environment: object
    t_min: float  # scale-aware ray epsilon (reference: 1e-12 in f64)
    shadow_eps: float  # relative tolerance of the shadow-visibility test
    scale: float  # scene diameter estimate
    # "occlusion": standard no-occluder-strictly-closer test (default).
    # "exact": the reference's literal semantics (renderer.rs:395-396) —
    # accept NEE only when the CLOSEST hit lies at the light distance,
    # which rejects all samples of lights whose geometry is not dual-added
    # to scene.objects. Kept for quantifying the deviation (PARITY.md).
    nee_mode: str = "occlusion"
    tables: dict = field(compare=False, repr=False, default=None)

    def env_color(self, tables, direction) -> Vec3:
        return self.environment.get_color(tables["env"], direction)


def _prim_set(entries) -> PrimSet:
    mats = np.array([e[1] for e in entries], np.int32)
    m4 = np.stack([e[0] for e in entries])
    inv = np.linalg.inv(m4)
    lin = m4[:, :3, :3]
    params = np.array([e[2] for e in entries], np.float64)
    return PrimSet(
        world_to_obj=Affine.from_numpy(inv),
        normal_mat=Mat3.from_numpy(np.linalg.inv(lin).transpose(0, 2, 1)),
        obj_to_world=Affine.from_numpy(m4),
        det=jnp.asarray(np.linalg.det(lin), DTYPE),
        material=jnp.asarray(mats),
        param=jnp.asarray(params, DTYPE),
    )


def compile_scene(scene: Scene) -> CompiledScene:
    materials: list[Material] = []
    mat_ids: dict[Material, int] = {}

    def mat_id(m: Material) -> int:
        if m not in mat_ids:
            mat_ids[m] = len(materials)
            materials.append(m)
        return mat_ids[m]

    spheres, cubes, monomials, planes = [], [], [], []
    tri_v, tri_n, tri_m = [], [], []
    points_min, points_max = [], []

    flat_objects = []
    for obj in scene.objects:
        base, matrix = unwrap(obj.shape)
        if isinstance(base, ShapeGroup):
            # flatten group members, composing the group transform
            for member in base.shapes:
                mbase, mmatrix = unwrap(member)
                flat_objects.append((mbase, matrix @ mmatrix, obj._material, member))
        else:
            flat_objects.append((base, matrix, obj._material, obj.shape))

    for base, matrix, material, original in flat_objects:
        mid = mat_id(material)
        is_transformed = not np.allclose(matrix, np.eye(4))
        if isinstance(base, Sphere):
            spheres.append((matrix, mid, 0.0))
            _track_bbox(points_min, points_max, base.bounding_box(), matrix)
        elif isinstance(base, Cube):
            cubes.append((matrix, mid, 0.0))
            _track_bbox(points_min, points_max, base.bounding_box(), matrix)
        elif isinstance(base, MonomialSurface):
            if abs(base.exp - 4.0) > 1e-9:
                raise NotImplementedError("MonomialSurface requires exp == 4 (as the reference)")
            monomials.append((matrix, mid, base.height))
            _track_bbox(points_min, points_max, base.bounding_box(), matrix)
        elif isinstance(base, Plane):
            # transform the plane equation analytically: under x -> Mx + t,
            # {p . n = v} maps to {p . n' = v'} with n' = M^-T n,
            # v' = v + n' . t
            m4 = np.asarray(matrix, np.float64)
            n_new = np.linalg.inv(m4[:3, :3]).T @ np.asarray(base.normal, np.float64)
            v_new = float(base.value + n_new @ m4[:3, 3])
            planes.append((n_new, v_new, mid))
        elif isinstance(base, Mesh):
            mesh = transform_mesh(base, matrix) if is_transformed else base
            tri_v.append(mesh.vertices)
            tri_n.append(mesh.normals)
            tri_m.append(np.full(len(mesh), mid, np.int32))
            if len(mesh):
                points_min.append(mesh.vertices.reshape(-1, 3).min(0))
                points_max.append(mesh.vertices.reshape(-1, 3).max(0))
        else:
            raise NotImplementedError(f"Unsupported shape {type(base).__name__}")

    tables: dict = {}

    if spheres:
        tables["spheres"] = _prim_set(spheres)
    if cubes:
        tables["cubes"] = _prim_set(cubes)
    if monomials:
        tables["monomials"] = _prim_set(monomials)
    if planes:
        tables["planes"] = PlaneSet(
            normal=Vec3.from_array(np.stack([p[0] for p in planes])),
            value=jnp.asarray(np.array([p[1] for p in planes]), DTYPE),
            material=jnp.asarray(np.array([p[2] for p in planes], np.int32)),
        )

    n_tris = 0
    if tri_v:
        v = np.concatenate(tri_v)
        n = np.concatenate(tri_n)
        m = np.concatenate(tri_m)
        n_tris = len(v)
        bvh = build_bvh(v.min(1), v.max(1))
        nodes, leaves, shade, stack_depth = pack_bvh(bvh, v, n, m)
        tables["bvh"] = BVHTables(
            nodes=jnp.asarray(nodes),
            leaves=jnp.asarray(leaves),
            shade=jnp.asarray(shade),
            stack_depth=stack_depth,
        )
        if n_tris >= CLUSTERS_MIN_TRIS:
            # fat-cluster tables for the tile-binned big-mesh fast path
            from .accel.clusters import (
                ClusterTables, pack_clusters, pack_wide_cluster_tree,
            )

            fat, sph, rec, sup, supblk, (bb_lo, bb_hi, tri_counts), n_c = (
                pack_clusters(bvh, v)
            )
            # 16-ary default: where a 512 B row costs the same gather as
            # 256 B (the earlier target), it cuts node visits ~15% on
            # incoherent wavefronts (host replay); width is sweepable via
            # RPT_TPU_TREE_WIDE
            ctree, ctree_depth, ctree_top = pack_wide_cluster_tree(bb_lo, bb_hi, tri_counts)
            tables["clusters"] = ClusterTables(
                fat=jnp.asarray(fat), sph=jnp.asarray(sph),
                rec=jnp.asarray(rec), sup=jnp.asarray(sup),
                supblk=jnp.asarray(supblk), tree=jnp.asarray(ctree),
                n_clusters=n_c, tree_depth=ctree_depth, tree_top=ctree_top,
            )

            # Optional SECOND table set with a different fat-row slot
            # count for the ANY-HIT (shadow) phase: any-hit lanes drain
            # fat rows early (no best-pruning ramp), where a halved row
            # cost can win while closest-hit keeps CT=32. Net-negative on
            # the dragon bench on the earlier target; off unless
            # RPT_TPU_AH_CT=16.
            import os as _os

            from .accel.clusters import CLUSTER_TRIS

            ah_ct = int(_os.environ.get("RPT_TPU_AH_CT", "0"))
            if ah_ct and ah_ct != CLUSTER_TRIS:
                fat2, sph2, rec2, sup2, supblk2, (bl2, bh2, tc2), n_c2 = (
                    pack_clusters(bvh, v, ah_ct)
                )
                ctree2, depth2, top2 = pack_wide_cluster_tree(bl2, bh2, tc2)
                tables["clusters_ah"] = ClusterTables(
                    fat=jnp.asarray(fat2), sph=jnp.asarray(sph2),
                    rec=jnp.asarray(rec2), sup=jnp.asarray(sup2),
                    supblk=jnp.asarray(supblk2), tree=jnp.asarray(ctree2),
                    n_clusters=n_c2, tree_depth=depth2, tree_top=top2,
                )

    compiled_lights = []
    light_tabs = []
    for light in scene.lights:
        st, tb = compile_light(light)
        compiled_lights.append(st)
        light_tabs.append(tb)
    tables["lights"] = tuple(light_tabs)
    tables["materials"] = MaterialTable.build(materials)
    tables["env"] = scene.environment.tables()

    # scale-aware epsilons: the reference's EPSILON=1e-12 (renderer.rs:17)
    # relies on f64; in f32 we scale with the scene diameter.
    if points_min:
        lo = np.minimum.reduce(points_min)
        hi = np.maximum.reduce(points_max)
        scale = float(np.linalg.norm(hi - lo))
    else:
        scale = 1.0
    scale = max(scale, 1e-6)
    t_min = 2e-4 * scale

    return CompiledScene(
        n_spheres=len(spheres),
        n_planes=len(planes),
        n_cubes=len(cubes),
        n_monomials=len(monomials),
        n_tris=n_tris,
        lights=tuple(compiled_lights),
        media=tuple(scene.media),
        environment=scene.environment,
        t_min=t_min,
        shadow_eps=1e-3,
        scale=scale,
        nee_mode=getattr(scene, "nee_mode", "occlusion"),
        tables=tables,
    )


def _track_bbox(points_min, points_max, bbox, matrix):
    """Transform the 8 bbox corners (shape.rs:154-177) for scene-scale
    estimation."""
    lo, hi = bbox
    corners = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])]
    )
    m4 = np.asarray(matrix, np.float64)
    world = corners @ m4[:3, :3].T + m4[:3, 3]
    points_min.append(world.min(0))
    points_max.append(world.max(0))
