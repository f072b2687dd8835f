"""rpt_tpu — a wavefront physically-based renderer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
reference Rust path tracer (neevparikh/rpt): four integrators (volumetric
path tracing and three photon-mapping estimators), the same
Scene/Object/Material/Medium/Camera/Renderer API surface, asset I/O, and
the ODE/animation module — executed as SPMD wavefronts over device meshes
instead of per-ray recursion over CPU threads.

Everything is re-exported flat, mirroring the reference's ``lib.rs:6-20``.
"""

from .buffer import Buffer, Filter  # noqa: F401
from .camera import Camera  # noqa: F401
from .color import color_bytes, hex_color  # noqa: F401
from .environment import ColorEnvironment, Environment, Hdri  # noqa: F401
from .io import load_hdr, load_mtl, load_obj, load_obj_with_mtl, load_stl  # noqa: F401
from .lights import (  # noqa: F401
    AmbientLight,
    DirectionalLight,
    Light,
    ObjectLight,
    PointLight,
)
from .materials import Material  # noqa: F401
from .medium import Medium  # noqa: F401
from .renderer import Renderer  # noqa: F401
from .scene import CompiledScene, Object, Scene  # noqa: F401
from .shapes import (  # noqa: F401
    Cube,
    KdTree,
    ShapeGroup,
    Mesh,
    MonomialSurface,
    Plane,
    Sphere,
    Transformed,
    cube,
    monomial_surface,
    plane,
    polygon,
    sphere,
)
from .ode import (  # noqa: F401
    MarblesSystem,
    ParticleState,
    ParticleSystem,
    SimpleCircleSystem,
    SolidGravitySystem,
)
from .vec import Vec3  # noqa: F401

__version__ = "0.1.0"
