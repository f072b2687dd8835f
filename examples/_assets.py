"""Shared asset helpers for the example drivers.

The reference examples download OBJ/STL/HDR assets at run time
(e.g. `dragon.rs:10-23`, `metal.rs:20-31`). These drivers look for the
same assets under ``data/`` (dragon.obj, teapot.obj, ...) and fall back to
deterministic procedural stand-ins when the file (or network) is absent,
so every example runs out of the box.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import rpt_tpu as rpt  # noqa: E402
from rpt_tpu.meshes import displaced_blob, uv_sphere  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _preview_decimate(mesh: "rpt.Mesh") -> "rpt.Mesh":
    """Under RPT_TPU_PREVIEW on the CPU backend (the test/smoke path),
    subsample huge meshes below the fat-cluster threshold: the tiled +
    deferred traversal graph takes minutes to compile on CPU for a
    handful of preview pixels. Accelerator runs are untouched."""
    import jax

    from rpt_tpu.scene import CLUSTERS_MIN_TRIS
    from rpt_tpu.shapes import Mesh

    cap = CLUSTERS_MIN_TRIS - 1
    if (
        not os.environ.get("RPT_TPU_PREVIEW")
        or jax.default_backend() != "cpu"
        or len(mesh) <= cap
    ):
        return mesh
    sel = np.linspace(0, len(mesh) - 1, cap).astype(np.int64)
    print(
        f"note: preview-decimating mesh {len(mesh)} -> {len(sel)} tris",
        file=sys.stderr,
    )
    return Mesh(mesh.vertices[sel], mesh.normals[sel])


def get_mesh(name: str, fallback_tris: int = 20000) -> "rpt.Mesh":
    """Load ``data/<name>`` (.obj/.stl) or synthesize a stand-in blob."""
    for ext, loader in ((".obj", "load_obj"), (".stl", "load_stl")):
        path = os.path.join(DATA, name + ext)
        if os.path.exists(path):
            from rpt_tpu import io

            return _preview_decimate(getattr(io, loader)(path))
    print(f"note: data/{name}.obj not found; using procedural stand-in", file=sys.stderr)
    n = max(8, int((fallback_tris / 2) ** 0.5))
    seed = abs(hash(name)) % (2**31)
    blob = displaced_blob(n, n + 1, amplitude=0.3, seed=seed)
    # normalize to typical OBJ-model dimensions: the raw blob is a
    # radius ~1.3 ball around the ORIGIN, which after an example's own
    # transform (e.g. dragon.py's scale 3.4) swallows its camera and
    # floor. Shrink to max half-extent 0.35 with the base at y=-0.294 so
    # the dragon example's x3.4 rests the stand-in on its y=-1 plane.
    blob = _preview_decimate(blob)
    v = blob.vertices.reshape(-1, 3)
    half = float(np.abs(v).max())
    s = 0.35 / max(half, 1e-9)
    ty = -0.294 - float(v[:, 1].min()) * s
    return blob.scale((s, s, s)).translate((0.0, ty, 0.0))


def get_hdri(name: str = "ballroom_2k") -> "rpt.Hdri":
    """Load ``data/<name>.hdr`` or synthesize a sky-gradient HDRI."""
    path = os.path.join(DATA, name + ".hdr")
    if os.path.exists(path):
        from rpt_tpu.io import load_hdr

        return rpt.Hdri(load_hdr(path))
    print(f"note: data/{name}.hdr not found; using procedural sky", file=sys.stderr)
    h, w = 256, 512
    y = np.linspace(0, np.pi, h)[:, None]
    x = np.linspace(0, 2 * np.pi, w)[None, :]
    sky = np.zeros((h, w, 3))
    horizon = np.exp(-(((y - np.pi / 2) / 0.3) ** 2))
    sky[..., 0] = 0.35 + 0.6 * horizon + 0.05 * np.cos(x)
    sky[..., 1] = 0.45 + 0.5 * horizon
    sky[..., 2] = 0.8 - 0.25 * np.cos(y)
    sun = 60.0 * np.exp(-(((y - 0.9) / 0.05) ** 2) - (((x - 2.0) / 0.05) ** 2))
    return rpt.Hdri(sky + sun[..., None] * np.array([1.0, 0.95, 0.9]))


def save(img, path: str):
    from PIL import Image

    Image.fromarray(img).save(path)
    print(f"saved {path}")
