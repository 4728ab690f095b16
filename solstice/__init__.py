"""solstice — a differentiable ray tracer with Sol-R's capabilities.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
cyrillefavreau/Sol-R (C++/CUDA/OpenCL interactive ray tracer):
primary + secondary (reflection/refraction/shadow) rays against analytic
primitives (spheres, cylinders, ellipsoids, axis-aligned planes /
checkerboards) and triangle meshes, BVH acceleration with stackless
skip-pointer traversal, Phong/textured/procedural materials, soft shadows,
progressive accumulation, post-processing (depth of field, ambient
occlusion), mono/anaglyph/side-by-side/fisheye cameras, OBJ/PDB/SWC/IRT
scene I/O — all expressed as pure-functional JAX programs with Pallas
kernels on the hot path, differentiable end-to-end, and sharded over
`jax.sharding.Mesh` device meshes for multi-chip / multi-host rendering.

This is NOT a port: the reference's mutable GPUKernel engine
(solr/engines/GPUKernel.{h,cpp}) becomes a functional core — the scene is
an immutable pytree of SoA arrays, and the engine is pure functions
`render(scene, camera, config, key) -> image`, with a thin stateful
`SceneBuilder` convenience layer mirroring the reference's
addPrimitive/addMaterial API (solr/engines/GPUKernel.h).
"""

from solstice.constants import RAY_EPS
from solstice.types import (
    BVH,
    Camera,
    CameraMode,
    Lights,
    Materials,
    Planes,
    PostFxConfig,
    PostFxMode,
    ProceduralKind,
    RenderConfig,
    Scene,
    SceneInfo,
    Spheres,
    Cylinders,
    Ellipsoids,
    Textures,
    Triangles,
)
from solstice.scene import SceneBuilder
from solstice.ops.render import render, render_sample
from solstice.engine import Engine

__version__ = "0.1.0"

__all__ = [
    "BVH",
    "Camera",
    "CameraMode",
    "Engine",
    "Lights",
    "Materials",
    "Planes",
    "PostFxConfig",
    "PostFxMode",
    "ProceduralKind",
    "RAY_EPS",
    "RenderConfig",
    "Scene",
    "SceneBuilder",
    "SceneInfo",
    "Spheres",
    "Cylinders",
    "Ellipsoids",
    "Textures",
    "Triangles",
    "render",
    "render_sample",
]
