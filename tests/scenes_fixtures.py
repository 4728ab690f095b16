"""Shared test scenes (the BASELINE.json config matrix).

Config #1: Cornell box with 8 analytic spheres, 1 point light, 256x256,
2 bounces — built here at parameterizable resolution.
"""

from __future__ import annotations

import numpy as np

import solstice as st
from solstice.types import PlaneAxis, ProceduralKind


def cornell_box(
    n_spheres: int = 8,
    reflective: bool = True,
    transparent: bool = True,
    checker: bool = False,
    seed: int = 7,
    dtype=np.float32,
):
    """Cornell box: 5 walls (planes), spheres, 1 emissive light sphere."""
    rng = np.random.default_rng(seed)
    b = st.SceneBuilder(dtype=dtype)
    white = b.add_material(color=(0.75, 0.75, 0.75, 1.0))
    red = b.add_material(color=(0.75, 0.15, 0.15, 1.0))
    green = b.add_material(color=(0.15, 0.75, 0.15, 1.0))
    floor_mat = white
    if checker:
        floor_mat = b.add_material(
            color=(0.8, 0.8, 0.8, 1.0),
            procedural=ProceduralKind.CHECKER,
            procedural_scale=8.0,
        )
    # Box [-1,1]^2 x [0,2] in z (camera looks +z).
    b.add_plane(PlaneAxis.XZ, (0, -1, 1), (1, 1), floor_mat)  # floor
    b.add_plane(PlaneAxis.XZ, (0, 1, 1), (1, 1), white)  # ceiling
    b.add_plane(PlaneAxis.YZ, (-1, 0, 1), (1, 1), red)  # left
    b.add_plane(PlaneAxis.YZ, (1, 0, 1), (1, 1), green)  # right
    b.add_plane(PlaneAxis.XY, (0, 0, 2), (1, 1), white)  # back

    for i in range(n_spheres):
        kind = i % 3
        if kind == 0 or not (reflective or transparent):
            m = b.add_material(
                color=tuple(rng.uniform(0.2, 0.9, 3)) + (1.0,),
                specular=0.4,
                specular_power=30.0,
            )
        elif kind == 1 and reflective:
            m = b.add_material(
                color=(0.9, 0.9, 0.9, 1.0), reflection=0.6, specular=0.8
            )
        else:
            m = b.add_material(
                color=(0.9, 0.95, 1.0, 1.0),
                transparency=0.8,
                ior=1.5,
            )
        c = rng.uniform(-0.6, 0.6, 3) * np.array([1.0, 1.0, 0.5]) + np.array(
            [0.0, -0.4, 1.2]
        )
        b.add_sphere(tuple(c), float(rng.uniform(0.12, 0.3)), m)

    b.add_light((0.0, 0.85, 1.0), color=(1.0, 1.0, 0.95, 1.0),
                intensity=1.0, radius=0.1)
    return b


def cornell_camera():
    return st.Camera.create(position=(0.0, 0.0, -1.6), fov=1.1)


def tri_quad_scene():
    """Two triangles forming a quad + a light; minimal mesh test."""
    b = st.SceneBuilder()
    m = b.add_material(color=(0.3, 0.5, 0.9, 1.0), specular=0.3)
    verts = np.array(
        [[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]], np.float32
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]])
    b.add_mesh(verts, faces, m)
    b.add_light((2, 2, -1), intensity=1.0)
    return b


def random_sphere_field(n: int, seed: int = 3, extent: float = 10.0):
    """Many-sphere scene for BVH tests."""
    rng = np.random.default_rng(seed)
    b = st.SceneBuilder()
    for i in range(n):
        m = b.add_material(color=tuple(rng.uniform(0.2, 1.0, 3)) + (1.0,))
        c = rng.uniform(-extent, extent, 3) + np.array([0, 0, extent * 1.5])
        b.add_sphere(tuple(c), float(rng.uniform(0.2, 0.6)), m)
    b.add_light((0, extent, 0), intensity=1.0)
    return b


def random_tri_field(n: int, seed: int = 5, extent: float = 10.0):
    """Random triangle soup for BVH tests."""
    rng = np.random.default_rng(seed)
    b = st.SceneBuilder()
    m = b.add_material(color=(0.7, 0.6, 0.5, 1.0))
    centers = rng.uniform(-extent, extent, (n, 3)) + np.array(
        [0, 0, extent * 1.5]
    )
    for i in range(n):
        c = centers[i]
        d1 = rng.normal(0, 0.5, 3)
        d2 = rng.normal(0, 0.5, 3)
        b.add_triangle(c, c + d1, c + d2, m)
    b.add_light((0, extent, 0), intensity=1.0)
    return b


def random_cylinder_field(n: int, seed: int = 7, extent: float = 10.0):
    """Many-cylinder scene (PDB-sticks-shaped) for sweep/BVH tests."""
    rng = np.random.default_rng(seed)
    b = st.SceneBuilder()
    for i in range(n):
        m = b.add_material(color=tuple(rng.uniform(0.2, 1.0, 3)) + (1.0,))
        p0 = rng.uniform(-extent, extent, 3) + np.array([0, 0, extent * 1.5])
        p1 = p0 + rng.normal(0, 1.0, 3)
        b.add_cylinder(tuple(p0), tuple(p1), float(rng.uniform(0.1, 0.3)), m)
    b.add_light((0, extent, 0), intensity=1.0)
    return b
