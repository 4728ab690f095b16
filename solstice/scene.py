"""SceneBuilder: the stateful scene-construction convenience API.

Analog of the reference engine's scene-building surface
(solr/engines/GPUKernel.h: addPrimitive/setPrimitive with per-type
parameter packing, addMaterial/setMaterial, addTexture, the emissive-
material lamp list m_lamps, and compactBoxes() to build acceleration
structures).  The builder accumulates host-side python/numpy state and
``build()`` freezes it into the immutable `Scene` pytree (padded SoA
arrays + per-pool BVHs) that the pure render functions consume.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from solstice.constants import BVH_LEAF_SIZE, PAD_ALIGN
from solstice.types import (
    BVH,
    Cylinders,
    Ellipsoids,
    Lights,
    Materials,
    Planes,
    PlaneAxis,
    ProceduralKind,
    Scene,
    SceneInfo,
    Spheres,
    Textures,
    Triangles,
)

__all__ = ["SceneBuilder"]


def _pad_to(n: int, align: int = PAD_ALIGN) -> int:
    if n == 0:
        return 0
    return ((n + align - 1) // align) * align


def _pad_rows(arr: np.ndarray, n_pad: int, fill) -> np.ndarray:
    if n_pad == arr.shape[0]:
        return arr
    pad_shape = (n_pad - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)], axis=0)


class SceneBuilder:
    """Accumulates primitives/materials/textures and freezes a Scene.

    Mirrors the reference's engine API (GPUKernel::addPrimitive /
    setPrimitive / addMaterial / addTexture / compactBoxes) as python
    methods returning integer ids.
    """

    def __init__(self, dtype=np.float32):
        self.dtype = dtype
        # materials
        self._mat = []  # list of dicts
        # pools
        self._spheres = []
        self._triangles = []  # list of bulk blocks (see add_triangles_raw)
        self._n_triangles = 0
        self._cylinders = []
        self._ellipsoids = []
        self._planes = []
        # textures
        self._tex_data = []  # list of (H, W, 4) uint8
        self.info = SceneInfo.create()
        # default material 0 (reference: DEFAULT_MATERIAL convention)
        self.add_material(color=(0.8, 0.8, 0.8, 1.0))

    # ------------------------------------------------------------------
    # Materials (reference: GPUKernel::addMaterial/setMaterial ~15 params)
    # ------------------------------------------------------------------

    def add_material(
        self,
        color=(0.8, 0.8, 0.8, 1.0),
        specular: float = 0.0,
        specular_power: float = 50.0,
        reflection: float = 0.0,
        ior: float = 1.0,
        transparency: float = 0.0,
        emission: float = 0.0,
        texture_diffuse: int = -1,
        texture_normal: int = -1,
        texture_bump: int = -1,
        texture_specular: int = -1,
        texture_reflection: int = -1,
        texture_transparency: int = -1,
        procedural: ProceduralKind = ProceduralKind.NONE,
        procedural_scale: float = 8.0,
    ) -> int:
        self._mat.append(
            dict(
                color=np.asarray(color, self.dtype),
                specular=np.asarray([specular, specular_power], self.dtype),
                reflection=float(reflection),
                ior=float(ior),
                transparency=float(transparency),
                emission=float(emission),
                texture_diffuse=int(texture_diffuse),
                texture_normal=int(texture_normal),
                texture_bump=int(texture_bump),
                texture_specular=int(texture_specular),
                texture_reflection=int(texture_reflection),
                texture_transparency=int(texture_transparency),
                procedural=int(procedural),
                procedural_scale=float(procedural_scale),
            )
        )
        return len(self._mat) - 1

    # ------------------------------------------------------------------
    # Primitives (reference: addPrimitive(ptSphere/ptCylinder/...) +
    # setPrimitive parameter packing)
    # ------------------------------------------------------------------

    def add_sphere(self, center, radius: float, material: int = 0) -> int:
        self._spheres.append((np.asarray(center, self.dtype), float(radius),
                              int(material)))
        return len(self._spheres) - 1

    def add_triangle(
        self,
        v0,
        v1,
        v2,
        material: int = 0,
        normals: Optional[Tuple] = None,
        uvs: Optional[Tuple] = None,
    ) -> int:
        v = [np.asarray(x, self.dtype)[None] for x in (v0, v1, v2)]
        n = None
        if normals is not None:
            n = np.stack(
                [np.asarray(x, self.dtype) for x in normals]
            )[None]  # (1, 3, 3)
        u = None
        if uvs is not None:
            u = np.stack(
                [np.asarray(x, self.dtype) for x in uvs]
            )[None]  # (1, 3, 2)
        return self.add_triangles_raw(
            v[0], v[1], v[2], material=material, normals=n, uvs=u
        )

    def add_triangles_raw(
        self,
        v0: np.ndarray,
        v1: np.ndarray,
        v2: np.ndarray,
        material=0,
        normals: Optional[np.ndarray] = None,  # (K, 3, 3) per-vertex
        uvs: Optional[np.ndarray] = None,  # (K, 3, 2) per-vertex
    ) -> int:
        """Bulk triangle-soup append: (K, 3) vertex arrays, scalar or
        (K,) material ids.  The fast path for meshes and benchmarks —
        blocks are stored as arrays and concatenated once at build()."""
        v0 = np.atleast_2d(np.asarray(v0, self.dtype))
        v1 = np.atleast_2d(np.asarray(v1, self.dtype))
        v2 = np.atleast_2d(np.asarray(v2, self.dtype))
        k = v0.shape[0]
        if normals is None:
            gn = np.cross(v1 - v0, v2 - v0)
            gn = gn / np.maximum(
                np.linalg.norm(gn, axis=-1, keepdims=True), 1e-12
            )
            n0 = n1 = n2 = gn.astype(self.dtype)
        else:
            normals = np.asarray(normals, self.dtype)
            n0, n1, n2 = normals[:, 0], normals[:, 1], normals[:, 2]
        if uvs is None:
            z = np.zeros((k, 2), self.dtype)
            u0, u1, u2 = z, z, z
        else:
            uvs = np.asarray(uvs, self.dtype)
            u0, u1, u2 = uvs[:, 0], uvs[:, 1], uvs[:, 2]
        mat = np.broadcast_to(
            np.asarray(material, np.int32), (k,)
        ).astype(np.int32)
        first = self._n_triangles
        self._triangles.append(
            (v0, v1, v2, n0, n1, n2, u0, u1, u2, mat)
        )
        self._n_triangles += k
        return first

    def add_mesh(
        self,
        vertices: np.ndarray,
        faces: np.ndarray,
        material: int = 0,
        normals: Optional[np.ndarray] = None,
        uvs: Optional[np.ndarray] = None,
    ) -> int:
        """Indexed-mesh import (reference: OBJReader's pass-2 face
        emission into addPrimitive(ptTriangle))."""
        vertices = np.asarray(vertices, self.dtype)
        faces = np.asarray(faces, np.int64)
        v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
        n = None
        if normals is not None:
            normals = np.asarray(normals, self.dtype)
            n = np.stack(
                [normals[faces[:, i]] for i in range(3)], axis=1
            )
        u = None
        if uvs is not None:
            uvs = np.asarray(uvs, self.dtype)
            u = np.stack([uvs[faces[:, i]] for i in range(3)], axis=1)
        return self.add_triangles_raw(
            v0, v1, v2, material=material, normals=n, uvs=u
        )

    def add_cylinder(self, p0, p1, radius: float, material: int = 0) -> int:
        self._cylinders.append(
            (np.asarray(p0, self.dtype), np.asarray(p1, self.dtype),
             float(radius), int(material))
        )
        return len(self._cylinders) - 1

    def add_ellipsoid(self, center, radii, material: int = 0) -> int:
        self._ellipsoids.append(
            (np.asarray(center, self.dtype), np.asarray(radii, self.dtype),
             int(material))
        )
        return len(self._ellipsoids) - 1

    def add_plane(
        self, axis: PlaneAxis, origin, half_extents, material: int = 0
    ) -> int:
        """Axis-aligned rectangle (reference: ptXYPlane/ptYZPlane/
        ptXZPlane; checkerboard via a CHECKER procedural material)."""
        self._planes.append(
            (int(axis), np.asarray(origin, self.dtype),
             np.asarray(half_extents, self.dtype), int(material))
        )
        return len(self._planes) - 1

    def add_light(self, position, color=(1.0, 1.0, 1.0, 1.0),
                  intensity: float = 1.0, radius: float = 0.1) -> int:
        """Emissive-sphere light (reference: lights are primitives whose
        material has innerIllumination > 0, collected into m_lamps)."""
        mat = self.add_material(color=color, emission=float(intensity))
        return self.add_sphere(position, radius, mat)

    # ------------------------------------------------------------------
    # Textures (reference: GPUKernel::addTexture + ImageLoader)
    # ------------------------------------------------------------------

    def add_texture(self, image: np.ndarray) -> int:
        """image: (H, W, 3|4) uint8 or float in [0,1]."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1
            )
        self._tex_data.append(img)
        return len(self._tex_data) - 1

    # ------------------------------------------------------------------
    # Freeze (reference: compactBoxes + streamDataToGPU rolled into one
    # functional snapshot)
    # ------------------------------------------------------------------

    def build(
        self,
        use_bvh: bool = True,
        bvh_threshold: int = 64,
        leaf_size: int = BVH_LEAF_SIZE,
    ) -> Scene:
        from solstice.ops.bvh import build_bvh, pool_aabbs
        from solstice.ops.traverse import (
            POOL_CYLINDER,
            POOL_SPHERE,
            POOL_TRIANGLE,
        )

        dt = self.dtype

        # Materials
        mats = Materials(
            color=jnp.asarray(np.stack([m["color"] for m in self._mat])),
            specular=jnp.asarray(np.stack([m["specular"] for m in self._mat])),
            reflection=jnp.asarray([m["reflection"] for m in self._mat], dt),
            ior=jnp.asarray([m["ior"] for m in self._mat], dt),
            transparency=jnp.asarray(
                [m["transparency"] for m in self._mat], dt
            ),
            emission=jnp.asarray([m["emission"] for m in self._mat], dt),
            texture_diffuse=jnp.asarray(
                [m["texture_diffuse"] for m in self._mat], jnp.int32
            ),
            texture_normal=jnp.asarray(
                [m["texture_normal"] for m in self._mat], jnp.int32
            ),
            texture_bump=jnp.asarray(
                [m["texture_bump"] for m in self._mat], jnp.int32
            ),
            texture_specular=jnp.asarray(
                [m["texture_specular"] for m in self._mat], jnp.int32
            ),
            texture_reflection=jnp.asarray(
                [m["texture_reflection"] for m in self._mat], jnp.int32
            ),
            texture_transparency=jnp.asarray(
                [m["texture_transparency"] for m in self._mat], jnp.int32
            ),
            procedural=jnp.asarray(
                [m["procedural"] for m in self._mat], jnp.int32
            ),
            procedural_scale=jnp.asarray(
                [m["procedural_scale"] for m in self._mat], dt
            ),
        )

        # ---- Pools as numpy SoA ----
        def np_stack(items, idx, shape, fill=0.0):
            if not items:
                return np.zeros((0,) + shape, dt)
            return np.stack([np.asarray(it[idx], dt) for it in items])

        sph_c = np_stack(self._spheres, 0, (3,))
        sph_r = np.asarray([s[1] for s in self._spheres], dt)
        sph_m = np.asarray([s[2] for s in self._spheres], np.int32)

        def tri_cat(i, shape):
            if not self._triangles:
                return np.zeros((0,) + shape, dt)
            return np.concatenate([blk[i] for blk in self._triangles])

        tri_arrs = [tri_cat(i, (3,)) for i in range(6)]
        tri_uvs = [tri_cat(i, (2,)) for i in range(6, 9)]
        tri_m = (
            np.concatenate([blk[9] for blk in self._triangles])
            if self._triangles else np.zeros((0,), np.int32)
        )

        cyl_p0 = np_stack(self._cylinders, 0, (3,))
        cyl_p1 = np_stack(self._cylinders, 1, (3,))
        cyl_r = np.asarray([c[2] for c in self._cylinders], dt)
        cyl_m = np.asarray([c[3] for c in self._cylinders], np.int32)

        ell_c = np_stack(self._ellipsoids, 0, (3,))
        ell_r = np_stack(self._ellipsoids, 1, (3,))
        ell_m = np.asarray([e[2] for e in self._ellipsoids], np.int32)

        pla_a = np.asarray([p[0] for p in self._planes], np.int32)
        pla_o = np_stack(self._planes, 1, (3,))
        pla_h = np_stack(self._planes, 2, (2,))
        pla_m = np.asarray([p[3] for p in self._planes], np.int32)

        # ---- Lights from emissive materials (reference: m_lamps) ----
        emis = np.asarray([m["emission"] for m in self._mat], dt)
        colors = np.stack([m["color"] for m in self._mat]) if self._mat else \
            np.zeros((0, 4), dt)
        lp, lc, lr = [], [], []
        for c, r, m in zip(sph_c, sph_r, sph_m):
            if emis[m] > 0:
                lp.append(c)
                lc.append(colors[m] * emis[m])
                lr.append(r)
        for c, r3, m in zip(ell_c, ell_r, ell_m):
            if emis[m] > 0:
                lp.append(c)
                lc.append(colors[m] * emis[m])
                lr.append(float(np.mean(r3)))
        lights = Lights(
            position=jnp.asarray(
                np.stack(lp) if lp else np.zeros((0, 3), dt)
            ),
            color=jnp.asarray(np.stack(lc) if lc else np.zeros((0, 4), dt)),
            radius=jnp.asarray(np.asarray(lr, dt)),
        )

        # ---- Textures ----
        if self._tex_data:
            offsets, widths, heights, chunks = [], [], [], []
            off = 0
            for img in self._tex_data:
                h, w = img.shape[:2]
                offsets.append(off)
                widths.append(w)
                heights.append(h)
                chunks.append(img.reshape(-1, 4))
                off += h * w
            textures = Textures(
                atlas=jnp.asarray(np.concatenate(chunks, axis=0)),
                offset=jnp.asarray(offsets, jnp.int32),
                width=jnp.asarray(widths, jnp.int32),
                height=jnp.asarray(heights, jnp.int32),
            )
        else:
            textures = Textures(
                atlas=jnp.zeros((0, 4), jnp.uint8),
                offset=jnp.zeros((0,), jnp.int32),
                width=jnp.zeros((0,), jnp.int32),
                height=jnp.zeros((0,), jnp.int32),
            )

        # ---- BVH per large pool (reference: compactBoxes) ----
        tmp_scene_arrays = {}

        def maybe_bvh(pool_code, n, mins_maxs_fn, reorder_fn):
            if not use_bvh or n < bvh_threshold:
                return None
            amin, amax = mins_maxs_fn()
            bvh, order = build_bvh(amin, amax, leaf_size)
            reorder_fn(order)
            return bvh

        tri_bvh = None
        if use_bvh and self._n_triangles >= bvh_threshold:
            v0, v1, v2 = tri_arrs[0], tri_arrs[1], tri_arrs[2]
            amin = np.minimum(np.minimum(v0, v1), v2)
            amax = np.maximum(np.maximum(v0, v1), v2)
            tri_bvh, order = build_bvh(amin, amax, leaf_size)
            tri_arrs = [a[order] for a in tri_arrs]
            tri_uvs = [a[order] for a in tri_uvs]
            tri_m = tri_m[order]

        sph_bvh = None
        if use_bvh and len(self._spheres) >= bvh_threshold:
            amin = sph_c - sph_r[:, None]
            amax = sph_c + sph_r[:, None]
            sph_bvh, order = build_bvh(amin, amax, leaf_size)
            sph_c, sph_r, sph_m = sph_c[order], sph_r[order], sph_m[order]

        cyl_bvh = None
        if use_bvh and len(self._cylinders) >= bvh_threshold:
            amin = np.minimum(cyl_p0, cyl_p1) - cyl_r[:, None]
            amax = np.maximum(cyl_p0, cyl_p1) + cyl_r[:, None]
            cyl_bvh, order = build_bvh(amin, amax, leaf_size)
            cyl_p0, cyl_p1 = cyl_p0[order], cyl_p1[order]
            cyl_r, cyl_m = cyl_r[order], cyl_m[order]

        # ---- Pad pools with inert entries ----
        ns = _pad_to(len(self._spheres))
        nt = _pad_to(self._n_triangles)
        nc = _pad_to(len(self._cylinders))
        ne = _pad_to(len(self._ellipsoids))
        npl = _pad_to(len(self._planes))

        spheres = Spheres(
            center=jnp.asarray(_pad_rows(sph_c, ns, 0.0)),
            radius=jnp.asarray(_pad_rows(sph_r, ns, -1.0)),
            material=jnp.asarray(_pad_rows(sph_m, ns, 0)),
        )
        triangles = Triangles(
            v0=jnp.asarray(_pad_rows(tri_arrs[0], nt, 0.0)),
            v1=jnp.asarray(_pad_rows(tri_arrs[1], nt, 0.0)),
            v2=jnp.asarray(_pad_rows(tri_arrs[2], nt, 0.0)),
            n0=jnp.asarray(_pad_rows(tri_arrs[3], nt, 0.0)),
            n1=jnp.asarray(_pad_rows(tri_arrs[4], nt, 0.0)),
            n2=jnp.asarray(_pad_rows(tri_arrs[5], nt, 0.0)),
            uv0=jnp.asarray(_pad_rows(tri_uvs[0], nt, 0.0)),
            uv1=jnp.asarray(_pad_rows(tri_uvs[1], nt, 0.0)),
            uv2=jnp.asarray(_pad_rows(tri_uvs[2], nt, 0.0)),
            material=jnp.asarray(_pad_rows(tri_m, nt, 0)),
        )
        cylinders = Cylinders(
            p0=jnp.asarray(_pad_rows(cyl_p0, nc, 0.0)),
            p1=jnp.asarray(_pad_rows(cyl_p1, nc, 0.0)),
            radius=jnp.asarray(_pad_rows(cyl_r, nc, -1.0)),
            material=jnp.asarray(_pad_rows(cyl_m, nc, 0)),
        )
        ellipsoids = Ellipsoids(
            center=jnp.asarray(_pad_rows(ell_c, ne, 0.0)),
            radii=jnp.asarray(_pad_rows(ell_r, ne, -1.0)),
            material=jnp.asarray(_pad_rows(ell_m, ne, 0)),
        )
        planes = Planes(
            axis=jnp.asarray(_pad_rows(pla_a, npl, 0)),
            origin=jnp.asarray(_pad_rows(pla_o, npl, 0.0)),
            half_extents=jnp.asarray(_pad_rows(pla_h, npl, -1.0)),
            material=jnp.asarray(_pad_rows(pla_m, npl, 0)),
        )

        scene = Scene(
            spheres=spheres,
            triangles=triangles,
            cylinders=cylinders,
            ellipsoids=ellipsoids,
            planes=planes,
            materials=mats,
            lights=lights,
            textures=textures,
            info=self.info,
            tri_bvh=tri_bvh,
            sph_bvh=sph_bvh,
            cyl_bvh=cyl_bvh,
        )
        if tri_bvh is not None:
            # Precompute the packet-traversal accelerator once (reference:
            # compactBoxes at scene-build time, not per frame).
            from solstice.ops.packet import build_tri_accel

            scene = scene.replace(
                tri_accel=jax.jit(build_tri_accel)(
                    scene.triangles, scene.materials
                )
            )
        if sph_bvh is not None:
            # Sphere-pool sweep accel (PDB molecule scenes).
            from solstice.ops.packet import build_sph_accel

            scene = scene.replace(
                sph_accel=jax.jit(build_sph_accel)(
                    scene.spheres, scene.materials
                )
            )
        if cyl_bvh is not None:
            # Cylinder-pool sweep accel (PDB sticks / SWC neurites).
            from solstice.ops.packet import build_cyl_accel

            scene = scene.replace(
                cyl_accel=jax.jit(build_cyl_accel)(
                    scene.cylinders, scene.materials
                )
            )
        return scene
