"""Scene serialization — the checkpoint system.

Re-creation of the reference's IRT marshaller
(solr/io/FileMarshaller.cpp: saveToFile/loadFromFile — a versioned
binary dump of camera + scene info + materials + textures + primitives,
reloadable into a fresh engine).  Here the scene is already a pytree of
arrays, so the format is a versioned NPZ: every leaf array plus a JSON
header carrying the treedef/static fields.  BVHs are REBUILT on load
(they are derived state, exactly like the reference re-running
compactBoxes after loadFromFile).
"""

from __future__ import annotations

import io as _io
import json
import zipfile
from typing import Optional, Tuple

import numpy as np

IRT_VERSION = 2  # v2: specular/reflection/transparency texture slots

__all__ = ["save_scene", "load_scene", "IRT_VERSION"]

_POOLS = {
    "spheres": ("center", "radius", "material"),
    "triangles": (
        "v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "material"
    ),
    "cylinders": ("p0", "p1", "radius", "material"),
    "ellipsoids": ("center", "radii", "material"),
    "planes": ("axis", "origin", "half_extents", "material"),
    "materials": (
        "color", "specular", "reflection", "ior", "transparency",
        "emission", "texture_diffuse", "texture_normal", "texture_bump",
        "texture_specular", "texture_reflection", "texture_transparency",
        "procedural", "procedural_scale",
    ),
    "lights": ("position", "color", "radius"),
    "textures": ("atlas", "offset", "width", "height"),
    "info": (
        "background_color", "ambient", "shadow_intensity",
        "view_distance", "fog_start", "soft_shadow_radius",
        "gradient_sky_zenith", "gradient_sky_horizon",
    ),
}
_CAMERA_FIELDS = (
    "position", "angles", "fov", "aperture", "focal_distance",
    "eye_separation",
)


def save_scene(path: str, scene, camera=None) -> None:
    """Serialize scene (+ optional camera) to a versioned .irt.npz."""
    arrays = {}
    for group, fields in _POOLS.items():
        obj = getattr(scene, group)
        for f in fields:
            arrays[f"{group}.{f}"] = np.asarray(getattr(obj, f))
    if camera is not None:
        for f in _CAMERA_FIELDS:
            arrays[f"camera.{f}"] = np.asarray(getattr(camera, f))
    header = {
        "version": IRT_VERSION,
        "has_camera": camera is not None,
        "bvh": {
            "tri": scene.tri_bvh is not None,
            "sph": scene.sph_bvh is not None,
            "cyl": scene.cyl_bvh is not None,
        },
        "leaf_size": (
            scene.tri_bvh.leaf_size if scene.tri_bvh is not None else 8
        ),
    }
    buf = _io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("header.json", json.dumps(header))
        z.writestr("arrays.npz", buf.getvalue())


def load_scene(path: str) -> Tuple[object, Optional[object]]:
    """Load (scene, camera-or-None); rebuilds BVHs (reference analog:
    compactBoxes after loadFromFile)."""
    import jax.numpy as jnp

    from solstice.ops.bvh import build_bvh
    from solstice.types import (
        BVH, Camera, Cylinders, Ellipsoids, Lights, Materials, Planes,
        Scene, SceneInfo, Spheres, Textures, Triangles,
    )

    with zipfile.ZipFile(path) as z:
        header = json.loads(z.read("header.json"))
        if header["version"] > IRT_VERSION:
            raise ValueError(
                f"irt version {header['version']} > supported {IRT_VERSION}"
            )
        data = np.load(_io.BytesIO(z.read("arrays.npz")))

    def group(cls, name):
        kwargs = {}
        for f in _POOLS[name]:
            key = f"{name}.{f}"
            if key in data:
                kwargs[f] = jnp.asarray(data[key])
            elif name == "materials" and f.startswith("texture_"):
                # Version-1 files predate the specular/reflection/
                # transparency slots: default to unset.
                n = data["materials.color"].shape[0]
                kwargs[f] = jnp.full((n,), -1, jnp.int32)
            else:
                raise KeyError(key)
        return cls(**kwargs)

    scene = Scene(
        spheres=group(Spheres, "spheres"),
        triangles=group(Triangles, "triangles"),
        cylinders=group(Cylinders, "cylinders"),
        ellipsoids=group(Ellipsoids, "ellipsoids"),
        planes=group(Planes, "planes"),
        materials=group(Materials, "materials"),
        lights=group(Lights, "lights"),
        textures=group(Textures, "textures"),
        info=group(SceneInfo, "info"),
    )

    leaf_size = int(header.get("leaf_size", 8))

    def rebuild(flag, amin, amax, n_real):
        if not flag or n_real == 0:
            return None, None
        return build_bvh(amin[:n_real], amax[:n_real], leaf_size)

    # Note: pools were saved already reordered+padded; rebuild the BVH
    # over the non-inert prefix (padding is inert by construction).
    tri_bvh = sph_bvh = cyl_bvh = None
    if header["bvh"]["tri"]:
        v0 = np.asarray(scene.triangles.v0)
        v1 = np.asarray(scene.triangles.v1)
        v2 = np.asarray(scene.triangles.v2)
        real = ~np.all((v0 == 0) & (v1 == 0) & (v2 == 0), axis=-1)
        n_real = int(real.sum())
        if n_real:
            amin = np.minimum(np.minimum(v0, v1), v2)
            amax = np.maximum(np.maximum(v0, v1), v2)
            tri_bvh, order = build_bvh(
                amin[:n_real], amax[:n_real], leaf_size
            )
            # Saved order already matches a valid BVH order only if we
            # re-apply the new order to the prefix:
            perm = np.concatenate(
                [order, np.arange(n_real, v0.shape[0])]
            )
            scene = scene.replace(
                triangles=_permute(scene.triangles, perm)
            )
    if header["bvh"]["sph"]:
        c = np.asarray(scene.spheres.center)
        r = np.asarray(scene.spheres.radius)
        real = r > 0
        n_real = int(real.sum())
        if n_real:
            sph_bvh, order = build_bvh(
                (c - r[:, None])[:n_real], (c + r[:, None])[:n_real],
                leaf_size,
            )
            perm = np.concatenate(
                [order, np.arange(n_real, r.shape[0])]
            )
            scene = scene.replace(spheres=_permute(scene.spheres, perm))
    if header["bvh"]["cyl"]:
        p0 = np.asarray(scene.cylinders.p0)
        p1 = np.asarray(scene.cylinders.p1)
        r = np.asarray(scene.cylinders.radius)
        real = r > 0
        n_real = int(real.sum())
        if n_real:
            amin = np.minimum(p0, p1) - r[:, None]
            amax = np.maximum(p0, p1) + r[:, None]
            cyl_bvh, order = build_bvh(
                amin[:n_real], amax[:n_real], leaf_size
            )
            perm = np.concatenate(
                [order, np.arange(n_real, r.shape[0])]
            )
            scene = scene.replace(
                cylinders=_permute(scene.cylinders, perm)
            )
    scene = scene.replace(tri_bvh=tri_bvh, sph_bvh=sph_bvh,
                          cyl_bvh=cyl_bvh)

    camera = None
    if header["has_camera"]:
        camera = Camera(
            **{
                f: jnp.asarray(data[f"camera.{f}"])
                for f in _CAMERA_FIELDS
            }
        )
    return scene, camera


def _permute(pool, perm):
    import jax

    return jax.tree.map(lambda a: a[perm], pool)
