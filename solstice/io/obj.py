"""Wavefront OBJ + MTL import.

Re-creation of the reference's OBJ pipeline
(solr/io/OBJReader.cpp: importModelFromFile — two-pass v/vn/vt then
faces, quad -> two triangles, per-face material from the MTL library
with map_Kd texture loading, optional scaling/centering, computed face
normals when vn is absent).  Emits bulk triangle blocks into a
SceneBuilder instead of per-primitive addPrimitive calls.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

__all__ = ["load_obj", "parse_mtl"]


def parse_mtl(path: str, builder, texture_dir: Optional[str] = None):
    """Parse an MTL library into builder materials.

    Returns {material_name: material_id}.  Supported fields (reference:
    OBJReader's MTL handling): Kd (diffuse), Ks + Ns (specular), d /
    Tr (opacity -> transparency), Ni (IoR), illum >= 3 (reflective),
    map_Kd (diffuse texture via ImageLoader analog).
    """
    from solstice.io.image import load_image

    mats: Dict[str, int] = {}
    if not os.path.exists(path):
        return mats
    name = None
    props: Dict[str, object] = {}

    def flush():
        if name is None:
            return
        kd = props.get("kd", (0.8, 0.8, 0.8))
        ks = props.get("ks", (0.0, 0.0, 0.0))
        spec = float(np.max(ks))
        opacity = float(props.get("d", 1.0))
        illum = int(props.get("illum", 2))

        def load_map(key):
            if key in props and texture_dir is not None:
                tex_path = os.path.join(texture_dir, str(props[key]))
                if os.path.exists(tex_path):
                    return builder.add_texture(load_image(tex_path))
            return -1

        mats[name] = builder.add_material(
            color=(kd[0], kd[1], kd[2], 1.0),
            specular=spec,
            specular_power=float(props.get("ns", 50.0)),
            reflection=0.4 if illum >= 3 else 0.0,
            ior=float(props.get("ni", 1.0)),
            transparency=1.0 - opacity,
            texture_diffuse=load_map("map_kd"),
            texture_normal=load_map("norm"),
            texture_bump=load_map("map_bump"),
            texture_specular=load_map("map_ks"),
            texture_reflection=load_map("map_refl"),
            texture_transparency=load_map("map_d"),
        )

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].lower()
            if key == "newmtl":
                flush()
                name = parts[1]
                props = {}
            elif key in ("kd", "ks"):
                props[key] = tuple(float(x) for x in parts[1:4])
            elif key in ("ns", "ni", "d"):
                props[key] = float(parts[1])
            elif key == "tr":
                props["d"] = 1.0 - float(parts[1])
            elif key == "illum":
                props["illum"] = int(parts[1])
            elif key in ("map_kd", "map_ks", "map_d", "map_refl",
                         "map_bump", "norm"):
                props[key] = parts[-1]
            elif key == "bump":  # synonym used by many exporters
                props["map_bump"] = parts[-1]
            elif key == "refl":
                props["map_refl"] = parts[-1]
    flush()
    return mats


def load_obj(
    path: str,
    builder,
    material: Optional[int] = None,
    scale: Optional[float] = None,
    center: bool = True,
    load_materials: bool = True,
):
    """Import an OBJ file into ``builder``; returns the first triangle id.

    ``material`` overrides MTL materials when given (reference:
    OBJReader's default-material path).  ``scale``: when given, the
    model is normalized so its largest |coordinate| equals ``scale``
    (reference: OBJReader's scaling-to-scene-units).

    Geometry parsing goes through the native C++ parser when available
    (solstice.native.obj_load — the reference's OBJReader is C++, and
    the Python line loop costs ~9 s at 1M faces, the native one ~1.5 s); the
    Python loop below is the always-available fallback, and
    tests/test_native.py pins the two parsers equal.
    """
    if not os.environ.get("SOLR_NO_NATIVE_OBJ"):
        from solstice import native as native_mod

        parsed = native_mod.obj_load(path)
        if parsed is not None:
            return _emit_parsed(
                parsed, path, builder, material, scale, center,
                load_materials,
            )
    verts, norms, uvs = [], [], []
    # Faces grouped per material for bulk emission.
    groups: Dict[int, list] = {}
    mtl_map: Dict[str, int] = {}
    cur_mat = material if material is not None else 0
    obj_dir = os.path.dirname(os.path.abspath(path))

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif key == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif key == "mtllib" and load_materials and material is None:
                mtl_map.update(
                    parse_mtl(
                        os.path.join(obj_dir, parts[1]), builder, obj_dir
                    )
                )
            elif key == "usemtl" and material is None:
                cur_mat = mtl_map.get(parts[1], 0)
            elif key == "f":
                refs = []
                for p in parts[1:]:
                    comps = p.split("/")
                    vi = int(comps[0])
                    ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                    ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                    refs.append((vi, ti, ni))
                # Fan-triangulate polygons (quad -> 2 tris; reference
                # handles tri + quad, we generalize).
                for a in range(1, len(refs) - 1):
                    groups.setdefault(cur_mat, []).append(
                        (refs[0], refs[a], refs[a + 1])
                    )

    if not verts:
        return None
    v = np.asarray(verts, np.float32)
    if center:
        lo, hi = v.min(axis=0), v.max(axis=0)
        v = v - 0.5 * (lo + hi)
    if scale is not None:
        extent = float(np.abs(v).max())
        if extent > 0:
            v = v * (scale / extent)
    n = np.asarray(norms, np.float32) if norms else None
    t = np.asarray(uvs, np.float32) if uvs else None

    def resolve(idx, arr, count):
        return (idx - 1) if idx > 0 else (count + idx)

    first = None
    for mat_id, faces in groups.items():
        fv = np.asarray(
            [[resolve(r[0], v, len(v)) for r in f3] for f3 in faces],
            np.int64,
        )
        v0, v1, v2 = v[fv[:, 0]], v[fv[:, 1]], v[fv[:, 2]]
        normals = None
        if n is not None and all(
            all(r[2] != 0 for r in f3) for f3 in faces[:1]
        ):
            fn = np.asarray(
                [[resolve(r[2], n, len(n)) for r in f3] for f3 in faces],
                np.int64,
            )
            fn = np.clip(fn, 0, len(n) - 1)
            normals = np.stack([n[fn[:, i]] for i in range(3)], axis=1)
        uv3 = None
        if t is not None and all(
            all(r[1] != 0 for r in f3) for f3 in faces[:1]
        ):
            ft = np.asarray(
                [[resolve(r[1], t, len(t)) for r in f3] for f3 in faces],
                np.int64,
            )
            ft = np.clip(ft, 0, len(t) - 1)
            uv3 = np.stack([t[ft[:, i]] for i in range(3)], axis=1)
        tid = builder.add_triangles_raw(
            v0, v1, v2, material=mat_id, normals=normals, uvs=uv3
        )
        first = tid if first is None else first
    return first


def _emit_parsed(parsed, path, builder, material, scale, center,
                 load_materials):
    """Emit native-parsed OBJ geometry into the builder (vectorized —
    no per-face Python).  Mirrors the Python path's semantics exactly:
    centering/scaling, per-material face groups, normals/uvs used only
    when the group's first face carries them."""
    obj_dir = os.path.dirname(os.path.abspath(path))
    v = parsed["v"]
    if v.shape[0] == 0:
        return None
    if center:
        lo, hi = v.min(axis=0), v.max(axis=0)
        v = v - 0.5 * (lo + hi)
    if scale is not None:
        extent = float(np.abs(v).max())
        if extent > 0:
            v = v * (scale / extent)

    # Slot -> builder material id.
    mtl_map = {}
    if load_materials and material is None:
        for lib_name in parsed["mtllibs"]:
            mtl_map.update(
                parse_mtl(os.path.join(obj_dir, lib_name), builder,
                          obj_dir)
            )
    if material is not None:
        slot_mat = {s: material for s in range(-1, len(parsed["usemtls"]))}
    else:
        slot_mat = {-1: 0}
        for s, name in enumerate(parsed["usemtls"]):
            slot_mat[s] = mtl_map.get(name, 0)

    f_v, f_vt, f_vn = parsed["f_v"], parsed["f_vt"], parsed["f_vn"]
    f_slot = parsed["f_slot"]
    vn, vt = parsed["vn"], parsed["vt"]
    first = None
    for slot in sorted(set(int(s) for s in np.unique(f_slot))):
        sel = f_slot == slot
        fv = f_v[sel]
        v0, v1, v2 = v[fv[:, 0]], v[fv[:, 1]], v[fv[:, 2]]
        normals = None
        fn = f_vn[sel]
        if len(vn) and len(fn) and (fn[0] >= 0).all():
            fn = np.clip(fn, 0, len(vn) - 1)
            normals = np.stack([vn[fn[:, i]] for i in range(3)], axis=1)
        uv3 = None
        ft = f_vt[sel]
        if len(vt) and len(ft) and (ft[0] >= 0).all():
            ft = np.clip(ft, 0, len(vt) - 1)
            uv3 = np.stack([vt[ft[:, i]] for i in range(3)], axis=1)
        tid = builder.add_triangles_raw(
            v0, v1, v2, material=slot_mat.get(slot, 0),
            normals=normals, uvs=uv3,
        )
        first = tid if first is None else first
    return first
