"""Asset I/O: OBJ/MTL, PDB, SWC importers and IRT scene round-trip
(SURVEY.md section 2.3)."""

import os

import jax
import numpy as np
import pytest

import solstice as st
from solstice.io import (
    load_image,
    load_obj,
    load_pdb,
    load_scene,
    load_swc,
    save_scene,
)
from solstice.io.image import save_image
from solstice.ops.render import render_sample

from scenes_fixtures import cornell_box, cornell_camera

OBJ_TEXT = """\
# simple cube-ish quad mesh with material
mtllib test.mtl
v -1 -1 0
v 1 -1 0
v 1 1 0
v -1 1 0
vn 0 0 -1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
"""

MTL_TEXT = """\
newmtl red
Kd 0.9 0.1 0.1
Ks 0.5 0.5 0.5
Ns 30
d 1.0
Ni 1.0
illum 2
"""

PDB_TEXT = """\
ATOM      1  N   ALA A   1      11.104   6.134  -6.504  1.00  0.00           N
ATOM      2  CA  ALA A   1      11.639   6.071  -5.147  1.00  0.00           C
ATOM      3  C   ALA A   1      10.783   6.852  -4.148  1.00  0.00           C
ATOM      4  O   ALA A   1       9.654   7.262  -4.442  1.00  0.00           O
HETATM    5  S   SO4 A   2      12.000   7.000  -5.000  1.00  0.00           S
END
"""

SWC_TEXT = """\
# id type x y z radius parent
1 1 0.0 0.0 0.0 2.0 -1
2 3 5.0 0.0 0.0 1.0 1
3 3 10.0 2.0 0.0 0.8 2
4 2 -4.0 -1.0 0.0 0.9 1
"""


class TestOBJ:
    def test_obj_with_mtl(self, tmp_path):
        (tmp_path / "test.obj").write_text(OBJ_TEXT)
        (tmp_path / "test.mtl").write_text(MTL_TEXT)
        b = st.SceneBuilder()
        first = load_obj(str(tmp_path / "test.obj"), b)
        assert first is not None
        assert b._n_triangles == 2  # quad -> two triangles
        scene = b.build(use_bvh=False)
        # material color came from the MTL
        mat = int(np.asarray(scene.triangles.material)[0])
        color = np.asarray(scene.materials.color)[mat]
        assert np.allclose(color[:3], [0.9, 0.1, 0.1])

    def test_obj_scaling_centering(self, tmp_path):
        (tmp_path / "t.obj").write_text(
            "v 0 0 0\nv 10 0 0\nv 10 10 0\nf 1 2 3\n"
        )
        b = st.SceneBuilder()
        load_obj(str(tmp_path / "t.obj"), b, material=0, scale=1.0)
        scene = b.build(use_bvh=False)
        v = np.concatenate(
            [
                np.asarray(scene.triangles.v0),
                np.asarray(scene.triangles.v1),
                np.asarray(scene.triangles.v2),
            ]
        )
        assert np.abs(v).max() <= 1.0 + 1e-6  # scaled into unit extent

    def test_renders(self, tmp_path):
        (tmp_path / "test.obj").write_text(OBJ_TEXT)
        (tmp_path / "test.mtl").write_text(MTL_TEXT)
        b = st.SceneBuilder()
        load_obj(str(tmp_path / "test.obj"), b)
        b.add_light((2, 2, -3))
        scene = b.build(use_bvh=False)
        cfg = st.RenderConfig(width=16, height=16, max_bounces=1)
        img, _ = render_sample(scene, st.Camera.create(), cfg)
        assert np.isfinite(np.asarray(img)).all()
        assert float(np.asarray(img)[..., 0].max()) > 0.1  # red visible


class TestPDB:
    def test_atoms_and_sticks(self, tmp_path):
        (tmp_path / "m.pdb").write_text(PDB_TEXT)
        b = st.SceneBuilder()
        n = load_pdb(str(tmp_path / "m.pdb"), b)
        assert n == 5
        assert len(b._spheres) == 5
        assert len(b._cylinders) > 0  # CA-C / N-CA bonds within cutoff

    def test_backbone(self, tmp_path):
        from solstice.io.pdb import GeometryMode

        (tmp_path / "m.pdb").write_text(PDB_TEXT)
        b = st.SceneBuilder()
        load_pdb(str(tmp_path / "m.pdb"), b, mode=GeometryMode.BACKBONE)
        assert len(b._spheres) >= 1


class TestSWC:
    def test_morphology(self, tmp_path):
        (tmp_path / "n.swc").write_text(SWC_TEXT)
        b = st.SceneBuilder()
        n = load_swc(str(tmp_path / "n.swc"), b, scale=0.1)
        assert n == 4
        assert len(b._spheres) == 4
        assert len(b._cylinders) == 3  # edges to parents


class TestIRT:
    def test_roundtrip_renders_identically(self, tmp_path):
        b = cornell_box(n_spheres=4)
        scene = b.build()
        cam = cornell_camera()
        path = str(tmp_path / "scene.irt")
        save_scene(path, scene, cam)
        scene2, cam2 = load_scene(path)
        cfg = st.RenderConfig(width=24, height=24, max_bounces=2)
        img1, _ = render_sample(scene, cam, cfg)
        img2, _ = render_sample(scene2, cam2, cfg)
        np.testing.assert_allclose(
            np.asarray(img1), np.asarray(img2), atol=1e-6
        )

    def test_roundtrip_with_bvh(self, tmp_path):
        from scenes_fixtures import random_tri_field

        b = random_tri_field(200)
        scene = b.build(bvh_threshold=64)
        path = str(tmp_path / "tri.irt")
        save_scene(path, scene)
        scene2, cam2 = load_scene(path)
        assert cam2 is None
        assert scene2.tri_bvh is not None
        cfg = st.RenderConfig(width=24, height=24, max_bounces=1)
        cam = st.Camera.create(position=(0, 0, -6.0), fov=1.0)
        img1, _ = render_sample(scene, cam, cfg)
        img2, _ = render_sample(scene2, cam, cfg)
        np.testing.assert_allclose(
            np.asarray(img1), np.asarray(img2), atol=1e-6
        )


class TestImages:
    def test_roundtrip(self, tmp_path):
        img = (np.random.default_rng(0).uniform(0, 1, (8, 8, 3)) * 255
               ).astype(np.uint8)
        p = str(tmp_path / "t.png")
        save_image(p, img)
        back = load_image(p)
        assert back.shape == (8, 8, 4)
        np.testing.assert_array_equal(back[..., :3], img)

    def test_texture_into_scene(self, tmp_path):
        img = np.zeros((4, 4, 4), np.uint8)
        img[..., 0] = 255
        p = str(tmp_path / "tex.tga")
        save_image(p, img)
        b = st.SceneBuilder()
        tid = b.add_texture(load_image(p))
        m = b.add_material(texture_diffuse=tid)
        b.add_sphere((0, 0, 2), 1.0, m)
        b.add_light((2, 2, -2))
        scene = b.build(use_bvh=False)
        cfg = st.RenderConfig(width=16, height=16, max_bounces=1)
        img_r, _ = render_sample(scene, st.Camera.create(), cfg)
        arr = np.asarray(img_r)
        assert arr[..., 0].max() > arr[..., 1].max()  # red texture shows
