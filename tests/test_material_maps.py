"""Specular/reflection/transparency texture-slot tests (reference:
Material textureIds[specular/reflection/transparency] consumed by
advancedTextureMapping — SURVEY.md section 2.1; VERDICT r03 missing #4).

The CPU oracle deliberately has no texture atlas, so these are analytic
comparative checks (same approach as tests/test_normal_maps.py): a
white map must be the identity, a black map must kill the channel, and
a half-and-half map must gate per-region."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import solstice as st
from solstice.ops.render import render_sample
from solstice.ops.textures import material_map_scales
from solstice.ops.traverse import scene_closest_hit, surface_at

CFG = st.RenderConfig(width=32, height=32, max_bounces=3)
CAM = st.Camera.create(position=(0.0, 1.0, -4.0), fov=1.0)


def _scene(tex_img=None, slot=None, **mat_kw):
    """Floor + one centered sphere with the material under test."""
    b = st.SceneBuilder()
    kw = dict(mat_kw)
    if tex_img is not None:
        tid = b.add_texture(tex_img)
        kw[slot] = tid
    m = b.add_material(color=(0.9, 0.9, 0.9, 1.0), **kw)
    floor = b.add_material(color=(0.3, 0.35, 0.4, 1.0))
    b.add_plane(st.types.PlaneAxis.XZ, (0.0, -1.0, 0.0), (20.0, 20.0),
                floor)
    b.add_sphere((0.0, 0.5, 0.0), 1.0, m)
    b.add_light((4.0, 8.0, -6.0), intensity=1.0)
    return b.build()


def _img(scene):
    img, _ = render_sample(scene, CAM, CFG)
    return np.asarray(img)


WHITE = np.full((8, 8, 3), 1.0)
BLACK = np.zeros((8, 8, 3))


class TestScales:
    def test_unset_slots_are_identity(self):
        scene = _scene(specular=0.8)
        uv = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (16, 2)),
                         jnp.float32)
        mat = jnp.ones((16,), jnp.int32)
        s, r, t = material_map_scales(scene, mat, uv)
        for x in (s, r, t):
            np.testing.assert_allclose(np.asarray(x), 1.0, atol=1e-2)

    def test_black_map_zeroes_channel(self):
        scene = _scene(BLACK, "texture_specular", specular=0.8)
        uv = jnp.asarray([[0.5, 0.5]], jnp.float32)
        mat = jnp.ones((1,), jnp.int32)
        s, r, t = material_map_scales(scene, mat, uv)
        assert float(s[0]) < 1e-3
        np.testing.assert_allclose(float(r[0]), 1.0, atol=1e-2)
        np.testing.assert_allclose(float(t[0]), 1.0, atol=1e-2)


class TestSpecularMap:
    def test_white_map_is_identity(self):
        base = _img(_scene(specular=0.9, specular_power=20.0))
        mapped = _img(_scene(WHITE, "texture_specular",
                             specular=0.9, specular_power=20.0))
        np.testing.assert_allclose(mapped, base, atol=2e-2)

    def test_black_map_gates_highlight(self):
        """A black specular map must remove the highlight: the mapped
        render equals the specular-free render, and differs visibly
        from the specular one."""
        shiny = _img(_scene(specular=0.9, specular_power=20.0))
        matte = _img(_scene(specular=0.0))
        gated = _img(_scene(BLACK, "texture_specular",
                            specular=0.9, specular_power=20.0))
        np.testing.assert_allclose(gated, matte, atol=2e-2)
        assert np.abs(shiny - gated).max() > 0.2  # highlight was real


class TestReflectionMap:
    def test_black_map_makes_mirror_matte(self):
        mirror = _img(_scene(reflection=0.8))
        matte = _img(_scene(reflection=0.0))
        gated = _img(_scene(BLACK, "texture_reflection", reflection=0.8))
        np.testing.assert_allclose(gated, matte, atol=2e-2)
        assert np.abs(mirror - gated).max() > 0.1

    def test_white_map_is_identity(self):
        base = _img(_scene(reflection=0.8))
        mapped = _img(_scene(WHITE, "texture_reflection", reflection=0.8))
        np.testing.assert_allclose(mapped, base, atol=2e-2)


class TestTransparencyMap:
    def test_black_map_makes_glass_opaque(self):
        # Shadows off: occluder shadow ATTENUATION deliberately uses the
        # base material transparency, not the map (the packed per-prim
        # shadow factor rides in the accel structure) — documented scope;
        # the map gates the refraction continuation + shading weight.
        cfg = st.RenderConfig(width=32, height=32, max_bounces=3,
                              shadows=False)

        def img(scene):
            out, _ = render_sample(scene, CAM, cfg)
            return np.asarray(out)

        glass = img(_scene(transparency=0.8, ior=1.5))
        opaque = img(_scene(transparency=0.0, ior=1.5))
        gated = img(_scene(BLACK, "texture_transparency",
                           transparency=0.8, ior=1.5))
        np.testing.assert_allclose(gated, opaque, atol=2e-2)
        assert np.abs(glass - gated).max() > 0.1

    def test_gradients_flow_through_map_scale(self):
        """The map-scaled continuation weight stays differentiable wrt
        the underlying material transparency."""
        scene = _scene(WHITE, "texture_transparency",
                       transparency=0.5, ior=1.3)

        def loss(tr):
            mats = scene.materials
            s2 = scene.replace(
                materials=mats.replace(
                    transparency=mats.transparency.at[1].set(tr)
                )
            )
            img, _ = render_sample(s2, CAM, CFG)
            return jnp.sum(img[..., :3])

        g = jax.grad(loss)(jnp.float32(0.5))
        assert np.isfinite(float(g)) and abs(float(g)) > 0.0


class TestIrtRoundTrip:
    def test_slots_survive_save_load(self, tmp_path):
        from solstice.io.irt import load_scene, save_scene

        scene = _scene(BLACK, "texture_reflection", reflection=0.8)
        p = str(tmp_path / "s.irt")
        save_scene(p, scene)
        s2, _ = load_scene(p)
        np.testing.assert_array_equal(
            np.asarray(s2.materials.texture_reflection),
            np.asarray(scene.materials.texture_reflection),
        )
        np.testing.assert_allclose(_img(s2), _img(scene), atol=1e-5)
