"""Normal/bump-map shading tests (reference: TextureMapping.cuh's
normal/bump texture slots consumed by advancedTextureMapping; VERDICT
r02 missing #4).

Analytic checks: a flat XZ floor lit straight from above.  A constant
tangent-space normal map of known tilt must change the diffuse term by
exactly the predicted cosine factor; a constant-height bump map must be
an identity; a ramp bump map must darken/tilt."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import solstice as st
from solstice.ops.textures import (
    BUMP_STRENGTH, apply_normal_maps, tangent_basis,
)
from solstice.ops.traverse import scene_closest_hit, surface_at


def _floor_scene(**mat_kw):
    b = st.SceneBuilder()
    m = b.add_material(color=(1.0, 1.0, 1.0, 1.0), **mat_kw)
    b.add_plane(st.types.PlaneAxis.XZ, (0.0, 0.0, 0.0), (10.0, 10.0), m)
    b.add_light((0.0, 50.0, 0.0), intensity=1.0)
    return b


def _shade_down(scene):
    """Shading normal at a straight-down ray onto the floor."""
    o = jnp.array([[0.3, 2.0, 0.2]], jnp.float32)
    d = jnp.array([[0.0, -1.0, 0.0]], jnp.float32)
    hit = scene_closest_hit(scene, o, d)
    surf = surface_at(scene, hit, o, d)
    return np.asarray(surf.shading_normal[0]), np.asarray(surf.valid[0])


class TestTangentBasis:
    def test_orthonormal(self):
        rng = np.random.default_rng(0)
        n = rng.normal(size=(64, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        t, b = tangent_basis(jnp.asarray(n))
        t, b = np.asarray(t), np.asarray(b)
        for a, c in [(t, n), (b, n), (t, b)]:
            np.testing.assert_allclose(
                (a * c).sum(-1), 0.0, atol=1e-5
            )
        np.testing.assert_allclose(
            np.linalg.norm(t, axis=-1), 1.0, rtol=1e-5
        )


class TestNormalMap:
    def test_flat_map_is_identity(self):
        b = _floor_scene()
        flat = np.full((8, 8, 3), [0.5, 0.5, 1.0])  # encodes (0,0,1)
        tid = b.add_texture(flat)
        b2 = _floor_scene(texture_normal=tid)
        # textures live on the builder that registered them:
        b2._tex_data = b._tex_data
        n0, v0 = _shade_down(b.build())
        n1, v1 = _shade_down(b2.build())
        assert v0 and v1
        np.testing.assert_allclose(n1, n0, atol=2.5e-2)  # uint8 quantum

    def test_tilted_map_tilts_by_known_angle(self):
        # Tangent-space normal (sin a, 0, cos a): tilt by a around the
        # bitangent.  The resulting world normal must satisfy
        # dot(n_new, n_old) == cos a.
        a = np.deg2rad(30.0)
        enc = np.array([np.sin(a), 0.0, np.cos(a)]) * 0.5 + 0.5
        b = _floor_scene()
        tid = b.add_texture(np.full((8, 8, 3), enc))
        b2 = _floor_scene(texture_normal=tid)
        b2._tex_data = b._tex_data
        n1, valid = _shade_down(b2.build())
        assert valid
        np.testing.assert_allclose(
            float(n1[1]), np.cos(a), atol=2e-2
        )  # floor normal is +y

    def test_masked_lanes_untouched(self):
        """Materials without a map keep their normals bit-exact."""
        scene = _floor_scene().build()
        rng = np.random.default_rng(1)
        n = rng.normal(size=(16, 3)).astype(np.float32)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        mat = jnp.zeros((16,), jnp.int32)
        uv = jnp.asarray(rng.uniform(0, 1, (16, 2)).astype(np.float32))
        out = apply_normal_maps(scene, mat, uv, jnp.asarray(n))
        np.testing.assert_array_equal(np.asarray(out), n)


class TestBumpMap:
    def test_constant_height_is_identity(self):
        b = _floor_scene()
        tid = b.add_texture(np.full((8, 8, 3), 0.6))
        b2 = _floor_scene(texture_bump=tid)
        b2._tex_data = b._tex_data
        n0, _ = _shade_down(_floor_scene().build())
        n1, valid = _shade_down(b2.build())
        assert valid
        np.testing.assert_allclose(n1, n0, atol=1e-5)

    def test_ramp_tilts_toward_gradient(self):
        # Height increasing along u -> normal tilts AGAINST +tangent.
        ramp = np.tile(np.linspace(0.25, 0.75, 32)[None, :, None],
                       (32, 1, 3))
        b = _floor_scene()
        tid = b.add_texture(ramp)
        b2 = _floor_scene(texture_bump=tid)
        b2._tex_data = b._tex_data
        n1, valid = _shade_down(b2.build())
        assert valid
        n0, _ = _shade_down(_floor_scene().build())
        # Normal must actually move, stay unit-length, and keep +y up.
        assert np.linalg.norm(n1 - n0) > 1e-3
        np.testing.assert_allclose(np.linalg.norm(n1), 1.0, rtol=1e-5)
        assert n1[1] > 0.5

    def test_render_end_to_end_changes_image(self):
        """Full render with a bump map differs from the flat render and
        stays finite (the map feeds reflection directions too)."""
        ramp = np.tile(
            (0.5 + 0.3 * np.sin(np.linspace(0, 12.56, 64)))[None, :, None],
            (64, 1, 3),
        )
        cfg = st.RenderConfig(width=32, height=32, max_bounces=2)
        cam = st.Camera.create(position=(0.0, 1.0, -3.0),
                               angles=(0.3, 0, 0))
        b = _floor_scene()
        img0 = np.asarray(st.render(b.build(), cam, cfg))
        b2 = _floor_scene()
        tid = b2.add_texture(ramp)
        b3 = _floor_scene(texture_bump=tid)
        b3._tex_data = b2._tex_data
        img1 = np.asarray(st.render(b3.build(), cam, cfg))
        assert np.isfinite(img1).all()
        assert np.abs(img1 - img0).max() > 1e-3
