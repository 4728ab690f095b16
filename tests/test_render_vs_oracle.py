"""Forward-correctness: the JAX renderer vs the independent CPU oracle
(SURVEY.md section 4 item 1; BASELINE.json configs #1-#3).

Comparison is robust to discrete hit-selection flips at geometric edges:
f32 renderer and f64 oracle may pick different-but-equidistant hits on a
silhouette pixel, so we require the mean error to be tiny and allow a
small fraction of outlier pixels rather than a strict allclose.
"""

import jax
import numpy as np
import pytest

import solstice as st
from solstice.oracle import assert_images_match, oracle_render
from solstice.ops.render import render_sample

from scenes_fixtures import (
    cornell_box,
    cornell_camera,
    random_sphere_field,
    random_tri_field,
    tri_quad_scene,
)


def _render(scene, cam, cfg):
    img, _ = jax.jit(render_sample, static_argnums=2)(scene, cam, cfg)
    return img


class TestCornell:
    """BASELINE config #1: Cornell box, 8 spheres, 1 light, 2 bounces."""

    def test_diffuse_only(self):
        b = cornell_box(n_spheres=8, reflective=False, transparent=False)
        scene = b.build()
        cfg = st.RenderConfig(width=48, height=48, max_bounces=2)
        cam = cornell_camera()
        assert_images_match(
            _render(scene, cam, cfg), oracle_render(scene, cam, cfg)
        )

    def test_reflective_transparent(self):
        """Config #3 semantics: mirrors + glass (IoR 1.5) at 3 bounces."""
        b = cornell_box(n_spheres=8, reflective=True, transparent=True)
        scene = b.build()
        cfg = st.RenderConfig(width=48, height=48, max_bounces=3)
        cam = cornell_camera()
        assert_images_match(
            _render(scene, cam, cfg), oracle_render(scene, cam, cfg)
        )

    def test_checker_floor(self):
        b = cornell_box(n_spheres=4, checker=True)
        scene = b.build()
        cfg = st.RenderConfig(width=48, height=48, max_bounces=2)
        cam = cornell_camera()
        assert_images_match(
            _render(scene, cam, cfg), oracle_render(scene, cam, cfg)
        )

    def test_no_shadows_mode(self):
        b = cornell_box(n_spheres=4)
        scene = b.build()
        cfg = st.RenderConfig(width=32, height=32, max_bounces=2,
                              shadows=False)
        cam = cornell_camera()
        assert_images_match(
            _render(scene, cam, cfg), oracle_render(scene, cam, cfg)
        )


class TestMeshes:
    def test_tri_quad(self):
        scene = tri_quad_scene().build()
        cfg = st.RenderConfig(width=32, height=32, max_bounces=1)
        cam = st.Camera.create(position=(0, 0, -2.0))
        assert_images_match(
            _render(scene, cam, cfg), oracle_render(scene, cam, cfg)
        )

    def test_tri_field_bvh_vs_oracle(self):
        """Config #2 semantics: triangle field with BVH vs brute oracle."""
        b = random_tri_field(300)
        scene = b.build(bvh_threshold=64)
        assert scene.tri_bvh is not None, "BVH should build for 300 tris"
        cfg = st.RenderConfig(width=32, height=32, max_bounces=2)
        cam = st.Camera.create(position=(0, 0, -6.0), fov=1.0)
        assert_images_match(
            _render(scene, cam, cfg), oracle_render(scene, cam, cfg)
        )


class TestBVHConsistency:
    """BVH render must equal brute-force render on the same scene
    (SURVEY.md section 4 item 2: compaction correctness analog)."""

    @pytest.mark.parametrize("field", ["spheres", "tris"])
    def test_bvh_equals_brute(self, field):
        b = (random_sphere_field(256) if field == "spheres"
             else random_tri_field(256))
        scene_bvh = b.build(bvh_threshold=64)
        scene_brute = b.build(use_bvh=False)
        cfg_b = st.RenderConfig(width=32, height=32, max_bounces=2,
                                use_bvh=True)
        cfg_n = st.RenderConfig(width=32, height=32, max_bounces=2,
                                use_bvh=False)
        cam = st.Camera.create(position=(0, 0, -6.0), fov=1.0)
        img_b = _render(scene_bvh, cam, cfg_b)
        img_n = _render(scene_brute, cam, cfg_n)
        # Same algorithm either path; only summation order differs.
        np.testing.assert_allclose(
            np.asarray(img_b), np.asarray(img_n), atol=2e-5
        )


class TestCameraModes:
    def test_anaglyph_runs(self):
        scene = cornell_box(n_spheres=2).build()
        cfg = st.RenderConfig(width=32, height=32, max_bounces=1,
                              camera_mode=st.CameraMode.ANAGLYPH)
        img, _ = render_sample(scene, cornell_camera(), cfg)
        assert img.shape == (32, 32, 4)
        assert np.isfinite(np.asarray(img)).all()

    def test_progressive_accumulation_converges(self):
        from solstice.ops.render import accumulate

        scene = cornell_box(n_spheres=2).build()
        cfg = st.RenderConfig(width=16, height=16, max_bounces=1,
                              antialias_jitter=True)
        cam = cornell_camera()
        key = jax.random.PRNGKey(0)
        accum = None
        for i in range(4):
            key, sub = jax.random.split(key)
            img, _ = render_sample(scene, cam, cfg, sub)
            accum = img if accum is None else accumulate(accum, img, i)
        ref = oracle_render(scene, cam, cfg)
        # 4 jittered samples vs the unjittered oracle: only edge pixels
        # should deviate; interior pixels converge immediately.
        assert_images_match(accum, ref, mean_tol=4e-2, pix_tol=0.3,
                            outliers=0.08)
