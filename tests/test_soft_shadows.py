"""Soft-shadow semantics (reference: processShadows' light-sample
jitter within the lamp radius; VERDICT r03 weak #7 — the old Gaussian
jitter was unbounded, so a 3-sigma draw moved the light outside its own
extent).

Pins: (1) the jitter distribution is bounded by the unit ball and
covers it; (2) penumbra width tracks the light radius in a rendered
occluder scene."""

import jax
import jax.numpy as jnp
import numpy as np

import solstice as st
from solstice.ops.render import render_sample
from solstice.ops.shade import ball_jitter


class TestBallJitter:
    def test_bounded_and_covering(self, key):
        s = np.asarray(ball_jitter(key, (4096,), jnp.float32))
        r = np.linalg.norm(s, axis=-1)
        assert r.max() <= 1.0 + 1e-6  # bounded: never outside the light
        assert r.max() > 0.9  # actually reaches the rim
        # Volume-uniform: P(r <= x) = x^3; the median radius is 2^(-1/3).
        np.testing.assert_allclose(
            np.median(r), 0.5 ** (1 / 3), atol=0.03
        )
        np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.05)


def _penumbra(radius, key):
    """Fraction of floor pixels in partial shadow for a sphere occluder
    under a light of the given radius."""
    b = st.SceneBuilder()
    floor = b.add_material(color=(0.9, 0.9, 0.9, 1.0))
    occ = b.add_material(color=(0.2, 0.2, 0.2, 1.0))
    b.add_plane(st.types.PlaneAxis.XZ, (0.0, 0.0, 0.0), (12.0, 12.0),
                floor)
    # Occluder close to the light: penumbra width on the floor is
    # ~2x the light radius (similar-triangles), so the radius effect
    # dominates pixel quantization.
    b.add_sphere((0.0, 6.0, 0.0), 0.5, occ)
    b.add_light((0.0, 9.0, 0.0), intensity=1.0, radius=radius)
    scene = b.build()
    cfg = st.RenderConfig(width=48, height=48, max_bounces=1,
                          shadow_samples=8)
    cam = st.Camera.create(position=(0.0, 7.0, -7.0),
                           angles=(0.8, 0.0, 0.0), fov=1.0)
    img, _ = render_sample(scene, cam, cfg, key)
    cfg_ns = cfg.replace(shadows=False) if hasattr(cfg, "replace") else (
        st.RenderConfig(width=48, height=48, max_bounces=1,
                        shadow_samples=8, shadows=False)
    )
    img_ns, _ = render_sample(scene, cam, cfg_ns, key)
    lum = np.asarray(img[..., :3].mean(-1))
    lum_ns = np.asarray(img_ns[..., :3].mean(-1))
    # Per-pixel shadow factor: 1 = fully lit, 0 = umbra.  Partial = the
    # penumbra band.
    factor = lum / np.maximum(lum_ns, 1e-6)
    partial = (factor > 0.15) & (factor < 0.85) & (lum_ns > 0.05)
    return partial.mean()


class TestPenumbra:
    def test_width_tracks_light_radius(self, key):
        small = _penumbra(0.02, key)
        large = _penumbra(1.2, key)
        # A bigger light must produce a substantially wider penumbra.
        assert large > small * 1.5 + 0.01, (small, large)
