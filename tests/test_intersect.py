"""Closed-form unit tests for the analytic intersectors
(SURVEY.md section 4 item 2 — the arbiter between renderer and oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from solstice.constants import T_FAR
from solstice.ops import intersect as isect
from solstice.ops import vecmath as vm

EPS = 1e-4


def _ray(o, d):
    o = jnp.asarray([o], jnp.float32)
    d = jnp.asarray([d], jnp.float32)
    return o, d / jnp.linalg.norm(d)


class TestSphere:
    def test_head_on(self):
        o, d = _ray((0, 0, -3), (0, 0, 1))
        t = isect.sphere_t(o, d, jnp.array([[0.0, 0, 0]]), jnp.array([1.0]),
                           EPS)
        assert np.allclose(t[0, 0], 2.0, atol=1e-5)

    def test_miss(self):
        o, d = _ray((0, 5, -3), (0, 0, 1))
        t = isect.sphere_t(o, d, jnp.array([[0.0, 0, 0]]), jnp.array([1.0]),
                           EPS)
        assert t[0, 0] > T_FAR * 0.5

    def test_inside_gives_exit(self):
        o, d = _ray((0, 0, 0), (0, 0, 1))
        t = isect.sphere_t(o, d, jnp.array([[0.0, 0, 0]]), jnp.array([1.0]),
                           EPS)
        assert np.allclose(t[0, 0], 1.0, atol=1e-5)

    def test_tangent_offset(self):
        # Grazing ray at y=1-1e-3 must hit, at y=1+1e-3 must miss.
        o, d = _ray((0, 1 - 1e-3, -3), (0, 0, 1))
        t = isect.sphere_t(o, d, jnp.array([[0.0, 0, 0]]), jnp.array([1.0]),
                           EPS)
        assert t[0, 0] < T_FAR * 0.5
        o, d = _ray((0, 1 + 1e-3, -3), (0, 0, 1))
        t = isect.sphere_t(o, d, jnp.array([[0.0, 0, 0]]), jnp.array([1.0]),
                           EPS)
        assert t[0, 0] > T_FAR * 0.5

    def test_inert_padding(self):
        o, d = _ray((0, 0, -3), (0, 0, 1))
        t = isect.sphere_t(o, d, jnp.zeros((1, 3)), jnp.array([-1.0]), EPS)
        assert t[0, 0] > T_FAR * 0.5


class TestTriangle:
    V0 = jnp.array([[-1.0, -1.0, 0.0]])
    V1 = jnp.array([[1.0, -1.0, 0.0]])
    V2 = jnp.array([[0.0, 1.0, 0.0]])

    def test_center_hit(self):
        o, d = _ray((0, -0.2, -2), (0, 0, 1))
        t = isect.triangle_t(o, d, self.V0, self.V1, self.V2, EPS)
        assert np.allclose(t[0, 0], 2.0, atol=1e-5)

    def test_outside_misses(self):
        o, d = _ray((2, 0, -2), (0, 0, 1))
        t = isect.triangle_t(o, d, self.V0, self.V1, self.V2, EPS)
        assert t[0, 0] > T_FAR * 0.5

    def test_backface_hits(self):
        # Two-sided: hit from behind too (refraction support).
        o, d = _ray((0, -0.2, 2), (0, 0, -1))
        t = isect.triangle_t(o, d, self.V0, self.V1, self.V2, EPS)
        assert np.allclose(t[0, 0], 2.0, atol=1e-5)

    def test_degenerate_inert(self):
        z = jnp.zeros((1, 3))
        o, d = _ray((0, 0, -2), (0, 0, 1))
        t = isect.triangle_t(o, d, z, z, z, EPS)
        assert t[0, 0] > T_FAR * 0.5

    def test_bary_matches_hit(self):
        o, d = _ray((0.3, -0.5, -2), (0, 0, 1))
        u, v = isect.triangle_bary(o, d, self.V0, self.V1, self.V2)
        p = self.V0 * (1 - u - v) + self.V1 * u + self.V2 * v
        assert np.allclose(p[0, :2], [0.3, -0.5], atol=1e-5)


class TestCylinder:
    def test_side_hit(self):
        # Vertical unit-radius cylinder along y in [0, 2].
        o, d = _ray((0, 1, -3), (0, 0, 1))
        t = isect.cylinder_t(
            o, d, jnp.array([[0.0, 0, 0]]), jnp.array([[0.0, 2, 0]]),
            jnp.array([1.0]), EPS,
        )
        assert np.allclose(t[0, 0], 2.0, atol=1e-4)

    def test_beyond_cap_misses(self):
        o, d = _ray((0, 3, -3), (0, 0, 1))
        t = isect.cylinder_t(
            o, d, jnp.array([[0.0, 0, 0]]), jnp.array([[0.0, 2, 0]]),
            jnp.array([1.0]), EPS,
        )
        assert t[0, 0] > T_FAR * 0.5

    def test_axis_parallel_ray_hits_cap(self):
        o, d = _ray((0, -3, 0), (0, 1, 0))
        t = isect.cylinder_t(
            o, d, jnp.array([[0.0, 0, 0]]), jnp.array([[0.0, 2, 0]]),
            jnp.array([1.0]), EPS,
        )
        # Parallel to the axis inside the tube: the side surface is
        # never hit, but the p0 END CAP is (capped cylinderIntersection,
        # round 3) — at y = 0, i.e. t = 3.
        np.testing.assert_allclose(float(t[0, 0]), 3.0, rtol=1e-5)

    def test_axis_parallel_ray_outside_radius_misses(self):
        o, d = _ray((2.5, -3, 0), (0, 1, 0))
        t = isect.cylinder_t(
            o, d, jnp.array([[0.0, 0, 0]]), jnp.array([[0.0, 2, 0]]),
            jnp.array([1.0]), EPS,
        )
        assert t[0, 0] > T_FAR * 0.5


class TestEllipsoid:
    def test_axis_hits(self):
        c = jnp.array([[0.0, 0, 0]])
        r = jnp.array([[2.0, 1.0, 0.5]])
        o, d = _ray((-5, 0, 0), (1, 0, 0))
        t = isect.ellipsoid_t(o, d, c, r, EPS)
        assert np.allclose(t[0, 0], 3.0, atol=1e-4)
        o, d = _ray((0, -5, 0), (0, 1, 0))
        t = isect.ellipsoid_t(o, d, c, r, EPS)
        assert np.allclose(t[0, 0], 4.0, atol=1e-4)

    def test_sphere_equivalence(self):
        c = jnp.array([[0.0, 0, 0]])
        o, d = _ray((0.3, 0.2, -4), (0, 0, 1))
        te = isect.ellipsoid_t(o, d, c, jnp.array([[1.0, 1, 1]]), EPS)
        ts = isect.sphere_t(o, d, c, jnp.array([1.0]), EPS)
        assert np.allclose(te[0, 0], ts[0, 0], atol=1e-4)


class TestPlane:
    def test_each_axis(self):
        for axis, o_pos, d_dir in [
            (0, (-3, 0.2, 0.3), (1, 0, 0)),  # YZ plane, normal x
            (1, (0.2, -3, 0.3), (0, 1, 0)),  # XZ plane, normal y
            (2, (0.2, 0.3, -3), (0, 0, 1)),  # XY plane, normal z
        ]:
            o, d = _ray(o_pos, d_dir)
            t = isect.plane_t(
                o, d, jnp.array([axis], jnp.int32), jnp.zeros((1, 3)),
                jnp.array([[1.0, 1.0]]), EPS,
            )
            assert np.allclose(t[0, 0], 3.0, atol=1e-5), axis

    def test_outside_extent(self):
        o, d = _ray((5, 0.2, -3), (0, 0, 1))
        t = isect.plane_t(
            o, d, jnp.array([2], jnp.int32), jnp.zeros((1, 3)),
            jnp.array([[1.0, 1.0]]), EPS,
        )
        assert t[0, 0] > T_FAR * 0.5

    def test_asymmetric_extents(self):
        # XZ plane with he=(4, 1): x extent 4, z extent 1.
        o, d = _ray((3, 3, 0.5), (0, -1, 0))
        t = isect.plane_t(
            o, d, jnp.array([1], jnp.int32), jnp.zeros((1, 3)),
            jnp.array([[4.0, 1.0]]), EPS,
        )
        assert t[0, 0] < T_FAR * 0.5
        o, d = _ray((3, 3, 2.5), (0, -1, 0))
        t = isect.plane_t(
            o, d, jnp.array([1], jnp.int32), jnp.zeros((1, 3)),
            jnp.array([[4.0, 1.0]]), EPS,
        )
        assert t[0, 0] > T_FAR * 0.5


class TestAABB:
    def test_hit_and_miss(self):
        o = jnp.array([[0.0, 0, -5]])
        d = jnp.array([[0.0, 0, 1]])
        inv = 1.0 / jnp.where(jnp.abs(d) > 1e-12, d, 1e-12)
        hit = isect.aabb_hit(
            o, inv, jnp.array([-1.0, -1, -1]), jnp.array([1.0, 1, 1]),
            EPS, T_FAR,
        )
        assert bool(hit[0])
        miss = isect.aabb_hit(
            o, inv, jnp.array([2.0, 2, 2]), jnp.array([3.0, 3, 3]),
            EPS, T_FAR,
        )
        assert not bool(miss[0])

    def test_inside_box(self):
        o = jnp.array([[0.0, 0, 0]])
        d = jnp.array([[0.0, 0, 1]])
        inv = 1.0 / jnp.where(jnp.abs(d) > 1e-12, d, 1e-12)
        hit = isect.aabb_hit(
            o, inv, jnp.array([-1.0, -1, -1]), jnp.array([1.0, 1, 1]),
            EPS, T_FAR,
        )
        assert bool(hit[0])


class TestVecmath:
    def test_reflect(self):
        i = jnp.array([1.0, -1.0, 0.0]) / np.sqrt(2)
        n = jnp.array([0.0, 1.0, 0.0])
        r = vm.reflect(i, n)
        assert np.allclose(r, [1 / np.sqrt(2), 1 / np.sqrt(2), 0], atol=1e-6)

    def test_refract_straight(self):
        i = jnp.array([[0.0, 0.0, 1.0]])
        n = jnp.array([[0.0, 0.0, -1.0]])
        r, tir = vm.refract(i, n, jnp.array([1.0 / 1.5]))
        assert np.allclose(r, [[0, 0, 1]], atol=1e-6)
        assert not bool(tir[0])

    def test_refract_snell_angle(self):
        # 45 deg incidence, n=1.5: sin(theta_t) = sin(45)/1.5
        s = 1 / np.sqrt(2)
        i = jnp.array([[s, 0.0, s]])
        n = jnp.array([[0.0, 0.0, -1.0]])
        r, tir = vm.refract(i, n, jnp.array([1.0 / 1.5]))
        assert not bool(tir[0])
        assert np.allclose(float(r[0, 0]), s / 1.5, atol=1e-6)

    def test_total_internal_reflection(self):
        # From glass to air beyond critical angle (~41.8 deg).
        ang = np.deg2rad(60.0)
        i = jnp.array([[np.sin(ang), 0.0, np.cos(ang)]])
        n = jnp.array([[0.0, 0.0, -1.0]])
        r, tir = vm.refract(i, n, jnp.array([1.5]))
        assert bool(tir[0])
        # TIR returns the reflection direction.
        assert np.allclose(r, vm.reflect(i, n), atol=1e-6)

    def test_rotate_euler_roundtrip(self):
        v = jnp.array([0.3, -0.7, 0.5])
        a = jnp.array([0.3, 1.1, -0.4])
        r = vm.rotate_euler(v, a)
        assert np.allclose(jnp.linalg.norm(r), jnp.linalg.norm(v), atol=1e-6)
