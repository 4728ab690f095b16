"""Gradient correctness vs central finite differences (SURVEY.md section
4 item 4; BASELINE north-star: grads match finite differences to 1e-3).

Runs in f64 (conftest enables x64) on small renders.  The FD comparison
uses a fixed-topology loss: geometric perturbations are small enough that
no hit id flips, which is exactly the north-star's regime ("param grads
at fixed topology").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import solstice as st
from solstice.ops.render import render_sample

from scenes_fixtures import cornell_box, cornell_camera


def _f64_scene():
    b = cornell_box(n_spheres=3, reflective=True, transparent=True,
                    seed=11, dtype=np.float64)
    return b.build()


CFG = st.RenderConfig(width=24, height=24, max_bounces=2)


def _loss_fn(scene, cam, target):
    def loss(params):
        img, _ = render_sample(scene.with_params(params), cam, CFG)
        return jnp.mean((img[..., :3] - target) ** 2)

    return loss


@pytest.fixture(scope="module")
def setup():
    scene = _f64_scene()
    cam = st.Camera.create(position=(0.0, 0.0, -1.6), fov=1.1,
                           dtype=jnp.float64)
    img, _ = render_sample(scene, cam, CFG)
    target = img[..., :3] * 0.8  # non-trivial residual
    loss = jax.jit(_loss_fn(scene, cam, target))
    grad = jax.jit(jax.grad(_loss_fn(scene, cam, target)))
    return scene, loss, grad


def _fd_check(loss, params, grads, path, indices, eps=1e-5, tol=1e-3):
    """Central finite difference on selected scalar entries."""
    leaf = params[path] if not isinstance(path, tuple) else (
        params[path[0]][path[1]]
    )
    g_leaf = grads[path] if not isinstance(path, tuple) else (
        grads[path[0]][path[1]]
    )
    worst = 0.0
    for idx in indices:
        def perturbed(sign):
            arr = np.asarray(leaf).copy()
            arr[idx] += sign * eps
            new = dict(params)
            if isinstance(path, tuple):
                seq = list(params[path[0]])
                seq[path[1]] = jnp.asarray(arr)
                new[path[0]] = tuple(seq)
            else:
                new[path] = jnp.asarray(arr)
            return float(loss(new))

        fd = (perturbed(+1) - perturbed(-1)) / (2 * eps)
        an = float(np.asarray(g_leaf)[idx])
        denom = max(abs(fd), abs(an), 1e-4)
        rel = abs(fd - an) / denom
        worst = max(worst, rel)
        assert rel < tol, (
            f"{path}[{idx}]: analytic {an:.6e} vs FD {fd:.6e} "
            f"(rel {rel:.2e})"
        )
    return worst


class TestGradientsVsFiniteDiff:
    def test_sphere_center(self, setup):
        scene, loss, grad = setup
        params = scene.params
        g = grad(params)
        _fd_check(loss, params, g, "sphere_center",
                  [(0, 0), (0, 1), (0, 2), (1, 0), (1, 2)])

    def test_sphere_radius(self, setup):
        scene, loss, grad = setup
        params = scene.params
        g = grad(params)
        _fd_check(loss, params, g, "sphere_radius", [(0,), (1,), (2,)])

    def test_albedo(self, setup):
        scene, loss, grad = setup
        params = scene.params
        g = grad(params)
        _fd_check(loss, params, g, "albedo",
                  [(1, 0), (1, 1), (2, 2), (4, 0)])

    def test_ior(self, setup):
        scene, loss, grad = setup
        params = scene.params
        g = grad(params)
        # Glass material ids: find one with transparency > 0.
        trans = np.asarray(scene.materials.transparency)
        glass = int(np.argmax(trans))
        assert trans[glass] > 0
        _fd_check(loss, params, g, "ior", [(glass,)])

    def test_light_position(self, setup):
        scene, loss, grad = setup
        params = scene.params
        g = grad(params)
        _fd_check(loss, params, g, "light_position",
                  [(0, 0), (0, 1), (0, 2)])

    def test_no_nans_anywhere(self, setup):
        scene, _, grad = setup
        g = grad(scene.params)
        for leaf in jax.tree_util.tree_leaves(g):
            assert np.isfinite(np.asarray(leaf)).all()


class TestBVHGradients:
    """Gradients through BVH-accelerated traversal (the detached-
    traversal + analytic-recompute path of scene_closest_hit)."""

    def test_bvh_scene_grads_finite_and_match_brute(self):
        from scenes_fixtures import random_tri_field

        b = random_tri_field(200)
        scene_bvh = b.build(bvh_threshold=64)
        scene_brute = b.build(use_bvh=False)
        assert scene_bvh.tri_bvh is not None
        cfg_b = st.RenderConfig(width=16, height=16, max_bounces=2,
                                use_bvh=True)
        cfg_n = st.RenderConfig(width=16, height=16, max_bounces=2,
                                use_bvh=False)
        cam = st.Camera.create(position=(0, 0, -6.0), fov=1.0)

        def make_loss(scene, cfg):
            def loss(params):
                img, _ = render_sample(scene.with_params(params), cam, cfg)
                return jnp.mean(img[..., :3] ** 2)
            return loss

        g_b = jax.jit(jax.grad(make_loss(scene_bvh, cfg_b)))(scene_bvh.params)
        g_n = jax.jit(jax.grad(make_loss(scene_brute, cfg_n)))(
            scene_brute.params)
        for leaf in jax.tree_util.tree_leaves(g_b):
            assert np.isfinite(np.asarray(leaf)).all()
        # BVH reorders triangles; compare the vertex-grad total instead
        # of elementwise (order-insensitive check).
        vb = sum(float(np.abs(np.asarray(x)).sum())
                 for x in g_b["vertices"])
        vn = sum(float(np.abs(np.asarray(x)).sum())
                 for x in g_n["vertices"])
        assert vb > 0
        np.testing.assert_allclose(vb, vn, rtol=1e-3)


class TestInverseRendering:
    """BASELINE config #4: recover sphere params by gradient descent."""

    def test_recover_albedo(self):
        scene = _f64_scene()
        cam = st.Camera.create(position=(0.0, 0.0, -1.6), fov=1.1,
                               dtype=jnp.float64)
        cfg = st.RenderConfig(width=32, height=32, max_bounces=2)
        target, _ = render_sample(scene, cam, cfg)
        target = target[..., :3]

        # Albedo-only perturbation: shading gradients exist everywhere,
        # so full recovery is expected.  Geometry recovery is the
        # separate test below (RGB-D objective — silhouette coverage
        # carries no gradient at detached topology, SURVEY.md §7 M2).
        true_params = scene.params
        start = dict(true_params)
        start["albedo"] = true_params["albedo"].at[1:, :3].add(0.15)

        def loss(p):
            img, _ = render_sample(scene.with_params(p), cam, cfg)
            return jnp.mean((img[..., :3] - target) ** 2)

        import optax

        opt = optax.adam(2e-2)
        mask = {k: k == "albedo" for k in start}
        vg = jax.jit(jax.value_and_grad(loss))
        p = start
        state = opt.init(p)
        l0 = float(vg(p)[0])
        for _ in range(150):
            _, g = vg(p)
            g = {k: (v if mask[k] else jax.tree.map(jnp.zeros_like, v))
                 for k, v in g.items()}
            updates, state = opt.update(g, state)
            p = optax.apply_updates(p, updates)
        l1 = float(vg(p)[0])
        assert np.isfinite(l1)
        assert l1 < l0 * 0.15, f"loss {l0:.3e} -> {l1:.3e}"

    def test_recover_sphere_geometry(self):
        """BASELINE config #4 literally: recover perturbed sphere
        centers + radii (+albedo) by descent through the renderer
        (VERDICT r04 missing #4).  RGB-D objective: depth is a render
        output, and supplies the smooth geometric cue that silhouette
        coverage (detached topology) cannot.  Done-bar: param error
        down >= 5x (examples/inverse.py --geometry is the full-size
        artifact)."""
        import optax

        b = st.SceneBuilder()
        floor = b.add_material(color=(0.75, 0.75, 0.75, 1.0))
        red = b.add_material(color=(0.85, 0.25, 0.2, 1.0), specular=0.4)
        teal = b.add_material(color=(0.15, 0.6, 0.65, 1.0), specular=0.6)
        b.add_plane(st.types.PlaneAxis.XZ, (0.0, -1.0, 0.0),
                    (12.0, 12.0), floor)
        b.add_sphere((-1.1, 0.0, 0.8), 1.0, red)
        b.add_sphere((1.2, -0.3, 0.0), 0.7, teal)
        b.add_light((3.0, 6.0, -4.0), intensity=1.0)
        scene = b.build()
        cam = st.Camera.create(position=(0.0, 1.2, -5.0),
                               angles=(0.18, 0.0, 0.0), fov=1.0)
        cfg = st.RenderConfig(width=32, height=32, max_bounces=2)
        timg, tdepth = render_sample(scene, cam, cfg)
        timg = jax.lax.stop_gradient(timg[..., :3])
        tdepth = jax.lax.stop_gradient(tdepth)
        tvalid = tdepth < 1e29

        true_p = scene.params
        start = dict(true_p)
        start["sphere_center"] = true_p["sphere_center"].at[0:2].add(
            jnp.asarray([[0.15, -0.12, 0.1], [-0.12, 0.1, -0.08]])
        )
        start["sphere_radius"] = true_p["sphere_radius"].at[0:2].mul(
            jnp.asarray([1.12, 0.9])
        )
        mask = {k: k in ("sphere_center", "sphere_radius")
                for k in start}

        def loss(p):
            img, depth = render_sample(scene.with_params(p), cam, cfg)
            dres = jnp.where(tvalid & (depth < 1e29), depth - tdepth,
                             0.0)
            return (jnp.mean((img[..., :3] - timg) ** 2)
                    + 0.05 * jnp.mean(dres ** 2))

        opt = optax.chain(optax.clip_by_global_norm(1.0),
                          optax.adam(1e-2))
        vg = jax.jit(jax.value_and_grad(loss))
        p, state = start, opt.init(start)

        def err(p):
            return max(
                float(jnp.abs(p["sphere_center"][0:2]
                              - true_p["sphere_center"][0:2]).max()),
                float(jnp.abs(p["sphere_radius"][0:2]
                              - true_p["sphere_radius"][0:2]).max()),
            )

        e0 = err(p)
        for _ in range(150):
            _, g = vg(p)
            g = {k: (v if mask[k] else jax.tree.map(jnp.zeros_like, v))
                 for k, v in g.items()}
            updates, state = opt.update(g, state)
            p = optax.apply_updates(p, updates)
        e1 = err(p)
        assert e1 < e0 / 5.0, f"geometry error {e0:.4f} -> {e1:.4f}"


class TestDifferentiabilityContract:
    """Pin WHICH gradients exist per configuration (VERDICT r03 weak
    #6: the occluder-transparency detachment on accelerated pools was
    documented only in a code comment).  Contract (also in README.md):
    occluder transparency gradients flow on brute-force pools (below
    bvh_threshold) and are DELIBERATELY zero on accelerated pools
    (the packed shadow factor is detached accel-structure data)."""

    @staticmethod
    def _shadow_scene(n_pad_spheres, bvh_threshold):
        b = st.SceneBuilder()
        floor = b.add_material(color=(0.9, 0.9, 0.9, 1.0))
        glass = b.add_material(color=(1.0, 1.0, 1.0, 1.0),
                               transparency=0.5, ior=1.0)
        b.add_plane(st.types.PlaneAxis.XZ, (0.0, 0.0, 0.0),
                    (6.0, 6.0), floor)
        # Occluder between light and floor.
        b.add_sphere((0.0, 2.0, 0.0), 0.8, glass)
        for i in range(n_pad_spheres):
            b.add_sphere((10.0 + i, 20.0, 10.0), 0.1, floor)
        b.add_light((0.0, 6.0, 0.0), intensity=1.0)
        return b.build(bvh_threshold=bvh_threshold), glass

    def _shadow_grad(self, scene, mat_id):
        # Camera UNDER the occluder looking straight down: only the
        # shadowed floor patch is in frame, so the sole transparency
        # dependence is the shadow attenuation (the direct shading
        # weight 1 - w of a visible occluder would otherwise dominate).
        cam = st.Camera.create(position=(0.0, 1.2, 0.0),
                               angles=(1.5, 0.0, 0.0), fov=0.8)
        cfg = st.RenderConfig(width=16, height=16, max_bounces=1)

        def loss(tr):
            mats = scene.materials
            s2 = scene.replace(materials=mats.replace(
                transparency=mats.transparency.at[mat_id].set(tr)
            ))
            img, _ = render_sample(s2, cam, cfg)
            return jnp.sum(img[..., :3])

        return float(jax.grad(loss)(
            jnp.asarray(0.5, scene.materials.transparency.dtype)
        ))

    def test_brute_pool_has_occluder_transparency_grad(self):
        scene, glass = self._shadow_scene(0, bvh_threshold=1000)
        assert scene.sph_bvh is None  # brute-force path engaged
        g = self._shadow_grad(scene, glass)
        assert np.isfinite(g) and abs(g) > 1e-3, g

    def test_accelerated_pool_grad_is_zero_by_contract(self):
        scene, glass = self._shadow_scene(80, bvh_threshold=16)
        assert scene.sph_bvh is not None  # accelerated path engaged
        g = self._shadow_grad(scene, glass)
        # Shadow-factor detachment: documented as exactly zero.  The
        # remaining CONTINUATION-weight gradient is also absent at
        # max_bounces=1 (no secondary ray is traced).
        assert np.isfinite(g)
        assert abs(g) < 1e-6, g
