"""Distributed code paths on 8 virtual CPU devices (SURVEY.md section 4
item 5): sharded render == single-device render; sharded grads == psum
of tile grads == single-device grads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import solstice as st
from solstice.ops.render import render_sample
from solstice.parallel import (
    make_mesh,
    make_sharded_train_step,
    shard_render,
    sharded_loss_grad,
)

from scenes_fixtures import cornell_box, cornell_camera

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

CFG = st.RenderConfig(width=32, height=32, max_bounces=2)


@pytest.fixture(scope="module")
def scene():
    return cornell_box(n_spheres=4).build()


@pytest.fixture(scope="module")
def cam():
    return cornell_camera()


class TestShardRender:
    def test_matches_single_device(self, scene, cam):
        mesh = make_mesh(8)
        img_s, depth_s = jax.jit(
            lambda s, c: shard_render(s, c, CFG, mesh)
        )(scene, cam)
        img_1, depth_1 = jax.jit(
            render_sample, static_argnums=2
        )(scene, cam, CFG)
        np.testing.assert_allclose(
            np.asarray(img_s), np.asarray(img_1), atol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(depth_s), np.asarray(depth_1), atol=1e-4
        )

    def test_uneven_mesh_sizes(self, scene, cam):
        mesh = make_mesh(4)
        img_s, _ = shard_render(scene, cam, CFG, mesh)
        img_1, _ = render_sample(scene, cam, CFG)
        np.testing.assert_allclose(
            np.asarray(img_s), np.asarray(img_1), atol=1e-6
        )

    def test_indivisible_raises(self, scene, cam):
        mesh = make_mesh(8)
        cfg = st.RenderConfig(width=33, height=31)
        with pytest.raises(ValueError):
            shard_render(scene, cam, cfg, mesh)


class TestShardedGrads:
    def test_matches_single_device_grads(self, scene, cam):
        mesh = make_mesh(8)
        target, _ = render_sample(scene, cam, CFG)
        target = target[..., :3] * 0.7

        loss_d, grads_d = jax.jit(
            lambda s, c, t: sharded_loss_grad(s, c, CFG, t, mesh)
        )(scene, cam, target)

        def loss_fn(params):
            img, _ = render_sample(scene.with_params(params), cam, CFG)
            err = img[..., :3] - target
            return jnp.mean(err * err)

        loss_1, grads_1 = jax.value_and_grad(loss_fn)(scene.params)
        assert np.allclose(float(loss_d), float(loss_1), rtol=1e-5)

        def check(path, a, b):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6,
                err_msg=str(path),
            )

        jax.tree_util.tree_map_with_path(check, grads_d, grads_1)

    def test_train_step_reduces_loss(self, scene, cam):
        mesh = make_mesh(8)
        target, _ = render_sample(scene, cam, CFG)
        target = target[..., :3]

        import optax

        params = dict(scene.params)
        params["albedo"] = params["albedo"] + 0.1
        # Albedo-only recovery (geometry grads are shading-only; see
        # test_gradients.TestInverseRendering).
        # NB optax.masked passes unmasked grads through verbatim (they
        # would be ADDED by apply_updates) — use multi_transform+zero.
        opt_inner = optax.multi_transform(
            {"adam": optax.adam(1e-2), "zero": optax.set_to_zero()},
            {k: "adam" if k == "albedo" else "zero" for k in params},
        )
        step, opt = make_sharded_train_step(
            scene, cam, CFG, mesh, opt_inner
        )
        state = opt.init(params)
        params, state, l0 = step(params, state, target)
        for _ in range(40):
            params, state, l1 = step(params, state, target)
        assert float(l1) < 0.5 * float(l0)


class TestHostChipMesh:
    def test_render_matches_single_device(self, scene, cam):
        from solstice.parallel import make_host_chip_mesh

        mesh = make_host_chip_mesh(n_hosts=2)  # 2 "hosts" x 4 "chips"
        assert mesh.axis_names == ("host", "chip")
        img_s, _ = jax.jit(
            lambda s, c: shard_render(s, c, CFG, mesh)
        )(scene, cam)
        img_1, _ = jax.jit(render_sample, static_argnums=2)(scene, cam, CFG)
        np.testing.assert_allclose(
            np.asarray(img_s), np.asarray(img_1), atol=1e-6
        )

    def test_grads_match_on_host_chip_mesh(self, scene, cam):
        from solstice.parallel import make_host_chip_mesh

        mesh = make_host_chip_mesh(n_hosts=2)
        target, _ = render_sample(scene, cam, CFG)
        target = target[..., :3] * 0.7
        loss_hc, grads_hc = sharded_loss_grad(scene, cam, CFG, target, mesh)
        loss_1d, grads_1d = sharded_loss_grad(
            scene, cam, CFG, target, make_mesh(8)
        )
        assert np.allclose(float(loss_hc), float(loss_1d), rtol=1e-6)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7
            ),
            grads_hc, grads_1d,
        )


class TestReduceScatter:
    def test_grads_match_psum(self, scene, cam):
        """North-star: reduce-scattered grads numerically equal the psum
        path (VERDICT round 1 item 4)."""
        mesh = make_mesh(8)
        target, _ = render_sample(scene, cam, CFG)
        target = target[..., :3] * 0.7
        _, g_ps = sharded_loss_grad(scene, cam, CFG, target, mesh, "psum")
        _, g_rs = sharded_loss_grad(
            scene, cam, CFG, target, mesh, "reduce_scatter"
        )
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-7
            ),
            g_ps, g_rs,
        )

    def test_zero_train_step_matches_psum(self, scene, cam):
        """ZeRO-1 sharded-optimizer step == replicated-optimizer step."""
        import optax

        from solstice.parallel import init_zero_opt_state

        mesh = make_mesh(8)
        target, _ = render_sample(scene, cam, CFG)
        target = target[..., :3]
        opt = optax.adam(1e-2)

        params_a = jax.tree.map(lambda x: x, scene.params)
        step_a, _ = make_sharded_train_step(
            scene, cam, CFG, mesh, opt, grad_reduce="psum"
        )
        state_a = opt.init(params_a)

        params_b = jax.tree.map(lambda x: x, scene.params)
        step_b, _ = make_sharded_train_step(
            scene, cam, CFG, mesh, opt, grad_reduce="reduce_scatter"
        )
        state_b = init_zero_opt_state(scene, opt, mesh)

        for _ in range(3):
            params_a, state_a, loss_a = step_a(params_a, state_a, target)
            params_b, state_b, loss_b = step_b(params_b, state_b, target)
        assert np.allclose(float(loss_a), float(loss_b), rtol=1e-5)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6
            ),
            params_a, params_b,
        )


class TestDistributedEntry:
    def test_single_process_noop(self):
        from solstice.parallel import initialize_distributed, process_info

        info = initialize_distributed()
        assert info["process_count"] == 1
        assert info == process_info()


class TestRingMode:
    """Geometry-sharded ring traversal (SURVEY §2.4 SP-analog stretch):
    shards rotate via ppermute while rays stay put; results must equal
    the replicated brute-force sweep exactly."""

    def test_matches_replicated(self):
        import numpy as np

        from scenes_fixtures import random_tri_field
        from solstice.ops import intersect as isect
        from solstice.parallel import ring_closest_hit
        from solstice.parallel.mesh import make_mesh

        scene = random_tri_field(500).build(bvh_threshold=10**9)
        mesh = make_mesh(8)
        rng = np.random.default_rng(0)
        o = jnp.asarray(rng.uniform(-2, 2, (512, 3)).astype(np.float32))
        o = o.at[:, 2].set(-20.0)
        d = rng.normal(size=(512, 3)).astype(np.float32)
        d[:, 2] = np.abs(d[:, 2]) * 6 + 2
        d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))

        t_r, i_r = jax.jit(
            lambda o, d: ring_closest_hit(scene, o, d, mesh)
        )(o, d)
        tm = isect.triangle_t(
            o, d, scene.triangles.v0, scene.triangles.v1,
            scene.triangles.v2, 1e-4,
        )
        t_ref = tm.min(axis=-1)
        i_ref = jnp.argmin(tm, axis=-1)
        hit = np.asarray(t_ref) < 1e30
        assert hit.sum() > 20
        np.testing.assert_allclose(
            np.asarray(t_r)[hit], np.asarray(t_ref)[hit], rtol=1e-6
        )
        np.testing.assert_array_equal(
            np.asarray(i_r)[hit], np.asarray(i_ref)[hit]
        )
