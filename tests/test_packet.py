"""Packet (tile-frustum) traversal correctness: must agree exactly with
the per-ray while_loop walk and the brute-force sweep (the candidate
cull is conservative and capped; the exactness net walks any ray whose
candidate drop is not provably safe, so identical hits are required,
not just close).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import solstice as st
from solstice.oracle.cpu_tracer import oracle_render
from solstice.ops import packet as pk
from solstice.ops.render import render_sample

from scenes_fixtures import random_tri_field


def _render(scene, cam, cfg):
    img, t = jax.jit(render_sample, static_argnums=2)(scene, cam, cfg)
    return np.asarray(img), np.asarray(t)


@pytest.fixture(scope="module")
def tri_scene():
    return random_tri_field(1500).build(bvh_threshold=64)


def _terrain_scene(gw=125):
    """Heightfield of ~2*gw^2 tris (the bench archetype, small)."""
    xs = np.linspace(-8, 8, gw + 1, dtype=np.float32)
    zs = np.linspace(2, 18, gw + 1, dtype=np.float32)
    xg, zg = np.meshgrid(xs, zs)
    yg = np.sin(xg) * np.cos(zg) - 2.0
    verts = np.stack([xg, yg, zg], -1).reshape(-1, 3)
    idx = np.arange((gw + 1) ** 2).reshape(gw + 1, gw + 1)
    q00, q10 = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    q01, q11 = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([
        np.stack([q00, q10, q11], -1), np.stack([q00, q11, q01], -1)
    ])
    b = st.SceneBuilder()
    m = b.add_material(color=(0.5, 0.5, 0.5, 1.0))
    b.add_mesh(verts, faces, m)
    b.add_light((0, 5, 5))
    return b.build(bvh_threshold=64)


CAM = st.Camera.create(position=(0, 0, -6.0), fov=1.0)


class TestTilePermutation:
    def test_roundtrip(self):
        perm, inv = pk.tile_permutation(64, 32, 16, 8)
        x = np.arange(64 * 32)
        assert (x[perm][inv] == x).all()

    def test_tiles_are_blocks(self):
        perm, _ = pk.tile_permutation(64, 64, 32, 32)
        first_tile = perm[: 32 * 32]
        rows = first_tile // 64
        cols = first_tile % 64
        assert rows.max() < 32 and cols.max() < 32


class TestPacketMatchesWhile:
    @pytest.mark.parametrize("bounces", [1, 3])
    def test_exact_match(self, tri_scene, bounces):
        base = dict(width=64, height=64, max_bounces=bounces)
        cfg_p = st.RenderConfig(
            **base, traversal="packet", packet_tile_w=16, packet_tile_h=16
        )
        cfg_w = st.RenderConfig(**base, traversal="while")
        img_p, t_p = _render(tri_scene, CAM, cfg_p)
        img_w, t_w = _render(tri_scene, CAM, cfg_w)
        np.testing.assert_allclose(img_p, img_w, atol=1e-6)
        np.testing.assert_allclose(t_p, t_w, rtol=1e-6)

    def test_exact_even_with_tiny_caps(self, tri_scene):
        """Force candidate drops (caps of 2) — the exactness net must
        re-walk exactly the affected rays, keeping the render identical
        to the while-loop walk."""
        base = dict(width=64, height=64, max_bounces=2)
        cfg_p = st.RenderConfig(
            **base, traversal="packet", packet_tile_w=16, packet_tile_h=16,
            packet_max_blocks=2, packet_tile_cand=4,
        )
        cfg_w = st.RenderConfig(**base, traversal="while")
        img_p, t_p = _render(tri_scene, CAM, cfg_p)
        img_w, t_w = _render(tri_scene, CAM, cfg_w)
        np.testing.assert_allclose(img_p, img_w, atol=1e-6)
        np.testing.assert_allclose(t_p, t_w, rtol=1e-6)

    def test_vs_oracle(self, tri_scene):
        cfg = st.RenderConfig(width=32, height=32, max_bounces=2,
                              traversal="packet", packet_tile_w=16,
                              packet_tile_h=16)
        img, _ = _render(tri_scene, CAM, cfg)
        ref = np.asarray(oracle_render(tri_scene, CAM, cfg))
        err = np.abs(img[..., :3] - ref[..., :3]).max(axis=-1)
        inlier = err <= 2e-2
        assert (1 - inlier.mean()) < 0.01
        assert err[inlier].mean() < 2e-3

    def test_gradients_through_packet(self, tri_scene):
        cfg = st.RenderConfig(width=32, height=32, max_bounces=2,
                              traversal="packet", packet_tile_w=16,
                              packet_tile_h=16)

        def loss(params):
            img, _ = render_sample(tri_scene.with_params(params), CAM, cfg)
            return jnp.mean(img[..., :3] ** 2)

        g = jax.jit(jax.grad(loss))(tri_scene.params)
        for leaf in jax.tree_util.tree_leaves(g):
            assert np.isfinite(np.asarray(leaf)).all()
        assert sum(float(np.abs(np.asarray(x)).sum())
                   for x in g["vertices"]) > 0


class TestStripIntervalSelect:
    def _bundle_setup(self, scene, cam, cfg):
        from solstice.ops.camera import camera_rays

        o, d = camera_rays(cam, cfg)
        perm, _ = pk.tile_permutation(
            cfg.width, cfg.height, cfg.packet_tile_w, cfg.packet_tile_h
        )
        sb = cfg.packet_rays
        return o[perm].reshape(-1, sb, 3), d[perm].reshape(-1, sb, 3)

    def test_terrain_selection_tight_and_complete(self):
        scene = _terrain_scene()
        accel = scene.tri_accel
        assert accel is not None
        cfg = st.RenderConfig(width=64, height=64, packet_tile_w=16,
                              packet_tile_h=16)
        cam = st.Camera.create(position=(0.0, 8.0, 10.0),
                               angles=(1.35, 0.0, 0.0), fov=1.0)
        o_t, d_t = self._bundle_setup(scene, cam, cfg)
        live = jnp.ones(o_t.shape[:2], bool)
        cand, counts, nearb, dropped = pk.strip_interval_select(
            o_t, d_t, live, accel, cfg.packet_tile_cand,
            cfg.packet_max_blocks, 1e-4,
        )
        c = np.asarray(counts)
        n_blocks = accel.packed.shape[0]
        assert c.max() <= cfg.packet_max_blocks
        # Tight: per-strip interval lists of a top-down view touch a
        # small fraction of the block list.
        assert c.mean() < 0.2 * n_blocks
        # Nothing dropped at default widths on this scene: the
        # exactness certificate stays +FAR.
        assert (np.asarray(dropped) > 1e29).all()
        # Valid candidates are distinct (transmittance multiplies per
        # occurrence — duplicates would double-attenuate) and entry
        # bounds ascend (front-to-back early-out contract).
        cand_np = np.asarray(cand)
        nb_np = np.asarray(nearb)
        for s in range(0, cand_np.shape[0], 7):
            for j in range(cand_np.shape[1]):
                v = cand_np[s, j, : c[s, j]]
                assert len(np.unique(v)) == len(v)
                assert (np.diff(nb_np[s, j, : c[s, j]]) >= -1e-6).all()

    def test_selection_covers_every_ray_hit(self):
        """Per-ray slab coverage: every block a ray's slab interval
        hits must appear in its strip's list (or be certified
        dropped).  Brute-check on a small terrain."""
        scene = _terrain_scene(40)
        accel = scene.tri_accel
        cfg = st.RenderConfig(width=32, height=32, packet_tile_w=16,
                              packet_tile_h=16)
        cam = st.Camera.create(position=(0.0, 6.0, 8.0),
                               angles=(1.2, 0.0, 0.0), fov=1.0)
        o_t, d_t = self._bundle_setup(scene, cam, cfg)
        live = jnp.ones(o_t.shape[:2], bool)
        cand, counts, nearb, dropped = pk.strip_interval_select(
            o_t, d_t, live, accel, 256, 64, 1e-4,
        )
        assert (np.asarray(dropped) > 1e29).all()
        from solstice.ops.traverse import _ray_block_slabs

        s, sb, _ = o_t.shape
        g = cand.shape[1]
        strip = sb // g
        entry, hitm = _ray_block_slabs(
            o_t.reshape(-1, 3), d_t.reshape(-1, 3),
            accel.block_bounds, 1e-4,
        )
        hitm = np.asarray(hitm).reshape(s, g, strip, -1)
        cand_np = np.asarray(cand)
        c = np.asarray(counts)
        for si in range(0, s, 3):
            for j in range(g):
                needed = set(np.nonzero(hitm[si, j].any(0))[0])
                listed = set(cand_np[si, j, : c[si, j]])
                assert needed <= listed

    def test_drop_certificate_is_per_ray(self):
        """A tiny tile prefilter forces drops; rays whose slab MISSES
        the dropped set's AABB must stay proven (+FAR certificate)
        while rays heading into it must not.  (Round-5 fix: the old
        tile-level distance bound marked every far-travelling ray
        unproven, and bounce-1 sky reflections all fell into the union
        net — PERF.md.)"""
        scene = _terrain_scene(40)
        accel = scene.tri_accel
        n_blocks = int(accel.packed.shape[0])
        assert n_blocks > 4
        # Origin above the terrain; half the rays look down (into
        # geometry), half look up (sky).
        n = 256
        o = np.tile(np.array([[0.0, 3.0, 10.0]], np.float32), (n, 1))
        d = np.zeros((n, 3), np.float32)
        d[: n // 2] = [0.0, -1.0, 0.2]
        d[n // 2 :] = [0.0, 1.0, 0.2]
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o_t = jnp.asarray(o)[None]
        d_t = jnp.asarray(d)[None]
        live = jnp.ones((1, n), bool)
        cand, counts, nearb, dropped = pk.strip_interval_select(
            o_t, d_t, live, accel, kt=2, ks=2, t_min=1e-4
        )
        dropped = np.asarray(dropped)[0]
        # Down rays head into the dropped terrain blocks: finite bound.
        assert (dropped[: n // 2] < 1e29).all()
        # Up rays provably miss every dropped block: certificate +FAR.
        assert (dropped[n // 2 :] > 1e29).all()

    def test_chunked_selection_identical(self, monkeypatch):
        """The lax.map tile chunking (the 1080p memory guard) must be
        invisible in the selection outputs."""
        scene = _terrain_scene(40)
        accel = scene.tri_accel
        cfg = st.RenderConfig(width=64, height=64, packet_tile_w=16,
                              packet_tile_h=16)
        cam = st.Camera.create(position=(0.0, 6.0, 8.0),
                               angles=(1.2, 0.0, 0.0), fov=1.0)
        o_t, d_t = self._bundle_setup(scene, cam, cfg)
        live = jnp.ones(o_t.shape[:2], bool)
        full = pk.strip_interval_select(
            o_t, d_t, live, accel, 64, 16, 1e-4
        )
        monkeypatch.setattr(pk, "_SEL_CHUNK", 3)  # force pad + chunks
        ch = pk.strip_interval_select(
            o_t, d_t, live, accel, 64, 16, 1e-4
        )
        for a, b in zip(full, ch):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_parked_rays_cull_to_nothing(self):
        scene = _terrain_scene(40)
        accel = scene.tri_accel
        from solstice.constants import PARK_DIR, PARK_POS

        o_t = jnp.full((2, 256, 3), PARK_POS, jnp.float32)
        d_t = jnp.full((2, 256, 3), PARK_DIR, jnp.float32)
        live = o_t[..., 0] < 1.0e7
        cand, counts, nearb, dropped = pk.strip_interval_select(
            o_t, d_t, live, accel, 64, 16, 1e-4,
        )
        assert int(np.asarray(counts).sum()) == 0
        assert (np.asarray(dropped) > 1e29).all()

    def test_capsule_cull_conservative(self, rng):
        """Every block a real shadow segment passes through must survive
        the capsule cull."""
        scene = _terrain_scene(40)
        accel = scene.tri_accel
        n = 64
        o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
        o[:, 1] = -2.0  # on the terrain
        light = np.array([0.0, 5.0, 5.0], np.float32)
        d = light[None] - o
        dist = np.linalg.norm(d, axis=1)
        d = d / dist[:, None]
        o_t = jnp.asarray(o)[None]
        d_t = jnp.asarray(d)[None]
        tm_t = jnp.asarray(dist)[None]
        po, ro, pa, ra = pk.capsule_bundles(o_t, d_t, tm_t)
        mask, _ = pk.cull_capsule(
            po, ro, pa, ra,
            accel.block_bounds[:, 0:3], accel.block_bounds[:, 3:6],
        )
        mask = np.asarray(mask)[0]
        # Reference: brute-force segment-vs-block-AABB overlap.
        sbc = np.asarray(accel.block_bounds[:, 0:3])
        sbh = np.asarray(accel.block_bounds[:, 3:6])
        for i in range(n):
            ts = np.linspace(0, dist[i], 64)
            pts = o[i][None] + ts[:, None] * d[i][None]
            inside = (
                np.abs(pts[:, None, :] - sbc[None]) <= sbh[None] + 1e-4
            ).all(-1)  # (64, NSB)
            touched = inside.any(0)
            assert not (touched & ~mask).any(), "capsule cull dropped a hit"


class TestFullPathInterpret:
    """The COMPLETE packet path (strip-interval sweep + exactness nets)
    through the real kernels in interpret mode — CPU coverage of the
    code path the GPU executes (XLA-route-only CPU coverage once let
    kernel-path bugs ship).  RenderConfig.backend="interpret" routes
    the strip sweeps onto the kernels."""

    def _render(self, scene, cfg, backend):
        import dataclasses

        from solstice.ops.render import render_sample

        cfg = dataclasses.replace(cfg, backend=backend)
        img, t = render_sample(scene, CAM, cfg)
        return np.asarray(img), np.asarray(t)

    def test_kernel_path_matches_xla_path(self, tri_scene):
        cfg = st.RenderConfig(
            width=32, height=32, max_bounces=2, traversal="packet",
            packet_tile_w=16, packet_tile_h=16,
            # Tiny widths force certified drops AND the exactness net
            # through the kernels.
            packet_max_blocks=4, packet_tile_cand=8,
        )
        img_k, t_k = self._render(tri_scene, cfg, "interpret")
        img_x, t_x = self._render(tri_scene, cfg, "xla")
        np.testing.assert_allclose(img_k, img_x, atol=1e-5)
        np.testing.assert_allclose(t_k, t_x, rtol=1e-5)


class TestUnionNetOverflow:
    """The union-block net's overflow fallback (pool brute) must
    preserve exactness: force it by shrinking the union width to 2."""

    def test_tiny_ucap_still_exact(self, tri_scene, monkeypatch):
        from solstice.ops import traverse as tv

        cfg_p = st.RenderConfig(
            width=32, height=32, max_bounces=2, traversal="packet",
            packet_tile_w=16, packet_tile_h=16,
            packet_max_blocks=2, packet_tile_cand=4,  # tiny: nets engage
        )
        cfg_w = st.RenderConfig(width=32, height=32, max_bounces=2,
                                traversal="while")
        img_w, _ = _render(tri_scene, CAM, cfg_w)
        monkeypatch.setattr(tv, "_NET_UCAP", 2)  # force overflow
        img_p, _ = _render(tri_scene, CAM, cfg_p)
        np.testing.assert_allclose(img_p, img_w, atol=1e-6)
