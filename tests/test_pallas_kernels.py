"""Triton strip-sweep kernels (solstice.ops.sweep_kernel) vs the XLA
block path, in interpret mode (SURVEY.md section 5: interpret mode is
the kernel "sanitizer"), plus the wrapper's padding, the lowering to
Triton IR and the choice of route.  The compiled kernels are checked
against the XLA path on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import solstice as st
from solstice.ops import packet as pk
from solstice.ops.camera import camera_rays
from solstice.ops.sweep_kernel import sweep_closest, sweep_transmittance

from scenes_fixtures import random_tri_field

CAM = st.Camera.create(position=(0, 0, -6.0), fov=1.0)
SB = 256  # 16x16 pixel tiles
KS = 8  # per-strip interval list width
KT = 48  # tile prefilter width


def _tile_rays(cfg=None):
    cfg = cfg or st.RenderConfig(width=64, height=64)
    o, d = camera_rays(CAM, cfg)
    perm, _ = pk.tile_permutation(64, 64, 16, 16)
    o_t = o[perm].reshape(-1, SB, 3).astype(jnp.float32)
    d_t = d[perm].reshape(-1, SB, 3).astype(jnp.float32)
    return o_t, d_t


def _select(accel, o_t, d_t, tm_t=None, live=None):
    if live is None:
        live = jnp.ones(o_t.shape[:2], bool)
    return pk.strip_interval_select(
        o_t, d_t, live, accel, KT, KS, 1e-4, tm_t=tm_t
    )


def _strips(a, g):
    """(S, SB, ...) tile arrays -> (S*G, SB/G, ...) strip rows."""
    return a.reshape((a.shape[0] * g, a.shape[1] // g) + a.shape[2:])


def _xla_closest(accel, o_t, d_t, cand, counts, prim="tri"):
    """XLA mirror at strip granularity (the plain route)."""
    s, g, k = cand.shape
    bt, bi = pk.tri_blocks_closest(
        accel.packed, _strips(o_t, g), _strips(d_t, g),
        cand.reshape(-1, k), counts.reshape(-1), 1e-4, prim=prim,
    )
    return bt.reshape(s, -1), bi.reshape(s, -1)


def _xla_trans(accel, o_t, d_t, tm_t, cand, counts, prim="tri"):
    s, g, k = cand.shape
    tr = pk.tri_blocks_transmittance(
        accel.packed, _strips(o_t, g), _strips(d_t, g), _strips(tm_t, g),
        cand.reshape(-1, k), counts.reshape(-1), 1e-4, prim=prim,
    )
    return tr.reshape(s, -1)


def _kernel_closest(accel, o_t, d_t, cand, counts, nearb, prim="tri",
                    t_cap=None, live=None, **kw):
    """Kernel at strip granularity, reshaped back to (S, SB)."""
    s, g, k = cand.shape
    if t_cap is None:
        t_cap = jnp.full(o_t.shape[:2], 1e30, jnp.float32)
    if live is None:
        live = jnp.ones(o_t.shape[:2], bool)
    t, i, nv = sweep_closest(
        accel.packed, _strips(o_t, g), _strips(d_t, g), _strips(t_cap, g),
        _strips(live, g), cand.reshape(-1, k), counts.reshape(-1),
        nearb.reshape(-1, k), 1e-4, prim=prim, interpret=True, **kw,
    )
    return t.reshape(s, -1), i.reshape(s, -1), nv.reshape(s, g)


def _kernel_trans(accel, o_t, d_t, tm_t, cand, counts, prim="tri",
                  live=None, **kw):
    s, g, k = cand.shape
    if live is None:
        live = jnp.ones(o_t.shape[:2], bool)
    tr, nv = sweep_transmittance(
        accel.packed, _strips(o_t, g), _strips(d_t, g), _strips(tm_t, g),
        _strips(live, g), cand.reshape(-1, k), counts.reshape(-1), 1e-4,
        prim=prim, interpret=True, **kw,
    )
    return tr.reshape(s, -1), nv.reshape(s, g)


@pytest.fixture(scope="module")
def setup():
    scene = random_tri_field(1200).build(bvh_threshold=64)
    accel = scene.tri_accel
    o_t, d_t = _tile_rays()
    cand, counts, nearb, dropped = _select(accel, o_t, d_t)
    return accel, o_t, d_t, cand, counts, nearb


class TestClosest:
    def test_matches_xla_strips(self, setup):
        accel, o_t, d_t, cand, counts, nearb = setup
        t_x, i_x = _xla_closest(accel, o_t, d_t, cand, counts)
        t_p, i_p, nv = _kernel_closest(accel, o_t, d_t, cand, counts,
                                       nearb)
        np.testing.assert_allclose(np.asarray(t_p), np.asarray(t_x),
                                   rtol=1e-6)
        hit = np.asarray(t_x) < 1e30
        np.testing.assert_array_equal(
            np.asarray(i_p)[hit], np.asarray(i_x)[hit]
        )
        # Early-out must never visit more than the strip list totals.
        assert (np.asarray(nv) <= np.asarray(counts)).all()

    def test_early_out_does_not_change_result(self, setup):
        """Early termination must be conservative: compare against a run
        where the entry bounds are all zero (no skipping possible)."""
        accel, o_t, d_t, cand, counts, nearb = setup
        t_e, _, nv_e = _kernel_closest(accel, o_t, d_t, cand, counts,
                                       nearb)
        t_n, _, nv_n = _kernel_closest(accel, o_t, d_t, cand, counts,
                                       jnp.zeros_like(nearb))
        np.testing.assert_allclose(np.asarray(t_e), np.asarray(t_n),
                                   rtol=1e-6)
        assert np.asarray(nv_e).sum() <= np.asarray(nv_n).sum()

    def test_early_out_skips_on_terrain(self):
        """On an all-hit front-to-back workload (terrain from above)
        the per-strip done bound must actually skip candidates."""
        import numpy as _np

        gw = 60
        xs = _np.linspace(-8, 8, gw + 1, dtype=_np.float32)
        zs = _np.linspace(2, 18, gw + 1, dtype=_np.float32)
        xg, zg = _np.meshgrid(xs, zs)
        yg = _np.sin(xg) * _np.cos(zg) - 2.0
        verts = _np.stack([xg, yg, zg], -1).reshape(-1, 3)
        idx = _np.arange((gw + 1) ** 2).reshape(gw + 1, gw + 1)
        faces = _np.concatenate([
            _np.stack([idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(),
                       idx[1:, 1:].ravel()], -1),
            _np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel(),
                       idx[1:, :-1].ravel()], -1),
        ])
        b = st.SceneBuilder()
        m = b.add_material(color=(0.5, 0.5, 0.5, 1.0))
        b.add_mesh(verts, faces, m)
        b.add_light((0, 5, 5))
        scene = b.build(bvh_threshold=64)
        accel = scene.tri_accel
        cam = st.Camera.create(position=(0.0, 8.0, 10.0),
                               angles=(1.35, 0.0, 0.0), fov=1.0)
        cfg = st.RenderConfig(width=64, height=64)
        o, d = camera_rays(cam, cfg)
        perm, _ = pk.tile_permutation(64, 64, 16, 16)
        o_t = o[perm].reshape(-1, SB, 3).astype(jnp.float32)
        d_t = d[perm].reshape(-1, SB, 3).astype(jnp.float32)
        cand, counts, nearb, _ = _select(accel, o_t, d_t)
        _, _, nv_e = _kernel_closest(accel, o_t, d_t, cand, counts, nearb)
        _, _, nv_n = _kernel_closest(accel, o_t, d_t, cand, counts,
                                     jnp.zeros_like(nearb))
        assert np.asarray(nv_e).sum() < np.asarray(nv_n).sum()

    def test_zero_count_strips_return_at_once(self, setup):
        """Parked tiles (live=0) select zero candidates; their strips
        visit nothing and report misses, and the strips that do have
        lists are unaffected by sharing the launch with them."""
        accel, o_t, d_t, cand, counts, nearb = setup
        live = jnp.zeros(o_t.shape[:2], bool).at[::2].set(True)
        cand_p, counts_p, nearb_p, _ = _select(accel, o_t, d_t, live=live)
        assert int(np.asarray(counts_p)[1::2].sum()) == 0
        t_p, i_p, nv = _kernel_closest(accel, o_t, d_t, cand_p, counts_p,
                                       nearb_p, live=live)
        assert int(np.asarray(nv)[1::2].sum()) == 0
        assert (np.asarray(i_p)[1::2] == -1).all()
        assert (np.asarray(t_p)[1::2] > 1e29).all()
        t_x, _ = _xla_closest(accel, o_t, d_t, cand_p, counts_p)
        np.testing.assert_allclose(np.asarray(t_p)[::2],
                                   np.asarray(t_x)[::2], rtol=1e-6)

    @pytest.mark.parametrize("sub", [16, 32])
    def test_column_chunks_invisible(self, setup, sub):
        """Sweeping a slab in narrower column chunks must not change t
        or the winning index (ties resolve to the lowest primitive)."""
        accel, o_t, d_t, cand, counts, nearb = setup
        t_1, i_1, _ = _kernel_closest(accel, o_t, d_t, cand, counts,
                                      nearb)
        t_c, i_c, _ = _kernel_closest(accel, o_t, d_t, cand, counts,
                                      nearb, sub=sub)
        np.testing.assert_array_equal(np.asarray(t_c), np.asarray(t_1))
        np.testing.assert_array_equal(np.asarray(i_c), np.asarray(i_1))

    def test_odd_strip_padded_to_pow2(self, setup):
        """A strip whose ray count is no power of two (odd tile shapes)
        is padded with parked rays inside the wrapper and cut back."""
        accel, o_t, d_t, *_ = setup
        o_3 = o_t[:, :48].reshape(-1, 48, 3)  # one 48-ray strip per tile
        d_3 = d_t[:, :48].reshape(-1, 48, 3)
        cand, counts, nearb, _ = _select(accel, o_3, d_3)
        assert cand.shape[1] == 1
        t_x, i_x = _xla_closest(accel, o_3, d_3, cand, counts)
        t_p, i_p, _ = _kernel_closest(accel, o_3, d_3, cand, counts, nearb)
        assert t_p.shape == t_x.shape == (o_3.shape[0], 48)
        np.testing.assert_allclose(np.asarray(t_p), np.asarray(t_x),
                                   rtol=1e-6)
        hit = np.asarray(t_x) < 1e30
        np.testing.assert_array_equal(
            np.asarray(i_p)[hit], np.asarray(i_x)[hit]
        )

    def test_strip_lists_conservative(self, setup):
        """Exactness of selection: the strip sweep over the per-strip
        interval lists must find the same closest hit as sweeping ALL
        blocks (the lists may only drop blocks a strip ray cannot
        hit, or certify the drop)."""
        accel, o_t, d_t, cand, counts, nearb = setup
        nb = accel.packed.shape[0]
        s = o_t.shape[0]
        allcand = jnp.broadcast_to(
            jnp.arange(nb, dtype=jnp.int32)[None], (s, nb)
        )
        allcounts = jnp.full((s,), nb, jnp.int32)
        t_all, i_all = pk.tri_blocks_closest(
            accel.packed, o_t, d_t, allcand, allcounts, 1e-4
        )
        t_sel, i_sel = _xla_closest(accel, o_t, d_t, cand, counts)
        # dropped certificate is +FAR on this small scene: exact.
        _, _, _, dropped = _select(accel, o_t, d_t)
        assert (np.asarray(dropped) > 1e29).all()
        np.testing.assert_allclose(np.asarray(t_sel), np.asarray(t_all),
                                   rtol=1e-6)
        hit = np.asarray(t_all) < 1e30
        np.testing.assert_array_equal(
            np.asarray(i_sel)[hit], np.asarray(i_all)[hit]
        )


class TestSelection:
    def test_lists_sorted_and_unique(self, setup):
        accel, o_t, d_t, cand, counts, nearb = setup
        c = np.asarray(counts)
        cand_np = np.asarray(cand)
        nb_np = np.asarray(nearb)
        s, g, k = cand_np.shape
        for si in range(0, s, 5):
            for j in range(g):
                n = int(c[si, j])
                v = cand_np[si, j, :n]
                # Distinct (transmittance multiplies per occurrence —
                # duplicates would double-attenuate).
                assert len(np.unique(v)) == len(v)
                # Entry bounds ascending (front-to-back early-out
                # contract) and +FAR past the count.
                assert (np.diff(nb_np[si, j, :n]) >= -1e-6).all()
                assert (nb_np[si, j, n:] > 1e29).all()

    def test_shadow_lists_clip_at_light(self):
        """A block strictly beyond every ray's light distance must not
        appear in the shadow lists."""
        scene = random_tri_field(800).build(bvh_threshold=64)
        accel = scene.tri_accel
        o_t, d_t = _tile_rays()
        tm_t = jnp.full(o_t.shape[:2], 0.5, jnp.float32)  # very short
        cand, counts, _, _ = _select(accel, o_t, d_t, tm_t=tm_t)
        cand_far, counts_far, _, _ = _select(
            accel, o_t, d_t, tm_t=jnp.full(o_t.shape[:2], 1e4,
                                           jnp.float32)
        )
        assert np.asarray(counts).sum() < np.asarray(counts_far).sum()


class TestSphereSweep:
    """Sphere-pool sweep (PDB molecule path) vs the XLA block path."""

    @pytest.fixture(scope="class")
    def sph_setup(self):
        from scenes_fixtures import random_sphere_field

        scene = random_sphere_field(900).build(bvh_threshold=64)
        accel = scene.sph_accel
        assert accel is not None
        o_t, d_t = _tile_rays()
        cand, counts, nearb, _ = _select(accel, o_t, d_t)
        return accel, o_t, d_t, cand, counts, nearb

    def test_closest_matches_xla(self, sph_setup):
        accel, o_t, d_t, cand, counts, nearb = sph_setup
        t_x, i_x = _xla_closest(accel, o_t, d_t, cand, counts,
                                prim="sphere")
        t_p, i_p, _ = _kernel_closest(accel, o_t, d_t, cand, counts,
                                      nearb, prim="sphere")
        t_x, t_p = np.asarray(t_x), np.asarray(t_p)
        hit = t_x < 1e30
        assert hit.any()
        np.testing.assert_allclose(t_p[hit], t_x[hit], rtol=1e-6)
        np.testing.assert_array_equal(
            np.asarray(i_p)[hit], np.asarray(i_x)[hit]
        )

    def test_transmittance_matches_xla(self, sph_setup):
        accel, o_t, d_t, cand, counts, nearb = sph_setup
        t_max = jnp.full(o_t.shape[:2], 40.0, jnp.float32)
        tr_x = _xla_trans(accel, o_t, d_t, t_max, cand, counts,
                          prim="sphere")
        tr_p, _ = _kernel_trans(accel, o_t, d_t, t_max, cand, counts,
                                prim="sphere")
        np.testing.assert_allclose(np.asarray(tr_p), np.asarray(tr_x),
                                   atol=1e-6)

    def test_sphere_blocks_match_bruteforce(self, sph_setup):
        """The sphere block test (XLA form) vs isect.sphere_t over every
        sphere — pins the packed layout + intersection math."""
        from solstice.ops import intersect as isect
        from scenes_fixtures import random_sphere_field

        scene = random_sphere_field(900).build(bvh_threshold=64)
        accel, o_t, d_t, _c, _n, _nb = sph_setup
        nb = accel.packed.shape[0]
        allcand = jnp.broadcast_to(
            jnp.arange(nb, dtype=jnp.int32)[None], (o_t.shape[0], nb)
        )
        counts = jnp.full((o_t.shape[0],), nb, jnp.int32)
        t_blk, i_blk = pk.tri_blocks_closest(
            accel.packed, o_t, d_t, allcand, counts, 1e-4, prim="sphere"
        )
        o_f = o_t.reshape(-1, 3)
        d_f = d_t.reshape(-1, 3)
        t_ref = isect.sphere_t(
            o_f, d_f, scene.spheres.center, scene.spheres.radius, 1e-4
        ).min(axis=-1)
        # rtol 5e-4: f32 accumulation-order noise between the block
        # form and isect.sphere_t; hit SELECTION is what matters (the
        # renderer recomputes exact t for the winner — traverse.
        # _recompute_t).
        np.testing.assert_allclose(
            np.asarray(t_blk).reshape(-1), np.asarray(t_ref), rtol=5e-4
        )


class TestTransmittance:
    def test_matches_xla_strips(self, setup):
        accel, o_t, d_t, *_ = setup
        t_max = jnp.full(o_t.shape[:2], 50.0, jnp.float32)
        cand, counts, nearb, _ = _select(accel, o_t, d_t, tm_t=t_max)
        tr_x = _xla_trans(accel, o_t, d_t, t_max, cand, counts)
        tr_p, _ = _kernel_trans(accel, o_t, d_t, t_max, cand, counts)
        np.testing.assert_allclose(np.asarray(tr_p), np.asarray(tr_x),
                                   rtol=1e-6)

    def test_extinguished_strips_stop(self, setup):
        """Fully-occluded strips must stop visiting candidates (lit
        early-out) without changing the result."""
        accel, o_t, d_t, *_ = setup
        t_max = jnp.full(o_t.shape[:2], 50.0, jnp.float32)
        cand, counts, nearb, _ = _select(accel, o_t, d_t, tm_t=t_max)
        tr, nv = _kernel_trans(accel, o_t, d_t, t_max, cand, counts)
        # On an opaque random field many strips extinguish early.
        assert np.asarray(nv).sum() <= np.asarray(counts).sum()


class TestCylinderSweep:
    """Cylinder-pool sweep (PDB sticks / SWC neurite path): kernel vs
    XLA block path vs per-cylinder brute force."""

    @pytest.fixture(scope="class")
    def cyl_setup(self):
        from scenes_fixtures import random_cylinder_field

        scene = random_cylinder_field(700).build(bvh_threshold=64)
        accel = scene.cyl_accel
        assert accel is not None
        o_t, d_t = _tile_rays()
        cand, counts, nearb, _ = _select(accel, o_t, d_t)
        return scene, accel, o_t, d_t, cand, counts, nearb

    def test_closest_matches_xla(self, cyl_setup):
        scene, accel, o_t, d_t, cand, counts, nearb = cyl_setup
        t_x, i_x = _xla_closest(accel, o_t, d_t, cand, counts,
                                prim="cyl")
        t_p, i_p, _ = _kernel_closest(accel, o_t, d_t, cand, counts,
                                      nearb, prim="cyl")
        t_x, t_p = np.asarray(t_x), np.asarray(t_p)
        hit = t_x < 1e30
        assert hit.any()
        np.testing.assert_allclose(t_p[hit], t_x[hit], rtol=1e-6)
        np.testing.assert_array_equal(
            np.asarray(i_p)[hit], np.asarray(i_x)[hit]
        )

    def test_blocks_match_bruteforce(self, cyl_setup):
        """All-candidate block sweep vs isect.cylinder_t over the whole
        pool — pins the packed layout + capped-cylinder math."""
        from solstice.ops import intersect as isect

        scene, accel, o_t, d_t, _c, _n, _nb = cyl_setup
        nb = accel.packed.shape[0]
        allcand = jnp.broadcast_to(
            jnp.arange(nb, dtype=jnp.int32)[None], (o_t.shape[0], nb)
        )
        counts = jnp.full((o_t.shape[0],), nb, jnp.int32)
        t_blk, _ = pk.tri_blocks_closest(
            accel.packed, o_t, d_t, allcand, counts, 1e-4, prim="cyl"
        )
        o_f = o_t.reshape(-1, 3)
        d_f = d_t.reshape(-1, 3)
        t_ref = isect.cylinder_t(
            o_f, d_f, scene.cylinders.p0, scene.cylinders.p1,
            scene.cylinders.radius, 1e-4,
        ).min(axis=-1)
        t_blk = np.asarray(t_blk).reshape(-1)
        t_ref = np.asarray(t_ref)
        # Grazing rays can flip hit/miss between the two f32 evaluation
        # orders (disc ~ 0); require > 99.9% agreement and tight t
        # equality on agreeing hits.
        hit_b = t_blk < 1e30
        hit_r = t_ref < 1e30
        assert (hit_b == hit_r).mean() > 0.999
        both = hit_b & hit_r
        np.testing.assert_allclose(t_blk[both], t_ref[both], rtol=5e-4)

    def test_transmittance_matches_xla(self, cyl_setup):
        scene, accel, o_t, d_t, *_ = cyl_setup
        t_max = jnp.full(o_t.shape[:2], 40.0, jnp.float32)
        cand, counts, nearb, _ = _select(accel, o_t, d_t, tm_t=t_max)
        tr_x = _xla_trans(accel, o_t, d_t, t_max, cand, counts,
                          prim="cyl")
        tr_p, _ = _kernel_trans(accel, o_t, d_t, t_max, cand, counts,
                                prim="cyl")
        np.testing.assert_allclose(np.asarray(tr_p), np.asarray(tr_x),
                                   atol=1e-6)

    def test_render_uses_cyl_packet(self):
        """End-to-end: a big cylinder field renders identically with the
        packet path and the reference-semantics while walk."""
        from scenes_fixtures import random_cylinder_field

        scene = random_cylinder_field(300).build(bvh_threshold=64)
        cfg_p = st.RenderConfig(width=32, height=32, max_bounces=2,
                                traversal="packet", packet_tile_w=16,
                                packet_tile_h=16)
        cfg_w = st.RenderConfig(width=32, height=32, max_bounces=2,
                                traversal="while")
        from solstice.ops.render import render_sample

        img_p, _ = render_sample(scene, CAM, cfg_p)
        img_w, _ = render_sample(scene, CAM, cfg_w)
        np.testing.assert_allclose(np.asarray(img_p), np.asarray(img_w),
                                   atol=1e-6)


class TestRoute:
    """RenderConfig.backend picks the strip-sweep route explicitly; the
    kernel is never reached by a silent fallback."""

    @pytest.mark.parametrize("backend,route", [
        ("auto", "xla"), ("xla", "xla"), ("interpret", "interpret"),
    ])
    def test_route_on_cpu(self, backend, route):
        cfg = st.RenderConfig(width=32, height=32, backend=backend)
        assert cfg.sweep_route() == route
        assert cfg.packet_spec()[-1] == route

    @pytest.mark.parametrize("backend", ["triton", "pallas", "jnp"])
    def test_kernel_or_unknown_route_raises_on_cpu(self, backend):
        cfg = st.RenderConfig(width=32, height=32, backend=backend)
        with pytest.raises(ValueError):
            cfg.sweep_route()


class TestWrapper:
    def test_non_pow2_block_raises(self):
        """The kernel's column chunks need a power-of-two BLOCK."""
        n, ssb = 2, 32
        packed = jnp.zeros((1, 16, 384), jnp.float32)
        o = jnp.zeros((n, ssb, 3), jnp.float32)
        t = jnp.ones((n, ssb), jnp.float32)
        live = jnp.ones((n, ssb), bool)
        cand = jnp.zeros((n, 4), jnp.int32)
        counts = jnp.zeros((n,), jnp.int32)
        with pytest.raises(ValueError, match="power-of-two"):
            sweep_closest(packed, o, o, t, live, cand, counts, t[:, :4],
                          1e-4, interpret=True)


class TestLowering:
    """Each kernel lowers to Triton IR for CUDA from the CPU (the
    GPU's compiler itself only runs on the card)."""

    @pytest.mark.parametrize("prim", ["tri", "sphere", "cyl"])
    @pytest.mark.parametrize("closest", [True, False])
    def test_lowers_for_cuda(self, prim, closest):
        import jax.export

        n, ssb, k, nb = 4, 32, 8, 3
        packed = jnp.zeros((nb, 16, pk.BLOCK), jnp.float32)
        o = jnp.zeros((n, ssb, 3), jnp.float32)
        t = jnp.ones((n, ssb), jnp.float32)
        live = jnp.ones((n, ssb), bool)
        cand = jnp.zeros((n, k), jnp.int32)
        counts = jnp.zeros((n,), jnp.int32)
        if closest:
            fn = lambda *a: sweep_closest(*a, 1e-4, prim=prim)
            args = (packed, o, o, t, live, cand, counts, t[:, :k])
        else:
            fn = lambda *a: sweep_transmittance(*a, 1e-4, prim=prim)
            args = (packed, o, o, t, live, cand, counts)
        exp = jax.export.export(
            jax.jit(fn), platforms=["cuda"],
            disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
                "__gpu$xla.gpu.triton")],
        )(*args)
        assert "__gpu$xla.gpu.triton" in exp.mlir_module()


@pytest.mark.gpu
class TestOnCard:
    """The compiled kernels against the XLA route on the card, at the
    small test sizes (chip_smoke.py runs the headline widths)."""

    @pytest.mark.parametrize("prim", ["tri", "sphere", "cyl"])
    def test_compiled_matches_xla(self, gpu, prim):
        from scenes_fixtures import (random_cylinder_field,
                                     random_sphere_field)

        field = {"tri": random_tri_field, "sphere": random_sphere_field,
                 "cyl": random_cylinder_field}[prim]
        scene = field(900).build(bvh_threshold=64)
        accel = {"tri": scene.tri_accel, "sphere": scene.sph_accel,
                 "cyl": scene.cyl_accel}[prim]
        o_t, d_t = _tile_rays()
        cand, counts, nearb, _ = _select(accel, o_t, d_t)
        s, g, k = cand.shape
        t_p, i_p, _ = jax.jit(
            lambda *a: sweep_closest(*a, 1e-4, prim=prim)
        )(accel.packed, _strips(o_t, g), _strips(d_t, g),
          jnp.full((s * g, SB // g), 1e30, jnp.float32),
          jnp.ones((s * g, SB // g), bool), cand.reshape(-1, k),
          counts.reshape(-1), nearb.reshape(-1, k))
        t_x, i_x = _xla_closest(accel, o_t, d_t, cand, counts, prim=prim)
        t_x = np.asarray(t_x).reshape(-1)
        t_p = np.asarray(t_p).reshape(-1)
        hit = t_x < 1e30
        # FMA contraction differs between the two compilers.
        np.testing.assert_allclose(t_p[hit], t_x[hit], rtol=1e-5)
