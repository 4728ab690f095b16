"""Scene-level closest-hit and occlusion queries.

Re-creation of the reference's traversal entry point
(solr/engines/cuda/GeometryIntersections.cuh: intersectionWithPrimitives
— the hottest loop: walk boxes by skip index, test primitives, keep the
closest hit) and of the shadow-ray query used by processShadows
(GeometryShaders.cuh).

Redesign: instead of one divergent per-thread loop over a type-tagged
primitive array, the scene is split into typed pools.  Each pool is
intersected with a single vectorized kernel — either a chunked
brute-force sweep (correctness baseline, small scenes) or a BVH walk
(solstice.ops.bvh / solstice.ops.pallas) — and the closest hit is
selected across pools with pure array ops.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from solstice.constants import RAY_EPS, T_FAR
from solstice.ops import intersect as isect
from solstice.ops.vecmath import cross, dot, normalize, spherical_uv
from solstice.types import Scene, pytree_dataclass

__all__ = [
    "Hit",
    "SurfaceInfo",
    "POOL_SPHERE",
    "POOL_TRIANGLE",
    "POOL_CYLINDER",
    "POOL_ELLIPSOID",
    "POOL_PLANE",
    "scene_closest_hit",
    "scene_transmittance",
    "surface_at",
]

POOL_SPHERE = 0
POOL_TRIANGLE = 1
POOL_CYLINDER = 2
POOL_ELLIPSOID = 3
POOL_PLANE = 4

# Primitive chunk for brute-force sweeps (bounds the (R, C, 3) broadcast
# intermediates).
_PRIM_CHUNK = 512


@pytree_dataclass
class Hit:
    """Closest-hit record (reference: the out-params of
    intersectionWithPrimitives — closestIntersection, closestPrimitiveId)."""

    t: Any  # (R,) distance, T_FAR on miss
    pool: Any  # (R,) int32 pool code
    idx: Any  # (R,) int32 index within the pool

    @property
    def valid(self):
        return self.t < T_FAR * 0.5


@pytree_dataclass
class SurfaceInfo:
    """Shading inputs at a hit point (reference: the intersection point /
    normal / UV produced by the per-primitive intersectors and consumed by
    primitiveShader)."""

    point: Any  # (R,3)
    normal: Any  # (R,3) geometric normal, flipped to oppose the ray
    shading_normal: Any  # (R,3) interpolated normal, opposing the ray
    uv: Any  # (R,2)
    material: Any  # (R,) int32
    backface: Any  # (R,) bool — ray exited the surface (inside hit)
    valid: Any  # (R,) bool


def _chunked_min(t_fn, n: int, r_shape, dtype):
    """Scan primitive chunks, folding a running (best_t, best_idx).

    ``t_fn(start)`` must return the (R, C) t-matrix for the chunk at
    ``start``.  ``n`` may be ANY size: the final partial chunk's start
    is clamped to ``n - chunk`` so the slice stays in range, and the
    SAME clamped start is the index base — re-testing the overlap rows
    is idempotent under min, and indices stay correct (ADVICE r03
    high #2: the unclamped base shifted last-chunk hit indices).
    """
    chunk = min(_PRIM_CHUNK, n)
    n_chunks = (n + chunk - 1) // chunk

    def body(carry, ci):
        best_t, best_i = carry
        start = jnp.minimum(ci * chunk, n - chunk)
        t = t_fn(start, chunk)  # (R, C)
        c_min = jnp.min(t, axis=-1)
        c_arg = jnp.argmin(t, axis=-1).astype(jnp.int32) + start
        better = c_min < best_t
        return (
            jnp.where(better, c_min, best_t),
            jnp.where(better, c_arg, best_i),
        ), None

    init = (
        jnp.full(r_shape, T_FAR, dtype),
        jnp.zeros(r_shape, jnp.int32),
    )
    (best_t, best_i), _ = jax.lax.scan(
        body, init, jnp.arange(n_chunks, dtype=jnp.int32)
    )
    return best_t, best_i


def _slice_rows(arr, start, size):
    return jax.lax.dynamic_slice_in_dim(arr, start, size, axis=0)


def _pool_closest(o, d, scene: Scene, pool_code: int, t_min, t_max):
    """Brute-force closest hit within one pool; (best_t, best_idx)."""
    dtype = o.dtype
    r_shape = o.shape[:-1]
    if pool_code == POOL_SPHERE:
        p = scene.spheres
        n = p.radius.shape[0]
        fn = lambda s, c: isect.sphere_t(
            o, d, _slice_rows(p.center, s, c), _slice_rows(p.radius, s, c), t_min
        )
    elif pool_code == POOL_TRIANGLE:
        p = scene.triangles
        n = p.v0.shape[0]
        fn = lambda s, c: isect.triangle_t(
            o,
            d,
            _slice_rows(p.v0, s, c),
            _slice_rows(p.v1, s, c),
            _slice_rows(p.v2, s, c),
            t_min,
        )
    elif pool_code == POOL_CYLINDER:
        p = scene.cylinders
        n = p.radius.shape[0]
        fn = lambda s, c: isect.cylinder_t(
            o,
            d,
            _slice_rows(p.p0, s, c),
            _slice_rows(p.p1, s, c),
            _slice_rows(p.radius, s, c),
            t_min,
        )
    elif pool_code == POOL_ELLIPSOID:
        p = scene.ellipsoids
        n = p.center.shape[0]
        fn = lambda s, c: isect.ellipsoid_t(
            o, d, _slice_rows(p.center, s, c), _slice_rows(p.radii, s, c), t_min
        )
    elif pool_code == POOL_PLANE:
        p = scene.planes
        n = p.axis.shape[0]
        fn = lambda s, c: isect.plane_t(
            o,
            d,
            _slice_rows(p.axis, s, c),
            _slice_rows(p.origin, s, c),
            _slice_rows(p.half_extents, s, c),
            t_min,
        )
    else:  # pragma: no cover
        raise ValueError(pool_code)
    if n == 0:
        return jnp.full(r_shape, T_FAR, dtype), jnp.zeros(r_shape, jnp.int32)
    best_t, best_i = _chunked_min(fn, n, r_shape, dtype)
    best_t = jnp.where(best_t <= t_max, best_t, T_FAR)
    return best_t, best_i


def _pool_sizes(scene: Scene):
    return {
        POOL_SPHERE: scene.spheres.radius.shape[0],
        POOL_TRIANGLE: scene.triangles.v0.shape[0],
        POOL_CYLINDER: scene.cylinders.radius.shape[0],
        POOL_ELLIPSOID: scene.ellipsoids.center.shape[0],
        POOL_PLANE: scene.planes.axis.shape[0],
    }


def scene_closest_hit(
    scene: Scene,
    o,
    d,
    t_min=RAY_EPS,
    t_max=T_FAR,
    use_bvh: bool = True,
    packet=None,
) -> Hit:
    """Closest hit across every pool (reference:
    intersectionWithPrimitives), differentiable.

    ``packet``: optional (tile_rays, max_leaves) — rays are already
    tile-coherent groups of tile_rays; triangle traversal uses the
    packet-culled path (solstice.ops.packet) instead of the per-ray
    while_loop walk.

    Two-phase design (SURVEY.md section 7 "differentiating through
    traversal"): the traversal itself — BVH while_loop or brute-force
    argmin scan — runs DETACHED (discrete hit selection has no useful
    gradient and while_loop has no reverse rule); the returned ``t`` is
    then RECOMPUTED analytically for the selected primitive only, a
    matched gather + one intersection test, which carries exact gradients
    to ray and geometry at fixed topology and makes the backward pass
    O(rays) instead of O(rays x primitives).
    """
    sg = jax.lax.stop_gradient
    raw = _scene_closest_hit_raw(
        sg(scene), sg(o), sg(d), t_min, t_max, use_bvh, packet
    )
    t = _recompute_t(scene, o, d, raw.pool, raw.idx, t_min)
    # Keep the traversal t on miss (sentinel) and on rare recompute
    # disagreements (f32 tangency): values match whenever both hit.
    t = jnp.where(raw.valid & (t < T_FAR * 0.5), t, raw.t)
    return Hit(t=t, pool=raw.pool, idx=raw.idx)


def _recompute_t(scene: Scene, o, d, pool, idx, t_min):
    """Differentiable hit distance for the already-selected primitive."""
    sizes = _pool_sizes(scene)
    t = jnp.full(o.shape[:-1], T_FAR, o.dtype)

    def sel(code, t_code):
        return jnp.where(pool == code, t_code, t)

    if sizes[POOL_SPHERE]:
        p = scene.spheres
        i = jnp.clip(idx, 0, sizes[POOL_SPHERE] - 1)
        t = sel(POOL_SPHERE, isect.sphere_t_p(
            o, d, p.center[i], p.radius[i], t_min))
    if sizes[POOL_TRIANGLE]:
        p = scene.triangles
        i = jnp.clip(idx, 0, sizes[POOL_TRIANGLE] - 1)
        t = sel(POOL_TRIANGLE, isect.triangle_t_p(
            o, d, p.v0[i], p.v1[i], p.v2[i], t_min))
    if sizes[POOL_CYLINDER]:
        p = scene.cylinders
        i = jnp.clip(idx, 0, sizes[POOL_CYLINDER] - 1)
        t = sel(POOL_CYLINDER, isect.cylinder_t_p(
            o, d, p.p0[i], p.p1[i], p.radius[i], t_min))
    if sizes[POOL_ELLIPSOID]:
        p = scene.ellipsoids
        i = jnp.clip(idx, 0, sizes[POOL_ELLIPSOID] - 1)
        t = sel(POOL_ELLIPSOID, isect.ellipsoid_t_p(
            o, d, p.center[i], p.radii[i], t_min))
    if sizes[POOL_PLANE]:
        p = scene.planes
        i = jnp.clip(idx, 0, sizes[POOL_PLANE] - 1)
        t = sel(POOL_PLANE, isect.plane_t_p(
            o, d, p.axis[i], p.origin[i], p.half_extents[i], t_min))
    return t


def _scene_closest_hit_raw(
    scene: Scene,
    o,
    d,
    t_min=RAY_EPS,
    t_max=T_FAR,
    use_bvh: bool = True,
    packet=None,
) -> Hit:
    """Detached traversal: packet-culled sweep (coherent tiles) or BVH
    skip-pointer walk where attached, chunked brute-force otherwise."""
    from solstice.ops import bvh as bvh_mod  # local import to avoid cycle

    r_shape = o.shape[:-1]
    best_t = jnp.full(r_shape, T_FAR, o.dtype)
    # pool = -1 on miss: no surface_at branch matches, so miss lanes get
    # the benign default normal instead of a fabricated pool surface.
    best_pool = jnp.full(r_shape, -1, jnp.int32)
    best_idx = jnp.zeros(r_shape, jnp.int32)

    pool_bvh = {
        POOL_SPHERE: scene.sph_bvh,
        POOL_TRIANGLE: scene.tri_bvh,
        POOL_CYLINDER: scene.cyl_bvh,
    }
    for code, size in _pool_sizes(scene).items():
        if size == 0:
            continue
        bvh = pool_bvh.get(code) if use_bvh else None
        packet_ok = (
            bvh is not None
            and packet is not None
            and len(r_shape) == 1
            and r_shape[0] % packet[0] == 0
        )
        if packet_ok and code == POOL_TRIANGLE:
            t, i = _tri_packet_closest(scene, o, d, t_min, packet)
        elif packet_ok and code == POOL_SPHERE and scene.sph_accel is not None:
            t, i = _tri_packet_closest(scene, o, d, t_min, packet,
                                       prim="sphere")
        elif packet_ok and code == POOL_CYLINDER and \
                scene.cyl_accel is not None:
            t, i = _tri_packet_closest(scene, o, d, t_min, packet,
                                       prim="cyl")
        elif bvh is not None:
            t, i = bvh_mod.bvh_closest_hit(scene, bvh, code, o, d, t_min, t_max)
        else:
            t, i = _pool_closest(o, d, scene, code, t_min, t_max)
        better = t < best_t
        best_t = jnp.where(better, t, best_t)
        best_pool = jnp.where(better, code, best_pool)
        best_idx = jnp.where(better, i, best_idx)
    return Hit(t=best_t, pool=best_pool, idx=best_idx)


def _sweep_closest(route, packed, o_t, d_t, t_cap, live, cand, counts,
                   nearb, t_min, prim):
    """Closest-hit strip sweep on the configured route: (t, idx), both
    (S, SB), idx -1 on miss, and visits (S * G,), the candidate blocks
    each strip tested (the XLA scan tests its whole list).  The strip is
    the tile of the block scan."""
    from solstice.ops import packet as pk

    s, sb = o_t.shape[:2]
    g, k = cand.shape[1:]
    ssb = sb // g
    strips = lambda a: a.reshape((-1, ssb) + a.shape[2:])
    if route == "xla":
        bt, bi = pk.tri_blocks_closest(
            packed, strips(o_t), strips(d_t), cand.reshape(-1, k),
            counts.reshape(-1), t_min, prim=prim,
        )
        visits = counts.reshape(-1)
    else:
        from solstice.ops.sweep_kernel import sweep_closest

        bt, bi, visits = sweep_closest(
            packed, strips(o_t), strips(d_t), strips(t_cap),
            strips(live), cand.reshape(-1, k), counts.reshape(-1),
            nearb.reshape(-1, k), t_min, prim=prim,
            interpret=route == "interpret",
        )
    return bt.reshape(s, sb), bi.reshape(s, sb), visits


def _sweep_transmittance(route, packed, o_t, d_t, tm_t, live, cand,
                         counts, t_min, prim):
    """Shadow strip sweep on the configured route: tr (S, SB)."""
    from solstice.ops import packet as pk

    s, sb = o_t.shape[:2]
    g, k = cand.shape[1:]
    ssb = sb // g
    strips = lambda a: a.reshape((-1, ssb) + a.shape[2:])
    if route == "xla":
        tr = pk.tri_blocks_transmittance(
            packed, strips(o_t), strips(d_t), strips(tm_t),
            cand.reshape(-1, k), counts.reshape(-1), t_min, prim=prim,
        )
    else:
        from solstice.ops.sweep_kernel import sweep_transmittance

        tr, _ = sweep_transmittance(
            packed, strips(o_t), strips(d_t), strips(tm_t),
            strips(live), cand.reshape(-1, k), counts.reshape(-1),
            t_min, prim=prim, interpret=route == "interpret",
        )
    return tr.reshape(s, sb)


def _tri_accel(scene: Scene):
    from solstice.ops import packet as pk

    if scene.tri_accel is not None:
        return scene.tri_accel
    # Unbuilt/raw scenes (tests): derive on the fly.
    return pk.build_tri_accel(scene.triangles, scene.materials)


def _pool_accel(scene: Scene, prim: str):
    from solstice.ops import packet as pk

    if prim == "sphere":
        if scene.sph_accel is not None:
            return scene.sph_accel
        return pk.build_sph_accel(scene.spheres, scene.materials)
    if prim == "cyl":
        if scene.cyl_accel is not None:
            return scene.cyl_accel
        return pk.build_cyl_accel(scene.cylinders, scene.materials)
    return _tri_accel(scene)


def _pool_net_bvh(scene: Scene, prim: str):
    return {
        "sphere": scene.sph_bvh,
        "cyl": scene.cyl_bvh,
        "tri": scene.tri_bvh,
    }[prim]


_PRIM_POOL = {"tri": POOL_TRIANGLE, "sphere": POOL_SPHERE,
              "cyl": POOL_CYLINDER}


def _scene_box(accel):
    """Scene AABB from the real (non-padding) block bounds."""
    real = accel.block_bounds[:, 0] < 1e29
    bmin = jnp.min(
        jnp.where(real[:, None],
                  accel.block_bounds[:, 0:3] - accel.block_bounds[:, 3:6],
                  jnp.inf), axis=0,
    )
    bmax = jnp.max(
        jnp.where(real[:, None],
                  accel.block_bounds[:, 0:3] + accel.block_bounds[:, 3:6],
                  -jnp.inf), axis=0,
    )
    return bmin, bmax


def _net_capacity(r: int) -> int:
    """Compacted exactness-net chunk size, lane-aligned, capped at 2048
    so the union-block net's per-ray (chunk x n_blocks) slab matrices
    stay tens of MB (at 1M tris: 2048 x 3968 f32 = 32 MB per
    component)."""
    return min(r, max(512, min(2048, -(-r // 64 // 128) * 128)))


# Union-net candidate width: the per-chunk union of blocks any needy
# ray intersects; a chunk whose union overflows falls back to the full
# pool brute (exactness is never conditional on this cap).
_NET_UCAP = int(__import__("os").environ.get("SOLR_NET_UCAP", "512"))


def _ray_block_slabs(o, d, block_bounds, t_min):
    """Per-(ray, block) AABB slab test: (entry (R, B), hit (R, B)).

    SoA component math (six (R, B) arrays) — the (R, B, 3) form
    materializes 3x the memory for nothing.  Blocks are the accel's
    [center, half-extent] rows; padding blocks (center ~ +BIG) never
    hit.  ``entry`` is the clamped-to-0 slab entry distance: a valid
    lower bound on any hit t inside the block.
    """
    big = 1.0e30
    cx, cy, cz = (block_bounds[:, i][None, :] for i in range(3))
    hx, hy, hz = (block_bounds[:, 3 + i][None, :] for i in range(3))

    def axis(o_a, d_a, c_a, h_a):
        safe = jnp.abs(d_a) > 1e-12
        inv = jnp.where(safe, 1.0, 0.0) / jnp.where(safe, d_a, 1.0)
        lo = (c_a - h_a - o_a[:, None]) * inv[:, None]
        hi = (c_a + h_a - o_a[:, None]) * inv[:, None]
        t0 = jnp.minimum(lo, hi)
        t1 = jnp.maximum(lo, hi)
        inside = jnp.abs(o_a[:, None] - c_a) <= h_a
        deg = ~safe[:, None]
        t0 = jnp.where(deg, jnp.where(inside, -big, big), t0)
        t1 = jnp.where(deg, jnp.where(inside, big, -big), t1)
        return t0, t1

    x0, x1 = axis(o[:, 0], d[:, 0], cx, hx)
    y0, y1 = axis(o[:, 1], d[:, 1], cy, hy)
    z0, z1 = axis(o[:, 2], d[:, 2], cz, hz)
    t_enter = jnp.maximum(jnp.maximum(x0, y0), z0)
    t_exit = jnp.minimum(jnp.minimum(x1, y1), z1)
    hit = (t_exit >= t_enter) & (t_exit > t_min)
    return jnp.maximum(t_enter, 0.0), hit


def _union_candidates(hitm, n_blocks):
    """Compact the chunk's union of hit blocks to a static-width
    (1, U) candidate list: (cand, counts, overflow)."""
    union = jnp.any(hitm, axis=0)  # (B,)
    u_count = jnp.sum(union)
    ucap = min(_NET_UCAP, n_blocks)
    idx = jnp.nonzero(union, size=ucap, fill_value=n_blocks)[0]
    valid = idx < n_blocks
    cand = jnp.where(valid, idx, 0).astype(jnp.int32)[None]
    counts = valid.sum(dtype=jnp.int32)[None]
    return cand, counts, u_count > ucap


_NET_WIN = 64  # candidate columns per conditionally-skipped net window


def _windowed_sweep(sweep_fn, carry_init, cand, counts, fold):
    """Run ``sweep_fn(cand_window, counts_window)`` over _NET_WIN-wide
    candidate windows, each under ``lax.cond`` so windows beyond the
    chunk's real union count cost nothing — a fixed-length scan over
    the full static width burned ~10x the needed work on typical
    unions (~50-150 blocks of the 512 cap).  ``fold(carry, out)``
    merges a window's result."""
    k_max = cand.shape[1]
    n_win = -(-k_max // _NET_WIN)
    pad = n_win * _NET_WIN - k_max
    if pad:
        cand = jnp.pad(cand, ((0, 0), (0, pad)))

    def body(w, carry):
        lo = w * _NET_WIN

        def run(carry):
            cand_w = jax.lax.dynamic_slice_in_dim(cand, lo, _NET_WIN, 1)
            cnt_w = jnp.clip(counts - lo, 0, _NET_WIN)
            return fold(carry, sweep_fn(cand_w, cnt_w))

        return jax.lax.cond(counts[0] > lo, run, lambda c: c, carry)

    return jax.lax.fori_loop(0, n_win, body, carry_init)


def _net_strips(n: int) -> int:
    """Rays per kernel program when a net chunk of ``n`` rays shares one
    candidate window: 32-ray strips when they divide the chunk."""
    return 32 if n % 32 == 0 else n


def _block_net_closest(scene, accel, pool_code, prim, o_c, d_c, act,
                       t_best, t_min, route):
    """Exact closest hit for one compacted needy chunk, at block cost:
    slab-test every ray against every block AABB (cheap), sweep ONLY
    the union of intersected blocks (blocks partition the pool, so the
    union contains every possible hit), and fall back to the full pool
    brute only if the union overflows the static width.

    The pool brute at 1M tris costs ~160 GFLOP per 2048-ray chunk; the
    union sweep is far less on the bench scenes.  On the kernel route
    the chunk's strips each walk the shared window in the sweep kernel;
    otherwise the XLA block scan runs it as one tile."""
    from solstice.ops import packet as pk

    entry, hitm = _ray_block_slabs(
        jax.lax.stop_gradient(o_c), jax.lax.stop_gradient(d_c),
        accel.block_bounds, t_min,
    )
    # Blocks entered beyond the ray's current best can't improve it.
    hitm = hitm & act[:, None] & (entry <= t_best[:, None])
    cand, counts, overflow = _union_candidates(
        hitm, accel.packed.shape[0]
    )

    def union_sweep(_):
        def one_window(cand_w, cnt_w):
            if route == "xla":
                t2, i2 = pk.tri_blocks_closest(
                    accel.packed, o_c[None], d_c[None], cand_w, cnt_w,
                    t_min, prim=prim,
                )
                return t2[0], i2[0]
            from solstice.ops.sweep_kernel import sweep_closest

            ssb = _net_strips(o_c.shape[0])
            n = o_c.shape[0] // ssb
            k = cand_w.shape[1]
            t2, i2, _ = sweep_closest(
                accel.packed, o_c.reshape(n, ssb, 3),
                d_c.reshape(n, ssb, 3),
                jnp.full((n, ssb), T_FAR, jnp.float32),
                act.reshape(n, ssb), jnp.broadcast_to(cand_w, (n, k)),
                jnp.broadcast_to(cnt_w, (n,)),
                jnp.zeros((n, k), jnp.float32),  # union: no entry order
                t_min, prim=prim, interpret=route == "interpret",
            )
            return t2.reshape(-1), i2.reshape(-1)

        def fold(carry, out):
            bt, bi = carry
            t2, i2 = out
            better = t2 < bt
            return jnp.where(better, t2, bt), jnp.where(better, i2, bi)

        init = (
            jnp.full(o_c.shape[:1], T_FAR, o_c.dtype),
            jnp.full(o_c.shape[:1], -1, jnp.int32),
        )
        return _windowed_sweep(one_window, init, cand, counts, fold)

    def pool_brute(_):
        return _pool_closest(o_c, d_c, scene, pool_code, t_min, t_best)

    return jax.lax.cond(overflow, pool_brute, union_sweep, None)


def _block_net_transmittance(scene, accel, pool_code, prim, o_c, d_c,
                             tm_c, act, t_min, route):
    """Exact shadow transmittance for one compacted needy chunk via the
    union-block sweep (see :func:`_block_net_closest`); occluders live
    only in blocks whose slab interval starts before the light."""
    from solstice.ops import packet as pk

    entry, hitm = _ray_block_slabs(o_c, d_c, accel.block_bounds, t_min)
    hitm = hitm & act[:, None] & (entry <= tm_c[:, None])
    cand, counts, overflow = _union_candidates(
        hitm, accel.packed.shape[0]
    )

    def union_sweep(_):
        def one_window(cand_w, cnt_w):
            if route == "xla":
                return pk.tri_blocks_transmittance(
                    accel.packed, o_c[None], d_c[None], tm_c[None],
                    cand_w, cnt_w, t_min, prim=prim,
                )[0]
            from solstice.ops.sweep_kernel import sweep_transmittance

            ssb = _net_strips(o_c.shape[0])
            n = o_c.shape[0] // ssb
            k = cand_w.shape[1]
            tr, _ = sweep_transmittance(
                accel.packed, o_c.reshape(n, ssb, 3),
                d_c.reshape(n, ssb, 3), tm_c.reshape(n, ssb),
                act.reshape(n, ssb), jnp.broadcast_to(cand_w, (n, k)),
                jnp.broadcast_to(cnt_w, (n,)), t_min, prim=prim,
                interpret=route == "interpret",
            )
            return tr.reshape(-1)

        def fold(tr, out):
            return tr * out

        init = jnp.ones(o_c.shape[:1], o_c.dtype)
        return _windowed_sweep(one_window, init, cand, counts, fold)

    def pool_brute(_):
        return _pool_transmittance_brute(
            scene, pool_code, o_c, d_c, tm_c, t_min
        )

    return jax.lax.cond(overflow, pool_brute, union_sweep, None)


def _spatial_keys(p, bmin, bmax):
    """Coarse Morton key of positions ``p`` (R, 3) within the scene box
    (64 cells per axis).  Used to SORT needy net rays into spatially
    tight chunks: the union-block net's per-chunk block union must stay
    under its static width, and pixel-order chunks of SPARSE needy rays
    span the whole frame, so every chunk overflows into the pool
    brute."""
    span = jnp.maximum(bmax - bmin, 1e-6)
    q = jnp.clip(((p - bmin) / span * 64.0).astype(jnp.int32), 0, 63)

    def spread(x):  # interleave 6 bits -> every 3rd bit
        x = (x | (x << 8)) & 0x0300F
        x = (x | (x << 4)) & 0x030C3
        x = (x | (x << 2)) & 0x09249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (
        spread(q[:, 2]) << 2
    )


def _compacted_net(need, carry, walk_chunk, sort_key=None):
    """Run an exactness-net walk over ONLY the unproven rays.

    ``need`` (R,) bool selects rays; ``walk_chunk(idx, act, carry)``
    walks one cap-sized compacted chunk and scatters its results into
    ``carry``.  Needy indices are gathered once, optionally SORTED by
    ``sort_key`` (R,) so chunks are spatially coherent (see
    :func:`_spatial_keys`), then processed in fixed-size chunks under
    ``lax.cond`` so the per-call cost is proportional to the actual
    needy count — a full-frame masked while_loop walk costs orders of
    magnitude more than a sweep frame; this bounds every walk invocation to cap rays while staying exact
    for ANY needy count."""
    r = need.shape[0]
    cap = _net_capacity(r)
    n_chunks = -(-r // cap)

    def run_net(carry):
        # ALL net prep lives inside the cond: the nonzero compaction
        # and especially the spatial argsort of all R rays must cost
        # nothing on the frames whose certificates all hold.  Padded to
        # n_chunks*cap so every dynamic_slice chunk is disjoint (a
        # clamped final slice would re-walk rays — transmittance
        # factors must be applied exactly once).
        idx_all = jnp.nonzero(need, size=n_chunks * cap, fill_value=r)[0]
        if sort_key is not None:
            # Stable two-level order: (active-first, spatial key).
            # Padding (idx == r) keys to +inf so inactive slots stay at
            # the tail and the leading chunks remain the only active
            # ones.
            key = jnp.where(
                idx_all < r,
                sort_key[jnp.minimum(idx_all, r - 1)].astype(
                    jnp.float32),
                jnp.inf,
            )
            order = jnp.argsort(key)
            idx_all = idx_all[order]

        def chunk_body(c, carry):
            idx = jax.lax.dynamic_slice_in_dim(idx_all, c * cap, cap)
            act = idx < r
            return jax.lax.cond(
                jnp.any(act),
                lambda carry: walk_chunk(idx, act, carry),
                lambda carry: carry,
                carry,
            )

        return jax.lax.fori_loop(0, n_chunks, chunk_body, carry)

    return jax.lax.cond(need.any(), run_net, lambda carry: carry, carry)


def _tri_packet_closest(scene, o, d, t_min, packet, prim="tri"):
    """Packet closest hit: per-strip interval lists -> front-to-back
    sweep on the configured route (Triton kernel or XLA block scan) ->
    conditional exactness net.

    Candidate selection is solstice.ops.packet.strip_interval_select —
    each 32-ray strip owns its own entry-sorted block list built from
    per-ray slab tests, so the sweep visits a few blocks per ray
    instead of every candidate shared by the tile, at identical
    exactness.  The static widths (K=64/Kt=256) hold the lists of the
    bench scene, and any overflow is certified per ray
    by ``dropped`` and union-net-walked under ``lax.cond`` (the
    predicate is false at bench scale, so the walk costs nothing).
    """
    from solstice.constants import PARK_THRESHOLD
    from solstice.ops import packet as pk

    tile_rays, ks, kt, exact, route = packet
    r = o.shape[0]
    o_t = o.reshape(-1, tile_rays, 3)
    d_t = d.reshape(-1, tile_rays, 3)
    accel = _pool_accel(scene, prim)
    net_bvh = _pool_net_bvh(scene, prim)
    pool_code = _PRIM_POOL[prim]
    live = o_t[..., 0] < PARK_THRESHOLD  # (S, SB)
    cand, counts, nearb, dropped = pk.strip_interval_select(
        o_t, d_t, live, accel, kt, ks, t_min
    )
    # Per-ray scene-box exit distance: the upper bound on ANY possible
    # hit, so miss/sky rays (best_t = T_FAR) neither stall the kernel's
    # front-to-back early-out nor trip the exactness net.
    bmin, bmax = _scene_box(accel)
    t_cap = pk.ray_box_exit(o_t, d_t, bmin, bmax)  # (S, SB)

    bt, bi, _ = _sweep_closest(route, accel.packed, o_t, d_t, t_cap,
                               live, cand, counts, nearb, t_min, prim)

    if exact and net_bvh is not None:
        need = (
            live & (jnp.minimum(bt, t_cap) > dropped)
        ).reshape(r)
        bt_f, bi_f = bt.reshape(r), bi.reshape(r)
        # Spatial sort key: the ray segment's midpoint (bounded by the
        # current best / scene-box exit) — needy chunks become
        # spatially tight so their block unions fit the net's width.
        t_mid = 0.5 * jnp.minimum(bt_f, t_cap.reshape(r))
        net_key = _spatial_keys(o + d * t_mid[:, None], bmin, bmax)

        def walk_chunk(idx, act, carry):
            # Union-block exact walk on the compacted needy rays (see
            # _block_net_closest): slab every ray against every block
            # AABB, sweep only the union; the pool brute remains only
            # as the conditional union-overflow fallback.
            bt_c, bi_c = carry
            safe = jnp.minimum(idx, r - 1)
            t2, i2 = _block_net_closest(
                scene, accel, pool_code, prim, o[safe], d[safe], act,
                bt_c[safe], t_min, route,
            )
            better = act & (t2 < bt_c[safe])
            new_t = jnp.where(better, t2, bt_c[safe])
            new_i = jnp.where(better, i2, bi_c[safe])
            return (
                bt_c.at[idx].set(new_t, mode="drop"),
                bi_c.at[idx].set(new_i, mode="drop"),
            )

        return _compacted_net(need, (bt_f, bi_f), walk_chunk,
                              sort_key=net_key)
    return bt.reshape(r), bi.reshape(r)


def scene_transmittance(
    scene: Scene,
    o,
    d,
    t_max,
    t_min=RAY_EPS,
    use_bvh: bool = True,
    packet=None,
):
    """Shadow-ray transmittance in [0, 1] toward a light.

    Reference semantics (GeometryShaders.cuh: processShadows): opaque
    occluders block light; transparent occluders *attenuate* instead of
    fully occluding, producing colored/partial shadows.  Here the
    transmittance is the product over occluding primitives of their
    material transparency — order-independent, fully vectorized, and
    differentiable (no sorting needed).
    """
    from solstice.ops import bvh as bvh_mod

    r_shape = o.shape[:-1]
    trans = jnp.ones(r_shape, o.dtype)

    pool_bvh = {
        POOL_SPHERE: scene.sph_bvh,
        POOL_TRIANGLE: scene.tri_bvh,
        POOL_CYLINDER: scene.cyl_bvh,
    }

    def mat_transparency(code, idx):
        # Emissive primitives ARE the lights; they never occlude shadow
        # rays (reference: processShadows skips the lamp primitive).
        mat = _pool_material(scene, code, idx)
        return jnp.where(
            scene.materials.emission[mat] > 0.0,
            1.0,
            scene.materials.transparency[mat],
        )

    for code, size in _pool_sizes(scene).items():
        if size == 0:
            continue
        bvh = pool_bvh.get(code) if use_bvh else None
        packet_ok = (
            bvh is not None
            and packet is not None
            and len(r_shape) >= 1
            and r_shape[0] % packet[0] == 0
        )
        # Detached INPUTS, not just outputs: under jax.grad/jvp a
        # tangent-carrying operand would still be traced INTO the
        # while_loop walk / Pallas sweep, and pallas_call has no JVP
        # rule (NotImplementedError at lowering — found by
        # tools/aot_overlap_check.py).  Detaching the operands makes
        # the tangents symbolic zeros so differentiation never enters.
        # Within fixed topology the only continuous dependence lost is
        # occluder material transparency; that gradient survives
        # through the brute-force path used by small pools and is
        # deliberately dropped for accelerated pools (not in the
        # north-star param set).
        sg = jax.lax.stop_gradient
        if packet_ok and (
            code == POOL_TRIANGLE
            or (code == POOL_SPHERE and scene.sph_accel is not None)
            or (code == POOL_CYLINDER and scene.cyl_accel is not None)
        ):
            prim = {POOL_TRIANGLE: "tri", POOL_SPHERE: "sphere",
                    POOL_CYLINDER: "cyl"}[code]
            trans = trans * _tri_packet_transmittance(
                sg(scene), sg(o), sg(d), sg(t_max), t_min, packet,
                prim=prim,
            )
            continue
        if bvh is not None:
            trans = trans * bvh_mod.bvh_transmittance(
                sg(scene), bvh, code, sg(o), sg(d), t_min, sg(t_max)
            )
            continue

        # Brute force: product over all chunks of per-primitive factors.
        # The final partial chunk clamps its start and masks the rows the
        # previous chunk already covered — transmittance factors must be
        # applied exactly once (ADVICE r03 high #1: the unclamped index
        # base paired occluders with the wrong material and the clamped
        # slice squared overlap factors).
        chunk = min(_PRIM_CHUNK, size)
        n_chunks = (size + chunk - 1) // chunk

        def body(carry, ci, chunk=chunk, code=code, size=size):
            start = jnp.minimum(ci * chunk, size - chunk)
            t = _pool_t_chunk(scene, code, o, d, start, chunk, t_min)
            idx = start + jnp.arange(chunk)
            fresh = idx >= ci * chunk  # rows not already processed
            occludes = (t < t_max[..., None]) & fresh
            f = mat_transparency(code, idx)[None, :]  # (1, C)
            return carry * jnp.prod(
                jnp.where(occludes, f, 1.0), axis=-1
            ), None

        trans, _ = jax.lax.scan(body, trans, jnp.arange(n_chunks))
    return trans


def _tri_packet_transmittance(scene, o, d, t_max, t_min, packet,
                              prim="tri"):
    """Packet shadow transmittance; handles (R, 3) and (R, L, 3) rays
    (the shadow path is rays x lights; lights unroll as a static
    Python loop — a vmapped lax.cond lowers to a select that executes
    both branches; DEBUGGING.md).

    Selection is the same strip_interval_select as the closest path,
    with the tile prefilter culling origin->light SEGMENT bundles
    (capsule between the origin sphere and the light-sample sphere —
    solstice.ops.packet.capsule_bundles) and per-ray slab intervals
    clipped at the light distance.  Transmittance needs EVERY occluder
    (no front-to-back order), so a strip sweeps its whole list, but
    stops once all its live rays are extinguished.  Any capped-out
    strip/tile is certified by ``dropped`` and union-net-walked under
    ``lax.cond`` (false at bench scale).
    """
    from solstice.constants import PARK_THRESHOLD, T_FAR as _TF
    from solstice.ops import packet as pk

    tile_rays, ks, kt, exact, route = packet
    accel = _pool_accel(scene, prim)
    net_bvh = _pool_net_bvh(scene, prim)
    pool_code = _PRIM_POOL[prim]

    def one_sweep(o2, d2, tm2):  # (R, 3), (R, 3), (R,) -> (tr, need)
        o_t = o2.reshape(-1, tile_rays, 3)
        d_t = d2.reshape(-1, tile_rays, 3)
        tm_full = jnp.broadcast_to(tm2, o2.shape[:-1])
        tm_t = tm_full.reshape(-1, tile_rays)
        live = o_t[..., 0] < PARK_THRESHOLD
        cand, counts, nearb, dropped = pk.strip_interval_select(
            o_t, d_t, live, accel, kt, ks, t_min, tm_t=tm_t
        )
        tr = _sweep_transmittance(route, accel.packed, o_t, d_t, tm_t,
                                  live, cand, counts, t_min, prim)
        # A dropped block occludes a ray only if its interval can start
        # before the ray's light distance.
        need = live & (dropped < jnp.minimum(tm_t, _TF * 0.5))
        return tr.reshape(o2.shape[:-1]), need.reshape(o2.shape[:-1])

    def net(o2, d2, tm2, tr, need):  # conditional exactness walk
        r2 = o2.shape[0]
        tm_full = jnp.broadcast_to(tm2, o2.shape[:-1])

        def walk_chunk(idx, act, carry):
            # Union-block exact walk (see _block_net_transmittance):
            # grazing tiles' capsule bundles span huge depth, so some
            # shadow rays drop candidates and land here.
            (tr_c,) = carry
            safe = jnp.minimum(idx, r2 - 1)
            tr_walk = _block_net_transmittance(
                scene, accel, pool_code, prim, o2[safe], d2[safe],
                tm_full[safe], act, t_min, route,
            )
            new_tr = jnp.where(act, tr_walk, tr_c[safe])
            return (tr_c.at[idx].set(new_tr, mode="drop"),)

        # Sort needy shadow rays by surface-point locality (see
        # _spatial_keys) so chunk block-unions stay under the width.
        bmin, bmax = _scene_box(accel)
        net_key = _spatial_keys(o2, bmin, bmax)
        return _compacted_net(need, (tr,), walk_chunk,
                              sort_key=net_key)[0]

    do_net = exact and net_bvh is not None

    def one_light(o2, d2, tm2):
        tr, need = one_sweep(o2, d2, tm2)
        if do_net:
            tr = net(o2, d2, tm2, tr, need)
        return tr

    if o.ndim == 3:  # (R, L, 3): per-light bundles, STATIC loop — a
        # vmapped pallas_call / lax.cond would batch the kernel and
        # run every net branch unconditionally (DEBUGGING.md).
        tm = jnp.broadcast_to(t_max, o.shape[:-1])
        return jnp.stack(
            [one_light(o[:, l], d[:, l], tm[:, l])
             for l in range(o.shape[1])],
            axis=1,
        )
    tm = jnp.broadcast_to(t_max, o.shape[:-1])
    return one_light(o, d, tm)


def _pool_transmittance_brute(scene: Scene, code: int, o, d, t_max,
                              t_min=RAY_EPS):
    """Brute-force shadow transmittance over one pool: product over all
    occluding primitives of their material transparency (emissive
    primitives never occlude — they ARE the lights).  Chunk-scanned; used
    by the packet exactness net on compacted needy rays."""
    size = _pool_sizes(scene)[code]
    trans = jnp.ones(o.shape[:-1], o.dtype)
    if size == 0:
        return trans
    chunk = min(_PRIM_CHUNK, size)
    n_chunks = (size + chunk - 1) // chunk

    def body(carry, ci):
        # Clamped start + fresh-row mask: see the brute-force branch of
        # scene_transmittance (ADVICE r03 high #1 — factors must apply
        # exactly once, with the material of the RIGHT primitive).
        start = jnp.minimum(ci * chunk, size - chunk)
        t = _pool_t_chunk(scene, code, o, d, start, chunk, t_min)
        idx = start + jnp.arange(chunk)
        fresh = idx >= ci * chunk
        occludes = (t < t_max[..., None]) & fresh
        mat = _pool_material(scene, code, idx)
        f = jnp.where(
            scene.materials.emission[mat] > 0.0,
            1.0,
            scene.materials.transparency[mat],
        )[None, :]
        return carry * jnp.prod(jnp.where(occludes, f, 1.0), axis=-1), None

    trans, _ = jax.lax.scan(body, trans, jnp.arange(n_chunks))
    return trans


def _pool_t_chunk(scene: Scene, code: int, o, d, start, chunk, t_min):
    if code == POOL_SPHERE:
        p = scene.spheres
        return isect.sphere_t(
            o, d, _slice_rows(p.center, start, chunk),
            _slice_rows(p.radius, start, chunk), t_min,
        )
    if code == POOL_TRIANGLE:
        p = scene.triangles
        return isect.triangle_t(
            o, d, _slice_rows(p.v0, start, chunk),
            _slice_rows(p.v1, start, chunk),
            _slice_rows(p.v2, start, chunk), t_min,
        )
    if code == POOL_CYLINDER:
        p = scene.cylinders
        return isect.cylinder_t(
            o, d, _slice_rows(p.p0, start, chunk),
            _slice_rows(p.p1, start, chunk),
            _slice_rows(p.radius, start, chunk), t_min,
        )
    if code == POOL_ELLIPSOID:
        p = scene.ellipsoids
        return isect.ellipsoid_t(
            o, d, _slice_rows(p.center, start, chunk),
            _slice_rows(p.radii, start, chunk), t_min,
        )
    if code == POOL_PLANE:
        p = scene.planes
        return isect.plane_t(
            o, d, _slice_rows(p.axis, start, chunk),
            _slice_rows(p.origin, start, chunk),
            _slice_rows(p.half_extents, start, chunk), t_min,
        )
    raise ValueError(code)  # pragma: no cover


def _pool_material(scene: Scene, code: int, idx):
    if code == POOL_SPHERE:
        return scene.spheres.material[idx]
    if code == POOL_TRIANGLE:
        return scene.triangles.material[idx]
    if code == POOL_CYLINDER:
        return scene.cylinders.material[idx]
    if code == POOL_ELLIPSOID:
        return scene.ellipsoids.material[idx]
    if code == POOL_PLANE:
        return scene.planes.material[idx]
    raise ValueError(code)  # pragma: no cover


# --------------------------------------------------------------------------
# Surface reconstruction at the selected hit (post-argmin gather).
# Reference: each intersector emits point/normal/UV inline; here they are
# recomputed only for the winning primitive — one gather per pool instead
# of per-candidate state.
# --------------------------------------------------------------------------


def surface_at(scene: Scene, hit: Hit, o, d) -> SurfaceInfo:
    t = jnp.where(hit.valid, hit.t, 1.0)
    point = o + t[..., None] * d
    r_shape = o.shape[:-1]

    normal = jnp.zeros_like(o).at[..., 2].set(-1.0)
    shading = normal
    uv = jnp.zeros(r_shape + (2,), o.dtype)
    material = jnp.zeros(r_shape, jnp.int32)

    sizes = _pool_sizes(scene)

    def blend(mask, n_new, sn_new, uv_new, m_new, normal, shading, uv, material):
        m3 = mask[..., None]
        return (
            jnp.where(m3, n_new, normal),
            jnp.where(m3, sn_new, shading),
            jnp.where(mask[..., None], uv_new, uv),
            jnp.where(mask, m_new, material),
        )

    if sizes[POOL_SPHERE]:
        p = scene.spheres
        i = jnp.clip(hit.idx, 0, sizes[POOL_SPHERE] - 1)
        c = p.center[i]
        r = jnp.maximum(p.radius[i], 1e-6)
        # normalize: on-sphere points make (P-C)/r unit already, but on
        # miss lanes hit.pool defaults to this pool and the fabricated
        # "normal" can be huge — pow(large, 50) = inf downstream breaks
        # the backward pass even though the lane is masked (0 * inf).
        n = normalize((point - c) / r[..., None])
        mask = hit.pool == POOL_SPHERE
        normal, shading, uv, material = blend(
            mask, n, n, spherical_uv(n), p.material[i],
            normal, shading, uv, material,
        )

    if sizes[POOL_TRIANGLE]:
        p = scene.triangles
        i = jnp.clip(hit.idx, 0, sizes[POOL_TRIANGLE] - 1)
        # ONE wide row gather instead of nine narrow (N, 3)/(N, 2) ones:
        # one index computation and one contiguous 96-byte row per hit.
        wide = jnp.concatenate(
            [p.v0, p.v1, p.v2, p.n0, p.n1, p.n2, p.uv0, p.uv1, p.uv2],
            axis=-1,
        )  # (N, 24)
        g = wide[i]  # (R, 24)
        v0, v1, v2 = g[..., 0:3], g[..., 3:6], g[..., 6:9]
        gn = cross(v1 - v0, v2 - v0)
        gn = normalize(gn)
        bu, bv = isect.triangle_bary(o, d, v0, v1, v2)
        bw = 1.0 - bu - bv
        sn = (
            bw[..., None] * g[..., 9:12]
            + bu[..., None] * g[..., 12:15]
            + bv[..., None] * g[..., 15:18]
        )
        has_sn = dot(sn, sn) > 1e-12
        sn = jnp.where(has_sn[..., None], sn, gn)
        sn = normalize(sn)
        uvt = (
            bw[..., None] * g[..., 18:20]
            + bu[..., None] * g[..., 20:22]
            + bv[..., None] * g[..., 22:24]
        )
        mask = hit.pool == POOL_TRIANGLE
        normal, shading, uv, material = blend(
            mask, gn, sn, uvt, p.material[i], normal, shading, uv, material
        )

    if sizes[POOL_CYLINDER]:
        p = scene.cylinders
        i = jnp.clip(hit.idx, 0, sizes[POOL_CYLINDER] - 1)
        p0, p1 = p.p0[i], p.p1[i]
        axis = p1 - p0
        h2 = jnp.maximum(dot(axis, axis), 1e-12)
        s = dot(point - p0, axis) / h2
        foot = p0 + s[..., None] * axis
        n_side = normalize(point - foot)
        # End-cap hits (capped cylinderIntersection): s pins to 0 or 1;
        # the normal there is the axis direction, not the radial one.
        a_hat = axis / jnp.sqrt(h2)[..., None]
        cap_lo = (s < 1e-4)[..., None]
        cap_hi = (s > 1.0 - 1e-4)[..., None]
        n = jnp.where(cap_lo, -a_hat, jnp.where(cap_hi, a_hat, n_side))
        ang = spherical_uv(n_side)[..., 0]
        mask = hit.pool == POOL_CYLINDER
        normal, shading, uv, material = blend(
            mask, n, n, jnp.stack([ang, s], -1), p.material[i],
            normal, shading, uv, material,
        )

    if sizes[POOL_ELLIPSOID]:
        p = scene.ellipsoids
        i = jnp.clip(hit.idx, 0, sizes[POOL_ELLIPSOID] - 1)
        c, rad = p.center[i], jnp.maximum(p.radii[i], 1e-6)
        local = (point - c) / rad
        n = normalize(local / rad)
        mask = hit.pool == POOL_ELLIPSOID
        normal, shading, uv, material = blend(
            mask, n, n, spherical_uv(local), p.material[i],
            normal, shading, uv, material,
        )

    if sizes[POOL_PLANE]:
        p = scene.planes
        i = jnp.clip(hit.idx, 0, sizes[POOL_PLANE] - 1)
        ax = p.axis[i]  # (R,)
        eye3 = jnp.eye(3, dtype=o.dtype)
        n = eye3[ax]  # (R,3) +normal-axis unit vector
        orig = p.origin[i]
        he = p.half_extents[i]
        rel = point - orig
        ar = jnp.arange(3)
        in_plane_mask = ar[None, :] != ax[..., None]  # (R,3)
        # Project the two in-plane coords, ascending axis order.
        coords = jnp.sort(
            jnp.where(in_plane_mask, ar[None, :], 3), axis=-1
        )[..., :2]  # (R,2) in-plane axis indices
        pu = jnp.take_along_axis(rel, coords, axis=-1)  # (R,2)
        uvp = 0.5 + 0.5 * pu / jnp.maximum(he, 1e-6)
        mask = hit.pool == POOL_PLANE
        normal, shading, uv, material = blend(
            mask, n, n, uvp, p.material[i], normal, shading, uv, material
        )

    # Normal/bump-map perturbation of the shading normal (reference:
    # TextureMapping.cuh bump/normal slots; applied pre-flip so the
    # oppose-the-ray guarantee below still holds).
    if scene.textures.count > 0:
        from solstice.ops import textures as tex_ops

        shading = tex_ops.apply_normal_maps(scene, material, uv, shading)

    # Flip normals to oppose the incoming ray; record inside/backface hits.
    backface = dot(d, normal) > 0.0
    flip = jnp.where(backface, -1.0, 1.0)[..., None]
    normal = normal * flip
    shading = shading * jnp.where(dot(d, shading) > 0.0, -1.0, 1.0)[..., None]
    return SurfaceInfo(
        point=point,
        normal=normal,
        shading_normal=shading,
        uv=uv,
        material=material,
        backface=backface,
        valid=hit.valid,
    )
