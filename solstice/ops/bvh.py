"""BVH construction, refit, and stackless traversal.

Generalization of the reference's acceleration structure
(solr/engines/GPUKernel.cpp: compactBoxes / processBoxes /
processOutterBoxes — a two-level grid of AABBs with per-box skip indices
— traversed by GeometryIntersections.cuh: intersectionWithPrimitives via
the stackless "if ray misses box, jump to box.indexForNextBox" walk).

Redesign: a real N-level median-split LBVH over Morton-sorted primitives,
flattened in DFS preorder with skip ("rope") pointers — the same
stackless walk the reference uses, but on a log-depth tree instead of a
depth-2 grid.  The build runs host-side in NumPy (the analog of the
reference's CPU-side compactBoxes); refit for animated/optimized
geometry is a vectorized level-by-level JAX pass; traversal is a
`lax.while_loop` with per-ray node pointers, fully vectorized over rays
(each step: one gathered node test per ray + a LEAF_SIZE-wide vectorized
primitive test).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from solstice.constants import BVH_LEAF_SIZE, T_FAR
from solstice.ops import intersect as isect
from solstice.types import BVH

__all__ = [
    "build_bvh",
    "bvh_closest_hit",
    "bvh_transmittance",
    "bvh_refit",
    "pool_aabbs",
]

_AABB_PAD = 1e-5


# --------------------------------------------------------------------------
# Host-side build (NumPy — the analog of GPUKernel::compactBoxes)
# --------------------------------------------------------------------------


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v to every 3rd bit (Morton helper)."""
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit 3D Morton codes from points quantized into a 1024^3 grid."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroids - lo) / span) * 1023.0, 0, 1023).astype(np.uint32)
    return (
        (_expand_bits(q[:, 0]) << np.uint64(2))
        | (_expand_bits(q[:, 1]) << np.uint64(1))
        | _expand_bits(q[:, 2])
    )


def build_bvh(
    aabb_min: np.ndarray,
    aabb_max: np.ndarray,
    leaf_size: int = BVH_LEAF_SIZE,
    backend: str = "auto",
) -> Tuple[BVH, np.ndarray]:
    """Build a median-split LBVH over primitives given their AABBs.

    Args:
      aabb_min/aabb_max: (N, 3) float — per-primitive bounds.
      leaf_size: max primitives per leaf.
      backend: "auto" (native C++ builder when compilable, else NumPy),
        "native" (require solstice.native), or "numpy".
    Returns:
      (bvh, order): the flattened BVH (jnp arrays) and the permutation
      ``order`` such that leaf ``first_prim..first_prim+count`` ranges
      index the *reordered* pool ``pool[order]``.
    """
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    n = aabb_min.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over 0 primitives")

    if backend in ("auto", "native"):
        from solstice import native

        built = native.lbvh_build(aabb_min, aabb_max, leaf_size)
        if built is not None:
            order, starts_a, ends_a, skips_a, depths_a, nmin, nmax = built
            return (
                _assemble_bvh(
                    starts_a, ends_a, skips_a, depths_a, nmin, nmax, leaf_size
                ),
                order,
            )
        if backend == "native":
            raise RuntimeError("native LBVH builder unavailable (no g++?)")

    centroids = 0.5 * (aabb_min + aabb_max)
    order = np.argsort(morton_codes(centroids), kind="stable").astype(np.int32)
    smin = aabb_min[order]
    smax = aabb_max[order]

    # Preorder node ranges via explicit recursion (depth = O(log2 n)).
    starts, ends, skips, depths = [], [], [], []

    def rec(start: int, end: int, depth: int) -> None:
        i = len(starts)
        starts.append(start)
        ends.append(end)
        depths.append(depth)
        skips.append(-1)
        if end - start > leaf_size:
            mid = (start + end) // 2
            rec(start, mid, depth + 1)
            rec(mid, end, depth + 1)
        skips[i] = len(starts)

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        rec(0, n, 0)
    finally:
        sys.setrecursionlimit(old)

    starts_a = np.asarray(starts, np.int32)
    ends_a = np.asarray(ends, np.int32)
    skips_a = np.asarray(skips, np.int32)
    depths_a = np.asarray(depths, np.int32)
    counts = ends_a - starts_a
    is_leaf = counts <= leaf_size

    # Node AABBs: leaves via reduceat over sorted prims; inner nodes via
    # a reverse pass (children appear after their parent in preorder).
    k = len(starts)
    nmin = np.empty((k, 3), np.float32)
    nmax = np.empty((k, 3), np.float32)
    leaf_ids = np.nonzero(is_leaf)[0]
    # reduceat needs sorted, non-empty segments; ranges here are non-empty.
    nmin[leaf_ids] = np.minimum.reduceat(smin, starts_a[leaf_ids], axis=0)[
        : len(leaf_ids)
    ]
    nmax[leaf_ids] = np.maximum.reduceat(smax, starts_a[leaf_ids], axis=0)[
        : len(leaf_ids)
    ]
    for i in range(k - 1, -1, -1):
        if not is_leaf[i]:
            left = i + 1
            right = skips_a[left]
            nmin[i] = np.minimum(nmin[left], nmin[right])
            nmax[i] = np.maximum(nmax[left], nmax[right])
    nmin -= _AABB_PAD
    nmax += _AABB_PAD
    return (
        _assemble_bvh(starts_a, ends_a, skips_a, depths_a, nmin, nmax,
                      leaf_size),
        order,
    )


def _assemble_bvh(
    starts_a, ends_a, skips_a, depths_a, nmin, nmax, leaf_size: int
) -> BVH:
    """Assemble the BVH pytree from flattened-node intermediates (shared
    by the NumPy and native-C++ build paths)."""
    counts = ends_a - starts_a
    is_leaf = counts <= leaf_size
    leaf_ids = np.nonzero(is_leaf)[0]

    # Leaf-only view for packet culling, padded to a multiple of 128
    # lanes with inert count-0 entries parked far away.
    lmin, lmax = nmin[leaf_ids], nmax[leaf_ids]
    lc = 0.5 * (lmin + lmax)
    lr = 0.5 * np.linalg.norm(lmax - lmin, axis=-1)
    lfirst = starts_a[leaf_ids]
    lcount = counts[leaf_ids]
    n_leaves = len(leaf_ids)
    lpad = ((n_leaves + 127) // 128) * 128
    lc = np.concatenate([lc, np.full((lpad - n_leaves, 3), 1e30, np.float32)])
    lr = np.concatenate([lr, np.zeros(lpad - n_leaves, np.float32)])
    lfirst = np.concatenate(
        [lfirst, np.zeros(lpad - n_leaves, np.int32)]
    ).astype(np.int32)
    lcount = np.concatenate(
        [lcount, np.zeros(lpad - n_leaves, np.int32)]
    ).astype(np.int32)

    return BVH(
        aabb_min=jnp.asarray(nmin),
        aabb_max=jnp.asarray(nmax),
        skip=jnp.asarray(skips_a),
        first_prim=jnp.asarray(np.where(is_leaf, starts_a, -1).astype(np.int32)),
        prim_count=jnp.asarray(np.where(is_leaf, counts, 0).astype(np.int32)),
        depth=jnp.asarray(depths_a),
        leaf_center=jnp.asarray(lc),
        leaf_radius=jnp.asarray(lr),
        leaf_first=jnp.asarray(lfirst),
        leaf_count=jnp.asarray(lcount),
        max_depth=int(depths_a.max()),
        leaf_size=int(leaf_size),
    )


def pool_aabbs(scene, pool_code: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-primitive AABBs for a pool (host-side, NumPy)."""
    from solstice.ops.traverse import POOL_CYLINDER, POOL_SPHERE, POOL_TRIANGLE

    if pool_code == POOL_SPHERE:
        c = np.asarray(scene.spheres.center)
        r = np.asarray(scene.spheres.radius)[:, None]
        return c - r, c + r
    if pool_code == POOL_TRIANGLE:
        v0 = np.asarray(scene.triangles.v0)
        v1 = np.asarray(scene.triangles.v1)
        v2 = np.asarray(scene.triangles.v2)
        return (
            np.minimum(np.minimum(v0, v1), v2),
            np.maximum(np.maximum(v0, v1), v2),
        )
    if pool_code == POOL_CYLINDER:
        p0 = np.asarray(scene.cylinders.p0)
        p1 = np.asarray(scene.cylinders.p1)
        r = np.asarray(scene.cylinders.radius)[:, None]
        return np.minimum(p0, p1) - r, np.maximum(p0, p1) + r
    raise ValueError(f"pool {pool_code} is not BVH-accelerated")


# --------------------------------------------------------------------------
# Refit (JAX — for animated / gradient-updated geometry)
# --------------------------------------------------------------------------


def bvh_refit(bvh: BVH, prim_min, prim_max) -> BVH:
    """Recompute node AABBs for fixed topology (reference analog:
    re-running processBoxes bounds without re-partitioning).

    Level-by-level bottom-up: O(max_depth) vectorized passes.  Structure
    arrays (skip/first/count) carry no gradient; AABBs are recomputed
    from (possibly traced) primitive bounds, wrapped in stop_gradient —
    the BVH is a derived accelerator, not a differentiable quantity.
    """
    prim_min = jax.lax.stop_gradient(prim_min)
    prim_max = jax.lax.stop_gradient(prim_max)
    k = bvh.n_nodes
    leaf_size = bvh.leaf_size
    is_leaf = bvh.first_prim >= 0

    # Leaf AABBs: gather up to leaf_size prims per node, masked union.
    lane = jnp.arange(leaf_size)
    pidx = jnp.clip(bvh.first_prim[:, None] + lane[None, :], 0, prim_min.shape[0] - 1)
    mask = (lane[None, :] < bvh.prim_count[:, None])[..., None]  # (K, L, 1)
    gmin = jnp.where(mask, prim_min[pidx], jnp.inf).min(axis=1)
    gmax = jnp.where(mask, prim_max[pidx], -jnp.inf).max(axis=1)
    nmin = jnp.where(is_leaf[:, None], gmin, jnp.inf)
    nmax = jnp.where(is_leaf[:, None], gmax, -jnp.inf)

    left = jnp.arange(k) + 1
    left_c = jnp.clip(left, 0, k - 1)
    right_c = jnp.clip(bvh.skip[left_c], 0, k - 1)

    def level(carry, lvl):
        nmin, nmax = carry
        sel = (bvh.depth == lvl) & ~is_leaf
        umin = jnp.minimum(nmin[left_c], nmin[right_c])
        umax = jnp.maximum(nmax[left_c], nmax[right_c])
        nmin = jnp.where(sel[:, None], umin, nmin)
        nmax = jnp.where(sel[:, None], umax, nmax)
        return (nmin, nmax), None

    levels = jnp.arange(bvh.max_depth - 1, -1, -1)
    (nmin, nmax), _ = jax.lax.scan(level, (nmin, nmax), levels)
    return bvh.replace(aabb_min=nmin - _AABB_PAD, aabb_max=nmax + _AABB_PAD)


# --------------------------------------------------------------------------
# Traversal (JAX — vectorized per-ray stackless walk)
# --------------------------------------------------------------------------


def _leaf_t(scene, pool_code: int, o, d, pids, t_min):
    """t for matched (ray, leaf-lane) pairs; o/d (R,3), pids (R,L)."""
    from solstice.ops.traverse import (
        POOL_CYLINDER,
        POOL_SPHERE,
        POOL_TRIANGLE,
    )

    ob = o[..., None, :]
    db = d[..., None, :]
    if pool_code == POOL_SPHERE:
        p = scene.spheres
        return isect.sphere_t_p(ob, db, p.center[pids], p.radius[pids], t_min)
    if pool_code == POOL_TRIANGLE:
        p = scene.triangles
        return isect.triangle_t_p(
            ob, db, p.v0[pids], p.v1[pids], p.v2[pids], t_min
        )
    if pool_code == POOL_CYLINDER:
        p = scene.cylinders
        return isect.cylinder_t_p(
            ob, db, p.p0[pids], p.p1[pids], p.radius[pids], t_min
        )
    raise ValueError(pool_code)  # pragma: no cover


def _pool_size(scene, pool_code: int) -> int:
    from solstice.ops.traverse import (
        POOL_CYLINDER,
        POOL_SPHERE,
        POOL_TRIANGLE,
    )

    return {
        POOL_SPHERE: scene.spheres.radius.shape[0],
        POOL_TRIANGLE: scene.triangles.v0.shape[0],
        POOL_CYLINDER: scene.cylinders.radius.shape[0],
    }[pool_code]


def bvh_closest_hit(scene, bvh: BVH, pool_code: int, o, d, t_min, t_max,
                    active=None):
    """Closest hit within one BVH-accelerated pool.

    Stackless skip-pointer walk (reference: the box loop in
    intersectionWithPrimitives), vectorized over rays: every ray carries
    its own node pointer; each step gathers that node, slab-tests it, and
    — when it is a hit leaf — tests its LEAF_SIZE-wide primitive range.

    ``active`` (R,) bool: rays to walk; inactive rays start with an
    exhausted pointer, so an all-inactive call costs one while_loop
    condition check (the packet path's exactness-net usage).
    """
    k = bvh.n_nodes
    leaf_size = bvh.leaf_size
    n_prims = _pool_size(scene, pool_code)
    r_shape = o.shape[:-1]
    inv_d = 1.0 / jnp.where(jnp.abs(d) > 1e-12, d, 1e-12)
    lane = jnp.arange(leaf_size)
    t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, o.dtype), r_shape)

    def cond(state):
        ptr, _, _ = state
        return jnp.any(ptr < k)

    def body(state):
        ptr, best_t, best_i = state
        alive = ptr < k
        sp = jnp.clip(ptr, 0, k - 1)
        bmin = bvh.aabb_min[sp]
        bmax = bvh.aabb_max[sp]
        limit = jnp.minimum(best_t, t_max_arr)
        box_hit = isect.aabb_hit(o, inv_d, bmin, bmax, t_min, limit) & alive

        first = bvh.first_prim[sp]
        cnt = jnp.where(box_hit, bvh.prim_count[sp], 0)
        pids = jnp.clip(first[..., None] + lane, 0, n_prims - 1)
        t = _leaf_t(scene, pool_code, o, d, pids, t_min)  # (R, L)
        t = jnp.where(lane[None, :] < cnt[..., None], t, T_FAR)
        t = jnp.where(t <= limit[..., None], t, T_FAR)
        leaf_min = jnp.min(t, axis=-1)
        leaf_arg = jnp.argmin(t, axis=-1).astype(jnp.int32)
        better = leaf_min < best_t
        best_t = jnp.where(better, leaf_min, best_t)
        best_i = jnp.where(better, first + leaf_arg, best_i)

        is_inner = first < 0
        descend = box_hit & is_inner
        nxt = jnp.where(descend, sp + 1, bvh.skip[sp])
        ptr = jnp.where(alive, nxt, ptr)
        return ptr, best_t, best_i

    ptr0 = jnp.zeros(r_shape, jnp.int32)
    if active is not None:
        ptr0 = jnp.where(active, 0, k)
    init = (
        ptr0,
        jnp.full(r_shape, T_FAR, o.dtype),
        jnp.zeros(r_shape, jnp.int32),
    )
    _, best_t, best_i = jax.lax.while_loop(cond, body, init)
    return best_t, best_i


def bvh_transmittance(scene, bvh: BVH, pool_code: int, o, d, t_min, t_max,
                      active=None):
    """Shadow transmittance through one pool: product over every occluder
    in (t_min, t_max) of its material transparency (reference:
    processShadows' transparent-attenuation semantics).

    ``active``: as in :func:`bvh_closest_hit`."""
    from solstice.ops.traverse import _pool_material

    k = bvh.n_nodes
    leaf_size = bvh.leaf_size
    n_prims = _pool_size(scene, pool_code)
    r_shape = o.shape[:-1]
    inv_d = 1.0 / jnp.where(jnp.abs(d) > 1e-12, d, 1e-12)
    lane = jnp.arange(leaf_size)
    t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, o.dtype), r_shape)

    def cond(state):
        ptr, _ = state
        return jnp.any(ptr < k)

    def body(state):
        ptr, trans = state
        alive = ptr < k
        sp = jnp.clip(ptr, 0, k - 1)
        box_hit = (
            isect.aabb_hit(
                o, inv_d, bvh.aabb_min[sp], bvh.aabb_max[sp], t_min, t_max_arr
            )
            & alive
            & (trans > 1e-6)  # fully-shadowed rays stop traversing
        )
        first = bvh.first_prim[sp]
        cnt = jnp.where(box_hit, bvh.prim_count[sp], 0)
        pids = jnp.clip(first[..., None] + lane, 0, n_prims - 1)
        t = _leaf_t(scene, pool_code, o, d, pids, t_min)
        occludes = (
            (lane[None, :] < cnt[..., None])
            & (t < t_max_arr[..., None])
        )
        mat = _pool_material(scene, pool_code, pids)
        # Emissive primitives are light sources and never occlude shadow
        # rays (reference: processShadows skips the lamp primitive).
        f = jnp.where(
            scene.materials.emission[mat] > 0.0,
            1.0,
            scene.materials.transparency[mat],
        )
        trans = trans * jnp.prod(jnp.where(occludes, f, 1.0), axis=-1)

        descend = box_hit & (first < 0)
        nxt = jnp.where(descend, sp + 1, bvh.skip[sp])
        ptr = jnp.where(alive, nxt, ptr)
        return ptr, trans

    ptr0 = jnp.zeros(r_shape, jnp.int32)
    if active is not None:
        ptr0 = jnp.where(active, 0, k)
    init = (ptr0, jnp.ones(r_shape, o.dtype))
    _, trans = jax.lax.while_loop(cond, body, init)
    return trans
