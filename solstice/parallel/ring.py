"""Geometry-sharded ring rendering: the renderer's sequence-parallel
axis (SURVEY.md §2.4 / §5 "long-context analog", stretch row).

For scenes too large to replicate per chip, the TRIANGLE POOL is
sharded over the mesh and ray packets stay stationary while geometry
shards rotate around the ring via `ppermute` — structurally ring
attention with stationary queries (rays) and rotating keys (geometry).
After N steps every device has folded the closest hit of its rays
against every shard; shading then runs locally against the replicated
materials/lights (which are small — it is geometry that dominates
scene memory).

This mode intersects each shard with the chunked brute-force sweep
(`solstice.ops.intersect.triangle_t`): per-shard BVH/packet accel of a
rotating shard would be rebuilt N times per frame, and the mode exists
for capacity, not speed.  The tile-sharded replicated path
(solstice.parallel.render) remains the fast path whenever the scene
fits.

Numerical contract (tested on the 8-virtual-device CPU mesh):
ring_closest_hit == single-device brute force, bit-for-bit hit ids.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from solstice.constants import RAY_EPS, T_FAR
from solstice.ops import intersect as isect
from solstice.parallel.mesh import TILE_AXIS, make_mesh

__all__ = ["ring_closest_hit", "shard_triangles"]


def shard_triangles(triangles, n_dev: int):
    """Pad the triangle pool to a multiple of n_dev (degenerate padding
    never hits) and return (v0, v1, v2, global_base_count) ready to be
    sharded along axis 0."""
    n = triangles.v0.shape[0]
    pad = (-n) % n_dev
    def p(a):
        return jnp.pad(a, ((0, pad), (0, 0))) if pad else a
    return p(triangles.v0), p(triangles.v1), p(triangles.v2)


def ring_closest_hit(scene, o, d, mesh=None, t_min=RAY_EPS):
    """Closest triangle hit with geometry sharded over the mesh.

    o, d: (R, 3) rays, tile-sharded over the mesh like the forward
    renderer; the triangle pool is split into n_dev contiguous shards
    that rotate via ppermute.  Returns (t (R,), tri index (R,)) with
    GLOBAL triangle indices, identical to a replicated brute-force
    sweep.
    """
    if mesh is None:
        mesh = make_mesh()
    axes = tuple(mesh.axis_names)
    if len(axes) != 1:
        raise ValueError(
            "ring mode rotates shards over ONE axis; flatten the mesh "
            "(make_mesh) or ring over the chip axis per host"
        )
    n_dev = mesh.devices.size
    v0, v1, v2 = shard_triangles(scene.triangles, n_dev)
    shard_n = v0.shape[0] // n_dev

    def body(o, d, v0s, v1s, v2s):
        # v*s: this device's (shard_n, 3) geometry shard.
        def linear_index():
            idx = jax.lax.axis_index(axes[0])
            for a in axes[1:]:
                idx = idx * jax.lax.axis_size(a) + jax.lax.axis_index(a)
            return idx

        my = linear_index()

        def step(carry, k):
            best_t, best_i, sv0, sv1, sv2 = carry
            # The shard currently held started at device (my + k) % N.
            owner = jax.lax.rem(my + k, jnp.int32(n_dev)).astype(
                jnp.int32
            )
            t = isect.triangle_t(o, d, sv0, sv1, sv2, t_min)  # (R, S)
            c_min = jnp.min(t, axis=-1)
            c_arg = jnp.argmin(t, axis=-1).astype(jnp.int32)
            c_idx = (owner * shard_n + c_arg).astype(jnp.int32)
            better = c_min < best_t
            best_t = jnp.where(better, c_min, best_t)
            best_i = jnp.where(better, c_idx, best_i)
            # Rotate: receive the next shard from the right neighbor.
            perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
            sv0, sv1, sv2 = (
                jax.lax.ppermute(x, axes[0], perm)
                for x in (sv0, sv1, sv2)
            )
            return (best_t, best_i, sv0, sv1, sv2), None

        init = (
            jnp.full(o.shape[:1], T_FAR, o.dtype),
            jnp.full(o.shape[:1], -1, jnp.int32),
            v0s, v1s, v2s,
        )
        (best_t, best_i, *_), _ = jax.lax.scan(
            step, init, jnp.arange(n_dev, dtype=jnp.int32)
        )
        return best_t, best_i

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(P(axes), P(axes), P(axes), P(axes), P(axes)),
        out_specs=(P(axes), P(axes)),
        check_vma=False,
    )
    return fn(o, d, v0, v1, v2)
