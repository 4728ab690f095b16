"""Strip sweep kernels for the GPU: Pallas with ``backend="triton"``.

The strip-interval traversal (:func:`solstice.ops.packet.
strip_interval_select`) gives every strip of rays its own list of
candidate blocks, sorted by slab entry distance.  The plain XLA form
(:func:`solstice.ops.packet.tri_blocks_closest` /
:func:`~solstice.ops.packet.tri_blocks_transmittance`) scans every
strip through all K slots and masks the steps past the strip's count.
Here one program owns one strip and walks only its own list in a
``lax.while_loop``:

* closest hit stops at the count, or once the next candidate's entry
  bound lies beyond every live ray's ``min(best t, scene-box exit)`` —
  exact, because the list is sorted by a lower bound on any hit in the
  block;
* transmittance stops at the count, or once every live ray's
  transmittance is exactly 0 (more occluders cannot change it).

Each step reads the candidate's packed slab from device memory in
``sub``-column chunks, loading only the rows its primitive family uses
(``packet.PRIM_ROWS``), so the (rays, sub) intermediates stay in
registers.  Rays are read in their natural (R, 3) layout, and each
program loads its own count, candidate ids and entry bounds.  One body
serves triangles, spheres and cylinders: the intersection math is
``packet.PRIM_CORES``, shared with the XLA form.

No gradient rule: the traversal runs on detached inputs
(:func:`solstice.ops.traverse.scene_closest_hit`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from solstice.constants import PARK_DIR, PARK_POS, T_FAR
from solstice.ops.packet import PRIM_CORES, PRIM_ROWS

__all__ = ["sweep_closest", "sweep_transmittance", "SUB", "NUM_WARPS",
           "NUM_STAGES"]

_BIG_I = 2**31 - 1

# Launch shape: slab columns per inner step, and Triton's warps per
# program and software-pipeline stages.  Not yet tuned on the card
# (ROADMAP S3).
SUB = 64
NUM_WARPS = 4
NUM_STAGES = 2


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _kernel(cand_ref, counts_ref, nearb_ref, o_ref, d_ref, tmax_ref,
            live_ref, packed_ref, *out_refs, prim, closest, ssb, block,
            sub, k_max, t_min):
    i = pl.program_id(0)
    rays = pl.ds(i * ssb, ssb)
    comp = {j: o_ref[rays, j][:, None] for j in range(3)}
    comp.update({4 + j: d_ref[rays, j][:, None] for j in range(3)})
    tmax = tmax_ref[rays]  # closest: scene-box exit; shadow: light
    live = live_ref[rays] > 0
    n = counts_ref[i]
    core = PRIM_CORES[prim]

    def slab_t(blk, c):
        """(ssb, sub) hit distances against columns [c*sub, c*sub+sub)
        of block ``blk``."""
        cols = pl.ds(pl.multiple_of(c * sub, sub), sub)
        w = {r: packed_ref[blk, r, cols][None, :] for r in PRIM_ROWS[prim]}
        return core(comp.__getitem__, w.__getitem__, t_min), cols

    n_sub = block // sub
    lane = jnp.arange(sub, dtype=jnp.int32)

    if closest:
        bt_ref, bi_ref, nv_ref = out_refs

        def cond(carry):
            k, _, _, done = carry
            entry = nearb_ref[i, jnp.minimum(k, k_max - 1)]
            return (k < n) & (entry < done)

        def body(carry):
            k, bt, bi, _ = carry
            blk = cand_ref[i, k]

            def chunk(c, acc):
                bt, bi = acc
                t, _ = slab_t(blk, c)
                c_min = jnp.min(t, axis=1)
                pid = blk * block + c * sub + lane
                c_idx = jnp.min(
                    jnp.where(t <= c_min[:, None], pid[None, :], _BIG_I),
                    axis=1,
                )
                better = c_min < bt  # first (lowest) primitive wins ties
                return (jnp.where(better, c_min, bt),
                        jnp.where(better, c_idx, bi))

            bt, bi = jax.lax.fori_loop(jnp.int32(0), jnp.int32(n_sub),
                                       chunk, (bt, bi))
            done = jnp.max(jnp.where(live, jnp.minimum(bt, tmax), 0.0))
            return k + 1, bt, bi, done

        init = (
            jnp.int32(0),
            jnp.full((ssb,), T_FAR, jnp.float32),
            jnp.full((ssb,), _BIG_I, jnp.int32),
            jnp.max(jnp.where(live, tmax, 0.0)),
        )
        k, bt, bi, _ = jax.lax.while_loop(cond, body, init)
        bt_ref[...] = bt
        bi_ref[...] = jnp.where(bi == _BIG_I, -1, bi)
        nv_ref[i] = k
        return

    tr_ref, nv_ref = out_refs

    def cond(carry):
        k, _, lit = carry
        return (k < n) & (lit > 0.0)

    def body(carry):
        k, tr, _ = carry
        blk = cand_ref[i, k]

        def chunk(c, tr):
            t, cols = slab_t(blk, c)
            # Product of the occluders' shadow factors (row 15) as a sum
            # of logs, since Pallas's Triton lowering has no product
            # reduction.  Exact for the opaque 0 (log -> -inf, exp -> 0)
            # and the clear 1; other factors are a few ulps from the
            # XLA scan's plain product.
            log_f = jnp.log(packed_ref[blk, 15, cols])[None, :]
            s = jnp.sum(jnp.where(t < tmax[:, None], log_f, 0.0), axis=1)
            return tr * jnp.exp(s)

        tr = jax.lax.fori_loop(jnp.int32(0), jnp.int32(n_sub), chunk, tr)
        return k + 1, tr, jnp.max(jnp.where(live, tr, 0.0))

    init = (jnp.int32(0), jnp.ones((ssb,), jnp.float32),
            jnp.max(live.astype(jnp.float32)))
    k, tr, _ = jax.lax.while_loop(cond, body, init)
    tr_ref[...] = tr
    nv_ref[i] = k


def _sweep(packed, o_s, d_s, tmax, live, cand, counts, nearb, t_min,
           prim, closest, interpret, sub):
    """Shared wrapper: pad strips to a power-of-two ray count with
    parked rays, flatten to the kernel's layout, launch one program per
    strip, and cut the padding off again."""
    n_strips, ssb = o_s.shape[:2]
    block = packed.shape[2]
    k_max = cand.shape[1]
    sub = min(sub, block)
    if not (_is_pow2(block) and _is_pow2(sub)):
        raise ValueError(
            f"sweep kernel needs power-of-two BLOCK and sub, got "
            f"{block} and {sub}"
        )
    ssb_p = _next_pow2(ssb)
    f32 = jnp.float32
    o_s, d_s, tmax = o_s.astype(f32), d_s.astype(f32), tmax.astype(f32)
    live = live.astype(jnp.int32)
    if ssb_p != ssb:
        pad = ssb_p - ssb
        o_s = jnp.concatenate(
            [o_s, jnp.broadcast_to(jnp.asarray(PARK_POS, f32),
                                   (n_strips, pad, 3))], axis=1)
        d_s = jnp.concatenate(
            [d_s, jnp.broadcast_to(jnp.asarray(PARK_DIR, f32),
                                   (n_strips, pad, 3))], axis=1)
        tmax = jnp.pad(tmax, ((0, 0), (0, pad)))
        live = jnp.pad(live, ((0, 0), (0, pad)))

    row = pl.BlockSpec((None, ssb_p), lambda i: (i, 0))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    ray_shape = (n_strips, ssb_p)
    if closest:
        out_shape = (jax.ShapeDtypeStruct(ray_shape, f32),
                     jax.ShapeDtypeStruct(ray_shape, jnp.int32),
                     jax.ShapeDtypeStruct((n_strips,), jnp.int32))
        out_specs = (row, row, whole)
    else:
        out_shape = (jax.ShapeDtypeStruct(ray_shape, f32),
                     jax.ShapeDtypeStruct((n_strips,), jnp.int32))
        out_specs = (row, whole)
    kernel = functools.partial(
        _kernel, prim=prim, closest=closest, ssb=ssb_p, block=block,
        sub=sub, k_max=k_max, t_min=float(t_min),
    )
    outs = pl.pallas_call(
        kernel,
        grid=(n_strips,),
        in_specs=[whole] * 8,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name=f"strip_sweep_{'closest' if closest else 'shadow'}_{prim}",
    )(
        cand.astype(jnp.int32), counts.astype(jnp.int32),
        nearb.astype(f32), o_s.reshape(-1, 3), d_s.reshape(-1, 3),
        tmax.reshape(-1), live.reshape(-1), packed.astype(f32),
    )
    return tuple(o[:, :ssb] if o.ndim == 2 else o for o in outs)


def sweep_closest(packed, o_s, d_s, t_cap, live, cand, counts, nearb,
                  t_min, prim: str = "tri", interpret: bool = False,
                  sub: int = SUB):
    """Closest hit over per-strip front-to-back candidate lists.

    packed (NB, 16, BLOCK) slabs (solstice.ops.packet.block_pack and
    friends); o_s/d_s (N, SSB, 3) rays, one row per strip; t_cap
    (N, SSB) per-ray upper bound on any hit (scene-box exit); live
    (N, SSB) bool; cand (N, K) block ids sorted by entry; counts (N,);
    nearb (N, K) ascending entry bounds.

    Returns (t (N, SSB), primitive index (N, SSB) with -1 = miss,
    visits (N,): candidate blocks each strip intersected).
    ``interpret=True`` runs the Pallas interpreter (tests on the CPU).
    """
    return _sweep(packed, o_s, d_s, t_cap, live, cand, counts, nearb,
                  t_min, prim, True, interpret, sub)


def sweep_transmittance(packed, o_s, d_s, t_max, live, cand, counts,
                        t_min, prim: str = "tri",
                        interpret: bool = False, sub: int = SUB):
    """Shadow transmittance over per-strip candidate lists: (tr (N, SSB)
    in [0, 1], visits (N,)).  Occluders closer than the per-ray
    ``t_max`` (N, SSB) multiply in their shadow factor (packed row 15).
    """
    nearb = jnp.zeros(cand.shape, jnp.float32)  # unused: no order
    return _sweep(packed, o_s, d_s, t_max, live, cand, counts, nearb,
                  t_min, prim, False, interpret, sub)
