#!/usr/bin/env python
"""Stage-level timing of strip_interval_select on the card: which of
(tile cull + tile top_k | bounds gather | per-ray slabs | strip reduce |
strip top_k + compact) owns the selection time.

    SOLR_BENCH_TRIS=200000 SOLR_BENCH_WIDTH=256 SOLR_BENCH_HEIGHT=256 \
        SOLR_PACKET_BLOCK=512 python tools/probe_select.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from solstice.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=5)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def timeit(fn, *args, reps=5):
    out = fn(*args)
    sync = lambda o: np.asarray(jax.tree.leaves(o)[0]).ravel()[:1]
    t0 = time.time()
    sync(out)
    compile_s = time.time() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.time()
        sync(fn(*args))
        best = min(best, time.time() - t0)
    return best * 1000, compile_s


def main():
    import bench as bench_mod
    from solstice.constants import T_FAR
    from solstice.ops import packet as pk
    from solstice.ops.camera import camera_rays

    scene, cam, cfg = bench_mod.build_scene()
    accel = scene.tri_accel
    sb = cfg.packet_rays
    o, d = camera_rays(cam, cfg)
    perm, _ = pk.tile_permutation(
        cfg.width, cfg.height, cfg.packet_tile_w, cfg.packet_tile_h
    )
    o_t = o[perm].reshape(-1, sb, 3)
    d_t = d[perm].reshape(-1, sb, 3)
    live = jnp.ones(o_t.shape[:2], bool)
    bb = accel.block_bounds
    nb = bb.shape[0]
    kt = min(cfg.packet_tile_cand, nb)
    ks = min(cfg.packet_max_blocks, kt)
    big = 1.0e30
    g = pk.strips_per_tile(sb)
    s_tiles = o_t.shape[0]

    def cull_topk(o_t, d_t):
        po, ro, axis, cos_g = pk.make_bundles(o_t, d_t, live)
        mask, near = pk.cull_blocks(po, ro, axis, cos_g, bb[:, 0:3],
                                    bb[:, 3:6])
        mask = mask & jnp.any(live, axis=1)[:, None]
        score = jnp.where(mask, -near, -big)
        topv, topi = jax.lax.top_k(score, min(kt + 1, nb))
        return topv, topi

    topv, topi = jax.jit(cull_topk)(o_t, d_t)
    tile_cand = topi[:, :kt]

    def gather(tile_cand):
        return jnp.take(bb, tile_cand, axis=0)

    bbg = jax.jit(gather)(tile_cand)

    def slabs(o_t, d_t, bbg):
        return pk.slab_entries_g(o_t, d_t, bbg, 1e-4)

    entry, hitm = jax.jit(slabs)(o_t, d_t, bbg)

    def strip_reduce(entry, hitm):
        e = jnp.where(hitm, entry, big)
        return e.reshape(s_tiles, g, sb // g, kt).min(axis=2)

    e_s = jax.jit(strip_reduce)(entry, hitm)

    def strip_topk(e_s):
        v2, i2 = jax.lax.top_k(-e_s, min(ks + 1, kt))
        sel = i2[..., :ks]
        valid2 = v2[..., :ks] > -big * 0.5
        cand = jnp.take_along_axis(
            jnp.broadcast_to(tile_cand[:, None, :], (s_tiles, g, kt)),
            sel, axis=-1,
        )
        return (jnp.where(valid2, cand, 0).astype(jnp.int32),
                valid2.sum(axis=-1).astype(jnp.int32),
                jnp.where(valid2, -v2[..., :ks], T_FAR))

    def full(o_t, d_t):
        return pk.strip_interval_select(o_t, d_t, live, accel, kt, ks,
                                        1e-4)[0]

    stages = [
        ("cull+tile_topk", jax.jit(cull_topk), (o_t, d_t)),
        ("bounds_gather", jax.jit(gather), (tile_cand,)),
        ("per_ray_slabs", jax.jit(slabs), (o_t, d_t, bbg)),
        ("strip_reduce", jax.jit(strip_reduce), (entry, hitm)),
        ("strip_topk+compact", jax.jit(strip_topk), (e_s,)),
        ("FULL select", jax.jit(full), (o_t, d_t)),
    ]
    for name, fn, args in stages:
        ms, cs = timeit(fn, *args)
        print(json.dumps({"stage": name, "run_ms": round(ms, 2),
                          "compile_s": round(cs, 1)}), flush=True)


if __name__ == "__main__":
    main()
