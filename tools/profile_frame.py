#!/usr/bin/env python
"""Frame-time attribution on the card: each phase of the packet
traversal compiles and times STANDALONE on the same inputs the frame
sees —

    select     strip-interval candidate selection (dense cull + per-ray
               slabs + per-strip top-k)
    closest    full closest-hit traversal (selection + strip sweep + net)
    shadow     full shadow-transmittance traversal toward light 0
    frame      the whole jitted frame (render_sample digest)

plus the XLA cost-analysis roofline AND bytes_accessed for each phase
(the byte-diet metric).  The gap
between sum(phases) and frame ~ shading/XLA glue.  One JSON line per
phase.

    python tools/profile_frame.py                 # bench scene 1M/512
    SOLR_BENCH_TRIS=200000 SOLR_BENCH_WIDTH=256 \
        python tools/profile_frame.py             # faster iteration
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


def _time(fn, *args, repeats=3):
    t0 = time.time()
    out = fn(*args)
    float(np.asarray(jax.tree.leaves(out)[0]).sum())
    compile_s = time.time() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.time()
        float(np.asarray(jax.tree.leaves(fn(*args))[0]).sum())
        best = min(best, time.time() - t0)
    return compile_s, best


def main():
    import bench as bench_mod
    from solstice.constants import RAY_EPS
    from solstice.ops import packet as pk
    from solstice.ops.camera import camera_rays
    from solstice.ops.render import render_sample
    from solstice.ops.traverse import (
        _tri_packet_closest, _tri_packet_transmittance,
    )

    scene, cam, cfg = bench_mod.build_scene()
    accel = scene.tri_accel
    sb = cfg.packet_rays
    spec = cfg.packet_spec()
    o, d = camera_rays(cam, cfg)
    perm, _ = pk.tile_permutation(
        cfg.width, cfg.height, cfg.packet_tile_w, cfg.packet_tile_h
    )
    o_p, d_p = o[perm], d[perm]
    o_t = o_p.reshape(-1, sb, 3)
    d_t = d_p.reshape(-1, sb, 3)
    results = {}

    def select(o_t, d_t):
        live = jnp.ones(o_t.shape[:2], bool)
        return pk.strip_interval_select(
            o_t, d_t, live, accel, cfg.packet_tile_cand,
            cfg.packet_max_blocks, RAY_EPS,
        )[0]

    bytes_by_phase = {}

    def record(name, fn, *args):
        # Print incrementally: on slow-compile days a later phase can
        # outlive the harness timeout — earlier numbers must survive.
        results[name] = _time(fn, *args)
        rec = {
            "phase": name,
            "run_ms": round(results[name][1] * 1000, 1),
            "compile_s": round(results[name][0], 1),
        }
        try:
            from solstice.utils.profiling import cost_summary

            c = cost_summary(fn, *args)
            bytes_by_phase[name] = round(c["bytes_accessed"] / 1e9, 3)
            rec["bytes_gb"] = bytes_by_phase[name]
            rec["flops_g"] = round(c["flops"] / 1e9, 2)
        except Exception:
            pass
        print(json.dumps(rec), flush=True)

    record("select", jax.jit(select), o_t, d_t)

    def closest(o_p, d_p):
        return _tri_packet_closest(scene, o_p, d_p, RAY_EPS, spec)[0]

    record("closest", jax.jit(closest), o_p, d_p)

    lpos = scene.lights.position[0]

    def shadow(o_p, d_p):
        to_l = lpos[None, :] - o_p
        dist = jnp.sqrt(jnp.maximum(jnp.sum(to_l * to_l, -1), 1e-12))
        ldir = to_l / dist[:, None]
        return _tri_packet_transmittance(
            scene, o_p, ldir, dist - RAY_EPS, RAY_EPS, spec
        )

    record("shadow", jax.jit(shadow), o_p, d_p)

    def frame(scene, cam):
        img, _ = render_sample(scene, cam, cfg)
        return jnp.sum(img)

    record("frame", jax.jit(frame), scene, cam)

    try:
        from solstice.utils.profiling import cost_summary

        cost = cost_summary(frame, scene, cam)
        roof = {"roofline_ms": round(cost["roofline_s"] * 1000, 2),
                "bound": cost["bound"],
                "bytes_gb": round(cost["bytes_accessed"] / 1e9, 2)}
    except Exception as e:
        roof = {"error": str(e)[:120]}

    out = {
        "config": f"{bench_mod.N_TRIS} tris {cfg.width}x{cfg.height} "
                  f"{cfg.max_bounces}b K={cfg.packet_max_blocks} "
                  f"Kt={cfg.packet_tile_cand}",
        "phases_ms": {
            k: round(run * 1000, 1) for k, (c, run) in results.items()
        },
        "compile_s": {
            k: round(c, 1) for k, (c, run) in results.items()
        },
        "roofline": roof,
        "bytes_by_phase_gb": bytes_by_phase,
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
