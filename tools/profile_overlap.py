"""Capture a jax.profiler trace of the reduce-scatter train step on the
8-virtual-device CPU mesh and report whether the gradient collective
overlaps backward compute.

Writes a TensorBoard/Perfetto trace directory and prints a summary of
collective vs compute event spans parsed from the trace.  Run:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/profile_overlap.py [trace_dir]
"""

import glob
import gzip
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, repo)

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import optax


def main(out_dir=None):
    from solstice.utils.cache import enable_compile_cache

    enable_compile_cache()
    if out_dir is None:
        import tempfile

        out_dir = os.path.join(tempfile.gettempdir(), "overlap_trace")
    import __graft_entry__ as g
    import solstice as st
    from solstice.parallel import (
        init_zero_opt_state, make_mesh, make_sharded_train_step,
        shard_render,
    )

    mesh = make_mesh(8)
    scene = g._flagship_builder(n_extra_tris=96).build(bvh_threshold=64)
    camera = st.Camera.create(position=(0.0, 0.0, -1.6), fov=1.1)
    cfg = st.RenderConfig(width=64, height=64, max_bounces=2,
                          packet_tile_w=16, packet_tile_h=2)
    img, _ = jax.jit(lambda s, c: shard_render(s, c, cfg, mesh))(
        scene, camera
    )
    target = np.asarray(img)[..., :3] * 0.8

    opt = optax.adam(1e-2)
    step, _ = make_sharded_train_step(
        scene, camera, cfg, mesh, opt, grad_reduce="reduce_scatter"
    )
    state = init_zero_opt_state(scene, opt, mesh)
    params = scene.params
    # Warm up (compile outside the trace).
    params, state, loss = step(params, state, target)
    jax.block_until_ready((params, state, loss))

    with jax.profiler.trace(out_dir):
        for _ in range(3):
            params, state, loss = step(params, state, target)
        jax.block_until_ready((params, state, loss))
    print(f"trace written to {out_dir}")
    summarize(out_dir)


def summarize(out_dir):
    """Parse the trace: sum spans of collective ops vs other compute and
    measure how much of the collective time overlaps compute on OTHER
    threads (the latency-hiding claim)."""
    paths = glob.glob(
        os.path.join(out_dir, "plugins/profile/*/*.trace.json.gz")
    )
    if not paths:
        print("no trace json found (older jax?); inspect with xprof")
        return
    with gzip.open(sorted(paths)[-1], "rt") as fh:
        trace = json.load(fh)
    events = [
        e for e in trace.get("traceEvents", [])
        if e.get("ph") == "X" and "name" in e and "dur" in e
    ]
    coll_keys = ("reduce-scatter", "all-gather", "all-reduce",
                 "collective", "psum")
    coll = [e for e in events
            if any(k in e["name"].lower() for k in coll_keys)]
    comp = [e for e in events
            if not any(k in e["name"].lower() for k in coll_keys)]
    coll_t = sum(e["dur"] for e in coll) / 1e3
    comp_t = sum(e["dur"] for e in comp) / 1e3

    def spans(ev):
        return [(e["ts"], e["ts"] + e["dur"]) for e in ev]

    def overlap(a, b):
        """Total time in spans `a` that intersects any span in `b`."""
        total = 0.0
        b = sorted(b)
        for s0, s1 in sorted(a):
            for t0, t1 in b:
                lo, hi = max(s0, t0), min(s1, t1)
                if hi > lo:
                    total += hi - lo
                if t0 > s1:
                    break
        return total / 1e3

    ov = overlap(spans(coll), spans(comp))
    print(f"collective events: {len(coll)}  total {coll_t:.2f} ms")
    print(f"compute events:    {len(comp)}  total {comp_t:.2f} ms")
    if coll_t > 0:
        print(f"collective time overlapping compute: {ov:.2f} ms "
              f"({100 * ov / coll_t:.0f}% of collective time)")


if __name__ == "__main__":
    main(*sys.argv[1:])
