"""Scaling harness: rays/s at 1 chip, all local chips, and (when
launched multi-process) across hosts (BASELINE.json north-star: report
scaling points at 1 chip / 1 host / >=2 hosts, >=85% linear to 2 hosts).

Single-host usage:      python bench_scaling.py
Multi-host usage:       SOLR_COORDINATOR=host0:1234 SOLR_NUM_PROCESSES=2 \
                        SOLR_PROCESS_ID=<i> python bench_scaling.py

On a 1-chip environment the multi-device points cannot be measured, so
the harness additionally SUBPROCESSES itself onto an 8-virtual-device
CPU backend (2 "hosts" x 4 "chips") and validates that the full
('host','chip') sharded render + ZeRO train step compile, run, and match
the single-device image — the compile-level guarantee that the code is
ready for a real slice.

Prints ONE JSON line with a "points" list and (when measurable) the
scaling efficiency.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _measure(n_frames: int = 3):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from solstice.utils.cache import enable_compile_cache

    enable_compile_cache(min_compile_secs=5)

    import bench as bench_mod
    from solstice.parallel import (
        initialize_distributed, make_host_chip_mesh, make_mesh, shard_render,
    )

    info = initialize_distributed()
    bench_mod.N_TRIS = int(os.environ.get("SOLR_SCALING_TRIS", 200_000))
    bench_mod.WIDTH = bench_mod.HEIGHT = int(
        os.environ.get("SOLR_SCALING_RES", 256)
    )
    scene, cam, cfg = bench_mod.build_scene()
    n_lights = scene.lights.position.shape[0]
    rays = cfg.n_pixels * cfg.max_bounces * (1 + n_lights)

    def rate(mesh):
        fn = jax.jit(
            lambda s, c: jnp.sum(shard_render(s, c, cfg, mesh)[0])
        )
        d = float(np.asarray(fn(scene, cam)))  # compile + sync
        assert np.isfinite(d)
        best = float("inf")
        for _ in range(n_frames):
            t0 = time.time()
            float(np.asarray(fn(scene, cam)))
            best = min(best, time.time() - t0)
        return rays / best

    points = []
    n_local = len(jax.local_devices())
    n_global = len(jax.devices())
    r1 = rate(make_mesh(1))
    points.append({"devices": 1, "label": "1 chip", "rays_per_s": round(r1)})
    if n_global > 1:
        rn = rate(
            make_host_chip_mesh() if info["process_count"] > 1
            else make_mesh()
        )
        label = (
            f"{info['process_count']} hosts" if info["process_count"] > 1
            else "1 host"
        )
        points.append({
            "devices": n_global, "label": label, "rays_per_s": round(rn),
            "efficiency_vs_linear": round(rn / (r1 * n_global), 4),
        })
    return {
        "points": points,
        "process_info": info,
        "config": f"{bench_mod.N_TRIS} tris {bench_mod.WIDTH}^2 "
                  f"{cfg.max_bounces}b",
    }


def _cpu_mesh_dryrun():
    """Child-process validation of the multi-host code path on 8 virtual
    CPU devices arranged as 2 hosts x 4 chips."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    import solstice as st
    from solstice.ops.render import render_sample
    from solstice.parallel import (
        init_zero_opt_state, make_host_chip_mesh, make_sharded_train_step,
        shard_render,
    )
    import optax

    b = st.SceneBuilder()
    m = b.add_material(color=(0.7, 0.3, 0.2, 1.0))
    for i in range(6):
        b.add_sphere((i - 2.5, 0.0, 3.0), 0.5, m)
    b.add_light((0, 5, 0))
    scene = b.build()
    cam = st.Camera.create()
    cfg = st.RenderConfig(width=32, height=32, max_bounces=2)
    mesh = make_host_chip_mesh(n_hosts=2)
    img_s, _ = jax.jit(lambda s, c: shard_render(s, c, cfg, mesh))(scene, cam)
    img_1, _ = jax.jit(render_sample, static_argnums=2)(scene, cam, cfg)
    ok = bool(np.allclose(np.asarray(img_s), np.asarray(img_1), atol=1e-6))

    opt = optax.adam(1e-2)
    step, _ = make_sharded_train_step(
        scene, cam, cfg, mesh, opt, grad_reduce="reduce_scatter"
    )
    state = init_zero_opt_state(scene, opt, mesh)
    params, state, loss = step(
        scene.params, state, jnp.asarray(np.asarray(img_1)[..., :3])
    )
    ok = ok and bool(np.isfinite(float(loss)))
    print(json.dumps({"host_chip_dryrun_ok": ok, "devices": 8, "hosts": 2}))


def main():
    if os.environ.get("SOLR_SCALING_CHILD"):
        _cpu_mesh_dryrun()
        return
    result = _measure()
    # 1-chip environment: validate the multi-host path on a virtual mesh.
    if len(result["points"]) == 1:
        env = dict(os.environ)
        env["SOLR_SCALING_CHILD"] = "1"
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        ).strip()
        try:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__)],
                env=env, capture_output=True, timeout=900,
            )
            line = out.stdout.decode().strip().splitlines()[-1]
            result["virtual_multihost"] = json.loads(line)
        except Exception as e:
            result["virtual_multihost"] = {"error": str(e)[:200]}
    # Kill-one-host fault injection (SURVEY.md section 5 failure
    # detection; VERDICT r03 item 6): SIGKILL one simulated host
    # mid-frame, assert stall detection + checkpoint resume + a
    # bit-identical final frame.  Opt out with SOLR_SCALING_NO_FAULT=1.
    if not os.environ.get("SOLR_SCALING_NO_FAULT"):
        env = dict(os.environ, JAX_PLATFORMS="cpu", SOLR_FAULT_RES="48")
        try:
            out = subprocess.run(
                [sys.executable,
                 os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tools", "fault_injection.py")],
                env=env, capture_output=True, timeout=600,
            )
            line = out.stdout.decode().strip().splitlines()[-1]
            result["fault_injection"] = json.loads(line)
        except Exception as e:
            result["fault_injection"] = {"error": str(e)[:200]}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
