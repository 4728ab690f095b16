#!/usr/bin/env python
"""BASELINE config #5 artifact: 1M-triangle scene, 1080p STEREO pair,
tile-sharded rendering with gradient all-reduce.

Two measurements, one JSON artifact (ARTIFACT_stereo1080p.json):

  real chip   the bench's 1M-tri terrain at 1920x1080 SIDE_BY_SIDE
              stereo (the reference's k_3DVisionRenderer analog —
              ops/camera.py picks the eye per pixel column), rendered
              on the card through the packet path; rays/s + frame time.
  virtual     subprocess on 8 virtual CPU devices: the SAME stereo
              config (reduced triangle count for CPU time) rendered
              (a) row-sharded over the mesh via shard_render and
              (b) on one device — digests must match bitwise-close;
              plus ONE sharded inverse-rendering train step whose
              scene-parameter gradients all-reduce (psum) across the
              mesh at 480x288 stereo (the gradient-all-reduce clause).

Tile shape note: 1080 rows shard 8 ways into 135-row bands, so packet
tiles are 32x9 (288 rays = nine 32-ray strips, one pixel row each) —
the same cfg is used on the real chip so the numbers compare.

    python tools/stereo_1080p.py            # full artifact
    SOLR_STEREO_VIRT_TRIS=50000 python tools/stereo_1080p.py
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TRIS = int(os.environ.get("SOLR_BENCH_TRIS", 1_000_000))
VIRT_TRIS = int(os.environ.get("SOLR_STEREO_VIRT_TRIS", 50_000))
W, H = 1920, 1080
ARTIFACT = os.path.join(REPO, "ARTIFACT_stereo1080p.json")


def _cfg_stereo(width=W, height=H, tile_h=9):
    import solstice as st

    return dict(
        width=width, height=height, max_bounces=2,
        camera_mode=st.CameraMode.SIDE_BY_SIDE,
        gradient_background=True,
        # Sharded runs need 32x9 tiles (9 divides the 135-row 8-way
        # device bands); the single-card run uses 32x8 (256 rays, the
        # tile size every other frame uses).
        packet_tile_w=32, packet_tile_h=tile_h,
    )


def _build(n_tris, width=W, height=H, tile_h=9):
    import bench as bench_mod
    import dataclasses
    import solstice as st

    bench_mod.N_TRIS = n_tris
    bench_mod.WIDTH, bench_mod.HEIGHT = width, height
    scene, cam, cfg = bench_mod.build_scene()
    cfg = dataclasses.replace(cfg, **_cfg_stereo(width, height, tile_h))
    return scene, cam, cfg


def real_chip():
    import jax

    from solstice.utils.cache import enable_compile_cache

    enable_compile_cache(min_compile_secs=5)
    import jax.numpy as jnp
    import numpy as np

    from solstice.ops.render import render_sample

    scene, cam, cfg = _build(TRIS, tile_h=8)  # single-chip: 1080 = 135*8

    def frame(scene, cam):
        img, _ = render_sample(scene, cam, cfg)
        return jnp.sum(img), img

    fn = jax.jit(frame)
    t0 = time.time()
    digest, img = fn(scene, cam)
    digest = float(np.asarray(digest))
    compile_s = time.time() - t0
    assert np.isfinite(digest)
    best = float("inf")
    for _ in range(2):
        t0 = time.time()
        float(np.asarray(fn(scene, cam)[0]))
        best = min(best, time.time() - t0)
    n_lights = scene.lights.position.shape[0]
    rays = cfg.n_pixels * cfg.max_bounces * (1 + n_lights)
    try:
        from solstice.io.image import save_image

        import tempfile

        save_image(os.path.join(tempfile.gettempdir(),
                                "solr_stereo_1080p.png"),
                   np.asarray(img)[..., :3])
    except Exception:
        pass
    return {
        "config": f"{TRIS} tris {W}x{H} side-by-side stereo "
                  f"{cfg.max_bounces}b",
        "device": str(jax.devices()[0]),
        "frame_ms": round(best * 1000, 1),
        "rays_per_s": round(rays / best, 1),
        "compile_s": round(compile_s, 1),
        "digest": digest,
    }


def virtual_sharded():
    """Child process (8 virtual CPU devices): sharded == single-device
    digest at 1080p stereo + one all-reduced sharded train step."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import optax

    from solstice.ops.render import render_sample
    from solstice.parallel import (
        make_mesh, make_sharded_train_step, shard_render,
    )

    scene, cam, cfg = _build(VIRT_TRIS)
    mesh = make_mesh()
    n_dev = mesh.devices.size
    img_s, _ = jax.jit(lambda s, c: shard_render(s, c, cfg, mesh))(
        scene, cam
    )
    img_1, _ = jax.jit(
        lambda s, c: render_sample(s, c, cfg)
    )(scene, cam)
    d_s = float(np.asarray(img_s).sum())
    d_1 = float(np.asarray(img_1).sum())
    rel = abs(d_s - d_1) / max(abs(d_1), 1e-9)
    pix_ok = bool(np.allclose(np.asarray(img_s), np.asarray(img_1),
                              atol=1e-5))

    # Gradient all-reduce: one sharded train step at 480x288 stereo
    # (rows shard 8 ways into 36-row bands; 9 divides 36).
    scene2, cam2, cfg2 = _build(VIRT_TRIS, width=480, height=288)
    opt = optax.adam(1e-2)
    step, _ = make_sharded_train_step(
        scene2, cam2, cfg2, mesh, opt, grad_reduce="psum"
    )
    # psum mode keeps the optimizer state replicated over the params
    # pytree (ZeRO/flat state is the reduce_scatter mode's contract).
    state = opt.init(scene2.params)
    target = jnp.asarray(np.asarray(
        jax.jit(lambda s, c: render_sample(s, c, cfg2))(scene2, cam2)[0]
    )[..., :3])
    params, state, loss = step(scene2.params, state, target)
    print(json.dumps({
        "devices": n_dev,
        "sharded_vs_single_digest_rel": rel,
        "pixelwise_allclose": pix_ok,
        "virt_tris": VIRT_TRIS,
        "train_step_loss_finite": bool(np.isfinite(float(loss))),
        "train_step_grad_reduce": "psum (all-reduce)",
    }))


def main():
    if os.environ.get("SOLR_STEREO_CHILD"):
        virtual_sharded()
        return
    result = {"artifact": "BASELINE config #5: 1080p stereo pair, "
                          "tile-sharded, gradient all-reduce"}
    try:
        result["real_chip"] = real_chip()
    except Exception as e:
        result["real_chip"] = {"error": str(e)[:300]}
    env = dict(os.environ, SOLR_STEREO_CHILD="1", JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8"
                        ).strip()
    # The CPU child sweeps through the XLA strip path, whose per-step
    # gather is (strips, 16, BLOCK): smaller blocks + lists keep the
    # digest check to minutes (exactness is certificate-guaranteed at
    # any width, so these are pure cost knobs).
    env.setdefault("SOLR_PACKET_BLOCK", "128")
    env.setdefault("SOLR_BENCH_K", "32")
    try:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__)], env=env,
            capture_output=True, timeout=3000,
        )
        line = out.stdout.decode().strip().splitlines()[-1]
        result["virtual_8dev"] = json.loads(line)
    except Exception as e:
        result["virtual_8dev"] = {"error": str(e)[:300]}
    with open(ARTIFACT, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
