"""Offline viewer / render CLI.

Analog of the reference's GLUT viewer (apps/sol-r/main.cpp:
the display/keyboard/idle loop blitting the engine bitmap).  Compute
hosts are headless, so the viewer renders demo scenes (or .irt/.obj/.pdb/.swc
files) to PNG frames — single stills, progressive refinement, or
animation sequences — with the same camera/post-processing controls the
reference bound to hotkeys.

  python -m solstice.viewer --scene cornell --out cornell.png
  python -m solstice.viewer --scene cubes --frames 24 --out anim/
  python -m solstice.viewer --file model.obj --width 512 --height 512
  python -m solstice.viewer --scene cornell --mode anaglyph --spp 8
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

import solstice as st
from solstice.io.image import save_image


def build_from_file(path: str):
    from solstice.io import load_obj, load_pdb, load_scene, load_swc

    ext = os.path.splitext(path)[1].lower()
    if ext == ".irt":
        scene, camera = load_scene(path)
        return scene, camera or st.Camera.create()
    b = st.SceneBuilder()
    if ext == ".obj":
        load_obj(path, b, scale=1.5)
    elif ext == ".pdb":
        load_pdb(path, b, scale=0.2)
    elif ext == ".swc":
        load_swc(path, b, scale=0.02)
    else:
        raise SystemExit(f"unsupported file type: {ext}")
    from solstice.types import PlaneAxis, ProceduralKind

    floor = b.add_material(
        color=(0.85, 0.85, 0.85, 1.0),
        procedural=ProceduralKind.CHECKER, procedural_scale=8.0,
    )
    b.add_plane(PlaneAxis.XZ, (0.0, -1.8, 0.0), (12.0, 12.0), floor)
    b.add_light((5.0, 8.0, -5.0))
    return b.build(), st.Camera.create(position=(0.0, 0.5, -4.0), fov=0.9)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default=None,
                    help="demo scene name (see --list)")
    ap.add_argument("--file", default=None,
                    help=".obj / .pdb / .swc / .irt to view")
    ap.add_argument("--list", action="store_true",
                    help="list demo scenes and exit")
    ap.add_argument("--out", default="frame.png")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--spp", type=int, default=1,
                    help="progressive samples to accumulate")
    ap.add_argument("--frames", type=int, default=1,
                    help="animation frames (scene.animate per frame)")
    ap.add_argument("--mode", default="mono",
                    choices=["mono", "anaglyph", "sidebyside", "fisheye"])
    ap.add_argument("--postfx", default="none",
                    choices=["none", "dof", "ao"])
    ap.add_argument("--save-irt", default=None,
                    help="also serialize the scene to this .irt path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="progressive mode: save the accumulation "
                    "buffer + RNG here every --checkpoint-every samples")
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--resume", action="store_true",
                    help="resume the progressive render from the "
                    "latest checkpoint in --checkpoint-dir")
    ap.add_argument("--metrics", default=None,
                    help="append per-sample/per-frame metrics JSONL "
                    "(rays/s, sample index) to this path")
    ap.add_argument("--tile-rows", type=int, default=0,
                    help="still mode: render in row-band chunks of this "
                    "many rows, checkpointing each into "
                    "--checkpoint-dir — a killed render resumes at the "
                    "first incomplete chunk (tile-granular resume)")
    args = ap.parse_args(argv)
    from solstice.utils.cache import enable_compile_cache

    enable_compile_cache()

    from solstice.scenes import SCENE_REGISTRY, make_scene

    if args.list:
        for name in sorted(SCENE_REGISTRY):
            print(name)
        return

    mode = {
        "mono": st.CameraMode.MONO,
        "anaglyph": st.CameraMode.ANAGLYPH,
        "sidebyside": st.CameraMode.SIDE_BY_SIDE,
        "fisheye": st.CameraMode.FISHEYE,
    }[args.mode]
    postfx = {
        "none": st.PostFxMode.NONE,
        "dof": st.PostFxMode.DEPTH_OF_FIELD,
        "ao": st.PostFxMode.AMBIENT_OCCLUSION,
    }[args.postfx]
    cfg = st.RenderConfig(
        width=args.width,
        height=args.height,
        max_bounces=args.bounces,
        camera_mode=mode,
        postfx=st.PostFxConfig(mode=postfx),
        antialias_jitter=args.spp > 1,
    )

    demo = None
    if args.file:
        scene, camera = build_from_file(args.file)
    else:
        demo = make_scene(args.scene or "cornell", seed=args.seed)
        scene, camera = demo.scene, demo.camera

    if args.save_irt:
        from solstice.io import save_scene

        save_scene(args.save_irt, scene, camera)
        print(f"saved {args.save_irt}")

    import jax

    from solstice.ops.render import jit_render
    from solstice.utils.metrics import MetricsLogger, RaysMeter

    key = jax.random.PRNGKey(args.seed)
    metrics = MetricsLogger(args.metrics) if args.metrics else None
    meter = RaysMeter()
    n_lights = int(scene.lights.position.shape[0])
    rays_per_sample = cfg.n_pixels * cfg.max_bounces * (1 + n_lights)

    def render_one(scene, camera, key):
        return jit_render(scene, camera, cfg, key)

    if args.frames <= 1 and args.spp > 1:
        _progressive(scene, camera, cfg, key, args, metrics, meter,
                     rays_per_sample)
        return

    if args.frames <= 1 and args.tile_rows > 0:
        # Tile-granular resumable still (SURVEY.md section 5 failure
        # detection: kill mid-frame, relaunch with the same args, and
        # only incomplete chunks re-render).
        from solstice.ops import postfx as postfx_mod
        from solstice.utils.resumable import resumable_render

        # Auto-derived dirs are cleaned up after success (and stale ones
        # from an edited scene are invalidated by the fingerprint —
        # ADVICE r04 medium #1); an explicit --checkpoint-dir is kept.
        ckdir = args.checkpoint_dir or (args.out + ".ckpt")
        t0 = time.time()
        img, depth = resumable_render(
            scene, camera, cfg, ckdir, rows_per_chunk=args.tile_rows,
            log=(metrics.log if metrics else None),
            cleanup=args.checkpoint_dir is None,
        )
        img = postfx_mod.apply_postfx(img, depth, scene, camera, cfg,
                                      None)
        dt = time.time() - t0
        print(f"rendered {args.width}x{args.height} in {dt:.1f}s "
              f"(resumable chunks of {args.tile_rows} rows)")
        save_image(args.out, np.asarray(img)[..., :3])
        print(f"wrote {args.out}")
        return

    if args.frames <= 1:
        t0 = time.time()
        img = np.asarray(render_one(scene, camera, key))
        dt = time.time() - t0
        print(f"rendered {args.width}x{args.height} in {dt:.1f}s")
        if metrics:
            metrics.log(event="still", seconds=round(dt, 3),
                        rays_per_s=rays_per_sample / dt)
        save_image(args.out, img[..., :3])
        print(f"wrote {args.out}")
        return

    os.makedirs(args.out, exist_ok=True)
    for f in range(args.frames):
        if demo is not None:
            scene, camera = demo.animate(f)
        key, sub = jax.random.split(key)
        t0 = time.time()
        img = np.asarray(render_one(scene, camera, sub))
        rate = meter.tick(rays_per_sample)
        path = os.path.join(args.out, f"frame_{f:04d}.png")
        save_image(path, img[..., :3])
        if metrics:
            metrics.log(event="frame", frame=f,
                        seconds=round(time.time() - t0, 3),
                        rays_per_s=rate)
        print(f"wrote {path}")


def _progressive(scene, camera, cfg, key, args, metrics, meter,
                 rays_per_sample):
    """Progressive refinement with resumable accumulation (reference:
    the pathTracingIteration running average in k_standardRenderer —
    which upstream RESETS on exit; here the buffer checkpoints so long
    renders survive preemption, SURVEY.md section 5 checkpoint row)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from solstice.ops.render import accumulate, jit_render
    from solstice.utils.checkpoint import (
        CheckpointManager, RenderState, latest_step,
    )

    cfg = dataclasses.replace(cfg, antialias_jitter=True)
    accum = jnp.zeros((cfg.height, cfg.width, 4), jnp.float32)
    start = 0
    mgr = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir \
        else None
    if mgr and args.resume:
        step = latest_step(args.checkpoint_dir)
        if step is not None:
            template = RenderState(params=None, opt_state=None,
                                   rng_key=key, accum=accum,
                                   iteration=jnp.int32(0))
            state, step = mgr.restore(template)
            accum, key = state.accum, state.rng_key
            start = int(state.iteration)
            print(f"resumed progressive render at sample {start}")

    jit_acc = jax.jit(accumulate)
    for it in range(start, args.spp):
        key, sub = jax.random.split(key)
        sample = jit_render(scene, camera, cfg, sub)
        accum = jit_acc(accum, sample, it)
        rate = meter.tick(rays_per_sample)
        if metrics:
            metrics.log(event="progressive", sample=it + 1,
                        rays_per_s=rate)
        if mgr and (it + 1) % args.checkpoint_every == 0:
            mgr.save(it + 1, RenderState(
                params=None, opt_state=None, rng_key=key, accum=accum,
                iteration=jnp.int32(it + 1),
            ))
    img = np.asarray(accum)
    save_image(args.out, img[..., :3])
    print(f"wrote {args.out} ({args.spp} samples)")


if __name__ == "__main__":
    main()
