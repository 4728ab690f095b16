#!/usr/bin/env python
"""On-card smoke test: the renderer's main path on an NVIDIA GPU.

    python chip_smoke.py          # one card, phases (a)-(e)
    python chip_smoke.py --four   # four cards: sharded frame + psum step

Phases on one card:

  (a) device: JAX's platform, device kind and count, and the card's name
      and power limit from nvidia-smi; no GPU is an error;
  (b) oracle: the flagship scene (every primitive family) at 64x64
      against the independent float64 CPU tracer;
  (c) kernels: each Triton strip sweep (closest hit and transmittance,
      for triangles, spheres and cylinders) at the headline widths,
      timed, against the plain XLA block scan on a sample of strips
      (the triangle closest-hit scan is timed on the card as well);
  (d) headline frame: bench.py's 1M-triangle scene at 512x512, 2
      bounces, 1 light through jax.jit(render_sample) on the kernel
      route: compile seconds, median frame ms, memory analysis, and the
      image against the XLA route's frame;
  (e) training: a few inverse-rendering steps (examples/inverse.py's
      scene at 256x256) through make_sharded_train_step on a 1-card
      mesh; the loss must stay finite and fall.

``--four`` runs only the four-card path: the 1M-triangle scene as a
3840x1080 side-by-side stereo frame through shard_render over four
cards against the same frame on one card, and one psum train step's
loss and gradients on four cards against one.

Nothing is caught: any failed check is a nonzero exit with no result
line.  The last line of standard output is one JSON object naming the
device as JAX reports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


_T0 = time.perf_counter()


def _phase(name):
    print(f"\n== {name} (at {time.perf_counter() - _T0:.1f} s)")


def _timed(fn, *args, reps=5):
    """Median wall ms of ``fn(*args)``, each call synchronised."""
    import jax

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _compare_images(img, ref, what):
    """Two renders of one frame: mean absolute difference <= 1e-4 over
    the inlier pixels, with the oracle comparison's outlier budget (1%
    of pixels beyond 2e-2) for hits that flip at silhouettes and shared
    edges, where FMA contraction decides a near-tie differently."""
    import numpy as np

    from solstice.oracle import assert_images_match

    a = np.asarray(img, np.float64)[..., :3]
    b = np.asarray(ref, np.float64)[..., :3]
    err = np.abs(a - b).max(axis=-1)
    print(f"{what}: mean |diff| {float(np.abs(a - b).mean()):.3e}, "
          f"outlier pixels {float((err > 2e-2).mean()):.3%}, max "
          f"{err.max():.3e}")
    assert np.isfinite(b).all(), what
    assert_images_match(img, ref, mean_tol=1e-4)


# A ray that grazes a primitive (a root, edge or rim test within f32
# rounding of its threshold) may be decided either way by the two
# compilers: this share of rays may differ beyond the tolerances below.
_GRAZING = 1e-3


# --------------------------------------------------------------------------
# (a) device
# --------------------------------------------------------------------------


def device_check(n_cards):
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"platform={d.platform} device_kind={d.device_kind} "
          f"count={len(devs)}")
    if d.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {d.platform!r}")
    if len(devs) < n_cards:
        raise SystemExit(f"needs {n_cards} GPUs, JAX sees {len(devs)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card)
    return d


# --------------------------------------------------------------------------
# (b) oracle
# --------------------------------------------------------------------------


def oracle_check(size=64):
    import jax

    import solstice as st
    from __graft_entry__ import _flagship_builder
    from solstice.oracle import assert_images_match, oracle_render
    from solstice.ops.render import render_sample

    scene = _flagship_builder().build(bvh_threshold=64)
    cam = st.Camera.create(position=(0.0, 0.0, -1.6), fov=1.1)
    cfg = st.RenderConfig(width=size, height=size, max_bounces=3)
    img, _ = jax.jit(render_sample, static_argnums=2)(scene, cam, cfg)
    ref = oracle_render(scene, cam, cfg)
    assert_images_match(img, ref)
    print(f"flagship {size}x{size} (route {cfg.sweep_route()}) matches "
          "the CPU oracle")


# --------------------------------------------------------------------------
# (c) kernels at the headline widths
# --------------------------------------------------------------------------


def _pools(scene):
    """The headline triangle accel plus sphere and cylinder pools of the
    same size and order: a sphere at every triangle's centroid and a
    cylinder along every triangle's first edge, so each pool lies on the
    terrain the camera sees, in the accel's spatial order."""
    import jax.numpy as jnp

    from solstice.ops import packet as pk
    from solstice.types import Cylinders, Spheres

    tris = scene.triangles
    n = tris.v0.shape[0]
    radius = jnp.full((n,), 0.05, jnp.float32)
    spheres = Spheres(center=(tris.v0 + tris.v1 + tris.v2) / 3.0,
                      radius=radius, material=tris.material)
    cyls = Cylinders(p0=tris.v0, p1=tris.v1, radius=radius,
                     material=tris.material)
    return {
        "tri": scene.tri_accel,
        "sphere": pk.build_sph_accel(spheres, scene.materials),
        "cyl": pk.build_cyl_accel(cyls, scene.materials),
    }


def _prim_t(accel, prim, o, d, idx):
    """Hit distance of primitive ``idx`` (flat pool index) per ray, by
    the shared block math: decides whether two indices are a tie."""
    from solstice.ops import packet as pk

    block = accel.packed.shape[2]
    w = accel.packed[idx // block, :, idx % block]  # (R, 16)
    comp = {i: o[:, i] for i in range(3)}
    comp.update({4 + i: d[:, i] for i in range(3)})
    return pk.PRIM_CORES[prim](comp.__getitem__, lambda i: w[:, i], 1e-4)


def _on_host(tree):
    """A copy of ``tree`` committed to the host CPU: the XLA route runs
    there as the plain reference."""
    import jax

    return jax.device_put(tree, jax.devices("cpu")[0])


class _Watchdog:
    """Exit (code 3) if the enclosed step outlasts ``limit_s``: a
    compile that runs away fails the smoke test at once."""

    def __init__(self, what, limit_s):
        import threading

        def fire():
            print(f"WATCHDOG: {what} exceeded {limit_s} s", flush=True)
            os._exit(3)

        self.timer = threading.Timer(limit_s, fire)

    def __enter__(self):
        self.timer.start()

    def __exit__(self, *exc):
        self.timer.cancel()


def _compile(what, fn, *args, limit_s=300):
    """AOT-compile ``fn`` for ``args`` under a watchdog; prints the
    compile seconds."""
    import jax

    t0 = time.perf_counter()
    with _Watchdog(f"compiling {what}", limit_s):
        compiled = jax.jit(fn).lower(*args).compile()
    print(f"{what}: compile {time.perf_counter() - t0:.2f} s")
    return compiled


def kernel_check(scene, cam, cfg, interpret=False, ref_every=7):
    """Each sweep kernel on the card at the headline widths, against the
    XLA block scan on every ``ref_every``-th strip, run on the host CPU
    (XLA's GPU compiler has not finished the scan's shadow sweep at
    these widths within this test's time limit; the closest-hit scan
    for triangles is timed on the card too).  The
    stride must be coprime to the strips per tile, so that every strip
    position within a tile is compared."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from solstice.constants import PARK_DIR, PARK_POS, RAY_EPS
    from solstice.ops import packet as pk
    from solstice.ops.camera import camera_rays
    from solstice.ops.sweep_kernel import (sweep_closest,
                                           sweep_transmittance)
    from solstice.ops.traverse import _scene_box

    sb, ks, kt = cfg.packet_rays, cfg.packet_max_blocks, cfg.packet_tile_cand
    o, d = camera_rays(cam, cfg)
    perm, _ = pk.tile_permutation(cfg.width, cfg.height, cfg.packet_tile_w,
                                  cfg.packet_tile_h)
    o_t = o[perm].reshape(-1, sb, 3)
    d_t = d[perm].reshape(-1, sb, 3)
    g = pk.strips_per_tile(sb)
    ssb = sb // g
    strips = lambda a: a.reshape((-1, ssb) + a.shape[2:])
    n_strips = o_t.shape[0] * g
    ref = np.arange(0, n_strips, ref_every)
    positions = np.unique(ref % g)
    assert positions.size == g, f"stride {ref_every} skips strip positions"
    light = scene.lights.position[0]
    print(f"rays {cfg.width}x{cfg.height}, strips {n_strips} x {ssb} "
          f"rays, K={ks}, Kt={kt}, BLOCK={pk.BLOCK}; reference on "
          f"{ref.size} strips (every {ref_every}th), in-tile strip "
          f"positions {positions.tolist()} of {g}")

    def select(accel, o_t, d_t, live, tm_t=None):
        return pk.strip_interval_select(o_t, d_t, live, accel, kt, ks,
                                        RAY_EPS, tm_t=tm_t)

    for prim, accel in _pools(scene).items():
        packed = accel.packed
        packed_h = _on_host(packed)
        live = jnp.ones(o_t.shape[:2], bool)
        cand, counts, nearb, _ = jax.jit(select)(accel, o_t, d_t, live)
        k = cand.shape[2]
        bmin, bmax = _scene_box(accel)
        t_cap = pk.ray_box_exit(o_t, d_t, bmin, bmax)
        args_k = (packed, strips(o_t), strips(d_t), strips(t_cap),
                  strips(live), cand.reshape(-1, k), counts.reshape(-1),
                  nearb.reshape(-1, k))
        kern = _compile(f"closest {prim} kernel",
                        lambda *a: sweep_closest(*a, RAY_EPS, prim=prim,
                                                 interpret=interpret),
                        *args_k)
        t_k, i_k, nv = jax.block_until_ready(kern(*args_k))
        ms_k = _timed(kern, *args_k)
        args_x = (packed, strips(o_t), strips(d_t), cand.reshape(-1, k),
                  counts.reshape(-1))
        xla = lambda *a: pk.tri_blocks_closest(*a, RAY_EPS, prim=prim)
        if prim == "tri":
            xla_card = _compile("closest tri xla on the card", xla, *args_x)
            jax.block_until_ready(xla_card(*args_x))
            print(f"closest tri xla on the card: "
                  f"{_timed(xla_card, *args_x):.3f} ms")
        t_x, i_x = jax.jit(xla)(packed_h, *_on_host(
            tuple(a[ref] for a in args_x[1:])))
        t_full = t_k.reshape(o_t.shape[:2])
        t_k, i_k = (np.asarray(t_k)[ref].ravel(),
                    np.asarray(i_k)[ref].ravel())
        t_x, i_x = np.asarray(t_x).ravel(), np.asarray(i_x).ravel()
        hit_k, hit_x = t_k < 1e29, t_x < 1e29
        both = hit_k & hit_x
        # rtol 1e-5: no matrix products, so no TF32; the card and the
        # host contract multiply-adds into FMAs differently, which moves
        # t by a few ulps.
        close = both & (np.abs(t_k - t_x) <= 1e-5 * np.abs(t_x))
        off = float((hit_k != hit_x).mean() + (both & ~close).mean())
        assert off <= _GRAZING, f"{prim}: {off:.2e} of rays differ"
        # Index exact where t is unique: a differing index must be a tie
        # (shared edges), i.e. its own t equals the reference best t.
        diff = np.nonzero(close & (i_k != i_x))[0]
        if diff.size:
            o_f = np.asarray(strips(o_t))[ref].reshape(-1, 3)[diff]
            d_f = np.asarray(strips(d_t))[ref].reshape(-1, 3)[diff]
            t_alt = np.asarray(_prim_t(accel, prim, jnp.asarray(o_f),
                                       jnp.asarray(d_f),
                                       jnp.asarray(i_k[diff])))
            np.testing.assert_allclose(t_alt, t_x[diff], rtol=1e-5)
        print(f"closest {prim}: kernel {ms_k:.3f} ms; hits "
              f"{both.mean():.4f}, grazing {off:.2e}, index ties "
              f"{diff.size}; mean strip list {float(counts.mean()):.2f}, "
              f"mean visits {float(nv.mean()):.2f}")

        # Shadow rays from the kernel's hits toward the light; misses
        # park.
        hit2 = t_full < 1e29
        p = o_t + d_t * jnp.where(hit2, t_full, 0.0)[..., None]
        to_l = light - p
        dist = jnp.linalg.norm(to_l, axis=-1)
        d_s = jnp.where(hit2[..., None], to_l / dist[..., None],
                        jnp.asarray(PARK_DIR, jnp.float32))
        o_s = jnp.where(hit2[..., None], p + d_s * (4.0 * RAY_EPS),
                        jnp.asarray(PARK_POS, jnp.float32))
        tm = jnp.where(hit2, dist - 8.0 * RAY_EPS, 0.0)
        cand, counts, _, _ = jax.jit(select)(accel, o_s, d_s, hit2, tm)
        args_k = (packed, strips(o_s), strips(d_s), strips(tm),
                  strips(hit2), cand.reshape(-1, k), counts.reshape(-1))
        kern = _compile(f"shadow {prim} kernel",
                        lambda *a: sweep_transmittance(
                            *a, RAY_EPS, prim=prim, interpret=interpret),
                        *args_k)
        tr_k, nv = jax.block_until_ready(kern(*args_k))
        ms_k = _timed(kern, *args_k)
        sub = lambda a: a[ref]
        tr_x = jax.jit(lambda *a: pk.tri_blocks_transmittance(
            *a, RAY_EPS, prim=prim))(
            packed_h, *_on_host((sub(strips(o_s)), sub(strips(d_s)),
                                 sub(strips(tm)),
                                 sub(cand.reshape(-1, k)),
                                 sub(counts.reshape(-1)))))
        # atol 1e-5: no matrix products, so no TF32.  The kernel
        # multiplies shadow factors as exp of a sum of logs (Triton has
        # no product reduction), the scan as a plain product: a few ulps
        # apart, with opaque (0) and clear (1) factors exact either way.
        # The kernel stops early only once the product is exactly 0.
        off = float((np.abs(np.asarray(tr_k)[ref] - np.asarray(tr_x))
                     > 1e-5).mean())
        assert off <= _GRAZING, f"shadow {prim}: {off:.2e} of rays differ"
        print(f"shadow {prim}: kernel {ms_k:.3f} ms; grazing {off:.2e}; lit "
              f"{float(tr_k.mean()):.4f}; mean strip list "
              f"{float(counts.mean()):.2f}, mean visits "
              f"{float(nv.mean()):.2f}")


# --------------------------------------------------------------------------
# (d) headline frame
# --------------------------------------------------------------------------


def _memory(compiled):
    m = compiled.memory_analysis()
    return ", ".join(
        f"{k} {getattr(m, k + '_in_bytes')}" for k in
        ("argument_size", "output_size", "temp_size",
         "generated_code_size") if hasattr(m, k + "_in_bytes"))


def headline_frame(scene, cam, cfg, frames=5, route="triton"):
    """The headline frame on the kernel route, timed on the card, against
    the XLA route's frame rendered on the host CPU."""
    import jax
    import jax.numpy as jnp

    from solstice.ops.render import render_sample

    cfg_k = dataclasses.replace(cfg, backend=route)
    frame = _compile(f"{route} route frame",
                     lambda s, c: render_sample(s, c, cfg_k)[0], scene, cam)
    print(f"memory bytes: {_memory(frame)}")
    img = jax.block_until_ready(frame(scene, cam))
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(frame(scene, cam))
        times.append((time.perf_counter() - t0) * 1e3)
    n_lights = scene.lights.position.shape[0]
    rays = cfg.n_pixels * cfg.max_bounces * (1 + n_lights)
    ms = statistics.median(times)
    print(f"{route} route frame: median {ms:.3f} ms over {frames} "
          f"({', '.join(f'{t:.3f}' for t in times)}), "
          f"{rays / ms * 1e3:.1f} rays/s")
    stats = jax.devices()[0].memory_stats() or {}  # None on a CPU
    print(f"peak bytes in use {stats.get('peak_bytes_in_use')}")
    assert bool(jnp.isfinite(img).all())

    cfg_x = dataclasses.replace(cfg, backend="xla")
    t0 = time.perf_counter()
    with _Watchdog("the xla route frame on the host", 400):
        ref = jax.jit(lambda s, c: render_sample(s, c, cfg_x)[0])(
            *_on_host((scene, cam)))
        ref = jax.block_until_ready(ref)
    print(f"xla route frame on the host CPU (reference): compile + run "
          f"{time.perf_counter() - t0:.1f} s")
    _compare_images(img, ref, "headline kernel route vs xla route")


# --------------------------------------------------------------------------
# (e) inverse-rendering train steps
# --------------------------------------------------------------------------


def _inverse_setup(size):
    """examples/inverse.py's scene and perturbation at ``size``^2: the
    target is the true scene's render; albedos and the light move."""
    import importlib.util

    import jax
    import jax.numpy as jnp
    import optax

    import solstice as st
    from solstice.ops.render import render_sample

    spec = importlib.util.spec_from_file_location(
        "inverse_example", os.path.join(REPO, "examples", "inverse.py"))
    inverse = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(inverse)
    scene, cam = inverse.build_scene()
    cfg = st.RenderConfig(width=size, height=size, max_bounces=2)
    target = jax.jit(render_sample, static_argnums=2)(scene, cam, cfg)[0]
    start = dict(scene.params)
    start["albedo"] = start["albedo"].at[1:3, :3].add(
        jnp.asarray([[0.25, -0.2, 0.15], [-0.1, 0.25, -0.2]]))
    start["light_position"] = start["light_position"] + jnp.asarray(
        [[-2.0, 0.0, 1.5]])
    opt = optax.multi_transform(
        {"fit": optax.adam(3e-2), "fixed": optax.set_to_zero()},
        {k: ("fit" if k in ("albedo", "light_position") else "fixed")
         for k in start},
    )
    return scene, cam, cfg, target[..., :3], start, opt


def train_steps(size=256, steps=5):
    import jax
    import numpy as np

    from solstice.parallel import make_mesh, make_sharded_train_step

    from jax.sharding import NamedSharding, PartitionSpec

    scene, cam, cfg, target, params, opt = _inverse_setup(size)
    mesh = make_mesh(1)
    step, _ = make_sharded_train_step(scene, cam, cfg, mesh, opt)
    # Start from the sharding the step returns, so step 2 reuses step
    # 1's compilation.
    params, state = jax.device_put((params, opt.init(params)),
                                   NamedSharding(mesh, PartitionSpec()))
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        with _Watchdog("the first train step (compiles)", 300):
            params, state, loss = jax.block_until_ready(
                step(params, state, target))
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    print(f"train {size}x{size}: losses {losses}; step ms "
          f"{', '.join(f'{t:.3f}' for t in times)} (first compiles)")
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], losses


# --------------------------------------------------------------------------
# --four: sharded frame and psum step against one card
# --------------------------------------------------------------------------


def four_cards(width=3840, height=1080, train_size=256):
    import jax
    import numpy as np

    import bench
    import solstice as st
    from solstice.ops.render import render_sample
    from solstice.parallel import make_mesh, shard_render, sharded_loss_grad

    mesh4, mesh1 = make_mesh(4), make_mesh(1)
    _phase("four cards: 1080p side-by-side stereo frame")
    scene, cam, cfg = bench.build_scene()
    cfg = dataclasses.replace(
        cfg, width=width, height=height,
        camera_mode=st.CameraMode.SIDE_BY_SIDE,
        packet_tile_w=32, packet_tile_h=9,
    )
    sharded = _compile("4-card stereo frame",
                       lambda s, c: shard_render(s, c, cfg, mesh4)[0],
                       scene, cam)
    single = _compile("1-card stereo frame",
                      lambda s, c: render_sample(s, c, cfg)[0], scene, cam)
    img4 = jax.block_until_ready(sharded(scene, cam))
    img1 = jax.block_until_ready(single(scene, cam))
    devices = set()
    for sh in img4.addressable_shards:
        print(f"image shard {sh.index} on {sh.device}")
        devices.add(sh.device)
    assert devices == set(mesh4.devices.ravel()), devices
    ms4, ms1 = _timed(sharded, scene, cam, reps=3), _timed(
        single, scene, cam, reps=3)
    print(f"{width}x{height} stereo frame: 4 cards {ms4:.3f} ms, 1 card "
          f"{ms1:.3f} ms")
    _compare_images(img4, img1, "4-card vs 1-card stereo frame")

    _phase("four cards: psum train step")
    from solstice.parallel import make_sharded_train_step

    scene, cam, cfg, target, params, opt = _inverse_setup(train_size)
    scene_p = scene.with_params(params)
    (l4, g4), (l1, g1) = [
        jax.block_until_ready(_compile(
            f"loss and grads on {m.devices.size} card(s)",
            lambda s, t, m=m: sharded_loss_grad(s, cam, cfg, t, m),
            scene_p, target)(scene_p, target))
        for m in (mesh4, mesh1)
    ]
    print(f"loss 4 cards {float(l4)!r}, 1 card {float(l1)!r}")
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-5)
    for k in sorted(g1):
        a, b = np.asarray(g4[k]), np.asarray(g1[k])
        # The 4-card sum adds four partial sums: another f32 order.
        np.testing.assert_allclose(
            a, b, rtol=1e-3,
            atol=1e-4 * max(float(np.abs(b).max(initial=0.0)), 1e-12),
            err_msg=k)
    step, _ = make_sharded_train_step(scene, cam, cfg, mesh4, opt)
    with _Watchdog("the 4-card train step (compiles)", 300):
        new, _, loss = jax.block_until_ready(
            step(params, opt.init(params), target))
    assert np.isfinite(float(loss))
    print(f"psum step on 4 cards: loss {float(loss)!r}; param shards on "
          f"{sorted({str(s.device) for s in new['albedo'].addressable_shards})}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path")
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)  # progress survives a kill

    _phase("(a) device")
    dev = device_check(4 if args.four else 1)
    import bench  # sets the headline BLOCK before solstice loads
    import jax

    from solstice.utils.cache import enable_compile_cache

    enable_compile_cache()
    if args.four:
        four_cards()
    else:
        _phase("(b) oracle check")
        oracle_check()
        _phase("headline scene build")
        scene, cam, cfg = bench.build_scene()
        _phase("(c) kernel check at headline widths")
        kernel_check(scene, cam, cfg)
        _phase("(d) headline frame")
        headline_frame(scene, cam, cfg)
        del scene
        _phase("(e) train steps")
        train_steps()
    _phase("all phases passed")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
