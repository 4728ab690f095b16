"""Headline benchmark: rays/s on one card, primary+secondary, on a BVH
triangle scene (BASELINE.json north-star: >= 1 Grays/s on 1M tris).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
Detailed per-attempt records (roofline, packet diagnostics, failures)
are appended to bench_metrics.jsonl next to this file (SURVEY.md §5
observability).

Ray accounting (matches the north-star's "primary + secondary
(reflection/refraction/shadow) rays"): every bounce traces 1 closest-hit
ray per pixel plus 1 shadow ray per light per pixel, so
    rays/frame = n_pixels * max_bounces * (1 + n_lights).
This is the work the kernel actually performs (dead rays still occupy
lanes until compaction lands), identical to how the reference's per-pixel
loop counts (SURVEY.md section 3.3).

Routes: by default the strip sweeps take the route RenderConfig.backend
"auto" resolves to (the Triton kernel on a GPU).  ``--routes
triton,xla`` times the named routes in turn, each at headline scale;
the summary line then leads with the faster one and carries every
route under "paths", with their digests compared.  A route that fails
or outlasts SOLR_BENCH_ATTEMPT_TIMEOUT seconds is named under "failed"
in the summary line, and the bench exits nonzero.

Each attempt runs in its own subprocess, so one crash cannot take the
other route down with it, and the parent never opens the card itself:
one process per card.

    python bench.py                     # the configured route
    python bench.py --routes triton,xla # both routes, in turn
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Triangles per packed block at the headline scale.  Must be set before
# solstice.ops.packet is first imported; the value awaits measurement on
# the card (ROADMAP S2).
os.environ.setdefault("SOLR_PACKET_BLOCK", "512")

N_TRIS = int(os.environ.get("SOLR_BENCH_TRIS", 1_000_000))
WIDTH = int(os.environ.get("SOLR_BENCH_WIDTH", 512))
HEIGHT = int(os.environ.get("SOLR_BENCH_HEIGHT", 512))
BOUNCES = int(os.environ.get("SOLR_BENCH_BOUNCES", 2))
REPEATS = int(os.environ.get("SOLR_BENCH_REPEATS", 3))
BASELINE_RAYS_PER_S = 1.0e9  # north-star: 1 Grays/s
_METRICS_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "bench_metrics.jsonl"
)


def build_scene():
    import numpy as np
    import solstice as st

    rng = np.random.default_rng(42)
    b = st.SceneBuilder()
    terrain = b.add_material(color=(0.55, 0.5, 0.4, 1.0), specular=0.2)
    mirror = b.add_material(color=(0.9, 0.9, 0.9, 1.0), reflection=0.6,
                            specular=0.8)

    # Tessellated terrain heightfield of ~N_TRIS triangles: a realistic
    # high-poly surface (every pixel hits geometry; traversal touches a
    # localized leaf set, unlike a volumetric triangle soup).
    gw = int(np.sqrt(N_TRIS / 2.0))
    gh = max(N_TRIS // (2 * gw), 1)
    extent = 40.0
    xs = np.linspace(-extent, extent, gw + 1, dtype=np.float32)
    zs = np.linspace(5.0, 5.0 + 2 * extent, gh + 1, dtype=np.float32)
    xg, zg = np.meshgrid(xs, zs)
    yg = (
        2.0 * np.sin(xg * 0.25) * np.cos(zg * 0.25)
        + 0.7 * np.sin(xg * 1.1 + 2.0) * np.cos(zg * 0.9)
        + 0.25 * np.sin(xg * 3.7) * np.sin(zg * 4.1)
        - 4.0
    ).astype(np.float32)
    verts = np.stack([xg, yg, zg], axis=-1).reshape(-1, 3)
    idx = np.arange((gh + 1) * (gw + 1)).reshape(gh + 1, gw + 1)
    q00 = idx[:-1, :-1].reshape(-1)
    q10 = idx[:-1, 1:].reshape(-1)
    q01 = idx[1:, :-1].reshape(-1)
    q11 = idx[1:, 1:].reshape(-1)
    faces = np.concatenate(
        [
            np.stack([q00, q10, q11], axis=-1),
            np.stack([q00, q11, q01], axis=-1),
        ]
    )
    b.add_mesh(verts, faces, terrain)

    # Mirror spheres scattered on the terrain: secondary-ray workload.
    for i in range(24):
        x = rng.uniform(-extent * 0.8, extent * 0.8)
        z = rng.uniform(10.0, 5.0 + 1.8 * extent)
        b.add_sphere((x, -1.5, z), rng.uniform(0.8, 2.0), mirror)
    b.add_light((0.0, extent, 10.0), intensity=1.0)
    scene = b.build(bvh_threshold=64)
    cam = st.Camera.create(
        position=(0.0, 2.0, -4.0), angles=(0.25, 0.0, 0.0), fov=1.0
    )
    cfg = st.RenderConfig(
        width=WIDTH, height=HEIGHT, max_bounces=BOUNCES,
        gradient_background=True,
        packet_tile_w=int(os.environ.get("SOLR_BENCH_TILE_W", 16)),
        packet_tile_h=int(os.environ.get("SOLR_BENCH_TILE_H", 16)),
        # Per-strip interval list width K and tile prefilter width Kt
        # (round-5 strip-interval traversal).  K=64 holds every
        # measured strip list (probe_intervals: strip union max 42 at
        # 200k tris) so the exactness net never fires; Kt bounds the
        # per-ray slab matrices and exceeds the measured max tile
        # candidate count (96).
        packet_max_blocks=int(os.environ.get("SOLR_BENCH_K", 64)),
        packet_tile_cand=int(os.environ.get("SOLR_BENCH_KT", 256)),
        # "auto" (packet), "while" (per-ray skip-pointer walk), or
        # "packet".
        traversal=os.environ.get("SOLR_BENCH_TRAVERSAL", "auto"),
    )
    return scene, cam, cfg


def packet_diagnostics(scene, cam, cfg):
    """Primary-bounce packet stats for the strip-interval traversal:
    per-strip list lengths, per-strip kernel visits, PER-RAY visits
    (the VERDICT r04 item-1 "done" metric: <= 5), and the exactness-net
    ray rate (THE metric whose absence hid the round-2 collapse)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from solstice.constants import T_FAR
    from solstice.ops import packet as pk
    from solstice.ops.camera import camera_rays
    from solstice.ops.traverse import _sweep_closest

    accel = scene.tri_accel
    sb = cfg.packet_rays
    ks, kt = cfg.packet_max_blocks, cfg.packet_tile_cand

    @jax.jit
    def stats(scene, cam):
        o, d = camera_rays(cam, cfg)
        perm, _ = pk.tile_permutation(
            cfg.width, cfg.height, cfg.packet_tile_w, cfg.packet_tile_h
        )
        o_t = o[perm].reshape(-1, sb, 3)
        d_t = d[perm].reshape(-1, sb, 3)
        live = jnp.ones(o_t.shape[:2], bool)
        cand, counts, nearb, dropped = pk.strip_interval_select(
            o_t, d_t, live, accel, kt, ks, 1e-4
        )
        real =accel.block_bounds[:, 0] < 1e29
        bmin = jnp.min(jnp.where(
            real[:, None],
            accel.block_bounds[:, 0:3] - accel.block_bounds[:, 3:6],
            jnp.inf), axis=0)
        bmax = jnp.max(jnp.where(
            real[:, None],
            accel.block_bounds[:, 0:3] + accel.block_bounds[:, 3:6],
            -jnp.inf), axis=0)
        t_cap = pk.ray_box_exit(o_t, d_t, bmin, bmax)
        bt, _bi, strip_visits = _sweep_closest(
            cfg.sweep_route(), accel.packed, o_t, d_t, t_cap, live, cand,
            counts, nearb, 1e-4, "tri",
        )
        done = jnp.minimum(bt, t_cap)  # (S, SB)
        net = done > dropped
        # PER-RAY visits: blocks of the ray's own interval list a
        # front-to-back walk would intersect (entry <= done) — the
        # item the whole round-5 selection exists to minimize.
        bbg = jnp.take(accel.block_bounds, cand.reshape(-1, cand.shape[2]),
                       axis=0).reshape(cand.shape + (8,))
        per_strip = bbg.reshape(-1, cand.shape[2], 8)
        o_s = o_t.reshape(per_strip.shape[0], -1, 3)
        d_s = d_t.reshape(per_strip.shape[0], -1, 3)
        entry, hitm = pk.slab_entries_g(o_s, d_s, per_strip, 1e-4)
        k_valid = (
            jnp.arange(cand.shape[2])[None, None, :]
            < counts.reshape(-1, 1, 1)
        )
        ray_visits = jnp.sum(
            hitm & k_valid
            & (entry <= done.reshape(entry.shape[0], -1)[..., None]),
            axis=-1,
        )
        return (
            jnp.mean(counts.astype(jnp.float32)),
            jnp.max(counts),
            jnp.mean(strip_visits),
            jnp.mean(ray_visits.astype(jnp.float32)),
            jnp.mean(net.astype(jnp.float32)),
            jnp.mean((dropped < T_FAR * 0.5).astype(jnp.float32)),
        )

    (mean_cand, max_cand, strip_visits, ray_visits, net_rate,
     drop_rate) = [
        float(x) for x in jax.device_get(stats(scene, cam))
    ]
    return {
        "blocks": int(accel.packed.shape[0]),
        "strips_per_tile": int(pk.strips_per_tile(sb)),
        "mean_strip_candidates": round(mean_cand, 2),
        "max_strip_candidates": int(max_cand),
        "mean_strip_visits": round(strip_visits, 2),
        "mean_visits": round(ray_visits, 2),
        "net_ray_rate": round(net_rate, 5),
        "strip_drop_rate": round(drop_rate, 4),
    }


def bytes_by_phase(scene, cam, cfg):
    """XLA cost-analysis bytes_accessed per traversal phase (VERDICT
    r04 missing #2: the byte diet needs the budget itemized by the
    bench itself, not a one-off tool).  Pallas custom calls report
    their operand bytes; the XLA select/shade glue is the remainder vs
    the frame roofline."""
    import jax.numpy as jnp

    from solstice.constants import RAY_EPS
    from solstice.ops import packet as pk
    from solstice.ops.camera import camera_rays
    from solstice.ops.traverse import (
        _tri_packet_closest, _tri_packet_transmittance,
    )
    from solstice.utils.profiling import cost_summary

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
    live = jnp.ones(o_t.shape[:2], bool)

    def select(o_t, d_t):
        return pk.strip_interval_select(
            o_t, d_t, live, accel, cfg.packet_tile_cand,
            cfg.packet_max_blocks, RAY_EPS,
        )[0]

    def closest(o_p, d_p):
        return _tri_packet_closest(scene, o_p, d_p, RAY_EPS, spec)[0]

    lpos = scene.lights.position[0]

    def shadow(o_p, d_p):
        to_l = lpos[None, :] - o_p
        dist = jnp.sqrt(jnp.maximum(jnp.sum(to_l * to_l, -1), 1e-12))
        return _tri_packet_transmittance(
            scene, o_p, to_l / dist[:, None], dist - RAY_EPS, RAY_EPS,
            spec,
        )

    out = {}
    for name, fn in (("select", select), ("closest", closest),
                     ("shadow", shadow)):
        c = cost_summary(fn, o_p if name != "select" else o_t,
                         d_p if name != "select" else d_t)
        out[name] = round(c["bytes_accessed"] / 1e9, 3)
    return out


def _run(route, metrics):
    """Returns the result dict for one sweep route, or raises."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from solstice.ops.render import render_sample
    from solstice.utils.profiling import cost_summary

    t0 = time.time()
    scene, cam, cfg = build_scene()
    cfg = dataclasses.replace(cfg, backend=route)
    build_s = time.time() - t0

    # Digest to a scalar on-device: forces the full render and keeps
    # the host transfer tiny.
    def frame(scene, cam):
        img, _ = render_sample(scene, cam, cfg)
        return jnp.sum(img)

    fn = jax.jit(frame)
    t0 = time.time()
    digest = float(fn(scene, cam).block_until_ready())
    compile_s = time.time() - t0
    assert np.isfinite(digest)

    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.time()
        fn(scene, cam).block_until_ready()
        best = min(best, time.time() - t0)

    n_lights = scene.lights.position.shape[0]
    rays = cfg.n_pixels * cfg.max_bounces * (1 + n_lights)
    rays_per_s = rays / best
    dev = jax.devices()[0]
    result = {
        "metric": (
            f"rays/s primary+secondary, {N_TRIS} tris, "
            f"{WIDTH}x{HEIGHT}x{BOUNCES}b BVH"
        ),
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 6),
        "frame_ms": round(best * 1000, 2),
        "compile_s": round(compile_s, 1),
        "scene_build_s": round(build_s, 1),
        "route": cfg.sweep_route(),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "digest": digest,
    }

    # Roofline + packet diagnostics: observability, never fatal.
    try:
        cost = cost_summary(frame, scene, cam)
        result["roofline"] = {
            "flops": cost["flops"],
            "bytes_accessed": cost["bytes_accessed"],
            "bound": cost["bound"],
            "roofline_ms": round(cost["roofline_s"] * 1000, 3),
            # XLA cost analysis sums BOTH branches of every lax.cond,
            # so on a program with conditional exactness-net fallbacks
            # these figures are upper bounds dominated by never-taken
            # branches (the per-phase bytes are in bytes_by_phase_gb).
            "note": "upper bound: includes untaken lax.cond branches",
        }
    except Exception as e:  # pragma: no cover
        result["roofline"] = {"error": str(e)[:120]}
    try:
        result["bytes_by_phase_gb"] = bytes_by_phase(scene, cam, cfg)
    except Exception as e:  # pragma: no cover
        result["bytes_by_phase_gb"] = {"error": str(e)[:120]}
    try:
        result["packet"] = packet_diagnostics(scene, cam, cfg)
        # A mis-sized net quietly brute-forcing rays is the collapse to
        # watch for: make the assumption loud.
        if result["packet"].get("net_ray_rate", 0.0) > 0.02:
            result["packet"]["warning"] = (
                "net_ray_rate above the 2% design budget - raise "
                "packet_max_blocks / packet_tile_cand"
            )
    except Exception as e:  # pragma: no cover
        result["packet"] = {"error": str(e)[:120]}
    metrics.log(**result)
    return result


def _attempt_main(route):
    """Single attempt, in-process (invoked as `bench.py --attempt ROUTE`
    by main).  Prints one JSON line on success."""
    from solstice.utils.cache import enable_compile_cache
    from solstice.utils.metrics import MetricsLogger

    enable_compile_cache(min_compile_secs=5)
    metrics = MetricsLogger(_METRICS_PATH)
    result = _run(route, metrics)
    metrics.close()
    print("SOLR_BENCH_RESULT " + json.dumps(result))


def _attempt_subprocess(route, timeout_s, metrics):
    """One isolated bench attempt: (result dict, None) or (None, error).
    The attempt runs in its own process group, so a timeout ends it and
    every process it started (a compiler it spawned included)."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--attempt", route],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        out, errout = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, errout = proc.communicate()
        err = f"attempt timed out after {timeout_s}s: " + errout.strip()[-400:]
    else:
        for line in out.splitlines():
            if line.startswith("SOLR_BENCH_RESULT "):
                return json.loads(line[len("SOLR_BENCH_RESULT "):]), None
        err = f"exit {proc.returncode}: " + errout.strip()[-500:]
    metrics.log(event="bench_attempt_failed", n_tris=N_TRIS, route=route,
                error=err[:600])
    print(f"bench: {route} route failed: {err}", file=sys.stderr)
    return None, err


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card(s), read
    without opening the card from JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description="Headline rays/s benchmark.")
    ap.add_argument("--routes", default="auto",
                    help="comma-separated strip-sweep routes to time in "
                         "turn: auto, triton, xla (default: auto)")
    ap.add_argument("--attempt", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.attempt:
        _attempt_main(args.attempt)
        return

    from solstice.utils.metrics import MetricsLogger

    card = card_name_and_power_limit()
    print(card)
    metrics = MetricsLogger(_METRICS_PATH)
    attempt_cap = int(os.environ.get("SOLR_BENCH_ATTEMPT_TIMEOUT", 2400))

    paths, failed = {}, {}
    for route in args.routes.split(","):
        res, err = _attempt_subprocess(route, attempt_cap, metrics)
        if res is None:
            failed[route] = err
        else:
            paths[res["route"]] = res

    result = (dict(max(paths.values(), key=lambda r: r["value"]))
              if paths else {})
    result["ok"] = not failed
    result["card"] = card
    result["paths"] = {
        name: {k: r[k] for k in
               ("value", "frame_ms", "compile_s", "digest") if k in r}
        for name, r in paths.items()
    }
    if failed:
        result["failed"] = failed
    # Cross-route digest agreement: the same algorithm through two
    # execution routes.
    if len(paths) == 2:
        d = [r["digest"] for r in paths.values()]
        if abs(d[0]) > 1e-9:
            rel = abs(d[0] - d[1]) / abs(d[0])
            result["path_digest_rel_diff"] = round(rel, 6)
            if rel > 1e-3:
                result["warning"] = "triton/xla digests disagree beyond 1e-3"
    metrics.log(event="bench_summary", **{
        k: v for k, v in result.items() if not isinstance(v, dict)
    })
    metrics.close()
    print(json.dumps(result))
    if failed:
        raise SystemExit(f"bench: route(s) failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()
