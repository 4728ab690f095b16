"""Measure per-ray / per-strip / per-tile slab-interval candidate stats.

Design probe: the per-ray slab-interval traversal needs a static per-strip candidate width K.  This script
measures, on the bench scene at a configurable scale:

  count  = number of blocks whose slab interval intersects the ray
           (clipped to the scene-box exit) — the length of the
           front-to-back candidate LIST;
  visits = number of those blocks whose entry distance <= the ray's
           true min(best_t, box_exit) — the blocks a front-to-back
           sweep with early-out actually INTERSECTS.

aggregated per ray, per 32-ray strip (union / strip-max-done), and per
256-ray tile, for BOTH the eye rays (bounce 0) and the bounce-0 shadow
rays.  Run on CPU: SOLR_BENCH_TRIS=200000 python tools/probe_intervals.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("SOLR_BENCH_TRIS", "200000")
os.environ.setdefault("SOLR_BENCH_WIDTH", "256")
os.environ.setdefault("SOLR_BENCH_HEIGHT", "256")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

from solstice.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

import bench as bench_mod


def stats(name, x):
    x = np.asarray(x, np.float64)
    print(
        f"{name:28s} mean {x.mean():7.2f}  median {np.median(x):5.0f}  "
        f"p95 {np.percentile(x, 95):5.0f}  max {x.max():5.0f}"
    )


def interval_stats(label, o, d, done, accel, strip=32):
    """o/d (R, 3); done (R,) per-ray completion bound
    (min(best_t, t_cap) for closest; t_max for shadow)."""
    from solstice.ops.traverse import _ray_block_slabs

    slab = jax.jit(
        lambda o, d: _ray_block_slabs(o, d, accel.block_bounds, 1e-4)
    )
    chunk = 32768
    es, hs = [], []
    for lo in range(0, o.shape[0], chunk):
        e, h = slab(o[lo : lo + chunk], d[lo : lo + chunk])
        es.append(np.asarray(e, np.float32))
        hs.append(np.asarray(h))
    entry = np.concatenate(es)
    hitm = np.concatenate(hs)
    done = np.asarray(done)
    # Clip list to blocks that can matter at all: entry <= done is the
    # visit criterion; the LIST must hold every block that could have
    # contained the winning hit, i.e. all slab-hit blocks (entry is a
    # lower bound on any hit inside).
    visits = hitm & (entry <= done[:, None])
    print(f"--- {label}: rays {o.shape[0]}, blocks {hitm.shape[1]}")
    stats("ray count", hitm.sum(1))
    stats("ray visits", visits.sum(1))

    r = o.shape[0]
    for g, gname in ((strip, "strip32"), (256, "tile256")):
        hs = hitm.reshape(r // g, g, -1)
        es = np.where(hitm, entry, np.inf).reshape(r // g, g, -1)
        ds = done.reshape(r // g, g)
        union = hs.any(1)
        stats(f"{gname} union count", union.sum(1))
        # Group front-to-back sweep: the group visits a block iff its
        # min-entry <= the max over rays of the per-ray done bound
        # (each ray's own early-out is per-ray; the group must keep
        # sweeping while any member is unfinished).
        gmin_e = es.min(1)
        gdone = ds.max(1)
        gvis = union & (gmin_e <= gdone[:, None])
        stats(f"{gname} visits", gvis.sum(1))


def main():
    t0 = time.time()
    scene, cam, cfg = bench_mod.build_scene()
    print(f"scene built in {time.time() - t0:.1f}s; "
          f"BLOCK={os.environ.get('SOLR_PACKET_BLOCK', '256')}")
    from solstice.constants import RAY_EPS
    from solstice.ops import packet as pk
    from solstice.ops.camera import camera_rays
    from solstice.ops.traverse import (
        _scene_box, scene_closest_hit, surface_at,
    )

    accel = scene.tri_accel
    o, d = camera_rays(cam, cfg)
    perm, _ = pk.tile_permutation(
        cfg.width, cfg.height, cfg.packet_tile_w, cfg.packet_tile_h
    )
    o, d = o[perm], d[perm]

    t0 = time.time()
    hit = jax.jit(
        lambda s, o, d: scene_closest_hit(
            s, o, d, packet=cfg.packet_spec()
        )
    )(scene, o, d)
    bt = np.asarray(hit.t)
    print(f"closest hit in {time.time() - t0:.1f}s")

    bmin, bmax = _scene_box(accel)
    t_cap = np.asarray(pk.ray_box_exit(o, d, bmin, bmax))
    done = np.minimum(bt, t_cap)
    interval_stats("eye rays (closest)", np.asarray(o), np.asarray(d),
                   done, accel)

    # Bounce-0 shadow rays toward light 0.
    surf = surface_at(scene, hit, o, d)
    lp = np.asarray(scene.lights.position)[0]
    p = np.asarray(surf.point)
    n = np.asarray(surf.normal)
    so = p + n * (RAY_EPS * 4.0)
    sv = lp[None, :] - so
    dist = np.linalg.norm(sv, axis=-1)
    sd = sv / np.maximum(dist, 1e-9)[:, None]
    valid = np.asarray(hit.valid)
    # Park missed rays like render.py does, so stats reflect real load.
    so = np.where(valid[:, None], so, 1e7)
    sd = np.where(valid[:, None], sd, np.array([0.0, 1.0, 0.0]))
    interval_stats("shadow rays (bounce 0)", so.astype(np.float32),
                   sd.astype(np.float32), dist.astype(np.float32), accel)


if __name__ == "__main__":
    main()
