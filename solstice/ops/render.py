"""The render loop: iterative bounce chain, background, progressive
accumulation.

Re-creation of the reference's render kernels and light
transport loop (solr/engines/cuda/CudaRayTracer.cu: k_standardRenderer
etc. + solr/engines/cuda/GeometryShaders.cuh: launchRay — the iterative
reflection/refraction bounce loop with back-to-front attenuation
blending, bounded by NB_MAX_ITERATIONS).

Redesign: the per-thread sequential bounce loop becomes a `lax.scan`
over bounces carrying (origin, direction, throughput, color, live) for
the whole ray batch at once; continuation choice (refract if
transparent, else reflect — the reference's exact rule) is a masked
select; radiance accumulates forward with a running throughput product
(mathematically identical to the reference's back-to-front blend).
Everything is differentiable end-to-end.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from solstice.constants import PARK_DIR, PARK_POS, RAY_EPS
from solstice.ops import textures as tex_ops
from solstice.ops.camera import camera_rays, eye_rays
from solstice.ops.shade import phong_shade
from solstice.ops.traverse import scene_closest_hit, surface_at
from solstice.ops.vecmath import dot, normalize, reflect, refract
from solstice.types import Camera, CameraMode, RenderConfig, Scene

__all__ = ["render", "render_sample", "trace_rays", "trace_rays_tiled",
           "background_color", "accumulate"]

_MIN_THROUGHPUT = 1e-3

# Dead-ray parking spot: far outside any scene, pointing away from the
# origin region, so packet bundles of parked rays cull to ZERO candidate
# blocks and retired tiles cost almost nothing (solstice.ops.packet;
# values in solstice.constants so the packet cull can detect them).
_PARK_POS = PARK_POS
_PARK_DIR = PARK_DIR


def _compact_perm(live, key=None):
    """Live-first compaction permutation, optionally SPATIALLY SORTED.

    Returns (perm, target): ``x[perm]`` packs live rays to the front,
    ``y[target]`` undoes it.  The replacement for the
    wavefront ray-compaction pass (SURVEY.md section 7 M3).

    ``key`` (R,) orders the live rays (Morton code of the bounce
    origin).  Without it, secondary bounces pack live rays from ACROSS
    the frame into the leading tiles in pixel order: such a tile's
    bundle spans the whole scene, the prefilter's near bounds collapse
    to ~0, every ray fails the exactness proof, and the union net
    brute-forces: bounce 1 then costs more than bounce 0 with a few
    percent of the rays live.  Morton-sorting restores tile-bundle locality, which is what the
    whole packet design feeds on.
    """
    r = live.shape[0]
    if key is None:
        li = live.astype(jnp.int32)
        n_live = jnp.sum(li)
        pos_live = jnp.cumsum(li) - 1
        pos_dead = n_live + jnp.cumsum(1 - li) - 1
        target = jnp.where(live, pos_live, pos_dead).astype(jnp.int32)
        perm = jnp.zeros((r,), jnp.int32).at[target].set(
            jnp.arange(r, dtype=jnp.int32)
        )
        return perm, target
    # GROUP-granular sort: sorting 32-ray groups by their min live key
    # is 32x smaller than a full argsort of all R rays and rays within a group are
    # already coherent from the previous bounce's order.  All-dead
    # groups key to +inf and sink to the back, which is what the
    # dead-chunk skip feeds on; stray dead rays inside live groups just
    # ride along (their live flags mask them in the kernels).
    grp = 32 if r % 32 == 0 else 1
    sort_key = jnp.where(live, key.astype(jnp.float32), jnp.inf)
    gkey = jnp.min(sort_key.reshape(-1, grp), axis=1)
    gperm = jnp.argsort(gkey).astype(jnp.int32)  # stable
    perm = (
        gperm[:, None] * grp + jnp.arange(grp, dtype=jnp.int32)[None, :]
    ).reshape(-1)
    target = jnp.zeros((r,), jnp.int32).at[perm].set(
        jnp.arange(r, dtype=jnp.int32)
    )
    return perm, target


def background_color(scene: Scene, cfg: RenderConfig, d):
    """Miss radiance (reference: the background/skybox branch of
    launchRay — solid color, vertical gradient, or spherical skybox
    texture via skyboxMapping)."""
    info = scene.info
    if cfg.sky_texture >= 0 and scene.textures.count > 0:
        from solstice.ops.vecmath import spherical_uv

        uv = spherical_uv(d)
        tid = jnp.full(d.shape[:-1], cfg.sky_texture, jnp.int32)
        return tex_ops.sample_texture(scene.textures, tid, uv)
    if cfg.gradient_background:
        t = jnp.clip(0.5 + 0.5 * d[..., 1], 0.0, 1.0)[..., None]
        return (1.0 - t) * info.gradient_sky_horizon + t * info.gradient_sky_zenith
    return jnp.broadcast_to(info.background_color, d.shape[:-1] + (4,))


def trace_rays(
    scene: Scene,
    o,
    d,
    cfg: RenderConfig,
    key: Optional[jax.Array] = None,
    packet=None,
):
    """Trace a flat ray batch through the bounce chain.

    ``packet``: optional (tile_rays, max_leaves) — rays must already be
    tile-coherent groups (see render_sample's swizzle).
    Returns (color (R, 4), primary_t (R,)) — primary hit distance feeds
    depth-of-field post-processing (reference: the depth written to
    d_primitivesXYIds / the post-processing buffer).
    """
    r = o.shape[0]
    dtype = o.dtype
    mats = scene.materials

    def bounce(carry, bounce_key):
        o, d, thru, color, live, dist0 = carry
        if packet is not None and cfg.compact_rays:
            # Wavefront compaction: pack live rays into leading tiles
            # in MORTON ORDER of their origins (see _compact_perm) and
            # park dead ones where the cull rejects every block, so
            # retired tiles skip traversal and live tiles stay
            # spatially tight.
            from solstice.ops.traverse import _spatial_keys

            sg = jax.lax.stop_gradient
            o_sg = sg(o)
            lv = sg(live)
            omin = jnp.min(jnp.where(lv[:, None], o_sg, jnp.inf), 0)
            omax = jnp.max(jnp.where(lv[:, None], o_sg, -jnp.inf), 0)
            keys = _spatial_keys(o_sg, omin, omax)
            perm, target = _compact_perm(lv, keys)
            o, d, thru, color, live, dist0 = (
                o[perm], d[perm], thru[perm], color[perm], live[perm],
                dist0[perm],
            )
            park = ~live[..., None]
            o = jnp.where(park, _PARK_POS, o)
            d = jnp.where(park, _PARK_DIR, d)
        else:
            target = None
        hit = scene_closest_hit(scene, o, d, use_bvh=cfg.use_bvh,
                                packet=packet)
        valid = hit.valid & live
        surf = surface_at(scene, hit, o, d)

        local = phong_shade(scene, surf, d, cfg, bounce_key,
                            packet=packet)  # (R,4)

        m = surf.material
        # Reflection/transparency map slots scale the continuation
        # weights per hit (reference: Material textureIds — a black
        # region of a reflection map makes the mirror matte there).
        _, refl_scale, trans_scale = tex_ops.material_map_scales(
            scene, m, surf.uv
        )
        w_refr = mats.transparency[m] * trans_scale
        w_refl = mats.reflection[m] * refl_scale
        has_refr = w_refr > 1e-4
        w = jnp.where(has_refr, w_refr, w_refl)
        own = 1.0 - w

        # Fog / view-distance attenuation (reference: the viewDistance
        # falloff applied to accumulated color in launchRay).
        if cfg.fog:
            total_d = dist0 + jnp.where(valid, hit.t, 0.0)
            span = jnp.maximum(scene.info.view_distance - scene.info.fog_start,
                               1e-3)
            fog = jnp.clip(1.0 - (total_d - scene.info.fog_start) / span,
                           0.0, 1.0)
        else:
            total_d = dist0
            fog = jnp.ones((r,), dtype)

        contrib = thru * (own * fog)[..., None] * local
        color = color + jnp.where(valid[..., None], contrib, 0.0)

        # Miss: add background once, then retire the ray.
        missed = live & ~hit.valid
        bg = background_color(scene, cfg, d)
        color = color + jnp.where(missed[..., None], thru * bg, 0.0)

        # Continuation ray: refract if transparent else reflect
        # (reference: launchRay's exact branch order).
        n = surf.shading_normal
        eta = jnp.where(
            surf.backface, mats.ior[m], 1.0 / jnp.maximum(mats.ior[m], 1e-3)
        )
        refr_d, _ = refract(d, n, eta)
        refl_d = reflect(d, n)
        nd = normalize(jnp.where(has_refr[..., None], refr_d, refl_d))
        no = surf.point + nd * (RAY_EPS * 4.0)

        # Colored-glass tint on refraction; mirrors stay untinted.
        tint = jnp.where(
            has_refr[..., None],
            mats.color[m] * 0.98 + 0.02,
            jnp.ones_like(local),
        )
        thru = thru * w[..., None] * tint
        live = valid & (w > 1e-4) & (
            jnp.max(thru[..., :3], axis=-1) > _MIN_THROUGHPUT
        )

        o = jnp.where(live[..., None], no, o)
        d = jnp.where(live[..., None], nd, d)
        out = (o, d, thru, color, live, total_d)
        t_out = hit.t
        if target is not None:  # undo the compaction permutation
            out = tuple(x[target] for x in out)
            t_out = t_out[target]
        return out, t_out

    if key is not None:
        keys = jax.random.split(key, cfg.max_bounces)
    else:
        keys = jnp.zeros((cfg.max_bounces, 2), jnp.uint32)
        keys = None if key is None else keys
    init = (
        o,
        d,
        jnp.ones((r, 4), dtype),
        jnp.zeros((r, 4), dtype),
        jnp.ones((r,), bool),
        jnp.zeros((r,), dtype),
    )
    if keys is None:
        (o, d, thru, color, live, _), ts = jax.lax.scan(
            lambda c, _: bounce(c, None), init, None, length=cfg.max_bounces
        )
    else:
        (o, d, thru, color, live, _), ts = jax.lax.scan(bounce, init, keys)
    primary_t = ts[0]
    return color.at[..., 3].set(1.0), primary_t


def trace_rays_tiled(
    scene: Scene,
    o,
    d,
    cfg: RenderConfig,
    key: Optional[jax.Array] = None,
):
    """Trace a row-major pixel-block ray batch with the packet tile
    swizzle applied when the geometry/config allow it.

    ``o``/``d`` are flat rays over a contiguous (h_loc x cfg.width)
    pixel block — the FULL frame (render_sample) or one device's shard
    of rows (solstice.parallel.render / .grads), which is how the
    distributed path runs the SAME fast traversal as the single-chip
    path (VERDICT r02 missing #3: the sharded renderer and train step
    previously always took the slow path).
    """
    n = o.shape[0]
    spec = None
    h_loc = n // cfg.width
    if scene.tri_bvh is not None and cfg.use_bvh and n % cfg.width == 0:
        spec = cfg.packet_spec(rows=h_loc)
    if spec is None:
        return trace_rays(scene, o, d, cfg, key)
    from solstice.ops.packet import tile_permutation

    perm, inv = tile_permutation(
        cfg.width, h_loc, cfg.packet_tile_w, cfg.packet_tile_h
    )
    color, t = trace_rays(scene, o[perm], d[perm], cfg, key, packet=spec)
    return color[inv], t[inv]


def render_sample(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    key: Optional[jax.Array] = None,
):
    """One progressive sample: (image (H, W, 4), depth (H, W)).

    Dispatches on camera mode (reference: the kernel-variant switch in
    CudaKernel::render_begin).
    """
    dtype = scene.info.background_color.dtype
    if cfg.camera_mode == CameraMode.ANAGLYPH:
        kl, kr = (None, None) if key is None else tuple(jax.random.split(key))
        ol, dl = eye_rays(camera, cfg, -1.0, kl, dtype)
        orr, dr = eye_rays(camera, cfg, +1.0, kr, dtype)
        cl, tl = trace_rays(scene, ol, dl, cfg, kl)
        cr, _ = trace_rays(scene, orr, dr, cfg, kr)
        # Red/cyan compose (reference: k_anaglyphRenderer).
        color = jnp.stack(
            [cl[..., 0], cr[..., 1], cr[..., 2], jnp.ones_like(cl[..., 0])],
            axis=-1,
        )
        t = tl
    else:
        o, d = camera_rays(camera, cfg, key, dtype)
        # Swizzles rays into spatially-coherent pixel tiles so packet
        # bundles are tight (solstice.ops.packet).
        color, t = trace_rays_tiled(scene, o, d, cfg, key)
    img = color.reshape(cfg.height, cfg.width, 4)
    depth = t.reshape(cfg.height, cfg.width)
    return img, depth


def render(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    key: Optional[jax.Array] = None,
    spp: int = 1,
):
    """Render with ``spp`` progressive samples averaged, plus the
    configured post-processing pass.  Returns (H, W, 4) float radiance.
    """
    from solstice.ops import postfx as postfx_mod

    if spp <= 1 or key is None:
        img, depth = render_sample(scene, camera, cfg, key)
    else:
        keys = jax.random.split(key, spp)

        def one(k):
            return render_sample(scene, camera, cfg, k)

        imgs, depths = jax.lax.map(one, keys)
        img = imgs.mean(axis=0)
        depth = depths[0]
    img = postfx_mod.apply_postfx(img, depth, scene, camera, cfg, key)
    return img


jit_render = jax.jit(render, static_argnames=("cfg", "spp"))
"""Jitted entry point: `cfg`/`spp` are static (shape-defining), scene and
camera are traced — moving the camera or optimizing scene parameters does
not retrigger compilation (the analog of the reference's one-time kernel
build in CudaKernel/OpenCLKernel::initializeDevice)."""


def accumulate(accum, sample, iteration):
    """Progressive-refinement running average (reference: the
    pathTracingIteration blend into the float4 post-processing buffer in
    k_standardRenderer)."""
    it = jnp.asarray(iteration, sample.dtype)
    return (accum * it + sample) / (it + 1.0)
