"""Post-processing passes over the rendered frame.

Re-creation of the reference's second-pass kernels
(solr/engines/cuda/CudaRayTracer.cu: k_depthOfField — gather blur with
radius proportional to |depth - focus| using random disk offsets;
screen-space ambient occlusion; cartoon/filter effects; k_default
copy-out), expressed as jit-friendly gather ops on the (H, W, 4) frame
plus its (H, W) primary-depth buffer.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

from solstice.types import Camera, PostFxMode, RenderConfig, Scene

__all__ = ["apply_postfx", "depth_of_field", "ambient_occlusion",
           "cartoon", "enlightment"]


def _disk_offsets(samples: int, dtype):
    """Deterministic golden-angle spiral disk (unit radius), (S, 2)."""
    i = jnp.arange(samples, dtype=dtype) + 0.5
    r = jnp.sqrt(i / samples)
    theta = i * (math.pi * (3.0 - math.sqrt(5.0)))
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def _gather_px(img, yy, xx):
    h, w = img.shape[:2]
    yy = jnp.clip(yy, 0, h - 1)
    xx = jnp.clip(xx, 0, w - 1)
    return img[yy, xx]


def depth_of_field(img, depth, focus, strength, samples: int = 16):
    """Gather-blur with circle of confusion ~ |depth - focus|
    (reference: k_depthOfField; PostProcessingInfo param1=focus,
    param2=strength)."""
    h, w = img.shape[:2]
    dtype = img.dtype
    coc = jnp.abs(depth - focus) * strength  # (H, W) blur radius in px
    coc = jnp.clip(coc, 0.0, 32.0)
    offs = _disk_offsets(samples, dtype)  # (S, 2)
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]

    def tap(off):
        dy = jnp.round(off[1] * coc).astype(jnp.int32)
        dx = jnp.round(off[0] * coc).astype(jnp.int32)
        return _gather_px(img, ys + dy, xs + dx)

    acc = jax.vmap(tap)(offs)  # (S, H, W, 4)
    return acc.mean(axis=0)


def ambient_occlusion(img, depth, strength, radius: float = 8.0,
                      samples: int = 16):
    """Screen-space AO: darken pixels whose neighborhood is mostly
    closer to the camera (reference: the ambient-occlusion
    post-processing kernel)."""
    h, w = img.shape[:2]
    dtype = img.dtype
    offs = _disk_offsets(samples, dtype) * radius
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]

    def tap(off):
        dy = jnp.round(off[1]).astype(jnp.int32)
        dx = jnp.round(off[0]).astype(jnp.int32)
        dz = _gather_px(depth[..., None], ys + dy, xs + dx)[..., 0]
        closer = (depth - dz) > 0.05 * jnp.abs(depth)
        return closer.astype(dtype)

    occ = jax.vmap(tap)(offs).mean(axis=0)  # (H, W)
    factor = jnp.clip(1.0 - strength * occ, 0.0, 1.0)[..., None]
    out = img * factor
    return out.at[..., 3].set(img[..., 3])


def cartoon(img, depth, levels: float = 4.0, edge_strength: float = 1.0):
    """Posterize + depth-edge darkening (reference: the cartoon/filter
    post-processing effects)."""
    quant = jnp.floor(img[..., :3] * levels) / levels
    dzx = jnp.abs(jnp.diff(depth, axis=1, append=depth[:, -1:]))
    dzy = jnp.abs(jnp.diff(depth, axis=0, append=depth[-1:, :]))
    edge = jnp.clip((dzx + dzy) * edge_strength, 0.0, 1.0)[..., None]
    rgb = quant * (1.0 - edge)
    return jnp.concatenate([rgb, img[..., 3:4]], axis=-1)


def enlightment(img, depth, strength: float = 0.6, radius: float = 24.0,
                samples: int = 32):
    """Screen-space irradiance bleeding (reference: the
    radiosity/"enlightment" post pass — upstream accumulates random-ray
    illumination into the post-processing buffer; the screen-space
    analog gathers neighborhood radiance, depth-weighted so light only
    bleeds along continuous surfaces, and adds it as indirect light).

    Properties pinned by tests: a uniform frame brightens uniformly;
    bright regions bleed onto nearby same-depth pixels; pixels across a
    large depth discontinuity are unaffected by each other.
    """
    h, w = img.shape[:2]
    dtype = img.dtype
    offs = _disk_offsets(samples, dtype) * radius
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    z_scale = 0.08 * jnp.abs(depth) + 1e-3

    def tap(off):
        dy = jnp.round(off[1]).astype(jnp.int32)
        dx = jnp.round(off[0]).astype(jnp.int32)
        c = _gather_px(img, ys + dy, xs + dx)
        z = _gather_px(depth[..., None], ys + dy, xs + dx)[..., 0]
        wgt = jnp.exp(-((z - depth) / z_scale) ** 2)
        return c * wgt[..., None], wgt

    cs, ws = jax.vmap(tap)(offs)  # (S, H, W, 4), (S, H, W)
    indirect = cs.sum(axis=0) / (ws.sum(axis=0)[..., None] + 1e-6)
    rgb = img[..., :3] + strength * 0.5 * indirect[..., :3]
    return jnp.concatenate([rgb, img[..., 3:4]], axis=-1)


def apply_postfx(
    img,
    depth,
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    key: Optional[jax.Array] = None,
):
    """Dispatch on the statically-selected mode (reference: the
    PostProcessingInfo.type switch after the render kernel)."""
    mode = cfg.postfx.mode
    if mode == PostFxMode.NONE:
        return img
    if mode == PostFxMode.DEPTH_OF_FIELD:
        return depth_of_field(
            img, depth, camera.focal_distance,
            jnp.maximum(camera.aperture, 0.05) * 8.0,
            cfg.postfx.samples,
        )
    if mode == PostFxMode.AMBIENT_OCCLUSION:
        return ambient_occlusion(img, depth, scene.info.shadow_intensity,
                                 samples=cfg.postfx.samples)
    if mode == PostFxMode.CARTOON:
        return cartoon(img, depth)
    if mode == PostFxMode.ENLIGHTMENT:
        return enlightment(img, depth, samples=cfg.postfx.samples)
    raise NotImplementedError(mode)
