"""Camera models and primary-ray generation.

Re-creation of the reference's per-pixel camera ray setup in
the render kernels (solr/engines/cuda/CudaRayTracer.cu:
k_standardRenderer / k_anaglyphRenderer / k_3DVisionRenderer /
k_fishEyeRenderer — ray from origin/direction/angles with aperture
jitter for depth of field and per-frame jitter for progressive AA).

All modes produce flat ray batches (R, 3) origins/directions with
R = width * height, so the downstream render loop is mode-agnostic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from solstice.ops.vecmath import normalize, rotate_euler
from solstice.types import Camera, CameraMode, RenderConfig

__all__ = ["camera_rays", "pixel_grid", "rays_from_pixels"]


def pixel_grid(cfg: RenderConfig, dtype=jnp.float32):
    """Pixel centers as (R, 2) [x, y] in pixel units, row-major."""
    xs = jnp.arange(cfg.width, dtype=dtype)
    ys = jnp.arange(cfg.height, dtype=dtype)
    px, py = jnp.meshgrid(xs, ys)  # (H, W)
    return jnp.stack([px.reshape(-1), py.reshape(-1)], axis=-1)


def _ndc(pix, cfg: RenderConfig, jitter):
    """Pixel coords -> [-aspect*s, aspect*s] x [s, -s] image plane."""
    x = pix[..., 0] + 0.5 + jitter[..., 0]
    y = pix[..., 1] + 0.5 + jitter[..., 1]
    u = (2.0 * x / cfg.width - 1.0) * (cfg.width / cfg.height)
    v = 1.0 - 2.0 * y / cfg.height  # +v is up
    return u, v


def _lens_offsets(key, camera: Camera, n, dtype):
    """Concentric-ish lens samples for depth of field (reference: the
    aperture jitter consumed from the random buffer in the render
    kernels)."""
    if key is None:
        return jnp.zeros((n, 2), dtype)
    r = jax.random.uniform(key, (n, 2), dtype)
    ang = r[:, 0] * 2.0 * jnp.pi
    rad = jnp.sqrt(r[:, 1])
    return jnp.stack([jnp.cos(ang) * rad, jnp.sin(ang) * rad], axis=-1)


def _make_rays(camera: Camera, u, v, eye_shift, key, dtype):
    """Rays for a pinhole/thin-lens camera with optional stereo shift."""
    scale = jnp.tan(0.5 * camera.fov)
    d_cam = jnp.stack(
        [u * scale, v * scale, jnp.ones_like(u)], axis=-1
    )
    d_world = normalize(rotate_euler(d_cam, camera.angles))
    right = rotate_euler(
        jnp.asarray([1.0, 0.0, 0.0], dtype), camera.angles
    )
    up = rotate_euler(jnp.asarray([0.0, 1.0, 0.0], dtype), camera.angles)
    o = camera.position + eye_shift * right

    lens = _lens_offsets(key, camera, u.shape[0], dtype) * camera.aperture
    focal = o + d_world * camera.focal_distance
    o = o + right * lens[:, 0:1] + up * lens[:, 1:2]
    d = normalize(focal - o)
    # Pinhole fast-path keeps gradients exact when aperture == 0.
    d = jnp.where(camera.aperture > 0.0, d, d_world)
    o = jnp.where(camera.aperture > 0.0, o, camera.position + eye_shift * right)
    return o, d


def camera_rays(
    camera: Camera,
    cfg: RenderConfig,
    key: Optional[jax.Array] = None,
    dtype=jnp.float32,
) -> Tuple[jax.Array, jax.Array]:
    """Primary rays for the configured camera mode: ((R, 3), (R, 3)).

    ANAGLYPH returns interleaved left/right ray pairs handled by the
    renderer's channel combine; SIDE_BY_SIDE selects the eye per pixel
    column; FISHEYE uses equidistant angular mapping.
    """
    return rays_from_pixels(camera, cfg, pixel_grid(cfg, dtype), key, dtype)


def rays_from_pixels(
    camera: Camera,
    cfg: RenderConfig,
    pix,
    key: Optional[jax.Array] = None,
    dtype=jnp.float32,
) -> Tuple[jax.Array, jax.Array]:
    """Rays for an arbitrary pixel subset ``pix`` (R, 2) — the shardable
    entry point: each device of a mesh passes its own tile's pixels
    (solstice.parallel.render.shard_render)."""
    n = pix.shape[0]
    if key is not None and cfg.antialias_jitter:
        kj, kl = jax.random.split(key)
        jitter = jax.random.uniform(kj, (n, 2), dtype) - 0.5
    else:
        kl = key
        jitter = jnp.zeros((n, 2), dtype)
    u, v = _ndc(pix, cfg, jitter)

    mode = cfg.camera_mode
    if mode == CameraMode.MONO:
        return _make_rays(camera, u, v, jnp.zeros((n, 1), dtype), kl, dtype)

    if mode == CameraMode.SIDE_BY_SIDE:
        # Left half of the image = left eye, right half = right eye
        # (reference: k_3DVisionRenderer).  Each half re-spans the fov.
        half = cfg.width / 2.0
        x = pix[..., 0]
        left = x < half
        xloc = jnp.where(left, x, x - half)
        u = (2.0 * (xloc + 0.5 + jitter[..., 0]) / half - 1.0) * (
            half / cfg.height
        )
        shift = jnp.where(left, -1.0, 1.0)[..., None] * camera.eye_separation
        return _make_rays(camera, u, v, shift, kl, dtype)

    if mode == CameraMode.ANAGLYPH:
        # Rays for both eyes are generated by the renderer via two calls;
        # here we return the cyclopean ray set for mode-agnostic callers.
        return _make_rays(camera, u, v, jnp.zeros((n, 1), dtype), kl, dtype)

    if mode == CameraMode.FISHEYE:
        # Equidistant fisheye (reference: k_fishEyeRenderer): angle from
        # the view axis grows linearly with radial pixel distance.
        r = jnp.sqrt(u * u + v * v)
        max_r = cfg.width / cfg.height  # corner-ish normalization
        theta = r / max_r * camera.fov  # radial angle
        phi = jnp.arctan2(v, u)
        sin_t = jnp.sin(theta)
        d_cam = jnp.stack(
            [sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), jnp.cos(theta)],
            axis=-1,
        )
        d = normalize(rotate_euler(d_cam, camera.angles))
        o = jnp.broadcast_to(camera.position, d.shape)
        return o, d

    raise NotImplementedError(mode)


def eye_rays(camera: Camera, cfg: RenderConfig, eye: float, key, dtype):
    """Full-frame rays for one eye (ANAGLYPH): eye in {-1.0, +1.0}."""
    pix = pixel_grid(cfg, dtype)
    n = pix.shape[0]
    if key is not None and cfg.antialias_jitter:
        kj, kl = jax.random.split(key)
        jitter = jax.random.uniform(kj, (n, 2), dtype) - 0.5
    else:
        kl = key
        jitter = jnp.zeros((n, 2), dtype)
    u, v = _ndc(pix, cfg, jitter)
    shift = jnp.full((n, 1), eye, dtype) * camera.eye_separation
    return _make_rays(camera, u, v, shift, kl, dtype)
