"""Texture sampling and procedural textures.

Re-creation of the reference's texture layer
(solr/engines/cuda/TextureMapping.cuh: texel fetch from the flat byte
atlas, sphereUVMapping / triangleUVMapping / cubeMapping, and the
procedural generators mandelbrotSet / juliaSet; atlas layout from
GPUKernel texture storage).

The atlas is a single (NTEXELS, 4) uint8 array; per-texture (offset,
width, height) descriptors address into it.  Sampling is a bilinear
4-texel gather, vectorized over rays — the analog of the reference's
per-thread texel loads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from solstice.types import ProceduralKind, Textures

__all__ = [
    "sample_texture",
    "procedural_color",
    "value_noise",
    "tangent_basis",
    "apply_normal_maps",
    "material_map_scales",
]

# Bump-map height-gradient gain (reference: the fixed perturbation
# scale in TextureMapping.cuh's bump branch).
BUMP_STRENGTH = 2.0


def sample_texture(tex: Textures, tex_id, uv):
    """Bilinear RGBA sample; tex_id (R,) int32 (-1 -> white), uv (R,2).

    UVs wrap (repeat addressing, matching the reference's modulo fetch).
    Returns (R, 4) float in [0, 1].
    """
    if tex.count == 0:
        return jnp.ones(uv.shape[:-1] + (4,), uv.dtype)
    tid = jnp.clip(tex_id, 0, tex.count - 1)
    w = tex.width[tid].astype(uv.dtype)
    h = tex.height[tid].astype(uv.dtype)
    off = tex.offset[tid]
    wi = tex.width[tid]
    hi = tex.height[tid]

    u = uv[..., 0] - jnp.floor(uv[..., 0])
    v = uv[..., 1] - jnp.floor(uv[..., 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def texel(xi, yi):
        xi = jnp.mod(xi.astype(jnp.int32), jnp.maximum(wi, 1))
        yi = jnp.mod(yi.astype(jnp.int32), jnp.maximum(hi, 1))
        idx = off + yi * wi + xi
        return tex.atlas[idx].astype(uv.dtype) / 255.0  # (R, 4)

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    rgba = top * (1 - fy) + bot * fy
    return jnp.where((tex_id >= 0)[..., None], rgba, 1.0)


def _luminance(rgba):
    return (
        0.299 * rgba[..., 0] + 0.587 * rgba[..., 1] + 0.114 * rgba[..., 2]
    )


def material_map_scales(scene, material, uv):
    """Per-hit (specular, reflection, transparency) scale factors from
    the material's three remaining texture slots (reference: Material
    textureIds[specular/reflection/transparency] consumed in
    advancedTextureMapping — SURVEY.md section 2.1).

    Each factor is the texture's luminance at the hit UV, or 1.0 when
    the slot is unset, so a white map is the identity and a black map
    kills the channel (specular highlights gated off, mirrors matte,
    glass opaque).  material (R,) int32; uv (R, 2).  Returns three (R,)
    arrays; differentiable through the bilinear fetch.
    """
    tex = scene.textures
    mats = scene.materials
    if tex.count == 0:
        one = jnp.ones(uv.shape[:-1], uv.dtype)
        return one, one, one

    def scale(tid_per_mat):
        tid = tid_per_mat[material]
        lum = _luminance(sample_texture(tex, tid, uv))
        return jnp.where(tid >= 0, lum, 1.0)

    return (
        scale(mats.texture_specular),
        scale(mats.texture_reflection),
        scale(mats.texture_transparency),
    )


def tangent_basis(n):
    """Branchless orthonormal (tangent, bitangent) for unit normals
    ``n`` (..., 3) — Frisvad's method with Pixar's sign fix.  The frame
    is continuous except across n_z = 0, which is fine for texture-space
    perturbation (the reference's bump/normal mapping is likewise an
    approximate surface frame, not a UV-derivative frame)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = jnp.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = jnp.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    bt = jnp.stack([b, sign + ny * ny * a, -ny], -1)
    return t, bt


def apply_normal_maps(scene, material, uv, n):
    """Perturb shading normals by the material's normal and/or bump
    textures (reference: TextureMapping.cuh — the normal/bump texture
    slots of Material consumed in advancedTextureMapping; VERDICT r02
    missing #4).

    * ``texture_normal``: tangent-space RGB map — rgb*2-1 rotated into
      the (t, b, n) frame.
    * ``texture_bump``: height map — central-difference gradient of the
      luminance tilts the normal by BUMP_STRENGTH.

    material (R,) int32; uv (R, 2); n (R, 3) unit shading normals.
    Returns perturbed unit normals; identity where neither slot is set.
    """
    tex = scene.textures
    if tex.count == 0:
        return n
    mats = scene.materials
    tn = mats.texture_normal[material]
    tb = mats.texture_bump[material]
    t, bt = tangent_basis(n)
    out = n

    rgb = sample_texture(tex, tn, uv)[..., :3] * 2.0 - 1.0
    nm = (
        rgb[..., 0:1] * t + rgb[..., 1:2] * bt + rgb[..., 2:3] * n
    )
    nm = nm / jnp.sqrt(
        jnp.maximum(jnp.sum(nm * nm, -1, keepdims=True), 1e-12)
    )
    out = jnp.where((tn >= 0)[..., None], nm, out)

    # Bump: luminance height field, central differences at one texel.
    tid = jnp.clip(tb, 0, tex.count - 1)
    du = 1.0 / jnp.maximum(tex.width[tid].astype(uv.dtype), 1.0)
    dv = 1.0 / jnp.maximum(tex.height[tid].astype(uv.dtype), 1.0)

    def height(uv_s):
        c = sample_texture(tex, tb, uv_s)
        return (
            0.299 * c[..., 0] + 0.587 * c[..., 1] + 0.114 * c[..., 2]
        )

    zero = jnp.zeros_like(du)
    gu = (
        height(uv + jnp.stack([du, zero], -1))
        - height(uv - jnp.stack([du, zero], -1))
    ) / (2.0 * du)
    gv = (
        height(uv + jnp.stack([zero, dv], -1))
        - height(uv - jnp.stack([zero, dv], -1))
    ) / (2.0 * dv)
    bumped = n - BUMP_STRENGTH * (gu[..., None] * t + gv[..., None] * bt)
    bumped = bumped / jnp.sqrt(
        jnp.maximum(jnp.sum(bumped * bumped, -1, keepdims=True), 1e-12)
    )
    out = jnp.where((tb >= 0)[..., None], bumped, out)
    return out


# --------------------------------------------------------------------------
# Procedural textures
# --------------------------------------------------------------------------

_MANDEL_ITERS = 32


def _escape_time(c_re, c_im, z_re, z_im, iters: int):
    """Escape-time iteration count / iters in [0, 1] (smooth-ish)."""

    def body(carry, _):
        zr, zi, count, alive = carry
        zr2 = zr * zr - zi * zi + c_re
        zi2 = 2.0 * zr * zi + c_im
        mag2 = zr2 * zr2 + zi2 * zi2
        alive_next = alive & (mag2 < 4.0)
        count = count + alive_next.astype(zr.dtype)
        zr = jnp.where(alive_next, zr2, zr)
        zi = jnp.where(alive_next, zi2, zi)
        return (zr, zi, count, alive_next), None

    init = (z_re, z_im, jnp.zeros_like(z_re), jnp.ones_like(z_re, bool))
    (zr, zi, count, _), _ = jax.lax.scan(body, init, None, length=iters)
    return count / iters


def mandelbrot(uv, scale):
    """(reference: TextureMapping.cuh mandelbrotSet)"""
    re = (uv[..., 0] - 0.6) * 2.6 * scale
    im = (uv[..., 1] - 0.5) * 2.4 * scale
    return _escape_time(re, im, jnp.zeros_like(re), jnp.zeros_like(im),
                        _MANDEL_ITERS)


def julia(uv, scale):
    """(reference: TextureMapping.cuh juliaSet)"""
    re = (uv[..., 0] - 0.5) * 3.0 * scale
    im = (uv[..., 1] - 0.5) * 3.0 * scale
    c_re = jnp.full_like(re, -0.70176)
    c_im = jnp.full_like(im, -0.3842)
    return _escape_time(c_re, c_im, re, im, _MANDEL_ITERS)


def _hash2(x, y):
    """Cheap deterministic [0,1) hash of integer lattice points."""
    h = jnp.sin(x * 127.1 + y * 311.7) * 43758.5453
    return h - jnp.floor(h)


def value_noise(p, scale):
    """Smooth 2-D value noise in [0, 1] (the analog of the
    reference's noise-based procedural materials)."""
    q = p * jnp.asarray(scale)[..., None]
    xi = jnp.floor(q[..., 0])
    yi = jnp.floor(q[..., 1])
    fx = q[..., 0] - xi
    fy = q[..., 1] - yi
    # Smoothstep interpolation weights.
    sx = fx * fx * (3.0 - 2.0 * fx)
    sy = fy * fy * (3.0 - 2.0 * fy)
    a = _hash2(xi, yi)
    b = _hash2(xi + 1.0, yi)
    c = _hash2(xi, yi + 1.0)
    d = _hash2(xi + 1.0, yi + 1.0)
    return (a * (1 - sx) + b * sx) * (1 - sy) + (c * (1 - sx) + d * sx) * sy


def turbulence(p, scale, octaves: int = 4):
    out = jnp.zeros(p.shape[:-1], p.dtype)
    amp = 0.5
    freq = 1.0
    for _ in range(octaves):
        out = out + amp * value_noise(p, scale * freq)
        amp *= 0.5
        freq *= 2.0
    return out


def procedural_color(kind, scale, uv, base_color):
    """Procedural albedo by ProceduralKind code (vectorized select).

    Args:
      kind: (R,) int32 ProceduralKind; scale: (R,) frequency;
      uv: (R, 2); base_color: (R, 4).
    Returns (R, 4).
    """
    dt = uv.dtype
    checker = (
        (jnp.floor(uv[..., 0] * scale) + jnp.floor(uv[..., 1] * scale)) % 2.0
    )
    mand = mandelbrot(uv, scale)
    jul = julia(uv, scale)
    noise = value_noise(uv, scale)
    marble = 0.5 + 0.5 * jnp.sin(
        uv[..., 0] * scale * 6.28318 + 4.0 * turbulence(uv, scale)
    )
    granite = jnp.clip(turbulence(uv, scale * 4.0) * 1.4, 0.0, 1.0)

    def tint(f):
        return base_color * f[..., None]

    palette = jnp.stack(
        [
            base_color,  # NONE
            tint(mand),
            tint(jul),
            jnp.where(
                (checker > 0.5)[..., None], base_color, 1.0 - base_color
            ),
            tint(noise),
            tint(marble),
            tint(granite),
        ],
        axis=0,
    )  # (7, R, 4)
    k = jnp.clip(kind, 0, palette.shape[0] - 1)
    out = jnp.take_along_axis(
        palette, k[None, ..., None].astype(jnp.int32), axis=0
    )[0]
    out = out.at[..., 3].set(base_color[..., 3])
    return out.astype(dt)
