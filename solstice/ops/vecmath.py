"""Vector math primitives (reference: solr/engines/cuda/VectorUtils.cuh —
dotProduct, crossProduct, normalizeVector, vectorReflection,
vectorRefraction, vectorRotation).

All functions are batched: vectors are ``(..., 3)`` arrays and operations
broadcast over leading axes.  Everything is differentiable; guards use
``jnp.where`` (never python branches) so the same code traces under jit,
grad, vmap and inside Pallas kernels.
"""

from __future__ import annotations

import jax.numpy as jnp

from solstice.constants import NORMAL_EPS

__all__ = [
    "dot",
    "cross",
    "norm",
    "normalize",
    "reflect",
    "refract",
    "rotate_euler",
    "orthonormal_basis",
    "spherical_uv",
]


def dot(a, b, keepdims: bool = False):
    """Batched dot product over the last axis."""
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a, b):
    return jnp.cross(a, b)


def norm(v, keepdims: bool = False):
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), NORMAL_EPS))


def normalize(v):
    """Safe normalize: returns v/|v|, zero-safe via epsilon clamp."""
    return v / norm(v, keepdims=True)


def reflect(incident, normal):
    """r = i - 2 (i.n) n  (both unit; reference: vectorReflection)."""
    return incident - 2.0 * dot(incident, normal, keepdims=True) * normal


def refract(incident, normal, eta):
    """Snell refraction with total-internal-reflection fallback
    (reference: vectorRefraction).

    Args:
      incident: (..., 3) unit incoming direction.
      normal:   (..., 3) unit surface normal opposing the incident ray
                (i.n < 0).
      eta:      (...,) or (..., 1) ratio n_incident / n_transmitted.

    Returns:
      (refracted_dir, tir): unit direction — the *reflection* direction
      where total internal reflection occurs — and a boolean TIR mask.
    """
    eta = jnp.asarray(eta)
    if eta.ndim == incident.ndim - 1:
        eta = eta[..., None]
    cos_i = -dot(incident, normal, keepdims=True)
    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    # Double-where: keep the clamped branch out of sqrt or its gradient
    # is 0 * inf = NaN on TIR lanes.
    cos_t = jnp.sqrt(jnp.where(tir, 1.0, 1.0 - sin2_t))
    refr = eta * incident + (eta * cos_i - cos_t) * normal
    refl = reflect(incident, normal)
    out = jnp.where(tir, refl, refr)
    return normalize(out), jnp.squeeze(tir, axis=-1)


def spherical_uv(n):
    """Longitude/latitude UV of a unit direction (reference:
    sphereUVMapping in TextureMapping.cuh), gradient-safe at the poles:
    arcsin' and arctan2's 0/0 both blow up at |n_y| = 1, so the inputs
    are nudged off the singular set (clip for arcsin, epsilon on the
    arctan2 operands when both vanish).
    """
    eps = 1e-6
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    at_pole = (jnp.abs(x) < eps) & (jnp.abs(z) < eps)
    u = 0.5 + jnp.arctan2(
        jnp.where(at_pole, eps, z), jnp.where(at_pole, eps, x)
    ) / (2.0 * jnp.pi)
    v = 0.5 - jnp.arcsin(jnp.clip(y, -1.0 + eps, 1.0 - eps)) / jnp.pi
    return jnp.stack([u, v], axis=-1)


def rotate_euler(v, angles):
    """Rotate vectors by Euler angles (rx, ry, rz), applied X then Y then
    Z (reference: vectorRotation — the camera/primitive rotation).

    Args:
      v: (..., 3), angles: (..., 3) broadcastable.
    """
    ax, ay, az = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = jnp.cos(ax), jnp.sin(ax)
    cy, sy = jnp.cos(ay), jnp.sin(ay)
    cz, sz = jnp.cos(az), jnp.sin(az)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    # X axis
    y, z = cx * y - sx * z, sx * y + cx * z
    # Y axis
    x, z = cy * x + sy * z, -sy * x + cy * z
    # Z axis
    x, y = cz * x - sz * y, sz * x + cz * y
    return jnp.stack([x, y, z], axis=-1)


def orthonormal_basis(n):
    """Build (t, b) orthonormal to unit n (branchless Frisvad-style)."""
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        axis=-1,
    )
    bb = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return t, bb
