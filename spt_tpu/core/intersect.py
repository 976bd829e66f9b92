"""Batched ray-sphere intersection — the hot op.

The reference delegates intersection to Embree's BVH + per-ray
``rtcIntersect1`` (CPUPathTracer.cpp:227) over one-vertex SPHERE_POINT
geometries; the analytic quadratic it relies on is documented at
/root/reference/sphere.md:126-188 (a=|D|², b=2L·D, c=|L|²−r²).

Design: rays are SoA batches and *all primitives are tested at once* in a
(rays × spheres) broadcast grid, which XLA compiles into fused elementwise
loops (the (T,P,3) intermediates below never materialize — each is
consumed by an immediately following reduction).  The compact
``oc = c − o`` form is used because the algebraically equivalent expanded
form (two (T,3)×(3,P) matrix products) loses ~10 bits to cancellation when
scene coordinates are large relative to hit distances, which flips grazing
hits.  There is no matrix product here, so no ``precision`` setting is
involved.

Convention: directions need not be unit length (``a = |d|²`` is kept), hit
distance must satisfy t > tmin (the reference's tnear = 1e-3), missing rays
get hit_id = -1 and t = inf.
"""

from __future__ import annotations

import jax.numpy as jnp

TMIN = 1e-3  # the reference's tnear (CPUPathTracer.cpp:221)


def _quadratic_t(b, a, c, tmin):
    """Smallest valid root of a·t² − 2b·t + c = 0 (ray-sphere form).

    Returns (t, valid).  Gradient-safe at disc == 0 via double-where.
    """
    disc = b * b - a * c
    pos = disc > 0.0
    # 1e-12 floor bounds the grazing-incidence gradient (see physics.py).
    sq = jnp.where(pos, jnp.sqrt(jnp.maximum(
        jnp.where(pos, disc, 1.0), 1e-12)), 0.0)
    inv_a = jnp.reciprocal(a)
    t0 = (b - sq) * inv_a
    t1 = (b + sq) * inv_a
    t = jnp.where(t0 > tmin, t0, t1)
    return t, pos & (t > tmin)


def intersect_spheres(o, d, centers, radii, valid, tmin=TMIN, tmax=jnp.inf):
    """Nearest-hit of ray batch vs sphere set (compact, numerically stable).

    Args:
      o, d: (..., T, 3) ray origins / directions.
      centers: (P, 3); radii: (P,); valid: (P,) bool padding mask.
    Returns:
      t: (..., T) hit distance (inf on miss)
      hit_id: (..., T) int32 primitive index (-1 on miss)
    """
    oc = centers - o[..., None, :]                      # (T, P, 3) fused
    a = jnp.sum(d * d, axis=-1, keepdims=True)          # (T, 1)
    b = jnp.sum(d[..., None, :] * oc, axis=-1)          # (T, P)
    c = jnp.sum(oc * oc, axis=-1) - radii * radii       # (T, P)
    t, ok = _quadratic_t(b, a, c, tmin)
    hit = ok & (t < tmax) & valid
    t = jnp.where(hit, t, jnp.inf)
    t_best = jnp.min(t, axis=-1)
    hit_id = jnp.argmin(t, axis=-1).astype(jnp.int32)
    hit_id = jnp.where(jnp.isfinite(t_best), hit_id, -1)
    return t_best, hit_id


def occluded(o, d, centers, radii, valid, tmax, tmin=TMIN):
    """Any-hit (shadow ray) test: True where something blocks (tmin, tmax).

    Same quadratic as intersect_spheres but without the argmin — a pure
    any-reduce, cheaper and fusion-friendly for NEE shadow rays.
    """
    oc = centers - o[..., None, :]
    a = jnp.sum(d * d, axis=-1, keepdims=True)
    b = jnp.sum(d[..., None, :] * oc, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radii * radii
    t, ok = _quadratic_t(b, a, c, tmin)
    blocked = ok & (t < tmax[..., None]) & valid
    return jnp.any(blocked, axis=-1)


def sphere_normal(p, center):
    """Outward geometric normal of a sphere at surface point ``p``.

    The reference normalizes Embree's geometric normal
    (CPUPathTracer.cpp:244-250); for spheres that is (p - center)/|p - center|.
    """
    n = p - center
    return n * jnp.reciprocal(
        jnp.sqrt(jnp.maximum(jnp.sum(n * n, axis=-1, keepdims=True), 1e-20)))
