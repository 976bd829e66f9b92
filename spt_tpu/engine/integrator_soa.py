"""SoA differentiable integrator — the plain-XLA render and fwd+bwd path.

Same estimator, RNG streams, and semantics as
``integrator_jax.render_megasample`` (the AoS oracle), laid out as
component arrays:

* every per-ray quantity is a separate ``(N,)`` f32 component array — no
  trailing ``(..., 3)`` axis, so scan carries and AD residuals stay one
  flat array per component.

* small scenes (capacity ≤ ``SOA_MAX_PRIMS``) visit primitives in a
  *static unroll* with scalar attribute reads (traced scalars, so geometry
  gradients still flow) and vector selects; larger scenes use the skip-link
  BVH with per-lane gathers (``core/bvh.py``).

* material *types* are static python ints (``static_mtypes``) so the lobe
  dispatch is boolean algebra resolved at trace time.

On a GPU this is the engine for every scene the Triton megakernel does
not take (engine/pallas_backend.py), and ``jax.grad`` through it is the
production path-replay backward: the remat'd scan re-derives every RNG
draw, and residual/carry memory stays O(N) per component.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..core.materials import DIELECTRIC, LAMBERT, METAL
from ..core.scene import SKY_CONSTANT, SKY_ENVMAP, SKY_GRADIENT, SceneData

_NDIMS = 8
_DIM_RR, _DIM_U1, _DIM_U2, _DIM_LSEL, _DIM_LU1, _DIM_LU2, _DIM_LOBE = range(7)
_CAM_SLOT = 0xFFFF * _NDIMS

TMIN = 1e-3
EPS = 1e-4
BIG = 1e30

SOA_MAX_PRIMS = 128  # static-unroll budget; beyond this the BVH mode


def static_mtypes(scene: SceneData) -> tuple:
    """Per-sphere material types as a static tuple (host-side read)."""
    mt = np.asarray(scene.materials.mtype)
    mid = np.asarray(scene.mat_id)
    valid = np.asarray(scene.prim_valid)
    return tuple(int(mt[mid[i]]) if valid[i] else LAMBERT
                 for i in range(scene.capacity))


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize(x, y, z):
    inv = jax.lax.rsqrt(jnp.maximum(x * x + y * y + z * z, 1e-20))
    return x * inv, y * inv, z * inv


def _cross(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def _onb(nx, ny, nz):
    use_z = jnp.abs(nz) < 0.999
    ux = jnp.where(use_z, 0.0, 1.0)
    uy = jnp.zeros_like(nx)
    uz = jnp.where(use_z, 1.0, 0.0)
    tx, ty, tz = _cross(ux, uy, uz, nx, ny, nz)
    tx, ty, tz = _normalize(tx, ty, tz)
    bx, by, bz = _cross(nx, ny, nz, tx, ty, tz)
    return tx, ty, tz, bx, by, bz


def _schlick1(cos_i, f0):
    m = jnp.clip(1.0 - cos_i, 0.0, 1.0)
    m2 = m * m
    return f0 + (1.0 - f0) * m2 * m2 * m


def _fresnel_dielectric(cos_i, eta_ti):
    cos_i = jnp.clip(cos_i, 0.0, 1.0)
    sin2_t = (1.0 / (eta_ti * eta_ti)) * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = sin2_t >= 1.0
    safe = jnp.where(tir, 1.0, 1.0 - sin2_t)
    cos_t = jnp.where(tir, 0.0, jnp.sqrt(jnp.maximum(safe, 1e-12)))
    rs = (cos_i - eta_ti * cos_t) / jnp.maximum(cos_i + eta_ti * cos_t, 1e-8)
    rp = (eta_ti * cos_i - cos_t) / jnp.maximum(eta_ti * cos_i + cos_t, 1e-8)
    f = 0.5 * (rs * rs + rp * rp)
    return jnp.where(tir, 1.0, f)


def render_megasample_soa(scene: SceneData, camera, width: int, height: int,
                          sample_ids, *, mtypes: tuple = None,
                          max_bounces: int = 8, rr_depth: int = 3,
                          use_nee: bool = True, use_mis: bool = True,
                          seed: int = 0, row_offset=0,
                          full_height: int = None, with_stats: bool = False,
                          with_occupancy: bool = False, dof: bool = False):
    """(H, W, 3) radiance sum over sample_ids — SoA fast path.

    ``with_stats`` additionally returns the traced ray-segment count;
    ``with_occupancy`` additionally returns the (max_bounces,) active-lane
    fraction at each bounce — the measurement that motivates (or kills)
    wavefront compaction.

    ``mtypes``: static per-sphere material-type tuple (``static_mtypes``);
    required under jit (the scene arg is traced there).  Scenes larger than
    ``SOA_MAX_PRIMS`` switch from the static per-sphere unroll to gather-
    based attribute fetch + skip-link BVH traversal (``mtypes`` unused);
    they must be compiled with a BVH.
    """
    big = scene.capacity > SOA_MAX_PRIMS
    if big and scene.bvh is None:
        raise ValueError(f"scenes over {SOA_MAX_PRIMS} prims need a BVH; "
                         f"compile with use_bvh=True")
    if mtypes is None and not big:
        mtypes = static_mtypes(scene)
    if full_height is None:
        full_height = height
    P = scene.capacity
    n_px = height * width
    px_i = jnp.broadcast_to(jnp.arange(width, dtype=jnp.int32)[None, :],
                            (height, width)).reshape(-1)
    py_i = jnp.broadcast_to(jnp.arange(height, dtype=jnp.int32)[:, None],
                            (height, width)).reshape(-1)
    py_i = py_i + jnp.asarray(row_offset, jnp.int32)
    pid = (py_i * width + px_i).astype(jnp.uint32)
    seed_u = jnp.uint32(seed)
    nl = max(scene.num_lights, 1)
    has_lights = scene.num_lights > 0 and use_nee
    from ..kernels import physics as _physics
    lsb = _physics.lsel_bounds(scene.centers, scene.radii,
                               scene.prim_valid)
    n_light_slots = scene.light_idx.shape[0]

    # Per-sphere scalar attribute getters (traced; gradients flow).  The
    # material tables are gathered per sphere once, so each sphere's
    # scalars are static-index reads and the backward pass needs one
    # scatter-add per table instead of one dynamic update per sphere.
    alb = scene.materials.albedo
    emi = scene.materials.emission
    rough_t = scene.materials.roughness
    ior_t = scene.materials.ior
    alb_p, emi_p = alb[scene.mat_id], emi[scene.mat_id]
    rough_p, ior_p = rough_t[scene.mat_id], ior_t[scene.mat_id]

    def sphere_attrs(j):
        return (scene.centers[j, 0], scene.centers[j, 1], scene.centers[j, 2],
                scene.radii[j], alb_p[j, 0], alb_p[j, 1], alb_p[j, 2],
                emi_p[j, 0], emi_p[j, 1], emi_p[j, 2], rough_p[j], ior_p[j])

    def sky(dx, dy, dz):
        if scene.sky_mode == SKY_GRADIENT:
            t = 0.5 * (dy + 1.0)
            h0 = scene.sky_params[0]
            z0 = scene.sky_params[1]
            return (h0[0] * (1 - t) + z0[0] * t, h0[1] * (1 - t) + z0[1] * t,
                    h0[2] * (1 - t) + z0[2] * t)
        if scene.sky_mode == SKY_CONSTANT:
            one = jnp.ones_like(dx)
            c = scene.sky_params[0]
            return c[0] * one, c[1] * one, c[2] * one
        if scene.sky_mode == SKY_ENVMAP and scene.env_map is not None:
            from .integrator_jax import sample_env_map_soa
            return sample_env_map_soa(scene.env_map, dx, dy, dz)
        z = jnp.zeros_like(dx)
        return z, z, z

    # Light-slot attribute tables (one gather each; see sphere_attrs).
    light_c = scene.centers[scene.light_idx]
    light_r = scene.radii[scene.light_idx]
    light_e = emi[scene.mat_id[scene.light_idx]]

    # Primitive component arrays for the gather-based large-scene path.
    cx_a = scene.centers[:, 0]
    cy_a = scene.centers[:, 1]
    cz_a = scene.centers[:, 2]
    r_a = scene.radii

    def intersect_all_bvh(ox, oy, oz, dx, dy, dz):
        """Large-scene nearest hit: SoA BVH traversal + differentiable
        attribute gathers (winner id is discrete; t and attrs carry grads)."""
        from ..core.bvh import intersect_bvh_soa
        t, hit_id = intersect_bvh_soa(ox, oy, oz, dx, dy, dz,
                                      cx_a, cy_a, cz_a, r_a, scene.bvh,
                                      tmin=TMIN)
        found = hit_id >= 0
        hid = jnp.maximum(hit_id, 0)
        m = scene.mat_id[hid]
        fz = lambda v: jnp.where(found, v, 0.0)
        h = dict(cx=fz(cx_a[hid]), cy=fz(cy_a[hid]), cz=fz(cz_a[hid]),
                 r=fz(r_a[hid]),
                 ar=fz(alb[m, 0]), ag=fz(alb[m, 1]), ab=fz(alb[m, 2]),
                 er=fz(emi[m, 0]), eg=fz(emi[m, 1]), eb=fz(emi[m, 2]),
                 rough=fz(rough_t[m]),
                 ior=jnp.where(found, ior_t[m], 1.5))
        mt = scene.materials.mtype[m]
        m_lam = found & (mt == LAMBERT)
        m_met = found & (mt == METAL)
        m_die = found & (mt == DIELECTRIC)
        t_best = jnp.where(found, t, BIG)
        return t_best, h, m_lam, m_met, m_die

    def occluded_before_bvh(ox, oy, oz, dx, dy, dz, tmax):
        from ..core.bvh import occluded_bvh_soa
        return occluded_bvh_soa(ox, oy, oz, dx, dy, dz,
                                cx_a, cy_a, cz_a, r_a, scene.bvh,
                                jnp.maximum(tmax, 0.0), tmin=TMIN)

    def intersect_all(ox, oy, oz, dx, dy, dz):
        t_best = jnp.full((n_px,), BIG, jnp.float32)
        zero = jnp.zeros((n_px,), jnp.float32)
        h = dict(cx=zero, cy=zero, cz=zero, r=zero, ar=zero, ag=zero, ab=zero,
                 er=zero, eg=zero, eb=zero, rough=zero,
                 ior=jnp.full((n_px,), 1.5, jnp.float32))
        false = jnp.zeros((n_px,), bool)
        m_lam, m_met, m_die = false, false, false
        for j in range(P):
            cx, cy, cz, r, ar, ag, ab, er, eg, eb, ro, io = sphere_attrs(j)
            ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
            b = _dot(dx, dy, dz, ocx, ocy, ocz)
            c = _dot(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
            disc = b * b - c
            pos = disc > 0.0
            # Grazing-gradient floor; see kernels/physics.py.
            sq = jnp.where(pos, jnp.sqrt(jnp.maximum(
                jnp.where(pos, disc, 1.0), 1e-12)), 0.0)
            t0 = b - sq
            t1 = b + sq
            tj = jnp.where(t0 > TMIN, t0, t1)
            ok = pos & (tj > TMIN) & (tj < t_best)
            t_best = jnp.where(ok, tj, t_best)
            vals = dict(cx=cx, cy=cy, cz=cz, r=r, ar=ar, ag=ag, ab=ab,
                        er=er, eg=eg, eb=eb, rough=ro, ior=io)
            for k in h:
                h[k] = jnp.where(ok, vals[k], h[k])
            mt = mtypes[j]
            m_lam = (m_lam & ~ok) | (ok if mt == LAMBERT else false)
            m_met = (m_met & ~ok) | (ok if mt == METAL else false)
            m_die = (m_die & ~ok) | (ok if mt == DIELECTRIC else false)
        return t_best, h, m_lam, m_met, m_die

    def occluded_before(ox, oy, oz, dx, dy, dz, tmax):
        blocked = jnp.zeros((n_px,), bool)
        for j in range(P):
            cx, cy, cz, r = sphere_attrs(j)[:4]
            ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
            b = _dot(dx, dy, dz, ocx, ocy, ocz)
            c = _dot(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
            disc = b * b - c
            pos = disc > 0.0
            sq = jnp.where(pos, jnp.sqrt(jnp.maximum(
                jnp.where(pos, disc, 1.0), 1e-12)), 0.0)
            t0 = b - sq
            t1 = b + sq
            tj = jnp.where(t0 > TMIN, t0, t1)
            blocked = blocked | (pos & (tj > TMIN) & (tj < tmax))
        # Occlusion is a discrete visibility decision — detach it.
        return jax.lax.stop_gradient(blocked)

    if big:  # gather+BVH path replaces the static per-sphere unroll
        intersect_all = intersect_all_bvh
        occluded_before = occluded_before_bvh

    cam_px, cam_py, cam_pz = camera.position[0], camera.position[1], camera.position[2]
    cam_rx, cam_ry, cam_rz = camera.right[0], camera.right[1], camera.right[2]
    cam_ux, cam_uy, cam_uz = camera.up[0], camera.up[1], camera.up[2]
    cam_fx, cam_fy, cam_fz = camera.forward[0], camera.forward[1], camera.forward[2]

    def one_sample(carry, sample_id):
        sid = jnp.asarray(sample_id, jnp.uint32)
        sid_b = jnp.broadcast_to(sid, (n_px,))
        jx = rng.counter_uniform(pid, sid_b, jnp.uint32(_CAM_SLOT + 0), seed_u)
        jy = rng.counter_uniform(pid, sid_b, jnp.uint32(_CAM_SLOT + 1), seed_u)
        aspect = jnp.float32(width / full_height)
        sx = (px_i.astype(jnp.float32) + jx) * (1.0 / width)
        sy = (py_i.astype(jnp.float32) + jy) * (1.0 / full_height)
        ndc_x = (2.0 * sx - 1.0) * aspect * camera.tan_half_fov
        ndc_y = (1.0 - 2.0 * sy) * camera.tan_half_fov
        dx = ndc_x * cam_rx + ndc_y * cam_ux + cam_fx
        dy = ndc_x * cam_ry + ndc_y * cam_uy + cam_fy
        dz = ndc_x * cam_rz + ndc_y * cam_uz + cam_fz
        dx, dy, dz = _normalize(dx, dy, dz)
        ones = jnp.ones((n_px,), jnp.float32)
        ox, oy, oz = ones * cam_px, ones * cam_py, ones * cam_pz
        if dof:
            # Thin-lens: same math + RNG dims (_CAM_SLOT+2/3) as
            # Camera.generate_rays and the Pallas megakernel raygen.
            lu = rng.counter_uniform(pid, sid_b, jnp.uint32(_CAM_SLOT + 2),
                                     seed_u)
            lv = rng.counter_uniform(pid, sid_b, jnp.uint32(_CAM_SLOT + 3),
                                     seed_u)
            r = camera.aperture * jnp.sqrt(lu)
            phi = jnp.float32(2.0 * np.pi) * lv
            cphi, sphi = jnp.cos(phi), jnp.sin(phi)
            offx = r * (cphi * cam_rx + sphi * cam_ux)
            offy = r * (cphi * cam_ry + sphi * cam_uy)
            offz = r * (cphi * cam_rz + sphi * cam_uz)
            denom = jnp.maximum(dx * cam_fx + dy * cam_fy + dz * cam_fz, 1e-6)
            tf = camera.focus_dist / denom
            fx, fy, fz = ox + dx * tf, oy + dy * tf, oz + dz * tf
            ox, oy, oz = ox + offx, oy + offy, oz + offz
            dx, dy, dz = _normalize(fx - ox, fy - oy, fz - oz)
        state = (ox, oy, oz,                                   # o
                 dx, dy, dz,                                   # d
                 ones, ones, ones,                             # throughput
                 jnp.zeros((n_px,), jnp.float32),              # rad r
                 jnp.zeros((n_px,), jnp.float32),              # rad g
                 jnp.zeros((n_px,), jnp.float32),              # rad b
                 jnp.ones((n_px,), bool),                      # active
                 jnp.zeros((n_px,), jnp.float32),              # prev_pdf
                 jnp.ones((n_px,), bool),                      # prev_specular
                 jnp.zeros((), jnp.float32))                   # ray count

        def bounce(state, k):
            (ox, oy, oz, dx, dy, dz, th_r, th_g, th_b,
             rad_r, rad_g, rad_b, active, prev_pdf, prev_spec, n_rays) = state

            t, h, m_lam, m_met, m_die = intersect_all(ox, oy, oz, dx, dy, dz)
            found = t < BIG
            hit = active & found
            miss = active & ~found
            n_active = jnp.sum(active.astype(jnp.float32))
            n_rays = n_rays + n_active
            if has_lights:
                n_rays = n_rays + jnp.sum(hit.astype(jnp.float32))

            sk_r, sk_g, sk_b = sky(dx, dy, dz)
            rad_r = jnp.where(miss, rad_r + th_r * sk_r, rad_r)
            rad_g = jnp.where(miss, rad_g + th_g * sk_g, rad_g)
            rad_b = jnp.where(miss, rad_b + th_b * sk_b, rad_b)

            t_safe = jnp.where(hit, t, 1.0)
            hx = ox + t_safe * dx
            hy = oy + t_safe * dy
            hz = oz + t_safe * dz
            ngx, ngy, ngz = _normalize(hx - h["cx"], hy - h["cy"], hz - h["cz"])
            wox, woy, woz = -dx, -dy, -dz

            emitting = hit & ((h["er"] + h["eg"] + h["eb"]) > 0.0) \
                & (_dot(wox, woy, woz, ngx, ngy, ngz) > 0.0)
            if has_lights and use_mis:
                tocx, tocy, tocz = h["cx"] - ox, h["cy"] - oy, h["cz"] - oz
                d2 = jnp.maximum(_dot(tocx, tocy, tocz, tocx, tocy, tocz), 1e-12)
                sin2 = jnp.clip(h["r"] * h["r"] / d2, 0.0, 1.0)
                deg = sin2 >= 1.0
                cosm = jnp.where(deg, 0.0,
                                 jnp.sqrt(jnp.where(deg, 1.0, 1.0 - sin2)))
                pdf_lh = 1.0 / jnp.maximum(2.0 * math.pi * (1.0 - cosm), 1e-9)
                pdf_lh = pdf_lh / nl
                pp2 = prev_pdf * prev_pdf
                w_b = pp2 / jnp.maximum(pp2 + pdf_lh * pdf_lh, 1e-20)
                w_emit = jnp.where(prev_spec, 1.0, w_b)
            elif has_lights:
                w_emit = jnp.where(prev_spec, 1.0, 0.0)
            else:
                w_emit = jnp.ones_like(prev_pdf)
            rad_r = jnp.where(emitting, rad_r + th_r * h["er"] * w_emit, rad_r)
            rad_g = jnp.where(emitting, rad_g + th_g * h["eg"] * w_emit, rad_g)
            rad_b = jnp.where(emitting, rad_b + th_b * h["eb"] * w_emit, rad_b)

            front = _dot(wox, woy, woz, ngx, ngy, ngz) > 0.0
            sgn = jnp.where(front, 1.0, -1.0)
            nsx, nsy, nsz = ngx * sgn, ngy * sgn, ngz * sgn

            u_lobe = rng.counter_uniform(
                pid, sid_b, k.astype(jnp.uint32) * _NDIMS + _DIM_LOBE, seed_u)
            u1 = rng.counter_uniform(
                pid, sid_b, k.astype(jnp.uint32) * _NDIMS + _DIM_U1, seed_u)
            u2 = rng.counter_uniform(
                pid, sid_b, k.astype(jnp.uint32) * _NDIMS + _DIM_U2, seed_u)

            tx, ty, tz, bx, by, bz = _onb(nsx, nsy, nsz)

            # Lambert cosine sample.
            ct = jnp.sqrt(u1)
            st = jnp.sqrt(jnp.maximum(0.0, 1.0 - u1))
            phi = (2.0 * math.pi) * u2
            cphi = jnp.cos(phi)
            sphi = jnp.sin(phi)
            dl_x = st * cphi * tx + st * sphi * bx + ct * nsx
            dl_y = st * cphi * ty + st * sphi * by + ct * nsy
            dl_z = st * cphi * tz + st * sphi * bz + ct * nsz
            pdf_lam = jnp.maximum(_dot(nsx, nsy, nsz, dl_x, dl_y, dl_z), 0.0) \
                * (1.0 / math.pi)

            # GGX metal.
            alpha = jnp.maximum(h["rough"] * h["rough"], 1e-4)
            a2g = alpha * alpha
            cos2h = (1.0 - u1) / (1.0 + (a2g - 1.0) * u1)
            cth = jnp.sqrt(jnp.maximum(cos2h, 0.0))
            sth = jnp.sqrt(jnp.maximum(1.0 - cos2h, 1e-12))
            hwx = sth * cphi * tx + sth * sphi * bx + cth * nsx
            hwy = sth * cphi * ty + sth * sphi * by + cth * nsy
            hwz = sth * cphi * tz + sth * sphi * bz + cth * nsz
            odoth = jnp.maximum(_dot(wox, woy, woz, hwx, hwy, hwz), 1e-6)
            dm_x = 2.0 * odoth * hwx - wox
            dm_y = 2.0 * odoth * hwy - woy
            dm_z = 2.0 * odoth * hwz - woz
            ndotl_m = _dot(nsx, nsy, nsz, dm_x, dm_y, dm_z)
            ndotv = jnp.maximum(_dot(nsx, nsy, nsz, wox, woy, woz), 1e-6)
            ndoth = jnp.maximum(_dot(nsx, nsy, nsz, hwx, hwy, hwz), 1e-6)
            kg = alpha * 0.5
            g1v = ndotv / (ndotv * (1.0 - kg) + kg)
            ndotl_mc = jnp.maximum(ndotl_m, 1e-6)
            g1l = ndotl_mc / (ndotl_mc * (1.0 - kg) + kg)
            gterm = g1v * g1l
            met_ok = ndotl_m > 1e-6
            f_met_r = _schlick1(odoth, h["ar"])
            f_met_g = _schlick1(odoth, h["ag"])
            f_met_b = _schlick1(odoth, h["ab"])
            w_met_scale = jnp.where(met_ok, gterm * odoth / (ndotv * ndoth), 0.0)
            dggx = a2g / jnp.maximum(
                math.pi * ((ndoth * ndoth * (a2g - 1.0) + 1.0) ** 2), 1e-12)
            pdf_met = dggx * ndoth / (4.0 * odoth)

            # Dielectric.
            ior = jnp.maximum(h["ior"], 1.001)
            eta = jnp.where(front, 1.0 / ior, ior)
            cos_i = jnp.maximum(_dot(wox, woy, woz, nsx, nsy, nsz), 1e-6)
            f_die = _fresnel_dielectric(cos_i, 1.0 / eta)
            dr_x = 2.0 * cos_i * nsx - wox
            dr_y = 2.0 * cos_i * nsy - woy
            dr_z = 2.0 * cos_i * nsz - woz
            sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
            tir = sin2_t >= 1.0
            safe = jnp.where(tir, 1.0, 1.0 - sin2_t)
            cos_t = jnp.where(tir, 0.0, jnp.sqrt(jnp.maximum(safe, 1e-12)))
            dt_x = eta * (-wox) + (eta * cos_i - cos_t) * nsx
            dt_y = eta * (-woy) + (eta * cos_i - cos_t) * nsy
            dt_z = eta * (-woz) + (eta * cos_i - cos_t) * nsz
            dt_x, dt_y, dt_z = _normalize(dt_x, dt_y, dt_z)
            refl = (u_lobe < f_die) | tir
            dd_x = jnp.where(refl, dr_x, dt_x)
            dd_y = jnp.where(refl, dr_y, dt_y)
            dd_z = jnp.where(refl, dr_z, dt_z)

            nd_x = jnp.where(m_lam, dl_x, jnp.where(m_met, dm_x, dd_x))
            nd_y = jnp.where(m_lam, dl_y, jnp.where(m_met, dm_y, dd_y))
            nd_z = jnp.where(m_lam, dl_z, jnp.where(m_met, dm_z, dd_z))
            w_r = jnp.where(m_lam, h["ar"], jnp.where(
                m_met, f_met_r * w_met_scale, jnp.where(refl, 1.0, h["ar"])))
            w_g = jnp.where(m_lam, h["ag"], jnp.where(
                m_met, f_met_g * w_met_scale, jnp.where(refl, 1.0, h["ag"])))
            w_b2 = jnp.where(m_lam, h["ab"], jnp.where(
                m_met, f_met_b * w_met_scale, jnp.where(refl, 1.0, h["ab"])))
            pdf_new = jnp.where(m_lam, pdf_lam, jnp.where(m_met, pdf_met, 0.0))
            spec_new = m_die
            dead = m_met & ~met_ok
            off_sign = jnp.where(m_die & ~refl, -1.0, 1.0)

            if has_lights:
                k0 = k == 0
                cell = _physics.lsel_cell(
                    jnp.where(k0, hx, ox), jnp.where(k0, hy, oy),
                    jnp.where(k0, hz, oz), (lsb[0], lsb[1], lsb[2]),
                    (lsb[3], lsb[4], lsb[5]))
                ul = rng.counter_uniform(
                    cell, sid_b, k.astype(jnp.uint32) * _NDIMS + _DIM_LSEL, seed_u)
                lu1 = rng.counter_uniform(
                    pid, sid_b, k.astype(jnp.uint32) * _NDIMS + _DIM_LU1, seed_u)
                lu2 = rng.counter_uniform(
                    pid, sid_b, k.astype(jnp.uint32) * _NDIMS + _DIM_LU2, seed_u)
                nlf = jnp.float32(nl)
                li = jnp.minimum((ul * nlf).astype(jnp.int32), nl - 1)
                if big:  # gather-based light fetch (many emitters possible)
                    lp_g = scene.light_idx[li]
                    lm_g = scene.mat_id[lp_g]
                    lcx = cx_a[lp_g]
                    lcy = cy_a[lp_g]
                    lcz = cz_a[lp_g]
                    lrr = r_a[lp_g]
                    ler = emi[lm_g, 0]
                    leg = emi[lm_g, 1]
                    leb = emi[lm_g, 2]
                else:
                    zero = jnp.zeros((n_px,), jnp.float32)
                    lcx, lcy, lcz, lrr = zero, zero, zero, zero
                    ler, leg, leb = zero, zero, zero
                    for l in range(min(n_light_slots, nl)):
                        sel = li == l
                        lcx = jnp.where(sel, light_c[l, 0], lcx)
                        lcy = jnp.where(sel, light_c[l, 1], lcy)
                        lcz = jnp.where(sel, light_c[l, 2], lcz)
                        lrr = jnp.where(sel, light_r[l], lrr)
                        ler = jnp.where(sel, light_e[l, 0], ler)
                        leg = jnp.where(sel, light_e[l, 1], leg)
                        leb = jnp.where(sel, light_e[l, 2], leb)
                pox = hx + EPS * nsx
                poy = hy + EPS * nsy
                poz = hz + EPS * nsz
                tocx, tocy, tocz = lcx - pox, lcy - poy, lcz - poz
                d2 = jnp.maximum(_dot(tocx, tocy, tocz, tocx, tocy, tocz), 1e-12)
                dist = jnp.sqrt(d2)
                inside_l = dist <= lrr
                sin2m = jnp.clip(lrr * lrr / d2, 0.0, 1.0)
                degm = sin2m >= 1.0
                cosm = jnp.where(degm, 0.0,
                                 jnp.sqrt(jnp.where(degm, 1.0, 1.0 - sin2m)))
                ctl = 1.0 - lu1 * (1.0 - cosm)
                stl = jnp.sqrt(jnp.maximum(1.0 - ctl * ctl, 1e-12))
                phil = (2.0 * math.pi) * lu2
                wlx, wly, wlz = tocx / dist, tocy / dist, tocz / dist
                ltx, lty, ltz, lbx, lby, lbz = _onb(wlx, wly, wlz)
                cpl = jnp.cos(phil)
                spl = jnp.sin(phil)
                ldx = stl * cpl * ltx + stl * spl * lbx + ctl * wlx
                ldy = stl * cpl * lty + stl * spl * lby + ctl * wly
                ldz = stl * cpl * ltz + stl * spl * lbz + ctl * wlz
                pdf_l = 1.0 / jnp.maximum(2.0 * math.pi * (1.0 - cosm), 1e-9)
                pdf_l = pdf_l / nlf
                bl = _dot(ldx, ldy, ldz, tocx, tocy, tocz)
                cl = _dot(tocx, tocy, tocz, tocx, tocy, tocz) - lrr * lrr
                discl = jnp.maximum(bl * bl - cl, 0.0)
                t_l = bl - jnp.sqrt(jnp.maximum(discl, 1e-20))
                blocked = occluded_before(pox, poy, poz, ldx, ldy, ldz,
                                          t_l - 1e-3)
                lit = ~blocked & ~inside_l & (t_l > TMIN)
                ndotl = jnp.maximum(_dot(nsx, nsy, nsz, ldx, ldy, ldz), 0.0)
                pdf_b_lam = ndotl * (1.0 / math.pi)
                hsx, hsy, hsz = wox + ldx, woy + ldy, woz + ldz
                hlen2 = hsx * hsx + hsy * hsy + hsz * hsz
                h_ok = hlen2 > 1e-12
                hinv = jax.lax.rsqrt(jnp.where(h_ok, hlen2, 1.0))
                hhx = jnp.where(h_ok, hsx, 0.0) * hinv
                hhy = jnp.where(h_ok, hsy, 0.0) * hinv
                hhz = jnp.where(h_ok, hsz, 0.0) * hinv
                ndoth_e = jnp.maximum(_dot(nsx, nsy, nsz, hhx, hhy, hhz), 1e-6)
                odoth_e = jnp.maximum(_dot(wox, woy, woz, hhx, hhy, hhz), 1e-6)
                dggx_e = a2g / jnp.maximum(
                    math.pi * ((ndoth_e * ndoth_e * (a2g - 1.0) + 1.0) ** 2),
                    1e-12)
                ndotl_c = jnp.maximum(ndotl, 1e-6)
                g1l_e = ndotl_c / (ndotl_c * (1.0 - kg) + kg)
                g_e = g1v * g1l_e
                fmr = _schlick1(odoth_e, h["ar"])
                fmg = _schlick1(odoth_e, h["ag"])
                fmb = _schlick1(odoth_e, h["ab"])
                spec_e = jnp.where(h_ok, dggx_e * g_e / (4.0 * ndotv * ndotl_c),
                                   0.0)
                fl = 1.0 / math.pi
                fcos_r = jnp.where(m_lam, h["ar"] * fl,
                                   jnp.where(m_met, fmr * spec_e, 0.0)) * ndotl
                fcos_g = jnp.where(m_lam, h["ag"] * fl,
                                   jnp.where(m_met, fmg * spec_e, 0.0)) * ndotl
                fcos_b = jnp.where(m_lam, h["ab"] * fl,
                                   jnp.where(m_met, fmb * spec_e, 0.0)) * ndotl
                pdf_b_at_l = jnp.where(m_lam, pdf_b_lam, jnp.where(
                    m_met, jnp.where(h_ok, dggx_e * ndoth_e / (4.0 * odoth_e),
                                     0.0), 0.0))
                if use_mis:
                    pl2 = pdf_l * pdf_l
                    w_nee = pl2 / jnp.maximum(pl2 + pdf_b_at_l * pdf_b_at_l,
                                              1e-20)
                else:
                    w_nee = jnp.ones_like(pdf_l)
                scale = w_nee / jnp.maximum(pdf_l, 1e-12)
                nee_ok = hit & lit & ~spec_new & (pdf_l > 0.0)
                rad_r = jnp.where(nee_ok, rad_r + th_r * fcos_r * ler * scale,
                                  rad_r)
                rad_g = jnp.where(nee_ok, rad_g + th_g * fcos_g * leg * scale,
                                  rad_g)
                rad_b = jnp.where(nee_ok, rad_b + th_b * fcos_b * leb * scale,
                                  rad_b)

            th_r_n = th_r * w_r
            th_g_n = th_g * w_g
            th_b_n = th_b * w_b2
            active_n = hit & ~dead
            u_rr = rng.counter_uniform(
                pid, sid_b, k.astype(jnp.uint32) * _NDIMS + _DIM_RR, seed_u)
            rr_on = k >= rr_depth
            p_cont = jnp.clip(jnp.maximum(th_r_n, jnp.maximum(th_g_n, th_b_n)),
                              0.05, 0.95)
            kill = rr_on & (u_rr > p_cont)
            active_n = active_n & ~kill
            rr_scale = jnp.where(rr_on, 1.0 / p_cont, 1.0)
            th_r_n = th_r_n * rr_scale
            th_g_n = th_g_n * rr_scale
            th_b_n = th_b_n * rr_scale

            ox = jnp.where(active_n, hx + EPS * off_sign * nsx, ox)
            oy = jnp.where(active_n, hy + EPS * off_sign * nsy, oy)
            oz = jnp.where(active_n, hz + EPS * off_sign * nsz, oz)
            dx = jnp.where(active_n, nd_x, dx)
            dy = jnp.where(active_n, nd_y, dy)
            dz = jnp.where(active_n, nd_z, dz)
            th_r = jnp.where(active_n, th_r_n, th_r)
            th_g = jnp.where(active_n, th_g_n, th_g)
            th_b = jnp.where(active_n, th_b_n, th_b)
            prev_pdf = jnp.where(active_n, pdf_new, prev_pdf)
            prev_spec = (active_n & spec_new) | (~active_n & prev_spec)

            return (ox, oy, oz, dx, dy, dz, th_r, th_g, th_b,
                    rad_r, rad_g, rad_b, active_n, prev_pdf, prev_spec,
                    n_rays), n_active

        state, occ_steps = jax.lax.scan(jax.checkpoint(bounce), state,
                                        jnp.arange(max_bounces))
        acc_r, acc_g, acc_b, acc_n, acc_occ = carry
        return (acc_r + state[9], acc_g + state[10], acc_b + state[11],
                acc_n + state[15], acc_occ + occ_steps), None

    zero_img = jnp.zeros((n_px,), jnp.float32)
    carry0 = (zero_img, zero_img, zero_img, jnp.zeros((), jnp.float32),
              jnp.zeros((max_bounces,), jnp.float32))
    carry, _ = jax.lax.scan(jax.checkpoint(one_sample), carry0,
                            jnp.asarray(sample_ids))
    r, g, b, n_rays, occ_counts = carry
    img = jnp.stack([r, g, b], axis=-1).reshape(height, width, 3)
    if with_occupancy:
        n_samples = jnp.asarray(sample_ids).shape[0]
        occupancy = occ_counts / jnp.float32(max(n_px * n_samples, 1))
        return img, n_rays, occupancy
    if with_stats:
        return img, n_rays
    return img
