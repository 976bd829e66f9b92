"""Per-bounce transport physics shared by the megakernel and its tests.

One pure-jnp function, ``trace_bounce``, implements a single bounce on
component arrays: intersection (static sphere unroll over scalar uniforms,
or a caller-supplied intersector), emission with MIS weighting, NEE with
sphere-cone light sampling, branchless Lambert/GGX/dielectric sampling,
Russian roulette.

``kernels/megakernel.py`` calls it once per bounce inside the Triton
kernel, with its own intersection loop; tests/test_pallas_grad.py drives it
as a plain-jnp bounce chain and checks its forward and ``jax.grad`` against
the SoA integrator.

Inputs:
  * ``theta`` — nested tuples of *scalar* jnp values (per-sphere geometry +
    material, sky colors, per-light-slot attributes).
  * ``state`` — tuple of 13 f32 arrays (o, d, throughput, radiance,
    prev_pdf): the differentiable carry.
  * ``aux`` — bool arrays (active, prev_specular) + RNG uniforms: non-
    differentiable, passed alongside.

The math matches integrator_soa.render_megasample_soa term for term
(identical RNG stream consumption), which is the oracle it is tested
against.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.materials import DIELECTRIC, LAMBERT, METAL
from ..core.scene import SKY_CONSTANT, SKY_ENVMAP, SKY_GRADIENT  # noqa: F401

TMIN = 1e-3
EPS = 1e-4
BIG = 1e30

# Canonical RNG stream layout shared by every integrator (the megakernel,
# integrator_jax, integrator_soa): dim = bounce * N_DIMS + D.
N_DIMS = 8
DIM_RR, DIM_U1, DIM_U2, DIM_LSEL, DIM_LU1, DIM_LU2, DIM_LOBE = range(7)

# NEE light selection is keyed on the SHADING-POINT CELL, not the pixel:
# quantize the shading point into a LSEL_CELLS^3 grid over the scene's
# primitive bounds and draw the light index from
# counter_uniform(cell, sample, bounce*N_DIMS+DIM_LSEL, seed).  A pure
# deterministic function (replay-safe, sharding-safe, identical in every
# integrator) and still uniform over lights per (pixel, sample), so the
# estimator stays unbiased; all rays shading inside one cell at one
# (sample, bounce) target the same light.  The cost is cell-sized spatial
# correlation of direct-light noise at low spp.  Every integrator must key
# the pick the same way, or their images stop agreeing.
LSEL_CELLS = 16


def lsel_bounds(centers, radii, valid):
    """Canonical (lo3, ext3) cell-grid bounds, as one (6,) f32 array.

    Min/max of c±r over prims with ``valid & r > 0`` — exact (order-free)
    float reductions, so every backend computing this from the same scene
    arrays gets bit-identical bounds (the parity requirement for the
    cell-keyed light pick).  Works on jnp or np inputs.
    """
    c = jnp.asarray(centers, jnp.float32)
    r = jnp.asarray(radii, jnp.float32)
    ok = jnp.asarray(valid, bool) & (r > 0)
    big = jnp.float32(3e38)
    lo = jnp.min(jnp.where(ok[:, None], c - r[:, None], big), axis=0)
    hi = jnp.max(jnp.where(ok[:, None], c + r[:, None], -big), axis=0)
    any_ok = jnp.any(ok)
    lo = jnp.where(any_ok, lo, 0.0)
    ext = jnp.where(any_ok, jnp.maximum(hi - lo, 1e-5), 1.0)
    return jnp.concatenate([lo, ext])


def lsel_cell(hx, hy, hz, lo3, ext3):
    """Quantized shading-point cell id (u32) — the light pick's stream key."""
    n = jnp.float32(LSEL_CELLS)
    cell = None
    for h, l, e in zip((hx, hy, hz), lo3, ext3):
        q = jnp.clip((h - l) * (n / e), 0.0, n - 1.0).astype(jnp.int32)
        cell = q if cell is None else cell * LSEL_CELLS + q
    return cell.astype(jnp.uint32)


def lsel_uniform(kx, ky, kz, u, k):
    """The cell-keyed light-selection uniform (see LSEL_CELLS).

    Key point convention (identical in every backend): the HIT point at
    bounce 0 (origin-keying would give the whole image one light per
    sample, since every camera ray starts at the eye), the RAY ORIGIN at
    bounces >= 1, which is the previous hit point."""
    cell = lsel_cell(kx, ky, kz, u["lsel_lo"], u["lsel_ext"])
    dim = jnp.uint32(jnp.asarray(k, jnp.uint32) * N_DIMS + DIM_LSEL)
    return rng.counter_uniform(cell, u["sample"], dim, u["seed"])

N_SKY_ATTRS = 6       # horizon rgb, zenith rgb
# Sphere-attribute slots (cx cy cz r ar ag ab er eg eb rough ior) that make
# up a light's 7 attributes (cx cy cz r er eg eb).
LIGHT_TO_SPHERE_ATTR = (0, 1, 2, 3, 7, 8, 9)


class BounceCfg(NamedTuple):
    """Per-bounce configuration; every field but ``k`` is static."""
    mtypes: tuple        # per-sphere material type ints
    k: int               # bounce index (a Python int or a traced scalar)
    rr_depth: int
    use_nee: bool
    use_mis: bool
    sky_mode: int
    n_light_slots: int


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


def sky_radiance(sky, dx, dy, dz, sky_mode):
    """Sky scalars -> per-lane radiance. sky = 6 scalars (horizon, zenith)."""
    if sky_mode == SKY_GRADIENT:
        t = 0.5 * (dy + 1.0)
        return (sky[0] * (1.0 - t) + sky[3] * t,
                sky[1] * (1.0 - t) + sky[4] * t,
                sky[2] * (1.0 - t) + sky[5] * t)
    if sky_mode == SKY_CONSTANT:
        one = jnp.ones_like(dx)
        return sky[0] * one, sky[1] * one, sky[2] * one
    z = jnp.zeros_like(dx)
    return z, z, z


def intersect_spheres_unrolled(spheres, mtypes, ox, oy, oz, dx, dy, dz,
                               tmax=None):
    """Static unroll over per-sphere scalar tuples; nearest hit + attrs."""
    t_best = jnp.full_like(ox, BIG)
    zero = jnp.zeros_like(ox)
    h = dict(cx=zero, cy=zero, cz=zero, r=zero, ar=zero, ag=zero, ab=zero,
             er=zero, eg=zero, eb=zero, rough=zero,
             ior=jnp.full_like(ox, 1.5))
    false = jnp.zeros(ox.shape, bool)
    m_lam, m_met, m_die = false, false, false
    j_best = jnp.zeros_like(ox)  # f32 winner index (for residual/debug)
    for j, attrs in enumerate(spheres):
        cx, cy, cz, r, ar, ag, ab, er, eg, eb, ro, io = attrs
        ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
        b = _dot(dx, dy, dz, ocx, ocy, ocz)
        c = _dot(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
        disc = b * b - c
        pos = disc > 0.0
        # The 1e-12 floor bounds dt/dtheta at grazing incidence (otherwise
        # the sqrt gradient reaches 1/sqrt(disc) ~ 1e15 and overflows f32
        # in deep adjoint chains); forward t changes by <= 1e-6.
        sq = jnp.where(pos, jnp.sqrt(jnp.maximum(
            jnp.where(pos, disc, 1.0), 1e-12)), 0.0)
        t0 = b - sq
        t1 = b + sq
        tj = jnp.where(t0 > TMIN, t0, t1)
        ok = pos & (tj > TMIN) & (tj < t_best)
        if tmax is not None:
            ok = ok & (tj < tmax)
        t_best = jnp.where(ok, tj, t_best)
        vals = dict(cx=cx, cy=cy, cz=cz, r=r, ar=ar, ag=ag, ab=ab,
                    er=er, eg=eg, eb=eb, rough=ro, ior=io)
        for key in h:
            h[key] = jnp.where(ok, vals[key], h[key])
        j_best = jnp.where(ok, jnp.float32(j), j_best)
        mt = mtypes[j]
        m_lam = (m_lam & ~ok) | (ok if mt == LAMBERT else false)
        m_met = (m_met & ~ok) | (ok if mt == METAL else false)
        m_die = (m_die & ~ok) | (ok if mt == DIELECTRIC else false)
    return t_best, h, m_lam, m_met, m_die, j_best


def occluded_unrolled(spheres, ox, oy, oz, dx, dy, dz, tmax):
    blocked = jnp.zeros(ox.shape, bool)
    for attrs in spheres:
        cx, cy, cz, r = attrs[:4]
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
    return blocked


def nee_shadow_setup(ox, oy, oz, hx, hy, hz, nsx, nsy, nsz, u, lights, nl,
                     nlf, k):
    """Light pick + sphere-cone sample + shadow-ray construction.

    ``lights`` is a tuple of 7-scalar tuples (kernel scalar loads and XLA
    0-d arrays both fit).

    Returns (pox, poy, poz, ldx, ldy, ldz, t_l, pdf_l, inside_l,
    ler, leg, leb).
    """
    if "lsel_lo" in u:
        # Key point: the hit at bounce 0, the bounce's input ray origin
        # after (``k`` may be traced).
        k0 = k == 0
        ul = lsel_uniform(jnp.where(k0, hx, ox), jnp.where(k0, hy, oy),
                          jnp.where(k0, hz, oz), u, k)
    else:
        ul = u["lsel"]   # legacy per-pixel stream (small fallbacks)
    lu1, lu2 = u["lu1"], u["lu2"]
    li = jnp.minimum((ul * nlf).astype(jnp.int32), nl - 1)
    zero = jnp.zeros_like(ox)
    lcx, lcy, lcz, lrr = zero, zero, zero, zero
    ler, leg, leb = zero, zero, zero
    for l, lat in enumerate(lights):
        sel = (li == l) & (l < nl)
        lcx = jnp.where(sel, lat[0], lcx)
        lcy = jnp.where(sel, lat[1], lcy)
        lcz = jnp.where(sel, lat[2], lcz)
        lrr = jnp.where(sel, lat[3], lrr)
        ler = jnp.where(sel, lat[4], ler)
        leg = jnp.where(sel, lat[5], leg)
        leb = jnp.where(sel, lat[6], leb)
    pox = hx + EPS * nsx
    poy = hy + EPS * nsy
    poz = hz + EPS * nsz
    tocx, tocy, tocz = lcx - pox, lcy - poy, lcz - poz
    d2 = jnp.maximum(_dot(tocx, tocy, tocz, tocx, tocy, tocz), 1e-12)
    dist = jnp.sqrt(d2)
    inside_l = dist <= lrr
    sin2m = jnp.clip(lrr * lrr / d2, 0.0, 1.0)
    degm = sin2m >= 1.0
    cosm_l = jnp.where(degm, 0.0,
                       jnp.sqrt(jnp.where(degm, 1.0, 1.0 - sin2m)))
    ctl = 1.0 - lu1 * (1.0 - cosm_l)
    # Same sqrt'(0) hazard as sth: ctl == 1 at lu1 == 0 and ctl depends
    # on light geometry.
    stl = jnp.sqrt(jnp.maximum(1.0 - ctl * ctl, 1e-12))
    phil = (2.0 * math.pi) * lu2
    wlx, wly, wlz = tocx / dist, tocy / dist, tocz / dist
    ltx, lty, ltz, lbx, lby, lbz = _onb(wlx, wly, wlz)
    cpl = jnp.cos(phil)
    spl = jnp.sin(phil)
    ldx = stl * cpl * ltx + stl * spl * lbx + ctl * wlx
    ldy = stl * cpl * lty + stl * spl * lby + ctl * wly
    ldz = stl * cpl * ltz + stl * spl * lbz + ctl * wlz
    pdf_l = 1.0 / jnp.maximum(2.0 * math.pi * (1.0 - cosm_l), 1e-9)
    pdf_l = pdf_l / nlf
    bl = _dot(ldx, ldy, ldz, tocx, tocy, tocz)
    cl = _dot(tocx, tocy, tocz, tocx, tocy, tocz) - lrr * lrr
    discl = jnp.maximum(bl * bl - cl, 0.0)
    t_l = bl - jnp.sqrt(jnp.maximum(discl, 1e-20))
    return (pox, poy, poz, ldx, ldy, ldz, t_l, pdf_l, inside_l,
            ler, leg, leb)


def trace_bounce(theta, state, aux, u, nl, cfg: BounceCfg,
                 intersect_fn=None, occluded_fn=None):
    """One bounce of a batch of paths.

    theta = (spheres: tuple[P] of 12-scalar tuples,
             sky: 6-scalar tuple,
             lights: tuple[L] of 7-scalar tuples)   -- differentiable
    state = (ox,oy,oz, dx,dy,dz, th_r,th_g,th_b,
             rad_r,rad_g,rad_b, prev_pdf)           -- differentiable carry
    aux   = (active, prev_spec)  bool arrays        -- non-diff
    u     = dict rr,u1,u2,lobe[,lsel,lu1,lu2]       -- non-diff uniforms
    nl    = dynamic scalar int: live light count
    intersect_fn(ox,oy,oz,dx,dy,dz, active) -> (t, h, m_lam, m_met, m_die):
        optional replacement for the static sphere unroll (the megakernel
        plugs its sphere loop in here); default uses ``theta[0]``.
    occluded_fn(ox,oy,oz,dx,dy,dz, tmax, need) -> blocked: likewise for the
        NEE shadow test (``need`` marks lanes whose result matters).
    Returns (new_state, new_aux).
    """
    spheres, sky, lights = theta
    (ox, oy, oz, dx, dy, dz, th_r, th_g, th_b,
     rad_r, rad_g, rad_b, prev_pdf) = state
    active, prev_spec = aux
    k = cfg.k
    use_nee = cfg.use_nee and cfg.n_light_slots > 0
    use_mis = cfg.use_mis

    if intersect_fn is None:
        t, h, m_lam, m_met, m_die, _ = intersect_spheres_unrolled(
            spheres, cfg.mtypes, ox, oy, oz, dx, dy, dz)
    else:
        t, h, m_lam, m_met, m_die = intersect_fn(ox, oy, oz, dx, dy, dz,
                                                 active)
    found = t < BIG
    hit = active & found
    miss = active & ~found

    sk_r, sk_g, sk_b = sky_radiance(sky, dx, dy, dz, cfg.sky_mode)
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
    nlf = jnp.maximum(nl.astype(jnp.float32), 1.0)
    if use_nee and use_mis:
        tocx, tocy, tocz = h["cx"] - ox, h["cy"] - oy, h["cz"] - oz
        d2 = jnp.maximum(_dot(tocx, tocy, tocz, tocx, tocy, tocz), 1e-12)
        sin2 = jnp.clip(h["r"] * h["r"] / d2, 0.0, 1.0)
        deg = sin2 >= 1.0
        cosm = jnp.where(deg, 0.0, jnp.sqrt(jnp.where(deg, 1.0, 1.0 - sin2)))
        pdf_lh = 1.0 / jnp.maximum(2.0 * math.pi * (1.0 - cosm), 1e-9)
        pdf_lh = pdf_lh / nlf
        pp2 = prev_pdf * prev_pdf
        w_b = pp2 / jnp.maximum(pp2 + pdf_lh * pdf_lh, 1e-20)
        w_emit = jnp.where(prev_spec, 1.0, w_b)
        w_emit = jnp.where(nl > 0, w_emit, 1.0)
    elif use_nee:
        w_emit = jnp.where(prev_spec, 1.0, 0.0)
        w_emit = jnp.where(nl > 0, w_emit, 1.0)
    else:
        w_emit = jnp.ones_like(prev_pdf)
    rad_r = jnp.where(emitting, rad_r + th_r * h["er"] * w_emit, rad_r)
    rad_g = jnp.where(emitting, rad_g + th_g * h["eg"] * w_emit, rad_g)
    rad_b = jnp.where(emitting, rad_b + th_b * h["eb"] * w_emit, rad_b)

    front = _dot(wox, woy, woz, ngx, ngy, ngz) > 0.0
    sgn = jnp.where(front, 1.0, -1.0)
    nsx, nsy, nsz = ngx * sgn, ngy * sgn, ngz * sgn

    u_lobe, u1, u2 = u["lobe"], u["u1"], u["u2"]
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
    # 1e-12 floor: at u1 == 0 exactly, cos2h == 1 and sqrt'(0) = inf would
    # poison the roughness cotangent (cos2h depends on alpha).
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

    # -- next-event estimation ---------------------------------------------
    if use_nee:
        ns = nee_shadow_setup(ox, oy, oz, hx, hy, hz, nsx, nsy, nsz, u,
                              lights, nl, nlf, k)
        (pox, poy, poz, ldx, ldy, ldz, t_l, pdf_l, inside_l,
         ler, leg, leb) = ns
        if occluded_fn is None:
            blocked = occluded_unrolled(spheres, pox, poy, poz, ldx, ldy,
                                        ldz, t_l - 1e-3)
        else:
            blocked = occluded_fn(pox, poy, poz, ldx, ldy, ldz, t_l - 1e-3,
                                  hit & ~spec_new)
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
            math.pi * ((ndoth_e * ndoth_e * (a2g - 1.0) + 1.0) ** 2), 1e-12)
        ndotl_c = jnp.maximum(ndotl, 1e-6)
        g1l_e = ndotl_c / (ndotl_c * (1.0 - kg) + kg)
        g_e = g1v * g1l_e
        fmr = _schlick1(odoth_e, h["ar"])
        fmg = _schlick1(odoth_e, h["ag"])
        fmb = _schlick1(odoth_e, h["ab"])
        spec_e = jnp.where(h_ok, dggx_e * g_e / (4.0 * ndotv * ndotl_c), 0.0)
        fl = 1.0 / math.pi
        fcos_r = jnp.where(m_lam, h["ar"] * fl,
                           jnp.where(m_met, fmr * spec_e, 0.0)) * ndotl
        fcos_g = jnp.where(m_lam, h["ag"] * fl,
                           jnp.where(m_met, fmg * spec_e, 0.0)) * ndotl
        fcos_b = jnp.where(m_lam, h["ab"] * fl,
                           jnp.where(m_met, fmb * spec_e, 0.0)) * ndotl
        pdf_b_at_l = jnp.where(m_lam, pdf_b_lam, jnp.where(
            m_met, jnp.where(h_ok, dggx_e * ndoth_e / (4.0 * odoth_e), 0.0),
            0.0))
        if use_mis:
            pl2 = pdf_l * pdf_l
            w_nee = pl2 / jnp.maximum(pl2 + pdf_b_at_l * pdf_b_at_l, 1e-20)
        else:
            w_nee = jnp.ones_like(pdf_l)
        scale = w_nee / jnp.maximum(pdf_l, 1e-12)
        nee_ok = hit & lit & ~spec_new & (pdf_l > 0.0) & (nl > 0)
        rad_r = jnp.where(nee_ok, rad_r + th_r * fcos_r * ler * scale, rad_r)
        rad_g = jnp.where(nee_ok, rad_g + th_g * fcos_g * leg * scale, rad_g)
        rad_b = jnp.where(nee_ok, rad_b + th_b * fcos_b * leb * scale, rad_b)

    # -- throughput update + Russian roulette ------------------------------
    th_r_n = th_r * w_r
    th_g_n = th_g * w_g
    th_b_n = th_b * w_b2
    active_n = hit & ~dead
    rr_on = k >= cfg.rr_depth
    p_cont = jnp.clip(jnp.maximum(th_r_n, jnp.maximum(th_g_n, th_b_n)),
                      0.05, 0.95)
    # RR decisions are discrete: detach the continuation probability from
    # the kill test; the 1/p_cont weight stays differentiable.
    kill = rr_on & (u["rr"] > jax.lax.stop_gradient(p_cont))
    active_n = active_n & ~kill
    inv_p = jnp.where(rr_on, 1.0 / p_cont, 1.0)
    th_r_n = th_r_n * inv_p
    th_g_n = th_g_n * inv_p
    th_b_n = th_b_n * inv_p

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

    new_state = (ox, oy, oz, dx, dy, dz, th_r, th_g, th_b,
                 rad_r, rad_g, rad_b, prev_pdf)
    new_aux = (active_n, prev_spec)
    return new_state, new_aux
