"""Pure-JAX wavefront integrators.

This backend is the framework's *reference implementation*: readable,
differentiable end-to-end, and the oracle that the Pallas megakernel must
match bit-for-bit on RNG streams and statistically on radiance.

Two integrators:

* ``render_reference_sample`` — reproduces the C++ reference renderer's exact
  semantics (SURVEY.md §2.3; CPUPathTracer.cpp:43-326): hard-coded pinhole +z
  camera with no jitter, 1 spp per call, fixed 0.7 albedo, sky-gradient-only
  lighting, max 4 bounces, Russian roulette after bounce 2, and the
  bit-exact stateful hash RNG.  The per-pixel recursive CPU loop becomes a
  masked SoA wavefront: every bounce intersects the *whole* ray batch via
  batched all-pairs sphere tests, lanes deactivate on miss/termination.

* ``render_megasample`` — the framework-native integrator: sub-pixel
  jittered positionable camera, material table (Lambert / GGX metal /
  dielectric), emissive-sphere area lights with next-event estimation and
  MIS (power heuristic), honored max_bounces / RR depth, counter-based
  stateless RNG (identical streams in any execution order or sharding).

Everything is jit-compatible with static shapes; control flow is masks and
``lax.scan`` — no data-dependent Python branching.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import intersect, rng, sampling
from ..core.bvh import intersect_bvh
from ..core.materials import DIELECTRIC, LAMBERT, METAL
from ..core.scene import SKY_CONSTANT, SKY_ENVMAP, SKY_GRADIENT, SceneData

EPS_OFFSET = 1e-4  # the reference's surface offset (CPUPathTracer.cpp:277)

# RNG dimension ids (per bounce) for the counter-based discipline.
_NDIMS = 8
_DIM_RR = 0
_DIM_U1 = 1
_DIM_U2 = 2
_DIM_LSEL = 3
_DIM_LU1 = 4
_DIM_LU2 = 5
_DIM_LOBE = 6
# Camera dims live in a reserved "bounce" slot so they never collide.
_CAM_SLOT_JX = 0
_CAM_SLOT_JY = 1
_CAM_SLOT_LU = 2
_CAM_SLOT_LV = 3


def scene_intersect(scene: SceneData, o, d, tmax=jnp.inf):
    """Nearest-hit dispatch: BVH traversal when the compiled scene carries
    one (large scenes), all-pairs brute force otherwise.  The choice is
    static (pytree structure), so each variant jit-specializes cleanly."""
    if scene.bvh is not None:
        return intersect_bvh(o, d, scene.centers, scene.radii, scene.bvh,
                             tmax=tmax)
    return intersect.intersect_spheres(
        o, d, scene.centers, scene.radii, scene.prim_valid, tmax=tmax)


def scene_occluded(scene: SceneData, o, d, tmax):
    """Any-hit shadow test with tmax, via BVH or brute force."""
    if scene.bvh is not None:
        _, hid = intersect_bvh(o, d, scene.centers, scene.radii, scene.bvh,
                               tmax=tmax)
        return hid >= 0
    return intersect.occluded(o, d, scene.centers, scene.radii,
                              scene.prim_valid, tmax)


def sample_sky(d, scene: SceneData):
    """Environment radiance for direction batch ``d``.

    GRADIENT mode reproduces the reference's sample_sky
    (CPUPathTracer.cpp:286-292): mix(horizon, zenith, 0.5*(dir.y+1)).
    """
    if scene.sky_mode == SKY_GRADIENT:
        t = 0.5 * (d[..., 1:2] + 1.0)
        horizon = scene.sky_params[0]
        zenith = scene.sky_params[1]
        return horizon * (1.0 - t) + zenith * t
    if scene.sky_mode == SKY_CONSTANT:
        return jnp.broadcast_to(scene.sky_params[0], d.shape)
    if scene.sky_mode == SKY_ENVMAP and scene.env_map is not None:
        return sample_env_map(scene.env_map, d)
    return jnp.zeros_like(d)


def sample_env_map(env, d):
    """Equirectangular lookup: dir -> (u, v) -> bilinear radiance sample."""
    he, we = env.shape[0], env.shape[1]
    u = (jnp.arctan2(d[..., 0], d[..., 2]) * (0.5 / jnp.pi) + 0.5) * we - 0.5
    v = (jnp.arccos(jnp.clip(d[..., 1], -1.0, 1.0)) / jnp.pi) * he - 0.5
    v = jnp.clip(v, 0.0, he - 1.0)  # clamp-to-edge at the poles
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0i = jnp.mod(u0.astype(jnp.int32), we)
    u1i = jnp.mod(u0i + 1, we)
    v0i = jnp.clip(v0.astype(jnp.int32), 0, he - 1)
    v1i = jnp.clip(v0i + 1, 0, he - 1)
    c00 = env[v0i, u0i]
    c01 = env[v0i, u1i]
    c10 = env[v1i, u0i]
    c11 = env[v1i, u1i]
    return ((c00 * (1 - fu) + c01 * fu) * (1 - fv)
            + (c10 * (1 - fu) + c11 * fu) * fv)


def sample_env_map_soa(env, dx, dy, dz):
    """``sample_env_map`` on component arrays -> (r, g, b) components.

    Bit-identical math to ``sample_env_map`` but never materializes a
    trailing-3 tensor; gathers run on flat per-channel tables instead.
    """
    he, we = env.shape[0], env.shape[1]
    flat = env.reshape(he * we, 3)
    u = (jnp.arctan2(dx, dz) * (0.5 / jnp.pi) + 0.5) * we - 0.5
    v = (jnp.arccos(jnp.clip(dy, -1.0, 1.0)) / jnp.pi) * he - 0.5
    v = jnp.clip(v, 0.0, he - 1.0)
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    fu = u - u0
    fv = v - v0
    u0i = jnp.mod(u0.astype(jnp.int32), we)
    u1i = jnp.mod(u0i + 1, we)
    v0i = jnp.clip(v0.astype(jnp.int32), 0, he - 1)
    v1i = jnp.clip(v0i + 1, 0, he - 1)
    i00 = v0i * we + u0i
    i01 = v0i * we + u1i
    i10 = v1i * we + u0i
    i11 = v1i * we + u1i
    out = []
    for c in range(3):
        tab = flat[:, c]
        c00 = jnp.take(tab, i00)
        c01 = jnp.take(tab, i01)
        c10 = jnp.take(tab, i10)
        c11 = jnp.take(tab, i11)
        out.append((c00 * (1 - fu) + c01 * fu) * (1 - fv)
                   + (c10 * (1 - fu) + c11 * fu) * fv)
    return tuple(out)


# ---------------------------------------------------------------------------
# Reference-semantics integrator (parity mode).
# ---------------------------------------------------------------------------


def render_reference_sample(scene: SceneData, width: int, height: int, frame):
    """One progressive sample with the reference's exact semantics.

    Returns (H, W, 3) radiance for frame index ``frame`` (0-based; the
    reference seeds with frame+1 — CPUPathTracer.cpp:61).  Adding successive
    frames and dividing reproduces its progressive accumulation.
    """
    px = jnp.broadcast_to(jnp.arange(width, dtype=jnp.uint32)[None, :], (height, width))
    py = jnp.broadcast_to(jnp.arange(height, dtype=jnp.uint32)[:, None], (height, width))
    px = px.reshape(-1)
    py = py.reshape(-1)

    state = rng.ref_seed(px, py, jnp.uint32(width), jnp.asarray(frame, jnp.uint32) + 1)

    # Hard-coded camera (CPUPathTracer.cpp:62-73).
    aspect = jnp.float32(width) / jnp.float32(height)
    u = px.astype(jnp.float32) * (1.0 / jnp.float32(width))
    v = 1.0 - py.astype(jnp.float32) * (1.0 / jnp.float32(height))
    uv_x = (u * 2.0 - 1.0) * aspect
    uv_y = v * 2.0 - 1.0
    inv_len = 1.0 / jnp.sqrt(uv_x * uv_x + uv_y * uv_y + 1.0)
    d = jnp.stack([uv_x * inv_len, uv_y * inv_len, inv_len], axis=-1)
    o = jnp.zeros_like(d)

    radiance = jnp.zeros_like(d)
    throughput = jnp.ones_like(d)
    active = jnp.ones(px.shape, bool)

    # max_bounces = 4 hard-coded (CPUPathTracer.cpp:199); RR applies when the
    # post-increment bounce count exceeds 2, i.e. loop iterations k >= 2.
    for k in range(4):
        t, hit_id = scene_intersect(scene, o, d)
        hit = active & (hit_id >= 0)
        miss = active & (hit_id < 0)

        radiance = jnp.where(miss[:, None],
                             radiance + throughput * sample_sky(d, scene),
                             radiance)
        active = hit

        t_safe = jnp.where(hit, t, 1.0)[:, None]
        p = o + t_safe * d
        centers_hit = scene.centers[jnp.maximum(hit_id, 0)]
        n = intersect.sphere_normal(p, centers_hit)

        throughput = jnp.where(hit[:, None], throughput * 0.7, throughput)

        if k >= 2:
            new_state, u_rr = rng.ref_next(state)
            state = jnp.where(hit, new_state, state)
            p_cont = jnp.max(throughput, axis=-1)
            survive = u_rr <= p_cont
            active = active & survive
            throughput = jnp.where(active[:, None],
                                   throughput / jnp.maximum(p_cont, 1e-12)[:, None],
                                   throughput)

        new_state, u1 = rng.ref_next(state)
        state = jnp.where(active, new_state, state)
        new_state, u2 = rng.ref_next(state)
        state = jnp.where(active, new_state, state)

        d_new = sampling.cosine_hemisphere(n, u1, u2)
        d = jnp.where(active[:, None], d_new, d)
        o = jnp.where(active[:, None], p + EPS_OFFSET * n, o)

    return radiance.reshape(height, width, 3)


# ---------------------------------------------------------------------------
# Framework-native integrator: materials, NEE, MIS, counter RNG.
# ---------------------------------------------------------------------------


def _u(pixel, sample, bounce, dim, seed):
    return rng.counter_uniform(pixel, sample, bounce * jnp.uint32(_NDIMS) + jnp.uint32(dim), seed)


def _camera_rays(camera, px, py, pixel_id, sample_id, width, height, seed,
                 jitter: bool, dof: bool):
    cam_slot = jnp.uint32(0xFFFF) * jnp.uint32(_NDIMS)
    if jitter:
        jx = rng.counter_uniform(pixel_id, sample_id, cam_slot + _CAM_SLOT_JX, seed)
        jy = rng.counter_uniform(pixel_id, sample_id, cam_slot + _CAM_SLOT_JY, seed)
    else:
        jx = jnp.full(px.shape, 0.5, jnp.float32)
        jy = jnp.full(px.shape, 0.5, jnp.float32)
    if dof:
        lu = rng.counter_uniform(pixel_id, sample_id, cam_slot + _CAM_SLOT_LU, seed)
        lv = rng.counter_uniform(pixel_id, sample_id, cam_slot + _CAM_SLOT_LV, seed)
        return camera.generate_rays(px, py, width, height, jx, jy, lu, lv)
    return camera.generate_rays(px, py, width, height, jx, jy)


def _shade_and_sample(scene: SceneData, p, n_g, wo, mat_id, u_lobe, u1, u2):
    """Branchless material dispatch: sample a new direction + path weight.

    Args:
      p: hit points (N,3); n_g: geometric normals (N,3) (outward);
      wo: direction *toward* the camera (= -ray dir); mat_id: (N,) i32.
    Returns dict with new direction, throughput multiplier, solid-angle pdf of
    the sampled direction (0 for delta lobes), specular flag, and the offset
    sign for the next origin (+1 reflect side, -1 transmit side).
    """
    albedo, _, roughness, ior, mtype = scene.materials.gather(mat_id)
    front = sampling.dot(wo, n_g)[..., 0] > 0.0
    ns = jnp.where(front[:, None], n_g, -n_g)  # shading normal, same side as wo

    # --- Lambert ---------------------------------------------------------
    d_lam = sampling.cosine_hemisphere(ns, u1, u2)
    w_lam = albedo
    pdf_lam = sampling.cosine_hemisphere_pdf(ns, d_lam)

    # --- GGX metal -------------------------------------------------------
    h = sampling.ggx_sample_half(ns, roughness, u1, u2)
    d_met = sampling.reflect(-wo, h)
    ndotl = sampling.dot(ns, d_met)[..., 0]
    ndotv = jnp.maximum(sampling.dot(ns, wo)[..., 0], 1e-6)
    ndoth = jnp.maximum(sampling.dot(ns, h)[..., 0], 1e-6)
    odoth = jnp.maximum(sampling.dot(wo, h)[..., 0], 1e-6)
    f_met = sampling.schlick_fresnel(odoth[:, None], albedo)
    g_met = sampling.ggx_smith_g(ns, wo, d_met, roughness)
    valid_met = ndotl > 1e-6
    w_met = jnp.where(valid_met[:, None],
                      f_met * (g_met * odoth / (ndotv * ndoth))[:, None],
                      0.0)
    # pdf from the sampled half-vector directly (recomputing h from
    # wo+d_met is degenerate when d_met ≈ -wo and NaNs the backward pass).
    pdf_met = sampling.ggx_pdf_from_half(ns, wo, h, roughness)

    # --- Dielectric (smooth) --------------------------------------------
    eta = jnp.where(front, 1.0 / jnp.maximum(ior, 1.001), jnp.maximum(ior, 1.001))
    cos_i = jnp.maximum(sampling.dot(wo, ns)[..., 0], 1e-6)
    f_die = sampling.fresnel_dielectric(cos_i, 1.0 / eta)
    d_refl = sampling.reflect(-wo, ns)
    d_refr, tir = sampling.refract(-wo, ns, eta[:, None])
    choose_refl = (u_lobe < f_die) | tir
    d_die = jnp.where(choose_refl[:, None], d_refl, sampling.normalize(d_refr))
    # Energy-preserving: weight 1 on reflect, tint on refract.
    w_die = jnp.where(choose_refl[:, None], jnp.ones_like(albedo), albedo)

    is_lam = (mtype == LAMBERT)[:, None]
    is_met = (mtype == METAL)[:, None]
    is_die = (mtype == DIELECTRIC)[:, None]

    d_new = jnp.where(is_lam, d_lam, jnp.where(is_met, d_met, d_die))
    weight = jnp.where(is_lam, w_lam, jnp.where(is_met, w_met, w_die))
    pdf = jnp.where(is_lam[..., 0], pdf_lam, jnp.where(is_met[..., 0], pdf_met, 0.0))
    specular = is_die[..., 0]
    # Transmit side offset: refraction crosses the surface.
    transmit = is_die[..., 0] & ~choose_refl
    offset_sign = jnp.where(transmit, -1.0, 1.0)
    dead = is_met[..., 0] & ~valid_met
    return dict(d=d_new, weight=weight, pdf=pdf, specular=specular,
                offset_sign=offset_sign, ns=ns, dead=dead)


def _eval_bsdf(scene: SceneData, ns, wo, wi, mat_id):
    """Evaluate f(wo, wi)·cos(wi) and the BSDF sample pdf for MIS / NEE.

    Delta lobes (dielectric) evaluate to zero — NEE never connects them.
    """
    albedo, _, roughness, _, mtype = scene.materials.gather(mat_id)
    ndotl = jnp.maximum(sampling.dot(ns, wi)[..., 0], 0.0)
    # Lambert
    f_lam = albedo * sampling.INV_PI
    pdf_lam = ndotl * sampling.INV_PI
    # GGX metal — half-vector guarded against the wi ≈ -wo degeneracy.
    h, h_ok = sampling.half_vector(wo, wi)
    dterm = sampling.ggx_ndf(ns, h, roughness)
    gterm = sampling.ggx_smith_g(ns, wo, wi, roughness)
    odoth = jnp.maximum(sampling.dot(wo, h)[..., 0], 1e-6)
    ndotv = jnp.maximum(sampling.dot(ns, wo)[..., 0], 1e-6)
    fterm = sampling.schlick_fresnel(odoth[:, None], albedo)
    f_met = jnp.where(
        h_ok[:, None],
        fterm * (dterm * gterm / (4.0 * ndotv * jnp.maximum(ndotl, 1e-6)))[:, None],
        0.0)
    pdf_met = jnp.where(h_ok, sampling.ggx_pdf_from_half(ns, wo, h, roughness),
                        0.0)

    is_lam = (mtype == LAMBERT)[:, None]
    is_met = (mtype == METAL)[:, None]
    f = jnp.where(is_lam, f_lam, jnp.where(is_met, f_met, 0.0))
    pdf = jnp.where(is_lam[..., 0], pdf_lam,
                    jnp.where(is_met[..., 0], pdf_met, 0.0))
    fcos = f * ndotl[:, None]
    return fcos, pdf


def render_megasample(scene: SceneData, camera, width: int, height: int,
                      sample_ids, *, max_bounces: int = 8,
                      rr_depth: int = 3, use_nee: bool = True,
                      use_mis: bool = True, seed: int = 0,
                      jitter: bool = True, dof: bool = False,
                      unroll: bool = False, row_offset=0,
                      full_height: int = None,
                      intersect_fn=None, occluded_fn=None,
                      gather_prim_fn=None, gather_light_fn=None,
                      intersect_attrs_fn=None, light_attrs_fn=None,
                      with_stats: bool = False):
    """Trace ``len(sample_ids)`` full samples per pixel; return summed radiance.

    sample_ids: (S,) int array of global sample indices (progressive chunks
    pass disjoint ranges; RNG streams depend only on the ids, so any chunking
    yields identical results).  Output: (H, W, 3) radiance *sum* over S.

    Sharding hooks (used by spt_tpu.parallel): ``row_offset``/``full_height``
    render a horizontal band of a taller image with *global* pixel ids and
    camera NDC, so a row-sharded render is bitwise identical to the
    single-device one; ``intersect_fn``/``occluded_fn`` override scene
    intersection (e.g. primitive-sharded intersection with cross-device
    min-reduction); ``gather_prim_fn(hid)`` / ``gather_light_fn(prim)``
    override primitive-attribute fetch by global id -> (centers, radii,
    mat_id), so sharded geometry never needs to be replicated.
    ``intersect_attrs_fn(o, d)`` replaces the intersect+gather pair at once
    -> (t, hit_id, centers, radii, mat_id): the ring-pass sharding picks up
    the winner's attributes *while* the scene chunk visits each device, so
    no post-hoc gather (and no broadcast collective) is needed.
    ``light_attrs_fn(l_slot)`` -> (centers, radii, mat_id) fetches light
    attributes by light *slot* (for shardings that replicate the small
    light table instead of gathering by global prim id).
    """
    if full_height is None:
        full_height = height
    if intersect_fn is None:
        intersect_fn = lambda o, d: scene_intersect(scene, o, d)
    if occluded_fn is None:
        occluded_fn = lambda o, d, tmax: scene_occluded(scene, o, d, tmax)
    if gather_prim_fn is None:
        gather_prim_fn = lambda ids: (scene.centers[ids], scene.radii[ids],
                                      scene.mat_id[ids])
    if gather_light_fn is None:
        gather_light_fn = gather_prim_fn
    n_px = height * width
    px = jnp.broadcast_to(jnp.arange(width, dtype=jnp.uint32)[None, :], (height, width)).reshape(-1)
    py = jnp.broadcast_to(jnp.arange(height, dtype=jnp.uint32)[:, None], (height, width)).reshape(-1)
    py = py + jnp.asarray(row_offset, jnp.uint32)
    pixel_id = py * jnp.uint32(width) + px
    seed_u = jnp.uint32(seed)
    nl = max(scene.num_lights, 1)
    has_lights = scene.num_lights > 0 and use_nee
    from ..kernels import physics as _ph
    lsb = _ph.lsel_bounds(scene.centers, scene.radii, scene.prim_valid)

    def one_sample(carry_radiance, sample_id):
        sid = jnp.asarray(sample_id, jnp.uint32)
        sid_b = jnp.broadcast_to(sid, px.shape)
        o, d = _camera_rays(camera, px, py, pixel_id, sid_b, width,
                            full_height, seed_u, jitter, dof)
        state = dict(
            o=o, d=d,
            throughput=jnp.ones_like(d),
            radiance=jnp.zeros_like(d),
            active=jnp.ones((n_px,), bool),
            prev_pdf=jnp.zeros((n_px,), jnp.float32),
            prev_specular=jnp.ones((n_px,), bool),  # camera vertex counts as delta
            n_rays=jnp.zeros((), jnp.float32),
        )

        def bounce(state, k):
            ku = jnp.asarray(k, jnp.uint32)
            o, d = state["o"], state["d"]
            throughput = state["throughput"]
            radiance = state["radiance"]
            active = state["active"]

            if intersect_attrs_fn is not None:
                t, hit_id, c_hit, r_hit, mat_hit = intersect_attrs_fn(o, d)
            else:
                t, hit_id = intersect_fn(o, d)
                c_hit = r_hit = mat_hit = None
            hit = active & (hit_id >= 0)
            miss = active & (hit_id < 0)
            n_rays = state["n_rays"] + jnp.sum(active.astype(jnp.float32))
            if has_lights:  # one shadow ray per surviving hit lane
                n_rays = n_rays + jnp.sum(hit.astype(jnp.float32))

            radiance = jnp.where(miss[:, None],
                                 radiance + throughput * sample_sky(d, scene),
                                 radiance)

            hid = jnp.maximum(hit_id, 0)
            t_safe = jnp.where(hit, t, 1.0)[:, None]
            p = o + t_safe * d
            if c_hit is None:
                c_hit, r_hit, mat_hit = gather_prim_fn(hid)
            n_g = intersect.sphere_normal(p, c_hit)
            wo = -d

            # Emitted radiance at the hit, MIS-weighted against NEE.
            _, emission, _, _, _ = scene.materials.gather(mat_hit)
            emitting = hit & (jnp.sum(emission, -1) > 0.0) \
                & (sampling.dot(wo, n_g)[..., 0] > 0.0)
            if has_lights and use_mis:
                pdf_light_here = sampling.sphere_cone_pdf(o, c_hit, r_hit) / nl
                w_bsdf = sampling.power_heuristic(state["prev_pdf"], pdf_light_here)
                w_emit = jnp.where(state["prev_specular"], 1.0, w_bsdf)
            elif has_lights:  # pure NEE: count emitters only via light sampling
                w_emit = jnp.where(state["prev_specular"], 1.0, 0.0)
            else:
                w_emit = jnp.ones((n_px,), jnp.float32)
            radiance = jnp.where(emitting[:, None],
                                 radiance + throughput * emission * w_emit[:, None],
                                 radiance)

            # BSDF sampling.
            u_lobe = _u(pixel_id, sid_b, ku, _DIM_LOBE, seed_u)
            u1 = _u(pixel_id, sid_b, ku, _DIM_U1, seed_u)
            u2 = _u(pixel_id, sid_b, ku, _DIM_U2, seed_u)
            sh = _shade_and_sample(scene, p, n_g, wo, mat_hit, u_lobe, u1, u2)
            ns = sh["ns"]

            # Next-event estimation (skip delta lobes).
            if has_lights:
                # Light pick keyed on the shading-point cell (r4) — the
                # coherence that makes wavefront NEE cullable; same stream
                # in every backend (physics.LSEL_CELLS).
                kp = jnp.where(jnp.broadcast_to(ku == 0, (n_px, 1)), p, o)
                cell = _ph.lsel_cell(kp[:, 0], kp[:, 1], kp[:, 2],
                                     (lsb[0], lsb[1], lsb[2]),
                                     (lsb[3], lsb[4], lsb[5]))
                ul_sel = _u(cell, sid_b, ku, _DIM_LSEL, seed_u)
                lu1 = _u(pixel_id, sid_b, ku, _DIM_LU1, seed_u)
                lu2 = _u(pixel_id, sid_b, ku, _DIM_LU2, seed_u)
                l_slot = jnp.minimum((ul_sel * nl).astype(jnp.int32), nl - 1)
                if light_attrs_fn is not None:
                    lc, lr, l_mat = light_attrs_fn(l_slot)
                else:
                    l_prim = scene.light_idx[l_slot]
                    lc, lr, l_mat = gather_light_fn(l_prim)
                p_off = p + EPS_OFFSET * ns
                ldir, pdf_l, inside_l = sampling.sample_sphere_cone(
                    p_off, lc, lr, lu1, lu2)
                pdf_l = pdf_l / nl
                # Distance to the light along the sampled direction, then an
                # any-hit occlusion test short of it (the light sphere's own
                # first hit lies beyond tmax, so it never self-occludes).
                oc_l = lc - p_off
                b_l = jnp.sum(ldir * oc_l, axis=-1)
                c_l = jnp.sum(oc_l * oc_l, axis=-1) - lr * lr
                disc_l = jnp.maximum(b_l * b_l - c_l, 0.0)
                t_l = b_l - jnp.sqrt(disc_l)
                blocked = occluded_fn(p_off, ldir, t_l - jnp.float32(1e-3))
                lit = ~blocked & ~inside_l & (t_l > intersect.TMIN)
                fcos, pdf_b_at_l = _eval_bsdf(scene, ns, wo, ldir, mat_hit)
                _, l_emission, _, _, _ = scene.materials.gather(l_mat)
                w_nee = sampling.power_heuristic(pdf_l, pdf_b_at_l) if use_mis \
                    else jnp.ones((n_px,), jnp.float32)
                contrib = throughput * fcos * l_emission \
                    * (w_nee / jnp.maximum(pdf_l, 1e-12))[:, None]
                nee_ok = hit & lit & ~sh["specular"] & (pdf_l > 0.0)
                radiance = jnp.where(nee_ok[:, None], radiance + contrib, radiance)

            # Update path state.
            throughput_new = throughput * sh["weight"]
            active_new = hit & ~sh["dead"]

            # Russian roulette (honoring settings, unlike the reference).
            rr_on = k >= rr_depth
            u_rr = _u(pixel_id, sid_b, ku, _DIM_RR, seed_u)
            p_cont = jnp.clip(jnp.max(throughput_new, -1), 0.05, 0.95)
            kill = rr_on & (u_rr > p_cont)
            active_new = active_new & ~kill
            rr_scale = jnp.where(rr_on, 1.0 / p_cont, 1.0)
            throughput_new = throughput_new * rr_scale[:, None]

            o_new = p + (EPS_OFFSET * sh["offset_sign"])[:, None] * ns
            d_new = sh["d"]

            out = dict(
                o=jnp.where(active_new[:, None], o_new, o),
                d=jnp.where(active_new[:, None], d_new, d),
                throughput=jnp.where(active_new[:, None], throughput_new, throughput),
                radiance=radiance,
                active=active_new,
                prev_pdf=jnp.where(active_new, sh["pdf"], state["prev_pdf"]),
                prev_specular=jnp.where(active_new, sh["specular"],
                                        state["prev_specular"]),
                n_rays=n_rays,
            )
            return out, None

        if unroll:  # python loop: keeps jax_debug_nans line info
            for kk in range(max_bounces):
                state, _ = bounce(state, jnp.asarray(kk))
        else:
            # Remat the bounce body: differentiating the scan would otherwise
            # stack per-bounce residuals for every bounce.  Path replay is
            # cheap to recompute (counter RNG re-derives every draw).
            state, _ = jax.lax.scan(jax.checkpoint(bounce), state,
                                    jnp.arange(max_bounces))
        carry_radiance, carry_count = carry_radiance
        return (carry_radiance + state["radiance"],
                carry_count + state["n_rays"]), None

    carry0 = (jnp.zeros((n_px, 3), jnp.float32), jnp.zeros((), jnp.float32))
    if unroll:
        carry = carry0
        for sid in np.asarray(sample_ids):
            carry, _ = one_sample(carry, jnp.asarray(sid))
    else:
        # Remat per sample too (see bounce remat note above).
        carry, _ = jax.lax.scan(jax.checkpoint(one_sample), carry0,
                                jnp.asarray(sample_ids))
    radiance, n_rays = carry
    img = radiance.reshape(height, width, 3)
    if with_stats:
        return img, n_rays
    return img
