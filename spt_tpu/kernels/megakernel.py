"""Forward megakernel for small scenes — Pallas through Triton.

One path per lane, carried through every bounce and every sample in
registers: ray generation → sphere intersection → shading/NEE → bounce, with
one store of the summed radiance per pixel.  The integrator it replaces on
this path (``integrator_soa.render_megasample_soa``) keeps the ray state in
device memory and runs one ``lax.scan`` trip per sample and per bounce.

* **Grid.**  1-D over blocks of ``block`` pixels (a power of two).  Each
  program loops over the samples itself and accumulates in registers, so
  blocks are independent and need no ordering.

* **Scene uniforms.**  Spheres, materials, camera and sky arrive as one f32
  ``blob`` and one i32 ``meta`` array, which every program reads itself.
  The sphere loop is dynamic (scalar loads of the current sphere, broadcast
  over the block); the winning sphere's attributes and material type are
  gathered once per bounce.  So one compiled kernel serves every scene with
  the same capacity, light count and flags.

* **Counter-based RNG in-kernel.**  The uint32 hash chain of
  ``spt_tpu.core.rng`` runs per lane, so the kernel draws the same streams
  as the pure-JAX integrators and the images can be compared directly.

* **Shared physics.**  Shading, NEE, MIS and Russian roulette are
  ``kernels.physics.trace_bounce``; only intersection is the kernel's own.

Radiance semantics match ``integrator_soa.render_megasample_soa`` and
``integrator_jax.render_megasample`` (same estimator, same RNG streams); they
differ only in float rounding.  See tests/test_pallas.py.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core import rng
from ..core.materials import DIELECTRIC, LAMBERT, METAL
from . import physics

# Pixels per program.  Chosen on an H100 from {64, 128, 256}; see PERF.md
# "Kernel decisions".
BLOCK = 128
# Largest scene capacity the kernel is routed to (engine/pallas_backend.py).
MAX_PRIMS = 128

_CAM_SLOT = 0xFFFF * physics.N_DIMS

# blob layout ---------------------------------------------------------------
_CAM_OFF = 0          # pos3, right3, up3, fwd3, tan_half_fov, aperture,
                      # focus_dist -> 15
_SKY_OFF = 15         # horizon3, zenith3 -> 6
_SPH_OFF = 21         # per sphere: cx,cy,cz,r, ar,ag,ab, er,eg,eb, rough,ior
_SPH_STRIDE = 12
# meta layout: [start_sample, seed, n_lights, spp, mtype*P, light_prim*L]
_META_FIXED = 4


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def pack_scene(scene, camera) -> tuple[np.ndarray, list[int], list[int]]:
    """Host-side packing of scene+camera uniforms -> (blob, mtypes, lights).

    ``blob`` is zero-padded to a power of two; padding spheres (and invalid
    slots) have radius 0, which no ray hits."""
    cap = scene.capacity
    blob = np.zeros(_pow2(_SPH_OFF + _SPH_STRIDE * cap), np.float32)
    blob[0:3] = np.asarray(camera.position)
    blob[3:6] = np.asarray(camera.right)
    blob[6:9] = np.asarray(camera.up)
    blob[9:12] = np.asarray(camera.forward)
    blob[12] = float(camera.tan_half_fov)
    blob[13] = float(getattr(camera, "aperture", 0.0))
    blob[14] = float(getattr(camera, "focus_dist", 1.0))
    blob[_SKY_OFF:_SKY_OFF + 3] = np.asarray(scene.sky_params[0])
    blob[_SKY_OFF + 3:_SKY_OFF + 6] = np.asarray(scene.sky_params[1])
    valid = np.asarray(scene.prim_valid)
    mat_id = np.asarray(scene.mat_id)
    mtype = np.asarray(scene.materials.mtype)
    rows = np.zeros((cap, _SPH_STRIDE), np.float32)
    rows[:, 0:3] = np.asarray(scene.centers)
    rows[:, 3] = np.asarray(scene.radii)
    rows[:, 4:7] = np.asarray(scene.materials.albedo)[mat_id]
    rows[:, 7:10] = np.asarray(scene.materials.emission)[mat_id]
    rows[:, 10] = np.asarray(scene.materials.roughness)[mat_id]
    rows[:, 11] = np.asarray(scene.materials.ior)[mat_id]
    rows[~valid] = 0.0
    rows[~valid, 11] = 1.5
    blob[_SPH_OFF:_SPH_OFF + _SPH_STRIDE * cap] = rows.reshape(-1)
    mtypes = [int(m) for m in np.where(valid, mtype[mat_id], LAMBERT)]
    light_prims = [int(p) for p, ok in
                   zip(np.asarray(scene.light_idx),
                       np.asarray(scene.light_valid)) if ok]
    return blob, mtypes, light_prims


def pack_meta(start_sample: int, seed: int, spp: int, mtypes, light_prims):
    """i32 ``meta`` array (power-of-two length) for ``pack_scene``'s blob."""
    n = len(mtypes)
    meta = np.zeros(_pow2(_META_FIXED + n + max(len(light_prims), 1)),
                    np.int32)
    meta[0:_META_FIXED] = (start_sample, seed, len(light_prims), spp)
    meta[_META_FIXED:_META_FIXED + n] = mtypes
    meta[_META_FIXED + n:_META_FIXED + n + len(light_prims)] = light_prims
    return meta


def _sphere_t(cx, cy, cz, r, ox, oy, oz, dx, dy, dz):
    """Near-root distance of one sphere (``physics`` float-op order)."""
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    b = dx * ocx + dy * ocy + dz * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - c
    pos = disc > 0.0
    sq = jnp.where(pos, jnp.sqrt(jnp.maximum(
        jnp.where(pos, disc, 1.0), 1e-12)), 0.0)
    t0 = b - sq
    t1 = b + sq
    return pos, jnp.where(t0 > physics.TMIN, t0, t1)


def _kernel(meta_ref, blob_ref, lsb_ref, out_r, out_g, out_b, *, n_prims,
            n_light_slots, width, height, max_bounces, rr_depth, use_nee,
            use_mis, sky_mode, dof, block):
    lin = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    n_pix = width * height
    in_image = lin < n_pix
    pix = jnp.minimum(lin, n_pix - 1)
    px = pix % width
    py = pix // width
    pid = pix.astype(jnp.uint32)
    start_sample = meta_ref[0]
    seed = meta_ref[1].astype(jnp.uint32)
    nl = meta_ref[2]
    spp = meta_ref[3]

    sky = tuple(blob_ref[_SKY_OFF + a] for a in range(physics.N_SKY_ATTRS))
    lights = tuple(
        tuple(blob_ref[_SPH_OFF + _SPH_STRIDE
                       * meta_ref[_META_FIXED + n_prims + l] + a]
              for a in physics.LIGHT_TO_SPHERE_ATTR)
        for l in range(n_light_slots))
    theta = ((), sky, lights)
    lsel_lo = tuple(lsb_ref[a] for a in range(3))
    lsel_ext = tuple(lsb_ref[3 + a] for a in range(3))

    def intersect(ox, oy, oz, dx, dy, dz, active):
        del active

        def body(j, carry):
            t_best, j_best = carry
            off = _SPH_OFF + _SPH_STRIDE * j
            pos, tj = _sphere_t(blob_ref[off], blob_ref[off + 1],
                                blob_ref[off + 2], blob_ref[off + 3],
                                ox, oy, oz, dx, dy, dz)
            ok = pos & (tj > physics.TMIN) & (tj < t_best)
            return jnp.where(ok, tj, t_best), jnp.where(ok, j, j_best)

        t_best, j_best = jax.lax.fori_loop(
            0, n_prims, body,
            (jnp.full((block,), physics.BIG, jnp.float32),
             jnp.zeros((block,), jnp.int32)))
        found = t_best < physics.BIG
        base = _SPH_OFF + _SPH_STRIDE * j_best
        names = ("cx", "cy", "cz", "r", "ar", "ag", "ab", "er", "eg", "eb",
                 "rough")
        h = {nm: jnp.where(found, blob_ref[base + a], 0.0)
             for a, nm in enumerate(names)}
        h["ior"] = jnp.where(found, blob_ref[base + 11], 1.5)
        mt = meta_ref[_META_FIXED + j_best]
        return (t_best, h, found & (mt == LAMBERT), found & (mt == METAL),
                found & (mt == DIELECTRIC))

    def occluded(ox, oy, oz, dx, dy, dz, tmax, need):
        del need

        def body(j, blocked):
            off = _SPH_OFF + _SPH_STRIDE * j
            pos, tj = _sphere_t(blob_ref[off], blob_ref[off + 1],
                                blob_ref[off + 2], blob_ref[off + 3],
                                ox, oy, oz, dx, dy, dz)
            return blocked | (pos & (tj > physics.TMIN) & (tj < tmax))

        return jax.lax.fori_loop(0, n_prims, body,
                                 jnp.zeros((block,), jnp.bool_))

    def u(sample, k, dim):
        return rng.counter_uniform(
            pid, sample, k.astype(jnp.uint32) * physics.N_DIMS + dim, seed)

    def one_sample(s, acc):
        sample = jnp.broadcast_to((start_sample + s).astype(jnp.uint32),
                                  (block,))
        # Camera ray generation (jittered pinhole, optional thin lens).
        jx = rng.counter_uniform(pid, sample, jnp.uint32(_CAM_SLOT), seed)
        jy = rng.counter_uniform(pid, sample, jnp.uint32(_CAM_SLOT + 1), seed)
        tanf = blob_ref[12]
        sx = (px.astype(jnp.float32) + jx) * jnp.float32(1.0 / width)
        sy = (py.astype(jnp.float32) + jy) * jnp.float32(1.0 / height)
        ndc_x = (2.0 * sx - 1.0) * jnp.float32(width / height) * tanf
        ndc_y = (1.0 - 2.0 * sy) * tanf
        dx = ndc_x * blob_ref[3] + ndc_y * blob_ref[6] + blob_ref[9]
        dy = ndc_x * blob_ref[4] + ndc_y * blob_ref[7] + blob_ref[10]
        dz = ndc_x * blob_ref[5] + ndc_y * blob_ref[8] + blob_ref[11]
        dx, dy, dz = physics._normalize(dx, dy, dz)
        ones = jnp.ones((block,), jnp.float32)
        ox, oy, oz = ones * blob_ref[0], ones * blob_ref[1], ones * blob_ref[2]
        if dof:
            lu = rng.counter_uniform(pid, sample, jnp.uint32(_CAM_SLOT + 2),
                                     seed)
            lv = rng.counter_uniform(pid, sample, jnp.uint32(_CAM_SLOT + 3),
                                     seed)
            r = blob_ref[13] * jnp.sqrt(lu)
            phi = jnp.float32(2.0 * math.pi) * lv
            cphi, sphi = jnp.cos(phi), jnp.sin(phi)
            offx = r * (cphi * blob_ref[3] + sphi * blob_ref[6])
            offy = r * (cphi * blob_ref[4] + sphi * blob_ref[7])
            offz = r * (cphi * blob_ref[5] + sphi * blob_ref[8])
            denom = jnp.maximum(
                dx * blob_ref[9] + dy * blob_ref[10] + dz * blob_ref[11],
                1e-6)
            tf = blob_ref[14] / denom
            fx, fy, fz = ox + dx * tf, oy + dy * tf, oz + dz * tf
            ox, oy, oz = ox + offx, oy + offy, oz + offz
            dx, dy, dz = physics._normalize(fx - ox, fy - oy, fz - oz)

        zero = jnp.zeros((block,), jnp.float32)
        state = (ox, oy, oz, dx, dy, dz, ones, ones, ones, zero, zero, zero,
                 zero)
        aux = (jnp.ones((block,), jnp.bool_), jnp.ones((block,), jnp.bool_))

        # The bounce loop is dynamic (one copy of the bounce in the compiled
        # kernel) and stops once no lane of the block is alive; a dead lane
        # changes nothing in a bounce, so the early exit is exact.
        def alive(carry):
            k, _, aux = carry
            return (k < max_bounces) & (jnp.max(aux[0].astype(jnp.int32)) > 0)

        def bounce(carry):
            k, state, aux = carry
            uniforms = dict(
                rr=u(sample, k, physics.DIM_RR),
                u1=u(sample, k, physics.DIM_U1),
                u2=u(sample, k, physics.DIM_U2),
                lobe=u(sample, k, physics.DIM_LOBE),
                lu1=u(sample, k, physics.DIM_LU1),
                lu2=u(sample, k, physics.DIM_LU2),
                lsel_lo=lsel_lo, lsel_ext=lsel_ext, sample=sample, seed=seed)
            cfg = physics.BounceCfg(
                mtypes=(), k=k, rr_depth=rr_depth, use_nee=use_nee,
                use_mis=use_mis, sky_mode=sky_mode,
                n_light_slots=n_light_slots)
            state, aux = physics.trace_bounce(
                theta, state, aux, uniforms, nl, cfg,
                intersect_fn=intersect, occluded_fn=occluded)
            return k + 1, state, aux

        _, state, _ = jax.lax.while_loop(alive, bounce,
                                         (jnp.int32(0), state, aux))
        return (acc[0] + state[9], acc[1] + state[10], acc[2] + state[11])

    zero = jnp.zeros((block,), jnp.float32)
    acc = jax.lax.fori_loop(0, spp, one_sample, (zero, zero, zero))
    out_r[...] = jnp.where(in_image, acc[0], 0.0)
    out_g[...] = jnp.where(in_image, acc[1], 0.0)
    out_b[...] = jnp.where(in_image, acc[2], 0.0)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "n_prims", "n_light_slots",
                     "max_bounces", "rr_depth", "use_nee", "use_mis",
                     "sky_mode", "dof", "block", "interpret"))
def _launch(blob, meta, lsb, *, width, height, n_prims, n_light_slots,
            max_bounces, rr_depth, use_nee, use_mis, sky_mode, dof, block,
            interpret):
    n_blocks = pl.cdiv(width * height, block)
    kernel = functools.partial(
        _kernel, n_prims=n_prims, n_light_slots=n_light_slots, width=width,
        height=height, max_bounces=max_bounces, rr_depth=rr_depth,
        use_nee=use_nee, use_mis=use_mis, sky_mode=sky_mode, dof=dof,
        block=block)
    plane = jax.ShapeDtypeStruct((n_blocks * block,), jnp.float32)
    spec = pl.BlockSpec((block,), lambda i: (i,))
    r, g, b = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[pl.no_block_spec] * 3,
        out_specs=[spec] * 3,
        out_shape=[plane] * 3,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(block // 32, 1), num_stages=1),
        interpret=interpret,
        name="spt_megakernel",
    )(meta, blob, lsb)
    n_pix = width * height
    return jnp.stack([r[:n_pix], g[:n_pix], b[:n_pix]],
                     axis=-1).reshape(height, width, 3)


def launch_args(scene, camera, width: int, height: int,
                start_sample: int, spp: int, *, max_bounces=8, rr_depth=3,
                use_nee=True, use_mis=True, seed=0, dof=None, block=BLOCK,
                interpret=False):
    """``render_tiles``' arguments as ``_launch``'s: (arrays, statics)."""
    if scene.capacity > MAX_PRIMS:
        raise ValueError(f"megakernel takes at most {MAX_PRIMS} prims, "
                         f"got capacity {scene.capacity}")
    blob, mtypes, light_prims = pack_scene(scene, camera)
    if dof is None:  # auto: thin-lens iff the camera has a real aperture
        dof = bool(blob[13] > 0.0)
    meta = pack_meta(start_sample, seed, spp, mtypes, light_prims)
    lsb = jnp.pad(physics.lsel_bounds(scene.centers, scene.radii,
                                      scene.prim_valid), (0, 2))
    statics = dict(
        width=width, height=height, n_prims=scene.capacity,
        n_light_slots=len(light_prims), max_bounces=max_bounces,
        rr_depth=rr_depth, use_nee=bool(use_nee), use_mis=bool(use_mis),
        sky_mode=scene.sky_mode, dof=bool(dof), block=block,
        interpret=interpret)
    return (jnp.asarray(blob), jnp.asarray(meta), lsb), statics


def render_tiles(scene, camera, width: int, height: int,
                 start_sample: int, spp: int, **kw):
    """Render ``spp`` samples with the megakernel; returns (H,W,3) radiance sum.

    Matches ``integrator_soa.render_megasample_soa(..., sample_ids=
    arange(start_sample, start_sample+spp))`` semantically (same RNG streams,
    same estimators); differs only in float op ordering.  ``start_sample``
    and ``spp`` are runtime values: chunks of a progressive render reuse one
    compiled kernel.  Keywords as ``launch_args``: the integrator settings
    (``max_bounces``, ``rr_depth``, ``use_nee``, ``use_mis``, ``seed``,
    ``dof``), the pixels per program ``block``, and ``interpret=True`` to
    run the kernel on the CPU (tests).
    """
    args, statics = launch_args(scene, camera, width, height, start_sample,
                                spp, **kw)
    return _launch(*args, **statics)
