"""Shared bounce physics (kernels/physics.py) validation.

Drives ``physics.trace_bounce`` — the function the Triton megakernel runs
per bounce — as a pure-jnp bounce chain and checks its forward AND
``jax.grad`` against the SoA integrator oracle.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import spt_tpu
from spt_tpu import Camera, Scene
from spt_tpu.core import rng
from spt_tpu.diff import gradients as G
from spt_tpu.engine.integrator_soa import render_megasample_soa, static_mtypes
from spt_tpu.kernels import physics

W = H = 16
N = W * H


def _scene():
    scene = Scene()
    scene.set_sky(spt_tpu.SKY_NONE)
    white = scene.add_material("lambert", albedo=(0.7, 0.65, 0.6))
    lamp = scene.add_material("lambert", albedo=(0.8,) * 3, emission=(11.0,) * 3)
    metal = scene.add_material("metal", albedo=(0.85, 0.85, 0.9), roughness=0.3)
    glass = scene.add_material("glass", albedo=(0.95,) * 3, ior=1.5)
    scene.create_sphere("floor", (0, -1000, 4), 1000.0, white)
    scene.create_sphere("lamp", (0, 2.8, 4), 0.7, lamp)
    scene.create_sphere("m", (-0.6, 0.6, 4.0), 0.6, metal)
    scene.create_sphere("g", (0.7, 0.5, 3.6), 0.5, glass)
    return scene


CAM = Camera.look_at((0, 1.0, -1.2), (0, 0.8, 4.0), fov_degrees=55)


def _theta_from_arrays(centers, radii, albedo, emission, rough, ior, mat_id,
                       sky_params, light_prims, n_prims):
    """Build the physics theta tuple from (differentiable) scene arrays."""
    spheres = tuple(
        (centers[j, 0], centers[j, 1], centers[j, 2], radii[j],
         albedo[mat_id[j], 0], albedo[mat_id[j], 1], albedo[mat_id[j], 2],
         emission[mat_id[j], 0], emission[mat_id[j], 1], emission[mat_id[j], 2],
         rough[mat_id[j]], ior[mat_id[j]])
        for j in range(n_prims))
    sky = (sky_params[0, 0], sky_params[0, 1], sky_params[0, 2],
           sky_params[1, 0], sky_params[1, 1], sky_params[1, 2])
    lights = tuple(
        (centers[lp, 0], centers[lp, 1], centers[lp, 2], radii[lp],
         emission[mat_id[lp], 0], emission[mat_id[lp], 1],
         emission[mat_id[lp], 2])
        for lp in light_prims)
    return (spheres, sky, lights)


def _render_via_physics(sd, params, sample_ids, max_bounces, rr_depth,
                        use_nee, use_mis, seed):
    """Pure-jnp render using physics.trace_bounce — the kernels' math."""
    mtypes = static_mtypes(sd)
    mat_id = np.asarray(sd.mat_id)
    light_prims = [int(p) for p, ok in zip(np.asarray(sd.light_idx),
                                           np.asarray(sd.light_valid)) if ok]
    centers = params.get("centers", sd.centers)
    radii = params.get("radii", sd.radii)
    albedo = params.get("albedo", sd.materials.albedo)
    emission = params.get("emission", sd.materials.emission)
    rough = params.get("roughness", sd.materials.roughness)
    ior = sd.materials.ior
    theta = _theta_from_arrays(centers, radii, albedo, emission, rough, ior,
                               mat_id, sd.sky_params, light_prims,
                               sd.capacity)
    nl = jnp.int32(len(light_prims))

    px = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :],
                          (H, W)).reshape(-1)
    py = jnp.broadcast_to(jnp.arange(H, dtype=jnp.int32)[:, None],
                          (H, W)).reshape(-1)
    pid = (py * W + px).astype(jnp.uint32)
    seed_u = jnp.uint32(seed)

    total = jnp.zeros((N, 3), jnp.float32)
    for sid in sample_ids:
        sample = jnp.broadcast_to(jnp.uint32(sid), pid.shape)
        jx = rng.counter_uniform(pid, sample, jnp.uint32(0xFFFF * 8 + 0), seed_u)
        jy = rng.counter_uniform(pid, sample, jnp.uint32(0xFFFF * 8 + 1), seed_u)
        aspect = jnp.float32(W / H)
        sx = (px.astype(jnp.float32) + jx) / W
        sy = (py.astype(jnp.float32) + jy) / H
        ndc_x = (2 * sx - 1) * aspect * CAM.tan_half_fov
        ndc_y = (1 - 2 * sy) * CAM.tan_half_fov
        dx = ndc_x * CAM.right[0] + ndc_y * CAM.up[0] + CAM.forward[0]
        dy = ndc_x * CAM.right[1] + ndc_y * CAM.up[1] + CAM.forward[1]
        dz = ndc_x * CAM.right[2] + ndc_y * CAM.up[2] + CAM.forward[2]
        dx, dy, dz = physics._normalize(dx, dy, dz)
        ones = jnp.ones_like(dx)
        zero = jnp.zeros_like(dx)
        state = (ones * CAM.position[0], ones * CAM.position[1],
                 ones * CAM.position[2], dx, dy, dz, ones, ones, ones,
                 zero, zero, zero, zero)
        aux = (jnp.ones(N, bool), jnp.ones(N, bool))
        for k in range(max_bounces):
            u = {key: rng.counter_uniform(
                     pid, sample, jnp.uint32(k * 8 + d), seed_u)
                 for key, d in (("rr", 0), ("u1", 1), ("u2", 2), ("lsel", 3),
                                ("lu1", 4), ("lu2", 5), ("lobe", 6))}
            cfg = physics.BounceCfg(
                mtypes=mtypes, k=k, rr_depth=rr_depth, use_nee=use_nee,
                use_mis=use_mis, sky_mode=sd.sky_mode,
                n_light_slots=len(light_prims))
            state, aux = physics.trace_bounce(theta, state, aux, u, nl, cfg)
        total = total + jnp.stack([state[9], state[10], state[11]], -1)
    return total.reshape(H, W, 3)


@pytest.mark.parametrize("use_nee,use_mis", [(True, True), (False, False)])
def test_physics_chain_matches_soa_forward(use_nee, use_mis):
    sd = _scene().compile()
    kw = dict(max_bounces=3, rr_depth=5, use_nee=use_nee, use_mis=use_mis,
              seed=4)
    a = np.asarray(_render_via_physics(sd, {}, [0, 1], **kw))
    b = np.asarray(render_megasample_soa(sd, CAM, W, H, jnp.arange(2),
                                         mtypes=static_mtypes(sd), **kw))
    close = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() > 0.98, f"{(~close).sum()} px diverge"


def test_physics_chain_grads_match_soa():
    sd = _scene().compile()
    kw = dict(max_bounces=3, rr_depth=5, use_nee=True, use_mis=True, seed=4)
    fields = ("albedo", "emission", "roughness")
    params = G.get_params(sd, fields)
    mt = static_mtypes(sd)

    def loss_phys(p):
        return jnp.sum(_render_via_physics(sd, p, [0, 1], **kw))

    def loss_soa(p):
        sc = G.apply_params(sd, p)
        return jnp.sum(render_megasample_soa(sc, CAM, W, H, jnp.arange(2),
                                             mtypes=mt, **kw))

    g_a = jax.grad(loss_phys)(params)
    g_b = jax.grad(loss_soa)(params)
    for key in fields:
        np.testing.assert_allclose(np.asarray(g_a[key]),
                                   np.asarray(g_b[key]),
                                   rtol=2e-2, atol=2e-3,
                                   err_msg=f"grad mismatch: {key}")


def test_physics_chain_grads_with_rr_finite():
    sd = _scene().compile()
    kw = dict(max_bounces=4, rr_depth=1, use_nee=True, use_mis=True, seed=2)
    params = G.get_params(sd, ("albedo", "centers", "radii"))

    def loss(p):
        return jnp.sum(_render_via_physics(sd, p, [0], **kw))

    g = jax.grad(loss)(params)
    for k, v in g.items():
        assert np.isfinite(np.asarray(v)).all(), k
