#!/usr/bin/env python
"""Benchmark suite: the five BASELINE.json workload configs, on one GPU.

Prints one JSON line per config.  The headline fwd+bwd metric stays in
bench.py; this suite tracks the full workload matrix:

  1. diffuse sphere on plane, 256^2, 16 spp, depth 4      (forward)
  2. Cornell box, Lambert + area light, 512^2, NEE, d8    (forward)
  3. Cornell + GGX metal/dielectric, MIS                  (fwd and fwd+bwd)
  4. inverse rendering albedo+roughness, 32 spheres       (optimizer step)
  5. 10k-primitive BVH scene, 1920x1080                   (fwd and fwd+bwd)

Forward renders of configs 1-3 run the Triton megakernel; every fwd+bwd
and config 5 run the plain-XLA SoA integrator.  The suite refuses to run
without a GPU, and every row names the device it ran on.

Usage: python bench_suite.py [--quick] [--configs 1,2,5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def require_gpu(devices=None) -> dict:
    """Device fields for a result row; raises SystemExit unless the default
    device is a GPU (a CPU timing is never reported as a device number)."""
    devices = jax.devices() if devices is None else devices
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default device is "
                         f"{d.platform} ({d.device_kind})")
    return {"platform": d.platform, "device_kind": d.device_kind,
            "count": len(devices),
            "xla_flags": os.environ.get("XLA_FLAGS", "")}


def timed(fn, *args, reps=3):
    """min wall-time of fn(*args) after a warmup call (compile)."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return min(times)


def count_segments(scene_data, camera, kw, w=128, h=128, spp=8):
    """Exact forward ray segments per path (incl. shadow rays)."""
    from spt_tpu.engine.integrator_soa import render_megasample_soa, static_mtypes
    mt = static_mtypes(scene_data) if scene_data.capacity <= 128 else None
    fn = jax.jit(lambda sc, ids: render_megasample_soa(
        sc, camera, w, h, ids, mtypes=mt, with_stats=True, **kw)[1])
    n = float(fn(scene_data, jnp.arange(spp)))
    return n / (spp * w * h)


def sphere_on_plane():
    from spt_tpu import Scene
    scene = Scene()  # reference sky gradient is the light source
    m = scene.add_material("lambert", albedo=(0.7, 0.7, 0.7))
    scene.create_sphere("ball", (0.0, 0.0, 5.0), 1.0, m)
    scene.create_sphere("ground", (0.0, -101.0, 5.0), 100.0, m)
    return scene


def cornell(ggx: bool):
    import spt_tpu
    from spt_tpu import Scene
    scene = Scene()
    scene.set_sky(spt_tpu.SKY_NONE)
    white = scene.add_material("lambert", albedo=(0.73, 0.73, 0.73))
    red = scene.add_material("lambert", albedo=(0.65, 0.05, 0.05))
    green = scene.add_material("lambert", albedo=(0.12, 0.45, 0.15))
    light = scene.add_material("lambert", albedo=(0.78,) * 3,
                               emission=(15.0,) * 3)
    if ggx:
        m1 = scene.add_material("metal", albedo=(0.8, 0.85, 0.9), roughness=0.2)
        m2 = scene.add_material("glass", albedo=(0.97,) * 3, ior=1.5)
    else:
        m1 = m2 = white
    R = 1000.0
    for nm, pos, r, m in [
            ("floor", (0, -R, 3), R, white), ("ceil", (0, R + 2, 3), R, white),
            ("left", (-R - 2, 1, 3), R, red), ("right", (R + 2, 1, 3), R, green),
            ("back", (0, 1, R + 5), R, white), ("lamp", (0, 2.55, 3), 0.6, light),
            ("ball", (-0.7, 0.5, 3.4), 0.5, m1),
            ("gball", (0.7, 0.45, 2.8), 0.45, m2)]:
        scene.create_sphere(nm, pos, r, m)
    return scene


def cornell_camera():
    from spt_tpu import Camera
    return Camera.look_at((0, 1.0, -1.5), (0, 1.0, 3.0), fov_degrees=55)


def gradient_scene():
    """Small lit scene of the finite-difference gradient checks: at its
    24x18, 4-spp, 3-bounce setting no FD step crosses a visibility
    boundary, so FD is a valid reference for geometry and roughness."""
    import spt_tpu
    from spt_tpu import Camera, Scene
    scene = Scene()
    scene.set_sky(spt_tpu.SKY_NONE)
    white = scene.add_material("lambert", albedo=(0.6, 0.55, 0.5))
    rough = scene.add_material("metal", albedo=(0.7, 0.7, 0.75), roughness=0.4)
    lamp = scene.add_material("lambert", albedo=(0.8,) * 3, emission=(9.0,) * 3)
    scene.create_sphere("floor", (0, -1000, 4), 1000.0, white)
    scene.create_sphere("ball", (-0.6, 0.6, 4.0), 0.6, white)
    scene.create_sphere("mball", (0.8, 0.5, 4.3), 0.5, rough)
    scene.create_sphere("lamps", (0.0, 2.8, 4.0), 0.7, lamp)
    cam = Camera.look_at((0, 1.0, -1.0), (0, 0.8, 4.0), fov_degrees=55)
    return scene, cam


def scene_10k(n=10_000, seed=42):
    import spt_tpu
    from spt_tpu import Scene
    rng = np.random.default_rng(seed)
    scene = Scene()
    scene.set_sky(spt_tpu.SKY_GRADIENT)
    mats = [scene.add_material("lambert",
                               albedo=tuple(rng.uniform(0.2, 0.9, 3)))
            for _ in range(8)]
    mats += [scene.add_material("metal", albedo=(0.85, 0.85, 0.9),
                                roughness=0.25),
             scene.add_material("glass", albedo=(0.97,) * 3, ior=1.5)]
    emit = scene.add_material("lambert", albedo=(0.8,) * 3,
                              emission=(40.0, 36.0, 30.0))
    pos = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    pos[:, 2] += 60.0
    rad = rng.uniform(0.2, 0.9, n).astype(np.float32)
    for i in range(n):
        m = emit if i % 500 == 0 else mats[i % len(mats)]
        scene.create_sphere(f"s{i}", tuple(pos[i]), float(rad[i]), m)
    return scene


def camera_10k():
    from spt_tpu import Camera
    return Camera.look_at((0, 0, -10), (0, 0, 60), fov_degrees=65)


def inverse_scene(seed=7):
    """Config 4: 32 random Lambert spheres under one area light."""
    from spt_tpu import Camera, Scene
    rng = np.random.default_rng(seed)
    scene = Scene()
    mats = [scene.add_material(
        "lambert", albedo=tuple(rng.uniform(0.2, 0.9, 3))) for _ in range(8)]
    scene.add_material("lambert", albedo=(0.8,) * 3, emission=(20.0,) * 3)
    for i in range(32):
        p = rng.uniform(-4, 4, 3)
        p[2] += 8.0
        scene.create_sphere(f"s{i}", tuple(p), float(rng.uniform(0.4, 0.9)),
                            mats[i % 8])
    scene.create_sphere("lamp", (0, 6, 8), 1.5, 8)
    cam = Camera.look_at((0, 0, -2), (0, 0, 8), fov_degrees=60)
    return scene, cam, rng


def soa_grad_fn(scene_data, camera, width, height, fields, kw):
    """jit(grad of sum(image)) through the SoA integrator (path replay)."""
    from spt_tpu.diff import gradients as G
    render = G.make_render_fn(scene_data, camera, width, height, **kw)
    return jax.jit(lambda p, ids: jax.grad(
        lambda q: jnp.sum(render(q, ids)))(p)), G.get_params(scene_data,
                                                             fields)


def bench_config1(quick):
    from spt_tpu import Camera
    from spt_tpu.kernels import megakernel
    sd = sphere_on_plane().compile()
    cam = Camera.look_at((0, 0, 0), (0, 0, 5), fov_degrees=70)
    W = H = 256
    SPP = 16
    kw = dict(max_bounces=4, rr_depth=2, use_nee=False, use_mis=False, seed=1)
    segs = count_segments(sd, cam, kw)
    dt = timed(lambda s0: megakernel.render_tiles(
        sd, cam, W, H, s0, SPP, **kw), 0, reps=7)
    return {"config": 1, "name": "sphere-on-plane 256^2 16spp d4 (triton fwd)",
            "spp": SPP, "wall_s": dt, "rays_per_s": SPP * segs * W * H / dt,
            "segments_per_path": segs}


def bench_config2(quick):
    from spt_tpu.kernels import megakernel
    sd = cornell(ggx=False).compile()
    cam = cornell_camera()
    W = H = 512
    SPP = 16 if quick else 256
    kw = dict(max_bounces=8, rr_depth=3, use_nee=True, use_mis=False, seed=2)
    segs = count_segments(sd, cam, kw)
    dt = timed(lambda s0: megakernel.render_tiles(sd, cam, W, H, s0, SPP,
                                                  **kw), 0, reps=5)
    return {"config": 2, "name": "Cornell Lambert+NEE 512^2 d8 (triton fwd)",
            "spp": SPP, "quick": quick, "wall_s": dt,
            "rays_per_s": SPP * segs * W * H / dt, "segments_per_path": segs}


def bench_config3(quick):
    from spt_tpu.kernels import megakernel
    sd = cornell(ggx=True).compile()
    cam = cornell_camera()
    W = H = 512
    SPP_F = 16 if quick else 256
    SPP_B = 16 if quick else 256
    kw = dict(max_bounces=8, rr_depth=3, use_nee=True, use_mis=True, seed=3)
    segs = count_segments(sd, cam, kw)
    dt_f = timed(lambda s0: megakernel.render_tiles(sd, cam, W, H, s0, SPP_F,
                                                    **kw), 0, reps=5)
    grad, params = soa_grad_fn(sd, cam, W, H, ("albedo", "roughness"), kw)
    dt_b = timed(grad, params, jnp.arange(SPP_B))
    return {"config": 3, "name": "Cornell GGX+MIS 512^2 d8",
            "spp_fwd": SPP_F, "spp_fwd_bwd": SPP_B, "quick": quick,
            "fwd_rays_per_s": SPP_F * segs * W * H / dt_f,
            "fwd_bwd_rays_per_s": SPP_B * segs * W * H / dt_b,
            "wall_s_fwd": dt_f, "wall_s_fwd_bwd": dt_b,
            "segments_per_path": segs}


def bench_config4(quick):
    from spt_tpu.diff.gradients import InverseRenderer, get_params, make_render_fn
    scene, cam, rng = inverse_scene()
    sd = scene.compile()
    W = H = 128 if quick else 256
    render = make_render_fn(sd, cam, W, H, max_bounces=4)
    true_albedo = get_params(sd)["albedo"]
    target = jax.block_until_ready(render(get_params(sd), jnp.arange(32)))
    inv = InverseRenderer(sd, cam, target, fields=("albedo", "roughness"),
                          spp_per_step=8, max_bounces=4)
    inv.params["albedo"] = jnp.clip(
        inv.params["albedo"] + jnp.asarray(
            rng.uniform(-0.3, 0.3, inv.params["albedo"].shape), jnp.float32),
        0.05, 0.95)

    def alb_rmse():
        return float(jnp.sqrt(jnp.mean(
            (inv.params["albedo"] - true_albedo) ** 2)))

    rmse0 = alb_rmse()
    loss0 = inv.step()  # includes compile
    t0 = time.perf_counter()
    n_steps = 10 if quick else 50
    for _ in range(n_steps):
        loss = inv.step()
    dt = (time.perf_counter() - t0) / n_steps
    # The image loss has an MC-noise floor (rotating 8-spp estimates vs a
    # 32-spp target); parameter recovery is the real convergence metric.
    return {"config": 4, "name": f"inverse render 32 spheres {W}x{W}",
            "n_steps": n_steps, "quick": quick, "step_wall_s": dt,
            "loss_first": loss0, "loss_last": loss,
            "albedo_rmse_first": rmse0, "albedo_rmse_last": alb_rmse()}


def bench_config5(quick):
    from spt_tpu.engine.integrator_soa import render_megasample_soa
    sd = scene_10k(2000 if quick else 10_000).compile()
    assert sd.bvh is not None
    cam = camera_10k()
    W, H = (960, 540) if quick else (1920, 1080)
    kw = dict(max_bounces=8, rr_depth=3, use_nee=True, use_mis=True, seed=5)
    segs = count_segments(sd, cam, kw, w=128, h=128, spp=4)
    SPP = 1 if quick else 4
    fwd = jax.jit(lambda sc, ids: render_megasample_soa(sc, cam, W, H, ids,
                                                        **kw))
    dt_f = timed(fwd, sd, jnp.arange(SPP), reps=3)
    grad, params = soa_grad_fn(sd, cam, W, H,
                               ("albedo", "roughness", "centers", "radii"),
                               kw)
    dt_b = timed(grad, params, jnp.arange(SPP), reps=2)
    return {"config": 5, "name": f"10k-prim BVH {W}x{H} d8 NEE+MIS (xla)",
            "spp": SPP, "quick": quick, "n_prims": sd.num_prims,
            "fwd_rays_per_s": SPP * segs * W * H / dt_f,
            "fwd_bwd_rays_per_s": SPP * segs * W * H / dt_b,
            "wall_s_fwd": dt_f, "wall_s_fwd_bwd": dt_b,
            "segments_per_path": segs}


BENCHES = {1: bench_config1, 2: bench_config2, 3: bench_config3,
           4: bench_config4, 5: bench_config5}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller spp/res (CI-sized)")
    ap.add_argument("--configs", default="1,2,3,4,5")
    args = ap.parse_args()
    ids = [int(x) for x in args.configs.split(",")]
    device = require_gpu()
    from spt_tpu.utils import compile_cache
    log(f"devices: {jax.devices()}; compile cache {compile_cache.enable()}")
    for i in ids:
        log(f"--- config {i} ---")
        t0 = time.perf_counter()
        r = BENCHES[i](args.quick)
        r.update(device)
        log(f"config {i} done in {time.perf_counter() - t0:.1f}s")
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
