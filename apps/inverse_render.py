#!/usr/bin/env python
"""Inverse-rendering demo (BASELINE config 4): recover material parameters
of a sphere scene from a target image by pixel-gradient descent.

Builds an N-sphere scene with random albedos/roughness, renders a target,
perturbs the parameters, then optimizes back with path-replay gradients.

Usage:
  python apps/inverse_render.py --spheres 32 --steps 200 --out recovery.png
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spheres", type=int, default=32)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", type=int, nargs=2, default=(96, 72))
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--target-spp", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.03)
    ap.add_argument("--fields", nargs="+", default=["albedo", "roughness"])
    ap.add_argument("--out", default=None, help="write before/after/target PNG")
    ap.add_argument("--device", default=None, choices=[None, "cpu", "gpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    if args.device:
        jax.config.update("jax_platforms", args.device)
    import jax.numpy as jnp
    import numpy as np

    import spt_tpu
    from spt_tpu import Camera, Scene
    from spt_tpu.diff import gradients as G
    from spt_tpu.io.image import write_png

    rng = np.random.default_rng(args.seed)
    scene = Scene()
    scene.set_sky(spt_tpu.SKY_NONE)
    lamp = scene.add_material("lambert", albedo=(0.8,) * 3,
                              emission=(12.0,) * 3)
    floor = scene.add_material("lambert", albedo=(0.55, 0.55, 0.55))
    scene.create_sphere("floor", (0, -1000, 8), 1000.0, floor)
    scene.create_sphere("lamp", (0, 9, 8), 2.5, lamp)
    for i in range(args.spheres):
        kind = "metal" if rng.uniform() < 0.4 else "lambert"
        m = scene.add_material(
            kind, albedo=tuple(rng.uniform(0.15, 0.9, 3)),
            roughness=float(rng.uniform(0.1, 0.8)))
        ang = 2 * np.pi * i / args.spheres
        ring = 2.0 + 2.5 * (i % 3)
        pos = (float(ring * np.cos(ang)), float(0.6 + 1.3 * (i % 4)),
               float(8.0 + ring * np.sin(ang)))
        scene.create_sphere(f"s{i}", pos, 0.6, m)

    sd = scene.compile()
    cam = Camera.look_at((0, 3.5, -4.0), (0, 1.5, 8.0), fov_degrees=60)
    w, h = args.size

    render = G.make_render_fn(sd, cam, w, h, max_bounces=4)
    true_params = G.get_params(sd, tuple(args.fields))
    print(f"rendering target ({args.target_spp} spp)...")
    target = render(true_params, jnp.arange(args.target_spp))

    inv = G.InverseRenderer(sd, cam, target, fields=tuple(args.fields),
                            spp_per_step=args.spp, learning_rate=args.lr,
                            max_bounces=4, seed=args.seed)
    # Perturb the start.
    start = dict(inv.params)
    if "albedo" in start:
        start["albedo"] = jnp.clip(
            start["albedo"] + jnp.asarray(
                rng.uniform(-0.3, 0.3, start["albedo"].shape), jnp.float32),
            0.0, 1.0)
    if "roughness" in start:
        start["roughness"] = jnp.clip(
            start["roughness"] + jnp.asarray(
                rng.uniform(-0.3, 0.3, start["roughness"].shape), jnp.float32),
            0.02, 1.0)
    inv.params = start
    before = render(inv.params, jnp.arange(16))

    t0 = time.time()
    for i in range(args.steps):
        loss = inv.step()
        if (i + 1) % max(args.steps // 10, 1) == 0:
            err = {k: float(jnp.abs(inv.params[k] - true_params[k]).mean())
                   for k in inv.params}
            print(f"step {i+1:4d} loss={loss:.6f} "
                  + " ".join(f"{k}_err={v:.4f}" for k, v in err.items()))
    print(f"optimized {args.steps} steps in {time.time()-t0:.1f}s")

    for k in inv.params:
        e0 = float(jnp.abs(start[k] - true_params[k]).mean())
        e1 = float(jnp.abs(inv.params[k] - true_params[k]).mean())
        print(f"  {k}: mean abs error {e0:.4f} -> {e1:.4f} "
              f"({100*(1-e1/max(e0,1e-9)):.0f}% recovered)")

    if args.out:
        after = render(inv.params, jnp.arange(16))
        strip = np.concatenate([np.asarray(x) for x in (before, after, target)],
                               axis=1)
        write_png(args.out, np.clip(strip, 0, 1) ** (1 / 2.2))
        print(f"wrote {args.out} (before | after | target)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
