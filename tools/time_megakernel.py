#!/usr/bin/env python
"""Triton megakernel vs the plain-XLA SoA integrator, on one GPU.

Configs 2 and 3 forward (Cornell 512x512, depth 8, 256 spp; NEE, and
NEE+MIS with GGX and glass), same scene, sample ids and settings for both
paths.  Both run in this one process, after a warm-up, in turns
(kernel, XLA, XLA, kernel, ...), each call ending in ``block_until_ready``;
the kernel is timed at each candidate block size.  Prints one JSON line per
config with every wall, then their medians.

Usage: python tools/time_megakernel.py [--reps 6] [--spp 256]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--blocks", default="64,128,256")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import bench_suite
    from spt_tpu.engine.integrator_soa import render_megasample_soa, static_mtypes
    from spt_tpu.kernels import megakernel
    from spt_tpu.utils import compile_cache

    device = bench_suite.require_gpu()
    compile_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    blocks = [int(b) for b in args.blocks.split(",")]
    cam = bench_suite.cornell_camera()
    W = H = 512
    spp = args.spp
    for config, ggx, mis, seed in ((2, False, False, 2), (3, True, True, 3)):
        sd = bench_suite.cornell(ggx=ggx).compile()
        kw = dict(max_bounces=8, rr_depth=3, use_nee=True, use_mis=mis,
                  seed=seed)
        mt = static_mtypes(sd)
        xla = jax.jit(lambda sc, ids: render_megasample_soa(
            sc, cam, W, H, ids, mtypes=mt, **kw))
        paths = {"xla_soa": lambda s0: xla(sd, s0 + jnp.arange(spp))}
        for b in blocks:
            paths[f"triton_block{b}"] = (
                lambda s0, b=b: megakernel.render_tiles(
                    sd, cam, W, H, s0, spp, block=b, **kw))
        for fn in paths.values():   # warm-up: compile, first run
            jax.block_until_ready(fn(0))
        walls = {name: [] for name in paths}
        order = list(paths)
        for rep in range(args.reps):
            for name in (order if rep % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                jax.block_until_ready(paths[name]((rep + 1) * spp))
                walls[name].append(time.perf_counter() - t0)
        print(json.dumps({
            "config": config, "width": W, "height": H, "spp": spp,
            "card": card, **device, "walls_s": walls,
            "median_s": {k: statistics.median(v) for k, v in walls.items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
