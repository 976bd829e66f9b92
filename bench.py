#!/usr/bin/env python
"""Headline benchmark: rays/s on one GPU, forward+backward, Cornell box.

Metric definition (BASELINE.json: "rays/s/chip fwd+bwd at 1024spp Cornell
box"): the Cornell scene is rendered at 512x512 with NEE+MIS at depth 8 and
differentiated w.r.t. scene parameters (path-replay backward through the
SoA integrator).  Ray count is the number of *actual* ray segments traced
forward (path segments + NEE shadow rays, measured exactly by an
instrumented pass — not paths x max_depth), and the denominator is the full
forward+backward wall time, so the number is conservative: backward
re-traces the transport chain but is not double-counted.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "rays/s", "vs_baseline": N, ...}
vs_baseline is value / 500e6 (the BASELINE.md target).  The line also
carries the forward-only rate of the Triton megakernel and the device it
ran on.  Refuses to run without a GPU.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _min_wall(fn, starts):
    """min wall over ``starts`` (each a fresh sample range) after a warmup."""
    jax.block_until_ready(fn(0))
    times = []
    for s0 in starts:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(s0))
        times.append(time.perf_counter() - t0)
    return min(times)


def main() -> int:
    import bench_suite
    from spt_tpu.engine.integrator_soa import render_megasample_soa, static_mtypes
    from spt_tpu.kernels import megakernel
    from spt_tpu.utils import compile_cache

    device = bench_suite.require_gpu()
    log(f"devices: {jax.devices()}; compile cache {compile_cache.enable()}")
    scene_data = bench_suite.cornell(ggx=True).compile()
    camera = bench_suite.cornell_camera()
    W = H = 512
    kw = dict(max_bounces=8, rr_depth=3, use_nee=True, use_mis=True, seed=3)
    mtypes = static_mtypes(scene_data)

    # --- forward: Triton megakernel ----------------------------------------
    SPP_F = 256
    dt_f = _min_wall(lambda s0: megakernel.render_tiles(
        scene_data, camera, W, H, s0, SPP_F, **kw),
        [(i + 1) * SPP_F for i in range(3)])

    # --- exact ray-segment count (small instrumented SoA pass) ------------
    CW = CH = 128
    count_fn = jax.jit(lambda sc, ids: render_megasample_soa(
        sc, camera, CW, CH, ids, mtypes=mtypes, with_occupancy=True,
        **kw)[1:])
    n_rays0, occ = count_fn(scene_data, jnp.arange(8))
    segs_per_path = float(n_rays0) / (8.0 * CW * CH)
    # Per-bounce occupancy sums to path segments WITHOUT NEE shadow rays —
    # report both so the metric is unambiguous.
    path_segs_per_path = float(jnp.sum(occ))
    segs_per_spp = segs_per_path * W * H
    log(f"measured segments per path: {segs_per_path:.2f} "
        f"(incl. shadow rays; {path_segs_per_path:.2f} path-only)")
    fwd_rays_s = SPP_F * segs_per_spp / dt_f
    log(f"forward (triton): {dt_f:.4f}s/{SPP_F}spp")

    # --- forward+backward: jax.grad through the SoA integrator -------------
    SPP_B = 1024  # the metric config itself
    grad, params = bench_suite.soa_grad_fn(
        scene_data, camera, W, H,
        ("albedo", "emission", "roughness", "centers", "radii"), kw)
    dt_b = _min_wall(lambda s0: grad(params, s0 + jnp.arange(SPP_B)),
                     [(i + 1) * SPP_B for i in range(3)])
    fb_rays_s = SPP_B * segs_per_spp / dt_b
    log(f"fwd+bwd (xla path replay): {dt_b:.4f}s/{SPP_B}spp")

    result = {
        "metric": "rays/s fwd+bwd, Cornell 512x512 depth-8 NEE+MIS",
        "value": fb_rays_s,
        "unit": "rays/s",
        "vs_baseline": fb_rays_s / 500e6,
        "forward_only_rays_s": fwd_rays_s,
        "wall_s_fwd_256spp": dt_f,
        "wall_s_fwd_bwd_1024spp": dt_b,
        "segments_per_spp": segs_per_spp,
        # Same wall time counted without NEE shadow rays (path segments
        # only) — the conservative reading of "rays".
        "value_path_segments_only": fb_rays_s * path_segs_per_path
        / segs_per_path,
        **device,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
