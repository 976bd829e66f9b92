#!/usr/bin/env python
"""CLI renderer: scene.json -> image.

The application layer the reference implemented as an SDL/ImGui editor
(src/App.cpp) and *planned* as a CLI (render-library-architecture.md's
standalone-renderer goal), realized headless: progressive chunked rendering
with live status lines, periodic preview writes, and checkpoint/resume.

Usage:
  python apps/render_cli.py scenes/cornell.json -o out.png --spp 256
  python apps/render_cli.py scenes/cornell.json -o out.png --backend pallas
  python apps/render_cli.py scene.json -o out.png --resume state.npz
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="spt_tpu CLI renderer")
    ap.add_argument("scene", help="scene JSON file")
    ap.add_argument("-o", "--output", required=True,
                    help="output image (.png/.ppm/.npy)")
    ap.add_argument("--backend", default="pallas", choices=["jax", "pallas"])
    ap.add_argument("--spp", type=int, default=None,
                    help="override samples per pixel")
    ap.add_argument("--size", type=int, nargs=2, default=None,
                    metavar=("W", "H"), help="override resolution")
    ap.add_argument("--max-bounces", type=int, default=None)
    ap.add_argument("--chunk", type=int, default=16,
                    help="samples per progressive chunk")
    ap.add_argument("--preview-every", type=int, default=0,
                    help="write preview image every N chunks (0=off)")
    ap.add_argument("--checkpoint", default=None,
                    help="write progressive state here after each chunk")
    ap.add_argument("--resume", default=None,
                    help="resume from a saved state file")
    ap.add_argument("--device", default=None, choices=[None, "cpu", "gpu"],
                    help="force JAX platform")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler device trace of the render "
                         "into DIR (view with xprof/tensorboard)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    import jax
    if args.device:
        jax.config.update("jax_platforms", args.device)

    import spt_tpu
    from spt_tpu.io import checkpoint as ckpt
    from spt_tpu.io.image import write_image
    from spt_tpu.io.scene_json import load_scene

    if not args.quiet:
        spt_tpu.install_console_sink()

    scene, camera, settings = load_scene(args.scene)
    if args.size:
        settings.set_resolution(*args.size)
    if args.spp is not None:
        settings.samples_per_pixel = args.spp
    if args.max_bounces is not None:
        settings.max_bounces = args.max_bounces
    if args.seed is not None:
        settings.seed = args.seed

    tracer = spt_tpu.create_path_tracer(args.backend)
    tracer.set_scene(scene)
    tracer.set_settings(settings)
    if camera is not None:
        tracer.set_camera(camera)

    if args.resume:
        ckpt.load_render_state(args.resume, tracer)
        print(f"resumed at {tracer.frame_count} spp from {args.resume}")

    import contextlib

    from spt_tpu.utils.profiling import capture_trace, trace_scope

    target = settings.samples_per_pixel
    t_start = time.time()
    chunk_i = 0
    profiler = capture_trace(args.profile) if args.profile \
        else contextlib.nullcontext()
    with profiler:
        while tracer.frame_count < target:
            n = min(args.chunk, target - tracer.frame_count)
            t0 = time.time()
            with trace_scope(f"render_chunk_{chunk_i}"):
                tracer.render(spp=n)
                import jax as _jax
                _jax.block_until_ready(tracer.get_state()["accum"])
            dt = time.time() - t0
            chunk_i += 1
            done = tracer.frame_count
            rays = settings.width * settings.height * n
            if not args.quiet:
                print(f"  [{done:5d}/{target} spp] chunk {dt:6.2f}s "
                      f"({rays / dt / 1e6:7.1f}M paths/s)")
            if args.checkpoint:
                ckpt.save_render_state(args.checkpoint, tracer)
            if args.preview_every and chunk_i % args.preview_every == 0:
                res = tracer.get_render_result()
                write_image(args.output, res.image_f32)
    if args.profile and not args.quiet:
        print(f"profiler trace written to {args.profile}")
        # Per-bounce lane occupancy: the wavefront-compaction diagnostic.
        from spt_tpu.utils.profiling import measure_occupancy
        occ = measure_occupancy(
            tracer.scene_data, tracer._camera or tracer._default_camera(),
            min(settings.width, 128), min(settings.height, 128),
            spp=4, max_bounces=settings.max_bounces,
            rr_depth=settings.russian_roulette_depth,
            use_nee=settings.use_nee, use_mis=settings.use_mis,
            seed=settings.seed)
        print("active-lane occupancy per bounce: "
              + " ".join(f"{x:.3f}" for x in occ))

    res = tracer.get_render_result()
    write_image(args.output, res.image_f32)
    total = time.time() - t_start
    print(f"wrote {args.output} ({settings.width}x{settings.height}, "
          f"{tracer.frame_count} spp, {total:.1f}s, backend={args.backend})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
