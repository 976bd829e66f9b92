#!/usr/bin/env python
"""Smoke test of the path tracer on one GPU, through the user entry points.

    python chip_smoke.py                # one card: phases 0-7
    python chip_smoke.py --four-cards   # four cards: the sharded paths only

Each phase prints one line; any failure exits non-zero and prints no
result.  The last line of a passing run is one JSON object naming the
device as JAX reports it.  Everything runs in this one process (a second
JAX process could not get the card's memory); the only child process is
``nvidia-smi``.

One-card phases:
  0 device      the default device must be a GPU
  1 native      the C++ BVH builder and display library build from
                native/*.cpp and load; the SAH builder built the BVH
  2 config 3    Cornell GGX+MIS 512x512, depth 8, 64 spp, through
    forward     create_path_tracer("pallas") (the Triton megakernel),
                against the SoA integrator; the SoA integrator against the
                AoS oracle; the card against the host CPU at 128x128; no
                matrix product on the main path without precision=HIGHEST
  3 config 3    jax.grad of make_render_fn at 512x512, 16 spp, checked
    fwd+bwd     against central finite differences
  4 config 5    10k-sphere BVH scene, 1920x1080, depth 8, 1 spp: forward
                against the AoS oracle (see ``oracle_checks``), and fwd+bwd
  5 config 4    five InverseRenderer steps (32 spheres, 256x256, 8 spp)
  6 CLI         apps/render_cli.py writes a PNG
  7 gpu tests   the tests marked ``gpu``
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Image agreement rule of the test suite (tests/test_pallas.py): every path
# is float32 and draws the same random numbers, so two renders differ only
# by rounding (operation order, fused multiply-adds); a rounding difference
# can flip a discrete event (which sphere is hit, Russian roulette, lobe
# choice) in a few pixels, hence a per-pixel rule with a 97% quorum plus a
# 1% check on the image mean, which such flips barely move.
RTOL, ATOL, QUORUM, MEAN_RTOL = 2e-3, 2e-4, 0.97, 0.01

# Shapes of the phases (the BASELINE configs' own widths).
CONFIG3_SIZE, CONFIG3_SPP, ORACLE_SPP, GRAD_SPP = 512, 64, 16, 16
HOST_SIZE, HOST_SPP = 128, 4
CONFIG5_SIZE = (1920, 1080)
CONFIG4_SIZE = 256


IMAGE_RULE_REASON = ("float32 on both sides with the same random streams: "
                     "the images differ by rounding, which flips a discrete "
                     "event in a few pixels")


def _jaxpr_eqns(jaxpr):
    """Every equation of ``jaxpr``, those of its sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else (p,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _jaxpr_eqns(inner)


def low_precision_matmuls(fn, *args) -> tuple[int, int]:
    """(matrix products, those without ``precision=HIGHEST``) in the jaxpr
    of ``fn(*args)``.  On the GPU an f32 product without it may run in
    TF32, which would loosen every tolerance below."""
    import jax
    hi = jax.lax.Precision.HIGHEST
    dots = [e for e in _jaxpr_eqns(jax.make_jaxpr(fn)(*args).jaxpr)
            if e.primitive.name in ("dot_general", "conv_general_dilated")]
    low = [e for e in dots
           if tuple(e.params.get("precision") or ()) != (hi, hi)]
    return len(dots), len(low)


def main_path_matmuls(sd, cam, width, height, kw) -> tuple[int, int]:
    """``low_precision_matmuls`` summed over the SoA forward, its gradient
    through ``make_render_fn`` and the megakernel, for scene ``sd``."""
    import jax
    import jax.numpy as jnp

    from spt_tpu.diff import gradients as G
    from spt_tpu.engine.integrator_soa import render_megasample_soa, static_mtypes
    from spt_tpu.kernels import megakernel

    ids = jnp.arange(1)
    mt = static_mtypes(sd)
    render = G.make_render_fn(sd, cam, width, height, **kw)
    args, statics = megakernel.launch_args(sd, cam, width, height, 0, 1, **kw)
    counts = [
        low_precision_matmuls(lambda sc: render_megasample_soa(
            sc, cam, width, height, ids, mtypes=mt, **kw), sd),
        low_precision_matmuls(jax.grad(lambda p: jnp.sum(render(p, ids))),
                              G.get_params(sd)),
        low_precision_matmuls(
            lambda *a: megakernel._launch(*a, **statics), *args),
    ]
    return tuple(sum(c) for c in zip(*counts))


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def image_rule(a, b, what: str) -> str:
    """Raises AssertionError unless ``a`` agrees with reference ``b``."""
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape or not np.isfinite(a).all():
        raise AssertionError(f"{what}: shape {a.shape} vs {b.shape}, "
                             f"finite={np.isfinite(a).all()}")
    close = np.isclose(a, b, rtol=RTOL, atol=ATOL).all(axis=-1).mean()
    rel = abs(a.mean() - b.mean()) / abs(b.mean())
    msg = (f"{what}: {close:.5f} of px within rtol {RTOL}/atol {ATOL} "
           f"(need >= {QUORUM}), means differ by {rel:.2e} "
           f"(need < {MEAN_RTOL})")
    if close < QUORUM or rel >= MEAN_RTOL:
        raise AssertionError(msg)
    return msg


def oracle_checks(make_test, make_ref, args, what, deep=None) -> str:
    """Compares a render path with its reference where the paths' float
    operations differ (another integrator, another sharding of the scene).

    In the 10k-sphere cloud a last-bit difference in a ray flips which
    sphere a later bounce hits, and the flip compounds: the share of pixels
    within the image rule fell from 0.996 at depth 1 to 0.93 at depth 8
    (CPU run, 320x180).  So the image rule applies at depth 1, where no
    flip has compounded, and depth 8 (the config) is held to the rule's
    1% bound on the image mean; its per-pixel share is printed.
    ``make_test(depth)`` / ``make_ref(depth)`` return jitted renders;
    ``deep`` is the test path's depth-8 image when already rendered."""
    import numpy as np
    shallow = image_rule(np.asarray(make_test(1)(*args)),
                         np.asarray(make_ref(1)(*args)), what + " depth 1")
    a = np.asarray(make_test(8)(*args)) if deep is None else deep
    b = np.asarray(make_ref(8)(*args))
    rel = abs(a.mean() - b.mean()) / abs(b.mean())
    share = np.isclose(a, b, rtol=RTOL, atol=ATOL).all(axis=-1).mean()
    msg = (f"{what} depth 8: means differ by {rel:.2e} (need < "
           f"{MEAN_RTOL}), {share:.5f} of px within the rule (information: "
           f"hit flips compound with depth)")
    if not (np.isfinite(a).all() and rel < MEAN_RTOL):
        raise AssertionError(msg)
    return shallow + "; " + msg


@contextlib.contextmanager
def phase(name: str):
    """Prints one line for the phase; any exception ends the run."""
    t0 = time.perf_counter()
    notes: list = []
    try:
        yield notes
    except BaseException:
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s",
              flush=True)
        traceback.print_exc()
        sys.exit(1)
    print(f"[{name}] ok {time.perf_counter() - t0:.1f}s: "
          + "; ".join(notes), flush=True)


def _wall(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def phase_native(notes):
    import numpy as np

    import bench_suite
    from spt_tpu.core import bvh as bvh_mod
    from spt_tpu.io import native_display
    from spt_tpu.utils import native

    for name in native.LIBRARIES:
        native.build(name)
    notes.append("built " + ", ".join(
        os.path.basename(native.library_path(n)) for n in native.LIBRARIES))
    if not native_display.available():
        raise AssertionError("display library did not load")
    sd = bench_suite.scene_10k().compile()
    live = np.nonzero(np.asarray(sd.prim_valid))[0]
    sah = bvh_mod._build_native(np.asarray(sd.centers)[live],
                                np.asarray(sd.radii)[live], sd.bvh.max_leaf)
    if sah is None:
        raise AssertionError("native SAH builder unavailable")
    if not (np.array_equal(np.asarray(sd.bvh.node_skip), sah[2])
            and np.array_equal(np.asarray(sd.bvh.prim_idx), live[sah[5]])):
        raise AssertionError("scene BVH was not built by the SAH builder")
    notes.append(f"10k-sphere BVH from the SAH builder, {sd.bvh.n_nodes} "
                 f"nodes")
    return sd


def phase_config3_forward(notes):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench_suite
    import spt_tpu
    from spt_tpu.engine.integrator_jax import render_megasample
    from spt_tpu.engine.integrator_soa import render_megasample_soa, static_mtypes
    from spt_tpu.engine.pallas_backend import uses_megakernel

    cam = bench_suite.cornell_camera()
    W = H = CONFIG3_SIZE
    SPP = CONFIG3_SPP
    kw = dict(max_bounces=8, rr_depth=3, use_nee=True, use_mis=True, seed=3)
    tracer = spt_tpu.create_path_tracer("pallas")
    tracer.set_scene(bench_suite.cornell(ggx=True))
    tracer.set_camera(cam)
    s = spt_tpu.RenderSettings()
    s.set_resolution(W, H)
    s.samples_per_pixel = SPP
    s.max_bounces, s.russian_roulette_depth = 8, 3
    s.use_nee = s.use_mis = True
    s.seed = 3
    s.progressive = False
    tracer.set_settings(s)
    t0 = time.perf_counter()
    tracer.render_to_completion()
    accum = np.asarray(tracer.get_state()["accum"])
    t_facade = time.perf_counter() - t0
    sd = tracer.scene_data
    if not uses_megakernel(sd, jax.default_backend()):
        raise AssertionError("facade did not route to the megakernel")
    mt = static_mtypes(sd)

    def soa_fn(width, height):
        return jax.jit(lambda sc, c, ids: render_megasample_soa(
            sc, c, width, height, ids, mtypes=mt, **kw))

    soa = soa_fn(W, H)
    ref = np.asarray(soa(sd, cam, jnp.arange(SPP)))
    notes.append(f"facade {SPP} spp {t_facade:.2f}s incl. compile")
    n_dots, n_low = main_path_matmuls(sd, cam, W, H, kw)
    if n_low:
        raise AssertionError(f"{n_low} of {n_dots} matrix products on the "
                             f"main path lack precision=HIGHEST")
    notes.append(f"{n_dots} matrix products in the soa forward, its "
                 f"gradient and the megakernel, so no precision setting")
    notes.append(f"image rule: {IMAGE_RULE_REASON}")
    notes.append(image_rule(accum, ref, f"triton vs soa {W}^2 {SPP}spp"))

    aos = jax.jit(lambda sc, c, ids: render_megasample(
        sc, c, W, H, ids, **kw))
    ids = jnp.arange(ORACLE_SPP)
    notes.append(image_rule(np.asarray(soa(sd, cam, ids)),
                            np.asarray(aos(sd, cam, ids)),
                            f"soa vs aos oracle {W}^2 {ORACLE_SPP}spp"))

    cpu = jax.devices("cpu")[0]
    small = soa_fn(HOST_SIZE, HOST_SIZE)
    ids = jnp.arange(HOST_SPP)
    on_gpu = np.asarray(small(sd, cam, ids))
    on_cpu = np.asarray(small(*jax.device_put((sd, cam, ids), cpu)))
    notes.append(image_rule(on_gpu, on_cpu, f"gpu vs host cpu {HOST_SIZE}^2 "
                            f"{HOST_SPP}spp"))


def _fd(loss64, params, field, index, h):
    import jax.numpy as jnp
    import numpy as np

    def perturbed(delta):
        p = dict(params)
        arr = np.asarray(p[field]).copy()
        arr[index] += delta
        p[field] = jnp.asarray(arr)
        return loss64(p)

    return (perturbed(h) - perturbed(-h)) / (2 * h)


def _check_fd(notes, g_auto, g_fd, rtol, atol, what):
    import numpy as np
    if not np.allclose(g_auto, g_fd, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: autodiff {g_auto} vs FD {g_fd} "
                             f"(rtol {rtol}, atol {atol})")
    notes.append(f"{what} {g_auto:.5g} vs FD {g_fd:.5g}")


def phase_config3_fwd_bwd(notes):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench_suite
    from spt_tpu.diff import gradients as G

    cam = bench_suite.cornell_camera()
    sd = bench_suite.cornell(ggx=True).compile()
    W = H = CONFIG3_SIZE
    render = G.make_render_fn(sd, cam, W, H, max_bounces=8, use_nee=True,
                              use_mis=True, seed=3)
    params = G.get_params(sd, ("albedo", "roughness", "centers"))
    ids = jnp.arange(GRAD_SPP)
    grad = jax.jit(jax.grad(lambda p, i: jnp.sum(render(p, i))))
    compiled = grad.lower(params, ids).compile()
    mem = compiled.memory_analysis()
    g, dt = _wall(compiled, params, ids)
    g, dt = _wall(compiled, params, ids)
    for k, v in g.items():
        if not np.isfinite(np.asarray(v)).all():
            raise AssertionError(f"non-finite gradient for {k}")
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    notes.append(f"grad {W}^2 {GRAD_SPP}spp {dt:.3f}s; memory_analysis: temp "
                 f"{mem.temp_size_in_bytes} B, args "
                 f"{mem.argument_size_in_bytes} B, out "
                 f"{mem.output_size_in_bytes} B; peak_bytes_in_use {peak}")

    # Sums in float64 on the host, so the FD quotient is not limited by an
    # f32 sum over 786k values.  Albedo enters linearly, so FD is exact up
    # to rounding at any size: step 1e-2, rtol 1e-2 (tests/test_gradients).
    fwd = jax.jit(render)

    def loss64(p):
        return float(np.asarray(fwd(p, ids), np.float64).sum())

    for index in ((0, 0), (0, 1)):
        _check_fd(notes, float(g["albedo"][index]),
                  _fd(loss64, params, "albedo", index, 1e-2), 1e-2, 1e-5,
                  f"d/dalbedo{index} {W}^2")

    # Roughness and geometry move discrete visibility events (which sphere
    # a reflected or shadow ray hits, silhouettes); the path-replay
    # gradient keeps only the interior term (diff/gradients.py), so FD is
    # a valid reference only where no step crosses a boundary: the unit
    # test's 24x18, 4-spp, 3-bounce scene, with its steps and tolerances.
    scene, gcam = bench_suite.gradient_scene()
    gsd = scene.compile()
    grender = G.make_render_fn(gsd, gcam, 24, 18, max_bounces=3)
    gparams = G.get_params(gsd, ("roughness", "centers", "radii"))
    gids = jnp.arange(4)
    gg = jax.jit(jax.grad(lambda p: jnp.sum(grender(p, gids))))(gparams)
    gfwd = jax.jit(grender)

    def gloss64(p):
        return float(np.asarray(gfwd(p, gids), np.float64).sum())

    for field, index, h, rtol, atol in (
            ("roughness", (1,), 1e-3, 5e-2, 1e-5),
            ("centers", (1, 0), 1e-4, 0.1, 1e-2),
            ("radii", (3,), 1e-4, 0.1, 1e-2)):
        _check_fd(notes, float(gg[field][index]),
                  _fd(gloss64, gparams, field, index, h), rtol, atol,
                  f"d/d{field}{index} 24x18 (h {h}, rtol {rtol})")
    notes.append("FD tolerances: albedo is linear in the image, so FD is "
                 "exact up to rounding (rtol 1e-2); the others are "
                 "tests/test_gradients.py's, on its scene, where no step "
                 "crosses a visibility boundary")


def phase_config5(notes, sd):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench_suite
    from spt_tpu.diff import gradients as G
    from spt_tpu.engine.integrator_jax import render_megasample
    from spt_tpu.engine.integrator_soa import render_megasample_soa

    cam = bench_suite.camera_10k()
    W, H = CONFIG5_SIZE
    kw = dict(max_bounces=8, rr_depth=3, use_nee=True, use_mis=True, seed=5)
    ids = jnp.arange(1)
    fwd = jax.jit(lambda sc, i: render_megasample_soa(sc, cam, W, H, i, **kw))
    img, t_first = _wall(fwd, sd, ids)
    img, t_fwd = _wall(fwd, sd, ids)
    notes.append(f"soa forward {t_fwd:.3f}s warm ({t_first:.1f}s first, "
                 f"information only)")
    notes.append(oracle_checks(
        lambda d: jax.jit(lambda sc, i: render_megasample_soa(
            sc, cam, W, H, i, **dict(kw, max_bounces=d))),
        lambda d: jax.jit(lambda sc, i: render_megasample(
            sc, cam, W, H, i, **dict(kw, max_bounces=d))),
        (sd, ids), f"soa vs aos {W}x{H}", deep=np.asarray(img)))
    render = G.make_render_fn(sd, cam, W, H, **kw)
    params = G.get_params(sd, ("albedo", "roughness", "centers", "radii"))
    grad = jax.jit(jax.grad(lambda p, i: jnp.sum(render(p, i))))
    g, t_first = _wall(grad, params, ids)
    g, t_bwd = _wall(grad, params, ids)
    for k, v in g.items():
        if not np.isfinite(np.asarray(v)).all():
            raise AssertionError(f"non-finite gradient for {k}")
    notes.append(f"fwd+bwd {t_bwd:.3f}s warm ({t_first:.1f}s first), "
                 f"gradients finite")


def phase_config4(notes):
    import jax.numpy as jnp
    import numpy as np

    import bench_suite
    from spt_tpu.diff.gradients import InverseRenderer, get_params, make_render_fn

    scene, cam, rng = bench_suite.inverse_scene()
    sd = scene.compile()
    W = H = CONFIG4_SIZE
    render = make_render_fn(sd, cam, W, H, max_bounces=4)
    true_albedo = get_params(sd)["albedo"]
    target = render(get_params(sd), jnp.arange(32))
    inv = InverseRenderer(sd, cam, target, fields=("albedo", "roughness"),
                          spp_per_step=8, max_bounces=4)
    inv.params["albedo"] = jnp.clip(
        inv.params["albedo"] + jnp.asarray(
            rng.uniform(-0.3, 0.3, inv.params["albedo"].shape), jnp.float32),
        0.05, 0.95)

    def rmse():
        return float(jnp.sqrt(jnp.mean(
            (inv.params["albedo"] - true_albedo) ** 2)))

    rmse0 = rmse()
    losses = inv.run(5)
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss {losses}")
    if not rmse() < rmse0:
        raise AssertionError(f"albedo RMSE {rmse0} -> {rmse()}")
    notes.append(f"losses {['%.5f' % x for x in losses]}; albedo RMSE "
                 f"{rmse0:.4f} -> {rmse():.4f}")


def phase_cli(notes):
    sys.path.insert(0, os.path.join(REPO, "apps"))
    import render_cli

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell.png")
        rc = render_cli.main([os.path.join(REPO, "scenes", "cornell.json"),
                              "-o", out, "--spp", "16", "-q"])
        if rc != 0:
            raise AssertionError(f"render_cli returned {rc}")
        with open(out, "rb") as f:
            head = f.read(8)
        if head != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"{out} is not a PNG")
        notes.append(f"wrote a {os.path.getsize(out)}-byte PNG")


def phase_gpu_tests(notes):
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(REPO, "tests")])
    if rc != 0:
        raise AssertionError(f"pytest -m gpu exited {rc}")
    notes.append("pytest -m gpu passed")


def phase_four_cards(notes, size=CONFIG5_SIZE, n_spheres=10_000,
                     grad_size=128):
    """Each strategy of parallel/sharding.py on a 4-device mesh against one
    device.  The defaults are config 5's widths; a CPU rehearsal on four
    virtual devices passes smaller ones (tests/test_chip_smoke.py)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench_suite
    from spt_tpu.diff import gradients as G
    from spt_tpu.engine.integrator_jax import render_megasample
    from spt_tpu.parallel import sharding as S
    from spt_tpu.parallel.mesh import make_render_mesh

    if len(jax.devices()) < 4:
        raise AssertionError(f"needs 4 devices, found {jax.devices()}")
    sd = bench_suite.scene_10k(n_spheres).compile()
    cam = bench_suite.camera_10k()
    W, H = size
    kw = dict(max_bounces=8, rr_depth=3, use_nee=True, use_mis=True, seed=5)
    ids1 = jnp.arange(1)
    one = jax.jit(lambda sc, i: render_megasample(sc, cam, W, H, i, **kw))
    refs = {8: np.asarray(one(sd, ids1))}
    ref4 = np.asarray(one(sd, jnp.arange(4)))

    def one_at(depth):
        """One device's 1-spp image at ``depth``, rendered once."""
        if depth not in refs:
            refs[depth] = np.asarray(jax.jit(lambda sc, i: render_megasample(
                sc, cam, W, H, i, **dict(kw, max_bounces=depth)))(sd, ids1))
        return refs[depth]

    # Each strategy builds its program per call, so its wall includes the
    # compile; it is information, not a result.
    data4 = make_render_mesh(data=4)
    mesh22 = make_render_mesh(data=2, prim=2)
    for what, fn, ref in (
            (f"pixel-sharded 4x1 {W}x{H}",
             lambda: S.render_pixel_sharded(sd, cam, W, H, ids1, data4,
                                            **kw), refs[8]),
            (f"sample-sharded 4x1 {W}x{H} 4spp",
             lambda: S.render_sample_sharded(sd, cam, W, H, 1, data4, **kw),
             ref4)):
        img, dt = _wall(fn)
        notes.append(f"{dt:.1f}s incl. compile; "
                     + image_rule(np.asarray(img), ref, what))
    for what, strategy in (("gather", S.render_prim_sharded_gather),
                           ("ring", S.render_prim_sharded_ring)):
        img, dt = _wall(lambda: strategy(sd, cam, W, H, ids1, mesh22, **kw))
        notes.append(f"{dt:.1f}s incl. compile; " + oracle_checks(
            lambda d: (lambda: strategy(sd, cam, W, H, ids1, mesh22,
                                        **dict(kw, max_bounces=d))),
            lambda d: (lambda: one_at(d)),
            (), f"prim {what} 2x2 {W}x{H}", deep=np.asarray(img)))

    csd = bench_suite.cornell(ggx=True).compile()
    ccam = bench_suite.cornell_camera()
    render = G.make_render_fn(csd, ccam, grad_size, grad_size, max_bounces=8)
    params = G.get_params(csd, ("albedo", "roughness"))
    target = render(params, jnp.arange(8, 16))
    loss_fn = G.make_loss_fn(render, target)
    step = S.make_dp_grad_step(loss_fn, data4, samples_per_device=2)
    loss, grads = step(params, jnp.int32(0))
    vg = jax.jit(jax.value_and_grad(loss_fn))
    parts = [vg(params, jnp.arange(2 * d, 2 * d + 2)) for d in range(4)]
    loss_ref = np.mean([float(p[0]) for p in parts])
    # Per-device partial results are the same compiled program; only the
    # order of the final mean differs.
    if not np.allclose(float(loss), loss_ref, rtol=1e-4):
        raise AssertionError(f"dp loss {float(loss)} vs {loss_ref}")
    for k in params:
        gref = np.mean([np.asarray(p[1][k]) for p in parts], axis=0)
        if not np.allclose(np.asarray(grads[k]), gref, rtol=1e-3,
                           atol=1e-7):
            raise AssertionError(f"dp grad {k} differs from one card")
    notes.append(f"make_dp_grad_step on 4 cards == mean of one-card "
                 f"steps (loss {float(loss):.6f}, rtol 1e-4; grads rtol "
                 f"1e-3)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    with phase("0 device") as notes:
        import jax

        import bench_suite
        from spt_tpu.utils import compile_cache
        devices = jax.devices()
        device = bench_suite.require_gpu(devices)
        notes.append(f"devices {devices}")
        notes.append(f"kind {device['device_kind']}, count {len(devices)}")
        notes.append(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
        notes.append(f"JAX_PLATFORMS="
                     f"{os.environ.get('JAX_PLATFORMS', '')!r}")
        notes.append(f"jax {jax.__version__}")
        notes.append(f"compile cache {compile_cache.enable()}")
        card = gpu_name_and_power()
    print(card, flush=True)

    if args.four_cards:
        with phase("four cards") as notes:
            phase_four_cards(notes)
    else:
        with phase("1 native") as notes:
            sd5 = phase_native(notes)
        with phase("2 config 3 forward") as notes:
            phase_config3_forward(notes)
        with phase("3 config 3 fwd+bwd") as notes:
            phase_config3_fwd_bwd(notes)
        with phase("4 config 5") as notes:
            phase_config5(notes, sd5)
        with phase("5 config 4") as notes:
            phase_config4(notes)
        with phase("6 cli") as notes:
            phase_cli(notes)
        with phase("7 gpu tests") as notes:
            phase_gpu_tests(notes)

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
