"""Triton megakernel vs the pure-JAX integrators (interpret mode on CPU).

All integrators consume identical counter-RNG streams, so images must agree
to float reordering tolerance on the overwhelming majority of pixels, and
exactly in expectation.  The compiled kernel is checked against the SoA
integrator by the ``gpu``-marked test, on a card.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import spt_tpu
from spt_tpu import Camera, RenderSettings, Scene, create_path_tracer
from spt_tpu.engine.integrator_jax import render_megasample
from spt_tpu.kernels import megakernel


def _cornell():
    scene = Scene()
    scene.set_sky(spt_tpu.SKY_NONE)
    white = scene.add_material("lambert", albedo=(0.73, 0.73, 0.73))
    red = scene.add_material("lambert", albedo=(0.65, 0.05, 0.05))
    green = scene.add_material("lambert", albedo=(0.12, 0.45, 0.15))
    light = scene.add_material("lambert", albedo=(0.78,) * 3,
                               emission=(15.0,) * 3)
    metal = scene.add_material("metal", albedo=(0.8, 0.85, 0.9), roughness=0.2)
    glass = scene.add_material("glass", albedo=(0.97,) * 3, ior=1.5)
    R = 1000.0
    scene.create_sphere("floor", (0, -R, 3), R, white)
    scene.create_sphere("ceil", (0, R + 2, 3), R, white)
    scene.create_sphere("left", (-R - 2, 1, 3), R, red)
    scene.create_sphere("right", (R + 2, 1, 3), R, green)
    scene.create_sphere("back", (0, 1, R + 5), R, white)
    scene.create_sphere("lamp", (0, 2.55, 3), 0.6, light)
    scene.create_sphere("ball", (-0.7, 0.5, 3.4), 0.5, metal)
    scene.create_sphere("gball", (0.7, 0.45, 2.8), 0.45, glass)
    return scene


def _camera():
    return Camera.look_at((0, 1.0, -1.5), (0, 1.0, 3.0), fov_degrees=55)


@pytest.mark.parametrize("use_nee,use_mis", [(True, True), (False, False)])
def test_megakernel_matches_jax_integrator(use_nee, use_mis):
    scene = _cornell()
    sd = scene.compile()
    cam = _camera()
    W = H = 32
    kw = dict(max_bounces=4, rr_depth=2, use_nee=use_nee, use_mis=use_mis,
              seed=3)
    spp = 4
    img_jax = np.asarray(render_megasample(
        sd, cam, W, H, jnp.arange(spp), **kw))
    img_pal = np.asarray(megakernel.render_tiles(
        sd, cam, W, H, 0, spp, interpret=True, **kw))

    assert np.isfinite(img_pal).all()
    close = np.isclose(img_pal, img_jax, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() > 0.97, f"{(~close).sum()} px diverge"
    rel_mean = abs(img_pal.mean() - img_jax.mean()) / img_jax.mean()
    assert rel_mean < 0.01


def test_megakernel_sky_scene():
    """Sky-gradient scene (no lights) also matches."""
    scene = Scene()
    m = scene.add_material("lambert", albedo=(0.7, 0.7, 0.7))
    scene.create_sphere("s", (0.0, -1.0, 5.0), 1.0, m)
    scene.create_sphere("ground", (0.0, -102.0, 5.0), 100.0, m)
    sd = scene.compile()
    cam = Camera.look_at((0, 0, 0), (0, 0, 1), fov_degrees=90)
    W, H = 48, 32
    kw = dict(max_bounces=4, rr_depth=2, seed=0)
    img_jax = np.asarray(render_megasample(sd, cam, W, H, jnp.arange(2), **kw))
    img_pal = np.asarray(megakernel.render_tiles(
        sd, cam, W, H, 0, 2, interpret=True, **kw))
    close = np.isclose(img_pal, img_jax, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() > 0.97


@pytest.mark.parametrize("W,H", [(16, 16), (40, 24)])
def test_megakernel_sample_chunking_invariance(W, H):
    """start_sample chunks must compose exactly like one big call."""
    scene = _cornell()
    sd = scene.compile()
    cam = _camera()
    kw = dict(max_bounces=3, rr_depth=2, seed=5)
    full = np.asarray(megakernel.render_tiles(sd, cam, W, H, 0, 4,
                                              interpret=True, **kw))
    parts = (np.asarray(megakernel.render_tiles(sd, cam, W, H, 0, 2,
                                                interpret=True, **kw))
             + np.asarray(megakernel.render_tiles(sd, cam, W, H, 2, 2,
                                                  interpret=True, **kw)))
    np.testing.assert_allclose(parts, full, rtol=1e-6, atol=1e-7)


def test_pallas_backend_via_factory():
    tracer = create_path_tracer("pallas")
    assert tracer.get_backend_name() == "pallas"
    tracer.set_scene(_cornell())
    tracer.set_camera(_camera())
    s = RenderSettings()
    s.set_resolution(24, 24)
    s.samples_per_pixel = 2
    s.max_bounces = 3
    s.progressive = False
    tracer.set_settings(s)
    tracer.render()
    img = np.asarray(tracer.get_render_result().image_f32)
    assert np.isfinite(img).all() and img.max() > 0.05


def test_megakernel_dof_matches_jax_integrator():
    """Thin-lens raygen (aperture > 0) agrees across jax / SoA / pallas."""
    from spt_tpu.engine.integrator_soa import render_megasample_soa

    sd = _cornell().compile()
    cam = Camera.look_at((0, 1.0, -1.5), (0, 1.0, 3.0), fov_degrees=55,
                         aperture=0.15, focus_dist=4.5)
    W = H = 32
    kw = dict(max_bounces=3, rr_depth=2, use_nee=True, use_mis=True, seed=7)
    spp = 4
    img_jax = np.asarray(render_megasample(
        sd, cam, W, H, jnp.arange(spp), dof=True, **kw))
    img_soa = np.asarray(render_megasample_soa(
        sd, cam, W, H, jnp.arange(spp), dof=True, **kw))
    img_pal = np.asarray(megakernel.render_tiles(
        sd, cam, W, H, 0, spp, interpret=True, **kw))  # dof auto-detected

    for name, img in [("soa", img_soa), ("pallas", img_pal)]:
        assert np.isfinite(img).all(), name
        close = np.isclose(img, img_jax, rtol=2e-3, atol=2e-4).all(axis=-1)
        assert close.mean() > 0.97, f"{name}: {(~close).sum()} px diverge"

    # DoF must actually blur: pinhole and thin-lens images differ.
    img_pin = np.asarray(megakernel.render_tiles(
        sd, cam, W, H, 0, spp, dof=False, interpret=True, **kw))
    assert np.abs(img_pin - img_pal).max() > 1e-3


def test_engine_auto_dof():
    """The facade enables thin-lens when the camera has an aperture."""
    tracer = create_path_tracer("jax")
    scene = Scene()
    m = scene.add_material("lambert", albedo=(0.7, 0.7, 0.7))
    scene.create_sphere("s", (0.0, 0.0, 5.0), 1.0, m)
    scene.create_sphere("ground", (0.0, -101.0, 5.0), 100.0, m)
    tracer.set_scene(scene)
    s = RenderSettings()
    s.set_resolution(24, 24)
    s.samples_per_pixel = 4
    tracer.set_settings(s)
    cam_pin = Camera.look_at((0, 0, 0), (0, 0, 5), fov_degrees=60)
    tracer.set_camera(cam_pin)
    tracer.render(spp=4)
    img_pin = np.asarray(tracer.get_render_result().image_f32)
    cam_dof = Camera.look_at((0, 0, 0), (0, 0, 5), fov_degrees=60,
                             aperture=0.3)
    tracer.set_camera(cam_dof)
    tracer.render(spp=4)
    img_dof = np.asarray(tracer.get_render_result().image_f32)
    assert np.isfinite(img_dof).all()
    assert np.abs(img_dof - img_pin).max() > 1e-3


@pytest.mark.parametrize("block", [64, 128, 256])
def test_megakernel_pads_partial_block(block):
    """40x24 = 960 pixels fill no whole number of blocks: the padded lanes
    must be dropped and every real pixel must match the SoA integrator."""
    from spt_tpu.engine.integrator_soa import render_megasample_soa

    sd = _cornell().compile()
    W, H = 40, 24
    kw = dict(max_bounces=3, rr_depth=2, use_nee=True, use_mis=True, seed=11)
    img = np.asarray(megakernel.render_tiles(sd, _camera(), W, H, 0, 2,
                                             block=block, interpret=True,
                                             **kw))
    ref = np.asarray(render_megasample_soa(sd, _camera(), W, H,
                                           jnp.arange(2), **kw))
    assert img.shape == (H, W, 3)
    close = np.isclose(img, ref, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() > 0.97, f"{(~close).sum()} px diverge"


def test_megakernel_rejects_large_scene():
    scene = Scene()
    m = scene.add_material("lambert")
    for i in range(megakernel.MAX_PRIMS + 1):
        scene.create_sphere(f"s{i}", (0, 0, 5 + i), 0.1, m)
    sd = scene.compile(use_bvh=False)
    with pytest.raises(ValueError, match="at most"):
        megakernel.render_tiles(sd, _camera(), 8, 8, 0, 1, interpret=True)


def _sky_scene(n=2):
    scene = Scene()
    m = scene.add_material("lambert", albedo=(0.7, 0.7, 0.7))
    for i in range(n):
        scene.create_sphere(f"s{i}", (0.0, -1.0, 5.0 + 3 * i), 1.0, m)
    return scene


@pytest.mark.parametrize("platform,n_prims,sky,expected", [
    ("gpu", 8, spt_tpu.SKY_NONE, True),
    ("gpu", 128, spt_tpu.SKY_GRADIENT, True),
    ("gpu", 129, spt_tpu.SKY_GRADIENT, False),
    ("gpu", 8, "envmap", False),
    ("cpu", 8, spt_tpu.SKY_NONE, False),
])
def test_pallas_backend_routing(platform, n_prims, sky, expected):
    """The kernel takes small scenes without an env map, on a GPU only."""
    from spt_tpu.core.scene import SKY_ENVMAP
    from spt_tpu.engine.pallas_backend import uses_megakernel

    scene = _sky_scene(n_prims)
    if sky == "envmap":
        scene.set_environment_map(np.ones((4, 8, 3), np.float32))
        sd = scene.compile()
        assert sd.sky_mode == SKY_ENVMAP
    else:
        scene.set_sky(sky)
        sd = scene.compile(use_bvh=False)
    assert uses_megakernel(sd, platform) is expected


def test_pallas_backend_runs_kernel_on_gpu(monkeypatch):
    """With the platform reported as a GPU, the facade renders through the
    megakernel (run here in interpret mode) and matches the SoA route."""
    import jax
    from spt_tpu.engine import pallas_backend

    calls = []
    real = megakernel.render_tiles

    def spy(*a, **k):
        calls.append(a[4:6])
        return real(*a, interpret=True, **k)

    def render(platform):
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        tracer = create_path_tracer("pallas")
        tracer.set_scene(_cornell())
        tracer.set_camera(_camera())
        s = RenderSettings()
        s.set_resolution(24, 16)
        s.samples_per_pixel = 3
        s.max_bounces = 3
        tracer.set_settings(s)
        tracer.render_to_completion(chunk_spp=2)
        return np.asarray(tracer.get_state()["accum"])

    monkeypatch.setattr(pallas_backend.megakernel, "render_tiles", spy)
    img_kernel = render("gpu")
    assert calls == [(0, 2), (2, 1)]
    img_soa = render("cpu")
    assert len(calls) == 2
    close = np.isclose(img_kernel, img_soa, rtol=2e-3, atol=2e-4).all(-1)
    assert close.mean() > 0.97


@pytest.mark.gpu
def test_compiled_megakernel_matches_soa(gpu):
    """The kernel as compiled for the card, against the SoA integrator."""
    from spt_tpu.engine.integrator_soa import render_megasample_soa

    sd = _cornell().compile()
    W, H = 96, 64
    kw = dict(max_bounces=8, rr_depth=3, use_nee=True, use_mis=True, seed=3)
    img = np.asarray(megakernel.render_tiles(sd, _camera(), W, H, 0, 8,
                                             **kw))
    ref = np.asarray(render_megasample_soa(sd, _camera(), W, H,
                                           jnp.arange(8), **kw))
    close = np.isclose(img, ref, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() > 0.97, f"{(~close).sum()} px diverge"
    assert abs(img.mean() - ref.mean()) / ref.mean() < 0.01
