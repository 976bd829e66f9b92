"""SoA fast-path integrator ≡ AoS oracle (same RNG, same estimators)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import spt_tpu
from spt_tpu import Camera, Scene
from spt_tpu.engine.integrator_jax import render_megasample
from spt_tpu.engine.integrator_soa import (SOA_MAX_PRIMS,
                                           render_megasample_soa,
                                           static_mtypes)


def _scene():
    scene = Scene()
    scene.set_sky(spt_tpu.SKY_NONE)
    white = scene.add_material("lambert", albedo=(0.73, 0.7, 0.68))
    lamp = scene.add_material("lambert", albedo=(0.8,) * 3, emission=(12.0,) * 3)
    metal = scene.add_material("metal", albedo=(0.85, 0.85, 0.9), roughness=0.25)
    glass = scene.add_material("glass", albedo=(0.96,) * 3, ior=1.5)
    scene.create_sphere("floor", (0, -1000, 4), 1000.0, white)
    scene.create_sphere("lamp", (0, 2.8, 4), 0.7, lamp)
    scene.create_sphere("m", (-0.7, 0.6, 4.0), 0.6, metal)
    scene.create_sphere("g", (0.7, 0.5, 3.6), 0.5, glass)
    return scene


CAM = Camera.look_at((0, 1.0, -1.2), (0, 0.8, 4.0), fov_degrees=55)


@pytest.mark.parametrize("use_nee,use_mis", [(True, True), (False, False)])
def test_soa_matches_aos(use_nee, use_mis):
    sd = _scene().compile()
    kw = dict(max_bounces=4, rr_depth=2, use_nee=use_nee, use_mis=use_mis,
              seed=9)
    a = np.asarray(render_megasample(sd, CAM, 32, 32, jnp.arange(4), **kw))
    b = np.asarray(render_megasample_soa(sd, CAM, 32, 32, jnp.arange(4), **kw))
    close = np.isclose(a, b, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() > 0.97, f"{(~close).sum()} px diverge"
    assert abs(a.mean() - b.mean()) / a.mean() < 0.01


def test_soa_sky_gradient_scene():
    scene = Scene()  # default gradient sky, one sphere
    m = scene.add_material("lambert", albedo=(0.7,) * 3)
    scene.create_sphere("s", (0, -1, 5), 1.0, m)
    sd = scene.compile()
    kw = dict(max_bounces=3, rr_depth=2, seed=1)
    a = np.asarray(render_megasample(sd, CAM, 24, 24, jnp.arange(2), **kw))
    b = np.asarray(render_megasample_soa(sd, CAM, 24, 24, jnp.arange(2), **kw))
    close = np.isclose(a, b, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() > 0.97


def test_soa_under_jit_with_static_mtypes():
    sd = _scene().compile()
    mt = static_mtypes(sd)
    f = jax.jit(lambda sc, ids: render_megasample_soa(
        sc, CAM, 16, 16, ids, mtypes=mt, max_bounces=3, rr_depth=2, seed=0))
    img = np.asarray(f(sd, jnp.arange(2)))
    assert np.isfinite(img).all() and img.max() > 0.0


def test_soa_rejects_oversized_scene():
    scene = Scene()
    m = scene.add_material("lambert")
    for i in range(SOA_MAX_PRIMS + 1):
        scene.create_sphere(f"s{i}", (0, 0, 5 + i), 0.1, m)
    sd = scene.compile(use_bvh=False)
    with pytest.raises(ValueError, match="need a BVH"):
        render_megasample_soa(sd, CAM, 8, 8, jnp.arange(1))


def test_soa_stats_counts_rays():
    sd = _scene().compile()
    img, n = render_megasample_soa(sd, CAM, 16, 16, jnp.arange(2),
                                   max_bounces=3, rr_depth=8, seed=0,
                                   with_stats=True)
    n = float(n)
    # Between 1 and (bounces + shadow rays) per path.
    assert 16 * 16 * 2 <= n <= 16 * 16 * 2 * 6


def _sky_scene(sky):
    """Lit scene under each sky mode; the env map is a smooth, seeded
    equirect image so misses carry direction-dependent radiance."""
    scene = _scene()
    if sky == "envmap":
        rng = np.random.default_rng(3)
        scene.set_environment_map(
            rng.uniform(0.1, 1.5, (8, 16, 3)).astype(np.float32))
    elif sky == "constant":
        scene.set_sky(spt_tpu.SKY_CONSTANT, horizon=(0.3, 0.4, 0.5))
    elif sky == "gradient":
        scene.set_sky(spt_tpu.SKY_GRADIENT)
    return scene


@pytest.mark.parametrize("dof", [False, True])
@pytest.mark.parametrize("use_nee,use_mis",
                         [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("sky", ["none", "gradient", "constant", "envmap"])
def test_soa_matches_aos_matrix(sky, use_nee, use_mis, dof):
    """SoA ≡ AoS oracle for every sky mode × estimator × camera model."""
    sd = _sky_scene(sky).compile()
    cam = Camera.look_at((0, 1.0, -1.2), (0, 0.8, 4.0), fov_degrees=55,
                         aperture=0.1 if dof else 0.0, focus_dist=5.0)
    kw = dict(max_bounces=3, rr_depth=2, use_nee=use_nee, use_mis=use_mis,
              seed=13, dof=dof)
    ids = jnp.arange(2)
    a = np.asarray(render_megasample(sd, cam, 12, 12, ids, **kw))
    b = np.asarray(render_megasample_soa(sd, cam, 12, 12, ids, **kw))
    assert np.isfinite(b).all()
    close = np.isclose(a, b, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() > 0.97, f"{(~close).sum()} px diverge"
    assert abs(a.mean() - b.mean()) / a.mean() < 0.01


@pytest.mark.parametrize("n_prims", [300, 1000])
def test_soa_bvh_scene_matches_aos(n_prims):
    """Gather+BVH SoA mode ≡ AoS oracle on 300- and 1k-sphere BVH scenes."""
    import bench_suite

    sd = bench_suite.scene_10k(n_prims, seed=5).compile(use_bvh=True)
    assert sd.bvh is not None and sd.capacity > SOA_MAX_PRIMS
    cam = bench_suite.camera_10k()
    kw = dict(max_bounces=3, rr_depth=2, use_nee=True, use_mis=True, seed=4)
    ids = jnp.arange(2)
    a = np.asarray(jax.jit(lambda s, i: render_megasample(
        s, cam, 24, 16, i, **kw))(sd, ids))
    b = np.asarray(jax.jit(lambda s, i: render_megasample_soa(
        s, cam, 24, 16, i, **kw))(sd, ids))
    assert a.max() > 0.0
    close = np.isclose(a, b, rtol=2e-3, atol=2e-4).all(axis=-1)
    assert close.mean() > 0.97, f"{(~close).sum()} px diverge"
    assert abs(a.mean() - b.mean()) / a.mean() < 0.01
