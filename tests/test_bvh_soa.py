"""SoA BVH traversal + differentiable large-scene rendering.

Covers the large-scene path of BASELINE config 5: component-array BVH
traversal equals brute force, BVH intersection carries the same gradients
as the brute-force argmin path, and the SoA gather integrator matches the
AoS integrator (images and gradients) on >128-sphere scenes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spt_tpu.core import intersect
from spt_tpu.core.bvh import (build_bvh, intersect_bvh, intersect_bvh_soa,
                              occluded_bvh_soa)


def _random_scene(rng, n, spread=10.0):
    centers = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.2, 0.8, (n,)).astype(np.float32)
    return centers, radii


def _random_rays(rng, n_rays, spread=12.0):
    o = rng.uniform(-spread, spread, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _soa(v):
    v = jnp.asarray(v)
    return v[:, 0], v[:, 1], v[:, 2]


@pytest.mark.parametrize("n_prims", [5, 64, 300])
def test_intersect_bvh_soa_matches_bruteforce(rng_np, n_prims):
    centers, radii = _random_scene(rng_np, n_prims)
    b = build_bvh(centers, radii)
    o, d = _random_rays(rng_np, 512)
    t_b, id_b = intersect.intersect_spheres(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(centers),
        jnp.asarray(radii), jnp.ones(n_prims, bool))
    ox, oy, oz = _soa(o)
    dx, dy, dz = _soa(d)
    cx, cy, cz = _soa(centers)
    t_s, id_s = intersect_bvh_soa(ox, oy, oz, dx, dy, dz, cx, cy, cz,
                                  jnp.asarray(radii), b)
    id_b, id_s = np.asarray(id_b), np.asarray(id_s)
    agree = id_b == id_s
    assert agree.mean() > 0.995, f"{(~agree).sum()} id mismatches"
    both = agree & (id_b >= 0)
    np.testing.assert_allclose(np.asarray(t_s)[both], np.asarray(t_b)[both],
                               rtol=1e-4, atol=1e-5)


def test_occluded_bvh_soa_matches_bruteforce(rng_np):
    centers, radii = _random_scene(rng_np, 200)
    b = build_bvh(centers, radii)
    o, d = _random_rays(rng_np, 512)
    tmax = jnp.asarray(rng_np.uniform(1.0, 30.0, (512,)).astype(np.float32))
    blocked_b = intersect.occluded(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(centers),
        jnp.asarray(radii), jnp.ones(200, bool), tmax)
    ox, oy, oz = _soa(o)
    dx, dy, dz = _soa(d)
    cx, cy, cz = _soa(centers)
    blocked_s = occluded_bvh_soa(ox, oy, oz, dx, dy, dz, cx, cy, cz,
                                 jnp.asarray(radii), b, tmax)
    # Grazing boundary flips allowed at ulp level only.
    agree = np.asarray(blocked_b) == np.asarray(blocked_s)
    assert agree.mean() > 0.995


def test_intersect_bvh_gradients_match_bruteforce(rng_np):
    """d sum(t) / d (centers, radii, o, d): BVH recompute == brute force."""
    centers, radii = _random_scene(rng_np, 64, spread=6.0)
    b = build_bvh(centers, radii)
    o, d = _random_rays(rng_np, 256, spread=8.0)
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(centers),
            jnp.asarray(radii))

    def loss_brute(o, d, c, r):
        t, hid = intersect.intersect_spheres(o, d, c, r, jnp.ones(64, bool))
        return jnp.sum(jnp.where(hid >= 0, t, 0.0))

    def loss_bvh(o, d, c, r):
        t, hid = intersect_bvh(o, d, c, r, b)
        return jnp.sum(jnp.where(hid >= 0, t, 0.0))

    # Only compare when hit selection agrees (grazing flips excluded).
    _, id_b = intersect.intersect_spheres(*args, jnp.ones(64, bool))
    _, id_v = intersect_bvh(*args, b)
    if not (np.asarray(id_b) == np.asarray(id_v)).all():
        keep = np.asarray(id_b) == np.asarray(id_v)
        args = tuple(a[jnp.asarray(keep)] if a.shape[0] == 256 else a
                     for a in args)

    g_brute = jax.grad(loss_brute, argnums=(0, 1, 2, 3))(*args)
    g_bvh = jax.grad(loss_bvh, argnums=(0, 1, 2, 3))(*args)
    for gb, gv in zip(g_brute, g_bvh):
        np.testing.assert_allclose(np.asarray(gv), np.asarray(gb),
                                   rtol=1e-4, atol=1e-5)


def _big_scene(rng, n=300, with_lights=True):
    from spt_tpu import Scene
    from spt_tpu.core.scene import SKY_GRADIENT

    scene = Scene()
    scene.set_sky(SKY_GRADIENT)
    lam = scene.add_material("lambert", albedo=(0.6, 0.5, 0.4))
    met = scene.add_material("metal", albedo=(0.8, 0.8, 0.9), roughness=0.3)
    gls = scene.add_material("glass", albedo=(0.95,) * 3, ior=1.5)
    emit = scene.add_material("lambert", albedo=(0.8,) * 3,
                              emission=(12.0, 10.0, 8.0))
    mats = [lam, lam, met, gls]
    for i in range(n):
        p = rng.uniform(-8, 8, 3)
        p[2] += 14.0
        m = emit if (with_lights and i % 37 == 0) else mats[i % 4]
        scene.create_sphere(f"s{i}", tuple(p), float(rng.uniform(0.2, 0.6)), m)
    return scene


def test_soa_large_scene_matches_aos(rng_np):
    """>128-sphere scene: SoA gather+BVH integrator ≡ AoS integrator."""
    from spt_tpu import Camera
    from spt_tpu.engine.integrator_jax import render_megasample
    from spt_tpu.engine.integrator_soa import render_megasample_soa

    scene = _big_scene(rng_np, n=220)
    sd = scene.compile(use_bvh=True)
    assert sd.capacity > 128 and sd.bvh is not None
    cam = Camera.look_at((0, 0, -4), (0, 0, 14), fov_degrees=60)
    W = H = 24
    kw = dict(max_bounces=3, rr_depth=8, use_nee=True, use_mis=True, seed=3)
    ids = jnp.arange(4)
    img_aos = np.asarray(jax.jit(
        lambda sd, s: render_megasample(sd, cam, W, H, s, **kw))(sd, ids)) / 4
    img_soa = np.asarray(jax.jit(
        lambda sd, s: render_megasample_soa(sd, cam, W, H, s, **kw))(sd, ids)) / 4
    close = np.isclose(img_aos, img_soa, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() > 0.97, f"{(~close).sum()} mismatched px"
    assert abs(img_aos.mean() - img_soa.mean()) / img_aos.mean() < 0.01


def test_soa_large_scene_gradients(rng_np):
    """Large-scene gradients flow through BVH + gathers, match AoS grads."""
    from spt_tpu import Camera
    from spt_tpu.diff import gradients as G
    from spt_tpu.engine import integrator_jax, integrator_soa

    scene = _big_scene(rng_np, n=200)
    sd = scene.compile(use_bvh=True)
    cam = Camera.look_at((0, 0, -4), (0, 0, 14), fov_degrees=60)
    W = H = 16
    ids = jnp.arange(2)
    kw = dict(max_bounces=2, rr_depth=8, use_nee=True, use_mis=True, seed=5)

    def loss_soa(params):
        sc = G.apply_params(sd, params)
        img = integrator_soa.render_megasample_soa(sc, cam, W, H, ids, **kw)
        return jnp.mean(img)

    def loss_aos(params):
        sc = G.apply_params(sd, params)
        img = integrator_jax.render_megasample(sc, cam, W, H, ids, **kw)
        return jnp.mean(img)

    params = G.get_params(sd, ("albedo", "roughness", "centers", "radii"))
    g_soa = jax.jit(jax.grad(loss_soa))(params)
    g_aos = jax.jit(jax.grad(loss_aos))(params)
    for k in params:
        gs, ga = np.asarray(g_soa[k]), np.asarray(g_aos[k])
        assert np.isfinite(gs).all(), f"non-finite grad in {k}"
        denom = np.abs(ga).max() + 1e-8
        np.testing.assert_allclose(gs / denom, ga / denom, atol=5e-3,
                                   err_msg=f"grad mismatch in {k}")
    # Albedo gradient must actually be nonzero (light reaches surfaces).
    assert np.abs(np.asarray(g_soa["albedo"])).max() > 0


def test_aos_bvh_scene_is_differentiable(rng_np):
    """jax.grad through render_megasample on a BVH-compiled scene works
    (traversal is detached; t is recomputed differentiably)."""
    from spt_tpu import Camera
    from spt_tpu.diff import gradients as G

    scene = _big_scene(rng_np, n=150, with_lights=False)
    sd = scene.compile(use_bvh=True)
    cam = Camera.look_at((0, 0, -4), (0, 0, 14), fov_degrees=60)
    render = G.make_render_fn(sd, cam, 12, 12, max_bounces=2)
    params = G.get_params(sd, ("albedo", "centers"))
    g = jax.jit(jax.grad(lambda p, s: jnp.mean(render(p, s))))(
        params, jnp.arange(2))
    assert np.isfinite(np.asarray(g["albedo"])).all()
    assert np.isfinite(np.asarray(g["centers"])).all()
    assert np.abs(np.asarray(g["albedo"])).max() > 0


def _lit_bvh_scene(n=140, seed=5):
    """>128 spheres (gather+BVH SoA mode) with a lamp, Lambert and GGX."""
    import spt_tpu
    from spt_tpu import Scene

    rng = np.random.default_rng(seed)
    sc = Scene()
    sc.set_sky(spt_tpu.SKY_GRADIENT)
    m = sc.add_material("lambert", albedo=(0.6, 0.5, 0.45))
    m2 = sc.add_material("metal", albedo=(0.3, 0.55, 0.7), roughness=0.4)
    lamp = sc.add_material("lambert", albedo=(0.8,) * 3, emission=(6.0,) * 3)
    sc.create_sphere("floor", (0, -1000, 5), 999.5, m)
    sc.create_sphere("lamp", (0, 4.0, 5), 1.0, lamp)
    for i in range(n):
        p = (float(rng.uniform(-3, 3)), float(rng.uniform(-0.2, 2.5)),
             float(5 + rng.uniform(-1.5, 1.5)))
        sc.create_sphere(f"s{i}", p, 0.3, m if i % 2 else m2)
    return sc


# (field, index, step, rtol, atol): the steps and tolerances of
# tests/test_gradients.py, except roughness, whose 1e-3 step flips which
# sphere a reflected ray hits in this denser scene.
_BVH_FD_CASES = [
    ("albedo", (0, 0), 1e-2, 1e-2, 1e-5),
    ("emission", (2, 1), 5e-2, 1e-2, 1e-5),
    ("roughness", (1,), 1e-4, 5e-2, 1e-5),
    ("centers", (1, 0), 1e-4, 0.1, 1e-2),
    ("radii", (1,), 1e-4, 0.1, 1e-2),
]


@pytest.fixture(scope="module")
def bvh_fd_setup():
    from spt_tpu import Camera
    from spt_tpu.diff import gradients as G

    sd = _lit_bvh_scene().compile(use_bvh=True)
    assert sd.capacity > 128 and sd.bvh is not None
    cam = Camera.look_at((0, 0.5, -1.5), (0, 0.5, 5.0), fov_degrees=60)
    render = G.make_render_fn(sd, cam, 12, 9, max_bounces=2, seed=1)
    params = G.get_params(sd, ("albedo", "emission", "roughness", "centers",
                               "radii"))
    ids = jnp.arange(2)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(render(p, ids))))(params)
    return jax.jit(render), params, ids, grads


@pytest.mark.parametrize("field,index,step,rtol,atol", _BVH_FD_CASES)
def test_bvh_path_gradient_matches_fd(bvh_fd_setup, field, index, step,
                                      rtol, atol):
    """Path-replay gradients through BVH traversal + attribute gathers ==
    central finite differences (summed in float64 on the host)."""
    render, params, ids, grads = bvh_fd_setup

    def loss(delta):
        p = dict(params)
        arr = np.asarray(p[field]).copy()
        arr[index] += delta
        p[field] = jnp.asarray(arr)
        return float(np.asarray(render(p, ids), np.float64).sum())

    g_fd = (loss(step) - loss(-step)) / (2 * step)
    g_auto = float(grads[field][index])
    assert g_auto != 0.0
    np.testing.assert_allclose(g_auto, g_fd, rtol=rtol, atol=atol)
