"""Gradient correctness: autodiff (path replay) vs finite differences.

With fixed sample ids, the render is a deterministic function of the
parameters, so central finite differences of that exact function must match
jax.grad wherever no discrete decision boundary is crossed — the BASELINE.md
'pixel-grad allclose' gate.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import bench_suite
import spt_tpu
from spt_tpu import Camera
from spt_tpu.diff import gradients as G


def _scene_with_light():
    return bench_suite.gradient_scene()[0]


def _setup(fields, spp=4, w=24, h=18, **kw):
    scene = _scene_with_light()
    sd = scene.compile()
    cam = Camera.look_at((0, 1.0, -1.0), (0, 0.8, 4.0), fov_degrees=55)
    render = G.make_render_fn(sd, cam, w, h, max_bounces=3, **kw)
    params = G.get_params(sd, fields)
    ids = jnp.arange(spp)
    return render, params, ids


def _fd_check(render, params, ids, field, index, h_step, rtol, atol=1e-5):
    """Central FD on a scalar loss = sum(render) wrt params[field][index]."""
    def loss(p):
        return jnp.sum(render(p, ids))

    g_auto = jax.grad(lambda p: loss(p))(params)[field][index]

    def perturb(delta):
        p = dict(params)
        arr = np.asarray(p[field]).copy()
        arr[index] += delta
        p[field] = jnp.asarray(arr)
        return float(loss(p))

    g_fd = (perturb(h_step) - perturb(-h_step)) / (2 * h_step)
    np.testing.assert_allclose(np.asarray(g_auto), g_fd, rtol=rtol, atol=atol)


def test_albedo_gradient_matches_fd():
    render, params, ids = _setup(("albedo",))
    _fd_check(render, params, ids, "albedo", (0, 0), 1e-2, rtol=1e-2)
    _fd_check(render, params, ids, "albedo", (0, 1), 1e-2, rtol=1e-2)


def test_emission_gradient_matches_fd():
    render, params, ids = _setup(("emission",))
    _fd_check(render, params, ids, "emission", (2, 0), 5e-2, rtol=1e-2)


def test_roughness_gradient_matches_fd():
    render, params, ids = _setup(("roughness",))
    _fd_check(render, params, ids, "roughness", (1,), 1e-3, rtol=5e-2)


def test_radius_gradient_matches_fd():
    # Geometry gradients carry interior terms only; pick a step small enough
    # not to flip visibility for these samples.
    render, params, ids = _setup(("radii",))
    _fd_check(render, params, ids, "radii", (3,), 1e-4, rtol=0.1, atol=1e-2)


def test_ior_gradient_matches_fd():
    scene = _scene_with_light()
    glass = scene.add_material("glass", albedo=(0.95,) * 3, ior=1.5)
    scene.create_sphere("gball", (0.0, 0.6, 3.2), 0.5, glass)
    sd = scene.compile()
    cam = Camera.look_at((0, 1.0, -1.0), (0, 0.8, 4.0), fov_degrees=55)
    render = G.make_render_fn(sd, cam, 24, 18, max_bounces=3)
    params = G.get_params(sd, ("ior",))
    ids = jnp.arange(4)
    _fd_check(render, params, ids, "ior", (3,), 1e-3, rtol=5e-2, atol=1e-3)


def test_sky_params_gradient_matches_fd():
    scene = _scene_with_light()
    scene.set_sky(spt_tpu.SKY_GRADIENT)
    sd = scene.compile()
    cam = Camera.look_at((0, 1.0, -1.0), (0, 0.8, 4.0), fov_degrees=55)
    render = G.make_render_fn(sd, cam, 24, 18, max_bounces=3)
    params = G.get_params(sd, ("sky_params",))
    ids = jnp.arange(4)
    _fd_check(render, params, ids, "sky_params", (0, 1), 1e-2, rtol=1e-2)
    _fd_check(render, params, ids, "sky_params", (1, 2), 1e-2, rtol=1e-2)


def test_center_gradient_is_finite_and_nonzero():
    render, params, ids = _setup(("centers",))
    g = jax.grad(lambda p: jnp.sum(render(p, ids)))(params)["centers"]
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g).max() > 0.0


def test_gradients_finite_with_rr_and_all_materials():
    """Full featureset (RR on, glass added): grads must stay finite."""
    scene = _scene_with_light()
    glass = scene.add_material("glass", albedo=(0.95,) * 3, ior=1.5)
    scene.create_sphere("gball", (0.0, 0.5, 3.2), 0.4, glass)
    sd = scene.compile()
    cam = Camera.look_at((0, 1.0, -1.0), (0, 0.8, 4.0), fov_degrees=55)
    render = G.make_render_fn(sd, cam, 20, 16, max_bounces=5, rr_depth=2)
    params = G.get_params(sd, ("albedo", "roughness", "emission",
                               "centers", "radii"))
    g = jax.grad(lambda p: jnp.sum(render(p, jnp.arange(2))))(params)
    for k, v in g.items():
        assert np.isfinite(np.asarray(v)).all(), f"non-finite grad in {k}"


def test_inverse_rendering_recovers_albedo():
    """Mini config-4: recover a perturbed albedo by gradient descent."""
    scene = _scene_with_light()
    sd_true = scene.compile()
    cam = Camera.look_at((0, 1.0, -1.0), (0, 0.8, 4.0), fov_degrees=55)
    W, H = 24, 18
    render = G.make_render_fn(sd_true, cam, W, H, max_bounces=3)
    true_params = G.get_params(sd_true, ("albedo",))
    target = render(true_params, jnp.arange(8))

    # Fixed sample ids: the loss is a deterministic function with minimum at
    # the true parameters (target rendered with the same ids), so descent
    # must recover them.
    inv = G.InverseRenderer(sd_true, cam, target, fields=("albedo",),
                            spp_per_step=8, learning_rate=0.05, max_bounces=3,
                            rotate_samples=False)
    inv.params = {"albedo": jnp.clip(
        true_params["albedo"] + jnp.asarray([[0.25, -0.2, 0.15]] * 3), 0, 1)}
    first = inv.step()
    for _ in range(49):
        loss = inv.step()
    err0 = np.abs(np.asarray([0.25, -0.2, 0.15]))
    err = np.abs(np.asarray(inv.params["albedo"][0])
                 - np.asarray(true_params["albedo"][0]))
    assert loss < first * 0.1, (first, loss)
    assert err.max() < err0.max() * 0.4, (err, err0)
