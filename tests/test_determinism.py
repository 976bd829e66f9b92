"""Determinism: same inputs -> identical images, across runs and chunkings.

The stand-in for race detection (SURVEY.md §5): any
nondeterminism in kernels or collectives shows up as image differences.
"""

import numpy as np
import jax
import jax.numpy as jnp

import spt_tpu
from spt_tpu import Camera, Scene
from spt_tpu.engine.integrator_jax import (render_megasample,
                                           render_reference_sample)


def _scene():
    scene = Scene()
    m = scene.add_material("lambert", albedo=(0.7,) * 3)
    lamp = scene.add_material("lambert", albedo=(0.8,) * 3, emission=(8.0,) * 3)
    scene.create_sphere("s", (0, -1, 5), 1.0, m)
    scene.create_sphere("ground", (0, -102, 5), 100.0, m)
    scene.create_sphere("lamp", (0, 3, 5), 0.5, lamp)
    return scene.compile()


CAM = Camera.look_at((0, 0, 0), (0, 0, 1), fov_degrees=80)


def test_same_call_twice_is_bitwise_identical():
    sd = _scene()
    f = jax.jit(lambda ids: render_megasample(sd, CAM, 24, 24, ids,
                                              max_bounces=4, rr_depth=2,
                                              seed=7))
    a = np.asarray(f(jnp.arange(4)))
    b = np.asarray(f(jnp.arange(4)))
    np.testing.assert_array_equal(a, b)


def test_sample_chunking_is_exact():
    """sum of chunked renders == one-shot render, bitwise (same jit graph)."""
    sd = _scene()
    f = jax.jit(lambda ids: render_megasample(sd, CAM, 16, 16, ids,
                                              max_bounces=3, rr_depth=2,
                                              seed=1))
    whole = np.asarray(f(jnp.arange(4)))
    parts = np.asarray(f(jnp.arange(0, 2))) + np.asarray(f(jnp.arange(2, 4)))
    np.testing.assert_allclose(parts, whole, rtol=1e-6, atol=1e-7)


def test_seed_changes_image():
    sd = _scene()
    kw = dict(max_bounces=3, rr_depth=2)
    a = np.asarray(render_megasample(sd, CAM, 16, 16, jnp.arange(2), seed=0, **kw))
    b = np.asarray(render_megasample(sd, CAM, 16, 16, jnp.arange(2), seed=1, **kw))
    assert not np.array_equal(a, b)


def test_reference_mode_deterministic_across_processes_shape():
    """Reference RNG is seeded purely by (pixel, frame): two fresh traces
    must agree bitwise."""
    sd = _scene()
    a = np.asarray(render_reference_sample(sd, 16, 16, 3))
    b = np.asarray(jax.jit(
        lambda s: render_reference_sample(s, 16, 16, 3))(sd))
    # Eager and jit compilations may differ by fusion ulps.
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
