"""Engine facade: factory, progressive accumulation/invalidation protocol."""

import numpy as np
import pytest

import spt_tpu
from spt_tpu import RenderSettings, Scene, create_path_tracer


def _simple_scene():
    scene = Scene()
    m = scene.add_material("lambert", albedo=(0.7, 0.7, 0.7))
    scene.create_sphere("s", (0.0, -1.0, 5.0), 1.0, m)
    scene.create_sphere("ground", (0.0, -102.0, 5.0), 100.0, m)
    return scene


def test_factory_unknown_backend_raises():
    with pytest.raises(ValueError):
        create_path_tracer("cuda")


def test_progressive_accumulation_and_result():
    tracer = create_path_tracer("jax")
    tracer.set_scene(_simple_scene())
    s = RenderSettings()
    s.set_resolution(32, 32)
    s.integrator = "reference"
    tracer.set_settings(s)

    tracer.render()
    assert tracer.frame_count == 1
    tracer.render()
    assert tracer.frame_count == 2

    res = tracer.get_render_result()
    assert res.width == 32 and res.height == 32
    assert res.image_buffer.shape == (32, 32)
    assert res.image_buffer.dtype == np.uint32
    img = np.asarray(res.image_f32)
    assert img.min() >= 0.0 and img.max() <= 1.0 and img.max() > 0.1


def test_scene_edit_resets_accumulation():
    tracer = create_path_tracer("jax")
    scene = _simple_scene()
    tracer.set_scene(scene)
    s = RenderSettings()
    s.set_resolution(16, 16)
    s.integrator = "reference"
    tracer.set_settings(s)
    tracer.render()
    tracer.render()
    assert tracer.frame_count == 2
    # Scene edit -> dirty -> accumulation reset on next render
    # (CPUPathTracer.cpp:119-131 semantics).
    scene.find_node("s").set_position(0.5, -1.0, 5.0)
    tracer.render()
    assert tracer.frame_count == 1


def test_settings_change_resets_accumulation():
    tracer = create_path_tracer("jax")
    tracer.set_scene(_simple_scene())
    s = RenderSettings()
    s.set_resolution(16, 16)
    s.integrator = "reference"
    tracer.set_settings(s)
    tracer.render()
    tracer.render()
    s.exposure = 2.0  # marks dirty only on change (RenderSettings.cpp:5-55)
    tracer.render()
    assert tracer.frame_count == 1
    s.exposure = 2.0  # same value -> not dirty
    tracer.render()
    assert tracer.frame_count == 2


def test_resolution_change_reallocates():
    tracer = create_path_tracer("jax")
    tracer.set_scene(_simple_scene())
    s = RenderSettings()
    s.set_resolution(16, 16)
    s.integrator = "reference"
    tracer.set_settings(s)
    tracer.render()
    s.set_resolution(24, 16)
    tracer.render()
    assert tracer.frame_count == 1
    res = tracer.get_render_result()
    assert res.width == 24 and res.height == 16


def test_full_integrator_smoke():
    tracer = create_path_tracer("jax")
    scene = _simple_scene()
    tracer.set_scene(scene)
    s = RenderSettings()
    s.set_resolution(24, 24)
    s.samples_per_pixel = 4
    s.max_bounces = 4
    s.progressive = False
    tracer.set_settings(s)
    tracer.render()
    assert tracer.frame_count == 4
    img = np.asarray(tracer.get_render_result().image_f32)
    assert np.isfinite(img).all() and img.max() > 0.1


def test_checkpoint_roundtrip():
    tracer = create_path_tracer("jax")
    tracer.set_scene(_simple_scene())
    s = RenderSettings()
    s.set_resolution(16, 16)
    s.integrator = "reference"
    tracer.set_settings(s)
    tracer.render()
    tracer.render()
    state = tracer.get_state()
    img_a = np.asarray(tracer.get_render_result().image_f32)

    tracer2 = create_path_tracer("jax")
    tracer2.set_scene(_simple_scene())
    s2 = RenderSettings()
    s2.set_resolution(16, 16)
    s2.integrator = "reference"
    tracer2.set_settings(s2)
    tracer2.set_state(state)
    img_b = np.asarray(tracer2.get_render_result().image_f32)
    np.testing.assert_array_equal(img_a, img_b)
    # Resuming continues the same stream.
    tracer.render()
    tracer2.render()
    np.testing.assert_array_equal(
        np.asarray(tracer.get_render_result().image_f32),
        np.asarray(tracer2.get_render_result().image_f32))
