"""Distribution correctness on the virtual 8-device CPU mesh.

The gold standard throughout: a sharded render/gradient must equal the
single-device one (counter RNG keys on global pixel/sample ids only).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import spt_tpu
from spt_tpu import Camera, Scene
from spt_tpu.diff import gradients as G
from spt_tpu.engine.integrator_jax import render_megasample
from spt_tpu.parallel.mesh import make_render_mesh
from spt_tpu.parallel import sharding as S


def _scene():
    scene = Scene()
    scene.set_sky(spt_tpu.SKY_NONE)
    white = scene.add_material("lambert", albedo=(0.7, 0.7, 0.7))
    red = scene.add_material("lambert", albedo=(0.6, 0.1, 0.1))
    lamp = scene.add_material("lambert", albedo=(0.8,) * 3, emission=(10.0,) * 3)
    metal = scene.add_material("metal", albedo=(0.8, 0.8, 0.9), roughness=0.3)
    scene.create_sphere("floor", (0, -1000, 4), 1000.0, white)
    scene.create_sphere("ball", (-0.7, 0.6, 4.0), 0.6, red)
    scene.create_sphere("mball", (0.8, 0.5, 4.3), 0.5, metal)
    scene.create_sphere("lamp", (0.0, 2.8, 4.0), 0.7, lamp)
    return scene


CAM = Camera.look_at((0, 1.0, -1.0), (0, 0.8, 4.0), fov_degrees=55)
KW = dict(max_bounces=3, rr_depth=2, seed=11)


def test_eight_devices_available():
    assert len(jax.devices()) == 8, jax.devices()


def test_pixel_sharded_matches_single_device():
    sd = _scene().compile()
    W, H = 32, 32
    ids = jnp.arange(2)
    ref = np.asarray(render_megasample(sd, CAM, W, H, ids, **KW))
    mesh = make_render_mesh(data=8)
    out = np.asarray(S.render_pixel_sharded(sd, CAM, W, H, ids, mesh, **KW))
    # Remat recompute makes sharded-vs-single differ by float reassociation
    # ulps; identical sampling decisions still hold.
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_pixel_sharded_4x2_mesh():
    sd = _scene().compile()
    W, H = 32, 32
    ids = jnp.arange(2)
    ref = np.asarray(render_megasample(sd, CAM, W, H, ids, **KW))
    mesh = make_render_mesh(data=4, prim=2)
    out = np.asarray(S.render_pixel_sharded(sd, CAM, W, H, ids, mesh, **KW))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_sample_sharded_matches_single_device():
    sd = _scene().compile()
    W = H = 24
    mesh = make_render_mesh(data=8)
    out = np.asarray(S.render_sample_sharded(sd, CAM, W, H, 2, mesh, **KW))
    ref = np.asarray(render_megasample(sd, CAM, W, H, jnp.arange(16), **KW))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_prim_sharded_matches_single_device():
    sd = _scene().compile()
    W, H = 24, 24
    ids = jnp.arange(2)
    ref = np.asarray(render_megasample(sd, CAM, W, H, ids, **KW))
    mesh = make_render_mesh(data=2, prim=4)
    out = np.asarray(S.render_prim_sharded(sd, CAM, W, H, ids, mesh, **KW))
    close = np.isclose(out, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() > 0.995, f"{(~close).sum()} px differ"


def test_prim_sharded_large_scene(rng_np):
    """600-sphere scene sharded over prim axis, compared to brute render."""
    scene = Scene()
    m = scene.add_material("lambert", albedo=(0.6, 0.6, 0.6))
    for i in range(600):
        p = rng_np.uniform(-8, 8, 3)
        p[2] += 12.0
        scene.create_sphere(f"s{i}", tuple(p), float(rng_np.uniform(0.2, 0.5)), m)
    sd = scene.compile(use_bvh=False)
    W = H = 16
    ids = jnp.arange(1)
    kw = dict(max_bounces=2, rr_depth=8, seed=1)
    cam = Camera.look_at((0, 0, -4), (0, 0, 12), fov_degrees=60)
    ref = np.asarray(render_megasample(sd, cam, W, H, ids, **kw))
    mesh = make_render_mesh(data=1, prim=8)
    out = np.asarray(S.render_prim_sharded(sd, cam, W, H, ids, mesh, **kw))
    close = np.isclose(out, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() > 0.99


def test_prim_sharded_gather_matches_single_device():
    """ZeRO-style gather-per-chunk prim sharding ≡ single device."""
    sd = _scene().compile()
    W, H = 24, 24
    ids = jnp.arange(2)
    ref = np.asarray(render_megasample(sd, CAM, W, H, ids, **KW))
    mesh = make_render_mesh(data=2, prim=4)
    out = np.asarray(S.render_prim_sharded_gather(sd, CAM, W, H, ids, mesh,
                                                  **KW))
    close = np.isclose(out, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() > 0.995, f"{(~close).sum()} px differ"


def test_prim_sharded_ring_matches_single_device():
    """The ppermute scene-ring pass (config-5 pattern) ≡ single device."""
    sd = _scene().compile()
    W, H = 24, 24
    ids = jnp.arange(2)
    ref = np.asarray(render_megasample(sd, CAM, W, H, ids, **KW))
    mesh = make_render_mesh(data=2, prim=4)
    out = np.asarray(S.render_prim_sharded_ring(sd, CAM, W, H, ids, mesh,
                                                **KW))
    close = np.isclose(out, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() > 0.995, f"{(~close).sum()} px differ"


def test_prim_sharded_ring_large_scene(rng_np):
    scene = Scene()
    m = scene.add_material("lambert", albedo=(0.6, 0.6, 0.6))
    lamp = scene.add_material("lambert", albedo=(0.8,) * 3,
                              emission=(12.0,) * 3)
    for i in range(600):
        p = rng_np.uniform(-8, 8, 3)
        p[2] += 12.0
        scene.create_sphere(f"s{i}", tuple(p), float(rng_np.uniform(0.2, 0.5)), m)
    scene.create_sphere("lamp", (0, 10, 12), 2.0, lamp)  # NEE exercised
    sd = scene.compile(use_bvh=False)
    W = H = 16
    ids = jnp.arange(1)
    kw = dict(max_bounces=2, rr_depth=8, seed=1)
    cam = Camera.look_at((0, 0, -4), (0, 0, 12), fov_degrees=60)
    ref = np.asarray(render_megasample(sd, cam, W, H, ids, **kw))
    mesh = make_render_mesh(data=1, prim=8)
    out = np.asarray(S.render_prim_sharded_ring(sd, cam, W, H, ids, mesh,
                                                **kw))
    close = np.isclose(out, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() > 0.99


def test_host_axis_mesh():
    """hosts= lays devices host-major with prim groups inside one host."""
    mesh = make_render_mesh(data=4, prim=2, hosts=2)
    assert dict(mesh.shape) == {"data": 4, "prim": 2}
    devs = np.asarray(mesh.devices)
    # Host 0 owns the first 4 devices = first two prim groups (rows 0-1).
    flat = [d.id for d in devs.reshape(-1)]
    assert flat == list(range(8))
    with pytest.raises(ValueError, match="straddle hosts"):
        make_render_mesh(data=2, prim=4, hosts=4)  # 2 chips/host < prim=4
    # Sharded render still matches on a host-shaped mesh.
    sd = _scene().compile()
    W, H = 24, 24
    ids = jnp.arange(1)
    ref = np.asarray(render_megasample(sd, CAM, W, H, ids, **KW))
    out = np.asarray(S.render_prim_sharded_gather(sd, CAM, W, H, ids, mesh,
                                                  **KW))
    close = np.isclose(out, ref, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() > 0.995


def test_dp_grad_step_matches_single_device():
    sd = _scene().compile()
    W = H = 16
    render = G.make_render_fn(sd, CAM, W, H, max_bounces=3)
    params = G.get_params(sd, ("albedo",))
    target = render(params, jnp.arange(4))
    loss_fn = G.make_loss_fn(render, target)

    mesh = make_render_mesh(data=8)
    step = S.make_dp_grad_step(loss_fn, mesh, samples_per_device=1)
    loss_sh, grads_sh = step(params, jnp.int32(0))

    # Single device: average loss/grad over the same 8 sample ids.
    losses, grads = [], []
    for i in range(8):
        l, g = jax.value_and_grad(loss_fn)(params, jnp.asarray([i]))
        losses.append(l)
        grads.append(g)
    loss_ref = np.mean([float(l) for l in losses])
    grad_ref = np.mean([np.asarray(g["albedo"]) for g in grads], axis=0)
    np.testing.assert_allclose(float(loss_sh), loss_ref, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(grads_sh["albedo"]), grad_ref,
                               rtol=1e-4, atol=1e-6)


def test_gather_matches_ring_1k():
    """Gather and ring prim sharding agree at BVH scale (>=1k prims).

    The two strategies order their float operations differently, so a
    knife-edge hit can flip in a rare pixel (an unsharded render
    reproduces the same flip without any sharding); the bound allows 1%."""
    import bench_suite
    from spt_tpu.parallel import sharding as S

    cam = Camera.look_at((0, 0, -10), (0, 0, 60), fov_degrees=65)
    mesh = make_render_mesh(data=1, prim=8)
    kw = dict(max_bounces=2, rr_depth=8, use_nee=False, use_mis=False,
              seed=3)
    sd = bench_suite.scene_10k(1000).compile(use_bvh=False)
    ids = jnp.arange(1)
    g = np.asarray(S.render_prim_sharded_gather(sd, cam, 32, 32, ids, mesh,
                                                **kw))
    r = np.asarray(S.render_prim_sharded_ring(sd, cam, 32, 32, ids, mesh,
                                              **kw))
    assert np.isfinite(g).all() and np.isfinite(r).all()
    close = (np.abs(g - r) < 1e-3 + 1e-2 * np.abs(r)).all(-1)
    assert close.mean() >= 0.99, f"frac_close {close.mean():.4f}"


def _soa_pixel_sharded(sd, cam, W, H, ids, mesh, **kw):
    """SoA integrator under shard_map, rows split over ``data`` with
    global pixel ids (its row_offset/full_height contract)."""
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from spt_tpu.engine.integrator_soa import render_megasample_soa, static_mtypes

    mt = static_mtypes(sd)
    h_loc = H // mesh.shape["data"]

    @partial(shard_map, mesh=mesh, in_specs=(P(), P()), out_specs=P("data"),
             check_vma=False)
    def run(sc, c):
        idx = jax.lax.axis_index("data")
        return render_megasample_soa(sc, c, W, h_loc, ids, mtypes=mt,
                                     row_offset=idx * h_loc, full_height=H,
                                     **kw)

    return jax.jit(run)(sd, cam)


def _soa_sample_sharded(sd, cam, W, H, spd, mesh, **kw):
    """SoA integrator under shard_map, samples split over ``data``."""
    from functools import partial

    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from spt_tpu.engine.integrator_soa import render_megasample_soa, static_mtypes

    mt = static_mtypes(sd)

    @partial(shard_map, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
             check_vma=False)
    def run(sc, c):
        idx = jax.lax.axis_index("data")
        ids = idx * spd + jnp.arange(spd)
        return jax.lax.psum(render_megasample_soa(sc, c, W, H, ids,
                                                  mtypes=mt, **kw), "data")

    return jax.jit(run)(sd, cam)


@pytest.mark.parametrize("integrator", ["aos", "soa"])
@pytest.mark.parametrize("split", ["pixel", "sample"])
def test_four_device_split_matches_single_device(split, integrator):
    """Pixel- and sample-sharded renders on a 4-device mesh == one device,
    for the AoS oracle (parallel.sharding) and the SoA integrator."""
    from spt_tpu.engine.integrator_soa import render_megasample_soa

    sd = _scene().compile()
    W, H = 16, 16
    mesh = make_render_mesh(data=4)
    assert mesh.devices.size == 4
    single = render_megasample if integrator == "aos" else render_megasample_soa
    if split == "pixel":
        ids = jnp.arange(2)
        ref = single(sd, CAM, W, H, ids, **KW)
        if integrator == "aos":
            out = S.render_pixel_sharded(sd, CAM, W, H, ids, mesh, **KW)
        else:
            out = _soa_pixel_sharded(sd, CAM, W, H, ids, mesh, **KW)
    else:
        ref = single(sd, CAM, W, H, jnp.arange(8), **KW)
        if integrator == "aos":
            out = S.render_sample_sharded(sd, CAM, W, H, 2, mesh, **KW)
        else:
            out = _soa_sample_sharded(sd, CAM, W, H, 2, mesh, **KW)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
