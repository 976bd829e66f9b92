"""BVH refit under geometry parameter updates (VERDICT r2 missing #3).

A sphere optimized outside its build-time AABB must stay hittable.  The
reference rebuilds its acceleration structure on every scene edit
(/root/reference/libs/render/src/engines/pathtracer/backends/cpu/
CPUPathTracer.cpp:374-403); under jax.grad a rebuild isn't traceable, so
the differentiable path refits node AABBs over the static topology
(core/bvh.refit_bvh wired into diff/gradients.make_render_fn).

It is pinned against a FRESH compile of the moved scene (image and
gradients) — without the refit these renders silently miss the moved
sphere.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import spt_tpu
from spt_tpu import Camera, Scene
from spt_tpu.core.bvh import build_bvh, refit_bvh
from spt_tpu.diff import gradients as G

CAM = Camera.look_at((0, 0, -10), (0, 0, 60), fov_degrees=65)


def _scene(n=40, seed=3):
    from bench_suite import scene_10k
    return scene_10k(n, seed=seed)


DENSE_CAM = Camera.look_at((0, 0.5, -1.5), (0, 0.5, 5.0), fov_degrees=60)


def _dense_scene(n, seed=5):
    """Spheres packed INSIDE the camera frustum + a floor: primary hits are
    guaranteed at any resolution (the sparse scene_10k cloud covers ~0% of
    an 8x6 image, which made every geometry gradient legitimately zero)."""
    rng = np.random.default_rng(seed)
    sc = Scene()
    sc.set_sky(spt_tpu.SKY_GRADIENT)
    m = sc.add_material("lambert", albedo=(0.6, 0.5, 0.45))
    m2 = sc.add_material("lambert", albedo=(0.3, 0.55, 0.7))
    sc.create_sphere("floor", (0, -1000, 5), 999.5, m)
    for i in range(n):
        p = (float(rng.uniform(-3, 3)), float(rng.uniform(-0.2, 2.5)),
             float(5 + rng.uniform(-1.5, 1.5)))
        sc.create_sphere(f"s{i}", p, 0.5, m if i % 2 else m2)
    return sc


def _moved_centers(sd, k=1, factor=4.0):
    """Move sphere ``k`` by factor x its radius along +x (outside its
    build-time AABB)."""
    c = np.asarray(sd.centers).copy()
    c[k, 0] += factor * float(np.asarray(sd.radii)[k])
    return jnp.asarray(c)


def _shifted_centers(sd, dx=2.5):
    """Shift EVERY sphere by +dx (most leave their build-time AABBs, and
    the image change is guaranteed visible at any resolution)."""
    c = np.asarray(sd.centers).copy()
    c[:, 0] += dx
    return jnp.asarray(c)


def test_refit_bvh_traversal_matches_fresh_build():
    """intersect via refit tree == intersect via a fresh tree (same rays)."""
    from spt_tpu.core.bvh import intersect_bvh_soa

    sd = _scene(60).compile(use_bvh=True)
    moved = _moved_centers(sd, k=7, factor=6.0)
    refit = refit_bvh(sd.bvh, moved, sd.radii)
    fresh = build_bvh(np.asarray(moved), np.asarray(sd.radii),
                      valid=np.asarray(sd.prim_valid))

    rng = np.random.default_rng(0)
    n = 512
    o = rng.uniform(-45, -20, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2]) + 0.3  # aim toward the cloud
    args = [jnp.asarray(v) for v in
            (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]
    cx, cy, cz = moved[:, 0], moved[:, 1], moved[:, 2]
    t_r, id_r = intersect_bvh_soa(*args, cx, cy, cz, sd.radii, refit)
    t_f, id_f = intersect_bvh_soa(*args, cx, cy, cz, sd.radii, fresh)
    np.testing.assert_allclose(np.asarray(t_r), np.asarray(t_f),
                               rtol=1e-5, atol=1e-5)
    assert (np.asarray(id_r) == np.asarray(id_f)).mean() > 0.999


# 200 prims: capacity 256 > SOA_MAX_PRIMS routes make_render_fn to the
# gather+BVH SoA mode — the configuration where the refit actually gates
# intersection (the <=128 static-unroll mode never reads the tree), and
# far cheaper to trace than a 64-sphere unroll (the r3 test-time hog).
# One bounce, no NEE, 8x6 pixels: the refit wiring is what's under test;
# the tree math itself is pinned by test_refit_bvh_traversal above.
def test_soa_render_fn_refits_under_moved_centers():
    """make_render_fn(params with moved centers) == fresh compile render."""
    sd = _dense_scene(130).compile(use_bvh=True)
    moved = _shifted_centers(sd)
    render = G.make_render_fn(sd, DENSE_CAM, 8, 6, max_bounces=2,
                              use_nee=False, seed=1)
    ids = jnp.arange(1)
    img = np.asarray(render({"centers": moved}, ids))

    sd2 = _dense_scene(130).compile(use_bvh=True)
    sd2 = dataclasses.replace(sd2, centers=moved,
                              bvh=build_bvh(np.asarray(moved),
                                            np.asarray(sd2.radii),
                                            valid=np.asarray(sd2.prim_valid)))
    render2 = G.make_render_fn(sd2, DENSE_CAM, 8, 6, max_bounces=2,
                               use_nee=False, seed=1)
    img2 = np.asarray(render2({}, ids))
    np.testing.assert_allclose(img, img2, rtol=1e-4, atol=1e-5)
    # Sanity: the move is actually visible (stale-tree render would differ).
    img_stale = np.asarray(render({}, ids))
    assert np.abs(img - img_stale).max() > 1e-3


def test_soa_gradients_flow_to_moved_spheres():
    """d loss / d centers is finite and nonzero after the shift (the stale
    tree would zero out every sphere that left its box)."""
    sd = _dense_scene(130).compile(use_bvh=True)
    moved = _shifted_centers(sd)
    render = G.make_render_fn(sd, DENSE_CAM, 8, 6, max_bounces=2,
                              use_nee=False, seed=1)
    ids = jnp.arange(1)

    def loss(c):
        return jnp.sum(render({"centers": c}, ids))

    g = np.asarray(jax.grad(loss)(moved))
    assert np.isfinite(g).all()
    assert (np.abs(g).max(axis=1) > 0.0).sum() >= 3, \
        "moved spheres invisible to gradients (stale BVH?)"
