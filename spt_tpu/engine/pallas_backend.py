"""Fast forward backend — registers as backend "pallas".

Shares the progressive session/invalidation logic of PathTracerBase; only
the sample function differs.  Routing, from what the backend can observe:

* on a GPU, scenes of at most ``megakernel.MAX_PRIMS`` spheres without an
  environment map go to the Triton megakernel (``kernels/megakernel.py``);
* every other scene, and every scene on another platform, goes to the
  plain-XLA SoA integrator (``integrator_soa.render_megasample_soa``),
  which covers the BVH, environment maps and depth of field;
* "reference" integrator mode uses the pure-JAX reference path (bit-exact
  reference semantics are its contract, not speed).

Reference analog: PathTracer.cpp:9-22 — the factory exists so callers get
the best backend without knowing kernel names.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.scene import SKY_ENVMAP, SceneData
from ..kernels import megakernel
from . import integrator_soa
from .api import JaxPathTracer, camera_has_dof, register_backend


def uses_megakernel(scene: SceneData, platform: str) -> bool:
    """True where the Triton megakernel renders ``scene`` on ``platform``."""
    return (platform == "gpu" and scene.capacity <= megakernel.MAX_PRIMS
            and scene.sky_mode != SKY_ENVMAP)


class PallasPathTracer(JaxPathTracer):
    backend_name = "pallas"

    def _render_samples(self, start_sample: int, spp: int):
        s = self._settings
        if s.integrator == "reference":
            return super()._render_samples(start_sample, spp)
        camera = self._camera or self._default_camera()
        kw = dict(max_bounces=s.max_bounces,
                  rr_depth=s.russian_roulette_depth, use_nee=s.use_nee,
                  use_mis=s.use_mis, seed=s.seed, dof=camera_has_dof(camera))
        sd = self._scene_data
        if uses_megakernel(sd, jax.default_backend()):
            return megakernel.render_tiles(
                sd, camera, s.width, s.height, start_sample, spp, **kw)
        small = sd.capacity <= integrator_soa.SOA_MAX_PRIMS
        if not small and sd.bvh is None:
            # Mid-size scene compiled without a BVH: the SoA integrator
            # needs one, the AoS integrator brute-forces.
            return super()._render_samples(start_sample, spp)
        mtypes = integrator_soa.static_mtypes(sd) if small else None
        key = ("soa", s.static_key(), s.seed, bool(s.progressive), kw["dof"],
               mtypes)
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = jax.jit(lambda sc, cam, ids: integrator_soa.render_megasample_soa(
                sc, cam, s.width, s.height, ids, mtypes=mtypes, **kw))
            self._fn_cache[key] = fn
        return fn(sd, camera, jnp.arange(start_sample, start_sample + spp))


register_backend("pallas", PallasPathTracer)
