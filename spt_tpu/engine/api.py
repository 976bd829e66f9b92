"""Engine facade: the PathTracer contract + backend factory.

Mirrors the reference's public engine API
(/root/reference/libs/render/include/render/PathTracer.h:13-51 — pure-virtual
``render()``, scene/settings injection, ``get_render_result()``, backend
name/type, and the static factory ``create_path_tracer(BackendType)``,
PathTracer.cpp:9-22) and its progressive invalidation protocol
(CPUPathTracer.cpp:119-161):

  * scene dirty      -> reset accumulation, recompile scene buffers
  * settings dirty   -> reset accumulation
  * resolution change-> reallocate + reset
  * frame_count == 0 -> zero the accumulation buffer

Backends: ``"jax"`` (pure-JAX wavefront integrator — differentiable oracle)
and ``"pallas"`` (Triton megakernel / SoA integrator, engine/pallas_backend).
Both share this session logic; they
differ only in the jitted sample function.  Unknown backends raise, matching
the reference factory's throw (PathTracer.cpp:19-20).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp

from ..core import color
from ..core.camera import Camera, ReferenceCamera
from ..core.scene import Scene, SceneData
from ..core.settings import RenderSettings
from ..utils.log import Log
from . import integrator_jax


@dataclasses.dataclass
class RenderResult:
    """Mirrors PathTracer::RenderResult (PathTracer.h:23-28) + float image."""

    image_buffer: jax.Array  # (H, W) uint32 RGBA8888, R in high byte
    width: int
    height: int
    image_f32: jax.Array     # (H, W, 3) float display image in [0, 1]


class PathTracerBase:
    """Backend-agnostic progressive render session."""

    backend_name = "base"

    def __init__(self):
        self._scene: Optional[Scene] = None
        self._scene_data: Optional[SceneData] = None
        self._settings = RenderSettings()
        self._camera: Optional[Camera] = None
        self._accum: Optional[jax.Array] = None  # (H, W, 3) f32 radiance sum
        self._frame_count: int = 0               # samples accumulated so far
        self._accum_shape = (0, 0)
        self._fn_cache: Dict[tuple, Callable] = {}

    # -- the PathTracer contract -------------------------------------------
    def set_scene(self, scene: Scene) -> None:
        self._scene = scene

    def set_settings(self, settings: RenderSettings) -> None:
        self._settings = settings

    def get_settings(self) -> RenderSettings:
        return self._settings

    def set_camera(self, camera: Camera) -> None:
        self._camera = camera
        self.reset_accumulation()

    def get_backend_name(self) -> str:
        return self.backend_name

    def reset_accumulation(self) -> None:
        self._frame_count = 0

    @property
    def frame_count(self) -> int:
        return self._frame_count

    @property
    def scene_data(self) -> Optional[SceneData]:
        return self._scene_data

    # -- invalidation protocol (CPUPathTracer.cpp:119-161) ------------------
    def _invalidate(self) -> None:
        s = self._settings
        if self._scene is None:
            raise RuntimeError("Scene not set before rendering")
        needs_rebuild = self._scene_data is None
        if self._scene.has_changes():
            self._frame_count = 0
            needs_rebuild = True
        if s.is_dirty():
            self._frame_count = 0
            s.clear_dirty()
        if self._accum_shape != (s.height, s.width):
            self._accum_shape = (s.height, s.width)
            self._accum = jnp.zeros((s.height, s.width, 3), jnp.float32)
            self._frame_count = 0
        if self._frame_count == 0:
            self._accum = jnp.zeros((s.height, s.width, 3), jnp.float32)
        if needs_rebuild:
            capacity = None
            if self._scene_data is not None:
                # Keep the capacity bucket if it still fits: scene edits then
                # re-upload buffers without recompiling the render step.
                live = sum(1 for n in self._scene.get_all_nodes().values()
                           if n.node_type == 1)
                if live <= self._scene_data.capacity:
                    capacity = self._scene_data.capacity
            self._scene_data = self._scene.compile(capacity=capacity)
            self._scene.mark_changes_processed()
            Log.info(f"Recompiled scene: {self._scene_data.num_prims} prims, "
                     f"{self._scene_data.num_lights} lights, "
                     f"capacity {self._scene_data.capacity}")

    # -- rendering ----------------------------------------------------------
    def render(self, spp: Optional[int] = None) -> None:
        """Trace one progressive chunk (default: 1 spp progressive, matching
        the reference's render-per-frame model; or all spp when
        progressive=False)."""
        self._invalidate()
        s = self._settings
        if spp is None:
            spp = 1 if s.progressive else s.samples_per_pixel
        start = self._frame_count
        chunk = self._render_samples(start, spp)
        self._accum = self._accum + chunk
        self._frame_count += spp

    def render_to_completion(self, chunk_spp: Optional[int] = None) -> None:
        """Accumulate until samples_per_pixel is reached.

        Progressive sessions advance in fixed-size chunks (default 32) so
        intermediate results exist and the sample kernel is compiled for at
        most two distinct spp values (the chunk and the final remainder);
        non-progressive sessions render everything in one launch.
        """
        self._invalidate()
        target = self._settings.samples_per_pixel
        if chunk_spp is None:
            chunk_spp = 32 if self._settings.progressive else max(target, 1)
        while self._frame_count < target:
            self.render(spp=min(chunk_spp, target - self._frame_count))

    def _render_samples(self, start_sample: int, spp: int) -> jax.Array:
        raise NotImplementedError

    def get_render_result(self) -> RenderResult:
        assert self._frame_count > 0, "No frames rendered yet"
        s = self._settings
        img = color.finalize_image(
            self._accum, self._frame_count, exposure=s.exposure,
            tonemap=s.tonemap, gamma=s.gamma, auto_exposure=s.auto_exposure,
            target_exposure=s.target_exposure)
        return RenderResult(
            image_buffer=color.pack_rgba8(img),
            width=s.width, height=s.height, image_f32=img)

    # -- checkpoint of progressive state (SURVEY.md §5 checkpoint/resume) ---
    def get_state(self) -> dict:
        return {"accum": self._accum, "frame_count": self._frame_count}

    def set_state(self, state: dict) -> None:
        self._invalidate()
        self._accum = jnp.asarray(state["accum"])
        self._accum_shape = tuple(self._accum.shape[:2])
        self._frame_count = int(state["frame_count"])


class JaxPathTracer(PathTracerBase):
    """Pure-JAX backend — the differentiable reference implementation."""

    backend_name = "jax"

    def _default_camera(self) -> Camera:
        return Camera.look_at((0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
                              fov_degrees=90.0)

    def _render_samples(self, start_sample: int, spp: int) -> jax.Array:
        s = self._settings
        if s.integrator == "reference":
            key = ("ref", s.width, s.height)
            fn = self._fn_cache.get(key)
            if fn is None:
                fn = jax.jit(lambda sc, frame: integrator_jax.render_reference_sample(
                    sc, s.width, s.height, frame))
                self._fn_cache[key] = fn
            out = jnp.zeros((s.height, s.width, 3), jnp.float32)
            for f in range(start_sample, start_sample + spp):
                out = out + fn(self._scene_data, f)
            return out

        camera = self._camera or self._default_camera()
        dof = camera_has_dof(camera)
        key = ("full", s.static_key(), s.seed, bool(s.progressive), dof)
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = jax.jit(partial_megasample(s, dof=dof))
            self._fn_cache[key] = fn
        sample_ids = jnp.arange(start_sample, start_sample + spp)
        return fn(self._scene_data, camera, sample_ids)


def camera_has_dof(camera) -> bool:
    """Thin-lens iff the camera has a real aperture (host-known value)."""
    ap = getattr(camera, "aperture", None)
    return ap is not None and float(ap) > 0.0


def partial_megasample(s: RenderSettings, dof: bool = False):
    """Bind static settings into the megasample integrator."""
    def fn(scene_data, camera, sample_ids):
        return integrator_jax.render_megasample(
            scene_data, camera, s.width, s.height, sample_ids,
            max_bounces=s.max_bounces, rr_depth=s.russian_roulette_depth,
            use_nee=s.use_nee, use_mis=s.use_mis, seed=s.seed, dof=dof)
    return fn


_BACKENDS: Dict[str, type] = {}


def register_backend(name: str, cls: type) -> None:
    _BACKENDS[name] = cls


register_backend("jax", JaxPathTracer)


def create_path_tracer(backend: str = "jax") -> PathTracerBase:
    """Backend factory — the analog of PathTracer::create_path_tracer
    (PathTracer.cpp:9-22); raises on unknown backends as the reference
    throws."""
    # Late import so the pallas backend registers itself.
    if backend == "pallas" and "pallas" not in _BACKENDS:
        from . import pallas_backend  # noqa: F401
    if backend not in _BACKENDS:
        raise ValueError(f"Unsupported backend type: {backend!r} "
                         f"(available: {sorted(_BACKENDS)})")
    tracer = _BACKENDS[backend]()
    Log.info(f"Created path tracer backend '{backend}'")
    return tracer
