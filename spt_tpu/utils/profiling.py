"""Profiling and render statistics.

The reference's only observability is an ImGui FPS readout (App.cpp:292)
and an aspirational RAII ProfilerBlock design
(architecture-redesign-gameplan.md:1144-1178, MetricsCollector :1424-1468).
Equivalents here: ``jax.profiler`` trace capture for XProf/Perfetto,
named trace annotations around wavefront stages, and a RenderStats
aggregator (rays/s, paths/s, sliding-window frame times).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Optional

import jax


@contextlib.contextmanager
def trace_scope(name: str):
    """Named annotation visible in jax.profiler traces (XProf/Perfetto)."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Capture a device trace to ``log_dir`` for xprof/tensorboard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-time block timer with device sync."""

    def __init__(self, sync=None):
        self._sync = sync
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            jax.block_until_ready(self._sync)
        self.elapsed = time.perf_counter() - self._t0
        return False


class RenderStats:
    """Sliding-window render statistics (the MetricsCollector analog)."""

    def __init__(self, window: int = 64):
        self._frames = deque(maxlen=window)
        self.total_paths = 0
        self.total_rays = 0
        self.total_time = 0.0

    def record(self, seconds: float, n_paths: int,
               n_rays: Optional[int] = None) -> None:
        self._frames.append((seconds, n_paths, n_rays or 0))
        self.total_time += seconds
        self.total_paths += n_paths
        self.total_rays += n_rays or 0

    @property
    def fps(self) -> float:
        if not self._frames:
            return 0.0
        t = sum(f[0] for f in self._frames)
        return len(self._frames) / t if t > 0 else 0.0

    @property
    def paths_per_second(self) -> float:
        t = sum(f[0] for f in self._frames)
        return sum(f[1] for f in self._frames) / t if t > 0 else 0.0

    @property
    def rays_per_second(self) -> float:
        t = sum(f[0] for f in self._frames)
        return sum(f[2] for f in self._frames) / t if t > 0 else 0.0

    def record_occupancy(self, occupancy) -> None:
        """Store the per-bounce active-lane fraction (see
        ``measure_occupancy``)."""
        self.occupancy = [float(x) for x in occupancy]

    def summary(self) -> dict:
        out = {"fps": self.fps, "paths_per_s": self.paths_per_second,
               "rays_per_s": self.rays_per_second,
               "total_paths": self.total_paths,
               "total_time_s": self.total_time}
        if getattr(self, "occupancy", None) is not None:
            out["occupancy_per_bounce"] = self.occupancy
        return out


def measure_occupancy(scene_data, camera, width: int, height: int, *,
                      spp: int = 8, max_bounces: int = 8, rr_depth: int = 3,
                      use_nee: bool = True, use_mis: bool = True,
                      seed: int = 0) -> list:
    """Per-bounce active-lane fraction of the wavefront (list of floats).

    Bounce k's entry records how many lanes still carry a live ray; the
    tail fractions are exactly the wasted lane work a compaction pass would
    reclaim — the measurement that motivates (or kills) pipeline-
    parallel / compaction designs (SURVEY.md §2.4 PP row).
    """
    import jax
    import jax.numpy as jnp
    from ..engine.integrator_soa import render_megasample_soa, static_mtypes

    mt = static_mtypes(scene_data) if scene_data.capacity <= 128 else None
    fn = jax.jit(lambda sc, ids: render_megasample_soa(
        sc, camera, width, height, ids, mtypes=mt, max_bounces=max_bounces,
        rr_depth=rr_depth, use_nee=use_nee, use_mis=use_mis, seed=seed,
        with_occupancy=True)[2])
    occ = fn(scene_data, jnp.arange(spp))
    return [float(x) for x in occ]
