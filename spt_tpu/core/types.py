"""POD-style batch types: SoA rays, hits, render requests.

The reference declares AoS PODs — ``Ray {origin, direction}``, float-pixel
``RenderResult``, ``RenderRequest`` (/root/reference/libs/render/include/
render/Types.h:11-40; all dead code there, live here).  The forms here
are SoA batches: a ``RayBatch`` is arrays of components, not an array of
structs, so every field is one contiguous array.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.tree_util.register_dataclass,
         data_fields=["origin", "direction"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class RayBatch:
    """SoA ray bundle: origin/direction are (N, 3) f32."""

    origin: jax.Array
    direction: jax.Array

    @property
    def count(self) -> int:
        return self.origin.shape[0]

    def at(self, t):
        """Points origin + t*direction; t is (N,) or scalar."""
        return self.origin + jnp.asarray(t)[..., None] * self.direction


@partial(jax.tree_util.register_dataclass,
         data_fields=["t", "prim_id", "position", "normal"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class HitBatch:
    """SoA hit records: t (N,), prim_id (N,) i32 (-1 = miss), position and
    geometric normal (N, 3)."""

    t: jax.Array
    prim_id: jax.Array
    position: jax.Array
    normal: jax.Array

    @property
    def mask(self):
        return self.prim_id >= 0


@dataclasses.dataclass
class RenderRequest:
    """Host-side render request (Types.h:34-40's analog): what to render."""

    width: int = 512
    height: int = 512
    samples_per_pixel: int = 64
    start_sample: int = 0
    tile: tuple = None  # (x0, y0, w, h) or None for the full frame
