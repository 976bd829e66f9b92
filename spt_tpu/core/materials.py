"""Material system.

The reference has *no* material system in its live path — every surface uses
a fixed 0.7 albedo Lambertian (CPUPathTracer.cpp:260); a material node type
exists only as an enum value (Scene.h:19-24) and the dead ``#elif`` design
sketches a real material store (Scene.h:229-353).  This module builds the
real thing as a flat SoA *material table* — one row per material,
integer material ids on primitives — so shading is branchless gather +
select over the whole wavefront (no per-ray virtual dispatch).

Material model (evaluated in materials/shading code in the integrators):
  LAMBERT     — albedo/π diffuse, cosine-sampled.
  METAL       — GGX conductor, Schlick F with f0 = albedo.
  DIELECTRIC  — smooth glass, exact Fresnel, reflect/refract, tint = albedo.
  Any material may also emit (emission > 0) — emitters drive NEE.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

LAMBERT = 0
METAL = 1
DIELECTRIC = 2

_TYPE_NAMES = {"lambert": LAMBERT, "diffuse": LAMBERT,
               "metal": METAL, "ggx": METAL,
               "dielectric": DIELECTRIC, "glass": DIELECTRIC}


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["albedo", "emission", "roughness", "ior", "mtype"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """SoA material table; all arrays share leading dim M (num materials)."""

    albedo: jax.Array     # (M, 3) f32 — diffuse albedo / metal f0 / glass tint
    emission: jax.Array   # (M, 3) f32 — radiant exitance (emitted radiance)
    roughness: jax.Array  # (M,)  f32 — GGX perceptual roughness
    ior: jax.Array        # (M,)  f32 — dielectric index of refraction
    mtype: jax.Array      # (M,)  i32 — LAMBERT / METAL / DIELECTRIC

    @property
    def num_materials(self) -> int:
        return self.albedo.shape[0]

    def gather(self, mat_id):
        """Gather per-ray material rows for an int array of material ids."""
        return (self.albedo[mat_id], self.emission[mat_id],
                self.roughness[mat_id], self.ior[mat_id], self.mtype[mat_id])


class MaterialBuilder:
    """Host-side accumulation of materials into a MaterialTable."""

    def __init__(self):
        self._rows: list[tuple] = []

    def add(self, kind: str = "lambert", albedo=(0.7, 0.7, 0.7),
            emission=(0.0, 0.0, 0.0), roughness: float = 0.5,
            ior: float = 1.5) -> int:
        mtype = _TYPE_NAMES[kind.lower()]
        idx = len(self._rows)
        self._rows.append((tuple(albedo), tuple(emission), float(roughness),
                           float(ior), mtype))
        return idx

    def build(self) -> MaterialTable:
        if not self._rows:
            self.add()  # default 0.7 Lambertian (the reference's one material)
        albedo = np.array([r[0] for r in self._rows], np.float32)
        emission = np.array([r[1] for r in self._rows], np.float32)
        roughness = np.array([r[2] for r in self._rows], np.float32)
        ior = np.array([r[3] for r in self._rows], np.float32)
        mtype = np.array([r[4] for r in self._rows], np.int32)
        return MaterialTable(
            albedo=jnp.asarray(albedo), emission=jnp.asarray(emission),
            roughness=jnp.asarray(roughness), ior=jnp.asarray(ior),
            mtype=jnp.asarray(mtype))


def default_table() -> MaterialTable:
    """The reference's implicit material: 0.7 gray Lambertian for everything."""
    b = MaterialBuilder()
    b.add("lambert", albedo=(0.7, 0.7, 0.7))
    return b.build()
