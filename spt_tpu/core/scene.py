"""Scene graph and its device-side compiled form.

The host-side graph mirrors the reference's API surface
(/root/reference/libs/render/include/render/Scene.h:16-227): integer
``NodeID``s from a global counter, ``NodeType`` enum, ``Transform``
(position / quaternion rotation / scale, with the same composition rule:
``a * b`` adds positions and multiplies rotations — Scene.h:49-56),
``SceneNode`` / ``SphereObject``, and a ``Scene`` registry with
``create_node`` / ``delete_node`` / ``find_node`` / ``get_all_nodes`` and a
coarse ``has_changes`` dirty bit (Scene.h:207-215).  Extensions over the
reference: per-node material ids, named materials via MaterialBuilder, sky
configuration, and emissive-sphere area lights (the dead ``#elif`` design the
reference never compiled — Scene.h:229-353 — realized here).

``Scene.compile()`` lowers the graph to ``SceneData`` — flat SoA device
arrays (the analog of the reference's per-sphere Embree geometry
rebuild, CPUPathTracer.cpp:328-404): sphere centers/radii/material ids padded
to a static size, the material table, light index list, and sky parameters.
Static padding keeps XLA shapes stable across scene edits of the same
capacity bucket, so edits re-upload buffers without recompiling the render
step.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .bvh import BVH, build_bvh
from .materials import MaterialBuilder, MaterialTable, default_table

# Scenes larger than this get a BVH at compile time; smaller ones use the
# brute-force all-primitive test.  Not measured on a GPU yet.
BVH_AUTO_THRESHOLD = 512

# Sky modes.
SKY_NONE = 0
SKY_GRADIENT = 1   # the reference's sample_sky (CPUPathTracer.cpp:286-292)
SKY_CONSTANT = 2
SKY_ENVMAP = 3   # equirectangular HDR environment map (IBL)


class NodeType(IntEnum):
    """Mirrors render::NodeType (Scene.h:19-24)."""
    SCENE_ROOT = 0
    SPHERE_OBJECT = 1
    MATERIAL = 2
    GROUP = 3


def _quat_mul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return (
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    )


@dataclasses.dataclass
class Transform:
    """Position / rotation(quat wxyz) / scale, matching Scene.h:26-57."""

    position: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (1.0, 0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)

    def __mul__(self, other: "Transform") -> "Transform":
        # Reference composition: positions add, rotations multiply, scales
        # multiply componentwise (Scene.h:49-56).
        return Transform(
            position=tuple(a + b for a, b in zip(self.position, other.position)),
            rotation=_quat_mul(self.rotation, other.rotation),
            scale=tuple(a * b for a, b in zip(self.scale, other.scale)),
        )


class SceneNode:
    """Base node: id, name, type, local transform (Scene.h:59-121)."""

    def __init__(self, name: str = "", node_type: NodeType = NodeType.GROUP):
        self.id: int = 0  # assigned by Scene.create_node
        self.name = name
        self.node_type = node_type
        self.transform = Transform()
        self._scene: Optional["Scene"] = None

    # Reference-style accessors.
    def get_id(self) -> int:
        return self.id

    def get_name(self) -> str:
        return self.name

    def get_type(self) -> NodeType:
        return self.node_type

    def set_position(self, x, y, z) -> None:
        self.transform.position = (float(x), float(y), float(z))
        if self._scene is not None:
            self._scene.mark_changed()

    def get_position(self) -> tuple:
        return self.transform.position


class SphereObject(SceneNode):
    """Sphere primitive node (Scene.h:123-133) + material binding."""

    def __init__(self, name: str = "sphere", radius: float = 1.0,
                 material: int = 0):
        super().__init__(name, NodeType.SPHERE_OBJECT)
        self.radius = float(radius)
        self.material = int(material)

    def get_radius(self) -> float:
        return self.radius

    def set_radius(self, r: float) -> None:
        self.radius = float(r)
        if self._scene is not None:
            self._scene.mark_changed()


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["centers", "radii", "mat_id", "prim_valid", "materials",
                 "light_idx", "light_valid", "sky_params", "bvh", "env_map"],
    meta_fields=["num_prims", "num_lights", "sky_mode"],
)
@dataclasses.dataclass(frozen=True)
class SceneData:
    """Compiled device scene: flat SoA arrays, statically padded.

    The replacement for the reference's Embree scene commit
    (CPUPathTracer.cpp:328-404).  ``prim_valid`` masks padding lanes so the
    capacity bucket (next power of two) — not the live count — sets XLA
    shapes.
    """

    centers: jax.Array     # (P, 3) f32
    radii: jax.Array       # (P,)  f32
    mat_id: jax.Array      # (P,)  i32
    prim_valid: jax.Array  # (P,)  bool
    materials: MaterialTable
    light_idx: jax.Array    # (L,) i32 — prim indices of emissive spheres
    light_valid: jax.Array  # (L,) bool
    sky_params: jax.Array   # (2, 3) f32 — [horizon/constant color, zenith color]
    bvh: Optional[BVH]      # None for small scenes (brute-force wins there)
    env_map: Optional[jax.Array]  # (He, We, 3) f32 equirect radiance or None
    num_prims: int          # static live prim count (python int)
    num_lights: int
    sky_mode: int

    @property
    def capacity(self) -> int:
        return self.centers.shape[0]


def _pad_pow2(n: int, minimum: int = 8) -> int:
    c = minimum
    while c < n:
        c *= 2
    return c


class Scene:
    """Node registry with the reference's dirty protocol (Scene.h:135-227)."""

    def __init__(self):
        self._nodes: Dict[int, SceneNode] = {}
        self._next_id = 1  # SceneNode::s_nextID starts at 1 (Scene.cpp:8)
        self._has_changes = True  # scenes start dirty (Scene.h:144)
        self.materials = MaterialBuilder()
        self.sky_mode = SKY_GRADIENT
        # The reference's gradient: horizon white -> zenith light blue
        # (CPUPathTracer.cpp:288-291).
        self.sky_horizon = (1.0, 1.0, 1.0)
        self.sky_zenith = (0.5, 0.7, 1.0)
        self.env_map = None  # (He, We, 3) float radiance, equirectangular
        self.env_map_path = None  # source file of env_map, if loaded from one

    # -- node management ----------------------------------------------------
    def create_node(self, node: SceneNode) -> SceneNode:
        node.id = self._next_id
        self._next_id += 1
        node._scene = self
        self._nodes[node.id] = node
        self._has_changes = True
        return node

    def create_sphere(self, name="sphere", position=(0.0, 0.0, 0.0),
                      radius=1.0, material=0) -> SphereObject:
        sphere = SphereObject(name, radius, material)
        self.create_node(sphere)
        sphere.set_position(*position)
        return sphere

    def delete_node(self, node_id: int) -> bool:
        if node_id in self._nodes:
            self._nodes.pop(node_id)._scene = None
            self._has_changes = True
            return True
        return False

    def find_node(self, key) -> Optional[SceneNode]:
        """Find by id (int) or by name (str) — Scene.h:180-199."""
        if isinstance(key, int):
            return self._nodes.get(key)
        for node in self._nodes.values():
            if node.name == key:
                return node
        return None

    def get_all_nodes(self) -> Dict[int, SceneNode]:
        return dict(self._nodes)

    # -- materials / sky ----------------------------------------------------
    def add_material(self, kind="lambert", **kwargs) -> int:
        self._has_changes = True
        return self.materials.add(kind, **kwargs)

    def set_sky(self, mode=SKY_GRADIENT, horizon=None, zenith=None):
        self.sky_mode = mode
        if horizon is not None:
            self.sky_horizon = tuple(horizon)
        if zenith is not None:
            self.sky_zenith = tuple(zenith)
        self._has_changes = True

    def set_environment_map(self, image, path: Optional[str] = None) -> None:
        """Image-based lighting from an equirectangular radiance map
        (the capability the reference sketched in dead code —
        Scene.cpp:124-169 — but never shipped).  ``path`` records the
        source file so scene serialization can reference it."""
        self.env_map = np.asarray(image, np.float32)
        if self.env_map.ndim != 3 or self.env_map.shape[2] != 3:
            raise ValueError("environment map must be (H, W, 3)")
        self.sky_mode = SKY_ENVMAP
        self.env_map_path = path
        self._has_changes = True

    # -- dirty protocol (Scene.h:207-215) ------------------------------------
    def has_changes(self) -> bool:
        return self._has_changes

    def mark_changed(self) -> None:
        self._has_changes = True

    def mark_changes_processed(self) -> None:
        self._has_changes = False

    # -- compile to device --------------------------------------------------
    def compile(self, capacity: Optional[int] = None,
                light_capacity: Optional[int] = None,
                use_bvh: Optional[bool] = None) -> SceneData:
        spheres = [n for n in self._nodes.values()
                   if n.node_type == NodeType.SPHERE_OBJECT]
        spheres.sort(key=lambda n: n.id)  # deterministic order
        n = len(spheres)
        cap = capacity or _pad_pow2(max(n, 1))
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} spheres")

        centers = np.zeros((cap, 3), np.float32)
        radii = np.zeros((cap,), np.float32)
        mat_id = np.zeros((cap,), np.int32)
        valid = np.zeros((cap,), bool)
        for i, s in enumerate(spheres):
            centers[i] = s.transform.position
            # Nonuniform scale of a sphere is out of scope (as in the
            # reference); uniform scale multiplies the radius.
            radii[i] = s.radius * float(s.transform.scale[0])
            mat_id[i] = s.material
            valid[i] = True

        materials = self.materials.build() if self.materials._rows else default_table()
        emission = np.asarray(materials.emission)
        is_light = valid & (emission[np.asarray(mat_id)].sum(-1) > 0.0)
        light_indices = np.nonzero(is_light)[0].astype(np.int32)
        nl = len(light_indices)
        lcap = light_capacity or _pad_pow2(max(nl, 1), minimum=4)
        light_idx = np.zeros((lcap,), np.int32)
        light_valid = np.zeros((lcap,), bool)
        light_idx[:nl] = light_indices
        light_valid[:nl] = True

        sky_params = np.array([self.sky_horizon, self.sky_zenith], np.float32)

        if use_bvh is None:
            use_bvh = n > BVH_AUTO_THRESHOLD
        bvh = build_bvh(centers, radii, valid=valid) if use_bvh else None
        env_map = jnp.asarray(self.env_map) if self.env_map is not None else None

        return SceneData(
            centers=jnp.asarray(centers), radii=jnp.asarray(radii),
            mat_id=jnp.asarray(mat_id), prim_valid=jnp.asarray(valid),
            materials=materials,
            light_idx=jnp.asarray(light_idx),
            light_valid=jnp.asarray(light_valid),
            sky_params=jnp.asarray(sky_params),
            bvh=bvh, env_map=env_map,
            num_prims=n, num_lights=nl, sky_mode=self.sky_mode,
        )


def demo_scene_38_spheres() -> Scene:
    """The reference app's demo scene (/root/reference/src/App.cpp:101-122).

    Sphere r=1 at (0,−1,5); ground sphere r=100 at (0,−102,5); 6×6 grid of
    r=0.5 spheres at x,y ∈ {−5,−3,−1,1,3,5}, z=10 — 38 spheres total.
    """
    scene = Scene()
    m = scene.add_material("lambert", albedo=(0.7, 0.7, 0.7))
    scene.create_sphere("sphere", (0.0, -1.0, 5.0), 1.0, m)
    scene.create_sphere("ground", (0.0, -102.0, 5.0), 100.0, m)
    for ix, x in enumerate((-5.0, -3.0, -1.0, 1.0, 3.0, 5.0)):
        for iy, y in enumerate((-5.0, -3.0, -1.0, 1.0, 3.0, 5.0)):
            scene.create_sphere(f"grid_{ix}_{iy}", (x, y, 10.0), 0.5, m)
    return scene
