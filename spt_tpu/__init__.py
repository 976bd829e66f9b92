"""spt_tpu — a differentiable path tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference C++ renderer (imisumi/software-path-tracer), for NVIDIA GPUs:
SoA wavefront integration, batched all-pairs intersection, flattened BVH,
a Triton forward megakernel, counter-based RNG, materials/NEE/MIS,
path-replay gradients, and multi-device sharding.  See SURVEY.md for the
reference analysis this builds to.
"""

from .core.camera import Camera, ReferenceCamera
from .core.materials import DIELECTRIC, LAMBERT, METAL, MaterialBuilder, MaterialTable
from .core.scene import (NodeType, Scene, SceneData, SceneNode, SphereObject,
                         Transform, demo_scene_38_spheres,
                         SKY_CONSTANT, SKY_GRADIENT, SKY_NONE)
from .core.settings import RenderSettings
from .engine.api import RenderResult, create_path_tracer
from .utils.log import Level, Log, install_console_sink

__version__ = "0.1.0"

__all__ = [
    "Camera", "ReferenceCamera", "DIELECTRIC", "LAMBERT", "METAL",
    "MaterialBuilder", "MaterialTable", "NodeType", "Scene", "SceneData",
    "SceneNode", "SphereObject", "Transform", "demo_scene_38_spheres",
    "SKY_CONSTANT", "SKY_GRADIENT", "SKY_NONE", "RenderSettings",
    "RenderResult", "create_path_tracer", "Level", "Log",
    "install_console_sink",
]
