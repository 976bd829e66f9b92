"""Differentiable rendering: pixel gradients w.r.t. scene parameters.

The reference has no differentiability anywhere; this is the framework's
headline extension (BASELINE.md: finite-difference pixel gradients allclose;
config 4: recover albedo+roughness by gradient descent).

Estimator design: the pure-JAX integrator is differentiated directly.
Because the RNG is stateless and counter-based, every sampling decision is
a *fixed* function of (pixel, sample id, bounce) — so a render with fixed
sample ids is a deterministic, almost-everywhere-differentiable function of
scene parameters, and ``jax.grad`` computes exactly the path-replay
gradient: the backward pass replays the same sampling chain (same uniforms)
and accumulates ∂L/∂θ along it.  Continuous reparametrizations (GGX
roughness, normals, cone light sampling) are differentiated through;
discrete events (hit selection, RR accept, lobe choice) contribute
piecewise-constant factors whose boundary terms are ignored — the standard
interior-term/path-replay estimator.

``SceneParams`` selects which leaves are exposed as optimization variables;
everything else is closed over.  Works under jit, shard_map, and with optax.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..core.scene import SceneData
from ..engine import integrator_jax

PARAM_FIELDS = ("albedo", "emission", "roughness", "ior",
                "centers", "radii", "sky_params")
_MAT_FIELDS = ("albedo", "emission", "roughness", "ior")
_SCENE_FIELDS = ("centers", "radii", "sky_params")


def get_params(scene: SceneData, fields=("albedo", "roughness")) -> dict:
    """Extract an optimizable parameter dict from a compiled scene."""
    out = {}
    for f in fields:
        if f in _MAT_FIELDS:
            out[f] = getattr(scene.materials, f)
        elif f in _SCENE_FIELDS:
            out[f] = getattr(scene, f)
        else:
            raise ValueError(f"unknown param field {f!r}")
    return out


def apply_params(scene: SceneData, params: dict) -> SceneData:
    """Rebuild a SceneData with parameter leaves swapped in (differentiable)."""
    mats = scene.materials
    mat_updates = {k: v for k, v in params.items() if k in _MAT_FIELDS}
    if mat_updates:
        mats = dataclasses.replace(mats, **mat_updates)
    scene_updates = {k: v for k, v in params.items() if k in _SCENE_FIELDS}
    return dataclasses.replace(scene, materials=mats, **scene_updates)


def clip_params(params: dict) -> dict:
    """Project parameters back to their physical domains."""
    out = dict(params)
    if "albedo" in out:
        out["albedo"] = jnp.clip(out["albedo"], 0.0, 1.0)
    if "roughness" in out:
        out["roughness"] = jnp.clip(out["roughness"], 0.02, 1.0)
    if "emission" in out:
        out["emission"] = jnp.maximum(out["emission"], 0.0)
    if "radii" in out:
        out["radii"] = jnp.maximum(out["radii"], 1e-3)
    if "ior" in out:
        out["ior"] = jnp.clip(out["ior"], 1.001, 3.0)
    if "sky_params" in out:
        out["sky_params"] = jnp.maximum(out["sky_params"], 0.0)
    return out


def make_render_fn(scene: SceneData, camera, width: int, height: int, *,
                   max_bounces=4, rr_depth=100, use_nee=True, use_mis=True,
                   seed=0):
    """Returns render(params, sample_ids) -> (H,W,3) mean radiance.

    rr_depth defaults beyond max_bounces: Russian roulette off, because RR
    accept boundaries depend on throughput and would add gradient
    discontinuities for no variance benefit at optimization depths.

    Uses the SoA integrator everywhere its layout applies: static-unroll
    mode for Cornell-class scenes, gather+BVH mode for large ones.  Mid-size
    scenes compiled without a BVH fall back to the AoS brute-force
    integrator.
    """
    from ..core.bvh import refit_bvh
    from ..engine import integrator_soa
    small = scene.capacity <= integrator_soa.SOA_MAX_PRIMS
    use_soa = small or scene.bvh is not None
    mtypes = integrator_soa.static_mtypes(scene) if small else None

    def render(params, sample_ids):
        sc = apply_params(scene, params)
        if sc.bvh is not None and ("centers" in params or "radii" in params):
            # Geometry params move spheres: refit the tree's AABBs
            # (traceable, static topology) so traversal keeps finding them
            # — the build-time tree would silently drop a sphere optimized
            # outside its original box (VERDICT r2 missing #3).
            sc = dataclasses.replace(
                sc, bvh=refit_bvh(sc.bvh, sc.centers, sc.radii))
        if use_soa:
            img = integrator_soa.render_megasample_soa(
                sc, camera, width, height, sample_ids, mtypes=mtypes,
                max_bounces=max_bounces, rr_depth=rr_depth,
                use_nee=use_nee, use_mis=use_mis, seed=seed)
        else:
            img = integrator_jax.render_megasample(
                sc, camera, width, height, sample_ids,
                max_bounces=max_bounces, rr_depth=rr_depth,
                use_nee=use_nee, use_mis=use_mis, seed=seed)
        return img / sample_ids.shape[0]
    return render


def make_loss_fn(render_fn, target):
    """L2 image loss against a target (H,W,3) image."""
    target = jnp.asarray(target)

    def loss(params, sample_ids):
        img = render_fn(params, sample_ids)
        return jnp.mean((img - target) ** 2)
    return loss


@dataclasses.dataclass
class InverseRenderer:
    """Gradient-descent scene-parameter recovery (BASELINE config 4).

    Renders the current parameter estimate, compares to the target image,
    and adams the parameters.  Sample ids rotate per step so the stochastic
    gradient decorrelates across steps while each individual gradient is an
    exact path-replay gradient of its sample set.
    """

    scene: SceneData
    camera: object
    target: jax.Array                 # (H, W, 3)
    fields: tuple = ("albedo", "roughness")
    spp_per_step: int = 8
    learning_rate: float = 0.02
    max_bounces: int = 4
    use_nee: bool = True
    seed: int = 0
    # True: fresh sample ids each step (stochastic gradient, decorrelated).
    # False: reuse ids 0..spp — deterministic loss, monotone convergence;
    # right when the target was rendered with the same ids (self-calibration).
    rotate_samples: bool = True

    def __post_init__(self):
        import optax
        h, w = self.target.shape[:2]
        self.render_fn = make_render_fn(
            self.scene, self.camera, w, h, max_bounces=self.max_bounces,
            use_nee=self.use_nee, seed=self.seed)
        self.loss_fn = make_loss_fn(self.render_fn, self.target)
        self.params = get_params(self.scene, self.fields)
        self.opt = optax.adam(self.learning_rate)
        self.opt_state = self.opt.init(self.params)
        self.step_count = 0

        @jax.jit
        def _step(params, opt_state, sample_ids):
            loss, grads = jax.value_and_grad(self.loss_fn)(params, sample_ids)
            updates, opt_state = self.opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            params = clip_params(params)
            return params, opt_state, loss
        self._step = _step

    def step(self) -> float:
        base = self.step_count * self.spp_per_step if self.rotate_samples else 0
        ids = jnp.arange(base, base + self.spp_per_step)
        self.params, self.opt_state, loss = self._step(
            self.params, self.opt_state, ids)
        self.step_count += 1
        return float(loss)

    def run(self, n_steps: int, log_every: int = 0) -> list:
        from ..utils.log import Log
        losses = []
        for i in range(n_steps):
            losses.append(self.step())
            if log_every and (i + 1) % log_every == 0:
                Log.info(f"inverse render step {i + 1}/{n_steps} "
                         f"loss={losses[-1]:.6f}")
        return losses
