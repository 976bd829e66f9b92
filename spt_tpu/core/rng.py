"""Random number generation for the path tracer.

Two RNG disciplines live here:

1. ``ref_*`` — a bit-exact JAX reimplementation of the reference renderer's
   stateful per-pixel hash RNG (a PCG-style hash; see
   /root/reference/libs/render/src/engines/pathtracer/backends/cpu/CPUPathTracer.cpp:192-301
   for the behavior being reproduced: seed = x + y*width + frame*982451653,
   stream advance = LCG + variable xorshift + multiply + xorshift, output in
   [0, 1]).  All arithmetic is uint32 with wraparound, so the JAX version
   produces *identical* u32 streams to the C++ one — this is what makes
   golden-image parity tests against the reference semantics meaningful.

2. ``counter_*`` — the framework's native *stateless*, counter-based RNG.
   Every sampling site derives its uniform from
   ``(pixel_id, sample_id, bounce, dim, seed)``, so forward rendering and
   path-replay backward consume identical streams regardless of device
   sharding, vectorization order, or backend (pure-JAX vs Pallas — the same
   integer ops run in both).  This replaces the reference's stateful RNG the
   data-parallel way: no sequential state to thread, embarrassingly
   parallel.

All functions are plain jnp uint32/float32 ops — usable inside jit, vmap,
shard_map, and Pallas kernels alike.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Constants of the reference's hash chain (public-domain PCG-hash constants).
_REF_SEED_PRIME = np.uint32(982451653)
_LCG_MUL = np.uint32(747796405)
_LCG_INC = np.uint32(2891336453)
_PCG_MUL = np.uint32(277803737)

# The reference divides by the *f32 rounding* of 4294967295.0f, which is
# exactly 2**32.  Keeping the same literal keeps the same rounding.
_INV_U32_MAX = np.float32(np.float32(1.0) / np.float32(4294967295.0))


def ref_seed(x, y, width, frame):
    """Per-pixel seed, bit-exact with the reference.

    Mirrors ``get_rng_state`` (CPUPathTracer.cpp:192-195):
    ``x + y*width + frame*982451653`` in wrapping uint32.
    """
    x = jnp.asarray(x, jnp.uint32)
    y = jnp.asarray(y, jnp.uint32)
    width = jnp.asarray(width, jnp.uint32)
    frame = jnp.asarray(frame, jnp.uint32)
    return x + y * width + frame * _REF_SEED_PRIME


def ref_next(state):
    """One step of the reference's stateful RNG.

    Returns ``(new_state, uniform_f32)`` with the exact integer pipeline of
    ``random_float`` (CPUPathTracer.cpp:294-301):

        state  = state*747796405 + 2891336453
        r      = ((state >> ((state >> 28) + 4)) ^ state) * 277803737
        r      = (r >> 22) ^ r
        u      = float(r) / 4294967295.0f
    """
    state = state * _LCG_MUL + _LCG_INC
    shift = (state >> np.uint32(28)) + np.uint32(4)
    r = ((state >> shift) ^ state) * _PCG_MUL
    r = (r >> np.uint32(22)) ^ r
    return state, r.astype(jnp.float32) * _INV_U32_MAX


# ---------------------------------------------------------------------------
# Stateless counter-based RNG (the framework-native discipline).
# ---------------------------------------------------------------------------

_H_MUL1 = np.uint32(0x9E3779B9)  # golden-ratio Weyl constant
_H_MUL2 = np.uint32(0x85EBCA6B)  # murmur3 finalizer constant
_H_MUL3 = np.uint32(0xC2B2AE35)  # murmur3 finalizer constant


def hash_u32(x):
    """PCG output hash of a uint32 — fast, good avalanche, branch-free."""
    x = jnp.asarray(x, jnp.uint32)
    state = x * _LCG_MUL + _LCG_INC
    shift = (state >> np.uint32(28)) + np.uint32(4)
    r = ((state >> shift) ^ state) * _PCG_MUL
    return (r >> np.uint32(22)) ^ r


def _mix(h, k):
    """Murmur3-style combine of a new word ``k`` into running hash ``h``."""
    k = jnp.asarray(k, jnp.uint32) * _H_MUL2
    k = (k << np.uint32(15)) | (k >> np.uint32(17))
    k = k * _H_MUL3
    h = h ^ k
    h = (h << np.uint32(13)) | (h >> np.uint32(19))
    return h * np.uint32(5) + np.uint32(0xE6546B64)


def counter_bits(pixel, sample, bounce_dim, seed=0):
    """Stateless random uint32 from a (pixel, sample, site) counter tuple.

    ``bounce_dim`` is a single uint32 combining bounce index and draw
    dimension (callers use ``bounce * NDIMS + dim``) so each sampling site in
    the light-transport chain owns a unique stream — the invariant that makes
    path-replay backprop consume the forward pass's exact randomness.
    """
    h = jnp.asarray(seed, jnp.uint32) ^ _H_MUL1
    h = _mix(h, pixel)
    h = _mix(h, sample)
    h = _mix(h, bounce_dim)
    return hash_u32(h)


def counter_uniform(pixel, sample, bounce_dim, seed=0):
    """Stateless uniform in [0, 1)."""
    bits = counter_bits(pixel, sample, bounce_dim, seed)
    # Take the top 24 bits -> exactly representable in f32, uniform in [0,1).
    # The value fits in 24 bits, so the int32 hop is lossless.
    return (bits >> np.uint32(8)).astype(jnp.int32).astype(jnp.float32) \
        * np.float32(1.0 / (1 << 24))
