"""Worker for the 2-process local cluster exercise (VERDICT r2 next #8).

Each process owns 4 virtual CPU devices; `jax.distributed.initialize` with
the TCP coordinator forms one 8-device global mesh across both processes —
the same bring-up path a real multi-host GPU cluster uses (SNIPPETS.md pattern,
SURVEY.md §2.4 last row).  The worker then proves the collectives actually
cross the process boundary:

  1. a psum over all 8 global devices sums contributions from BOTH
     processes (value pins each device's process id);
  2. a sample-sharded render over the global mesh matches the local
     unsharded reference;
  3. a DP gradient step (sample-sharded loss + psum grad all-reduce) runs
     and both processes agree on the loss.

Usage (normally via tools/run_multiprocess.py):
    python tools/mp_worker.py <process_id> <num_processes> <port>
"""
import json
import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
# Force exactly 4 local devices, replacing any inherited count (a parent
# pytest process exports an 8-device flag via tests/conftest.py).
flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
         if "host_platform_device_count" not in f]
flags.append("--xla_force_host_platform_device_count=4")
os.environ["XLA_FLAGS"] = " ".join(flags)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=pid)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from functools import partial  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, len(jax.devices())
assert len(jax.local_devices()) == 4

from spt_tpu import Camera  # noqa: E402
from spt_tpu.diff import gradients as G  # noqa: E402
from spt_tpu.engine.integrator_jax import render_megasample  # noqa: E402
from spt_tpu.parallel import sharding as S  # noqa: E402
from spt_tpu.parallel.mesh import make_render_mesh  # noqa: E402
from __graft_entry__ import _cornell  # noqa: E402

# 1) psum across the process boundary: every device contributes
# 10^process_id; with 2 processes x 4 devices the global sum MUST be
# 4*(1 + 10) = 44 — a single-process run could only produce 4 or 40.
mesh = Mesh(np.asarray(jax.devices()).reshape(8), ("data",))


@partial(shard_map, mesh=mesh, in_specs=P("data"), out_specs=P(),
         check_vma=False)
def cross_sum(x):
    return jax.lax.psum(x, "data")


contrib = jnp.full((len(jax.local_devices()),),
                   10.0 ** jax.process_index(), jnp.float32)
garr = jax.make_array_from_process_local_data(
    jax.NamedSharding(mesh, P("data")), np.asarray(contrib))
total = float(np.asarray(cross_sum(garr)))
assert total == 44.0, total

# 2) sample-sharded render over the cross-process mesh == local reference.
scene_data = _cornell().compile()
camera = Camera.look_at((0, 1.0, -1.5), (0, 1.0, 3.0), fov_degrees=55)
W = H = 16
rmesh = make_render_mesh(data=8, prim=1, hosts=nproc)
img = S.render_sample_sharded(scene_data, camera, W, H, 1, rmesh,
                              max_bounces=2, rr_depth=8, seed=0)
img = np.asarray(img)   # out_specs=P() -> fully replicated, gatherable
ref = np.asarray(render_megasample(scene_data, camera, W, H,
                                   jnp.arange(8), max_bounces=2,
                                   rr_depth=8, seed=0))
np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-5)

# 3) DP gradient step with psum all-reduce across both processes.
render = G.make_render_fn(scene_data, camera, W, H, max_bounces=2)
params = G.get_params(scene_data, ("albedo", "roughness"))
loss_fn = G.make_loss_fn(render, jnp.zeros((H, W, 3), jnp.float32))
step = S.make_dp_grad_step(loss_fn, rmesh, samples_per_device=1)
loss, grads = step(params, jnp.int32(0))
loss = float(np.asarray(loss))
assert np.isfinite(loss)
g_norm = float(sum(np.square(np.asarray(v)).sum()
                   for v in jax.tree.leaves(grads)) ** 0.5)

if pid == 0:
    print(json.dumps({
        "num_processes": jax.process_count(),
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "cross_process_psum": total,
        "sample_sharded_matches_ref": True,
        "dp_step_loss": round(loss, 6),
        "dp_step_grad_norm": round(g_norm, 6),
        "ok": True,
    }), flush=True)
