"""Device mesh construction for multi-GPU rendering.

The reference is single-process with no distribution anywhere (SURVEY.md
§2.4); this module is its replacement: a ``jax.sharding.Mesh`` over the
GPUs, with the convention that the ``data`` axis shards rays/pixels/samples
(DP) and the optional ``prim`` axis shards scene primitives (the TP analog,
for scenes larger than one card's memory — BASELINE config 5).  On one host
the cards are joined all to all by NVLink, so any axis order reaches every
peer at the same rate; collectives under ``shard_map`` go to NCCL.

Multi-process bring-up uses ``jax.distributed.initialize()`` (call
``init_distributed`` once per process before building meshes); one process
can also drive every card of a host, and tests fake 8 devices with
``--xla_force_host_platform_device_count=8``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-process bring-up (SNIPPETS.md pattern): call once per process
    before any device op.  With no arguments, defers to JAX's environment
    auto-detection (``jax.distributed.initialize()`` reads a cluster
    environment where one exists; elsewhere pass the coordinator
    ``host:port``, the process count and this process's id).  No-op when
    already initialized."""
    try:
        if coordinator_address is None:
            jax.distributed.initialize()
        else:
            jax.distributed.initialize(coordinator_address=coordinator_address,
                                       num_processes=num_processes,
                                       process_id=process_id)
    except RuntimeError:
        pass  # already initialized (or single-process with no cluster env)


def make_render_mesh(data: Optional[int] = None, prim: int = 1,
                     hosts: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with a ``data`` (rays/samples) axis and a ``prim`` axis.

    Defaults to all devices on ``data``.  ``hosts`` declares a multi-host
    shape: devices are laid out host-major and each ``prim`` group is kept
    *within* one host's cards, so the prim-axis collectives of config 5
    (the scene all_gather / ppermute ring) stay on that host's NVLink; only
    the ``data``-axis collectives — the one psum of sample-sharded partial
    images and the DP gradient all-reduce, both once per step — cross the
    network between hosts.  Requires prim to divide the per-host card
    count.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        if n % prim != 0:
            raise ValueError(f"{n} devices not divisible by prim={prim}")
        data = n // prim
    if data * prim > n:
        raise ValueError(f"mesh {data}x{prim} exceeds {n} devices")
    if hosts is not None:
        if (data * prim) % hosts != 0:
            raise ValueError(f"{data * prim} devices not divisible by "
                             f"hosts={hosts}")
        per_host = data * prim // hosts
        if per_host % prim != 0:
            raise ValueError(
                f"prim={prim} does not divide the {per_host} devices/host — "
                f"a prim group would straddle hosts and its collectives "
                f"would leave the host")
        # Host-major order; contiguous devices within a host form each prim
        # group: reshape (hosts, per_host) -> (hosts * per_host/prim, prim).
        dev_array = np.asarray(devices[:data * prim]).reshape(
            hosts, per_host // prim, prim).reshape(data, prim)
    else:
        dev_array = np.asarray(devices[:data * prim]).reshape(data, prim)
    return Mesh(dev_array, ("data", "prim"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def row_sharded(mesh: Mesh) -> NamedSharding:
    """Image rows over the data axis."""
    return NamedSharding(mesh, P("data"))
