"""Multi-host distributed setup and scaling measurement.

The reference's "distributed" story is pthreads + cudaMemcpy weight averaging
inside one host (SURVEY §5.8).  Here multi-host runs use jax.distributed: one
process per host, a global Mesh spanning every chip, and the SAME jitted train
step as single-device — XLA compiles the gradient psum to the collectives of
the interconnect (NCCL over NVLink within a host, the network across hosts).  Nothing else changes: sharding annotations are the whole
"communication backend".

Usage (one process per host):

    from yoloq.parallel import distributed
    distributed.initialize(coordinator, num_processes, process_id)
    mesh = distributed.global_mesh()          # all chips, ("data", "model")
    # shard global batches with mesh + PartitionSpec("data") as usual

``scaling_efficiency`` measures images/sec at increasing device counts for
the BASELINE.md north star (>=0.95 linear at 8+ chips).
"""

from __future__ import annotations

import time

import jax
import numpy as np

from yoloq.parallel.mesh import make_mesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    initialization_timeout: int = 300,
) -> None:
    """jax.distributed.initialize with env-var fallbacks (no-op if already up
    or single-process).

    Must run before anything touches the XLA backend — so the already-up
    check reads the distributed client state, NOT jax.process_count()
    (which would itself initialize the backend).
    """
    from jax._src.distributed import global_state

    if global_state.client is not None:  # already initialized
        return
    kwargs = {}
    if coordinator_address:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            initialization_timeout=initialization_timeout,
        )
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError):
        if coordinator_address:
            # the caller explicitly asked for a multi-process cluster; a
            # silent fallback to single-host would corrupt training (each
            # process would average only its own gradients) — fail loudly
            raise
        # implicit single-process use (no coordinator configured): fine


def global_mesh(n_model: int = 1):
    """Mesh over every device across all processes."""
    return make_mesh(n_model=n_model)


def scaling_efficiency(
    step_fn,
    make_batch,
    device_counts: list[int],
    iters: int = 10,
) -> dict[int, float]:
    """Throughput at each device count; step_fn(mesh, batch) must run one
    sharded step and block.  Returns {n_devices: items/sec}."""
    results = {}
    for n in device_counts:
        if n > len(jax.devices()):
            continue
        mesh = make_mesh(n_data=n)
        batch = make_batch(n)
        step_fn(mesh, batch)  # compile
        t0 = time.perf_counter()
        for _ in range(iters):
            step_fn(mesh, batch)
        dt = time.perf_counter() - t0
        results[n] = iters * _batch_items(batch) / dt
    return results


def _batch_items(batch) -> int:
    leaf = jax.tree.leaves(batch)[0]
    return int(np.asarray(leaf.shape[0]))
