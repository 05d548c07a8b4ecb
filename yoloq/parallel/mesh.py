"""Device mesh construction and sharding helpers.

The replacement for the reference's multi-GPU backend
(src/network.c:924-1194: pthread-per-GPU replicas + periodic host-staged
weight averaging every 4 batches).  Here data parallelism is expressed as
shardings on a jax Mesh: the batch is split over the ``data`` axis, params are
replicated, and XLA inserts an exact per-step gradient all-reduce (NCCL on
GPUs) — strictly stronger than the reference's stale averaging (SURVEY
§5.8); accuracy parity is the contract, not staleness semantics.

The mesh is (data, model); the model axis is available for optional tensor
sharding of wide conv layers (SURVEY §2.6) and defaults to size 1.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def device_pool(n_needed: int = 1) -> np.ndarray:
    """The default platform's devices; raises when there are fewer than
    ``n_needed``.  Tests get several devices from the CPU backend
    (``--xla_force_host_platform_device_count``)."""
    devices = np.asarray(jax.devices())
    if len(devices) < n_needed:
        raise ValueError(
            f"need {n_needed} devices, the {devices[0].platform} platform "
            f"has {len(devices)}"
        )
    return devices


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    devices = device_pool(n_model if n_data is None else n_data * n_model)
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or len(devices) < n_data * n_model:
        raise ValueError(
            f"mesh ({n_data} data x {n_model} model) needs "
            f"{max(n_data, 1) * n_model} devices; have {len(devices)}"
        )
    devices = devices[: n_data * n_model].reshape(n_data, n_model)
    return Mesh(devices, axis_names=("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis split over the data axis (inputs, truths)."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, *arrays):
    sh = batch_sharding(mesh)
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, tree):
    return jax.device_put(tree, replicated(mesh))
