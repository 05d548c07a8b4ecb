"""Training throughput: jitted QAT step time + scaling curve (VERDICT r2 item 3).

The reference's flagship GPU mode is QAT training (examples/detector.c:8-156,
multi-GPU src/network.c:1164); this measures the same step here:

  chip     one-card jitted QAT step at 416x416 (flagship config), batch
           configurable; compile time separated from steady-state step time,
           which ends in block_until_ready on the last step's state.
  scaling  1->N virtual-CPU-device data-parallel scaling_efficiency curve
           (weak scaling: per-device batch fixed).  Virtual devices share one
           host's cores, so the curve measures sharding/collective overhead,
           not hardware speedup — multi-card numbers need the cards.

Usage:
  python scripts/bench_train.py chip [batch] [steps]
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/bench_train.py scaling
Prints one JSON line per result.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from yoloq.utils.runtime import device_report, setup_compile_cache


def _synthetic_batch(key, batch: int, size: int, classes: int = 5, max_boxes: int = 90):
    """Device-generated images + a plausible truth tensor."""
    kx, kb = jax.random.split(key)
    images = jax.random.uniform(kx, (batch, size, size, 3), jnp.float32)
    # a handful of random boxes per image, rest zero (empty slots)
    nbox = 6
    xy = jax.random.uniform(kb, (batch, nbox, 2), minval=0.2, maxval=0.8)
    wh = jnp.full((batch, nbox, 2), 0.15, jnp.float32)
    cls = jax.random.randint(jax.random.fold_in(kb, 1), (batch, nbox, 1), 0, classes)
    truths = jnp.concatenate([xy, wh, cls.astype(jnp.float32)], axis=-1)
    truths = jnp.pad(truths, ((0, 0), (0, max_boxes - nbox), (0, 0)))
    return images, truths


def bench_chip(batch: int, steps: int, size: int = 416,
               compute_dtype: str = "float32", qat: bool = True,
               freeze_ranges: bool = False):
    from yoloq.models.presets import flagship_network
    from yoloq.train.qat import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    net = flagship_network()
    cfg = TrainConfig(batch_size=batch, compute_dtype=compute_dtype)
    state = init_train_state(net, cfg, jax.random.PRNGKey(0))
    step = make_train_step(net, cfg, qat=qat, freeze_ranges=freeze_ranges)
    images, truths = jax.jit(
        lambda k: _synthetic_batch(k, batch, size)
    )(jax.random.PRNGKey(1))

    t0 = time.perf_counter()
    state, metrics = step(state, images, truths)
    jax.block_until_ready((state, metrics))  # compile + first step
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, images, truths)
    jax.block_until_ready((state, metrics))
    dt = time.perf_counter() - t0
    loss = float(metrics["loss"])
    out = {
        "metric": ("qat_train_step_frozen_ranges" if freeze_ranges
                   else "qat_train_step") if qat else "float_train_step",
        "size": size,
        "batch": batch,
        "compute_dtype": compute_dtype,
        "steps": steps,
        "step_ms": round(1e3 * dt / steps, 2),
        "images_per_sec": round(steps * batch / dt, 1),
        "compile_plus_first_step_s": round(compile_s, 1),
        "loss": round(loss, 4),
        "device": device_report(),
    }
    print(json.dumps(out), flush=True)
    return out


def bench_scaling(size: int = 160, per_device_batch: int = 8, iters: int = 8):
    from yoloq.models.presets import flagship_network
    from yoloq.parallel import mesh as pmesh
    from yoloq.parallel.distributed import scaling_efficiency
    from yoloq.train.qat import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    net = flagship_network(size=size)
    cfg = TrainConfig(batch_size=per_device_batch)
    step = make_train_step(net, cfg, qat=True)
    # numpy snapshot: the step donates its input, so each mesh must get a
    # fresh device copy (device_put of a device tree may alias)
    state0 = jax.tree.map(
        np.asarray, init_train_state(net, cfg, jax.random.PRNGKey(0))
    )
    holder = {"state": state0}

    def step_fn(mesh, batch):
        if holder.get("mesh") is not mesh:
            from jax.sharding import NamedSharding, PartitionSpec

            holder["state"] = jax.device_put(
                state0, NamedSharding(mesh, PartitionSpec())
            )
            holder["mesh"] = mesh
        images, truths = batch
        with mesh:
            images, truths = pmesh.shard_batch(mesh, images, truths)
            holder["state"], metrics = step(holder["state"], images, truths)
        float(metrics["loss"])

    def make_batch(n):
        imgs, tr = _synthetic_batch(
            jax.random.PRNGKey(2), n * per_device_batch, size
        )
        return np.asarray(imgs), np.asarray(tr)

    counts = [n for n in (1, 2, 4, 8) if n <= len(jax.devices())]
    results = scaling_efficiency(step_fn, make_batch, counts, iters=iters)
    base = results.get(1)
    out = {
        "metric": "qat_train_scaling_virtual_cpu",
        "size": size,
        "per_device_batch": per_device_batch,
        "images_per_sec": {str(k): round(v, 2) for k, v in results.items()},
        "weak_scaling_vs_1dev": {
            str(k): round(v / base, 3) for k, v in results.items()
        } if base else {},
        "note": "virtual devices share one host's cores; curve measures "
                "sharding overhead, not hardware speedup",
    }
    print(json.dumps(out), flush=True)
    return out


def bench_trace(batch: int = 64, size: int = 416, qat: bool = True, freeze_ranges: bool = False):
    """Device trace of the train step: where the step time goes (VERDICT r3
    item 3 — 'training got one throughput number and no profile').  Prints
    the per-fusion table like scripts/profile_engine.py does for inference.
    """
    from profile_engine import parse_xplane

    from yoloq.models.presets import flagship_network
    from yoloq.train.qat import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    net = flagship_network()
    cfg = TrainConfig(batch_size=batch)
    state = init_train_state(net, cfg, jax.random.PRNGKey(0))
    step = make_train_step(net, cfg, qat=qat, freeze_ranges=freeze_ranges)
    images, truths = jax.jit(
        lambda k: _synthetic_batch(k, batch, size)
    )(jax.random.PRNGKey(1))

    state, m = step(state, images, truths)
    float(m["loss"])  # compile + warm
    logdir = f"/tmp/yoloq_trace_train_{'qat' if qat else 'float'}"
    n = 4
    with jax.profiler.trace(logdir):
        for _ in range(n):
            state, m = step(state, images, truths)
        float(m["loss"])
    per_op, total = parse_xplane(logdir)
    print(f"total device op time {total*1e3:.2f} ms over {n} steps "
          f"({total/n*1e3:.2f} ms/step, batch {batch})")
    items = sorted(per_op.items(), key=lambda kv: -kv[1])
    cum = 0.0
    for name, dur in items:
        frac = dur / total
        cum += frac
        if frac < 0.005 and cum > 0.97:
            break
        print(f"{dur/n*1e3:8.3f} ms/step {frac*100:5.1f}% {name[:110]}")


def bench_dissect(size: int = 160, per_device_batch: int = 8, iters: int = 8):
    """Separate the 8-virtual-device weak-scaling dip into its two candidate
    causes (VERDICT r3 item 9): the gradient all-reduce (psum) vs host-CPU
    contention (8 virtual devices sharing this host's cores).

    Method: time (a) the full DP step at 1 device and at 8 devices (same
    per-device batch), and (b) the psum ALONE — an explicit 8-way all-reduce
    of a gradient-sized pytree over the same mesh via shard_map.  If the
    psum-alone time is small against the 8-dev step-time excess, the dip is
    host contention, not the sharded step.
    """
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from yoloq.models.presets import flagship_network
    from yoloq.parallel import mesh as pmesh
    from yoloq.train.qat import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    net = flagship_network(size=size)
    cfg = TrainConfig(batch_size=per_device_batch)
    step = make_train_step(net, cfg, qat=True)
    # host-side snapshot: the step donates its input state, and device_put of
    # an already-device-resident tree may alias the same buffers — numpy
    # leaves force a fresh copy per topology
    state0 = jax.tree.map(
        np.asarray, init_train_state(net, cfg, jax.random.PRNGKey(0))
    )
    n_params = sum(x.size for x in jax.tree.leaves(state0.params))

    def time_step(n_dev):
        mesh = pmesh.make_mesh(n_data=n_dev)
        imgs, tr = _synthetic_batch(
            jax.random.PRNGKey(2), n_dev * per_device_batch, size
        )
        with mesh:
            state = jax.device_put(state0, NamedSharding(mesh, P()))
            images, truths = pmesh.shard_batch(
                mesh, np.asarray(imgs), np.asarray(tr)
            )
            state, m = step(state, images, truths)
            float(m["loss"])  # compile
            t0 = time.perf_counter()
            for _ in range(iters):
                state, m = step(state, images, truths)
            loss = float(m["loss"])
            dt = (time.perf_counter() - t0) / iters
        del loss
        return dt

    step1_ms = 1e3 * time_step(1)
    step8_ms = 1e3 * time_step(8)

    # psum-alone: explicit all-reduce of a gradient-sized pytree on the mesh
    mesh = pmesh.make_mesh(n_data=8)
    allreduce = jax.jit(
        shard_map(
            lambda g: jax.tree.map(lambda a: jax.lax.psum(a, "data"), g),
            mesh=mesh,
            in_specs=P(),
            out_specs=P(),
            check_rep=False,
        )
    )
    g = jax.device_put(state0.params, NamedSharding(mesh, P()))
    out = allreduce(g)
    float(jax.tree.leaves(out)[0].ravel()[0])  # compile + run
    t0 = time.perf_counter()
    for _ in range(iters):
        out = allreduce(g)
    float(jax.tree.leaves(out)[0].ravel()[0])
    psum_ms = 1e3 * (time.perf_counter() - t0) / iters

    excess = step8_ms - step1_ms
    result = {
        "metric": "qat_scaling_dip_dissection",
        "size": size,
        "per_device_batch": per_device_batch,
        "host_cpus": os.cpu_count(),
        "grad_params": int(n_params),
        "step_ms_1dev": round(step1_ms, 1),
        "step_ms_8dev": round(step8_ms, 1),
        "excess_ms_8dev": round(excess, 1),
        "psum_alone_ms": round(psum_ms, 1),
        "psum_share_of_excess": round(psum_ms / excess, 3) if excess > 0 else None,
        "verdict": (
            "host contention"
            if psum_ms < 0.5 * max(excess, 1e-9)
            else "collective overhead"
        ),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "chip"
    setup_compile_cache()
    if mode == "chip":
        args = [a for a in sys.argv[2:] if not a.startswith("--")]
        batch = int(args[0]) if args else 64
        steps = int(args[1]) if len(args) > 1 else 10
        bench_chip(
            batch, steps,
            compute_dtype="bfloat16" if "--bf16" in sys.argv else "float32",
            qat="--float" not in sys.argv,
            freeze_ranges="--freeze" in sys.argv,
        )
    elif mode == "scaling":
        # the virtual CPU mesh (same trick as tests/conftest.py); flags and
        # platform are read lazily at backend init, which hasn't happened yet
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        jax.config.update("jax_platforms", "cpu")
        bench_scaling()
    elif mode == "trace":
        batch = int(sys.argv[2]) if len(sys.argv) > 2 else 64
        bench_trace(batch, qat="--float" not in sys.argv,
                    freeze_ranges="--freeze" in sys.argv)
    elif mode == "dissect":
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        jax.config.update("jax_platforms", "cpu")
        bench_dissect()
    else:
        raise SystemExit(f"unknown mode {mode}")
