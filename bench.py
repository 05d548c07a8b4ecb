"""Benchmark: quantized yolov3-tiny uint8 inference throughput on one card.

Prints the device it ran on, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ...extras}.

Baseline (BASELINE.md): the reference's uint8 CPU path runs one 416x416 image
in 0.34 s => 2.94 images/sec.  vs_baseline = our images/sec/card / 2.94.

Every time is host clock around calls that end in ``block_until_ready``;
``mfu_int8`` is the conv MACs the graph needs (2 ops each) over the card's
published dense int8 peak (PEAKS, keyed by ``device_kind``).  A device that
is not in PEAKS is an error, and so is any failure: nothing is caught.

Usage: python bench.py
"""

from __future__ import annotations

import json
import time

import jax
import numpy as np

BASELINE_IMG_PER_SEC = 1.0 / 0.34  # reference README.md:58

# Published dense peaks (no sparsity) at the full power limit, by JAX's
# device_kind.  Source: NVIDIA's H100 and H200 data sheets (SXM parts).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "int8_ops": 1979e12, "bf16_flops": 989e12, "tf32_flops": 495e12,
        "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12,
    },
    "NVIDIA H200": {
        "int8_ops": 1979e12, "bf16_flops": 989e12, "tf32_flops": 495e12,
        "f32_flops": 67e12, "hbm_bytes_per_s": 4.8e12,
    },
}


def peaks_for(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            f"bench.PEAKS with its source"
        ) from None


def conv_macs_per_image(program) -> float:
    """Sum conv MACs from the graph geometry (quantized + float convs)."""
    from yoloq.nn.graph import ConvSpec

    net = program.net
    shapes = net.shapes()
    macs = 0
    for i, s in enumerate(net.specs):
        if not isinstance(s, ConvSpec):
            continue
        ih, iw, ic = shapes[i - 1] if i > 0 else (net.height, net.width, net.channels)
        oh, ow, oc = shapes[i]
        macs += oh * ow * oc * s.size * s.size * ic
    return float(macs)


def _build():
    from yoloq.infer.engine import Engine
    from yoloq.models.presets import flagship_program

    program = flagship_program()
    engine = Engine(program, max_det=64)
    return engine._run, engine.arrays, program


def _device_batch(batch: int) -> jax.Array:
    return jax.jit(
        lambda k: jax.random.uniform(k, (batch, 416, 416, 3), jax.numpy.float32)
    )(jax.random.PRNGKey(0))


def _timed(run, arrays, x, iters: int) -> float:
    """Seconds per call over ``iters`` back-to-back calls."""
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = run(arrays, x)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def throughput(run, arrays, batch: int, iters: int = 20) -> float:
    """Images/sec at ``batch``: the best of three windows of ``iters`` calls."""
    x = _device_batch(batch)
    jax.block_until_ready(run(arrays, x))  # compile + warm
    return batch / min(_timed(run, arrays, x, iters) for _ in range(3))


def latency_batch1(run, arrays, iters: int = 50) -> float:
    """Median seconds of one batch-1 call, each waited for."""
    x = _device_batch(1)
    jax.block_until_ready(run(arrays, x))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(run(arrays, x))
        ts.append(time.perf_counter() - t0)
    return float(np.percentile(ts, 50))


def main():
    from yoloq.utils.runtime import device_report, setup_compile_cache

    setup_compile_cache()
    dev = device_report()
    for line in dev["nvidia_smi"]:
        print(line, flush=True)
    peaks = peaks_for(dev["kind"])
    run, arrays, program = _build()
    per_batch = {batch: throughput(run, arrays, batch) for batch in (128, 256)}
    best_batch = max(per_batch, key=lambda b: per_batch[b])
    images_per_sec = per_batch[best_batch]
    macs = conv_macs_per_image(program)
    p50 = latency_batch1(run, arrays)
    result = {
        "metric": "yolov3-tiny uint8 416x416 inference throughput (1 card)",
        "value": images_per_sec,
        "unit": "images/sec",
        "vs_baseline": images_per_sec / BASELINE_IMG_PER_SEC,
        "batch": best_batch,
        "mfu_int8": 2.0 * macs * images_per_sec / peaks["int8_ops"],
        "conv_gmacs_per_image": macs / 1e9,
        "p50_latency_batch1_ms": p50 * 1e3,
        "images_per_sec_by_batch": {str(k): v for k, v in per_batch.items()},
        "platform": dev["platform"],
        "device_kind": dev["kind"],
        "device_count": dev["count"],
        "nvidia_smi": dev["nvidia_smi"],
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
