"""Full yolov3 (106-layer, quantized shortcuts) inference throughput.

The reference cannot run full yolov3 integer end-to-end (its shortcut layer
is float-only, src/shortcut_layer.c); this framework quantizes shortcuts
with learned ranges, so the whole 61.6-GMAC graph runs in the uint8 domain.
Prints the device, then one JSON line, with bench.py's timing and peaks.

Usage: python scripts/bench_v3.py [batch]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 64

    import bench
    from yoloq.infer.convert import convert
    from yoloq.infer.engine import Engine
    from yoloq.models import zoo
    from yoloq.models.presets import synthetic_quant_state
    from yoloq.nn.graph import init_params_numpy
    from yoloq.utils.runtime import device_report, setup_compile_cache

    setup_compile_cache()
    dev = device_report()
    for line in dev["nvidia_smi"]:
        print(line, flush=True)
    peaks = bench.peaks_for(dev["kind"])

    net = zoo.yolov3(classes=80, width=416, height=416)
    program = convert(net, init_params_numpy(0, net), synthetic_quant_state(net))
    engine = Engine(program, max_det=64)
    run, arrays = engine._run, engine.arrays
    t0 = time.perf_counter()
    jax.block_until_ready(run(arrays, bench._device_batch(batch)))
    compile_s = time.perf_counter() - t0
    ips = bench.throughput(run, arrays, batch, iters=10)
    macs = bench.conv_macs_per_image(program)
    print(json.dumps({
        "metric": "yolov3-full uint8 416x416 inference throughput (1 card)",
        "batch": batch,
        "images_per_sec": ips,
        "mfu_int8": 2.0 * macs * ips / peaks["int8_ops"],
        "conv_gmacs_per_image": macs / 1e9,
        "compile_s": compile_s,
        "platform": dev["platform"],
        "device_kind": dev["kind"],
        "device_count": dev["count"],
        "nvidia_smi": dev["nvidia_smi"],
    }))


if __name__ == "__main__":
    main()
