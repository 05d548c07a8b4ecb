"""Capture a device trace of the integer engine and print where the time goes.

Runs the engine at the given batch under jax.profiler, then sums the device
durations per HLO op ("XLA Ops") and per kernel (the stream lines) from the
GPU planes of the trace (utils.profiling.device_op_times).

Usage: python scripts/profile_engine.py [batch] [--v3]

The trace goes to build/trace_engine.

--v3 profiles the full yolov3 graph (quantized shortcuts) instead of the
flagship tiny.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

RUNS = 6


def build(v3: bool):
    from yoloq.infer.engine import Engine
    from yoloq.models.presets import flagship_program

    if v3:
        from yoloq.infer.convert import convert
        from yoloq.models import zoo
        from yoloq.models.presets import synthetic_quant_state
        from yoloq.nn.graph import init_params_numpy

        net = zoo.yolov3(classes=80, width=416, height=416)
        program = convert(net, init_params_numpy(0, net), synthetic_quant_state(net))
    else:
        program = flagship_program()
    return Engine(program, max_det=64)


def capture(engine, batch: int, logdir: str) -> None:
    x = jax.jit(
        lambda k: jax.random.uniform(k, (batch, 416, 416, 3), jax.numpy.float32)
    )(jax.random.PRNGKey(0))
    jax.block_until_ready(engine._run(engine.arrays, x))  # compile + warm
    with jax.profiler.trace(logdir):
        out = None
        for _ in range(RUNS):
            out = engine._run(engine.arrays, x)
        jax.block_until_ready(out)


def print_table(title: str, per_name: dict[str, int], top: int = 40) -> None:
    total = sum(per_name.values())
    print(f"{title}: {total / RUNS / 1e6:.3f} ms/run over {len(per_name)} names")
    for name, ns in sorted(per_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{ns / RUNS / 1e6:9.3f} ms/run {100 * ns / total:5.1f}%  {name[:140]}")


def main():
    from yoloq.utils.profiling import device_op_times
    from yoloq.utils.runtime import setup_compile_cache

    setup_compile_cache()
    logdir = "build/trace_engine"
    v3 = "--v3" in sys.argv
    pos = [a for a in sys.argv[1:] if not a.startswith("--")]
    batch = int(pos[0]) if pos else (64 if v3 else 128)
    capture(build(v3), batch, logdir)
    lines = device_op_times(logdir)
    if not lines:
        raise RuntimeError(f"no GPU device planes in the trace under {logdir}")
    for line, per_name in lines.items():
        print_table(f"[{line}] batch {batch}", per_name)


if __name__ == "__main__":
    main()
