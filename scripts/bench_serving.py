"""Serving SLO benchmark: p50/p99 latency vs offered load.

Drives infer/serving.Server with a Poisson open-loop arrival process at
increasing offered rates, measuring end-to-end request latency (submit ->
future resolved, includes letterbox, batching delay, the input upload, the
device run, NMS) and batch-bucket fill rates.  Prints the device, one JSON
line per load point, and a summary table.

Usage: python scripts/bench_serving.py [--rates 50,200,1000,4000] [--uint8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_load(server, images, rate_hz: float, duration_s: float):
    """Open-loop Poisson arrivals at rate_hz for duration_s; returns latencies.

    Latency is stamped by a done-callback AT COMPLETION (resolver thread),
    not when the caller later observes the future — observing sequentially
    after the load loop would credit early completions with the whole
    remaining loop time and inflate percentiles by seconds."""
    import threading

    rng = np.random.default_rng(0)
    lat: list[float] = []
    lock = threading.Lock()
    futures = []
    t_end = time.monotonic() + duration_s
    next_t = time.monotonic()
    i = 0

    def stamp(t0):
        def cb(_fut):
            dt = time.monotonic() - t0
            with lock:
                lat.append(dt)
        return cb

    while time.monotonic() < t_end:
        now = time.monotonic()
        if now < next_t:
            time.sleep(min(next_t - now, 0.001))
            continue
        t0 = time.monotonic()
        fut = server.submit(images[i % len(images)], thresh=0.25)
        fut.add_done_callback(stamp(t0))
        futures.append(fut)
        i += 1
        next_t += rng.exponential(1.0 / rate_hz)
    for fut in futures:
        fut.result(timeout=600)
    return np.asarray(lat), i


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rates", default="50,200,800,3000")
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--buckets", default="1,4,16",
                    help="batch bucket ladder (one compiled program each)")
    ap.add_argument("--uint8", action="store_true",
                    help="stage frames as uint8 codes (engine raw-u8 input)")
    ap.add_argument("--size", type=int, default=416)
    args = ap.parse_args()

    from yoloq.infer.engine import Engine
    from yoloq.infer.serving import Server
    from yoloq.models.presets import flagship_program
    from yoloq.utils.runtime import device_report, setup_compile_cache

    setup_compile_cache()
    dev = device_report()
    print(json.dumps({"device": dev}), flush=True)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    program = flagship_program()
    engine = Engine(program, max_det=64)
    rng = np.random.default_rng(1)
    # a few distinct input sizes exercise per-request letterboxing
    images = [
        rng.uniform(0, 1, (480, 640, 3)).astype(np.float32),
        rng.uniform(0, 1, (720, 960, 3)).astype(np.float32),
        rng.uniform(0, 1, (416, 416, 3)).astype(np.float32),
    ]

    rows = []
    for rate in [float(r) for r in args.rates.split(",")]:
        server = Server(
            engine, batch_size=buckets, max_delay_ms=5.0, uint8_io=args.uint8
        )
        # warm every compiled bucket (full-ladder warmup: one singleton, then
        # bursts that land in each larger bucket)
        server.submit(images[0]).result(timeout=600)
        for b in buckets[1:]:
            futs = [server.submit(images[i % 3]) for i in range(b)]
            for f in futs:
                f.result(timeout=600)
        lat, n = run_load(server, images, rate, args.duration)
        stats = dict(server.stats)
        server.close()
        row = {
            "offered_rate_hz": rate,
            "completed": int(n),
            "achieved_rate_hz": round(n / args.duration, 1),
            "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
            "p90_ms": round(float(np.percentile(lat, 90)) * 1e3, 2),
            "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 2),
            "batches": stats["batches"],
            "avg_batch_fill": round(
                stats["batch_fill_sum"] / max(stats["batches"], 1), 3
            ),
            "bucket_hist": {str(k): v for k, v in sorted(stats["bucket_hist"].items())},
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    print("\n| offered req/s | achieved | p50 ms | p90 ms | p99 ms | batch fill |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['offered_rate_hz']:.0f} | {r['achieved_rate_hz']} | "
            f"{r['p50_ms']} | {r['p90_ms']} | {r['p99_ms']} | {r['avg_batch_fill']} |"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
