"""Profiling and metrics: structured replacements for the reference's printfs.

The reference's observability is stdout printf + gettimeofday timers
(SURVEY §5.1, src/utils.c:29, examples/detector.c:131).  Here:

  - StepTimer: wall-clock per-step timing (the caller ends each step with
    jax.block_until_ready so the time covers the device work)
  - trace(): context manager around jax.profiler for XLA-level traces
    viewable in TensorBoard / Perfetto
  - MetricsWriter: JSONL metrics log (step, loss, lr, imgs/sec, ...) — the
    structured successor of the reference's per-batch print line
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field


@contextlib.contextmanager
def trace(logdir: str):
    """Capture an XLA profiler trace for the enclosed block."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_op_times(logdir: str) -> dict[str, dict[str, int]]:
    """Sum the device durations (ns) of each event name in the newest trace
    under ``logdir``, per trace line of the GPU planes (the "Stream" lines
    hold kernel names)."""
    import glob

    import jax

    paths = sorted(
        glob.glob(os.path.join(logdir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    lines: dict[str, dict[str, int]] = {}
    for plane in jax.profiler.ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            agg = lines.setdefault(line.name, {})
            for ev in line.events:
                agg[ev.name] = agg.get(ev.name, 0) + int(ev.duration_ns)
    return lines


@dataclass
class StepTimer:
    """Rolling-average step timer (EMA like the reference's avg loss)."""

    decay: float = 0.9
    avg: float | None = None
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else self.decay * self.avg + (1 - self.decay) * dt
        return dt


class MetricsWriter:
    """Append-only JSONL metrics, one object per step/event."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def write(self, step: int, **metrics):
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()
