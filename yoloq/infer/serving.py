"""Continuous-batching inference server.

The production serving layer over infer/engine.py: callers submit single
images (any size) and get detection futures; a batcher thread letterboxes on
host worker threads, groups requests into fixed batch buckets (static shapes
=> one compiled program per bucket, no recompiles), runs the device, and
resolves futures with decoded, NMS'd detections.

The reference has no serving path — its closest analog is the single-image
test loop (examples/detector.c:878-950).  This is the "multi-host streaming /
continuous image batching" capability called for by BASELINE.json; multi-host
sharding composes by giving each host its own Server over its local devices
(data-parallel serving), since YOLO inference is embarrassingly parallel
across images — exercised by tests/test_serving_multihost.py (2 processes,
identical detections to single-process).

Batching is a bucket LADDER (default {1, 4, 16}): each dispatch runs the
smallest compiled bucket that holds the gathered requests — the serving twin
of the reference's set_batch_network(1) single-image path plus its batch
mode, without padding low-load singletons to the max batch.  ``uint8_io``
stages frames as uint8 pixel codes into the engine's raw-uint8 input mode
(4x less host->device transfer per image).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from yoloq.eval import detect
from yoloq.utils import native


@dataclass
class Detection:
    box: np.ndarray       # (4,) center-format, relative to the ORIGINAL image
    objectness: float
    class_probs: np.ndarray


@dataclass
class _Request:
    image: np.ndarray     # original HWC float32
    future: Future
    thresh: float
    nms: float
    enqueue_time: float = 0.0


class Server:
    """Continuous batching over a quantized (or float) Engine.

    submit() is thread-safe and non-blocking; the returned Future resolves to
    a list[Detection].  max_delay_ms bounds added latency: a partial batch is
    flushed when the oldest request has waited that long.
    """

    def __init__(
        self,
        engine,
        batch_size: int | tuple[int, ...] = (1, 4, 16),
        max_delay_ms: float = 5.0,
        preprocess_workers: int = 4,
        pipeline_depth: int = 2,
        uint8_io: bool = False,
    ):
        self.engine = engine
        self.net = engine.program.net
        # batch bucket ladder: one compiled program per bucket (jit caches by
        # shape), chosen per dispatch as the smallest bucket holding the
        # gathered requests — low load rides the batch-1 program instead of
        # padding 16x (r3 SLO run: fill 0.09 at 20 req/s on a single bucket).
        # An int keeps the old single-bucket behavior.
        buckets = (batch_size,) if isinstance(batch_size, int) else tuple(
            sorted(set(batch_size))
        )
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"invalid batch buckets {buckets}")
        self.buckets = buckets
        self.batch_size = buckets[-1]  # gather cap
        # uint8_io: stage letterboxed frames as uint8 pixel codes (engine's
        # raw-uint8 input mode, infer/engine.py forward) — 4x less
        # host->device transfer, exactly where serving transfer matters
        self.uint8_io = uint8_io
        self.max_delay = max_delay_ms / 1e3
        self._q: queue.Queue[_Request] = queue.Queue()
        # serializes late submit() against close()'s final queue drain so a
        # racing submit either lands before the drain or is rejected — never
        # enqueued after the drain with its future left pending forever
        self._submit_lock = threading.Lock()
        self._closed = False
        self._pre = ThreadPoolExecutor(max_workers=preprocess_workers)
        self._stop = threading.Event()
        # pipelined continuous batching: the dispatch loop enqueues device
        # work and hands (requests, resolver) to the resolver thread, so
        # batch N+1 is gathered and dispatched while batch N's results are
        # still in flight — without this, the dispatch->fetch round trip
        # serializes and bounds throughput at ~1/RTT batches/sec regardless
        # of batch size.  The bounded queue (depth 2) is the backpressure
        # that keeps device-side queueing shallow.
        self._inflight: queue.Queue = queue.Queue(maxsize=pipeline_depth)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._resolver = threading.Thread(target=self._resolve_loop, daemon=True)
        self._thread.start()
        self._resolver.start()
        self.stats = {
            "batches": 0, "images": 0, "batch_fill_sum": 0.0, "bucket_hist": {},
        }

    def submit(self, image: np.ndarray, thresh: float = 0.5, nms: float = 0.45) -> Future:
        if image.dtype == np.uint8:
            # raw camera/decoder frames: normalize once on the host; the
            # letterbox path and box correction expect [0,1] floats
            image = image.astype(np.float32) / np.float32(255.0)
        fut: Future = Future()
        req = _Request(image=image, future=fut, thresh=thresh, nms=nms,
                       enqueue_time=time.monotonic())
        with self._submit_lock:
            if self._closed:
                fut.set_exception(RuntimeError("server closed"))
            else:
                self._q.put(req)
        return fut

    def _gather_batch(self) -> list[_Request]:
        reqs: list[_Request] = []
        try:
            reqs.append(self._q.get(timeout=0.1))
        except queue.Empty:
            return reqs
        # drain the existing backlog non-blockingly FIRST: when requests have
        # queued behind a busy device, the oldest is already past its window
        # and the deadline loop below would flush a singleton — degenerating
        # the server to batch-of-1 exactly when batching matters most (found
        # by the r3 SLO run: fill pinned at 1/16 under 10x backlog)
        while len(reqs) < self.batch_size:
            try:
                reqs.append(self._q.get_nowait())
            except queue.Empty:
                break
        # then wait out the batching window for stragglers
        deadline = reqs[0].enqueue_time + self.max_delay
        while len(reqs) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                reqs.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return reqs

    def _loop(self):
        while not self._stop.is_set():
            reqs = self._gather_batch()
            if not reqs:
                continue
            try:
                self._dispatch_batch(reqs)
            except Exception as e:  # resolve futures with the error
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _dispatch_batch(self, reqs: list[_Request]):
        net = self.net
        # parallel host-side letterbox (native C++ when available)
        letterboxed = list(
            self._pre.map(lambda r: native.letterbox(r.image, net.width, net.height), reqs)
        )
        # smallest bucket that fits -> one compiled shape per bucket
        bucket = next(b for b in self.buckets if b >= len(reqs))
        if self.uint8_io:
            batch = np.zeros((bucket, net.height, net.width, 3), np.uint8)
            for i, x in enumerate(letterboxed):
                batch[i] = (x * 255.0 + 0.5).astype(np.uint8)
        else:
            batch = np.zeros((bucket, net.height, net.width, 3), np.float32)
            for i, x in enumerate(letterboxed):
                batch[i] = x
        if hasattr(self.engine, "predict_async"):
            resolve = self.engine.predict_async(batch)
        else:
            out = self.engine.predict(batch)
            resolve = lambda: out  # noqa: E731 — already-resolved engines
        while True:
            try:
                self._inflight.put((reqs, resolve, bucket), timeout=0.25)
                return
            except queue.Full:
                if self._stop.is_set():
                    # shutting down with the pipeline full: resolve inline so
                    # no submitter is left blocked on an abandoned future
                    try:
                        self._finish_batch(reqs, resolve(), bucket)
                    except Exception as e:
                        for r in reqs:
                            if not r.future.done():
                                r.future.set_exception(e)
                    return

    def _resolve_loop(self):
        # keeps draining after stop until the pipeline is empty, so a batch
        # mid-resolve (e.g. a cold-bucket compile) finishes before close()'s
        # unbounded join returns — no future completes after close()
        while True:
            try:
                reqs, resolve, bucket = self._inflight.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                self._finish_batch(reqs, resolve(), bucket)
            except Exception as e:
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _finish_batch(self, reqs: list[_Request], outputs, bucket: int | None = None):
        net = self.net
        boxes, obj, cls = outputs
        bucket = bucket or self.batch_size
        self.stats["batches"] += 1
        self.stats["images"] += len(reqs)
        self.stats["batch_fill_sum"] += len(reqs) / bucket
        self.stats["bucket_hist"][bucket] = (
            self.stats["bucket_hist"].get(bucket, 0) + 1
        )
        for i, r in enumerate(reqs):
            h, w, _ = r.image.shape
            b = detect.correct_boxes(boxes[i], w, h, net.width, net.height)
            keep = obj[i] > r.thresh
            bb, oo, cc = native.nms_obj(b[keep], obj[i][keep], cls[i][keep], r.nms)
            dets = [
                Detection(box=bb[j], objectness=float(oo[j]), class_probs=cc[j])
                for j in np.argsort(-oo)
                if oo[j] > r.thresh
            ]
            # a client may have cancelled its future mid-batch; never let that
            # poison the other requests in the batch
            if not r.future.cancelled():
                try:
                    r.future.set_result(dets)
                except Exception:
                    pass

    def close(self):
        self._stop.set()
        # the dispatch loop's blocking waits are all bounded (gather timeout
        # 0.1 s, put timeout 0.25 s) and on stop it resolves inline rather
        # than dropping, so join WITHOUT a cap — a capped join could return
        # while a batch is still being enqueued, and the drain below would
        # miss it, leaving submitters blocked (advisor r3 finding)
        self._thread.join()
        # unbounded like the dispatch join: the resolver only exits once the
        # pipeline is drained (see _resolve_loop), and a capped join could
        # return while a cold-compile batch is mid-resolve, leaving its
        # futures/stats to complete on a daemon thread after close() returns
        self._resolver.join()
        # safety net for batches enqueued between the resolver's last empty
        # check and the dispatch thread's exit
        try:
            while True:
                reqs, resolve, bucket = self._inflight.get_nowait()
                try:
                    self._finish_batch(reqs, resolve(), bucket)
                except Exception as e:
                    for r in reqs:
                        if not r.future.done():
                            r.future.set_exception(e)
        except queue.Empty:
            pass
        # fail anything still sitting in the submit queue; the lock makes the
        # closed-flag flip and the drain atomic vs racing submit() calls
        with self._submit_lock:
            self._closed = True
            try:
                while True:
                    r = self._q.get_nowait()
                    if not r.future.done():
                        r.future.set_exception(RuntimeError("server closed"))
            except queue.Empty:
                pass
        self._pre.shutdown(wait=True)
