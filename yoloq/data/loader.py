"""Asynchronous batched data loader: thread pool + double buffering.

The counterpart of the reference's pthread loader pipeline
(src/data.c:1090-1199 load_threads fanning out 64 workers, double-buffered
against training in examples/detector.c:56-88): a thread pool decodes and
augments samples while the accelerator trains on the previous batch, with a
bounded queue providing backpressure instead of the reference's
benign-by-luck buffer-swap race (SURVEY §5.2).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from yoloq.data.voc import DetectionDataset


class BatchLoader:
    """Prefetching batch iterator over a DetectionDataset.

    next() returns (images (B,H,W,3) f32, truths (B,MAX_BOXES,5) f32).
    Samples are drawn randomly with replacement, like the reference's
    rand()%m path selection (src/data.c random_paths).
    """

    def __init__(
        self,
        dataset: DetectionDataset,
        batch_size: int,
        workers: int = 8,
        prefetch: int = 2,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._feeder.start()

    def _make_batch(self):
        idxs = self.rng.integers(0, len(self.dataset), self.batch_size)
        # per-sample generators: augmentation draws are a pure function of
        # (loader seed, batch index, slot) — deterministic under any thread
        # scheduling, and no Generator is shared across pool threads
        seeds = self.rng.integers(0, 2**63 - 1, self.batch_size)
        samples = list(
            self._pool.map(
                lambda t: self.dataset.sample(t[0], np.random.default_rng(t[1])),
                zip(idxs, seeds),
            )
        )
        images = np.stack([s[0] for s in samples])
        truths = np.stack([s[1] for s in samples])
        return images, truths

    def _feed(self):
        while not self._stop.is_set():
            try:
                batch = self._make_batch()
            except RuntimeError:
                # close() shut the pool down while a batch was in flight;
                # exit quietly instead of crashing the daemon thread
                if self._stop.is_set():
                    return
                raise
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.25)
                    break
                except queue.Full:
                    continue

    def next(self):
        return self._q.get()

    def __iter__(self):
        while True:
            yield self.next()

    def close(self):
        """Stop the pipeline.  Ordering matters: the feeder must exit BEFORE
        the pool shuts down, or a batch in flight submits work to a dead
        executor (the shutdown race of VERDICT r2 weak item 4).  The feeder
        may be blocked in q.put, so drain while joining."""
        self._stop.set()
        while self._feeder.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._feeder.join(timeout=0.05)
        self._pool.shutdown(wait=True)
