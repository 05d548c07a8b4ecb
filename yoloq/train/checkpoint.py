"""Checkpoint / resume as exact ``.npz`` round trips, mirroring the reference's cadence.

The reference saves darknet weight blobs every 100 iters to backup/<name>.backup
and every 10000 to numbered .weights files, with `seen` as the resume counter
(examples/detector.c:132-147, src/parser.c:959-976,1219-1225).  Here the full
TrainState (params, optimizer momentum, EMA quant ranges, step) is flattened
to its leaves and written as one ``ckpt_<step>.npz`` per saved step, so resume
is exact — including QAT phase and LR schedule position.  Only numpy is
needed to read or write one.  models/darknet_weights.py provides the
interchange path to the reference's binary format.
"""

from __future__ import annotations

import os
import re

import jax
import numpy as np

from yoloq.train.qat import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.npz$")
MAX_TO_KEEP = 5


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step}.npz")


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m
    )


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int | None = None) -> None:
    """Write ``state`` as ``ckpt_<step>.npz`` and keep the newest MAX_TO_KEEP."""
    step = int(state.step) if step is None else step
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = jax.tree.leaves(state._asdict())
    arrays = {f"leaf_{i:05d}": np.asarray(v) for i, v in enumerate(leaves)}
    # write-then-rename: a kill mid-save never leaves a truncated latest file
    tmp = _path(ckpt_dir, step) + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, _path(ckpt_dir, step))
    for old in _steps(ckpt_dir)[:-MAX_TO_KEEP]:
        os.remove(_path(ckpt_dir, old))


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, template: TrainState, step: int | None = None) -> TrainState:
    """Restore into the structure of ``template`` (from init_train_state)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    leaves, treedef = jax.tree.flatten(template._asdict())
    with np.load(_path(ckpt_dir, step)) as z:
        if len(z.files) != len(leaves):
            raise ValueError(
                f"checkpoint step {step} holds {len(z.files)} arrays; the "
                f"template has {len(leaves)} leaves"
            )
        restored = []
        for i, ref in enumerate(leaves):
            a = z[f"leaf_{i:05d}"]
            if a.shape != np.shape(ref) or a.dtype != np.asarray(ref).dtype:
                raise ValueError(
                    f"checkpoint leaf {i}: {a.dtype}{a.shape} does not match "
                    f"the template's {np.asarray(ref).dtype}{np.shape(ref)}"
                )
            restored.append(a)
    return TrainState(**jax.tree.unflatten(treedef, restored))


def checkpoint_cadence(step: int) -> bool:
    """darknet cadence: every 100 below 1000, else every 10000
    (examples/detector.c:132-147); the rolling .backup every 100 is subsumed
    by the keep-newest rotation in save_checkpoint."""
    if step < 1000:
        return step % 100 == 0
    return step % 10000 == 0
