"""Float inference engine — the reference's close_quantization fallback.

Mode 4 of the capability matrix (SURVEY.md): run the graph in float (BN
rolling stats, no fake-quant), same predict() API as the integer Engine.
Used for float checkpoints (no learned quant ranges yet) and as the accuracy
reference when validating quantization (the float row of README.md:57).

Both engines here are references, so their float32 convolutions run at
``highest`` matmul precision: on a GPU the default lets them run in TF32,
which keeps about three decimal digits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from yoloq.eval import detect
from yoloq.nn.graph import (
    HEAD_SPECS,
    ForwardMode,
    NetworkDef,
    YoloSpec,
    forward,
)

REFERENCE_PRECISION = "highest"


def reference_forward(net, params, x, mode=ForwardMode(), quant_state=None):
    """nn.graph.forward with float32 convolutions at full precision."""
    with jax.default_matmul_precision(REFERENCE_PRECISION):
        return forward(net, params, x, mode, quant_state)


class FloatEngine:
    def __init__(self, net: NetworkDef, params, max_det: int = 256,
                 _device_params=None):
        self.net = net
        self.max_det = max_det
        self.params = (
            _device_params
            if _device_params is not None
            else jax.device_put(
                {i: {k: np.asarray(v) for k, v in p.items()} for i, p in params.items()}
            )
        )
        self._size_cache: dict[tuple[int, int], "FloatEngine"] = {}
        head_specs = [s for s in net.specs if isinstance(s, HEAD_SPECS)]

        @jax.jit
        def _run(params, x):
            heads, _ = reference_forward(net, params, x)
            boxes, obj, cls = detect.decode_all_heads(heads, net)
            return detect.top_k_detections(boxes, obj, cls, max_det)

        @jax.jit
        def _run_flip(params, x):
            # same flip TTA as the integer Engine (`detector valid2`,
            # examples/detector.c:260-388): mirror in one doubled batch,
            # average the raw yolo heads, decode once
            n = x.shape[0]
            heads, _ = reference_forward(
                net, params, jnp.concatenate([x, x[:, :, ::-1, :]], axis=0)
            )
            merged = []
            for h_raw, spec in zip(heads, head_specs):
                if isinstance(spec, YoloSpec):
                    merged.append(
                        detect.flip_average_head(h_raw[:n], h_raw[n:], spec.classes)
                    )
                else:
                    merged.append(h_raw[:n])
            boxes, obj, cls = detect.decode_all_heads(merged, net)
            return detect.top_k_detections(boxes, obj, cls, max_det)

        self._run = _run
        self._run_flip = _run_flip
        self._raw = jax.jit(
            lambda p, x: reference_forward(net, p, x)[0]
        )

    @property
    def program(self):  # duck-type Engine for eval harnesses
        class _P:
            net = self.net

        return _P()

    def at_size(self, height: int, width: int | None = None) -> "FloatEngine":
        """Per-resolution engine cache (see Engine.at_size): the graph is
        shape-polymorphic, so a resolution is one more cached jit."""
        width = width or height
        if (height, width) == (self.net.height, self.net.width):
            return self
        if height % 32 or width % 32:
            raise ValueError(
                f"input size must be a multiple of 32, got {height}x{width}"
            )
        key = (height, width)
        eng = self._size_cache.get(key)
        if eng is None:
            import dataclasses

            net = dataclasses.replace(self.net, height=height, width=width)
            eng = FloatEngine(
                net, None, max_det=self.max_det, _device_params=self.params
            )
            self._size_cache[key] = eng
        return eng

    def predict(self, images: np.ndarray, flip: bool = False):
        net = self.net
        if images.shape[1:] != (net.height, net.width, net.channels):
            raise ValueError(
                f"engine expects {(net.height, net.width, net.channels)} images, "
                f"got {images.shape[1:]}"
            )
        run = self._run_flip if flip else self._run
        boxes, obj, cls = run(self.params, jnp.asarray(images))
        return np.asarray(boxes), np.asarray(obj), np.asarray(cls)

    def raw_heads(self, images: np.ndarray):
        heads = self._raw(self.params, jnp.asarray(images))
        return [np.asarray(h) for h in heads]


class QatSimEngine:
    """Fake-quant SIMULATION forward with the Engine predict() API.

    Runs the exact graph QAT optimized (ForwardMode(train=False, qat=True)
    with the trained quant ranges) — the faithfulness reference for the
    integer engine: if Engine matches this, any gap to FloatEngine is the
    quantization itself; if Engine diverges from this, the integer
    implementation is wrong (scripts/accuracy_capstone.py protocol, made
    reusable for the CI gates).
    """

    def __init__(self, net: NetworkDef, params, quant_state, max_det: int = 256):
        self.net = net
        self.max_det = max_det
        self.params = jax.device_put(
            {i: {k: np.asarray(v) for k, v in p.items()}
             for i, p in params.items()}
        )
        qs = jax.device_put(
            {k: {n: np.asarray(v) for n, v in st.items()}
             for k, st in quant_state.items()}
        )

        @jax.jit
        def _run(params, x):
            heads, _ = reference_forward(
                net, params, x, ForwardMode(train=False, qat=True), qs
            )
            boxes, obj, cls = detect.decode_all_heads(heads, net)
            return detect.top_k_detections(boxes, obj, cls, max_det)

        self._run = _run

    @property
    def program(self):  # duck-type Engine for eval harnesses
        class _P:
            net = self.net

        return _P()

    def predict(self, images: np.ndarray):
        boxes, obj, cls = self._run(self.params, jnp.asarray(images))
        return np.asarray(boxes), np.asarray(obj), np.asarray(cls)
