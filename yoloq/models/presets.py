"""Canonical ready-to-run model builds (flagship configs + synthetic ranges).

``flagship_program`` builds the reference benchmark config — quantized
yolov3-tiny, 416x416, 5 classes, relu6, per-channel weights
(cfg/yolov3_tiny_quant_channelwise.cfg + BASELINE.md) — with deterministic
synthetic quantization ranges suitable for compile checks and speed
benchmarks (accuracy-bearing ranges come from QAT or calibration).
"""

from __future__ import annotations

import numpy as np

from yoloq.infer.convert import IntProgram, convert
from yoloq.models import zoo
from yoloq.nn.graph import (
    ConvSpec,
    NetworkDef,
    init_params_numpy,
    init_quant_state,
)


def synthetic_quant_state(net: NetworkDef):
    """Plausible fixed ranges: input [0,1] (letterboxed images), relu6 convs
    [0,6], linear heads symmetric — enough for compile/perf work without QAT."""
    qs = init_quant_state(net)
    qs["input"] = {"min": np.float32(0.0), "max": np.float32(1.0)}
    for i, s in enumerate(net.specs):
        key = f"act_{i}"
        if key not in qs:
            continue
        if isinstance(s, ConvSpec) and s.activation == "relu6":
            qs[key] = {"min": np.float32(0.0), "max": np.float32(6.0)}
        elif isinstance(s, ConvSpec) and s.activation == "linear":
            qs[key] = {"min": np.float32(-12.0), "max": np.float32(12.0)}
        else:  # leaky convs, routes, shortcuts
            qs[key] = {"min": np.float32(-2.0), "max": np.float32(6.0)}
    return qs


def flagship_network(classes: int = 5, size: int = 416) -> NetworkDef:
    return zoo.yolov3_tiny(classes=classes, width=size, height=size)


def flagship_program(classes: int = 5, size: int = 416, seed: int = 0) -> IntProgram:
    net = flagship_network(classes, size)
    params = init_params_numpy(seed, net)
    return convert(net, params, synthetic_quant_state(net))


def conv_shapes(net: NetworkDef) -> list[tuple[int, int, int, int, int, int]]:
    """(input height, in channels, out channels, kernel, stride, pad) of
    every conv layer of ``net``, in layer order."""
    shapes = net.shapes()
    out = []
    for i, s in enumerate(net.specs):
        if isinstance(s, ConvSpec):
            h, _, c = shapes[i - 1] if i else (net.height, net.width, net.channels)
            out.append((h, c, s.filters, s.size, s.stride, s.pad))
    return out


def distinct_conv_shapes(size: int = 416) -> list[tuple[int, int, int, int, int, int]]:
    """The distinct conv shapes of the flagship yolov3-tiny and of the full
    yolov3 (80 classes) at ``size``, largest map first."""
    nets = (flagship_network(size=size), zoo.yolov3(classes=80, width=size, height=size))
    found = {t for net in nets for t in conv_shapes(net)}
    return sorted(found, key=lambda t: (-t[0], t[1], t[2], t[3], t[4]))
