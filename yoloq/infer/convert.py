"""QAT checkpoint -> integer program conversion.

The offline step that turns float params + learned quantization ranges into a
pure-integer inference program, replacing the reference's
quantization_weights_and_activations preprocessing (src/blas.c:259-346):

  per quantized conv:  fold BN (rolling stats) into weights/bias
                       per-channel weight nudge -> uint8 weights (as int8-128)
                       inherit input scale from the producing layer
                       fold all static zero-point terms + float bias into one
                       int32 bias (src/blas.c:306-334 weights_sum_int fold)
                       requant multiplier M = S1*S2/S3 as f32 AND as the
                       gemmlowp (M0, shift) pair for serialization parity
  maxpool/upsample:    output scale := input scale (exact; max and
                       nearest-repeat are value-preserving on codes)
  route:               multi-input concat re-quantizes each branch onto the
                       learned common grid — fixing the reference's silent
                       scale-mismatch concat (src/route_layer.c:107-130,
                       SURVEY §"hard parts")
  shortcut:            float-domain add between dequantized branches,
                       re-quantized to a learned range (the reference has no
                       quantized shortcut at all)

All conversion math is host-side numpy on concrete arrays; the result is an
``IntProgram`` whose arrays form a pytree that infer/engine.py jits over.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from yoloq.core.quant import QUANT_MAX, QUANT_MIN, quantize_multiplier
from yoloq.nn.graph import (
    SIMPLE_SPECS,
    ConvSpec,
    DetectionSpec,
    MaxPoolSpec,
    NetworkDef,
    RegionSpec,
    RouteSpec,
    ShortcutSpec,
    UpsampleSpec,
    YoloSpec,
)
from yoloq.ops.qconv import ACTIVATION_BY_NAME, fold_static_bias

BN_EPS = 1e-6  # matches nn/layers.py and reference src/blas.c:576


def _s2d_weights(w_i8: np.ndarray) -> np.ndarray:
    """Space-to-depth rewrite of a 3x3/stride-1/pad-1 conv kernel.

    A 2x2 space-to-depth moves pixel phases into channels: x(H,W,C) becomes
    xs(H/2,W/2,4C) with slot (qy,qx,c).  The original conv's output at
    (2i+py, 2j+px, o) is then a 3x3 conv over BLOCKS: each original tap u has
    exactly one (block offset A, input phase qy) with 2A+qy = py+u, so the
    block kernel (3,3,4C,4O) holds the original taps scattered by phase with
    structural zeros elsewhere.  Integer math is identical tap-for-tap — the
    engine uses this to contract the 3/16/32-channel stem convs over 4x the
    channels (see PERF.md for what it measured).

    Output slot layout: (py,px,o) -> (py*2+px)*O + o; the following 2x2/s2
    maxpool is an elementwise max over the 4 phase groups.
    """
    kh, kw, c, o = w_i8.shape
    assert (kh, kw) == (3, 3)
    w2 = np.zeros((3, 3, 4 * c, 4 * o), np.int8)
    for py in (0, 1):
        for px in (0, 1):
            for u in (-1, 0, 1):
                qy, ay = (py + u) % 2, (py + u) // 2
                for v in (-1, 0, 1):
                    qx, ax = (px + v) % 2, (px + v) // 2
                    w2[
                        ay + 1, ax + 1,
                        (qy * 2 + qx) * c : (qy * 2 + qx + 1) * c,
                        (py * 2 + px) * o : (py * 2 + px + 1) * o,
                    ] = w_i8[u + 1, v + 1]
    return w2


def _nudge_np(lo: float, hi: float) -> tuple[float, int]:
    """Scalar numpy twin of core.quant.nudge_min_max (reference src/blas.c:68-89)."""
    lo, hi = min(lo, 0.0), max(hi, 0.0)
    rng = hi - lo
    scale = (rng if rng > 0 else 1.0) / (QUANT_MAX - QUANT_MIN)
    zp = int(np.clip(np.round(-lo / scale), QUANT_MIN, QUANT_MAX))
    return float(scale), zp


@dataclass
class QuantizedLayerCfg:
    """Static (non-array) config for one layer of the integer program."""

    kind: str  # qconv | maxpool | upsample | route | shortcut | yolo
    spec: Any
    out_scale: float
    out_zp: int
    # qconv extras
    act: int = 0
    quant_stop: bool = False
    symmetric_w: bool = False  # all weight zero-points == 128 (0 shifted)
    # space-to-depth conv+pool rewrite available (arrays carry w_s2d etc.):
    # the engine may run this conv+following-pool as phase-space conv + phase
    # max (see _s2d_weights) — bit-identical, 4x the contraction depth on
    # small-channel stems
    s2d_pool: bool = False
    # route extras: per-branch (identity, ratio, zp_in) — ratio = s_in/s_out
    branches: tuple = ()
    # shortcut extras
    in_scales: tuple = ()


@dataclass
class IntProgram:
    """A fully-converted integer inference graph.

    ``arrays`` maps layer index -> named numpy arrays (weights, biases,
    multipliers); ``cfg`` holds the static per-layer configuration.  The pair
    is what infer/engine.py compiles; it is also the serialization unit.
    """

    net: NetworkDef
    cfg: list[QuantizedLayerCfg]
    arrays: dict[int, dict[str, np.ndarray]]
    in_scale: float
    in_zp: int
    meta: dict = field(default_factory=dict)


def convert(
    net: NetworkDef, params, quant_state, *, symmetric_weights: bool = True,
    route_rescale: bool = True,
) -> IntProgram:
    """Build the integer program from float params + learned ranges.

    ``symmetric_weights=True`` (default) quantizes weights
    symmetrically per channel: scale = max|w| / 127, zero point fixed at 128
    in uint8 codes (0 after the int8 shift).  This kills the data-dependent
    zero-point cross term -zw[o]*patchsum(x) of Jacob et al. eq. 7, so the
    engine runs ONE int8 conv per layer instead of two — the standard
    TFLite/production scheme.  Activations stay asymmetric uint8.

    ``symmetric_weights=False`` reproduces the reference's fully-asymmetric
    weight quantization (src/blas.c:108-168) for byte-parity with darknet
    checkpoint files.

    ``route_rescale=False`` reproduces the reference's raw-byte concat
    (src/route_layer.c:107-130): branches of a multi-input route are copied
    as codes without regridding onto the learned common scale.  Numerically
    wrong across mismatched branch scales (SURVEY §"hard parts") but needed
    for C-parity comparisons; the default requantizes correctly.
    """
    params = {k: {n: np.asarray(v) for n, v in p.items()} for k, p in params.items()}
    qs = {k: {n: float(v) for n, v in st.items()} for k, st in quant_state.items()}

    in_scale, in_zp = _nudge_np(qs["input"]["min"], qs["input"]["max"])
    domains = net.output_domains()
    shapes = net.shapes()
    referenced = set()  # layer outputs consumed by non-sequential consumers
    for s in net.specs:
        if isinstance(s, RouteSpec):
            referenced.update(s.layers)
        elif isinstance(s, ShortcutSpec):
            referenced.add(s.index)
    out_qp: list[tuple[float, int] | None] = []  # (scale, zp) of u8 outputs
    cfg: list[QuantizedLayerCfg] = []
    arrays: dict[int, dict[str, np.ndarray]] = {}

    cur_qp: tuple[float, int] | None = (in_scale, in_zp)
    for i, s in enumerate(net.specs):
        in_domain = domains[i - 1] if i > 0 else "u8"
        if isinstance(s, ConvSpec) and not s.quantized:
            # float conv: fold BN into f32 weights; engine dequantizes a u8
            # input with the producer's qp (reference float path,
            # src/convolutional_layer.c:802-848)
            p = params[i]
            w = p["w"].astype(np.float64)
            if s.batch_normalize:
                inv = p["gamma"] / (np.sqrt(p["var"]) + BN_EPS)
                w = w * inv.reshape(1, 1, 1, -1)
                bias = p["bias"] - p["mean"] * inv
            else:
                bias = p["bias"].astype(np.float64)
            arrays[i] = {"w_f32": w.astype(np.float32), "bias_f32": bias.astype(np.float32)}
            cfg.append(
                QuantizedLayerCfg(
                    kind="fconv", spec=s, out_scale=0.0, out_zp=0,
                    in_scales=((cur_qp if in_domain == "u8" else None),),
                )
            )
            cur_qp = None
            out_qp.append(None)
            continue

        if isinstance(s, ConvSpec):
            p = params[i]
            w = p["w"].astype(np.float64)  # HWIO
            if s.batch_normalize:
                inv = p["gamma"] / (np.sqrt(p["var"]) + BN_EPS)
                w = w * inv.reshape(1, 1, 1, -1)
                bias = p["bias"] - p["mean"] * inv
            else:
                bias = p["bias"].astype(np.float64)

            if symmetric_weights:
                # symmetric per-channel: scale = max|w|/127, zp = 128 (u8)
                absmax = np.abs(w).max(axis=(0, 1, 2))
                s_w = np.where(absmax > 0, absmax, 1.0) / 127.0
                zp_w = np.full(w.shape[-1], 128, np.int64)
                w_i8 = np.clip(
                    np.round(w / s_w.reshape(1, 1, 1, -1)), -127, 127
                ).astype(np.int8)
                w_u8 = w_i8.astype(np.int64) + 128
            else:
                # per-channel asymmetric (reference src/blas.c:108-168)
                w_min = np.minimum(w.min(axis=(0, 1, 2)), 0.0)
                w_max = np.maximum(w.max(axis=(0, 1, 2)), 0.0)
                rngs = np.where(w_max - w_min > 0, w_max - w_min, 1.0)
                s_w = rngs / (QUANT_MAX - QUANT_MIN)
                zp_w = np.clip(np.round(-w_min / s_w), QUANT_MIN, QUANT_MAX).astype(np.int64)
                w_u8 = np.clip(
                    np.round(w / s_w.reshape(1, 1, 1, -1)) + zp_w.reshape(1, 1, 1, -1),
                    QUANT_MIN,
                    QUANT_MAX,
                ).astype(np.int64)
                w_i8 = (w_u8 - 128).astype(np.int8)

            qin = None
            if in_domain == "f32":
                # float -> quant boundary: quantize the input with the range
                # tracked at this boundary during QAT (in_{i} state)
                key = f"in_{i}"
                if key not in qs:
                    raise ValueError(
                        f"layer {i}: quantized conv after a float layer needs "
                        f"a tracked input range ({key}) — run QAT calibration"
                    )
                qin = _nudge_np(qs[key]["min"], qs[key]["max"])
                cur_qp = qin
            s_in, zp_in = cur_qp
            so, zo = _nudge_np(qs[f"act_{i}"]["min"], qs[f"act_{i}"]["max"])

            # static zero-point folds (reference src/blas.c:306-334), in the
            # int8-shifted domain used by the int8 GEMMs
            x_zp_s = zp_in - 128
            w_zp_s = zp_w - 128
            bias_i32 = fold_static_bias(bias, s_in, s_w, x_zp_s, w_zp_s, w_i8)

            m = (s_in * s_w / so).astype(np.float64)
            m0, shift = quantize_multiplier(m)

            arrays[i] = {
                "w_i8": w_i8,
                "bias_i32": bias_i32,
                "m": m.astype(np.float32),
                "x_zp": np.int32(x_zp_s),
                "w_zp": w_zp_s.astype(np.int32),
                "out_zp": np.int32(zo),
                # serialization-parity artifacts (not used by the f32 epilogue)
                "m0": m0,
                "m_shift": shift,
                "w_scale": s_w.astype(np.float32),
                "w_zp_u8": zp_w.astype(np.uint8),
            }
            if i == 0:
                # dynamic input quantization (reference src/blas.c:213-256
                # re-quantizes every image): the engine's dynamic_input mode
                # rebuilds this layer's bias/multiplier per image from the
                # BN-folded float bias and the weight sums, so those raw
                # ingredients ship with the program
                arrays[i]["bias_f"] = bias.astype(np.float32)
                arrays[i]["wsum_i32"] = (
                    w_i8.astype(np.int64).sum(axis=(0, 1, 2)).astype(np.int32)
                )
                arrays[i]["out_scale_f"] = np.float32(so)
            # space-to-depth conv+pool rewrite for small-channel stems
            in_ch = shapes[i - 1][2] if i > 0 else net.channels
            oh, ow, _ = shapes[i]
            nxt = net.specs[i + 1] if i + 1 < len(net.specs) else None
            if (
                symmetric_weights
                and not s.quant_stop
                and s.size == 3 and s.stride == 1 and s.pad == 1
                and in_ch <= 32
                and oh % 2 == 0 and ow % 2 == 0
                and isinstance(nxt, MaxPoolSpec)
                and nxt.size == 2 and nxt.stride == 2 and nxt.padding == 1
                and i not in referenced and (i + 1) not in referenced
            ):
                # phase-max happens on the int32 accumulators, so the plain
                # per-channel bias/m apply after the max — no tiled copies
                arrays[i]["w_s2d"] = _s2d_weights(w_i8)
                s2d = True
            else:
                s2d = False
            cfg.append(
                QuantizedLayerCfg(
                    kind="qconv",
                    spec=s,
                    out_scale=so,
                    out_zp=zo,
                    act=ACTIVATION_BY_NAME[s.activation],
                    quant_stop=s.quant_stop,
                    symmetric_w=symmetric_weights,
                    in_scales=(qin,),
                    s2d_pool=s2d,
                )
            )
            cur_qp = None if s.quant_stop else (so, zo)

        elif isinstance(s, (MaxPoolSpec, UpsampleSpec)):
            # domain-preserving; u8 path inherits the producer's qp exactly
            cfg.append(
                QuantizedLayerCfg(
                    kind="maxpool" if isinstance(s, MaxPoolSpec) else "upsample",
                    spec=s,
                    out_scale=cur_qp[0] if cur_qp else 0.0,
                    out_zp=cur_qp[1] if cur_qp else 0,
                )
            )

        elif isinstance(s, RouteSpec):
            srcs = [out_qp[j] for j in s.layers]
            if domains[i] == "u8":
                if len(srcs) == 1:
                    so, zo = srcs[0]
                else:
                    so, zo = _nudge_np(qs[f"act_{i}"]["min"], qs[f"act_{i}"]["max"])
                branches = []
                for (sb, zb) in srcs:
                    ratio = sb / so
                    identity = (
                        not route_rescale
                        or (abs(ratio - 1.0) < 1e-9 and zb == zo)
                    )
                    branches.append((identity, float(ratio), int(zb)))
                cfg.append(
                    QuantizedLayerCfg(
                        kind="route", spec=s, out_scale=so, out_zp=zo,
                        branches=tuple(branches),
                    )
                )
                cur_qp = (so, zo)
            else:
                # mixed/float concat: dequantize u8 branches, concat in f32
                cfg.append(
                    QuantizedLayerCfg(
                        kind="route_f32", spec=s, out_scale=0.0, out_zp=0,
                        branches=tuple(srcs),  # qp or None per branch
                    )
                )
                cur_qp = None

        elif isinstance(s, ShortcutSpec):
            skip_qp = out_qp[s.index]
            if domains[i] == "u8":
                so, zo = _nudge_np(qs[f"act_{i}"]["min"], qs[f"act_{i}"]["max"])
                cfg.append(
                    QuantizedLayerCfg(
                        kind="shortcut", spec=s, out_scale=so, out_zp=zo,
                        in_scales=(cur_qp, skip_qp),
                    )
                )
                cur_qp = (so, zo)
            else:
                cfg.append(
                    QuantizedLayerCfg(
                        kind="shortcut_f32", spec=s, out_scale=0.0, out_zp=0,
                        in_scales=(cur_qp, skip_qp),  # qp or None per input
                    )
                )
                cur_qp = None

        elif isinstance(s, YoloSpec):
            cfg.append(
                QuantizedLayerCfg(
                    kind="yolo", spec=s,
                    out_scale=cur_qp[0] if cur_qp else 0.0,
                    out_zp=cur_qp[1] if cur_qp else 0,
                )
            )
        elif isinstance(s, SIMPLE_SPECS):
            # extended float-only layers: engine dequantizes a u8 input with
            # the producer's qp then runs the shared float implementation
            if i in params:
                arrays[i] = {k: v.astype(np.float32) for k, v in params[i].items()}
            cfg.append(
                QuantizedLayerCfg(
                    kind="simple", spec=s, out_scale=0.0, out_zp=0,
                    in_scales=((cur_qp if in_domain == "u8" else None),),
                )
            )
            cur_qp = None
        else:
            raise TypeError(f"unknown spec {s}")

        out_qp.append(cur_qp)

    return IntProgram(
        net=net, cfg=cfg, arrays=arrays, in_scale=in_scale, in_zp=in_zp
    )
