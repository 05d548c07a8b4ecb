"""Declarative network graph: layer specs, parameter init, float/QAT forward.

Replaces the reference's cfg-file parser + mutable layer structs + sequential
executor (src/parser.c:682-815, src/network.c:229-338) with an immutable spec
list and a pure functional forward.  A model is a tuple of *Spec dataclasses;
parameters and quantization state are pytrees keyed by layer index, so the
whole forward jits and shards with pjit without any graph-side mutation.

Forward modes:
  - float inference  (BN rolling stats)               — parity with reference
    float path (src/convolutional_layer.c:802-848)
  - float training   (BN batch stats, stats returned for rolling update)
  - QAT              (BN folded into weights with batch-stat correction,
    per-channel weight fake-quant, EMA-tracked activation fake-quant) —
    the reference's GPU QAT graph (src/convolutional_kernels.cu:107-216)
    without its per-step host round-trips.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Sequence

import jax
import jax.numpy as jnp

from yoloq.core.quant import (
    ema_update,
    fake_quant,
    fake_quant_learned,
    fake_quant_per_channel,
    fake_quant_symmetric_per_channel,
)
from yoloq.nn import layers as L


# ---------------------------------------------------------------------------
# Layer specs (succeed the darknet cfg sections, reference src/parser.c:710-787)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvSpec:
    filters: int
    size: int = 3
    stride: int = 1
    pad: int = 1
    activation: str = "leaky"
    batch_normalize: bool = True
    quantized: bool = True
    quant_stop: bool = False  # dequantize output to float (YOLO head input)


@dataclass(frozen=True)
class MaxPoolSpec:
    size: int = 2
    stride: int = 2
    pad: int | None = None  # darknet default: size - 1 (src/parser.c parse_maxpool)
    quantized: bool = True

    @property
    def padding(self) -> int:
        return self.size - 1 if self.pad is None else self.pad


@dataclass(frozen=True)
class RouteSpec:
    layers: tuple[int, ...]  # absolute layer indices (cfg importer normalizes)
    quantized: bool = True
    # cfg `first_time=1`: fine-tuning a pre-quantization checkpoint — the
    # weights file has no quant block for this layer; inherit the range from
    # the first input instead (reference src/parser.c:1176-1183)
    first_time: bool = False


@dataclass(frozen=True)
class UpsampleSpec:
    stride: int = 2
    quantized: bool = True
    first_time: bool = False  # like RouteSpec (reference src/parser.c:1187-1191)


@dataclass(frozen=True)
class ShortcutSpec:
    index: int  # absolute layer index of the skip source
    activation: str = "linear"


@dataclass(frozen=True)
class YoloSpec:
    mask: tuple[int, ...]
    anchors: tuple[tuple[float, float], ...]  # ALL anchors; mask selects
    classes: int


# --- extended darknet layer set (SURVEY §2.3), all float-domain -------------


@dataclass(frozen=True)
class ConnectedSpec:
    """Fully-connected layer (src/connected_layer.c)."""

    outputs: int
    activation: str = "linear"
    batch_normalize: bool = False


@dataclass(frozen=True)
class SoftmaxSpec:
    """Softmax over channels (src/softmax_layer.c).

    With ``tree`` set, softmax runs independently within each sibling group of
    the hierarchy (WordTree, src/softmax_layer.c:41-48 / src/tree.c).
    """

    groups: int = 1
    temperature: float = 1.0
    tree: Any = None  # core.tree.HierarchyTree | None (hashable)


@dataclass(frozen=True)
class AvgPoolSpec:
    """Global average pool (src/avgpool_layer.c)."""


@dataclass(frozen=True)
class DropoutSpec:
    probability: float = 0.5


@dataclass(frozen=True)
class CropSpec:
    crop_height: int
    crop_width: int
    flip: bool = False


@dataclass(frozen=True)
class LocalSpec:
    """Locally-connected conv (src/local_layer.c, yolov1 head)."""

    filters: int
    size: int = 3
    stride: int = 1
    pad: int = 0
    activation: str = "leaky"


@dataclass(frozen=True)
class DeconvSpec:
    """Transpose conv (src/deconvolutional_layer.c): VALID, out=(in-1)*s+k."""

    filters: int
    size: int = 3
    stride: int = 1
    activation: str = "leaky"
    batch_normalize: bool = False


@dataclass(frozen=True)
class ReorgSpec:
    stride: int = 2
    reverse: bool = False


@dataclass(frozen=True)
class LRNSpec:
    """[normalization] local response norm (src/normalization_layer.c)."""

    size: int = 5
    alpha: float = 0.0001
    beta: float = 0.75
    kappa: float = 1.0


@dataclass(frozen=True)
class L2NormSpec:
    pass


@dataclass(frozen=True)
class LogisticSpec:
    """Standalone logistic activation layer (src/logistic_layer.c)."""


@dataclass(frozen=True)
class ActivationSpec:
    activation: str = "linear"


@dataclass(frozen=True)
class BatchNormSpec:
    """Standalone batchnorm layer (src/batchnorm_layer.c)."""


@dataclass(frozen=True)
class RegionSpec:
    """YOLOv2 head (src/region_layer.c): logistic x/y/obj, softmax classes."""

    anchors: tuple[tuple[float, float], ...]
    classes: int = 20
    num: int = 5
    softmax: bool = True
    tree: Any = None  # core.tree.HierarchyTree | None — WordTree classes
    # anchors are in feature-grid units (unlike YoloSpec's input pixels)
    # loss term weights (src/parser.c parse_region; defaults here are the
    # canonical yolov2-voc cfg values, which region_head_loss also defaults)
    object_scale: float = 5.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0
    rescore: bool = True
    thresh: float = 0.6


@dataclass(frozen=True)
class DetectionSpec:
    """YOLOv1 head (src/detection_layer.c), fed by a connected layer."""

    classes: int = 20
    num: int = 2
    side: int = 7
    coords: int = 4
    sqrt: bool = True
    rescore: bool = False  # obj target = IoU instead of 1 (detection_layer.c:166)
    softmax: bool = False  # softmax the class block (detection_layer.c:57-66)
    forced: bool = False   # predictor by truth size (detection_layer.c:136-142)
    random: bool = False   # random predictor while seen < 64000 (:143-145)
    # loss term weights (src/parser.c parse_detection; the canonical v1 cfgs
    # set 1 / 0.5 / 1 / 5 — without coord_scale 5 the responsible-box
    # localization gradient is drowned by the S*S*N no-object conf terms)
    object_scale: float = 1.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0


LayerSpec = Any  # union of the above

HEAD_SPECS = (YoloSpec, RegionSpec, DetectionSpec)


@dataclass(frozen=True)
class NetworkDef:
    """A model: input geometry + ordered layer specs (the cfg [net] + sections)."""

    specs: tuple[LayerSpec, ...]
    width: int = 416
    height: int = 416
    channels: int = 3

    def shapes(self) -> list[tuple[int, int, int]]:
        """Static shape inference: (h, w, c) produced by each layer.

        Fully-connected outputs are reported as (1, 1, outputs), matching
        darknet's flattened handling (src/connected_layer.c).
        """
        out: list[tuple[int, int, int]] = []
        h, w, c = self.height, self.width, self.channels
        for i, s in enumerate(self.specs):
            if isinstance(s, ConvSpec):
                h = (h + 2 * s.pad - s.size) // s.stride + 1
                w = (w + 2 * s.pad - s.size) // s.stride + 1
                c = s.filters
            elif isinstance(s, MaxPoolSpec):
                p = s.padding
                h = (h + p - s.size) // s.stride + 1
                w = (w + p - s.size) // s.stride + 1
            elif isinstance(s, UpsampleSpec):
                h, w = h * s.stride, w * s.stride
            elif isinstance(s, RouteSpec):
                h, w, _ = out[s.layers[0]]
                c = sum(out[j][2] for j in s.layers)
            elif isinstance(s, (ShortcutSpec, YoloSpec, RegionSpec, DetectionSpec,
                                SoftmaxSpec, DropoutSpec, LRNSpec, L2NormSpec,
                                LogisticSpec, ActivationSpec, BatchNormSpec)):
                pass
            elif isinstance(s, ConnectedSpec):
                h, w, c = 1, 1, s.outputs
            elif isinstance(s, AvgPoolSpec):
                h, w = 1, 1
            elif isinstance(s, CropSpec):
                h, w = s.crop_height, s.crop_width
            elif isinstance(s, LocalSpec):
                h = (h + 2 * s.pad - s.size) // s.stride + 1
                w = (w + 2 * s.pad - s.size) // s.stride + 1
                c = s.filters
            elif isinstance(s, DeconvSpec):
                h = (h - 1) * s.stride + s.size
                w = (w - 1) * s.stride + s.size
                c = s.filters
            elif isinstance(s, ReorgSpec):
                if s.reverse:
                    h, w, c = h * s.stride, w * s.stride, c // (s.stride**2)
                else:
                    h, w, c = h // s.stride, w // s.stride, c * s.stride**2
            else:
                raise TypeError(f"unknown spec {s}")
            out.append((h, w, c))
        return out

    def out_channels(self) -> list[int]:
        """Static shape inference: #channels produced by each layer."""
        return [c for (_, _, c) in self.shapes()]

    def head_indices(self) -> list[int]:
        return [i for i, s in enumerate(self.specs) if isinstance(s, HEAD_SPECS)]

    def output_domains(self) -> list[str]:
        """Static per-layer output domain at integer inference: "u8" or "f32".

        Drives mixed float/quant graphs (the reference's per-layer
        ``quantized=`` flags, src/parser.c:193-194): quantized convs emit u8
        (f32 when quant_stop dequantizes), float convs emit f32,
        maxpool/upsample inherit, a route is u8 only if every branch is,
        a shortcut is u8 only if both inputs are.
        """
        doms: list[str] = []

        def inp(i: int) -> str:
            return doms[i - 1] if i > 0 else "u8"  # net input is quantized

        for i, s in enumerate(self.specs):
            if isinstance(s, ConvSpec):
                d = ("f32" if s.quant_stop else "u8") if s.quantized else "f32"
            elif isinstance(s, (MaxPoolSpec, UpsampleSpec)):
                d = inp(i)
            elif isinstance(s, RouteSpec):
                d = "u8" if s.quantized and all(doms[j] == "u8" for j in s.layers) else "f32"
            elif isinstance(s, ShortcutSpec):
                d = "u8" if inp(i) == "u8" and doms[s.index] == "u8" else "f32"
            elif isinstance(s, YoloSpec):
                d = inp(i)
            else:
                # extended layers run float at inference (the reference
                # quantizes none of them, SURVEY §2.3)
                d = "f32"
            doms.append(d)
        return doms


# ---------------------------------------------------------------------------
# Parameter / state initialization
# ---------------------------------------------------------------------------


def init_params(key: jax.Array, net: NetworkDef) -> dict[int, dict[str, jax.Array]]:
    """He-style init matching darknet's scale*randn (src/convolutional_layer.c:214-257).

    Conv params (HWIO): w, bias; with BN additionally gamma (darknet 'scales'),
    mean/var rolling stats (darknet rolling_mean/rolling_variance).  With BN
    the 'bias' slot is the BN beta, exactly like darknet reuses l.biases.
    """
    import numpy as np

    return jax.tree.map(jnp.asarray, init_params_numpy(int(jax.random.randint(key, (), 0, 2**31 - 1)), net))


def init_params_numpy(seed: int, net: NetworkDef) -> dict[int, dict[str, Any]]:
    """Host-side numpy twin of init_params — no device round-trips.

    Used by presets/bench where params are immediately consumed by the
    (numpy) converter; avoids shipping every random tensor through the
    accelerator just to pull it back.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    params: dict[int, dict[str, Any]] = {}
    shapes = net.shapes()

    def randn(shape, scale):
        return (rng.standard_normal(shape) * scale).astype("float32")

    def bn_extras(p, n):
        p["gamma"] = np.ones((n,), "float32")
        p["mean"] = np.zeros((n,), "float32")
        p["var"] = np.ones((n,), "float32")

    for i, s in enumerate(net.specs):
        in_h, in_w, in_c = shapes[i - 1] if i > 0 else (net.height, net.width, net.channels)
        if isinstance(s, ConvSpec):
            scale = float(np.sqrt(2.0 / (s.size * s.size * in_c)))
            p = {
                "w": randn((s.size, s.size, in_c, s.filters), scale),
                "bias": np.zeros((s.filters,), "float32"),
            }
            if s.batch_normalize:
                bn_extras(p, s.filters)
            params[i] = p
        elif isinstance(s, ConnectedSpec):
            fin = in_h * in_w * in_c
            p = {
                "w": randn((fin, s.outputs), float(np.sqrt(2.0 / fin))),
                "bias": np.zeros((s.outputs,), "float32"),
            }
            if s.batch_normalize:
                bn_extras(p, s.outputs)
            params[i] = p
        elif isinstance(s, LocalSpec):
            oh, ow, _ = shapes[i]
            kin = s.size * s.size * in_c
            params[i] = {
                "w": randn((oh * ow, kin, s.filters), float(np.sqrt(2.0 / kin))),
                "bias": np.zeros((oh * ow, s.filters), "float32"),
            }
        elif isinstance(s, DeconvSpec):
            scale = float(np.sqrt(2.0 / (s.size * s.size * in_c)))
            p = {
                "w": randn((s.size, s.size, in_c, s.filters), scale),
                "bias": np.zeros((s.filters,), "float32"),
            }
            if s.batch_normalize:
                bn_extras(p, s.filters)
            params[i] = p
        elif isinstance(s, BatchNormSpec):
            p = {"bias": np.zeros((in_c,), "float32")}
            bn_extras(p, in_c)
            params[i] = p
    return params


def init_quant_state(
    net: NetworkDef, input_calibration: tuple[float, ...] = ()
) -> dict[str, dict[str, jax.Array]]:
    """EMA range state for QAT: one (min, max) pair per tracked activation.

    Tracked: the network input ("input"), every quantized conv output, and
    every multi-input quantized route output.  Maxpool/upsample outputs stay on
    their input's grid (max / nearest-repeat are value-preserving), so unlike
    the reference (which fake-quants them too and then ignores the result at
    integer inference, src/maxpool_layer_kernels.cu:98-108) we do not track
    ranges for them — their scale is inherited, which the integer engine makes
    exact.  Zeros mean "unseen"; ema_update adopts the first batch stats.

    ``input_calibration`` (cfg `[net] input_calibration=`, reference
    src/parser.c:593-608 — which the reference parses and then never reads)
    seeds the input range instead of first-batch adoption: one value v means
    [0, v]; two values mean [min, max].  The EMA refines it from there.
    """
    import numpy as np

    if len(input_calibration) >= 2:
        in_lo, in_hi = float(input_calibration[0]), float(input_calibration[1])
    elif len(input_calibration) == 1:
        in_lo, in_hi = 0.0, float(input_calibration[0])
    else:
        in_lo = in_hi = 0.0
    qs: dict[str, dict[str, jax.Array]] = {
        "input": {"min": np.float32(min(in_lo, 0.0)), "max": np.float32(max(in_hi, 0.0))}
    }
    domains = net.output_domains()
    for i, s in enumerate(net.specs):
        if isinstance(s, ConvSpec) and s.quantized:
            qs[f"act_{i}"] = {"min": np.float32(0.0), "max": np.float32(0.0)}
            if i > 0 and domains[i - 1] == "f32":
                # float -> quant boundary (mixed graphs): the conv input needs
                # its own tracked range to quantize by at inference
                qs[f"in_{i}"] = {"min": np.float32(0.0), "max": np.float32(0.0)}
        elif isinstance(s, RouteSpec) and s.quantized and len(s.layers) > 1:
            qs[f"act_{i}"] = {"min": np.float32(0.0), "max": np.float32(0.0)}
        elif isinstance(s, ShortcutSpec):
            # The reference leaves shortcut float-only (src/shortcut_layer.c) and
            # therefore cannot run full yolov3 end-to-end quantized; we track a
            # range so the engine can re-quantize after the float-domain add.
            qs[f"act_{i}"] = {"min": np.float32(0.0), "max": np.float32(0.0)}
    return qs


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ForwardMode:
    train: bool = False        # BN batch stats (+ stats aux out)
    qat: bool = False          # fake-quant weights + activations
    update_ranges: bool = False  # EMA-update quant ranges (training only)
    symmetric_w: bool = True   # weight fake-quant scheme; must match the
                               # convert(symmetric_weights=...) used at export
    # conv contraction operand dtype: "float32" (default) or "bfloat16"
    # (bf16 operands, f32 accumulation/outputs — params stay f32).
    # Gated on the accuracy capstone staying in-band (PERF.md).
    compute_dtype: str = "float32"
    # activation-range statistic fed to the EMA tracker: "minmax" (reference
    # src/blas.c:38-42, raw batch extremes) or "percentile" (0.1/99.9th over
    # a strided subsample) — clips outliers so two-sided leaky ranges get
    # finer grids; the fake-quant clamp makes training see the same clipping
    # the integer engine will apply (VERDICT r3 item 4).
    range_stat: str = "minmax"
    # learnable ranges: fake-quant passes gradients to min/max (TF
    # FakeQuantWithMinMaxVars semantics) and the train step SGDs the ranges
    # on the task loss; used after an EMA warmup (train/qat.py phase plan)
    learned_ranges: bool = False


def _batch_range(y: jax.Array, stat: str) -> tuple[jax.Array, jax.Array]:
    """Per-batch activation range statistic for the EMA tracker.

    "minmax": raw extremes (reference src/blas.c:38-42).  "percentile":
    0.1/99.9th percentiles over a strided subsample (bounded sort cost at any
    resolution) — clips range-inflating outliers so two-sided leaky
    activations get a finer grid; the fake-quant clamp then makes training
    see exactly the saturation the integer engine will apply.
    """
    if stat == "minmax":
        return jnp.min(y), jnp.max(y)
    if stat.startswith("percentile"):
        # "percentile" clips 0.1% per tail; "percentile:<p>" clips p% (e.g.
        # "percentile:0.01" = 1-in-10k per tail)
        tail = float(stat.split(":", 1)[1]) if ":" in stat else 0.1
        flat = y.reshape(-1)
        step = max(flat.shape[0] // 65536, 1)
        sub = flat[::step].astype(jnp.float32)
        q = jnp.percentile(sub, jnp.asarray([tail, 100.0 - tail], jnp.float32))
        return q[0], q[1]
    raise ValueError(f"unknown range_stat {stat!r}")


def _act_fq(mode: ForwardMode):
    return fake_quant_learned if mode.learned_ranges else fake_quant


def _conv_forward(
    s: ConvSpec,
    p: dict[str, jax.Array],
    x: jax.Array,
    mode: ForwardMode,
    act_state: dict[str, jax.Array] | None,
):
    """One conv layer in any mode.  Returns (y, bn_stats|None, new_act_state|None).

    QAT path mirrors the reference training graph
    (src/convolutional_kernels.cu:107-216): compute batch statistics from a
    float conv, fold BN into the weights with those statistics, fake-quant the
    folded weights per output channel, run the real conv, add the folded bias,
    activate, and fake-quant the activation with EMA-tracked ranges.  Here the
    stats conv and the main conv share one XLA-fused graph instead of two
    cublas GEMMs with host round-trips.

    Float-phase fast path: when the weights are NOT fake-quantized,
    conv(x, w * inv) == conv(x, w) * inv exactly (per-output-channel scaling
    commutes with the contraction), so the stats conv IS the layer conv —
    one conv + a per-channel FMA instead of the reference's two GEMMs
    (src/convolutional_kernels.cu:132-153), halving forward conv FLOPs and
    the matching backward cost for the whole pre-quant_start phase.
    """
    quantizing = mode.qat and s.quantized
    bn_stats = None
    if s.batch_normalize and mode.train and not quantizing:
        pre = L.conv2d(x, p["w"], s.stride, s.pad, mode.compute_dtype)
        mean, var = L.batch_stats(pre)
        bn_stats = (mean, var)
        inv, bias = L.bn_inference_scale_bias(p["gamma"], p["bias"], mean, var)
        y = pre * inv.reshape(1, 1, 1, -1) + bias.reshape(1, 1, 1, -1)
        return L.activate(y, s.activation), bn_stats, act_state

    if s.batch_normalize:
        if mode.train:
            pre = L.conv2d(x, p["w"], s.stride, s.pad, mode.compute_dtype)
            mean, var = L.batch_stats(pre)
            bn_stats = (mean, var)
        else:
            mean, var = p["mean"], p["var"]
        w_folded, bias = L.fold_bn_into_weights(
            p["w"], None, p["gamma"], p["bias"], mean, var
        )
    else:
        w_folded, bias = p["w"], p["bias"]

    if quantizing:
        if mode.symmetric_w:
            w_used = fake_quant_symmetric_per_channel(w_folded)
        else:
            w_min = jnp.min(w_folded, axis=(0, 1, 2))
            w_max = jnp.max(w_folded, axis=(0, 1, 2))
            w_used = fake_quant_per_channel(w_folded, w_min, w_max)
    else:
        w_used = w_folded

    y = L.conv2d(x, w_used, s.stride, s.pad, mode.compute_dtype)
    y = y + bias.reshape(1, 1, 1, -1)

    # clamp-family activations FOLD INTO the fake-quant clamp, exactly:
    # relu6's nudged EMA range satisfies 0 <= lo, hi <= 6 (stats are taken
    # over activated outputs), so fq(relu6(y)) == fq(y) value- AND
    # gradient-wise (the STE gate reproduces the activation's dead zones);
    # likewise relu with (0, inf).  Batch range stats commute too: min/max
    # and percentiles of clip(y) equal clip of the raw statistics (quantiles
    # commute with monotone maps).  Saves one full-tensor elementwise pass
    # (fwd + the select in bwd) per quantized conv (TRAINBENCH r5).
    _FOLDABLE = {"relu6": (0.0, 6.0), "relu": (0.0, jnp.inf)}
    fold_bounds = (
        _FOLDABLE.get(s.activation)
        if quantizing and act_state is not None
        else None
    )
    if fold_bounds is None:
        y = L.activate(y, s.activation)

    new_state = act_state
    if quantizing and act_state is not None:
        lo, hi = act_state["min"], act_state["max"]
        if mode.update_ranges:
            # quant_stop (head) convs always use raw extremes: a detection
            # head's strong responses ARE the top percentile — clipping them
            # caps the very logits that become detections (measured: the
            # leaky 416 capstone's float F1 collapsed 92->60 when heads were
            # percentile-clipped, PERF.md)
            stat = "minmax" if s.quant_stop else mode.range_stat
            blo, bhi = _batch_range(y, stat)
            if fold_bounds is not None:
                blo = jnp.clip(blo, *fold_bounds)
                bhi = jnp.clip(bhi, *fold_bounds)
            lo, hi = ema_update(lo, hi, blo, bhi)
            new_state = {"min": lo, "max": hi}
        if fold_bounds is not None:
            # defensive scalar clips: identity for any range produced by this
            # trainer (the stats invariant above); restores exactness if a
            # loaded state ever carries an out-of-activation-bound range
            lo = jnp.clip(lo, *fold_bounds)
            hi = jnp.clip(hi, *fold_bounds)
        y = _act_fq(mode)(y, lo, hi)
    return y, bn_stats, new_state


def apply_simple_layer(
    s: LayerSpec,
    p: dict[str, jax.Array] | None,
    x: jax.Array,
    *,
    train: bool = False,
    rng: jax.Array | None = None,
) -> jax.Array:
    """Forward for the extended (float-only) darknet layer set.

    Shared by the float/QAT graph (forward below) and the integer engine
    (infer/engine.py dequantizes into here for f32-domain layers).
    """
    if isinstance(s, ConnectedSpec):
        if s.batch_normalize:
            y = L.connected(x, p["w"], jnp.zeros_like(p["bias"]))
            scale, bias = L.bn_inference_scale_bias(p["gamma"], p["bias"], p["mean"], p["var"])
            y = y * scale + bias
        else:
            y = L.connected(x, p["w"], p["bias"])
        return L.activate(y, s.activation)
    if isinstance(s, SoftmaxSpec):
        if s.tree is not None:
            from yoloq.core.tree import softmax_tree

            return softmax_tree(x, s.tree, s.temperature)
        return L.softmax(x, s.temperature, s.groups)
    if isinstance(s, AvgPoolSpec):
        return L.global_avgpool(x)
    if isinstance(s, DropoutSpec):
        return L.dropout(x, s.probability, rng if train else None)
    if isinstance(s, CropSpec):
        return L.crop(x, s.crop_height, s.crop_width, train=train, rng=rng, flip=s.flip)
    if isinstance(s, LocalSpec):
        y = L.local_conv(x, p["w"], p["bias"], s.size, s.stride, s.pad)
        return L.activate(y, s.activation)
    if isinstance(s, DeconvSpec):
        y = L.deconv2d(x, p["w"], s.stride)
        if s.batch_normalize:
            scale, bias = L.bn_inference_scale_bias(p["gamma"], p["bias"], p["mean"], p["var"])
            y = y * scale.reshape(1, 1, 1, -1) + bias.reshape(1, 1, 1, -1)
        else:
            y = y + p["bias"].reshape(1, 1, 1, -1)
        return L.activate(y, s.activation)
    if isinstance(s, ReorgSpec):
        return L.reorg(x, s.stride, s.reverse)
    if isinstance(s, LRNSpec):
        return L.lrn(x, s.size, s.alpha, s.beta, s.kappa)
    if isinstance(s, L2NormSpec):
        return L.l2norm(x)
    if isinstance(s, LogisticSpec):
        return jax.nn.sigmoid(x)
    if isinstance(s, ActivationSpec):
        return L.activate(x, s.activation)
    if isinstance(s, BatchNormSpec):
        scale, bias = L.bn_inference_scale_bias(p["gamma"], p["bias"], p["mean"], p["var"])
        shape = (1,) * (x.ndim - 1) + (-1,)
        return x * scale.reshape(shape) + bias.reshape(shape)
    if isinstance(s, RegionSpec):
        # yolov2 head forward (src/region_layer.c:160-188): logistic on x, y,
        # obj; classes get the WordTree grouped softmax when a tree is set
        # (region_layer.c:176-183), plain softmax when softmax=1, logistic
        # otherwise (region_layer.c:173)
        n, h, w, _ = x.shape
        r = x.reshape(n, h, w, s.num, 5 + s.classes)
        xy = jax.nn.sigmoid(r[..., 0:2])
        wh = r[..., 2:4]
        obj = jax.nn.sigmoid(r[..., 4:5])
        if s.tree is not None:
            from yoloq.core.tree import softmax_tree

            cls = softmax_tree(r[..., 5:], s.tree)
        elif s.softmax:
            cls = jax.nn.softmax(r[..., 5:], axis=-1)
        else:
            cls = jax.nn.sigmoid(r[..., 5:])
        return jnp.concatenate([xy, wh, obj, cls], axis=-1).reshape(x.shape)
    if isinstance(s, DetectionSpec):
        # v1 head: raw output except the optional per-cell class softmax
        # (detection_layer.c:57-66); decode happens in eval/detect.py
        if s.softmax:
            b = x.shape[0]
            s2 = s.side * s.side
            cls = jax.nn.softmax(
                x[:, : s2 * s.classes].reshape(b, s2, s.classes), axis=-1
            ).reshape(b, s2 * s.classes)
            x = jnp.concatenate([cls, x[:, s2 * s.classes :]], axis=-1)
        return x
    raise TypeError(f"not a simple layer: {s}")


SIMPLE_SPECS = (
    ConnectedSpec, SoftmaxSpec, AvgPoolSpec, DropoutSpec, CropSpec, LocalSpec,
    DeconvSpec, ReorgSpec, LRNSpec, L2NormSpec, LogisticSpec, ActivationSpec,
    BatchNormSpec, RegionSpec, DetectionSpec,
)


def forward(
    net: NetworkDef,
    params: dict[int, dict[str, jax.Array]],
    x: jax.Array,
    mode: ForwardMode = ForwardMode(),
    quant_state: dict[str, dict[str, jax.Array]] | None = None,
    rng: jax.Array | None = None,
):
    """Run the graph.  Returns (head_outputs, aux).

    head_outputs: list of raw float NHWC tensors, one per YoloSpec, channels
    laid out darknet-style as A*(4+1+classes) with per-anchor blocks.
    aux: {"bn_stats": {i: (mean, var)}, "quant_state": updated EMA ranges}.

    Replaces the reference's forward_network loop (src/network.c:229-338); the
    uint8 handoff between quantized layers (network.c:247-251) has no analog
    here — this is the float/QAT graph; integer inference is a separate
    compiled program built by infer/convert.py.
    """
    qs = dict(quant_state) if quant_state is not None else None
    if mode.qat and qs is None:
        raise ValueError("QAT forward requires quant_state")

    if mode.qat:
        lo, hi = qs["input"]["min"], qs["input"]["max"]
        if mode.update_ranges:
            lo, hi = ema_update(lo, hi, jnp.min(x), jnp.max(x))
            qs["input"] = {"min": lo, "max": hi}
        x = _act_fq(mode)(x, lo, hi)

    outputs: list[jax.Array] = []
    heads: list[jax.Array] = []
    bn_stats: dict[int, tuple[jax.Array, jax.Array]] = {}

    for i, s in enumerate(net.specs):
        if isinstance(s, ConvSpec):
            in_key = f"in_{i}"
            if mode.qat and qs is not None and in_key in qs:
                # float -> quant boundary: fake-quant the input (EMA-tracked)
                lo, hi = qs[in_key]["min"], qs[in_key]["max"]
                if mode.update_ranges:
                    lo, hi = ema_update(lo, hi, *_batch_range(x, mode.range_stat))
                    qs[in_key] = {"min": lo, "max": hi}
                x = _act_fq(mode)(x, lo, hi)
            key = f"act_{i}"
            y, stats, new_state = _conv_forward(
                s, params[i], x, mode, qs.get(key) if qs else None
            )
            if stats is not None:
                bn_stats[i] = stats
            if qs is not None and new_state is not None and key in qs:
                qs[key] = new_state
        elif isinstance(s, MaxPoolSpec):
            y = L.maxpool(x, s.size, s.stride, s.padding)
        elif isinstance(s, UpsampleSpec):
            y = L.upsample_nearest(x, s.stride)
        elif isinstance(s, RouteSpec):
            y = L.route_concat([outputs[j] for j in s.layers])
            key = f"act_{i}"
            if mode.qat and qs is not None and key in qs:
                lo, hi = qs[key]["min"], qs[key]["max"]
                if mode.update_ranges:
                    lo, hi = ema_update(lo, hi, *_batch_range(y, mode.range_stat))
                    qs[key] = {"min": lo, "max": hi}
                y = _act_fq(mode)(y, lo, hi)
        elif isinstance(s, ShortcutSpec):
            y = L.shortcut_add(x, outputs[s.index])
            y = L.activate(y, s.activation)
            key = f"act_{i}"
            if mode.qat and qs is not None and key in qs:
                lo, hi = qs[key]["min"], qs[key]["max"]
                if mode.update_ranges:
                    lo, hi = ema_update(lo, hi, *_batch_range(y, mode.range_stat))
                    qs[key] = {"min": lo, "max": hi}
                y = _act_fq(mode)(y, lo, hi)
        elif isinstance(s, YoloSpec):
            y = x  # heads are decoded separately (eval/detect.py)
            heads.append(x)
        elif isinstance(s, SIMPLE_SPECS):
            layer_rng = None
            if rng is not None:
                rng, layer_rng = jax.random.split(rng)
            y = apply_simple_layer(
                s, params.get(i), x, train=mode.train, rng=layer_rng
            )
            if isinstance(s, (RegionSpec, DetectionSpec)):
                heads.append(y)
        else:
            raise TypeError(f"unknown spec {s}")
        outputs.append(y)
        x = y

    aux = {"bn_stats": bn_stats, "quant_state": qs}
    return heads, aux
