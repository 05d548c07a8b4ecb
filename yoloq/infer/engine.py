"""Integer inference engine: compiles an IntProgram into one jitted function.

The counterpart of the reference's forward_network integer loop
(src/network.c:229-338 + src/convolutional_layer.c:694-761): a single XLA
program that takes a float NHWC image batch, quantizes it on-device, runs
every layer in the uint8/int32 domain (int8 GEMM convs with float32 requant
epilogues, uint8 maxpool/route/upsample), dequantizes at the quant_stop
heads, and decodes the YOLO outputs — one compilation, zero host-device
ping-pong per layer.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from yoloq.eval import detect
from yoloq.infer.convert import IntProgram
from yoloq.nn import layers as L
from yoloq.nn.graph import (
    DetectionSpec,
    RegionSpec,
    YoloSpec,
    apply_simple_layer,
)
from yoloq.ops import qconv


def _round_half_away(v: jax.Array) -> jax.Array:
    """C round() semantics (half away from zero) in exact f32 ops.

    x - floor(x) is computed exactly in float32 for any x, so the .5
    comparison never suffers the rounding an |x|+0.5 addition can; matches
    parity/ctwin.py _c_round bit-for-bit on f32 inputs.
    """
    a = jnp.abs(v)
    f = jnp.floor(a)
    r = f + (a - f >= 0.5).astype(v.dtype)
    return jnp.where(v < 0, -r, r)


def _div_rn(a: jax.Array, b: jax.Array) -> jax.Array:
    """a / b correctly rounded (IEEE round-to-nearest-even) in float32, on
    every backend.

    XLA's GPU division of two runtime float32 values is up to 2 ulp off the
    IEEE quotient, which the C reference's float arithmetic (and the CPU
    backend) compute; a quantizer that rounds the quotient then lands on
    another code near ties.  This is long division of the 24-bit
    significands in uint32, with the remainder deciding the rounding.
    Domain: finite normal ``b`` and a quotient below the float32 maximum; a
    zero or subnormal ``a``, and a quotient below the normal range, give
    zero.  (The engine's dynamic-input quotients — pixels over a per-image
    scale, biases over scale products — are far inside it.)
    """
    a, b = jnp.broadcast_arrays(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    ia = jax.lax.bitcast_convert_type(a, jnp.uint32)
    ib = jax.lax.bitcast_convert_type(b, jnp.uint32)
    sign = (ia ^ ib) & jnp.uint32(0x80000000)
    ea = ((ia >> 23) & 0xFF).astype(jnp.int32)
    eb = ((ib >> 23) & 0xFF).astype(jnp.int32)
    ma = (ia & 0x7FFFFF) | 0x800000
    mb = (ib & 0x7FFFFF) | 0x800000
    # align so the quotient of the significands lies in [1, 2)
    low = ma < mb
    r = jnp.where(low, ma << 1, ma)
    e = ea - eb + 127 - low.astype(jnp.int32)
    q = jnp.zeros_like(ma)
    for _ in range(25):  # 24 significand bits and a guard bit
        bit = r >= mb
        q = (q << 1) | bit.astype(jnp.uint32)
        r = jnp.where(bit, r - mb, r) << 1
    guard = q & 1
    q = q >> 1
    q = q + (guard & ((r != 0) | (q & 1)).astype(jnp.uint32))
    carry = q >> 24  # rounding overflowed into a 25th bit
    q = q >> carry
    e = e + carry.astype(jnp.int32)
    bits = sign | (e.astype(jnp.uint32) << 23) | (q & 0x7FFFFF)
    out = jax.lax.bitcast_convert_type(bits, jnp.float32)
    return jnp.where((ea == 0) | (e <= 0), jnp.float32(0.0) * jnp.sign(b), out)


def _dynamic_input_qp(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-image input (scale, zero_point) with the reference's float32
    arithmetic (src/blas.c:108-150; numpy twin parity/ctwin.dynamic_input_qp):
    min/max seeded at 0, scale = (max-min)/255, zp = round(-min/scale) clamped.
    Returns ((N,) f32 scale, (N,) f32 integral zp)."""
    n = x.shape[0]
    flat = x.reshape(n, -1).astype(jnp.float32)
    mx = jnp.maximum(jnp.max(flat, axis=1), 0.0)
    mn = jnp.minimum(jnp.min(flat, axis=1), 0.0)
    scale = _div_rn(mx - mn, jnp.float32(255.0))
    scale = jnp.where(scale > 0, scale, jnp.float32(1.0))
    zp = jnp.clip(_round_half_away(_div_rn(-mn, scale)), 0.0, 255.0)
    return scale, zp


def _quantize_input_dynamic(x: jax.Array, scale: jax.Array, zp: jax.Array) -> jax.Array:
    """Float image -> shifted int8 codes with per-image dynamic (scale, zp),
    C round semantics (src/blas.c:152-158; ctwin.quantize_input_c)."""
    t = _round_half_away(_div_rn(x, scale[:, None, None, None])) + zp[:, None, None, None]
    return (jnp.clip(t, 0.0, 255.0) - 128.0).astype(jnp.int8)


def _quantize_input(x: jax.Array, scale: float, zp: int) -> jax.Array:
    """Image floats -> quantized codes (reference src/blas.c:213-256 quantizes
    the letterboxed input with the stored input scale per image).

    Emits the engine's internal SHIFTED representation: int8 holding
    (uint8 code - 128).  Keeping activations int8 end-to-end feeds the signed
    int8 GEMMs directly and removes a per-layer uint8->int8 conversion pass
    over device memory; all code values are identical, only the fixed -128
    offset moves into zero points.
    """
    q = jnp.round(x / scale) + (zp - 128)
    return jnp.clip(q, -128, 127).astype(jnp.int8)


def _requant_i8(x_i8: jax.Array, ratio: float, zp_in: int, zp_out: int) -> jax.Array:
    """Affine regrid of codes: out = round((q - zi) * ratio) + zo, in the
    shifted int8 representation (zero points are uint8-domain values)."""
    v = jnp.round((x_i8.astype(jnp.float32) - (zp_in - 128)) * ratio) + (zp_out - 128)
    return jnp.clip(v, -128, 127).astype(jnp.int8)


def _dequant_i8(x_i8: jax.Array, scale: float, zp: int) -> jax.Array:
    """Shifted int8 codes -> float: (code - zp) * scale with code = x + 128."""
    return (x_i8.astype(jnp.float32) - (zp - 128)) * scale


def build_forward(program: IntProgram, return_outputs: bool = False,
                  use_s2d: bool = False, dynamic_input: bool = False,
                  exact_leaky: bool = False):
    """Return a pure fn(arrays, x_f32_nhwc) -> (head_floats, feature_u8s).

    ``return_outputs=True`` makes the fn return (heads, per_layer_outputs) —
    every layer's tensor in order — for debugging and the cross-binary parity
    harness (scripts/parity_c.py).

    The layer loop is unrolled at trace time (specs are static); XLA fuses
    each conv with its epilogue and the surrounding u8 plumbing.

    ``use_s2d`` rewrites eligible small-channel stem conv+pool pairs to the
    space-to-depth form with the pool as a phase max on the int32
    accumulators (bit-identical; see PERF.md).

    ``dynamic_input`` re-quantizes the input per image at runtime with the
    reference's float32 arithmetic (src/blas.c:213-256), rebuilding layer
    0's bias/multiplier from runtime scalars; shapes stay static.

    Inputs may be float32 (letterboxed [0,1] images) or raw uint8 pixel
    codes — the uint8 path folds /255 into the quantize scale and jit
    retraces per dtype.
    """
    if dynamic_input and program.cfg[0].kind != "qconv":
        raise ValueError(
            "dynamic_input requires a quantized conv as layer 0 (the "
            "reference re-quantizes the image feeding its first conv, "
            "src/blas.c:213-256)"
        )
    if dynamic_input:
        # programs serialized before dynamic_input existed lack the raw
        # per-image rebuild ingredients; fail with a clear message instead of
        # a KeyError deep inside jit tracing
        missing = {"bias_f", "wsum_i32", "out_scale_f"} - set(
            program.arrays.get(0, {})
        )
        if missing:
            raise ValueError(
                f"program predates dynamic_input support (layer 0 lacks "
                f"{sorted(missing)}); re-run convert() to regenerate it"
            )

    cfg = program.cfg

    def forward(arrays, x):
        if x.dtype == jnp.uint8:
            # raw pixel codes in [0,255]: fold the /255 normalization into
            # the quantize scale — 4x less host->device transfer and input
            # HBM traffic than the f32 path.  Codes may differ from the f32
            # path's by 1 on round ties (different f32 division chains);
            # jit retraces per input dtype, so no flag is needed.
            if dynamic_input:
                x = x.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
            else:
                x = _quantize_input(
                    x.astype(jnp.float32), program.in_scale * 255.0,
                    program.in_zp,
                )
        if dynamic_input:
            # per-image input quantization (reference src/blas.c:213-256):
            # layer 0's bias/multiplier are rebuilt from the runtime scale —
            # shapes stay static, only scalars flow
            dyn_scale, dyn_zp = _dynamic_input_qp(x)
            x = _quantize_input_dynamic(x, dyn_scale, dyn_zp)
        elif x.dtype != jnp.int8:
            x = _quantize_input(x, program.in_scale, program.in_zp)

        def _dyn_pad(x_i8, pad):
            # pad with each image's own zero point (im2col zp-padding rule,
            # src/im2col.c:4-24, but zp is per-image here)
            n_, h_, w_, _ = x_i8.shape
            zx_i8 = (dyn_zp - 128.0).astype(jnp.int8)[:, None, None, None]
            xp = jnp.pad(x_i8, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
            interior = np.zeros((1, h_ + 2 * pad, w_ + 2 * pad, 1), bool)
            interior[:, pad : pad + h_, pad : pad + w_, :] = True
            return jnp.where(jnp.asarray(interior), xp, zx_i8)

        def _dyn_bias_m(a, c, k_elems):
            # per-image int32 bias + requant multiplier: the runtime twin of
            # convert-time fold_static_bias / m (src/blas.c:306-334, re-done
            # per image by quantization_activations_preprocess)
            s_w = a["w_scale"]
            denom = dyn_scale[:, None] * s_w[None, :]
            bias_q = _round_half_away(_div_rn(a["bias_f"][None, :], denom))
            zx = dyn_zp[:, None] - 128.0
            corr = -zx * a["wsum_i32"].astype(jnp.float32)
            if not c.symmetric_w:
                corr = corr + k_elems * zx * a["w_zp"].astype(jnp.float32)
            return (bias_q + corr).astype(jnp.int32), _div_rn(denom, a["out_scale_f"])

        outputs = []
        heads = []
        skip_next = False
        for i, c in enumerate(cfg):
            s = c.spec
            if skip_next:
                # this maxpool was folded into the previous s2d conv
                skip_next = False
                outputs.append(outputs[-1])
                continue
            if use_s2d and c.kind == "qconv" and c.s2d_pool:
                # space-to-depth conv+pool (convert._s2d_weights): phase the
                # 2x2 pixel blocks into channels so the 3/16/32-channel stem
                # contracts over 4x the channels, then take the following 2x2/s2
                # maxpool as an elementwise max over the 4 output phase
                # groups ON THE INT32 ACCUMULATORS, before the requant
                # epilogue.  Bit-identical to conv -> requant -> pool: the
                # per-channel epilogue map acc -> code (bias add, multiply by
                # M>0, round, leaky/relu select, zero point, clamp) is
                # monotone nondecreasing and identical across the 4 phases of
                # a channel, so max commutes with it — while the epilogue
                # runs on 1/4 the elements and the pool op disappears.
                # Slicing phase groups keeps the max an
                # elementwise op XLA can fuse into the conv consumer chain,
                # instead of a reshape+reduce_max it materializes.
                a = arrays[i]
                if x.dtype != jnp.int8:
                    qp = c.in_scales[0]
                    x = _quantize_input(x, qp[0], qp[1])
                n, h, w, ci = x.shape
                xs = x.reshape(n, h // 2, 2, w // 2, 2, ci)
                xs = xs.transpose(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * ci)
                if dynamic_input and i == 0:
                    xs = _dyn_pad(xs, 1)
                    acc = qconv.conv_acc_int32(
                        xs, a["w_s2d"], a["x_zp"], a["w_zp"], stride=1, pad=0,
                        symmetric=True,
                    )
                else:
                    acc = qconv.conv_acc_int32(
                        xs, a["w_s2d"], a["x_zp"], a["w_zp"], stride=1, pad=1,
                        symmetric=True,
                    )
                o4 = acc.shape[-1] // 4
                accm = jnp.maximum(
                    jnp.maximum(acc[..., :o4], acc[..., o4 : 2 * o4]),
                    jnp.maximum(acc[..., 2 * o4 : 3 * o4], acc[..., 3 * o4 :]),
                )
                if dynamic_input and i == 0:
                    wk = a["w_i8"].shape
                    bias_dyn, m_dyn = _dyn_bias_m(a, c, wk[0] * wk[1] * wk[2])
                    y = qconv.requant_activate(
                        accm, bias_dyn, m_dyn, a["out_zp"], c.act, out_i8=True,
                        exact_leaky=exact_leaky,
                    )
                else:
                    y = qconv.requant_activate(
                        accm, a["bias_i32"], a["m"], a["out_zp"], c.act,
                        out_i8=True, exact_leaky=exact_leaky,
                    )
                # outputs[i] is the (unavailable) pre-pool tensor; the plan
                # guarantees nothing references it (convert checks routes)
                outputs.append(y)
                x = y
                skip_next = True
                continue
            if c.kind == "qconv":
                a = arrays[i]
                if x.dtype != jnp.int8:
                    # float -> quant boundary (mixed graphs): quantize the
                    # input with the QAT-tracked boundary range
                    qp = c.in_scales[0]
                    x = _quantize_input(x, qp[0], qp[1])
                if dynamic_input and i == 0:
                    xq = _dyn_pad(x, s.pad) if s.pad else x
                    acc = qconv.conv_acc_int32(
                        xq, a["w_i8"], a["x_zp"], a["w_zp"], stride=s.stride,
                        pad=0, symmetric=c.symmetric_w,
                    )
                    wk = a["w_i8"].shape
                    bias_dyn, m_dyn = _dyn_bias_m(a, c, wk[0] * wk[1] * wk[2])
                    y = qconv.requant_activate(
                        acc, bias_dyn, m_dyn, a["out_zp"], c.act, out_i8=True,
                        exact_leaky=exact_leaky,
                    )
                else:
                    y = qconv.quantized_conv2d(
                        x, a["w_i8"], a["bias_i32"], a["m"], a["x_zp"], a["w_zp"],
                        a["out_zp"], stride=s.stride, pad=s.pad, act=c.act,
                        symmetric=c.symmetric_w, out_i8=True,
                        exact_leaky=exact_leaky,
                    )
                if c.quant_stop:
                    y = _dequant_i8(y, c.out_scale, c.out_zp)
            elif c.kind == "fconv":
                # float conv (per-layer quantized=0, reference float path)
                a = arrays[i]
                if x.dtype == jnp.int8:
                    qp = c.in_scales[0]
                    x = _dequant_i8(x, qp[0], qp[1])
                y = L.conv2d(x, a["w_f32"], s.stride, s.pad)
                y = L.activate(y + a["bias_f32"].reshape(1, 1, 1, -1), s.activation)
            elif c.kind == "maxpool":
                if x.dtype == jnp.int8:
                    y = L.maxpool_u8(x, s.size, s.stride, s.padding)
                else:
                    y = L.maxpool(x, s.size, s.stride, s.padding)
            elif c.kind == "upsample":
                y = L.upsample_nearest(x, s.stride)
            elif c.kind == "route":
                parts = []
                for (j, (identity, ratio, zp_in)) in zip(s.layers, c.branches):
                    t = outputs[j]
                    if not identity:
                        t = _requant_i8(t, ratio, zp_in, c.out_zp)
                    parts.append(t)
                y = jnp.concatenate(parts, axis=-1)
            elif c.kind == "route_f32":
                parts = []
                for (j, qp) in zip(s.layers, c.branches):
                    t = outputs[j]
                    if t.dtype == jnp.int8:
                        t = _dequant_i8(t, qp[0], qp[1])
                    parts.append(t)
                y = jnp.concatenate(parts, axis=-1)
            elif c.kind in ("shortcut", "shortcut_f32"):
                qp_x, qp_k = c.in_scales
                skip = outputs[s.index]
                int_add = (
                    c.kind == "shortcut"
                    and x.dtype == jnp.int8
                    and skip.dtype == jnp.int8
                    and s.activation in ("linear", "leaky", "relu", "relu6")
                )
                if int_add:
                    # Integer-domain residual add, single-rounded (the TFLite
                    # ADD shape) — beyond the reference, whose shortcut is
                    # float-only and blocks integer yolov3
                    # (src/shortcut_layer.c:62-67).  Both operands regrid onto
                    # the output scale with conversion-time ratios, and the
                    # add + activation + ONE rounding run as a single fused
                    # elementwise expression:
                    #   q_o = clamp(round(act((q_x-z_x)*ra + (q_k-z_k)*rb))
                    #               + z_o)
                    # with ra = s_x/s_o, rb = s_k/s_o static floats.  Matches
                    # what QAT's fake-quant after the add simulates
                    # (tests/test_int_shortcut.py); replaces the r3
                    # dequant -> f32 add -> requant chain.  Leaky/relu commute
                    # with the positive 1/s_o scaling; relu6's upper clamp
                    # rescales to 6/s_o.
                    ra = qp_x[0] / c.out_scale
                    rb = qp_k[0] / c.out_scale
                    cst = -(qp_x[1] - 128) * ra - (qp_k[1] - 128) * rb
                    t = (
                        x.astype(jnp.float32) * jnp.float32(ra)
                        + skip.astype(jnp.float32) * jnp.float32(rb)
                        + jnp.float32(cst)
                    )
                    if s.activation == "leaky":
                        t = jnp.where(t < 0, t * jnp.float32(0.1), t)
                    elif s.activation == "relu":
                        t = jnp.maximum(t, 0.0)
                    elif s.activation == "relu6":
                        t = jnp.clip(t, 0.0, jnp.float32(6.0 / c.out_scale))
                    y = jnp.clip(
                        jnp.round(t) + (c.out_zp - 128), -128, 127
                    ).astype(jnp.int8)
                else:
                    fx = _dequant_i8(x, qp_x[0], qp_x[1]) if x.dtype == jnp.int8 else x
                    fk = (
                        _dequant_i8(skip, qp_k[0], qp_k[1])
                        if skip.dtype == jnp.int8 else skip
                    )
                    f = L.activate(fx + fk, s.activation)
                    y = _quantize_input(f, c.out_scale, c.out_zp) if c.kind == "shortcut" else f
            elif c.kind == "yolo":
                if x.dtype == jnp.int8:
                    # quantized pre-head conv without quant_stop: the decoder
                    # needs reals, so dequantize with the producer's params
                    x = _dequant_i8(x, c.out_scale, c.out_zp)
                y = x
                heads.append(x)
            elif c.kind == "simple":
                if x.dtype == jnp.int8:
                    qp = c.in_scales[0]
                    x = _dequant_i8(x, qp[0], qp[1])
                y = apply_simple_layer(s, arrays.get(i), x, train=False)
                if isinstance(s, (RegionSpec, DetectionSpec)):
                    heads.append(y)
            else:
                raise ValueError(c.kind)
            outputs.append(y)
            x = y
        if return_outputs:
            return heads, outputs
        return heads

    return forward


class Engine:
    """Batched quantized-inference engine for one model + converted program.

    predict() runs image batch -> decoded (boxes, objectness, class_probs)
    entirely on device, then hands the top-k to the host — the equivalent of
    the reference's network_predict + get_network_boxes
    (src/network.c:570-640) without per-layer host transfers.
    """

    def __init__(self, program: IntProgram, max_det: int = 256,
                 use_s2d: bool = False, dynamic_input: bool = False,
                 arrays=None, exact_leaky: bool = False):
        self.program = program
        self.max_det = max_det
        self.use_s2d = use_s2d
        self.dynamic_input = dynamic_input
        self.exact_leaky = exact_leaky
        # ``arrays``: already-device-resident program arrays to share (the
        # at_size resolution cache uploads the weights once for every size)
        self.arrays = arrays if arrays is not None else jax.device_put(program.arrays)
        self._size_cache: dict[tuple[int, int], "Engine"] = {}
        fwd = build_forward(program, use_s2d=use_s2d,
                            dynamic_input=dynamic_input,
                            exact_leaky=exact_leaky)
        net = program.net

        @jax.jit
        def _run(arrays, x):
            heads = fwd(arrays, x)
            boxes, obj, cls = detect.decode_all_heads(heads, net)
            return detect.top_k_detections(boxes, obj, cls, self.max_det)

        self._run = _run
        self._raw_heads = jax.jit(fwd)

        from yoloq.nn.graph import HEAD_SPECS, YoloSpec

        head_specs = [s for s in net.specs if isinstance(s, HEAD_SPECS)]

        @jax.jit
        def _run_flip(arrays, x):
            # flip TTA (`detector valid2`, examples/detector.c:260-388): run
            # the image and its mirror in one doubled batch, average the raw
            # yolo heads (avg_flipped_yolo), decode once.  Non-yolo heads
            # keep the unflipped prediction (the reference's flip path only
            # averages yolo layers).
            n = x.shape[0]
            heads = fwd(arrays, jnp.concatenate([x, x[:, :, ::-1, :]], axis=0))
            merged = []
            for h_raw, spec in zip(heads, head_specs):
                if isinstance(spec, YoloSpec):
                    merged.append(
                        detect.flip_average_head(h_raw[:n], h_raw[n:], spec.classes)
                    )
                else:
                    merged.append(h_raw[:n])
            boxes, obj, cls = detect.decode_all_heads(merged, net)
            return detect.top_k_detections(boxes, obj, cls, self.max_det)

        self._run_flip = _run_flip

    def at_size(self, height: int, width: int | None = None) -> "Engine":
        """Per-resolution engine cache — the counterpart of the reference's
        whole-net reshape (src/network.c:434 resize_network, used by
        multi-scale eval).

        The integer program is shape-free (per-channel scales, multipliers
        and weights carry no spatial dims), so another input resolution is
        just another compiled program over the SAME device-resident arrays.
        Each size jit-compiles once and is cached; repeated calls return the
        identical Engine object (tests/test_multires.py).
        """
        width = width or height
        net = self.program.net
        if (height, width) == (net.height, net.width):
            return self
        if height % 32 or width % 32:
            raise ValueError(
                f"input size must be a multiple of 32 (yolo head grids), "
                f"got {height}x{width}"
            )
        key = (height, width)
        eng = self._size_cache.get(key)
        if eng is None:
            import dataclasses

            prog = dataclasses.replace(
                self.program,
                net=dataclasses.replace(net, height=height, width=width),
            )
            eng = Engine(
                prog, max_det=self.max_det, use_s2d=self.use_s2d,
                dynamic_input=self.dynamic_input, arrays=self.arrays,
                exact_leaky=self.exact_leaky,
            )
            self._size_cache[key] = eng
        return eng

    def predict(self, images: np.ndarray, flip: bool = False):
        """images: (N, H, W, 3) float32 letterboxed to the network size.

        ``flip`` enables horizontal-flip test-time averaging (the reference's
        `detector valid2` mode).
        """
        net = self.program.net
        if images.shape[1:] != (net.height, net.width, net.channels):
            raise ValueError(
                f"engine expects {(net.height, net.width, net.channels)} images, "
                f"got {images.shape[1:]}; letterbox to the network size first"
            )
        run = self._run_flip if flip else self._run
        boxes, obj, cls = run(self.arrays, jnp.asarray(images))
        return np.asarray(boxes), np.asarray(obj), np.asarray(cls)

    def predict_async(self, images: np.ndarray, flip: bool = False):
        """Dispatch a batch and return a zero-arg resolver.

        The device call is enqueued asynchronously (JAX dispatch); calling
        the returned function blocks on the transfer and yields the same
        (boxes, obj, cls) as predict().  Lets a serving loop overlap the
        next batch's gathering/dispatch with this batch's device execution
        and result round trip (infer/serving.py pipelined batching)."""
        net = self.program.net
        if images.shape[1:] != (net.height, net.width, net.channels):
            raise ValueError(
                f"engine expects {(net.height, net.width, net.channels)} images, "
                f"got {images.shape[1:]}; letterbox to the network size first"
            )
        run = self._run_flip if flip else self._run
        boxes, obj, cls = run(self.arrays, jnp.asarray(images))

        def resolve():
            return np.asarray(boxes), np.asarray(obj), np.asarray(cls)

        return resolve

    def raw_heads(self, images: np.ndarray):
        heads = self._raw_heads(self.arrays, jnp.asarray(images))
        return [np.asarray(h) for h in heads]
