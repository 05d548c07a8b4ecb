"""Integer uint8 convolution: int8 matrix products + zero-point corrections.

Implements the integer-only conv of the reference
(src/convolutional_layer.c:694-761 forward_convolutional_layer_quant_inputi_outputi).
The reference materializes an im2col buffer padded with the input zero point
and runs two uint8 GEMMs (src/gemm.c:279-299) — one with the weights and one
with a zero-point plane — then requantizes through C doubles.  Here:

- Layouts: NHWC activations, HWIO weights (darknet is NCHW/OIHW).
- uint8 operands are shifted to int8 by XOR 0x80 (x_i8 = x_u8 - 128) so a
  signed int8 GEMM applies; the shift folds into the zero points.
- The contraction is one im2col matrix product, s8 x s8 -> s32, per layer
  (conv_acc_int32).
- The asymmetric zero-point cross terms of Jacob et al. eq. 7,
      acc = sum (x - zx)(w - zw[o])
          = conv(x, w) - zw[o]*patchsum(x) - zx*wsum[o] + K*zx*zw[o],
  are handled as: input padded with its zero point (matching the reference's
  im2col padding rule, src/im2col.c:4-24), the patch row sum for
  patchsum(x), and the two static terms folded into the int32 bias at
  conversion time (mirroring src/blas.c:306-334 weights_sum_int folding).
- Requantization multiplies the int32 accumulator by the per-channel real
  multiplier M = S1*S2/S3 in float32 (see core.quant.requantize_float for
  the accuracy argument), applies the activation in the quantized domain,
  adds the output zero point, and clamps to uint8.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

# Activation codes, static ints so they stay compile-time under jit.
ACT_LINEAR = 0
ACT_LEAKY = 1   # slope 0.1, reference src/convolutional_layer.c:737
ACT_RELU = 2
ACT_RELU6 = 3

ACTIVATION_BY_NAME = {
    "linear": ACT_LINEAR,
    "leaky": ACT_LEAKY,
    "relu": ACT_RELU,
    "relu6": ACT_RELU6,
}


def u8_to_i8(x_u8: jax.Array) -> jax.Array:
    """Shift uint8 codes to int8 (x - 128) without leaving the 8-bit domain."""
    return (x_u8 ^ jnp.uint8(0x80)).astype(jnp.int8)


def _im2col(x: jax.Array, k: int, stride: int) -> jax.Array:
    """(N, H, W, C) -> (N, OH, OW, K*K*C) patches in (ky, kx, c) order, the
    row order of an HWIO weight flattened to (K*K*C, O).  A 1x1 stride-1
    conv needs no copy."""
    n, h, w, c = x.shape
    if k == 1 and stride == 1:
        return x
    oh = (h - k) // stride + 1
    ow = (w - k) // stride + 1
    taps = [
        lax.slice(
            x, (0, dy, dx, 0),
            (n, dy + (oh - 1) * stride + 1, dx + (ow - 1) * stride + 1, c),
            (1, stride, stride, 1),
        )
        for dy in range(k)
        for dx in range(k)
    ]
    return jnp.concatenate(taps, axis=-1)


def conv_acc_int32(
    x_i8: jax.Array,
    w_i8: jax.Array,
    x_zp_i32: jax.Array,
    w_zp_i32: jax.Array,
    stride: int,
    pad: int,
    symmetric: bool = False,
) -> jax.Array:
    """int32 accumulator of sum (x - zx)(w - zw[o]) over each conv window.

    Args:
      x_i8: (N, H, W, C) int8 activations (uint8 codes shifted by -128).
      w_i8: (KH, KW, C, O) int8 weights (uint8 codes shifted by -128).
      x_zp_i32: scalar int32, input zero point shifted by -128.
      w_zp_i32: (O,) int32, per-channel weight zero points shifted by -128.
      stride, pad: conv geometry (darknet-style symmetric padding).

    The contraction is an im2col matrix product, s8 x s8 -> s32, which XLA
    hands to its int8 GEMMs.  An integer ``conv_general_dilated`` has no GPU
    lowering with an int32 result (cuDNN's integer convolutions emit s8 or
    f32 only), and a per-tap sum of products writes K*K int32 partials to
    device memory; docs in PERF.md.  The contracted dimension is zero-padded
    to a multiple of 4: the GPU's int8 GEMMs need it, and without it the
    product is taken in float at reduced precision and is not exact.

    The two data-independent correction terms (-zx*wsum[o] + K*zx*zw[o]) are
    NOT applied here — the converter folds them into the int32 bias
    (infer/convert.py), as the reference folds them into weights_sum_int
    (src/blas.c:306-311).  Only the data-dependent -zw[o]*patchsum(x) term is
    computed, as the row sum of the patches.
    """
    if pad:
        # Pad with the input zero point, not 0: reference src/im2col.c:4-24.
        x_i8 = jnp.pad(
            x_i8,
            ((0, 0), (pad, pad), (pad, pad), (0, 0)),
            constant_values=x_zp_i32.astype(x_i8.dtype),
        )
    kh, kw, c, o = w_i8.shape
    assert kh == kw, "square kernels only"
    cols = _im2col(x_i8, kh, stride)
    kdim = kh * kw * c
    w2 = w_i8.reshape(kdim, o)
    extra = -kdim % 4
    if extra:
        cols = jnp.pad(cols, ((0, 0), (0, 0), (0, 0), (0, extra)))
        w2 = jnp.pad(w2, ((0, extra), (0, 0)))
    acc = lax.dot_general(
        cols, w2, (((3,), (0,)), ((), ())), preferred_element_type=jnp.int32
    )
    if symmetric:
        # weight zero points are all 0 in the int8 domain: no cross term
        return acc
    patchsum = jnp.sum(cols, axis=-1, dtype=jnp.int32, keepdims=True)
    return acc - w_zp_i32.reshape(1, 1, 1, -1) * patchsum


@partial(jax.jit, static_argnames=("act", "out_i8", "exact_leaky"))
def requant_activate(
    acc: jax.Array,
    bias_i32: jax.Array,
    m: jax.Array,
    out_zp: jax.Array,
    act: int,
    out_i8: bool = False,
    exact_leaky: bool = False,
) -> jax.Array:
    """Fused epilogue: bias add, per-channel rescale, quantized activation, clamp.

    Matches the reference epilogue (src/convolutional_layer.c:726-750):
      v = round((acc + bias) * M[o])       # M = S1*S2[o]/S3
      leaky: 0.1-slope in the quantized domain, SINGLE-rounded (deviation 8)
      relu/relu6: v<=0 -> 0                # upper clamp comes from uint8 saturation
      out = clamp(v + zp_out, 0, 255)

    Leaky deviation: the reference double-rounds the negative branch
    (round(0.1*round(v)), src/convolutional_layer.c:737), which QAT's
    fake-quant does not model — measured 1.6 F1 loss at the 416 capstone on
    a leaky graph.  Here the slope applies BEFORE the single rounding
    (round(0.1*v_real)), matching what QAT simulates; the C-exact
    double-rounded form lives in parity/ctwin.py for byte-parity work.

    ``out_i8`` emits the same codes shifted by -128 as int8 — the engine's
    internal representation, which keeps activations in the GEMM's signed
    domain between layers and eliminates a per-layer uint8->int8 conversion
    pass over device memory.

    ``bias_i32``/``m`` are per-channel (O,) normally; the engine's dynamic
    input mode passes per-image (N, O) values for the first layer.

    ``exact_leaky`` reproduces the reference's DOUBLE-rounded leaky
    (round(0.1*round(v)), src/convolutional_layer.c:737) instead of the
    accuracy-preferred single round — the opt-in for byte-exact leaky
    parity against the C binary (parity/ctwin.py carries the same form).
    """
    b = bias_i32.reshape(1, 1, 1, -1) if bias_i32.ndim == 1 else bias_i32[:, None, None, :]
    mm = m.reshape(1, 1, 1, -1) if m.ndim == 1 else m[:, None, None, :]
    vf = (acc + b).astype(jnp.float32) * mm
    if act == ACT_LEAKY:
        if exact_leaky:
            v1 = jnp.round(vf)
            v = jnp.where(v1 < 0, jnp.round(v1 * jnp.float32(0.1)), v1)
        else:
            v = jnp.round(jnp.where(vf < 0, vf * jnp.float32(0.1), vf))
    elif act in (ACT_RELU, ACT_RELU6, ACT_LINEAR):
        v = jnp.round(vf)
    else:
        raise ValueError(f"unsupported quantized activation code {act}")
    # relu/relu6 fold into the clamp: max(v,0)+zp clipped == clip(v+zp, zp, hi)
    # — exact, and two fewer elementwise ops on the epilogue
    relu_like = act in (ACT_RELU, ACT_RELU6)
    if out_i8:
        zps = out_zp.astype(jnp.float32) - 128.0
        lo = jnp.maximum(zps, -128.0) if relu_like else -128.0
        return jnp.clip(v + zps, lo, 127.0).astype(jnp.int8)
    zpf = out_zp.astype(jnp.float32)
    lo = jnp.maximum(zpf, 0.0) if relu_like else 0.0
    return jnp.clip(v + zpf, lo, 255.0).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("stride", "pad", "act", "symmetric", "out_i8",
                                   "exact_leaky"))
def quantized_conv2d(
    x_u8: jax.Array,
    w_i8: jax.Array,
    bias_i32: jax.Array,
    m: jax.Array,
    x_zp_i32: jax.Array,
    w_zp_i32: jax.Array,
    out_zp: jax.Array,
    *,
    stride: int = 1,
    pad: int = 0,
    act: int = ACT_LINEAR,
    symmetric: bool = False,
    out_i8: bool = False,
    exact_leaky: bool = False,
) -> jax.Array:
    """Full integer conv layer: uint8 in -> uint8 out.

    ``w_i8`` are pre-shifted int8 weights (conversion-time), ``bias_i32`` the
    fully folded bias (float bias / (S1*S2) plus the static zero-point terms),
    ``m`` the per-channel requant multiplier S1*S2/S3 as float32.
    ``symmetric`` statically elides the weight zero-point correction conv
    (see infer/convert.py symmetric_weights).

    The input may already be in the shifted int8 representation (codes - 128),
    in which case the uint8->int8 conversion is skipped; ``out_i8`` emits the
    output in that representation too (see requant_activate).
    """
    x_i8 = x_u8 if x_u8.dtype == jnp.int8 else u8_to_i8(x_u8)
    acc = conv_acc_int32(
        x_i8, w_i8, x_zp_i32, w_zp_i32, stride, pad, symmetric
    )
    return requant_activate(
        acc, bias_i32, m, out_zp, act, out_i8=out_i8, exact_leaky=exact_leaky
    )


def fold_static_bias(bias_f, s_in, s_w, x_zp_i32, w_zp_i32, w_i8):
    """Fold the float bias and static zero-point terms into one int32 bias.

    bias_i32[o] = round(bias_f[o] / (S1*S2[o])) - zx*wsum[o] + K*zx*zw[o]
    (reference src/blas.c:306-334: weights_sum_int + biases_int32).
    All zero points here are the int8-shifted ones (code - 128).

    Numpy (host-side) — this is conversion-time math, and it is the single
    canonical implementation used by infer/convert.py and the tests.
    """
    import numpy as np

    bias_f = np.asarray(bias_f, np.float64)
    w_i8 = np.asarray(w_i8)
    k = w_i8.shape[0] * w_i8.shape[1] * w_i8.shape[2]
    wsum = w_i8.astype(np.int64).sum(axis=(0, 1, 2))
    x_zp = np.int64(np.asarray(x_zp_i32))
    w_zp = np.asarray(w_zp_i32, np.int64)
    static = -x_zp * wsum + k * x_zp * w_zp
    return (
        np.round(bias_f / (np.asarray(s_in, np.float64) * np.asarray(s_w, np.float64)))
        + static
    ).astype(np.int32)
