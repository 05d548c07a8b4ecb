"""Float-domain layer primitives (NHWC), shared by QAT training and float eval.

These are the float counterparts of the reference's layer forwards
(src/convolutional_layer.c:802-848, src/maxpool_layer.c:174-217,
src/upsample_layer.c, src/shortcut_layer.c), re-expressed as pure jittable
functions in NHWC layout.  Quantized-domain inference variants live
in ops/ and infer/engine.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

BN_EPS = 1e-6  # reference adds 1e-6 to sqrt(var), src/blas.c:576


def activate(x: jax.Array, name: str) -> jax.Array:
    """The complete darknet activation library (src/activations.h:19-55,
    enum include/darknet.h:87-89): LOGISTIC RELU RELIE LINEAR RAMP TANH PLSE
    LEAKY6 RELU6 LEAKY ELU LOGGY STAIR HARDTAN LHTAN SELU."""
    if name == "linear":
        return x
    if name == "leaky":
        return jnp.where(x > 0, x, 0.1 * x)
    if name == "relu":
        return jnp.maximum(x, 0.0)
    if name == "relu6":
        return jnp.clip(x, 0.0, 6.0)
    if name == "leaky6":
        return jnp.where(x > 6, 6.0, jnp.where(x > 0, x, 0.1 * x))
    if name == "logistic":
        return jax.nn.sigmoid(x)
    if name == "loggy":
        return 2.0 * jax.nn.sigmoid(x) - 1.0
    if name == "relie":
        return jnp.where(x > 0, x, 0.01 * x)
    if name == "ramp":
        return x * (x > 0) + 0.1 * x
    if name == "tanh":
        return jnp.tanh(x)
    if name == "elu":
        return jnp.where(x >= 0, x, jnp.exp(jnp.minimum(x, 0.0)) - 1.0)
    if name == "selu":
        return jnp.where(
            x >= 0, 1.0507 * x, 1.0507 * 1.6732 * (jnp.exp(jnp.minimum(x, 0.0)) - 1.0)
        )
    if name == "plse":
        return jnp.where(
            x < -4, 0.01 * (x + 4),
            jnp.where(x > 4, 0.01 * (x - 4) + 1.0, 0.125 * x + 0.5),
        )
    if name == "stair":
        n = jnp.floor(x)
        return jnp.where(
            jnp.floor(x).astype(jnp.int32) % 2 == 0,
            jnp.floor(x / 2.0),
            (x - n) + jnp.floor(x / 2.0),
        )
    if name == "hardtan":
        return jnp.clip(x, -1.0, 1.0)
    if name == "lhtan":
        return jnp.where(
            x < 0, 0.001 * x, jnp.where(x > 1, 0.001 * (x - 1) + 1.0, x)
        )
    raise ValueError(f"unknown activation {name!r}")


def conv2d(
    x: jax.Array, w: jax.Array, stride: int, pad: int,
    compute_dtype: str | None = None,
) -> jax.Array:
    """Plain float conv, NHWC x HWIO -> NHWC, darknet symmetric padding.

    ``compute_dtype="bfloat16"`` runs the contraction with bf16 operands —
    the training fast path (params/optimizer stay f32; the tensor cores
    accumulate bf16 products in f32, the output rounds through bf16 once).  The plain-cast form keeps autodiff happy: the conv
    transpose rule sees matching dtypes, unlike a mixed-dtype
    preferred_element_type conv whose cotangent is f32 against bf16
    operands.
    """
    if compute_dtype in (None, "float32"):
        dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
        return lax.conv_general_dilated(
            x, w, (stride, stride), [(pad, pad), (pad, pad)], dimension_numbers=dn
        )
    dt = jnp.dtype(compute_dtype)
    x = x.astype(dt)
    w = w.astype(dt)
    dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    out = lax.conv_general_dilated(
        x, w, (stride, stride), [(pad, pad), (pad, pad)], dimension_numbers=dn
    )
    return out.astype(jnp.float32)


def bn_inference_scale_bias(gamma, beta, mean, var):
    """Fold BN running stats into a per-channel (scale, bias) pair.

    y = gamma * (x - mean) / (sqrt(var) + eps) + beta
    Matches the reference's fold (src/blas.c:582-601): note the denominator is
    sqrt(var) + eps, NOT sqrt(var + eps).
    """
    inv = gamma / (jnp.sqrt(var) + BN_EPS)
    return inv, beta - mean * inv


def fold_bn_into_weights(w, bias, gamma, beta, mean, var):
    """Return (w_folded, bias_folded) for conv-then-BN collapse.

    w is HWIO; the fold scales each output channel: w' = w * gamma/(sqrt(var)+eps),
    b' = beta - gamma*mean/(sqrt(var)+eps) (+ the conv's own bias scaled in —
    darknet conv layers with BN reuse .biases as BN beta, so ``bias`` here IS
    beta and there is no separate conv bias; we keep the argument for clarity).
    Reference: src/blas.c:582-601 batch_normalize_weights / batch_normalize_bias.
    """
    inv = gamma / (jnp.sqrt(var) + BN_EPS)
    w_folded = w * inv.reshape(1, 1, 1, -1)
    bias_folded = beta - mean * inv
    del bias
    return w_folded, bias_folded


def batch_stats(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-channel mean/variance over (N, H, W) of an NHWC tensor.

    darknet's variance_cpu divides by (batch*spatial - 1)? No — it divides by
    (batch * spatial), biased, src/blas.c mean/variance kernels; we match jnp
    default (biased) which is what jnp.var computes.
    """
    mean = jnp.mean(x, axis=(0, 1, 2))
    var = jnp.var(x, axis=(0, 1, 2))
    return mean, var


def maxpool_padding(h: int, size: int, stride: int, pad: int) -> tuple[int, int, int]:
    """darknet maxpool geometry: out = (h + pad - size)//stride + 1, window
    origin offset -pad//2 (src/maxpool_layer.c:22-37,112-115).

    Returns (out_h, pad_lo, pad_hi) where pad_lo/pad_hi are the explicit
    amounts to pad so a VALID reduce_window reproduces the darknet layout.
    """
    out = (h + pad - size) // stride + 1
    pad_lo = pad // 2
    pad_hi = max(0, (out - 1) * stride + size - pad_lo - h)
    return out, pad_lo, pad_hi


def maxpool(x: jax.Array, size: int, stride: int, pad: int) -> jax.Array:
    """Float maxpool with darknet geometry; pads with -inf."""
    _, lo, hi = maxpool_padding(x.shape[1], size, stride, pad)
    return lax.reduce_window(
        x,
        -jnp.inf,
        lax.max,
        window_dimensions=(1, size, size, 1),
        window_strides=(1, stride, stride, 1),
        padding=((0, 0), (lo, hi), (lo, hi), (0, 0)),
    )


def maxpool_u8(x_u8: jax.Array, size: int, stride: int, pad: int) -> jax.Array:
    """Quantized maxpool — max is scale-invariant so it runs directly on codes.

    Pads with code 0, matching the reference quant pool's effective padding
    (src/maxpool_layer.c:109-147: invalid taps contribute 0 to a uint8 max).
    Also accepts the engine's shifted int8 representation (code - 128), where
    code 0 is -128 — the identical domain minimum.
    """
    init = jnp.int8(-128) if x_u8.dtype == jnp.int8 else jnp.uint8(0)
    _, lo, hi = maxpool_padding(x_u8.shape[1], size, stride, pad)
    return lax.reduce_window(
        x_u8,
        init,
        lax.max,
        window_dimensions=(1, size, size, 1),
        window_strides=(1, stride, stride, 1),
        padding=((0, 0), (lo, hi), (lo, hi), (0, 0)),
    )


def upsample_nearest(x: jax.Array, stride: int) -> jax.Array:
    """Nearest-neighbor upsample by integer stride (src/blas.c:781-803).

    Works on any dtype (including uint8 codes — value-preserving, so quant
    params pass through unchanged, reference src/upsample_layer.c:96-113).
    """
    return jnp.repeat(jnp.repeat(x, stride, axis=1), stride, axis=2)


def route_concat(tensors: list[jax.Array]) -> jax.Array:
    """Channel concat (darknet [route] with multiple layers, src/route_layer.c)."""
    return jnp.concatenate(tensors, axis=-1)


def shortcut_add(x: jax.Array, skip: jax.Array) -> jax.Array:
    """Residual add (darknet [shortcut]); same-shape case (src/blas.c:490-514
    also handles mismatched shapes via strided indexing — YOLOv3 only uses the
    same-shape form, so that is what we support)."""
    return x + skip


# ---------------------------------------------------------------------------
# Extended layer library (reference SURVEY §2.3: the full darknet op set).
# All float-domain; the reference quantizes none of these.
# ---------------------------------------------------------------------------


def connected(x: jax.Array, w: jax.Array, bias: jax.Array) -> jax.Array:
    """Fully-connected layer (src/connected_layer.c): flattens all non-batch
    dims.  w is (in_features, out_features)."""
    n = x.shape[0]
    return x.reshape(n, -1) @ w + bias


def softmax(x: jax.Array, temperature: float = 1.0, groups: int = 1) -> jax.Array:
    """darknet softmax layer (src/softmax_layer.c) over the channel axis,
    optionally in independent groups along channels."""
    n = x.shape[0]
    flat = x.reshape(n, groups, -1)
    out = jax.nn.softmax(flat / temperature, axis=-1)
    return out.reshape(x.shape)


def global_avgpool(x: jax.Array) -> jax.Array:
    """Global average pool NHWC -> (N, 1, 1, C) (src/avgpool_layer.c)."""
    return jnp.mean(x, axis=(1, 2), keepdims=True)


def dropout(x: jax.Array, prob: float, rng: jax.Array | None) -> jax.Array:
    """Inverted-scaling dropout matching darknet (src/dropout_layer.c:
    surviving values scaled by 1/(1-p) at train time, identity at test)."""
    if rng is None or prob <= 0:
        return x
    keep = jax.random.bernoulli(rng, 1.0 - prob, x.shape)
    return jnp.where(keep, x / (1.0 - prob), 0.0)


import functools as _functools


@_functools.lru_cache(maxsize=32)
def _reorg_permutation(h: int, w: int, c: int, stride: int) -> "np.ndarray":
    """Flat NCHW permutation reproducing darknet's reorg_cpu exactly
    (src/blas.c:420-441).

    darknet's reorg is famously NOT a clean space-to-depth: the input buffer
    (c, h, w) is *reinterpreted* as (c/s^2, h*s, w*s) and gathered from, and
    the output buffer is then reinterpreted as (c*s^2, h/s, w/s).  YOLOv2
    checkpoints depend on this exact element order, so we precompute the flat
    permutation (out_flat[i] = in_flat[perm[i]]) and apply it as a gather.
    """
    import numpy as np

    out_c2 = c // (stride * stride)
    perm = np.empty(c * h * w, np.int64)
    for k in range(c):
        off = k // out_c2
        c2 = k % out_c2
        for j in range(h):
            h2 = j * stride + off // stride
            for i in range(w):
                w2 = i * stride + off % stride
                in_index = i + w * (j + h * k)
                out_index = w2 + w * stride * (h2 + h * stride * c2)
                perm[in_index] = out_index
    return perm


def reorg(x: jax.Array, stride: int, reverse: bool = False) -> jax.Array:
    """darknet [reorg] (src/reorg_layer.c + src/blas.c:420-441 reorg_cpu).

    Not-reverse (the yolov2 passthrough, 26x26x64 -> 13x13x256): the exact —
    and famously scrambled — darknet element mapping, applied as a static
    flat gather in NCHW order so imported yolov2 weights line up bit-for-bit.
    reverse inverts the permutation ((c,h,w) -> (c/s^2, h*s, w*s)).
    """
    import numpy as np

    n, h, w, c = x.shape
    if not reverse:
        # out[a] = in[perm[a]]  (reorg_cpu forward=0: out[in_idx] = x[out_idx])
        perm = _reorg_permutation(h, w, c, stride)
        out_shape = (n, c * stride * stride, h // stride, w // stride)
    else:
        # reorg_cpu forward=1 scatters out[out_idx] = x[in_idx] -> gather by
        # the inverse permutation
        perm = np.argsort(_reorg_permutation(h, w, c, stride))
        out_shape = (n, c // (stride * stride), h * stride, w * stride)
    flat = x.transpose(0, 3, 1, 2).reshape(n, -1)  # NCHW flat
    out = flat[:, jnp.asarray(perm)]
    return out.reshape(out_shape).transpose(0, 2, 3, 1)


def lrn(x: jax.Array, size: int, alpha: float, beta: float, kappa: float) -> jax.Array:
    """Local response normalization across channels (src/normalization_layer.c):
    out = x / (kappa + alpha * sum_{window} x^2)^beta."""
    sq = x * x
    c = x.shape[-1]
    half = size // 2
    padded = jnp.pad(sq, ((0, 0), (0, 0), (0, 0), (half, half)))
    window = sum(padded[..., i : i + c] for i in range(size))
    return x / (kappa + alpha * window) ** beta


def l2norm(x: jax.Array, eps: float = 1e-6) -> jax.Array:
    """Channel-wise L2 normalization (src/l2norm_layer.c)."""
    norm = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True) + eps)
    return x / norm


def crop(
    x: jax.Array, crop_h: int, crop_w: int, *, train: bool = False,
    rng: jax.Array | None = None, flip: bool = False,
) -> jax.Array:
    """Crop layer (src/crop_layer.c): center crop at test time; random offset
    + optional random horizontal flip at train time (the color-distortion
    part of the reference crop layer lives in the data pipeline here)."""
    n, h, w, c = x.shape
    if train and rng is not None:
        r1, r2, r3 = jax.random.split(rng, 3)
        dy = jax.random.randint(r1, (), 0, max(h - crop_h, 0) + 1)
        dx = jax.random.randint(r2, (), 0, max(w - crop_w, 0) + 1)
        out = jax.lax.dynamic_slice(x, (0, dy, dx, 0), (n, crop_h, crop_w, c))
        if flip:
            do_flip = jax.random.bernoulli(r3)
            out = jnp.where(do_flip, out[:, :, ::-1, :], out)
        return out
    dy, dx = (h - crop_h) // 2, (w - crop_w) // 2
    return x[:, dy : dy + crop_h, dx : dx + crop_w, :]


def local_conv(x: jax.Array, w: jax.Array, bias: jax.Array, size: int,
               stride: int, pad: int) -> jax.Array:
    """Locally-connected layer (src/local_layer.c): conv with untied weights
    per output position.  w: (out_h*out_w, size*size*in_c, out_c),
    bias: (out_h*out_w, out_c).  Implemented as patch extraction + batched
    matmul (einsum) — small layers only, as in darknet (yolov1 head)."""
    n, h, wd, c = x.shape
    if pad:
        # darknet local layer pads with zeros (float domain)
        x = jnp.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    out_h = (h + 2 * pad - size) // stride + 1
    out_w = (wd + 2 * pad - size) // stride + 1
    patches = jax.lax.conv_general_dilated_patches(
        x, (size, size), (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )  # (n, out_h, out_w, c*size*size) in CHW-of-patch order
    patches = patches.reshape(n, out_h * out_w, -1)
    out = jnp.einsum("npk,pko->npo", patches, w) + bias
    return out.reshape(n, out_h, out_w, -1)


def deconv2d(x: jax.Array, w: jax.Array, stride: int) -> jax.Array:
    """Transpose convolution (src/deconvolutional_layer.c): darknet uses
    no padding and output size (in-1)*stride + size.  w is HWIO."""
    return lax.conv_transpose(
        x, w, (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
