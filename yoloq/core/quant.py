"""Core uint8 affine-quantization math.

Implements the Jacob et al. (arXiv:1712.05877) scheme used by the reference
framework (ArtyZe/yolo_quantization):

  real = scale * (quant - zero_point),   quant in [0, 255]  (uint8 asymmetric)

Reference semantics being matched (file:line refer to /root/reference):
  - range "nudge" -> (scale, zero_point):        src/blas.c:68-89
  - EMA min/max tracking for activations:        src/blas.c:49-62 (decay 0.999)
  - post-training quantize q=round(x/S)+Z:       src/blas.c:151-158
  - fake-quant (quantize-dequantize in-place):   src/blas.c:90-104
  - gemmlowp fixed-point multiplier encoding:    src/blas.c:387-418

Everything here is functional and jit-friendly: no Python control flow on
traced values, static shapes, vectorized over channels.  Unlike the
reference's per-channel C loops, per-channel quantization is expressed as
whole-array ops reduced over all axes but the channel axis, so XLA fuses it
into one elementwise pass.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

QUANT_MIN = 0    # reference include/darknet.h:47 QUANT_NEGATIVE_LIMIT
QUANT_MAX = 255  # reference include/darknet.h:46 QUANT_POSITIVE_LIMIT
EMA_DECAY = 0.999  # reference src/convolutional_kernels.cu fake-quant calls


class QuantParams(NamedTuple):
    """Affine quantization parameters.

    ``scale`` float32, ``zero_point`` int32.  Shapes are either scalar ()
    (per-tensor) or (C,) (per-channel).  The pair maps reals to uint8 codes:
    q = round(x / scale) + zero_point, clamped to [0, 255].
    """

    scale: jax.Array
    zero_point: jax.Array

    @property
    def per_channel(self) -> bool:
        return self.scale.ndim > 0 and self.scale.shape[0] > 1


def nudge_min_max(min_val: jax.Array, max_val: jax.Array) -> QuantParams:
    """Turn a float range into (scale, zero_point) with an exactly-representable 0.

    Mirrors the reference nudge (src/blas.c:68-89): the range is first widened
    to include 0 (the reference guarantees this by initializing its min/max
    scan at 0, src/blas.c:34-35), scale = (max-min)/255, and the zero point is
    round(-min/scale) clamped into [0, 255] so that real 0.0 maps to an exact
    uint8 code — required so that zero-padding in convolutions is lossless.

    Degenerate ranges (min == max == 0) get scale 1 to avoid division by zero
    (the reference asserts instead, src/blas.c:64-67).
    """
    min_val = jnp.minimum(min_val.astype(jnp.float32), 0.0)
    max_val = jnp.maximum(max_val.astype(jnp.float32), 0.0)
    rng = max_val - min_val
    scale = jnp.where(rng > 0, rng, 1.0) / (QUANT_MAX - QUANT_MIN)
    initial_zp = QUANT_MIN - min_val / scale
    zero_point = jnp.clip(jnp.round(initial_zp), QUANT_MIN, QUANT_MAX).astype(
        jnp.int32
    )
    return QuantParams(scale=scale, zero_point=zero_point)


def quantize(x: jax.Array, qp: QuantParams, channel_axis: int | None = None) -> jax.Array:
    """Real -> uint8 codes: clamp(round(x/S) + Z, 0, 255).

    Reference: src/blas.c:151-158 (quant_weights_with_min_max_channel body).
    ``channel_axis`` selects the axis that per-channel params broadcast over.
    """
    scale, zp = _broadcast(qp, x.ndim, channel_axis)
    q = jnp.round(x / scale) + zp
    return jnp.clip(q, QUANT_MIN, QUANT_MAX).astype(jnp.uint8)


def dequantize(q: jax.Array, qp: QuantParams, channel_axis: int | None = None) -> jax.Array:
    """uint8 codes -> reals: (q - Z) * S.  Reference: src/convolutional_layer.c:752-760."""
    scale, zp = _broadcast(qp, q.ndim, channel_axis)
    return (q.astype(jnp.int32) - zp).astype(jnp.float32) * scale


def _broadcast(qp: QuantParams, ndim: int, channel_axis: int | None):
    scale, zp = qp.scale, qp.zero_point
    if scale.ndim == 0 or channel_axis is None:
        return scale, zp
    shape = [1] * ndim
    shape[channel_axis] = scale.shape[0]
    return scale.reshape(shape), zp.reshape(shape)


# ---------------------------------------------------------------------------
# Fake quantization (QAT forward) with straight-through estimator.
# ---------------------------------------------------------------------------


@jax.custom_vjp
def fake_quant(x: jax.Array, min_val: jax.Array, max_val: jax.Array) -> jax.Array:
    """Quantize-dequantize ``x`` through the nudged uint8 grid of [min, max].

    Forward mirrors the reference fake-quant (src/blas.c:87-104): clamp to the
    nudged range, snap to the 256-level grid, return to reals.  The training
    graph therefore *sees* quantization error (Jacob et al. §3).

    Backward is a gated straight-through estimator: gradients pass unchanged
    where x landed inside the clamp range and are zeroed outside, which is the
    TF FakeQuantWithMinMaxVars behavior.  (The reference implicitly uses an
    ungated STE because it fake-quants copies; gating is strictly better and
    standard.)  No gradient flows to min/max — ranges are EMA-tracked state,
    not learned parameters, exactly as in the reference.
    """
    out, _ = _fake_quant_fwd(x, min_val, max_val)
    return out


def _fake_quant_fwd(x, min_val, max_val):
    qp = nudge_min_max(min_val, max_val)
    nudged_min = (QUANT_MIN - qp.zero_point).astype(jnp.float32) * qp.scale
    nudged_max = (QUANT_MAX - qp.zero_point).astype(jnp.float32) * qp.scale
    clamped = jnp.clip(x, nudged_min, nudged_max)
    q = jnp.round((clamped - nudged_min) / qp.scale)
    out = q * qp.scale + nudged_min
    mask = (x >= nudged_min) & (x <= nudged_max)
    return out, mask


def _fake_quant_bwd(mask, g):
    return (jnp.where(mask, g, 0.0), None, None)


fake_quant.defvjp(_fake_quant_fwd, _fake_quant_bwd)


@jax.custom_vjp
def fake_quant_per_channel(
    x: jax.Array, min_val: jax.Array, max_val: jax.Array
) -> jax.Array:
    """Per-channel fake-quant over the LAST axis of ``x``.

    Used for conv weights in HWIO layout (per output channel), matching the
    reference's per-filter weight fake-quant (src/convolutional_kernels.cu:159-168
    quantizing each filter row separately).
    """
    out, _ = _fq_pc_fwd(x, min_val, max_val)
    return out


def _fq_pc_fwd(x, min_val, max_val):
    qp = nudge_min_max(min_val, max_val)  # shapes (C,)
    nudged_min = (QUANT_MIN - qp.zero_point).astype(jnp.float32) * qp.scale
    nudged_max = (QUANT_MAX - qp.zero_point).astype(jnp.float32) * qp.scale
    clamped = jnp.clip(x, nudged_min, nudged_max)
    q = jnp.round((clamped - nudged_min) / qp.scale)
    out = q * qp.scale + nudged_min
    mask = (x >= nudged_min) & (x <= nudged_max)
    return out, mask


def _fq_pc_bwd(mask, g):
    return (jnp.where(mask, g, 0.0), None, None)


fake_quant_per_channel.defvjp(_fq_pc_fwd, _fq_pc_bwd)


@jax.custom_vjp
def fake_quant_symmetric_per_channel(x: jax.Array) -> jax.Array:
    """Symmetric per-channel (last axis) weight fake-quant: scale = max|x|/127.

    The QAT twin of infer/convert.py's symmetric_weights=True scheme
    (TFLite-style signed-int8 weights, zero point 0).  Straight-through
    gradient; the clamp at +-max|x| is vacuous so no gating is needed.
    """
    out, _ = _fq_sym_fwd(x)
    return out


def _fq_sym_fwd(x):
    absmax = jnp.max(jnp.abs(x), axis=tuple(range(x.ndim - 1)))
    scale = jnp.where(absmax > 0, absmax, 1.0) / 127.0
    q = jnp.clip(jnp.round(x / scale), -127, 127)
    return q * scale, None


def _fq_sym_bwd(_, g):
    return (g,)


fake_quant_symmetric_per_channel.defvjp(_fq_sym_fwd, _fq_sym_bwd)


@jax.custom_vjp
def fake_quant_learned(x: jax.Array, min_val: jax.Array, max_val: jax.Array) -> jax.Array:
    """fake_quant with GRADIENTS to the range — learnable quantization ranges.

    Forward is identical to fake_quant (nudged uint8 grid).  Backward follows
    TF's FakeQuantWithMinMaxVarsGradient: upstream gradients pass to x inside
    the clamp range; gradients landing on clamped-below elements accumulate
    into d/d(min), clamped-above into d/d(max).  Training then moves the
    range to trade clipping error against grid coarseness ON THE TASK LOSS —
    the remedy class the EMA statistics (minmax / percentile) cannot
    express.  Used by TrainConfig.learned_ranges after an EMA warmup seeds
    the ranges (nn/graph.py, train/qat.py).
    """
    out, _ = _fq_learned_fwd(x, min_val, max_val)
    return out


def _fq_learned_fwd(x, min_val, max_val):
    qp = nudge_min_max(min_val, max_val)
    nudged_min = (QUANT_MIN - qp.zero_point).astype(jnp.float32) * qp.scale
    nudged_max = (QUANT_MAX - qp.zero_point).astype(jnp.float32) * qp.scale
    clamped = jnp.clip(x, nudged_min, nudged_max)
    q = jnp.round((clamped - nudged_min) / qp.scale)
    out = q * qp.scale + nudged_min
    below = x < nudged_min
    above = x > nudged_max
    return out, (below, above)


def _fq_learned_bwd(res, g):
    below, above = res
    gx = jnp.where(below | above, 0.0, g)
    gmin = jnp.sum(jnp.where(below, g, 0.0))
    gmax = jnp.sum(jnp.where(above, g, 0.0))
    return gx, gmin, gmax


fake_quant_learned.defvjp(_fq_learned_fwd, _fq_learned_bwd)


# ---------------------------------------------------------------------------
# EMA range tracking (activation statistics during QAT).
# ---------------------------------------------------------------------------


def ema_update(
    ema_min: jax.Array,
    ema_max: jax.Array,
    batch_min: jax.Array,
    batch_max: jax.Array,
    decay: float = EMA_DECAY,
) -> tuple[jax.Array, jax.Array]:
    """EMA-track activation ranges: m <- m - (m - new) * (1 - decay).

    Reference: src/blas.c:52-58.  The reference special-cases the very first
    update (both stats still 0) by adopting the batch stats directly; we keep
    that so ranges warm-start instead of creeping from 0.
    """
    fresh = (ema_min == 0.0) & (ema_max == 0.0)
    new_min = ema_min - (ema_min - batch_min) * (1.0 - decay)
    new_max = ema_max - (ema_max - batch_max) * (1.0 - decay)
    return (
        jnp.where(fresh, batch_min, new_min),
        jnp.where(fresh, batch_max, new_max),
    )


# ---------------------------------------------------------------------------
# gemmlowp-style fixed-point requantization multiplier.
# ---------------------------------------------------------------------------


def quantize_multiplier(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Encode real multipliers M > 0 as (M0 int32, right_shift).

    M ~= M0 * 2^-31 * 2^-right_shift with M0 in [2^30, 2^31).  This is the
    gemmlowp encoding the reference uses to serialize requant multipliers
    (src/blas.c:387-418).  Host-side conversion code — vectorized numpy, not
    jitted.  np.frexp gives M = mant * 2^exp with mant in [0.5, 1), so
    right_shift = -exp and M0 = round(mant * 2^31), with the mant==1.0
    rounding edge case folded back (reference src/blas.c:410-413).

    Unlike the reference (which asserts M < 1, src/blas.c:391-392), M >= 1
    is supported via a NEGATIVE right_shift (a left shift) — TFLite does the
    same; legitimate QAT checkpoints with narrow output ranges produce M
    slightly above 1.
    """
    m = np.asarray(m, dtype=np.float64)
    if np.any(m <= 0.0):
        raise ValueError(f"multipliers must be > 0; got min {m.min()}")
    mant, exp = np.frexp(m)  # m = mant * 2**exp, mant in [0.5, 1)
    shift = (-exp).astype(np.int32)
    q = np.round(mant * (1 << 31)).astype(np.int64)
    overflow = q == (1 << 31)
    q = np.where(overflow, q >> 1, q)
    shift = np.where(overflow, shift - 1, shift).astype(np.int32)
    return q.astype(np.int32), shift


def multiplier_from_fixed(m0: np.ndarray, right_shift: np.ndarray) -> np.ndarray:
    """Decode (M0, shift) back to the real multiplier (float64)."""
    return np.asarray(m0, np.float64) * 2.0**-31 * 2.0 ** -np.asarray(right_shift, np.float64)


def requantize_float(acc: jax.Array, m: jax.Array) -> jax.Array:
    """Scale int32 accumulators to the output grid: round(acc * M), in float32.

    This is the engine's path: the requant multiply runs in f32 and fuses
    into the conv epilogue.  acc fits in ~2^28 for the largest layers,
    so f32's 24-bit mantissa can deviate from exact fixed-point by at most
    ±1 LSB — the accuracy contract is F1-level parity (BASELINE.md), and
    bit-exactness against our own spec is tested via requantize_fixed_np.
    (The reference itself is not integer-exact either: it requantizes through
    C doubles, src/convolutional_layer.c:732-733.)
    """
    return jnp.round(acc.astype(jnp.float32) * m)


def requantize_fixed_np(acc: np.ndarray, m0: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """Bit-exact integer requantization (numpy spec/reference implementation).

    SaturatingRoundingDoublingHighMul(acc, M0) followed by
    RoundingDivideByPOT(., shift) — the gemmlowp output stage the (M0, shift)
    encoding is designed for.  Used in tests to pin down the semantics the
    f32 runtime path approximates.
    """
    acc = np.asarray(acc, dtype=np.int64)
    m0 = np.asarray(m0, dtype=np.int64)
    shift = np.asarray(shift, dtype=np.int64)
    # Doubling high mul: gemmlowp divides (prod + nudge) by 2^31 with C++
    # TRUNCATION toward zero, not an arithmetic (flooring) right shift —
    # they differ on negative values.
    prod = acc * m0  # fits in int64: |acc| < 2^31, m0 < 2^31
    nudge = np.where(prod >= 0, 1 << 30, 1 - (1 << 30))
    summed = prod + nudge
    high = np.sign(summed) * (np.abs(summed) >> 31)
    # Negative shift = left shift (M >= 1 encodings).
    left = np.maximum(-shift, 0)
    rs = np.maximum(shift, 0)
    high = high << left
    # Rounding right shift (gemmlowp RoundingDivideByPOT).
    mask = (np.int64(1) << rs) - 1
    remainder = high & mask
    threshold = (mask >> 1) + np.where(high < 0, 1, 0)
    out = (high >> rs) + np.where(remainder > threshold, 1, 0)
    return out.astype(np.int32)
