"""Quantization math primitives (Jacob et al., arXiv:1712.05877)."""

from yoloq.core.quant import (
    QuantParams,
    QUANT_MIN,
    QUANT_MAX,
    nudge_min_max,
    quantize,
    dequantize,
    fake_quant,
    fake_quant_per_channel,
    ema_update,
    quantize_multiplier,
    multiplier_from_fixed,
    requantize_float,
    requantize_fixed_np,
)
