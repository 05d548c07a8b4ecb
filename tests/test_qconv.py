"""Golden tests: the integer conv vs a numpy transcription of the reference.

The numpy model below independently re-implements the reference's uint8 conv
pipeline in darknet layouts (NCHW / OIHW):
  - im2col with zero-point padding        (src/im2col.c:26-75)
  - two uint8 GEMMs (weights, zp plane)   (src/convolutional_layer.c:718-721)
  - weights_sum_int / biases_int32 fold   (src/blas.c:306-334)
  - double-arithmetic requant + act       (src/convolutional_layer.c:726-750)

The integer accumulator must match bit-exactly.  The requantized uint8 output
may differ by <=1 code: the reference truncates through C doubles while we
round in f32 (both are within half an LSB of exact fixed-point; parity
contract is F1-level, BASELINE.md).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from yoloq.core import nudge_min_max, quantize, quantize_multiplier
from yoloq.models.presets import distinct_conv_shapes
from yoloq.ops.qconv import (
    ACT_LEAKY,
    ACT_LINEAR,
    ACT_RELU6,
    conv_acc_int32,
    fold_static_bias,
    quantized_conv2d,
    u8_to_i8,
)


def ref_im2col_u8(x, K, stride, pad, zp):
    """darknet im2col_cpu_uint8: out-of-range pixels return the zero point."""
    C, H, W = x.shape
    out_h = (H + 2 * pad - K) // stride + 1
    out_w = (W + 2 * pad - K) // stride + 1
    cols = np.full((C * K * K, out_h * out_w), zp, dtype=np.int64)
    for c in range(C):
        for ky in range(K):
            for kx in range(K):
                row = c * K * K + ky * K + kx
                for y in range(out_h):
                    for xx in range(out_w):
                        iy = y * stride + ky - pad
                        ix = xx * stride + kx - pad
                        if 0 <= iy < H and 0 <= ix < W:
                            cols[row, y * out_w + xx] = x[c, iy, ix]
    return cols, out_h, out_w


def ref_quant_conv(x_u8, w_u8, bias_f, s_in, zp_in, s_w, zp_w, s_out, zp_out,
                   stride, pad, act):
    """Full reference-semantics integer conv, NCHW/OIHW, numpy int64."""
    O, C, K, _ = w_u8.shape
    cols, out_h, out_w = ref_im2col_u8(x_u8, K, stride, pad, zp_in)
    A = w_u8.reshape(O, C * K * K).astype(np.int64)
    acc = A @ cols  # q1*q2 gemm
    # second gemm with the per-channel zero-point plane, alpha=-1
    colsum = cols.sum(axis=0)
    acc = acc - np.asarray(zp_w, np.int64)[:, None] * colsum
    # static folds
    kk = C * K * K
    wsum = A.sum(axis=1)
    weights_sum_int = kk * zp_in * np.asarray(zp_w, np.int64) - wsum * zp_in
    bias_i32 = (bias_f / (s_in * np.asarray(s_w))).astype(np.int64) + weights_sum_int
    # requant through doubles, exactly like the C code (truncating int casts)
    m = s_in * np.asarray(s_w, np.float64) / s_out
    m0, shift = quantize_multiplier(m)
    m_value = 2.0 ** -31 * m0.astype(np.float64)
    shift_value = 2.0 ** -shift.astype(np.float64)
    v64 = ((acc + bias_i32[:, None]).astype(np.float64) * m_value[:, None]).astype(np.int64)
    v = (v64.astype(np.float64) * shift_value[:, None]).astype(np.int64)
    if act == "leaky":
        v = np.where(v < 0, np.round(v * 0.1).astype(np.int64), v)
    elif act in ("relu6",):
        v = np.where(v <= 0, 0, v)
    out = np.clip(v + zp_out, 0, 255).astype(np.uint8)
    return out.reshape(O, out_h, out_w), (acc + bias_i32[:, None]).reshape(O, out_h, out_w)


def make_case(rng, C=5, H=9, W=9, O=7, K=3, stride=1, pad=1):
    x = rng.normal(0.3, 1.0, size=(C, H, W)).astype(np.float32)
    w = rng.normal(0, 0.4, size=(O, C, K, K)).astype(np.float32)
    bias = rng.normal(0, 0.5, size=(O,)).astype(np.float32)
    # derive quant params from the data like the converter does
    in_qp = nudge_min_max(jnp.float32(x.min()), jnp.float32(x.max()))
    w_mins = w.min(axis=(1, 2, 3))
    w_maxs = w.max(axis=(1, 2, 3))
    w_qp = nudge_min_max(jnp.asarray(w_mins), jnp.asarray(w_maxs))
    out_scale, out_zp = 0.05, 111  # plausible learned output range
    x_u8 = np.asarray(quantize(jnp.asarray(x), in_qp))  # CHW per-tensor
    w_u8 = np.asarray(
        quantize(jnp.asarray(w.transpose(1, 2, 3, 0)), w_qp, channel_axis=3)
    ).transpose(3, 0, 1, 2)  # back to OIHW
    return dict(
        x=x, w=w, bias=bias, x_u8=x_u8, w_u8=w_u8,
        s_in=float(in_qp.scale), zp_in=int(in_qp.zero_point),
        s_w=np.asarray(w_qp.scale), zp_w=np.asarray(w_qp.zero_point),
        s_out=out_scale, zp_out=out_zp, stride=stride, pad=pad, K=K,
    )


def run_ours(case, act_code):
    # NCHW -> NHWC, OIHW -> HWIO
    x_u8 = jnp.asarray(case["x_u8"].transpose(1, 2, 0))[None]
    w_u8 = case["w_u8"].transpose(2, 3, 1, 0)  # HWIO
    w_i8 = np.asarray(u8_to_i8(jnp.asarray(w_u8)))
    x_zp = jnp.int32(case["zp_in"] - 128)
    w_zp = jnp.asarray(case["zp_w"].astype(np.int32) - 128)
    bias_i32 = fold_static_bias(
        jnp.asarray(case["bias"]),
        jnp.float32(case["s_in"]),
        jnp.asarray(case["s_w"]),
        x_zp, w_zp, jnp.asarray(w_i8),
    )
    m = jnp.asarray(case["s_in"] * case["s_w"] / case["s_out"], dtype=jnp.float32)
    out = quantized_conv2d(
        x_u8, jnp.asarray(w_i8), bias_i32, m, x_zp, w_zp,
        jnp.int32(case["zp_out"]), stride=case["stride"], pad=case["pad"],
        act=act_code,
    )
    return np.asarray(out)[0].transpose(2, 0, 1)  # back to OHW


class TestIntegerAccumulator:
    @pytest.mark.parametrize("stride,pad,K", [(1, 1, 3), (2, 1, 3), (1, 0, 1), (2, 0, 1)])
    def test_acc_bit_exact_vs_reference_gemm(self, rng, stride, pad, K):
        case = make_case(rng, stride=stride, pad=pad, K=K)
        _, ref_acc_bias = ref_quant_conv(
            case["x_u8"].astype(np.int64), case["w_u8"], case["bias"],
            case["s_in"], case["zp_in"], case["s_w"], case["zp_w"],
            case["s_out"], case["zp_out"], stride, pad, "linear",
        )
        # our accumulator + our folded bias, but with the reference's
        # truncating bias conversion so integers are comparable
        x_i8 = u8_to_i8(jnp.asarray(case["x_u8"].transpose(1, 2, 0))[None])
        w_u8 = case["w_u8"].transpose(2, 3, 1, 0)
        w_i8 = u8_to_i8(jnp.asarray(w_u8))
        x_zp = jnp.int32(case["zp_in"] - 128)
        w_zp = jnp.asarray(case["zp_w"].astype(np.int32) - 128)
        acc = np.asarray(conv_acc_int32(x_i8, w_i8, x_zp, w_zp, stride, pad))[0]
        kk = case["w_u8"].shape[1] * K * K
        wsum = np.asarray(w_i8, np.int64).sum(axis=(0, 1, 2))
        static = -int(x_zp) * wsum + kk * int(x_zp) * np.asarray(w_zp, np.int64)
        bias_trunc = (case["bias"] / (case["s_in"] * case["s_w"])).astype(np.int64)
        ours = acc.transpose(2, 0, 1).astype(np.int64) + (static + bias_trunc)[:, None, None]
        np.testing.assert_array_equal(ours, ref_acc_bias)


class TestQuantizedConvOutput:
    @pytest.mark.parametrize(
        "act_name,act_code",
        [("linear", ACT_LINEAR), ("leaky", ACT_LEAKY), ("relu6", ACT_RELU6)],
    )
    def test_within_one_lsb_of_reference(self, rng, act_name, act_code):
        case = make_case(rng)
        ref_out, _ = ref_quant_conv(
            case["x_u8"].astype(np.int64), case["w_u8"], case["bias"],
            case["s_in"], case["zp_in"], case["s_w"], case["zp_w"],
            case["s_out"], case["zp_out"], case["stride"], case["pad"], act_name,
        )
        ours = run_ours(case, act_code)
        diff = np.abs(ours.astype(np.int64) - ref_out.astype(np.int64))
        # The reference truncates (biased toward zero) where we round, so a
        # fraction of codes legitimately differ by exactly 1.
        assert diff.max() <= 2, f"max diff {diff.max()}"
        assert (diff <= 1).mean() == 1.0
        assert (diff == 0).mean() > 0.4, f"only {(diff == 0).mean():.2%} exact"

def ref_conv_nhwc(x_u8, w_i8, bias_i32, m, x_zp_i8, out_zp, stride, pad, act):
    """The layer's full integer semantics in numpy, per image through the
    reference's im2col: int64 accumulator of the shifted codes, then the
    engine's float32 epilogue (requant_activate) op for op."""
    n = x_u8.shape[0]
    kh, _, ci, co = w_i8.shape
    a = np.asarray(w_i8, np.int64).reshape(kh * kh * ci, co)
    # im2col rows are (c, ky, kx); HWIO weights flatten as (ky, kx, c)
    a = a.reshape(kh, kh, ci, co).transpose(2, 0, 1, 3).reshape(ci * kh * kh, co)
    outs = []
    for b in range(n):
        x_i8 = x_u8[b].astype(np.int64).transpose(2, 0, 1) - 128
        cols, oh, ow = ref_im2col_u8(x_i8, kh, stride, pad, x_zp_i8)
        acc = (a.T @ cols).reshape(co, oh, ow).transpose(1, 2, 0)
        vf = (acc + bias_i32).astype(np.float32) * m
        if act == ACT_LEAKY:
            v = np.round(np.where(vf < 0, vf * np.float32(0.1), vf))
        else:
            v = np.round(vf)
        lo = max(out_zp, 0) if act == ACT_RELU6 else 0
        outs.append(np.clip(v + np.float32(out_zp), lo, 255).astype(np.uint8))
    return np.stack(outs)


def ref_maxpool2_nhwc(y):
    """darknet 2x2/s2 maxpool with padding 1 (size-1): a trailing odd row or
    column pools alone."""
    n, h, w, c = y.shape
    oh, ow = (h + 1 - 2) // 2 + 1, (w + 1 - 2) // 2 + 1
    out = np.zeros((n, oh, ow, c), y.dtype)
    for i in range(oh):
        for j in range(ow):
            out[:, i, j] = y[:, 2 * i:2 * i + 2, 2 * j:2 * j + 2].max(axis=(1, 2))
    return out


def make_layer(rng, n=1, h=13, ci=32, co=64, k=3):
    x = rng.integers(0, 256, (n, h, h, ci), dtype=np.uint8)
    w = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)
    bias = rng.integers(-(2**14), 2**14, (co,)).astype(np.int32)
    m = rng.uniform(1e-4, 5e-3, (co,)).astype(np.float32)
    return x, w, bias, m


def run_layer(x, w, bias, m, x_zp, out_zp, pad, act):
    co = w.shape[-1]
    return np.asarray(quantized_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(m),
        jnp.int32(x_zp), jnp.zeros((co,), jnp.int32), jnp.int32(out_zp),
        stride=1, pad=pad, act=act, symmetric=True,
    ))


class TestLayerShapes:
    """The XLA conv layer against the im2col reference, bit for bit, over
    channel counts that are not multiples of 4 or 8, odd spatial sizes and
    the fused-pool consumer."""

    @pytest.mark.parametrize(
        "h,ci,co,k,pad,act",
        [
            (13, 32, 64, 3, 1, ACT_LEAKY),
            (13, 256, 30, 1, 0, ACT_LINEAR),
            (26, 16, 48, 3, 1, ACT_RELU6),
            (20, 8, 130, 3, 1, ACT_LINEAR),
            (52, 16, 32, 3, 1, ACT_RELU6),
            (72, 8, 16, 3, 1, ACT_LINEAR),
            (96, 12, 24, 3, 1, ACT_LEAKY),
        ],
    )
    def test_matches_im2col_reference(self, rng, h, ci, co, k, pad, act):
        x, w, bias, m = make_layer(rng, h=h, ci=ci, co=co, k=k)
        got = run_layer(x, w, bias, m, 7, 111, pad, act)
        want = ref_conv_nhwc(x, w, bias, m, 7, 111, 1, pad, act)
        np.testing.assert_array_equal(got, want)

    def test_batch_dimension(self, rng):
        x, w, bias, m = make_layer(rng, n=3, h=13, ci=16, co=32)
        got = run_layer(x, w, bias, m, -3, 90, 1, ACT_LEAKY)
        want = ref_conv_nhwc(x, w, bias, m, -3, 90, 1, 1, ACT_LEAKY)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("h", [16, 15])  # 15: odd map, lone last row
    def test_conv_then_pool(self, rng, h):
        from yoloq.nn.layers import maxpool_u8

        x, w, bias, m = make_layer(rng, h=h, ci=16, co=32, k=3)
        y = run_layer(x, w, bias, m, 5, 100, 1, ACT_LEAKY)
        got = np.asarray(maxpool_u8(jnp.asarray(y), 2, 2, 1))
        want = ref_maxpool2_nhwc(ref_conv_nhwc(x, w, bias, m, 5, 100, 1, 1, ACT_LEAKY))
        np.testing.assert_array_equal(got, want)


def _shape_id(t):
    return "h{}_c{}_o{}_k{}_s{}".format(*t[:5])


class TestConvShapes:
    """conv_acc_int32 (im2col GEMM) against XLA's own integer convolution,
    over every distinct conv shape of yolov3-tiny and yolov3 with the
    spatial size cut to 7 (odd, so stride 2 meets an unpaired edge)."""

    @pytest.mark.parametrize(
        "shape", distinct_conv_shapes(416), ids=_shape_id
    )
    def test_acc_matches_lax_conv(self, shape):
        from jax import lax

        _, ci, co, k, stride, pad = shape
        rng = np.random.default_rng(ci * 131 + co * 7 + k + stride)
        x = jnp.asarray(rng.integers(-128, 128, (1, 7, 7, ci), dtype=np.int8))
        w = jnp.asarray(rng.integers(-128, 128, (k, k, ci, co), dtype=np.int8))
        w_zp = jnp.asarray(rng.integers(-20, 20, co).astype(np.int32))
        x_zp = jnp.int32(-7)
        got = np.asarray(conv_acc_int32(x, w, x_zp, w_zp, stride, pad))
        xp = jnp.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                     constant_values=jnp.int8(-7))
        dn = ("NHWC", "HWIO", "NHWC")
        conv = lax.conv_general_dilated(
            xp, w, (stride, stride), "VALID", dimension_numbers=dn,
            preferred_element_type=jnp.int32,
        )
        patch = lax.conv_general_dilated(
            xp, jnp.ones((k, k, ci, 1), jnp.int8), (stride, stride), "VALID",
            dimension_numbers=dn, preferred_element_type=jnp.int32,
        )
        want = np.asarray(conv - w_zp * patch)
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_acc_on_gpu_matches_cpu(gpu_device):
    """The GPU's int8 GEMMs give the CPU's accumulators bit for bit
    (chip_smoke.py checks every shape at full size)."""
    import jax

    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, (2, 13, 13, 3), dtype=np.int8)
    w = rng.integers(-128, 128, (3, 3, 3, 16), dtype=np.int8)
    w_zp = rng.integers(-20, 20, 16).astype(np.int32)
    args = (x, w, np.int32(-7), w_zp)
    fn = jax.jit(lambda x, w, zx, zw: conv_acc_int32(x, w, zx, zw, 1, 1))
    got = np.asarray(fn(*jax.device_put(args, gpu_device)))
    want = np.asarray(fn(*jax.device_put(args, jax.devices("cpu")[0])))
    np.testing.assert_array_equal(got, want)


def conv2d_nchw(x, w, bias, stride, pad):
    O, C, K, _ = w.shape
    H, W = x.shape[1:]
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad)))
    out_h = (H + 2 * pad - K) // stride + 1
    out_w = (W + 2 * pad - K) // stride + 1
    out = np.zeros((O, out_h, out_w), np.float32)
    for o in range(O):
        for y in range(out_h):
            for xx in range(out_w):
                patch = xp[:, y * stride:y * stride + K, xx * stride:xx * stride + K]
                out[o, y, xx] = (patch * w[o]).sum() + bias[o]
    return out


def test_dequantized_close_to_float_conv(rng):
    case = make_case(rng)
    ours = run_ours(case, ACT_LINEAR)
    deq = (ours.astype(np.float32) - case["zp_out"]) * case["s_out"]
    ref = conv2d_nchw(case["x"], case["w"], case["bias"], case["stride"], case["pad"])
    # quant error budget: input LSB propagated through K*K*C taps + output LSB
    tol = case["s_out"] * 1.5 + 0.15
    clipped = np.clip(ref, (0 - case["zp_out"]) * case["s_out"],
                      (255 - case["zp_out"]) * case["s_out"])
    assert np.abs(deq - clipped).max() < tol


class TestExactLeaky:
    def test_double_round_matches_c_semantics(self):
        """exact_leaky reproduces the reference's double-rounded leaky
        (round(0.1*round(v)), src/convolutional_layer.c:737; numpy twin
        parity/ctwin.py:315-316) — the byte-parity opt-in the default
        single-rounded epilogue deviates from (deviation 8)."""
        import jax.numpy as jnp

        from yoloq.ops.qconv import ACT_LEAKY, requant_activate

        rng = np.random.default_rng(0)
        acc = jnp.asarray(rng.integers(-20000, 20000, (1, 4, 4, 8)), jnp.int32)
        bias = jnp.asarray(rng.integers(-500, 500, 8), jnp.int32)
        m = jnp.asarray(rng.uniform(0.001, 0.02, 8).astype(np.float32))
        zp = jnp.int32(77)

        got = np.asarray(
            requant_activate(acc, bias, m, zp, ACT_LEAKY, exact_leaky=True)
        )

        # independent numpy transcription of the C arithmetic
        v = np.asarray(acc) + np.asarray(bias).reshape(1, 1, 1, -1)
        vf = v.astype(np.float32) * np.asarray(m).reshape(1, 1, 1, -1)
        v1 = np.round(vf)  # the requant round
        neg = np.round(v1 * np.float32(0.1))
        out = np.where(v1 < 0, neg, v1) + 77
        want = np.clip(out, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(got, want)

    def test_single_vs_double_round_differ_by_at_most_one(self):
        import jax.numpy as jnp

        from yoloq.ops.qconv import ACT_LEAKY, requant_activate

        rng = np.random.default_rng(1)
        acc = jnp.asarray(rng.integers(-20000, 0, (1, 8, 8, 4)), jnp.int32)
        bias = jnp.zeros(4, jnp.int32)
        m = jnp.full(4, 0.01, jnp.float32)
        zp = jnp.int32(128)
        a = np.asarray(requant_activate(acc, bias, m, zp, ACT_LEAKY)).astype(int)
        b = np.asarray(
            requant_activate(acc, bias, m, zp, ACT_LEAKY, exact_leaky=True)
        ).astype(int)
        assert np.abs(a - b).max() <= 1
