"""Unit tests for core quantization math.

Golden values are computed from independent transcriptions of the reference
semantics (src/blas.c nudge / EMA / multiplier encoding), not from our own
implementation, so these tests pin the spec.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yoloq.core import (
    QUANT_MAX,
    QUANT_MIN,
    QuantParams,
    dequantize,
    ema_update,
    fake_quant,
    fake_quant_per_channel,
    multiplier_from_fixed,
    nudge_min_max,
    quantize,
    quantize_multiplier,
    requantize_fixed_np,
    requantize_float,
)


def ref_nudge(min_v, max_v):
    """Independent numpy transcription of the reference nudge (src/blas.c:68-89).

    The C code computes the scale in float32 (nudged_scale is a float), so we
    do too — exact-half ties in the zero-point round depend on it.
    """
    min_v = min(min_v, 0.0)
    max_v = max(max_v, 0.0)
    scale = np.float32(np.float32(max_v - min_v) / np.float32(255.0))
    initial_zp = 0.0 - np.float32(min_v) / scale
    if initial_zp <= 0:
        zp = 0
    elif initial_zp >= 255:
        zp = 255
    else:
        zp = round(initial_zp)
    return scale, zp


class TestNudge:
    @pytest.mark.parametrize(
        "lo,hi",
        [(-1.0, 1.0), (-6.3, 5.9), (0.0, 6.0), (-10.0, 0.0), (-0.01, 12.7)],
    )
    def test_matches_reference_nudge(self, lo, hi):
        qp = nudge_min_max(jnp.float32(lo), jnp.float32(hi))
        scale, zp = ref_nudge(lo, hi)
        assert float(qp.scale) == pytest.approx(scale, rel=1e-6)
        assert int(qp.zero_point) == zp

    def test_zero_is_exactly_representable(self):
        qp = nudge_min_max(jnp.float32(-3.7), jnp.float32(11.1))
        z = dequantize(jnp.array(int(qp.zero_point), jnp.uint8), qp)
        assert float(z) == 0.0

    def test_degenerate_range(self):
        qp = nudge_min_max(jnp.float32(0.0), jnp.float32(0.0))
        assert float(qp.scale) > 0

    def test_range_always_contains_zero(self):
        # All-positive data must still map 0 to a valid code (zp == 0).
        qp = nudge_min_max(jnp.float32(2.0), jnp.float32(6.0))
        assert int(qp.zero_point) == 0
        assert float(qp.scale) == pytest.approx(6.0 / 255.0, rel=1e-6)


class TestQuantizeDequantize:
    def test_roundtrip_error_bounded_by_half_lsb(self, rng):
        x = rng.uniform(-4.0, 4.0, size=(64,)).astype(np.float32)
        qp = nudge_min_max(jnp.float32(x.min()), jnp.float32(x.max()))
        err = np.abs(np.asarray(dequantize(quantize(jnp.asarray(x), qp), qp)) - x)
        assert err.max() <= float(qp.scale) / 2 + 1e-6

    def test_per_channel_weights(self, rng):
        w = rng.normal(size=(3, 3, 8, 4)).astype(np.float32)  # HWIO
        mins = w.min(axis=(0, 1, 2))
        maxs = w.max(axis=(0, 1, 2))
        qp = nudge_min_max(jnp.asarray(mins), jnp.asarray(maxs))
        q = quantize(jnp.asarray(w), qp, channel_axis=3)
        dq = np.asarray(dequantize(q, qp, channel_axis=3))
        for o in range(4):
            assert np.abs(dq[..., o] - w[..., o]).max() <= float(qp.scale[o]) / 2 + 1e-6

    def test_clamps_out_of_range(self):
        qp = QuantParams(jnp.float32(0.1), jnp.int32(128))
        q = quantize(jnp.array([-1e9, 1e9], jnp.float32), qp)
        assert int(q[0]) == QUANT_MIN and int(q[1]) == QUANT_MAX


class TestFakeQuant:
    def test_idempotent(self, rng):
        x = jnp.asarray(rng.uniform(-2, 2, size=(128,)).astype(np.float32))
        lo, hi = jnp.float32(-2.0), jnp.float32(2.0)
        once = fake_quant(x, lo, hi)
        twice = fake_quant(once, lo, hi)
        np.testing.assert_allclose(np.asarray(once), np.asarray(twice), atol=1e-6)

    def test_output_on_256_grid(self, rng):
        x = jnp.asarray(rng.uniform(-1, 3, size=(512,)).astype(np.float32))
        qp = nudge_min_max(jnp.float32(-1.0), jnp.float32(3.0))
        out = np.asarray(fake_quant(x, jnp.float32(-1.0), jnp.float32(3.0)))
        codes = out / float(qp.scale) + float(qp.zero_point)
        np.testing.assert_allclose(codes, np.round(codes), atol=1e-3)

    def test_ste_gradient_gated(self):
        lo, hi = jnp.float32(-1.0), jnp.float32(1.0)
        g = jax.grad(lambda x: jnp.sum(fake_quant(x, lo, hi)))(
            jnp.array([-5.0, 0.0, 0.5, 5.0], jnp.float32)
        )
        np.testing.assert_array_equal(np.asarray(g), [0.0, 1.0, 1.0, 0.0])

    def test_per_channel_matches_per_tensor_on_each_channel(self, rng):
        x = jnp.asarray(rng.normal(size=(17, 4)).astype(np.float32))
        mins = jnp.asarray(np.array([-1.0, -2.0, -0.5, -3.0], np.float32))
        maxs = jnp.asarray(np.array([1.0, 0.5, 2.0, 3.0], np.float32))
        out_pc = fake_quant_per_channel(x, mins, maxs)
        for c in range(4):
            out_pt = fake_quant(x[:, c], mins[c], maxs[c])
            np.testing.assert_allclose(
                np.asarray(out_pc[:, c]), np.asarray(out_pt), atol=1e-6
            )


class TestEMA:
    def test_first_update_adopts_batch_stats(self):
        new_min, new_max = ema_update(
            jnp.float32(0.0), jnp.float32(0.0), jnp.float32(-2.0), jnp.float32(3.0)
        )
        assert float(new_min) == -2.0 and float(new_max) == 3.0

    def test_ema_formula(self):
        # m <- m - (m - new)*(1 - decay), reference src/blas.c:53-54
        new_min, new_max = ema_update(
            jnp.float32(-1.0), jnp.float32(1.0),
            jnp.float32(-3.0), jnp.float32(5.0), decay=0.9,
        )
        assert float(new_min) == pytest.approx(-1.0 - (-1.0 - -3.0) * 0.1)
        assert float(new_max) == pytest.approx(1.0 - (1.0 - 5.0) * 0.1)


class TestQuantizeMultiplier:
    def ref_encode(self, m):
        """Independent transcription of src/blas.c:387-418."""
        s = 0
        while m < 0.5:
            m *= 2.0
            s += 1
        q = round(m * (1 << 31))
        if q == (1 << 31):
            q //= 2
            s -= 1
        return q, s

    @pytest.mark.parametrize("m", [0.5, 0.25, 0.1, 0.9999999, 0.0003, 0.75])
    def test_matches_reference_encoding(self, m):
        m0, shift = quantize_multiplier(np.array([m]))
        # float32 single-value walk like the C code
        q_ref, s_ref = self.ref_encode(np.float64(m))
        assert int(shift[0]) == s_ref
        assert abs(int(m0[0]) - q_ref) <= 1  # float64 vs C float walk

    def test_decode_accuracy(self, rng):
        m = rng.uniform(1e-6, 1 - 1e-6, size=(256,))
        m0, shift = quantize_multiplier(m)
        back = multiplier_from_fixed(m0, shift)
        np.testing.assert_allclose(back, m, rtol=2e-9)
        assert np.all(m0 >= (1 << 30)) and np.all(m0 < (1 << 31))

    def test_rejects_nonpositive(self):
        with pytest.raises(ValueError):
            quantize_multiplier(np.array([0.0]))

    def test_multiplier_above_one_uses_left_shift(self):
        # TFLite-style: M >= 1 encodes with a negative right_shift
        m0, shift = quantize_multiplier(np.array([1.5, 3.0]))
        assert (shift < 0).all()
        back = multiplier_from_fixed(m0, shift)
        np.testing.assert_allclose(back, [1.5, 3.0], rtol=1e-9)
        # and the fixed-point reference implementation honors it
        acc = np.arange(-1000, 1000, dtype=np.int64)
        out = requantize_fixed_np(acc, m0[0], shift[0])
        np.testing.assert_allclose(out, np.round(acc * 1.5), atol=1)


class TestRequantize:
    def test_negative_values_truncate_like_gemmlowp(self):
        # gemmlowp divides by 2^31 with truncation toward zero: acc=-1,
        # M0=2^30, shift=0 must give 0 (a flooring shift would give -1)
        out = requantize_fixed_np(np.array([-1]), np.int32(1 << 30), np.int32(0))
        assert out[0] == 0

    def test_fixed_point_matches_real_multiply(self, rng):
        acc = rng.integers(-(2**27), 2**27, size=(4096,), dtype=np.int64)
        m = rng.uniform(1e-4, 0.9, size=())
        m0, shift = quantize_multiplier(np.array([m]))
        fixed = requantize_fixed_np(acc, m0[0], shift[0])
        exact = np.round(acc * m).astype(np.int64)
        assert np.abs(fixed - exact).max() <= 1  # ties can differ by 1 LSB

    def test_float_path_close_to_fixed_path(self, rng):
        acc = rng.integers(-(2**24), 2**24, size=(4096,), dtype=np.int32)
        m = 0.0123
        m0, shift = quantize_multiplier(np.array([m]))
        fixed = requantize_fixed_np(acc, m0[0], shift[0])
        flt = np.asarray(requantize_float(jnp.asarray(acc), jnp.float32(m)))
        assert np.abs(fixed - flt).max() <= 1
