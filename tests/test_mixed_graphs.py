"""Mixed float/quant graph support (the reference's per-layer quantized= flags)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yoloq.infer.convert import convert
from yoloq.infer.engine import Engine
from yoloq.nn.graph import (
    ConvSpec,
    ForwardMode,
    MaxPoolSpec,
    NetworkDef,
    RouteSpec,
    YoloSpec,
    forward,
    init_params,
    init_quant_state,
)

ANCHORS = ((10, 14), (23, 27), (37, 58))


def mixed_net():
    """quant conv -> pool -> FLOAT conv -> quant conv -> head."""
    return NetworkDef(
        specs=(
            ConvSpec(filters=8, activation="relu6", quantized=True),        # 0 u8
            MaxPoolSpec(2, 2),                                              # 1 u8
            ConvSpec(filters=12, activation="leaky", quantized=False),      # 2 f32
            ConvSpec(filters=16, activation="relu6", quantized=True),       # 3 u8
            ConvSpec(filters=3 * 9, size=1, pad=0, activation="linear",
                     batch_normalize=False, quantized=True, quant_stop=True),  # 4
            YoloSpec(mask=(0, 1, 2), anchors=ANCHORS, classes=4),           # 5
        ),
        width=64, height=64,
    )


class TestDomains:
    def test_output_domains(self):
        net = mixed_net()
        assert net.output_domains() == ["u8", "u8", "f32", "u8", "f32", "f32"]

    def test_boundary_range_tracked(self):
        qs = init_quant_state(mixed_net())
        assert "in_3" in qs          # float->quant boundary
        assert "act_2" not in qs     # float conv output not fake-quanted

    def test_float_route_domain(self):
        net = NetworkDef(
            specs=(
                ConvSpec(filters=8, quantized=True),
                ConvSpec(filters=8, quantized=False),
                RouteSpec(layers=(0, 1)),
            ),
            width=32, height=32,
        )
        assert net.output_domains()[-1] == "f32"


class TestMixedEngine:
    @pytest.fixture(scope="class")
    def calibrated(self):
        net = mixed_net()
        params = init_params(jax.random.PRNGKey(0), net)
        qs = init_quant_state(net)
        x = jax.random.uniform(jax.random.PRNGKey(1), (2, 64, 64, 3))
        _, aux = forward(
            net, params, x, ForwardMode(train=False, qat=True, update_ranges=True), qs
        )
        return net, params, aux["quant_state"]

    def test_engine_matches_qat_sim(self, calibrated):
        net, params, qs = calibrated
        x = jax.random.uniform(jax.random.PRNGKey(2), (1, 64, 64, 3))
        sim_heads, _ = forward(
            net, params, x, ForwardMode(train=False, qat=True, update_ranges=False), qs
        )
        program = convert(net, params, qs)
        kinds = [c.kind for c in program.cfg]
        assert kinds == ["qconv", "maxpool", "fconv", "qconv", "qconv", "yolo"]
        engine = Engine(program)
        int_heads = engine.raw_heads(np.asarray(x))
        out_scale = program.cfg[4].out_scale
        err = np.abs(np.asarray(sim_heads[0]) - int_heads[0])
        assert err.max() <= 3.5 * out_scale, err.max()

    def test_missing_boundary_range_raises(self, calibrated):
        net, params, qs = calibrated
        bad = {k: v for k, v in qs.items() if k != "in_3"}
        with pytest.raises(ValueError, match="in_3"):
            convert(net, params, bad)
