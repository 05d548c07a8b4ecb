"""End-to-end graph tests: float forward, QAT simulation, integer engine parity.

The key invariant (mirroring the reference's QAT->integer contract, Jacob et
al. §3): the integer program built by infer/convert must reproduce the
fake-quant training-graph simulation within accumulated rounding error —
that is what makes QAT accuracy transfer to uint8 inference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yoloq.eval import detect
from yoloq.infer.convert import convert
from yoloq.infer.engine import Engine
from yoloq.models import zoo
from yoloq.nn.graph import (
    ForwardMode,
    YoloSpec,
    forward,
    init_params,
    init_quant_state,
)


@pytest.fixture(scope="module")
def tiny():
    net = zoo.yolov3_tiny(classes=5, width=160, height=160)
    params = init_params(jax.random.PRNGKey(0), net)
    return net, params


@pytest.fixture(scope="module")
def tiny_with_ranges(tiny):
    net, params = tiny
    x = jax.random.uniform(jax.random.PRNGKey(1), (2, 160, 160, 3))
    qs = init_quant_state(net)
    # one calibration pass populates EMA ranges (adopts batch stats when fresh)
    _, aux = forward(
        net, params, x, ForwardMode(train=False, qat=True, update_ranges=True), qs
    )
    return net, params, aux["quant_state"]


class TestFloatForward:
    def test_tiny_head_shapes(self, tiny):
        net, params = tiny
        x = jnp.zeros((1, 160, 160, 3))
        heads, _ = forward(net, params, x)
        assert len(heads) == 2
        assert heads[0].shape == (1, 5, 5, 30)   # 160/32, 3*(5+5)
        assert heads[1].shape == (1, 10, 10, 30)  # 160/16

    def test_channel_inference_matches_execution(self, tiny):
        net, params = tiny
        chans = net.out_channels()
        x = jnp.zeros((1, 160, 160, 3))
        heads, _ = forward(net, params, x)
        assert chans[15] == 30 and chans[22] == 30
        assert chans[20] == 128 + 256  # route concat of upsample + layer 8

    def test_full_yolov3_compiles(self):
        net = zoo.yolov3(classes=2, width=160, height=160)
        params = init_params(jax.random.PRNGKey(0), net)
        x = jnp.zeros((1, 160, 160, 3))
        heads, _ = forward(net, params, x)
        assert [h.shape for h in heads] == [
            (1, 5, 5, 21), (1, 10, 10, 21), (1, 20, 20, 21)
        ]


class TestQATForward:
    def test_ranges_populated(self, tiny_with_ranges):
        net, params, qs = tiny_with_ranges
        assert float(qs["input"]["max"]) > 0
        for i in (0, 2, 15, 21):
            assert float(qs[f"act_{i}"]["max"]) > float(qs[f"act_{i}"]["min"])

    def test_qat_forward_differentiable(self, tiny_with_ranges):
        net, params, qs = tiny_with_ranges
        x = jax.random.uniform(jax.random.PRNGKey(2), (1, 160, 160, 3))

        def loss(p):
            heads, _ = forward(
                net, p, x, ForwardMode(train=True, qat=True), qs
            )
            return sum(jnp.mean(h**2) for h in heads)

        g = jax.grad(loss)(params)
        gnorm = sum(float(jnp.abs(v).sum()) for p in g.values() for v in p.values())
        assert np.isfinite(gnorm) and gnorm > 0


class TestIntegerEngineParity:
    @pytest.mark.parametrize("symmetric", [True, False])
    def test_engine_matches_qat_simulation(self, tiny_with_ranges, symmetric):
        net, params, qs = tiny_with_ranges
        x = jax.random.uniform(jax.random.PRNGKey(3), (1, 160, 160, 3))
        sim_heads, _ = forward(
            net, params, x,
            ForwardMode(train=False, qat=True, update_ranges=False,
                        symmetric_w=symmetric),
            qs,
        )
        program = convert(net, params, qs, symmetric_weights=symmetric)
        engine = Engine(program)
        int_heads = engine.raw_heads(np.asarray(x))
        for sim, integer, idx in zip(sim_heads, int_heads, (15, 22)):
            out_scale = program.cfg[idx].out_scale
            err = np.abs(np.asarray(sim) - integer)
            # budget: a few output LSBs of accumulated rounding
            assert err.max() <= 3.5 * out_scale, (
                f"head {idx}: max err {err.max():.4f} vs scale {out_scale:.4f}"
            )

    def test_decode_and_nms_run(self, tiny_with_ranges):
        net, params, qs = tiny_with_ranges
        program = convert(net, params, qs)
        engine = Engine(program, max_det=64)
        x = np.random.default_rng(0).uniform(0, 1, (1, 160, 160, 3)).astype(np.float32)
        boxes, obj, cls = engine.predict(x)
        assert boxes.shape == (1, 64, 4) and obj.shape == (1, 64)
        assert cls.shape == (1, 64, 5)
        assert np.all(obj >= 0) and np.all(obj <= 1)
        b, o, c = detect.nms_obj(boxes[0], obj[0], cls[0], 0.1)
        assert b.shape == (64, 4)

    def test_route_requantization_exact_on_common_grid(self, tiny_with_ranges):
        """Multi-input route branches land on the learned common grid."""
        net, params, qs = tiny_with_ranges
        program = convert(net, params, qs)
        route_cfg = program.cfg[20]
        assert route_cfg.kind == "route"
        assert len(route_cfg.branches) == 2
        # at least the scales were tracked and finite
        assert route_cfg.out_scale > 0


def _conv_precisions(lowered) -> list[str]:
    import re

    return re.findall(r"stablehlo\.convolution.*precision (\w+)>\]", lowered.as_text())


class TestReferencePrecision:
    """The float references pin every conv to full f32 ("highest"); the
    training step keeps the default, which a GPU may run in TF32."""

    def test_float_and_qat_sim_engines_pin_highest(self, tiny_with_ranges):
        from yoloq.infer.float_engine import FloatEngine, QatSimEngine

        net, params, qs = tiny_with_ranges
        x = jnp.zeros((1, 160, 160, 3))
        f = FloatEngine(net, params)
        s = QatSimEngine(net, params, qs)
        for lowered in (f._raw.lower(f.params, x), f._run.lower(f.params, x),
                        s._run.lower(s.params, x)):
            precisions = _conv_precisions(lowered)
            assert len(precisions) == 13  # yolov3-tiny's convs
            assert set(precisions) == {"HIGHEST"}

    def test_train_step_keeps_default_precision(self, tiny):
        from yoloq.train.loss import MAX_BOXES
        from yoloq.train.qat import (
            TrainConfig,
            init_train_state,
            make_train_step,
        )

        net, _ = tiny
        cfg = TrainConfig(quant_start_step=0, donate_state=False)
        state = init_train_state(net, cfg, jax.random.PRNGKey(0))
        step = make_train_step(net, cfg, qat=True)
        lowered = step.lower(state, jnp.zeros((1, 160, 160, 3)),
                             jnp.zeros((1, MAX_BOXES, 5)))
        assert set(_conv_precisions(lowered)) == {"DEFAULT"}
