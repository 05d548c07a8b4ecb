"""Space-to-depth conv+pool rewrite exactness (convert._s2d_weights).

The s2d path phases 2x2 pixel blocks into channels and replaces the
following 2x2/s2 maxpool with an elementwise max over the 4 output phases.
It must be BIT-identical to the plain path on every downstream layer and
head (integer accumulation is order-invariant; max commutes with the
monotone per-channel epilogue).
"""

import copy

import jax
import numpy as np

from yoloq.infer.convert import convert
from yoloq.infer.engine import build_forward
from yoloq.models.presets import flagship_program
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


def _net_with_near_miss_route():
    """conv0 -> pool1 -> conv2 -> pool3 -> route4([0]) -> conv5 -> yolo.

    conv0's following pool makes it an s2d candidate — but route4 indexes
    layer 0, so the rewrite must leave it alone.  conv2 stays rewritable.
    """
    anchors = ((10.0, 14.0), (23.0, 27.0), (37.0, 58.0))
    return NetworkDef(
        specs=(
            ConvSpec(filters=16, size=3, stride=1, pad=1, activation="relu6"),
            MaxPoolSpec(size=2, stride=2),
            ConvSpec(filters=32, size=3, stride=1, pad=1, activation="relu6"),
            MaxPoolSpec(size=2, stride=2),
            RouteSpec(layers=(0,)),
            ConvSpec(filters=24, size=1, stride=1, pad=0, activation="linear",
                     batch_normalize=False, quant_stop=True),
            YoloSpec(mask=(0, 1, 2), anchors=anchors, classes=3),
        ),
        width=32,
        height=32,
    )


def _program(net):
    params = init_params(jax.random.PRNGKey(0), net)
    x = jax.random.uniform(jax.random.PRNGKey(1), (2, net.height, net.width, 3))
    qs = init_quant_state(net)
    _, aux = forward(
        net, params, x, ForwardMode(train=False, qat=True, update_ranges=True), qs
    )
    return convert(net, params, aux["quant_state"])


def test_s2d_bit_identical_to_plain_path():
    prog = flagship_program(classes=5, size=64)
    s2d_layers = [i for i, c in enumerate(prog.cfg) if c.s2d_pool]
    assert s2d_layers == [0, 2, 4]  # the small-channel stem stages
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    arrays = jax.device_put(prog.arrays)
    got_h, got_o = build_forward(prog, use_s2d=True, return_outputs=True)(arrays, x)

    plain = copy.deepcopy(prog)
    for c in plain.cfg:
        c.s2d_pool = False
    ref_h, ref_o = build_forward(plain, return_outputs=True)(
        jax.device_put(plain.arrays), x
    )
    for i, (a, b) in enumerate(zip(ref_o, got_o)):
        if i in s2d_layers:
            continue  # fused-away conv slot holds the pooled duplicate
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(ref_h, got_h):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_s2d_skipped_for_referenced_convs():
    """A conv whose output feeds a route must not get the s2d rewrite."""
    prog = _program(_net_with_near_miss_route())
    assert not prog.cfg[0].s2d_pool  # route4 references layer 0
    assert prog.cfg[2].s2d_pool      # conv2 is free to rewrite


def test_per_layer_outputs_route_sees_conv_not_pool():
    """outputs[0] consumed by the route must be the CONV output (32x32x16),
    never the pooled 16x16 tensor — shape check through the route concat."""
    net = _net_with_near_miss_route()
    prog = _program(net)
    x = np.zeros((1, 32, 32, 3), np.float32)
    arrays = jax.device_put(prog.arrays)
    _, outs = build_forward(prog, use_s2d=True, return_outputs=True)(arrays, x)
    assert outs[0].shape == (1, 32, 32, 16)
    assert outs[4].shape == (1, 32, 32, 16)  # route passes conv0 through
