"""cfg `input_calibration` and per-layer `first_time` flags (VERDICT r1 item 6).

Drives the reference's own cfg (cfg/yolov3_tiny_quant_channelwise.cfg) with
both flags activated end-to-end: parse -> quant-state seeding -> weights
save/load (first_time layers carry no quant block, reference
src/parser.c:1176-1191) -> convert -> integer engine forward.
"""

import os
import re

import jax
import numpy as np
import pytest

from yoloq.models.cfg import parse_cfg
from yoloq.models.darknet_weights import (
    load_darknet_weights,
    save_darknet_weights,
)
from yoloq.nn.graph import (
    ForwardMode,
    RouteSpec,
    UpsampleSpec,
    forward,
    init_params,
    init_quant_state,
)

REF_CFG = "/root/reference/cfg/yolov3_tiny_quant_channelwise.cfg"


@pytest.fixture(scope="module")
def flagged_cfg_text():
    if not os.path.exists(REF_CFG):
        pytest.skip("reference cfg not present")
    text = open(REF_CFG).read()
    # seed the input range from cfg and mark route/upsample as first_time
    text = text.replace("[net]", "[net]\ninput_calibration=-0.25,1.5", 1)
    text = re.sub(r"\[(route|upsample)\]", r"[\1]\nfirst_time=1", text)
    return text


def test_flags_parse(flagged_cfg_text):
    net, tc = parse_cfg(flagged_cfg_text)
    assert tc.input_calibration == (-0.25, 1.5)
    routes = [s for s in net.specs if isinstance(s, RouteSpec)]
    ups = [s for s in net.specs if isinstance(s, UpsampleSpec)]
    assert routes and all(s.first_time for s in routes)
    assert ups and all(s.first_time for s in ups)


def test_input_calibration_seeds_quant_state(flagged_cfg_text):
    net, tc = parse_cfg(flagged_cfg_text)
    qs = init_quant_state(net, input_calibration=tc.input_calibration)
    assert float(qs["input"]["min"]) == -0.25
    assert float(qs["input"]["max"]) == 1.5
    # single calibration value means [0, v]
    qs1 = init_quant_state(net, input_calibration=(2.0,))
    assert float(qs1["input"]["min"]) == 0.0
    assert float(qs1["input"]["max"]) == 2.0


def test_first_time_roundtrip_and_engine(flagged_cfg_text, tmp_path):
    """Weights written for a first_time cfg omit route/upsample quant blocks;
    loading them back and building the engine still works (ranges inherited /
    re-learned), reproducing the reference fine-tune-from-float workflow."""
    text = flagged_cfg_text.replace("width=416", "width=96").replace(
        "height=416", "height=96"
    )
    net, tc = parse_cfg(text)
    params = init_params(jax.random.PRNGKey(0), net)
    qs = init_quant_state(net, input_calibration=tc.input_calibration)
    x = jax.random.uniform(jax.random.PRNGKey(1), (1, 96, 96, 3))
    _, aux = forward(
        net, params, x, ForwardMode(train=False, qat=True, update_ranges=True), qs
    )
    qs = jax.tree.map(np.asarray, aux["quant_state"])

    path = str(tmp_path / "ft.weights")
    params_np = {i: {k: np.asarray(v) for k, v in p.items()} for i, p in params.items()}
    save_darknet_weights(path, net, params_np, qs)

    # the flagged net reads its own file; the same cfg WITHOUT first_time has
    # a different (larger) layout, so auto-detection must reject it
    ckpt = load_darknet_weights(path, net)
    net_plain, _ = parse_cfg(
        text.replace("first_time=1\n", "")
    )
    with pytest.raises(ValueError):
        load_darknet_weights(path, net_plain)

    # multi-input route has no stored range -> engine re-derives it from the
    # QAT state we trained above; convert+forward must succeed
    from yoloq.infer.convert import convert
    from yoloq.infer.engine import build_forward

    qs2 = dict(ckpt.quant_state)
    # first_time multi-route ranges are absent from the file by design;
    # supply the live QAT range (the fine-tuning scenario)
    for i, s in enumerate(net.specs):
        if isinstance(s, RouteSpec) and len(s.layers) > 1 and f"act_{i}" not in qs2:
            qs2[f"act_{i}"] = qs[f"act_{i}"]
    program = convert(net, ckpt.params, qs2)
    fwd = jax.jit(build_forward(program))
    heads = fwd(program.arrays, np.zeros((1, 96, 96, 3), np.float32))
    assert len(heads) == 2 and all(np.isfinite(np.asarray(h)).all() for h in heads)
