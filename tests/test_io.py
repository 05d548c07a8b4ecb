"""cfg importer and darknet weights serialization tests."""

import os

import numpy as np
import pytest

from yoloq.models import zoo
from yoloq.models.cfg import load_cfg, parse_cfg
from yoloq.models.darknet_weights import (
    load_darknet_weights,
    save_darknet_weights,
    _layout_size,
)
from yoloq.models.presets import synthetic_quant_state
from yoloq.nn.graph import (
    ConvSpec,
    MaxPoolSpec,
    RouteSpec,
    UpsampleSpec,
    YoloSpec,
    init_params_numpy,
)

REF_CFG = "/root/reference/cfg/yolov3_tiny_quant_channelwise.cfg"


@pytest.fixture
def ref_cfg():
    if not os.path.exists(REF_CFG):
        pytest.skip("reference cfg not present")
    return REF_CFG


class TestCfgImporter:
    def test_reference_cfg_matches_zoo_builder(self, ref_cfg):
        net, train_cfg = load_cfg(ref_cfg)
        ours = zoo.yolov3_tiny(classes=5, activation="relu6",
                               anchors=zoo.NOK_TINY_ANCHORS)
        assert len(net.specs) == len(ours.specs) == 24
        for i, (a, b) in enumerate(zip(net.specs, ours.specs)):
            assert type(a) is type(b), f"layer {i}: {a} vs {b}"
        # spot-check key layers
        assert net.specs[0] == ours.specs[0]
        assert net.specs[11] == ours.specs[11]   # stride-1 maxpool
        assert net.specs[17].layers == (13,)     # route -4
        assert net.specs[20].layers == (19, 8)   # route -1, 8
        assert net.specs[15].quant_stop and net.specs[15].activation == "linear"
        assert net.specs[16].mask == (3, 4, 5)
        assert net.specs[16].anchors == zoo.NOK_TINY_ANCHORS
        assert net.width == 416 and net.height == 416

    def test_train_options(self, ref_cfg):
        _, tc = load_cfg(ref_cfg)
        assert tc.learning_rate == pytest.approx(0.001)
        assert tc.burn_in == 1000
        assert tc.quant_start_step == 10000
        assert tc.lr_steps == (400000, 450000)
        assert tc.lr_scales == (0.1, 0.1)
        assert tc.max_batches == 550200

    def test_shortcut_relative_index(self):
        cfg = """
[net]
width=64
height=64
channels=3
[convolutional]
filters=8
size=3
stride=1
pad=1
activation=leaky
[convolutional]
filters=8
size=3
stride=1
pad=1
activation=leaky
[shortcut]
from=-2
activation=linear
"""
        net, _ = parse_cfg(cfg)
        assert net.specs[2].index == 0


class TestDarknetWeights:
    @pytest.mark.parametrize("quantized", [False, True])
    def test_roundtrip(self, tmp_path, quantized):
        net = zoo.yolov3_tiny(classes=5, width=96, height=96)
        params = init_params_numpy(3, net)
        # make BN stats non-trivial so the round-trip is meaningful
        for p in params.values():
            if "var" in p:
                p["var"] = np.abs(np.random.default_rng(0).normal(1, 0.1, p["var"].shape)).astype(np.float32)
        qs = synthetic_quant_state(net) if quantized else None
        path = str(tmp_path / "w.weights")
        save_darknet_weights(path, net, params, qs, seen=1234)
        ckpt = load_darknet_weights(path, net)  # auto-detect layout
        assert ckpt.seen == 1234
        for i, p in params.items():
            for k in ("w", "bias"):
                np.testing.assert_array_equal(ckpt.params[i][k], p[k])
            if "gamma" in p:
                np.testing.assert_array_equal(ckpt.params[i]["gamma"], p["gamma"])
                np.testing.assert_array_equal(ckpt.params[i]["var"], p["var"])

    def test_quant_ranges_survive_roundtrip(self, tmp_path):
        net = zoo.yolov3_tiny(classes=5, width=96, height=96)
        params = init_params_numpy(3, net)
        qs = synthetic_quant_state(net)
        path = str(tmp_path / "w.weights")
        save_darknet_weights(path, net, params, qs)
        ckpt = load_darknet_weights(path, net)
        # re-converting from the recovered ranges must give identical programs
        from yoloq.infer.convert import convert

        p1 = convert(net, params, qs)
        p2 = convert(net, ckpt.params, ckpt.quant_state)
        assert p1.in_scale == pytest.approx(p2.in_scale, rel=1e-6)
        assert p1.in_zp == p2.in_zp
        for i in p1.arrays:
            np.testing.assert_array_equal(p1.arrays[i]["w_i8"], p2.arrays[i]["w_i8"])
            np.testing.assert_array_equal(p1.arrays[i]["bias_i32"], p2.arrays[i]["bias_i32"])
            np.testing.assert_allclose(p1.arrays[i]["m"], p2.arrays[i]["m"], rtol=1e-6)

    def test_uint8_weights_in_file_match_converter(self, tmp_path):
        net = zoo.yolov3_tiny(classes=5, width=96, height=96)
        params = init_params_numpy(3, net)
        qs = synthetic_quant_state(net)
        path = str(tmp_path / "w.weights")
        save_darknet_weights(path, net, params, qs)
        ckpt = load_darknet_weights(path, net)
        from yoloq.infer.convert import convert

        prog = convert(net, params, qs)
        w_u8_file = ckpt.raw_quant[0]["weights_u8"]        # OIHW uint8
        w_u8_conv = (prog.arrays[0]["w_i8"].astype(np.int16) + 128).astype(np.uint8)
        np.testing.assert_array_equal(
            w_u8_file, w_u8_conv.transpose(3, 2, 0, 1)
        )

    def test_size_mismatch_detected(self, tmp_path):
        net = zoo.yolov3_tiny(classes=5, width=96, height=96)
        params = init_params_numpy(3, net)
        path = str(tmp_path / "w.weights")
        save_darknet_weights(path, net, params)
        bad = zoo.yolov3_tiny(classes=7, width=96, height=96)
        with pytest.raises(ValueError):
            load_darknet_weights(path, bad)
