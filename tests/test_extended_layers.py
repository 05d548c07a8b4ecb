"""Extended darknet layer set: forwards, reorg exactness, v2/v1 heads, IO."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yoloq.eval import detect
from yoloq.models import zoo
from yoloq.nn import layers as L
from yoloq.nn.graph import (
    ActivationSpec,
    AvgPoolSpec,
    BatchNormSpec,
    ConnectedSpec,
    ConvSpec,
    DeconvSpec,
    DetectionSpec,
    DropoutSpec,
    ForwardMode,
    L2NormSpec,
    LocalSpec,
    LRNSpec,
    MaxPoolSpec,
    NetworkDef,
    RegionSpec,
    ReorgSpec,
    SoftmaxSpec,
    forward,
    init_params_numpy,
)


def ref_reorg_c(x_nchw, stride, forward_flag):
    """Direct transcription of src/blas.c:420-441 reorg_cpu."""
    b, c, h, w = x_nchw.shape
    out = np.zeros_like(x_nchw).reshape(b, -1)
    xf = x_nchw.reshape(b, -1)
    out_c = c // (stride * stride)
    for k in range(c):
        for j in range(h):
            for i in range(w):
                in_index = i + w * (j + h * k)
                c2 = k % out_c
                offset = k // out_c
                w2 = i * stride + offset % stride
                h2 = j * stride + offset // stride
                out_index = w2 + w * stride * (h2 + h * stride * c2)
                if forward_flag:
                    out[:, out_index] = xf[:, in_index]
                else:
                    out[:, in_index] = xf[:, out_index]
    return out


class TestReorg:
    def test_matches_c_reference_forward0(self, rng):
        """The yolov2 passthrough case (layer reverse=0 -> reorg_cpu forward=0)."""
        x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)  # NHWC
        got = np.asarray(L.reorg(jnp.asarray(x), 2, reverse=False))
        ref_flat = ref_reorg_c(x.transpose(0, 3, 1, 2), 2, forward_flag=False)
        ref = ref_flat.reshape(2, 64, 4, 4).transpose(0, 2, 3, 1)
        np.testing.assert_array_equal(got, ref)

    def test_reverse_matches_c_reference_forward1(self, rng):
        """darknet's reverse reorg is NOT the inverse of its forward — it is a
        separate scatter (reorg_cpu forward=1 with the layer's input dims).
        Verify element-for-element against the C loop."""
        x = rng.normal(size=(1, 6, 6, 8)).astype(np.float32)
        got = np.asarray(L.reorg(jnp.asarray(x), 2, reverse=True))
        ref_flat = ref_reorg_c(x.transpose(0, 3, 1, 2), 2, forward_flag=True)
        ref = ref_flat.reshape(1, 2, 12, 12).transpose(0, 2, 3, 1)
        np.testing.assert_array_equal(got, ref)


class TestSimpleLayers:
    def test_connected_softmax_pipeline(self, rng):
        net = NetworkDef(
            specs=(
                ConvSpec(filters=4, quantized=False),
                AvgPoolSpec(),
                ConnectedSpec(outputs=10, activation="linear"),
                SoftmaxSpec(),
            ),
            width=32, height=32,
        )
        params = jax.tree.map(jnp.asarray, init_params_numpy(0, net))
        x = jnp.asarray(rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
        heads, _ = forward(net, params, x)
        # softmax output is the last layer's output; re-run to fetch it
        from yoloq.nn.graph import apply_simple_layer  # noqa

        # direct check through shapes
        shapes = net.shapes()
        assert shapes[-1] == (1, 1, 10)

    def test_lrn_identity_when_alpha_zero(self, rng):
        x = jnp.asarray(rng.normal(size=(1, 4, 4, 8)).astype(np.float32))
        out = L.lrn(x, size=5, alpha=0.0, beta=0.75, kappa=1.0)
        np.testing.assert_allclose(np.asarray(out), np.asarray(x), rtol=1e-6)

    def test_l2norm_unit_norm(self, rng):
        x = jnp.asarray(rng.normal(size=(1, 2, 2, 16)).astype(np.float32))
        out = np.asarray(L.l2norm(x))
        norms = np.linalg.norm(out, axis=-1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-3)

    def test_deconv_shape(self, rng):
        x = jnp.zeros((1, 5, 5, 3))
        w = jnp.zeros((4, 4, 3, 8))
        out = L.deconv2d(x, w, stride=2)
        assert out.shape == (1, 12, 12, 8)  # (5-1)*2 + 4

    def test_local_conv_untied_weights(self, rng):
        x = jnp.asarray(rng.normal(size=(1, 4, 4, 2)).astype(np.float32))
        # 2x2 output positions with stride 2, kernel 2
        w = jnp.asarray(rng.normal(size=(4, 8, 3)).astype(np.float32))
        b = jnp.zeros((4, 3))
        out = L.local_conv(x, w, b, size=2, stride=2, pad=0)
        assert out.shape == (1, 2, 2, 3)
        # position (0,0) must use weight slice 0 only
        patch = np.asarray(x)[0, :2, :2, :]
        feats = patch.transpose(2, 0, 1).reshape(-1)  # C-major like darknet im2col
        expected = feats @ np.asarray(w)[0]
        np.testing.assert_allclose(np.asarray(out)[0, 0, 0], expected, atol=1e-5)

    def test_dropout_train_vs_eval(self, rng):
        x = jnp.ones((1, 8, 8, 4))
        out_eval = L.dropout(x, 0.5, None)
        np.testing.assert_array_equal(np.asarray(out_eval), np.asarray(x))
        out_train = L.dropout(x, 0.5, jax.random.PRNGKey(0))
        vals = np.unique(np.asarray(out_train))
        assert set(np.round(vals, 3)) <= {0.0, 2.0}


class TestRegionHead:
    def test_yolov2_tiny_forward_and_decode(self):
        net = zoo.yolov2_tiny(classes=3, width=96, height=96, quantized=False)
        params = jax.tree.map(jnp.asarray, init_params_numpy(0, net))
        x = jnp.zeros((1, 96, 96, 3))
        heads, _ = forward(net, params, x)
        assert len(heads) == 1
        assert heads[0].shape == (1, 3, 3, 5 * (5 + 3))
        boxes, obj, cls = detect.decode_all_heads(heads, net)
        assert boxes.shape == (1, 3 * 3 * 5, 4)
        assert np.all(np.asarray(obj) >= 0) and np.all(np.asarray(obj) <= 1)
        probs = np.asarray(cls)
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)  # softmaxed

    def test_yolov2_full_forward(self):
        net = zoo.yolov2(classes=3, width=128, height=128, quantized=False)
        params = jax.tree.map(jnp.asarray, init_params_numpy(0, net))
        x = jnp.zeros((1, 128, 128, 3))
        heads, _ = forward(net, params, x)
        assert heads[0].shape == (1, 4, 4, 40)

    def test_region_loss_gradients(self):
        from yoloq.train.loss import MAX_BOXES, region_head_loss

        rng = np.random.default_rng(0)
        raw = jnp.asarray(rng.normal(0, 0.1, (1, 4, 4, 5 * 8)).astype(np.float32))
        # apply region forward activations first
        spec = RegionSpec(anchors=zoo.VOC_V2_TINY_ANCHORS, classes=3, num=5)
        from yoloq.nn.graph import apply_simple_layer

        truths = np.zeros((1, MAX_BOXES, 5), np.float32)
        truths[0, 0] = [0.5, 0.5, 0.3, 0.4, 1.0]

        def loss_fn(r):
            out = apply_simple_layer(spec, None, r)
            l, _ = region_head_loss(out, jnp.asarray(truths), spec.anchors, 3)
            return l

        val, g = jax.value_and_grad(loss_fn)(raw)
        assert np.isfinite(float(val)) and float(val) > 0
        assert np.isfinite(np.asarray(g)).all()
        assert float(jnp.abs(g).sum()) > 0


class TestDetectionHead:
    def test_v1_decode_shapes(self):
        spec = DetectionSpec(classes=3, num=2, side=4, sqrt=True)
        out = jnp.asarray(
            np.random.default_rng(0).uniform(0, 1, (1, 4 * 4 * (3 + 2 * 5))).astype(np.float32)
        )
        boxes, obj, cls = detect.decode_detection_head(out, spec)
        assert boxes.shape == (1, 32, 4)
        assert obj.shape == (1, 32)
        assert cls.shape == (1, 32, 3)


class TestExtendedWeightsIO:
    def test_roundtrip_classifier_with_connected(self, tmp_path):
        from yoloq.models.darknet_weights import (
            load_darknet_weights,
            save_darknet_weights,
        )

        net = NetworkDef(
            specs=(
                ConvSpec(filters=8, quantized=False),
                MaxPoolSpec(2, 2),
                BatchNormSpec(),
                DeconvSpec(filters=4, size=2, stride=2),
                AvgPoolSpec(),
                ConnectedSpec(outputs=6, activation="linear"),
                SoftmaxSpec(),
            ),
            width=32, height=32,
        )
        params = init_params_numpy(5, net)
        params[5]["w"] += 0.5  # make asymmetric for a meaningful roundtrip
        path = str(tmp_path / "c.weights")
        save_darknet_weights(path, net, params)
        ckpt = load_darknet_weights(path, net, quantized=False)
        for i in params:
            for k, v in params[i].items():
                if i == 2 and k == "bias":
                    continue  # standalone BN beta is not serialized (darknet)
                np.testing.assert_array_equal(ckpt.params[i][k], v)


class TestActivationLibrary:
    """The 16-activation darknet library vs transcriptions of
    src/activations.h:19-55."""

    @staticmethod
    def _c(name, x):
        import math

        if name == "linear":
            return x
        if name == "logistic":
            return 1.0 / (1.0 + math.exp(-x))
        if name == "loggy":
            return 2.0 / (1.0 + math.exp(-x)) - 1
        if name == "relu":
            return x * (x > 0)
        if name == "elu":
            return (x >= 0) * x + (x < 0) * (math.exp(x) - 1)
        if name == "selu":
            return (x >= 0) * 1.0507 * x + (x < 0) * 1.0507 * 1.6732 * (math.exp(x) - 1)
        if name == "relie":
            return x if x > 0 else 0.01 * x
        if name == "ramp":
            return x * (x > 0) + 0.1 * x
        if name == "leaky6":
            return 6 if x > 6 else (x if x > 0 else 0.1 * x)
        if name == "relu6":
            return min(max(x, 0), 6)
        if name == "leaky":
            return x if x > 0 else 0.1 * x
        if name == "tanh":
            return (math.exp(2 * x) - 1) / (math.exp(2 * x) + 1)
        if name == "plse":
            if x < -4:
                return 0.01 * (x + 4)
            if x > 4:
                return 0.01 * (x - 4) + 1
            return 0.125 * x + 0.5
        if name == "stair":
            n = math.floor(x)
            if n % 2 == 0:
                return math.floor(x / 2.0)
            return (x - n) + math.floor(x / 2.0)
        if name == "hardtan":
            return -1 if x < -1 else (1 if x > 1 else x)
        if name == "lhtan":
            if x < 0:
                return 0.001 * x
            if x > 1:
                return 0.001 * (x - 1) + 1
            return x
        raise ValueError(name)

    def test_all_match_c(self):
        names = ("linear", "logistic", "loggy", "relu", "elu", "selu", "relie",
                 "ramp", "leaky6", "relu6", "leaky", "tanh", "plse", "stair",
                 "hardtan", "lhtan")
        xs = np.array([-8.0, -4.5, -4.0, -1.0, -0.3, 0.0, 0.3, 1.0, 2.7, 4.0,
                       4.5, 6.0, 8.0], np.float32)
        for name in names:
            got = np.asarray(L.activate(jnp.asarray(xs), name))
            want = np.array([self._c(name, float(v)) for v in xs], np.float32)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=name)

    def test_all_differentiable(self):
        names = ("logistic", "loggy", "relu", "elu", "selu", "relie", "ramp",
                 "leaky6", "relu6", "leaky", "tanh", "plse", "hardtan", "lhtan")
        for name in names:
            g = jax.grad(lambda v, n=name: jnp.sum(L.activate(v, n)))(
                jnp.asarray([-2.0, 0.5, 3.0])
            )
            assert np.isfinite(np.asarray(g)).all(), name
