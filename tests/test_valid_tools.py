"""VOC/COCO writers, mAP, and weight-surgery tool tests."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from yoloq.eval.valid import (
    voc_map,
    write_coco_results,
    write_imagenet_results,
    write_voc_results,
)
from yoloq.infer.engine import Engine
from yoloq.models import weights_tools as wt
from yoloq.models import zoo
from yoloq.models.presets import flagship_program
from yoloq.nn.graph import init_params_numpy


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("valid")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(3):
        im = (rng.uniform(0, 1, (64, 64, 3)) * 255).astype(np.uint8)
        p = root / "images" / f"im{i}.jpg"
        Image.fromarray(im).save(p)
        (root / "labels" / f"im{i}.txt").write_text("0 0.5 0.5 0.4 0.4\n")
        paths.append(str(p))
    lf = root / "list.txt"
    lf.write_text("\n".join(paths))
    return str(lf), str(root)


@pytest.fixture(scope="module")
def engine():
    return Engine(flagship_program(classes=5, size=64), max_det=32)


class TestWriters:
    def test_voc_files(self, dataset, engine, tmp_path_factory):
        lf, _ = dataset
        out = str(tmp_path_factory.mktemp("voc_out"))
        files = write_voc_results(engine, lf, out, [f"c{i}" for i in range(5)])
        assert len(files) == 5
        content = open(files["c0"]).read().strip().splitlines()
        if content:
            parts = content[0].split()
            assert len(parts) == 6
            assert parts[0].startswith("im")
            float(parts[1])

    def test_imagenet_txt(self, dataset, engine, tmp_path_factory):
        """myvalid's eval=imagenet writer (print_imagenet_detections,
        examples/detector.c:238-258): 1-based image index, cls+1, clamped
        pixel boxes."""
        lf, _ = dataset
        out = os.path.join(str(tmp_path_factory.mktemp("inet_out")), "det.txt")
        write_imagenet_results(engine, lf, out)
        lines = open(out).read().strip().splitlines()
        for ln in lines:
            parts = ln.split()
            assert len(parts) == 7
            idx, cls = int(parts[0]), int(parts[1])
            assert 1 <= idx <= 3 and 1 <= cls <= 5
            x1, y1, x2, y2 = map(float, parts[3:])
            assert 0 <= x1 <= x2 <= 64 and 0 <= y1 <= y2 <= 64

    def test_coco_json(self, dataset, engine, tmp_path_factory):
        lf, _ = dataset
        out = os.path.join(str(tmp_path_factory.mktemp("coco_out")), "r.json")
        write_coco_results(engine, lf, out)
        data = json.load(open(out))
        assert isinstance(data, list)
        if data:
            assert set(data[0]) == {"image_id", "category_id", "bbox", "score"}


class TestMAP:
    def test_map_runs_and_bounded(self, dataset, engine):
        lf, _ = dataset
        res = voc_map(engine, lf, 5)
        assert 0.0 <= res["map"] <= 1.0
        assert res["num_truths"][0] == 3

    def test_perfect_detector_gets_map_1(self, dataset, monkeypatch, engine):
        """Feed ground truth back as detections -> AP must be 1."""
        lf, _ = dataset
        import yoloq.eval.valid as V

        def fake_predict(engine_, path, flip=False, class_map=None):
            boxes = np.array([[0.5, 0.5, 0.4, 0.4]], np.float32)
            return boxes, np.array([0.9], np.float32), np.ones((1, 5), np.float32), 64, 64

        monkeypatch.setattr(V, "_predict", fake_predict)
        res = V.voc_map(engine, lf, 5)
        assert res["ap"][0] == pytest.approx(1.0)


class TestWeightsTools:
    def test_rgbgr_swaps_first_conv(self):
        net = zoo.yolov3_tiny(classes=5, width=64, height=64)
        params = init_params_numpy(0, net)
        before = params[0]["w"].copy()
        wt.rgbgr_net(net, params)
        np.testing.assert_array_equal(params[0]["w"], before[:, :, ::-1, :])

    def test_denormalize_preserves_function(self):
        import jax
        import jax.numpy as jnp

        from yoloq.nn.graph import forward

        net = zoo.yolov3_tiny(classes=5, width=64, height=64)
        params = init_params_numpy(0, net)
        # non-trivial BN stats
        rng = np.random.default_rng(1)
        for p in params.values():
            if "var" in p:
                p["var"] = np.abs(rng.normal(1, 0.2, p["var"].shape)).astype(np.float32)
                p["mean"] = rng.normal(0, 0.1, p["mean"].shape).astype(np.float32)
        x = jnp.asarray(rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
        ref_heads, _ = forward(net, jax.tree.map(jnp.asarray, params), x)
        wt.denormalize_net(net, params)
        got_heads, _ = forward(net, jax.tree.map(jnp.asarray, params), x)
        for a, b in zip(ref_heads, got_heads):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)

    def test_normalize_roundtrip(self):
        """normalize_net (examples/darknet.c:98-122) adds identity BN without
        changing the function; denormalize_net inverts it back to the
        original bias/weights (the darknet toolbox round trip)."""
        import jax
        import jax.numpy as jnp

        from yoloq.nn.graph import ConvSpec, forward

        net = zoo.yolov3_tiny(classes=5, width=64, height=64)
        params = init_params_numpy(0, net)
        rng = np.random.default_rng(2)
        # give the BN-free head convs a real bias so the round trip is tested
        for i, s in enumerate(net.specs):
            if isinstance(s, ConvSpec) and not s.batch_normalize:
                params[i]["bias"] = rng.normal(0, 0.2, params[i]["bias"].shape).astype(
                    np.float32
                )
        before = {i: {k: v.copy() for k, v in p.items()} for i, p in params.items()}
        x = jnp.asarray(rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
        ref_heads, _ = forward(net, jax.tree.map(jnp.asarray, params), x)

        net2 = wt.normalize_net(net, params)
        n_bn_before = sum(
            1 for s in net.specs if isinstance(s, ConvSpec) and s.batch_normalize
        )
        n_bn_after = sum(
            1 for s in net2.specs if isinstance(s, ConvSpec) and s.batch_normalize
        )
        assert n_bn_after > n_bn_before  # head convs gained BN
        # identity BN: function bit-unchanged
        got_heads, _ = forward(net2, jax.tree.map(jnp.asarray, params), x)
        for a, b in zip(ref_heads, got_heads):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

        # denormalize inverts: bias/weights return to the originals
        wt.denormalize_net(net2, params)
        for i in before:
            np.testing.assert_allclose(
                params[i]["w"], before[i]["w"], atol=1e-6, rtol=1e-6
            )
            np.testing.assert_allclose(
                params[i]["bias"], before[i]["bias"], atol=1e-6, rtol=1e-6
            )

    def test_stats_output(self):
        net = zoo.yolov3_tiny(classes=5, width=64, height=64)
        params = init_params_numpy(0, net)
        out = wt.statistics_net(net, params)
        assert "layer   0" in out and "std" in out

    def test_filter_mosaic(self):
        """darknet `visualize` analog: first-conv collage, filters normalized
        to [0,1] (src/convolutional_layer.c:954-969)."""
        net = zoo.yolov3_tiny(classes=5, width=64, height=64)
        params = init_params_numpy(0, net)
        imgs = wt.get_filter_images(net, params, 0)
        assert imgs.shape[0] == net.specs[0].filters
        assert imgs.min() >= 0.0 and imgs.max() <= 1.0
        # each filter individually spans its full range after normalization
        assert imgs[0].max() == pytest.approx(1.0) and imgs[0].min() == pytest.approx(0.0)
        mosaic = wt.filter_mosaic(net, params)
        assert mosaic.dtype == np.uint8 and mosaic.ndim == 3 and mosaic.shape[2] == 3
        n, k = imgs.shape[0], imgs.shape[1]
        cols = int(np.ceil(np.sqrt(n)))
        assert mosaic.shape[1] == cols * (k + 1) + 1

    def test_mkimg_generates(self):
        """darknet `mkimg` analog (examples/darknet.c:188-213)."""
        net = zoo.yolov3_tiny(classes=5, width=64, height=64)
        params = init_params_numpy(0, net)
        ims = wt.mkimg(net, params, 32, 32, num=2, seed=3, per_image=10)
        assert len(ims) == 2
        for im in ims:
            assert im.shape == (32, 32, 3)
            assert im.min() >= 0.0 and im.max() <= 1.0
            assert im.std() > 0.0  # stamps actually landed
        # deterministic under a fixed seed
        again = wt.mkimg(net, params, 32, 32, num=2, seed=3, per_image=10)
        np.testing.assert_array_equal(ims[0], again[0])
