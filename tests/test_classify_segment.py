"""Classifier and segmenter task tests (small synthetic data)."""

import numpy as np
import pytest
from PIL import Image

from yoloq.nn.graph import (
    AvgPoolSpec,
    ConnectedSpec,
    ConvSpec,
    MaxPoolSpec,
    NetworkDef,
    SoftmaxSpec,
)
from yoloq.train.classify import (
    ClassificationDataset,
    ClassifierTrainer,
    evaluate_top_k,
    label_from_path,
)
from yoloq.train.segment import SegmentationDataset, SegmenterTrainer


def tiny_classifier(classes=3, size=32):
    return NetworkDef(
        specs=(
            ConvSpec(filters=8, quantized=False),
            MaxPoolSpec(2, 2),
            ConvSpec(filters=16, quantized=False),
            AvgPoolSpec(),
            ConnectedSpec(outputs=classes, activation="linear"),
            SoftmaxSpec(),
        ),
        width=size, height=size,
    )


@pytest.fixture(scope="module")
def class_dataset(tmp_path_factory):
    """3 classes distinguishable by dominant color; dirs named by class."""
    root = tmp_path_factory.mktemp("cls")
    rng = np.random.default_rng(0)
    names = ["red", "green", "blue"]
    paths = []
    for ci, name in enumerate(names):
        d = root / name
        d.mkdir()
        for i in range(6):
            im = rng.uniform(0, 0.3, (32, 32, 3))
            im[..., ci] += 0.7
            p = d / f"{i}.jpg"
            Image.fromarray((im * 255).astype(np.uint8)).save(p)
            paths.append(str(p))
    lf = root / "list.txt"
    lf.write_text("\n".join(paths))
    return str(lf), names


class TestClassifier:
    def test_label_from_path(self):
        assert label_from_path("/data/green/1.jpg", ["red", "green"]) == 1

    def test_training_learns_colors(self, class_dataset):
        lf, names = class_dataset
        net = tiny_classifier()
        ds = ClassificationDataset(lf, names, 32, 32)
        trainer = ClassifierTrainer(net, lr=0.05)
        rng = np.random.default_rng(0)
        losses = []
        for step in range(30):
            idx = rng.integers(0, len(ds), 6)
            samples = [ds.sample(int(i)) for i in idx]
            images = np.stack([s[0] for s in samples])
            labels = np.asarray([s[1] for s in samples])
            m = trainer.step(images, labels)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0]
        res = evaluate_top_k(net, trainer.params, ds, k=2, max_images=9)
        assert res["top1"] > 0.6  # trivially separable task


@pytest.fixture(scope="module")
def seg_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    (root / "images").mkdir()
    (root / "mask").mkdir()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        im = rng.uniform(0, 0.3, (32, 32, 3))
        mask = np.zeros((32, 32), np.uint8)
        im[:, 16:, 0] += 0.6   # right half is class 1 (red-ish)
        mask[:, 16:] = 1
        p = root / "images" / f"s{i}.jpg"
        Image.fromarray((im * 255).astype(np.uint8)).save(p)
        Image.fromarray(mask).save(root / "mask" / f"s{i}.png")
        paths.append(str(p))
    lf = root / "list.txt"
    lf.write_text("\n".join(paths))
    return str(lf)


class TestSegmenter:
    def test_training_and_predict(self, seg_dataset):
        net = NetworkDef(
            specs=(
                ConvSpec(filters=8, quantized=False),
                ConvSpec(filters=2, size=1, pad=0, activation="linear",
                         batch_normalize=False, quantized=False),
            ),
            width=32, height=32,
        )
        ds = SegmentationDataset(seg_dataset, 32, 32, classes=2)
        trainer = SegmenterTrainer(net, classes=2, lr=0.1)
        losses = []
        # enough steps for the .99-EMA rolling BN stats to approach batch stats
        for step in range(300):
            im, mask = ds.sample(step)
            m = trainer.step(im[None], mask[None])
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] * 0.8
        im, mask = ds.sample(0)
        pred = trainer.predict(im)
        assert pred.shape == (32, 32)
        acc = (pred == mask).mean()
        assert acc > 0.8, acc
