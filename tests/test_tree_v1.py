"""Tests: softmax hierarchy trees (src/tree.c) and the YOLOv1 detection loss
(src/detection_layer.c) — golden-checked against direct numpy transcriptions
of the reference C."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yoloq.core.tree import (
    HierarchyTree,
    hierarchy_cross_entropy,
    hierarchy_predictions,
    hierarchy_top_prediction,
    get_hierarchy_probability,
    parse_tree,
    softmax_tree,
)

# A small wordtree: 3 roots (animal, vehicle, plant); animal -> {dog, cat};
# dog -> {poodle, husky}; vehicle -> {car}.
TREE_LINES = [
    "animal -1",
    "vehicle -1",
    "plant -1",
    "dog 0",
    "cat 0",
    "car 1",
    "poodle 3",
    "husky 3",
]


@pytest.fixture(scope="module")
def tree():
    return parse_tree(TREE_LINES)


def test_parse_groups(tree):
    # reference read_tree: new group whenever the parent id changes between
    # consecutive lines (src/tree.c:105-113)
    assert tree.n == 8
    assert tree.groups == 4
    np.testing.assert_array_equal(tree.group, [0, 0, 0, 1, 1, 2, 3, 3])
    np.testing.assert_array_equal(tree.group_offset, [0, 3, 5, 6])
    np.testing.assert_array_equal(tree.group_size, [3, 2, 1, 2])
    # child[i] = group index of i's children (src/tree.c:116-118)
    np.testing.assert_array_equal(tree.child, [1, 2, -1, 3, -1, -1, -1, -1])
    np.testing.assert_array_equal(
        tree.leaf, [False, False, True, False, True, True, True, True]
    )
    np.testing.assert_array_equal(tree.depth, [0, 0, 0, 1, 1, 1, 2, 2])


def test_change_leaves(tree):
    t2 = tree.change_leaves(["dog", "plant"])
    np.testing.assert_array_equal(
        t2.leaf, [False, False, True, True, False, False, False, False]
    )
    assert t2 != tree and hash(t2) != hash(tree)


def test_softmax_tree_matches_per_group_numpy(tree):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, tree.n)).astype(np.float32)
    got = np.asarray(softmax_tree(jnp.asarray(x), tree))
    # reference: independent softmax per group (src/softmax_layer.c:41-48)
    want = np.zeros_like(x)
    for g in range(tree.groups):
        o, s = tree.group_offset[g], tree.group_size[g]
        seg = x[..., o : o + s]
        e = np.exp(seg - seg.max(-1, keepdims=True))
        want[..., o : o + s] = e / e.sum(-1, keepdims=True)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # every group sums to 1
    for g in range(tree.groups):
        o, s = tree.group_offset[g], tree.group_size[g]
        np.testing.assert_allclose(got[..., o : o + s].sum(-1), 1.0, rtol=1e-5)


def _hier_pred_c(pred, tree, only_leaves):
    """Direct transcription of hierarchy_predictions (src/tree.c:37-51)."""
    pred = pred.copy()
    for j in range(tree.n):
        parent = tree.parent[j]
        if parent >= 0:
            pred[j] *= pred[parent]
    if only_leaves:
        for j in range(tree.n):
            if not tree.leaf[j]:
                pred[j] = 0
    return pred


def test_hierarchy_predictions_golden(tree):
    rng = np.random.default_rng(1)
    p = rng.uniform(0.05, 1.0, (tree.n,)).astype(np.float32)
    for only_leaves in (False, True):
        got = np.asarray(hierarchy_predictions(jnp.asarray(p), tree, only_leaves))
        np.testing.assert_allclose(got, _hier_pred_c(p, tree, only_leaves), rtol=1e-6)
    # batched last-axis
    pb = rng.uniform(0.05, 1.0, (3, 4, tree.n)).astype(np.float32)
    got = np.asarray(hierarchy_predictions(jnp.asarray(pb), tree))
    for i in range(3):
        for j in range(4):
            np.testing.assert_allclose(
                got[i, j], _hier_pred_c(pb[i, j], tree, False), rtol=1e-6
            )


def test_get_hierarchy_probability(tree):
    p = np.linspace(0.1, 0.8, tree.n).astype(np.float32)
    # poodle (6) -> dog (3) -> animal (0)
    assert get_hierarchy_probability(p, tree, 6) == pytest.approx(
        float(p[6] * p[3] * p[0])
    )


def _top_pred_c(pred, tree, thresh):
    """Direct transcription of hierarchy_top_prediction (src/tree.c:53-81)."""
    p = 1.0
    group = 0
    while True:
        mx, max_i = 0.0, 0
        for i in range(tree.group_size[group]):
            index = i + tree.group_offset[group]
            if pred[index] > mx:
                mx, max_i = pred[index], index
        if p * mx > thresh:
            p = p * mx
            if tree.child[max_i] < 0:
                return max_i
            group = tree.child[max_i]
        elif group == 0:
            return max_i
        else:
            return tree.parent[tree.group_offset[group]]


def test_hierarchy_top_prediction_golden(tree):
    rng = np.random.default_rng(2)
    for _ in range(50):
        p = rng.uniform(0, 1, (tree.n,)).astype(np.float32)
        for thresh in (0.1, 0.4, 0.9):
            assert hierarchy_top_prediction(p, tree, thresh) == _top_pred_c(
                p, tree, thresh
            )


def test_hierarchy_cross_entropy_trains(tree):
    # minimizing the loss should drive the label's whole path toward prob 1
    logits = jnp.zeros((2, tree.n))
    labels = jnp.asarray([6, 5])  # poodle, car
    grad_fn = jax.grad(lambda z: jnp.mean(hierarchy_cross_entropy(z, labels, tree)))
    z = logits
    for _ in range(200):
        z = z - 0.5 * grad_fn(z)
    p = np.asarray(softmax_tree(z, tree))
    joint = np.asarray(hierarchy_predictions(jnp.asarray(p), tree))
    assert joint[0, 6] > 0.9  # poodle joint prob
    assert joint[1, 5] > 0.9  # car joint prob


def test_region_head_with_tree_forward_and_decode(tree):
    from yoloq.eval.detect import decode_region_head, tree_top_probs
    from yoloq.nn.graph import RegionSpec, apply_simple_layer

    spec = RegionSpec(
        anchors=((1.0, 1.0), (2.0, 2.0)), classes=tree.n, num=2, softmax=False,
        tree=tree,
    )
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((1, 3, 3, 2 * (5 + tree.n))), jnp.float32)
    out = apply_simple_layer(spec, None, x)
    r = np.asarray(out).reshape(1, 3, 3, 2, 5 + tree.n)
    # class block is a grouped softmax: each group sums to 1
    for g in range(tree.groups):
        o, s = tree.group_offset[g], tree.group_size[g]
        np.testing.assert_allclose(
            r[..., 5 + o : 5 + o + s].sum(-1), 1.0, rtol=1e-5
        )
    boxes, obj, cls = decode_region_head(out, spec)
    # decode emits JOINT path probabilities (hierarchy_predictions applied)
    conds = r[..., 5:].reshape(-1, tree.n)
    joints = np.asarray(cls).reshape(-1, tree.n)
    for i in range(conds.shape[0]):
        np.testing.assert_allclose(
            joints[i], _hier_pred_c(conds[i], tree, False), rtol=1e-5
        )
    probs = tree_top_probs(joints, np.asarray(obj).ravel(), tree, thresh=0.0)
    # exactly one class per detection, carrying its objectness
    assert ((probs > 0).sum(-1) <= 1).all()
    nz = probs.sum(-1)
    np.testing.assert_allclose(nz, np.asarray(obj).ravel(), rtol=1e-6)


def test_region_loss_tree_gradient_structure(tree):
    """Class gradients may only touch the truth's path groups
    (delta_region_class hier branch, src/region_layer.c:117-129)."""
    from yoloq.train.loss import MAX_BOXES, region_head_loss

    rng = np.random.default_rng(4)
    a, c = 2, tree.n
    out = jnp.asarray(rng.uniform(0.1, 0.9, (1, 4, 4, a * (5 + c))), jnp.float32)
    truths = np.zeros((1, MAX_BOXES, 5), np.float32)
    truths[0, 0] = [0.4, 0.4, 0.2, 0.2, 6]  # a poodle
    loss_fn = lambda o: region_head_loss(  # noqa: E731
        o, jnp.asarray(truths), ((1.0, 1.0), (2.0, 2.0)), c, tree=tree
    )[0]
    g = np.asarray(jax.grad(loss_fn)(out)).reshape(1, 4, 4, a, 5 + c)
    cls_g = g[..., 5:]
    # nodes outside poodle's path groups: plant(2), cat(4), car(5) untouched
    touched = np.nonzero(np.abs(cls_g).sum((0, 1, 2, 3)))[0]
    # poodle path: poodle(6) -> dog(3) -> animal(0); groups touched:
    # {0,1,2} (roots), {3,4} (animal's children), {6,7} (dog's children)
    assert set(touched) <= {0, 1, 2, 3, 4, 6, 7}
    assert 5 not in touched  # car shares no group with the path
    assert len(touched) > 0


# ---------------------------------------------------------------------------
# YOLOv1 detection head
# ---------------------------------------------------------------------------


def _fill_truth_region_c(boxes, side, classes):
    """Direct transcription of fill_truth_region (src/data.c:255-301)."""
    truth = np.zeros((side * side, 1 + classes + 4), np.float32)
    for x, y, w, h, cid in boxes:
        if w < 0.005 or h < 0.005:
            continue
        col, row = int(x * side), int(y * side)
        cell = row * side + col
        if truth[cell, 0]:
            continue
        truth[cell, 0] = 1
        if int(cid) < classes:
            truth[cell, 1 + int(cid)] = 1
        truth[cell, 1 + classes :] = [x * side - col, y * side - row, w, h]
    return truth


def test_encode_detection_truth_golden():
    from yoloq.train.loss import MAX_BOXES, encode_detection_truth

    side, classes = 3, 4
    rng = np.random.default_rng(5)
    boxes = []
    for _ in range(10):
        boxes.append(
            [
                rng.uniform(0.05, 0.95),
                rng.uniform(0.05, 0.95),
                rng.uniform(0.01, 0.4),
                rng.uniform(0.01, 0.4),
                rng.integers(0, classes),
            ]
        )
    boxes.append([0.5, 0.5, 0.001, 0.3, 0])  # skipped: w < .005
    truths = np.zeros((1, MAX_BOXES, 5), np.float32)
    truths[0, : len(boxes)] = boxes
    got = np.asarray(encode_detection_truth(jnp.asarray(truths), side, classes))[0]
    want = _fill_truth_region_c(boxes, side, classes)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_detection_loss_converges():
    """A linear layer + v1 head fits a single example: loss -> near 0 and the
    decoded box matches the truth."""
    from yoloq.eval.detect import decode_detection_head
    from yoloq.nn.graph import DetectionSpec
    from yoloq.train.loss import (
        MAX_BOXES,
        detection_head_loss,
        encode_detection_truth,
    )

    side, classes, num = 3, 2, 2
    spec = DetectionSpec(classes=classes, num=num, side=side, sqrt=True)
    outputs = side * side * (classes + num * 5)
    truths = np.zeros((1, MAX_BOXES, 5), np.float32)
    truths[0, 0] = [0.5, 0.5, 0.4, 0.3, 1]
    grid = encode_detection_truth(jnp.asarray(truths), side, classes)

    z = jnp.zeros((1, outputs)) + 0.1

    def loss_fn(z):
        return detection_head_loss(
            z, grid, classes, num, side, sqrt=True, coord_scale=5.0,
            noobject_scale=0.5,
        )[0]

    grad_fn = jax.jit(jax.grad(loss_fn))
    for _ in range(400):
        z = z - 0.3 * grad_fn(z)
    final = float(loss_fn(z))
    assert final < 1e-3, final

    boxes, obj, cls = decode_detection_head(z, spec)
    best = int(np.argmax(np.asarray(obj)[0]))
    bx, by, bw, bh = np.asarray(boxes)[0, best]
    assert abs(bx - 0.5) < 0.02 and abs(by - 0.5) < 0.02
    assert abs(bw - 0.4) < 0.02 and abs(bh - 0.3) < 0.02
    cell = best // num
    assert int(np.argmax(np.asarray(cls)[0, best])) == 1


def test_detection_loss_noobj_gradient_structure():
    """Cells without objects only receive confidence gradients."""
    from yoloq.train.loss import (
        MAX_BOXES,
        detection_head_loss,
        encode_detection_truth,
    )

    side, classes, num = 2, 3, 2
    s2 = side * side
    truths = np.zeros((1, MAX_BOXES, 5), np.float32)  # no objects at all
    grid = encode_detection_truth(jnp.asarray(truths), side, classes)
    rng = np.random.default_rng(6)
    z = jnp.asarray(rng.uniform(0.1, 0.9, (1, s2 * (classes + num * 5))), jnp.float32)
    g = np.asarray(
        jax.grad(lambda o: detection_head_loss(o, grid, classes, num, side)[0])(z)
    )[0]
    assert np.abs(g[: s2 * classes]).max() == 0  # class block untouched
    assert np.abs(g[s2 * classes : s2 * (classes + num)]).max() > 0  # confs pushed
    assert np.abs(g[s2 * (classes + num) :]).max() == 0  # boxes untouched


def test_hierarchical_classifier_trains(tree, tmp_path):
    """A tiny conv->avgpool->softmax(tree) classifier learns to separate two
    leaf classes with the hierarchical loss and greedy-descent prediction."""
    from PIL import Image

    from yoloq.nn.graph import (
        AvgPoolSpec,
        ConvSpec,
        NetworkDef,
        SoftmaxSpec,
    )
    from yoloq.train.classify import (
        ClassificationDataset,
        ClassifierTrainer,
        evaluate_top_k,
    )

    net = NetworkDef(
        (
            ConvSpec(filters=16, size=3, stride=2, pad=1, activation="leaky",
                     batch_normalize=False, quantized=False),
            ConvSpec(filters=tree.n, size=1, stride=1, pad=0,
                     activation="linear", batch_normalize=False, quantized=False),
            AvgPoolSpec(),
            SoftmaxSpec(tree=tree),
        ),
        width=16, height=16,
    )
    rng = np.random.default_rng(7)
    # poodle = bright images, car = dark images; names must appear in paths
    paths = []
    for i in range(8):
        name = "poodle" if i % 2 == 0 else "car"
        lvl = (0.8, 0.2)[i % 2]
        im = (rng.uniform(lvl - 0.15, lvl + 0.15, (16, 16, 3)) * 255).astype("uint8")
        p = tmp_path / f"{name}_{i}.png"
        Image.fromarray(im).save(p)
        paths.append(str(p))
    (tmp_path / "list.txt").write_text("\n".join(paths) + "\n")
    names = list(tree.names)
    ds = ClassificationDataset(str(tmp_path / "list.txt"), names, 16, 16)

    trainer = ClassifierTrainer(net, lr=0.05)
    assert trainer.tree is tree
    ims, labels = zip(*(ds.sample(i) for i in range(8)))
    ims = np.stack(ims).astype(np.float32)
    labels = np.asarray(labels)
    first = None
    for it in range(150):
        m = trainer.step(ims, labels)
        if first is None:
            first = float(m["loss"])
    assert float(m["loss"]) < first * 0.2
    res = evaluate_top_k(net, trainer.params, ds, k=3)
    assert res["top1"] >= 0.9


def test_yolov1_tiny_end_to_end():
    """zoo.yolov1_tiny forward -> detection loss -> grads -> decode, at a
    reduced input size (448 is slow on CPU)."""
    from yoloq.eval.detect import decode_all_heads
    from yoloq.models import zoo
    from yoloq.nn.graph import (
        DetectionSpec,
        forward,
        init_params,
    )
    from yoloq.train.loss import MAX_BOXES, total_loss

    net = zoo.yolov1_tiny(classes=3, width=64, height=64, side=4)
    assert isinstance(net.specs[-1], DetectionSpec)
    h, w, cdim = net.shapes()[-1]
    assert (h, w, cdim) == (1, 1, 4 * 4 * (2 * 5 + 3))

    params = init_params(jax.random.PRNGKey(0), net)
    x = jnp.zeros((2, 64, 64, 3))
    heads, _ = forward(net, params, x)
    assert len(heads) == 1 and heads[0].shape == (2, 4 * 4 * 13)

    truths = np.zeros((2, MAX_BOXES, 5), np.float32)
    truths[:, 0] = [0.5, 0.5, 0.3, 0.3, 1]

    def loss_fn(p):
        hs, _ = forward(net, p, x)
        l, _ = total_loss(hs, jnp.asarray(truths), net)
        return l

    loss, grads = jax.value_and_grad(loss_fn)(params)
    assert np.isfinite(float(loss))
    gmax = max(float(jnp.max(jnp.abs(g))) for d in grads.values() for g in d.values())
    assert gmax > 0

    boxes, obj, cls = decode_all_heads(heads, net)
    assert boxes.shape == (2, 4 * 4 * 2, 4) and cls.shape[-1] == 3


def test_cfg_tree_option(tmp_path):
    """[softmax] tree= and [region] tree= load relative to the cfg file."""
    from yoloq.models.cfg import load_cfg
    from yoloq.nn.graph import RegionSpec, SoftmaxSpec

    (tmp_path / "tiny.tree").write_text("\n".join(TREE_LINES) + "\n")
    cfg = """
[net]
width=32
height=32
channels=3

[convolutional]
filters=26
size=1
stride=1
pad=0
activation=linear
batch_normalize=0
quantized=0

[region]
anchors=1,1, 2,2
num=2
classes=8
softmax=0
tree=tiny.tree
"""
    p = tmp_path / "m.cfg"
    p.write_text(cfg)
    net, _ = load_cfg(str(p))
    region = net.specs[-1]
    assert isinstance(region, RegionSpec)
    assert isinstance(region.tree, HierarchyTree)
    assert region.tree.n == 8 and region.tree.groups == 4
