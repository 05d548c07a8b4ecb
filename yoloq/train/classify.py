"""Image classification training/eval (darknet classifier lineage).

The reference framework descends from darknet's classifier (darknet19 etc.);
its data path matches class labels by substring of the image path
(src/data.c fill_truth: a path containing "<name>" gets that class).  This
module provides the same: a path-labeled dataset, softmax cross-entropy
training on any NetworkDef ending in [softmax] (or logits conv), and top-1/5
eval — usable with models/zoo.darknet19 or any imported classifier cfg.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from yoloq.data.image import letterbox, load_image_rgb
from yoloq.data.voc import read_image_list
from yoloq.nn.graph import (
    ForwardMode,
    NetworkDef,
    SoftmaxSpec,
    forward,
    init_params,
)


def label_from_path(path: str, names: list[str]) -> int:
    """darknet's substring label matching (src/data.c fill_truth)."""
    for i, n in enumerate(names):
        if n in path:
            return i
    raise ValueError(f"no class name of {names[:3]}... found in {path}")


class ClassificationDataset:
    def __init__(self, list_file: str, names: list[str], net_w: int, net_h: int):
        self.paths = read_image_list(list_file)
        self.names = names
        self.net_w, self.net_h = net_w, net_h

    def __len__(self):
        return len(self.paths)

    def sample(self, idx: int) -> tuple[np.ndarray, int]:
        p = self.paths[idx % len(self.paths)]
        im = letterbox(load_image_rgb(p), self.net_w, self.net_h)
        return im, label_from_path(p, self.names)


def _logits_forward(net: NetworkDef, params, x, train: bool):
    """Forward, returning pre-softmax logits: runs the graph but stops before
    a trailing SoftmaxSpec so the loss can use stable CE-with-logits."""
    specs = net.specs
    if isinstance(specs[-1], SoftmaxSpec):
        net = NetworkDef(specs[:-1], net.width, net.height, net.channels)
    mode = ForwardMode(train=train)
    outputs, bn_stats = _forward_all(net, params, x, mode)
    return outputs[-1].reshape(x.shape[0], -1), bn_stats


def _forward_all(net, params, x, mode):
    """forward() variant that returns every layer output (for nets without
    detection heads)."""
    from yoloq.nn import layers as L
    from yoloq.nn.graph import (
        SIMPLE_SPECS,
        ConvSpec,
        MaxPoolSpec,
        RouteSpec,
        ShortcutSpec,
        UpsampleSpec,
        apply_simple_layer,
        _conv_forward,
    )

    outputs = []
    bn_stats = {}
    for i, s in enumerate(net.specs):
        if isinstance(s, ConvSpec):
            y, stats, _ = _conv_forward(s, params[i], x, mode, None)
            if stats is not None:
                bn_stats[i] = stats
        elif isinstance(s, MaxPoolSpec):
            y = L.maxpool(x, s.size, s.stride, s.padding)
        elif isinstance(s, UpsampleSpec):
            y = L.upsample_nearest(x, s.stride)
        elif isinstance(s, RouteSpec):
            y = L.route_concat([outputs[j] for j in s.layers])
        elif isinstance(s, ShortcutSpec):
            y = L.activate(L.shortcut_add(x, outputs[s.index]), s.activation)
        elif isinstance(s, SIMPLE_SPECS):
            y = apply_simple_layer(s, params.get(i), x, train=mode.train)
        else:
            raise TypeError(f"unsupported spec in classifier: {s}")
        outputs.append(y)
        x = y
    return outputs, bn_stats


def _net_tree(net: NetworkDef):
    """The hierarchy tree of a trailing [softmax] layer, if any (the darknet
    classifier's net->hierarchy, src/parser.c:739)."""
    if net.specs and isinstance(net.specs[-1], SoftmaxSpec):
        return net.specs[-1].tree
    return None


class ClassifierTrainer:
    """SGD + momentum softmax-CE training (darknet classifier defaults).

    Nets whose trailing [softmax] carries a WordTree train with the
    hierarchical loss (grouped softmax, CE summed over the label's ancestor
    path) instead of flat CE — the darknet hierarchy classifier path.
    """

    def __init__(self, net: NetworkDef, lr: float = 0.01, momentum: float = 0.9,
                 weight_decay: float = 5e-4, key=None):
        self.net = net
        self.tree = _net_tree(net)
        self.params = init_params(key or jax.random.PRNGKey(0), net)
        self.tx = optax.chain(
            optax.add_decayed_weights(
                weight_decay, mask=lambda p: {i: {k: k == "w" for k in d} for i, d in p.items()}
            ),
            optax.sgd(lr, momentum=momentum),
        )
        self.opt_state = self.tx.init(self.params)

        @jax.jit
        def step(params, opt_state, images, labels):
            def loss_fn(p):
                logits, bn_stats = _logits_forward(self.net, p, images, train=True)
                if self.tree is not None:
                    from yoloq.core.tree import hierarchy_cross_entropy

                    ce = hierarchy_cross_entropy(logits, labels, self.tree)
                else:
                    ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
                return jnp.mean(ce), (logits, bn_stats)

            (loss, (logits, bn_stats)), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(params)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            # darknet .99/.01 rolling stats (src/batchnorm_layer.c:143-146)
            for i, (mean, var) in bn_stats.items():
                params[i]["mean"] = 0.99 * params[i]["mean"] + 0.01 * mean
                params[i]["var"] = 0.99 * params[i]["var"] + 0.01 * var
            acc = jnp.mean((jnp.argmax(logits, -1) == labels).astype(jnp.float32))
            return params, opt_state, {"loss": loss, "acc": acc}

        self._step = step

    def step(self, images: np.ndarray, labels: np.ndarray):
        self.params, self.opt_state, metrics = self._step(
            self.params, self.opt_state, jnp.asarray(images), jnp.asarray(labels)
        )
        return metrics


def evaluate_top_k(net: NetworkDef, params, dataset: ClassificationDataset,
                   k: int = 5, max_images: int | None = None,
                   tree_thresh: float = 0.5) -> dict:
    """Top-1 / top-k accuracy (darknet validate_classifier).

    With a WordTree trailing softmax, top-1 uses the greedy hierarchy descent
    (hierarchy_top_prediction) and top-k ranks by joint path probability —
    the darknet predict_classifier hierarchy behavior.
    """
    tree = _net_tree(net)
    correct1 = correctk = total = 0
    n = min(len(dataset), max_images or len(dataset))

    @jax.jit
    def infer(params, x):
        logits, _ = _logits_forward(net, params, x, train=False)
        if tree is not None:
            from yoloq.core.tree import softmax_tree

            return softmax_tree(logits, tree)
        return logits

    for i in range(n):
        im, label = dataset.sample(i)
        scores = np.asarray(infer(params, jnp.asarray(im[None])))[0]
        if tree is not None:
            from yoloq.core.tree import (
                hierarchy_predictions,
                hierarchy_top_prediction,
            )

            top1 = hierarchy_top_prediction(scores, tree, tree_thresh)
            joint = np.asarray(hierarchy_predictions(jnp.asarray(scores), tree))
            order = np.argsort(-joint)
            correct1 += int(top1 == label)
        else:
            order = np.argsort(-scores)
            correct1 += int(order[0] == label)
        correctk += int(label in order[:k])
        total += 1
    return {"top1": correct1 / max(total, 1), f"top{k}": correctk / max(total, 1)}
