"""YOLO head decode, box correction, and NMS.

Float-domain detection extraction, the counterpart of the reference's
src/yolo_layer.c:316-343 (get_yolo_detections), src/yolo_layer.c:247-273
(correct_yolo_boxes) and src/box.c:21-88 (do_nms_obj / do_nms_sort).

The decode is fully jittable and batched (runs fused on-device at the end of
the inference program); box correction and NMS run host-side on the small
filtered set, like the reference, with a numpy implementation that replicates
darknet's exact suppression semantics for eval parity.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("num_classes", "net_w", "net_h"))
def decode_head(
    raw: jax.Array,
    anchors: jax.Array,
    num_classes: int,
    net_w: int,
    net_h: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Decode one YOLO head.

    Args:
      raw: (N, H, W, A*(5+C)) raw conv output (float).
      anchors: (A, 2) anchor (w, h) in input pixels for this head's mask.

    Returns (boxes (N, H*W*A, 4) center-format relative to the network input,
    objectness (N, H*W*A), class_probs (N, H*W*A, C)).

    Matches src/yolo_layer.c:83-91 (get_yolo_box) + 132-146 (logistic
    activations on x, y, obj, classes): bx=(i+sig(tx))/W, by=(j+sig(ty))/H,
    bw=exp(tw)*anchor_w/net_w, bh=exp(th)*anchor_h/net_h.
    """
    n, h, w, _ = raw.shape
    a = anchors.shape[0]
    raw = raw.reshape(n, h, w, a, 5 + num_classes)
    tx, ty, tw, th = raw[..., 0], raw[..., 1], raw[..., 2], raw[..., 3]
    obj = jax.nn.sigmoid(raw[..., 4])
    cls = jax.nn.sigmoid(raw[..., 5:])
    cols = jnp.arange(w, dtype=jnp.float32).reshape(1, 1, w, 1)
    rows = jnp.arange(h, dtype=jnp.float32).reshape(1, h, 1, 1)
    bx = (jax.nn.sigmoid(tx) + cols) / w
    by = (jax.nn.sigmoid(ty) + rows) / h
    bw = jnp.exp(tw) * anchors[:, 0].reshape(1, 1, 1, a) / net_w
    bh = jnp.exp(th) * anchors[:, 1].reshape(1, 1, 1, a) / net_h
    boxes = jnp.stack([bx, by, bw, bh], axis=-1)
    flat = lambda t: t.reshape(n, h * w * a, *t.shape[4:])  # noqa: E731
    return flat(boxes), flat(obj), flat(cls)


def decode_region_head(out: jax.Array, spec) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Decode a YOLOv2 [region] head (src/region_layer.c get_region_box /
    get_region_detections).

    ``out`` is the head's forward output — x/y/obj already logistic,
    classes already softmaxed (nn/graph.apply_simple_layer).  Region anchors
    are in FEATURE-GRID units: bw = exp(tw) * anchor_w / W.
    """
    n, h, w, _ = out.shape
    a = spec.num
    r = out.reshape(n, h, w, a, 5 + spec.classes)
    anchors = jnp.asarray(spec.anchors, jnp.float32)
    cols = jnp.arange(w, dtype=jnp.float32).reshape(1, 1, w, 1)
    rows = jnp.arange(h, dtype=jnp.float32).reshape(1, h, 1, 1)
    bx = (r[..., 0] + cols) / w
    by = (r[..., 1] + rows) / h
    bw = jnp.exp(r[..., 2]) * anchors[:, 0].reshape(1, 1, 1, a) / w
    bh = jnp.exp(r[..., 3]) * anchors[:, 1].reshape(1, 1, 1, a) / h
    boxes = jnp.stack([bx, by, bw, bh], axis=-1)
    obj = r[..., 4]
    cls = r[..., 5:]
    if spec.tree is not None:
        # WordTree: turn per-group conditionals into joint path probabilities
        # (get_region_detections calls hierarchy_predictions in place,
        # src/region_layer.c:414-416); greedy class selection happens
        # host-side via tree_top_probs.
        from yoloq.core.tree import hierarchy_predictions

        cls = hierarchy_predictions(cls, spec.tree)
    return (
        boxes.reshape(n, h * w * a, 4),
        obj.reshape(n, h * w * a),
        cls.reshape(n, h * w * a, spec.classes),
    )


def tree_top_probs(
    cls: np.ndarray,
    obj: np.ndarray,
    tree,
    thresh: float,
    tree_thresh: float = 0.5,
) -> np.ndarray:
    """Sparse per-detection class probs for a WordTree region head.

    Replicates the reference's map-less tree branch
    (src/region_layer.c:424-426): per detection, greedily descend the
    hierarchy over the JOINT probabilities produced by decode_region_head
    (the reference runs hierarchy_top_prediction on the in-place-updated
    joint values) and assign the detection's objectness to the chosen node.
    """
    from yoloq.core.tree import hierarchy_top_prediction

    out = np.zeros_like(np.asarray(cls))
    cls = np.asarray(cls)
    obj = np.asarray(obj)
    for d in range(cls.shape[0]):
        if obj[d] > thresh:
            j = hierarchy_top_prediction(cls[d], tree, tree_thresh)
            out[d, j] = obj[d]
    return out


def decode_detection_head(out: jax.Array, spec) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Decode a YOLOv1 [detection] head (src/detection_layer.c
    get_detection_boxes): flat layout [S*S*C class probs][S*S*B confs]
    [S*S*B*4 boxes]; optional sqrt on w/h."""
    n = out.shape[0]
    s2, b, c = spec.side * spec.side, spec.num, spec.classes
    probs = out[:, : s2 * c].reshape(n, s2, c)
    confs = out[:, s2 * c : s2 * (c + b)].reshape(n, s2, b)
    boxes = out[:, s2 * (c + b) :].reshape(n, s2, b, 4)
    cells = jnp.arange(s2)
    col = (cells % spec.side).astype(jnp.float32)
    row = (cells // spec.side).astype(jnp.float32)
    bx = (boxes[..., 0] + col[None, :, None]) / spec.side
    by = (boxes[..., 1] + row[None, :, None]) / spec.side
    bw = boxes[..., 2] ** 2 if spec.sqrt else boxes[..., 2]
    bh = boxes[..., 3] ** 2 if spec.sqrt else boxes[..., 3]
    out_boxes = jnp.stack([bx, by, bw, bh], axis=-1).reshape(n, s2 * b, 4)
    obj = confs.reshape(n, s2 * b)
    cls = jnp.repeat(probs, b, axis=1)  # each of the B boxes shares cell probs
    return out_boxes, obj, cls


def flip_average_head(a: jax.Array, b: jax.Array, classes: int) -> jax.Array:
    """Average a YOLO head's raw output over the horizontal-flip TTA pair
    (avg_flipped_yolo, src/yolo_layer.c:290-314, used by `detector valid2`).

    ``a`` is the head on the original image, ``b`` on the W-flipped image
    (both (N, H, W, A*(5+C)) raw).  ``b`` is un-flipped spatially and its tx
    channel negated — bx=(sig(tx)+col)/W mirrors to (col'+(1-sig(tx)))/W and
    sig(-t) = 1-sig(t), so negating the pre-sigmoid tx is exact.
    """
    n, h, w, c = a.shape
    blk = 5 + classes
    bf = b[:, :, ::-1, :].reshape(n, h, w, c // blk, blk)
    bf = bf.at[..., 0].multiply(-1.0)
    return (a + bf.reshape(n, h, w, c)) / 2.0


def decode_all_heads(heads, net, threshold_free=True):
    """Decode every detection head (yolo/region/detection) and concat."""
    from yoloq.nn.graph import (
        DetectionSpec,
        RegionSpec,
        YoloSpec,
    )

    head_specs = [
        s for s in net.specs if isinstance(s, (YoloSpec, RegionSpec, DetectionSpec))
    ]
    assert len(head_specs) == len(heads)
    parts = []
    for raw, spec in zip(heads, head_specs):
        if isinstance(spec, YoloSpec):
            anchors = jnp.asarray(
                [spec.anchors[m] for m in spec.mask], dtype=jnp.float32
            )
            parts.append(
                decode_head(raw, anchors, spec.classes, net.width, net.height)
            )
        elif isinstance(spec, RegionSpec):
            parts.append(decode_region_head(raw, spec))
        else:
            parts.append(decode_detection_head(raw, spec))
    boxes = jnp.concatenate([p[0] for p in parts], axis=1)
    obj = jnp.concatenate([p[1] for p in parts], axis=1)
    cls = jnp.concatenate([p[2] for p in parts], axis=1)
    return boxes, obj, cls


def correct_boxes(
    boxes: np.ndarray, img_w: int, img_h: int, net_w: int, net_h: int
) -> np.ndarray:
    """Invert the letterbox transform (src/yolo_layer.c:247-273), relative coords."""
    if net_w / img_w < net_h / img_h:
        new_w, new_h = net_w, (img_h * net_w) // img_w
    else:
        new_w, new_h = (img_w * net_h) // img_h, net_h
    out = boxes.astype(np.float64).copy()
    out[:, 0] = (out[:, 0] - (net_w - new_w) / 2.0 / net_w) / (new_w / net_w)
    out[:, 1] = (out[:, 1] - (net_h - new_h) / 2.0 / net_h) / (new_h / net_h)
    out[:, 2] *= net_w / new_w
    out[:, 3] *= net_h / new_h
    return out.astype(np.float32)


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between (..., 4) center-format boxes (src/box.c box_iou)."""
    ax1, ax2 = a[..., 0] - a[..., 2] / 2, a[..., 0] + a[..., 2] / 2
    ay1, ay2 = a[..., 1] - a[..., 3] / 2, a[..., 1] + a[..., 3] / 2
    bx1, bx2 = b[..., 0] - b[..., 2] / 2, b[..., 0] + b[..., 2] / 2
    by1, by2 = b[..., 1] - b[..., 3] / 2, b[..., 1] + b[..., 3] / 2
    iw = np.maximum(0.0, np.minimum(ax2, bx2) - np.maximum(ax1, bx1))
    ih = np.maximum(0.0, np.minimum(ay2, by2) - np.maximum(ay1, by1))
    inter = iw * ih
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def nms_obj(
    boxes: np.ndarray, obj: np.ndarray, cls: np.ndarray, nms_thresh: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """darknet do_nms_obj (src/box.c:21-55): class-agnostic greedy NMS.

    Sorts by objectness descending; any later box with IoU > thresh against a
    surviving box gets its objectness (and class probs) zeroed but REMAINS in
    the arrays — the reference's F1 harness counts those zeroed entries in its
    precision denominator (examples/detector.c:839-841), so we must not drop
    them.
    """
    order = np.argsort(-obj, kind="stable")
    boxes, obj, cls = boxes[order].copy(), obj[order].copy(), cls[order].copy()
    for i in range(len(obj)):
        if obj[i] == 0:
            continue
        suppress = box_iou(boxes[i + 1 :], boxes[i]) > nms_thresh
        obj[i + 1 :][suppress] = 0.0
        cls[i + 1 :][suppress] = 0.0
    return boxes, obj, cls


def nms_sort_per_class(
    boxes: np.ndarray, probs: np.ndarray, nms_thresh: float
) -> np.ndarray:
    """darknet do_nms_sort (src/box.c:58-88): per-class greedy suppression.

    probs: (M, C) = objectness * class_prob.  Returns probs with suppressed
    entries zeroed, per class independently.
    """
    probs = probs.copy()
    for c in range(probs.shape[1]):
        order = np.argsort(-probs[:, c], kind="stable")
        for oi, i in enumerate(order):
            if probs[i, c] == 0:
                continue
            rest = order[oi + 1 :]
            ious = box_iou(boxes[rest], boxes[i])
            probs[rest[ious > nms_thresh], c] = 0.0
    return probs


@partial(jax.jit, static_argnames=("max_det",))
def top_k_detections(boxes, obj, cls, max_det: int = 256):
    """Device-side top-k prefilter so only O(max_det) boxes reach the host.

    The reference walks all H*W*A predictions on the host per image
    (src/yolo_layer.c:275-343); here the host transfer is cut to the top-k
    by objectness, which is exact as long as max_det exceeds the number of
    above-threshold boxes (guaranteed for the eval thresholds used).
    """
    max_det = min(max_det, obj.shape[1])  # small feature maps at low input sizes
    val, idx = jax.lax.top_k(obj, max_det)
    return (
        jnp.take_along_axis(boxes, idx[..., None], axis=1),
        val,
        jnp.take_along_axis(cls, idx[..., None], axis=1),
    )
