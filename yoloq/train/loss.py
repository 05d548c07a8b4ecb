"""YOLOv3 detection loss, fully jittable (static shapes, scatter-based assignment).

Re-derives the reference's delta-based loss (src/yolo_layer.c:132-240) as a
scalar objective whose gradients match darknet's deltas exactly:

- darknet applies logistic to x/y/obj/class in forward and back-propagates
  (target - activated) WITHOUT the logistic derivative
  (src/yolo_layer.c:103-106,178,183; backward_yolo_layer just copies deltas).
  (target - sigmoid(z)) is precisely d/dz of sigmoid cross-entropy, so here
  those terms are BCE-with-logits.
- w/h deltas are (target - raw): plain squared error on the raw outputs.
- box deltas are scaled by (2 - w*h) (src/yolo_layer.c:190,219) -> loss weight.
- objectness: background target 0 everywhere, but ignored (zero loss) where
  the predicted box overlaps any truth with IoU > ignore_thresh
  (src/yolo_layer.c:176-181); foreground target 1 at assigned cells.
- assignment: each truth is assigned to the anchor with best wh-IoU across
  ALL anchors of the network; the head whose mask contains that anchor owns
  the truth (src/yolo_layer.c:195-219).

Truths are fixed-size (B, MAX_BOXES, 5) arrays [x, y, w, h, class] in
relative coords, zero-padded — matching the reference's net.truth layout
(90 boxes, src/yolo_layer.c:167-168).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

MAX_BOXES = 90  # reference max_boxes (src/yolo_layer.c truth loop bound)


def _bce_logits(logit, target):
    """Sigmoid cross-entropy, numerically stable."""
    return jnp.maximum(logit, 0.0) - logit * target + jnp.log1p(jnp.exp(-jnp.abs(logit)))


def _wh_iou(w1, h1, w2, h2):
    """IoU of origin-centered boxes — anchor matching (src/yolo_layer.c:203-213)."""
    inter = jnp.minimum(w1, w2) * jnp.minimum(h1, h2)
    union = w1 * h1 + w2 * h2 - inter
    return inter / jnp.maximum(union, 1e-12)


def _box_iou_xywh(a, b):
    """IoU of center-format boxes, broadcasting on leading dims."""
    ax1, ax2 = a[..., 0] - a[..., 2] / 2, a[..., 0] + a[..., 2] / 2
    ay1, ay2 = a[..., 1] - a[..., 3] / 2, a[..., 1] + a[..., 3] / 2
    bx1, bx2 = b[..., 0] - b[..., 2] / 2, b[..., 0] + b[..., 2] / 2
    by1, by2 = b[..., 1] - b[..., 3] / 2, b[..., 1] + b[..., 3] / 2
    iw = jnp.maximum(0.0, jnp.minimum(ax2, bx2) - jnp.maximum(ax1, bx1))
    ih = jnp.maximum(0.0, jnp.minimum(ay2, by2) - jnp.maximum(ay1, by1))
    inter = iw * ih
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return jnp.where(union > 0, inter / jnp.maximum(union, 1e-12), 0.0)


@partial(jax.jit, static_argnames=("mask", "anchors", "classes", "net_w", "net_h",
                                   "ignore_thresh"))
def yolo_head_loss(
    raw: jax.Array,          # (B, H, W, A*(5+C)) raw conv output
    truths: jax.Array,       # (B, MAX_BOXES, 5)  [x,y,w,h,cls], zero-padded
    mask: tuple[int, ...],
    anchors: tuple[tuple[float, float], ...],
    classes: int,
    net_w: int,
    net_h: int,
    ignore_thresh: float = 0.7,
):
    b, h, w, _ = raw.shape
    a = len(mask)
    raw = raw.reshape(b, h, w, a, 5 + classes)
    anchors_arr = jnp.asarray(anchors, jnp.float32)           # (total, 2)
    head_anchors = anchors_arr[jnp.asarray(mask)]             # (a, 2)

    # ---- predicted boxes (for the ignore mask), src/yolo_layer.c:163-181 ----
    cols = jnp.arange(w, dtype=jnp.float32).reshape(1, 1, w, 1)
    rows = jnp.arange(h, dtype=jnp.float32).reshape(1, h, 1, 1)
    px = (jax.nn.sigmoid(raw[..., 0]) + cols) / w
    py = (jax.nn.sigmoid(raw[..., 1]) + rows) / h
    pw = jnp.exp(raw[..., 2]) * head_anchors[:, 0].reshape(1, 1, 1, a) / net_w
    ph = jnp.exp(raw[..., 3]) * head_anchors[:, 1].reshape(1, 1, 1, a) / net_h
    pred_boxes = jnp.stack([px, py, pw, ph], axis=-1)         # (B,H,W,A,4)

    valid = truths[..., 2] > 0                                # (B, M) w>0 marks real boxes
    ious = _box_iou_xywh(
        pred_boxes[:, :, :, :, None, :], truths[:, None, None, None, :, :4]
    )                                                         # (B,H,W,A,M)
    best_iou = jnp.max(jnp.where(valid[:, None, None, None, :], ious, 0.0), axis=-1)
    ignore = best_iou > ignore_thresh

    # ---- truth -> anchor assignment, src/yolo_layer.c:195-219 ----
    t_xy = truths[..., 0:2]
    t_wh = truths[..., 2:4]
    t_cls = truths[..., 4].astype(jnp.int32)
    wh_ious = _wh_iou(
        t_wh[..., 0:1] * net_w, t_wh[..., 1:2] * net_h,
        anchors_arr[None, None, :, 0], anchors_arr[None, None, :, 1],
    )                                                         # (B,M,total)
    best_n = jnp.argmax(wh_ious, axis=-1)                     # (B,M)
    mask_arr = jnp.asarray(mask)
    in_head = jnp.any(best_n[..., None] == mask_arr[None, None, :], axis=-1)
    anchor_slot = jnp.argmax(
        best_n[..., None] == mask_arr[None, None, :], axis=-1
    )                                                         # index within mask
    gi = jnp.clip((t_xy[..., 0] * w).astype(jnp.int32), 0, w - 1)
    gj = jnp.clip((t_xy[..., 1] * h).astype(jnp.int32), 0, h - 1)
    assign = valid & in_head                                  # (B,M)

    # targets in network units (src/yolo_layer.c:98-101)
    tx = t_xy[..., 0] * w - gi
    ty = t_xy[..., 1] * h - gj
    anchor_wh = anchors_arr[best_n]                           # (B,M,2)
    tw = jnp.log(jnp.maximum(t_wh[..., 0] * net_w / anchor_wh[..., 0], 1e-9))
    th = jnp.log(jnp.maximum(t_wh[..., 1] * net_h / anchor_wh[..., 1], 1e-9))
    box_scale = 2.0 - t_wh[..., 0] * t_wh[..., 1]             # src/yolo_layer.c:190

    # scatter targets onto the grid; drop unassigned via out-of-range index
    bi = jnp.broadcast_to(jnp.arange(b)[:, None], gi.shape)
    drop = jnp.where(assign, gj, h)  # row index h is out of range -> dropped
    obj_target = jnp.zeros((b, h, w, a)).at[bi, drop, gi, anchor_slot].set(
        1.0, mode="drop"
    )
    scale_grid = jnp.zeros((b, h, w, a)).at[bi, drop, gi, anchor_slot].set(
        box_scale, mode="drop"
    )
    txywh = jnp.stack([tx, ty, tw, th], axis=-1)
    box_target = jnp.zeros((b, h, w, a, 4)).at[bi, drop, gi, anchor_slot].set(
        txywh, mode="drop"
    )
    cls_target = jnp.zeros((b, h, w, a, classes)).at[
        bi, drop, gi, anchor_slot, jnp.where(assign, t_cls, 0)
    ].set(1.0, mode="drop")
    assigned = obj_target > 0                                  # (B,H,W,A)

    # ---- loss terms (gradient-equivalent to darknet deltas) ----
    xy_loss = scale_grid[..., None] * _bce_logits(raw[..., 0:2], box_target[..., 0:2])
    wh_loss = 0.5 * scale_grid[..., None] * (raw[..., 2:4] - box_target[..., 2:4]) ** 2
    obj_bce = _bce_logits(raw[..., 4], obj_target)
    obj_loss = jnp.where(assigned, obj_bce, jnp.where(ignore, 0.0, obj_bce))
    cls_loss = jnp.where(
        assigned[..., None], _bce_logits(raw[..., 5:], cls_target), 0.0
    )
    total = (
        jnp.sum(jnp.where(assigned[..., None], xy_loss, 0.0))
        + jnp.sum(jnp.where(assigned[..., None], wh_loss, 0.0))
        + jnp.sum(obj_loss)
        + jnp.sum(cls_loss)
    )
    stats = {
        "obj_count": jnp.sum(assigned),
        "avg_obj": jnp.sum(jax.nn.sigmoid(raw[..., 4]) * assigned)
        / jnp.maximum(jnp.sum(assigned), 1),
        "best_iou_mean": jnp.mean(best_iou),
    }
    return total, stats


@partial(jax.jit, static_argnames=("anchors", "classes", "ignore_thresh",
                                   "object_scale", "noobject_scale",
                                   "class_scale", "coord_scale", "rescore",
                                   "tree"))
def region_head_loss(
    out: jax.Array,          # (B, H, W, A*(5+C)) region FORWARD output
    truths: jax.Array,       # (B, MAX_BOXES, 5)
    anchors: tuple[tuple[float, float], ...],  # grid units (v2 convention)
    classes: int,
    ignore_thresh: float = 0.6,
    object_scale: float = 5.0,
    noobject_scale: float = 1.0,
    class_scale: float = 1.0,
    coord_scale: float = 1.0,
    rescore: bool = True,
    tree=None,               # core.tree.HierarchyTree | None (WordTree classes)
    seen=None,               # traced images-seen counter; enables the 12800 warmup
):
    """YOLOv2 [region] loss (src/region_layer.c delta_region_box/forward).

    Takes the head's FORWARD output (x/y/obj logistic-activated, classes
    softmaxed — nn/graph.apply_simple_layer), since darknet computes region
    deltas on activated values.  Squared-error terms reproduce darknet's
    delta*scale semantics: obj target is the predicted-box IoU when rescore
    (the darknet default for v2), 1 otherwise; class deltas are (t - p) on the
    softmax output.  With ``seen`` (a traced images-seen counter) the
    12800-seen anchor-prior warmup is active (region_layer.c:256-263):
    until 12800 images, EVERY cell/anchor is pulled toward the anchor prior
    centered in its cell at weight .01 — in this parametrization target
    x=y=0.5 (activated) and raw tw=th=0 (log(anchor/anchor)).
    """
    b, h, w, _ = out.shape
    a = len(anchors)
    r = out.reshape(b, h, w, a, 5 + classes)
    anchors_arr = jnp.asarray(anchors, jnp.float32)  # grid units

    cols = jnp.arange(w, dtype=jnp.float32).reshape(1, 1, w, 1)
    rows = jnp.arange(h, dtype=jnp.float32).reshape(1, h, 1, 1)
    px = (r[..., 0] + cols) / w
    py = (r[..., 1] + rows) / h
    pw = jnp.exp(r[..., 2]) * anchors_arr[:, 0].reshape(1, 1, 1, a) / w
    ph = jnp.exp(r[..., 3]) * anchors_arr[:, 1].reshape(1, 1, 1, a) / h
    pred_boxes = jnp.stack([px, py, pw, ph], axis=-1)
    obj = r[..., 4]
    cls = r[..., 5:]

    valid = truths[..., 2] > 0
    ious = _box_iou_xywh(
        pred_boxes[:, :, :, :, None, :], truths[:, None, None, None, :, :4]
    )
    best_iou = jnp.max(jnp.where(valid[:, None, None, None, :], ious, 0.0), axis=-1)
    ignore = best_iou > ignore_thresh

    # truth assignment: cell of the center + best wh-IoU anchor (grid units)
    t_xy, t_wh = truths[..., 0:2], truths[..., 2:4]
    t_cls = truths[..., 4].astype(jnp.int32)
    wh_ious = _wh_iou(
        t_wh[..., 0:1] * w, t_wh[..., 1:2] * h,
        anchors_arr[None, None, :, 0], anchors_arr[None, None, :, 1],
    )
    best_n = jnp.argmax(wh_ious, axis=-1)
    gi = jnp.clip((t_xy[..., 0] * w).astype(jnp.int32), 0, w - 1)
    gj = jnp.clip((t_xy[..., 1] * h).astype(jnp.int32), 0, h - 1)
    assign = valid

    tx = t_xy[..., 0] * w - gi
    ty = t_xy[..., 1] * h - gj
    anchor_wh = anchors_arr[best_n]
    tw = jnp.log(jnp.maximum(t_wh[..., 0] * w / anchor_wh[..., 0], 1e-9))
    th = jnp.log(jnp.maximum(t_wh[..., 1] * h / anchor_wh[..., 1], 1e-9))
    box_scale = coord_scale * (2.0 - t_wh[..., 0] * t_wh[..., 1])

    bi = jnp.broadcast_to(jnp.arange(b)[:, None], gi.shape)
    drop = jnp.where(assign, gj, h)
    obj_target = jnp.zeros((b, h, w, a)).at[bi, drop, gi, best_n].set(1.0, mode="drop")
    scale_grid = jnp.zeros((b, h, w, a)).at[bi, drop, gi, best_n].set(box_scale, mode="drop")
    txywh = jnp.stack([tx, ty, tw, th], axis=-1)
    box_target = jnp.zeros((b, h, w, a, 4)).at[bi, drop, gi, best_n].set(txywh, mode="drop")
    if tree is not None:
        # hierarchical class targets (delta_region_class's hier branch,
        # src/region_layer.c:117-129): the truth label and each ancestor get
        # target 1, their sibling groups get target 0, every other node's
        # delta is untouched -> masked out of the loss
        path_m = jnp.asarray(tree.path_matrix, jnp.float32)      # (C, C)
        sib_m = jnp.asarray(tree.sibling_matrix, jnp.float32)    # (C, C)
        t_rows = path_m[jnp.where(assign, t_cls, 0)]             # (B, M, C)
        m_rows = sib_m[jnp.where(assign, t_cls, 0)]
        cls_target = jnp.zeros((b, h, w, a, classes)).at[
            bi, drop, gi, best_n
        ].set(t_rows, mode="drop")
        cls_mask = jnp.zeros((b, h, w, a, classes)).at[
            bi, drop, gi, best_n
        ].set(m_rows, mode="drop")
    else:
        cls_target = jnp.zeros((b, h, w, a, classes)).at[
            bi, drop, gi, best_n, jnp.where(assign, t_cls, 0)
        ].set(1.0, mode="drop")
        cls_mask = None
    assigned = obj_target > 0

    xy = jnp.stack([r[..., 0], r[..., 1]], axis=-1)
    wh = jnp.stack([r[..., 2], r[..., 3]], axis=-1)
    coord_loss = 0.5 * scale_grid[..., None] * (
        (xy - box_target[..., 0:2]) ** 2 + (wh - box_target[..., 2:4]) ** 2
    )
    iou_at_cell = jnp.where(assigned, best_iou, 0.0)
    obj_tgt = jnp.where(assigned, iou_at_cell if rescore else 1.0, 0.0)
    obj_w = jnp.where(assigned, object_scale,
                      jnp.where(ignore, 0.0, noobject_scale))
    obj_loss = 0.5 * obj_w * (obj - obj_tgt) ** 2
    cls_sq = 0.5 * class_scale * (cls - cls_target) ** 2
    if cls_mask is not None:
        cls_sq = cls_sq * cls_mask
    cls_loss = jnp.where(assigned[..., None], cls_sq, 0.0)
    total = (
        jnp.sum(jnp.where(assigned[..., None], coord_loss, 0.0))
        + jnp.sum(obj_loss)
        + jnp.sum(cls_loss)
    )
    if seen is not None:
        warm = (jnp.asarray(seen) < 12800).astype(jnp.float32)
        prior = 0.5 * 0.01 * (
            (r[..., 0] - 0.5) ** 2 + (r[..., 1] - 0.5) ** 2
            + r[..., 2] ** 2 + r[..., 3] ** 2
        )
        # the reference writes the prior delta first and then OVERWRITES it
        # at the truth-assigned anchor's box index (region_layer.c:256-263 then
        # :282 delta_region_box on the same delta slot) — assigned anchors see
        # only the truth coord pull, so mask them out of the prior term
        total = total + warm * jnp.sum(prior * (1.0 - assigned.astype(jnp.float32)))
    stats = {"obj_count": jnp.sum(assigned),
             "avg_obj": jnp.sum(obj * assigned) / jnp.maximum(jnp.sum(assigned), 1)}
    return total, stats


@partial(jax.jit, static_argnames=("side", "classes"))
def encode_detection_truth(
    truths: jax.Array, side: int, classes: int
) -> jax.Array:
    """(B, MAX_BOXES, 5) box lists -> YOLOv1 per-cell truth grid.

    Replicates fill_truth_region (src/data.c:255-301): per box, cell =
    floor(x*S), stored as [is_obj, class one-hot, x*S-col, y*S-row, w, h];
    boxes with w or h < .005 are skipped; the FIRST box landing in a cell
    wins (data.c:289 "if (truth[index]) continue") — achieved here by
    scattering in reverse order so the earliest write lands last.
    """
    b, m, _ = truths.shape
    s2 = side * side
    x, y, w, h = truths[..., 0], truths[..., 1], truths[..., 2], truths[..., 3]
    cls = truths[..., 4].astype(jnp.int32)
    valid = (w >= 0.005) & (h >= 0.005)
    col = jnp.clip((x * side).astype(jnp.int32), 0, side - 1)
    row = jnp.clip((y * side).astype(jnp.int32), 0, side - 1)
    cell = row * side + col
    feat = jnp.concatenate(
        [
            jnp.ones((b, m, 1)),
            jax.nn.one_hot(cls, classes),
            jnp.stack([x * side - col, y * side - row, w, h], axis=-1),
        ],
        axis=-1,
    )
    cell = jnp.where(valid, cell, s2)  # out-of-range -> dropped
    bi = jnp.broadcast_to(jnp.arange(b)[:, None], (b, m))
    grid = jnp.zeros((b, s2, 1 + classes + 4))
    return grid.at[bi[:, ::-1], cell[:, ::-1]].set(feat[:, ::-1], mode="drop")


@partial(jax.jit, static_argnames=("classes", "num", "side", "sqrt", "rescore",
                                   "object_scale", "noobject_scale",
                                   "class_scale", "coord_scale", "forced",
                                   "random"))
def detection_head_loss(
    out: jax.Array,          # (B, S*S*(C + N + N*4)) v1 head forward output
    truth_grid: jax.Array,   # (B, S*S, 1 + C + 4) from encode_detection_truth
    classes: int,
    num: int,
    side: int,
    sqrt: bool = False,
    rescore: bool = False,
    object_scale: float = 1.0,
    noobject_scale: float = 1.0,
    class_scale: float = 1.0,
    coord_scale: float = 1.0,
    forced: bool = False,
    random: bool = False,
    seen=None,               # traced images-seen counter (random override gate)
):
    """YOLOv1 [detection] loss (src/detection_layer.c:50-217), vectorized.

    Darknet's printed cost is recomputed as ||delta||^2 at the end
    (detection_layer.c:212), so the per-term cost bookkeeping there is dead;
    what matters for training are the deltas.  Each 0.5*scale*(t-p)^2 term
    below has exactly darknet's delta = scale*(t-p) as its gradient.
    Box responsibility: the predictor with best IoU vs truth, falling back to
    lowest box-RMSE when every IoU is zero (detection_layer.c:109-134).
    The `forced` override (detection_layer.c:136-142) picks predictor 1 for
    small truths (area < .1) and 0 otherwise; the `random` override
    (detection_layer.c:143-145) assigns a uniform-random predictor while
    seen < 64000 — reproduced with a counter-based draw (deterministic,
    resume-stable) instead of the reference's global rand().
    """
    b = out.shape[0]
    s2 = side * side
    probs = out[:, : s2 * classes].reshape(b, s2, classes)
    confs = out[:, s2 * classes : s2 * (classes + num)].reshape(b, s2, num)
    boxes = out[:, s2 * (classes + num) :].reshape(b, s2, num, 4)

    is_obj = truth_grid[..., 0] > 0                       # (B, S2)
    t_cls = truth_grid[..., 1 : 1 + classes]              # one-hot
    t_box = truth_grid[..., 1 + classes :]                # [xr, yr, w, h]

    # ---- IoU / RMSE in the reference's cell-relative-over-side frame
    # (detection_layer.c:105-134: both pred and truth x,y are divided by side)
    pw = boxes[..., 2] ** 2 if sqrt else boxes[..., 2]
    ph = boxes[..., 3] ** 2 if sqrt else boxes[..., 3]
    pred = jnp.stack([boxes[..., 0] / side, boxes[..., 1] / side, pw, ph], axis=-1)
    tr = jnp.stack(
        [t_box[..., 0] / side, t_box[..., 1] / side, t_box[..., 2], t_box[..., 3]],
        axis=-1,
    )[:, :, None, :]                                      # (B, S2, 1, 4)
    ious = _box_iou_xywh(pred, tr)                        # (B, S2, N)
    rmse = jnp.sqrt(jnp.sum((pred - tr) ** 2, axis=-1))
    any_iou = jnp.max(ious, axis=-1) > 0
    best = jnp.where(any_iou, jnp.argmax(ious, axis=-1), jnp.argmin(rmse, axis=-1))
    if forced:
        # small objects go to predictor 1, large to 0 (detection_layer.c:136).
        # Clamped to num-1: at num==1 the reference would index out of its own
        # delta array (latent upstream bug); here the small-object predictor
        # degenerates to 0 instead of silently zeroing the coord/obj loss
        area = t_box[..., 2] * t_box[..., 3]
        best = jnp.where(area < 0.1, min(1, num - 1), 0)
    if random and seen is not None:
        key = jax.random.fold_in(
            jax.random.PRNGKey(17), jnp.asarray(seen).astype(jnp.int32)
        )
        rand_best = jax.random.randint(key, best.shape, 0, num)
        best = jnp.where(jnp.asarray(seen) < 64000, rand_best, best)
    best_oh = jax.nn.one_hot(best, num)                   # (B, S2, N)
    best_iou = jnp.take_along_axis(ious, best[..., None], axis=-1)[..., 0]

    # ---- confidence: noobj everywhere, responsible predictor gets obj target
    conf_tgt = jnp.where(rescore, best_iou, 1.0)[..., None] * best_oh
    resp = is_obj[..., None] * best_oh                    # (B, S2, N)
    conf_w = jnp.where(resp > 0, object_scale, noobject_scale)
    conf_loss = 0.5 * conf_w * (confs - conf_tgt * resp) ** 2

    # ---- classes (only at object cells)
    cls_loss = jnp.where(
        is_obj[..., None], 0.5 * class_scale * (probs - t_cls) ** 2, 0.0
    )

    # ---- coords (only the responsible predictor; sqrt targets on w/h)
    tw = jnp.sqrt(t_box[..., 2]) if sqrt else t_box[..., 2]
    th = jnp.sqrt(t_box[..., 3]) if sqrt else t_box[..., 3]
    coord_tgt = jnp.stack([t_box[..., 0], t_box[..., 1], tw, th], axis=-1)
    coord_loss = jnp.where(
        resp[..., None] > 0,
        0.5 * coord_scale * (boxes - coord_tgt[:, :, None, :]) ** 2,
        0.0,
    )

    total = jnp.sum(conf_loss) + jnp.sum(cls_loss) + jnp.sum(coord_loss)
    stats = {
        "obj_count": jnp.sum(is_obj),
        "avg_iou": jnp.sum(best_iou * is_obj) / jnp.maximum(jnp.sum(is_obj), 1),
        "avg_obj": jnp.sum(jnp.sum(confs * resp, -1) * is_obj)
        / jnp.maximum(jnp.sum(is_obj), 1),
    }
    return total, stats


def total_loss(heads, truths, net, input_hw: tuple[int, int] | None = None,
               seen=None):
    """Sum of per-head losses over every detection head of a NetworkDef.

    ``input_hw`` is the ACTUAL input resolution this batch ran at — under
    multi-scale training it differs from net.width/height (darknet reshapes
    the whole net via resize_network, examples/detector.c:65-84; here the
    graph is shape-polymorphic and only the anchor scaling needs the real
    resolution).  Defaults to the NetworkDef's nominal size.
    """
    from yoloq.nn.graph import DetectionSpec, RegionSpec, YoloSpec

    net_h, net_w = input_hw if input_hw is not None else (net.height, net.width)
    specs = [
        s for s in net.specs if isinstance(s, (YoloSpec, RegionSpec, DetectionSpec))
    ]
    loss = 0.0
    all_stats = []
    for raw, s in zip(heads, specs):
        if isinstance(s, YoloSpec):
            l, st = yolo_head_loss(
                raw, truths, s.mask, s.anchors, s.classes, net_w, net_h
            )
        elif isinstance(s, RegionSpec):
            l, st = region_head_loss(
                raw, truths, s.anchors, s.classes,
                ignore_thresh=getattr(s, "thresh", 0.6),
                object_scale=getattr(s, "object_scale", 5.0),
                noobject_scale=getattr(s, "noobject_scale", 1.0),
                class_scale=getattr(s, "class_scale", 1.0),
                coord_scale=getattr(s, "coord_scale", 1.0),
                rescore=getattr(s, "rescore", True),
                tree=s.tree, seen=seen,
            )
        else:
            grid = encode_detection_truth(truths, s.side, s.classes)
            l, st = detection_head_loss(
                raw, grid, s.classes, s.num, s.side, sqrt=s.sqrt,
                rescore=s.rescore,
                object_scale=getattr(s, "object_scale", 1.0),
                noobject_scale=getattr(s, "noobject_scale", 1.0),
                class_scale=getattr(s, "class_scale", 1.0),
                coord_scale=getattr(s, "coord_scale", 1.0),
                forced=getattr(s, "forced", False),
                random=getattr(s, "random", False), seen=seen,
            )
        loss = loss + l
        all_stats.append(st)
    batch = heads[0].shape[0]
    return loss / batch, all_stats
