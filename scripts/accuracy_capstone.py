"""Flagship-resolution accuracy capstone (VERDICT r2 item 2).

The reference's headline is F1 90.08/91.83/90.94 from QAT at 416x416 on a
5-class set (README.md:55-58, eval protocol examples/detector.c:760-876).
Its dataset and pretrained weights do not exist here, so this reproduces the
PROTOCOL at the flagship config on synthetic data:

  - 416x416, 5 classes, multi-box (2 large -> coarse head, 2 small -> fine
    head through the route+upsample path)
  - full QAT schedule: float burn-in -> quant_start_step -> EMA ranges
  - multi-scale buckets {320, 416, 512} every 10 steps (the reference's
    random-dim resize, examples/detector.c:65-84)
  - convert -> integer engine; f1 threshold sweep 0.1-0.7, NMS 0.1, IoU 0.1
    for BOTH the float engine and the integer engine
  - contract: int F1 within 0.5 of float F1 (BASELINE.md parity band)

Everything bulk stays on device: the dataset is rendered INSIDE jit from
PRNG keys, and eval fetches only the top-k detections.

Usage: python scripts/accuracy_capstone.py [steps] [batch]
         [--no-multiscale] [--leaky] [--v3] [--base-size=N]
         [--percentile[=tail]] [--learned] [--bf16] [--float-baseline]
         [--eval-images=N]
Writes ACCURACY*_r04*.json (or FLOATBASE*_r04.json) at the repo root; the
--v3 variant is the flagship quantized-shortcut validation (VERDICT r3
item 1).
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

CLASSES = 5
PALETTE = jnp.asarray(
    [
        [0.95, 0.30, 0.20],
        [0.25, 0.85, 0.35],
        [0.25, 0.40, 0.95],
        [0.92, 0.85, 0.25],
        [0.80, 0.30, 0.90],
    ],
    jnp.float32,
)
MAX_BOXES = 90
# slot size ranges (relative): tiny exercises both tiny-yolo heads; the v3
# variant adds a mid pair so all THREE v3 scales get targets
SLOT_RANGES = {
    "tiny": ((0.45, 0.72), (0.45, 0.72), (0.09, 0.20), (0.09, 0.20)),
    "v3": (
        (0.45, 0.72), (0.45, 0.72),   # coarse head (116-373 px anchors)
        (0.12, 0.25), (0.12, 0.25),   # mid head (30-119 px anchors)
        (0.035, 0.075), (0.035, 0.075),  # fine head (10-33 px anchors)
    ),
}


def render_batch(key, batch: int, size: int, slots: str = "tiny"):
    """Render a batch on device: noise background + colored class rectangles.

    Even slots are always present, odd slots with prob 0.7; slot size ranges
    target each head's anchor band (SLOT_RANGES).  Returns
    (images (B,S,S,3) f32, truths (B,MAX_BOXES,5) [x,y,w,h,cls])."""
    ranges = SLOT_RANGES[slots]
    n_slots = len(ranges)
    kb, kc, kw, kx, kj, kp = jax.random.split(key, 6)
    img = jax.random.uniform(kb, (batch, size, size, 3), jnp.float32, 0.0, 0.22)
    lo = jnp.asarray([r[0] for r in ranges])
    hi = jnp.asarray([r[1] for r in ranges])
    wh = jax.random.uniform(kw, (batch, n_slots, 2), jnp.float32) * (
        (hi - lo)[None, :, None]
    ) + lo[None, :, None]
    xy = (
        jax.random.uniform(kx, (batch, n_slots, 2), jnp.float32)
        * (1.0 - wh) + wh / 2
    )
    cls = jax.random.randint(kc, (batch, n_slots), 0, CLASSES)
    present = jnp.concatenate(
        [
            jnp.ones((batch, 1), bool)
            if s % 2 == 0
            else jax.random.uniform(jax.random.fold_in(kp, s), (batch, 1)) < 0.7
            for s in range(n_slots)
        ],
        axis=1,
    )
    jitter = jax.random.uniform(kj, (batch, n_slots, 1, 1, 3), jnp.float32, -0.06, 0.06)
    yy = jnp.arange(size, dtype=jnp.float32)[None, :, None] / size
    xx = jnp.arange(size, dtype=jnp.float32)[None, None, :] / size
    for s in range(n_slots):  # paint larges first so smalls stay visible
        x0 = (xy[:, s, 0] - wh[:, s, 0] / 2)[:, None, None]
        x1 = (xy[:, s, 0] + wh[:, s, 0] / 2)[:, None, None]
        y0 = (xy[:, s, 1] - wh[:, s, 1] / 2)[:, None, None]
        y1 = (xy[:, s, 1] + wh[:, s, 1] / 2)[:, None, None]
        mask = (
            (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
            & present[:, s, None, None]
        )
        color = jnp.clip(PALETTE[cls[:, s]][:, None, None, :] + jitter[:, s], 0, 1)
        img = jnp.where(mask[..., None], color, img)
    truth_rows = jnp.concatenate(
        [xy, jnp.where(present[..., None], wh, 0.0), cls[..., None].astype(jnp.float32)],
        axis=-1,
    )
    truths = jnp.pad(truth_rows, ((0, 0), (0, MAX_BOXES - n_slots), (0, 0)))
    return img, truths


def build_net(activation: str = "relu6", v3: bool = False, size: int = 416,
              v2: bool = False):
    from yoloq.models import zoo
    from yoloq.nn.graph import YoloSpec

    if v2:
        # yolov2-tiny, [region] head (src/region_layer.c): anchors in GRID
        # units for the 13x13 grid at 416 — one per synthetic slot band
        # (larges 0.45-0.72 rel ≈ 5.8-9.4 cells, smalls 0.09-0.20 ≈ 1.2-2.6)
        return zoo.yolov2_tiny(
            classes=CLASSES, width=size, height=size, activation=activation,
            anchors=((1.8, 1.8), (4.2, 4.2), (7.6, 7.6)),
        )
    if v3:
        # full yolov3: darknet53 residual ladder, 23 quantized shortcuts,
        # 3-scale heads — the graph the reference cannot run integer
        # end-to-end (src/shortcut_layer.c:62-67)
        return zoo.yolov3(classes=CLASSES, width=size, height=size,
                          activation=activation)
    net = zoo.yolov3_tiny(classes=CLASSES, width=size, height=size,
                          activation=activation)
    # standard darknet-tiny anchors (the zoo ships the NOK cfg's elongated
    # anchors, unmatched by square synthetic boxes — same swap as the CI gate)
    std = ((10, 14), (23, 27), (37, 58), (81, 82), (135, 169), (344, 319))
    return replace(
        net,
        specs=tuple(
            replace(s, anchors=std) if isinstance(s, YoloSpec) else s
            for s in net.specs
        ),
    )


def train(net, steps: int, batch: int, multiscale: bool, quant_start: int,
          slots: str = "tiny", base_size: int = 416,
          range_stat: str = "minmax", compute_dtype: str = "float32",
          learned_ranges: bool = False, lr: float = 1e-3):
    from yoloq.train.qat import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    cfg = TrainConfig(
        learning_rate=lr, burn_in=50, batch_size=batch,
        quant_start_step=quant_start, max_batches=steps,
        range_stat=range_stat, compute_dtype=compute_dtype,
        learned_ranges=learned_ranges,
    )
    state = init_train_state(net, cfg, jax.random.PRNGKey(3))
    fstep = make_train_step(net, cfg, qat=False)
    qstep = make_train_step(net, cfg, qat=True)
    lstep = (
        make_train_step(net, cfg, qat=True, learned_ranges=True)
        if learned_ranges else None
    )
    gen = jax.jit(render_batch, static_argnames=("batch", "size", "slots"))
    sizes = (
        (base_size - 96, base_size, base_size + 96) if multiscale else (base_size,)
    )
    base = jax.random.PRNGKey(101)
    t0 = time.time()
    metrics = None
    for step in range(steps):
        size = sizes[(step // 10) % len(sizes)]
        imgs, truths = gen(
            jax.random.fold_in(base, step), batch=batch, size=size, slots=slots
        )
        if step < quant_start:
            fn = fstep
        elif lstep is not None and step >= quant_start + cfg.range_warmup:
            fn = lstep
        else:
            fn = qstep
        state, metrics = fn(state, imgs, truths)
        if (step + 1) % 100 == 0 or step + 1 == steps:
            loss = float(metrics["loss"])  # forces the queued chain
            print(
                f"step {step + 1}/{steps} size {size} loss {loss:.4f} "
                f"({time.time() - t0:.0f}s)",
                flush=True,
            )
    return state


def eval_engine(run, params_or_arrays, n_images: int, batch: int = 25,
                max_det: int = 64, slots: str = "tiny", size: int = 416):
    """Device-side eval: render fixed seeded images, run, fetch only top-k."""
    gen = jax.jit(render_batch, static_argnames=("batch", "size", "slots"))
    cache = []
    for bi in range(n_images // batch):
        key = jax.random.fold_in(jax.random.PRNGKey(777), bi)
        imgs, truths = gen(key, batch=batch, size=size, slots=slots)
        boxes, obj, cls = run(params_or_arrays, imgs)
        boxes, obj = np.asarray(boxes), np.asarray(obj)
        tr = np.asarray(truths)
        for k in range(batch):
            rows = tr[k][tr[k, :, 2] > 0]
            truths_k = np.concatenate(
                [rows[:, 4:5], rows[:, 0:4]], axis=1
            )  # [cls,x,y,w,h]
            cache.append((boxes[k], obj[k], truths_k))
    return cache


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    steps = int(args[0]) if args else 3000
    batch = int(args[1]) if len(args) > 1 else 32
    multiscale = "--no-multiscale" not in sys.argv
    activation = "leaky" if "--leaky" in sys.argv else "relu6"
    v3 = "--v3" in sys.argv
    size = 416
    for a in sys.argv[1:]:
        if a.startswith("--base-size="):
            size = int(a.split("=", 1)[1])
    range_stat = "minmax"
    for a in sys.argv[1:]:
        if a == "--percentile":
            range_stat = "percentile"
        elif a.startswith("--percentile="):
            range_stat = "percentile:" + a.split("=", 1)[1]
    learned = "--learned" in sys.argv
    float_baseline = "--float-baseline" in sys.argv
    v2 = "--v2" in sys.argv
    lr = 1e-3
    tag = "r05"
    for a in sys.argv[1:]:
        if a.startswith("--lr="):
            lr = float(a.split("=", 1)[1])
        elif a.startswith("--tag="):
            tag = a.split("=", 1)[1]
    compute_dtype = "bfloat16" if "--bf16" in sys.argv else "float32"
    slots = "v3" if v3 else "tiny"
    n_eval = 200
    for a in sys.argv[1:]:
        if a.startswith("--eval-images="):
            n_eval = int(a.split("=", 1)[1])
    quant_start = steps + 1 if float_baseline else steps * 2 // 5

    from yoloq.eval import detect
    from yoloq.eval.f1 import f1_rows
    from yoloq.infer.convert import convert
    from yoloq.infer.engine import Engine
    from yoloq.infer.float_engine import FloatEngine

    net = build_net(activation, v3=v3, size=size, v2=v2)
    print(
        f"capstone: {'yolov2-tiny' if v2 else 'yolov3-full' if v3 else 'yolov3-tiny'} {size}x{size} "
        f"{CLASSES}-class {activation} QAT, {steps} steps batch {batch}, "
        f"multiscale={multiscale}, quant_start={quant_start}, "
        f"range_stat={range_stat}, compute_dtype={compute_dtype}, "
        f"device={jax.devices()[0]}",
        flush=True,
    )
    t0 = time.time()
    state = train(net, steps, batch, multiscale, quant_start, slots=slots,
                  base_size=size, range_stat=range_stat,
                  compute_dtype=compute_dtype, learned_ranges=learned, lr=lr)
    train_s = time.time() - t0

    params = jax.tree.map(np.asarray, state.params)
    qs = jax.tree.map(np.asarray, state.quant_state)

    if float_baseline:
        # pure float training (QAT never activates): the honest comparator
        # for the QAT capstones' int rows — their "float" row is QAT weights
        # stripped of the clamps they trained against, not a float model
        fe = FloatEngine(net, params, max_det=64)
        fcache = eval_engine(fe._run, fe.params, n_images=n_eval, slots=slots,
                             size=size)
        rows = f1_rows(fcache, verbose=True)
        best = max(rows, key=lambda r: r.f1)
        print(f"float-baseline best: thresh {best.thresh} R {best.recall:.2f} "
              f"P {best.precision:.2f} F1 {best.f1:.2f}", flush=True)
        out = {
            "metric": f"float_baseline_{'v3_' if v3 else ''}{size}",
            "config": {
                "model": ("yolov2-tiny" if v2 else
                          "yolov3" if v3 else "yolov3-tiny"), "size": size,
                "classes": CLASSES, "steps": steps, "batch": batch,
                "activation": activation, "multiscale": multiscale,
                "learning_rate": lr, "eval_images": n_eval,
            },
            "train_seconds": round(train_s, 1),
            "float": {
                "thresh": best.thresh, "recall": round(best.recall, 2),
                "precision": round(best.precision, 2), "f1": round(best.f1, 2),
            },
            "device": str(jax.devices()[0]),
        }
        lr_part = "" if lr == 1e-3 else f"_lr{lr:g}"
        name = f"FLOATBASE{'_V3' if v3 else ''}_{tag}{lr_part}.json"
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))), name
        )
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(json.dumps(out), flush=True)
        return

    # QAT-SIMULATED eval: the fake-quant graph training actually optimized.
    # If this matches the int engine, the engine is faithful and any gap to
    # float is the quantization itself; if it matches float, the engine
    # diverges from the simulation (a bug).
    from yoloq.nn.graph import ForwardMode, forward

    @jax.jit
    def qat_run(p, x):
        heads, _ = forward(net, p, x, ForwardMode(train=False, qat=True), qs)
        b, o, c = detect.decode_all_heads(heads, net)
        return detect.top_k_detections(b, o, c, 64)

    qat_cache = eval_engine(qat_run, jax.device_put(params), n_images=n_eval,
                            slots=slots, size=size)
    qrows = f1_rows(qat_cache, verbose=False)
    qbest = max(qrows, key=lambda r: r.f1)
    print(f"qat-sim best: thresh {qbest.thresh} R {qbest.recall:.2f} "
          f"P {qbest.precision:.2f} F1 {qbest.f1:.2f}", flush=True)

    fe = FloatEngine(net, params, max_det=64)
    float_cache = eval_engine(fe._run, fe.params, n_images=n_eval, slots=slots,
                              size=size)
    frows = f1_rows(float_cache, verbose=True)
    fbest = max(frows, key=lambda r: r.f1)
    print(f"float best: thresh {fbest.thresh} R {fbest.recall:.2f} "
          f"P {fbest.precision:.2f} F1 {fbest.f1:.2f}", flush=True)

    program = convert(net, params, qs)
    eng = Engine(program, max_det=64)

    @jax.jit
    def int_run(arrays, x):
        from yoloq.infer.engine import build_forward

        heads = build_forward(program)(arrays, x)
        b, o, c = detect.decode_all_heads(heads, net)
        return detect.top_k_detections(b, o, c, 64)

    int_cache = eval_engine(int_run, eng.arrays, n_images=n_eval, slots=slots,
                            size=size)
    irows = f1_rows(int_cache, verbose=True)
    ibest = max(irows, key=lambda r: r.f1)
    print(f"int best: thresh {ibest.thresh} R {ibest.recall:.2f} "
          f"P {ibest.precision:.2f} F1 {ibest.f1:.2f}", flush=True)

    out = {
        "metric": f"accuracy_capstone_{'v2_' if v2 else 'v3_' if v3 else ''}{size}",
        "config": {
            "model": ("yolov2-tiny" if v2 else "yolov3" if v3 else
                      "yolov3-tiny"),
            "size": size, "classes": CLASSES, "steps": steps, "batch": batch,
            "activation": activation,
            "multiscale": multiscale, "quant_start_step": quant_start,
            "range_stat": range_stat, "compute_dtype": compute_dtype,
            "learned_ranges": learned,
            "quantized_shortcuts": 23 if v3 else 0,
            "eval_images": n_eval, "protocol": "detector f1 sweep 0.1-0.7, NMS "
            "0.1, IoU 0.1 (examples/detector.c:760-876)",
        },
        "train_seconds": round(train_s, 1),
        "float": {
            "thresh": fbest.thresh, "recall": round(fbest.recall, 2),
            "precision": round(fbest.precision, 2), "f1": round(fbest.f1, 2),
        },
        "int": {
            "thresh": ibest.thresh, "recall": round(ibest.recall, 2),
            "precision": round(ibest.precision, 2), "f1": round(ibest.f1, 2),
        },
        "qat_sim": {
            "thresh": qbest.thresh, "recall": round(qbest.recall, 2),
            "precision": round(qbest.precision, 2), "f1": round(qbest.f1, 2),
        },
        "f1_gap": round(fbest.f1 - ibest.f1, 3),
        "f1_gap_vs_qat_sim": round(qbest.f1 - ibest.f1, 3),
        "within_half_point": bool(ibest.f1 >= fbest.f1 - 0.5),
        "int_within_half_of_qat_sim": bool(ibest.f1 >= qbest.f1 - 0.5),
        "device": str(jax.devices()[0]),
    }
    parts = ["ACCURACY"]
    if v3:
        parts.append("V3")
    if v2:
        parts.append("V2")
    parts.append(tag)
    if activation != "relu6":
        parts.append(activation)
    if range_stat != "minmax":
        parts.append(range_stat.replace(":", "-"))
    if learned:
        parts.append("learned")
    if compute_dtype != "float32":
        parts.append("bf16")
    name = "_".join(parts) + ".json"
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        name)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
