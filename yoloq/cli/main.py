"""Command-line entry points, succeeding the darknet CLI (examples/darknet.c:220,
examples/detector.c:952-997):

  python -m yoloq.cli train  --cfg CFG --train-list L [...]
  python -m yoloq.cli detect --cfg CFG --weights W --image IMG
  python -m yoloq.cli f1     --cfg CFG --weights W --test-list L
  python -m yoloq.cli export --cfg CFG --ckpt DIR --out W
  python -m yoloq.cli bench

Models come from darknet cfg files (models/cfg.py) or the built-in zoo
(--model yolov3-tiny|yolov3|yolov2-tiny|yolov2); weights from darknet
.weights files (models/darknet_weights.py) or .npz training checkpoints
(train/checkpoint.py).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load_model(args):
    from yoloq.models import cfg as cfgmod
    from yoloq.models import zoo
    from yoloq.train.qat import TrainConfig

    if args.cfg:
        return cfgmod.load_cfg(args.cfg)
    size = getattr(args, "size", 416)
    classes = getattr(args, "classes", 5)
    builders = {
        "yolov3-tiny": zoo.yolov3_tiny,
        "yolov3": zoo.yolov3,
        "yolov2-tiny": zoo.yolov2_tiny,
        "yolov2": zoo.yolov2,
    }
    if args.model in builders:
        return builders[args.model](classes=classes, width=size, height=size), TrainConfig()
    raise SystemExit(
        f"unknown model {args.model!r}; pass --cfg or one of {sorted(builders)}"
    )


def _engine_from(args, net):
    """Integer engine when quant ranges exist; float engine otherwise
    (the reference's close_quantization fallback, examples/detector.c:986)."""
    from yoloq.infer.convert import convert
    from yoloq.infer.engine import Engine
    from yoloq.infer.float_engine import FloatEngine

    force_float = getattr(args, "float", False)

    def build(params, qs):
        has_ranges = qs is not None and any(
            k.startswith("act_") and float(st["max"]) != float(st["min"])
            for k, st in qs.items()
        )
        if force_float or not has_ranges:
            print("running FLOAT inference (no quant ranges or --float given)")
            return FloatEngine(net, params)
        return Engine(convert(net, params, qs),
                      dynamic_input=getattr(args, "dynamic_input", False),
                      exact_leaky=getattr(args, "exact_leaky", False))

    if getattr(args, "program", None):
        from yoloq.infer.serialize import load_program

        return Engine(load_program(args.program),
                      dynamic_input=getattr(args, "dynamic_input", False),
                      exact_leaky=getattr(args, "exact_leaky", False))
    if args.weights:
        from yoloq.models.darknet_weights import load_darknet_weights

        ckpt = load_darknet_weights(args.weights, net)
        return build(ckpt.params, ckpt.quant_state)
    if args.ckpt:
        from yoloq.train.checkpoint import restore_checkpoint
        from yoloq.train.qat import TrainConfig, init_train_state
        import jax

        template = init_train_state(net, TrainConfig(), jax.random.PRNGKey(0))
        state = restore_checkpoint(args.ckpt, template)
        return build(state.params, state.quant_state)
    raise SystemExit("need --weights (darknet) or --ckpt (checkpoint dir)")


def cmd_train(args):
    import jax
    import numpy as np

    from yoloq.data.loader import BatchLoader
    from yoloq.data.voc import AugmentConfig, DetectionDataset
    from yoloq.parallel import mesh as pmesh
    from yoloq.train import checkpoint as ckpt
    from yoloq.train.qat import Trainer

    net, tcfg = _load_model(args)
    if args.batch_size:
        tcfg = type(tcfg)(**{**tcfg.__dict__, "batch_size": args.batch_size})
    if args.max_batches:
        tcfg = type(tcfg)(**{**tcfg.__dict__, "max_batches": args.max_batches})
    if args.quant_start is not None:
        tcfg = type(tcfg)(**{**tcfg.__dict__, "quant_start_step": args.quant_start})
    if args.prune:
        tcfg = type(tcfg)(
            **{**tcfg.__dict__, "prune": True, "prune_threshold": args.prune_threshold}
        )
    if getattr(args, "freeze_ranges_after", None) is not None:
        tcfg = type(tcfg)(
            **{**tcfg.__dict__, "freeze_ranges_after": args.freeze_ranges_after}
        )

    trainer = Trainer(net, tcfg)
    start = 0
    if args.resume and ckpt.latest_step(args.backup_dir) is not None:
        trainer.state = ckpt.restore_checkpoint(args.backup_dir, trainer.state)
        start = int(trainer.state.step)
        print(f"resumed from step {start}")

    ds = DetectionDataset(args.train_list, net.width, net.height, augment=True)
    loader = BatchLoader(ds, tcfg.batch_size, workers=args.workers)
    use_mesh = args.data_parallel or getattr(args, "fsdp", False)
    mesh = pmesh.make_mesh() if use_mesh else None
    print(
        f"training {len(net.specs)}-layer net at {net.width}x{net.height}, "
        f"batch {tcfg.batch_size}, {len(ds)} images, "
        f"{'DP over ' + str(mesh.devices.size) + ' devices' if mesh else 'single device'}"
    )
    if getattr(args, "fsdp", False):
        # ZeRO-3-style placement: params + optimizer state shard over the
        # data axis in place of replication (parallel/fsdp.py); the jitted
        # step is unchanged.  The report makes silent replication (layers
        # with channel counts not divisible by the mesh) visible up front.
        from yoloq.parallel import fsdp

        trainer.state = fsdp.shard_state(mesh, trainer.state)
        rep = fsdp.shard_report(mesh, trainer.state.params)
        print(
            f"FSDP over {mesh.shape['data']} devices: "
            f"{rep['sharded_fraction'] * 100:.1f}% of param bytes sharded "
            f"({rep['sharded_bytes']} sharded / {rep['replicated_bytes']} "
            f"replicated)"
        )
    avg_loss = None
    import random as _random

    from yoloq.train.qat import multiscale_resolutions

    resolutions = multiscale_resolutions() if args.multiscale else None
    try:
        for step in range(start, tcfg.max_batches):
            if resolutions and step % 10 == 0:
                dim = _random.choice(resolutions)
                ds.set_size(dim, dim)
                if step % 100 == 0:
                    print(f"resolution -> {dim}")
            images, truths = loader.next()
            t0 = time.time()
            if mesh:
                with mesh:
                    images, truths = pmesh.shard_batch(mesh, images, truths)
                    metrics = trainer.step(images, truths)
            else:
                metrics = trainer.step(images, truths)
            loss = float(metrics["loss"])
            avg_loss = loss if avg_loss is None else 0.9 * avg_loss + 0.1 * loss
            # per-batch line, reference examples/detector.c:131; sparsity is
            # the reference's "prune zeros:%d,all:%d" (src/network.c:316)
            prune_info = (
                f", sparsity {float(metrics['sparsity']):.3f}"
                if "sparsity" in metrics
                else ""
            )
            print(
                f"{step + 1}: loss {loss:.4f}, avg {avg_loss:.4f}, "
                f"lr {float(metrics['lr']):.6f}, {time.time() - t0:.2f}s, "
                f"{(step + 1) * tcfg.batch_size} images{prune_info}"
            )
            if ckpt.checkpoint_cadence(step + 1):
                ckpt.save_checkpoint(args.backup_dir, trainer.state)
                print(f"checkpointed step {step + 1} -> {args.backup_dir}")
    finally:
        loader.close()
    ckpt.save_checkpoint(args.backup_dir, trainer.state)
    print("training done")


def cmd_detect(args):
    import numpy as np

    from yoloq.data.image import letterbox, load_image_rgb
    from yoloq.eval import detect as D

    net, _ = _load_model(args)
    engine = _engine_from(args, net)
    im = load_image_rgb(args.image)
    h, w, _ = im.shape
    t0 = time.time()
    x = letterbox(im, net.width, net.height)
    boxes, obj, cls = engine.predict(x[None])
    boxes = D.correct_boxes(boxes[0], w, h, net.width, net.height)
    obj, cls = obj[0], cls[0]
    keep = obj > args.thresh
    b, o, c = D.nms_obj(boxes[keep], obj[keep], cls[keep], args.nms)
    print(f"{args.image}: predicted in {time.time() - t0:.3f}s")
    names = None
    if args.names:
        with open(args.names) as f:
            names = [ln.strip() for ln in f if ln.strip()]
    for i in range(len(o)):
        if o[i] <= args.thresh:
            continue
        probs = o[i] * c[i]
        ci = int(np.argmax(probs))
        label = names[ci] if names and ci < len(names) else f"class{ci}"
        print(
            f"  {label}: {100 * probs[ci]:.0f}%  "
            f"box(x={b[i, 0]:.3f} y={b[i, 1]:.3f} w={b[i, 2]:.3f} h={b[i, 3]:.3f})"
        )
    if args.out:
        _draw(im, b, o, args.thresh, args.out, cls=c, names=names)
        print(f"  wrote {args.out}")


def _class_color(ci: int, classes: int):
    """Darknet's per-class color wheel (src/image.c get_color, called from
    draw_detections with offset = class*123457 %% classes and channels
    red/green/blue = columns 2/1/0 of a 6-color table)."""
    table = [(1, 0, 1), (0, 0, 1), (0, 1, 1), (0, 1, 0), (1, 1, 0), (1, 0, 0)]
    classes = max(classes, 1)
    offset = (ci * 123457) % classes
    ratio = offset / classes * 5
    i, j = int(ratio), min(int(ratio) + 1, 5)
    r = ratio - i
    rgb = [(1 - r) * table[i][c] + r * table[j][c] for c in (2, 1, 0)]
    return tuple(int(255 * v) for v in rgb)


def _annotate(im, boxes, obj, thresh, cls=None, names=None):
    """Draw boxes with class-name labels; returns float32 RGB [0,1].

    The information content of the reference's draw_detections
    (src/image.c: class-colored box + "name: prob" label strip) — text via
    PIL instead of the reference's 761 pre-rendered glyph PNGs."""
    import numpy as np
    from PIL import Image, ImageDraw

    img = Image.fromarray((im * 255).astype(np.uint8))
    d = ImageDraw.Draw(img)
    h, w = im.shape[:2]
    for i in range(len(obj)):
        if obj[i] <= thresh:
            continue
        x, y, bw, bh = boxes[i]
        left, top = (x - bw / 2) * w, (y - bh / 2) * h
        right, bot = (x + bw / 2) * w, (y + bh / 2) * h
        color = (255, 60, 40)
        label = None
        if cls is not None and np.size(cls[i]):
            probs = obj[i] * np.asarray(cls[i])
            ci = int(np.argmax(probs))
            if probs[ci] > thresh:
                name = names[ci] if names and ci < len(names) else f"class{ci}"
                label = f"{name} {100 * probs[ci]:.0f}%"
            color = _class_color(ci, len(cls[i]))
        d.rectangle([left, top, right, bot], outline=color,
                    width=max(2, round(0.006 * min(h, w))))
        if label:
            tb = d.textbbox((0, 0), label)
            tw, th = tb[2] - tb[0], tb[3] - tb[1]
            y0 = top - th - 4 if top - th - 4 >= 0 else top
            d.rectangle([left, y0, left + tw + 4, y0 + th + 4], fill=color)
            lum = 0.299 * color[0] + 0.587 * color[1] + 0.114 * color[2]
            d.text((left + 2, y0 + 2), label,
                   fill=(0, 0, 0) if lum > 128 else (255, 255, 255))
    return np.asarray(img).astype(np.float32) / 255.0


def _draw(im, boxes, obj, thresh, out_path, cls=None, names=None):
    import numpy as np
    from PIL import Image

    out = _annotate(im, boxes, obj, thresh, cls=cls, names=names)
    Image.fromarray((out * 255).astype(np.uint8)).save(out_path)


def cmd_f1(args):
    from yoloq.eval.f1 import f1_sweep

    net, _ = _load_model(args)
    engine = _engine_from(args, net)
    if args.eval_size:
        # evaluate at a non-native resolution (the reference's resize_network
        # before eval, src/network.c:434) — one more cached compile, same
        # integer program arrays
        engine = engine.at_size(args.eval_size)
    rows = f1_sweep(
        engine, args.test_list, max_images=args.max_images, verbose=True
    )
    best = max(rows, key=lambda r: r.f1)
    print(
        f"best: thresh {best.thresh:.1f} recall {best.recall:.2f} "
        f"precision {best.precision:.2f} F1 {best.f1:.2f}"
    )
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(
                    f"thresh = {r.thresh:.6f}, recall = {r.recall:.6f}, "
                    f"precison = {r.precision:.6f}, f1 score = {r.f1:.6f}\n"
                )


def cmd_export_program(args):
    """Checkpoint/weights -> self-contained integer program (.npz)."""
    from yoloq.infer.convert import convert
    from yoloq.infer.serialize import save_program

    net, _ = _load_model(args)
    if args.weights:
        from yoloq.models.darknet_weights import load_darknet_weights

        ckpt = load_darknet_weights(args.weights, net)
        params, qs = ckpt.params, ckpt.quant_state
    else:
        import jax

        from yoloq.train.checkpoint import restore_checkpoint
        from yoloq.train.qat import TrainConfig, init_train_state

        template = init_train_state(net, TrainConfig(), jax.random.PRNGKey(0))
        state = restore_checkpoint(args.ckpt, template)
        params, qs = state.params, state.quant_state
    save_program(args.out, convert(net, params, qs))
    print(f"wrote integer program {args.out}")


def cmd_export(args):
    """Training checkpoint -> darknet .weights (with quant extension)."""
    import jax

    from yoloq.models.darknet_weights import save_darknet_weights
    from yoloq.train import checkpoint as ckpt
    from yoloq.train.qat import TrainConfig, init_train_state

    net, _ = _load_model(args)
    template = init_train_state(net, TrainConfig(), jax.random.PRNGKey(0))
    state = ckpt.restore_checkpoint(args.ckpt, template)
    qs = state.quant_state if float(state.quant_state["input"]["max"]) != 0 else None
    # seen is the images-consumed counter (TrainState.seen, darknet net.seen);
    # older checkpoints without it fall back to the step count
    seen = int(getattr(state, "seen", state.step))
    save_darknet_weights(
        args.out, net,
        {i: {k: v for k, v in p.items()} for i, p in state.params.items()},
        qs, seen=seen,
    )
    print(f"wrote {args.out} (quantized={qs is not None}, seen={seen})")


def cmd_recall(args):
    """Recall/IoU eval (reference validate_detector_recall, detector.c:647)."""
    from yoloq.eval.f1 import recall_eval

    net, _ = _load_model(args)
    engine = _engine_from(args, net)
    out = recall_eval(engine, args.test_list, thresh=args.thresh,
                      iou_thresh=args.iou, max_images=args.max_images)
    print(
        f"recall {out['recall']:.2f}%  avg IoU {out['avg_iou']:.2f}%  "
        f"RPs/img {out['proposals_per_image']:.2f}  truths {out['total_truths']}"
    )


def cmd_valid(args):
    """VOC/COCO result writers + self-contained mAP (reference detector valid)."""
    from yoloq.eval.valid import (
        read_map,
        voc_map,
        write_coco_results,
        write_imagenet_results,
        write_voc_results,
    )

    net, _ = _load_model(args)
    engine = _engine_from(args, net)
    if args.eval_size:
        engine = engine.at_size(args.eval_size)
    class_map = read_map(args.class_map) if args.class_map else None
    if args.names:
        with open(args.names) as f:
            names = [ln.strip() for ln in f if ln.strip()]
    else:
        names = [f"class{i}" for i in range(args.classes)]
    if args.format == "voc":
        files = write_voc_results(engine, args.test_list, args.out_dir, names,
                                  max_images=args.max_images, flip=args.flip,
                                  class_map=class_map)
        print(f"wrote {len(files)} VOC result files to {args.out_dir}")
    elif args.format == "coco":
        out = write_coco_results(
            engine, args.test_list,
            __import__("os").path.join(args.out_dir, "coco_results.json"),
            max_images=args.max_images, flip=args.flip, class_map=class_map,
        )
        print(f"wrote {out}")
    elif args.format == "imagenet":
        out = write_imagenet_results(
            engine, args.test_list,
            __import__("os").path.join(args.out_dir, "imagenet-detection.txt"),
            max_images=args.max_images, flip=args.flip, class_map=class_map,
        )
        print(f"wrote {out}")
    if args.map:
        res = voc_map(engine, args.test_list, len(names),
                      max_images=args.max_images, flip=args.flip)
        for c, ap in zip(names, res["ap"]):
            print(f"  AP {c}: {100 * ap:.2f}" if ap == ap else f"  AP {c}: n/a (no truths)")
        print(f"mAP@0.5 = {100 * res['map']:.2f}")


def cmd_weights_tool(args):
    """Weight surgery (reference examples/darknet.c utilities)."""
    from yoloq.models import weights_tools as wt
    from yoloq.models.darknet_weights import (
        load_darknet_weights,
        save_darknet_weights,
    )

    net, _ = _load_model(args)
    ckpt = load_darknet_weights(args.weights, net)
    params = ckpt.params
    if args.op == "print":
        print(wt.print_weights(net, params, args.layer))
        return
    if args.op == "stats":
        print(wt.statistics_net(net, params))
        return
    if args.op == "visualize":
        from PIL import Image

        mosaic = wt.filter_mosaic(
            net, params, args.layer if args.layer >= 0 else None
        )
        out = args.out or "filters.png"
        Image.fromarray(mosaic).save(out)
        print(f"wrote filter mosaic {mosaic.shape} to {out}")
        return
    if args.op == "mkimg":
        import os

        from PIL import Image

        out_dir = args.out or "mkimg_out"
        os.makedirs(out_dir, exist_ok=True)
        for z, im in enumerate(wt.mkimg(net, params, args.canvas, args.canvas, args.num)):
            Image.fromarray((im * 255 + 0.5).astype("uint8")).save(
                os.path.join(out_dir, f"gen_{z}.png")
            )
        print(f"wrote {args.num} generated images to {out_dir}/")
        return
    if args.op == "rgbgr":
        wt.rgbgr_net(net, params)
    elif args.op == "rescale":
        wt.rescale_net(net, params, args.scale)
    elif args.op == "denormalize":
        wt.denormalize_net(net, params)
    elif args.op == "normalize":
        net = wt.normalize_net(net, params)
        print(
            "note: layers gained batch_normalize=1 — load the result with a "
            "BN-enabled model definition (same caveat as darknet normalize_net)"
        )
    else:
        raise SystemExit(f"unknown op {args.op}")
    out = args.out or args.weights
    save_darknet_weights(out, net, params, seen=ckpt.seen)
    print(f"applied {args.op}, wrote {out}")


def cmd_demo(args):
    """Streaming demo (the reference's OpenCV video demo, src/image_opencv.cpp,
    without a display): continuous batching via the Server.  ``--frames`` may
    be a directory of images (annotated frames written to --out-dir) or a
    VIDEO FILE (annotated video written to --out-video via OpenCV)."""
    import glob
    import os

    import numpy as np

    from yoloq.data.image import load_image_rgb
    from yoloq.infer.serving import Server

    net, _ = _load_model(args)
    engine = _engine_from(args, net)
    server = Server(engine, batch_size=args.batch_size, max_delay_ms=10)

    names = None
    if getattr(args, "names", None):
        with open(args.names) as f:
            names = [ln.strip() for ln in f if ln.strip()]

    def _dets_arrays(dets):
        boxes = np.array([d.box for d in dets]) if dets else np.zeros((0, 4))
        objs = np.array([d.objectness for d in dets]) if dets else np.zeros(0)
        cls = (
            np.array([d.class_probs for d in dets]) if dets else np.zeros((0, 0))
        )
        return boxes, objs, cls

    t0 = time.time()
    if os.path.isfile(args.frames):
        # video mode: decode -> stream through the server -> encode annotated
        from yoloq.data.video import VideoWriter, read_video

        frames_it, fps, size_wh = read_video(args.frames)
        out_path = args.out_video or os.path.splitext(args.frames)[0] + "_det.mp4"
        writer = VideoWriter(out_path, fps, size_wh)
        pending = []  # (frame, future), drained in order to keep encode order
        n = 0
        for im in frames_it:
            pending.append((im, server.submit(im, thresh=args.thresh)))
            if len(pending) >= 4 * args.batch_size:
                im0, fut = pending.pop(0)
                bb, oo, cc = _dets_arrays(fut.result(timeout=600))
                writer.write(_annotate(im0, bb, oo, 0.0, cls=cc, names=names))
                n += 1
        for im0, fut in pending:
            bb, oo, cc = _dets_arrays(fut.result(timeout=600))
            writer.write(_annotate(im0, bb, oo, 0.0, cls=cc, names=names))
            n += 1
        writer.close()
        where = f"annotated video {out_path}"
    else:
        frames = sorted(
            f for pat in ("*.jpg", "*.jpeg", "*.png")
            for f in glob.glob(os.path.join(args.frames, pat))
        )
        if not frames:
            raise SystemExit(f"no frames found in {args.frames}")
        os.makedirs(args.out_dir, exist_ok=True)
        futures = []
        images = []
        for f in frames:
            im = load_image_rgb(f)
            images.append(im)
            futures.append(server.submit(im, thresh=args.thresh))
        for f, im, fut in zip(frames, images, futures):
            out = os.path.join(args.out_dir, os.path.basename(f))
            boxes, objs, cc = _dets_arrays(fut.result(timeout=600))
            _draw(im, boxes, objs, 0.0, out, cls=cc, names=names)
        n = len(frames)
        where = f"annotated frames in {args.out_dir}"
    dt = time.time() - t0
    stats = server.stats
    server.close()
    print(
        f"{n} frames in {dt:.2f}s ({n / dt:.1f} fps), "
        f"{stats['batches']} batches, avg fill "
        f"{stats['batch_fill_sum'] / max(stats['batches'], 1):.2f}; {where}"
    )


def cmd_bench(args):
    import bench

    bench.main()


def build_parser():
    p = argparse.ArgumentParser(prog="yoloq")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, weights=True):
        sp.add_argument("--cfg", help="darknet cfg file")
        sp.add_argument("--model", default="yolov3-tiny", help="zoo model name")
        sp.add_argument("--size", type=int, default=416)
        sp.add_argument("--classes", type=int, default=5)
        if weights:
            sp.add_argument("--weights", help="darknet .weights file")
            sp.add_argument("--ckpt", help="checkpoint dir (train --backup-dir)")
            sp.add_argument("--float", action="store_true",
                            help="force float inference (close_quantization)")
            sp.add_argument("--program",
                            help="pre-converted integer program (.npz)")
            sp.add_argument("--exact-leaky", action="store_true",
                            help="C byte-parity mode: double-rounded "
                                 "quantized leaky (src/convolutional_layer.c"
                                 ":737) instead of the QAT-matched single "
                                 "round")
            sp.add_argument("--dynamic-input", action="store_true",
                            help="re-quantize the input per image at runtime "
                                 "(the reference's per-image preprocessing, "
                                 "src/blas.c:213-256)")

    sp = sub.add_parser("train", help="QAT training")
    common(sp, weights=False)
    sp.add_argument("--train-list", required=True)
    sp.add_argument("--backup-dir", default="backup")
    sp.add_argument("--batch-size", type=int)
    sp.add_argument("--max-batches", type=int)
    sp.add_argument("--workers", type=int, default=8)
    sp.add_argument("--resume", action="store_true")
    sp.add_argument("--quant-start", type=int,
                    help="override start_quantization_step")
    sp.add_argument("--multiscale", action="store_true",
                    help="random input resolution in {320..608} every 10 batches")
    sp.add_argument("--data-parallel", action="store_true")
    sp.add_argument("--fsdp", action="store_true",
                    help="shard params+optimizer over the data axis "
                         "(ZeRO-3 style placement, parallel/fsdp.py); "
                         "prints the sharded-bytes report at startup")
    sp.add_argument("--freeze-ranges-after", type=int, default=None,
                    help="freeze EMA activation ranges N QAT steps after "
                         "quant_start (compiles the range tracking out of "
                         "the step, ~6%% faster; deviation from the "
                         "reference's always-on EMA — TRAINBENCH_r05)")
    sp.add_argument("--prune", action="store_true",
                    help="magnitude pruning each update (reference PRUNE build flag)")
    sp.add_argument("--prune-threshold", type=float, default=0.001)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("detect", help="single-image quantized inference")
    common(sp)
    sp.add_argument("--image", required=True)
    sp.add_argument("--thresh", type=float, default=0.5)
    sp.add_argument("--nms", type=float, default=0.45)
    sp.add_argument("--names", help="class names file")
    sp.add_argument("--out", help="write annotated image here")
    sp.set_defaults(fn=cmd_detect)

    sp = sub.add_parser("f1", help="F1 sweep eval (reference detector f1)")
    common(sp)
    sp.add_argument("--test-list", required=True)
    sp.add_argument("--max-images", type=int)
    sp.add_argument("--out", help="append results file (test_quant.txt style)")
    sp.add_argument("--eval-size", type=int,
                    help="evaluate at a non-native resolution (multiple of "
                         "32; the reference's resize_network)")
    sp.set_defaults(fn=cmd_f1)

    sp = sub.add_parser("export", help="checkpoint -> darknet .weights")
    common(sp, weights=False)
    sp.add_argument("--ckpt", required=True)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("export-program", help="build a deployable integer program (.npz)")
    common(sp)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_export_program)

    sp = sub.add_parser("recall", help="recall/IoU eval (reference detector recall)")
    common(sp)
    sp.add_argument("--test-list", required=True)
    sp.add_argument("--thresh", type=float, default=0.25)
    sp.add_argument("--iou", type=float, default=0.5)
    sp.add_argument("--max-images", type=int)
    sp.set_defaults(fn=cmd_recall)

    sp = sub.add_parser("valid", help="VOC/COCO result writers + mAP")
    common(sp)
    sp.add_argument("--test-list", required=True)
    sp.add_argument("--out-dir", default="results")
    sp.add_argument("--format", choices=("voc", "coco", "imagenet", "none"),
                    default="voc")
    sp.add_argument("--names", help="class names file")
    sp.add_argument("--map", action="store_true", help="also compute mAP@0.5")
    sp.add_argument("--flip", action="store_true",
                    help="horizontal-flip TTA (reference `detector valid2`)")
    sp.add_argument("--class-map",
                    help="class index map file (reference .data `map=`)")
    sp.add_argument("--max-images", type=int)
    sp.add_argument("--eval-size", type=int,
                    help="evaluate at a non-native resolution (multiple of 32)")
    sp.set_defaults(fn=cmd_valid)

    sp = sub.add_parser(
        "weights-tool",
        help="weight surgery (print/stats/rgbgr/rescale/normalize/denormalize/"
             "visualize/mkimg)",
    )
    common(sp, weights=False)
    sp.add_argument("--weights", required=True)
    sp.add_argument("--op", required=True,
                    choices=("print", "stats", "rgbgr", "rescale", "normalize",
                             "denormalize", "visualize", "mkimg"))
    sp.add_argument("--layer", type=int, default=0,
                    help="conv layer index (visualize: -1 = first conv)")
    sp.add_argument("--scale", type=float, default=1.0)
    sp.add_argument("--num", type=int, default=4, help="mkimg: images to generate")
    sp.add_argument("--canvas", type=int, default=256, help="mkimg: canvas size")
    sp.add_argument("--out", help="output path (weights file / png / mkimg dir)")
    sp.set_defaults(fn=cmd_weights_tool)

    sp = sub.add_parser(
        "demo", help="streaming demo over a frames directory or a video file"
    )
    common(sp)
    sp.add_argument(
        "--frames", required=True,
        help="directory of jpg/png frames, or a video file (mp4/avi)",
    )
    sp.add_argument("--out-dir", default="demo_out")
    sp.add_argument("--out-video", default=None,
                    help="output path for video mode (default <input>_det.mp4)")
    sp.add_argument("--thresh", type=float, default=0.5)
    sp.add_argument("--batch-size", type=int, default=8)
    sp.add_argument("--names", help="class names file for box labels")
    sp.set_defaults(fn=cmd_demo)

    sp = sub.add_parser("bench", help="run the benchmark")
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
