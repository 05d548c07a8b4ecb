#!/usr/bin/env python
"""Cross-binary F1: the compiled reference scores THIS framework's trained
checkpoint (VERDICT r4 item 1 — the strongest accuracy claim this
environment permits).

Closes the loop the tier-1/2 parity harness (scripts/parity_c.py) left open:
there, byte parity was proven on ONE image with RANDOM weights; here a QAT
TRAINING RUN of the reference's own cfg (yolov3_tiny_quant_channelwise.cfg,
relu6, 5 classes) is exported to .weights and the reference binary itself
runs its detector-f1 protocol (validate_detector_f1,
examples/detector.c:760-876 — split quantization preprocessing, per-image
dynamic input quant, get_network_boxes per threshold, do_nms_obj(classes=1),
TP/TP_FP/TP_FN counting) over a dumped eval set; the integer engine runs the
identical protocol (eval/f1.py) over the same files.

Controls for comparability:
- eval images are LOSSLESS (PNG bytes; named .jpg only because the
  reference's label lookup find_replace's ".jpg"->".txt" — both stb and our
  decoders sniff magic bytes, so content rules), eliminating JPEG decoder
  variance between stb and libjpeg;
- anchors in the cfg copy are the standard tiny set (the NOK cfg's 405-420 px
  elongated anchors cannot match square synthetic boxes — same adjustment as
  tests/test_accuracy_gate.py); both binaries read the SAME cfg file;
- the engine row runs full parity mode: asymmetric per-channel weights,
  route_rescale=False, per-image dynamic input quantization — the same
  integer semantics the C binary executes; a production-mode engine row
  (symmetric weights, requantized routes, static input) is reported next to
  it.

Training runs on CPU at --train-size (the graph is shape-polymorphic; params
are resolution-independent, exactly like darknet's resize_network), eval at
the cfg's native 416.

Usage: python scripts/crossf1.py [--steps 1500] [--train-size 160]
         [--n-train 48] [--n-eval 24] [--tag r05]
Writes CROSSF1_<tag>.json at the repo root and prints it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.environ.get("REF", "/root/reference")
CFG_SRC = os.path.join(REF, "cfg", "yolov3_tiny_quant_channelwise.cfg")
sys.path.insert(0, REPO)

STD_TINY_ANCHORS = "10,14,  23,27,  37,58,  81,82,  135,169,  344,319"
CLASS_COLORS = [
    (245, 80, 50), (60, 220, 90), (70, 110, 245), (240, 200, 60),
    (180, 70, 230),
]


def render_dataset(root: str, n: int, seed: int, canvas: int = 416) -> str:
    """Synthetic colored-box detection set, lossless on disk.

    Same task family as tests/test_accuracy_gate.py / the on-chip capstone:
    one large box (matched by the 344x319-class anchors at 416) and one
    small (81x82-class, through the route+upsample fine head) per image,
    5 classes.
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(f"{root}/images", exist_ok=True)
    os.makedirs(f"{root}/labels", exist_ok=True)
    paths = []
    for i in range(n):
        im = (rng.uniform(0, 0.22, (canvas, canvas, 3)) * 255).astype(np.uint8)
        labels = []

        def put_box(w, h, cls):
            x = rng.uniform(w / 2, 1 - w / 2)
            y = rng.uniform(h / 2, 1 - h / 2)
            x0, y0 = int((x - w / 2) * canvas), int((y - h / 2) * canvas)
            x1, y1 = int((x + w / 2) * canvas), int((y + h / 2) * canvas)
            im[y0:y1, x0:x1] = CLASS_COLORS[cls]
            labels.append(f"{cls} {x:.6f} {y:.6f} {w:.6f} {h:.6f}")

        # same slot distribution as the on-chip capstone renderer
        # (scripts/accuracy_capstone.py SLOT_RANGES["tiny"]): two large
        # (second present p=.7), two small (second present p=.7)
        put_box(rng.uniform(0.45, 0.72), rng.uniform(0.45, 0.72),
                int(rng.integers(5)))
        if rng.uniform() < 0.7:
            put_box(rng.uniform(0.45, 0.72), rng.uniform(0.45, 0.72),
                    int(rng.integers(5)))
        put_box(rng.uniform(0.09, 0.20), rng.uniform(0.09, 0.20),
                int(rng.integers(5)))
        if rng.uniform() < 0.7:
            put_box(rng.uniform(0.09, 0.20), rng.uniform(0.09, 0.20),
                    int(rng.integers(5)))
        # PNG bytes under a .jpg name: lossless for BOTH decoders (magic-byte
        # sniffing), .jpg so the reference's find_replace label lookup works
        p = f"{root}/images/img_{i:03d}.jpg"
        Image.fromarray(im).save(p, format="PNG")
        with open(f"{root}/labels/img_{i:03d}.txt", "w") as f:
            f.write("\n".join(labels) + "\n")
        paths.append(p)
    list_file = f"{root}/list.txt"
    with open(list_file, "w") as f:
        f.write("\n".join(paths) + "\n")
    return list_file


def write_cfg(workdir: str) -> str:
    """Copy the reference cfg, replacing only the anchors lines."""
    with open(CFG_SRC) as f:
        text = f.read()
    text = re.sub(r"anchors *=.*", f"anchors = {STD_TINY_ANCHORS}", text)
    out = os.path.join(workdir, "crossf1.cfg")
    with open(out, "w") as f:
        f.write(text)
    return out


def train(net, tcfg_over: dict, list_file: str, train_size: int, steps: int,
          batch: int, key: int = 7):
    import jax

    from yoloq.data.loader import BatchLoader
    from yoloq.data.voc import AugmentConfig, DetectionDataset
    from yoloq.train.qat import TrainConfig, Trainer

    cfg = TrainConfig(
        learning_rate=1e-3, burn_in=50, quant_start_step=steps * 2 // 5,
        max_batches=steps, batch_size=batch, **tcfg_over,
    )
    trainer = Trainer(net, cfg, key=jax.random.PRNGKey(key))
    ds = DetectionDataset(
        list_file, train_size, train_size, augment=True,
        aug_cfg=AugmentConfig(jitter=0.08, hue=0.02, saturation=1.1,
                              exposure=1.1),
    )
    loader = BatchLoader(ds, batch, workers=4)
    t0 = time.time()
    try:
        for i in range(steps):
            images, truths = loader.next()
            m = trainer.step(images, truths)
            if i % 100 == 0 or i == steps - 1:
                print(f"step {i}: loss {float(m['loss']):.4f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
    finally:
        loader.close()
    return trainer.state


def train_device(net, steps: int, batch: int, multiscale: bool):
    """On-card training with the capstone's device-side renderer (the train
    set is rendered INSIDE jit; the dumped eval set follows the same slot
    distribution)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import accuracy_capstone as ac
    import jax

    from yoloq.train.qat import (
        TrainConfig,
        init_train_state,
        make_train_step,
    )

    quant_start = steps * 2 // 5
    cfg = TrainConfig(
        learning_rate=1e-3, burn_in=50, batch_size=batch,
        quant_start_step=quant_start, max_batches=steps,
    )
    state = init_train_state(net, cfg, jax.random.PRNGKey(3))
    fstep = make_train_step(net, cfg, qat=False)
    qstep = make_train_step(net, cfg, qat=True)
    gen = jax.jit(ac.render_batch, static_argnames=("batch", "size", "slots"))
    sizes = (320, 416, 512) if multiscale else (416,)
    base = jax.random.PRNGKey(101)
    t0 = time.time()
    for step in range(steps):
        size = sizes[(step // 10) % len(sizes)]
        imgs, truths = gen(jax.random.fold_in(base, step), batch=batch,
                           size=size, slots="tiny")
        fn = fstep if step < quant_start else qstep
        state, metrics = fn(state, imgs, truths)
        if (step + 1) % 100 == 0 or step + 1 == steps:
            print(f"step {step + 1}/{steps} size {size} "
                  f"loss {float(metrics['loss']):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return state


def run_c_f1(shim: str, cfg: str, weights: str, list_file: str,
             outdir: str) -> list[dict]:
    """Run the shim's f1 list mode; parse crossf1.txt rows."""
    r = subprocess.run(
        [shim, cfg, weights, list_file, outdir],
        capture_output=True, text=True, timeout=3600,
    )
    if r.returncode != 0:
        raise RuntimeError(f"parity_shim f1 mode failed:\n{r.stderr[-2000:]}")
    rows = []
    with open(os.path.join(outdir, "crossf1.txt")) as f:
        for line in f:
            p = line.split()
            tp, tp_fp, tp_fn = int(p[1]), int(p[2]), int(p[3])
            rows.append({
                "thresh": float(p[0]), "tp": tp, "tp_fp": tp_fp,
                "tp_fn": tp_fn, "proposals": int(p[4]),
                "recall": 100.0 * tp / max(tp_fn, 1),
                "precision": 100.0 * tp / max(tp_fp, 1),
                "f1": 100.0 * 2 * tp / max(tp_fp + tp_fn, 1),
            })
    return rows


def engine_rows(engine, list_file: str) -> list[dict]:
    from yoloq.eval.f1 import f1_sweep

    return [
        {"thresh": r.thresh, "tp": r.tp, "tp_fp": r.tp_fp, "tp_fn": r.tp_fn,
         "recall": r.recall, "precision": r.precision, "f1": r.f1}
        for r in f1_sweep(engine, list_file)
    ]


def twin_rows(net, weights_path: str, list_file: str) -> list[dict]:
    """F1 rows from the C-EXACT numpy twin (parity/ctwin.py) — byte-identical
    to the compiled reference per tier-1, so these counts must EQUAL the C
    binary's rows exactly; any engine-vs-C gap is then attributable purely to
    the engine's f32 requant epilogue (the documented LSB-level deviation
    from the reference's truncation-through-doubles arithmetic)."""
    from yoloq.data.image import letterbox, load_image_rgb
    from yoloq.data.voc import label_path_for, read_boxes, \
        read_image_list
    from yoloq.eval.f1 import f1_rows
    from yoloq.models.darknet_weights import (
        load_darknet_weights,
    )
    from yoloq.parity.ctwin import CTwin, yolo_detections_c

    ckpt = load_darknet_weights(weights_path, net)
    twin = CTwin(net, ckpt)
    cache = []
    for p in read_image_list(list_file):
        im = load_image_rgb(p)
        h, w, _ = im.shape
        chw = np.ascontiguousarray(letterbox(im, net.width, net.height)
                                   .transpose(2, 0, 1))
        res = twin.forward(chw, thresh=0.05)
        yolo_outs = [tl.f32 for tl, s in zip(res.layers, net.specs)
                     if type(s).__name__ == "YoloSpec"]
        dets = yolo_detections_c(net, yolo_outs, w, h, 0.05)
        truths = read_boxes(label_path_for(p))
        cache.append((dets[:, :4], dets[:, 4], truths))
    return [
        {"thresh": r.thresh, "tp": r.tp, "tp_fp": r.tp_fp, "tp_fn": r.tp_fn,
         "recall": r.recall, "precision": r.precision, "f1": r.f1}
        for r in f1_rows(cache)
    ]


def best(rows: list[dict]) -> dict:
    return max(rows, key=lambda r: r["f1"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "train", "eval"), default="all",
                    help="train: train+export only (use --device gpu for the "
                         "card); eval: reuse an exported .weights (CPU)")
    ap.add_argument("--device", choices=("cpu", "gpu"), default="cpu")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--train-size", type=int, default=160,
                    help="CPU-training resolution (device training is "
                         "multiscale 320/416/512)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-train", type=int, default=48)
    ap.add_argument("--n-eval", type=int, default=24)
    ap.add_argument("--tag", default="r05")
    ap.add_argument("--workdir", default=os.path.join(REPO, "build", "crossf1"))
    args = ap.parse_args()

    import jax

    if args.device == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from yoloq.utils.runtime import setup_compile_cache

    setup_compile_cache()

    os.makedirs(args.workdir, exist_ok=True)

    # --- reference binary + shim (out-of-tree build)
    subprocess.run(["bash", os.path.join(REPO, "scripts", "build_reference.sh")],
                   check=True, capture_output=True, text=True)
    shim = os.path.join(REPO, "build", "ref", "parity_shim")

    cfg_path = write_cfg(args.workdir)
    eval_list = render_dataset(os.path.join(args.workdir, "eval"),
                               args.n_eval, seed=99)

    from yoloq.models.cfg import load_cfg
    from yoloq.models.darknet_weights import (
        load_darknet_weights,
        save_darknet_weights,
    )

    net, _ = load_cfg(cfg_path)
    weights_path = os.path.join(args.workdir, "crossf1.weights")

    if args.phase in ("all", "train"):
        if args.device == "gpu":
            print(f"on-chip training: {len(net.specs)}-spec net, "
                  f"{args.steps} steps batch {args.batch}, multiscale "
                  f"320/416/512, device={jax.devices()[0]}", flush=True)
            state = train_device(net, args.steps, args.batch, multiscale=True)
        else:
            train_list = render_dataset(os.path.join(args.workdir, "train"),
                                        args.n_train, seed=11)
            print(f"CPU training: {len(net.specs)}-spec net at "
                  f"{args.train_size}^2 for {args.steps} steps", flush=True)
            state = train(net, {}, train_list, args.train_size, args.steps,
                          args.batch)
        t0 = time.time()
        params = {i: {k: np.asarray(v) for k, v in p.items()}
                  for i, p in state.params.items()}
        qs = {k: {n: np.asarray(v) for n, v in st.items()}
              for k, st in state.quant_state.items()}
        save_darknet_weights(weights_path, net, params, qs,
                             seen=int(state.seen))
        with open(os.path.join(args.workdir, "train_meta.json"), "w") as f:
            json.dump({"steps": args.steps, "batch": args.batch,
                       "device": args.device,
                       "train_size": ("multiscale 320/416/512"
                                      if args.device == "gpu"
                                      else args.train_size),
                       "quant_start_step": args.steps * 2 // 5}, f)
        print(f"exported {weights_path} "
              f"(param fetch+write {time.time() - t0:.0f}s)", flush=True)
        if args.phase == "train":
            return 0
    else:
        ckpt = load_darknet_weights(weights_path, net)
        params, qs = ckpt.params, ckpt.quant_state

    # --- the compiled reference scores the checkpoint
    c_rows = run_c_f1(shim, cfg_path, weights_path, eval_list, args.workdir)
    print("C binary rows:", json.dumps(c_rows), flush=True)

    # --- the integer engine, full parity mode, same files
    from yoloq.infer.convert import convert
    from yoloq.infer.engine import Engine
    from yoloq.infer.float_engine import QatSimEngine

    prog_parity = convert(net, params, qs, symmetric_weights=False,
                          route_rescale=False)
    eng_parity = Engine(prog_parity, max_det=256, dynamic_input=True)
    e_rows = engine_rows(eng_parity, eval_list)
    print("engine (parity mode) rows:", json.dumps(e_rows), flush=True)

    # --- production-mode engine + QAT-sim context rows
    prog_prod = convert(net, params, qs)
    p_rows = engine_rows(Engine(prog_prod, max_det=256), eval_list)
    q_rows = engine_rows(QatSimEngine(net, params, qs, max_det=256), eval_list)

    # --- C-exact twin rows: must equal the C binary's exactly (harness
    # validation + attribution anchor for any engine gap)
    t_rows = twin_rows(net, weights_path, eval_list)
    print("twin (C-exact) rows:", json.dumps(t_rows), flush=True)
    twin_matches_c = all(
        (tr["tp"], tr["tp_fp"], tr["tp_fn"]) == (cr["tp"], cr["tp_fp"], cr["tp_fn"])
        for tr, cr in zip(t_rows, c_rows)
    )

    meta_path = os.path.join(args.workdir, "train_meta.json")
    if os.path.exists(meta_path):
        train_meta = json.load(open(meta_path))
    else:  # pre-r5 workdirs: fall back to this invocation's args
        train_meta = {"steps": args.steps, "batch": args.batch,
                      "device": args.device}
    cb, eb, pb, qb = best(c_rows), best(e_rows), best(p_rows), best(q_rows)
    out = {
        "protocol": "reference validate_detector_f1 (examples/detector.c:760-876) "
                    "run BY THE COMPILED REFERENCE over this framework's "
                    "QAT-trained exported .weights; identical counting by the "
                    "integer engine over the same lossless images",
        "cfg": "yolov3_tiny_quant_channelwise.cfg (anchors -> standard tiny; "
               "relu6, 5 classes, 416x416 eval)",
        "train": train_meta,
        "eval_images": args.n_eval,
        "c_binary": {"rows": c_rows, "best": cb},
        "engine_parity_mode": {"rows": e_rows, "best": eb},
        "engine_production": {"rows": p_rows, "best": pb},
        "qat_sim": {"rows": q_rows, "best": qb},
        "twin_c_exact": {"rows": t_rows, "best": best(t_rows)},
        "twin_counts_equal_c_binary": bool(twin_matches_c),
        "f1_delta_c_vs_engine_parity": round(abs(cb["f1"] - eb["f1"]), 3),
        "f1_delta_c_vs_engine_production": round(abs(cb["f1"] - pb["f1"]), 3),
        "within_half_point": bool(abs(cb["f1"] - eb["f1"]) <= 0.5),
    }
    path = os.path.join(REPO, f"CROSSF1_{args.tag}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("c_binary", "engine_parity_mode",
                                   "engine_production", "qat_sim")}
                     | {"c_best": cb, "engine_parity_best": eb,
                        "engine_production_best": pb, "qat_sim_best": qb}))
    return 0 if out["within_half_point"] else 1


if __name__ == "__main__":
    sys.exit(main())
