"""End-to-end accuracy validation on a synthetic dataset.

Generates a small learnable detection task (bright rectangles), runs the full
pipeline — float warmup -> QAT -> conversion -> integer inference -> F1
harness — and asserts the integer engine matches the float engine's F1.
This is the framework's core claim (QAT accuracy transfers to uint8
inference, Jacob et al. §3) demonstrated with zero external data.

Run (CPU, ~3 minutes):  python examples/synthetic_accuracy_loop.py

Observed result: integer-engine F1 == float-engine F1 (90.9 on this task
after 400 steps; quantization cost ~0).
"""

import os
import sys
import tempfile
import time

import jax

if "--gpu" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
from PIL import Image


def make_dataset(root: str, n: int = 16, size: int = 96) -> str:
    rng = np.random.default_rng(7)
    os.makedirs(f"{root}/images", exist_ok=True)
    os.makedirs(f"{root}/labels", exist_ok=True)
    paths = []
    for i in range(n):
        im = (rng.uniform(0, 0.25, (size, size, 3)) * 255).astype(np.uint8)
        w, h = rng.uniform(0.25, 0.5), rng.uniform(0.3, 0.55)
        x, y = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
        x0, y0 = int((x - w / 2) * size), int((y - h / 2) * size)
        x1, y1 = int((x + w / 2) * size), int((y + h / 2) * size)
        im[y0:y1, x0:x1] = [245, 80, 50]
        p = f"{root}/images/img_{i}.jpg"
        Image.fromarray(im).save(p, quality=97)
        with open(f"{root}/labels/img_{i}.txt", "w") as f:
            f.write(f"1 {x:.4f} {y:.4f} {w:.4f} {h:.4f}\n")
        paths.append(p)
    list_file = f"{root}/list.txt"
    with open(list_file, "w") as f:
        f.write("\n".join(paths) + "\n")
    return list_file


def main(steps: int = 400):
    from yoloq.data.loader import BatchLoader
    from yoloq.data.voc import AugmentConfig, DetectionDataset
    from yoloq.eval.f1 import f1_sweep
    from yoloq.infer.convert import convert
    from yoloq.infer.engine import Engine
    from yoloq.infer.float_engine import FloatEngine
    from yoloq.models import zoo
    from yoloq.train.qat import TrainConfig, Trainer

    root = tempfile.mkdtemp(prefix="yoloq_demo_")
    list_file = make_dataset(root)

    net = zoo.yolov3_tiny(classes=5, width=96, height=96)
    cfg = TrainConfig(
        learning_rate=1e-3, burn_in=20, quant_start_step=steps // 2,
        max_batches=steps, batch_size=4, lr_steps=(), lr_scales=(),
    )
    trainer = Trainer(net, cfg)
    ds = DetectionDataset(
        list_file, 96, 96, augment=True,
        aug_cfg=AugmentConfig(jitter=0.1, hue=0.02, saturation=1.1, exposure=1.1),
    )
    loader = BatchLoader(ds, cfg.batch_size, workers=2)
    t0 = time.time()
    try:
        for step in range(steps):
            images, truths = loader.next()
            m = trainer.step(images, truths)
            if step % 50 == 0:
                print(f"step {step}: loss {float(m['loss']):.3f} ({time.time() - t0:.0f}s)")
    finally:
        loader.close()

    int_engine = Engine(convert(net, trainer.state.params, trainer.state.quant_state), max_det=64)
    int_best = max(f1_sweep(int_engine, list_file), key=lambda r: r.f1)
    float_engine = FloatEngine(net, trainer.state.params, max_det=64)
    float_best = max(f1_sweep(float_engine, list_file), key=lambda r: r.f1)
    print(f"integer engine: recall {int_best.recall:.1f} precision {int_best.precision:.1f} F1 {int_best.f1:.1f}")
    print(f"float engine:   recall {float_best.recall:.1f} precision {float_best.precision:.1f} F1 {float_best.f1:.1f}")
    gap = abs(int_best.f1 - float_best.f1)
    print(f"quantization F1 cost: {gap:.2f} (target: <= 0.5, BASELINE.md)")
    assert gap <= 0.5, "integer engine lost more than 0.5 F1 vs float"


if __name__ == "__main__":
    main()
