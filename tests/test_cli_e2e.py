"""CLI end-to-end pipeline test: train -> export -> detect -> f1 -> program.

Exercises the same flow a user runs, in-process (CPU, tiny sizes).
"""

import os

import numpy as np
import pytest
from PIL import Image

from yoloq.cli.main import main


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        im = (rng.uniform(0, 0.2, (96, 96, 3)) * 255).astype(np.uint8)
        im[24:72, 30:70] = [250, 60, 40]
        p = root / "images" / f"img_{i}.jpg"
        Image.fromarray(im).save(p, quality=95)
        (root / "labels" / f"img_{i}.txt").write_text("1 0.52 0.5 0.42 0.5\n")
        paths.append(str(p))
    (root / "list.txt").write_text("\n".join(paths) + "\n")
    return root


MODEL = ["--model", "yolov3-tiny", "--size", "64", "--classes", "5"]


class TestPipeline:
    def test_full_pipeline(self, workspace, capsys):
        backup = str(workspace / "backup")
        # 1. QAT train a couple of steps
        main(["train", *MODEL, "--train-list", str(workspace / "list.txt"),
              "--backup-dir", backup, "--batch-size", "2", "--max-batches", "2",
              "--workers", "2", "--quant-start", "0"])
        assert os.path.isdir(backup)

        # 2. export darknet weights (quantized) and integer program
        weights = str(workspace / "m.weights")
        program = str(workspace / "m.npz")
        main(["export", *MODEL, "--ckpt", backup, "--out", weights])
        main(["export-program", *MODEL, "--ckpt", backup, "--out", program])
        assert os.path.getsize(weights) > 1000
        assert os.path.getsize(program) > 1000

        # 3. detect from all three weight sources
        img = str(workspace / "images" / "img_0.jpg")
        for src in (["--weights", weights], ["--ckpt", backup],
                    ["--program", program]):
            main(["detect", *MODEL, *src, "--image", img, "--thresh", "0.95"])

        # 4. f1 sweep — native and two non-native eval resolutions (the
        # reference's resize_network before eval, src/network.c:434)
        main(["f1", *MODEL, "--ckpt", backup,
              "--test-list", str(workspace / "list.txt"), "--max-images", "2"])
        out = capsys.readouterr().out
        assert "thresh 0.1" in out and "best:" in out
        for size in ("96", "128"):
            main(["f1", *MODEL, "--ckpt", backup,
                  "--test-list", str(workspace / "list.txt"),
                  "--max-images", "2", "--eval-size", size])
            out = capsys.readouterr().out
            assert "best:" in out

        # 5. weights-tool stats on the exported file
        main(["weights-tool", *MODEL, "--weights", weights, "--op", "stats"])
        out = capsys.readouterr().out
        assert "layer   0" in out

    def test_multiscale_flag(self, workspace):
        main(["train", *MODEL, "--train-list", str(workspace / "list.txt"),
              "--backup-dir", str(workspace / "b2"), "--batch-size", "1",
              "--max-batches", "1", "--workers", "1", "--multiscale"])


class TestFreezeRangesCli:
    def test_train_freeze_ranges(self, workspace, capsys):
        """--freeze-ranges-after trains through all three phases (float ->
        EMA-QAT -> frozen-QAT) via the CLI."""
        main(["train", *MODEL, "--train-list", str(workspace / "list.txt"),
              "--backup-dir", str(workspace / "backup_frz"),
              "--batch-size", "2", "--max-batches", "5", "--workers", "2",
              "--quant-start", "1", "--freeze-ranges-after", "2"])
        out = capsys.readouterr().out
        assert "5: loss" in out
