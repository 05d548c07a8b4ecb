"""Video-file demo: decode -> streaming engine -> annotated video output
(the reference's OpenCV video demo role, src/image_opencv.cpp — VERDICT r1
item 8)."""

import os

import numpy as np
import pytest

from yoloq.cli.main import main
from yoloq.data.video import VideoWriter, read_video, synthesize_clip

MODEL = ["--model", "yolov3-tiny", "--size", "64", "--classes", "5"]


def test_video_roundtrip(tmp_path):
    path = synthesize_clip(str(tmp_path / "clip.mp4"), n_frames=10, size=96)
    frames, fps, (w, h) = read_video(path)
    frames = list(frames)
    assert len(frames) == 10 and (w, h) == (96, 96)
    assert frames[0].dtype == np.float32
    assert 0.0 <= frames[0].min() and frames[0].max() <= 1.0
    # the moving rectangle actually moves
    assert not np.allclose(frames[0], frames[-1])


def test_demo_on_video_file(tmp_path, capsys):
    import jax

    from yoloq.models import zoo
    from yoloq.models.darknet_weights import save_darknet_weights
    from yoloq.nn.graph import init_params

    net = zoo.yolov3_tiny(classes=5, width=64, height=64)
    params = {
        i: {k: np.asarray(v) for k, v in p.items()}
        for i, p in init_params(jax.random.PRNGKey(0), net).items()
    }
    weights = str(tmp_path / "m.weights")
    save_darknet_weights(weights, net, params)  # float layout -> FloatEngine

    clip = synthesize_clip(str(tmp_path / "clip.mp4"), n_frames=12, size=96)
    out = str(tmp_path / "out.mp4")
    main([
        "demo", *MODEL, "--weights", weights, "--frames", clip,
        "--out-video", out, "--thresh", "0.99", "--batch-size", "4",
    ])
    printed = capsys.readouterr().out
    assert "12 frames" in printed
    assert os.path.getsize(out) > 1000
    frames, _, (w, h) = read_video(out)
    assert len(list(frames)) == 12 and (w, h) == (96, 96)
