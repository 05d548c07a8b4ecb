"""Tests: horizontal-flip test-time averaging (reference `detector valid2`,
examples/detector.c:260-388 + avg_flipped_yolo src/yolo_layer.c:290-314)."""

import jax.numpy as jnp
import numpy as np
import pytest

from yoloq.eval.detect import flip_average_head
from yoloq.infer.engine import Engine
from yoloq.models.presets import flagship_program


def _avg_flipped_yolo_c(out, flip, classes, num):
    """Transcription of avg_flipped_yolo (src/yolo_layer.c:290-314), adapted
    from darknet's (A, 5+C, H, W) channel layout to our NHWC per-anchor
    blocks: swap columns i <-> W-1-i, negate the tx entry, average."""
    h, w, c = out.shape
    blk = 5 + classes
    f = flip.reshape(h, w, num, blk).copy()
    f = f[:, ::-1]
    f[..., 0] = -f[..., 0]
    return (out + f.reshape(h, w, c)) / 2.0


def test_flip_average_head_golden():
    classes, num = 5, 3
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 9, 9, num * (5 + classes))).astype(np.float32)
    b = rng.standard_normal((2, 9, 9, num * (5 + classes))).astype(np.float32)
    got = np.asarray(flip_average_head(jnp.asarray(a), jnp.asarray(b), classes))
    for n in range(2):
        want = _avg_flipped_yolo_c(a[n], b[n], classes, num)
        np.testing.assert_allclose(got[n], want, rtol=1e-6)


@pytest.fixture(scope="module")
def small_engine():
    return Engine(flagship_program(classes=5, size=128), max_det=32)


def test_flip_tta_runs_and_is_flip_invariant(small_engine):
    """TTA(x) and TTA(flip(x)) must produce mirrored detections: the averaged
    head is symmetric under input flip by construction."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    xf = x[:, :, ::-1, :].copy()

    b1, o1, c1 = small_engine.predict(x, flip=True)
    b2, o2, c2 = small_engine.predict(xf, flip=True)
    # objectness spectra identical, box x mirrored (match top-k sets by score)
    np.testing.assert_allclose(np.sort(o1.ravel()), np.sort(o2.ravel()), atol=1e-5)
    k1 = np.argsort(-o1[0])[:10]
    k2 = np.argsort(-o2[0])[:10]
    np.testing.assert_allclose(o1[0, k1], o2[0, k2], atol=1e-5)
    np.testing.assert_allclose(b1[0, k1, 0], 1.0 - b2[0, k2, 0], atol=1e-4)
    np.testing.assert_allclose(b1[0, k1, 1], b2[0, k2, 1], atol=1e-4)
    np.testing.assert_allclose(b1[0, k1, 2:], b2[0, k2, 2:], atol=1e-4)


def test_flip_tta_differs_from_plain(small_engine):
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    _, o_plain, _ = small_engine.predict(x)
    _, o_tta, _ = small_engine.predict(x, flip=True)
    assert not np.allclose(np.sort(o_plain.ravel()), np.sort(o_tta.ravel()))


def test_float_engine_flip_tta():
    """FloatEngine.predict(flip=True) — same TTA semantics on the float
    fallback path, so valid2/valid work on float checkpoints too."""
    import jax

    from yoloq.infer.float_engine import FloatEngine
    from yoloq.models import zoo
    from yoloq.nn.graph import init_params

    net = zoo.yolov3_tiny(classes=5, width=128, height=128)
    params = init_params(jax.random.PRNGKey(0), net)
    eng = FloatEngine(net, params, max_det=32)
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    xf = x[:, :, ::-1, :].copy()
    b1, o1, _ = eng.predict(x, flip=True)
    b2, o2, _ = eng.predict(xf, flip=True)
    np.testing.assert_allclose(np.sort(o1.ravel()), np.sort(o2.ravel()), atol=1e-5)
    _, o_plain, _ = eng.predict(x)
    assert not np.allclose(np.sort(o_plain.ravel()), np.sort(o1.ravel()))
