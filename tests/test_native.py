"""Native host library vs numpy reference implementations."""

import numpy as np
import pytest

from yoloq.data.image import letterbox as np_letterbox
from yoloq.eval import detect
from yoloq.utils import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no toolchain)"
)


def make_dets(rng, m=50, classes=5):
    boxes = np.stack([
        rng.uniform(0.1, 0.9, m), rng.uniform(0.1, 0.9, m),
        rng.uniform(0.05, 0.4, m), rng.uniform(0.05, 0.4, m),
    ], axis=1).astype(np.float32)
    obj = rng.uniform(0, 1, m).astype(np.float32)
    cls = rng.uniform(0, 1, (m, classes)).astype(np.float32)
    return boxes, obj, cls


class TestNMS:
    def test_nms_obj_matches_numpy_survivor_set(self, rng):
        boxes, obj, cls = make_dets(rng)
        nb, no, nc = native.nms_obj(boxes, obj, cls, 0.3)
        rb, ro, rc = detect.nms_obj(boxes, obj, cls, 0.3)
        # native keeps input order; numpy returns sorted — compare survivor
        # sets as (objectness, box) multisets
        def key(b, o):
            alive = o > 0
            return sorted(
                (round(float(o[i]), 6), *np.round(b[i], 6).tolist())
                for i in np.where(alive)[0]
            )
        assert key(nb, no) == key(rb, ro)

    def test_nms_sort_matches_numpy(self, rng):
        boxes, obj, cls = make_dets(rng)
        probs = obj[:, None] * cls
        got = native.nms_sort(boxes, probs, 0.3)
        ref = detect.nms_sort_per_class(boxes, probs, 0.3)
        np.testing.assert_allclose(got, ref, atol=1e-6)


class TestMatching:
    def test_match_truths_matches_python(self, rng):
        boxes, obj, _ = make_dets(rng, m=30)
        truths = np.stack([
            rng.uniform(0.2, 0.8, 7), rng.uniform(0.2, 0.8, 7),
            rng.uniform(0.1, 0.3, 7), rng.uniform(0.1, 0.3, 7),
        ], axis=1).astype(np.float32)
        tp_n, iou_n = native.match_truths(boxes, obj, truths, 0.3, 0.1)
        # python reference
        tp_p, iou_p = 0, 0.0
        for t in truths:
            live = obj > 0.3
            best = float(np.max(detect.box_iou(boxes[live], t))) if live.any() else 0.0
            iou_p += best
            if best > 0.1:
                tp_p += 1
        assert tp_n == tp_p
        assert iou_n == pytest.approx(iou_p, abs=1e-5)


class TestLetterbox:
    def test_matches_numpy_letterbox(self, rng):
        im = rng.uniform(0, 1, (96, 128, 3)).astype(np.float32)
        got = native.letterbox(im, 64, 64)
        ref = np_letterbox(im, 64, 64)
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_speed_sanity(self, rng):
        """Native letterbox should not be slower than numpy (smoke check)."""
        import time

        im = rng.uniform(0, 1, (720, 1280, 3)).astype(np.float32)
        native.letterbox(im, 416, 416)  # warm
        t0 = time.perf_counter()
        for _ in range(5):
            native.letterbox(im, 416, 416)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(5):
            np_letterbox(im, 416, 416)
        t_numpy = time.perf_counter() - t0
        assert t_native < t_numpy * 3  # loose: just catch pathology


class TestImageDecode:
    """Native libjpeg/libpng decode vs PIL (native/yoloq_image.cc)."""

    @pytest.fixture(autouse=True)
    def _need_image_support(self):
        lib = native.load_library()
        if lib is None or not lib._has_image:
            pytest.skip("library built without libjpeg/libpng")

    def test_png_decode_exact(self, rng, tmp_path):
        from PIL import Image

        arr = (rng.uniform(0, 1, (37, 53, 3)) * 255).astype(np.uint8)
        p = str(tmp_path / "x.png")
        Image.fromarray(arr).save(p)
        got = native.decode_image(p)
        assert got is not None and got.shape == (37, 53, 3)
        # native multiplies by the f32 reciprocal of 255; 1-ulp tolerance
        np.testing.assert_allclose(got, arr.astype(np.float32) / 255.0, atol=1e-6)

    def test_jpeg_decode_close_to_pil(self, rng, tmp_path):
        from PIL import Image

        arr = (rng.uniform(0, 1, (64, 48, 3)) * 255).astype(np.uint8)
        p = str(tmp_path / "x.jpg")
        Image.fromarray(arr).save(p, quality=95)
        got = native.decode_image(p)
        assert got is not None and got.shape == (64, 48, 3)
        with Image.open(p) as im:
            ref = np.asarray(im.convert("RGB"), np.float32) / 255.0
        # different IDCT implementations may differ by a couple LSBs
        assert np.max(np.abs(got - ref)) <= 2.5 / 255.0

    def test_unsupported_returns_none(self, tmp_path):
        p = str(tmp_path / "x.bin")
        open(p, "wb").write(b"not an image")
        assert native.decode_image(p) is None

    def test_load_image_rgb_uses_native_path(self, rng, tmp_path):
        from yoloq.data.image import load_image_rgb

        arr = (rng.uniform(0, 1, (20, 30, 3)) * 255).astype(np.uint8)
        from PIL import Image

        p = str(tmp_path / "y.png")
        Image.fromarray(arr).save(p)
        np.testing.assert_allclose(
            load_image_rgb(p), arr.astype(np.float32) / 255.0, atol=1e-6
        )


class TestAugmentPlace:
    """Fused native augmentation vs the numpy golden reference."""

    @pytest.fixture(autouse=True)
    def _need_image_support(self):
        lib = native.load_library()
        if lib is None or not lib._has_image:
            pytest.skip("library built without libjpeg/libpng")

    @pytest.mark.parametrize(
        "nw,nh,dx,dy,dhue,dsat,dexp,flip",
        [
            (64, 48, 10, 5, 0.0, 1.0, 1.0, False),      # pure place
            (100, 90, -20, -15, 0.05, 1.3, 0.8, True),  # crop + distort + flip
            (30, 30, 40, 40, -0.08, 0.7, 1.4, False),   # small paste, off-center
            (160, 160, -50, -60, 0.1, 1.5, 1.5, True),  # zoomed-in crop
        ],
    )
    def test_matches_numpy(self, rng, nw, nh, dx, dy, dhue, dsat, dexp, flip):
        from yoloq.data.voc import place_distort_flip_numpy

        im = rng.uniform(0, 1, (57, 71, 3)).astype(np.float32)
        got = native.augment_place(im, 80, 64, nw, nh, dx, dy, dhue, dsat, dexp, flip)
        ref = place_distort_flip_numpy(im, 80, 64, nw, nh, dx, dy, dhue, dsat, dexp, flip)
        assert got.shape == ref.shape == (64, 80, 3)
        np.testing.assert_allclose(got, ref, atol=2e-5)

    def test_augment_detection_end_to_end(self, rng, tmp_path):
        """Whole augment_detection goes through the native kernel and still
        produces valid boxes."""
        from yoloq.data.voc import augment_detection

        im = rng.uniform(0, 1, (80, 120, 3)).astype(np.float32)
        boxes = np.array([[1, 0.5, 0.5, 0.6, 0.6]], np.float32)
        g = np.random.default_rng(3)
        out, tb = augment_detection(im, boxes, 96, 96, g)
        assert out.shape == (96, 96, 3)
        assert out.min() >= 0 and out.max() <= 1
        for row in tb:
            assert 0 <= row[1] <= 1 and 0 <= row[2] <= 1
