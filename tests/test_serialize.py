"""IntProgram serialization round-trip tests."""

import numpy as np
import pytest

from yoloq.infer.engine import Engine
from yoloq.infer.serialize import load_program, save_program
from yoloq.models.presets import flagship_program


class TestProgramSerialization:
    def test_roundtrip_identical_outputs(self, tmp_path):
        prog = flagship_program(classes=5, size=64)
        path = str(tmp_path / "model.npz")
        save_program(path, prog)
        loaded = load_program(path)
        assert loaded.net == prog.net
        assert loaded.in_scale == prog.in_scale
        for i in prog.arrays:
            for k in prog.arrays[i]:
                np.testing.assert_array_equal(loaded.arrays[i][k], prog.arrays[i][k])
        x = np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
        a = Engine(prog, max_det=16).predict(x)
        b = Engine(loaded, max_det=16).predict(x)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)

    def test_rejects_foreign_npz(self, tmp_path):
        path = str(tmp_path / "junk.npz")
        np.savez(path, __manifest__="{}", a=np.zeros(3))
        with pytest.raises(ValueError, match="not a yoloq"):
            load_program(path)
