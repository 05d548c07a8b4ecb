"""Checkpoint round-trip and CLI smoke tests (CPU)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from yoloq.models import zoo
from yoloq.train import checkpoint as ckpt
from yoloq.train.qat import TrainConfig, init_train_state


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        net = zoo.yolov3_tiny(classes=5, width=96, height=96)
        cfg = TrainConfig()
        state = init_train_state(net, cfg, jax.random.PRNGKey(0))
        state = state._replace(step=state.step + 7)
        d = str(tmp_path / "bk")
        ckpt.save_checkpoint(d, state)
        assert ckpt.latest_step(d) == 7
        template = init_train_state(net, cfg, jax.random.PRNGKey(1))
        restored = ckpt.restore_checkpoint(d, template)
        assert int(restored.step) == 7
        np.testing.assert_array_equal(
            np.asarray(restored.params[0]["w"]), np.asarray(state.params[0]["w"])
        )

    def test_keeps_newest_and_restores_any_kept_step(self, tmp_path):
        net = zoo.yolov3_tiny(classes=5, width=64, height=64)
        cfg = TrainConfig()
        state = init_train_state(net, cfg, jax.random.PRNGKey(0))
        d = str(tmp_path / "bk")
        for step in range(1, 8):
            ckpt.save_checkpoint(d, state._replace(step=state.step + step))
        assert sorted(os.listdir(d)) == [f"ckpt_{i}.npz" for i in range(3, 8)]
        assert ckpt.latest_step(d) == 7
        template = init_train_state(net, cfg, jax.random.PRNGKey(1))
        assert int(ckpt.restore_checkpoint(d, template, step=5).step) == 5
        # every leaf, optimizer state included, comes back bit for bit
        got = jax.tree.leaves(ckpt.restore_checkpoint(d, template))
        want = jax.tree.leaves(state._replace(step=state.step + 7))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))

    def test_restore_rejects_other_structure(self, tmp_path):
        cfg = TrainConfig()
        small = zoo.yolov3_tiny(classes=5, width=64, height=64)
        other = zoo.yolov3_tiny(classes=3, width=64, height=64)
        d = str(tmp_path / "bk")
        ckpt.save_checkpoint(d, init_train_state(small, cfg, jax.random.PRNGKey(0)))
        with pytest.raises(ValueError, match="does not match"):
            ckpt.restore_checkpoint(d, init_train_state(other, cfg, jax.random.PRNGKey(0)))
        assert ckpt.latest_step(str(tmp_path / "missing")) is None
        with pytest.raises(FileNotFoundError):
            ckpt.restore_checkpoint(str(tmp_path / "missing"), None)

    def test_cadence(self):
        assert ckpt.checkpoint_cadence(100)
        assert not ckpt.checkpoint_cadence(150)
        assert ckpt.checkpoint_cadence(10000)
        assert not ckpt.checkpoint_cadence(10100)


class TestCLI:
    def test_help_lists_subcommands(self):
        out = subprocess.run(
            [sys.executable, "-m", "yoloq.cli", "--help"],
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode == 0
        for cmd in ("train", "detect", "f1", "export", "bench"):
            assert cmd in out.stdout
