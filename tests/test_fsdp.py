"""FSDP-style sharded training (parallel/fsdp.py): the same jitted step,
params + optimizer state sharded over the data axis, identical math to the
replicated run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from yoloq.models import zoo
from yoloq.parallel import fsdp
from yoloq.parallel import mesh as pmesh
from yoloq.train.loss import MAX_BOXES
from yoloq.train.qat import (
    TrainConfig,
    init_train_state,
    make_train_step,
)


def _batch():
    images = np.asarray(
        jax.random.uniform(jax.random.PRNGKey(1), (8, 96, 96, 3))
    )
    truths = np.zeros((8, MAX_BOXES, 5), np.float32)
    truths[:, 0] = (0.5, 0.5, 0.4, 0.4, 0.0)
    return images, truths


class TestFSDP:
    def test_matches_replicated_and_stays_sharded(self):
        net = zoo.yolov3_tiny(classes=2, width=96, height=96)
        cfg = TrainConfig(burn_in=0, quant_start_step=0)
        # numpy snapshot: the step donates its input state
        state0 = jax.tree.map(
            np.asarray, init_train_state(net, cfg, jax.random.PRNGKey(0))
        )
        step = make_train_step(net, cfg, qat=True)
        images, truths = _batch()
        mesh = pmesh.make_mesh()

        # replicated baseline
        with mesh:
            st = jax.device_put(state0, pmesh.replicated(mesh))
            im, tr = pmesh.shard_batch(mesh, images, truths)
            st_rep, m_rep = step(st, im, tr)
        loss_rep = float(m_rep["loss"])

        # FSDP-sharded run: same step function, different placement
        with mesh:
            st = fsdp.shard_state(mesh, state0)
            im, tr = pmesh.shard_batch(mesh, images, truths)
            st_fsdp, m_fsdp = step(st, im, tr)
        loss_fsdp = float(m_fsdp["loss"])

        # identical math, placement-only change (f32 reduction-order noise)
        assert loss_fsdp == pytest.approx(loss_rep, rel=2e-4)

        # updated conv kernels are still sharded over the data axis
        w = st_fsdp.params[10]["w"]  # 512-filter conv, divisible by 8
        spec = w.sharding.spec
        assert tuple(spec) == (None, None, None, "data"), spec

        # updated params agree with the replicated run
        for i in st_rep.params:
            for k in st_rep.params[i]:
                # sharded reductions shift the adopted fake-quant ranges by
                # f32 noise (~1e-3 on min/max), which moves one step's grads
                # at the quantization-grid level — absolute-dominated bound
                np.testing.assert_allclose(
                    np.asarray(st_rep.params[i][k]),
                    np.asarray(st_fsdp.params[i][k]),
                    rtol=2e-3, atol=5e-4,
                    err_msg=f"param {i}/{k}",
                )

    def test_shard_report(self):
        net = zoo.yolov3_tiny(classes=2, width=96, height=96)
        cfg = TrainConfig()
        state = jax.tree.map(
            np.asarray, init_train_state(net, cfg, jax.random.PRNGKey(0))
        )
        mesh = pmesh.make_mesh()
        rep = fsdp.shard_report(mesh, state.params)
        # the deep 512/1024-channel convs dominate: most bytes shard
        assert rep["sharded_fraction"] > 0.9, rep


class TestFSDPCli:
    def test_train_fsdp_smoke(self, tmp_path, capsys):
        """`cli train --fsdp` shards the state, prints the shard report, and
        completes a short run (the CLI wiring over parallel/fsdp.py)."""
        from PIL import Image

        from yoloq.cli.main import main

        (tmp_path / "images").mkdir()
        (tmp_path / "labels").mkdir()
        rng = np.random.default_rng(0)
        paths = []
        for i in range(4):
            im = (rng.uniform(0, 0.2, (96, 96, 3)) * 255).astype(np.uint8)
            im[24:72, 30:70] = [250, 60, 40]
            p = tmp_path / "images" / f"img_{i}.jpg"
            Image.fromarray(im).save(p, quality=95)
            (tmp_path / "labels" / f"img_{i}.txt").write_text(
                "1 0.52 0.5 0.42 0.5\n"
            )
            paths.append(str(p))
        (tmp_path / "list.txt").write_text("\n".join(paths) + "\n")

        main([
            "train", "--model", "yolov3-tiny", "--size", "64",
            "--classes", "5", "--train-list", str(tmp_path / "list.txt"),
            "--backup-dir", str(tmp_path / "backup"), "--batch-size", "8",
            "--max-batches", "2", "--workers", "2", "--quant-start", "0",
            "--fsdp",
        ])
        out = capsys.readouterr().out
        assert "FSDP over 8 devices" in out, out
        # the report must show the model genuinely distributed
        frac = float(out.split("FSDP over 8 devices: ")[1].split("%")[0])
        assert frac > 50.0, out
        assert "2: loss" in out, out
