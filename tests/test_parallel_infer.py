"""Data-parallel sharded inference + scaling harness (virtual CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from yoloq.infer.engine import build_forward
from yoloq.models.presets import flagship_program
from yoloq.parallel import distributed, mesh as pmesh


class TestShardedInference:
    def test_batch_sharded_engine_forward(self):
        """Inference with the batch split over 8 devices, params replicated."""
        prog = flagship_program(classes=5, size=64)
        fwd = build_forward(prog)
        mesh = pmesh.make_mesh()
        run = jax.jit(lambda a, x: fwd(a, x)[0])
        with mesh:
            arrays = jax.device_put(prog.arrays, pmesh.replicated(mesh))
            x = jax.device_put(
                np.random.default_rng(0).uniform(0, 1, (8, 64, 64, 3)).astype(np.float32),
                pmesh.batch_sharding(mesh),
            )
            out = run(arrays, x)
        assert out.shape[0] == 8
        # output stays batch-sharded: no gather was forced
        assert out.sharding.spec == P("data")

    def test_scaling_harness_runs(self):
        prog = flagship_program(classes=5, size=64)
        fwd = build_forward(prog)
        run = jax.jit(lambda a, x: fwd(a, x)[0])
        arrays = jax.device_put(prog.arrays)

        def step(mesh, batch):
            with mesh:
                x = jax.device_put(batch, pmesh.batch_sharding(mesh))
                jax.block_until_ready(run(arrays, x))

        def make_batch(n):
            return np.zeros((2 * n, 64, 64, 3), np.float32)

        res = distributed.scaling_efficiency(step, make_batch, [1, 2], iters=2)
        assert set(res) == {1, 2}
        assert all(v > 0 for v in res.values())
