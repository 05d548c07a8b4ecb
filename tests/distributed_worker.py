"""Worker process for the multi-process jax.distributed test.

Launched by tests/test_distributed_multiproc.py: N processes, each with 4
virtual CPU devices, form one jax.distributed cluster; every process runs
the SAME jitted QAT train step over a global (data,) mesh spanning all
N*4 devices and writes its loss + a param checksum to a JSON file.

Usage: python distributed_worker.py <coordinator> <num_procs> <proc_id> <outfile>
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    coordinator, num_procs, proc_id, outfile = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    from yoloq.parallel import distributed

    distributed.initialize(coordinator, num_procs, proc_id)
    assert jax.process_count() == num_procs, jax.process_count()
    assert len(jax.devices()) == num_procs * 4

    import numpy as np

    from yoloq.models import zoo
    from yoloq.parallel import mesh as pmesh
    from yoloq.train.loss import MAX_BOXES
    from yoloq.train.qat import (
        TrainConfig, init_train_state, make_train_step,
    )

    net = zoo.yolov3_tiny(classes=2, width=96, height=96)
    cfg = TrainConfig(burn_in=0, quant_start_step=0)
    state = init_train_state(net, cfg, jax.random.PRNGKey(0))
    step = make_train_step(net, cfg, qat=True)

    # identical global batch on every process (deterministic host-side numpy)
    rng = np.random.default_rng(7)
    g_images = rng.uniform(0, 1, (8, 96, 96, 3)).astype(np.float32)
    g_truths = np.zeros((8, MAX_BOXES, 5), np.float32)
    g_truths[:, 0] = (0.5, 0.5, 0.4, 0.4, 0.0)

    mesh = distributed.global_mesh()
    sh = pmesh.batch_sharding(mesh)
    images = jax.make_array_from_callback(
        g_images.shape, sh, lambda idx: g_images[idx]
    )
    truths = jax.make_array_from_callback(
        g_truths.shape, sh, lambda idx: g_truths[idx]
    )
    with mesh:
        state = pmesh.replicate(mesh, state)
        new_state, metrics = step(state, images, truths)

    loss = float(metrics["loss"])
    # checksum over the process-local view of the (replicated) updated params
    leaves = jax.tree.leaves(new_state.params)
    checksum = float(
        sum(abs(np.asarray(jax.device_get(l))).sum() for l in leaves)
    )
    with open(outfile, "w") as f:
        json.dump({"process": proc_id, "loss": loss, "checksum": checksum}, f)
    print(f"worker {proc_id}: loss={loss} checksum={checksum}", flush=True)


if __name__ == "__main__":
    main()
