"""Worker process for the multi-host serving test.

Launched by tests/test_serving_multihost.py: N jax.distributed processes,
each running its OWN Server over its process-local devices — the composition
infer/serving.py's docstring claims ("each host its own Server",
data-parallel serving).  Every worker builds the same deterministic program,
serves the same seeded frames through the continuous-batching path, and
writes its detections to JSON for cross-process and vs-single-process
comparison.

Usage: python serving_worker.py <coordinator> <num_procs> <proc_id> <outfile>
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


def serve_frames(frames, thresh=0.05):
    """Build the deterministic engine+server and run the frames through the
    full continuous-batching path.  Shared with the in-test single-process
    run so both sides execute identical code."""
    from yoloq.infer.engine import Engine
    from yoloq.infer.serving import Server
    from yoloq.models.presets import flagship_program

    engine = Engine(flagship_program(classes=3, size=96), max_det=32)
    server = Server(engine, batch_size=(1, 4), max_delay_ms=5.0)
    try:
        futs = [server.submit(im, thresh=thresh) for im in frames]
        out = []
        for f in futs:
            dets = f.result(timeout=300)
            out.append(
                [
                    {
                        "box": [round(float(v), 5) for v in d.box],
                        "obj": round(float(d.objectness), 5),
                        "cls": int(d.class_probs.argmax()),
                    }
                    for d in dets
                ]
            )
        return out
    finally:
        server.close()


def make_frames():
    import numpy as np

    rng = np.random.default_rng(99)
    return [
        rng.uniform(0, 1, (128, 160, 3)).astype(np.float32) for _ in range(6)
    ]


def main() -> None:
    coordinator, num_procs, proc_id, outfile = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    from yoloq.parallel import distributed

    distributed.initialize(coordinator, num_procs, proc_id)
    assert jax.process_count() == num_procs, jax.process_count()

    dets = serve_frames(make_frames())
    with open(outfile, "w") as f:
        json.dump({"process": proc_id, "detections": dets}, f)
    print(f"worker {proc_id}: {sum(len(d) for d in dets)} detections", flush=True)


if __name__ == "__main__":
    main()
