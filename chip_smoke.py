"""Smoke run of the system's main paths on one GPU, checked against the CPU.

Usage:
  python chip_smoke.py           # one card: every phase below but --multi's
  python chip_smoke.py --multi   # four cards: DP/FSDP training and TP
                                 # inference against one card, nothing else

Phases (each prints its own lines; any failure raises, nothing is caught):
  1. device    platform must be gpu (no CPU fallback); card name and power
               limit, JAX version, XLA_FLAGS, compile cache, native library
  2. convs     every distinct conv shape of yolov3-tiny and yolov3 at 416^2,
               batch 2: compiled on the card, its GEMM kernel named from a
               short trace, int32 accumulators equal to the CPU backend's
  3. engine    flagship yolov3-tiny 416^2 (weights from seed): predict at
               batch 1 and 256 with memory_analysis; at batch 2 every layer's
               codes and the heads byte-identical to the CPU, also in the
               dynamic_input and exact_leaky modes; dynamic-input scale and
               zero point against parity/ctwin
  4. yolov3    full yolov3 (23 quantized shortcuts) at 416^2 batch 8 with
               memory_analysis; heads at 128^2 batch 1 byte-identical to CPU
  5. server    Server(uint8_io=True) answers 32 mixed-size requests; each
               answer equals Engine.predict on the same letterboxed input
  6. qat       5 train steps of yolov3-tiny 416^2 batch 32 (QAT from step
               1) with finite loss and memory_analysis; checkpoint round
               trip; convert + engine; one 64^2 step at highest precision
               against the CPU

The last line of stdout is {"ok": true, "device": {...}}; it is printed only
when every phase passed.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

from yoloq.utils.runtime import device_report, setup_compile_cache

WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
SEED = 0
# sizes of the phases (a rehearsal on the CPU imports this module and shrinks
# them; the script itself always runs them as set here)
SIZE = 416             # input side of every 416^2 phase
ENGINE_BATCHES = (1, 256)
V3_BATCH = 8
V3_SMALL = 128         # yolov3 byte-identity check size
QAT_BATCH = 32
N_REQUESTS = 32
T0 = time.perf_counter()


def say(phase: str, msg: str) -> None:
    print(f"[{phase} {time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def mem(compiled) -> str:
    m = compiled.memory_analysis()
    return (f"args {m.argument_size_in_bytes / 2**20:.1f} MiB, "
            f"out {m.output_size_in_bytes / 2**20:.1f} MiB, "
            f"temp {m.temp_size_in_bytes / 2**20:.1f} MiB")


def on_cpu(fn, *args):
    """Run jitted ``fn`` on the CPU backend of this process."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        out = jax.jit(fn)(*jax.device_put(args, cpu))
        return jax.tree.map(np.asarray, out)


def on_gpu(fn, *args):
    return jax.tree.map(np.asarray, jax.jit(fn)(*args))


# ---------------------------------------------------------------- phase 1
def phase_device(n_cards: int) -> dict:
    from yoloq.utils import native

    dev = device_report()
    if dev["platform"] != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {dev['platform']!r}); "
            f"this check runs on the card only"
        )
    if dev["count"] < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, found {dev['count']}")
    cache = setup_compile_cache()
    say("device", f"platform {dev['platform']}, kind {dev['kind']}, count {dev['count']}")
    for line in dev["nvidia_smi"]:
        say("device", f"nvidia-smi: {line}")
    say("device", f"jax {jax.__version__}, XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
                  f"compile cache {cache}")
    say("device", f"native host library loaded: {native.load_library() is not None}")
    return dev


# ---------------------------------------------------------------- phase 2
def gemm_kernel_names(fn, args, logdir: str) -> list[str]:
    """Names of the GEMM kernels one call of ``fn`` runs on the card."""
    from yoloq.utils.profiling import device_op_times

    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(logdir):
        jax.block_until_ready(fn(*args))
    names = set()
    for per_name in device_op_times(logdir).values():
        names.update(n for n in per_name if "gemm" in n or "xmma" in n or "cutlass" in n)
    return sorted(names)


def phase_convs() -> None:
    from yoloq.models.presets import distinct_conv_shapes
    from yoloq.ops.qconv import conv_acc_int32

    rng = np.random.default_rng(SEED)
    shapes = distinct_conv_shapes(SIZE)
    say("convs", f"{len(shapes)} distinct conv shapes (h, cin, cout, k, stride, pad), batch 2")
    for i, (h, ci, co, k, s, p) in enumerate(shapes):
        x = rng.integers(-128, 128, (2, h, h, ci), dtype=np.int8)
        w = rng.integers(-128, 128, (k, k, ci, co), dtype=np.int8)
        w_zp = rng.integers(-20, 20, co).astype(np.int32)
        x_zp = np.int32(-7)

        def acc(x, w, x_zp, w_zp, s=s, p=p):
            return conv_acc_int32(x, w, x_zp, w_zp, s, p)

        fn = jax.jit(acc)
        compiled = fn.lower(x, w, x_zp, w_zp).compile()
        route = "cublas" if "__cublas" in compiled.as_text() else "xla-triton"
        got = np.asarray(compiled(x, w, x_zp, w_zp))
        want = on_cpu(acc, x, w, x_zp, w_zp)
        check(np.array_equal(got, want),
              f"conv {(h, ci, co, k, s, p)}: int32 accumulators differ from the CPU "
              f"(max |diff| {np.abs(got.astype(np.int64) - want).max()})")
        kernels = gemm_kernel_names(fn, (x, w, x_zp, w_zp), os.path.join(WORK, "conv_trace", str(i)))
        say("convs", f"{(h, ci, co, k, s, p)} acc == cpu (bit-exact), {route}: {', '.join(kernels)}")


# ---------------------------------------------------------------- phase 3
def compare_layers(tag: str, program, x, **mode) -> None:
    """Every layer output and head of build_forward, card vs CPU."""
    from yoloq.infer.engine import _quantize_input, build_forward

    fwd = build_forward(program, return_outputs=True, **mode)
    arrays = program.arrays
    heads_g, outs_g = on_gpu(fwd, arrays, x)
    heads_c, outs_c = on_cpu(fwd, arrays, x)
    # the input quantize is the one float->code rounding outside the layers
    q = lambda x: _quantize_input(x, program.in_scale, program.in_zp)  # noqa: E731
    in_diff = int(np.abs(on_gpu(q, x).astype(np.int32) - on_cpu(q, x)).max())
    worst = 0
    for i, (a, b) in enumerate(zip(outs_g, outs_c)):
        d = np.abs(a.astype(np.float64) - b.astype(np.float64)).max()
        if d:
            cause = ("input quantize round tie" if in_diff else "unexplained")
            say("engine", f"{tag}: layer {i} {program.cfg[i].kind} differs by {d} ({cause})")
            # one code, or one code's worth of a dequantized float output
            tol = 1 if a.dtype == np.int8 else getattr(program.cfg[i], "out_scale", 0.0)
            check(in_diff <= 1 and d <= tol * (1 + 1e-6),
                  f"{tag}: layer {i} differs from the CPU by {d}")
        worst = max(worst, d)
    for a, b in zip(heads_g, heads_c):
        check(in_diff or np.array_equal(a, b), f"{tag}: heads differ from the CPU")
    say("engine", f"{tag}: {len(outs_g)} layers + {len(heads_g)} heads vs cpu: "
                  f"max |diff| {worst} (input codes max |diff| {in_diff})")


def phase_engine():
    from yoloq.infer.engine import (
        Engine,
        _dynamic_input_qp,
        _quantize_input_dynamic,
    )
    from yoloq.models.presets import flagship_program
    from yoloq.parity import ctwin

    program = flagship_program(size=SIZE, seed=SEED)
    engine = Engine(program, max_det=64)
    for batch in ENGINE_BATCHES:
        x = jax.random.uniform(jax.random.PRNGKey(batch), (batch, SIZE, SIZE, 3))
        compiled = engine._run.lower(engine.arrays, x).compile()
        boxes, obj, cls = engine.predict(np.asarray(x))
        check(boxes.shape[::2] == (batch, 4) and np.isfinite(boxes).all()
              and np.isfinite(obj).all(), f"predict at batch {batch}: bad output")
        say("engine", f"yolov3-tiny {SIZE} batch {batch}: predict ok, boxes {boxes.shape}; "
                      f"memory_analysis {mem(compiled)}")

    x2 = np.random.default_rng(SEED + 2).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    compare_layers("static input", program, x2)
    compare_layers("dynamic_input", program, x2, dynamic_input=True)
    compare_layers("exact_leaky", program, x2, exact_leaky=True)

    scales, zps = on_gpu(_dynamic_input_qp, x2)
    codes = on_gpu(_quantize_input_dynamic, x2, scales, zps).astype(np.int16) + 128
    code_diff = 0
    for i in range(len(x2)):
        s_ref, zp_ref = ctwin.dynamic_input_qp(x2[i])
        check(abs(float(scales[i]) - float(s_ref)) <= float(np.spacing(s_ref)),
              f"dynamic scale {scales[i]} vs ctwin {s_ref}: more than 1 ulp")
        check(abs(int(zps[i]) - zp_ref) <= 1, f"dynamic zp {zps[i]} vs ctwin {zp_ref}")
        ref = ctwin.quantize_input_c(x2[i], s_ref, zp_ref).astype(np.int16)
        code_diff = max(code_diff, int(np.abs(codes[i] - ref).max()))
    check(code_diff <= 1, f"dynamic input codes differ from ctwin by {code_diff}")
    say("engine", f"dynamic input vs parity/ctwin: scale <= 1 ulp, zp <= 1, "
                  f"codes max |diff| {code_diff}")
    return engine


# ---------------------------------------------------------------- phase 4
def phase_v3() -> None:
    import dataclasses

    from yoloq.infer.convert import convert
    from yoloq.infer.engine import Engine, build_forward
    from yoloq.models import zoo
    from yoloq.models.presets import synthetic_quant_state
    from yoloq.nn.graph import ShortcutSpec, init_params_numpy

    net = zoo.yolov3(classes=80, width=SIZE, height=SIZE)
    program = convert(net, init_params_numpy(SEED, net), synthetic_quant_state(net))
    n_short = sum(isinstance(s, ShortcutSpec) for s in net.specs)
    engine = Engine(program, max_det=64)
    x = jax.random.uniform(jax.random.PRNGKey(8), (V3_BATCH, SIZE, SIZE, 3))
    compiled = engine._run.lower(engine.arrays, x).compile()
    boxes, obj, _ = engine.predict(np.asarray(x))
    check(np.isfinite(boxes).all() and np.isfinite(obj).all(), "yolov3 predict: non-finite")
    say("yolov3", f"yolov3 ({n_short} shortcuts) {SIZE} batch {V3_BATCH}: predict ok; "
                  f"memory_analysis {mem(compiled)}")

    small = dataclasses.replace(
        program, net=dataclasses.replace(net, height=V3_SMALL, width=V3_SMALL)
    )
    fwd = build_forward(small)
    x1 = np.random.default_rng(SEED + 4).uniform(
        0, 1, (1, V3_SMALL, V3_SMALL, 3)
    ).astype(np.float32)
    heads_g = on_gpu(fwd, small.arrays, x1)
    heads_c = on_cpu(fwd, small.arrays, x1)
    for a, b in zip(heads_g, heads_c):
        check(np.array_equal(a, b), f"yolov3 {V3_SMALL} heads differ from the CPU")
    say("yolov3", f"yolov3 {V3_SMALL} batch 1: {len(heads_g)} heads byte-identical to cpu")


# ---------------------------------------------------------------- phase 5
def phase_server(engine) -> None:
    from concurrent.futures import Future

    from yoloq.infer.serving import Server, _Request
    from yoloq.utils import native

    rng = np.random.default_rng(SEED + 5)
    sizes = [(int(rng.integers(120, 720)), int(rng.integers(120, 960)))
             for _ in range(N_REQUESTS)]
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    server = Server(engine, uint8_io=True)
    try:
        futs = [server.submit(f, thresh=0.3) for f in frames]
        answers = [f.result(timeout=600) for f in futs]
    finally:
        server.close()
    batches = dict(server.stats["bucket_hist"])
    net = engine.program.net
    n_dets = 0
    for frame, got in zip(frames, answers):
        # the same request, answered by one direct Engine.predict call and
        # the server's own post-processing
        image = frame.astype(np.float32) / np.float32(255.0)
        lb = native.letterbox(image, net.width, net.height)
        u8 = (lb * 255.0 + 0.5).astype(np.uint8)[None]
        req = _Request(image=image, future=Future(), thresh=0.3, nms=0.45)
        server._finish_batch([req], engine.predict(u8), 1)
        want = req.future.result()
        check(len(got) == len(want), "server answer differs from Engine.predict")
        for a, b in zip(got, want):
            check(np.array_equal(a.box, b.box) and a.objectness == b.objectness
                  and np.array_equal(a.class_probs, b.class_probs),
                  "server detection differs from Engine.predict")
        n_dets += len(got)
    say("server", f"{N_REQUESTS} requests of {len(set(sizes))} frame sizes answered "
                  f"({n_dets} detections, batches by bucket {batches}); "
                  f"all equal Engine.predict on the same uint8 inputs")


# ---------------------------------------------------------------- phase 6
def _truths(n: int) -> np.ndarray:
    from yoloq.train.loss import MAX_BOXES

    t = np.zeros((n, MAX_BOXES, 5), np.float32)
    t[:, 0] = (0.5, 0.5, 0.4, 0.4, 1.0)
    t[:, 1] = (0.3, 0.6, 0.2, 0.3, 2.0)
    return t


def _checksum(params) -> float:
    return float(sum(np.abs(np.asarray(v, np.float64)).sum()
                     for p in params.values() for v in p.values()))


def phase_qat() -> None:
    from yoloq.infer.convert import convert
    from yoloq.infer.engine import Engine
    from yoloq.models import zoo
    from yoloq.train import checkpoint as ckpt
    from yoloq.train.qat import (
        TrainConfig,
        Trainer,
        init_train_state,
        make_train_step,
    )

    net = zoo.yolov3_tiny(classes=5, width=SIZE, height=SIZE)
    cfg = TrainConfig(quant_start_step=1, batch_size=QAT_BATCH, burn_in=0)
    trainer = Trainer(net, cfg, jax.random.PRNGKey(SEED))
    images = jax.random.uniform(jax.random.PRNGKey(SEED + 6), (QAT_BATCH, SIZE, SIZE, 3))
    truths = jnp.asarray(_truths(QAT_BATCH))
    compiled = trainer._qat_step.lower(trainer.state, images, truths).compile()
    say("qat", f"QAT step yolov3-tiny {SIZE} batch {QAT_BATCH}: "
               f"memory_analysis {mem(compiled)}")
    losses = []
    for _ in range(5):
        losses.append(float(trainer.step(images, truths)["loss"]))
    check(all(np.isfinite(losses)), f"non-finite QAT loss {losses}")
    say("qat", f"5 steps (float step 0, QAT steps 1-4), loss {losses}")

    ck_dir = os.path.join(WORK, "ckpt")
    state = jax.tree.map(np.asarray, trainer.state)
    ckpt.save_checkpoint(ck_dir, trainer.state)
    template = init_train_state(net, cfg, jax.random.PRNGKey(SEED + 1))
    restored = ckpt.restore_checkpoint(ck_dir, template)
    same = jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), b), restored, state)
    check(all(jax.tree.leaves(same)), "checkpoint round trip changed the state")
    program = convert(net, restored.params, restored.quant_state)
    boxes, obj, _ = Engine(program, max_det=64).predict(np.asarray(images[:2]))
    check(np.isfinite(boxes).all() and np.isfinite(obj).all(), "trained engine: non-finite")
    say("qat", f"checkpoint step {ckpt.latest_step(ck_dir)} round trip exact; "
               f"convert + engine predict ok")

    # one QAT step at 64^2 batch 2, card vs CPU, both at highest precision.
    # Tolerances: the loss sums thousands of terms in another order on each
    # backend, and a last-bit difference can move an activation across a
    # fake-quant code boundary, which shifts it by a whole quantization step
    # (relative 1e-3; 7.7e-5 measured on an H100); the post-step |param|
    # checksum moves by lr*grad only and agrees far tighter (relative 1e-6;
    # 3.8e-9 measured).
    small = zoo.yolov3_tiny(classes=5, width=64, height=64)
    cfg_s = TrainConfig(quant_start_step=0, batch_size=2, burn_in=0, donate_state=False)
    state0 = jax.tree.map(np.asarray, init_train_state(small, cfg_s, jax.random.PRNGKey(SEED)))
    step = make_train_step(small, cfg_s, qat=True)
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(SEED + 7), (2, 64, 64, 3)))
    t = _truths(2)
    with jax.default_matmul_precision("highest"):
        st_g, m_g = on_gpu(step, state0, x, t)
        st_c, m_c = on_cpu(step, state0, x, t)
    lg, lc = float(m_g["loss"]), float(m_c["loss"])
    cg, cc = _checksum(st_g.params), _checksum(st_c.params)
    say("qat", f"64^2 step at highest precision: loss gpu {lg!r} cpu {lc!r}; "
               f"param checksum gpu {cg!r} cpu {cc!r}")
    check(abs(lg - lc) <= 1e-3 * max(abs(lc), 1.0), "64^2 step loss differs from the CPU")
    check(abs(cg - cc) <= 1e-6 * abs(cc), "64^2 step params differ from the CPU")


# ---------------------------------------------------------------- phase 7
def phase_multi() -> None:
    import __graft_entry__

    # the check compares placements, so both sides run at full f32
    # precision: TF32 would add its own rounding to each side
    with jax.default_matmul_precision("highest"):
        __graft_entry__.dryrun_multichip(4)
    say("multi", "DP and FSDP steps match one card; TP heads bitwise equal")


def main(argv: list[str]) -> int:
    multi = "--multi" in argv
    n_cards = 4 if multi else 1
    dev = phase_device(n_cards)
    os.makedirs(WORK, exist_ok=True)
    if multi:
        phase_multi()
    else:
        phase_convs()
        engine = phase_engine()
        phase_v3()
        phase_server(engine)
        phase_qat()
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": dev["count"],
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
