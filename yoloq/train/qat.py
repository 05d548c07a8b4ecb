"""QAT training loop: state, LR policy, optimizer, jitted data-parallel step.

Replaces the reference's train path (examples/detector.c:8-156 +
src/network.c:365-404 + src/convolutional_kernels.cu:107-389):

- SGD with momentum 0.9, weight decay 5e-4 on conv kernels only (darknet
  applies decay to .weights, not biases/BN, src/convolutional_layer.c:901-919).
- darknet 'steps' LR policy with burn-in: lr * (step/burn_in)^4 during
  burn-in, then piecewise scale drops (reference src/network.c get_current_rate).
- BN rolling statistics EMA .99/.01 (src/batchnorm_layer.c:143-146).
- Fake-quant activates after ``quant_start_step`` (cfg start_quantization_step,
  reference src/parser.c:592): before it, plain float training; after it, the
  QAT graph with EMA range tracking.  The mode flip happens host-side between
  two jitted step functions — no traced branching.
- Data parallelism: one jitted step over a Mesh; batch sharded on the 'data'
  axis, params replicated; XLA emits the per-step gradient all-reduce.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from yoloq.nn.graph import ConvSpec, ForwardMode, NetworkDef, forward
from yoloq.train.loss import total_loss

BN_ROLLING_DECAY = 0.99  # reference src/batchnorm_layer.c:143-146


@dataclass(frozen=True)
class TrainConfig:
    """[net] hyperparameters (reference src/parser.c:579-674)."""

    learning_rate: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    burn_in: int = 1000
    max_batches: int = 550200
    policy: str = "steps"  # constant|step|steps|exp|poly|random|sig
    lr_steps: tuple[int, ...] = (400000, 450000)
    lr_scales: tuple[float, ...] = (0.1, 0.1)
    power: float = 4.0     # burn-in + poly + random exponent
    gamma: float = 1.0     # exp + sig
    lr_step: int = 1       # step + sig policies' period/midpoint
    lr_scale: float = 1.0  # step policy's scale
    quant_start_step: int = 10000
    batch_size: int = 64
    # darknet adam=1 support (src/parser.c:609-613); default SGD+momentum
    adam: bool = False
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-7
    input_calibration: tuple[float, ...] = ()  # parsed for cfg parity
    # Magnitude pruning (the reference's PRUNE build flag, Makefile:6 —
    # compile-time there, runtime config here per SURVEY §5.6): every update,
    # conv kernel weights with |w| < threshold are zeroed along with their
    # momentum (src/network.c:264-277 CPU, src/convolutional_kernels.cu:364 +
    # src/blas_kernels.cu:59-73 GPU; 0.001 is the GPU path's threshold).
    prune: bool = False
    prune_threshold: float = 0.001
    # conv contraction operand dtype: "float32" or "bfloat16" (bf16
    # operands, f32 accumulation; params/optimizer stay f32).  bf16 is gated
    # on the accuracy capstone staying in the ±0.5 F1 band (PERF.md).
    compute_dtype: str = "float32"
    # activation range statistic: "minmax" (reference raw extremes) or
    # "percentile" (outlier-clipping calibrated ranges, nn/graph._batch_range)
    range_stat: str = "minmax"
    # learnable ranges (beyond reference): after `range_warmup` EMA-seeded QAT
    # steps, fake-quant passes gradients to min/max (TF
    # FakeQuantWithMinMaxVars semantics) and the step moves each range by
    # sign-SGD (±range_lr per step — scale-free: the raw gradients are sums
    # over clamped elements whose magnitude varies with tensor size)
    learned_ranges: bool = False
    range_lr: float = 0.01
    range_warmup: int = 200
    # donate the input TrainState to the jitted step (in-place buffer reuse,
    # halves peak param+optimizer memory).  See make_train_step's donation
    # contract; set False when callers must keep the pre-step state alive.
    donate_state: bool = True
    # freeze EMA activation ranges N QAT steps after quant_start: the min/max
    # reductions and EMA updates drop out of the step entirely (they were
    # 10.4% of the r4 trace together with BN stats).  DEVIATION from the
    # reference, which EMA-tracks until the end of training
    # (src/blas.c:38-42) — opt-in; ranges barely move after warmup in
    # practice (the learned_ranges study r4 measured EMA drift ~1e-3/step
    # post-warmup).  None = reference behavior.
    freeze_ranges_after: int | None = None


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    quant_state: Any
    step: jax.Array
    # images consumed so far — the reference's persistent net.seen counter
    # (src/network.c:372 `net.seen += net.batch`), carried explicitly instead
    # of being reconstructed as step*batch so the 12800/64000-image warmup
    # gates stay correct across resume with a different batch size or future
    # gradient accumulation (advisor r4)
    seen: jax.Array = jnp.int32(0)


def lr_schedule(cfg: TrainConfig):
    """The full darknet LR policy set (src/network.c:106-136
    get_current_rate): burn-in warmup lr*(t/burn_in)^power, then
    constant / step / steps / exp / poly / random / sig.

    One deviation: `random` uses a per-step counter-based uniform draw
    (deterministic, resume-stable) instead of the reference's global rand().
    """
    base = cfg.learning_rate

    def lr(step):
        stepf = jnp.asarray(step, jnp.float32)
        if cfg.policy == "constant":
            rate = jnp.float32(base)
        elif cfg.policy == "step":
            rate = base * cfg.lr_scale ** jnp.floor(stepf / max(cfg.lr_step, 1))
        elif cfg.policy == "steps":
            # the scale applies AT the boundary step (reference:
            # "if steps[i] > batch_num return" — i.e. >= applies the drop)
            rate = jnp.float32(base)
            for s, sc in zip(cfg.lr_steps, cfg.lr_scales):
                rate = jnp.where(step >= s, rate * sc, rate)
        elif cfg.policy == "exp":
            rate = base * cfg.gamma ** stepf
        elif cfg.policy == "poly":
            rate = base * jnp.maximum(
                1.0 - stepf / max(cfg.max_batches, 1), 0.0
            ) ** cfg.power
        elif cfg.policy == "random":
            u = jax.random.uniform(
                jax.random.fold_in(jax.random.PRNGKey(0), jnp.asarray(step, jnp.int32))
            )
            rate = base * u ** cfg.power
        elif cfg.policy == "sig":
            rate = base / (1.0 + jnp.exp(cfg.gamma * (stepf - cfg.lr_step)))
        else:
            raise ValueError(f"unknown LR policy {cfg.policy!r}")
        warm = base * (stepf / max(cfg.burn_in, 1)) ** cfg.power
        return jnp.where(step < cfg.burn_in, warm, rate)

    return lr


def _decay_mask(params):
    """Weight decay applies to conv kernels only (darknet update rule)."""
    return {i: {k: (k == "w") for k in p} for i, p in params.items()}


def _prune_step(net: NetworkDef, cfg: TrainConfig, params, opt_state):
    """Magnitude pruning, applied just before the optimizer update exactly
    like the reference (src/network.c:299-311 prunes each conv then calls
    l.update; src/convolutional_kernels.cu:360-365 prunes at the top of the
    GPU update): conv kernel weights with |w| < threshold are zeroed together
    with their momentum (the reference zeroes l.weight_updates, its momentum
    buffer).  Returns (params, opt_state, sparsity) where sparsity is the
    zeroed fraction — the reference's per-update "prune zeros:%d,all:%d"
    counter (src/network.c:316) as a metric instead of a printf.

    Deviation noted: the reference CPU path tests ``w < 0.01`` (unsigned,
    src/network.c:269 — large negative weights get zeroed); we follow the GPU
    kernel's |w| < threshold (src/blas_kernels.cu:62), which is the intended
    semantics.
    """
    params = {i: dict(p) for i, p in params.items()}
    masks = {}
    zeros = jnp.int32(0)
    total = 0
    for i, s in enumerate(net.specs):
        if not (isinstance(s, ConvSpec) and i in params):
            continue
        w = params[i]["w"]
        m = jnp.abs(w) >= cfg.prune_threshold
        params[i]["w"] = jnp.where(m, w, 0.0)
        masks[i] = m
        zeros = zeros + jnp.sum(~m)
        total += w.size

    def mask_tree(tree):
        out = dict(tree)
        for i, m in masks.items():
            li = dict(out[i])
            li["w"] = jnp.where(m, li["w"], 0.0)
            out[i] = li
        return out

    def fix(state):
        if isinstance(state, optax.TraceState):
            return optax.TraceState(trace=mask_tree(state.trace))
        if isinstance(state, optax.ScaleByAdamState):
            return optax.ScaleByAdamState(
                count=state.count, mu=mask_tree(state.mu), nu=state.nu
            )
        return state

    is_momentum = lambda x: isinstance(
        x, (optax.TraceState, optax.ScaleByAdamState)
    )
    opt_state = jax.tree.map(fix, opt_state, is_leaf=is_momentum)
    return params, opt_state, zeros / jnp.float32(max(total, 1))


def make_optimizer(cfg: TrainConfig):
    if cfg.adam:
        opt = optax.adam(
            learning_rate=lr_schedule(cfg), b1=cfg.adam_b1, b2=cfg.adam_b2,
            eps=cfg.adam_eps,
        )
    else:
        opt = optax.sgd(learning_rate=lr_schedule(cfg), momentum=cfg.momentum)
    return optax.chain(
        optax.add_decayed_weights(cfg.weight_decay, mask=_decay_mask), opt
    )


def init_train_state(net: NetworkDef, cfg: TrainConfig, key) -> TrainState:
    from yoloq.nn.graph import init_params, init_quant_state

    params = init_params(key, net)
    tx = make_optimizer(cfg)
    return TrainState(
        params=params,
        opt_state=tx.init(params),
        quant_state=init_quant_state(
            net, input_calibration=getattr(cfg, "input_calibration", ())
        ),
        step=jnp.int32(0),
        seen=jnp.int32(0),
    )


def make_train_step(net: NetworkDef, cfg: TrainConfig, qat: bool,
                    learned_ranges: bool = False, freeze_ranges: bool = False):
    """Build the jitted step for one phase (float warmup / EMA-QAT /
    learned-range QAT / frozen-range QAT).

    Returns step(state, images, truths) -> (state, metrics).  Non-trainable
    state (BN rolling stats via bn_stats aux, EMA quant ranges) is threaded
    functionally; masked out of the gradient.  With ``learned_ranges`` the
    quant ranges ARE differentiated (fake_quant_learned) and move by
    sign-SGD each step instead of EMA tracking.  With ``freeze_ranges`` the
    EMA tracking is compiled OUT (cfg.freeze_ranges_after phase).
    """
    tx = make_optimizer(cfg)
    mode = ForwardMode(
        train=True, qat=qat,
        update_ranges=qat and not learned_ranges and not freeze_ranges,
        compute_dtype=cfg.compute_dtype, range_stat=cfg.range_stat,
        learned_ranges=learned_ranges,
    )

    def loss_fn(params, quant_state, images, truths, seen):
        heads, aux = forward(net, params, images, mode, quant_state)
        # actual batch resolution (multi-scale aware), static under jit;
        # ``seen`` (images so far, the reference's net.seen) gates the
        # region/v1 early-training heuristics in the loss
        loss, _ = total_loss(
            heads, truths, net, input_hw=images.shape[1:3], seen=seen
        )
        return loss, aux

    # Donation contract: with cfg.donate_state (the default) the input
    # TrainState's buffers are DONATED — consumed and rewritten in place, so
    # XLA avoids allocating a second copy of the model+optimizer memory.  The
    # pre-step state object is invalidated: callers must rebind to the
    # returned state (Trainer.step does) and must NOT hold the old one for
    # mid-train checkpointing or before/after comparisons — snapshot with
    # jax.tree.map(np.asarray, state) BEFORE stepping if needed.  A step that
    # throws (e.g. OOM on a multiscale retrace) leaves the donated state
    # unusable; set donate_state=False for recoverable / experimental runs.
    @partial(jax.jit, donate_argnums=(0,) if cfg.donate_state else ())
    def step(state: TrainState, images, truths):
        seen = state.seen
        if learned_ranges:
            (loss, aux), (grads, qgrads) = jax.value_and_grad(
                loss_fn, argnums=(0, 1), has_aux=True
            )(state.params, state.quant_state, images, truths, seen)
        else:
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                state.params, state.quant_state, images, truths, seen
            )
        params, opt_state = state.params, state.opt_state
        sparsity = None
        if cfg.prune:
            params, opt_state, sparsity = _prune_step(net, cfg, params, opt_state)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        # BN rolling stats update (darknet .99/.01 EMA)
        for i, (mean, var) in aux["bn_stats"].items():
            params[i]["mean"] = (
                BN_ROLLING_DECAY * params[i]["mean"] + (1 - BN_ROLLING_DECAY) * mean
            )
            params[i]["var"] = (
                BN_ROLLING_DECAY * params[i]["var"] + (1 - BN_ROLLING_DECAY) * var
            )
        if learned_ranges:
            # sign-SGD with nudge-compatible clamps: min stays <= 0,
            # max stays >= a small positive floor (degenerate-scale guard)
            def upd(k, r, g):
                v = r - jnp.float32(cfg.range_lr) * jnp.sign(g)
                return (
                    jnp.minimum(v, 0.0) if k == "min" else jnp.maximum(v, 1e-3)
                )

            quant_state = {
                name: {k: upd(k, r, qgrads[name][k]) for k, r in st.items()}
                for name, st in state.quant_state.items()
            }
        else:
            quant_state = aux["quant_state"] if qat else state.quant_state
        new_state = TrainState(
            params, opt_state, quant_state, state.step + 1,
            state.seen + images.shape[0],
        )
        metrics = {"loss": loss, "lr": lr_schedule(cfg)(state.step)}
        if sparsity is not None:
            metrics["sparsity"] = sparsity
        return new_state, metrics

    return step


class Trainer:
    """Host-side driver selecting float vs QAT step by global step count
    (the reference's `*net->seen > quant_start_step` check,
    src/convolutional_kernels.cu:110).

    Multi-scale training: the reference randomly re-shapes the whole network
    every 10 batches to a resolution in {320..608} (examples/detector.c:65-84,
    src/network.c:434 resize_network).  The graph here is shape-polymorphic
    (specs carry no spatial dims), so multi-scale is just feeding a batch of a
    different size — each resolution jit-compiles once and is cached
    (bucketed compiles, no per-resize graph surgery).  Params and quant state
    are resolution-independent, exactly as in the reference.
    """

    def __init__(self, net: NetworkDef, cfg: TrainConfig, key=None):
        self.net = net
        self.cfg = cfg
        self.state = init_train_state(net, cfg, key if key is not None else jax.random.PRNGKey(0))
        self._float_step = make_train_step(net, cfg, qat=False)
        self._qat_step = make_train_step(net, cfg, qat=True)
        self._learned_step = None  # built lazily (extra compile)
        self._frozen_step = None   # built lazily (freeze_ranges_after phase)

    def step(self, images, truths):
        step_i = int(self.state.step)
        if step_i < self.cfg.quant_start_step:
            fn = self._float_step
        elif (
            self.cfg.learned_ranges
            and step_i >= self.cfg.quant_start_step + self.cfg.range_warmup
        ):
            # third phase: EMA-seeded ranges now move on the task gradient
            if self._learned_step is None:
                self._learned_step = make_train_step(
                    self.net, self.cfg, qat=True, learned_ranges=True
                )
            fn = self._learned_step
        elif (
            self.cfg.freeze_ranges_after is not None
            and step_i >= self.cfg.quant_start_step + self.cfg.freeze_ranges_after
        ):
            # frozen-range phase: EMA tracking compiled out of the step
            if self._frozen_step is None:
                self._frozen_step = make_train_step(
                    self.net, self.cfg, qat=True, freeze_ranges=True
                )
            fn = self._frozen_step
        else:
            fn = self._qat_step
        self.state, metrics = fn(self.state, images, truths)
        return metrics


def multiscale_resolutions(
    base: int = 416, lo: int = 320, hi: int = 608, stride: int = 32
) -> tuple[int, ...]:
    """The reference's random-dim set: multiples of 32 in [320, 608]
    (examples/detector.c:65-69: rand()%10 + 10 times 32)."""
    del base
    return tuple(range(lo, hi + 1, stride))
