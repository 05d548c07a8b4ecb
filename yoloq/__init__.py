"""yoloq — a uint8 quantized YOLO framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
ArtyZe/yolo_quantization (a darknet fork implementing Jacob et al.,
arXiv:1712.05877 "Quantization and Training of Neural Networks for
Efficient Integer-Arithmetic-Only Inference"):

- Quantization-aware training (QAT): float forward/backward with fake-quant
  nodes, EMA activation ranges, on-the-fly batchnorm folding.
- uint8 integer inference: int8 GEMM convolutions with zero-point corrections,
  per-channel fixed-point requantization (M = S1*S2/S3), quantized
  leaky/relu6/linear activations, quantized maxpool/route/upsample,
  float YOLO decode heads.
- Data-parallel multi-device training via jax.sharding.Mesh + per-step psum
  (replacing the reference's periodic pthread weight averaging,
  reference src/network.c:1100-1194).

Package layout:
  core/      quant math primitives (nudge, fake-quant, fixed-point multipliers)
  ops/       compute kernels (integer conv as an int8 GEMM, requant epilogue)
  nn/        layer library + graph executor
  models/    declarative model zoo, darknet cfg/weights importers
  train/     QAT training loop, LR policies, checkpointing
  infer/     QAT checkpoint -> integer program conversion, inference engine
  data/      image pipeline (letterbox, augmentation, VOC loading)
  eval/      detection decode, NMS, F1/mAP harnesses
  parallel/  mesh construction and sharding helpers
  utils/     profiling, process set-up, native host library
  cli/       command-line entry points (train / detect / eval-f1 / bench)
"""

__version__ = "0.1.0"
