"""Declarative model zoo: YOLOv3-tiny and YOLOv3 graphs as data.

Succeeds the reference's cfg files (cfg/yolov3_tiny_quant_channelwise.cfg,
cfg/yolov3.cfg) — the builders below emit the exact same layer topology as the
cfg parser would (reference src/parser.c:710-787), with quantization flags per
layer.  models/cfg.py can additionally import arbitrary darknet cfg files into
the same NetworkDef form.
"""

from __future__ import annotations

from yoloq.nn.graph import (
    AvgPoolSpec,
    ConnectedSpec,
    ConvSpec,
    DetectionSpec,
    DropoutSpec,
    MaxPoolSpec,
    NetworkDef,
    RegionSpec,
    ReorgSpec,
    RouteSpec,
    ShortcutSpec,
    SoftmaxSpec,
    UpsampleSpec,
    YoloSpec,
)

# Anchors from the reference quant cfg (cfg/yolov3_tiny_quant_channelwise.cfg:168)
NOK_TINY_ANCHORS = ((25, 39), (29, 88), (405, 102), (407, 109), (408, 113), (420, 129))
# Standard darknet yolov3-tiny.cfg anchors
COCO_TINY_ANCHORS = ((10, 14), (23, 27), (37, 58), (81, 82), (135, 169), (344, 319))
# Standard yolov3.cfg anchors
COCO_V3_ANCHORS = (
    (10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
    (116, 90), (156, 198), (373, 326),
)


def yolov3_tiny(
    classes: int = 5,
    activation: str = "relu6",
    anchors: tuple[tuple[float, float], ...] = NOK_TINY_ANCHORS,
    width: int = 416,
    height: int = 416,
    quantized: bool = True,
) -> NetworkDef:
    """The reference's 24-layer quantized yolov3-tiny
    (cfg/yolov3_tiny_quant_channelwise.cfg:1-231, layer indices in comments)."""
    q = quantized
    head_filters = 3 * (4 + 1 + classes)
    c = lambda f, k=3, **kw: ConvSpec(  # noqa: E731
        filters=f, size=k, pad=1 if k == 3 else 0, activation=activation,
        quantized=q, **kw,
    )
    head = lambda: ConvSpec(  # noqa: E731
        filters=head_filters, size=1, pad=0, activation="linear",
        batch_normalize=False, quantized=q, quant_stop=True,
    )
    specs = (
        c(16),                                  # 0
        MaxPoolSpec(2, 2, quantized=q),         # 1
        c(32),                                  # 2
        MaxPoolSpec(2, 2, quantized=q),         # 3
        c(64),                                  # 4
        MaxPoolSpec(2, 2, quantized=q),         # 5
        c(128),                                 # 6
        MaxPoolSpec(2, 2, quantized=q),         # 7
        c(256),                                 # 8
        MaxPoolSpec(2, 2, quantized=q),         # 9
        c(512),                                 # 10
        MaxPoolSpec(2, 1, quantized=q),         # 11 (stride 1, SAME-ish pad)
        c(1024),                                # 12
        c(256, k=1),                            # 13
        c(512),                                 # 14
        head(),                                 # 15
        YoloSpec(mask=(3, 4, 5), anchors=anchors, classes=classes),  # 16
        RouteSpec(layers=(13,), quantized=q),   # 17  (cfg: layers = -4)
        c(128, k=1),                            # 18
        UpsampleSpec(2, quantized=q),           # 19
        RouteSpec(layers=(19, 8), quantized=q), # 20  (cfg: layers = -1, 8)
        c(256),                                 # 21
        head(),                                 # 22
        YoloSpec(mask=(0, 1, 2), anchors=anchors, classes=classes),  # 23
    )
    return NetworkDef(specs=specs, width=width, height=height)


def _v3_res_block(specs: list, filters: int, repeats: int, activation: str, q: bool):
    """darknet53 residual stage: downsample conv + n*(1x1 -> 3x3 -> shortcut)."""
    specs.append(ConvSpec(filters=filters, size=3, stride=2, pad=1,
                          activation=activation, quantized=q))
    for _ in range(repeats):
        specs.append(ConvSpec(filters=filters // 2, size=1, pad=0,
                              activation=activation, quantized=q))
        specs.append(ConvSpec(filters=filters, size=3, pad=1,
                              activation=activation, quantized=q))
        specs.append(ShortcutSpec(index=len(specs) - 3))


def yolov3(
    classes: int = 80,
    activation: str = "leaky",
    anchors: tuple[tuple[float, float], ...] = COCO_V3_ANCHORS,
    width: int = 416,
    height: int = 416,
    quantized: bool = True,
) -> NetworkDef:
    """Full YOLOv3 (darknet53 + 3-scale heads), topology of darknet yolov3.cfg.

    Unlike the reference — whose shortcut layer is float-only
    (src/shortcut_layer.c:62-67) and therefore cannot run yolov3 integer
    end-to-end — every residual add here is quantized: QAT tracks a range per
    shortcut output and the engine executes a single-rounded integer-domain
    add on the learned grid (infer/engine.py shortcut path).
    """
    q = quantized
    head_filters = 3 * (4 + 1 + classes)
    s: list = []
    s.append(ConvSpec(filters=32, size=3, pad=1, activation=activation, quantized=q))
    _v3_res_block(s, 64, 1, activation, q)      # ends layer 4
    _v3_res_block(s, 128, 2, activation, q)     # ends layer 11
    _v3_res_block(s, 256, 8, activation, q)     # ends layer 36
    route_36 = len(s) - 1
    _v3_res_block(s, 512, 8, activation, q)     # ends layer 61
    route_61 = len(s) - 1
    _v3_res_block(s, 1024, 4, activation, q)    # ends layer 74

    def conv(f, k):
        return ConvSpec(filters=f, size=k, pad=1 if k == 3 else 0,
                        activation=activation, quantized=q)

    def head_conv():
        return ConvSpec(filters=head_filters, size=1, pad=0, activation="linear",
                        batch_normalize=False, quantized=q, quant_stop=True)

    # Scale 1 (13x13)
    for f, k in [(512, 1), (1024, 3), (512, 1), (1024, 3), (512, 1)]:
        s.append(conv(f, k))
    branch_1 = len(s) - 1
    s.append(conv(1024, 3))
    s.append(head_conv())
    s.append(YoloSpec(mask=(6, 7, 8), anchors=anchors, classes=classes))
    # Scale 2 (26x26)
    s.append(RouteSpec(layers=(branch_1,), quantized=q))
    s.append(conv(256, 1))
    s.append(UpsampleSpec(2, quantized=q))
    s.append(RouteSpec(layers=(len(s) - 1, route_61), quantized=q))
    for f, k in [(256, 1), (512, 3), (256, 1), (512, 3), (256, 1)]:
        s.append(conv(f, k))
    branch_2 = len(s) - 1
    s.append(conv(512, 3))
    s.append(head_conv())
    s.append(YoloSpec(mask=(3, 4, 5), anchors=anchors, classes=classes))
    # Scale 3 (52x52)
    s.append(RouteSpec(layers=(branch_2,), quantized=q))
    s.append(conv(128, 1))
    s.append(UpsampleSpec(2, quantized=q))
    s.append(RouteSpec(layers=(len(s) - 1, route_36), quantized=q))
    for f, k in [(128, 1), (256, 3), (128, 1), (256, 3), (128, 1), (256, 3)]:
        s.append(conv(f, k))
    s.append(head_conv())
    s.append(YoloSpec(mask=(0, 1, 2), anchors=anchors, classes=classes))

    return NetworkDef(specs=tuple(s), width=width, height=height)


# YOLOv2 region anchors are in 13x13-grid units (darknet yolov2-voc.cfg)
VOC_V2_ANCHORS = (
    (1.3221, 1.73145), (3.19275, 4.00944), (5.05587, 8.09892),
    (9.47112, 4.84053), (11.2364, 10.0071),
)
VOC_V2_TINY_ANCHORS = (
    (1.08, 1.19), (3.42, 4.41), (6.63, 11.38), (9.42, 5.11), (16.62, 10.52),
)


def yolov2_tiny(
    classes: int = 20,
    activation: str = "leaky",
    anchors: tuple[tuple[float, float], ...] = VOC_V2_TINY_ANCHORS,
    width: int = 416,
    height: int = 416,
    quantized: bool = True,
) -> NetworkDef:
    """Tiny YOLOv2 (darknet yolov2-tiny-voc.cfg topology, [region] head)."""
    q = quantized
    num = len(anchors)

    def c(f, k=3):
        return ConvSpec(filters=f, size=k, pad=1 if k == 3 else 0,
                        activation=activation, quantized=q)

    specs: list = []
    for f in (16, 32, 64, 128, 256):
        specs += [c(f), MaxPoolSpec(2, 2, quantized=q)]
    specs += [c(512), MaxPoolSpec(2, 1, quantized=q), c(1024), c(1024)]
    specs.append(ConvSpec(filters=num * (5 + classes), size=1, pad=0,
                          activation="linear", batch_normalize=False,
                          quantized=q, quant_stop=True))
    specs.append(RegionSpec(anchors=anchors, classes=classes, num=num))
    return NetworkDef(tuple(specs), width=width, height=height)


def yolov2(
    classes: int = 20,
    activation: str = "leaky",
    anchors: tuple[tuple[float, float], ...] = VOC_V2_ANCHORS,
    width: int = 416,
    height: int = 416,
    quantized: bool = True,
) -> NetworkDef:
    """Full YOLOv2: darknet19 backbone + reorg passthrough (darknet
    yolov2-voc.cfg topology), [region] head.  The reorg layer reproduces
    darknet's exact scrambled element order (nn/layers.reorg)."""
    q = quantized
    num = len(anchors)

    def c(f, k=3):
        return ConvSpec(filters=f, size=k, pad=1 if k == 3 else 0,
                        activation=activation, quantized=q)

    s: list = [
        c(32), MaxPoolSpec(2, 2, quantized=q),                    # 0-1
        c(64), MaxPoolSpec(2, 2, quantized=q),                    # 2-3
        c(128), c(64, 1), c(128), MaxPoolSpec(2, 2, quantized=q),  # 4-7
        c(256), c(128, 1), c(256), MaxPoolSpec(2, 2, quantized=q), # 8-11
        c(512), c(256, 1), c(512), c(256, 1), c(512),              # 12-16
        MaxPoolSpec(2, 2, quantized=q),                            # 17
        c(1024), c(512, 1), c(1024), c(512, 1), c(1024),           # 18-22
        c(1024), c(1024),                                          # 23-24
    ]
    passthrough = 16  # the 26x26x512 conv (cfg route layers=-9)
    s.append(RouteSpec(layers=(passthrough,), quantized=q))        # 25
    s.append(c(64, 1))                                             # 26
    s.append(ReorgSpec(stride=2))                                  # 27
    s.append(RouteSpec(layers=(27, 24), quantized=q))              # 28
    s.append(c(1024))                                              # 29
    s.append(ConvSpec(filters=num * (5 + classes), size=1, pad=0,
                      activation="linear", batch_normalize=False,
                      quantized=q, quant_stop=True))               # 30
    s.append(RegionSpec(anchors=anchors, classes=classes, num=num))
    return NetworkDef(tuple(s), width=width, height=height)


def yolov1_tiny(
    classes: int = 20,
    num: int = 2,
    side: int = 7,
    width: int = 448,
    height: int = 448,
) -> NetworkDef:
    """Tiny YOLOv1 (darknet tiny-yolo v1 topology): conv/pool backbone, FC
    head, [detection] layer with the per-cell grid loss
    (train/loss.detection_head_loss).  v1 predates quantization — all float,
    like the reference's v1 path."""
    def c(f, k=3):
        return ConvSpec(filters=f, size=k, pad=1 if k == 3 else 0,
                        activation="leaky", quantized=False)

    s: list = []
    for f in (16, 32, 64, 128, 256, 512):
        s += [c(f), MaxPoolSpec(2, 2)]
    s += [c(1024), c(1024), c(1024)]
    s.append(ConnectedSpec(outputs=256, activation="linear"))
    s.append(ConnectedSpec(outputs=4096, activation="leaky"))
    s.append(DropoutSpec(probability=0.5))
    s.append(ConnectedSpec(outputs=side * side * (num * 5 + classes),
                           activation="linear"))
    s.append(DetectionSpec(classes=classes, num=num, side=side, coords=4,
                           sqrt=True, rescore=True,
                           # canonical tiny-yolo v1 cfg loss weights
                           object_scale=1.0, noobject_scale=0.5,
                           class_scale=1.0, coord_scale=5.0))
    return NetworkDef(tuple(s), width=width, height=height)


def darknet19(classes: int = 1000, width: int = 224, height: int = 224) -> NetworkDef:
    """darknet19 classifier (the reference's classification lineage):
    conv backbone + 1x1 class conv + global avgpool + softmax."""
    def c(f, k=3):
        return ConvSpec(filters=f, size=k, pad=1 if k == 3 else 0,
                        activation="leaky", quantized=False)

    s: list = [c(32), MaxPoolSpec(2, 2)]
    s += [c(64), MaxPoolSpec(2, 2)]
    s += [c(128), c(64, 1), c(128), MaxPoolSpec(2, 2)]
    s += [c(256), c(128, 1), c(256), MaxPoolSpec(2, 2)]
    s += [c(512), c(256, 1), c(512), c(256, 1), c(512), MaxPoolSpec(2, 2)]
    s += [c(1024), c(512, 1), c(1024), c(512, 1), c(1024)]
    s.append(ConvSpec(filters=classes, size=1, pad=0, activation="linear",
                      batch_normalize=False, quantized=False))
    s.append(AvgPoolSpec())
    s.append(SoftmaxSpec())
    return NetworkDef(tuple(s), width=width, height=height)
