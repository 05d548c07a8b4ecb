"""Integer-program serialization: the deployment artifact.

Saves a converted IntProgram (uint8/int32 arrays + static layer config +
model topology) as one .npz plus a JSON manifest, so serving hosts load the
ready-to-run integer model without the float checkpoint or a conversion step
— the role the reference's quantized .weights file plays for its CPU binary
(src/parser.c quant blocks), but self-describing (topology travels with it).
"""

from __future__ import annotations

import dataclasses
import json
import zipfile

import numpy as np

from yoloq.infer.convert import IntProgram, QuantizedLayerCfg
from yoloq.nn import graph as G

_SPEC_TYPES = {
    cls.__name__: cls
    for cls in (
        G.ConvSpec, G.MaxPoolSpec, G.RouteSpec, G.UpsampleSpec, G.ShortcutSpec,
        G.YoloSpec, G.ConnectedSpec, G.SoftmaxSpec, G.AvgPoolSpec,
        G.DropoutSpec, G.CropSpec, G.LocalSpec, G.DeconvSpec, G.ReorgSpec,
        G.LRNSpec, G.L2NormSpec, G.LogisticSpec, G.ActivationSpec,
        G.BatchNormSpec, G.RegionSpec, G.DetectionSpec,
    )
}


def _spec_to_json(spec) -> dict:
    d = dataclasses.asdict(spec)
    d["__type__"] = type(spec).__name__
    return d


def _spec_from_json(d: dict):
    d = dict(d)
    cls = _SPEC_TYPES[d.pop("__type__")]
    for f in dataclasses.fields(cls):
        if f.name in d and isinstance(d[f.name], list):
            d[f.name] = tuple(
                tuple(x) if isinstance(x, list) else x for x in d[f.name]
            )
    return cls(**d)


def save_program(path: str, program: IntProgram) -> None:
    manifest = {
        "format": "yoloq-intprogram-v1",
        "net": {
            "width": program.net.width,
            "height": program.net.height,
            "channels": program.net.channels,
            "specs": [_spec_to_json(s) for s in program.net.specs],
        },
        "in_scale": program.in_scale,
        "in_zp": program.in_zp,
        "cfg": [
            {
                "kind": c.kind,
                "out_scale": c.out_scale,
                "out_zp": c.out_zp,
                "act": c.act,
                "quant_stop": c.quant_stop,
                "symmetric_w": c.symmetric_w,
                "branches": c.branches,
                "in_scales": c.in_scales,
            }
            for c in program.cfg
        ],
    }
    arrays = {
        f"{i}/{name}": arr
        for i, layer in program.arrays.items()
        for name, arr in layer.items()
    }
    np.savez_compressed(path, __manifest__=json.dumps(manifest), **arrays)


def load_program(path: str) -> IntProgram:
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"]))
        if manifest.get("format") != "yoloq-intprogram-v1":
            raise ValueError(f"not a yoloq integer program: {path}")
        arrays: dict[int, dict[str, np.ndarray]] = {}
        for key in z.files:
            if key == "__manifest__":
                continue
            i, name = key.split("/", 1)
            arrays.setdefault(int(i), {})[name] = z[key]
    net = G.NetworkDef(
        specs=tuple(_spec_from_json(s) for s in manifest["net"]["specs"]),
        width=manifest["net"]["width"],
        height=manifest["net"]["height"],
        channels=manifest["net"]["channels"],
    )

    def _tupify(v):
        return tuple(_tupify(x) if isinstance(x, list) else x for x in v)

    cfg = []
    for spec, c in zip(net.specs, manifest["cfg"]):
        cfg.append(
            QuantizedLayerCfg(
                kind=c["kind"],
                spec=spec,
                out_scale=c["out_scale"],
                out_zp=c["out_zp"],
                act=c["act"],
                quant_stop=c["quant_stop"],
                symmetric_w=c["symmetric_w"],
                branches=_tupify(c["branches"]),
                in_scales=_tupify(c["in_scales"]),
            )
        )
    return IntProgram(
        net=net, cfg=cfg, arrays=arrays,
        in_scale=manifest["in_scale"], in_zp=manifest["in_zp"],
    )
