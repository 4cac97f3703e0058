"""The paper's four MLPerf-Tiny benchmark models (Sec. IV-A), PyTorch.

Counterpart of ``repro.models.tinyml``:

  IC  — ResNet-8 on CIFAR-10 (32x32x3)
  KWS — DS-CNN on Speech Commands (49x10x1; conv + 4x depthwise-separable)
  VWW — MobileNetV1 width 0.25 (96x96x3)
  AD  — Dense autoencoder on DCASE2020 ToyCar (640-d)

Each model is an op list run by a small interpreter that gives init,
quantization-aware apply and the per-layer ``LayerCostSpec`` from one
description.  ``apply_fn(params, nas, policy, batch)`` takes a
:class:`PrecisionPolicy`; with ``QTensor`` weight leaves (``Engine.deploy``)
and ``PrecisionPolicy.deployed(backend)`` the same interpreter serves the
packed model.  Activations are NHWC.  BatchNorm is the folded per-channel
scale+bias.  Site names and the dict insertion order (conv, then a
resblock's ``n1``, ``n2``, ``nshort``, then fc) match the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import mixedprec as mp
from repro_torch.core.regularizers import LayerCostSpec
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class TinyConfig:
    name: str
    task: str                    # ic | kws | vww | ad
    input_shape: tuple           # (H, W, C) or (D,) for AD
    n_classes: int
    quant: mp.MixedPrecConfig = dataclasses.field(
        default_factory=lambda: mp.MixedPrecConfig())
    width_mult: float = 1.0


def resnet8_ops():
    return [
        ("conv", dict(cout=16, k=3, s=1)), ("bn",), ("relu",),
        ("resblock", dict(cout=16, s=1)),
        ("resblock", dict(cout=32, s=2)),
        ("resblock", dict(cout=64, s=2)),
        ("gap",),
        ("fc", dict(cout=10)),
    ]


def dscnn_ops():
    seq = [("conv", dict(cout=64, k=(10, 4), s=2)), ("bn",), ("relu",)]
    for _ in range(4):
        seq += [("dwconv", dict(k=3, s=1)), ("bn",), ("relu",),
                ("conv", dict(cout=64, k=1, s=1)), ("bn",), ("relu",)]
    seq += [("gap",), ("fc", dict(cout=12))]
    return seq


def mobilenetv1_ops(width=0.25):
    def c(ch):
        return max(8, int(ch * width))
    seq = [("conv", dict(cout=c(32), k=3, s=2)), ("bn",), ("relu",)]
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
            (1024, 1)]
    for ch, s in plan:
        seq += [("dwconv", dict(k=3, s=s)), ("bn",), ("relu",),
                ("conv", dict(cout=c(ch), k=1, s=1)), ("bn",), ("relu",)]
    seq += [("gap",), ("fc", dict(cout=2))]
    return seq


def dae_ops():
    seq = []
    for _ in range(4):
        seq += [("fc", dict(cout=128)), ("bn",), ("relu",)]
    seq += [("fc", dict(cout=8)), ("bn",), ("relu",)]
    for _ in range(4):
        seq += [("fc", dict(cout=128)), ("bn",), ("relu",)]
    seq += [("fc", dict(cout=640))]
    return seq


OPS_FOR = {"ic": resnet8_ops, "kws": dscnn_ops,
           "vww": lambda: mobilenetv1_ops(0.25), "ad": dae_ops}


def _norm_k(k):
    return (k, k) if isinstance(k, int) else k


def build(cfg: TinyConfig):
    """Returns ``(init_fn(gen) -> (params, nas), apply_fn, specs)``.

    ``init_fn`` draws every weight from the ``torch.Generator`` it is given,
    on the CPU; :meth:`Engine.for_tinyml` moves the trees to the device.
    """
    ops = OPS_FOR[cfg.task]()
    specs: dict[str, LayerCostSpec] = {}
    geom = []
    if len(cfg.input_shape) == 3:
        h, w, c = cfg.input_shape
    else:
        h, w, c = 1, 1, cfg.input_shape[0]
    idx = 0

    def reg_conv(name, cin, cout, kh, kw, ho, wo):
        specs[name] = LayerCostSpec(name=name, c_out=cout,
                                    weights_per_channel=cin * kh * kw,
                                    ops=cout * cin * kh * kw * ho * wo)

    for op, *rest in ops:
        arg = rest[0] if rest else {}
        if op == "conv":
            kh, kw = _norm_k(arg["k"])
            s = arg["s"]
            ho, wo = math.ceil(h / s), math.ceil(w / s)
            name = f"conv{idx}"
            reg_conv(name, c, arg["cout"], kh, kw, ho, wo)
            geom.append((op, dict(name=name, cin=c, cout=arg["cout"],
                                  k=(kh, kw), s=s)))
            h, w, c = ho, wo, arg["cout"]
            idx += 1
        elif op == "dwconv":
            kh, kw = _norm_k(arg["k"])
            s = arg["s"]
            ho, wo = math.ceil(h / s), math.ceil(w / s)
            name = f"dwconv{idx}"
            specs[name] = LayerCostSpec(name=name, c_out=c,
                                        weights_per_channel=kh * kw,
                                        ops=c * kh * kw * ho * wo)
            geom.append((op, dict(name=name, cin=c, cout=c, k=(kh, kw), s=s)))
            h, w = ho, wo
            idx += 1
        elif op == "resblock":
            cout, s = arg["cout"], arg["s"]
            ho, wo = math.ceil(h / s), math.ceil(w / s)
            n1, n2 = f"conv{idx}", f"conv{idx + 1}"
            reg_conv(n1, c, cout, 3, 3, ho, wo)
            reg_conv(n2, cout, cout, 3, 3, ho, wo)
            rec = dict(n1=n1, n2=n2, cin=c, cout=cout, s=s)
            idx += 2
            if s != 1 or c != cout:
                ns = f"conv{idx}"
                reg_conv(ns, c, cout, 1, 1, ho, wo)
                rec["nshort"] = ns
                idx += 1
            geom.append((op, rec))
            h, w, c = ho, wo, cout
        elif op == "fc":
            name = f"fc{idx}"
            cin = c * h * w if (h > 1 or w > 1) else c
            specs[name] = LayerCostSpec(name=name, c_out=arg["cout"],
                                        weights_per_channel=cin,
                                        ops=arg["cout"] * cin)
            geom.append((op, dict(name=name, cin=cin, cout=arg["cout"])))
            h, w, c = 1, 1, arg["cout"]
            idx += 1
        elif op in ("bn", "relu", "gap"):
            if op == "gap":
                h, w = 1, 1
            geom.append((op, dict(c=c)))
        else:
            raise ValueError(op)

    def init_fn(gen: torch.Generator):
        params, nas = {}, {}
        bn_i = 0
        for op, g in geom:
            if op == "conv":
                params[g["name"]] = L.conv2d_init(gen, g["cin"], g["cout"],
                                                  *g["k"], bias=False)
                nas[g["name"]] = L.nas_init(g["cout"], cfg.quant)
            elif op == "dwconv":
                params[g["name"]] = L.conv2d_init(gen, g["cin"], g["cout"],
                                                  *g["k"], bias=False,
                                                  groups=g["cin"])
                nas[g["name"]] = L.nas_init(g["cout"], cfg.quant)
            elif op == "resblock":
                params[g["n1"]] = L.conv2d_init(gen, g["cin"], g["cout"], 3, 3,
                                                bias=False)
                nas[g["n1"]] = L.nas_init(g["cout"], cfg.quant)
                params[g["n2"]] = L.conv2d_init(gen, g["cout"], g["cout"], 3, 3,
                                                bias=False)
                nas[g["n2"]] = L.nas_init(g["cout"], cfg.quant)
                params[g["n1"] + "_bn"] = _bn_init(g["cout"])
                params[g["n2"] + "_bn"] = _bn_init(g["cout"])
                if "nshort" in g:
                    params[g["nshort"]] = L.conv2d_init(gen, g["cin"],
                                                        g["cout"], 1, 1,
                                                        bias=False)
                    nas[g["nshort"]] = L.nas_init(g["cout"], cfg.quant)
                    params[g["nshort"] + "_bn"] = _bn_init(g["cout"])
            elif op == "fc":
                params[g["name"]] = L.linear_init(gen, g["cin"], g["cout"],
                                                  bias=True)
                nas[g["name"]] = L.nas_init(g["cout"], cfg.quant)
            elif op == "bn":
                params[f"bn{bn_i}"] = _bn_init(g["c"])
                bn_i += 1
        return params, nas

    def apply_fn(params, nas, policy, batch):
        x = batch["x"]
        if len(cfg.input_shape) == 1 and x.ndim == 2:
            x = x[:, None, None, :]          # AD vectors as 1x1 images
        getn = (lambda n: nas[n]) if nas is not None else (lambda n: None)
        bn_i = 0
        for op, g in geom:
            if op == "conv":
                x = L.qconv2d(x, params[g["name"]], getn(g["name"]),
                              policy, cfg.quant, stride=g["s"])
            elif op == "dwconv":
                x = L.qconv2d(x, params[g["name"]], getn(g["name"]),
                              policy, cfg.quant, stride=g["s"],
                              groups=g["cin"])
            elif op == "resblock":
                sc = x
                h1 = L.qconv2d(x, params[g["n1"]], getn(g["n1"]), policy,
                               cfg.quant, stride=g["s"])
                h1 = torch.relu(_bn(h1, params[g["n1"] + "_bn"]))
                h2 = L.qconv2d(h1, params[g["n2"]], getn(g["n2"]), policy,
                               cfg.quant)
                h2 = _bn(h2, params[g["n2"] + "_bn"])
                if "nshort" in g:
                    sc = L.qconv2d(sc, params[g["nshort"]], getn(g["nshort"]),
                                   policy, cfg.quant, stride=g["s"])
                    sc = _bn(sc, params[g["nshort"] + "_bn"])
                x = torch.relu(h2 + sc)
            elif op == "fc":
                if x.ndim == 4:
                    x = x.reshape(x.shape[0], -1)
                x = L.qlinear(x, params[g["name"]], getn(g["name"]),
                              policy, cfg.quant, signed_act=False)
            elif op == "bn":
                x = _bn(x, params[f"bn{bn_i}"])
                bn_i += 1
            elif op == "relu":
                x = torch.relu(x)
            elif op == "gap":
                x = torch.mean(x, dim=(1, 2), keepdim=True)
        return x

    return init_fn, apply_fn, specs


def _bn_init(c: int) -> dict:
    return {"scale": torch.ones((c,)), "bias": torch.zeros((c,))}


def _bn(x, p):
    return x * p["scale"] + p["bias"]


def task_loss(cfg: TinyConfig, pred: torch.Tensor, batch: dict) -> torch.Tensor:
    if cfg.task == "ad":                      # reconstruction MSE
        return torch.mean(torch.square(pred - batch["x"].reshape(pred.shape)))
    logp = torch.log_softmax(pred.reshape(pred.shape[0], -1), dim=-1)
    return -torch.mean(torch.gather(logp, 1, batch["y"].long()[:, None]))


def task_metric(cfg: TinyConfig, pred: torch.Tensor, batch: dict) -> torch.Tensor:
    if cfg.task == "ad":                      # higher = better (neg. error)
        return -torch.mean(torch.square(pred - batch["x"].reshape(pred.shape)))
    logits = pred.reshape(pred.shape[0], -1)
    return torch.mean((torch.argmax(logits, -1) == batch["y"]).to(torch.float32))


TINY_CONFIGS = {
    "resnet8-cifar10": TinyConfig("resnet8-cifar10", "ic", (32, 32, 3), 10),
    "dscnn-kws": TinyConfig("dscnn-kws", "kws", (49, 10, 1), 12),
    "mobilenetv1-vww": TinyConfig("mobilenetv1-vww", "vww", (96, 96, 3), 2,
                                  width_mult=0.25),
    "dae-ad": TinyConfig("dae-ad", "ad", (640,), 0),
}
