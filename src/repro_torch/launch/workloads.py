"""Workload builders: (arch x shape) -> step function + fake-tensor args +
shardings for a given mesh.

Counterpart of ``repro.launch.workloads``, consumed by the dry run
(``launch/dryrun.py``):

  train_4k     -> ``train_step``   the paper's search-phase W update (DNAS
                  mixture forward + CE + optimizer), the dominant workload.
  prefill_32k  -> ``prefill``      the deployed mixed-precision model over
                  the full sequence, building the int8 KV cache.
  decode_32k / long_500k -> ``decode_step``  one new token against a
                  seq_len-deep cache (the bandwidth-bound serving workload,
                  where the searched bit-widths set the bytes a step reads).

Where the reference builds ``ShapeDtypeStruct`` trees with
``jax.eval_shape``, the args here are fake tensors made under one
``FakeTensorMode`` (``Workload.mode``): shapes, dtypes and a device, no
memory.  The trees are drawn on the CPU inside the mode, from a
``torch.Generator`` (a fake tensor needs no card to be drawn), then moved
to :func:`card_device`, so the steps take the card's branches (the
kernels' APIs, K4 over a packed cache, the tensor-core sums).  A kernel
wrapper given a fake tensor launches nothing (``kernels/_build.is_fake``).

Nothing here allocates a parameter or an activation.  The reference's
``lower`` has no counterpart: :func:`trace` runs the step once under the
cost counter of ``launch/costs.py`` and returns its ``Costs``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.dist import sharding as shd
from repro_torch.launch import costs as costs_mod
from repro_torch.launch.shapes import SHAPES, ShapeSpec
from repro_torch.models import serving
from repro_torch.train import steps as steps_mod


@dataclasses.dataclass
class Workload:
    name: str                      # "<arch>/<shape>"
    kind: str                      # train | prefill | decode
    fn: Callable                   # positional-args step function
    args: tuple                    # fake-tensor trees
    mode: FakeTensorMode           # the mode ``args`` live in
    donate: tuple = ()             # args the step updates in place
    tokens_per_step: int = 0       # for MODEL_FLOPS accounting


def card_device() -> torch.device:
    """The device the fake trees live on: the card (``cuda:0``) where
    PyTorch is built with CUDA.  A CPU-only build cannot index a fake CUDA
    tensor (its device guard raises "not linked with support for cuda
    devices"), so there it is ``meta``, which takes the same branches:
    every device branch of the port tests ``device.type == "cpu"``."""
    return torch.device("cuda", 0) if torch.version.cuda else torch.device("meta")


def to_device(tree, device):
    """``tree`` (dicts, lists, tuples of tensors and QTensors) on
    ``device``; other leaves as they are."""
    from repro_torch.api.qtensor import QTensor
    if isinstance(tree, (torch.Tensor, QTensor)):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree


def batch_struct(cfg, spec: ShapeSpec, device=None) -> dict:
    """One *global* training/prefill batch of fake (or, outside a fake
    mode, empty) tensors."""
    B, S = spec.global_batch, spec.seq_len
    device = card_device() if device is None else device
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32, device=device)}
    if spec.kind == "train":
        batch["labels"] = torch.zeros((B, S), dtype=torch.int32, device=device)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model), device=device)
    if cfg.family == "vlm" and cfg.n_prefix_tokens:
        batch["prefix_embeds"] = torch.zeros((B, cfg.n_prefix_tokens, cfg.d_model),
                                             device=device)
    return batch


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def make_train_workload(cfg, spec: ShapeSpec,
                        hp: Optional[steps_mod.TrainHParams] = None) -> Workload:
    hp = hp or steps_mod.TrainHParams.for_arch(cfg)
    mode, dev = FakeTensorMode(allow_non_fake_inputs=True), card_device()
    with mode:
        state = to_device(steps_mod.init_train_state(cfg, hp, 0, device="cpu"), dev)
        batch = batch_struct(cfg, spec, dev)
    step = steps_mod.make_train_step(cfg, hp)
    return Workload(name=f"{cfg.name}/{spec.name}", kind="train", fn=step,
                    args=(state, batch), mode=mode, donate=(0,),
                    tokens_per_step=spec.global_batch * spec.seq_len)


def _deployed(cfg, mode, dev) -> dict:
    with mode:
        return to_device(serving.init_deployed_model(cfg, 0, device="cpu"), dev)


def make_prefill_workload(cfg, spec: ShapeSpec) -> Workload:
    mode, dev = FakeTensorMode(allow_non_fake_inputs=True), card_device()
    dparams = _deployed(cfg, mode, dev)
    with mode:
        batch = batch_struct(cfg, spec, dev)

    def prefill_fn(dp, b):
        return serving.prefill(dp, cfg, b)

    return Workload(name=f"{cfg.name}/{spec.name}", kind="prefill", fn=prefill_fn,
                    args=(dparams, batch), mode=mode,
                    tokens_per_step=spec.global_batch * spec.seq_len)


def make_decode_workload(cfg, spec: ShapeSpec) -> Workload:
    B, S = spec.global_batch, spec.seq_len
    mode, dev = FakeTensorMode(allow_non_fake_inputs=True), card_device()
    dparams = _deployed(cfg, mode, dev)
    with mode:
        caches = to_device(serving.init_caches(cfg, B, S, device="cpu"), dev)
        tokens = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        pos = torch.zeros((), dtype=torch.int32, device=dev)

    def decode_fn(dp, tok, c, p):
        return serving.decode_step(dp, cfg, tok, c, p)

    return Workload(name=f"{cfg.name}/{spec.name}", kind="decode", fn=decode_fn,
                    args=(dparams, tokens, caches, pos), mode=mode, donate=(2,),
                    tokens_per_step=B)


def build(cfg, shape_name: str, hp: Optional[steps_mod.TrainHParams] = None) -> Workload:
    spec = SHAPES[shape_name]
    if spec.kind == "train":
        return make_train_workload(cfg, spec, hp)
    if spec.kind == "prefill":
        return make_prefill_workload(cfg, spec)
    if spec.kind == "decode":
        return make_decode_workload(cfg, spec)
    raise ValueError(spec.kind)


# ---------------------------------------------------------------------------
# Shardings and the count
# ---------------------------------------------------------------------------

def shardings_for(wl: Workload, mesh, fsdp: bool = True) -> tuple:
    """The specs of ``wl.args`` on ``mesh`` (a tree like each arg: a tuple
    of axis names per tensor, ``{sub-path: spec}`` per QTensor)."""
    rules = shd.ShardingRules(mesh, fsdp=fsdp)
    if wl.kind == "train":
        state, batch = wl.args
        return (rules.tree_shardings(state), shd.batch_specs(mesh, batch))
    if wl.kind == "prefill":
        dparams, batch = wl.args
        return (rules.tree_shardings(dparams), shd.batch_specs(mesh, batch))
    if wl.kind == "decode":
        dparams, tokens, caches, pos = wl.args
        return (rules.tree_shardings(dparams), shd.batch_specs(mesh, tokens),
                rules.tree_shardings(caches), ())
    raise ValueError(wl.kind)


def trace(wl: Workload) -> costs_mod.Costs:
    """Run ``wl.fn(*wl.args)`` once, inside the workload's fake mode, under
    the cost counter; the step's ``Costs`` (the whole step in one process).
    The step updates its donated args in place, as on the card."""
    with wl.mode, costs_mod.counting() as c:
        wl.fn(*wl.args)
    return c
