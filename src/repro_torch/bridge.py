"""Carry weights from the reference package into the port, as numpy.

The reference initialises its models with ``jax.random``, which torch
cannot reproduce, so parity runs start both packages from the same
weights and settings: the caller converts the reference's trees to numpy
(and its dataclasses to dicts) and these functions build the port's
counterparts from them.  bf16 leaves arrive as numpy's bfloat16 (the
``ml_dtypes`` type JAX hands out) and cross by their bits.  Nothing here
imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.qtensor import QTensor
from repro_torch.kernels import quant_matmul as qmk


def _tensor(v, device):
    v = np.array(v, copy=True)
    if v.dtype.name == "bfloat16":          # numpy's bf16 (ml_dtypes): by its bits
        return torch.from_numpy(v.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(v).to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def params_from_numpy(params: dict, nas: dict, device="cpu") -> tuple:
    """The reference engine's ``params`` and ``nas`` trees (numpy leaves)
    as the port's trees: same keys (``w``, ``aw``, ``ax``, ``b``, BN
    ``scale``/``bias``, ``gamma``, ``delta``) and the same dict order."""
    return _tree(params, device), _tree(nas, device)


def search_settings_from_fields(fields: dict):
    """The port's ``SearchSettings`` from the reference's field values
    (``dataclasses.asdict`` of its ``SearchSettings``: ``cfg`` as a dict of
    ``MixedPrecConfig`` fields, every other field a Python value)."""
    from repro_torch.core.mixedprec import MixedPrecConfig
    from repro_torch.core.search import SearchSettings
    cfg = dict(fields["cfg"])
    for key in ("weight_bits", "act_bits"):
        cfg[key] = tuple(int(b) for b in cfg[key])
    return SearchSettings(**{**fields, "cfg": MixedPrecConfig(**cfg)})


def qtensor_from_numpy(fields: dict, device="cpu") -> QTensor:
    """A port ``QTensor`` from a reference QTensor's numpy leaves and aux
    (``fields`` keyed by the reference's dataclass field names).  An expert
    stack (``experts`` set) keeps its leading expert axis on every leaf but
    the output gather, as the reference does."""

    def opt(key, dtype=None):
        v = fields.get(key)
        if v is None:
            return None
        t = _tensor(v, device)
        return t if dtype is None else t.to(dtype)

    tile_bits = fields.get("tile_bits")
    tile_n = fields.get("tile_n")
    table = None
    if tile_bits is not None:
        Kp = -(-int(fields["c_in"]) // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
        table = qmk.fused_table(tuple(tile_bits), Kp, int(tile_n)).to(device)
    kernel_shape = fields.get("kernel_shape")
    return QTensor(
        packed=tuple(_tensor(p, device) for p in fields["packed"]),
        scales=tuple(_tensor(s, device) for s in fields["scales"]),
        inv_perm=opt("inv_perm", torch.int64),
        bits=tuple(int(b) for b in fields["bits"]),
        c_out=int(fields["c_out"]), c_in=int(fields["c_in"]),
        act_bits=int(fields.get("act_bits", 8)),
        act_scale=float(fields.get("act_scale", 1.0)),
        kernel_shape=None if kernel_shape is None else tuple(kernel_shape),
        restore_order=bool(fields.get("restore_order", True)),
        fused_packed=opt("fused_packed"), fused_scales=opt("fused_scales"),
        fused_perm=opt("fused_perm", torch.int64),
        tile_bits=None if tile_bits is None else tuple(int(b) for b in tile_bits),
        tile_n=None if tile_n is None else int(tile_n),
        fused_table=table,
        experts=None if fields.get("experts") is None else int(fields["experts"]))


def _is_qtensor_fields(v) -> bool:
    return isinstance(v, dict) and "packed" in v and "tile_bits" in v


def _lm_tree(tree, device):
    if _is_qtensor_fields(tree):
        return qtensor_from_numpy(tree, device)
    if isinstance(tree, dict):
        return {k: _lm_tree(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _layer(tree, i):
    """Layer ``i`` of a tree whose array leaves are stacked per layer (a
    QTensor's static fields are shared by every layer)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_layer(v, i) for v in tree)
    if isinstance(tree, np.ndarray):
        return tree[i]
    return tree


def deployed_lm_from_numpy(tree: dict, device="cpu") -> dict:
    """The reference's deployed LM tree (``serving.init_deployed_model``,
    dense or MoE family) as the port's: ``{"embed", "blocks", "ln_f",
    "lm_head"}`` with the bf16 embedding, norms, biases and MoE router, and
    every deployed linear a QTensor (its fused layout and ``fused_table``
    too; MoE expert weights as expert stacks).  ``tree`` has numpy leaves
    and each reference QTensor as its ``{field: value}`` dict (numpy
    leaves); the reference stacks the blocks along a leading layer axis,
    the port keeps a list of per-layer dicts."""
    blocks = tree["blocks"]
    n_layers = len(blocks["ln1"]["scale"])
    out = {k: _lm_tree(v, device) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_lm_tree(_layer(blocks, i), device) for i in range(n_layers)]
    return out


def caches_from_numpy(tree: dict, device="cpu") -> dict:
    """The reference's dense-ring serving caches (GQA's ``{"k", "v",
    "k_scale", "v_scale"}`` or MLA's ``{"ckv", "ckv_scale", "krope"}``,
    stacked per layer) as the port's: the same layout."""
    return {k: _tensor(v, device) for k, v in tree.items()}
