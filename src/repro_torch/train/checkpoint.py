"""Checkpoints of the training state, with an atomic commit.

PyTorch counterpart of ``repro.train.checkpoint``, with the same layout:

    <dir>/step_<N>/
        manifest.json   step, wall time, the leaf index and the caller's
                        ``meta`` (the data pipeline's position, the arch)
        shard_<host>.npz  every leaf, keyed by its path (``params/blocks/
                        attn/wq/w``); a bf16 leaf as its raw 16 bits under
                        ``<path>~bf16`` (npz has no bf16)

* A save writes ``step_<N>.tmp`` and renames it to ``step_<N>``: a crash
  mid-save leaves no directory that :meth:`CheckpointManager.latest_step`
  offers, so a restart finds the last complete state.
* Saves run on a background thread by default: the state is copied to
  host memory on the caller's thread, then serialized; ``block=True``
  waits for the commit.
* ``keep`` bounds the directories kept (the oldest go after a commit).

A state is a nested dict of tensors and Python numbers (the step); a
restore puts every tensor on the template's device in the template's dtype,
and every number back as the template's type, so a resumed run continues
bit for bit.  A state placed on a mesh (``dist/sharding.MeshContext.
put_train_state``) is saved whole, each :class:`~repro_torch.dist.sharding.
Shards` gathered, so the files keep the reference's layout and keys
whatever the mesh; ``restore(.., mesh=)`` places the loaded tree by that
mesh's rules (the reference's ``shardings=``), so a state saved on one
mesh restores on another.  Across processes (a state placed over a
``dist/collectives.Group``) every process calls :meth:`CheckpointManager.
save`, whose gather of each leaf onto the first process is a collective,
and only the manager made with ``writer=True`` (the first process's)
holds the state whole and writes the files, once; every process restores
its own row of blocks from them.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.sharding import Shards


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(v)


def _flatten(tree) -> dict:
    out = {}
    for key, leaf in _walk(tree):
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        out[key + ("~bf16" if bf16 else "")] = _to_numpy(leaf)
    return out


def _host_copy(tree, writer: bool = True):
    """The state's tensors copied to the host (the snapshot an async save
    serializes while training goes on), each placed leaf whole.  A leaf
    placed across processes is gathered onto the first process alone (the
    writer); a process that writes nothing takes part in those gathers
    and copies nothing."""
    if isinstance(tree, dict):
        return {k: _host_copy(v, writer) for k, v in tree.items()}
    if isinstance(tree, Shards):
        return tree.whole("cpu", root=0 if tree.group is not None else None)
    if not writer:
        return None
    return tree.detach().to("cpu", copy=True) if isinstance(tree, torch.Tensor) else tree


def _unflatten_into(template, loaded: dict, prefix="", host=False):
    """``loaded`` in ``template``'s structure and dtypes, on its devices (a
    placed leaf's first position), or on the host when ``host``."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, loaded, f"{prefix}/{k}" if prefix else str(k), host)
                for k, v in template.items()}
    if prefix + "~bf16" in loaded:
        arr = loaded[prefix + "~bf16"]
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    elif prefix in loaded:
        t = torch.from_numpy(np.array(loaded[prefix]))
    else:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    if not isinstance(template, (torch.Tensor, Shards)):
        return type(template)(t.item())
    if tuple(t.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {prefix}: checkpoint {tuple(t.shape)} "
                         f"vs model {tuple(template.shape)}")
    return t.to(device="cpu" if host else template.device, dtype=template.dtype)


def config_hash(cfg) -> str:
    return hashlib.sha1(repr(cfg).encode()).hexdigest()[:12]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, host_id: int = 0, writer: bool = True):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        self.writer = writer
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state: dict, meta: Optional[dict] = None,
             block: bool = False) -> None:
        """Save ``state`` (a nested dict of tensors and numbers) as step
        ``step`` with the JSON-serializable ``meta``; in the background
        unless ``block``.  A manager made with ``writer=False`` takes part in
        the gathers as every process must, and holds and writes nothing."""
        self.wait()   # never two saves at once
        host_state = _host_copy(state, self.writer)
        if not self.writer:
            return
        if block:
            self._save(step, host_state, meta or {})
        else:
            self._thread = threading.Thread(target=self._save,
                                            args=(step, host_state, meta or {}), daemon=True)
            self._thread.start()

    def _save(self, step: int, state, meta: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(state)
        np.savez(os.path.join(tmp, f"shard_{self.host_id}.npz"), **flat)
        manifest = {"step": step, "time": time.time(), "n_leaves": len(flat),
                    "leaves": sorted(flat), **meta}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)      # the atomic commit
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step:010d}", "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, template, mesh=None):
        """Step ``step`` in the structure and dtypes of ``template``: on
        its devices, or placed by ``mesh`` (a ``MeshContext``:
        ``put_train_state``, each block cut from the host copy)."""
        path = os.path.join(self.dir, f"step_{step:010d}", f"shard_{self.host_id}.npz")
        with np.load(path) as z:
            loaded = {k: z[k] for k in z.files}
        if mesh is None or not mesh.is_active:
            return _unflatten_into(template, loaded)
        return mesh.put_train_state(_unflatten_into(template, loaded, host=True))

    def restore_latest(self, template, mesh=None) -> tuple:
        """``(state, step, manifest)``, or ``(None, None, {})`` when no
        complete checkpoint exists; ``mesh`` as for :meth:`restore`."""
        step = self.latest_step()
        if step is None:
            return None, None, {}
        return self.restore(step, template, mesh), step, self.manifest(step)
