"""`Engine` — the lifecycle facade over Alg. 1 and the Sec. III-C deploy
(PyTorch).

Counterpart of ``repro.api.Engine``:

    cfg = tinyml.TINY_CONFIGS["resnet8-cifar10"]
    eng = Engine.for_tinyml(cfg, SearchSettings(cfg=cfg.quant, train_compute="int8"))
    eng.search(data_epochs)          # Alg. 1 warmup + DNAS search
    eng.finetune(data_epochs)        # Alg. 1 fine-tune (argmax frozen)
    eng.deploy(align=1)              # every searched w -> packed QTensor
    logits = eng.serve(batch)        # fused CUDA kernel, one launch per GEMM

``search`` and ``finetune`` run a :class:`repro_torch.core.search.SearchDriver`
that owns the params, the NAS logits and the optimizer states;
``train_compute="int8"`` sends every dense layer's three products through
the int8 CUDA kernel.  ``deploy`` turns each NAS site's float weight into a
:class:`QTensor` on the engine's device (reordered, packed sub-byte, with
the argmaxed activation quantization); everything else (biases, folded BN)
is kept as it is.  ``serve`` is the same ``apply_fn`` under
``PrecisionPolicy.deployed``.  ``randomize_nas`` stands in for a search
where a bench or test needs mixed precision groups without one.

The engine runs on the card unless the caller asks for another device:
``device=None`` means ``"cuda"``, and with no card that raises.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.api.policy import PrecisionPolicy


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``, which must exist; anything else as given."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the engine runs on the card; "
                           "pass device='cpu' to run on the CPU")
    return device


class Engine:
    def __init__(self, apply_fn: Callable, specs: dict, loss_fn: Callable,
                 params: dict, nas: dict, settings, quant_cfg, device=None):
        from repro_torch.core.search import SearchDriver
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.specs = specs
        self.quant_cfg = quant_cfg
        self.driver = SearchDriver(apply_fn, loss_fn, specs, params, nas,
                                   settings, device=self.device)
        self.deployed_params: Optional[dict] = None
        self.draft_params: Optional[dict] = None

    @classmethod
    def for_tinyml(cls, cfg, settings=None, params: Optional[dict] = None,
                   nas: Optional[dict] = None, seed: int = 0,
                   device=None) -> "Engine":
        """Engine over one MLPerf-Tiny task.  Weights come from a
        ``torch.Generator`` seeded with ``seed`` unless ``params``/``nas``
        are given (e.g. bridged from the reference); ``settings`` defaults
        to ``SearchSettings(cfg=cfg.quant)``."""
        from repro_torch.core.search import SearchSettings
        from repro_torch.models import tinyml
        device = resolve_device(device)
        init_fn, apply_fn, specs = tinyml.build(cfg)
        if params is None or nas is None:
            p0, n0 = init_fn(torch.Generator().manual_seed(seed))
            params = p0 if params is None else params
            nas = n0 if nas is None else nas
        settings = settings or SearchSettings(cfg=cfg.quant)
        loss_fn = lambda pred, batch: tinyml.task_loss(cfg, pred, batch)
        return cls(apply_fn, specs, loss_fn, params, nas, settings, cfg.quant,
                   device=device)

    # -- the training phases -------------------------------------------------
    @property
    def params(self) -> dict:
        return self.driver.params

    @property
    def nas(self) -> dict:
        return self.driver.nas

    @property
    def history(self) -> list:
        return self.driver.history

    def search(self, data_epochs: Callable[[], Iterable]) -> "Engine":
        """Alg. 1 phases 1 and 2: QAT warmup, then the DNAS search."""
        self.driver.warmup(data_epochs)
        self.driver.search(data_epochs)
        return self

    def finetune(self, data_epochs: Callable[[], Iterable],
                 epochs: Optional[int] = None) -> "Engine":
        """Alg. 1 phase 3: theta frozen (argmax), W trained."""
        self.driver.finetune(data_epochs, epochs=epochs)
        return self

    def result(self):
        return self.driver.result()

    def randomize_nas(self, seed: int = 0) -> "Engine":
        """Randomize the NAS logits in place (bench / demo / test utility):
        gives ``deploy`` genuinely mixed per-channel precision groups without
        a search.  Same numpy draws, in the same site order, as the
        reference, so both engines deploy the same assignment."""
        rng = np.random.default_rng(seed)
        for site in self.nas.values():
            g = rng.standard_normal(tuple(site["gamma"].shape)) * 3
            d = rng.standard_normal(tuple(site["delta"].shape))
            site["gamma"] = torch.from_numpy(g.astype(np.float32)).to(self.device)
            site["delta"] = torch.from_numpy(d.astype(np.float32)).to(self.device)
        return self

    def deploy(self, align: int = 1, tile_n="auto", draft_bits: Optional[int] = None) -> dict:
        """Sec. III-C offline transform: searched float weights -> QTensor.

        Channel order is restored after each matmul (``restore_order``), so
        BN, residuals and the next layer's ``c_in`` are untouched.
        ``tile_n`` (default ``"auto"``) builds the fused layout that serves
        every linear/conv GEMM as ONE kernel launch; depthwise sites
        (``dwconv*``) never read it and skip it.

        ``draft_bits`` deploys two policies from the one checkpoint: beside
        the searched tree (the verifier) every site's weight is also
        re-quantized to a uniform ``draft_bits`` assignment
        (``qtensor.requantize``), and the call returns ``{"verifier": tree,
        "draft": tree}`` (kept as ``deployed_params`` and ``draft_params``);
        the other leaves of a site (biases) are the verifier's own tensors.
        The speculative ``ServingEngine`` pairs such a draft with its
        verifier.
        """
        from repro_torch.api.qtensor import requantize
        from repro_torch.core import deploy as dpl
        if not any(n in self.nas for n in self.params):
            raise ValueError("no NAS site keys at the top level of the params "
                             "tree — Engine.deploy expects a flat site-keyed "
                             "model (tinyml)")
        deployed, draft = {}, {}
        for name, p in self.params.items():
            if name not in self.nas:
                deployed[name] = draft[name] = p
                continue
            nas = self.nas[name]
            qt = dpl.deploy_linear(
                p["w"].cpu().numpy(), nas["gamma"].cpu().numpy(),
                p["aw"].cpu().numpy(), nas["delta"].cpu().numpy(),
                float(p["ax"].cpu()), self.quant_cfg, align=align,
                restore_order=True,
                tile_n=None if name.startswith("dwconv") else tile_n)
            site = {k: v for k, v in p.items() if k not in ("aw", "ax")}
            site["w"] = qt.to(self.device)
            deployed[name] = site
            if draft_bits is not None:
                draft[name] = dict(site, w=requantize(site["w"], draft_bits))
        self.deployed_params = deployed
        self.draft_params = draft if draft_bits is not None else None
        if draft_bits is not None:
            return {"verifier": deployed, "draft": draft}
        return deployed

    def memory_bits(self) -> int:
        """Deployed model size in bits (sum over QTensor leaves)."""
        if self.deployed_params is None:
            raise RuntimeError("deploy() first")
        return sum(self.deployed_params[site]["w"].memory_bits for site in self.nas)

    def _batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    @torch.inference_mode()
    def forward(self, batch: dict, policy: PrecisionPolicy) -> torch.Tensor:
        """``apply_fn`` on the float params under ``policy`` (FLOAT, QAT8 or
        FROZEN — the FROZEN forward is the deployed path's reference)."""
        return self.apply_fn(self.params, self.nas, policy, self._batch(batch))

    @torch.inference_mode()
    def serve(self, batch: dict, backend: str = "cuda") -> torch.Tensor:
        """Deployed forward.  ``backend="cuda"`` serves every linear and
        dense conv as ONE fused kernel launch, ``"cuda-pergroup"`` as one
        launch per precision group, ``"torch"`` through the dense fall-back."""
        if self.deployed_params is None:
            raise RuntimeError("deploy() first")
        return self.apply_fn(self.deployed_params, None,
                             PrecisionPolicy.deployed(backend),
                             self._batch(batch))
