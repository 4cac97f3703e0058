"""Quickstart: the paper's pipeline end to end, on the card.

1. Build a small FC model (the AD autoencoder family) with channel-wise
   mixed-precision search sites, wrapped in the `repro_torch.api.Engine`
   facade.
2. Run Alg. 1 (warmup -> DNAS search -> fine-tune) against the Eq. 7
   model-size regularizer.
3. Inspect the learned per-channel bit-widths.
4. Deploy (Sec. III-C): every searched weight becomes a packed `QTensor`,
   then serve the deployed model and verify it computes the same function
   as the frozen (argmax fake-quant) reference.
5. Packed conv forward: a ResNet-8 deploys and serves through the im2col
   patch-GEMM conv path (`QTensor.conv2d` -> the fused CUDA kernel); no
   dense kernel is materialized.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import Engine, PrecisionPolicy
from repro_torch.core import mixedprec as mp
from repro_torch.core import regularizers as reg
from repro_torch.core import search
from repro_torch.data import pipeline as pipe
from repro_torch.kernels import ops as kops
from repro_torch.models import tinyml


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for a CPU run)")
    args = p.parse_args(argv)
    # the FROZEN reference's convolutions in f32: on the card cuDNN would
    # otherwise run them in TF32, far coarser than the packed kernels' sums
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}

    # 1. model + data + engine ------------------------------------------------
    cfg = tinyml.TINY_CONFIGS["dae-ad"]
    settings = search.SearchSettings(
        cfg=cfg.quant, objective="size", lam=3e-5,
        warmup_epochs=1, search_epochs=4, finetune_epochs=1)
    eng = Engine.for_tinyml(cfg, settings, seed=0, device=args.device)
    data = pipe.SyntheticTiny(cfg, n=128, seed=0)
    epochs = lambda: data.batches(16)

    # 2. Alg. 1 via the engine facade ------------------------------------------
    eng.search(epochs).finetune(epochs)
    print("search history:")
    for h in eng.history:
        print("  ", h)
    out["history"] = list(eng.history)

    # 3. learned assignment -----------------------------------------------------
    print("\nper-channel bit-widths (first FC layer):")
    site = sorted(eng.nas)[0]
    bits = mp.argmax_weight_bits(eng.nas[site]["gamma"], cfg.quant)
    uniq, counts = np.unique(bits.cpu().numpy(), return_counts=True)
    print(f"  {site}: " + ", ".join(f"{c} ch @ {b}b" for b, c in zip(uniq, counts)))
    specs = eng.specs
    size_bits = reg.discrete_size_bits(eng.nas, specs, cfg.quant)
    base_kb = sum(s.weights_per_channel * s.c_out for s in specs.values()) / 1e3
    print(f"  total model size: {size_bits / 8e3:.1f} KB (all-8b baseline: {base_kb:.1f} KB)")
    out.update(site=site, bit_counts={int(b): int(c) for b, c in zip(uniq, counts)},
               size_kb=size_bits / 8e3, all8_kb=base_kb)

    # 4. deploy + serve + verify ------------------------------------------------
    eng.deploy(align=1)
    print(f"\ndeployed model: {eng.memory_bits() / 8e3:.1f} KB packed")
    qt = eng.deployed_params[site]["w"]
    print("deployed groups: " + ", ".join(
        f"{n} rows @ {b}b" for b, n in sorted(qt.group_sizes.items())))
    out["deployed_kb"] = eng.memory_bits() / 8e3

    batch = next(iter(data.batches(16, seed=7)))
    served = eng.serve(batch, backend="cuda")        # the fused kernel, one launch a layer
    frozen = eng.forward(batch, PrecisionPolicy.FROZEN)
    err = float(torch.max(torch.abs(served - frozen)))
    print(f"\n|served (deployed, CUDA kernel) - frozen reference| max = {err:.2e}")
    out["served_frozen_err"] = err
    out["frozen_absmax"] = float(torch.max(torch.abs(frozen)))

    # 5. packed conv forward: ResNet-8 through the im2col patch-GEMM path -----
    conv_cfg = tinyml.TINY_CONFIGS["resnet8-cifar10"]
    conv_eng = Engine.for_tinyml(conv_cfg, seed=1, device=args.device)
    conv_eng.randomize_nas(1)   # mixed per-channel groups without a search
    conv_eng.deploy(align=1)
    conv_batch = next(iter(pipe.SyntheticTiny(conv_cfg, n=8, seed=1).batches(4)))
    conv_served = conv_eng.serve(conv_batch, backend="cuda")
    conv_frozen = conv_eng.forward(conv_batch, PrecisionPolicy.FROZEN)
    conv_err = float(torch.max(torch.abs(conv_served - conv_frozen)))
    print(f"\nresnet8 packed conv (CUDA, {conv_eng.memory_bits() / 8e3:.1f} KB):"
          f" |served - frozen| max = {conv_err:.2e}")
    out["conv_served_frozen_err"] = conv_err
    out["conv_frozen_absmax"] = float(torch.max(torch.abs(conv_frozen)))

    # the tile-aligned deploy serves every linear/conv as ONE fused
    # multi-precision kernel launch (vs one per precision group); a count
    # at run time: the plain versions on the CPU launch nothing
    out["launches"] = {}
    for bk in ("cuda", "cuda-pergroup"):
        n = kops.count_launches(conv_eng.serve, conv_batch, backend=bk)
        print(f"  kernel launches per forward [{bk}]: {sum(n.values())} {n}")
        out["launches"][bk] = n
    out["conv_layers"] = len(conv_eng.nas)          # deployed sites, one GEMM each
    return out


if __name__ == "__main__":
    main()
