"""Paper experiment flow on one MLPerf-Tiny task: channel-wise (ours) vs
EdMIPS (layer-wise) under the identical protocol, one lambda.

This is the per-point unit of Fig. 3 (a sweep of lambda traces whole
fronts).

Run:  PYTHONPATH=src python examples_torch/search_tinyml.py [task] [lambda] [--device cpu]
      task in {resnet8-cifar10, dscnn-kws, mobilenetv1-vww, dae-ad}
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.api import PrecisionPolicy
from repro_torch.api.engine import resolve_device
from repro_torch.core import edmips, regularizers as reg, search
from repro_torch.data import pipeline as pipe
from repro_torch.models import tinyml


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("task", nargs="?", default="dscnn-kws", choices=list(tinyml.TINY_CONFIGS))
    p.add_argument("lam", nargs="?", type=float, default=1e-5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for a CPU run)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    task, lam = args.task, args.lam
    out = {}

    for method, qcfg in [("channel-wise (ours)", edmips.channelwise_config()),
                         ("EdMIPS (layer-wise)", edmips.edmips_config())]:
        cfg = dataclasses.replace(tinyml.TINY_CONFIGS[task], quant=qcfg)
        init_fn, apply_fn, specs = tinyml.build(cfg)
        params, nas = init_fn(torch.Generator().manual_seed(0))
        data = pipe.SyntheticTiny(cfg, n=128, seed=0)
        settings = search.SearchSettings(
            cfg=qcfg, objective="energy", lam=lam, lut_name="mpic",
            warmup_epochs=1, search_epochs=3, finetune_epochs=1)
        res = search.run_search(apply_fn, lambda p, b: tinyml.task_loss(cfg, p, b),
                                specs, params, nas, lambda: data.batches(16), settings,
                                device=device)
        scores = []
        with torch.no_grad():
            for b in data.batches(32, seed=7):
                b = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
                pred = apply_fn(res.params, res.nas, PrecisionPolicy.FROZEN, b)
                scores.append(float(tinyml.task_metric(cfg, pred, b)))
        size = reg.discrete_size_bits(res.nas, specs, qcfg)
        energy = reg.discrete_energy(res.nas, specs, qcfg, "mpic")
        print(f"{method:22s} task={task} lam={lam:g} "
              f"metric={np.mean(scores):.4f} size={size / 8e3:.1f}KB "
              f"energy={energy:.3g}")
        out[method] = {"metric": float(np.mean(scores)), "size_kb": size / 8e3,
                       "energy": energy}
    return out


if __name__ == "__main__":
    main()
