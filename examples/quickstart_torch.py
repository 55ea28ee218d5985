"""Quickstart on the PyTorch/CUDA port: build a graph index, search it
through the backend registry, anchor it against exact brute force, and run
one contrastive-RL iteration over the search module.  It follows
``examples/quickstart.py`` step for step.

    PYTHONPATH=src python examples/quickstart_torch.py                # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Runs on the CUDA card unless ``--device cpu`` is given (then the kernels'
plain versions run); without a card and without ``--device cpu`` it
raises.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.anns import Engine, SearchParams, make_dataset, registry
from repro_torch.anns.datasets import recall_at_k
from repro_torch.anns.engine import GLASS_BASELINE
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # --- 1. data + index -------------------------------------------------
    ds = make_dataset("sift-128-euclidean", n_base=3000, n_query=64,
                      device=device)
    print(f"dataset: {ds.base.shape[0]} base vectors, dim {ds.base.shape[1]}"
          f" on {device}")
    print(f"registered backends: {registry.available()}")

    variant = dataclasses.replace(GLASS_BASELINE, alpha=1.2,
                                  num_entry_points=3)
    eng = Engine(variant, metric=ds.metric, device=device)
    t0 = time.time()
    eng.build_index(ds.base)
    sync()
    print(f"index built in {time.time()-t0:.1f}s  ({variant.describe()}, "
          f"{eng.memory_bytes()/1e6:.1f} MB)")

    # --- 2. exact anchor: the brute-force backend (distance + topk) -------
    exact = registry.create("brute_force", metric=ds.metric, device=device)
    exact.build(ds.base)
    res = exact.search(ds.queries, SearchParams(k=10))
    anchor = recall_at_k(res.ids.cpu().numpy(), ds.gt, 10)
    print(f"brute-force anchor: recall@10={anchor:.3f} (exact)")

    # --- 3. graph search across the ef sweep ------------------------------
    curve = {}
    for ef in (16, 48, 96):
        params = SearchParams(k=10, ef=ef)
        t0 = time.time()
        res = eng.query(ds.queries, params)
        sync()
        dt = time.time() - t0
        rec = recall_at_k(res.ids.cpu().numpy(), ds.gt, 10)
        curve[ef] = rec
        print(f"ef={ef:3d}: recall@10={rec:.3f}  "
              f"qps={len(ds.queries)/dt:,.0f}  steps={int(res.steps)}")

    # --- 4. one CRINN RL iteration over the search module ------------------
    from repro_torch.configs import get_config
    from repro_torch.core import CrinnOptimizer, LoopConfig, Policy
    from repro_torch.models import Runtime, model

    cfg = dataclasses.replace(get_config("crinn-policy-100m"),
                              num_layers=2, d_model=128, num_heads=4,
                              num_kv_heads=4, head_dim=32, d_ff=256,
                              dtype="float32")
    rt = Runtime(attn_chunk=64, logit_chunk=64, remat="none")
    gen = torch.Generator(device=device).manual_seed(0)
    policy = Policy(cfg, model.init_params(gen, cfg, device), rt)
    loop = LoopConfig(group_size=4, iterations_per_module=1,
                      ef_sweep=(16, 24, 32, 48), bench_repeats=1)
    opt = CrinnOptimizer(policy, ds, loop)
    best = opt.run_module("search")
    print(f"\nCRINN-selected search variant: {best.describe()}")
    print(f"exemplar DB now holds {opt.db.size('search')} scored programs")
    return {"anchor_recall": anchor, "graph_recall": curve,
            "variant": best.describe(), "db_size": opt.db.size("search")}


if __name__ == "__main__":
    main()
