"""End-to-end driver of the port: CRINN contrastive-RL optimization of the
ANNS modules with the ~114M-parameter policy trained by GRPO (the
counterpart of ``examples/train_crinn.py``).

    PYTHONPATH=src python -m repro_torch.launch.train_crinn
    PYTHONPATH=src python -m repro_torch.launch.train_crinn --fast --device cpu

Runs on the CUDA card unless ``--device cpu`` is given.  The policy is
``crinn-policy-100m`` in fp32 (``--fast`` shrinks it), initialised from
``torch.Generator`` seed 0.  The five modules run in the reference's
order (``MODULE_ORDER``), ``backend`` first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def main(argv=None) -> dict:
    """Run the loop; returns the summary written to ``--out`` with the
    :class:`~repro_torch.core.CrinnOptimizer` added under ``"optimizer"``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--dataset", default="sift-128-euclidean")
    ap.add_argument("--n-base", type=int, default=0, help="0 = auto")
    ap.add_argument("--iters", type=int, default=0, help="0 = auto")
    ap.add_argument("--out", default="artifacts/crinn_run.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.anns import make_dataset
    from repro_torch.configs import get_config
    from repro_torch.core import CrinnOptimizer, LoopConfig, Policy
    from repro_torch.core.variant_space import MODULE_ORDER
    from repro_torch.device import resolve_device
    from repro_torch.models import Runtime, model

    device = resolve_device(args.device)
    n_base = args.n_base or (2000 if args.fast else 5000)
    iters = args.iters or (1 if args.fast else 4)
    group = 4 if args.fast else 6

    cfg = get_config("crinn-policy-100m")
    if args.fast:
        cfg = dataclasses.replace(cfg, num_layers=2, d_model=128,
                                  num_heads=4, num_kv_heads=4, head_dim=32,
                                  d_ff=256)
    cfg = dataclasses.replace(cfg, dtype="float32")
    rt = Runtime(attn_chunk=128, logit_chunk=128, remat="none")
    gen = torch.Generator(device=device).manual_seed(0)
    policy = Policy(cfg, model.init_params(gen, cfg, device), rt)
    print(f"policy: {cfg.name} ({cfg.param_count()/1e6:.1f}M params) "
          f"on {device}")

    ds = make_dataset(args.dataset, n_base=n_base,
                      n_query=64 if args.fast else 100, device=device)
    print(f"dataset: {args.dataset} n={n_base}")

    loop = LoopConfig(group_size=group, iterations_per_module=iters,
                      ef_sweep=(16, 24, 32, 48, 64) if args.fast
                      else (16, 24, 32, 48, 64, 96, 128),
                      bench_repeats=1 if args.fast else 2)
    opt = CrinnOptimizer(policy, ds, loop)

    modules = list(MODULE_ORDER)
    t0 = time.time()
    seconds = {}
    for module in modules:
        tm = time.time()
        opt.run_module(module)
        seconds[module] = time.time() - tm
        print(f"== module {module} done in {seconds[module]:.0f}s; "
              f"variant now: {opt.current.describe()}")
    final = opt.current
    dt = time.time() - t0

    print(f"\n=== CRINN run complete in {dt/60:.1f} min")
    print(f"final variant: {final.describe()}")
    res = opt.evaluate(final)
    print(f"final reward: {res.reward:.3f} (rel AUC {res.rel:.3f} "
          f"vs GLASS baseline 1.0)")

    out = {
        "dataset": args.dataset, "n_base": n_base, "device": str(device),
        "param_count": cfg.param_count(), "modules": modules,
        "skipped_modules": [],
        "module_seconds": seconds, "baseline_auc": opt.baseline_auc,
        "final_variant": final.describe(), "final_reward": res.reward,
        "final_rel_auc": res.rel,
        "history": [dataclasses.asdict(h) for h in opt.history],
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"history written to {args.out}")
    out["optimizer"] = opt
    return out


if __name__ == "__main__":
    main()
