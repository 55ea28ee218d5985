"""One-off sweep that fixes a configuration's operating point and its open
cell's rate, on the card.

    python3 portbench/sweep_open.py --config <config> --seed 0 \
        --seconds 8 --shares 0.3,0.4,0.5,0.6,0.7,0.8,0.9,1.0 [--ef-sweep]

One set-up (the vectors from the seed, the port's IvfBackend over them).
With ``--ef-sweep``: recall@10 of every query at each ``EF_LADDER`` rung
through the backend's search, against the reference's exact neighbours,
and the lowest rung that reaches the configuration's SLO (this sets the
configuration's ``operating_point``).  Then ``closed256``'s closed loop at
that rung for its rate, and the open loop of single queries through the
tier at ``max_batch`` 64 at each share of that rate.  The knee is the
highest rate, up to the first that fails, whose backlog at the window's
close is at most one batch with nothing shed; the open cell runs at 0.8
of it.  Prints one JSON line
per step.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ef_sweep(s, slo: float, batch: int = 256) -> dict:
    import numpy as np
    import torch
    from repro_torch.anns.api import EF_LADDER, SearchParams

    from portbench import check
    from portbench.reference import ivf as ref

    gt, _ = ref.exact_knn(s.base, s.queries, s.config["k"])
    gt = gt.cpu().numpy()
    pick = None
    for ef in EF_LADDER:
        params = SearchParams(k=s.config["k"], ef=ef)
        ids, nprobe = [], None
        for lo in range(0, len(s.queries_host), batch):
            res = s.backend.search(s.queries_host[lo:lo + batch], params)
            ids.append(res.ids.cpu().numpy())
            nprobe = int(res.steps)
        torch.cuda.synchronize()
        r = check.recall(np.concatenate(ids).astype(np.int64), gt)
        emit({"step": "ef_sweep", "ef": ef, "nprobe": nprobe,
              "recall_at_10": r})
        if pick is None and r >= slo:
            pick = {"ef": ef, "nprobe": nprobe, "recall_at_10_seed0": r}
    return pick


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--shares", default="0.3,0.4,0.5,0.6,0.7,0.8,0.9,1.0")
    ap.add_argument("--ef-sweep", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from portbench import cell, specs

    torch.backends.cuda.matmul.allow_tf32 = False
    bench = specs.load_benchmark()
    entry = {c["name"]: c for c in bench["configs"]}[args.config]
    config = specs.load_json(specs.ROOT / entry["file"])
    closed = specs.load_json(specs.PB_DIR / "traffic" / "closed256.json")
    t = time.perf_counter()
    s = cell.build(config, args.seed, "cuda:0")
    emit({"step": "build", "seconds": time.perf_counter() - t,
          "build_s": s.build_s, "nlist": s.backend.index.nlist,
          "cell_pad": s.backend.index.cell_pad})
    if args.ef_sweep:
        pick = ef_sweep(s, config["operating_point"]["slo_recall_at_10"])
        emit({"step": "operating_point", **(pick or {})})
        if pick is None:
            return 1
        config = copy.deepcopy(config)
        config["operating_point"].update(pick)
        s.config = config
    cell.serve(s, closed, traced=False)
    win = cell.run_window(s, args.seconds)
    sv = cell.served(win, config["k"])
    qps = float(sv.in_window.sum()) / args.seconds
    emit({"step": "closed256", "qps": qps,
          "search_ms": float(np.mean(win.batch_compute_ms))})
    knee = None
    for share in [float(x) for x in args.shares.split(",")]:
        traffic = {"loop": "open", "rate_qps": share * qps, "max_batch": 64,
                   "max_queue": 65536}
        cell.serve(s, traffic, traced=False)
        win = cell.run_window(s, args.seconds)
        sv = cell.served(win, config["k"])
        holds = win.backlog_at_close <= 64 and win.shed == 0
        emit({"step": "open64", "share": share, "rate_qps": share * qps,
              "backlog_at_close": win.backlog_at_close, "shed": win.shed,
              "requests": len(sv.qidx),
              "p50_ms": float(np.percentile(sv.latency_ms, 50)),
              "p95_ms": float(np.percentile(sv.latency_ms, 95)),
              "lateness_p95_ms": float(np.percentile(sv.lateness_ms, 95)),
              "search_ms": float(np.mean(win.batch_compute_ms)),
              "rows_per_request": s.proxy.rows / max(1, int(sv.ok.sum())),
              "holds": holds})
        if not holds:
            break
        knee = share * qps
    emit({"step": "knee", "knee_qps": knee,
          "rate_qps": None if knee is None else 0.8 * knee})
    return 0


if __name__ == "__main__":
    sys.exit(main())
