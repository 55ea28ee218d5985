"""The readings the limits of ``correct`` are set from, on the card; the
benchmark's own runs never run this.

    python3 portbench/control.py --config <config> --seeds 11,12,... \
        --fault-seeds 11,12,13 --seconds 10 --fault-seconds 3 \
        [--answer-faults control,stale] [--build-faults frozen]

For each of ``--seeds``: one set-up (the vectors, the port's index), then
each cell of the configuration in ``BENCHMARK.json`` for ``--seconds`` at
its own load with the port in place (the sound readings); on those that
are also fault seeds, each of ``--answer-faults`` in the port's place for
``--fault-seconds`` (the reference's search in TF32, the control, and the
faults planted after the port answers).  On every fault seed, an index
built with each of ``--build-faults`` planted, served for
``--fault-seconds``.  Prints one JSON line of every number compared per
window.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

ANSWER_MODES = ("control", "stale", "half", "alter", "narrow")


def readings(s, answers, traffic, mode: str, seconds: float) -> dict:
    import numpy as np

    from portbench import cell

    cell.serve(s, traffic, traced=False, mode=mode)
    win = cell.run_window(s, seconds)
    sv = cell.served(win, s.config["k"])
    ok, _, nums = cell.judge(s, answers, win, sv,
                             s.deployment.program_numbers(s))
    e2e = {"qps": float(sv.in_window.sum()) / seconds,
           "p95_ms": cell.percentile(sv.latency_ms, 95),
           "search_ms": float(np.mean(win.batch_compute_ms))
           if win.batch_compute_ms else None}
    return {"correct": ok, "answered": int(sv.ok.sum()),
            "shed": win.shed, "backlog_at_close": win.backlog_at_close,
            **e2e, **nums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault-seconds", type=float, default=3.0)
    ap.add_argument("--answer-faults", default=",".join(ANSWER_MODES))
    ap.add_argument("--build-faults")   # the deployment's by default
    args = ap.parse_args(argv)

    import torch

    from portbench import cell, specs

    torch.backends.cuda.matmul.allow_tf32 = False
    bench = specs.load_benchmark()
    cells = [specs.find_cell(w["name"]) for w in bench["workloads"]
             if w["config"] == args.config]
    config = cells[0].config
    fault_seeds = [int(x) for x in args.fault_seeds.split(",") if x]
    answer_faults = tuple(x for x in args.answer_faults.split(",") if x)
    for seed in [int(x) for x in args.seeds.split(",") if x]:
        s = cell.build(config, seed, "cuda:0")
        print(json.dumps({"seed": seed, "build_s": s.build_s}), flush=True)
        answers = cell.Answers(s, s.deployment.reference(s))
        modes = ("program",) + (answer_faults if seed in fault_seeds
                                else ())
        for c in cells:
            for mode in modes:
                secs = args.seconds if mode == "program" else \
                    args.fault_seconds
                out = readings(s, answers, c.traffic, mode, secs)
                print(json.dumps({"seed": seed, "cell": c.name,
                                  "mode": mode, **out}), flush=True)
        del s, answers
        gc.collect()
        torch.cuda.empty_cache()
    faults = args.build_faults
    build_faults = ([x for x in faults.split(",") if x] if faults
                    else specs.deployment(config).BUILD_FAULTS)
    for seed in fault_seeds:
        for fault in build_faults:
            s = cell.build(config, seed, "cuda:0", fault=fault)
            answers = cell.Answers(s, s.deployment.reference(s))
            out = readings(s, answers, cells[0].traffic, "program",
                           args.fault_seconds)
            print(json.dumps({"seed": seed, "cell": cells[0].name,
                              "mode": fault, "build_s": s.build_s, **out}),
                  flush=True)
            del s, answers
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
