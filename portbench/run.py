"""Run one cell of ``BENCHMARK.json`` on the card this process is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``,
the card's name and power limit, and last ``checks``: every number the
verdict compared, beside its limit (also the last lines on standard
error).  Exits non-zero and prints no result without a CUDA card, with
fewer cards than the cell asks for, or if JAX or the JAX package was
loaded.  The port's kernels build into ``build/repro_torch/`` of the
checkout (``repro_torch.kernels._build``), so only a cell's first run in a
checkout compiles; traces go to ``build/portbench/`` and are deleted once
read.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

#: top-level modules no run may load (compared by whole top-level name:
#: ``repro_torch`` is the port, ``repro`` the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(out: dict, trace: bool, device_count: int,
                kind: str) -> dict:
    """The JSON object the run prints; ``checks`` comes last."""
    if trace:
        metrics = {name: {"value": v, "unit": out["layer_units"][name]}
                   for name, v in out["per_layer"].items() if v is not None}
    else:
        metrics = {name: {"value": v, "unit": out["units"][name]}
                   for name, v in out["e2e"].items()}
    device = {"platform": "gpu", "kind": kind, "count": device_count,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = out["trace"].busy_s
        device["window_s"] = out["trace"].window_s
        line["breakdown"] = out["breakdown"]
    line["card"] = out["card"]
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import cell as cell_mod
    from portbench import specs

    cell = specs.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards; "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    readers = ({m.name: specs.reader(m.name) for m in cell.per_layer}
               if args.trace else None)
    out = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda:0", t_start=T_START, readers=readers)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    line = result_line(out, bool(args.trace), cell.chips,
                       torch.cuda.get_device_name(0))
    sv, win = out["served"], out["window"]
    print(json.dumps({"numbers": out["numbers"],
                      "lateness_p95_ms": cell_mod.percentile(
                          sv.lateness_ms, 95),
                      "backlog_at_close": win.backlog_at_close,
                      "shed": win.shed}), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
