"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (one JSON line each; any failure raises, and the script then exits
non-zero without its last line):

1. device   -- the card's name and power limit (nvidia-smi); no card = error.
2. build    -- nvcc builds every kernel of the port, one process per source.
3. kernels  -- each kernel against its plain PyTorch version on the card
               (distance within rtol 1e-4 / atol 2e-3, topk ids and values
               exact), then timed at the main path's shapes beside the
               plain version, one PyTorch library call and the card's bound.
4. main     -- the serving path at SIFT1M scale (1,000,000 x 128 base,
               10,000 queries, gt on the card): build, then serve 2,048
               requests through AnnsServer (max_batch 64, k 10, ef 64) for
               brute_force, graph and quantized_prefilter.  The kernels'
               launch counters are set to 0 just before and read just after
               each backend's serving run.
5. ref20k   -- recall@10 of graph / quantized_prefilter at 20,000 vectors
               against the JAX package's numbers on the same data, the
               optimized (alpha-pruned) variant, and the CLI driver.

Then a ``{"kernels": [...]}`` line and, last, the device line the checks
read.  Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and fp32
#: FLOP/s outside the tensor cores (the kernels compute in plain fp32)
HBM_BYTES_S = 3.35e12
FP32_FLOPS_S = 67e12

#: recall@10 of the JAX package on the CPU, sift-128 at 20,000 x 256, seed 0
REF_RECALL_20K = {"graph": {16: 0.597, 64: 0.795, 256: 0.894},
                  "quantized_prefilter": {16: 0.598, 64: 0.796, 256: 0.889}}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False     # the default, stated
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "matmul_precision": torch.get_float32_matmul_precision()})
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------
KERNELS = ("distance", "topk")


def phase_build() -> None:
    from repro_torch.kernels import _build
    seconds = _build.build(KERNELS)
    usage = {n: [ln.strip() for ln in _build.BUILD_LOGS.get(n, "").splitlines()
                 if "Used" in ln] for n in KERNELS}
    emit({"phase": "build", "seconds": seconds, "ptxas": usage})


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions, and their times
# ---------------------------------------------------------------------------
def time_ms(fn, args_list, warmup: int = 3) -> float:
    """Mean time of ``fn(*args)`` over ``args_list`` (distinct inputs, so
    the 50 MB L2 does not hold them across calls) between two CUDA events.
    Where the host enqueues slower than the card runs, this is the host's
    rate: see :func:`device_ms`."""
    for a in args_list[:warmup]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for a in args_list:
        fn(*a)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / len(args_list)


def _self_device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else getattr(evt, "self_cuda_time_total", 0))


def traced(fn):
    """Run ``fn()`` under torch.profiler (CUDA activity); returns
    (wall seconds ending in a synchronize, {kernel name: device us})."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, {e.key: _self_device_us(e) for e in prof.key_averages()
                  if _self_device_us(e) > 0}


def device_ms(fn, args_list) -> float:
    """Device time per call: every kernel the calls launched, summed from
    the profiler trace, over the number of calls."""
    for a in args_list[:3]:
        fn(*a)

    def run():
        for a in args_list:
            fn(*a)
    _, by_kernel = traced(run)
    total = sum(by_kernel.values())
    check(total > 0, "the profiler saw no device time")
    return total / 1e3 / len(args_list)


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, nops / FP32_FLOPS_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels() -> dict:
    from repro_torch.kernels.distance import ops as dist_ops
    from repro_torch.kernels.distance.ref import distance_ref
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.kernels.topk.ref import topk_smallest_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # -- distance ----------------------------------------------------------
    err = 0.0
    shapes = [(128, 256, 128), (100, 300, 96), (8, 1000, 25),
              (256, 512, 960), (1, 128, 784), (17, 33, 100), (64, 8192, 128)]
    for nq, nx, d in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(nq, d, generator=gen, device=dev).to(dtype)
            x = torch.randn(nx, d, generator=gen, device=dev).to(dtype)
            for metric in ("l2", "ip"):
                got = dist_ops.pairwise_distance(q, x, metric=metric)
                want = distance_ref(q, x, metric)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-3)
                err = max(err, float((got - want).abs().max()))
    nq, nx, d, reps = 64, 8192, 128, 50
    q = torch.randn(nq, d, generator=gen, device=dev)
    xs = torch.randn(reps * nx, d, generator=gen, device=dev)
    args = [(q, xs[i * nx:(i + 1) * nx]) for i in range(reps)]
    kernel = (lambda a, b: dist_ops.pairwise_distance(a, b))
    plain = (lambda a, b: distance_ref(a, b, "l2"))
    library = (lambda a, b: torch.matmul(a, b.T))
    ms, plain_ms, lib_ms = (device_ms(f, args) for f in (kernel, plain, library))
    event_ms = {n: time_ms(f, args) for n, f in
                (("kernel", kernel), ("plain", plain), ("library", library))}
    b_ms, b_by = bound(4.0 * (nq * d + nx * d + nq * nx),
                       2.0 * nq * nx * d + 2.0 * (nq + nx) * d + 3.0 * nq * nx)
    out["distance"] = {
        "name": "distance", "route": "cuda",
        "source": "src/repro_torch/csrc/distance.cu",
        "replaces": "src/repro/kernels/distance/distance.py:46",
        "max_abs_err": err, "tolerance": "rtol 1e-4, atol 2e-3",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "library_call": "torch.matmul(q, x.T)",
        "shape": [nq, nx, d], "per_call_event_ms": event_ms}
    emit({"phase": "kernel", **out["distance"]})
    del xs, args

    # -- topk ---------------------------------------------------------------
    def check_topk(dm: torch.Tensor, k: int) -> None:
        v, i = topk_ops.topk_smallest(dm, k)
        wv, wi = topk_smallest_ref(dm, k)
        torch.cuda.synchronize()
        check(torch.equal(i, wi), f"topk ids differ at {tuple(dm.shape)} k={k}")
        check(torch.equal(v, wv), f"topk values differ at {tuple(dm.shape)} k={k}")

    for nq_, nx_, k in [(8, 128, 10), (5, 1000, 32), (16, 333, 100),
                        (1, 50, 5), (9, 2048, 64), (64, 8192, 10),
                        (64, 8192, 100), (64, 8192, 1), (64, 1230, 10),
                        (4, 40000, 16)]:
        check_topk(torch.randn(nq_, nx_, generator=gen, device=dev), k)
    ties = torch.zeros(64, 8192, device=dev)
    ties[:, 10] = -1.0
    ties[::2, 4000] = -0.0
    check_topk(ties, 10)
    big = torch.full((64, 8192), 3.0e38, device=dev)
    big[:, 5], big[:, 9] = 1.0, 2.0
    check_topk(big, 100)
    _, i = topk_ops.topk_smallest(big, 5)
    check(i[0].tolist() == [5, 9, 0, 1, 2], f"mostly-BIG row gave {i[0].tolist()}")
    nq, nx, k = 64, 8192, 10
    ds_ = torch.randn(reps, nq, nx, generator=gen, device=dev)
    args = [(ds_[r],) for r in range(reps)]
    kernel = (lambda a: topk_ops.topk_smallest(a, k))
    plain = (lambda a: topk_smallest_ref(a, k))
    library = (lambda a: torch.topk(a, k, dim=1, largest=False))
    ms, plain_ms, lib_ms = (device_ms(f, args) for f in (kernel, plain, library))
    event_ms = {n: time_ms(f, args) for n, f in
                (("kernel", kernel), ("plain", plain), ("library", library))}
    b_ms, b_by = bound(4.0 * nq * nx + 8.0 * nq * k, 1.0 * nq * nx)
    out["topk"] = {
        "name": "topk", "route": "cuda", "source": "src/repro_torch/csrc/topk.cu",
        "replaces": "src/repro/kernels/topk/topk.py:45",
        "max_abs_err": 0.0, "tolerance": "ids and values exact",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
        "library_call": "torch.topk(d, k, largest=False)",
        "shape": [nq, nx, k], "per_call_event_ms": event_ms}
    emit({"phase": "kernel", **out["topk"]})
    del ds_, args
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 4. the main path at SIFT1M scale
# ---------------------------------------------------------------------------
def serve_requests(backend, queries, gt, *, n_requests: int, ef: int,
                   k: int = 10, max_batch: int = 64) -> dict:
    """Closed-loop serving through AnnsServer: windows of ``max_batch``
    requests, each submitted then flushed."""
    from repro_torch.anns import SearchParams
    from repro_torch.anns.datasets import recall_at_k
    from repro_torch.runtime.server import AnnsServer

    server = AnnsServer(backend, max_batch=max_batch,
                        params=SearchParams(k=k, ef=ef))
    order = np.random.default_rng(0).integers(0, len(queries), size=n_requests)
    responses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, n_requests, max_batch):
        for i in order[lo:lo + max_batch]:
            server.submit(queries[i])
        responses.extend(server.run())
    dt = time.perf_counter() - t0
    lat = np.array([r.latency_ms for r in responses])
    found = np.stack([r.ids for r in responses])
    check(found.shape == (n_requests, k), f"served shape {found.shape}")
    return {"ef": ef, "requests": n_requests, "seconds": dt,
            "qps": n_requests / dt, "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            f"recall@{k}": recall_at_k(found, gt[order], k)}


def busy_share(backend, queries, gt, *, ef: int, n_requests: int = 512) -> dict:
    """A traced serving window: the share of its wall time the card spent
    in kernels or copies, and the five kernels that took most of it."""
    wall, by_kernel = traced(lambda: serve_requests(
        backend, queries, gt, n_requests=n_requests, ef=ef))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    return {"traced_requests": n_requests, "traced_wall_s": wall,
            "device_busy_share": sum(by_kernel.values()) / 1e6 / wall,
            "top_device_us": {name[:80]: us for name, us in top}}


def phase_main(n_base: int, n_query: int, n_requests: int) -> dict:
    import dataclasses

    from repro_torch.anns import make_dataset, registry
    from repro_torch.anns.engine import GLASS_BASELINE
    from repro_torch.kernels.distance import ops as dist_ops
    from repro_torch.kernels.topk import ops as topk_ops

    t0 = time.perf_counter()
    ds = make_dataset("sift-128-euclidean", n_base=n_base, n_query=n_query,
                      device="cuda")
    check(ds.gt.shape == (n_query, 100) and ds.gt.min() >= 0
          and ds.gt.max() < n_base, "ground truth malformed")
    emit({"phase": "main.dataset", "n_base": n_base, "n_query": n_query,
          "dim": int(ds.base.shape[1]), "seconds": time.perf_counter() - t0})

    launches = {}
    for name in ("brute_force", "graph", "quantized_prefilter"):
        variant = dataclasses.replace(GLASS_BASELINE, backend=name)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backend = registry.create(name, variant, metric=ds.metric,
                                  device="cuda")
        backend.build(ds.base)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        row = {"phase": "main.serve", "backend": name, "build_s": build_s,
               "device_bytes": backend.memory_bytes(),
               "build_peak_bytes": torch.cuda.max_memory_allocated()}
        efs = (64,) if name != "graph" else (16, 64, 256)
        runs = []
        for ef in efs:
            dist_ops.launches = topk_ops.launches = 0
            runs.append(serve_requests(backend, ds.queries, ds.gt,
                                       n_requests=n_requests, ef=ef))
            counts = {"distance": dist_ops.launches, "topk": topk_ops.launches}
            runs[-1]["launches"] = counts
        row["runs"] = runs
        row["trace_ef64"] = busy_share(backend, ds.queries, ds.gt, ef=64)
        emit(row)
        served = next(r for r in runs if r["ef"] == 64)
        finite = all(np.isfinite(v) for v in served.values()
                     if isinstance(v, float))
        check(finite, f"{name}: non-finite metrics {served}")
        if name == "brute_force":
            check(served["recall@10"] >= 0.999,
                  f"brute_force recall@10 {served['recall@10']} < 0.999")
            launches = served["launches"]
            check(launches["distance"] > 0 and launches["topk"] > 0,
                  f"the main path launched no kernel: {launches}")
        if name == "graph":
            rec = [r["recall@10"] for r in runs]
            check(rec[1] >= rec[0] - 0.01 and rec[2] >= rec[1] - 0.01,
                  f"graph recall falls as ef grows: {rec}")
        del backend
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 5. the reference point at 20k, the optimized variant, the CLI driver
# ---------------------------------------------------------------------------
def phase_ref20k() -> None:
    import dataclasses

    from repro_torch.anns import SearchParams, make_dataset, registry
    from repro_torch.anns.datasets import recall_at_k
    from repro_torch.anns.engine import GLASS_BASELINE, VariantConfig
    from repro_torch.launch import serve

    ds = make_dataset("sift-128-euclidean", n_base=20_000, n_query=256,
                      device="cuda")
    optimized = VariantConfig(alpha=1.2, num_entry_points=3, gather_width=2,
                              patience=4, adaptive_ef_coef=14.5)
    for label, name, variant in [
            ("graph", "graph", GLASS_BASELINE),
            ("quantized_prefilter", "quantized_prefilter",
             dataclasses.replace(GLASS_BASELINE,
                                 backend="quantized_prefilter")),
            ("graph-optimized", "graph", optimized)]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backend = registry.create(name, variant, metric=ds.metric, seed=0,
                                  device="cuda")
        backend.build(ds.base)
        torch.cuda.synchronize()
        row = {"phase": "ref20k", "variant": label,
               "build_s": time.perf_counter() - t0, "recall@10": {}}
        for ef in (16, 64, 256):
            res = backend.search(ds.queries, SearchParams(k=10, ef=ef))
            row["recall@10"][ef] = recall_at_k(res.ids.cpu().numpy(), ds.gt, 10)
        want = REF_RECALL_20K.get(label)
        if want is not None:
            row["reference"] = want
            for ef, r in want.items():
                check(abs(row["recall@10"][ef] - r) <= 0.02,
                      f"{label} ef={ef}: recall {row['recall@10'][ef]} vs "
                      f"reference {r}")
        if label == "graph-optimized":
            row.update(serve_requests(backend, ds.queries, ds.gt,
                                      n_requests=512, ef=64))
        emit(row)
        del backend
    rec = serve.main(["--n-base", "20000", "--n-query", "256",
                      "--n-requests", "512", "--backend", "brute_force"])
    check(rec >= 0.999, f"serve CLI brute_force recall {rec}")
    emit({"phase": "ref20k.cli", "backend": "brute_force", "recall@10": rec})


def main() -> None:
    phase_device()
    phase_build()
    kernels = phase_kernels()
    launches = phase_main(n_base=1_000_000, n_query=10_000, n_requests=2048)
    phase_ref20k()
    emit({"phase": "total", "seconds": time.perf_counter() - T_START})
    for name, row in kernels.items():
        row["launches"] = launches[name]
    emit({"kernels": list(kernels.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
