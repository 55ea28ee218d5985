"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (one JSON line each; any failure raises, and the script then exits
non-zero without its last line):

1. device   -- the card's name and power limit (nvidia-smi); no card = error.
2. build    -- nvcc builds every kernel of the port, one process per source;
               ptxas's register report and the count of HMMA (tensor-core
               mma) instructions in each library's SASS, which distance,
               qdist and flash (TF32 mma.sync) must have.
3. kernels  -- each kernel against its plain PyTorch version on the card
               (distance and qdist within rtol 1e-4 / atol 2e-3, topk ids
               and value bits exact, also at k = nx, a 1,000,000-value row,
               ties across a warp's and a step's edge, NaN and +-0, rows
               mostly BIG, k = 300 over 123 chunks' merge and k = nx past
               the row sort's 28,672 values (the k rounds); flash
               within 2e-3 in fp32 and 2e-2 in bf16; views one element off
               16 bytes and, for flash, bit-equal on strided and contiguous
               inputs; the qdist cell scan at the 1M ivf layout's shapes,
               its -1 slots exactly BIG), then timed at the main path's
               shapes beside the plain version, one PyTorch library call
               (SDPA's kernel named from the trace) and the card's bound
               (TF32 products at three passes for distance and flash, two
               for qdist's exact int8 codes, beside the CUDA-core bound).
4. main     -- the serving path at SIFT1M scale (1,000,000 x 128 base,
               10,000 queries, gt on the card): build, then serve 2,048
               requests through AnnsServer (max_batch 64, k 10, ef 64) for
               brute_force, graph, quantized_prefilter, ivf (nlist 1,024,
               nprobe 16, cells capped at 2,048) and sharded (the same in 2
               shards).  The kernels' launch counters are set to 0 just
               before and read just after each serving run.
5. ref20k   -- recall@10 of graph / quantized_prefilter / ivf / sharded
               (1, 2, 4 shards) at 20,000 vectors against the JAX package's
               numbers on the same data; sharded at 1 shard returns ivf's
               ids, ivf at the all-cells probe brute_force's; the optimized
               (alpha-pruned) variant, and the CLI driver.
6. rl       -- the CRINN RL loop through ``repro_torch.launch.train_crinn``:
               the 114M-parameter policy (fp32, full width and depth) samples
               GRPO groups of 6 programs, each built and swept on the engine
               at 5,000 x 128 and scored by the banded AUC, then takes a
               GRPO + AdamW step; 2 iterations of each of the five modules,
               ``backend`` first.  The kernels' counters are set to 0 just
               before and read just after.  The first update is held
               against the same GRPO + AdamW step on the CPU from the same
               weights and batch.

Then a ``{"kernels": [...]}`` line and, last, the device line the checks
read.  Imports nothing of JAX or of the ``repro`` package.

    python3 chip_smoke.py --kernel-times NAME [PATH/src]

times only kernel NAME (distance or topk) at the main path's shapes, with
the same method, from the ``repro_torch`` under PATH/src (another
checkout, e.g. a parent commit unpacked with ``git archive``) or this
tree's, and prints one JSON line.
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

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, fp32 FLOP/s
#: outside the tensor cores, and TF32 FLOP/s on them (distance and flash
#: take their products in 3xTF32, three TF32 passes per product; qdist in
#: two, its int8 codes being exact in TF32)
HBM_BYTES_S = 3.35e12
FP32_FLOPS_S = 67e12
TF32_FLOPS_S = 495e12

#: recall@10 of the JAX package on the CPU, sift-128 at 20,000 x 256, seed 0
#: (the ivf family's: IVF_BASELINE and SHARDED_BASELINE at 1, 2, 4 shards)
REF_RECALL_20K = {"graph": {16: 0.597, 64: 0.795, 256: 0.894},
                  "quantized_prefilter": {16: 0.598, 64: 0.796, 256: 0.889},
                  "ivf": {16: 0.94765625, 64: 1.0, 256: 1.0},
                  "sharded-1": {16: 0.94765625, 64: 1.0, 256: 1.0},
                  "sharded-2": {16: 0.94765625, 64: 1.0, 256: 1.0},
                  "sharded-4": {16: 0.94765625, 64: 1.0, 256: 1.0}}


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
KERNELS = ("distance", "topk", "qdist", "flash")


#: the kernels whose products run on the tensor cores (TF32 mma.sync)
TENSOR_CORE_KERNELS = ("distance", "qdist", "flash")


def phase_build() -> None:
    from repro_torch.kernels import _build
    seconds = _build.build(KERNELS)
    usage = {n: [ln.strip() for ln in _build.BUILD_LOGS.get(n, "").splitlines()
                 if "Used" in ln] for n in KERNELS}
    hmma = {n: _build.sass_count(n, "HMMA") for n in KERNELS}
    emit({"phase": "build", "seconds": seconds, "ptxas": usage,
          "sass_hmma": hmma})
    for n in TENSOR_CORE_KERNELS:
        check(hmma[n] > 0, f"{n}: no HMMA instruction in its SASS")


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


def device_profile(fn, args_list) -> tuple[float, dict]:
    """Device time per call: every kernel the calls launched, summed from
    the profiler trace, over the number of calls; and device us by kernel
    name."""
    for a in args_list[:3]:
        fn(*a)

    def run():
        for a in args_list:
            fn(*a)
    # a trace now and then comes back without its device activity (seen on
    # the H100 machine): take another, three at most
    for _ in range(3):
        _, by_kernel = traced(run)
        total = sum(by_kernel.values())
        if total > 0:
            return total / 1e3 / len(args_list), by_kernel
    raise AssertionError("the profiler saw no device time in three traces")


def device_ms(fn, args_list) -> float:
    return device_profile(fn, args_list)[0]


def bound(nbytes: float, nops: float, tf32_ops: float = 0.0,
          passes: int = 3) -> tuple[float, str]:
    """The least time of a call, ms, and what binds it: its bytes over the
    HBM rate, or its operations: ``nops`` fp32 operations on the CUDA
    cores and, for a tensor-core kernel, ``tf32_ops`` product operations
    at ``passes`` TF32 passes each (3 for 3xTF32, 2 where one operand is
    exact in TF32; the two units run side by side, so the slower counts)."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(nops / FP32_FLOPS_S, passes * tf32_ops / TF32_FLOPS_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def offset_view(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` whose storage starts one element past an aligned
    address: what the kernels' 4-byte-staging variant serves."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


#: the reference's six distance shapes (tests/test_kernels.py), the
#: brute_force chunk and a k-means assignment step: (nq, nx, d)
DISTANCE_SHAPES = [(128, 256, 128), (100, 300, 96), (8, 1000, 25),
                   (256, 512, 960), (1, 128, 784), (17, 33, 100),
                   (64, 8192, 128), (4096, 1024, 128)]


def distance_times(gen, plain: bool = False) -> dict:
    """distance's device ms at the brute_force chunk, the ivf coarse probe
    over the 1M layout's 1,569 centroids and a k-means assignment step,
    over 50 distinct inputs, beside torch.matmul's and the bound (three
    TF32 passes, and the CUDA-core bound); at the brute_force chunk also
    the plain version and CUDA-event times."""
    from repro_torch.kernels.distance import ops as dist_ops
    from repro_torch.kernels.distance.ref import distance_ref
    dev = torch.device("cuda")
    reps = 50
    kernel = (lambda a, b: dist_ops.pairwise_distance(a, b))
    plain_fn = (lambda a, b: distance_ref(a, b, "l2"))
    library = (lambda a, b: torch.matmul(a, b.T))

    def dist_bounds(nq, nx, d):
        nbytes = 4.0 * (nq * d + nx * d + nq * nx)
        other = 2.0 * (nq + nx) * d + 3.0 * nq * nx     # norms, epilogue
        products = 2.0 * nq * nx * d
        b_ms, b_by = bound(nbytes, other, products)
        return {"bound_ms": b_ms, "bound_by": b_by,
                "bound_cuda_core_ms": bound(nbytes, other + products)[0]}

    at_shapes = {}
    for nq, nx, d in ((64, 8192, 128), (64, 1569, 128), (4096, 1024, 128)):
        q = torch.randn(nq, d, generator=gen, device=dev)
        xs = torch.randn(reps * nx, d, generator=gen, device=dev)
        args = [(q, xs[i * nx:(i + 1) * nx]) for i in range(reps)]
        row = {"ms": device_ms(kernel, args),
               "library_ms": device_ms(library, args),
               **dist_bounds(nq, nx, d)}
        if plain and nx == 8192:
            row["plain_ms"] = device_ms(plain_fn, args)
            row["per_call_event_ms"] = {
                n: time_ms(f, args) for n, f in
                (("kernel", kernel), ("plain", plain_fn), ("library", library))}
        at_shapes[f"{nq}x{nx}x{d}"] = row
        del xs, args
    return at_shapes


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
    for nq, nx, d in DISTANCE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(nq, d, generator=gen, device=dev).to(dtype)
            x = torch.randn(nx, d, generator=gen, device=dev).to(dtype)
            # fp32 views one float off 16 bytes take the 4-byte staging
            views = [(q, x)] + ([(offset_view(q), offset_view(x))]
                                if dtype == torch.float32 else [])
            for qv, xv in views:
                for metric in ("l2", "ip"):
                    got = dist_ops.pairwise_distance(qv, xv, metric=metric)
                    want = distance_ref(qv, xv, metric)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-3)
                    err = max(err, float((got - want).abs().max()))
    at_shapes = distance_times(gen, plain=True)
    main_row = at_shapes.pop("64x8192x128")
    out["distance"] = {
        "name": "distance", "route": "cuda",
        "source": "src/repro_torch/csrc/distance.cu",
        "replaces": "src/repro/kernels/distance/distance.py:46",
        "max_abs_err": err, "tolerance": "rtol 1e-4, atol 2e-3",
        **main_row, "library_call": "torch.matmul(q, x.T)",
        "shape": [64, 8192, 128], "at_shapes": at_shapes}
    emit({"phase": "kernel", **out["distance"]})

    # -- topk ---------------------------------------------------------------
    def check_topk(dm: torch.Tensor, k: int) -> None:
        before = topk_ops.launches
        v, i = topk_ops.topk_smallest(dm, k)
        wv, wi = topk_smallest_ref(dm, k)
        torch.cuda.synchronize()
        where = f"{tuple(dm.shape)} k={k}"
        check(topk_ops.launches == before + 1, f"topk: not one launch at {where}")
        check(torch.equal(i, wi), f"topk ids differ at {where}")
        # bit-equal values: NaN equals NaN, -0 stays -0
        check(torch.equal(v.view(torch.int32), wv.view(torch.int32)),
              f"topk values differ at {where}")

    for nq_, nx_, k in TOPK_CHECKS:
        check_topk(torch.randn(nq_, nx_, generator=gen, device=dev), k)
    for dm, k in topk_edge_cases(gen, dev).values():
        check_topk(dm, k)
    big = torch.full((64, 8192), 3.0e38, device=dev)
    big[:, 5], big[:, 9] = 1.0, 2.0
    check_topk(big, 100)
    _, i = topk_ops.topk_smallest(big, 5)
    check(i[0].tolist() == [5, 9, 0, 1, 2], f"mostly-BIG row gave {i[0].tolist()}")
    torch.cuda.empty_cache()
    timed = topk_times(gen, plain=True)
    main_row = timed.pop("64x8192k10")
    out["topk"] = {
        "name": "topk", "route": "cuda", "source": "src/repro_torch/csrc/topk.cu",
        "replaces": "src/repro/kernels/topk/topk.py:45",
        "max_abs_err": 0.0, "tolerance": "ids and value bits exact",
        **main_row, "library_call": "torch.topk(d, k, largest=False)",
        "shape": [64, 8192, 10], "at_shapes": timed}
    emit({"phase": "kernel", **out["topk"]})
    torch.cuda.empty_cache()
    out["qdist"] = kernel_qdist(gen)
    emit({"phase": "kernel", **out["qdist"]})
    torch.cuda.empty_cache()
    out["flash"] = kernel_flash(gen)
    emit({"phase": "kernel", **out["flash"]})
    torch.cuda.empty_cache()
    return out


#: topk against its plain version: (nq, nx, k), the main path's shapes
#: among them (the brute_force chunk and its merge, the ivf coarse probe at
#: ef 64 and at the all-cells probe, a k-means assignment)
TOPK_CHECKS = [(8, 128, 10), (5, 1000, 32), (16, 333, 100), (1, 50, 5),
               (9, 2048, 64), (64, 8192, 10), (64, 8192, 100), (64, 8192, 1),
               (64, 1230, 10), (4, 40000, 16), (64, 1569, 16),
               (64, 1569, 1569), (4096, 1024, 1), (3, 9000, 256),
               (3, 9001, 257), (7, 4097, 1), (64, 123 * 300, 300)]
#: the main path's topk shapes, timed: (nq, nx, k)
TOPK_SHAPES = [(64, 8192, 10), (64, 1230, 10), (64, 1569, 16),
               (64, 1569, 1569), (4096, 1024, 1)]


def topk_edge_cases(gen, dev) -> dict:
    """Inputs that probe the kernel's seams: {name: (d, k)}."""
    cases = {}
    # a row past the old kernel's 57,856-value limit
    cases["long row"] = (torch.randn(2, 1_000_000, generator=gen, device=dev), 10)
    # equal values on both sides of a warp's edge (column 1,024) and of a
    # step's (8,192: a row of 20,000 takes three), cut in their middle
    d = torch.rand(4, 20_000, generator=gen, device=dev) + 1.0
    d[:, 1020:1030] = 0.5
    d[:, 8188:8196] = 0.5
    cases["ties at edges"] = (d, 12)
    t = torch.zeros(64, 8192, device=dev)
    t[:, 10] = -1.0
    t[::2, 4000] = -0.0
    cases["zeros"] = (t, 10)
    # the k smallest all in the row's last values
    d = torch.rand(4, 8192 + 777, generator=gen, device=dev) + 1.0
    d[:, -10:] = -torch.arange(10, device=dev, dtype=torch.float32)
    cases["last values"] = (d, 10)
    # NaN and +-0 in one row, through the select and the row sort
    d = torch.randn(3, 3000, generator=gen, device=dev)
    d[:, 7], d[:, 9], d[:, 11] = float("nan"), -0.0, 0.0
    d[:, 13], d[:, 15] = float("inf"), float("-inf")
    cases["nan and zeros"] = (d, 10)
    cases["nan and zeros, k = nx"] = (d, 3000)
    nan = torch.full((2, 2000), float("nan"), device=dev)
    nan[:, 3], nan[:, 5] = 0.0, -0.0
    cases["mostly nan"] = (nan, 20)
    # k = nx past the row sort's 28,672 values: the k rounds
    cases["k = nx past the row sort"] = (
        torch.randn(2, 30_000, generator=gen, device=dev), 30_000)
    # a selective filter: 4 values a row below BIG, in a chunk and a merge
    cases["mostly BIG"] = (mostly_big(gen, 64, 8192), 10)
    cases["mostly BIG, merge"] = (mostly_big(gen, 64, 1230), 10)
    return cases


def mostly_big(gen, nq: int, nx: int, reps: int = 1) -> torch.Tensor:
    """(reps, nq, nx), or (nq, nx) at one rep: BIG (the search's sentinel)
    but for 4 values in [0, 1) a row, as a selective filter leaves a
    brute-force chunk."""
    dev = torch.device("cuda")
    d = torch.full((reps, nq, nx), 3.0e38, device=dev)
    cols = torch.randint(0, nx, (reps, nq, 4), generator=gen, device=dev)
    d.scatter_(2, cols, torch.rand(reps, nq, 4, generator=gen, device=dev))
    return d[0] if reps == 1 else d


def topk_times(gen, plain: bool = False) -> dict:
    """topk's device ms at each of TOPK_SHAPES over 50 distinct inputs,
    beside torch.topk's and the bound (each value read once, k pairs
    written; one compare a value); at the brute_force chunk also the plain
    version and CUDA-event times."""
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.kernels.topk.ref import topk_smallest_ref
    dev = torch.device("cuda")
    reps, rows = 50, {}
    # the main path's shapes, and the brute_force chunk of a selective filter
    for nq, nx, k, big in [(*s, False) for s in TOPK_SHAPES] + [(64, 8192, 10, True)]:
        ds_ = (mostly_big(gen, nq, nx, reps) if big
               else torch.randn(reps, nq, nx, generator=gen, device=dev))
        args = [(ds_[r],) for r in range(reps)]
        kernel = (lambda a, k=k: topk_ops.topk_smallest(a, k))
        library = (lambda a, k=k: torch.topk(a, k, dim=1, largest=False))
        b_ms, b_by = bound(4.0 * nq * nx + 8.0 * nq * k, 1.0 * nq * nx)
        row = {"ms": device_ms(kernel, args), "library_ms": device_ms(library, args),
               "bound_ms": b_ms, "bound_by": b_by}
        if plain and (nq, nx, k, big) == (*TOPK_SHAPES[0], False):
            fn = (lambda a, k=k: topk_smallest_ref(a, k))
            row["plain_ms"] = device_ms(fn, args)
            row["per_call_event_ms"] = {
                n: time_ms(f, args) for n, f in
                (("kernel", kernel), ("plain", fn), ("library", library))}
        rows[f"{nq}x{nx}k{k}" + (" mostly BIG" if big else "")] = row
        del ds_, args
    return rows


#: the 1M x 128 ivf layout's scan: 64 queries, 16 probed cells of a
#: 2,048-wide cell table over 1,024 cells (sizes uniform in [0, 2048])
SCAN_SHAPE = {"B": 64, "nprobe": 16, "nlist": 1024, "pad": 2048, "d": 128}
QDIST_TOL = {"rtol": 1e-4, "atol": 2e-3}
#: qdist all pairs against its plain version: the reference's shapes
#: (tests/test_kernels.py), ragged d, and the brute-force chunk: (nq, nx, d)
QDIST_SHAPES = [(16, 256, 128), (7, 300, 25), (64, 128, 960), (64, 8192, 128)]


def cell_table(gen, nlist: int, pad: int):
    """(cells (nlist, pad) int32 over consecutive rows, -1 padded; the row
    count; the cell sizes)."""
    dev = torch.device("cuda")
    sizes = torch.randint(0, pad + 1, (nlist,), generator=gen, device=dev)
    offsets = torch.cumsum(sizes, 0) - sizes
    t = torch.arange(pad, device=dev)
    cells = torch.where(t[None, :] < sizes[:, None], offsets[:, None] + t, -1)
    return cells.to(torch.int32).contiguous(), int(sizes.sum()), sizes


def kernel_qdist(gen) -> dict:
    from repro_torch.kernels.qdist import ops as qdist_ops
    from repro_torch.kernels.qdist.ref import BIG, qdist_cells_ref, qdist_ref

    dev = torch.device("cuda")
    err = 0.0
    for nq, nx, d in QDIST_SHAPES:
        xq, s = qdist_ops.quantize_int8(
            torch.randn(nx, d, generator=gen, device=dev))
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(nq, d, generator=gen, device=dev).to(dtype)
            # views one element off 16 bytes take the element-wise staging
            for qv, xv in ((q, xq), (offset_view(q), offset_view(xq))):
                for metric in ("l2", "ip"):
                    got = qdist_ops.quantized_distance(qv, xv, s, metric=metric)
                    want = qdist_ref(qv, xv, s, metric)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got, want, **QDIST_TOL)
                    err = max(err, float((got - want).abs().max()))

    # the cell scan at the 1M layout's shapes, with -1 rows and -1 slots
    B, nprobe, nlist, pad, d = (SCAN_SHAPE[k] for k in
                                ("B", "nprobe", "nlist", "pad", "d"))
    cells, n, sizes = cell_table(gen, nlist, pad)
    xq, s = qdist_ops.quantize_int8(torch.randn(n, d, generator=gen, device=dev))

    def probes():
        return torch.randint(0, nlist, (B, nprobe), generator=gen, device=dev,
                             dtype=torch.int32)

    scan_err = 0.0
    for metric in ("l2", "ip"):
        q = torch.randn(B, d, generator=gen, device=dev)
        rows = probes()
        rows[torch.rand(B, nprobe, generator=gen, device=dev) < 0.2] = -1
        rows[0] = -1
        got = qdist_ops.quantized_cell_scan(q, xq, s, cells, rows,
                                            metric=metric)
        want = qdist_cells_ref(q, xq, s, cells, rows, metric)
        torch.cuda.synchronize()
        dead = want == BIG
        check(bool(dead.any()) and torch.equal(got[dead], want[dead]),
              "qdist cell scan: a -1 slot is not exactly BIG")
        torch.testing.assert_close(got[~dead], want[~dead], **QDIST_TOL)
        scan_err = max(scan_err, float((got[~dead] - want[~dead]).abs().max()))
        del got, want, dead
    torch.cuda.empty_cache()

    # timed: all pairs at (64 x 8192 x 128), 50 distinct int8 tables
    nq, nx, reps = 64, 8192, 50
    q = torch.randn(nq, d, generator=gen, device=dev)
    xs, ss = qdist_ops.quantize_int8(
        torch.randn(reps * nx, d, generator=gen, device=dev))
    xfs = xs.float() * ss[:, None]     # dequantized beforehand: the product alone
    args = [(q, xs[i * nx:(i + 1) * nx], ss[i * nx:(i + 1) * nx])
            for i in range(reps)]
    lib_args = [(q, xfs[i * nx:(i + 1) * nx]) for i in range(reps)]
    kernel = (lambda a, b, c: qdist_ops.quantized_distance(a, b, c))
    plain = (lambda a, b, c: qdist_ref(a, b, c, "l2"))
    library = (lambda a, b: torch.matmul(a, b.T))
    ms, plain_ms = (device_ms(f, args) for f in (kernel, plain))
    lib_ms = device_ms(library, lib_args)
    event_ms = {"kernel": time_ms(kernel, args), "plain": time_ms(plain, args),
                "library": time_ms(library, lib_args)}
    # bytes: q, the codes with their scales, out; operations: the products
    # in two TF32 passes (int8 codes are exact in TF32), the norms and the
    # epilogue on the CUDA cores
    q_bytes = 4.0 * nq * d + (d + 4.0) * nx + 4.0 * nq * nx
    other = 2.0 * (nq + nx) * d + 5.0 * nq * nx
    b_ms, b_by = bound(q_bytes, other, 2.0 * nq * nx * d, passes=2)
    b_cuda_core_ms = bound(q_bytes, other + 2.0 * nq * nx * d)[0]
    del xs, ss, xfs, args, lib_args

    # timed: the cell scan, 50 batches of probes over the 1M-row table
    rows_list = [probes() for _ in range(reps)]
    sargs = [(torch.randn(B, d, generator=gen, device=dev), xq, s, cells, r)
             for r in rows_list]
    scan = (lambda *a: qdist_ops.quantized_cell_scan(*a))
    scan_ms = device_ms(scan, sargs)
    scan_event_ms = time_ms(scan, sargs)
    # the plain version gathers (B, nprobe * pad, d) fp32 rows: 1 GB a batch
    scan_plain_ms = device_ms(lambda *a: qdist_cells_ref(*a, "l2"), sargs[:5])
    # bound, per batch: the rows of its distinct probed cells read once,
    # with their scales and cell-table rows, the queries, probes and
    # output; operations: 2 d per live slot (the dot; the norms are minor)
    read_once, no_reuse, live = [], [], []
    for r in rows_list:
        uniq = torch.unique(r.long())
        live.append(float(sizes[r.long()].sum()))
        read_once.append(float(sizes[uniq].sum()) * (d + 4) + len(uniq) * pad * 4
                         + B * d * 4 + B * nprobe * 4 + B * nprobe * pad * 4)
        no_reuse.append(live[-1] * (d + 4))
    scan_b_ms, scan_b_by = bound(np.mean(read_once), 2.0 * np.mean(live) * d)
    cell_scan = {"shape": SCAN_SHAPE, "rows": n, "ms": scan_ms,
                 "plain_ms": scan_plain_ms, "bound_ms": scan_b_ms,
                 "bound_by": scan_b_by, "bytes_read_once": np.mean(read_once),
                 "live_slots": np.mean(live),
                 "bytes_without_l2_reuse": np.mean(no_reuse),
                 "bound_without_l2_reuse_ms": 1e3 * np.mean(no_reuse) / HBM_BYTES_S,
                 "library_ms": None, "per_call_event_ms": scan_event_ms,
                 "max_abs_err": scan_err}
    del sargs, rows_list, xq, s, cells
    return {"name": "qdist", "route": "cuda",
            "source": "src/repro_torch/csrc/qdist.cu",
            "replaces": "src/repro/kernels/qdist/qdist.py:47",
            "max_abs_err": err, "tolerance": "rtol 1e-4, atol 2e-3",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_cuda_core_ms": b_cuda_core_ms, "library_ms": lib_ms,
            "library_call": "torch.matmul(q, xf.T), xf dequantized beforehand "
                            "(the product alone)",
            "shape": [nq, nx, d], "per_call_event_ms": event_ms,
            "cell_scan": cell_scan}


#: the reference's five shapes (tests/test_kernels.py), ragged S, D 80, a
#: group of 4, window 64, softcap 30, and the policy's prefill shapes:
#: (B, S, Hq, Hk, D, window, softcap)
FLASH_SHAPES = [(2, 256, 4, 2, 64, 0, 0.0), (1, 256, 8, 8, 128, 0, 50.0),
                (2, 256, 4, 1, 80, 128, 0.0), (1, 512, 2, 2, 64, 0, 0.0),
                (1, 128, 16, 4, 128, 64, 30.0), (2, 35, 8, 2, 80, 0, 0.0),
                (1, 200, 4, 1, 64, 64, 30.0), (2, 333, 8, 2, 32, 0, 0.0),
                (6, 35, 12, 12, 64, 0, 0.0), (6, 128, 12, 12, 64, 0, 0.0)]
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
#: the folding at its limits (a group of 4, of 64), S of 1 and of 65 (a
#: second kv tile with one key), checked on the card only
FLASH_EDGE_SHAPES = [(3, 65, 16, 4, 64, 0, 0.0), (2, 65, 64, 1, 64, 0, 0.0),
                     (4, 1, 12, 12, 64, 0, 0.0), (1, 65, 8, 8, 128, 16, 0.0)]


def kernel_flash(gen) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash.ref import flash_ref

    dev = torch.device("cuda")

    def qkv(B, S, Hq, Hk, D, dtype=torch.float32, n=1):
        return [tuple(torch.randn(B, S, h, D, generator=gen, device=dev).to(dtype)
                      for h in (Hq, Hk, Hk)) for _ in range(n)]

    err = {}
    for B, S, Hq, Hk, D, win, cap in FLASH_SHAPES + FLASH_EDGE_SHAPES:
        for dtype, tol in FLASH_TOL.items():
            ((q, k, v),) = qkv(B, S, Hq, Hk, D, dtype)
            kw = dict(q_scale=D ** -0.5, window=win, softcap=cap)
            want = flash_ref(q, k, v, **kw)
            # fp32 views one float off 16 bytes take the 4-byte staging
            views = [(q, k, v)] + ([tuple(offset_view(t) for t in (q, k, v))]
                                   if dtype == torch.float32 else [])
            for qv, kv_, vv in views:
                got = flash_ops.causal_attention(qv, kv_, vv, **kw)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=tol, atol=tol)
                e = float((got.float() - want.float()).abs().max())
                err[str(dtype)] = max(err.get(str(dtype), 0.0), e)
    # strided views into one fused projection: bit-equal to contiguous ones
    fused = torch.randn(2, 35, 3, 4, 64, generator=gen, device=dev)
    q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
    check(torch.equal(flash_ops.causal_attention(q, k, v, q_scale=0.125),
                      flash_ops.causal_attention(q.contiguous(), k.contiguous(),
                                                 v.contiguous(), q_scale=0.125)),
          "flash: strided and contiguous inputs give different outputs")
    # causality: changing future kv must not change past outputs
    ((q, k, v),) = qkv(1, 256, 2, 2, 64)
    o1 = flash_ops.causal_attention(q, k, v, q_scale=0.125)
    k2, v2 = k.clone(), v.clone()
    k2[:, 128:], v2[:, 128:] = 0.0, 9.0
    o2 = flash_ops.causal_attention(q, k2, v2, q_scale=0.125)
    torch.testing.assert_close(o1[:, :128], o2[:, :128], rtol=1e-5, atol=1e-5)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=q.shape[-1] ** -0.5)

    timed = {}
    reps = 50
    for B, S, H, D in ((6, 35, 12, 64), (6, 128, 12, 64)):
        args = qkv(B, S, H, H, D, n=reps)
        kernel = (lambda q, k, v: flash_ops.causal_attention(
            q, k, v, q_scale=D ** -0.5))
        plain = (lambda q, k, v: flash_ref(q, k, v, q_scale=D ** -0.5))
        q, k, v = args[0]
        torch.testing.assert_close(sdpa(q, k, v).transpose(1, 2),
                                   flash_ref(q, k, v, q_scale=D ** -0.5),
                                   rtol=2e-3, atol=2e-3)
        ms, plain_ms = (device_ms(f, args) for f in (kernel, plain))
        lib_ms, lib_kernels = device_profile(sdpa, args)
        event_ms = {n: time_ms(f, args) for n, f in
                    (("kernel", kernel), ("plain", plain), ("library", sdpa))}
        # bytes: q, k, v read once, out written once; operations: the two
        # products over the causal triangle (3xTF32), the softmax's ~4 fp32
        # operations per score on the CUDA cores
        nbytes = 4.0 * 4 * B * S * H * D
        products = 4.0 * B * H * D * S * (S + 1) / 2
        other = 4.0 * B * H * S * (S + 1) / 2
        b_ms, b_by = bound(nbytes, other, products)
        timed[(B, S, H, D)] = {"ms": ms, "plain_ms": plain_ms,
                               "bound_ms": b_ms, "bound_by": b_by,
                               "bound_cuda_core_ms": bound(nbytes, products)[0],
                               "library_ms": lib_ms,
                               "library_kernels": top_kernels(lib_kernels, 3),
                               "per_call_event_ms": event_ms}
        del args
    main_shape, long_shape = timed
    return {"name": "flash", "route": "cuda",
            "source": "src/repro_torch/csrc/flash.cu",
            "replaces": "src/repro/kernels/flash/flash.py:84",
            "max_abs_err": err[str(torch.float32)],
            "max_abs_err_bf16": err[str(torch.bfloat16)],
            "tolerance": "fp32 rtol/atol 2e-3; bf16 rtol/atol 2e-2",
            **timed[main_shape],
            "library_call": "F.scaled_dot_product_attention(is_causal=True)",
            "shape": list(main_shape), "dtype": "float32",
            "at_shape_6x128x12x64": timed[long_shape]}


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


def top_kernels(by_kernel: dict, n: int) -> dict:
    """The n kernels with the most device us, names cut to 80 characters
    (kernels whose cut names coincide are summed, not overwritten)."""
    cut = {}
    for name, us in by_kernel.items():
        cut[name[:80]] = cut.get(name[:80], 0.0) + us
    return dict(sorted(cut.items(), key=lambda kv: -kv[1])[:n])


def busy_share(backend, queries, gt, *, ef: int, n_requests: int = 512) -> dict:
    """A traced serving window: the share of its wall time the card spent
    in kernels or copies, and the five kernels that took most of it."""
    wall, by_kernel = traced(lambda: serve_requests(
        backend, queries, gt, n_requests=n_requests, ef=ef))
    return {"traced_requests": n_requests, "traced_wall_s": wall,
            "device_busy_share": sum(by_kernel.values()) / 1e6 / wall,
            "top_device_us": top_kernels(by_kernel, 5)}


#: the ivf cell of serve-1M: nlist ~ sqrt(N) (the usual IVF1024 setting for
#: SIFT1M), 16 cells probed at ef 64, cells capped at about twice the mean
IVF_1M = {"nlist": 1024, "nprobe": 16, "kmeans_iters": 8, "max_cell": 2048,
          "rerank_factor": 2}


def kernel_counters() -> dict:
    from repro_torch.kernels.distance import ops as dist_ops
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.qdist import ops as qdist_ops
    from repro_torch.kernels.topk import ops as topk_ops
    return {"distance": dist_ops, "topk": topk_ops, "qdist": qdist_ops,
            "flash": flash_ops}


def zero_counts(counters) -> None:
    for m in counters.values():
        m.launches = 0
    counters["qdist"].scan_launches = 0


def read_counts(counters) -> dict:
    """Each kernel's launches, and qdist's cell-scan entry's among them."""
    counts = {name: m.launches for name, m in counters.items()}
    counts["qdist.cell_scan"] = counters["qdist"].scan_launches
    return counts


def all_cells_recall(backend, ds, n: int = 64) -> dict:
    """recall@10 against the exact gt of one batch at the all-cells probe
    (int8 scan over every cell, a shortlist of 320): checks the 1M
    pipeline end to end, whatever recall the serving efs reach."""
    from repro_torch.anns import SearchParams
    from repro_torch.anns.datasets import recall_at_k
    ef = backend.search_ef_ladder()[-1]
    res = backend.search(ds.queries[:n], SearchParams(k=10, ef=ef,
                                                       rerank_factor=32))
    rec = recall_at_k(res.ids.cpu().numpy(), ds.gt[:n], 10)
    check(rec >= 0.99, f"ivf at the all-cells probe: recall@10 {rec}")
    return {"ef": ef, "nprobe": int(res.steps), "queries": n,
            "recall@10": rec}


def phase_main(n_base: int, n_query: int, n_requests: int) -> dict:
    """Serve every backend at SIFT1M scale; returns the kernels' launches
    of each backend's serving runs, by path."""
    import dataclasses

    from repro_torch.anns import make_dataset, registry
    from repro_torch.anns.engine import GLASS_BASELINE, VariantConfig

    t0 = time.perf_counter()
    ds = make_dataset("sift-128-euclidean", n_base=n_base, n_query=n_query,
                      device="cuda")
    check(ds.gt.shape == (n_query, 100) and ds.gt.min() >= 0
          and ds.gt.max() < n_base, "ground truth malformed")
    emit({"phase": "main.dataset", "n_base": n_base, "n_query": n_query,
          "dim": int(ds.base.shape[1]), "seconds": time.perf_counter() - t0})

    ivf = VariantConfig(backend="ivf", **IVF_1M)
    variants = {name: dataclasses.replace(GLASS_BASELINE, backend=name)
                for name in ("brute_force", "graph", "quantized_prefilter")}
    variants["ivf"] = ivf
    variants["sharded"] = dataclasses.replace(ivf, backend="sharded",
                                              n_shards=2)
    counters = kernel_counters()
    launches = {}
    for name, variant in variants.items():
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backend = registry.create(name, variant, metric=ds.metric,
                                  device="cuda")
        backend.build(ds.base)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        row = {"phase": "main.serve", "backend": name, "build_s": build_s,
               "variant": variant.describe(),
               "device_bytes": backend.memory_bytes(),
               "build_peak_bytes": torch.cuda.max_memory_allocated()}
        if name == "ivf":
            from repro_torch.anns.ivf import ivf_stats
            row["layout"] = ivf_stats(backend.index)
            row["all_cells"] = all_cells_recall(backend, ds)
        elif name == "sharded":
            row["layout"] = backend.stats()
        efs = (64,) if name in ("brute_force", "quantized_prefilter") \
            else (16, 64, 256)
        runs = []
        for ef in efs:
            zero_counts(counters)
            runs.append(serve_requests(backend, ds.queries, ds.gt,
                                       n_requests=n_requests, ef=ef))
            runs[-1]["launches"] = read_counts(counters)
        row["runs"] = runs
        row["trace_ef64"] = busy_share(backend, ds.queries, ds.gt, ef=64)
        emit(row)
        served = next(r for r in runs if r["ef"] == 64)
        finite = all(np.isfinite(v) for v in served.values()
                     if isinstance(v, float))
        check(finite, f"{name}: non-finite metrics {served}")
        launches[f"serve.{name}"] = {k: sum(r["launches"][k] for r in runs)
                                     for k in runs[0]["launches"]}
        if name == "brute_force":
            check(served["recall@10"] >= 0.999,
                  f"brute_force recall@10 {served['recall@10']} < 0.999")
        if name in ("brute_force", "ivf", "sharded"):
            needed = ("distance", "topk") + (("qdist",) if name != "brute_force"
                                             else ())
            for r in runs:
                check(all(r["launches"][k] > 0 for k in needed),
                      f"{name} ef={r['ef']}: the main path launched no "
                      f"{needed} kernel: {r['launches']}")
        if len(runs) == 3:
            rec = [r["recall@10"] for r in runs]
            check(rec[1] >= rec[0] - 0.01 and rec[2] >= rec[1] - 0.01,
                  f"{name} recall falls as ef grows: {rec}")
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
    from repro_torch.anns.engine import (GLASS_BASELINE, IVF_BASELINE,
                                         SHARDED_BASELINE, VariantConfig)
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

    exact = registry.create("brute_force", metric=ds.metric, device="cuda")
    exact.build(ds.base)
    exact_res = exact.search(ds.queries, SearchParams(k=10))
    ivf_ids = {}
    for label, variant in [("ivf", IVF_BASELINE)] + [
            (f"sharded-{n}", dataclasses.replace(SHARDED_BASELINE, n_shards=n))
            for n in (1, 2, 4)]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backend = registry.create(variant.backend, variant, metric=ds.metric,
                                  seed=0, device="cuda")
        backend.build(ds.base)
        torch.cuda.synchronize()
        row = {"phase": "ref20k", "variant": label,
               "build_s": time.perf_counter() - t0, "recall@10": {},
               "reference": REF_RECALL_20K[label]}
        ids = {}
        for ef in (16, 64, 256):
            ids[ef] = backend.search(ds.queries, SearchParams(k=10, ef=ef)).ids
            row["recall@10"][ef] = recall_at_k(ids[ef].cpu().numpy(), ds.gt, 10)
        for ef, r in REF_RECALL_20K[label].items():
            check(abs(row["recall@10"][ef] - r) <= 0.02,
                  f"{label} ef={ef}: recall {row['recall@10'][ef]} vs "
                  f"reference {r}")
        if label == "ivf":
            ivf_ids = ids
            row.update(all_cells_vs_brute_force(backend, ds, exact_res))
        if label == "sharded-1":
            same = all(torch.equal(ids[ef], ivf_ids[ef]) for ef in ids)
            row["ids_equal_ivf"] = same
            check(same, "sharded at 1 shard does not return ivf's ids")
        emit(row)
        del backend
    del exact

    rec = serve.main(["--n-base", "20000", "--n-query", "256",
                      "--n-requests", "512", "--backend", "brute_force"])
    check(rec >= 0.999, f"serve CLI brute_force recall {rec}")
    emit({"phase": "ref20k.cli", "backend": "brute_force", "recall@10": rec})
    for argv in (["--backend", "ivf", "--nlist", "128"],
                 ["--backend", "sharded", "--nlist", "128", "--n-shards", "2"]):
        rec = serve.main(["--n-base", "20000", "--n-query", "256",
                          "--n-requests", "512", *argv])
        check(np.isfinite(rec) and rec > 0.5, f"serve CLI {argv}: recall {rec}")
        emit({"phase": "ref20k.cli", "argv": argv, "recall@10": rec})


def all_cells_vs_brute_force(backend, ds, exact_res) -> dict:
    """ivf at the all-cells probe (int8 scan, a shortlist of 80) against the
    exact anchor: a row may differ only where the two lists are equally
    near (a rounding tie at the cut, as brute_force's own 0.999)."""
    from repro_torch.anns import SearchParams
    ef = backend.search_ef_ladder()[-1]
    res = backend.search(ds.queries, SearchParams(k=10, ef=ef,
                                                  rerank_factor=8))
    got = np.sort(res.ids.cpu().numpy(), 1)
    want = np.sort(exact_res.ids.cpu().numpy(), 1)
    differ = np.flatnonzero((got != want).any(axis=1))
    for r in differ:
        np.testing.assert_allclose(res.dists[r].cpu().numpy(),
                                   exact_res.dists[r].cpu().numpy(),
                                   rtol=1e-4, atol=2e-3,
                                   err_msg=f"ivf all-cells row {r} is no tie")
    share = 1.0 - len(differ) / len(got)
    return {"all_cells_ef": ef, "all_cells_rows_equal_brute_force": share,
            "all_cells_rows_at_a_tie": int(len(differ))}


# ---------------------------------------------------------------------------
# 6. the CRINN RL loop
# ---------------------------------------------------------------------------
RL_ITERS = 2
KL_ROUNDING = 1e-6
RL_EF_SWEEP = (16, 24, 32, 48, 64, 96, 128)


def glass_curve(ds) -> dict:
    """recall@10 and QPS of the GLASS baseline over the RL loop's ef sweep,
    and its banded AUC (the reward's denominator)."""
    from repro_torch.anns import SearchParams, registry
    from repro_torch.anns.bench import measure_point
    from repro_torch.anns.engine import GLASS_BASELINE
    from repro_torch.core.reward import banded_auc
    backend = registry.create("graph", GLASS_BASELINE, metric=ds.metric,
                              device="cuda")
    backend.build(ds.base)
    pts = [measure_point(backend, ds, params=SearchParams(k=10, ef=ef),
                         repeats=2) for ef in RL_EF_SWEEP]
    rec = [p.recall for p in pts]
    qps = [p.qps for p in pts]
    return {"n_base": len(ds.base), "ef": list(RL_EF_SWEEP), "recall@10": rec,
            "qps": qps, "banded_auc": banded_auc(np.array(rec), np.array(qps))[0]}


def _cpu_copy(obj):
    """``obj`` (nested dicts of tensors and numbers) with every tensor
    copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: _cpu_copy(v) for k, v in obj.items()}
    return obj


def check_first_update(opt, first: dict, loss_and_grad) -> dict:
    """The card's first GRPO + AdamW step whose group has non-zero
    advantages, against the same step on the CPU from the same weights,
    optimizer state and batch: the loss within 1e-5 and the new weights
    within 1e-6 on at least 99.9% of elements and within 2.5 lr on all (a
    near-zero gradient whose sign differs moves a weight by up to about
    2 lr).  A group whose rewards are all equal has zero advantages: its
    gradient is rounding noise, which AdamW scales to steps of ~lr on
    either side, so it is no comparison."""
    from repro_torch.models import model
    from repro_torch.optim.adamw import adamw_update
    check("batch" in first and "after" in first,
          "no update with non-zero advantages was recorded")
    t0 = time.perf_counter()
    cpu = model.DecoderLM(opt.policy.cfg, device="cpu")
    params = dict(cpu.named_parameters())
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(first["before"][n])
    (loss, _), grads = loss_and_grad(cpu, first["batch"], opt.policy.rt,
                                     opt.gcfg)
    adamw_update(params, grads, first["state"], opt.opt_cfg)
    diff = torch.cat([(first["after"][n] - p.detach()).abs().flatten()
                      for n, p in params.items()])
    lr = opt.opt_cfg.lr
    out = {"loss_card": first["loss"], "loss_cpu": float(loss),
           "max_abs_diff": float(diff.max()),
           "share_within_1e-6": float((diff <= 1e-6).double().mean()),
           "elements": diff.numel(), "lr": lr, "step": first["step"],
           "batch_shape": list(first["batch"]["tokens"].shape),
           "cpu_seconds": time.perf_counter() - t0}
    check(abs(out["loss_card"] - out["loss_cpu"]) <= 1e-5
          and out["share_within_1e-6"] >= 0.999
          and out["max_abs_diff"] <= 2.5 * lr,
          f"the card's first update differs from the CPU's: {out}")
    return out


def phase_rl() -> dict:
    """``train_crinn.main`` on the card; returns the kernels' launches of
    the run.  Rollouts are recorded by wrapping ``Policy.sample_group``."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import Policy
    from repro_torch.core.variant_space import BACKEND_CHOICES, MODULE_ORDER
    from repro_torch.launch import train_crinn
    from repro_torch.models import model

    from repro_torch.core import optimizer_loop

    groups = []
    sample_group = Policy.sample_group
    loss_and_grad = optimizer_loop.grpo_loss_and_grad
    update_policy = optimizer_loop.CrinnOptimizer._update_policy
    first = {}          # the first update's batch and weights, on the CPU

    def recording(self, *args, **kwargs):
        out = sample_group(self, *args, **kwargs)
        groups.append(out)
        return out

    def recording_grad(model_, batch, *args):
        if first.get("armed"):
            first["batch"] = {k: v.cpu() for k, v in batch.items()}
        return loss_and_grad(model_, batch, *args)

    def recording_update(self, rollouts, rewards):
        if "after" in first or np.ptp(rewards) == 0:
            return update_policy(self, rollouts, rewards)
        first["armed"] = True
        first["step"] = self.opt_state["step"]
        first["state"] = _cpu_copy(self.opt_state)
        first["before"] = {n: p.detach().cpu().clone()
                           for n, p in self.params.items()}
        out = update_policy(self, rollouts, rewards)
        first["armed"] = False
        first["after"] = {n: p.detach().cpu() for n, p in self.params.items()}
        first["loss"] = out[0]
        return out

    Policy.sample_group = recording
    optimizer_loop.grpo_loss_and_grad = recording_grad
    optimizer_loop.CrinnOptimizer._update_policy = recording_update
    torch.cuda.reset_peak_memory_stats()
    counters = kernel_counters()
    try:
        zero_counts(counters)
        res = train_crinn.main(["--iters", str(RL_ITERS), "--out",
                                os.path.join(ROOT, "build", "crinn_run.json")])
        launches = read_counts(counters)
    finally:
        Policy.sample_group = sample_group
        optimizer_loop.grpo_loss_and_grad = loss_and_grad
        optimizer_loop.CrinnOptimizer._update_policy = update_policy
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    opt = res["optimizer"]
    hist = opt.history

    check(res["param_count"] == get_config("crinn-policy-100m").param_count(),
          "the policy is not crinn-policy-100m at full width and depth")
    check(res["baseline_auc"] > 0, f"graph baseline AUC {res['baseline_auc']}")
    check(res["modules"] == list(MODULE_ORDER) and res["skipped_modules"] == [],
          f"modules run {res['modules']}, skipped {res['skipped_modules']}")
    check(len(groups) == len(hist) == len(MODULE_ORDER) * RL_ITERS,
          f"{len(groups)} groups sampled, {len(hist)} iterations logged")
    rollouts = [r for g in groups for r in g]
    check(all(r.program is not None for r in rollouts),
          "a rollout did not decode to a program")
    for h in hist:
        check(all(np.isfinite(x) and 0.0 <= x < 2.0 for x in h.rewards),
              f"[{h.module}] reward outside [0, 2): {h.rewards}")
        # k3 KL = exp(d) - d - 1 >= 0 exactly; in fp32 it lands a few 1e-9
        # below 0 where d ~ 0 (one inner epoch: rollout = reference policy)
        check(np.isfinite(h.loss) and np.isfinite(h.kl) and h.kl >= -KL_ROUNDING,
              f"[{h.module}] loss {h.loss} kl {h.kl}")
    # the backend module's candidates are each family's baseline with the
    # running knobs: a family whose baseline curve never enters the
    # reward's recall band (ivf, sharded and brute_force at 5,000 vectors
    # sit above 0.95) has baseline AUC 0 and scores every candidate 0, so
    # that module is held per rollout; the others need some reward > 0
    backend_rollouts = [
        (ro.program.knobs()["backend"], x)
        for g, h in zip(groups, hist) if h.module == "backend"
        for ro, x in zip(g, h.rewards)]
    for family, x in backend_rollouts:
        check(x > 0 or opt.baselines.get(family) == 0.0,
              f"backend module: a {family} rollout scored {x} though its "
              f"family's baseline AUC is {opt.baselines.get(family)}")
    for m in res["modules"]:
        if m == "backend":
            continue
        check(any(x > 0 for h in hist if h.module == m for x in h.rewards),
              f"module {m}: no reward > 0")
    check(launches["flash"] == 12 * len(groups) and launches["flash"] > 0,
          f"flash launches {launches['flash']} != 12 x {len(groups)} groups")
    families = [f for f in BACKEND_CHOICES if opt.baselines.has(f)]
    if {"ivf", "sharded"} & set(families):
        check(launches["qdist"] > 0,
              f"ivf-family variants were evaluated ({families}) but qdist "
              f"launched {launches['qdist']} times")
    init = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                             opt.policy.cfg, "cuda")
    moved = {n: float((p.detach() - q.detach()).abs().max())
             for (n, p), q in zip(opt.policy.model.named_parameters(),
                                  init.parameters())}
    check(max(moved.values()) > 0, "the updates left the policy unchanged")
    first_update = check_first_update(opt, first, loss_and_grad)

    per_module = {}
    for m in res["modules"]:
        hs = [h for h in hist if h.module == m]
        split = {k: sum(getattr(h, k) for h in hs)
                 for k in ("rollout_s", "reward_s", "update_s")}
        split["seed_eval_s"] = res["module_seconds"][m] - sum(split.values())
        per_module[m] = {"seconds": res["module_seconds"][m], **split,
                         "rewards": [h.rewards for h in hs],
                         "loss": [h.loss for h in hs], "kl": [h.kl for h in hs]}

    # the reward's sensor at the loop's size and at 20,000 vectors
    from repro_torch.anns import make_dataset
    sizes = [glass_curve(opt.ds),
             glass_curve(make_dataset("sift-128-euclidean", n_base=20_000,
                                      n_query=100, device="cuda"))]

    # where a rollout's time goes: one traced group at the loop's shapes
    from repro_torch.core import prompting
    prompt = prompting.build_prompt(
        "search", opt.db.sample("search", 4, np.random.default_rng(1)))
    wall, by_kernel = traced(lambda: opt.policy.sample_group(
        "search", prompt, 6, opt.generator))
    flash_us = sum(us for name, us in by_kernel.items() if "flash" in name)

    emit({"phase": "rl", "param_count": res["param_count"],
          "baseline_auc": res["baseline_auc"], "modules": res["modules"],
          "skipped_modules": res["skipped_modules"],
          "backend_chosen": opt.current.backend,
          "backend_rollouts": backend_rollouts,
          "families_evaluated": families,
          "family_baseline_auc": {f: opt.baselines.get(f) for f in families},
          "launches": launches,
          "per_module": per_module, "peak_device_bytes": peak,
          "groups": len(groups),
          "params_moved": sum(v > 0 for v in moved.values()),
          "params_total": len(moved), "first_update": first_update,
          "final_variant": res["final_variant"],
          "final_reward": res["final_reward"], "glass_curves": sizes,
          "rollout_trace": {"prompt_len": len(prompt), "wall_s": wall,
                            "device_busy_share": sum(by_kernel.values()) / 1e6 / wall,
                            "flash_device_us": flash_us,
                            "top_device_us": top_kernels(by_kernel, 6)}})
    return launches


def main() -> None:
    phase_device()
    phase_build()
    kernels = phase_kernels()
    launches = phase_main(n_base=1_000_000, n_query=10_000, n_requests=2048)
    phase_ref20k()
    launches["rl"] = phase_rl()
    emit({"phase": "total", "seconds": time.perf_counter() - T_START})
    for name, row in kernels.items():
        by_path = {path: n[name] for path, n in launches.items() if n[name]}
        check(by_path, f"{name} was launched on no path")
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    # qdist's launches by entry (the all-pairs entry has no caller on
    # these paths)
    scans = sum(n["qdist.cell_scan"] for n in launches.values())
    kernels["qdist"]["launches_by_entry"] = {
        "all_pairs": kernels["qdist"]["launches"] - scans, "cell_scan": scans}
    emit({"kernels": list(kernels.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


#: ``--kernel-times NAME``: the kernels whose timing runs alone
KERNEL_TIMES = {"distance": distance_times, "topk": topk_times}


def kernel_times_main(args: list) -> None:
    """``--kernel-times NAME [SRC]``: time kernel NAME alone at the main
    path's shapes, with the same method as the full run, from the
    repro_torch under SRC (another checkout, e.g. a parent commit unpacked
    with ``git archive``) or this tree's."""
    name, src = args[0], args[1] if len(args) > 1 else os.path.join(ROOT, "src")
    check(name in KERNEL_TIMES, f"--kernel-times: {name} not in {list(KERNEL_TIMES)}")
    sys.path.insert(0, os.path.abspath(src))
    phase_device()
    import repro_torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    emit({"phase": "kernel_times", "kernel": name,
          "package": os.path.dirname(repro_torch.__file__),
          "shapes": KERNEL_TIMES[name](gen)})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kernel-times"]:
        kernel_times_main(sys.argv[2:])
    else:
        main()
