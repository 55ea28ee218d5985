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
               mostly BIG, k = 300 and 471 over 123 chunks' merge and
               k = nx past the row sort's 28,672 values, to 100,000 (the
               step sort); flash
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
               before and read just after each serving run.  brute_force
               also serves k = 471 (its merge is 123 x 471 values wide),
               recall@471 against exact gt; ivf and sharded go through
               save_index / load_index (onto cuda), ids at ef 64 on 2,048
               queries bit-identical to the built index's.
5. tune     -- the SLO autotuner on the 1M ivf and sharded indexes:
               sweep_frontier over the whole nprobe ladder, to the
               all-cells probe, on a 256-query view of the dataset (the
               ivf search holds (queries, nprobe x cell_pad) slots at once,
               ~41 bytes each at the sweep's peak: all 10,000 queries at
               the all-cells probe would need ~1.3 TB); each rung's nprobe
               as searched (the ladder's, raised to the floor of cells
               that hold k vectors); recall must not fall along the
               ladder and must reach 0.99 at the all-cells probe; then an
               AnnsServer in SLO mode (RecallSLO(0.9)) serves 512
               requests within 0.02 of its pick's swept recall.  Counters
               as for main.
6. stream   -- the streaming indexes at 1M: stream_ivf (tail 16,384) and
               stream_sharded (2 shards, 8,192 a shard) adopt the main
               phase's ivf and sharded indexes (their to_state_dict(), no
               second build), served through AnnsServer at ef 64 and 384
               in five stages: (1) an empty tail, the base saved; (2) 10 x
               1,000 inserts and 10,000 deletes, two save_index_deltas on
               the way; (3) compact(); (4) load_index of base + deltas onto
               the card; (5) serving while a BackgroundCompactor prepares,
               warms and commits on a second thread.  Checks: every
               inserted vector returns its own id at rank 0 before and
               after compaction, no deleted id is served, recall@10 against
               the live gt within 0.02 of the read-only ivf's and >= 0.99
               at the all-cells probe, a twin given the same history
               compacts to the same bytes, the replayed index gives the
               stage-2 ids, stage 5 serves only live ids, and
               stream_sharded returns stream_ivf's ids at every stage.
               On each layout served (before compaction, after it, after
               the background one), the probe's distance and topk at
               each ef and at every cell, the cell scan of those probes
               (each shard's table for stream_sharded) and compaction's
               and insert routing's assignment chunks are held against
               their plain versions on the same inputs; those launches
               are not the path's.
7. async    -- the AsyncServeTier over the 1M ivf, tenants
               gold:0.95:3:20,bronze:0.6:1 picked from tune's frontier,
               max_batch 64, max_queue 256: a burst of 768 submissions
               before the serve loop runs (exactly 256 admitted, 512 typed
               Overloaded), then 4,096 requests (3 gold : 1 bronze) from an
               asyncio loop, each a distinct row of the 10,000 queries
               scored against its own gt row, then close(drain=True).  Checks: the
               accounting invariant, no batch mixing the tenants' picks,
               one batch shape per tenant group, each tenant's served
               recall within 0.02 of its pick's swept recall.  Counters for
               stream and async as for main.
8. ref20k   -- recall@10 of graph / quantized_prefilter / ivf / sharded
               (1, 2, 4 shards) at 20,000 vectors against the JAX package's
               numbers on the same data; sharded at 1 shard returns ivf's
               ids, ivf at the all-cells probe brute_force's; the optimized
               (alpha-pruned) variant, and the serve CLI: each read-only
               backend served with --save-index here and with --load-index
               in a separate process at the same recall, --tune
               --save-frontier then --load-frontier --target-recall 0.9,
               --filter-demo, the streaming-drift episode (--backend
               stream_ivf --stream-demo) and the multi-tenant one (--async
               --tenants), each printing the reference tests' markers.
9. rl       -- the CRINN RL loop through ``repro_torch.launch.train_crinn``:
               the 114M-parameter policy (fp32, full width and depth) samples
               GRPO groups of 6 programs, each built and swept on the engine
               at 5,000 x 128 and scored by the banded AUC, then takes a
               GRPO + AdamW step; 1 iteration of each of the five modules,
               ``backend`` first (2 before the zoo phase came: the
               graph_construction module's builds take 120-610 s).  The kernels' counters are set to 0 just
               before and read just after.  The first update is held
               against the same GRPO + AdamW step on the CPU from the same
               weights and batch.
10. train   -- ``repro_torch.launch.train`` at full width (crinn-policy-100m,
               bf16, 24 GRPO steps of seq 128 x batch 8, block remat, a
               checkpoint every 6 steps, each save timed on the caller's
               thread); ``--resume --steps 4`` in a separate process
               (``resumed from step 24``); a failure drill (failure at
               step 9, checkpoints every 4: step 8 replayed at an equal
               loss); the first step that moves the weights on the card
               against the CPU (fp32; loss within 1e-5 relative, weights
               within 1e-6 on >= 99.99%); one lm_loss step at seq 1024 x
               batch 8 with remat none and block (losses at rtol 1e-6,
               gradients within 1e-5 in norm, both peaks); h2o-danube-1.8b
               at full width (24 layers, d 2,560, 32 / 8 heads of 80): 2
               lm_loss trainer steps at seq 512 x batch 4, then a
               GenerateServer call of (4, 256) prompts + 32 greedy steps
               whose counted launches must be 24 flash (one a layer), and
               in fp32 prefill + one decode step against the forward's
               last logits at 1e-3.  The counters are set to 0 just before
               and read just after the GenerateServer call (the training
               path launches no kernel of the port: its attention is the
               reference's chunked PyTorch path, which has a backward).

11. zoo     -- the moe, hybrid, ssm, audio and vlm families at full width
               (bf16, seed-0 weights; ``param_count`` equal to the JAX
               package's, held as constants), each through a
               GenerateServer call of (4, 256) prompts (stub frame / patch
               embeddings for musicgen and internvl2) + 32 greedy steps
               whose flash launches must be one per attention layer:
               jamba-v0.1-52b at 16 of 32 layers (2 launches), traced, and
               in fp32 at 8 layers prefill + decode against the forward at
               (2, 64), capacity factor 8; deepseek-moe-16b whole (28
               launches), traced, then 2 lm_loss + aux Trainer steps at
               512 x 4, block remat, at 4 of 28 layers; rwkv6-1.6b whole
               (no port kernel: attention-free), 2 such steps and the
               fp32 check; musicgen-medium whole (48); internvl2-26b at 8
               of 48 layers (8, GQA 48 / 8); dbrx-132b at 2 of 40 (2).
               The counters are set to 0 before and read after each
               GenerateServer call.
12. dist    -- the distributed substrate (``repro_torch.dist``): the mesh
               path at world 1 over NCCL -- ``launch.train --debug-mesh
               1x1`` (crinn-policy-100m, bf16, seq 128 x batch 8, 4 steps,
               a rank process of its own) with losses bit-equal to the
               one-device run, and deepseek-moe-16b at 4 of 28 layers, two
               lm_loss + 0.01 aux Trainer steps through the expert-parallel
               MoE at tp 1 with losses and aux bit-equal to the local
               branch's; step ms beside the one-device step ms, and the
               collective bytes counted.  Then two ranks on the one card
               over Gloo with CUDA tensors: deepseek's MoE layer at full
               width (fp32, 64 experts split 32 / 32) within 1e-4 of the
               local layer, aux equal; glm4-9b's attention (32 / 2 heads of
               128) prefilled through the flash kernel into a cache of
               8,192 positions split in two, one decode step within 1e-4 of
               the plain decode; compressed_allreduce over
               crinn-policy-100m's gradient tree equal to the sum of both
               ranks' codes times the mean scale.  The counters are set to
               0 before and read after each rank's prefill.
13. shard_mesh -- run after async: main's 1M sharded index (2 shards)
               saved under build/, a stream_sharded copy of it and a 20k
               index of the same variant too; two ranks on the one card
               over Gloo with CUDA tensors each load_index onto the card,
               place_on_mesh (one shard a rank) and serve 2,048 queries in
               batches of 64 at ef 64 and the all-cells probe (the stream
               copy after the same 1,000 inserts and 1,000 deletes on both
               ranks); rank 0's ids and dists bit-equal to the
               single-device backends', each rank's device bytes within
               10% of device_memory_bytes(), the merge bytes a batch the
               closed form at 1M and 20k alike; placed QPS recorded beside
               the single-device QPS.  Then one leader episode on the
               placed stream_sharded copy: rank 0 serves through a Leader
               (repro_torch.dist.leader) and rank 1 replays its op stream:
               the nprobe ladder swept on 64 queries, async-1M's tenants
               resolved against that frontier, its burst of 768, then
               2,048 mixed requests; 400 inserts after window 2 trip the
               tail verdict and a BackgroundCompactor prepares and commits
               while serving goes on; 200 deletes, the last window after
               the swap.  Checks: rank 0's op log replayed on the
               single-device copy gives every batch's ids and dists bit
               for bit, exactly 256 admitted and 512 Overloaded, the
               accounting invariant, both ranks at the same epoch (1) and
               seqno, no deleted id served, the op stream's bytes the
               closed form (a 256-byte header a record, B x d x 4 query
               bytes a batch).  Each rank sets the counters to 0 before
               and reads them after each serving round and the episode;
               the ranks' launches are the path's.
14. dryrun  -- ``python -m repro_torch.launch.dryrun`` in a subprocess
               (CPU and meta tensors, a fake process group of 256 / 512
               ranks) for glm4-9b x train_4k at both meshes and
               deepseek-moe-16b x decode_32k at 16x16: per-rank argument
               bytes equal to the specs' local_shape sum, collective
               bytes equal to gather-on-use's closed form.

Then a ``{"kernels": [...]}`` line and, last, the device line the checks
read.  Imports nothing of JAX or of the ``repro`` package.

    python3 chip_smoke.py --kernel-times NAME [PATH/src]

times only kernel NAME (distance or topk) at the main path's shapes, with
the same method, from the ``repro_torch`` under PATH/src (another
checkout, e.g. a parent commit unpacked with ``git archive``) or this
tree's, and prints one JSON line.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
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
#: two, its int8 codes being exact in TF32), and bf16 FLOP/s on them (the
#: least time of a product of bf16 inputs, flash's at the danube prefill)
HBM_BYTES_S = 3.35e12
FP32_FLOPS_S = 67e12
TF32_FLOPS_S = 495e12
BF16_FLOPS_S = 989e12

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
    from repro_torch.kernels.topk import topk as topk_kernel
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
    def kernels_a_call(nx: int, k: int) -> int:
        """One launch, or the step sort's one per step plus a merge per
        halving of the runs."""
        if k <= topk_kernel.K_WARP_MAX or nx <= topk_kernel.SORT_MAX_NX:
            return 1
        steps = -(-nx // topk_kernel.STEP_NX)
        return 1 + (steps - 1).bit_length()

    def check_topk(dm: torch.Tensor, k: int) -> None:
        before = topk_ops.launches
        v, i = topk_ops.topk_smallest(dm, k)
        wv, wi = topk_smallest_ref(dm, k)
        torch.cuda.synchronize()
        where = f"{tuple(dm.shape)} k={k}"
        want = kernels_a_call(dm.shape[1], k)
        check(topk_ops.launches == before + want,
              f"topk: {topk_ops.launches - before} launches, not {want}, at {where}")
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
#: ef 64 and at the all-cells probe, a k-means assignment, the tune sweep's
#: coarse probe of 256 queries over 1,569 cells at its widest rungs)
TOPK_CHECKS = [(8, 128, 10), (5, 1000, 32), (16, 333, 100), (1, 50, 5),
               (9, 2048, 64), (64, 8192, 10), (64, 8192, 100), (64, 8192, 1),
               (64, 1230, 10), (4, 40000, 16), (64, 1569, 16),
               (64, 1569, 1569), (4096, 1024, 1), (3, 9000, 256),
               (3, 9001, 257), (7, 4097, 1), (64, 123 * 300, 300),
               (64, 123 * 471, 471), (2, 100_000, 100_000),
               (2, 40_000, 40_000), (256, 1569, 192), (256, 1569, 256),
               (256, 1569, 1569)]
#: the main path's topk shapes, timed: (nq, nx, k); then the step sort's
#: (k > 256 past the row sort: brute_force merges at k 300 and 471, k = nx)
#: and the tune sweep's coarse probe over the 1M layout's 1,569 cells
TOPK_SHAPES = [(64, 8192, 10), (64, 1230, 10), (64, 1569, 16),
               (64, 1569, 1569), (4096, 1024, 1), (64, 123 * 300, 300),
               (2, 30_000, 30_000), (64, 123 * 471, 471),
               (2, 100_000, 100_000), (256, 1569, 192), (256, 1569, 1569)]


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
    # k = nx past the row sort's 28,672 values: the step sort
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
    """topk's device ms at each of TOPK_SHAPES over 50 distinct inputs (20
    at k = nx past the row sort), beside torch.topk's and the bound (each
    value read once, k pairs written; one compare a value); at the
    brute_force chunk also the plain version and CUDA-event times."""
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.kernels.topk.ref import topk_smallest_ref
    dev = torch.device("cuda")
    rows = {}
    # the main path's shapes, and the brute_force chunk of a selective filter
    for nq, nx, k, big in [(*s, False) for s in TOPK_SHAPES] + [(64, 8192, 10, True)]:
        reps = 20 if k > 20_000 else 50
        ds_ = (mostly_big(gen, nq, nx, reps) if big
               else torch.randn(reps, nq, nx, generator=gen, device=dev))
        args = [(ds_[r],) for r in range(reps)]
        kernel = (lambda a, k=k: topk_ops.topk_smallest(a, k))
        library = (lambda a, k=k: torch.topk(a, k, dim=1, largest=False))
        b_ms, b_by = bound(4.0 * nq * nx + 8.0 * nq * k, 1.0 * nq * nx)
        name = f"{nq}x{nx}k{k}" + (" mostly BIG" if big else "")
        row = {"ms": device_ms(kernel, args), "library_ms": device_ms(library, args),
               "bound_ms": b_ms, "bound_by": b_by}
        if plain and (nq, nx, k, big) == (*TOPK_SHAPES[0], False):
            fn = (lambda a, k=k: topk_smallest_ref(a, k))
            row["plain_ms"] = device_ms(fn, args)
            row["per_call_event_ms"] = {
                n: time_ms(f, args) for n, f in
                (("kernel", kernel), ("plain", fn), ("library", library))}
        rows[name] = row
        del ds_, args
    return rows


#: the 1M x 128 ivf layout's scan: 64 queries, 16 probed cells of a
#: 2,048-wide cell table over 1,024 cells (sizes uniform in [0, 2048])
SCAN_SHAPE = {"B": 64, "nprobe": 16, "nlist": 1024, "pad": 2048, "d": 128}
QDIST_TOL = {"rtol": 1e-4, "atol": 2e-3}
#: the tune sweep's scan: 256 queries over the 1M layout's 1,569 cells at
#: its widest rungs, 256 cells and every cell; the queries held against the
#: plain gather (about 4 GB a query at every cell)
SWEEP_SCAN = {"B": 256, "nlist": 1569, "pad": 2048, "d": 128,
              "nprobe": (256, 1569), "checked": (0, 1, 128, 255)}
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


def check_sweep_scan(gen) -> float:
    """The cell scan at SWEEP_SCAN's shapes, launched for the whole batch;
    each probe a query's own permutation of the cells, as the coarse
    top-k gives them, and on odd queries the odd cells -1, as a shard of
    two sees the other's.  Returns the largest error of a live slot."""
    from repro_torch.kernels.qdist import ops as qdist_ops
    from repro_torch.kernels.qdist.ref import BIG, qdist_cells_ref

    dev = torch.device("cuda")
    B, nlist, pad, d = (SWEEP_SCAN[k] for k in ("B", "nlist", "pad", "d"))
    cells, n, _ = cell_table(gen, nlist, pad)
    xq, s = qdist_ops.quantize_int8(torch.randn(n, d, generator=gen, device=dev))
    err = 0.0
    for nprobe in SWEEP_SCAN["nprobe"]:
        perm = torch.argsort(torch.rand(B, nlist, generator=gen, device=dev), dim=1)
        rows = perm[:, :nprobe].to(torch.int32)
        rows[1::2][rows[1::2] % 2 == 1] = -1
        q = torch.randn(B, d, generator=gen, device=dev)
        for metric in ("l2", "ip"):
            got = qdist_ops.quantized_cell_scan(q, xq, s, cells, rows,
                                                metric=metric)
            for b in SWEEP_SCAN["checked"]:
                want = qdist_cells_ref(q[b:b + 1], xq, s, cells,
                                       rows[b:b + 1], metric)[0]
                torch.cuda.synchronize()
                dead = want == BIG
                check(torch.equal(got[b][dead], want[dead]),
                      f"qdist cell scan at nprobe {nprobe}, query {b}: "
                      "a -1 slot is not exactly BIG")
                torch.testing.assert_close(got[b][~dead], want[~dead], **QDIST_TOL)
                err = max(err, float((got[b][~dead] - want[~dead]).abs().max()))
                del want, dead
            del got
            torch.cuda.empty_cache()
    del cells, xq, s
    return err


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
    scan_err = max(scan_err, check_sweep_scan(gen))

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
#: group of 4, window 64, softcap 30, the policy's prefill shapes,
#: GenerateServer's h2o-danube-1.8b prefill (train phase) and the zoo
#: phase's prefills (jamba, deepseek, musicgen, internvl2 and dbrx):
#: (B, S, Hq, Hk, D, window, softcap)
FLASH_SHAPES = [(2, 256, 4, 2, 64, 0, 0.0), (1, 256, 8, 8, 128, 0, 50.0),
                (2, 256, 4, 1, 80, 128, 0.0), (1, 512, 2, 2, 64, 0, 0.0),
                (1, 128, 16, 4, 128, 64, 30.0), (2, 35, 8, 2, 80, 0, 0.0),
                (1, 200, 4, 1, 64, 64, 30.0), (2, 333, 8, 2, 32, 0, 0.0),
                (6, 35, 12, 12, 64, 0, 0.0), (6, 128, 12, 12, 64, 0, 0.0),
                (4, 256, 32, 8, 80, 4096, 0.0), (4, 256, 32, 8, 128, 0, 0.0),
                (4, 256, 16, 16, 128, 0, 0.0), (4, 256, 24, 24, 64, 0, 0.0),
                (4, 256, 48, 8, 128, 0, 0.0)]
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
#: (B, S, Hq, Hk, D) of GenerateServer's h2o-danube-1.8b prefill
DANUBE_PREFILL = (4, 256, 32, 8, 80)
#: GenerateServer's bf16 prefills, (B, S, Hq, Hk, D, window): danube (train
#: phase) and the zoo phase's (internvl2 and dbrx share 48 / 8 of 128)
PREFILLS = {"danube": DANUBE_PREFILL + (4096,),
            "jamba": (4, 256, 32, 8, 128, 0),
            "deepseek": (4, 256, 16, 16, 128, 0),
            "musicgen": (4, 256, 24, 24, 64, 0),
            "internvl2_dbrx": (4, 256, 48, 8, 128, 0)}
#: checked on the card only: the folding at its limits (a group of 4, of
#: 64), S of 1 and of 65 (a second kv tile with one key), and the dist
#: phase's glm4-9b prefill (S 8,191, a group of 16; the CPU tests'
#: 3xTF32 emulation of it would take tens of GB)
FLASH_EDGE_SHAPES = [(3, 65, 16, 4, 64, 0, 0.0), (2, 65, 64, 1, 64, 0, 0.0),
                     (4, 1, 12, 12, 64, 0, 0.0), (1, 65, 8, 8, 128, 16, 0.0),
                     (1, 8191, 32, 2, 128, 0, 0.0)]


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
    # GenerateServer's bf16 prefills: danube (train phase; window 4096,
    # wider than S) and the zoo's, GQA groups of 1, 4 and 6
    prefill = {}
    for name, (B, S, Hq, Hk, D, win) in PREFILLS.items():
        prefill[name] = flash_prefill_times(gen, B, S, Hq, Hk, D, win, reps)
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
            "at_shape_6x128x12x64": timed[long_shape],
            "at_danube_prefill": prefill.pop("danube"),
            "at_prefill": prefill}


def flash_prefill_times(gen, B, S, Hq, Hk, D, window, reps) -> dict:
    """flash at one of GenerateServer's bf16 prefill shapes: its device
    time beside the plain version's, GQA SDPA's (``enable_gqa``) and the
    bound (q, k, v read once, out written once; the two products over the
    causal triangle at the bf16 tensor-core peak, the softmax's ~4
    operations a score at the fp32 one), and its error to the plain
    version on the first input."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash.ref import flash_ref
    args = [tuple(torch.randn(B, S, h, D, generator=gen, device="cuda").to(
        torch.bfloat16) for h in (Hq, Hk, Hk)) for _ in range(reps)]
    kw = dict(q_scale=D ** -0.5, window=window)

    def kernel(q, k, v):
        return flash_ops.causal_attention(q, k, v, **kw)

    def plain(q, k, v):
        return flash_ref(q, k, v, **kw)

    def gqa_sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=D ** -0.5, enable_gqa=True)

    got, want = kernel(*args[0]).float(), plain(*args[0]).float()
    err = float((got - want).abs().max())
    check(err <= FLASH_TOL[torch.bfloat16] * (1 + float(want.abs().max())),
          f"flash at the prefill {(B, S, Hq, Hk, D)}: max error {err}")
    lib_ms, lib_kernels = device_profile(gqa_sdpa, args)
    nbytes = 2.0 * B * S * D * (2 * Hq + 2 * Hk)
    products = 4.0 * B * Hq * D * S * (S + 1) / 2
    other = 4.0 * B * Hq * S * (S + 1) / 2
    t_ops = max(products / BF16_FLOPS_S, other / FP32_FLOPS_S)
    out = {"shape": [B, S, Hq, Hk, D], "window": window, "dtype": "bfloat16",
           "max_abs_err": err, "ms": device_ms(kernel, args),
           "plain_ms": device_ms(plain, args),
           "bound_ms": 1e3 * max(nbytes / HBM_BYTES_S, t_ops),
           "bound_by": ("bytes" if nbytes / HBM_BYTES_S >= t_ops
                        else "operations"),
           "library_ms": lib_ms,
           "library_kernels": top_kernels(lib_kernels, 3)}
    del args
    return out


# ---------------------------------------------------------------------------
# 4. the main path at SIFT1M scale
# ---------------------------------------------------------------------------
def serve_requests(backend, queries, gt, *, n_requests: int, ef: int,
                   k: int = 10, max_batch: int = 64, server=None,
                   keep_ids: bool = False) -> dict:
    """Closed-loop serving through AnnsServer (``server``, or one at k and
    ef): windows of ``max_batch`` requests, each submitted then
    flushed.  ``keep_ids`` returns the served ids under ``"ids"``."""
    from repro_torch.anns import SearchParams
    from repro_torch.anns.datasets import recall_at_k
    from repro_torch.runtime.server import AnnsServer

    if server is None:
        server = AnnsServer(backend, max_batch=max_batch,
                            params=SearchParams(k=k, ef=ef))
    k, ef, max_batch = server.params.k, server.params.ef, server.max_batch
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
    out = {"ef": ef, "requests": n_requests, "seconds": dt,
           "qps": n_requests / dt, "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)),
           f"recall@{k}": recall_at_k(found, gt[order], k)}
    if keep_ids:
        out["ids"] = found
    return out


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


def serve_k471(backend, ds, counters, n: int = 256) -> dict:
    """brute_force at k = 471: each batch merges 123 chunks' 471 winners
    (57,933 values a row, past the 57,856 the topk kernel once held);
    recall@471 over 512 requests against exact gt of ``n`` queries, from
    the plain matmul-form oracle on the card."""
    from repro_torch.anns.datasets import exact_ground_truth
    q = ds.queries[:n]
    t0 = time.perf_counter()
    gt = exact_ground_truth(ds.base, q, 471, ds.metric, device="cuda")
    gt_s = time.perf_counter() - t0
    zero_counts(counters)
    out = serve_requests(backend, q, gt, n_requests=512, ef=64, k=471)
    out["launches"] = read_counts(counters)
    out["gt_seconds"] = gt_s
    check(out["recall@471"] >= 0.999,
          f"brute_force recall@471 {out['recall@471']} < 0.999")
    check(out["launches"]["topk"] > 0, "k 471: no topk launch")
    return out


def index_round_trip(backend, ds, n: int = 2048) -> dict:
    """save_index to a temporary directory under build/, load_index onto
    the card (its default device): ids at ef 64 on ``n`` queries
    bit-identical to the built index's; bytes on disk, save and load
    seconds."""
    import tempfile

    from repro_torch import ckpt
    from repro_torch.anns import SearchParams
    params = SearchParams(k=10, ef=64)
    q = ds.queries[:n]
    want = backend.search(q, params).ids
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, backend.name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_index(path, backend)
        save_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        t0 = time.perf_counter()
        loaded = ckpt.load_index(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    got = loaded.search(q, params).ids
    check(loaded.device.type == "cuda" and loaded.name == backend.name,
          f"load_index gave {loaded.name} on {loaded.device}")
    check(torch.equal(got, want),
          f"{backend.name}: ids after save_index / load_index differ on "
          f"{int((got != want).any(1).sum())} of {n} queries")
    return {"bytes_on_disk": disk, "save_s": save_s, "load_s": load_s,
            "queries": n, "ids_equal": True,
            "device_bytes": loaded.memory_bytes()}


def phase_main(n_base: int, n_query: int, n_requests: int):
    """Serve every backend at SIFT1M scale; returns the kernels' launches
    of each backend's serving runs, by path, the dataset, and the built
    ivf and sharded backends (the tune phase sweeps them)."""
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
    launches, kept = {}, {}
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
        if name in ("ivf", "sharded"):
            row["round_trip"] = index_round_trip(backend, ds)
            kept[name] = backend
        efs = (64,) if name in ("brute_force", "quantized_prefilter") \
            else (16, 64, 256)
        runs = []
        for ef in efs:
            zero_counts(counters)
            runs.append(serve_requests(backend, ds.queries, ds.gt,
                                       n_requests=n_requests, ef=ef))
            runs[-1]["launches"] = read_counts(counters)
        row["runs"] = runs
        if name == "brute_force":
            row["k471"] = serve_k471(backend, ds, counters)
            launches["serve.brute_force_k471"] = row["k471"]["launches"]
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
    return launches, ds, kept


# ---------------------------------------------------------------------------
# 5. the SLO autotuner on the 1M indexes
# ---------------------------------------------------------------------------
#: queries of the tune sweep's view of the dataset (see the docstring)
TUNE_QUERIES = 256


def phase_tune(ds, targets: dict):
    """sweep_frontier over the built 1M ivf and sharded backends, every
    rung of their nprobe ladders; then an SLO-mode server.  Returns the
    kernels' launches of the sweep and the SLO serving, and the
    frontier."""
    import dataclasses

    from repro_torch.anns import tune
    from repro_torch.anns.backends.ivf import _probe_floor_nprobe
    from repro_torch.anns.bench import measure_point
    from repro_torch.runtime.server import AnnsServer

    view = dataclasses.replace(ds, queries=ds.queries[:TUNE_QUERIES],
                               gt=ds.gt[:TUNE_QUERIES])
    raw = {name: [] for name in targets}

    def measure(target, ds_, params, repeats, build_seconds):
        p = measure_point(target, ds_, params=params, repeats=repeats,
                          build_seconds=build_seconds)
        idx = target.index
        raw[target.name].append({
            "ef": params.ef, "nprobe": _probe_floor_nprobe(
                idx, target.variant, params, min(params.k, idx.n)),
            "recall@10": p.recall, "qps": p.qps, "p50_ms": p.p50_ms,
            "device_memory_bytes": p.device_memory_bytes})
        return p

    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    zero_counts(counters)
    t0 = time.perf_counter()
    frontier = tune.sweep_frontier(view, backends=(),
                                   targets=list(targets.values()), k=10,
                                   repeats=1, measure_fn=measure)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for name, rungs in raw.items():
        rec = [r["recall@10"] for r in rungs]
        check(all(b >= a - 0.01 for a, b in zip(rec, rec[1:])),
              f"tune: {name} recall falls along the nprobe ladder: {rec}")
        check(rungs[-1]["nprobe"] == targets[name].index.nlist
              and rec[-1] >= 0.99,
              f"tune: {name} at the all-cells probe {rungs[-1]}")
    slo = tune.RecallSLO(0.9)
    pick = tune.choose(frontier, slo)
    server = AnnsServer(targets[pick.backend], max_batch=64, slo=slo,
                        frontier=frontier)
    served = serve_requests(None, view.queries, view.gt, n_requests=512,
                            ef=0, server=server)
    launches = read_counts(counters)
    check(abs(served["recall@10"] - server.operating_point.recall) <= 0.02,
          f"tune: SLO server recall {served['recall@10']} vs its pick's "
          f"swept {server.operating_point.recall}")
    for kname in ("distance", "topk", "qdist"):
        check(launches[kname] > 0, f"tune: no {kname} launch: {launches}")
    emit({"phase": "tune", "queries": TUNE_QUERIES, "sweep_s": sweep_s,
          "sweep_peak_device_bytes": peak,
          "device_bytes_before_sweep": base_bytes,
          "rungs": raw, "frontier_size": len(frontier.points),
          "frontier": [{"backend": p.backend, "ef": p.params.ef,
                        "recall@10": p.recall, "qps": p.qps,
                        "p50_ms": p.p50_ms,
                        "device_memory_bytes": p.device_memory_bytes}
                       for p in frontier.points],
          "slo": slo.describe(),
          "pick": {"backend": pick.backend, "ef": server.params.ef,
                   "recall@10": server.operating_point.recall,
                   "qps": server.operating_point.qps},
          "served": served, "launches": launches})
    return launches, frontier


# ---------------------------------------------------------------------------
# 6. the streaming indexes at 1M (stream-1M)
# ---------------------------------------------------------------------------
#: stream-1M: the serve-1M ivf / sharded indexes made mutable (tail caps:
#: 16,384 x 128 fp32 = 8.4 MB for stream_ivf, 8,192 a shard for
#: stream_sharded), 10 insert batches of 1,000 fresh vectors and 10,000
#: deletes, served at ef 64 (nprobe 16) and ef 384 (the tune-1M pick)
STREAM_1M = {"ivf_tail_cap": 16384, "sharded_tail_cap": 8192,
             "insert_batches": 10, "insert_batch": 1000, "deletes": 10_000,
             "requests": 2048, "efs": (64, 384), "recall_queries": 1000,
             "seed": 1}


def _stream_serve(backends, queries, gt, counters, live=None) -> dict:
    """Serve STREAM_1M["requests"] requests drawn from ``queries`` at each
    ef through AnnsServer on each backend; the ids of every response are
    checked against ``live`` (a set of ids) when given."""
    out = {}
    for name, b in backends.items():
        for ef in STREAM_1M["efs"]:
            before = read_counts(counters)
            row = serve_requests(b, queries, gt, ef=ef,
                                 n_requests=STREAM_1M["requests"],
                                 keep_ids=live is not None)
            row["launches"] = {k: v - before[k]
                               for k, v in read_counts(counters).items()}
            if live is not None:
                ids = row.pop("ids")
                stray = set(np.unique(ids).tolist()) - live - {-1}
                check(not stray, f"stream {name} ef={ef}: ids outside the "
                      f"live set: {sorted(stray)[:5]}")
            out[f"{name}.ef{ef}"] = row
    return out


def _ids_at(b, queries, ef: int, n: int = 512) -> torch.Tensor:
    from repro_torch.anns import SearchParams
    p = SearchParams(k=10, ef=ef)
    return torch.cat([b.search(queries[i:i + n], p).ids
                      for i in range(0, len(queries), n)])


def _check_twins(stage: str, a, s, queries) -> None:
    """stream_sharded returns stream_ivf's ids (the family invariant)."""
    for ef in STREAM_1M["efs"]:
        ia, is_ = _ids_at(a, queries, ef), _ids_at(s, queries, ef)
        check(torch.equal(ia, is_), f"stream {stage} ef={ef}: stream_sharded "
              f"differs from stream_ivf on "
              f"{int((ia != is_).any(1).sum())} of {len(queries)} queries")


def _inserted_find_themselves(b, vecs, ids, stage: str) -> None:
    from repro_torch.anns import SearchParams
    got = torch.cat([b.search(vecs[i:i + 500], SearchParams(k=1, ef=64)).ids
                     for i in range(0, len(vecs), 500)])[:, 0].cpu().numpy()
    bad = np.flatnonzero(got != ids)
    check(not len(bad), f"stream {stage} {b.name}: {len(bad)} of {len(ids)} "
          f"inserted vectors do not return their own id at rank 0 "
          f"(first: {ids[bad[:3]]} -> {got[bad[:3]]})")


def _no_tombstone(rows: dict, dead: set, stage: str) -> None:
    for key, ids in rows.items():
        hit = set(np.unique(ids).tolist()) & dead
        check(not hit, f"stream {stage} {key}: deleted ids served: "
              f"{sorted(hit)[:5]}")


def _stream_vs_plain(backends, queries, assign_rows, where: str) -> dict:
    """The stream path's kernels on the layouts it serves, held against
    their plain versions on the same card inputs: each backend's probe of
    64 queries at each served ef and at every cell, the cell scan of each
    probe (stream_sharded: each shard's table, the other's cells -1; at
    every cell two queries), and the assignment compaction and insert
    routing run (``assign``: distance, then topk k 1) against the served
    centroids, on the first ``r`` live vectors for each ``r`` in
    ``assign_rows``.  Returns the largest error of each; the caller keeps
    these launches out of the path's counts."""
    from repro_torch.anns import SearchParams
    from repro_torch.kernels.distance.ops import pairwise_distance
    from repro_torch.kernels.distance.ref import distance_ref
    from repro_torch.kernels.qdist.ops import quantized_cell_scan
    from repro_torch.kernels.qdist.ref import BIG, qdist_cells_ref
    from repro_torch.kernels.topk.ops import topk_smallest
    from repro_torch.kernels.topk.ref import topk_smallest_ref

    a = next(iter(backends.values()))
    dev = a.index.centroids.device
    q = torch.as_tensor(queries[:64], device=dev)
    errs = {"distance": 0.0, "qdist.cell_scan": 0.0}
    shapes = {"topk": set(), "scan": set(), "distance": set()}

    def dist(x, c, metric):
        got = pairwise_distance(x, c, metric=metric)
        want = distance_ref(x, c, metric)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-3)
        errs["distance"] = max(errs["distance"],
                               float((got - want).abs().max()))
        shapes["distance"].add(tuple(x.shape[:1]) + tuple(c.shape))
        return got

    def top(dm, k):
        v, i = topk_smallest(dm, k)
        wv, wi = topk_smallest_ref(dm, k)
        torch.cuda.synchronize()
        at = f"{where}: topk {tuple(dm.shape)} k={k}"
        check(torch.equal(i, wi), f"stream {at}: ids differ from the plain")
        check(torch.equal(v.view(torch.int32), wv.view(torch.int32)),
              f"stream {at}: values differ from the plain")
        shapes["topk"].add((*dm.shape, k))
        return i

    def scan(qs, bq, sc, cells, rows, metric, label):
        got = quantized_cell_scan(qs, bq, sc, cells, rows, metric=metric)
        for lo in range(0, len(qs), 16):
            want = qdist_cells_ref(qs[lo:lo + 16], bq, sc, cells,
                                   rows[lo:lo + 16], metric)
            torch.cuda.synchronize()
            g = got[lo:lo + 16]
            dead = want == BIG
            check(torch.equal(g[dead], want[dead]), f"stream {where}: "
                  f"{label}: a -1 slot is not exactly BIG")
            torch.testing.assert_close(g[~dead], want[~dead], **QDIST_TOL)
            errs["qdist.cell_scan"] = max(errs["qdist.cell_scan"], float(
                (g[~dead] - want[~dead]).abs().max()))
            del want, dead
        shapes["scan"].add((len(qs), rows.shape[1], *cells.shape[-2:]))

    for name, b in backends.items():
        idx, metric = b.index, b.metric
        dc = dist(q, idx.centroids, metric)
        nprobes = [b.search(q, SearchParams(k=10, ef=ef)).steps
                   for ef in STREAM_1M["efs"]] + [idx.nlist]
        for nprobe in nprobes:
            probe = top(dc, nprobe)
            qs, probe = (q[:2], probe[:2]) if nprobe == idx.nlist else (q, probe)
            label = f"{name} nprobe {nprobe}"
            if name == "stream_ivf":
                scan(qs, idx.base_q, idx.scales, idx.cells,
                     probe.to(torch.int32), metric, label)
                continue
            owner = idx.cell_shard[probe.long()]
            row = idx.cell_row[probe.long()]
            for j in range(idx.n_shards):
                rows_j = torch.where(owner == j, row, -1).to(torch.int32)
                scan(qs, idx.base_q[j], idx.scales[j], idx.cells[j], rows_j,
                     metric, f"{label} shard {j}")
            torch.cuda.empty_cache()
    vecs = torch.as_tensor(a.live_vectors()[0], device=dev)
    for r in assign_rows:
        top(dist(vecs[:r], a.index.centroids, a.metric), 1)
    del vecs
    torch.cuda.empty_cache()
    return {"max_abs_err": errs,
            "shapes": {k: sorted(v) for k, v in shapes.items()}}


def _stream_recalls(backends, queries, gt, ef_ro: dict, stage: str) -> dict:
    """recall@10 of each backend against the live gt on the recall
    queries, held within 0.02 of the read-only ivf's at each ef."""
    from repro_torch.anns.datasets import recall_at_k
    out = {}
    for name, b in backends.items():
        for ef in STREAM_1M["efs"]:
            rec = recall_at_k(_ids_at(b, queries, ef).cpu().numpy(), gt, 10)
            out[f"{name}.ef{ef}"] = rec
            check(abs(rec - ef_ro[ef]) <= 0.02,
                  f"stream {stage} {name} ef={ef}: recall@10 {rec} vs the "
                  f"read-only ivf's {ef_ro[ef]}")
    return out


def phase_stream(ds, kept: dict) -> tuple[dict, dict]:
    """stream-1M (see the docstring): returns the kernels' launches and
    their comparisons with the plain versions on the served layouts."""
    import dataclasses
    import tempfile

    from repro_torch import ckpt
    from repro_torch.anns import SearchParams, registry
    from repro_torch.anns.datasets import make_dataset, recall_at_k
    from repro_torch.anns.ivf.kmeans import ASSIGN_CHUNK
    from repro_torch.anns.stream import BackgroundCompactor, exact_live_gt

    cfg = STREAM_1M
    counters = kernel_counters()
    zero_counts(counters)
    path_counts = {k: 0 for k in read_counts(counters)}

    def bank():
        for k, v in read_counts(counters).items():
            path_counts[k] += v
        zero_counts(counters)

    t0 = time.perf_counter()
    states = {"ivf": kept["ivf"].to_state_dict(),
              "sharded": kept["sharded"].to_state_dict()}

    def stream_of(src: str, cap: int):
        name = f"stream_{src}"
        v = dataclasses.replace(kept[src].variant, backend=name, tail_cap=cap)
        b = registry.create(name, v, metric=ds.metric, device="cuda")
        b.from_state_dict(states[src])
        return b

    a = stream_of("ivf", cfg["ivf_tail_cap"])
    s = stream_of("sharded", cfg["sharded_tail_cap"])
    twin = stream_of("ivf", cfg["ivf_tail_cap"])  # the determinism twin
    del states
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    backends = {"stream_ivf": a, "stream_sharded": s}
    nq = cfg["recall_queries"]
    q = ds.queries[:nq]

    # the read-only ivf at the same efs, against the dataset's gt
    ef_ro = {ef: recall_at_k(_ids_at(kept["ivf"], q, ef).cpu().numpy(),
                             ds.gt[:nq], 10) for ef in cfg["efs"]}
    row = {"phase": "stream", "setup_s": setup_s,
           "tail_caps": {"stream_ivf": cfg["ivf_tail_cap"],
                         "stream_sharded": cfg["sharded_tail_cap"]},
           "readonly_ivf_recall@10": ef_ro, "stages": {}}
    stages = row["stages"]

    # stage 1: empty tail; save the base
    gt1 = exact_live_gt(a, q, 10)
    zero_counts(counters)
    stages["1_empty"] = {"serve": _stream_serve(backends, q, gt1, counters),
                         "recall@10": _stream_recalls(backends, q, gt1,
                                                      ef_ro, "1")}
    _check_twins("1", a, s, q)
    bank()
    tmp = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"))
    base_dir = os.path.join(tmp.name, "stream_ivf")
    t0 = time.perf_counter()
    ckpt.save_index(base_dir, a)
    base_save_s = time.perf_counter() - t0

    # stage 2: 10 x 1,000 inserts from the dataset's generator under
    # another seed, 10,000 random base ids deleted, two deltas on the way
    fresh = make_dataset("sift-128-euclidean", n_base=cfg["insert_batches"]
                         * cfg["insert_batch"], n_query=1,
                         seed=cfg["seed"], device="cuda").base
    rng = np.random.default_rng(cfg["seed"])
    dead_ids = rng.choice(kept["ivf"].index.n, cfg["deletes"], replace=False)
    new_ids, delta_s, delta_bytes = [], [], []
    t0 = time.perf_counter()
    for j in range(cfg["insert_batches"]):
        chunk = fresh[j * cfg["insert_batch"]:(j + 1) * cfg["insert_batch"]]
        ids = [b.insert(chunk) for b in (a, s, twin)]
        check(all(np.array_equal(ids[0], i) for i in ids[1:]),
              "stream: insert ids differ between the backends")
        new_ids.append(ids[0])
        if j == cfg["insert_batches"] // 2 - 1:
            for b in (a, s, twin):
                b.delete(dead_ids[: cfg["deletes"] // 2])
        if j in (cfg["insert_batches"] // 2 - 1, cfg["insert_batches"] - 1):
            if j == cfg["insert_batches"] - 1:
                for b in (a, s, twin):
                    b.delete(dead_ids[cfg["deletes"] // 2:])
            t1 = time.perf_counter()
            sub = ckpt.save_index_delta(base_dir, a)
            delta_s.append(time.perf_counter() - t1)
            delta_bytes.append(sum(os.path.getsize(os.path.join(sub, f))
                                   for f in os.listdir(sub)))
    mutate_s = time.perf_counter() - t0
    new_ids = np.concatenate(new_ids)
    dead = set(dead_ids.tolist())
    live_ids = set(a.live_vectors()[1].tolist())
    check(len(live_ids) == a.n_live() == s.n_live()
          == kept["ivf"].index.n, f"stream: n_live {a.n_live()} / "
          f"{s.n_live()} after {len(new_ids)} inserts and {len(dead)} "
          f"deletes of {kept['ivf'].index.n}")
    t0 = time.perf_counter()
    gt2 = exact_live_gt(a, q, 10)
    gt_s = time.perf_counter() - t0
    bank()
    zero_counts(counters)
    serve2 = _stream_serve(backends, q, gt2, counters, live=live_ids)
    stages["2_tail"] = {"serve": serve2, "recall@10": _stream_recalls(
        backends, q, gt2, ef_ro, "2"), "mutate_s": mutate_s,
        "live_gt_s": gt_s, "tail_fraction": a.tail_fraction()}
    ids2 = {n: _ids_at(b, ds.queries[:2048], 64) for n, b in backends.items()}
    _no_tombstone({n: i.cpu().numpy() for n, i in ids2.items()}, dead, "2")
    for b in backends.values():
        _inserted_find_themselves(b, fresh, new_ids, "2")
    _check_twins("2", a, s, q)
    wall, by_kernel = traced(lambda: serve_requests(
        a, q, gt2, n_requests=512, ef=64))
    stages["2_tail"]["trace_ef64"] = {
        "traced_requests": 512, "traced_wall_s": wall,
        "device_busy_share": sum(by_kernel.values()) / 1e6 / wall,
        "top_device_us": top_kernels(by_kernel, 5)}
    bank()
    vs_plain = row["kernels_vs_plain"] = {}
    vs_plain["2"] = _stream_vs_plain(backends, q, [
        ASSIGN_CHUNK, a.n_live() % ASSIGN_CHUNK or ASSIGN_CHUNK,
        cfg["insert_batch"]], "2")
    zero_counts(counters)       # the comparisons are not the path's

    # stage 3: compact inline (and the twin: the same bytes), serve again
    comp_s = {}
    for name, b in (("stream_ivf", a), ("stream_sharded", s),
                    ("stream_ivf_twin", twin)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.compact()
        torch.cuda.synchronize()
        comp_s[name] = time.perf_counter() - t0
    sa, st = a.to_state_dict(), twin.to_state_dict()
    differ = [k for k in sa if (sa[k].tobytes() != st[k].tobytes()
                                if isinstance(sa[k], np.ndarray)
                                else sa[k] != st[k])]
    check(sa.keys() == st.keys() and not differ,
          f"stream: one history compacted to different bytes: {differ}")
    del sa, st, twin
    check(a.n_live() == s.n_live() == len(live_ids) and a.epoch == 1,
          "stream: compaction changed the live set")
    serve3 = _stream_serve(backends, q, gt2, counters, live=live_ids)
    stages["3_compacted"] = {
        "serve": serve3, "recall@10": _stream_recalls(backends, q, gt2, ef_ro,
                                                      "3"),
        "compact_s": comp_s, "nlist": a.index.nlist,
        "cell_pad": a.index.cell_pad}
    ids3 = {n: _ids_at(b, ds.queries[:2048], 64).cpu().numpy()
            for n, b in backends.items()}
    _no_tombstone(ids3, dead, "3")
    for b in backends.values():
        _inserted_find_themselves(b, fresh, new_ids, "3")
    _check_twins("3", a, s, q)
    allc = {}
    for name, b in backends.items():
        ef = b.search_ef_ladder()[-1]
        res = b.search(q[:64], SearchParams(k=10, ef=ef, rerank_factor=32))
        allc[name] = recall_at_k(res.ids.cpu().numpy(), gt2[:64], 10)
        check(allc[name] >= 0.99, f"stream {name} at the all-cells probe: "
              f"recall@10 {allc[name]}")
    stages["3_compacted"]["all_cells_recall@10"] = allc
    bank()

    # stage 4: base + deltas replayed onto the card, ids as stage 2's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replayed = ckpt.load_index(base_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = _ids_at(replayed, ds.queries[:2048], 64)
    check(torch.equal(got, ids2["stream_ivf"]),
          f"stream: base + deltas replayed differ from the live index on "
          f"{int((got != ids2['stream_ivf']).any(1).sum())} of 2048 queries")
    stages["4_replay"] = {
        "base_bytes": sum(os.path.getsize(os.path.join(base_dir, f))
                          for f in os.listdir(base_dir)
                          if not f.startswith("delta_")),
        "base_save_s": base_save_s, "delta_bytes": delta_bytes,
        "delta_save_s": delta_s, "load_s": load_s, "seqno": replayed.seqno,
        "ids_equal": True}
    del replayed
    tmp.cleanup()
    bank()

    # stage 5: serve while a second thread runs a background compaction
    more = make_dataset("sift-128-euclidean", n_base=2 * cfg["insert_batch"],
                        n_query=1, seed=cfg["seed"] + 1, device="cuda").base
    a.insert(more)
    live5 = set(a.live_vectors()[1].tolist())
    gt5 = exact_live_gt(a, q, 10)
    comp = BackgroundCompactor(a, warm=[(q[:64], SearchParams(k=10, ef=ef))
                                        for ef in cfg["efs"]])
    bank()
    vs_plain["3"] = _stream_vs_plain(backends, q, [
        ASSIGN_CHUNK, a.n_live() % ASSIGN_CHUNK or ASSIGN_CHUNK], "3")
    zero_counts(counters)
    t0 = time.perf_counter()
    check(comp.schedule(), "stream: the compactor did not start")
    serve5, rounds = [], 0
    while comp.in_flight or rounds == 0:
        serve5.append(serve_requests(a, q, gt5, n_requests=cfg["requests"],
                                     ef=64, keep_ids=True))
        rounds += 1
    check(comp.join(timeout=600), "stream: the background compaction hung")
    bg_s = time.perf_counter() - t0
    for r in serve5:
        stray = set(np.unique(r.pop("ids")).tolist()) - live5 - {-1}
        check(not stray, f"stream 5: ids outside the live set {sorted(stray)[:5]}")
    check(a.epoch == 2 and a.n_live() == len(live5),
          f"stream 5: epoch {a.epoch}, n_live {a.n_live()}")
    stages["5_background"] = {
        "serve_rounds": serve5, "compact_s": bg_s, "runs": comp.runs,
        "launches": read_counts(counters),
        "p99_ms_vs_stage1": max(r["p99_ms"] for r in serve5)
        / stages["1_empty"]["serve"]["stream_ivf.ef64"]["p99_ms"]}
    bank()
    vs_plain["5"] = _stream_vs_plain({"stream_ivf": a}, q, [], "5")
    zero_counts(counters)

    s1 = stages["1_empty"]["serve"]
    row["tail_overhead"] = {k: serve2[k]["qps"] / s1[k]["qps"] for k in s1}
    row["compact_recovery"] = {k: serve3[k]["qps"] / s1[k]["qps"]
                               for k in s1}
    row["launches"] = dict(path_counts)
    emit(row)
    for kname in ("distance", "topk", "qdist"):
        check(path_counts[kname] > 0, f"stream: no {kname} launch")
    check(path_counts["qdist.cell_scan"] > 0, "stream: no cell scan")
    del a, s, backends
    torch.cuda.empty_cache()
    return path_counts, vs_plain


# ---------------------------------------------------------------------------
# 7. the async multi-tenant tier at 1M (async-1M)
# ---------------------------------------------------------------------------
#: async-1M: gold holds recall 0.95 at weight 3 with a 20 ms deadline,
#: bronze 0.6 at weight 1, both picked from tune-1M's frontier
ASYNC_1M = {"tenants": "gold:0.95:3:20,bronze:0.6:1", "max_batch": 64,
            "max_queue": 256, "burst": 768, "requests": 4096, "mix": 3,
            "seed": 0}


def phase_async(ds, ivf, frontier) -> tuple[dict, dict]:
    """async-1M (see the docstring): returns the kernels' launches and each
    tenant's QPS."""
    import asyncio

    from repro_torch.anns.datasets import recall_at_k
    from repro_torch.serve import (AsyncServeTier, Overloaded, ServeRejection,
                                   parse_tenant_specs, resolve_tenants)
    from repro_torch.serve import scheduler

    cfg = ASYNC_1M
    tenants = resolve_tenants(parse_tenant_specs(cfg["tenants"]),
                              target=ivf, frontier=frontier)
    groups = {st.params for st in tenants.values()}
    counters = kernel_counters()
    tier = AsyncServeTier(ivf, tenants, max_batch=cfg["max_batch"],
                          max_queue=cfg["max_queue"])
    shapes, mixed = set(), []
    real_exec = scheduler.execute_search_batch
    real_pop = tier.batcher.queue.pop_batch

    def recording_exec(search, queries, params, *, max_batch):
        shapes.add((max_batch, queries.shape[1], params.k, params.ef))
        return real_exec(search, queries, params, max_batch=max_batch)

    def checked_pop(group, max_n):
        batch = real_pop(group, max_n)
        if any(tenants[r.tenant].params != group for r in batch):
            mixed.append([r.tenant for r in batch])
        return batch

    tier.batcher.queue.pop_batch = checked_pop
    scheduler.execute_search_batch = recording_exec
    # every request a distinct row of the 10,000 queries in a seeded order,
    # scored against its own gt row: most were not among tune-1M's swept
    # 256, so the recall check holds each pick on queries it was not
    # chosen on
    rows = np.random.default_rng(cfg["seed"]).permutation(len(ds.queries))
    names = ["gold"] * cfg["mix"] + ["bronze"]

    async def episode():
        burst = []
        shed = 0
        for i in range(cfg["burst"]):
            try:
                burst.append(tier.submit(ds.queries[rows[i % len(rows)]],
                                         names[i % len(names)]))
            except Overloaded:
                shed += 1
        tier.start()
        burst_res = await asyncio.gather(*burst, return_exceptions=True)
        found = {n: [] for n in tenants}
        served = {n: [] for n in tenants}
        lat = {n: [] for n in tenants}
        t0 = time.perf_counter()
        window = cfg["max_queue"]
        for lo in range(0, cfg["requests"], window):
            subs = []
            for i in range(lo, min(lo + window, cfg["requests"])):
                name = names[i % len(names)]
                qi = int(rows[(cfg["burst"] + i) % len(rows)])
                subs.append((name, qi, tier.submit(ds.queries[qi], name)))
            for name, qi, fut in subs:
                try:
                    r = await fut
                except ServeRejection:
                    continue
                found[name].append(r.ids)
                served[name].append(qi)
                lat[name].append(r.latency_ms)
        wall = time.perf_counter() - t0
        await tier.close(drain=True)
        return len(burst), shed, burst_res, found, served, lat, wall

    zero_counts(counters)
    torch.cuda.synchronize()
    try:
        admitted, shed, burst_res, found, served, lat, wall = asyncio.run(
            episode())
    finally:
        scheduler.execute_search_batch = real_exec
    launches = read_counts(counters)
    tot = tier.telemetry.totals()
    snap = tier.telemetry.snapshot()
    check(admitted == cfg["max_queue"] and shed == cfg["burst"] - admitted,
          f"async burst: {admitted} admitted, {shed} shed (typed "
          f"Overloaded); want {cfg['max_queue']} and "
          f"{cfg['burst'] - cfg['max_queue']}")
    check(tot.accounted(), f"async accounting: admitted {tot.admitted} != "
          f"served {tot.served} + shed_deadline {tot.shed_deadline} + "
          f"shed_closed {tot.shed_closed}")
    check(not mixed, f"async: batches mixed tenants' picks: {mixed[:3]}")
    check(len(shapes) == len(groups),
          f"async: {len(shapes)} batch shapes for {len(groups)} tenant "
          f"groups: {sorted(shapes)}")
    per = {}
    for name, st in tenants.items():
        ts = snap["tenants"][name]
        rec = (recall_at_k(np.stack(found[name]),
                           ds.gt[np.asarray(served[name])], 10)
               if found[name] else float("nan"))
        per[name] = {"pick_ef": st.params.ef,
                     "swept_recall@10": st.point.recall,
                     "served_recall@10": rec, "served": len(found[name]),
                     "qps": len(found[name]) / wall,
                     "p50_ms": float(np.percentile(lat[name], 50)),
                     "p99_ms": float(np.percentile(lat[name], 99)),
                     "queue_wait": ts["queue_wait"],
                     "compute": ts["compute"],
                     "shed_deadline": ts["shed_deadline"],
                     "shed_overload": ts["shed_overload"]}
        check(abs(rec - st.point.recall) <= 0.02,
              f"async {name}: served recall {rec} vs its pick's swept "
              f"{st.point.recall}")
    emit({"phase": "async", "tenants": cfg["tenants"],
          "max_queue": cfg["max_queue"], "max_batch": cfg["max_batch"],
          "burst": {"submitted": cfg["burst"], "admitted": admitted,
                    "shed_overload": shed,
                    "deadline_shed": sum(isinstance(r, ServeRejection)
                                         for r in burst_res)},
          "steady": {"requests": cfg["requests"], "wall_s": wall,
                     "qps": sum(p["served"] for p in per.values()) / wall},
          "per_tenant": per, "batch_shapes": sorted(shapes),
          "queue": snap["queue"], "totals": snap["totals"],
          "launches": launches})
    for kname in ("distance", "topk", "qdist"):
        check(launches[kname] > 0, f"async: no {kname} launch")
    return launches, {name: p["qps"] for name, p in per.items()}


# ---------------------------------------------------------------------------
# 8. the reference point at 20k, the optimized variant, the serve CLI
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

    cli_round_trips(serve)


#: the serve CLI's 20k deployments: (label, flags)
CLI_20K = [("graph", ["--backend", "graph"]),
           ("brute_force", ["--backend", "brute_force"]),
           ("quantized_prefilter", ["--backend", "quantized_prefilter"]),
           ("ivf", ["--backend", "ivf", "--nlist", "128"]),
           ("sharded-2", ["--backend", "sharded", "--nlist", "128",
                          "--n-shards", "2"])]


#: the 20k streaming and async CLI episodes (the reference tests'
#: episodes at 20k).  The drift episode inserts 1,100 vectors, the fewest
#: past the 0.05 tail trigger, and holds the SLO 0.8: after compaction the
#: drifted queries' recall tops out under 0.9 on the retune's ladder (int8
#: scan, rerank factor 1), in the reference too, so 0.9 cannot be restored
CLI_STREAM_20K = ["--backend", "stream_ivf", "--n-base", "20000",
                  "--tail-cap", "2048", "--tune", "--target-recall", "0.8",
                  "--drift-retune", "0.05", "--max-tail-frac", "0.05",
                  "--stream-demo", "1100"]
CLI_ASYNC_20K = ["--backend", "ivf", "--n-base", "20000", "--tune",
                 "--async", "--tenants", "strict:0.9:4,lax:0.7",
                 "--max-queue", "32", "--max-batch", "16"]


def _captured(serve, argv) -> tuple[str, object]:
    """serve.main(argv) with its standard output captured (and echoed to
    standard error); returns (output, main's return value)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = serve.main(argv)
    out = buf.getvalue()
    sys.stderr.write(out)
    return out, got


def cli_episodes(serve) -> None:
    """The 20k serve CLI's scripted streaming-drift and multi-tenant
    episodes; each must print the reference tests' markers."""
    import re
    t0 = time.perf_counter()
    out, post = _captured(serve, CLI_STREAM_20K)
    drift_s = time.perf_counter() - t0
    for marker in ("-> tail_frac", "drift: compacted", "-> recall_drift",
                   "drift: retune ef", "slo restored"):
        check(marker in out, f"serve --stream-demo: no {marker!r} line")
    m = re.search(r"drift: post-retune recall=([0-9.]+) target=([0-9.]+)",
                  out)
    check(m is not None and float(m.group(1)) >= float(m.group(2)),
          "serve --stream-demo: post-retune recall under the target")
    emit({"phase": "ref20k.cli_stream_demo", "argv": CLI_STREAM_20K,
          "seconds": drift_s, "post_retune_recall@10": post,
          "lines": [ln for ln in out.splitlines()
                    if ln.startswith(("drift:", "slo pick"))]})
    t0 = time.perf_counter()
    out, snap = _captured(serve, CLI_ASYNC_20K)
    async_s = time.perf_counter() - t0
    check(re.search(r"serve: overload burst admitted=32 shed=64 "
                    r"\(typed Overloaded\)", out) is not None,
          "serve --async: no deterministic overload line")
    for name, target in (("strict", 0.9), ("lax", 0.7)):
        m = re.search(rf"serve: tenant {name} recall=([\d.]+) "
                      rf"target=([\d.]+) (ok|MISS)", out)
        check(m is not None and float(m.group(1)) >= target
              and m.group(3) == "ok", f"serve --async: tenant {name} line")
    m = re.search(r"serve: closed served=(\d+) shed_overload=(\d+) "
                  r"shed_deadline=(\d+) shed_closed=(\d+)", out)
    check(m is not None and int(m.group(4)) == 0,
          "serve --async: the drain left requests unserved")
    for marker in ("serve: accounting ok", "serve: episode ok"):
        check(marker in out, f"serve --async: no {marker!r} line")
    emit({"phase": "ref20k.cli_async", "argv": CLI_ASYNC_20K,
          "seconds": async_s, "queue": snap["queue"],
          "lines": [ln for ln in out.splitlines()
                    if ln.startswith("serve:")]})


def cli_round_trips(serve) -> None:
    """The serve CLI at 20k: each backend built and served with
    --save-index here, then served with --load-index by a separate
    process each (all started together), at the same recall; --tune
    --save-frontier then --load-frontier --target-recall 0.9;
    --filter-demo on ivf; and the streaming-drift and multi-tenant
    episodes (:func:`cli_episodes`)."""
    import re
    import tempfile

    data = ["--n-base", "20000", "--n-query", "256", "--n-requests", "512"]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        built, procs = {}, {}
        for label, flags in CLI_20K:
            t0 = time.perf_counter()
            built[label] = serve.main([*data, *flags, "--save-index",
                                       os.path.join(tmp, label)])
            built[label] = (built[label], time.perf_counter() - t0)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        for label, _ in CLI_20K:
            procs[label] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.serve", *data,
                 "--load-index", os.path.join(tmp, label)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        for label, p in procs.items():
            out, err = p.communicate(timeout=600)
            check(p.returncode == 0, f"serve --load-index {label}: exit "
                  f"{p.returncode}\n{err[-3000:]}")
            m = re.search(r"recall@10=([\d.]+)", out)
            rec, build_s = built[label]
            row = {"phase": "ref20k.cli", "backend": label,
                   "recall@10": rec, "build_and_serve_s": build_s,
                   "loaded_recall@10": m and m.group(1),
                   "restored": [ln for ln in out.splitlines()
                                if ln.startswith("restored")]}
            check(m is not None and m.group(1) == f"{rec:.3f}",
                  f"serve --load-index {label} in a separate process gave "
                  f"{row['loaded_recall@10']}, the build process {rec:.3f}")
            if label == "brute_force":
                check(rec >= 0.999, f"serve CLI brute_force recall {rec}")
            else:
                check(np.isfinite(rec) and rec > 0.5,
                      f"serve CLI {label}: recall {rec}")
            emit(row)
        emit({"phase": "ref20k.cli_loads", "processes": len(procs),
              "seconds": time.perf_counter() - t0})

        fpath = os.path.join(tmp, "frontier.json")
        ivf = CLI_20K[3][1]
        t0 = time.perf_counter()
        serve.main([*data, *ivf, "--tune", "--save-frontier", fpath])
        tune_s = time.perf_counter() - t0
        from repro_torch import ckpt
        from repro_torch.anns import tune
        frontier = ckpt.load_frontier(fpath)
        pick = tune.choose(frontier, tune.RecallSLO(0.9), backend="ivf")
        rec = serve.main([*data, *ivf, "--load-frontier", fpath,
                          "--target-recall", "0.9"])
        check(abs(rec - pick.recall) <= 0.02,
              f"serve --target-recall 0.9: recall {rec} vs the pick's "
              f"swept {pick.recall}")
        emit({"phase": "ref20k.cli_tune", "tune_s": tune_s,
              "frontier_points": len(frontier.points),
              "pick_ef": pick.params.ef, "pick_recall@10": pick.recall,
              "served_recall@10": rec})
    demo = serve.main([*data, *ivf, "--filter-demo"])
    check(len(demo) == 4 and all(0.0 <= r <= 1.0 for r in demo.values())
          and demo[1.0] > 0.5, f"serve --filter-demo: {demo}")
    emit({"phase": "ref20k.cli_filter_demo",
          "recall@10_by_selectivity": {str(k): v for k, v in demo.items()}})
    cli_episodes(serve)


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
# 9. the CRINN RL loop
# ---------------------------------------------------------------------------
#: iterations a module: the depth the script's time limit leaves (each
#: graph_construction iteration builds 6 alpha-pruned graphs, 60-300 s)
RL_ITERS = 1
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


# ---------------------------------------------------------------------------
# 10. the single-device trainer, the dense zoo and GenerateServer
# ---------------------------------------------------------------------------
#: launch.train's run: crinn-policy-100m, 24 steps of seq 128 x batch 8,
#: a checkpoint every 6 steps (launch.train's max(5, steps // 4))
TRAIN_ARGV = ["--arch", "crinn-policy-100m", "--seq", "128",
              "--global-batch", "8"]
TRAIN_STEPS, RESUME_STEPS = 24, 4
#: the failure drill: a failure injected at step 9, checkpoints every 4
DRILL = {"fail_at": 9, "ckpt_every": 4, "steps": 12}
DANUBE = "h2o-danube-1.8b"


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _policy_trainer(cfg, ckpt_dir: str, device: str, **kw):
    """A Trainer as launch.train builds one (seq 128: chunks of 128, block
    remat, warmup steps // 10), on init_params from seed 0."""
    from repro_torch.core.grpo import GRPOConfig
    from repro_torch.models import Runtime, model
    from repro_torch.runtime import Trainer, TrainerConfig
    rt = Runtime(attn_chunk=128, logit_chunk=128, remat="block")
    gen = torch.Generator(device=device).manual_seed(0)
    lm = model.init_params(gen, cfg, device)
    steps = kw.pop("total_steps", TRAIN_STEPS)
    tcfg = TrainerConfig(total_steps=steps, warmup_steps=max(1, steps // 10),
                         ckpt_dir=ckpt_dir, **kw)
    return Trainer(cfg, rt, lm, tcfg=tcfg, gcfg=GRPOConfig())


def train_card_vs_cpu(tmp: str) -> dict:
    """The first trainer step that moves the weights (step 1: step 0's
    learning rate is 0 under the warmup) of crinn-policy-100m in fp32, on
    the card and on the CPU from the same weights, AdamW state and
    PromptPipeline batch: the loss within 1e-5 relative, the weights within
    1e-6 on >= 99.99% of elements and within 2.5 lr on all, as phase rl
    holds its first update."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import PromptPipeline
    cfg = dataclasses.replace(get_config("crinn-policy-100m"), dtype="float32")
    pipe = PromptPipeline(seq_len=128, global_batch=8)
    big = {"ckpt_every": 10 ** 6}
    card = _policy_trainer(cfg, os.path.join(tmp, "card"), "cuda", **big)
    card.run(pipe.batch, steps=1)
    before = {n: p.detach().cpu().clone() for n, p in card.params.items()}
    state = _cpu_copy(card.opt_state)
    card.run(pipe.batch, steps=1)
    t0 = time.perf_counter()
    cpu = _policy_trainer(cfg, os.path.join(tmp, "cpu"), "cpu", **big)
    with torch.no_grad():
        for n, p in cpu.params.items():
            p.copy_(before[n])
    cpu.opt_state, cpu.step = state, 1
    cpu.run(pipe.batch, steps=1)
    diff = torch.cat([(card.params[n].detach().cpu() - p.detach()).abs().flatten()
                      for n, p in cpu.params.items()])
    lr = card.metrics_log[-1]["lr"]
    out = {"step": 1, "lr": lr, "loss_card": card.metrics_log[-1]["loss"],
           "loss_cpu": cpu.metrics_log[-1]["loss"],
           "max_abs_diff": float(diff.max()),
           "share_within_1e-6": float((diff <= 1e-6).double().mean()),
           "elements": diff.numel(), "cpu_seconds": time.perf_counter() - t0}
    out["loss_rel_diff"] = (abs(out["loss_card"] - out["loss_cpu"])
                            / abs(out["loss_cpu"]))
    check(lr > 0, "step 1's learning rate is 0")
    check(out["loss_rel_diff"] <= 1e-5 and out["share_within_1e-6"] >= 0.9999
          and out["max_abs_diff"] <= 2.5 * lr,
          f"the card's trainer step differs from the CPU's: {out}")
    return out


def train_remat(tmp: str) -> dict:
    """One lm_loss step of crinn-policy-100m at seq 1024 x batch 8 with
    remat none and block: losses at rtol 1e-6, gradients within 1e-5
    relative in norm; both peaks."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Runtime, model
    cfg = get_config("crinn-policy-100m")
    lm = model.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                           "cuda")
    toks = torch.as_tensor(TokenPipeline(cfg.vocab_size, 1024, 8).batch(0),
                           device="cuda")
    params = list(lm.parameters())
    out, grads = {}, {}
    for remat in ("none", "block"):
        rt = Runtime(attn_chunk=512, logit_chunk=512, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = model.lm_loss(lm, {"tokens": toks}, rt)
        grads[remat] = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        out[remat] = {"loss": float(loss.detach()),
                      "seconds": time.perf_counter() - t0,
                      "peak_device_bytes": torch.cuda.max_memory_allocated()}
    num = sum(float((a.float() - b.float()).square().sum())
              for a, b in zip(grads["block"], grads["none"]))
    den = sum(float(b.float().square().sum()) for b in grads["none"])
    out["grad_rel_diff"] = (num / den) ** 0.5
    out["loss_rel_diff"] = (abs(out["block"]["loss"] - out["none"]["loss"])
                            / abs(out["none"]["loss"]))
    check(out["loss_rel_diff"] <= 1e-6 and out["grad_rel_diff"] <= 1e-5,
          f"remat block differs from none: {out}")
    return out


def train_danube(tmp: str, counters) -> tuple[dict, dict]:
    """h2o-danube-1.8b at full width in its dtype (bf16): 2 lm_loss trainer
    steps (seq 512 x batch 4, block remat, no checkpoint; the second
    traced), then a
    GenerateServer call of (4, 256) prompts + 32 greedy steps, its flash
    launches counted (one per layer); then, in fp32, prefill + one decode
    step against the forward's last logits at 1e-3.  Returns (the row, the
    kernels' launches over the GenerateServer call)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Runtime, model
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.runtime.server import GenerateServer
    cfg = get_config(DANUBE)
    rt = Runtime(attn_chunk=512, logit_chunk=512, remat="block")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = model.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                           "cuda")
    pipe = TokenPipeline(cfg.vocab_size, 512, 4)
    tr = Trainer(cfg, rt, lm, tcfg=TrainerConfig(
        total_steps=2, warmup_steps=1, ckpt_every=10 ** 6,
        ckpt_dir=os.path.join(tmp, "danube")),
        loss_fn=lambda m, b: model.lm_loss(m, b, rt))
    def batch(step):
        return {"tokens": pipe.batch(step)}

    tr.run(batch, steps=1)
    wall, by_kernel = traced(lambda: tr.run(batch, steps=1))   # step 1
    log = tr.metrics_log
    row = {"arch": DANUBE, "param_count": cfg.param_count(),
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads], "head_dim": cfg.head_dim,
           "losses": [r["loss"] for r in log],
           "step_seconds": [r["dt"] for r in log],
           "train_peak_device_bytes": torch.cuda.max_memory_allocated(),
           "step_trace": {"step": 1, "wall_s": wall,
                          "device_busy_share": sum(by_kernel.values()) / 1e6 / wall,
                          "top_device_us": top_kernels(by_kernel, 6)}}
    check(len(log) == 2 and all(np.isfinite(r["loss"]) for r in log),
          f"{DANUBE} losses {row['losses']}")
    del tr, log
    torch.cuda.empty_cache()

    B, S, Hq, Hk, D = DANUBE_PREFILL
    n_new = 32
    prompts = TokenPipeline(cfg.vocab_size, S, B, seed=1).batch(0)
    srv = GenerateServer(cfg, lm, rt, batch=B, max_seq=S + n_new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    t0 = time.perf_counter()
    toks = srv.generate(prompts, n_new)
    gen_s = time.perf_counter() - t0
    launches = read_counts(counters)
    row["generate"] = {"prompts": [B, S], "new_tokens": n_new,
                       "seconds": gen_s, "tokens_per_s": B * n_new / gen_s,
                       "peak_device_bytes": torch.cuda.max_memory_allocated(),
                       "launches": launches}
    check(toks.shape == (B, n_new) and ((toks >= 0)
                                        & (toks < cfg.padded_vocab)).all(),
          f"GenerateServer tokens {toks.shape}")
    check(launches["flash"] == cfg.num_layers and launches["distance"] == 0
          and launches["topk"] == 0 and launches["qdist"] == 0,
          f"GenerateServer launched {launches}; the prefill should launch "
          f"flash once per layer ({cfg.num_layers})")
    wall, by_kernel = traced(lambda: srv.generate(prompts, n_new))
    flash_us = sum(us for name, us in by_kernel.items() if "flash" in name)
    row["generate"]["trace"] = {
        "wall_s": wall, "flash_device_us": flash_us,
        "device_busy_share": sum(by_kernel.values()) / 1e6 / wall,
        "top_device_us": top_kernels(by_kernel, 6)}
    del srv, lm
    torch.cuda.empty_cache()

    # decode matches forward at full width (tests/test_models_smoke.py:76)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    lm = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg32, "cuda")
    toks = torch.as_tensor(prompts[:2], device="cuda")
    with torch.no_grad():
        hidden, _ = model.forward_train(lm, toks, rt)
        want = lm.embed.logits(hidden[:, -1:])[:, 0]
    caches = model.init_cache(cfg32, 2, S + 8, device="cuda")
    _, caches, clen = model.prefill(lm, toks[:, :-1], rt, caches)
    got, _, _ = model.decode_step(lm, toks[:, -1:], rt, caches, clen)
    err = float((got - want).abs().max())
    row["decode_vs_forward"] = {"dtype": "float32", "shape": [2, S],
                                "max_abs_err": err,
                                "logits_abs_max": float(want.abs().max())}
    check(bool(torch.allclose(got, want, rtol=1e-3, atol=1e-3)),
          f"{DANUBE}: prefill + decode differs from the forward: {err}")
    del lm, caches, hidden
    torch.cuda.empty_cache()
    return row, launches


def phase_train() -> dict:
    """``repro_torch.launch.train`` at full width, its resume in a separate
    process, a failure drill, the card against the CPU, remat, and
    h2o-danube-1.8b's trainer steps and GenerateServer call; returns the
    kernels' launches on the path (GenerateServer's)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import PromptPipeline
    from repro_torch.launch import train as train_main
    from repro_torch.runtime import FailureInjector, Trainer

    counters = kernel_counters()
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="train_", dir=os.path.join(ROOT, "build"))
    try:
        # 1. launch.train, each save timed on the caller's thread
        ckdir = os.path.join(tmp, "ckpt")
        saves, save = [], Trainer.save

        def timed_save(self):
            t0 = time.perf_counter()
            save(self)
            saves.append({"step": self.step,
                          "caller_s": time.perf_counter() - t0})

        Trainer.save = timed_save
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        try:
            t0 = time.perf_counter()
            out, log = _captured(train_main, TRAIN_ARGV + [
                "--steps", str(TRAIN_STEPS), "--ckpt-dir", ckdir])
            run_s = time.perf_counter() - t0
        finally:
            Trainer.save = save
        trainer_launches = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        kept = sorted(int(d.split("_")[1]) for d in os.listdir(ckdir))
        for rec in saves:
            path = os.path.join(ckdir, f"step_{rec['step']}")
            rec["bytes"] = _dir_bytes(path) if os.path.isdir(path) else None
        dts = [r["dt"] for r in log]
        row = {"phase": "train", "arch": "crinn-policy-100m",
               "param_count": get_config("crinn-policy-100m").param_count(),
               "steps": len(log), "seconds": run_s,
               "median_step_ms": 1e3 * float(np.median(dts)),
               "first_step_ms": 1e3 * dts[0],
               "loss_first": log[0]["loss"], "loss_last": log[-1]["loss"],
               "straggler": [r["straggler"] for r in log],
               "checkpoints": saves, "kept": kept,
               "peak_device_bytes": peak, "launches": trainer_launches}
        check([r["step"] for r in log] == list(range(TRAIN_STEPS))
              and all(np.isfinite(r["loss"]) for r in log)
              and f"done: {TRAIN_STEPS} steps" in out,
              f"launch.train: {len(log)} steps, output {out[-500:]}")
        check([r["step"] for r in saves] == [6, 12, 18, 24]
              and kept == [12, 18, 24] and saves[-1]["bytes"],
              f"checkpoints saved {saves}, kept {kept}")

        # 2. resume in a separate process
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGV,
             "--steps", str(RESUME_STEPS), "--ckpt-dir", ckdir, "--resume"],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
        check(res.returncode == 0, f"launch.train --resume: exit "
              f"{res.returncode}\n{res.stderr[-3000:]}")
        check(f"resumed from step {TRAIN_STEPS}" in res.stdout
              and f"done: {RESUME_STEPS} steps" in res.stdout,
              f"launch.train --resume printed {res.stdout[-800:]}")
        row["resume"] = {"seconds": time.perf_counter() - t0,
                         "marker": f"resumed from step {TRAIN_STEPS}",
                         "end_step": TRAIN_STEPS + RESUME_STEPS,
                         "output": res.stdout.strip().splitlines()[-2:]}
        shutil.rmtree(ckdir)

        # 3. the failure drill, in this process
        cfg = get_config("crinn-policy-100m")
        drill = _policy_trainer(
            cfg, os.path.join(tmp, "drill"), "cuda",
            total_steps=DRILL["steps"], ckpt_every=DRILL["ckpt_every"])
        drill.injector = FailureInjector(fail_at_steps=(DRILL["fail_at"],))
        dlog = drill.run(PromptPipeline(seq_len=128, global_batch=8).batch)
        by_step = {}
        for rec in dlog:
            by_step.setdefault(rec["step"], []).append(rec["loss"])
        replayed = DRILL["fail_at"] - DRILL["fail_at"] % DRILL["ckpt_every"]
        row["drill"] = {"fail_at": DRILL["fail_at"],
                        "ckpt_every": DRILL["ckpt_every"],
                        "steps_logged": [r["step"] for r in dlog],
                        "replayed_step": replayed,
                        "losses": by_step[replayed], "end_step": drill.step}
        check(len(by_step[replayed]) == 2 and drill.step == DRILL["steps"]
              and abs(by_step[replayed][0] - by_step[replayed][1])
              <= 1e-6 * abs(by_step[replayed][0]),
              f"failure drill: {row['drill']}")
        # where a step's time goes: one more step, traced
        wall, by_kernel = traced(lambda: drill.run(
            PromptPipeline(seq_len=128, global_batch=8).batch, steps=1))
        row["step_trace"] = {"wall_s": wall,
                             "device_busy_share": sum(by_kernel.values()) / 1e6 / wall,
                             "kernels": len(by_kernel),
                             "top_device_us": top_kernels(by_kernel, 6)}
        del drill
        torch.cuda.empty_cache()

        # 4. - 6.
        row["card_vs_cpu"] = train_card_vs_cpu(tmp)
        torch.cuda.empty_cache()
        row["remat"] = train_remat(tmp)
        torch.cuda.empty_cache()
        row["danube"], launches = train_danube(tmp, counters)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["phase_seconds"] = time.perf_counter() - t_phase
    emit(row)
    return launches


# ---------------------------------------------------------------------------
# 11. zoo
# ---------------------------------------------------------------------------
#: each zoo row's arch and layers at full width (depth cut where one 80 GB
#: card cannot hold the bf16 weights, or the AdamW state for training)
ZOO_ROWS = {"jamba": ("jamba-v0.1-52b", 16),
            "deepseek": ("deepseek-moe-16b", 28),
            "rwkv": ("rwkv6-1.6b", 24), "musicgen": ("musicgen-medium", 48),
            "internvl2": ("internvl2-26b", 8), "dbrx": ("dbrx-132b", 2)}
#: the JAX package's ModelConfig.param_count() at each (arch, layers) the
#: phase builds (pure arithmetic, computed on the CPU)
REF_PARAM_COUNT = {("jamba-v0.1-52b", 16): 25994756096,
                   ("jamba-v0.1-52b", 8): 13265813504,
                   ("deepseek-moe-16b", 28): 16375726080,
                   ("deepseek-moe-16b", 4): 2267037696,
                   ("rwkv6-1.6b", 24): 1596473344,
                   ("musicgen-medium", 48): 1818378240,
                   ("internvl2-26b", 8): 4259414016,
                   ("dbrx-132b", 2): 7751294976}
#: GenerateServer's prompts (B, S) and greedy steps; the train rows' batch
ZOO_PROMPTS, ZOO_NEW, ZOO_TRAIN = (4, 256), 32, (512, 4)


def _zoo_cfg(arch: str, layers: int, dtype: str | None = None):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    check(cfg.param_count() == REF_PARAM_COUNT[(arch, layers)],
          f"{arch} at {layers} layers: param_count {cfg.param_count()}, "
          f"the reference's {REF_PARAM_COUNT[(arch, layers)]}")
    return cfg


def _free() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _zoo_model(cfg):
    """init_params on the card from seed 0; (model, seconds)."""
    from repro_torch.models import model
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = model.init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                           "cuda")
    torch.cuda.synchronize()
    check(sum(p.numel() for p in lm.parameters()) > 0, f"{cfg.name}: empty")
    return lm, time.perf_counter() - t0


def zoo_generate(cfg, lm, counters, *, trace: bool = False) -> tuple[dict, dict]:
    """A GenerateServer call of ZOO_PROMPTS (stub embeddings for the audio
    and vlm frontends, TokenPipeline tokens else) + ZOO_NEW greedy steps,
    the kernels' counters set to 0 just before and read just after: flash
    must run once per attention layer.  Then a prefill alone, timed, and
    (``trace``) the call again under the profiler.  Returns (the row, the
    launches)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Runtime, frontend, model
    from repro_torch.runtime.server import GenerateServer
    B, S = ZOO_PROMPTS
    rt = Runtime(remat="none")
    if cfg.frontend != "none":
        prompts = frontend.make_embeds(
            torch.Generator(device="cuda").manual_seed(1), cfg, B, S)
    else:
        prompts = TokenPipeline(cfg.vocab_size, S, B, seed=1).batch(0)
    srv = GenerateServer(cfg, lm, rt, batch=B, max_seq=S + ZOO_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    t0 = time.perf_counter()
    toks = srv.generate(prompts, ZOO_NEW)
    gen_s = time.perf_counter() - t0
    launches = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    n_attn = sum(s.kind == "attention" for s in cfg.block_specs())
    check(toks.shape == (B, ZOO_NEW)
          and ((toks >= 0) & (toks < cfg.padded_vocab)).all(),
          f"{cfg.name}: GenerateServer tokens {toks.shape}")
    check(launches["flash"] == n_attn and launches["distance"] == 0
          and launches["topk"] == 0 and launches["qdist"] == 0,
          f"{cfg.name}: GenerateServer launched {launches}; the prefill "
          f"should launch flash once per attention layer ({n_attn})")
    # the prefill alone, for the decode steps' share of the call
    caches = model.init_cache(cfg, B, S + ZOO_NEW, device="cuda")
    x = torch.as_tensor(prompts, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if x.ndim == 3:
        model.prefill(lm, None, rt, caches, embeds=x)
    else:
        model.prefill(lm, x, rt, caches)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    del caches
    # a decode step reads every weight but the embedding table's unread
    # rows (the MoE's capacity dispatch runs every expert on its >= 8-row
    # buffer): its least time at the HBM rate
    w_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    if not cfg.tie_embeddings:          # the unembedding is read whole
        emb = lm.embed.embedding
        w_bytes -= emb.numel() * emb.element_size()
    row = {"prompts": [B, S], "inputs": ("embeds" if cfg.frontend != "none"
                                         else "tokens"),
           "new_tokens": ZOO_NEW, "seconds": gen_s,
           "tokens_per_s": B * ZOO_NEW / gen_s, "prefill_s": prefill_s,
           "decode_ms_per_step": 1e3 * (gen_s - prefill_s) / ZOO_NEW,
           "decode_bound_ms_per_step": 1e3 * w_bytes / HBM_BYTES_S,
           "weight_bytes_per_step": w_bytes,
           "peak_device_bytes": peak, "attention_layers": n_attn,
           "launches": launches}
    if trace:
        wall, by_kernel = traced(lambda: srv.generate(prompts, ZOO_NEW))
        row["trace"] = {
            "wall_s": wall,
            "flash_device_us": sum(us for n, us in by_kernel.items()
                                   if "flash" in n),
            "device_busy_share": sum(by_kernel.values()) / 1e6 / wall,
            "top_device_us": top_kernels(by_kernel, 6)}
    return row, launches


def zoo_decode_vs_forward(cfg32) -> dict:
    """fp32: prefill of 63 tokens + one decode step against the forward's
    last logits at (2, 64), capacity factor 8 (no MoE drops in the
    forward), within 1e-3 (tests/test_models_smoke.py:74-92)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Runtime, model
    lm, _ = _zoo_model(cfg32)
    rt = Runtime(remat="none", capacity_factor=8.0)
    toks = torch.as_tensor(TokenPipeline(cfg32.vocab_size, 64, 2,
                                         seed=2).batch(0), device="cuda")
    with torch.no_grad():
        hidden, _ = model.forward_train(lm, toks, rt)
        want = lm.embed.logits(hidden[:, -1:])[:, 0]
    caches = model.init_cache(cfg32, 2, 72, device="cuda")
    _, caches, clen = model.prefill(lm, toks[:, :-1], rt, caches)
    got, _, _ = model.decode_step(lm, toks[:, -1:], rt, caches, clen)
    err = float((got - want).abs().max())
    out = {"dtype": "float32", "shape": [2, 64],
           "layers": cfg32.num_layers, "param_count": cfg32.param_count(),
           "max_abs_err": err, "logits_abs_max": float(want.abs().max()),
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    check(bool(torch.allclose(got, want, rtol=1e-3, atol=1e-3)),
          f"{cfg32.name}: prefill + decode differs from the forward: {out}")
    del lm, caches, hidden
    _free()
    return out


def zoo_train(cfg, tmp: str) -> dict:
    """2 Trainer steps of lm_loss + 0.01 aux (GRPOConfig's aux weight) on
    TokenPipeline at ZOO_TRAIN, block remat, no checkpoint: losses finite,
    aux > 0 where the config has experts."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Runtime, model
    from repro_torch.runtime import Trainer, TrainerConfig
    S, B = ZOO_TRAIN
    rt = Runtime(attn_chunk=512, logit_chunk=512, remat="block")
    lm, init_s = _zoo_model(cfg)
    pipe = TokenPipeline(cfg.vocab_size, S, B)

    def loss_fn(m, batch):
        loss, aux = model.lm_loss(m, batch, rt)
        return loss + 0.01 * aux, aux.detach()

    tr = Trainer(cfg, rt, lm, tcfg=TrainerConfig(
        total_steps=2, warmup_steps=1, ckpt_every=10 ** 6,
        ckpt_dir=os.path.join(tmp, cfg.name)), loss_fn=loss_fn)
    tr.run(lambda step: {"tokens": pipe.batch(step)}, steps=2)
    log = tr.metrics_log
    out = {"layers": cfg.num_layers, "param_count": cfg.param_count(),
           "seq_batch": [S, B], "init_s": init_s,
           "losses": [r["loss"] for r in log], "aux": [r["aux"] for r in log],
           "step_seconds": [r["dt"] for r in log],
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    check(len(log) == 2 and all(np.isfinite(r["loss"]) and np.isfinite(r["aux"])
                                for r in log), f"{cfg.name}: {out}")
    if cfg.moe_num_experts:
        check(all(r["aux"] > 0 for r in log), f"{cfg.name}: aux {out['aux']}")
    del tr, lm, log
    _free()
    return out


def phase_zoo() -> dict:
    """The moe, hybrid, ssm, audio and vlm families at full width (bf16,
    seed-0 weights), each row through GenerateServer, jamba and rwkv6 also
    in fp32 against the forward, deepseek and rwkv6 also through the
    Trainer; returns the kernels' launches over the GenerateServer calls
    (the counters set to 0 before each, read after, summed)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config

    counters = kernel_counters()
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="zoo_", dir=os.path.join(ROOT, "build"))
    total = {}
    try:
        for name, (arch, layers) in ZOO_ROWS.items():
            t_row = time.perf_counter()
            cfg = _zoo_cfg(arch, layers)
            lm, init_s = _zoo_model(cfg)
            gen, launches = zoo_generate(
                cfg, lm, counters,
                trace=name in ("jamba", "deepseek"))
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            del lm
            _free()
            row = {"phase": "zoo." + name, "arch": arch,
                   "family": cfg.family, "layers": layers,
                   "full_layers": get_config(arch).num_layers,
                   "param_count": cfg.param_count(),
                   "active_param_count": cfg.active_param_count(),
                   "d_model": cfg.d_model,
                   "heads": [cfg.num_heads, cfg.num_kv_heads],
                   "head_dim": cfg.head_dim, "init_s": init_s,
                   "generate": gen}
            if arch == "jamba-v0.1-52b":
                row["decode_vs_forward"] = zoo_decode_vs_forward(
                    _zoo_cfg(arch, 8, "float32"))
            elif arch == "deepseek-moe-16b":
                row["train"] = zoo_train(_zoo_cfg(arch, 4), tmp)
            elif arch == "rwkv6-1.6b":
                row["train"] = zoo_train(cfg, tmp)
                row["decode_vs_forward"] = zoo_decode_vs_forward(
                    _zoo_cfg(arch, layers, "float32"))
            if cfg.num_heads == 0:
                row["note"] = "attention-free: no port kernel runs"
            row["seconds"] = time.perf_counter() - t_row
            emit(row)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "zoo", "seconds": time.perf_counter() - t_phase,
          "rows": list(ZOO_ROWS), "launches": total})
    return total


# ---------------------------------------------------------------------------
# 12. dist
# ---------------------------------------------------------------------------
#: launch.train at world 1: the train phase's policy run, cut to 4 steps
DIST_TRAIN_ARGV = ["--arch", "crinn-policy-100m", "--seq", "128",
                   "--global-batch", "8", "--steps", "4"]
#: the two-rank checks: deepseek's MoE layer on (B, S) tokens, glm4-9b's
#: attention decode after a prompt of DIST_PROMPT tokens into a cache of
#: DIST_PROMPT + 1 positions, split in two
DIST_MOE_TOKENS, DIST_PROMPT = (4, 128), 8191
#: deepseek-4's Trainer steps on each MoE branch (the second moves weights
#: the first updated, so it also holds the update to bit-equality)
DIST_MOE_STEPS = 2
DIST_TOL = 1e-4


@contextlib.contextmanager
def _stdout_to_stderr():
    """Send file descriptor 1 (this process's and its children's) to
    standard error, keeping the standard output for the JSON lines."""
    sys.stdout.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def _world_one(store: str):
    """A one-rank NCCL group on this card; its 1x1 mesh."""
    from repro_torch.launch.mesh import init_distributed, make_debug_mesh
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    init_distributed("cuda", init_method=f"file://{store}", timeout_s=300)
    return make_debug_mesh(1, 1)


def dist_moe_step(mesh, tmp: str) -> dict:
    """deepseek-moe-16b at full width, 4 of 28 layers: DIST_MOE_STEPS
    lm_loss + 0.01 aux Trainer steps on the local MoE branch, then the same
    from the same weights through the expert-parallel branch on ``mesh``
    (tp = 1); the last step's ms (the first pays NCCL's communicator set-up
    on the mesh's groups)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Runtime, model
    from repro_torch.runtime import Trainer, TrainerConfig
    cfg = _zoo_cfg("deepseek-moe-16b", 4)
    S, B = ZOO_TRAIN
    pipe = TokenPipeline(cfg.vocab_size, S, B)
    out = {}
    for branch, m in (("local", None), ("expert_parallel", mesh)):
        rt = Runtime(mesh=m, attn_chunk=512, logit_chunk=512, remat="block")

        def loss_fn(lm_, batch, rt=rt):
            loss, aux = model.lm_loss(lm_, batch, rt)
            return loss + 0.01 * aux, aux.detach()

        lm, _ = _zoo_model(cfg)
        tr = Trainer(cfg, rt, lm, tcfg=TrainerConfig(
            total_steps=DIST_MOE_STEPS, warmup_steps=1, ckpt_every=10 ** 6,
            ckpt_dir=os.path.join(tmp, branch)), loss_fn=loss_fn)
        log = tr.run(lambda step: {"tokens": pipe.batch(step)},
                     steps=DIST_MOE_STEPS)
        out[branch] = {k: [r[k] for r in log]
                       for k in ("loss", "aux", "dt", "collective_bytes")
                       if k in log[0]}
        del tr, lm, log
        _free()
    local, ep = out["local"], out["expert_parallel"]
    check(local["loss"] == ep["loss"] and local["aux"] == ep["aux"],
          f"deepseek-4 expert-parallel at tp 1 differs from local: {out}")
    return {"layers": cfg.num_layers, "seq_batch": [S, B],
            "steps": DIST_MOE_STEPS, "step_ms": [1e3 * t for t in ep["dt"]],
            "single_step_ms": [1e3 * t for t in local["dt"]],
            "loss": ep["loss"], "aux": ep["aux"],
            "collective_bytes": ep["collective_bytes"], "bit_equal": True}


def _dist_rank(rank: int, store: str, out_file: str) -> None:
    """One of two ranks on the one card, over Gloo with CUDA tensors:
    deepseek's MoE layer split 32 / 32, glm4-9b's attention decode over a
    cache split in two (its prompt through the flash kernel), and
    compressed_allreduce over crinn-policy-100m's gradient tree."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist import comm, seq_decode
    from repro_torch.kernels.flash.ref import flash_ref
    from repro_torch.launch.mesh import init_distributed, make_debug_mesh
    from repro_torch.models import Runtime, model
    from repro_torch.models.attention import Attention
    from repro_torch.models.layers import apply_rope, rope_freqs
    from repro_torch.models.moe import MoE
    from repro_torch.optim.grad_compress import (compress_with_feedback,
                                                 compressed_allreduce)
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    init_distributed("cuda", backend="gloo", init_method=f"file://{store}",
                     timeout_s=300)
    res = {"rank": rank}
    try:
        mesh = make_debug_mesh(1, 2)
        dev = torch.device("cuda")
        counters = kernel_counters()
        g = torch.Generator(device=dev)

        # deepseek's MoE layer, fp32, 64 routed experts: 32 a rank
        cfg = dataclasses.replace(get_config("deepseek-moe-16b"),
                                  dtype="float32")
        g.manual_seed(0)
        layer = MoE(cfg, device=dev)
        with torch.no_grad():
            for n, p in layer.named_parameters():
                p.copy_(torch.randn(p.shape, generator=g, device=dev)
                        * layer.init_stds[n])
        x = torch.randn(*DIST_MOE_TOKENS, cfg.d_model, generator=g, device=dev)
        with torch.no_grad():
            want, waux = layer(x)
            half = cfg.moe_num_experts // 2
            for n in ("w_gate", "w_in", "w_out"):
                p = getattr(layer, n)
                p.data = p.data[rank * half:(rank + 1) * half].clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with comm.count_collectives() as counted:
                got, aux = layer(x, mesh=mesh,
                                 dp_axes=Runtime(mesh=mesh).data_axes())
            torch.cuda.synchronize()
            res["moe"] = {"experts_per_rank": half,
                          "tokens": DIST_MOE_TOKENS[0] * DIST_MOE_TOKENS[1],
                          "max_abs_err": float((got - want).abs().max()),
                          "aux": float(aux), "aux_local": float(waux),
                          "ms": 1e3 * (time.perf_counter() - t0),
                          "collective_bytes": counted["total_bytes"]}
        del layer, want, got
        torch.cuda.empty_cache()

        # glm4-9b's attention at full width: prefill (flash) into a split
        # cache, then one decode step against the plain decode
        cfg = dataclasses.replace(get_config("glm4-9b"), dtype="float32")
        g.manual_seed(1)
        attn = Attention(cfg, device=dev)
        with torch.no_grad():
            for n, p in attn.named_parameters():
                p.copy_(torch.randn(p.shape, generator=g, device=dev)
                        * attn.init_stds[n])
            size = DIST_PROMPT + 1
            xs = torch.randn(1, size, cfg.d_model, generator=g, device=dev)
            pos = torch.arange(size, device=dev)[None]
            shape = (1, size, cfg.num_kv_heads, cfg.head_dim)
            whole = {"k": torch.zeros(shape, device=dev),
                     "v": torch.zeros(shape, device=dev)}
            part = seq_decode.place_cache(
                {"k": whole["k"].clone(), "v": whole["v"].clone()}, mesh)
            zero_counts(counters)
            prefilled = attn(xs[:, :-1], window=0, positions=pos[:, :-1],
                             mode="prefill", cache=part)
            res["launches"] = read_counts(counters)
            # the rope'd q / K / V the prefill gave flash: K / V fill the
            # whole cache for the plain decode, and flash's plain version
            # (a KV head's group at a time, 4.3 GB of scores) projected by
            # wo is held against the prefill's output
            cos, sin = rope_freqs(cfg, pos[:, :-1], cfg.head_dim)
            qkv = [torch.einsum("bsd,dhe->bshe", xs[:, :-1], w)
                   for w in (attn.wq, attn.wk, attn.wv)]
            q, k, v = (apply_rope(qkv[0], cos, sin),
                       apply_rope(qkv[1], cos, sin), qkv[2])
            whole["k"][:, :-1], whole["v"][:, :-1] = k, v
            G = cfg.num_heads // cfg.num_kv_heads
            o = torch.cat([flash_ref(q[:, :, h * G:(h + 1) * G],
                                     k[:, :, h:h + 1], v[:, :, h:h + 1],
                                     q_scale=cfg.q_scale,
                                     softcap=cfg.attn_logit_softcap)
                           for h in range(cfg.num_kv_heads)], dim=2)
            want = torch.einsum("bshe,hed->bsd", o, attn.wo)
            tol = FLASH_TOL[torch.float32]
            torch.testing.assert_close(prefilled, want, rtol=tol, atol=tol)
            res["prefill"] = {"shape": [1, DIST_PROMPT, cfg.num_heads,
                                        cfg.num_kv_heads, cfg.head_dim],
                              "max_abs_err": float((prefilled - want).abs()
                                                   .max()),
                              "tolerance": tol}
            del q, k, v, qkv, o, want, prefilled
            rt = Runtime(mesh=mesh, seq_shard_decode=True, remat="none")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with comm.count_collectives() as counted:
                got = attn(xs[:, -1:], window=0, positions=pos[:, -1:],
                           mode="decode", cache=part, cache_len=DIST_PROMPT,
                           rt=rt)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            want = attn(xs[:, -1:], window=0, positions=pos[:, -1:],
                        mode="decode", cache=whole, cache_len=DIST_PROMPT)
            res["decode"] = {"cache": size, "positions_per_rank":
                             part["k"].shape[1], "heads": [cfg.num_heads,
                                                           cfg.num_kv_heads],
                             "head_dim": cfg.head_dim,
                             "max_abs_err": float((got - want).abs().max()),
                             "ms": ms,
                             "collective_bytes": counted["total_bytes"]}
        del attn, part, whole
        torch.cuda.empty_cache()

        # compressed_allreduce over the policy's gradient tree
        cfg = get_config("crinn-policy-100m")
        shapes = {n: p.shape for n, p in
                  model.DecoderLM(cfg, device="meta").named_parameters()}
        g.manual_seed(10 + rank)
        grads = {n: torch.randn(s, generator=g, device=dev) * 1e-3
                 for n, s in shapes.items()}
        resid = {n: torch.zeros(s, device=dev) for n, s in shapes.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with comm.count_collectives() as counted:
            red, _ = compressed_allreduce(grads, resid, mesh, "model")
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        comp, _ = compress_with_feedback(grads, resid)
        equal = True
        for n, c in comp.items():
            q1, s1 = c.q.to(torch.int32), c.scale.reshape(1).clone()
            dist.broadcast(q1, src=1)
            dist.broadcast(s1, src=1)
            if rank == 0:
                q0, s0 = c.q.to(torch.int32), c.scale.reshape(1)
                want = (q0 + q1).float() * ((s0 + s1) / 2)
                equal &= bool(torch.equal(red[n], want))
        res["compressed"] = {"leaves": len(shapes),
                             "values": sum(int(np.prod(s)) for s in
                                           shapes.values()),
                             "ms": ms, "equal": equal,
                             "collective_bytes": counted["total_bytes"]}
        with open(out_file.format(rank=rank), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_dist() -> dict:
    """The mesh path at world 1 over NCCL (launch.train --debug-mesh 1x1
    against the single-device run, deepseek-4's expert-parallel step at
    tp 1 against the local one), then the combine arithmetic across two
    ranks on the one card over Gloo; returns the kernels' launches on the
    path (the flash prefill's, summed over the two ranks)."""
    import shutil
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.launch import train as train_main

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="dist_", dir=os.path.join(ROOT, "build"))
    row = {"phase": "dist"}
    try:
        # 1. launch.train: one device, then --debug-mesh 1x1 (NCCL, a rank
        # process of its own)
        with _stdout_to_stderr():
            one = train_main.main(DIST_TRAIN_ARGV + [
                "--ckpt-dir", os.path.join(tmp, "one")])
            t0 = time.perf_counter()
            mesh_log = train_main.main(DIST_TRAIN_ARGV + [
                "--ckpt-dir", os.path.join(tmp, "mesh"), "--debug-mesh", "1x1"])
            mesh_s = time.perf_counter() - t0
        row["train_world1"] = {
            "arch": "crinn-policy-100m", "steps": len(mesh_log),
            "losses": [r["loss"] for r in mesh_log],
            "single_losses": [r["loss"] for r in one],
            "step_ms": [1e3 * r["dt"] for r in mesh_log],
            "single_step_ms": [1e3 * r["dt"] for r in one],
            "collective_bytes": [r["collective_bytes"] for r in mesh_log],
            "launcher_s": mesh_s}
        check(len(mesh_log) == 4 and [r["loss"] for r in mesh_log]
              == [r["loss"] for r in one],
              f"--debug-mesh 1x1 losses differ: {row['train_world1']}")
        _free()

        # 2. deepseek-4 through the expert-parallel branch at tp 1
        mesh = _world_one(os.path.join(tmp, "store1"))
        try:
            row["moe_world1"] = dist_moe_step(mesh, tmp)
        finally:
            dist.destroy_process_group()
        _free()

        # 3. two ranks on the one card over Gloo
        out_file = os.path.join(tmp, "rank{rank}.json")
        t0 = time.perf_counter()
        with _stdout_to_stderr():
            mp.start_processes(_dist_rank, args=(
                os.path.join(tmp, "store2"), out_file), nprocs=2, join=True,
                start_method="spawn")
        ranks = []
        for r in range(2):
            with open(out_file.format(rank=r)) as f:
                ranks.append(json.load(f))
        two = ranks[0]
        two["launches"] = {k: ranks[0]["launches"][k] + ranks[1]["launches"][k]
                           for k in ranks[0]["launches"]}
        two["seconds"] = time.perf_counter() - t0
        row["two_ranks"] = two
        check(two["moe"]["max_abs_err"] <= DIST_TOL
              and two["moe"]["aux"] == two["moe"]["aux_local"],
              f"two-rank MoE: {two['moe']}")
        check(two["decode"]["max_abs_err"] <= DIST_TOL,
              f"two-rank decode: {two['decode']}")
        check(two["compressed"]["equal"],
              f"compressed_allreduce: {two['compressed']}")
        check(two["launches"]["flash"] == 2, f"prefill: {two['launches']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["phase_seconds"] = time.perf_counter() - t_phase
    emit(row)
    return two["launches"]


# ---------------------------------------------------------------------------
# 13. shard_mesh: the 1M sharded index placed across two ranks
# ---------------------------------------------------------------------------
#: the placed search's round: queries served in batches at ef 64 and the
#: all-cells probe; the stream history both ranks apply; the small index
#: whose merge bytes must be the 1M index's
SHARD_MESH = {"queries": 2048, "batch": 64, "inserts": 1000, "deletes": 1000,
              "tail_cap": 1024, "n_small": 20_000}
#: a rank's device bytes after placement, relative to device_memory_bytes()
SHARD_MESH_HELD_TOL = 0.10
#: the leader episode on the placed stream_sharded copy, after its checks
#: above: rank 0 sweeps the nprobe ladder through a Leader on the first 64
#: queries (one batch: the all-cells rung holds (64, nlist x pad) slots on
#: each of two ranks sharing the card), resolves async-1M's tenants against
#: that frontier and serves async-1M's burst, then 2,048 mixed requests in
#: windows of max_queue; before window 2, 400 inserts push the tail (1,000
#: of 1,000,000 live) past max_tail_frac and the tail verdict schedules a
#: background compaction; 100 base and 100 tail ids are deleted before
#: window 4; the last window is served after the swap
SHARD_MESH_LEADER = {"sweep_queries": 64, "requests": 2048, "inserts": 400,
                     "insert_at": 2, "deletes": 200, "delete_at": 4,
                     "max_tail_frac": 0.0012, "seed": 12}


def _mesh_params(backend) -> dict:
    from repro_torch.anns import SearchParams
    return {"ef64": SearchParams(k=10, ef=64),
            "all_cells": SearchParams(k=10,
                                      ef=backend.search_ef_ladder()[-1])}


def _mesh_width(backend, params) -> int:
    """A shard's shortlist width for ``params`` (the search's arithmetic)."""
    from repro_torch.anns.backends.ivf import (_probe_floor_nprobe,
                                               shortlist_width)
    idx = backend.index
    p = params.resolved(backend.variant)
    k = min(p.k, idx.n)
    nprobe = _probe_floor_nprobe(idx, backend.variant, p, k)
    return min(shortlist_width(p, k, idx.n, nprobe, idx.cell_pad),
               nprobe * idx.cell_pad)


def _mesh_merge_bytes(world: int, B: int, m_shard: int, cap: int) -> int:
    """A placed batch's collective bytes: the (S, B, m) int32 positions,
    fp32 scan and rerank dists and 1-byte validity, the (S, B, cap) fp32
    tail dists of a streaming index, and the int64 scanned count."""
    return world * B * (13 * m_shard + 4 * cap) + 8


def _serve_batches(backend, q, params, batch: int):
    """ids, dists of ``q`` served in batches of ``batch``; wall seconds."""
    ids, dists = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, len(q), batch):
        r = backend.search(q[lo:lo + batch], params)
        ids.append(r.ids)
        dists.append(r.dists)
    torch.cuda.synchronize()
    return torch.cat(ids), torch.cat(dists), time.perf_counter() - t0


def _leader_episode(b, data, log_path: str) -> dict:
    """Rank 0's half of the leader episode (``SHARD_MESH_LEADER``) over the
    placed ``b``: everything goes through a recording Leader, whose op log
    is written to ``log_path``."""
    import asyncio

    from repro_torch.anns.datasets import DATASET_SPECS, Dataset, recall_at_k
    from repro_torch.anns.stream import BackgroundCompactor, exact_live_gt
    from repro_torch.anns.tune import sweep_frontier
    from repro_torch.dist import comm
    from repro_torch.dist.leader import Leader
    from repro_torch.serve import (AsyncServeTier, Overloaded,
                                   ServeRejection, attach_drift_monitors,
                                   parse_tenant_specs, resolve_tenants)

    cfg, acfg = SHARD_MESH_LEADER, ASYNC_1M
    q = data["queries"]
    n = cfg["sweep_queries"]
    out = {}
    with comm.count_collectives() as cnt, Leader(b, record=True) as leader:
        # the gt over the live set (on rank 0's host master, no record)
        gt = exact_live_gt(leader, q, 10)
        # a sweep reads queries and gt; the base's rows are the index's
        view = Dataset(spec=DATASET_SPECS["sift-128-euclidean"],
                       base=np.empty((b.n_live(), 0), np.float32),
                       queries=q[:n], gt=gt[:n], k_gt=10)
        t0 = time.perf_counter()
        frontier = sweep_frontier(view, backends=(), targets=[leader], k=10,
                                  repeats=1)
        out["sweep_s"] = time.perf_counter() - t0
        tenants = resolve_tenants(parse_tenant_specs(acfg["tenants"]),
                                  target=leader, frontier=frontier)
        attach_drift_monitors(tenants, max_tail_frac=cfg["max_tail_frac"])
        tier = AsyncServeTier(leader, tenants, max_batch=acfg["max_batch"],
                              max_queue=acfg["max_queue"])
        compactor = BackgroundCompactor(leader)
        tier.attach_compactor(compactor)
        rows = np.random.default_rng(cfg["seed"]).permutation(len(q))
        names = ["gold"] * acfg["mix"] + ["bronze"]
        found = {n_: [] for n_ in tenants}
        served = {n_: [] for n_ in tenants}
        lat = {n_: [] for n_ in tenants}

        async def episode():
            burst, shed = [], 0
            for i in range(acfg["burst"]):
                try:
                    burst.append(tier.submit(q[rows[i % len(rows)]],
                                             names[i % len(names)]))
                except Overloaded:
                    shed += 1
            out["admitted"], out["shed_overload"] = len(burst), shed
            tier.start()
            await asyncio.gather(*burst, return_exceptions=True)
            windows = list(range(0, cfg["requests"], acfg["max_queue"]))
            verdicts = []
            t0 = time.perf_counter()
            for w, lo in enumerate(windows):
                if w == cfg["insert_at"]:
                    leader.insert(data["more_inserts"], ids=data["more_ids"])
                    for name in sorted(tenants):
                        if found[name]:
                            rec = recall_at_k(np.stack(found[name]),
                                              gt[np.asarray(served[name])],
                                              10)
                            v = tier.batcher.observe_served(
                                name, recall=rec,
                                tail_fraction=leader.tail_fraction())
                            verdicts.append([name, v.reason])
                if w == cfg["delete_at"]:
                    leader.delete(data["more_deletes"])
                if w == len(windows) - 1:
                    # the last window after the swap; the wait is not
                    # serving time
                    tj = time.perf_counter()
                    compactor.join()
                    out["join_wait_s"] = time.perf_counter() - tj
                subs = []
                for i in range(lo, min(lo + acfg["max_queue"],
                                       cfg["requests"])):
                    name = names[i % len(names)]
                    qi = int(rows[i % len(rows)])
                    subs.append((name, qi, tier.submit(q[qi], name)))
                for name, qi, fut in subs:
                    try:
                        r = await fut
                    except ServeRejection:
                        continue
                    found[name].append(r.ids)
                    served[name].append(qi)
                    lat[name].append(r.latency_ms)
            out["wall_s"] = time.perf_counter() - t0
            out["verdicts"] = verdicts
            await tier.close(drain=True)

        asyncio.run(episode())
    with open(log_path, "wb") as f:
        pickle.dump(leader.log, f)
    tot = tier.telemetry.totals()
    out.update(tallies=leader.tallies, runs=compactor.runs,
               accounted=tot.accounted(), totals=tier.telemetry.snapshot()[
                   "totals"],
               op_stream_bytes=cnt["op-stream"]["bytes"],
               merge_bytes=sum(cnt.get(op, {}).get("bytes", 0)
                               for op in ("all-gather", "all-reduce")))
    out["per_tenant"] = {
        name: {"pick_ef": st.params.ef, "swept_recall@10": st.point.recall,
               "served": len(found[name]),
               "qps": len(found[name]) / (out["wall_s"]
                                          - out["join_wait_s"]),
               "served_recall@10": (recall_at_k(
                   np.stack(found[name]), gt[np.asarray(served[name])], 10)
                   if found[name] else float("nan")),
               "p50_ms": float(np.percentile(lat[name], 50)),
               "p99_ms": float(np.percentile(lat[name], 99))}
        for name, st in tenants.items()}
    return out


def _follow_episode(b) -> dict:
    """A follower's half of the leader episode: replay rank 0's records."""
    from repro_torch.dist import comm
    from repro_torch.dist.leader import follow
    with comm.count_collectives() as cnt:
        tallies = follow(b)
    return {"tallies": tallies, "op_stream_bytes": cnt["op-stream"]["bytes"]}


def _op_stream_closed_form(log: list, world: int, d: int) -> int:
    """The op stream's bytes on each rank: a header a record (and the
    stop's), the fp32 queries of each search and warm, an insert's fp32
    vectors and int64 ids, a delete's int64 ids, and the stop's tally (a
    rank's 4 int64 from every rank)."""
    from repro_torch.dist.leader import HEADER_BYTES
    total = (len(log) + 1) * HEADER_BYTES + world * 4 * 8
    for e in log:
        if e["op"] in ("search", "warm"):
            total += e["arrays"][0].shape[0] * d * 4
        elif e["op"] == "insert":
            total += len(e["arrays"][0]) * (d * 4 + 8)
        elif e["op"] == "delete":
            total += len(e["arrays"][0]) * 8
    return total


def _check_leader_episode(ranks: list, log: list, twin, async_qps: dict,
                          d: int) -> dict:
    """The leader episode's checks, against ``twin`` (the single-device
    stream_sharded in the episode's starting state), which replays the
    log; returns the phase row's ``leader`` entry."""
    from repro_torch.dist.leader import HEADER_BYTES, replay
    lead, fol = ranks[0]["stream_sharded"]["leader"], \
        ranks[1]["stream_sharded"]["leader"]
    acfg = ASYNC_1M
    t0 = time.perf_counter()
    results = replay(log, twin)
    replay_s = time.perf_counter() - t0
    searches = [e for e in log if e["op"] == "search"]
    bad = [i for i, (e, r) in enumerate(zip(searches, results))
           if not (np.array_equal(e["ids"], r.ids.cpu().numpy())
                   and np.array_equal(e["dists"], r.dists.cpu().numpy()))]
    check(len(searches) == len(results) and not bad,
          f"leader: {len(bad)} of {len(searches)} batches differ from the "
          f"single-device replay (first {bad[:5]})")
    check(lead["admitted"] == acfg["max_queue"]
          and lead["shed_overload"] == acfg["burst"] - acfg["max_queue"],
          f"leader burst: {lead['admitted']} admitted, "
          f"{lead['shed_overload']} shed")
    t = lead["totals"]
    check(lead["accounted"], f"leader accounting: {t}")
    check(lead["tallies"] == fol["tallies"]
          and lead["tallies"][0] == lead["tallies"][1],
          f"leader: ranks end at {lead['tallies']} / {fol['tallies']}")
    epoch, seqno = lead["tallies"][0][2:]
    check(epoch == 1 and lead["runs"] == 1
          and (twin.epoch, twin.seqno) == (epoch, seqno),
          f"leader: epoch {epoch}, {lead['runs']} compactions, replay at "
          f"{(twin.epoch, twin.seqno)}")
    dead, after = set(), 0
    for e in log:
        if e["op"] == "delete":
            dead |= set(e["arrays"][0].tolist())
        elif e["op"] == "search" and dead:
            check(dead.isdisjoint(e["ids"].ravel().tolist()),
                  "leader: a deleted id was served")
            after += 1
    ops = [e["op"] for e in log]
    p, c = ops.index("prepare"), ops.index("commit")
    want = _op_stream_closed_form(log, 2, d)
    batch = {e["arrays"][0].shape[0] for e in log
             if e["op"] in ("search", "warm")}
    check(lead["op_stream_bytes"] == fol["op_stream_bytes"] == want
          and batch == {acfg["max_batch"]},
          f"leader op stream: {lead['op_stream_bytes']} / "
          f"{fol['op_stream_bytes']} bytes, closed form {want}; batches "
          f"{batch}")
    return {"sweep_s": lead["sweep_s"],
            "compaction_s": log[c]["t"] - log[p]["t"],
            "searches_during_compaction": ops[p:c].count("search"),
            "delete_in_journal": "delete" in ops[p:c],
            "searches_after_deletes": after,
            "replay_s": replay_s, "batches_bit_equal": len(searches),
            "burst": {"admitted": lead["admitted"],
                      "shed_overload": lead["shed_overload"]},
            "totals": t, "verdicts": lead["verdicts"],
            "epoch_seqno": [epoch, seqno], "records": lead["tallies"][0][0],
            "op_stream_bytes": want,
            "op_stream_bytes_per_batch": HEADER_BYTES + acfg["max_batch"] * d * 4,
            "merge_bytes_per_search": lead["merge_bytes"] / (
                ops.count("search") + ops.count("warm")),
            "wall_s": lead["wall_s"], "join_wait_s": lead["join_wait_s"],
            "per_tenant": {name: {**row, "qps_single": async_qps.get(name)}
                           for name, row in lead["per_tenant"].items()},
            "launches": {"rank0": lead["launches"],
                         "rank1": fol["launches"]}}


def _shard_mesh_rank(rank: int, store: str, tmp: str) -> None:
    """One of two ranks on the one card over Gloo with CUDA tensors: load
    each saved index onto the card, place it (this rank's shard alone),
    apply the stream history to the streaming one, serve the queries;
    rank 0 keeps its ids and dists."""
    import torch.distributed as dist

    from repro_torch import ckpt
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import init_distributed, make_shard_mesh
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    init_distributed("cuda", backend="gloo", init_method=f"file://{store}",
                     timeout_s=300)
    try:
        mesh = make_shard_mesh(2)
        data = np.load(os.path.join(tmp, "inputs.npz"))
        q = torch.from_numpy(data["queries"]).cuda()
        counters = kernel_counters()
        res, arrays = {"rank": rank}, {}
        launches = {k: 0 for k in read_counts(counters)}
        for name in ("sharded", "stream_sharded", "small"):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            b = ckpt.load_index(os.path.join(tmp, name))
            b.place_on_mesh(mesh)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            row = {"held_bytes": torch.cuda.memory_allocated() - before,
                   "device_memory_bytes": b.device_memory_bytes(),
                   "leading": [getattr(b.index, f).shape[0] for f in
                               ("cells", "vec_start", "base_q", "scales",
                                "base_f")]}
            if name == "stream_sharded":
                b.insert(data["inserts"], ids=data["insert_ids"])
                b.delete(data["deletes"])
            cap = getattr(b, "tail_cap", 0)
            nq = len(q) if name != "small" else SHARD_MESH["batch"]
            for label, params in _mesh_params(b).items():
                zero_counts(counters)
                with comm.count_collectives() as cnt:
                    ids, dists, secs = _serve_batches(b, q[:nq], params,
                                                      SHARD_MESH["batch"])
                counts = read_counts(counters)
                if name != "small":
                    launches = {k: launches[k] + counts[k] for k in counts}
                batches = -(-nq // SHARD_MESH["batch"])
                row[label] = {"seconds": secs, "qps": nq / secs,
                              "bytes_per_batch": cnt["total_bytes"] / batches,
                              "m_shard": _mesh_width(b, params), "cap": cap}
                arrays[f"{name}/{label}/ids"] = ids.cpu().numpy()
                arrays[f"{name}/{label}/dists"] = dists.cpu().numpy()
            if name == "stream_sharded":
                zero_counts(counters)
                row["leader"] = (
                    _leader_episode(b, data, os.path.join(tmp, "leader.pkl"))
                    if rank == 0 else _follow_episode(b))
                counts = read_counts(counters)
                row["leader"]["launches"] = counts
                launches = {k: launches[k] + counts[k] for k in counts}
            res[name] = row
            del b
            torch.cuda.empty_cache()
        res["launches"] = launches
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        if rank == 0:
            np.savez(os.path.join(tmp, "rank0.npz"), **arrays)
    finally:
        dist.destroy_process_group()


def phase_shard_mesh(ds, kept: dict, async_qps: dict) -> dict:
    """The 1M sharded index (2 shards) saved under build/, then served by
    two ranks on the one card over Gloo with CUDA tensors, each holding
    one shard (``place_on_mesh``); the same for a stream_sharded copy
    after 1,000 inserts and 1,000 deletes on both ranks.  Checks rank 0's
    ids and dists bit-equal to the single-device backends', each rank's
    device bytes within 10% of ``device_memory_bytes()``, the merge bytes
    a batch the closed form and those of a 20k index of the same variant;
    records the placed QPS beside the single-device QPS.  Then the leader
    episode (``SHARD_MESH_LEADER``) on the placed stream_sharded copy:
    rank 0's op log replayed here on the single-device copy, every batch
    bit-equal; the burst's admissions, the accounting, both ranks' epoch
    and seqno, no deleted id served, the op stream's bytes the closed
    form; placed QPS a tenant beside ``async_qps`` (phase_async's, one
    device), compaction and sweep seconds.  Returns the ranks' kernel
    launches, summed."""
    import dataclasses
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch import ckpt
    from repro_torch.anns import registry

    t_phase = time.perf_counter()
    cfg = SHARD_MESH
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="shard_mesh_", dir=os.path.join(ROOT, "build"))
    row = {"phase": "shard_mesh", "ranks": 2, "config": cfg}
    try:
        sharded = kept["sharded"]
        rng = np.random.default_rng(11)
        q = ds.queries[:cfg["queries"]]
        ins = (ds.base[rng.integers(0, len(ds.base), cfg["inserts"])]
               + np.float32(0.01))
        ins_ids = np.arange(10 ** 7, 10 ** 7 + cfg["inserts"], dtype=np.int32)
        dels = rng.choice(sharded.index.n, cfg["deletes"], replace=False)
        lcfg = SHARD_MESH_LEADER
        more_ins = (ds.base[rng.integers(0, len(ds.base), lcfg["inserts"])]
                    + np.float32(0.02))
        more_ids = np.arange(2 * 10 ** 7, 2 * 10 ** 7 + lcfg["inserts"],
                             dtype=np.int32)
        alive = np.setdiff1d(np.arange(sharded.index.n), dels)
        more_dels = np.concatenate([
            rng.choice(alive, lcfg["deletes"] // 2, replace=False),
            rng.choice(np.concatenate([ins_ids, more_ids]),
                       lcfg["deletes"] // 2, replace=False)])
        np.savez(os.path.join(tmp, "inputs.npz"), queries=q, inserts=ins,
                 insert_ids=ins_ids, deletes=dels, more_inserts=more_ins, more_ids=more_ids,
                 more_deletes=more_dels)

        t0 = time.perf_counter()
        ckpt.save_index(os.path.join(tmp, "sharded"), sharded)
        stream = registry.create(
            "stream_sharded", dataclasses.replace(
                sharded.variant, backend="stream_sharded",
                tail_cap=cfg["tail_cap"]), metric=ds.metric, device="cuda")
        stream.from_state_dict(sharded.to_state_dict())
        ckpt.save_index(os.path.join(tmp, "stream_sharded"), stream)
        small = registry.create("sharded", sharded.variant, metric=ds.metric,
                                device="cuda")
        small.build(ds.base[:cfg["n_small"]])
        ckpt.save_index(os.path.join(tmp, "small"), small)
        del small
        row["save_s"] = time.perf_counter() - t0

        # the single-device answers (not counted: the path is the ranks')
        stream.insert(ins, ids=ins_ids)
        stream.delete(dels)
        single = {}
        for name, b in (("sharded", sharded), ("stream_sharded", stream)):
            for label, params in _mesh_params(b).items():
                ids, dists, secs = _serve_batches(b, q, params, cfg["batch"])
                single[name, label] = (ids.cpu().numpy(), dists.cpu().numpy(),
                                       len(q) / secs)

        t0 = time.perf_counter()
        with _stdout_to_stderr():
            mp.start_processes(_shard_mesh_rank, args=(
                os.path.join(tmp, "store"), tmp), nprocs=2, join=True,
                start_method="spawn")
        row["ranks_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        got = np.load(os.path.join(tmp, "rank0.npz"))
        for name in ("sharded", "stream_sharded"):
            out = {}
            for label in ("ef64", "all_cells"):
                ids, dists, qps = single[name, label]
                check(np.array_equal(got[f"{name}/{label}/ids"], ids)
                      and np.array_equal(got[f"{name}/{label}/dists"], dists),
                      f"shard_mesh {name} {label}: rank 0 differs from one "
                      f"device on {int((got[f'{name}/{label}/ids'] != ids).any(1).sum())} "
                      f"of {len(ids)} queries")
                per = [rk[name][label] for rk in ranks]
                want = _mesh_merge_bytes(2, cfg["batch"], per[0]["m_shard"],
                                         per[0]["cap"])
                small = ranks[0]["small"][label]
                check(all(p["bytes_per_batch"] == want for p in per),
                      f"shard_mesh {name} {label}: {per[0]['bytes_per_batch']}"
                      f" bytes a batch, closed form {want}")
                if name == "sharded":
                    check(small["bytes_per_batch"] == want,
                          f"shard_mesh {label}: 20k merges "
                          f"{small['bytes_per_batch']} bytes a batch, 1M "
                          f"{want}")
                out[label] = {"qps_placed": per[0]["qps"],
                              "qps_single": qps,
                              "bytes_per_batch": want,
                              "bytes_per_batch_20k": small["bytes_per_batch"],
                              "m_shard": per[0]["m_shard"],
                              "ids_equal": True}
            held = [rk[name]["held_bytes"] for rk in ranks]
            dev_b = ranks[0][name]["device_memory_bytes"]
            out["held_bytes"], out["device_memory_bytes"] = held, dev_b
            out["leading"] = ranks[0][name]["leading"]
            check(out["leading"] == [1] * 5, f"shard_mesh {name}: {out}")
            if name == "sharded":
                check(all(abs(h - dev_b) <= SHARD_MESH_HELD_TOL * dev_b
                          for h in held),
                      f"shard_mesh: ranks hold {held} bytes, one shard's "
                      f"layout is {dev_b}")
            row[name] = out
        # the leader episode, replayed on the single-device copy
        with open(os.path.join(tmp, "leader.pkl"), "rb") as f:
            log = pickle.load(f)
        row["leader"] = _check_leader_episode(ranks, log, stream, async_qps,
                                              ds.base.shape[1])
        del stream
        torch.cuda.empty_cache()
        launches = {k: ranks[0]["launches"][k] + ranks[1]["launches"][k]
                    for k in ranks[0]["launches"]}
        row["launches"] = launches
        check(all(launches[k] > 0 for k in ("distance", "topk",
                                            "qdist.cell_scan")),
              f"shard_mesh launched no distance / topk / cell scan: {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["phase_seconds"] = time.perf_counter() - t_phase
    emit(row)
    return launches


# ---------------------------------------------------------------------------
# 14. dryrun: two cells of the dry-run on fake 256 / 512-rank worlds
# ---------------------------------------------------------------------------
#: (arch, shape, meshes): the dry-run's CLI flags of each cell
DRYRUN_CELLS = [("glm4-9b", "train_4k", ["--both-meshes"]),
                ("deepseek-moe-16b", "decode_32k", [])]


def _dryrun_expected_args(cfg, shape, axes) -> int:
    """This rank's argument bytes from the specs alone: parameter slices,
    (train) AdamW's fp32 m / v / master ZeRO parts and the batch, (serve)
    the inputs, caches and the cache length."""
    from repro_torch.dist.fsdp import shard_specs
    from repro_torch.dist.sharding import local_shape
    from repro_torch.launch import specs
    from repro_torch.models import model

    def nbytes(shp, spec, item):
        return int(np.prod(local_shape(tuple(shp), spec, axes),
                           dtype=np.int64)) * item

    lm = model.DecoderLM(cfg, device="meta")
    dp = tuple(a for a in ("pod", "data", "replica") if a in axes)
    pspecs, zspecs, _ = shard_specs(lm, axes, dp_axes=dp)
    total = sum(nbytes(p.shape, pspecs[n], p.element_size())
                for n, p in lm.named_parameters())
    if shape.kind == "train":
        total += sum(nbytes(p.shape, zspecs[n], 12)
                     for n, p in lm.named_parameters())
        batch, bspecs = specs.train_specs(cfg, shape, axes)
        return total + sum(nbytes(t.shape, bspecs[k], t.element_size())
                           for k, t in batch.items())
    (x, caches, _), (xs, cs, _) = specs.decode_specs(cfg, shape, axes)
    total += sum(nbytes(t.shape, xs[k], t.element_size()) for k, t in x.items())
    total += sum(nbytes(t.shape, sp[n], t.element_size())
                 for c, sp in zip(caches, cs) for n, t in c.items())
    return total + 4


def phase_dryrun() -> None:
    """``python -m repro_torch.launch.dryrun`` in a subprocess (CPU and meta
    tensors only: a fake process group of 256 / 512 ranks) for
    DRYRUN_CELLS; checks each artifact's argument bytes against the specs'
    local_shape sum and its collective bytes against gather-on-use's
    closed form (``dryrun.gather_on_use_bytes``)."""
    import shutil
    import tempfile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import gather_on_use_bytes, mesh_axes

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="dryrun_", dir=os.path.join(ROOT, "build"))
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    cells = []
    try:
        for arch, shape_name, flags in DRYRUN_CELLS:
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--arch", arch, "--shape", shape_name, "--out",
                            tmp, *flags], check=True, env=env, timeout=300,
                           stdout=sys.stderr)
            secs = time.perf_counter() - t0
            cfg, shape = get_config(arch), SHAPES[shape_name]
            for tag in (("sp", "mp") if flags else ("sp",)):
                with open(os.path.join(tmp, f"{arch}__{shape_name}__{tag}.json")) as f:
                    art = json.load(f)
                axes = mesh_axes(multi_pod=tag == "mp")
                want_args = _dryrun_expected_args(cfg, shape, axes)
                want_coll = gather_on_use_bytes(cfg, shape, axes)
                got = {"arch": arch, "shape": shape_name, "mesh": art["mesh"],
                       "ranks": art["num_devices"],
                       "argument_bytes": art["memory"]["argument_bytes"],
                       "output_bytes": art["memory"]["output_bytes"],
                       "flops": art["flops"],
                       "bytes_accessed": art["bytes_accessed"],
                       "collectives": art["collectives"],
                       "closed_form_bytes": want_coll,
                       "costing_s": art["compile_costing_s"],
                       "cli_s": secs}
                check(art["memory"]["argument_bytes"] == want_args,
                      f"dryrun {arch} {shape_name} {tag}: argument bytes "
                      f"{art['memory']['argument_bytes']}, specs {want_args}")
                check(art["collectives"]["total_bytes"] == want_coll,
                      f"dryrun {arch} {shape_name} {tag}: collective bytes "
                      f"{art['collectives']['total_bytes']}, closed form "
                      f"{want_coll}")
                check(art["flops"] > 0 and art["bytes_accessed"] > 0,
                      f"dryrun {arch} {shape_name} {tag}: {art}")
                cells.append(got)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "dryrun", "torch": torch.__version__, "cells": cells,
          "phase_seconds": time.perf_counter() - t_phase})


def main() -> None:
    phase_device()
    phase_build()
    kernels = phase_kernels()
    launches, ds, kept = phase_main(n_base=1_000_000, n_query=10_000,
                                    n_requests=2048)
    launches["tune"], frontier = phase_tune(ds, kept)
    launches["stream"], stream_vs_plain = phase_stream(ds, kept)
    launches["async"], async_qps = phase_async(ds, kept["ivf"], frontier)
    launches["shard_mesh"] = phase_shard_mesh(ds, kept, async_qps)
    del ds, kept, frontier
    torch.cuda.empty_cache()
    phase_ref20k()
    launches["rl"] = phase_rl()
    torch.cuda.empty_cache()
    launches["train"] = phase_train()
    torch.cuda.empty_cache()
    launches["zoo"] = phase_zoo()
    torch.cuda.empty_cache()
    launches["dist"] = phase_dist()
    phase_dryrun()
    emit({"phase": "total", "seconds": time.perf_counter() - T_START})
    # the stream path's layouts, held against the plain versions there
    for stage in stream_vs_plain.values():
        err = stage["max_abs_err"]
        kernels["distance"]["max_abs_err"] = max(
            kernels["distance"]["max_abs_err"], err["distance"])
        scan = kernels["qdist"]["cell_scan"]
        scan["max_abs_err"] = max(scan["max_abs_err"], err["qdist.cell_scan"])
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
KERNEL_TIMES = {"distance": distance_times,
                "topk": topk_times}


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
