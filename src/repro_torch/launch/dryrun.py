"""Multi-pod dry-run of the port (mirrors ``repro.launch.dryrun``): cost
every (architecture x input shape) cell on the production mesh without
allocating a tensor, and record per-rank bytes, FLOPs and the collective
schedule.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out artifacts/dryrun

It runs as a process of its own: the world is a fake process group
(``torch.testing``'s ``FakeStore`` and the ``"fake"`` backend) of 256
ranks (16x16) or 512 (2x16x16), this process its rank 0, and the default
process group belongs to the whole process.  Collectives on it return at
once and move nothing.  The model is built on the ``meta`` device and
wrapped in :class:`~repro_torch.dist.fsdp.Sharded`, so every parameter,
optimizer state, input and cache is a meta tensor of its rank-0 slice,
and each cell runs the port's own step on them:

- train cells: the GRPO loss and its gradients under gather-on-use, the
  gradient reduction and clip norm, AdamW on the ZeRO parts and their
  refill (``--microbatch`` splits the rank's batch; each part gathers the
  weights again, so under gather-on-use the splits are not a wash);
- prefill cells: ``model.prefill`` into the rank's cache slices;
- decode cells: one ``model.decode_step`` on a ``seq_len``-deep cache.
  A KV cache is split on the sequence over the model axis
  (:func:`repro_torch.launch.specs.cache_specs`), and the port decodes
  such a cache only through the partial-softmax combine, so decode cells
  always run it; ``--seq-decode`` is recorded as the reference's flag.

One JSON a cell, with the reference's keys:

- ``collectives``: :func:`repro_torch.dist.comm.count_collectives` (the
  reference's ``hlo.collective_bytes`` schema: ``{op: {count, bytes}},
  total_bytes``, each op counted by its output's bytes on this rank);
- ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  2 m n k each; elementwise work is not counted, where XLA's cost
  analysis counts it);
- ``bytes_accessed``: :class:`ByteCount`, each op's input and output
  bytes summed, views skipped.  It is a per-op count with no fusion, not
  XLA's ``bytes accessed`` of a fused program;
- ``memory``: ``argument_bytes`` / ``output_bytes`` are this rank's
  local bytes of the step's inputs and outputs (params, optimizer state,
  batch, caches; from :func:`~repro_torch.dist.sharding.local_shape`).
  ``temp_bytes`` and ``generated_code_bytes`` are null: nothing assigns
  buffers or generates code;
- ``lower_s`` is the seconds to build the full-depth state on meta,
  ``compile_s`` null (nothing compiles), ``compile_costing_s`` the
  seconds of the costing passes.

Costing is the reference's: each cell runs at depth ``first_k_dense +
1 period`` and ``+ 2 periods`` with ``attn_chunk`` 4096 and
``mamba_chunk`` 1<<20 (:data:`COSTING_OVERRIDES`), and every count is
extrapolated linearly to the full depth; attention cells at train and
prefill add the identity-core passes for ``attn_adjustment``.  Both
meshes are costed so.  The reference's multi-pod pass instead reads one
full-depth compile whose scan bodies XLA counts once, an undercount the
port has no reason to copy: its 2x16x16 numbers are full-depth counts
like its 16x16 ones.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, dryrun_cells, get_config
from repro_torch.core.grpo import GRPOConfig, grpo_loss_and_grad
from repro_torch.dist import comm, seq_decode
from repro_torch.dist.fsdp import Sharded, shard_specs
from repro_torch.dist.sharding import (_axes, _axes_size, local_shape,
                                       local_slice)
from repro_torch.launch.mesh import (make_production_mesh, make_tuned_mesh,
                                     production_axes, tuned_axes)
from repro_torch.launch.specs import decode_specs, prefill_specs, train_specs
from repro_torch.models import model as model_lib
from repro_torch.models.runtime import Runtime
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

#: the costing passes' knobs (the reference's less ``unroll_layers``: the
#: port's layers are a Python loop, every one of them counted)
COSTING_OVERRIDES = {"attn_chunk": 4096, "mamba_chunk": 1 << 20}


def fake_world(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks, this
    process rank 0 (replacing a fake group of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def mesh_axes(*, multi_pod: bool, tp: int = 16) -> dict[str, int]:
    return (production_axes(multi_pod=multi_pod) if tp == 16
            else tuned_axes(tp, multi_pod=multi_pod))


def _mesh(*, multi_pod: bool, tp: int):
    world = 1
    for n in mesh_axes(multi_pod=multi_pod, tp=tp).values():
        world *= n
    fake_world(world)
    return (make_production_mesh(multi_pod=multi_pod) if tp == 16
            else make_tuned_mesh(tp, multi_pod=multi_pod))


def _runtime(mesh, overrides: dict | None = None) -> Runtime:
    kw = dict(mesh=mesh, attn_impl="masked", attn_chunk=512,
              remat="block", logit_chunk=512, mamba_chunk=512)
    kw.update(overrides or {})
    return Runtime(**kw)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tensors)
               if isinstance(t, torch.Tensor))


def _spec_bytes(leaves, specs, mesh) -> int:
    """Local bytes of each stand-in under its spec (matching pytrees)."""
    total = 0
    for t, s in zip(tree_leaves(leaves), tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, tuple))):
        n = 1
        for d in local_shape(tuple(t.shape), s, mesh):
            n *= d
        total += n * t.element_size()
    return total


class ByteCount(TorchDispatchMode):
    """Sums every op's input and output bytes (views and aliasing ops
    skipped): a per-op traffic count with no fusion."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            self.bytes += _nbytes((args, kwargs, out))
        return out


# ---------------------------------------------------------------------------
# one cell's state and step, on meta
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Cell:
    cfg: object
    shape: object
    mesh: object
    rt: Runtime
    sh: Sharded
    inputs: dict          # this rank's slices of the step's inputs
    specs: object         # the stand-ins' specs
    stand_ins: object
    opt_params: dict | None = None
    opt_state: dict | None = None
    ocfg: AdamWConfig | None = None


def _local_caches(cfg, caches, cspecs, mesh, tp_axis):
    """This rank's caches: the batch slice, and a KV cache's sequence
    slice as a :class:`SeqSlice`."""
    out = []
    for cache, spec in zip(caches, cspecs):
        part = {n: local_slice(t, spec[n][:1], mesh) for n, t in cache.items()}
        if "k" in cache and spec["k"][1] is not None:
            part = seq_decode.place_cache(part, mesh, tp_axis)
        elif any(e is not None for s in spec.values() for e in s[1:]):
            raise ValueError(f"cache spec {spec}: the port splits a KV "
                             f"cache on its sequence only")
        out.append(part)
    return out


def _build(cfg, shape, mesh, rt, *, fsdp: bool, quant_opt: bool) -> _Cell:
    lm = model_lib.DecoderLM(cfg, device="meta")
    sh = Sharded(lm, mesh, tp_axis=rt.tp_axis, dp_axes=rt.data_axes(),
                 fsdp=fsdp)
    if shape.kind == "train":
        stand_ins, specs = train_specs(cfg, shape, mesh)
        inputs = {"batch": {k: local_slice(v, specs[k], mesh)
                            for k, v in stand_ins.items()}}
        ocfg = AdamWConfig(quant_state=quant_opt)
        opt_params = sh.zero_views(dict(lm.named_parameters()))
        return _Cell(cfg, shape, mesh, rt, sh, inputs, specs, stand_ins,
                     opt_params, adamw_init(opt_params, ocfg), ocfg)
    make = prefill_specs if shape.kind == "prefill" else decode_specs
    stand_ins, specs = make(cfg, shape, mesh)
    x, caches = stand_ins[0], stand_ins[1]
    inputs = {"x": {k: local_slice(v, specs[0][k], mesh)
                    for k, v in x.items()},
              "caches": _local_caches(cfg, caches, specs[1], mesh,
                                      rt.tp_axis)}
    return _Cell(cfg, shape, mesh, rt, sh, inputs, specs, stand_ins)


def _microbatches(batch: dict, n: int) -> list[dict]:
    if n == 1:
        return [batch]
    B = batch["mask"].shape[0]
    if B % n:
        raise ValueError(f"--microbatch {n} does not divide this rank's "
                         f"batch of {B}")
    step = B // n
    return [{k: v[i * step:(i + 1) * step] for k, v in batch.items()}
            for i in range(n)]


def _step(cell: _Cell, microbatch: int = 1) -> None:
    """One step of the cell's kind on this rank's slices."""
    sh, rt, lm = cell.sh, cell.rt, cell.sh.model
    if cell.shape.kind == "train":
        grads, loss = None, 0.0
        for part in _microbatches(cell.inputs["batch"], microbatch):
            with sh.gathered():
                (l, _), g = grpo_loss_and_grad(
                    lm, part, rt, GRPOConfig(),
                    loss_scale=1.0 / (sh.world * microbatch))
            grads = g if grads is None else {n: grads[n] + g[n] for n in g}
            loss = loss + l / microbatch
        grads = sh.reduce_grads(grads)
        adamw_update(cell.opt_params, grads, cell.opt_state, cell.ocfg,
                     grad_norm=sh.grad_norm(grads))
        sh.refill(dict(lm.named_parameters()), cell.opt_params)
        sh.dp_reduce(loss)
        return
    x, caches = cell.inputs["x"], cell.inputs["caches"]
    with sh.gathered():
        if cell.shape.kind == "prefill":
            model_lib.prefill(lm, x.get("tokens"), rt, caches,
                              embeds=x.get("embeds"))
        else:
            model_lib.decode_step(
                lm, x.get("tokens"), dataclasses.replace(
                    rt, seq_shard_decode=True), caches,
                cell.shape.seq_len - 1, embeds=x.get("embeds"))


def _memory(cell: _Cell) -> dict:
    """This rank's local bytes of the step's inputs and outputs."""
    params = _nbytes(list(cell.sh.model.parameters()))
    if cell.shape.kind == "train":
        opt = _nbytes([cell.opt_state[k] for k in ("m", "v", "master")
                       if k in cell.opt_state])
        batch = _spec_bytes(cell.stand_ins, cell.specs, cell.mesh)
        args = params + opt + batch
        outs = params + opt + 4                       # + the fp32 loss
    else:
        x, caches = cell.stand_ins[0], cell.stand_ins[1]
        xb = _spec_bytes(x, cell.specs[0], cell.mesh)
        cb = _spec_bytes(caches, cell.specs[1], cell.mesh)
        dp = next(iter(cell.specs[0].values()))[0]
        B = local_shape((cell.shape.global_batch,), (dp,), cell.mesh)[0]
        logits = B * cell.cfg.vocab_size * 4
        clen = 4 if cell.shape.kind == "decode" else 0
        args = params + xb + cb + clen
        outs = logits + cb + clen
    return {"argument_bytes": args, "output_bytes": outs,
            "temp_bytes": None, "generated_code_bytes": None}


def _cost(cfg, shape, mesh, rt, *, fsdp, quant_opt, microbatch) -> dict:
    cell = _build(cfg, shape, mesh, rt, fsdp=fsdp, quant_opt=quant_opt)
    from torch.utils.flop_counter import FlopCounterMode
    with (FlopCounterMode(display=False) as fc, ByteCount() as bc,
          comm.count_collectives() as coll):
        _step(cell, microbatch)
    return {"flops": float(fc.get_total_flops()), "bytes": float(bc.bytes),
            "coll": coll}


def _extrap(v1, v2, periods: int):
    return v1 + (periods - 1) * (v2 - v1)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               rt_overrides: dict | None = None, fsdp: bool = False,
               microbatch: int = 1, tp: int = 16,
               quant_opt: bool = False) -> dict:
    """The artifact dict of one cell (see the module docstring)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = _mesh(multi_pod=multi_pod, tp=tp)
    rt = _runtime(mesh, rt_overrides)

    t0 = time.time()
    full = _build(cfg, shape, mesh, rt, fsdp=fsdp, quant_opt=quant_opt)
    mem = _memory(full)
    del full
    t_build = time.time() - t0

    period, P = len(cfg.layer_pattern()), cfg.num_periods()
    base = cfg.first_k_dense
    cost_rt = dataclasses.replace(rt, **COSTING_OVERRIDES)

    def two_depths(run_rt) -> list[dict]:
        return [_cost(dataclasses.replace(cfg, num_layers=base + k * period),
                      shape, mesh, run_rt, fsdp=fsdp, quant_opt=quant_opt,
                      microbatch=microbatch) for k in (1, 2)]

    t0 = time.time()
    c = two_depths(cost_rt)
    flops = _extrap(c[0]["flops"], c[1]["flops"], P)
    bytes_acc = _extrap(c[0]["bytes"], c[1]["bytes"], P)

    attn_adj = None
    has_attn = any(s.kind == "attention" for s in cfg.block_specs())
    if has_attn and shape.kind in ("train", "prefill"):
        ci = two_depths(dataclasses.replace(cost_rt, attn_core_identity=True))
        bytes_noattn = _extrap(ci[0]["bytes"], ci[1]["bytes"], P)
        # the flash kernel's HBM traffic model, per rank (the reference's):
        # forward reads q, k, v and writes o; training adds ~2.5x for bwd
        n_dev = dist.get_world_size()
        qkv_o = (2 * cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        n_attn = sum(s.kind == "attention" for s in cfg.block_specs())
        fwd_bytes = (shape.global_batch * shape.seq_len * qkv_o * 2
                     * n_attn / n_dev)
        flash_bytes = fwd_bytes * (3.5 if shape.kind == "train" else 1.0)
        attn_adj = {
            "bytes_noattn": bytes_noattn,
            "core_bytes_measured": max(bytes_acc - bytes_noattn, 0.0),
            "flash_core_bytes": flash_bytes,
            "bytes_flash_adjusted": bytes_noattn + flash_bytes,
        }
    t_cost = time.time() - t0

    coll = {}
    kinds = (set(c[0]["coll"]) | set(c[1]["coll"])) - {"total_bytes"}
    for k in sorted(kinds):
        one, two = c[0]["coll"].get(k, {}), c[1]["coll"].get(k, {})
        coll[k] = {
            "bytes": int(_extrap(one.get("bytes", 0), two.get("bytes", 0), P)),
            "count": int(_extrap(one.get("count", 0), two.get("count", 0), P))}
    coll["total_bytes"] = sum(v["bytes"] for v in coll.values())

    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "num_devices": dist.get_world_size(),
        "lower_s": round(t_build, 1),
        "compile_s": None,
        "compile_costing_s": round(t_cost, 1),
        "flops": flops,
        "bytes_accessed": bytes_acc,
        "attn_adjustment": attn_adj,
        "memory": mem,
        "collectives": coll,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "runtime_overrides": rt_overrides or {},
    }


# ---------------------------------------------------------------------------
# the closed form of gather-on-use's traffic
# ---------------------------------------------------------------------------
def _in_graph(name: str, cfg) -> bool:
    """Whether the loss reaches a parameter: not the token embedding of an
    untied model fed embeddings (its gradient is zeros, no collective)."""
    return not (name == "embed.embedding" and cfg.frontend != "none"
                and not cfg.tie_embeddings)


def gather_on_use_bytes(cfg, shape, sizes: dict, *, fsdp: bool = False,
                        microbatch: int = 1) -> int:
    """This rank's collective bytes for one full-depth step of ``cfg`` at
    input ``shape`` on a mesh of ``sizes`` ``{axis: size}``, from the
    specs and the config alone (no step runs): what :func:`lower_cell`'s
    counted ``collectives.total_bytes`` must equal at ``remat="block"``
    (``PERF.md`` writes the formula out).

    Per microbatch, every parameter cut by its spec is all-gathered as its
    block runs (once more in a train step's remat recompute of a pattern
    block) and its gradient reduce-scattered back; a train step then
    all-reduces each gradient slice over the axes neither spec uses,
    reduce-scatters it over its ZeRO axes, sums the clip norm, all-gathers
    each ZeRO part back and averages the loss.  Activations move only in
    the MoE (the expert-parallel combine and the aux statistics) and in
    the sequence-sharded decode (max, normaliser and accumulator).

    ``torch.utils.checkpoint`` stops a recompute once the last tensor the
    backward needs is rebuilt, so the expert-parallel combine of a
    period's last block is not recomputed unless a shared expert or a
    post-norm follows it.  The form holds at ``scan_groups`` 1."""
    rt = Runtime(mesh=None)
    dp = tuple(a for a in rt.dp_axes if a in sizes)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    lm = model_lib.DecoderLM(cfg, device="meta")
    specs, zero, local = shard_specs(lm, sizes, tp_axis=rt.tp_axis,
                                     dp_axes=dp, fsdp=fsdp)
    train = shape.kind == "train"
    B = shape.global_batch
    B_loc = B // dp_size if B % dp_size == 0 else B
    tokens = B_loc * (shape.seq_len if shape.kind != "decode" else 1)
    if train:
        tokens //= microbatch
    passes = microbatch if train else 1

    def numel(shp):
        n = 1
        for d in shp:
            n *= d
        return n

    def runs(block: int | None) -> int:
        """Forward runs of a block (None: the embedding and final norm)
        in one pass: a train step's remat recomputes a pattern block."""
        return 2 if (train and block is not None
                     and block >= cfg.first_k_dense) else 1

    def block_of(name: str) -> int | None:
        return int(name.split(".")[1]) if name.startswith("blocks.") else None

    total = 0
    for n, p in lm.named_parameters():
        b = p.element_size()
        spec = specs[n]
        cur = numel(local_shape(tuple(p.shape), spec, sizes))
        if n not in local:
            before = 0
            for e in spec:
                if e is None:
                    continue
                before += cur                     # the gather's input
                cur *= _axes_size(sizes, e)
                total += cur * b * runs(block_of(n)) * passes
            if train and _in_graph(n, cfg):
                total += before * b * passes      # reduce-scatter backward
        if not train:
            continue
        slice_n = numel(local_shape(tuple(p.shape), spec, sizes))
        zero_n = numel(local_shape(tuple(p.shape), zero[n], sizes))
        used = {a for e in zero[n] for a in _axes(e)}
        if set(sizes) - used:
            total += slice_n * b                  # all-reduce
        if zero_n != slice_n:
            total += zero_n * b + slice_n * b     # reduce-scatter, refill
    if train:
        total += 4 + (4 if dp else 0)             # clip norm, loss

    # activations
    period = len(cfg.layer_pattern())
    e = cfg.moe_num_experts
    d = cfg.d_model
    act_b = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    caches = (model_lib.init_cache(cfg, B, shape.seq_len, device="meta")
              if shape.kind == "decode" else None)
    for i, spec in enumerate(cfg.block_specs()):
        if spec.moe and rt.tp_axis in sizes:
            # the combine is the block's last collective: a recompute stops
            # before it unless a later op of the period saves a tensor
            last = (i - cfg.first_k_dense) % period == period - 1
            combine = (1 + train if (last and not cfg.moe_num_shared
                                     and not cfg.post_block_norm)
                       else runs(i) + train)
            total += tokens * d * act_b * combine * passes
            if dp_size > 1:                       # the aux statistics
                total += (2 * e + 1) * 4 * (runs(i) + train) * passes
        if caches is not None and spec.kind == "attention":
            size = caches[i]["k"].shape[1]
            if size % sizes[rt.tp_axis] == 0 and sizes[rt.tp_axis] > 1:
                total += B_loc * cfg.num_heads * (2 + cfg.head_dim) * 4
    return total


# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="cost the 2x16x16 mesh (default: single pod)")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=str, default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true", default=True)
    ap.add_argument("--attn-impl", type=str, default=None,
                    help="override Runtime.attn_impl (perf iterations)")
    ap.add_argument("--scan-groups", type=int, default=0,
                    help="two-level sqrt-memory remat (perf iterations)")
    ap.add_argument("--seq-decode", action="store_true",
                    help="flash-decode seq-parallel combine (recorded: the "
                         "port's decode cells always run it)")
    ap.add_argument("--capacity", type=float, default=0.0,
                    help="MoE capacity factor override (perf iterations)")
    ap.add_argument("--quant-opt", action="store_true",
                    help="int8 blockwise optimizer states (perf iterations)")
    ap.add_argument("--fsdp", action="store_true",
                    help="FSDP param sharding over DP axes")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches (train cells)")
    ap.add_argument("--tp", type=int, default=16,
                    help="TP degree on the same grid (perf iterations)")
    ap.add_argument("--tag", type=str, default="",
                    help="artifact filename suffix (perf iterations)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = dryrun_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    rt_overrides = {}
    if args.attn_impl:
        rt_overrides["attn_impl"] = args.attn_impl
    if args.scan_groups:
        rt_overrides["scan_groups"] = args.scan_groups
    if args.seq_decode:
        rt_overrides["seq_shard_decode"] = True
    if args.capacity:
        rt_overrides["capacity_factor"] = args.capacity

    failures = []
    for arch, shape_name in cells:
        for mp in meshes:
            tag = ("mp" if mp else "sp") + (f"_{args.tag}" if args.tag else "")
            fname = os.path.join(args.out, f"{arch}__{shape_name}__{tag}.json")
            if args.skip_existing and os.path.exists(fname):
                print(f"skip {fname}")
                continue
            print(f"=== {arch} x {shape_name} "
                  f"({'multi' if mp else 'single'}-pod)", flush=True)
            try:
                art = lower_cell(arch, shape_name, multi_pod=mp,
                                 rt_overrides=rt_overrides or None,
                                 fsdp=args.fsdp, microbatch=args.microbatch,
                                 tp=args.tp, quant_opt=args.quant_opt)
                art["fsdp"] = args.fsdp
                art["microbatch"] = args.microbatch
                art["tp"] = args.tp
                with open(fname, "w") as f:
                    json.dump(art, f, indent=1)
                print(f"    ok: costing={art['compile_costing_s']}s "
                      f"flops={art['flops']:.3e} "
                      f"coll={art['collectives']['total_bytes']:.3e}B "
                      f"args={art['memory']['argument_bytes']:.3e}B",
                      flush=True)
            except Exception as e:
                failures.append((arch, shape_name, mp, repr(e)))
                print(f"    FAIL: {e}\n{traceback.format_exc()}", flush=True)

    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f[:3], f[3][:200])
        raise SystemExit(1)
    print("\nall cells passed")


if __name__ == "__main__":
    main()
