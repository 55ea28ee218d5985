"""The rank side of ``tests/test_torch_dist.py``: functions that run in
Gloo CPU processes spawned by the tests.  This module imports only
``repro_torch`` (never JAX or the reference); the reference's arrays reach
it as numpy, and results go back as ``.npz`` files written by rank 0.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

#: every rank's rendezvous and collectives give up after this long
TIMEOUT_S = 150
#: the sharded training step's Trainer: the learning rate is 0 at step 0
#: (the warmup ramp) and not after, so steps 1 and 2 move the weights
TRAIN_STEPS = 3
TRAIN_TCFG = {"total_steps": 4, "warmup_steps": 1}


def entry(rank: int, fn, world: int, store: str, args_file: str) -> None:
    """Join a ``world``-rank Gloo group through a FileStore, then run
    ``fn(rank, *args)`` with the args pickled in ``args_file`` (a spawn
    pipe holds 64 KB: larger args would start the ranks one at a time)."""
    from repro_torch.launch.mesh import init_distributed
    torch.set_num_threads(1)
    with open(args_file, "rb") as f:
        args = pickle.load(f)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    init_distributed("cpu", init_method=f"file://{store}",
                     timeout_s=TIMEOUT_S)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def _save(path: str, **arrays) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------
def moe_rank(rank, cfg, p: dict, x: np.ndarray, cap: float, out: str):
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.moe import MoE

    mesh = make_debug_mesh(2, 4)
    tp, m = comm.axis_size(mesh, "model"), comm.axis_index(mesh, "model")
    d = comm.axis_index(mesh, "data")
    layer = MoE(cfg, device="cpu")
    e_local = cfg.moe_num_experts // tp
    with torch.no_grad():
        for name, t in layer.named_parameters():
            full = torch.from_numpy(p[name])
            if name != "router":
                full = full[m * e_local:(m + 1) * e_local]
            t.data = full.clone()
    rows = x.shape[0] // comm.axis_size(mesh, "data")
    xl = torch.from_numpy(x[d * rows:(d + 1) * rows]).requires_grad_(True)
    with comm.count_collectives() as counted:
        y, aux = layer(xl, cap, mesh=mesh, ep_axis="model", dp_axes=("data",))
    # every rank's term of sum(out): its DP share, held by tp model ranks
    names = ["router", "w_gate", "w_in", "w_out"]
    params = [getattr(layer, n) for n in names]
    grads = torch.autograd.grad(y.sum() / tp, params + [xl])
    g = dict(zip(names + ["x"], grads))
    g["router"] = comm.all_reduce(g["router"], mesh, ("data", "model"))
    for n in names[1:]:
        g[n] = comm.all_gather(comm.all_reduce(g[n], mesh, "data"), mesh,
                               "model")
    g["x"] = comm.all_gather(comm.all_reduce(g["x"], mesh, "model"), mesh,
                             "data")
    y = comm.all_gather(y.detach(), mesh, "data")
    aux_all = comm.all_gather(aux.detach().reshape(1), mesh, ("data", "model"))
    if rank == 0:
        _save(out, y=_np(y), aux=_np(aux_all),
              fwd_ops=np.array(sorted(k for k in counted if k != "total_bytes")),
              fwd_bytes=counted["total_bytes"],
              **{"g_" + k: _np(v) for k, v in g.items()})


# ---------------------------------------------------------------------------
# sequence-sharded decode
# ---------------------------------------------------------------------------
def seq_decode_rank(rank, cfg, params, toks: np.ndarray, sizes: tuple,
                    out: str):
    from repro_torch.dist import comm
    from repro_torch.dist.fsdp import Sharded
    from repro_torch.dist.seq_decode import SeqSlice, place_cache
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Runtime, model
    from repro_torch.models.convert import from_reference_params

    lm = from_reference_params(params, cfg, device="cpu")
    t = torch.from_numpy(toks)
    rt0 = Runtime(attn_chunk=16, logit_chunk=16, remat="none")
    prefilled = []
    for size in sizes:
        caches = model.init_cache(cfg, t.shape[0], size, device="cpu")
        _, caches, clen = model.prefill(lm, t[:, :-1], rt0, caches)
        prefilled.append((caches, clen))

    mesh = make_debug_mesh(2, 4)
    rt = Runtime(mesh=mesh, attn_chunk=16, logit_chunk=16, remat="none",
                 seq_shard_decode=True)
    sh = Sharded(lm, mesh, dp_axes=rt.data_axes())
    logits, counts = [], []
    for caches, clen in prefilled:
        placed = [place_cache(c, mesh) for c in caches]
        assert all(isinstance(c, SeqSlice) for c in placed)
        with sh.gathered(), comm.count_collectives() as counted:
            got, _, _ = model.decode_step(lm, t[:, -1:], rt, placed, clen)
        logits.append(_np(got))
        counts.append(counted)
    if rank == 0:
        _save(out, logits=np.stack(logits),
              bytes=np.array([c["total_bytes"] for c in counts]),
              ops=np.array([[c[op]["count"], c[op]["bytes"]]
                            for c in counts for op in sorted(c)
                            if op != "total_bytes"]))


# ---------------------------------------------------------------------------
# the sharded training step
# ---------------------------------------------------------------------------
def train_step_rank(rank, cfg, params, batch: dict, rt_kw: dict, out: str):
    from repro_torch.core.grpo import GRPOConfig
    from repro_torch.dist.sharding import local_shape
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Runtime
    from repro_torch.models.convert import from_reference_params
    from repro_torch.runtime import Trainer, TrainerConfig

    mesh = make_debug_mesh(2, 4)
    lm = from_reference_params(params, cfg, device="cpu")
    tr = Trainer(cfg, Runtime(mesh=mesh, **rt_kw), lm,
                 tcfg=TrainerConfig(ckpt_dir=os.path.dirname(out),
                                    **TRAIN_TCFG),
                 gcfg=GRPOConfig())
    sh = tr.shard
    b = {k: torch.from_numpy(v) for k, v in batch.items()}

    # each rank holds exactly its specs' bytes
    for name, p in tr.params.items():
        want = local_shape(sh.shapes[name], sh.specs[name], mesh)
        assert tuple(p.shape) == want, (name, tuple(p.shape), want)
        zwant = local_shape(sh.shapes[name], sh.zero_specs[name], mesh)
        for group in ("m", "v", "master"):
            got = tuple(tr.opt_state[group][name].shape)
            assert got == zwant, (group, name, got, zwant)
    held = sum(p.numel() * p.element_size() for p in tr.params.values())
    held_opt = sum(t.numel() * t.element_size()
                   for g in ("m", "v", "master")
                   for t in tr.opt_state[g].values())

    with sh.gathered():
        (loss, _), grads = tr._loss_and_grads(sh.split_batch(b),
                                              1.0 / sh.world)
    zg = sh.reduce_grads(grads)
    full = {n: _np(sh.full(g, n, zero=True)) for n, g in zg.items()}
    loss = float(sh.dp_reduce(loss))
    # TRAIN_STEPS Trainer steps, the whole weights after each
    after = {}
    for i in range(TRAIN_STEPS):
        tr.run(lambda step: batch, steps=1)
        after.update({f"p{i}/{n}": _np(sh.full(p, n, zero=False))
                      for n, p in tr.params.items()})
    if rank == 0:
        _save(out, loss=loss,
              step_loss=np.array([r["loss"] for r in tr.metrics_log]),
              held=held, held_opt=held_opt,
              **{"g/" + n: g for n, g in full.items()}, **after)


# ---------------------------------------------------------------------------
# compressed all-reduce (4 ranks), and a mesh larger than the world
# ---------------------------------------------------------------------------
def compress_rank(rank, grads: list, residuals: list, out: str):
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim.grad_compress import compressed_allreduce

    try:
        make_debug_mesh(2, 4)
    except ValueError as e:
        raised = str(e)
    else:
        raised = ""
    assert "needs 8 ranks" in raised and "the world has 4" in raised, raised
    mesh = make_debug_mesh(2, 2)
    g = {k: torch.from_numpy(v) for k, v in grads[rank].items()}
    r = {k: torch.from_numpy(v) for k, v in residuals[rank].items()}
    reduced, res = compressed_allreduce(g, r, mesh, ("data", "model"))
    _save(out.format(rank=rank), **{"sum/" + k: _np(v) for k, v in reduced.items()},
          **{"res/" + k: _np(v) for k, v in res.items()})


# ---------------------------------------------------------------------------
# checkpoints saved on one mesh, restored on another
# ---------------------------------------------------------------------------
def checkpoint_rank(rank, cfg, params, ckpt_dir: str, out: str):
    from repro_torch.core.grpo import GRPOConfig
    from repro_torch.data import PromptPipeline
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Runtime, model
    from repro_torch.models.convert import from_reference_params
    from repro_torch.runtime import Trainer, TrainerConfig

    tk = TrainerConfig(total_steps=4, warmup_steps=1, ckpt_every=2,
                       ckpt_dir=ckpt_dir)
    rt = dict(attn_chunk=16, logit_chunk=16, remat="none")

    def state(tr):
        sh = tr.shard
        out = {"p/" + n: sh.full(p, n, zero=False)
               for n, p in tr.params.items()}
        for g in ("m", "v", "master"):
            out.update({f"{g}/{n}": sh.full(t, n, zero=True)
                        for n, t in tr.opt_state[g].items()})
        return out

    a = Trainer(cfg, Runtime(mesh=make_debug_mesh(2, 4), **rt),
                from_reference_params(params, cfg, device="cpu"), tcfg=tk,
                gcfg=GRPOConfig())
    a.run(PromptPipeline(seq_len=16, global_batch=4).batch, steps=2)
    a.ckpt.wait()
    saved = state(a)

    b = Trainer(cfg, Runtime(mesh=make_debug_mesh(4, 2), **rt),
                model.DecoderLM(cfg, device="cpu"), tcfg=tk,
                gcfg=GRPOConfig())
    assert b.try_restore() and b.step == 2 and b.opt_state["step"] == 2
    restored = state(b)
    assert set(saved) == set(restored)
    for k, t in saved.items():
        assert t.dtype == restored[k].dtype, k
        assert torch.equal(t, restored[k]), k
    if rank == 0:
        _save(out, **{k: _np(t) for k, t in saved.items()})
