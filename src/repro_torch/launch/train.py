"""GRPO training entry point of the port (mirrors ``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch crinn-policy-100m --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --resume      # same --ckpt-dir
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --debug-mesh 2x4 --device cpu
    torchrun --nnodes 32 --nproc-per-node 8 -m repro_torch.launch.train --arch glm4-9b --production

Runs on the CUDA card unless ``--device cpu`` is given.  The model is
``--arch``'s config (any registered arch: dense, moe, hybrid, ssm, audio
or vlm; ``--reduced``: its smoke-test reduction) in the config's dtype,
drawn by ``init_params`` from ``torch.Generator`` seed 0; the data is the
deterministic ``PromptPipeline``, so a resumed run sees the batches an
unbroken one would.

``--debug-mesh DxM`` starts D*M ranks itself (``torch.multiprocessing``),
one per device: NCCL with one card a rank on ``cuda`` (it raises when
the machine has fewer cards), Gloo processes with ``--device cpu``.
``--production`` builds the 16x16 pod mesh from a ``torchrun`` world of
256 ranks (one card each) and raises under any other world size.  On a
mesh every rank draws the same seed-0 weights and keeps its slices
(:mod:`repro_torch.dist.fsdp`); rank 0 prints and checkpoints.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

#: the world ``--production``'s 16x16 mesh needs
PRODUCTION_WORLD = 256


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="crinn-policy-100m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test reduction of the arch")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--debug-mesh", default=None,
                    help="DxM (e.g. 2x4): start D*M ranks, one per device")
    ap.add_argument("--production", action="store_true",
                    help="the 16x16 pod mesh over a torchrun world of 256")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    return ap.parse_args(argv)


def _train(args, mesh=None) -> list[dict]:
    """Build the trainer (on ``mesh`` when given) and run it; rank 0 (or
    the only process) prints."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.grpo import GRPOConfig
    from repro_torch.data import PromptPipeline
    from repro_torch.device import resolve_device
    from repro_torch.models import Runtime, model
    from repro_torch.runtime import Trainer, TrainerConfig

    device = resolve_device(args.device)
    if device.type == "cuda" and mesh is not None:
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(args.arch, reduced=args.reduced)
    rt = Runtime(mesh=mesh, attn_chunk=min(512, args.seq),
                 logit_chunk=min(512, args.seq), remat="block")
    gen = torch.Generator(device=device).manual_seed(0)
    lm = model.init_params(gen, cfg, device)

    pipe = PromptPipeline(seq_len=args.seq, global_batch=args.global_batch)
    tcfg = TrainerConfig(total_steps=args.steps,
                         warmup_steps=max(1, args.steps // 10),
                         ckpt_every=max(5, args.steps // 4),
                         ckpt_dir=args.ckpt_dir, log_every=5)
    trainer = Trainer(cfg, rt, lm, tcfg=tcfg, gcfg=GRPOConfig())
    talk = trainer.ckpt.writer
    if args.resume and trainer.try_restore() and talk:
        print(f"resumed from step {trainer.step}")

    log = trainer.run(pipe.batch, verbose=True)
    losses = [r["loss"] for r in log]
    if talk:
        print(f"done: {len(log)} steps, loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}", flush=True)
    return log


def _mesh_shape(flag: str) -> tuple[int, int]:
    try:
        d, m = (int(x) for x in flag.split("x"))
    except ValueError:
        raise ValueError(f"--debug-mesh {flag!r}: expected DxM, e.g. 2x4")
    if d < 1 or m < 1:
        raise ValueError(f"--debug-mesh {flag!r}: both sizes must be >= 1")
    return d, m


def _rank_main(rank: int, args, shape: tuple, init_file: str,
               out_file: str) -> None:
    """One rank of ``--debug-mesh``: join the group, train on the mesh,
    rank 0 writes the step records for the launcher."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_debug_mesh

    world = shape[0] * shape[1]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_distributed(args.device, init_method=f"file://{init_file}")
    try:
        log = _train(args, make_debug_mesh(*shape))
        if rank == 0:
            with open(out_file, "w") as f:
                json.dump(log, f)
    finally:
        dist.destroy_process_group()


def _debug_mesh(args) -> list[dict]:
    import torch
    import torch.multiprocessing as mp

    shape = _mesh_shape(args.debug_mesh)
    world = shape[0] * shape[1]
    if args.device != "cpu":
        cards = torch.cuda.device_count()
        if cards < world:
            raise RuntimeError(
                f"--debug-mesh {args.debug_mesh} needs {world} CUDA cards, "
                f"one a rank; this machine has {cards} (or pass --device cpu "
                f"for Gloo processes)")
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        out_file = os.path.join(tmp, "log.json")
        # a failing rank raises here (the others are terminated)
        mp.spawn(_rank_main, args=(args, shape, os.path.join(tmp, "init"),
                                   out_file), nprocs=world, join=True)
        with open(out_file) as f:
            return json.load(f)


def _production(args) -> list[dict]:
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_production_mesh

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != PRODUCTION_WORLD:
        raise RuntimeError(
            f"--production builds the 16x16 mesh over {PRODUCTION_WORLD} "
            f"ranks; this world has {world} (start it with torchrun)")
    init_distributed(args.device)
    try:
        return _train(args, make_production_mesh())
    finally:
        dist.destroy_process_group()


def main(argv=None) -> list[dict]:
    """Train; returns the trainer's per-step records (rank 0's on a
    mesh)."""
    args = _parse(argv)
    if args.production:
        return _production(args)
    if args.debug_mesh:
        return _debug_mesh(args)
    return _train(args)


if __name__ == "__main__":
    main()
