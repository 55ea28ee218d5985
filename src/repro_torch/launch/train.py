"""GRPO training entry point of the port (mirrors ``repro.launch.train``) on
one device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch crinn-policy-100m --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --resume      # same --ckpt-dir

Runs on the CUDA card unless ``--device cpu`` is given.  The model is
``--arch``'s config (any registered arch: dense, moe, hybrid, ssm, audio
or vlm; ``--reduced``: its smoke-test reduction) in the config's dtype,
drawn by ``init_params`` from ``torch.Generator`` seed 0;
the data is the deterministic ``PromptPipeline``, so a resumed run sees
the batches an unbroken one would.  ``--debug-mesh`` and ``--production``
need the distributed substrate (``dist/``, a device mesh) and raise
:class:`MeshUnavailable` rather than train on one device instead.
"""
from __future__ import annotations

import argparse
import os
import tempfile


class MeshUnavailable(NotImplementedError):
    """A mesh flag was given: sharded training waits for ROADMAP.md §1
    queue item 8 (``dist/``, ``launch/mesh.py``)."""


def main(argv=None) -> list[dict]:
    """Train; returns the trainer's per-step records."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="crinn-policy-100m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test reduction of the arch")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--debug-mesh", default=None,
                    help="DxM (e.g. 2x4) mesh; needs ROADMAP item 8")
    ap.add_argument("--production", action="store_true",
                    help="the 16x16 pod mesh; needs ROADMAP item 8")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.debug_mesh or args.production:
        flag = "--debug-mesh" if args.debug_mesh else "--production"
        raise MeshUnavailable(
            f"{flag} needs a device mesh and the sharding rules of dist/, "
            f"which wait for ROADMAP.md §1 queue item 8; run without it to "
            f"train on one device")

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.grpo import GRPOConfig
    from repro_torch.data import PromptPipeline
    from repro_torch.device import resolve_device
    from repro_torch.models import Runtime, model
    from repro_torch.runtime import Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    rt = Runtime(attn_chunk=min(512, args.seq),
                 logit_chunk=min(512, args.seq), remat="block")
    gen = torch.Generator(device=device).manual_seed(0)
    lm = model.init_params(gen, cfg, device)

    pipe = PromptPipeline(seq_len=args.seq, global_batch=args.global_batch)
    tcfg = TrainerConfig(total_steps=args.steps,
                         warmup_steps=max(1, args.steps // 10),
                         ckpt_every=max(5, args.steps // 4),
                         ckpt_dir=args.ckpt_dir, log_every=5)
    trainer = Trainer(cfg, rt, lm, tcfg=tcfg, gcfg=GRPOConfig())
    if args.resume and trainer.try_restore():
        print(f"resumed from step {trainer.step}")

    log = trainer.run(pipe.batch, verbose=True)
    losses = [r["loss"] for r in log]
    print(f"done: {len(log)} steps, loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return log


if __name__ == "__main__":
    main()
