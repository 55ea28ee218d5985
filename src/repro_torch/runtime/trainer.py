"""Fault-tolerant training loop (mirrors ``repro.runtime.trainer``).

A step is the GRPO loss and its gradients (or a custom ``loss_fn`` under
autograd), the warmup-cosine learning rate, then AdamW, which writes the
parameters and its state in place.  Around it the Trainer provides
checkpoint / restart (resume is exact thanks to the deterministic
pipelines), failure recovery (restore the last checkpoint, replay) and
straggler monitoring.  It runs on the device of the model's parameters.

With ``rt.mesh`` set the step is sharded (:mod:`repro_torch.dist.fsdp`):
the trainer keeps this rank's slices of the model it is given (and the
ZeRO parts of the AdamW state), splits each global batch over the DP
axes, gathers each block's weights as it runs, completes the gradients
over the ranks holding each slice, and reports the loss and metrics of
the whole batch.  Checkpoints are gathered whole before rank 0 writes
them, and a restore cuts them again for whatever mesh it lands on.

Checkpoints are in the reference's layout, so either package's Trainer
restores the other's: ``params/<path>`` and ``opt/{step,m,v,master}/<path>``
with the pattern blocks stacked under ``num_periods``
(:func:`repro_torch.models.convert.reference_key`).  There is no jit or
buffer donation to mirror: a restore copies into the live parameters and
optimizer state, so nothing refers to the state from before it.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import HostArray, host_copy
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core.grpo import GRPOConfig, grpo_loss_and_grad
from repro_torch.dist.comm import count_collectives
from repro_torch.models.convert import from_reference_flat, reference_key
from repro_torch.models.model import DecoderLM
from repro_torch.models.runtime import Runtime
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.runtime.fault import (FailureInjector, SimulatedFailure,
                                       StragglerMonitor)


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 100
    warmup_steps: int = 10
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    keep_n: int = 3
    log_every: int = 10
    max_restore_attempts: int = 3


def _leaves(named: dict) -> dict:
    """{name: tensor}, with a dict value (int8 moments' ``q`` / ``scale``)
    flattened to ``name.q`` / ``name.scale``."""
    out = {}
    for name, leaf in named.items():
        if isinstance(leaf, dict):
            out.update({f"{name}.{k}": v for k, v in leaf.items()})
        else:
            out[name] = leaf
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, cfg, rt: Runtime, model: DecoderLM, *,
                 tcfg: TrainerConfig, gcfg: GRPOConfig | None = None,
                 opt_cfg: AdamWConfig | None = None,
                 loss_fn: Optional[Callable] = None,
                 failure_injector: FailureInjector | None = None):
        """``loss_fn(model, batch) -> (loss, metrics or aux)`` replaces
        the GRPO loss when given."""
        self.cfg = cfg
        self.rt = rt
        self.model = model
        self.tcfg = tcfg
        self.gcfg = gcfg or GRPOConfig()
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.shard = None
        group = None
        if rt.mesh is not None:
            if self.opt_cfg.quant_state:
                raise ValueError("a sharded trainer keeps fp32 moments "
                                 "(quant_state blocks the whole last dim)")
            import torch.distributed as dist

            from repro_torch.dist.fsdp import Sharded
            self.shard = Sharded(model, rt.mesh, tp_axis=rt.tp_axis,
                                 dp_axes=rt.data_axes())
            group = dist.group.WORLD
        self.params = dict(model.named_parameters())
        # what AdamW updates: the parameters, or each slice's ZeRO part
        self._opt_params = (self.params if self.shard is None
                            else self.shard.zero_views(self.params))
        self.opt_state = adamw_init(self._opt_params, self.opt_cfg)
        self.step = 0
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep_n=tcfg.keep_n,
                                      group=group)
        self.monitor = StragglerMonitor()
        self.injector = failure_injector
        self.metrics_log: list[dict] = []
        self._loss_fn = loss_fn

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    # ------------------------------------------------------------------
    def _loss_and_grads(self, batch: dict, scale: float):
        if self._loss_fn is None:
            return grpo_loss_and_grad(self.model, batch, self.rt, self.gcfg,
                                      loss_scale=scale)
        loss, metrics = self._loss_fn(self.model, batch)
        grads = dict(zip(self.params, torch.autograd.grad(
            loss * scale, list(self.params.values()),
            materialize_grads=True)))
        return (loss.detach(), metrics), grads

    def _train_step(self, batch: dict, step: int):
        lr_scale = linear_warmup_cosine(step, self.tcfg.warmup_steps,
                                        self.tcfg.total_steps)
        sh = self.shard
        if sh is None:
            (loss, metrics), grads = self._loss_and_grads(batch, 1.0)
            gnorm = None
        else:
            with count_collectives() as comm_bytes, sh.gathered():
                (loss, metrics), grads = self._loss_and_grads(
                    sh.split_batch(batch), 1.0 / sh.world)
                grads = sh.reduce_grads(grads)
                gnorm = sh.grad_norm(grads)
        om = adamw_update(self._opt_params, grads, self.opt_state,
                          self.opt_cfg, lr_scale=lr_scale, grad_norm=gnorm)
        if not isinstance(metrics, dict):
            metrics = {"aux": metrics}
        if sh is not None:
            with count_collectives() as after:
                sh.refill(self.params, self._opt_params)
                loss = sh.dp_reduce(loss)
                metrics = {k: sh.dp_reduce(
                    torch.as_tensor(v, device=loss.device),
                    "max" if k == "ratio_max" else "mean")
                    for k, v in metrics.items()}
            # this rank's collective traffic in the step (comm.py's count)
            metrics["collective_bytes"] = (comm_bytes["total_bytes"]
                                           + after["total_bytes"])
        return loss, {**metrics, **om}

    # ------------------------------------------------------------------
    def _groups(self) -> dict[str, dict]:
        """The state's leaf groups under their checkpoint prefixes."""
        groups = {"params": self.params, "opt/m": self.opt_state["m"],
                  "opt/v": self.opt_state["v"]}
        if "master" in self.opt_state:
            groups["opt/master"] = self.opt_state["master"]
        return groups

    def _tree_state(self) -> dict:
        """The state in the reference's checkpoint layout, copied to the
        host (per layer, then stacked there); a sharded trainer's leaves
        are gathered whole first (every rank takes part; the tree is
        empty but on the checkpoint's writer)."""
        tree = {"opt/step": np.asarray(self.opt_state["step"], np.int32)}
        for prefix, named in self._groups().items():
            stacks: dict[str, list] = {}
            for name, leaf in _leaves(named).items():
                if self.shard is not None:
                    leaf = self.shard.full(leaf, name, prefix != "params")
                    if not self.ckpt.writer:
                        continue
                key, t = reference_key(name, self.cfg)
                stacks.setdefault(key, []).append((t, host_copy(leaf)))
            for key, parts in stacks.items():
                if parts[0][0] is None:
                    tree[f"{prefix}/{key}"] = parts[0][1]
                else:
                    parts.sort(key=lambda p: p[0])
                    tree[f"{prefix}/{key}"] = HostArray(
                        np.stack([h.data for _, h in parts]), parts[0][1].dtype)
        return tree if self.ckpt.writer else {}

    def save(self) -> None:
        self.ckpt.save(self._tree_state(), self.step)

    @torch.no_grad()
    def _load_state(self, arrays: dict) -> None:
        for prefix, named in self._groups().items():
            head = prefix + "/"
            got = from_reference_flat(
                {k[len(head):]: a for k, a in arrays.items()
                 if k.startswith(head)}, self.cfg)
            want = _leaves(named)
            if set(got) != set(want):
                raise ValueError(
                    f"{prefix}: only in the checkpoint "
                    f"{sorted(set(got) - set(want))}, only in the trainer "
                    f"{sorted(set(want) - set(got))}")
            for name, dst in want.items():
                src = got[name]
                whole = (tuple(dst.shape) if self.shard is None
                         else self.shard.shapes[name])
                if tuple(src.shape) != whole:
                    raise ValueError(f"{prefix}/{name}: checkpoint shape "
                                     f"{tuple(src.shape)}, trainer {whole}")
                if not isinstance(src, torch.Tensor):
                    src = torch.from_numpy(np.array(src))
                if self.shard is not None:
                    src = self.shard.cut(src, name, prefix != "params")
                dst.copy_(src)
        self.opt_state["step"] = int(np.asarray(arrays["opt/step"]))

    def try_restore(self) -> bool:
        """Load the newest checkpoint (written by either package's Trainer)
        into the live state; False when there is none."""
        out = self.ckpt.restore()
        if out is None:
            return False
        arrays, step, _ = out
        self._load_state(arrays)
        self.step = step
        return True

    # ------------------------------------------------------------------
    def run(self, batch_fn: Callable[[int], dict], steps: int | None = None,
            verbose: bool = False) -> list[dict]:
        """batch_fn(step) -> batch dict (numpy arrays or tensors).
        Returns per-step metric dicts.  Failures trigger restore + replay."""
        target = self.step + (steps if steps is not None
                              else self.tcfg.total_steps)
        dev = self.device
        attempts = 0
        while self.step < target:
            try:
                t0 = time.perf_counter()
                if self.injector is not None:
                    self.injector.check(self.step)
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in batch_fn(self.step).items()}
                loss, metrics = self._train_step(batch, self.step)
                _sync(dev)
                dt = time.perf_counter() - t0
                verdict = self.monitor.observe(self.step, dt)
                rec = {"step": self.step, "loss": float(loss), "dt": dt,
                       "straggler": verdict,
                       **{k: float(v) for k, v in metrics.items()}}
                self.metrics_log.append(rec)
                if (verbose and self.ckpt.writer
                        and self.step % self.tcfg.log_every == 0):
                    print(f"step {self.step}: loss={rec['loss']:.4f} "
                          f"dt={dt*1e3:.0f}ms {verdict}")
                self.step += 1
                if self.step % self.tcfg.ckpt_every == 0:
                    self.save()
                attempts = 0
            except SimulatedFailure as e:
                attempts += 1
                if attempts > self.tcfg.max_restore_attempts:
                    raise
                failed_at = self.step
                restored = self.try_restore()
                if verbose:
                    print(f"FAILURE at step {failed_at}: {e}; "
                          f"restored={restored} -> replay from {self.step}")
                # without a checkpoint the run goes on from the live state
                # (the injector fires once per step)
        self.ckpt.wait()
        return self.metrics_log
