"""Fault-tolerance primitives (a copy of ``repro.runtime.fault``, which is
pure Python): failure injection (tests), straggler detection, elastic
resize planning.

At 1000+ nodes the failure model is: a host dies mid-step (checkpoint +
deterministic data replay recovers it), a host runs slow (straggler — in
synchronous SPMD the whole step inherits the tail latency, so detection +
mitigation matters), or capacity changes (elastic resize — the job should
continue on a smaller/larger mesh from the same checkpoint).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


class FailureInjector:
    """Deterministic failure schedule for tests/drills: raises
    ``SimulatedFailure`` at the given steps (once each)."""

    def __init__(self, fail_at_steps: tuple[int, ...] = ()):
        self.fail_at = set(fail_at_steps)
        self.fired: set[int] = set()

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class StragglerMonitor:
    """EMA step-time tracker.  A step slower than ``threshold`` x EMA is a
    straggler event; after ``patience`` consecutive events the monitor
    recommends mitigation (in production: preemptively restart the slow
    host / re-shard around it; here: recorded and surfaced to the
    trainer)."""
    threshold: float = 2.0
    decay: float = 0.9
    patience: int = 3
    ema: float | None = None
    consecutive: int = 0
    events: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> str:
        verdict = "ok"
        if self.ema is not None and dt > self.threshold * self.ema:
            self.consecutive += 1
            verdict = "straggler"
            self.events.append((step, dt, self.ema))
            if self.consecutive >= self.patience:
                verdict = "mitigate"
                self.consecutive = 0
        else:
            self.consecutive = 0
            # only fold healthy steps into the EMA so a slow patch does not
            # normalise itself away
            self.ema = dt if self.ema is None else (
                self.decay * self.ema + (1 - self.decay) * dt)
        return verdict


@dataclass(frozen=True)
class ElasticPlan:
    """Resize plan: new data-parallel topology after capacity change.

    Checkpoints are mesh-agnostic (global logical arrays) and the data
    pipeline is keyed by (step, global_row), so a resize is: restore ckpt
    on the new mesh + ``pipeline.reshard(new_shards, shard_id)`` + continue
    from the same step.  ``batch_ok`` tells whether the global batch
    divides the new topology (otherwise gradient accumulation picks up the
    remainder)."""
    old_shards: int
    new_shards: int
    global_batch: int

    @property
    def batch_ok(self) -> bool:
        return self.global_batch % self.new_shards == 0

    @property
    def accum_steps(self) -> int:
        """Micro-batching factor needed on the new topology."""
        if self.batch_ok:
            return 1
        # per-shard microbatch of gcd size
        g = math.gcd(self.global_batch, self.new_shards)
        return self.new_shards // g
