"""The sequential module-by-module CRINN driver (paper §3.1, §3.5), mirrors
``repro.core.optimizer_loop``.

For each module:
  repeat for N iterations:
    1. sample exemplars from the performance-indexed DB (eq. 1),
    2. build the contrastive prompt,
    3. sample a GRPO group of G programs from the policy,
    4. evaluate each: decode -> VariantConfig -> build/search on the real
       engine -> QPS-recall sweep -> banded-AUC reward (§3.3),
    5. eq.(2) group advantages -> GRPO + AdamW update of the policy,
    6. insert successful programs into the DB.
  The module's best program is frozen into the running variant before the
  next module starts.

Construction-variant indexes are cached by their construction knobs so RL
revisits don't pay the rebuild.  Every iteration records how its seconds
split into rollout (prefill + decode), reward evaluation and update.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.anns import registry
from repro_torch.anns.api import SearchParams
from repro_torch.anns.bench import CurvePoint, measure_point
from repro_torch.anns.datasets import Dataset
from repro_torch.anns.engine import GLASS_BASELINE, VariantConfig, family_baseline
from repro_torch.core import prompting
from repro_torch.core.exemplar_db import ExemplarDB
from repro_torch.core.grpo import GRPOConfig, group_advantages, grpo_loss_and_grad
from repro_torch.core.policy import Policy, Rollout
from repro_torch.core.reward import FamilyBaselines, RewardResult, banded_auc
from repro_torch.core.variant_space import MODULE_ORDER, program_from_variant
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


@dataclass(frozen=True)
class LoopConfig:
    k: int = 10
    ef_sweep: tuple = (16, 24, 32, 48, 64, 96)
    group_size: int = 6
    iterations_per_module: int = 4
    exemplars_per_prompt: int = 4
    temperature: float = 1.0
    tau: float = 0.25            # eq.(1) temperature
    seed: int = 0
    bench_repeats: int = 2


@dataclass
class IterationLog:
    module: str
    iteration: int
    rewards: list
    best_so_far: float
    loss: float
    kl: float
    rollout_s: float = 0.0       # prefill + decode of the group
    reward_s: float = 0.0        # builds + QPS/recall sweeps of its programs
    update_s: float = 0.0        # GRPO forward/backward + AdamW


class CrinnOptimizer:
    """Couples the policy LM, the exemplar DB, and the ANNS engine.  The
    indexes are built on the policy's device."""

    def __init__(self, policy: Policy, ds: Dataset, loop: LoopConfig,
                 gcfg: GRPOConfig | None = None,
                 opt_cfg: AdamWConfig | None = None):
        self.policy = policy
        self.device = policy.device
        self.ds = ds
        self.loop = loop
        self.gcfg = gcfg or GRPOConfig(group_size=loop.group_size)
        self.opt_cfg = opt_cfg or AdamWConfig(lr=1e-4, weight_decay=0.0)
        self.params = dict(policy.model.named_parameters())
        self.opt_state = adamw_init(self.params, self.opt_cfg)
        self.db = ExemplarDB(tau=loop.tau)
        self.rng = np.random.default_rng(loop.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(
            loop.seed)
        self._index_cache: dict[tuple, object] = {}   # built AnnsIndex backends
        self.history: list[IterationLog] = []

        # paper-faithful starting point: GLASS baseline, reward 1.0
        self.current = GLASS_BASELINE
        self.baselines = FamilyBaselines()

    @property
    def baseline_auc(self) -> float:
        """The graph family's baseline AUC (0.0 until the first graph-family
        evaluation fills the bank)."""
        return self.baselines.get("graph")

    # ------------------------------------------------------------------
    # Engine evaluation
    # ------------------------------------------------------------------
    def _construction_key(self, v: VariantConfig) -> tuple:
        # the backend family is part of the build identity, and only the
        # knobs that family's build consumes belong in the key (sweeping an
        # inert knob must not rebuild identical state)
        if v.backend == "ivf":
            return (v.backend, v.nlist, v.kmeans_iters, v.max_cell)
        if v.backend == "sharded":
            # n_shards re-slices the built layout, so it is build identity
            return (v.backend, v.nlist, v.kmeans_iters, v.max_cell,
                    v.n_shards)
        if v.backend == "brute_force":
            return (v.backend,)
        return (v.backend, v.degree, v.ef_construction, v.nn_descent_rounds,
                v.alpha, v.num_entry_points)

    def _engine_for(self, v: VariantConfig):
        """A backend for ``v`` sharing the cached built state."""
        key = self._construction_key(v)
        built = self._index_cache.get(key)
        if built is None:
            built = registry.create(v.backend, v, metric=self.ds.metric,
                                    seed=self.loop.seed, device=self.device)
            built.build(self.ds.base)
            self._index_cache[key] = built
        if (v.quantized_prefilter
                and getattr(built.index, "base_q", "na") is None):
            # graph-family state built without codes: patch them in so the
            # cached build is reusable across refinement variants
            from repro_torch.kernels.qdist.ops import quantize_int8
            bq, sc = quantize_int8(built.index.base)
            built.index.base_q, built.index.scales = bq, sc
        backend = registry.create(v.backend, v, metric=self.ds.metric,
                                  seed=self.loop.seed, device=self.device)
        backend.index = built.index
        return backend

    def curve(self, v: VariantConfig) -> list[CurvePoint]:
        eng = self._engine_for(v)
        pts = []
        for ef in self.loop.ef_sweep:
            tr = 0.95 if ef >= max(self.loop.ef_sweep) // 2 else 0.0
            params = SearchParams(k=self.loop.k, ef=ef, target_recall=tr)
            pts.append(measure_point(eng, self.ds, params=params,
                                     repeats=self.loop.bench_repeats))
        return pts

    def evaluate(self, v: VariantConfig) -> RewardResult:
        family = v.backend
        if not self.baselines.has(family):
            base_pts = self.curve(family_baseline(family))
            auc, _ = banded_auc(
                np.array([p.recall for p in base_pts], float),
                np.array([p.qps for p in base_pts], float))
            self.baselines.set(family, auc)
        pts = self.curve(v)
        return self.baselines.reward(family, pts)

    # ------------------------------------------------------------------
    # GRPO update
    # ------------------------------------------------------------------
    def _update_policy(self, rollouts: list[Rollout],
                       rewards: np.ndarray) -> tuple[float, float]:
        dev = self.device
        adv = group_advantages(torch.as_tensor(rewards, dtype=torch.float32))
        T = max(len(r.tokens) for r in rollouts)
        B = len(rollouts)
        tokens = np.zeros((B, T), np.int32)
        mask = np.zeros((B, T), np.float32)
        old = np.zeros((B, T), np.float32)
        for i, r in enumerate(rollouts):
            tokens[i, : len(r.tokens)] = r.tokens
            mask[i, : len(r.tokens)] = r.mask
            old[i, : len(r.tokens)] = r.logps
        # reference = rollout policy snapshot (single inner epoch => same)
        batch = {
            "tokens": torch.from_numpy(tokens).to(dev),
            "mask": torch.from_numpy(mask).to(dev),
            "advantages": adv.to(dev),
            "old_logps": torch.from_numpy(old).to(dev),
            "ref_logps": torch.from_numpy(old.copy()).to(dev),
        }
        (loss, metrics), grads = grpo_loss_and_grad(
            self.policy.model, batch, self.policy.rt, self.gcfg)
        adamw_update(self.params, grads, self.opt_state, self.opt_cfg)
        return float(loss), float(metrics["kl"])

    # ------------------------------------------------------------------
    # Module loop
    # ------------------------------------------------------------------
    def run_module(self, module: str, verbose: bool = True) -> VariantConfig:
        seed_prog = program_from_variant(module, self.current)
        seed_r = self.evaluate(self.current)
        self.db.add(seed_prog, seed_r.reward)
        best_prog, best_reward = seed_prog, seed_r.reward

        for it in range(self.loop.iterations_per_module):
            exemplars = self.db.sample(module, self.loop.exemplars_per_prompt,
                                       self.rng)
            prompt = prompting.build_prompt(module, exemplars)
            t0 = time.perf_counter()
            rollouts = self.policy.sample_group(
                module, prompt, self.loop.group_size, self.generator,
                temperature=self.loop.temperature)
            t1 = time.perf_counter()

            rewards = []
            for ro in rollouts:
                if ro.program is None:
                    rewards.append(0.0)   # malformed => score 0 (paper)
                    continue
                cand = ro.program.apply_to(self.current)
                res = self.evaluate(cand)
                rewards.append(res.reward)
                self.db.add(ro.program, res.reward, step=it)
                if res.reward > best_reward:
                    best_reward, best_prog = res.reward, ro.program
            rewards = np.asarray(rewards, np.float32)
            t2 = time.perf_counter()

            loss, kl = self._update_policy(rollouts, rewards)
            t3 = time.perf_counter()
            self.history.append(IterationLog(
                module=module, iteration=it, rewards=rewards.tolist(),
                best_so_far=best_reward, loss=loss, kl=kl,
                rollout_s=t1 - t0, reward_s=t2 - t1, update_s=t3 - t2))
            if verbose:
                print(f"[{module}] it={it} rewards={np.round(rewards,3)} "
                      f"best={best_reward:.3f} loss={loss:.4f} kl={kl:.4f}")

        self.current = best_prog.apply_to(self.current)
        return self.current

    def run(self, verbose: bool = True) -> VariantConfig:
        for module in MODULE_ORDER:
            t0 = time.time()
            self.run_module(module, verbose=verbose)
            if verbose:
                print(f"== module {module} done in {time.time()-t0:.0f}s; "
                      f"variant now: {self.current.describe()}")
        return self.current
