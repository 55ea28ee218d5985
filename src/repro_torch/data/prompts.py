"""CRINN prompt batches for GRPO training (mirrors ``repro.data.prompts``;
its batches are byte-equal to the reference's).

At production scale the rollout fleet writes (prompt, completion, reward,
logp) tuples to a replay service; this pipeline synthesises batches with
the same schema deterministically, so the training step can be exercised
end to end offline.  Prompts follow the real contrastive grammar (module
tag + scored exemplars + GEN + knob tokens), built with the port's
:mod:`repro_torch.core.prompting`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import prompting
from repro_torch.core.variant_space import MODULE_ORDER, MODULES, Program


@dataclass(frozen=True)
class PromptPipeline:
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard_id: int = 0

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.num_shards

    def _one(self, step: int, row: int) -> dict:
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[1, 0, step, row]))
        module = MODULE_ORDER[int(rng.integers(len(MODULE_ORDER)))]
        n_ex = int(rng.integers(1, 6))
        exemplars = []
        for _ in range(n_ex):
            prog = Program(module, tuple(
                int(rng.integers(len(ch))) for _, ch in MODULES[module]))
            exemplars.append((prog, float(rng.random() * 2)))
        prompt = prompting.build_prompt(module, exemplars)
        comp = Program(module, tuple(
            int(rng.integers(len(ch))) for _, ch in MODULES[module]))
        ctoks = prompting.program_tokens(comp)

        T = self.seq_len
        tokens = np.zeros(T, np.int32)
        mask = np.zeros(T, np.float32)
        seq = (prompt + ctoks)[:T]
        tokens[: len(seq)] = seq
        lo = min(len(prompt), T)
        hi = min(len(prompt) + len(ctoks), T)
        mask[lo:hi] = 1.0
        reward = float(rng.random() * 2)
        logp = rng.standard_normal(T).astype(np.float32) * mask
        return dict(tokens=tokens, mask=mask, reward=reward, logp=logp)

    def batch(self, step: int) -> dict:
        lb = self.local_batch
        rows = range(self.shard_id * lb, (self.shard_id + 1) * lb)
        items = [self._one(step, r) for r in rows]
        rewards = np.array([it["reward"] for it in items], np.float32)
        adv = (rewards - rewards.mean()) / (rewards.std() + 1e-6)
        return {
            "tokens": np.stack([it["tokens"] for it in items]),
            "mask": np.stack([it["mask"] for it in items]),
            "advantages": adv,
            "old_logps": np.stack([it["logp"] for it in items]),
            "ref_logps": np.stack([it["logp"] for it in items]),
        }

