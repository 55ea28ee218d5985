"""Performance-indexed exemplar database + eq.(1) contrastive sampling.

    P(B_i) = exp((s_i - mu) / tau) / sum_j exp((s_j - mu) / tau)

following the paper's §3.2 (strategy of [18, 26]): every *successful* code
sample is stored with its score; exemplars for the next prompt are drawn
with temperature-scaled softmax over scores, trading exploration against
exploitation.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.variant_space import Program


@dataclass
class Entry:
    program: Program
    score: float          # relative speed score (1.0 = baseline)
    step: int = 0


@dataclass
class ExemplarDB:
    tau: float = 0.25
    entries: dict[str, list[Entry]] = field(default_factory=dict)

    def add(self, program: Program, score: float, step: int = 0) -> None:
        if score <= 0.0:
            return  # only successful samples enter the DB (paper §3.2)
        lst = self.entries.setdefault(program.module, [])
        for e in lst:  # keep the best score per distinct program
            if e.program == program:
                e.score = max(e.score, score)
                return
        lst.append(Entry(program, score, step))

    def size(self, module: str) -> int:
        return len(self.entries.get(module, []))

    def best(self, module: str) -> Entry | None:
        lst = self.entries.get(module, [])
        return max(lst, key=lambda e: e.score) if lst else None

    def sample(self, module: str, m: int,
               rng: np.random.Generator) -> list[tuple[Program, float]]:
        """Eq.(1): softmax((s - mean)/tau) sampling without replacement."""
        lst = self.entries.get(module, [])
        if not lst:
            return []
        m = min(m, len(lst))
        s = np.array([e.score for e in lst], np.float64)
        mu = s.mean()
        logits = (s - mu) / max(self.tau, 1e-9)
        logits -= logits.max()
        p = np.exp(logits)
        p /= p.sum()
        idx = rng.choice(len(lst), size=m, replace=False, p=p)
        return [(lst[i].program, lst[i].score) for i in idx]

    def probabilities(self, module: str) -> np.ndarray:
        """Exposed for tests: the eq.(1) distribution."""
        lst = self.entries.get(module, [])
        s = np.array([e.score for e in lst], np.float64)
        mu = s.mean() if len(s) else 0.0
        logits = (s - mu) / max(self.tau, 1e-9)
        logits -= logits.max() if len(s) else 0.0
        p = np.exp(logits)
        return p / p.sum() if len(s) else p
