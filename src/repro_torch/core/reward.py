"""The speed reward (paper §3.3): recall-banded QPS-recall AUC.

Given a module implementation we sweep ``ef``, collect (QPS, recall)
points, keep the recall band [0.85, 0.95], and integrate QPS over recall —
one scalar that is fair across implementations whose discrete ef grids land
on different (QPS, recall) combinations.  Band edges are linearly
interpolated from the neighboring points so sparse grids still produce a
stable area (the instability the paper calls out for >0.95 is exactly why
the band exists).

Scores are normalised relative to a fixed baseline AUC and smoothed with a
bounded monotone transform (following the stability smoothing of [18]):
    smooth(r) = 2r / (1 + r)
which caps outlier speedups at 2.0 and keeps gradients informative near 1.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

RECALL_LO = 0.85
RECALL_HI = 0.95


@dataclass(frozen=True)
class RewardResult:
    auc: float            # raw banded AUC (QPS x recall units)
    rel: float            # auc / baseline_auc
    reward: float         # smoothed scalar handed to GRPO + the DB
    n_band_points: int
    valid: bool


def _interp_curve(recalls: np.ndarray, qps: np.ndarray,
                  lo: float, hi: float) -> tuple[np.ndarray, np.ndarray]:
    """Clip the piecewise-linear QPS(recall) curve to [lo, hi]."""
    order = np.argsort(recalls)
    r, q = recalls[order], qps[order]
    # deduplicate equal recalls keeping max QPS (pareto)
    uniq_r, uniq_q = [], []
    for ri, qi in zip(r, q):
        if uniq_r and ri == uniq_r[-1]:
            uniq_q[-1] = max(uniq_q[-1], qi)
        else:
            uniq_r.append(ri)
            uniq_q.append(qi)
    r, q = np.array(uniq_r), np.array(uniq_q)
    if len(r) < 2 or r[-1] < lo or r[0] > hi:
        return np.array([]), np.array([])
    grid = [lo] + [ri for ri in r if lo < ri < hi] + [hi]
    grid = np.array(sorted(set(grid)))
    # clamp the grid to the observed recall range (no extrapolation)
    grid = grid[(grid >= r[0]) & (grid <= r[-1])]
    if len(grid) < 2:
        return np.array([]), np.array([])
    qg = np.interp(grid, r, q)
    return grid, qg


def banded_auc(recalls: np.ndarray, qps: np.ndarray,
               lo: float = RECALL_LO, hi: float = RECALL_HI) -> tuple[float, int]:
    grid, qg = _interp_curve(np.asarray(recalls, float), np.asarray(qps, float),
                             lo, hi)
    if len(grid) < 2:
        return 0.0, 0
    auc = float(np.trapezoid(qg, grid))
    inside = int(np.sum((recalls >= lo) & (recalls <= hi)))
    return auc, inside


def smooth(rel: float) -> float:
    return 2.0 * rel / (1.0 + rel) if rel > 0 else 0.0


def speed_reward(points, baseline_auc: float,
                 lo: float = RECALL_LO, hi: float = RECALL_HI) -> RewardResult:
    """points: list of objects with .recall and .qps (bench CurvePoints)."""
    recalls = np.array([p.recall for p in points], float)
    qps = np.array([p.qps for p in points], float)
    auc, n_in = banded_auc(recalls, qps, lo, hi)
    if auc <= 0.0 or baseline_auc <= 0.0:
        return RewardResult(auc=auc, rel=0.0, reward=0.0,
                            n_band_points=n_in, valid=False)
    rel = auc / baseline_auc
    return RewardResult(auc=auc, rel=rel, reward=smooth(rel),
                        n_band_points=n_in, valid=True)


class FamilyBaselines:
    """Per-algorithm-family baseline AUCs.

    With the backend family inside the GRPO action space, one global
    baseline would let the fastest *family* dominate the reward signal:
    a mediocre IVF config could out-reward a well-tuned graph config
    purely because partitioned scans are cheaper at bench scale (or vice
    versa), and the within-family gradient — the thing the policy is
    supposed to learn — would vanish.  Normalising each candidate against
    its *own family's* canonical baseline keeps ``reward = smooth(relative
    improvement within family)`` comparable across families.

    The bank is lazily filled by the optimizer loop: the first candidate
    of a family triggers one baseline sweep (see
    ``repro_torch.anns.engine.family_baseline`` for the canonical variants).
    Families whose baseline curve never enters the recall band (e.g.
    ``brute_force``, pinned at recall 1.0) keep AUC 0.0 and every
    candidate in the family scores 0 via ``speed_reward``'s invalid path.
    """

    def __init__(self):
        self._auc: dict[str, float] = {}

    def has(self, family: str) -> bool:
        return family in self._auc

    def set(self, family: str, auc: float) -> float:
        self._auc[family] = float(auc)
        return self._auc[family]

    def get(self, family: str, default: float = 0.0) -> float:
        return self._auc.get(family, default)

    def reward(self, family: str, points,
               lo: float = RECALL_LO, hi: float = RECALL_HI) -> RewardResult:
        """Banded-AUC reward for ``points`` against ``family``'s baseline."""
        return speed_reward(points, self.get(family), lo=lo, hi=hi)

    def seed_from_frontier(self, frontier, *, lo: float = RECALL_LO,
                           hi: float = RECALL_HI,
                           overwrite: bool = False) -> dict:
        """Fill the bank from an already-swept Pareto frontier
        (``repro_torch.anns.tune``; any object with ``.points``) instead of
        re-measuring each family's baseline on first contact.

        Each family's banded AUC is integrated over its frontier points
        (``.backend``/``.recall``/``.qps`` rows — duck-typed, this module
        stays import-light).  NB this is an approximation of a fresh
        baseline sweep, not a bit-match: Pareto pruning drops dominated
        points, and :func:`banded_auc` integrates the piecewise curve
        through whatever points remain (clamped to their recall range),
        so a seeded AUC can differ slightly from the full-grid value.
        The trade is deliberate: a baseline offset scales all of a
        family's rewards uniformly, preserving the within-family
        ordering the policy learns from — while the one-time
        first-contact sweep it replaces costs a full bench run inside
        the RL loop.  Families absent from the frontier still get the
        fresh sweep on first contact.  Families already banked are kept
        unless ``overwrite``; returns the AUCs written.
        """
        by_family: dict[str, list] = {}
        for p in frontier.points:
            by_family.setdefault(p.backend, []).append(p)
        written = {}
        for family, pts in sorted(by_family.items()):
            if self.has(family) and not overwrite:
                continue
            auc, _ = banded_auc(np.array([p.recall for p in pts], float),
                                np.array([p.qps for p in pts], float),
                                lo=lo, hi=hi)
            written[family] = self.set(family, auc)
        return written
