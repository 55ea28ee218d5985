"""SLO-driven autotuning: bench-built Pareto frontiers, queried online
(the reference's ``repro.anns.tune``, on the port).

CRINN's reward is "fastest QPS subject to a recall constraint" — this
package makes the *serving layer* able to hold that constraint without
an operator hand-picking ``ef``/``nprobe`` per backend:

1. :func:`sweep_frontier` (offline, once per dataset/build) sweeps the
   registered backends along their static effort ladders through the
   bench harness and prunes to the Pareto-optimal
   :class:`Frontier` of :class:`OperatingPoint` rows — recall, QPS,
   latency, and the memory split per point.
2. :func:`repro_torch.ckpt.save_frontier` / ``load_frontier`` ship it as
   versioned JSON next to the index checkpoint.
3. :func:`choose` (online, O(|frontier|)) solves the constrained pick —
   max QPS s.t. recall >= SLO and device memory <= budget — and
   ``AnnsServer(..., slo=RecallSLO(0.95), frontier=...)`` serves at the
   result, re-snapped onto the backend's static effort ladder, so it
   serves a rung the sweep measured.

The frontier/choose half is pure stdlib+numpy math over measured
records; only an actual sweep touches the bench harness (its imports
are deferred), so loading a frontier and choosing a point is cheap.
"""
from repro_torch.anns.tune.choose import (InfeasibleSLO, RecallSLO, choose,
                                          feasible_points, snap_point_for_backend)
from repro_torch.anns.tune.drift import (DriftMonitor, DriftVerdict,
                                         resweep_and_choose)
from repro_torch.anns.tune.frontier import (FRONTIER_FORMAT, Frontier,
                                            OperatingPoint, dominates,
                                            frontier_from_points, pareto_prune,
                                            replace_params)
from repro_torch.anns.tune.sweep import (DEFAULT_TUNE_BACKENDS,
                                         frontier_from_curve, sweep_frontier,
                                         sweep_target)

__all__ = [
    "FRONTIER_FORMAT", "Frontier", "OperatingPoint", "dominates",
    "pareto_prune", "frontier_from_points", "replace_params",
    "RecallSLO", "InfeasibleSLO", "choose", "feasible_points",
    "snap_point_for_backend",
    "DEFAULT_TUNE_BACKENDS", "sweep_frontier", "sweep_target",
    "frontier_from_curve",
    "DriftMonitor", "DriftVerdict", "resweep_and_choose",
]
