"""Multi-tenancy: per-tenant SLO classes resolved through one frontier
(mirrors ``repro.serve.tenants``).

A tenant is a traffic class with its own :class:`RecallSLO` — "strict"
product search holding recall 0.95 next to "lax" analytics happy at
0.85 — served off the **same index**.  Each tenant's SLO is resolved to
an :class:`~repro_torch.anns.tune.OperatingPoint` through the one shared
frontier via :func:`~repro_torch.anns.tune.choose`, then re-snapped onto the
backend's static ladder
(:func:`~repro_torch.anns.tune.snap_point_for_backend`), so every tenant
serves at a swept params bucket.  Tenants whose SLOs resolve to the *same*
params share batches (and batch shapes);
tenants with different picks form separate batch groups — which is what
makes SLO isolation structural: a lax tenant flooding the queue can
delay a strict tenant's answers, but can never dilute its recall,
because no batch ever runs at a blend of operating points.

Scheduling weight uses **stride scheduling**: each tenant carries a
``pass_value`` advancing by ``1/weight`` per served request; the
scheduler always serves the tenant with the lowest pass among those
with queued work.  A weight-4 tenant therefore gets ~4x the service
rate of a weight-1 tenant under contention, and an idle tenant's pass
is caught up to the current virtual time on re-arrival so saved-up
credit can't starve everyone else.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.anns.api import SearchParams
from repro_torch.anns.tune import (DriftMonitor, OperatingPoint, RecallSLO,
                                   choose, snap_point_for_backend)


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's declared contract: recall SLO, scheduling weight,
    and default per-request deadline (``None`` = no deadline)."""
    name: str
    target_recall: float | None = None
    weight: float = 1.0
    deadline_ms: float | None = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if (self.target_recall is not None
                and not 0.0 <= self.target_recall <= 1.0):
            raise ValueError(
                f"tenant {self.name!r}: target_recall must be in [0, 1], "
                f"got {self.target_recall}")
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, "
                f"got {self.weight}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"tenant {self.name!r}: deadline_ms must be > 0, "
                f"got {self.deadline_ms}")


def parse_tenant_specs(spec: str) -> tuple:
    """Parse the CLI tenant grammar:
    ``name:recall[:weight[:deadline_ms]],...``.

    E.g. ``strict:0.95:4:200,lax:0.85`` — tenant *strict* holds recall
    0.95 at scheduling weight 4 with a 200 ms deadline; *lax* holds
    0.85 at weight 1, no deadline.
    """
    out = []
    seen = set()
    for chunk in spec.split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":")
        if not 2 <= len(parts) <= 4:
            raise ValueError(
                f"bad tenant spec {chunk!r}: expected "
                f"name:recall[:weight[:deadline_ms]]")
        name = parts[0].strip()
        if name in seen:
            raise ValueError(f"duplicate tenant name {name!r}")
        seen.add(name)
        try:
            recall = float(parts[1])
            weight = float(parts[2]) if len(parts) >= 3 else 1.0
            deadline = float(parts[3]) if len(parts) >= 4 else None
        except ValueError as e:
            raise ValueError(f"bad tenant spec {chunk!r}: {e}") from None
        out.append(TenantSpec(name=name, target_recall=recall,
                              weight=weight, deadline_ms=deadline))
    if not out:
        raise ValueError(f"no tenants in spec {spec!r}")
    return tuple(out)


@dataclass
class TenantState:
    """A resolved tenant: its spec, operating point, scheduler pass, and
    (optional) drift monitor."""
    spec: TenantSpec
    params: SearchParams
    point: OperatingPoint | None = None
    monitor: DriftMonitor | None = None
    pass_value: float = 0.0
    served: int = 0
    _stride: float = field(init=False)

    def __post_init__(self):
        self._stride = 1.0 / self.spec.weight

    @property
    def name(self) -> str:
        return self.spec.name

    def group_key(self) -> SearchParams:
        """The batch bucket this tenant's requests coalesce into."""
        return self.params

    def advance(self, n: int = 1) -> None:
        """Account ``n`` served requests against this tenant's share."""
        self.pass_value += self._stride * n
        self.served += n

    def observe_served(self, *, recall: float,
                       latency_ms: float | None = None,
                       tail_fraction: float = 0.0):
        """Feed a served window into this tenant's drift monitor (no-op
        returning ``None`` when no monitor is attached)."""
        if self.monitor is None:
            return None
        return self.monitor.observe(recall=recall, latency_ms=latency_ms,
                                    tail_fraction=tail_fraction)


def resolve_tenants(specs, *, target=None, frontier=None,
                    default_params: SearchParams | None = None) -> dict:
    """Resolve each spec to a :class:`TenantState`.

    With a ``frontier``, each tenant with a ``target_recall`` gets its
    own :func:`choose` pick (restricted to ``target``'s backend when
    known), snapped onto the ladder.  Without one, every tenant serves
    ``default_params`` — the explicit-params mode mirrors
    ``AnnsServer``'s.  Raises :class:`~repro_torch.anns.tune.InfeasibleSLO`
    when a tenant's SLO can't be met, at *resolve* time — a tier must
    not start serving a contract it already knows it will break.
    """
    backend_name = getattr(target, "name", None)
    out = {}
    for spec in specs:
        if frontier is not None and spec.target_recall is not None:
            point = choose(frontier, RecallSLO(spec.target_recall),
                           backend=backend_name)
            if target is not None:
                point = snap_point_for_backend(point, target)
            out[spec.name] = TenantState(spec=spec, params=point.params,
                                         point=point)
        else:
            if default_params is None:
                raise ValueError(
                    f"tenant {spec.name!r} has no frontier to resolve "
                    f"through and no default_params")
            out[spec.name] = TenantState(spec=spec, params=default_params)
    return out


def attach_drift_monitors(tenants: dict, *, recall_margin: float = 0.02,
                          max_tail_frac: float | None = None,
                          min_observations: int = 2) -> None:
    """Give every frontier-resolved tenant its own named
    :class:`DriftMonitor` — verdicts then say *whose* SLO drifted."""
    for state in tenants.values():
        if state.point is not None and state.monitor is None:
            state.monitor = DriftMonitor(
                state.point, recall_margin=recall_margin,
                max_tail_frac=max_tail_frac,
                min_observations=min_observations, name=state.name)
