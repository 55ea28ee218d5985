"""The async serving tier of the port (mirrors ``repro.serve``).

``repro_torch.runtime.server.AnnsServer`` is the *closed-loop* server — one
caller, explicit ``flush``.  This package is the *open-loop* tier that
sits in front of the same backends under real load:

- :mod:`repro_torch.serve.queue` — bounded admission with **typed** rejection
  (:class:`Overloaded` / :class:`DeadlineExceeded` /
  :class:`ServerClosed`); never a silent drop.
- :mod:`repro_torch.serve.tenants` — per-tenant :class:`RecallSLO` classes
  resolved through one shared frontier; stride-weighted scheduling.
- :mod:`repro_torch.serve.scheduler` — :class:`ContinuousBatcher` (batches
  form the instant the previous one finishes, padded to the one
  ``max_batch`` shape — no new batch shape under load) and
  :class:`AsyncServeTier` (asyncio front door, graceful drain).
- :mod:`repro_torch.serve.telemetry` — p50/p95/p99 split queue-wait vs
  compute, per-tenant recall/shed counters, queue-depth gauges.

CLI: ``python -m repro_torch.launch.serve --async --tenants
strict:0.95:4,lax:0.85 --tune`` runs a scripted multi-tenant load
episode.
"""
from repro_torch.serve.queue import (AdmissionQueue, DeadlineExceeded,
                                     Overloaded, ServeRejection, ServeRequest,
                                     ServeResponse, ServerClosed, Ticket)
from repro_torch.serve.scheduler import AsyncServeTier, ContinuousBatcher
from repro_torch.serve.telemetry import (LatencyHistogram, ServeTelemetry,
                                         TenantStats)
from repro_torch.serve.tenants import (TenantSpec, TenantState,
                                       attach_drift_monitors,
                                       parse_tenant_specs, resolve_tenants)

__all__ = [
    "ServeRejection", "Overloaded", "DeadlineExceeded", "ServerClosed",
    "Ticket", "ServeRequest", "ServeResponse", "AdmissionQueue",
    "TenantSpec", "TenantState", "parse_tenant_specs", "resolve_tenants",
    "attach_drift_monitors",
    "ContinuousBatcher", "AsyncServeTier",
    "LatencyHistogram", "TenantStats", "ServeTelemetry",
]
