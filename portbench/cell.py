"""One run of one cell: set-up, the measured window, the reference's
verdict, the metrics.

Set-up makes the vectors on the device from the seed, has the
configuration's deployment (:mod:`portbench.deployments`) build the
port's index from them, puts a :class:`Proxy` of it under the
serving tier's ``ContinuousBatcher`` (one tenant at the configuration's
operating point) and warms the one batch shape the cell's traffic uses.
The benchmark's own copy of the vectors then waits on the host, so the
card holds what the deployment holds.  The traffic's driver
(:func:`run_window`) drives the batcher for the window.  After it, the
window's peak device memory is read, the vectors come back to the card,
the deployment reads its numbers off the port's state, that state is
freed, and the reference judges every answer served.

``mode`` puts something else in the port's place for the control and the
fault tests: ``"control"`` serves the reference's search in TF32;
``"stale"``, ``"half"``, ``"alter"`` and ``"narrow"`` break the port's
answers after it computes them (the previous batch's answers; the second
half of a batch given the first half's; one id of a batch changed; a
search at half the operating point's ef); ``BUILD_FAULTS`` at the build.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from portbench import check, loadgen, specs, tracing
from portbench.data import make_vectors

#: what serves in the port's place once it is built
MODES = ("program", "control", "stale", "half", "alter", "narrow")


class Proxy:
    """The port's backend as the batcher sees it: every attribute is the
    backend's, and each ``search`` is counted (rows handed over, and in a
    traced run the queries themselves) inside a ``pb.search`` span."""

    def __init__(self, backend, spans, keep_queries: bool):
        self._backend = backend
        self._spans = spans
        self._keep = keep_queries
        self.impl = backend.search
        self.rows = 0
        self.batches = []

    def __getattr__(self, name):
        return getattr(self._backend, name)

    def search(self, queries, params):
        with self._spans("search"):
            res = self.impl(queries, params)
        self.rows += len(queries)
        if self._keep:
            self.batches.append(np.array(queries, copy=True))
        return res

    def reset(self) -> None:
        self.rows = 0
        self.batches = []


def _card(device) -> dict:
    if torch.device(device).type != "cuda":
        return {"name": "cpu", "power_limit_w": None}
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits", "-i",
             str(torch.device(device).index or 0)],
            capture_output=True, text=True, timeout=60).stdout.strip()
        name, limit = [s.strip() for s in out.split(",")[:2]]
        return {"name": name, "power_limit_w": float(limit)}
    except (OSError, ValueError, subprocess.SubprocessError):
        return {"name": torch.cuda.get_device_name(device),
                "power_limit_w": None}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Setup:
    config: dict
    seed: int
    device: object
    base: torch.Tensor          # raw base (the benchmark's), see park()
    queries: torch.Tensor       # query set on the device
    queries_host: np.ndarray
    backend: object
    build_s: float
    deployment: object          # the module of deployments/
    root: Path                  # where its deployments/ and loops/ are
    traffic: dict | None = None
    loop: object = None         # the module of loops/
    proxy: Proxy | None = None
    batcher: object = None
    spans: loadgen.Spans | None = None
    writes: list = field(default_factory=list)  # a driver's, in order


def build(config: dict, seed: int, device, *, fault: str | None = None,
          root: Path = specs.PB_DIR) -> Setup:
    """The cell's vectors from the seed and the port's index over them,
    built by the configuration's deployment."""
    dep = specs.deployment(config, root)
    base, queries = make_vectors(config["dataset"], seed, device)
    base_host = base.cpu().numpy()
    backend, build_s = dep.build(config, base_host, seed, device, fault)
    del base_host
    return Setup(config=config, seed=seed, device=device, base=base,
                 queries=queries, queries_host=queries.cpu().numpy(),
                 backend=backend, build_s=build_s, deployment=dep,
                 root=root)


def serve(s: Setup, traffic: dict, *, traced: bool,
          mode: str = "program") -> Setup:
    """Put the backend (behind a :class:`Proxy`, ``mode`` in its place)
    under a ContinuousBatcher for ``traffic`` and warm its batch shape."""
    from repro_torch.anns.api import SearchParams
    from repro_torch.serve.scheduler import ContinuousBatcher
    from repro_torch.serve.tenants import TenantSpec, TenantState

    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    s.loop = specs.found("loops", traffic["loop"], s.root)
    params = SearchParams(k=s.config["k"],
                          ef=s.config["operating_point"]["ef"])
    s.traffic = traffic
    s.spans = loadgen.Spans(traced)
    s.proxy = Proxy(s.backend, s.spans, keep_queries=traced)
    s.batcher = ContinuousBatcher(
        s.proxy, {loadgen.TENANT: TenantState(spec=TenantSpec(loadgen.TENANT),
                                              params=params)},
        max_batch=traffic["max_batch"], max_queue=traffic["max_queue"])
    if hasattr(s.deployment, "serve"):
        s.deployment.serve(s)
    _install(s, mode)
    warm(s)
    return s


def _install(s: Setup, mode: str) -> None:
    """Put the control or a fault in the port's place (``program`` keeps
    the port's search)."""
    real = s.backend.search
    k = s.config["k"]
    if mode == "control":
        r = s.deployment.reference(s)

        def control(queries, params):
            ids, d = r.search(torch.as_tensor(queries, device=s.device),
                              precision="tf32")
            return SimpleNamespace(ids=ids, dists=d)
        s.proxy.impl = control
    elif mode == "stale":
        last = []

        def stale(queries, params):
            res = real(queries, params)
            out = last[0] if last else res
            last[:] = [res]
            return out
        s.proxy.impl = stale
    elif mode == "half":
        def half(queries, params):
            b = len(queries)
            res = real(queries[: (b + 1) // 2], params)
            idx = torch.arange(b, device=res.ids.device) % res.ids.shape[0]
            return SimpleNamespace(ids=res.ids[idx], dists=res.dists[idx])
        s.proxy.impl = half
    elif mode == "alter":
        n = s.base.shape[0]

        def alter(queries, params):
            res = real(queries, params)
            ids = res.ids.clone()
            ids[0, k // 2] = (ids[0, k // 2] + n // 2) % n
            return SimpleNamespace(ids=ids, dists=res.dists)
        s.proxy.impl = alter
    elif mode == "narrow":
        def narrow(queries, params):
            return real(queries, params.replace(ef=max(1, params.ef // 2)))
        s.proxy.impl = narrow


def park(s: Setup) -> None:
    """Move the benchmark's raw vectors to the host, off the card the
    window measures."""
    s.base = s.base.cpu()
    gc.collect()
    if torch.device(s.device).type == "cuda":
        torch.cuda.empty_cache()


def unpark(s: Setup) -> None:
    s.base = s.base.to(s.device)


def warm(s: Setup, rounds: int = 3) -> None:
    """Serve ``rounds`` full batches of the cell's one shape, then forget
    them."""
    b = s.batcher
    mb = s.traffic["max_batch"]
    nq = len(s.queries_host)
    for r in range(rounds):
        for i in range(mb):
            b.submit(s.queries_host[(r * mb + i) % nq], loadgen.TENANT)
        while b.pending():
            b.step()
    _sync(s.device)
    s.proxy.reset()


def run_window(s: Setup, seconds: float) -> loadgen.Window:
    """``drive(setup, seconds)`` of ``loops/<loop>.py``: the window of
    every request; it may make the backend's writes (in ``setup.writes``)
    and keep on the window what a deployment's judge reads.  Its
    ``RECALL`` names the recall that ``recall_at_10`` reports."""
    s.proxy.reset()
    return s.loop.drive(s, seconds)


class Answers:
    """The reference's answers for one built index: the exact k of every
    query, its search's answer to each query asked, computed once each."""

    def __init__(self, s: Setup, search):
        k = s.config["k"]
        self.search = search
        self.gt_ids, self.gt_d = search.exact(s.queries)
        self.gt_host = self.gt_ids.cpu().numpy()
        nq = s.queries.shape[0]
        dev = s.device
        self.ref_ids = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
        self.ref_d = torch.full((nq, k), np.inf, dtype=torch.float64,
                                device=dev)
        self._done = np.zeros(nq, bool)
        self._queries = s.queries
        self.index = s.deployment.index_numbers(s, search)

    def asked(self, qidx: np.ndarray) -> None:
        todo = np.unique(qidx)
        todo = todo[~self._done[todo]]
        if len(todo):
            u = torch.as_tensor(todo, device=self.ref_ids.device)
            self.ref_ids[u], self.ref_d[u] = self.search.search(
                self._queries[u], precision="fp64")
            self._done[todo] = True


def free_program(s: Setup) -> None:
    """Drop the port's index and serving objects, and their device
    memory."""
    s.backend = s.batcher = s.proxy = None
    gc.collect()
    if torch.device(s.device).type == "cuda":
        torch.cuda.empty_cache()


@dataclass
class Served:
    """The window's requests as arrays (``ok`` marks those answered)."""
    qidx: np.ndarray
    latency_ms: np.ndarray    # due -> delivered; inf where never answered
    lateness_ms: np.ndarray   # due -> submitted
    in_window: np.ndarray     # delivered before the window closed
    ok: np.ndarray
    ids: np.ndarray           # (answered, k)
    dists: np.ndarray
    queue_wait_ms: np.ndarray


def served(win: loadgen.Window, k: int) -> Served:
    a = win.arrays()
    ok = np.array([x is not None for x in win.ids], bool)
    lat = np.where(ok, (a["t_done"] - a["t_due"]) * 1e3, np.inf)
    ids = [np.asarray(x) for x, o in zip(win.ids, ok) if o]
    dists = [np.asarray(x) for x, o in zip(win.dists, ok) if o]
    shape_ok = all(len(x) == k for x in ids)
    return Served(
        qidx=a["qidx"], latency_ms=lat,
        lateness_ms=(a["t_submit"] - a["t_due"]) * 1e3,
        in_window=ok & (a["t_done"] <= win.seconds), ok=ok,
        ids=(np.stack(ids).astype(np.int64) if ids and shape_ok
             else np.full((len(ids), k), -1, np.int64)),
        dists=(np.stack(dists).astype(np.float64) if dists and shape_ok
               else np.full((len(dists), k), np.inf)),
        queue_wait_ms=a["queue_wait_ms"][ok])


def served_numbers(s: Setup, answers: Answers, win: loadgen.Window,
                   sv: Served) -> dict:
    """:func:`portbench.check.served_numbers` over every answer served,
    and the recall of those delivered in the window and of all."""
    qi = sv.qidx[sv.ok]
    answers.asked(qi)
    nums = check.served_numbers(s.base, s.queries, qi, sv.ids, sv.dists,
                                answers.gt_d, answers.ref_ids,
                                answers.ref_d, s.config["k"])
    inw = sv.in_window[sv.ok]
    nums["recall_window"] = check.recall(sv.ids[inw],
                                         answers.gt_host[qi[inw]])
    nums["recall_all"] = check.recall(sv.ids, answers.gt_host[qi])
    return nums


def judge(s: Setup, answers: Answers, win: loadgen.Window, sv: Served,
          program: dict) -> tuple[bool, dict, dict]:
    """The served numbers (the deployment's ``judge`` where it has one),
    ``program``'s and the index's; returns (correct, checks, numbers)."""
    nums = getattr(s.deployment, "judge", served_numbers)(s, answers, win,
                                                          sv)
    nums.update(program)
    nums["unanswered"] = int((~sv.ok).sum()) - win.shed - win.errors
    nums.update(answers.index)
    return (*verdict(nums, s.config["limits"]), nums)


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """:func:`portbench.check.verdict`, then every other number limited."""
    _, checks = check.verdict(nums, limits)
    checks.update({name: {"value": nums[name], "limit": limit}
                   for name, limit in limits.items() if name not in checks})
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


class Run(SimpleNamespace):
    """What a per-layer reader reads: ``config``, ``build_s``, ``served``,
    ``window``, ``proxy_rows`` (rows handed to the search), ``batches``
    (each search call's queries, traced), ``trace``, ``card``, and the
    deployment's ``run_fields``."""
    least = None    # roofline.window_least_s, once counted


def run(cell, seed: int, seconds: float, trace: bool, device, *,
        t_start: float, mode: str = "program", readers=None,
        root: Path = specs.PB_DIR) -> dict:
    """One run of ``cell`` (a :class:`portbench.specs.Cell`), its modules
    found in ``root``; returns the result line's fields."""
    dep = specs.deployment(cell.config, root)
    specs.found("loops", cell.traffic["loop"], root)
    fault = mode if mode in dep.BUILD_FAULTS else None
    s = build(cell.config, seed, device, fault=fault, root=root)
    serve(s, cell.traffic, traced=trace, mode="program" if fault else mode)
    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if mode != "control":       # the control searches the raw vectors
        park(s)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    summary = None
    if trace:
        win, summary = tracing.traced_window(lambda: run_window(s, seconds))
    else:
        win = run_window(s, seconds)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    unpark(s)
    sv = served(win, cell.config["k"])
    program = dep.program_numbers(s)
    run_rec = Run(config=cell.config, build_s=s.build_s, window=win,
                  served=sv, proxy_rows=s.proxy.rows, batches=s.proxy.batches,
                  trace=summary, **dep.run_fields(s), card=_card(device))
    t_ref = time.perf_counter()
    search = dep.reference(s)
    free_program(s)
    answers = Answers(s, search)
    ok, checks, nums = judge(s, answers, win, sv, program)
    nums["reference_s"] = time.perf_counter() - t_ref
    nums["setup_peak_bytes"] = int(setup_peak)

    e2e = {m.name: _end_to_end(m.name, s.loop.RECALL, setup_s, win, sv,
                               nums) for m in cell.end_to_end}
    out = {"correct": bool(ok), "attempted": int(len(sv.qidx)),
           "failed": int(win.shed + win.errors + nums["unanswered"]),
           "setup_s": setup_s, "e2e": e2e,
           "units": {m.name: m.unit for m in cell.end_to_end},
           "memory_peak_bytes": int(peak), "checks": checks, "numbers": nums,
           "card": run_rec.card, "window": win, "served": sv}
    if trace:
        out["per_layer"] = {m.name: readers[m.name](run_rec)
                            for m in cell.per_layer}
        out["layer_units"] = {m.name: m.unit for m in cell.per_layer}
        out["trace"] = summary
        out["breakdown"] = tracing.breakdown(summary)
        if run_rec.least is not None:
            nums["roofline_binds"] = run_rec.least["binds"]
    return out


def percentile(values: np.ndarray, q: float) -> float:
    """The q-th percentile, interpolated linearly between the two nearest
    ranks; infinite (a request never answered) where either is."""
    v = np.sort(np.asarray(values, np.float64))
    if not len(v):
        return float("nan")
    pos = q / 100 * (len(v) - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if not np.isfinite(v[hi]):
        return float("inf")
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def _end_to_end(name: str, recall: str, setup_s: float, win, sv: Served,
                nums: dict) -> float:
    """A rate counts what was delivered inside the window, a tail every
    request due in it; ``recall`` is the driver's ``RECALL``."""
    if name == "setup_s":
        return setup_s
    if name == "qps":
        return float(sv.in_window.sum()) / win.seconds
    if name == "p95_ms":
        return percentile(sv.latency_ms, 95)
    if name == "recall_at_10":
        return nums[recall]
    raise KeyError(f"no end-to-end metric {name!r}")
