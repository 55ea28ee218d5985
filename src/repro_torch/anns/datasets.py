"""Synthetic stand-ins for the six ann-benchmarks datasets.

The numpy generators are the reference's (``repro.anns.datasets``), so
base, queries and attribute columns are byte-equal to it for the same
arguments.  Ground truth is computed on the named ``device`` with the
plain matmul-form distance and a stable ascending-id sort.

Dimensions and metrics match the paper's Table 2 exactly.  Clustered
mixture-of-Gaussians structure produces a non-trivial local intrinsic
dimension so graph quality actually matters (pure iid Gaussian would make
every method look alike).

Filtered search support (see :mod:`repro_torch.anns.filters`):

- Every dataset carries per-vector integer **attribute columns**
  (``Dataset.attrs``), drawn from a *separate* deterministic rng stream
  salted with ``name + "/attrs"`` — adding or re-parameterising columns
  can never perturb the base/query/gt bytes that checkpoints and golden
  tests pin.  Default columns: ``cat`` (100 uniform categories, so a
  j-value categorical-set predicate has selectivity ~j/100) and
  ``bucket`` (16 categories, for coarser predicates).
- ``Dataset.filtered_gt(predicate)`` is the exact ground truth **among
  the predicate-matching rows** — brute force over the masked base, ids
  mapped back to global row numbers, rows with fewer than ``k`` matches
  padded with ``-1``.  Results are cached per ``(predicate, k)`` (the
  predicate is frozen/hashable), so a sweep over the ef ladder computes
  each filtered gt once.
- ``filtered_recall_at_k`` scores against that gt, never the unfiltered
  one: hits are counted over the number of *true* matches per row
  (``-1`` pads are ignored on both sides), matching the ann-benchmarks
  filtered track.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.distance.ref import distance_ref


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    dim: int
    metric: str           # "l2" | "angular"
    lid: float            # paper's Table 2 (documentation only)
    clusters: int


# paper Table 2: name -> (D, metric, LID)
DATASET_SPECS: dict[str, DatasetSpec] = {
    "sift-128-euclidean":  DatasetSpec("sift-128-euclidean", 128, "l2", 9.3, 64),
    "gist-960-euclidean":  DatasetSpec("gist-960-euclidean", 960, "l2", 20.5, 128),
    "mnist-784-euclidean": DatasetSpec("mnist-784-euclidean", 784, "l2", 14.1, 10),
    "glove-25-angular":    DatasetSpec("glove-25-angular", 25, "angular", 9.9, 64),
    "glove-100-angular":   DatasetSpec("glove-100-angular", 100, "angular", 12.3, 64),
    "nytimes-256-angular": DatasetSpec("nytimes-256-angular", 256, "angular", 12.5, 96),
}


@dataclass
class Dataset:
    spec: DatasetSpec
    base: np.ndarray        # (N, d) float32 (unit-normalised if angular)
    queries: np.ndarray     # (nq, d)
    gt: np.ndarray          # (nq, k_gt) exact nearest neighbor ids
    k_gt: int
    attrs: dict | None = None   # {name: (N,) int32} per-vector attributes
    device: object = None       # where filtered_gt computes (None = cuda)
    _fgt_cache: dict = field(default_factory=dict, repr=False)

    @property
    def metric(self) -> str:           # kernel metric name
        return "l2" if self.spec.metric == "l2" else "ip"

    def filtered_gt(self, predicate, k: int | None = None) -> np.ndarray:
        """Exact gt among the rows matching ``predicate`` — the filtered
        anchor every backend is scored against.  Rows with fewer than
        ``k`` matching vectors are padded with ``-1``.  Cached per
        ``(predicate, k)``: filtered sweeps re-derive nothing."""
        from repro_torch.anns.filters import FilterError
        if self.attrs is None:
            raise FilterError(
                f"dataset {self.spec.name!r} has no attribute columns")
        k = self.k_gt if k is None else int(k)
        key = (predicate, k)
        hit = self._fgt_cache.get(key)
        if hit is not None:
            return hit
        mask = predicate.mask(self.attrs, len(self.base))
        rows = np.flatnonzero(mask).astype(np.int32)
        if len(rows) == 0:
            gt = np.full((len(self.queries), k), -1, np.int32)
        else:
            kk = min(k, len(rows))
            sub = exact_ground_truth(self.base[rows], self.queries, kk,
                                     self.metric, device=self.device)
            gt = rows[sub]
            if kk < k:
                pad = np.full((len(gt), k - kk), -1, np.int32)
                gt = np.concatenate([gt, pad], axis=1)
        self._fgt_cache[key] = gt
        return gt


def _clustered(rng: np.random.Generator, n: int, dim: int, clusters: int,
               spread: float = 0.35) -> np.ndarray:
    """Connected-manifold mixture: tight clusters + bridge points between
    nearby centers + diffuse background.  Pure isolated Gaussians would make
    the k-NN graph disconnected (greedy search cannot hop clusters), which
    real ann-benchmarks data is not."""
    centers = rng.standard_normal((clusters, dim)).astype(np.float32)
    n_clu = int(n * 0.6)
    n_bri = int(n * 0.25)
    n_bg = n - n_clu - n_bri

    assign = rng.integers(0, clusters, size=n_clu)
    clu = centers[assign] + spread * rng.standard_normal((n_clu, dim)).astype(np.float32)

    # bridges: interpolations between random center pairs (manifold paths)
    a = rng.integers(0, clusters, size=n_bri)
    b = rng.integers(0, clusters, size=n_bri)
    t = rng.random((n_bri, 1)).astype(np.float32)
    bri = centers[a] * t + centers[b] * (1 - t)
    bri += 2 * spread * rng.standard_normal((n_bri, dim)).astype(np.float32)

    bg = 0.8 * rng.standard_normal((n_bg, dim)).astype(np.float32)

    pts = np.concatenate([clu, bri, bg], axis=0).astype(np.float32)
    return pts[rng.permutation(n)]


def exact_ground_truth(base: np.ndarray, queries: np.ndarray, k: int,
                       metric: str, *, device=None) -> np.ndarray:
    """Brute force with the plain matmul-form distance on ``device``,
    chunked over 512 queries.

    This is the independent oracle the ``distance`` / ``topk`` kernels are
    held against, so it uses neither.  Distance ties break *stably* by
    ascending id (``torch.sort(stable=True)``, never ``torch.topk``, whose
    order among ties is unspecified): duplicate base vectors always yield
    the lowest-id winner, as the reference's stable numpy argsort does.
    """
    dev = resolve_device(device)
    b = torch.from_numpy(np.ascontiguousarray(base, np.float32)).to(dev)
    out = []
    for i in range(0, len(queries), 512):
        q = torch.from_numpy(
            np.ascontiguousarray(queries[i:i + 512], np.float32)).to(dev)
        d = distance_ref(q, b, metric)
        idx = torch.sort(d, dim=1, stable=True).indices[:, :k]
        out.append(idx.to(torch.int32).cpu())
        del d
    return torch.cat(out, dim=0).numpy()


# default attribute columns: {name: cardinality}, values uniform over
# [0, cardinality).  "cat" at 100 makes selectivity a direct dial: a
# j-value categorical-set predicate keeps ~j% of the base.
DEFAULT_ATTRIBUTES: dict[str, int] = {"cat": 100, "bucket": 16}


def make_dataset(name: str, n_base: int = 20000, n_query: int = 200,
                 k_gt: int = 100, seed: int = 0,
                 attributes: dict[str, int] | None = None, *,
                 device=None) -> Dataset:
    """The reference's dataset for the same arguments, with its ground
    truth computed on ``device`` (``cuda`` unless ``"cpu"`` is asked)."""
    spec = DATASET_SPECS[name]
    device = resolve_device(device)
    # crc32, not hash(): str hashing is salted per process, and a shipped
    # index must land on the *same* synthetic
    # dataset when the serving host regenerates it.
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2 ** 31))
    base = _clustered(rng, n_base, spec.dim, spec.clusters)
    queries = _clustered(rng, n_query, spec.dim, spec.clusters)
    if spec.metric == "angular":
        base /= np.maximum(np.linalg.norm(base, axis=1, keepdims=True), 1e-9)
        queries /= np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-9)
    metric = "l2" if spec.metric == "l2" else "ip"
    gt = exact_ground_truth(base, queries, k_gt, metric, device=device)
    # attribute columns come from their own salted stream (and are drawn in
    # sorted column order): base/query/gt bytes are identical with or
    # without them, so nothing pinned by golden tests or shipped
    # checkpoints moves.
    cards = DEFAULT_ATTRIBUTES if attributes is None else attributes
    arng = np.random.default_rng(
        seed + zlib.crc32((name + "/attrs").encode()) % (2 ** 31))
    attrs = {c: arng.integers(0, card, size=n_base, dtype=np.int32)
             for c, card in sorted(cards.items())}
    return Dataset(spec=spec, base=base, queries=queries, gt=gt, k_gt=k_gt,
                   attrs=attrs, device=device)


def selectivity_filter(ds: Dataset, selectivity: float,
                       attr: str = "cat"):
    """A categorical-set predicate over ``ds.attrs[attr]`` keeping roughly
    ``selectivity`` of the base (exact fraction = n_values/cardinality for
    the uniform default columns).  The standard way benchmarks dial the
    selectivity sweep axis."""
    from repro_torch.anns.filters import FilterError, FilterPredicate
    if ds.attrs is None or attr not in ds.attrs:
        raise FilterError(
            f"dataset {ds.spec.name!r} has no attribute column {attr!r}")
    card = int(ds.attrs[attr].max()) + 1
    n_vals = max(1, round(float(selectivity) * card))
    return FilterPredicate.isin(attr, range(n_vals))


def recall_at_k(found: np.ndarray, gt: np.ndarray, k: int) -> float:
    """Fraction of true top-k ids recovered (standard ann-benchmarks recall)."""
    hits = 0
    for row_found, row_gt in zip(found[:, :k], gt[:, :k]):
        hits += len(set(row_found.tolist()) & set(row_gt.tolist()))
    return hits / (len(found) * k)


def filtered_recall_at_k(found: np.ndarray, gt: np.ndarray, k: int) -> float:
    """Recall against a filtered (``-1``-padded) gt, per the
    ann-benchmarks filtered track: each row is scored against the true
    matches that *exist* (``min(k, #matching rows)``), and ``-1`` pads
    never count as hits on either side.  An all-empty predicate scores
    1.0 — returning nothing is the correct answer."""
    hits = 0
    denom = 0
    for row_found, row_gt in zip(found[:, :k], gt[:, :k]):
        true = {int(i) for i in row_gt.tolist() if i >= 0}
        got = {int(i) for i in row_found.tolist() if i >= 0}
        hits += len(true & got)
        denom += len(true)
    return hits / denom if denom else 1.0
