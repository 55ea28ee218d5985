"""Mutable ``stream_ivf`` / ``stream_sharded`` backends (mirror
``repro.anns.stream.backends``).

Both subclass their read-only family backend and add host-side mutable
masters (numpy: delta tail, tombstone mask, id maps, so the packed masks
and the delta checkpoints are the reference's bytes) mirrored to
fixed-shape tensors on the backend's device after every mutation.  The
search in :mod:`repro_torch.anns.stream.search` consumes the mirrors, so
insert / delete change tensor *contents* only, never the shapes that reach
the kernels.

Mutation contract (see :class:`repro_torch.anns.api.MutableAnnsIndex`):

- ``insert(vectors, ids=None)`` — ids assigned sequentially when omitted;
  duplicate live ids are an error; a full tail raises
  :class:`DeltaTailFull` (call ``compact()``).  The sharded backend routes
  each vector to its nearest cell's owning shard and appends to that
  shard's tail.
- ``delete(ids)`` — tombstones base entries through the position mask and
  tail entries by freeing the slot; returns the newly-dead count.
- ``compact()`` — survivors (base in cell-major order, then tail in slot
  order) are re-assigned against the *existing* centroids (the
  ``distance`` and ``topk`` ops, k = 1, on the backend's device), the
  ``split_oversized`` cap applies when the variant sets ``max_cell``, and
  :func:`repro_torch.anns.ivf.layout.layout_from_assignments` lays them
  out as ``build_ivf`` does — one mutation history always compacts to the
  same bytes.  Bumps ``epoch``; deltas recorded against an older epoch no
  longer apply.

Concurrency (the seqno fence): everything a search consumes is bundled
into one immutable :class:`_SearchView`, published by a single reference
assignment in ``_sync()``.  A search captures the view once at entry, so a
concurrent mutation or compaction swap never hands it a torn mix of old
and new state.  The view's tensors are *copies* of the masters
(``torch.tensor`` copies even onto the CPU, where ``torch.from_numpy``
would share the master's buffer), and ``commit_compaction`` installs fresh
masters rather than zeroing them in place.  ``compact()`` is two-phase:
:meth:`_StreamCommon.prepare_compaction` snapshots the survivors under the
mutation lock and builds the replacement layout outside it (a background
worker — :class:`repro_torch.anns.stream.compactor.BackgroundCompactor` —
runs this while serving continues), and
:meth:`_StreamCommon.commit_compaction` re-takes the lock, checks the
epoch fence, installs the layout and replays the journal of mutations that
landed meanwhile.  All device work runs on the thread's current CUDA
stream, the default one: a background prepare is serialised with serving
on the card, and the commit publishes tensors the same stream wrote.

Checkpointing: ``to_state_dict`` extends the family format with tail
leaves and packed tombstone bitmaps; ``to_delta_dict`` /
``apply_delta_dict`` carry just the mutable leaves and (``seqno``,
``epoch``) for :func:`repro_torch.ckpt.save_index_delta`.

Placement across processes (``StreamingShardedBackend.place_on_mesh``,
one rank a shard) is SPMD: every rank applies the same inserts, deletes
and compactions (the host masters stay whole on every rank, and one
history compacts to the same bytes), while each rank's device view holds
only its own shard's live mask and tail.  A compaction gathers the base
slices from every rank, re-shards and re-places; it runs inline, on every
rank at once (the background compactor refuses a placed index).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.anns.api import SearchParams, SearchResult
from repro_torch.anns.backends.ivf import (IvfBackend, _quantized, nprobe_for,
                                           round_nprobe, shortlist_width)
from repro_torch.anns.backends.sharded import ShardedBackend
from repro_torch.anns.filters import (FilterError, UnknownAttribute,
                                      check_attributes)
from repro_torch.anns.ivf.kmeans import assign, split_oversized
from repro_torch.anns.ivf.layout import layout_from_assignments
from repro_torch.anns.ivf.sharding import place_on_mesh, shard_ivf
from repro_torch.anns.registry import register
from repro_torch.anns.stream.search import (placed_stream_search,
                                            stream_ivf_search,
                                            stream_sharded_search)
from repro_torch.device import as_f32
from repro_torch.dist import comm

DEFAULT_TAIL_CAP = 256


class DeltaTailFull(RuntimeError):
    """The fixed-capacity delta tail cannot hold the insert — compact()
    (or delete) to make room.  ``free`` says how many slots were left
    (for the sharded backend: in the shard the insert routed to)."""

    def __init__(self, msg: str, *, free: int = 0):
        super().__init__(msg)
        self.free = int(free)


class CompactionInFlight(RuntimeError):
    """``prepare_compaction`` was called while a previous prepared
    compaction has not been committed or abandoned — the mutation journal
    tracks one pending swap."""


class StaleCompaction(RuntimeError):
    """``commit_compaction`` was handed a prepared layout whose epoch fence
    no longer matches the backend (another compaction committed in
    between, or nothing is in flight): prepare again."""


class _SearchView:
    """Immutable snapshot of everything one search consumes, published by
    a single reference assignment (``self._view = ...``): that assignment
    *is* the seqno fence."""

    __slots__ = ("index", "live", "tail_vecs", "tail_live", "ids_ext",
                 "seqno", "epoch", "attrs", "tail_attrs")

    def __init__(self, index, live, tail_vecs, tail_live, ids_ext,
                 seqno: int, epoch: int, attrs=None, tail_attrs=None):
        self.index = index
        self.live = live
        self.tail_vecs = tail_vecs
        self.tail_live = tail_live
        self.ids_ext = ids_ext
        self.seqno = int(seqno)
        self.epoch = int(epoch)
        # attribute columns in the view's own geometry (base like `live`,
        # tail like `tail_live`), on the device: a filtered search derives
        # its bitmask from the snapshot it captured
        self.attrs = attrs
        self.tail_attrs = tail_attrs


def _view_filter_masks(view: _SearchView, predicate):
    """``predicate`` against a view's attribute columns as device bool
    masks (base geometry, tail geometry), which AND into ``live`` /
    ``tail_live`` — the tombstone path, on the same shapes."""
    if view.attrs is None:
        raise UnknownAttribute(
            f"filter on {predicate.attr!r} but the backend has no "
            f"attribute columns — set_attributes() after build")
    col = view.attrs.get(predicate.attr)
    if col is None:
        raise UnknownAttribute(
            f"unknown attribute {predicate.attr!r} — available columns: "
            f"{sorted(view.attrs)}")
    vals = torch.tensor(np.asarray(predicate.values, np.int32),
                        device=col.device)
    base_mask = (col[..., None] == vals).any(-1)
    tail_mask = (view.tail_attrs[predicate.attr][..., None] == vals).any(-1)
    return base_mask, tail_mask


@dataclasses.dataclass(frozen=True)
class PreparedCompaction:
    """Replacement layout built off the hot path by ``prepare_compaction``
    plus the fence it was snapshotted under; ``commit_compaction`` refuses
    it if the backend's epoch moved.  ``attrs`` is the surviving attribute
    columns remapped into the new layout's position space, or None."""
    index: object
    epoch: int
    seqno: int
    empty: bool
    attrs: object = None


def _pack_mask(mask: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(mask, bool).reshape(-1))


def _unpack_mask(bits: np.ndarray, shape) -> np.ndarray:
    n = int(np.prod(shape))
    out = np.unpackbits(np.asarray(bits, np.uint8), count=n)
    return out.astype(bool).reshape(shape)


def _check_insert_ids(ids, m: int):
    ids = np.asarray(ids, np.int32).reshape(-1)
    if len(ids) != m:
        raise ValueError(f"{m} vectors but {len(ids)} ids")
    if np.any(ids < 0):
        raise ValueError("ids must be non-negative")
    if len(np.unique(ids)) != m:
        raise ValueError("duplicate ids within one insert batch")
    return ids


def _host(t) -> np.ndarray:
    """A numpy copy of a tensor (from any device)."""
    return t.detach().cpu().numpy().copy()


def exact_live_gt(backend, queries, k: int) -> np.ndarray:
    """Exact top-k *ids* over a mutable backend's current live set — the
    moving ground truth mutations invalidate ``Dataset.gt`` against.
    Brute force over ``live_vectors()`` with the plain matmul-form
    distance on the backend's device (ties to the lower live row); rows
    are ids (not positions), -1 padded when fewer than k are live."""
    from repro_torch.anns.datasets import exact_ground_truth

    vecs, ids = backend.live_vectors()
    queries = np.asarray(queries, np.float32)
    if len(vecs) == 0:
        return np.full((len(queries), k), -1, np.int32)
    kk = min(k, len(vecs))
    rows = ids[exact_ground_truth(vecs, queries, kk, backend.metric,
                                  device=backend.device)]
    if kk < k:
        rows = np.concatenate(
            [rows, np.full((len(rows), k - kk), -1, np.int32)], axis=1)
    return rows.astype(np.int32)


class _StreamCommon:
    """Host-side mutable state shared by both streaming backends.

    Masters are plain numpy (the checkpoint / delta leaves); subclasses
    define the tail geometry (flat vs per-shard) via ``_tail_shape_for``
    and publish device mirrors in ``_sync``.
    """

    def _variant_tail_cap(self) -> int:
        cap = getattr(self.variant, "tail_cap", 0) or DEFAULT_TAIL_CAP
        return max(1, int(cap))

    def _init_concurrency(self) -> None:
        """Mutation lock + pending-compaction state (from ``__init__``)."""
        self._lock = threading.RLock()
        self._compacting = False
        self._mutation_log: list[tuple] = []
        self._view: _SearchView | None = None

    def _tail_shape(self) -> tuple:
        return self._tail_shape_for(self.index)

    def _dev(self, a) -> torch.Tensor:
        """A device copy of a numpy master — never a view of it."""
        return torch.tensor(np.asarray(a), device=self.device)

    def _init_mutable(self) -> None:
        """Fresh mutable state over the current built index (after build()
        and when restoring a read-only snapshot)."""
        idx = self.index
        ids = _host(idx.ids)
        d = int(idx.centroids.shape[1])
        shape = self._tail_shape()
        self._live = np.ones(idx.n, bool)
        self._tail_vecs = np.zeros(shape + (d,), np.float32)
        self._tail_ids = np.full(shape, -1, np.int32)
        self._tail_live = np.zeros(shape, bool)
        # attribute columns survive adoption of a read-only snapshot that
        # carried them; a fresh build() resets them to None first
        self._tail_attrs = (None if self.attributes is None else
                            {c: np.full(shape, -1, np.int32)
                             for c in self.attributes})
        self.seqno = 0
        self.epoch = 0
        self._next_id = int(ids.max(initial=-1)) + 1
        self._rebuild_maps()
        self._sync()

    def _rebuild_maps(self) -> None:
        ids = _host(self.index.ids)
        self._id_pos = {int(i): p for p, i in enumerate(ids.tolist())
                        if i >= 0}
        # tail map values are index tuples — (slot,) flat, (shard, slot)
        # per-shard — so one delete path serves both layouts
        self._tail_pos = {}
        for slot in zip(*np.nonzero(self._tail_ids >= 0)):
            self._tail_pos[int(self._tail_ids[slot])] = tuple(
                int(s) for s in slot)

    # -- attribute columns -------------------------------------------------
    def set_attributes(self, attrs) -> None:
        """Attach per-vector attribute columns to a *freshly built* index
        (before any mutation); inserts then carry attributes, deletes free
        them with their slot, and ``compact()`` remaps them with the ids."""
        with self._lock:
            if self.seqno != 0 or self.epoch != 0 or self._compacting:
                raise FilterError(
                    "set_attributes must run on a freshly built index, "
                    "before any mutation — attributes then ride inserts "
                    "and compactions")
            super().set_attributes(attrs)      # stored in position space
            self._tail_attrs = {c: np.full(self._tail_shape(), -1,
                                           np.int32)
                                for c in self.attributes}
            self._sync()

    def live_attributes(self):
        """Attribute rows of everything live, in ``live_vectors()`` order;
        None when no columns are configured."""
        with self._lock:
            if self.attributes is None:
                return None
            live_pos = np.flatnonzero(self._live)
            tail_slots = np.nonzero(self._tail_live)
            return {c: np.concatenate(
                        [np.asarray(self.attributes[c])[live_pos],
                         self._tail_attrs[c][tail_slots]]).astype(np.int32)
                    for c in self.attributes}

    def _normalize_insert_attrs(self, attrs, m: int):
        """One insert batch's attribute values as ``{col: (m,) int32}``
        over every configured column (missing columns -1); typed failures
        for attributes on an attribute-less backend, unknown columns and
        wrong lengths / dtypes."""
        if attrs is None:
            if self.attributes is None:
                return None
            return {c: np.full(m, -1, np.int32) for c in self.attributes}
        if self.attributes is None:
            raise UnknownAttribute(
                "insert() got attribute values but the backend has no "
                "attribute columns — set_attributes() on the built "
                "index first")
        unknown = set(attrs) - set(self.attributes)
        if unknown:
            raise UnknownAttribute(
                f"insert() got unknown attribute columns "
                f"{sorted(unknown)} — configured: "
                f"{sorted(self.attributes)}")
        cols = check_attributes(dict(attrs), m)
        return {c: cols.get(c, np.full(m, -1, np.int32))
                for c in self.attributes}

    # -- MutableAnnsIndex protocol ----------------------------------------
    def n_live(self) -> int:
        with self._lock:
            return int(self._live.sum()) + int(self._tail_live.sum())

    def tail_fraction(self) -> float:
        with self._lock:
            tail = int(self._tail_live.sum())
            return tail / max(int(self._live.sum()) + tail, 1)

    def _apply_delete(self, ids_arr: np.ndarray) -> int:
        """Tombstone one id batch against the current maps — no lock, no
        seqno, no sync: the body of ``delete`` and of journal replay."""
        count = 0
        for i in ids_arr.reshape(-1).tolist():
            i = int(i)
            p = self._id_pos.get(i)
            if p is not None and self._live[p]:
                self._live[p] = False
                count += 1
                continue
            s = self._tail_pos.pop(i, None)
            if s is not None:
                self._tail_live[s] = False
                self._tail_ids[s] = -1
                if self._tail_attrs is not None:
                    for col in self._tail_attrs.values():
                        col[s] = -1       # freed slots are byte-stable
                count += 1
        return count

    def delete(self, ids) -> int:
        assert self.index is not None, "build() first"
        ids_arr = np.asarray(ids)
        with self._lock:
            if self._compacting:
                self._mutation_log.append(("delete", ids_arr.copy()))
            count = self._apply_delete(ids_arr)
            self.seqno += 1
            self._sync()
        return count

    def insert(self, vectors, ids=None, attrs=None) -> np.ndarray:
        assert self.index is not None, "build() first"
        vecs = np.ascontiguousarray(np.asarray(vectors, np.float32))
        if vecs.ndim == 1:
            vecs = vecs[None]
        m = len(vecs)
        with self._lock:
            acols = self._normalize_insert_attrs(attrs, m)
            if ids is None:
                ids = np.arange(self._next_id, self._next_id + m,
                                dtype=np.int32)
            ids = _check_insert_ids(ids, m)
            for i in ids.tolist():
                p = self._id_pos.get(int(i))
                if ((p is not None and self._live[p])
                        or int(i) in self._tail_pos):
                    raise ValueError(
                        f"id {int(i)} is already live — delete it "
                        f"first or pick a fresh id")
            self._place_in_tail(vecs, ids, acols)  # checks the cap, fills
            if self._compacting:
                self._mutation_log.append((
                    "insert", vecs.copy(), ids.copy(),
                    None if acols is None else
                    {c: a.copy() for c, a in acols.items()}))
            self._next_id = max(self._next_id, int(ids.max()) + 1)
            self.seqno += 1
            self._sync()
        return ids

    def compact(self) -> None:
        """Fold tail + tombstones into a fresh cell-major layout against
        the existing centroids (see the module docstring).  An all-dead
        index keeps one masked dummy row (the layout needs a vector; its
        ``live`` bit stays False).  Prepare + commit with nothing able to
        land in the journal in between."""
        self.commit_compaction(self.prepare_compaction())

    def prepare_compaction(self) -> PreparedCompaction:
        """Phase one: snapshot the survivors under the lock, then build the
        replacement layout *outside* it — the expensive half (assign,
        split, layout, id remap, re-shard) that a background worker runs
        while serving continues.  Mutations that land meanwhile are
        journaled and replayed at commit."""
        assert self.index is not None, "build() first"
        with self._lock:
            if self._compacting:
                raise CompactionInFlight(
                    "a prepared compaction is already pending — commit "
                    "or abandon it before preparing another")
            index = self.index
            vecs, oids = self.live_vectors()
            acols = self.live_attributes()
            fence_seqno, fence_epoch = self.seqno, self.epoch
            self._compacting = True
            self._mutation_log = []
        try:
            centroids = _host(index.centroids)
            empty = len(vecs) == 0
            if empty:
                vecs = np.zeros((1, centroids.shape[1]), np.float32)
                oids = np.array([-1], np.int32)
                if acols is not None:
                    acols = {c: np.array([-1], np.int32) for c in acols}
            a, _ = assign(vecs, centroids, metric=self.metric,
                          device=self.device)
            max_cell = getattr(self.variant, "max_cell", 0) or None
            if max_cell:
                centroids, a = split_oversized(vecs, centroids, a,
                                               cap=max_cell)
            inner = layout_from_assignments(vecs, a, centroids,
                                            metric=self.metric,
                                            device=self.device)
            # inner.ids maps positions -> rows of `vecs`; compose the
            # surviving original ids on top, and carry the attribute
            # columns through the same permutation
            perm = _host(inner.ids)
            inner = dataclasses.replace(inner, ids=self._dev(oids[perm]))
            new_attrs = (None if acols is None else
                         {c: np.ascontiguousarray(a_[perm], np.int32)
                          for c, a_ in acols.items()})
            return PreparedCompaction(
                index=self._finalize_layout(inner), epoch=fence_epoch,
                seqno=fence_seqno, empty=empty, attrs=new_attrs)
        except BaseException:
            with self._lock:
                self._compacting = False
                self._mutation_log = []
            raise

    def commit_compaction(self, prepared: PreparedCompaction) -> None:
        """Phase two: the fenced swap.  Under the lock, check the epoch
        fence, install the prepared layout, reset tail + tombstones, bump
        ``epoch`` / ``seqno``, and replay the journal of mutations that
        arrived during the build (in arrival order, so the replayed tail
        never exceeds the capacity the originals respected)."""
        with self._lock:
            if not self._compacting:
                raise StaleCompaction(
                    "no compaction is in flight — the prepared state "
                    "was already committed or abandoned")
            if prepared.epoch != self.epoch:
                self._compacting = False
                self._mutation_log = []
                raise StaleCompaction(
                    f"prepared at epoch {prepared.epoch}, but the "
                    f"backend is at epoch {self.epoch} — prepare again")
            log, self._mutation_log = self._mutation_log, []
            self._compacting = False
            self.index = prepared.index
            self.attributes = prepared.attrs
            self._clear_filter_caches()   # masks describe the old layout
            self._live = np.ones(self.index.n, bool)
            if prepared.empty:
                self._live[:] = False
            # fresh masters, never zeroed in place: an in-flight search on
            # the old epoch keeps the tail it captured
            self._tail_vecs = np.zeros_like(self._tail_vecs)
            self._tail_ids = np.full_like(self._tail_ids, -1)
            self._tail_live = np.zeros_like(self._tail_live)
            self._tail_attrs = (None if self.attributes is None else
                                {c: np.full(self._tail_shape(), -1,
                                            np.int32)
                                 for c in self.attributes})
            self.epoch += 1
            self.seqno += 1
            self._rebuild_maps()
            for entry in log:
                if entry[0] == "insert":
                    _, vecs, ids, acols = entry
                    self._place_in_tail(vecs, ids, acols)
                else:
                    self._apply_delete(entry[1])
            self._sync()

    def live_vectors(self) -> tuple[np.ndarray, np.ndarray]:
        """(L, d) fp32 vectors + (L,) int32 ids of everything visible to
        search, base (cell-major order) then tail (slot order)."""
        with self._lock:
            base, ids_arr = self._global_base()
            live_pos = np.flatnonzero(self._live)
            tail_slots = np.nonzero(self._tail_live)
            vecs = np.concatenate(
                [base[live_pos], self._tail_vecs[tail_slots]], axis=0)
            ids = np.concatenate(
                [ids_arr[live_pos],
                 self._tail_ids[tail_slots]]).astype(np.int32)
        return vecs, ids

    # -- warm-before-publish ----------------------------------------------
    def warm_compacted(self, prepared: PreparedCompaction, queries,
                       params: SearchParams) -> None:
        """Run the search the prepared layout will serve after the swap
        once, on the caller's thread: a background compactor calls this
        right before ``commit_compaction``, so the serving thread's first
        post-swap batch finds the kernels built and the allocator's blocks
        for the new shapes cached."""
        res = self._search_view(self._fresh_view(prepared.index),
                                queries, params)
        if res.ids.is_cuda:
            torch.cuda.synchronize(res.ids.device)

    def _fresh_view(self, index) -> _SearchView:
        """A view over ``index`` with an all-live base and an empty tail —
        the state ``commit_compaction`` publishes (before the replay), with
        throwaway attribute columns when the backend has any."""
        d = int(index.centroids.shape[1])
        shape = self._tail_shape_for(index)
        attrs = tail_attrs = None
        if self.attributes is not None:
            attrs = {c: np.full(index.n, -1, np.int32)
                     for c in self.attributes}
            tail_attrs = {c: np.full(shape, -1, np.int32)
                          for c in self.attributes}
        return self._make_view(index, np.ones(index.n, bool),
                               np.zeros(shape + (d,), np.float32),
                               np.full(shape, -1, np.int32),
                               np.zeros(shape, bool), -1, -1,
                               attrs, tail_attrs)

    def _sync(self) -> None:
        """Publish a fresh immutable view of the fixed-shape device
        mirrors; the single reference assignment is the fence concurrent
        searches read through."""
        self._view = self._make_view(self.index, self._live,
                                     self._tail_vecs, self._tail_ids,
                                     self._tail_live, self.seqno,
                                     self.epoch, self.attributes,
                                     self._tail_attrs)

    def search(self, queries, params: SearchParams) -> SearchResult:
        assert self.index is not None, "build() first"
        return self._search_view(self._view, queries, params)

    def _view_plan(self, view: _SearchView, params: SearchParams,
                   tail_slots: int):
        """(k, nprobe, m, live, tail_live) of one search on ``view``: k
        clamped to the layout's capacity (base rows + tail slots), so the
        output shape is fixed across mutations; a filter ANDs into the
        tombstone masks on the same shapes."""
        idx = view.index
        p = params.resolved(self.variant)
        k = min(p.k, idx.n + tail_slots)
        k_base = min(k, idx.n)
        nprobe = nprobe_for(self.variant, p, idx.nlist)
        min_probe = idx.min_cells_for(k_base)
        if nprobe < min_probe:
            nprobe = min(round_nprobe(min_probe), idx.nlist)
        m = shortlist_width(p, k_base, idx.n, nprobe, idx.cell_pad)
        live, tail_live = view.live, view.tail_live
        if p.filter is not None:
            base_mask, tail_mask = _view_filter_masks(view, p.filter)
            live = live & base_mask
            tail_live = tail_live & tail_mask
        return k, nprobe, m, live, tail_live

    # -- mutable-state (de)serialization ----------------------------------
    def _mutable_leaves(self) -> dict:
        with self._lock:
            leaves = {"live_bits": _pack_mask(self._live),
                      "seqno": int(self.seqno), "epoch": int(self.epoch),
                      "next_id": int(self._next_id),
                      "tail_cap": int(self.tail_cap)}
            leaves.update(self._tail_leaves())
            if self._tail_attrs is not None:
                for c, a in self._tail_attrs.items():
                    leaves[f"tail_attr/{c}"] = a.copy()
        return leaves

    def _restore_mutable(self, state: dict) -> None:
        with self._lock:
            self.tail_cap = int(state.get("tail_cap", self.tail_cap))
            self._live = _unpack_mask(state["live_bits"], (self.index.n,))
            self._restore_tail_leaves(state)
            cols = {k.split("/", 1)[1]: np.array(v, np.int32)
                    for k, v in state.items()
                    if k.startswith("tail_attr/")}
            if cols:
                self._tail_attrs = cols
            elif self.attributes is not None:
                # the base carried attribute columns but the delta
                # predates them: every tail slot is unattributed
                self._tail_attrs = {c: np.full(self._tail_shape(), -1,
                                               np.int32)
                                    for c in self.attributes}
            else:
                self._tail_attrs = None
            self.seqno = int(state["seqno"])
            self.epoch = int(state["epoch"])
            self._next_id = int(state["next_id"])
            self._rebuild_maps()
            self._sync()

    def to_delta_dict(self) -> dict:
        """Cumulative mutable-state snapshot since the base epoch: tail
        leaves + tombstone bitmap + (seqno, epoch).  Applying the latest
        delta reproduces the live state exactly."""
        assert self.index is not None, "build() first"
        return {"backend": self.name, **self._mutable_leaves()}

    def apply_delta_dict(self, delta: dict) -> None:
        """Replay one delta onto the restored base; a delta recorded at
        another compaction epoch is refused."""
        assert self.index is not None, "restore the base first"
        d_epoch = int(delta["epoch"])
        if d_epoch != self.epoch:
            raise ValueError(
                f"checkpoint delta was recorded at epoch {d_epoch}, but "
                f"the base is at epoch {self.epoch} — deltas do not span "
                f"compactions; re-save the base")
        self._restore_mutable({**delta, "tail_cap": self.tail_cap})

    def _mutable_nbytes(self) -> int:
        return (self._tail_vecs.nbytes + self._tail_ids.nbytes
                + self._tail_live.nbytes + self._live.nbytes)


@register("stream_ivf")
class StreamingIvfBackend(_StreamCommon, IvfBackend):
    """Mutable single-device IVF: flat (cap, d) delta tail."""

    name = "stream_ivf"
    #: v1 = the read-only ivf layout (no stamp); v2 adds tail leaves +
    #: tombstone bitmaps + mutation counters; v3 adds optional attribute
    #: columns (attr/<col> base + tail_attr/<col> tail).  v1/v2 load.
    STATE_FORMAT = 3

    def __init__(self, variant=None, *, metric: str = "l2", seed: int = 0,
                 device=None):
        if variant is None:
            from repro_torch.anns.engine import VariantConfig
            variant = VariantConfig(backend=self.name)
        IvfBackend.__init__(self, variant, metric=metric, seed=seed,
                            device=device)
        self.tail_cap = self._variant_tail_cap()
        self._init_concurrency()

    def _tail_shape_for(self, index) -> tuple:
        return (self.tail_cap,)

    def _global_base(self):
        return _host(self.index.base), _host(self.index.ids)

    def build(self, base: np.ndarray):
        out = IvfBackend.build(self, base)
        self._init_mutable()
        return out

    def _finalize_layout(self, inner):
        return inner

    def _place_in_tail(self, vecs: np.ndarray, ids: np.ndarray,
                       attrs=None) -> None:
        free = np.flatnonzero(self._tail_ids < 0)
        if len(free) < len(vecs):
            raise DeltaTailFull(
                f"delta tail has {len(free)} free slots of {self.tail_cap}, "
                f"cannot insert {len(vecs)} vectors — compact() first",
                free=len(free))
        slots = free[: len(vecs)]
        self._tail_vecs[slots] = vecs
        self._tail_ids[slots] = ids
        self._tail_live[slots] = True
        if attrs is not None:
            for c, col in attrs.items():
                self._tail_attrs[c][slots] = col
        for s, i in zip(slots.tolist(), ids.tolist()):
            self._tail_pos[int(i)] = (int(s),)

    def _make_view(self, index, live, tail_vecs, tail_ids, tail_live,
                   seqno, epoch, attrs=None, tail_attrs=None) -> _SearchView:
        dattrs = dtail = None
        if attrs is not None:
            dattrs = {c: self._dev(a) for c, a in attrs.items()}
            dtail = {c: self._dev(tail_attrs[c]) for c in attrs}
        return _SearchView(index, self._dev(live), self._dev(tail_vecs),
                           self._dev(tail_live),
                           torch.cat([index.ids, self._dev(tail_ids)]),
                           seqno, epoch, dattrs, dtail)

    def _search_view(self, view: _SearchView, queries,
                     params: SearchParams) -> SearchResult:
        k, nprobe, m, live, tail_live = self._view_plan(view, params,
                                                        self.tail_cap)
        out_ids, out_d, scanned = stream_ivf_search(
            view.index, live, view.tail_vecs, tail_live, view.ids_ext,
            as_f32(queries, self.device), nprobe=nprobe, k=k, m=m,
            metric=self.metric, quantized=_quantized(params))
        return SearchResult(ids=out_ids, dists=out_d, steps=nprobe,
                            expansions=scanned, backend=self.name)

    def memory_bytes(self) -> int:
        extra = self._mutable_nbytes() if self.index is not None else 0
        return IvfBackend.memory_bytes(self) + extra

    def _tail_leaves(self) -> dict:
        return {"tail_vecs": self._tail_vecs.copy(),
                "tail_ids": self._tail_ids.copy(),
                "tail_live_bits": _pack_mask(self._tail_live)}

    def _restore_tail_leaves(self, state: dict) -> None:
        self._tail_vecs = np.array(state["tail_vecs"], np.float32)
        self._tail_ids = np.array(state["tail_ids"], np.int32)
        self._tail_live = _unpack_mask(state["tail_live_bits"],
                                       self._tail_ids.shape)
        self.tail_cap = int(self._tail_ids.shape[0])

    def to_state_dict(self) -> dict:
        st = IvfBackend.to_state_dict(self)
        st["backend"] = self.name
        st["state_format"] = self.STATE_FORMAT
        st.update(self._mutable_leaves())
        return st

    def from_state_dict(self, state: dict) -> None:
        IvfBackend.from_state_dict(self, state)
        if int(state.get("state_format", 1)) >= 2 and "live_bits" in state:
            self._restore_mutable(state)
        else:
            # a read-only ivf snapshot: adopt it with fresh mutable state
            self._init_mutable()


@register("stream_sharded")
class StreamingShardedBackend(_StreamCommon, ShardedBackend):
    """Mutable cell-routed sharded IVF: per-shard (S, cap, d) tails.

    Inserts route through the coarse quantizer to the owning shard's tail,
    so the mutable leaves shard exactly like the base slices."""

    name = "stream_sharded"
    #: v2 = the read-only shardN/base_f layout; v3 adds per-shard tail
    #: leaves + tombstone bitmaps + mutation counters; v4 adds optional
    #: attribute columns (attr/<col> + tail_attr/<col>).  v1-v3 load.
    STATE_FORMAT = 4

    def __init__(self, variant=None, *, metric: str = "l2", seed: int = 0,
                 device=None):
        if variant is None:
            from repro_torch.anns.engine import VariantConfig
            variant = VariantConfig(backend=self.name)
        ShardedBackend.__init__(self, variant, metric=metric, seed=seed,
                                device=device)
        self.tail_cap = self._variant_tail_cap()
        self._init_concurrency()

    def _tail_shape_for(self, index) -> tuple:
        return (index.n_shards, self.tail_cap)

    def _global_base(self):
        idx = self.index
        vb = np.asarray(idx.vec_bounds)
        # a placed index holds one shard: gather the others' (a collective)
        bf = _host(idx.base_f if idx.mesh is None
                   else comm.all_gather(idx.base_f, idx.mesh, "shard"))
        parts = [bf[j, : int(vb[j + 1] - vb[j])]
                 for j in range(idx.n_shards)]
        return np.concatenate(parts, axis=0), _host(idx.ids)

    def build(self, base: np.ndarray):
        out = ShardedBackend.build(self, base)
        self._init_mutable()
        return out

    def _finalize_layout(self, inner):
        """The re-shard (and re-placement) happens in *prepare*, off the
        serving path."""
        out = shard_ivf(inner, self.index.n_shards)
        mesh = self.index.mesh
        return out if mesh is None else place_on_mesh(out, mesh)

    def place_on_mesh(self, mesh) -> None:
        """:meth:`ShardedBackend.place_on_mesh`, then a fresh view holding
        this rank's live mask and tail alone (see the module docstring)."""
        with self._lock:
            ShardedBackend.place_on_mesh(self, mesh)
            self._sync()

    def _route_to_shards(self, vecs: np.ndarray) -> np.ndarray:
        """Owning shard per vector: nearest cell through the existing
        coarse quantizer (the ``distance`` and ``topk`` ops), then the
        static cell -> shard map — the routing such a vector gets at
        search time."""
        idx = self.index
        a, _ = assign(vecs, idx.centroids, metric=self.metric,
                      device=self.device)
        return _host(idx.cell_shard)[a]

    def _place_in_tail(self, vecs: np.ndarray, ids: np.ndarray,
                       attrs=None) -> None:
        shard_of = self._route_to_shards(vecs)
        frees = {}
        for j in np.unique(shard_of).tolist():
            need = int((shard_of == j).sum())
            free = np.flatnonzero(self._tail_ids[j] < 0)
            if len(free) < need:
                raise DeltaTailFull(
                    f"shard {j}'s delta tail has {len(free)} free slots "
                    f"of {self.tail_cap}, cannot take {need} routed "
                    f"vectors — compact() first", free=len(free))
            frees[j] = free
        used = {j: 0 for j in frees}
        for r, j in enumerate(shard_of.tolist()):
            s = int(frees[j][used[j]])
            used[j] += 1
            self._tail_vecs[j, s] = vecs[r]
            self._tail_ids[j, s] = ids[r]
            self._tail_live[j, s] = True
            if attrs is not None:
                for c in attrs:
                    self._tail_attrs[c][j, s] = attrs[c][r]
            self._tail_pos[int(ids[r])] = (int(j), s)

    def _make_view(self, index, live_global, tail_vecs, tail_ids,
                   tail_live, seqno, epoch, attrs=None,
                   tail_attrs=None) -> _SearchView:
        """Device view over ``index``: the global live mask (and attribute
        columns) expand to the per-shard padded layout, pad rows dead (-1
        for attributes, which no predicate over real values matches).  A
        placed index's view holds this rank's shard's rows alone."""
        vb = np.asarray(index.vec_bounds)
        npad = int(index.base_q.shape[1])

        def per_shard(col, fill, dtype):
            exp = np.full((index.n_shards, npad), fill, dtype)
            col = np.asarray(col)
            for j in range(index.n_shards):
                v0, v1 = int(vb[j]), int(vb[j + 1])
                exp[j, : v1 - v0] = col[v0:v1]
            return exp

        rows = (slice(None) if index.mesh is None
                else slice(index.shard, index.shard + 1))

        def dev(a):
            return self._dev(np.asarray(a)[rows])

        live = per_shard(live_global, False, bool)
        dattrs = dtail = None
        if attrs is not None:
            dattrs = {c: dev(per_shard(col, -1, np.int32))
                      for c, col in attrs.items()}
            dtail = {c: dev(a) for c, a in tail_attrs.items()}
        ids_ext = torch.cat([index.ids,
                             self._dev(np.asarray(tail_ids).reshape(-1))])
        return _SearchView(index, dev(live), dev(tail_vecs), dev(tail_live),
                           ids_ext, seqno, epoch, dattrs, dtail)

    def _search_view(self, view: _SearchView, queries,
                     params: SearchParams) -> SearchResult:
        k, nprobe, m, live, tail_live = self._view_plan(
            view, params, view.index.n_shards * self.tail_cap)
        search = (stream_sharded_search if view.index.mesh is None
                  else placed_stream_search)
        out_ids, out_d, scanned = search(
            view.index, live, view.tail_vecs, tail_live, view.ids_ext,
            as_f32(queries, self.device), nprobe=nprobe, k=k, m=m,
            metric=self.metric, quantized=_quantized(params))
        return SearchResult(ids=out_ids, dists=out_d, steps=nprobe,
                            expansions=scanned, backend=self.name)

    def memory_bytes(self) -> int:
        extra = self._mutable_nbytes() if self.index is not None else 0
        return ShardedBackend.memory_bytes(self) + extra

    def device_memory_bytes(self) -> int:
        if self.index is None:
            return 0
        return (ShardedBackend.device_memory_bytes(self)
                + self._mutable_nbytes() // max(self.index.n_shards, 1))

    def _tail_leaves(self) -> dict:
        leaves = {"tail_live_bits": _pack_mask(self._tail_live)}
        for j in range(self.index.n_shards):
            leaves[f"shard{j}/tail_vecs"] = self._tail_vecs[j].copy()
            leaves[f"shard{j}/tail_ids"] = self._tail_ids[j].copy()
        return leaves

    def _restore_tail_leaves(self, state: dict) -> None:
        S = self.index.n_shards
        self._tail_vecs = np.stack(
            [np.asarray(state[f"shard{j}/tail_vecs"], np.float32)
             for j in range(S)])
        self._tail_ids = np.stack(
            [np.asarray(state[f"shard{j}/tail_ids"], np.int32)
             for j in range(S)])
        self._tail_live = _unpack_mask(state["tail_live_bits"],
                                       self._tail_ids.shape)
        self.tail_cap = int(self._tail_ids.shape[1])

    def to_state_dict(self) -> dict:
        st = ShardedBackend.to_state_dict(self)
        st["backend"] = self.name
        st["state_format"] = self.STATE_FORMAT
        st.update(self._mutable_leaves())
        return st

    def from_state_dict(self, state: dict) -> None:
        ShardedBackend.from_state_dict(self, state)
        if int(state.get("state_format", 1)) >= 3 and "live_bits" in state:
            self._restore_mutable(state)
        else:
            # a read-only sharded snapshot (v1 replicated base, v2 / v3
            # shardN/base_f): adopt it with fresh mutable state
            self._init_mutable()
