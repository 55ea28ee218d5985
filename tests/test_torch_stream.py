"""The port's streaming backends (``repro_torch.anns.stream``) against the
JAX package's (``repro.anns.stream``) on the CPU.

Both packages start from one built index (the reference's, moved across as
a read-only snapshot) and take the same mutation history, so every
lifecycle property of ``tests/test_stream.py`` is held twice: the port's
ids equal the reference's after every insert / delete / compact; compacted
state is byte-equal leaf by leaf, except the int8 scales, which sit up to
1 ulp apart (the reference's jitted quantizer multiplies by 1/127 where
the port divides — the layout's recorded rounding difference); delta
checkpoints are byte-equal to the reference's raw frames and base + deltas
load both ways to identical ids; and the refusals (stale epoch, future
formats, a full tail, id collisions, compaction fences) raise the same
typed errors.  Sizes are the reference tests': 1,500 x 128, nlist 32, a
tail of 256.
"""
import dataclasses
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.ckpt.checkpoint as jax_checkpoint  # noqa: E402
from repro import ckpt as jax_ckpt  # noqa: E402
from repro.anns import SearchParams as JaxParams  # noqa: E402
from repro.anns import make_dataset as jax_make_dataset  # noqa: E402
from repro.anns import registry as jax_registry  # noqa: E402
from repro.anns.engine import VariantConfig as JaxVariant  # noqa: E402
from repro.anns.filters import FilterPredicate as JaxPredicate  # noqa: E402
from repro.anns.stream import exact_live_gt as jax_exact_live_gt  # noqa: E402
from repro.anns.stream import search as jax_stream_search  # noqa: E402
from repro_torch import ckpt  # noqa: E402
from repro_torch.anns import SearchParams, registry  # noqa: E402
from repro_torch.anns import search as search_lib  # noqa: E402
from repro_torch.anns.api import search_ef_ladder, supports_mutation  # noqa: E402
from repro_torch.anns.datasets import (exact_ground_truth,  # noqa: E402
                                       filtered_recall_at_k, recall_at_k)
from repro_torch.anns.engine import family_baseline  # noqa: E402
from repro_torch.anns.filters import (AttributeMismatch, FilterError,  # noqa: E402
                                      FilterPredicate, UnknownAttribute)
from repro_torch.anns.ivf import ivf_stats  # noqa: E402
from repro_torch.anns.stream import (BackgroundCompactor,  # noqa: E402
                                     CompactionInFlight, DeltaTailFull,
                                     StaleCompaction, StreamingIvfBackend,
                                     StreamingShardedBackend, exact_live_gt)
from repro_torch.anns.stream import search as stream_search  # noqa: E402
from repro_torch.anns.tune import (DriftMonitor, OperatingPoint,  # noqa: E402
                                   RecallSLO, resweep_and_choose)
from repro_torch.ckpt import index_io  # noqa: E402
from repro_torch.runtime.server import index_size  # noqa: E402

N_BASE, N_QUERY, NLIST, TAIL_CAP = 1500, 24, 32, 256
NAMES = ["stream_ivf", "stream_sharded"]
MUTABLE_LEAVES = ("live_bits", "seqno", "epoch", "next_id", "tail_cap",
                  "tail_vecs", "tail_ids", "tail_live_bits")
D = 128


@pytest.fixture(scope="module")
def ds():
    return jax_make_dataset("sift-128-euclidean", n_base=N_BASE,
                            n_query=N_QUERY)


_READONLY = {}


def _readonly_state(name, ds):
    """The reference's built index as a read-only snapshot (built once per
    family): ivf's v1 (no stamp), sharded's v2 — the formats both
    streaming backends adopt with fresh mutable state."""
    if name not in _READONLY:
        v = dataclasses.replace(_variant(name, TAIL_CAP), backend=name)
        b = jax_registry.create(name, JaxVariant(**dataclasses.asdict(v)),
                                metric=ds.metric, seed=0)
        b.build(ds.base)
        st = {k: v for k, v in b.to_state_dict().items()
              if k not in MUTABLE_LEAVES and "/tail_" not in k}
        if name == "stream_ivf":
            st.pop("state_format")
        else:
            st["state_format"] = 2
        _READONLY[name] = st
    return _READONLY[name]


def _variant(name, tail_cap):
    return dataclasses.replace(family_baseline(name), nlist=NLIST,
                               kmeans_iters=2, tail_cap=tail_cap)


def _pair(name, ds, *, tail_cap=TAIL_CAP):
    """(reference, port) streaming backends over one built index."""
    state = _readonly_state(name, ds)
    v = _variant(name, tail_cap)
    ref = jax_registry.create(name, JaxVariant(**dataclasses.asdict(v)),
                              metric=ds.metric, seed=0)
    ref.from_state_dict(dict(state))
    port = registry.create(name, v, metric=ds.metric, seed=0, device="cpu")
    port.from_state_dict(dict(state))
    return ref, port


def _port(name, ds, *, tail_cap=TAIL_CAP):
    v = _variant(name, tail_cap)
    port = registry.create(name, v, metric=ds.metric, seed=0, device="cpu")
    port.from_state_dict(dict(_readonly_state(name, ds)))
    return port


def _ids(b, queries, **kw):
    if isinstance(b, (StreamingIvfBackend, StreamingShardedBackend)):
        return b.search(queries, SearchParams(**kw)).ids.numpy()
    if isinstance(kw.get("filter"), FilterPredicate):
        f = kw["filter"]
        kw = {**kw, "filter": JaxPredicate.isin(f.attr, f.values)}
    return np.asarray(b.search(queries, JaxParams(**kw)).ids)


def _exact(b, k=10):
    """Max-nprobe fp32 search: every cell probed, no quantization — the
    result must equal brute force over the live set."""
    return dict(k=k, ef=64 * b.index.nlist, quantized=False, rerank_factor=4)


def _assert_same_ids(ref, port, queries, efs=(16, 64)):
    for kw in [dict(k=10, ef=ef) for ef in efs] + [_exact(port)]:
        np.testing.assert_array_equal(_ids(port, queries, **kw),
                                      _ids(ref, queries, **kw), err_msg=kw)


def _new_vecs(rng, n, d=D):
    return rng.standard_normal((n, d)).astype(np.float32)


def _both(ref, port, method, *args, **kw):
    a = getattr(ref, method)(*args, **kw)
    b = getattr(port, method)(*args, **kw)
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (method, a, b)
    return b


def _mutate(ref, port, seed):
    rng = np.random.default_rng(seed)
    _both(ref, port, "insert", _new_vecs(rng, 80))
    _both(ref, port, "delete",
          rng.choice(N_BASE, 50, replace=False).astype(np.int64))


def _assert_state_equal(want, got):
    """Leaf by leaf byte-equal, but the int8 scales of a layout the port
    laid out itself: those may sit 1 ulp from the reference's."""
    assert want.keys() == got.keys(), set(want) ^ set(got)
    for key in want:
        w, g = want[key], got[key]
        if not isinstance(w, np.ndarray):
            assert w == g, key
            continue
        w = np.asarray(w)
        assert w.dtype == g.dtype and w.shape == g.shape, key
        if key.endswith("scales"):
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            assert w.tobytes() == g.tobytes(), key


# ---------------------------------------------------------------------------
# the search's own arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_tail_scan_is_the_ivf_distance(metric):
    """The tail scan is ``_qdist``'s shared form, which agrees with its
    per-query form and with the reference's tail scan; dead slots are
    exactly BIG."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_new_vecs(rng, 16, 40))
    tail = torch.from_numpy(_new_vecs(rng, 300, 40))
    live = torch.from_numpy(rng.random(300) < 0.7)
    got = stream_search._tail_dists(q, tail, live, metric)
    batched = search_lib._qdist(q, tail.expand(16, 300, 40), metric)
    torch.testing.assert_close(search_lib._qdist(q, tail, metric), batched,
                               rtol=1e-5, atol=1e-4)
    want = np.asarray(jax_stream_search._tail_dists(
        jnp.asarray(q.numpy()), jnp.asarray(tail.numpy()),
        jnp.asarray(live.numpy()), metric))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    dead = ~live.numpy()
    assert (got.numpy()[:, dead] == search_lib.BIG).all()


# ---------------------------------------------------------------------------
# property (a): inserted vectors are served pre-compaction
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_inserted_vectors_served_before_compaction(ds, name):
    ref, port = _pair(name, ds)
    _assert_same_ids(ref, port, ds.queries)
    extra = _new_vecs(np.random.default_rng(1), 100)
    new_ids = _both(ref, port, "insert", extra)
    assert port.tail_fraction() > 0.0 and supports_mutation(port)
    _assert_same_ids(ref, port, ds.queries)
    gt = exact_live_gt(port, ds.queries, 10)
    np.testing.assert_array_equal(gt, jax_exact_live_gt(ref, ds.queries, 10))
    assert recall_at_k(_ids(port, ds.queries, **_exact(port)), gt, 10) == 1.0
    # an inserted vector queried verbatim returns its own fresh id
    probe = _ids(port, extra[:8], **_exact(port, k=1))
    assert probe.ravel().tolist() == new_ids[:8].tolist()


# ---------------------------------------------------------------------------
# property (b): tombstoned ids never surface
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_tombstoned_ids_never_surface(ds, name, tmp_path):
    ref, port = _pair(name, ds)
    rng = np.random.default_rng(2)
    new_ids = _both(ref, port, "insert", _new_vecs(rng, 64))
    dead = np.concatenate([rng.choice(N_BASE, 40, replace=False),
                           new_ids[:10]]).astype(np.int64)
    assert _both(ref, port, "delete", dead) == len(dead)
    _assert_same_ids(ref, port, ds.queries)

    def surfaced(b):
        return set(_ids(b, ds.queries, **_exact(port)).ravel()) & set(
            dead.tolist())

    assert not surfaced(port)                    # masked in tail + cells
    path = str(tmp_path / "idx.ckpt")
    ckpt.save_index(path, port)
    ckpt.save_index_delta(path, port)
    loaded = ckpt.load_index(path, device="cpu")
    assert not surfaced(loaded)                  # after delta replay
    _both(ref, port, "compact")
    assert not surfaced(port)                    # dropped from the layout
    _assert_same_ids(ref, port, ds.queries)
    assert port.n_live() == N_BASE + 64 - len(dead)
    # a tombstone outlives the id: deleting twice is a no-op
    assert _both(ref, port, "delete", dead[:5]) == 0


# ---------------------------------------------------------------------------
# property (c): compact() determinism and parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_same_mutation_history_compacts_to_the_reference_bytes(ds, name):
    """The same history twice compacts the port to byte-identical state,
    and that state is the reference's (scales within 1 ulp)."""
    states = []
    for _ in range(2):
        ref, port = _pair(name, ds)
        _mutate(ref, port, seed=3)
        _both(ref, port, "compact")
        states.append(port.to_state_dict())
    a, c = states
    assert a.keys() == c.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].tobytes() == c[key].tobytes(), key
        else:
            assert a[key] == c[key], key
    _assert_state_equal(ref.to_state_dict(), a)
    _assert_same_ids(ref, port, ds.queries)


def test_compact_search_identical_to_fresh_build_on_survivors(ds):
    """compact() folds through the *existing* centroids where a fresh
    build re-trains k-means on the survivors: different layouts, but both
    serve brute-force results at the exact probe."""
    ref, port = _pair("stream_ivf", ds)
    _mutate(ref, port, seed=4)
    vecs, ids = port.live_vectors()
    _both(ref, port, "compact")
    assert port.tail_fraction() == 0.0
    fresh = registry.create(
        "ivf", dataclasses.replace(port.variant, backend="ivf"),
        metric=ds.metric, seed=0, device="cpu")
    fresh.build(vecs)
    got = _ids(port, ds.queries, **_exact(port))
    np.testing.assert_array_equal(
        got, ids[fresh.search(ds.queries, SearchParams(
            **_exact(port))).ids.numpy()])
    np.testing.assert_array_equal(got, _ids(ref, ds.queries, **_exact(port)))


# ---------------------------------------------------------------------------
# property (d): incremental checkpoints, both ways
# ---------------------------------------------------------------------------
def _save_ref(path, ref, monkeypatch, *, delta=False, zstd=False):
    with monkeypatch.context() as mp:
        if not zstd:
            mp.setattr(jax_checkpoint, "zstd", None)
        if delta:
            return jax_ckpt.save_index_delta(path, ref)
        jax_ckpt.save_index(path, ref)
        return path


def _same_files(a, b):
    for f in ("shard_0.bin", "manifest.json"):
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), (a, f)


@pytest.mark.parametrize("name", NAMES)
def test_base_plus_deltas_byte_equal_and_load_both_ways(ds, name, tmp_path,
                                                        monkeypatch):
    ref, port = _pair(name, ds)
    pp, rp = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save_index(pp, port)
    _save_ref(rp, ref, monkeypatch)
    _same_files(pp, rp)                          # the base
    rng = np.random.default_rng(5)
    _both(ref, port, "insert", _new_vecs(rng, 30))
    subs = [(ckpt.save_index_delta(pp, port),
             _save_ref(rp, ref, monkeypatch, delta=True))]
    _both(ref, port, "delete",
          rng.choice(N_BASE, 20, replace=False).astype(np.int64))
    _both(ref, port, "insert", _new_vecs(rng, 10))
    subs.append((ckpt.save_index_delta(pp, port),
                 _save_ref(rp, ref, monkeypatch, delta=True)))
    for sp, sr in subs:
        assert os.path.basename(sp) == os.path.basename(sr)
        _same_files(sp, sr)                      # each delta
    live = port.to_state_dict()
    for loaded in (ckpt.load_index(pp, device="cpu"),
                   ckpt.load_index(rp, device="cpu")):
        _assert_state_equal(live, loaded.to_state_dict())
        _assert_same_ids(ref, loaded, ds.queries)
    back = jax_ckpt.load_index(pp)
    _assert_state_equal(ref.to_state_dict(), back.to_state_dict())
    _assert_same_ids(back, port, ds.queries)


@pytest.mark.parametrize("name", NAMES)
def test_zstd_deltas_of_the_reference_load_into_the_port(ds, name, tmp_path,
                                                         monkeypatch):
    pytest.importorskip("zstandard")
    ref, port = _pair(name, ds)
    path = str(tmp_path / "ref")
    _save_ref(path, ref, monkeypatch, zstd=True)
    rng = np.random.default_rng(6)
    _both(ref, port, "insert", _new_vecs(rng, 12))
    _both(ref, port, "delete", np.arange(7, dtype=np.int64))
    _save_ref(path, ref, monkeypatch, delta=True, zstd=True)
    loaded = ckpt.load_index(path, device="cpu")
    _assert_state_equal(port.to_state_dict(), loaded.to_state_dict())
    _assert_same_ids(ref, loaded, ds.queries)


def test_readonly_snapshots_load_with_fresh_mutable_state(ds, tmp_path):
    """A v1 snapshot (read-only ivf layout, no stamp) restored under the
    streaming backend comes up clean-slate mutable; so does the read-only
    ivf's current v2 snapshot (the 1M chip path), where the reference's
    stream_ivf looks for mutable leaves the snapshot never had."""
    ref, port = _pair("stream_ivf", ds)
    path = str(tmp_path / "v1.ckpt")
    ckpt.save_checkpoint(path, {k: v for k, v in _readonly_state(
        "stream_ivf", ds).items() if isinstance(v, np.ndarray)}, 0,
        extra={"anns_index_meta": {"backend": "stream_ivf", "metric": "l2"}})
    loaded = ckpt.load_index(path, device="cpu")
    assert isinstance(loaded, StreamingIvfBackend)
    assert loaded.n_live() == N_BASE and loaded.tail_fraction() == 0.0
    loaded.insert(_new_vecs(np.random.default_rng(6), 4))
    assert loaded.n_live() == N_BASE + 4
    ivf = registry.create("ivf", dataclasses.replace(
        port.variant, backend="ivf"), device="cpu")
    ivf.from_state_dict(_readonly_state("stream_ivf", ds))
    v2 = ivf.to_state_dict()
    assert v2["state_format"] == 2
    adopted = registry.create("stream_ivf", port.variant, device="cpu")
    adopted.from_state_dict(v2)
    assert adopted.n_live() == N_BASE and adopted.seqno == 0
    _assert_same_ids(ref, adopted, ds.queries)


def test_stale_epoch_delta_rejected(ds, tmp_path):
    """A delta recorded before a compaction does not replay onto the
    compacted base."""
    port = _port("stream_ivf", ds)
    port.insert(_new_vecs(np.random.default_rng(7), 8))
    stale = port.to_delta_dict()
    port.compact()
    path = str(tmp_path / "idx.ckpt")
    ckpt.save_index(path, port)
    port.to_delta_dict = lambda: stale
    ckpt.save_index_delta(path, port)
    with pytest.raises(ValueError, match="epoch"):
        ckpt.load_index(path, device="cpu")


def _expect_format_error(fn, *, kind, found):
    with pytest.raises(ckpt.ArtifactFormatError, match="newer") as ei:
        fn()
    err = ei.value
    assert (err.kind, err.found) == (kind, found)
    assert err.supported < found and str(err.supported) in str(err)


def test_future_base_state_format_fails_fast(ds, tmp_path):
    port = _port("stream_ivf", ds)
    orig = port.to_state_dict()
    port.to_state_dict = lambda: {**orig, "state_format": 99}
    path = str(tmp_path / "future.ckpt")
    ckpt.save_index(path, port)
    _expect_format_error(lambda: ckpt.load_index(path, device="cpu"),
                         kind="state", found=99)


def test_future_delta_format_fails_fast(ds, tmp_path, monkeypatch):
    port = _port("stream_ivf", ds)
    path = str(tmp_path / "idx.ckpt")
    ckpt.save_index(path, port)
    port.insert(_new_vecs(np.random.default_rng(8), 4))
    with monkeypatch.context() as mp:
        mp.setattr(index_io, "DELTA_FORMAT", 99)
        ckpt.save_index_delta(path, port)
    _expect_format_error(lambda: ckpt.load_index(path, device="cpu"),
                         kind="delta", found=99)


def test_a_read_only_backend_refuses_deltas(ds, tmp_path):
    port = _port("stream_ivf", ds)
    with pytest.raises(TypeError, match="to_delta_dict"):
        ckpt.save_index_delta(str(tmp_path / "x"),
                              registry.create("brute_force", device="cpu"))
    path = str(tmp_path / "idx.ckpt")
    ckpt.save_index(path, port)
    port.insert(_new_vecs(np.random.default_rng(9), 4))
    port.name = "stream_sharded"                 # a delta of another family
    ckpt.save_index_delta(path, port)
    with pytest.raises(ValueError, match="delta for backend"):
        ckpt.load_index(path, device="cpu")


# ---------------------------------------------------------------------------
# mutation guardrails
# ---------------------------------------------------------------------------
def test_delta_tail_full_raises_then_compact_frees(ds):
    ref, port = _pair("stream_ivf", ds, tail_cap=16)
    rng = np.random.default_rng(9)
    _both(ref, port, "insert", _new_vecs(rng, 12))
    x = _new_vecs(rng, 8)
    for b in (ref, port):
        with pytest.raises(Exception) as ei:
            b.insert(x)
        assert type(ei.value).__name__ == "DeltaTailFull"
        assert ei.value.free == 4
    assert isinstance(ei.value, DeltaTailFull)
    _both(ref, port, "compact")
    _both(ref, port, "insert", x)                # tail drained
    assert port.n_live() == N_BASE + 20
    _assert_same_ids(ref, port, ds.queries)


def test_insert_id_collisions_rejected(ds):
    ref, port = _pair("stream_ivf", ds)
    x = _new_vecs(np.random.default_rng(10), 2)
    for b in (ref, port):
        with pytest.raises(ValueError, match="already live"):
            b.insert(x, ids=[0, N_BASE + 1])     # 0 is a live base id
        with pytest.raises(ValueError, match="duplicate"):
            b.insert(x, ids=[N_BASE + 1, N_BASE + 1])
        with pytest.raises(ValueError, match="non-negative"):
            b.insert(x, ids=[-1, N_BASE + 1])
        assert b.n_live() == N_BASE and b.seqno == 0   # no-ops


# ---------------------------------------------------------------------------
# sharded streaming stays equivalent to single-device streaming
# ---------------------------------------------------------------------------
def test_stream_sharded_matches_stream_ivf_through_lifecycle(ds):
    a = _port("stream_ivf", ds)
    s = _port("stream_sharded", ds)
    rng_a, rng_s = np.random.default_rng(11), np.random.default_rng(11)
    for stage in ("fresh", "mutated", "compacted"):
        if stage == "mutated":
            for b, rng in ((a, rng_a), (s, rng_s)):
                b.insert(_new_vecs(rng, 80))
                b.delete(rng.choice(N_BASE, 50, replace=False))
        elif stage == "compacted":
            a.compact(), s.compact()
        for ef in (16, 64):
            np.testing.assert_array_equal(
                _ids(a, ds.queries, k=10, ef=ef),
                _ids(s, ds.queries, k=10, ef=ef),
                err_msg=f"stage={stage} ef={ef}")


def test_ivf_stats_survives_degenerate_layouts(ds):
    ref, port = _pair("stream_ivf", ds, tail_cap=8)
    _both(ref, port, "delete", np.arange(N_BASE - 1))   # one survivor
    _both(ref, port, "compact")
    st = ivf_stats(port.index)
    assert st["n"] == 1
    assert st["cell_skew"] == pytest.approx(float(port.index.nlist))
    _both(ref, port, "delete", port.live_vectors()[1])  # fully empty
    _both(ref, port, "compact")
    assert port.n_live() == 0
    st = ivf_stats(port.index)
    assert st["n"] == 1 and np.isfinite(st["cell_skew"])
    ids = _ids(port, ds.queries[:2], k=5)
    assert (ids == -1).all()
    np.testing.assert_array_equal(ids, _ids(ref, ds.queries[:2], k=5))
    _assert_state_equal(ref.to_state_dict(), port.to_state_dict())


def test_server_index_size_tracks_mutations(ds):
    from repro_torch.runtime.server import AnnsServer
    port = _port("stream_ivf", ds)
    srv = AnnsServer(port, params=SearchParams(k=10, ef=16), max_batch=8)
    assert index_size(srv.engine) == N_BASE
    port.insert(_new_vecs(np.random.default_rng(13), 6))
    port.delete(np.arange(4))
    assert index_size(srv.engine) == port.n_live() == N_BASE + 2


# ---------------------------------------------------------------------------
# views are copies: mutations and swaps never tear a captured snapshot
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_a_captured_view_survives_mutation_and_swap(ds, name):
    port = _port(name, ds)
    rng = np.random.default_rng(14)
    port.insert(_new_vecs(rng, 40))
    old = port._view
    tail = old.tail_vecs.clone()
    live = old.live.clone()
    port.insert(_new_vecs(rng, 40))
    port.delete(np.arange(30))
    port.compact()
    assert torch.equal(old.tail_vecs, tail) and torch.equal(old.live, live)
    for t in (old.live, old.tail_vecs, old.tail_live):
        for master in (port._live, port._tail_vecs, port._tail_live):
            assert not np.shares_memory(t.numpy(), master)


# ---------------------------------------------------------------------------
# background compaction: two-phase prepare / commit, seqno-fenced swap
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_mutations_during_background_build_survive_swap(ds, name):
    """Inserts / deletes landing between prepare and commit are journaled
    and replayed into the fresh epoch, as in the reference."""
    ref, port = _pair(name, ds)
    _mutate(ref, port, seed=11)
    rng = np.random.default_rng(12)
    preps = (ref.prepare_compaction(), port.prepare_compaction())
    mid = _both(ref, port, "insert", _new_vecs(rng, 16))
    _both(ref, port, "delete", mid[:4])          # a journaled insert
    _both(ref, port, "delete", np.asarray([7, 8], np.int64))
    ref.commit_compaction(preps[0])
    port.commit_compaction(preps[1])
    assert port.epoch == 1
    assert port.n_live() == N_BASE + 80 - 50 + 16 - 4 - 2
    _assert_state_equal(ref.to_state_dict(), port.to_state_dict())
    _assert_same_ids(ref, port, ds.queries)
    res = _ids(port, ds.queries, **_exact(port))
    assert recall_at_k(res, exact_live_gt(port, ds.queries, 10), 10) >= 0.995
    assert not set(res.ravel().tolist()) & set(mid[:4].tolist())


@pytest.mark.parametrize("name", NAMES)
def test_prepare_commit_lifecycle_guards(ds, name):
    port = _port(name, ds)
    port.insert(_new_vecs(np.random.default_rng(13), 20))
    prep = port.prepare_compaction()
    with pytest.raises(CompactionInFlight):
        port.prepare_compaction()
    port.commit_compaction(prep)
    with pytest.raises(StaleCompaction):        # already swapped
        port.commit_compaction(prep)
    port.commit_compaction(port.prepare_compaction())
    assert port.epoch == 2


@pytest.mark.parametrize("name", NAMES)
def test_fenced_swap_concurrent_searches_never_torn(ds, name):
    """Searches racing the swap see the old or the new epoch's state,
    never a mix: the live set is the same on both sides, so anything but
    brute-force ground truth means a torn view."""
    ref, port = _pair(name, ds)
    _mutate(ref, port, seed=17)
    gt = exact_live_gt(port, ds.queries, 10)
    np.testing.assert_array_equal(gt, jax_exact_live_gt(ref, ds.queries, 10))
    params = SearchParams(**_exact(port))
    stop = threading.Event()
    results, errors = [], []

    def hammer():
        try:
            while not stop.is_set():
                results.append(port.search(ds.queries, params).ids.numpy())
        except BaseException as e:               # surfaced below
            errors.append(e)

    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    try:
        for _ in range(3):                       # several swaps under fire
            prep = port.prepare_compaction()
            port.warm_compacted(prep, ds.queries, params)
            port.commit_compaction(prep)
    finally:
        stop.set()
        t.join(timeout=120)
    assert not errors, errors
    assert port.epoch == 3 and results
    for ids in results:
        assert recall_at_k(ids, gt, 10) >= 0.995


def _point(recall=0.9, ef=32, qps=100.0):
    return OperatingPoint(backend="stream_ivf",
                          params=SearchParams(k=10, ef=ef), recall=recall,
                          qps=qps)


def test_background_compactor_suppresses_trigger_while_in_flight(ds):
    port = _port("stream_ivf", ds)
    port.insert(_new_vecs(np.random.default_rng(19), 80))
    monitor = DriftMonitor(_point(), max_tail_frac=0.05, min_observations=1)
    comp = BackgroundCompactor(port, monitors=[monitor])
    v = monitor.observe(recall=0.95, tail_fraction=port.tail_fraction())
    assert v.triggered and v.reason == "tail_frac"
    gate = threading.Event()
    orig = port.prepare_compaction
    port.prepare_compaction = lambda: (gate.wait(60), orig())[1]
    try:
        assert comp.maybe_compact(v) is True
        assert comp.in_flight and monitor.compaction_pending
        v2 = monitor.observe(recall=0.95, tail_fraction=port.tail_fraction())
        assert not v2.triggered
        assert comp.maybe_compact(v2) is False
        assert comp.maybe_compact(v) is False    # no double schedule
    finally:
        gate.set()
    assert comp.join(timeout=120)
    assert port.epoch == 1 and comp.runs == 1
    assert not monitor.compaction_pending
    port.insert(_new_vecs(np.random.default_rng(23), 120))
    v3 = monitor.observe(recall=0.95, tail_fraction=port.tail_fraction())
    assert v3.triggered and v3.reason == "tail_frac"


def test_background_compactor_worker_failure_surfaces(ds):
    port = _port("stream_ivf", ds)

    def boom():
        raise RuntimeError("layout build exploded")

    port.prepare_compaction = boom
    comp = BackgroundCompactor(port)
    assert comp.schedule() is True
    with pytest.raises(RuntimeError, match="layout build exploded"):
        comp.join(timeout=120)
    assert comp.join(timeout=1)                 # not raised twice


def test_background_compactor_warms_then_swaps_and_rebases(ds):
    port = _port("stream_ivf", ds)
    port.insert(_new_vecs(np.random.default_rng(24), 30))
    monitor = DriftMonitor(_point(), min_observations=1)
    monitor.observe(recall=0.95)
    warmed = []
    orig = port.warm_compacted
    port.warm_compacted = lambda p, q, params: (warmed.append(params),
                                                orig(p, q, params))
    comp = BackgroundCompactor(port, monitors=[monitor], nice=None,
                               warm=lambda: (ds.queries[:4],
                                             SearchParams(k=10, ef=16)))
    assert comp.schedule() and comp.join(timeout=120)
    assert warmed == [SearchParams(k=10, ef=16)] and port.epoch == 1
    assert monitor.n_observations == 0           # rebased after the swap


def test_resweep_frontier_stamps_live_count_and_epoch(ds):
    port = _port("stream_ivf", ds)
    port.insert(_new_vecs(np.random.default_rng(31), 80))
    port.delete(np.arange(50))
    port.compact()
    ladder = list(search_ef_ladder(port))

    def measure(target, ds_, params, repeats, build_seconds):
        return OperatingPoint(backend=target.name, params=params,
                              recall=0.95, qps=1e4 / params.ef)

    _, fr = resweep_and_choose(port, ds, RecallSLO(0.5),
                               _point(ef=ladder[1]), measure_fn=measure)
    assert fr.n_base == port.n_live() == N_BASE + 30
    assert fr.meta["n_live"] == port.n_live() and fr.meta["epoch"] == 1


# ---------------------------------------------------------------------------
# attribute lifecycle: columns ride insert -> tail -> tombstone -> compact
# ---------------------------------------------------------------------------
def _assert_attrs_match_mirror(b, mirror):
    _, ids_l = b.live_vectors()
    got = b.live_attributes()
    assert set(got) == {"cat", "bucket"}
    assert set(ids_l.tolist()) == set(mirror)
    for c, col in got.items():
        want = np.array([mirror[int(i)][c] for i in ids_l], np.int32)
        assert col.dtype == np.int32 and np.array_equal(col, want), c


@pytest.mark.parametrize("name", NAMES)
def test_attribute_lifecycle_matches_numpy_mirror_and_reference(ds, name):
    ref, port = _pair(name, ds)
    _both(ref, port, "set_attributes", ds.attrs)
    rng = np.random.default_rng(11)
    mirror = {i: {"cat": int(ds.attrs["cat"][i]),
                  "bucket": int(ds.attrs["bucket"][i])}
              for i in range(N_BASE)}
    _assert_attrs_match_mirror(port, mirror)
    for step in range(4):
        m = 40
        vecs = _new_vecs(rng, m)
        if step == 0:
            attrs = None
        elif step == 1:
            attrs = {"cat": rng.integers(0, 100, m)}
        else:
            attrs = {"cat": rng.integers(0, 100, m),
                     "bucket": rng.integers(0, 16, m)}
        new_ids = _both(ref, port, "insert", vecs, attrs=attrs)
        for j, i in enumerate(new_ids.tolist()):
            mirror[i] = {
                "cat": -1 if attrs is None else int(attrs["cat"][j]),
                "bucket": -1 if attrs is None or "bucket" not in attrs
                else int(attrs["bucket"][j])}
        live = np.array(sorted(mirror), np.int64)
        dead = rng.choice(live, 15, replace=False)
        assert _both(ref, port, "delete", dead) == len(dead)
        for i in dead.tolist():
            del mirror[i]
        _assert_attrs_match_mirror(port, mirror)
        if step == 2:
            _both(ref, port, "compact")
            _assert_attrs_match_mirror(port, mirror)
    pred = FilterPredicate.isin("cat", range(20))
    vecs_l, ids_l = port.live_vectors()
    rows = np.flatnonzero([mirror[int(i)]["cat"] in range(20) for i in ids_l])
    p = _exact(port)
    fgt = ids_l[rows][exact_ground_truth(vecs_l[rows], ds.queries, p["k"],
                                         ds.metric, device="cpu")]
    found = _ids(port, ds.queries, **p, filter=pred)
    assert all(mirror[int(i)]["cat"] in range(20) for i in found[found >= 0])
    assert filtered_recall_at_k(found, fgt, p["k"]) == 1.0
    np.testing.assert_array_equal(found, _ids(ref, ds.queries, **p,
                                              filter=pred))
    _assert_state_equal(ref.to_state_dict(), port.to_state_dict())


@pytest.mark.parametrize("name", NAMES)
def test_attribute_all_dead_compact_and_refill(ds, name):
    port = _port(name, ds)
    port.set_attributes(ds.attrs)
    _, ids_l = port.live_vectors()
    assert port.delete(ids_l.astype(np.int64)) == len(ids_l)
    port.compact()
    assert port.n_live() == 0
    got = port.live_attributes()
    assert set(got) == {"cat", "bucket"}
    assert all(len(col) == 0 for col in got.values())
    vecs = _new_vecs(np.random.default_rng(13), 8)
    new_ids = port.insert(vecs, attrs={"cat": np.full(8, 7),
                                       "bucket": np.arange(8)})
    ids = _ids(port, vecs, **_exact(port, k=1),
               filter=FilterPredicate.eq("cat", 7))
    assert ids.ravel().tolist() == new_ids.tolist()


@pytest.mark.parametrize("name", NAMES)
def test_attrs_survive_ckpt_base_plus_delta(ds, name, tmp_path):
    port = _port(name, ds)
    port.set_attributes(ds.attrs)
    path = str(tmp_path / "idx.ckpt")
    ckpt.save_index(path, port)
    rng = np.random.default_rng(19)
    port.insert(_new_vecs(rng, 48), attrs={"cat": rng.integers(0, 100, 48),
                                           "bucket": rng.integers(0, 16, 48)})
    port.delete(rng.choice(N_BASE, 30, replace=False).astype(np.int64))
    ckpt.save_index_delta(path, port)
    for b2 in (ckpt.load_index(path, device="cpu"), jax_ckpt.load_index(path)):
        np.testing.assert_array_equal(port.live_vectors()[1],
                                      b2.live_vectors()[1])
        ga, gb = port.live_attributes(), b2.live_attributes()
        assert set(ga) == set(gb)
        for c in ga:
            np.testing.assert_array_equal(ga[c], gb[c])
        kw = dict(_exact(port), filter=FilterPredicate.isin("cat", range(30)))
        np.testing.assert_array_equal(_ids(port, ds.queries, **kw),
                                      _ids(b2, ds.queries, **kw))


def test_stream_insert_attr_failures(ds):
    port = _port("stream_ivf", ds)
    vecs = _new_vecs(np.random.default_rng(23), 4)
    with pytest.raises(UnknownAttribute, match="no attribute columns"):
        port.insert(vecs, attrs={"cat": np.zeros(4, np.int32)})
    port.set_attributes(ds.attrs)
    n0, s0 = port.n_live(), port.seqno
    with pytest.raises(UnknownAttribute, match="unknown"):
        port.insert(vecs, attrs={"color": np.zeros(4, np.int32)})
    with pytest.raises(AttributeMismatch):
        port.insert(vecs, attrs={"cat": np.zeros(3, np.int32)})
    assert (port.n_live(), port.seqno) == (n0, s0)
    port.insert(vecs)
    with pytest.raises(FilterError, match="freshly built"):
        port.set_attributes(ds.attrs)
