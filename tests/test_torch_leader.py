"""The leader / follower op stream (``repro_torch.dist.leader``): the async
tier, the background compactor and in-run SLO picks over an index placed
across two Gloo CPU ranks, one rank a shard.

Rank 0 serves through a ``Leader`` and rank 1 replays its records
(``follow``).  The oracle is the one ``tests/test_torch_mesh_search.py``
uses: the JAX package's single-device ``ShardedBackend`` (its mesh-placed
search does not run under this JAX), and the port's unplaced backend
replaying rank 0's op log bit for bit.  The ranks
(``tests/_torch_leader_ranks.py``) import only ``repro_torch`` and are
spawned through ``tests/test_torch_dist.py``'s harness; the serve CLI
starts its own group from ``torchrun``'s environment.
"""
import dataclasses
import multiprocessing
import pickle
import re
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_ranks as ranks  # noqa: E402
import _torch_leader_ranks as lranks  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from repro.anns import SearchParams as JaxParams  # noqa: E402
from repro.anns import registry as jax_registry  # noqa: E402
from repro.anns.engine import VariantConfig as JaxVariant  # noqa: E402
from repro_torch.anns import SearchParams, registry  # noqa: E402
from repro_torch.anns.bench import measure_point  # noqa: E402
from repro_torch.anns.datasets import (Dataset, DatasetSpec,  # noqa: E402
                                       exact_ground_truth)
from repro_torch.anns.filters import FilterPredicate  # noqa: E402
from repro_torch.anns.tune import sweep_frontier  # noqa: E402
from repro_torch.dist import leader  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from test_torch_dist import _spawn  # noqa: E402
from test_torch_mesh_search import (_blobs, _fields, _free_port,  # noqa: E402
                                    _variant)

K = 10
N, D = 2000, 32
MAX_BATCH = 16
BURST = {"tenants": "gold:0.99:3,bronze:0.6:1", "max_batch": MAX_BATCH,
         "max_queue": 32, "queries": 64, "inserts": 150, "tail_cap": 128}
#: each spawn's deadline, well inside _torch_dist_ranks.TIMEOUT_S
DEADLINE_S = 120


def _read(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# the record codec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("params", [
    SearchParams(k=K, ef=64),
    SearchParams(k=3, ef=1024, target_recall=0.95, rerank_factor=4,
                 quantized=False, gather_width=2, patience=1),
    SearchParams(k=K, ef=16, filter=FilterPredicate("cat", (0, 3)))],
    ids=["plain", "knobs", "filter"])
def test_a_search_record_round_trips(params):
    q = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    op, got, arrays, text = leader.decode(*leader.encode("search", params,
                                                          (q,)))
    assert (op, got, text) == ("search", params, "")
    np.testing.assert_array_equal(arrays[0], q)
    assert arrays[1:] == [None] * (leader.MAX_ARRAYS - 1)


def test_an_insert_record_round_trips():
    vecs = np.ones((3, 4), np.float32)
    arrays, names = leader._insert_args(vecs, [7, 8, 9],
                                        {"cat": [1, 2, 3], "tag": [0, 0, 5]})
    op, params, got, text = leader.decode(*leader.encode("insert", None,
                                                          arrays, names))
    kw = leader._insert_kwargs(got, text)
    assert (op, params) == ("insert", None)
    np.testing.assert_array_equal(kw["vectors"], vecs)
    assert kw["ids"].tolist() == [7, 8, 9]
    assert {c: v.tolist() for c, v in kw["attrs"].items()} == {
        "cat": [1, 2, 3], "tag": [0, 0, 5]}


def test_an_unfiltered_search_moves_the_header_and_its_queries():
    """The closed form chip_smoke holds the op stream's bytes to."""
    h, payload = leader.encode("search", SearchParams(k=K, ef=64),
                               (np.zeros((64, 128), np.float32),))
    assert h.nbytes + len(payload) == leader.HEADER_BYTES + 64 * 128 * 4


def test_records_are_sent_in_the_order_their_calls_take_effect(
        tmp_path, monkeypatch):
    """8 threads search and insert through one Leader (a world of one, a
    backend that logs its calls, a short switch interval): the records
    go out in the order in which the backend sees the calls."""
    import sys
    import threading

    import torch.distributed as dist

    from repro_torch.anns import SearchResult
    from repro_torch.launch import mesh as port_mesh
    calls = []

    class Logged:                # each call yields the GIL first
        def search(self, queries, params):
            time.sleep(1e-4)
            calls.append(("search", float(np.asarray(queries)[0, 0])))
            z = torch.zeros((len(queries), 1))
            return SearchResult(ids=z.int(), dists=z)

        def insert(self, vectors, ids=None, attrs=None):
            time.sleep(1e-4)
            calls.append(("insert", float(vectors[0, 0])))

    def work(lead, t):
        for i in range(50):
            v = np.full((2, 4), t * 1000 + i, np.float32)
            if i % 2:
                lead.insert(v)
            else:
                lead.search(v, SearchParams())

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    port_mesh.init_distributed("cpu", init_method=f"file://{tmp_path}/s",
                               timeout_s=30)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        lead = leader.Leader(Logged())
        send, sent = lead._stream.send, []

        def logged_send(h, payload):
            op, _, arrays, _ = leader.decode(h, payload)
            if op != "stop":
                sent.append((op, float(arrays[0][0, 0])))
            send(h, payload)

        lead._stream.send = logged_send
        threads = [threading.Thread(target=work, args=(lead, t))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert lead.stop() == [[400, 0, -1, -1]]
    finally:
        sys.setswitchinterval(interval)
        dist.destroy_process_group()
    assert sent == calls and len(calls) == 400


# ---------------------------------------------------------------------------
# (a) one tenant over a placed sharded index, (b) the multi-tenant burst
# over a placed stream_sharded index with a background compaction; one
# spawned group
# ---------------------------------------------------------------------------
def _blob_ds(x, q) -> Dataset:
    return Dataset(spec=DatasetSpec("blobs", x.shape[1], "l2", 0.0, 8),
                   base=x, queries=q,
                   gt=exact_ground_truth(x, q, K, "l2", device="cpu"),
                   k_gt=K, device="cpu")


def _frontier(backend, ds):
    """The backend's frontier with real recall and a QPS that falls with ef
    (1e5 / ef), so the tenants' picks do not hang on timing."""
    def measure(target, ds_, params, repeats, build_seconds):
        p = measure_point(target, ds_, params=params, repeats=1)
        return dataclasses.replace(p, qps=1e5 / params.ef)
    return sweep_frontier(ds, backends=(), targets=[backend], k=K,
                          repeats=1, measure_fn=measure)


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("leader")
    x = _blobs(5, N, D)
    # (a): the reference's state, its single-device ids per query
    q = (x[:48] + 0.05).astype(np.float32)
    variant = _variant(2)
    ref = jax_registry.create("sharded", JaxVariant(**_fields(variant)),
                              seed=1)
    ref.build(x)
    single = {"state": ref.to_state_dict(), "variant": _fields(variant),
              "queries": q, "params": SearchParams(k=K, ef=64),
              "max_batch": MAX_BATCH}
    ref_ids = np.asarray(ref.search(q, JaxParams(k=K, ef=64)).ids)
    # (b): the port's stream_sharded, its frontier, the episode's history
    svariant = dataclasses.replace(_variant(2, "stream_sharded"),
                                   tail_cap=BURST["tail_cap"])
    sb = registry.create("stream_sharded", svariant, seed=1, device="cpu")
    sb.build(x)
    rng = np.random.default_rng(2)
    bq = (x[rng.integers(0, N, BURST["queries"])]
          + 0.05 * rng.standard_normal((BURST["queries"], D))
          ).astype(np.float32)
    dels = rng.choice(N, 120, replace=False)
    burst = {"state": sb.to_state_dict(), "variant": _fields(svariant),
             "frontier": _frontier(sb, _blob_ds(x, bq)), "queries": bq,
             "inserts": (x[rng.integers(0, N, BURST["inserts"])]
                         + 0.3 * rng.standard_normal((BURST["inserts"], D))
                         ).astype(np.float32),
             "dels_before": dels[:60], "dels_during": dels[60:],
             **{k: BURST[k] for k in ("tenants", "max_batch", "max_queue")}}
    out = str(tmp / "ep_{rank}.pkl")
    _spawn(tmp, 2, lranks.episodes_rank, single, burst, out)
    got = {f"{e}{r}": _read(out.format(rank=f"{e}{r}"))
           for e in "ab" for r in range(2)}
    return single, burst, ref_ids, got


def _replayed(job, log):
    twin = lranks._backend(job["state"], job["variant"])
    return twin, leader.replay(log, twin)


def _assert_replay_equal(log, results):
    searches = [e for e in log if e["op"] == "search"]
    assert len(searches) == len(results) > 0
    for i, (e, r) in enumerate(zip(searches, results)):
        np.testing.assert_array_equal(e["ids"], r.ids.numpy(), f"batch {i}")
        np.testing.assert_array_equal(e["dists"], r.dists.numpy(),
                                      f"batch {i}")


def test_async_ids_are_the_references(episodes):
    """Each request served by the async tier over the placed index has the
    reference's single-device ids for its query."""
    single, _, ref_ids, got = episodes
    ep = got["a0"]["episode"]
    np.testing.assert_array_equal(ep["ids"], ref_ids)
    assert ep["batches"] == len(single["queries"]) // MAX_BATCH


def test_async_replay_is_bit_equal(episodes):
    """The op log replayed on the unplaced backend gives every batch's ids
    and dists bit for bit; both ranks replayed every record."""
    single, _, _, got = episodes
    _, results = _replayed(single, got["a0"]["log"])
    _assert_replay_equal(got["a0"]["log"], results)
    assert got["a0"]["tallies"] == got["a1"]["tallies"]
    assert got["a0"]["tallies"][0][:2] == [len(got["a0"]["log"]), 0]


def test_burst_admission_and_accounting(episodes):
    _, burst, _, got = episodes
    ep = got["b0"]["episode"]
    q = burst["max_queue"]
    assert (ep["admitted"], ep["shed"]) == (q, 2 * q)
    assert ep["accounted"] and ep["shed_closed"] == 0
    W = q // 2
    assert ep["served"] == q + 2 * (len(burst["queries"]) + W)
    assert ep["verdicts"] == ["tail_frac"] and ep["runs"] == 1


def test_burst_replay_is_bit_equal_across_the_swap(episodes):
    """Replaying the log (the compaction's prepare, the journaled delete
    and the commit at their points) gives every batch bit for bit, before,
    during and after the swap."""
    _, burst, _, got = episodes
    log = got["b0"]["log"]
    ops = [e["op"] for e in log]
    p, c = ops.index("prepare"), ops.index("commit")
    assert "search" in ops[:p] and "search" in ops[c:]
    assert ops[p:c].count("delete") == 1 and ops.count("compact") == 0
    _, results = _replayed(burst, log)
    _assert_replay_equal(log, results)


def test_ranks_end_at_one_epoch_and_seqno(episodes):
    _, _, _, got = episodes
    t0, t1 = got["b0"]["tallies"], got["b1"]["tallies"]
    assert t0 == t1 and t0[0] == t0[1]
    assert got["b0"]["state"] == got["b1"]["state"]
    assert got["b0"]["state"][0] == 1      # one compaction committed


def test_compacted_layout_is_the_unplaced_ones(episodes):
    """Each rank's shard of the compacted layout is the replayed unplaced
    backend's."""
    _, burst, _, got = episodes
    twin, _ = _replayed(burst, got["b0"]["log"])
    assert (twin.epoch, twin.seqno) == got["b0"]["state"]
    for r in range(2):
        lay = got[f"b{r}"]["layout"]
        j = lay["shard"]
        np.testing.assert_array_equal(lay["ids"], twin.index.ids.numpy())
        np.testing.assert_array_equal(lay["base_q"],
                                      twin.index.base_q[j].numpy())
        np.testing.assert_array_equal(lay["cells"],
                                      twin.index.cells[j].numpy())


def test_no_deleted_id_is_served(episodes):
    _, _, _, got = episodes
    dead, seen = set(), 0
    for e in got["b0"]["log"]:
        if e["op"] == "delete":
            dead |= set(e["arrays"][0].tolist())
        elif e["op"] == "search" and dead:
            assert dead.isdisjoint(e["ids"].ravel().tolist())
            seen += 1
    assert len(dead) == 120 and seen > 0


# ---------------------------------------------------------------------------
# (c) the serve CLI under two ranks
# ---------------------------------------------------------------------------
CLI = ["--backend", "stream_sharded", "--n-shards", "2", "--nlist", "16",
       "--n-base", "2000", "--n-query", "64", "--k", "10", "--tail-cap",
       "256", "--device", "cpu"]


def _cli_runs(frontier: str) -> list:
    return [
        [*CLI, "--tune", "--tune-ef-cap", "64", "--target-recall", "0.9",
         "--save-frontier", frontier, "--n-requests", "96"],
        [*CLI, "--load-frontier", frontier, "--async", "--tenants",
         "strict:0.995:4,lax:0.5", "--max-queue", "32", "--max-batch", "16"],
        [*CLI, "--load-frontier", frontier, "--target-recall", "0.8",
         "--drift-retune", "0.1", "--max-tail-frac", "0.1", "--max-batch",
         "32", "--stream-demo", "300"],
        ["--backend", "sharded", "--n-shards", "2", "--nlist", "16",
         "--n-base", "2000", "--n-query", "64", "--async", "--n-requests",
         "96", "--max-batch", "16", "--device", "cpu"],
    ]


def _one_process(argv) -> str:
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("leader_cli")
    runs = _cli_runs(str(tmp / "frontier.json"))
    out = str(tmp / "serve_{rank}_{run}.txt")
    ports = [_free_port() for _ in runs]
    ctx = mp.start_processes(lranks.serve_runs,
                             args=(2, ports, runs, out), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("serve ranks still running at the deadline")
    got = [[open(out.format(rank=r, run=i)).read() for i in range(len(runs))]
           for r in range(2)]
    return runs, got


_TIMING = re.compile(r"(lat=|p50=|p99=|p95=|qps=|in )[0-9.,na/]+(ms|s)?")


def _lines(out: str, prefix: str) -> list:
    return [_TIMING.sub(r"\1*", ln) for ln in out.splitlines()
            if ln.startswith(prefix)]


def test_cli_slo_pick_serves_its_swept_recall(cli):
    """``--tune --target-recall 0.9``: rank 0 sweeps through the leader,
    picks from its own timings and serves within 0.02 of the pick's swept
    recall."""
    _, got = cli
    out = got[0][0]
    assert "placed 2 cell shards on 2 devices" in out, out
    swept = float(re.search(r"slo pick .* \(swept recall=([0-9.]+)",
                            out).group(1))
    served = float(re.search(r"^recall@10=([0-9.]+)", out, re.M).group(1))
    assert abs(served - swept) <= 0.02, out


def test_cli_async_tenants_match_one_process(cli):
    """``--async --tenants``: the same picks, admission and shed counts and
    per-tenant recalls as one process serving the unplaced index."""
    runs, got = cli
    out = got[0][1]
    assert "serve: overload burst admitted=32 shed=64" in out, out
    assert "serve: accounting ok" in out and "serve: episode ok" in out
    keep = ("serve: tenant", "serve: overload", "serve: accounting",
            "serve: episode", "serve: closed served")

    def det(text):
        return [re.sub(r" depth_max=\d+ batches=\d+", "", ln)
                for ln in _lines(text, "serve:") if ln.startswith(keep)]

    assert det(out) == det(_one_process(runs[1]))


def test_cli_stream_demo_verdicts_match_one_process(cli):
    """``--stream-demo``: the drift episode's lines up to the re-sweep
    (whose pick weighs measured QPS) are one process's, the background
    compaction included."""
    runs, got = cli
    out = got[0][2]
    assert "-> tail_frac" in out and "drift: compacted -> epoch 1" in out

    def det(text):
        return [ln for ln in _lines(text, "drift:")
                if not ln.startswith(("drift: retune", "drift: post-retune",
                                      "drift: served during"))]

    assert det(out) == det(_one_process(runs[2]))


def test_cli_async_one_tenant_matches_one_process(cli):
    """``--async`` without tenants over a placed read-only ``sharded``
    index: the recall of one process serving it unplaced."""
    runs, got = cli
    out = got[0][3]
    assert "serve: async served 96 requests" in out, out
    assert (_lines(out, "recall@10=")[0].split()[0]
            == _lines(_one_process(runs[3]), "recall@10=")[0].split()[0])


def test_cli_followers_print_nothing(cli):
    _, got = cli
    assert got[1] == [""] * len(got[1])


# ---------------------------------------------------------------------------
# (d) a failure on the leader ends every rank
# ---------------------------------------------------------------------------
def test_leader_failure_ends_every_rank(tmp_path):
    """Rank 0 raises mid-episode: its abort record makes rank 1 raise with
    rank 0's message, and both exit non-zero long before the group's
    timeout."""
    x = _blobs(9, N, D)
    variant = _variant(2)
    b = registry.create("sharded", variant, seed=1, device="cpu")
    b.build(x)
    args_file = tmp_path / "args.pkl"
    out = str(tmp_path / "rank_{rank}.txt")
    args_file.write_bytes(pickle.dumps(
        (b.to_state_dict(), _fields(variant), x[:8], out)))
    spawn = multiprocessing.get_context("spawn")
    procs = [spawn.Process(target=ranks.entry, args=(
        r, lranks.failing_rank, 2, str(tmp_path / "store"), str(args_file)))
        for r in range(2)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    for p in procs:
        p.join(DEADLINE_S)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        p.kill()
    assert not any(alive), "ranks still running at the deadline"
    assert time.monotonic() - t0 < leader.SERVE_TIMEOUT_S
    assert all(p.exitcode != 0 for p in procs)
    msgs = [open(out.format(rank=r)).read() for r in range(2)]
    assert msgs[0] == "RuntimeError: boom: the leader failed mid-episode"
    assert msgs[1].startswith("LeaderAborted: rank 0 aborted the op stream: "
                              "RuntimeError: boom"), msgs[1]
