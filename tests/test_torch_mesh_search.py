"""The sharded ANN search placed across processes (``place_on_mesh`` of
``repro_torch.anns.ivf.sharding``, ``ShardedBackend`` and
``StreamingShardedBackend``, ``placed_stream_search``, the serve
CLI under a process group) on Gloo CPU ranks, one rank a shard.

The reference's mesh-placed search runs on forced host devices, which
this JAX does not give its multi-device tests (``tests/test_dist_train.py``
fails at the seed); its placed ids are its single-device ids
(``tests/test_sharded.py``), so the oracle here is its single-device
``ShardedBackend``.  The ranks (``tests/_torch_mesh_ranks.py``) import
only ``repro_torch``, spawned through ``tests/test_torch_dist.py``'s
harness.
"""
import dataclasses
import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as mranks  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from repro.anns import SearchParams as JaxParams  # noqa: E402
from repro.anns import registry as jax_registry  # noqa: E402
from repro.anns.engine import VariantConfig as JaxVariant  # noqa: E402
from repro.anns.filters import FilterPredicate as JaxPredicate  # noqa: E402
from repro_torch.anns import registry  # noqa: E402
from repro_torch.anns.engine import SHARDED_BASELINE  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from test_torch_dist import _spawn  # noqa: E402

K = 10
NLIST = 16
#: (ef, extra) of each search case; the last is the all-cells probe
CASES = [{"ef": 16}, {"ef": 64}, {"ef": 64, "filter": ("cat", (0, 3))},
         {"ef": 64 * NLIST, "rerank_factor": 4}]


def _fields(v) -> dict:
    return {f.name: getattr(v, f.name) for f in dataclasses.fields(v)}


def _blobs(seed: int, n: int, d: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, d)).astype(np.float32) * 2.5
    return (centers[rng.integers(0, 8, size=n)]
            + rng.standard_normal((n, d)).astype(np.float32))


def _variant(n_shards: int, backend: str = "sharded"):
    return dataclasses.replace(SHARDED_BASELINE, backend=backend,
                               nlist=NLIST, nprobe=4, kmeans_iters=2,
                               n_shards=n_shards)


def _ref_case(case: dict) -> JaxParams:
    case = dict(case)
    if "filter" in case:
        case["filter"] = JaxPredicate(*case["filter"])
    return JaxParams(k=K, **case)


def _merge_bytes(world: int, B: int, m_shard: int, cap: int = 0) -> int:
    """int32 positions, scan and rerank dists, a 1-byte validity, (stream)
    the fp32 tail dists, and the int64 scanned count."""
    return world * B * (m_shard * 13 + cap * 4) + 8


# ---------------------------------------------------------------------------
# the read-only sharded backend
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[2, 4])
def placed(request, tmp_path_factory):
    """One spawned group of ``world`` ranks: for l2 and ip, the
    reference's state at N 2,000 searched at every case, and the port's own
    index at N 4,000 (merge bytes only)."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"placed{world}")
    variant = _variant(world)
    jobs, refs = [], []
    for metric in ("l2", "ip"):
        x = _blobs(world, 2000, 32)
        q = (x[:24] + 0.05).astype(np.float32)
        ref = jax_registry.create("sharded", JaxVariant(**_fields(variant)),
                                  metric=metric, seed=1)
        ref.build(x)
        ref.set_attributes({"cat": np.arange(len(x)) % 6})
        refs.append([np.asarray(ref.search(q, _ref_case(c)).ids)
                     for c in CASES])
        jobs.append({"state": ref.to_state_dict(), "variant": _fields(variant),
                     "queries": q, "cases": [{"k": K, **c} for c in CASES]})
    big = registry.create("sharded", variant, metric="l2", seed=1,
                          device="cpu")
    big.build(_blobs(world + 1, 4000, 32))
    big.set_attributes({"cat": np.arange(4000) % 6})
    jobs.append({"state": big.to_state_dict(), "variant": _fields(variant),
                 "queries": jobs[0]["queries"],
                 "cases": [{"k": K, **c} for c in CASES]})
    out = str(tmp / "placed_{rank}.npz")
    _spawn(tmp, world, mranks.placed_sharded_rank, jobs, out)
    return world, refs, [dict(np.load(out.format(rank=r)))
                         for r in range(world)]


@pytest.mark.parametrize("metric_job", [0, 1], ids=["l2", "ip"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_placed_ids_are_the_references_and_dists_the_unplaced(
        placed, metric_job, case):
    """Every rank returns the reference's single-device ids (unfiltered,
    filtered, at the all-cells probe) and the port's unplaced search's
    dists and scanned count bit for bit."""
    world, refs, got = placed
    key = f"{metric_job}/{case}"
    for r in range(world):
        np.testing.assert_array_equal(got[r][f"{key}/ids"],
                                      refs[metric_job][case], err_msg=key)
        np.testing.assert_array_equal(got[r][f"{key}/ids"],
                                      got[r][f"{key}/plain_ids"])
        np.testing.assert_array_equal(got[r][f"{key}/dists"],
                                      got[r][f"{key}/plain_dists"])
        assert (int(got[r][f"{key}/expansions"])
                == int(got[r][f"{key}/plain_expansions"]))


def test_merge_bytes_do_not_depend_on_n(placed):
    """The counted bytes are the closed form at N 2,000 and 4,000 alike,
    and under N * d * 4 (a replicated fp32 base would be that)."""
    world, _, got = placed
    for case in range(len(CASES)):
        small = int(got[0][f"0/{case}/bytes"])
        large = int(got[0][f"2/{case}/bytes"])
        m_shard = int(got[0][f"0/{case}/m_shard"])
        assert m_shard == int(got[0][f"2/{case}/m_shard"])
        assert small == large == _merge_bytes(world, 24, m_shard), case
        assert small < 2000 * 32 * 4


def test_each_rank_holds_one_shard(placed):
    """Per-shard leaves are (1, ...), no (N, d) leaf, and the rank's bytes
    are device_memory_bytes(), which is the unplaced layout's per-device
    figure."""
    world, _, got = placed
    for r in range(world):
        for job in ("0", "1", "2"):
            assert list(got[r][f"{job}/leading"]) == [1] * 5
            assert not bool(got[r][f"{job}/nd_leaf"])
            assert (int(got[r][f"{job}/held"])
                    == int(got[r][f"{job}/device_bytes"]))


def test_place_on_mesh_refuses_a_world_of_another_size(tmp_path,
                                                       monkeypatch):
    """Two shards over a one-rank group: the shard mesh raises."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as port_mesh
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    port_mesh.init_distributed("cpu", init_method=f"file://{tmp_path}/s",
                               timeout_s=30)
    try:
        be = registry.create("sharded", _variant(2), device="cpu")
        be.build(_blobs(0, 300, 16))
        assert port_mesh.shard_mesh_if_available(2) is None
        with pytest.raises(ValueError, match="needs 2 ranks"):
            be.place_on_mesh(port_mesh.make_shard_mesh(2))
        from repro_torch.anns.ivf.sharding import place_on_mesh
        with pytest.raises(ValueError, match="one rank a shard"):
            place_on_mesh(be.index, port_mesh.make_shard_mesh(1))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the streaming sharded backend
# ---------------------------------------------------------------------------
def test_placed_stream_sharded_through_insert_delete_compact(tmp_path):
    """2 ranks: a placed and an unplaced stream_sharded from one state
    through 300 inserts, 400 deletes and a compaction return the same ids
    and dists at every stage; the view holds this rank's rows alone, the
    merge bytes are the closed form with the tail dists, the compacted
    layout is the unplaced one's, and the background compactor refuses
    the placed index."""
    world = 2
    x = _blobs(7, 2000, 32)
    variant = dataclasses.replace(_variant(world, "stream_sharded"),
                                  tail_cap=256)
    be = registry.create("stream_sharded", variant, seed=1, device="cpu")
    be.build(x)
    rng = np.random.default_rng(3)
    inserts = (x[rng.integers(0, 2000, 300)]
               + 0.3 * rng.standard_normal((300, 32))).astype(np.float32)
    deletes = rng.choice(2000, 400, replace=False)
    q = np.concatenate([x[:12], inserts[:12]]).astype(np.float32)
    cases = [{"k": K, "ef": 64}, {"k": K, "ef": 64 * NLIST,
                                  "rerank_factor": 4}]
    out = str(tmp_path / "stream_{rank}.npz")
    _spawn(tmp_path, world, mranks.placed_stream_rank, be.to_state_dict(),
           _fields(variant), q, inserts, deletes, cases, out)
    for r in range(world):
        got = np.load(out.format(rank=r))
        for stage in ("base", "insert", "delete", "compact"):
            for c in range(len(cases)):
                key = f"{stage}/{c}"
                np.testing.assert_array_equal(got[f"{key}/ids"],
                                              got[f"{key}/plain_ids"], key)
                np.testing.assert_array_equal(got[f"{key}/dists"],
                                              got[f"{key}/plain_dists"], key)
                assert int(got[f"{key}/bytes"]) == _merge_bytes(
                    world, len(q), int(got[f"{key}/m_shard"]),
                    int(got[f"{stage}/cap"])), key
            assert list(got[f"{stage}/view_rows"]) == [1, 1, 1]
            assert list(got[f"{stage}/leading"]) == [1] * 5
            assert not bool(got[f"{stage}/nd_leaf"])
        assert bool(got["compact/layout_equal"])
        assert bool(got["compactor_refused"])
        assert set(deletes.tolist()).isdisjoint(
            got["compact/1/ids"].ravel().tolist())


# ---------------------------------------------------------------------------
# the serve CLI under a process group
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_serve_places_the_shards_under_two_gloo_ranks(tmp_path):
    """``serve --backend sharded --n-shards 2`` in a group of 2: rank 0
    prints the ``placed 2 cell shards`` line and the served recall, which
    is the unplaced run's; rank 1 prints nothing."""
    argv = ["--backend", "sharded", "--n-shards", "2", "--nlist", "16",
            "--n-base", "1200", "--n-query", "24", "--n-requests", "48",
            "--device", "cpu"]
    out = str(tmp_path / "serve_{rank}.txt")
    ctx = mp.start_processes(mranks.serve_entry,
                             args=(2, _free_port(), argv, out), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + 150
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("serve ranks still running at the deadline")
    lines = open(out.format(rank=0)).read().splitlines()
    assert any(ln.startswith("placed 2 cell shards on 2 devices")
               for ln in lines), lines
    assert open(out.format(rank=1)).read() == ""
    rec = [ln for ln in lines if ln.startswith("recall@10=")]
    want = serve.main(argv)
    assert rec and rec[0].startswith(f"recall@10={want:.3f}")


@pytest.mark.parametrize("extra", [["--async"],
                                   ["--tune", "--target-recall", "0.9"]])
def test_serve_refuses_timing_driven_loops_under_a_group(monkeypatch,
                                                            capsys, extra):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit):
        serve.main(["--backend", "sharded", "--n-shards", "2", "--device",
                    "cpu", *extra])
    assert "ROADMAP" in capsys.readouterr().err
