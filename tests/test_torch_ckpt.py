"""Index checkpoints of the port (``repro_torch.ckpt``) against the JAX
package's (``repro.ckpt``) on the CPU.

The two packages write the same files: the port's msgpack codec encodes
as ``msgpack.packb(use_bin_type=True)`` does, and its raw checkpoints are
byte-equal to the reference's written without ``zstandard``.  Every
read-only backend's index crosses both ways (the reference's ``save_index``
with zstd and without into the port's ``load_index``, the port's into the
reference's) and searches to identical ids.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import repro.ckpt.checkpoint as jax_checkpoint  # noqa: E402
from repro import ckpt as jax_ckpt  # noqa: E402
from repro.anns import SearchParams as JaxParams  # noqa: E402
from repro.anns import make_dataset as jax_make_dataset  # noqa: E402
from repro.anns import registry as jax_registry  # noqa: E402
from repro.anns.engine import VariantConfig as JaxVariant  # noqa: E402
from repro_torch import ckpt  # noqa: E402
from repro_torch.anns import SearchParams  # noqa: E402
from repro_torch.anns.engine import VariantConfig, family_baseline  # noqa: E402
from repro_torch.ckpt import _msgpack  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

N_BASE, N_QUERY = 800, 32
DTYPES = ["float32", "int32", "int8", "int64", "uint8", "bool", "float64"]


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------
def _frames(keys, shapes, dtypes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for key, shape, dt in zip(keys, shapes, dtypes):
        arr = (rng.standard_normal(shape) * 100).astype(dt)
        out.append({"key": key, "bounds": [[0, s] for s in arr.shape],
                    "data": arr.tobytes()})
    return out


@settings(max_examples=40, deadline=None)
@given(keys=st.lists(st.text(min_size=0, max_size=300), min_size=0,
                     max_size=20),
       shapes=st.lists(st.lists(st.integers(0, 70), max_size=3), min_size=20,
                       max_size=20),
       dtypes=st.lists(st.sampled_from(DTYPES), min_size=20, max_size=20),
       seed=st.integers(0, 2**16))
def test_msgpack_frames_byte_equal_to_msgpack(keys, shapes, dtypes, seed):
    """Frames of any keys (fixstr to str16), shapes and dtypes (bin8 to
    bin32 sizes, fixarray to array16 counts) encode to msgpack's bytes and
    decode back."""
    frames = _frames(keys, shapes, dtypes, seed)
    want = msgpack.packb(frames, use_bin_type=True)
    assert _msgpack.packb(frames) == want
    got = _msgpack.unpackb(want)
    assert [{**f, "data": bytes(f["data"])} for f in got] == frames


@pytest.mark.parametrize("value", [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    "", "a" * 31, "a" * 32, "é" * 200, "x" * 70000,
    b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536,
    list(range(15)), list(range(16)), list(range(70000)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)}])
def test_msgpack_formats_at_their_edges(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert _msgpack.packb(value) == want
    got = _msgpack.unpackb(want)
    assert (bytes(got) if isinstance(value, bytes) else got) == value


def test_msgpack_refuses_what_checkpoints_never_hold():
    for value in (1.5, None, True, {"x": [False]}):
        with pytest.raises(TypeError):
            _msgpack.packb(value)
        with pytest.raises(ValueError, match="unsupported"):
            _msgpack.unpackb(msgpack.packb(value))
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(msgpack.packb(1) + b"\x01")
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(msgpack.packb(b"abc", use_bin_type=True)[:-1])


# ---------------------------------------------------------------------------
# raw checkpoints: the same bytes as the reference's without zstandard
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_raw_checkpoint_byte_equal_to_the_reference(tmp_path, monkeypatch,
                                                    seed):
    monkeypatch.setattr(jax_checkpoint, "zstd", None)
    rng = np.random.default_rng(seed)
    tree = {f"leaf{j}/{'x' * j}": (rng.standard_normal((j, 3 + seed)) * 9)
            .astype(DTYPES[j % len(DTYPES)]) for j in range(9)}
    tree["shard0/zero_d"] = np.asarray(7, np.int64)
    extra = {"anns_index_meta": {"backend": "ivf", "n": seed}}
    jax_checkpoint.save_checkpoint(str(tmp_path / "ref"), tree, 3, extra)
    # the port takes tensors and arrays alike
    mixed = {k: torch.from_numpy(np.array(v)) if j % 2 else v
             for j, (k, v) in enumerate(tree.items())}
    ckpt.save_checkpoint(str(tmp_path / "port"), mixed, 3, extra)
    for name in ("shard_0.bin", "manifest.json"):
        assert (tmp_path / "ref" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes()
    assert not (tmp_path / "port.tmp").exists()
    arrays, step, got_extra = ckpt.load_checkpoint(str(tmp_path / "ref"))
    assert step == 3 and got_extra == extra
    for k, v in tree.items():
        np.testing.assert_array_equal(arrays[k], v)
        assert arrays[k].dtype == v.dtype


def test_load_checkpoint_like_tree_gives_tensors(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.arange(4, dtype=np.int32)}
    ckpt.save_checkpoint(str(tmp_path / "c"), tree, 0)
    like = {"a": torch.zeros(2, 3, dtype=torch.float64),
            "b": np.zeros(4, np.int64)}
    out, _, _ = ckpt.load_checkpoint(str(tmp_path / "c"), like)
    assert out["a"].dtype == torch.float64 and out["b"].dtype == np.int64
    np.testing.assert_array_equal(out["a"].numpy(), tree["a"])
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_checkpoint(str(tmp_path / "c"), {"a": torch.zeros(3, 2)})
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.load_checkpoint(str(tmp_path / "c"), {"z": torch.zeros(1)})


def test_a_zstd_checkpoint_without_zstandard_names_it(tmp_path, monkeypatch):
    pytest.importorskip("zstandard")
    jax_checkpoint.save_checkpoint(str(tmp_path / "z"),
                                   {"a": np.ones(3, np.float32)}, 0)
    manifest = json.loads((tmp_path / "z" / "manifest.json").read_text())
    assert manifest["compression"] == "zstd"
    arrays, _, _ = ckpt.load_checkpoint(str(tmp_path / "z"))
    np.testing.assert_array_equal(arrays["a"], np.ones(3, np.float32))
    monkeypatch.setitem(__import__("sys").modules, "zstandard", None)
    with pytest.raises(ModuleNotFoundError, match="zstandard"):
        ckpt.load_checkpoint(str(tmp_path / "z"))


# ---------------------------------------------------------------------------
# index checkpoints, both ways, every read-only backend
# ---------------------------------------------------------------------------
def _jax_variant(v):
    return JaxVariant(**dataclasses.asdict(v))


@pytest.fixture(scope="module")
def ds():
    return jax_make_dataset("sift-128-euclidean", n_base=N_BASE,
                            n_query=N_QUERY, seed=2)


_BUILT = {}


def _reference(ds, name):
    """The reference's backend ``name`` built once (sharded: 3 shards)."""
    if name not in _BUILT:
        v = family_baseline(name)
        if name == "sharded":
            v = dataclasses.replace(v, n_shards=3, nlist=16)
        ref = jax_registry.create(name, _jax_variant(v), metric=ds.metric,
                                  seed=2)
        ref.build(ds.base)
        ref.set_attributes(ds.attrs)
        _BUILT[name] = ref
    return _BUILT[name]


def _v1(state, ref):
    """The reference's sharded v1 snapshot: a replicated ``base`` and no
    ``shardN/base_f`` leaves or ``state_format``."""
    v1 = {k: v for k, v in state.items()
          if not k.endswith("/base_f") and k != "state_format"}
    vb = np.asarray(state["vec_bounds"])
    v1["base"] = np.concatenate([np.asarray(ref.index.base_f[j])[: vb[j + 1] - vb[j]]
                                 for j in range(len(vb) - 1)])
    return v1


def _v2(state):
    return {**state, "state_format": 2}


def _ids(backend, queries, params):
    ids = backend.search(queries, params).ids
    return ids.numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)


CASES = ["graph", "brute_force", "quantized_prefilter", "ivf", "sharded-v1",
         "sharded-v2", "sharded-v3"]


def _saved_by_reference(tmp_path, ds, case, zstd):
    """The reference's save_index of ``case`` in ``tmp_path/ref``, with
    zstd frames or raw ones; sharded v1 / v2 are written from the
    reference's v3 snapshot reshaped, as its older writers left them."""
    name = case.split("-")[0]
    ref = _reference(ds, name)
    path = str(tmp_path / "ref")
    old = jax_checkpoint.zstd
    if not zstd:
        jax_checkpoint.zstd = None
    try:
        if case in ("sharded-v1", "sharded-v2"):
            state = ref.to_state_dict()
            state = _v1(state, ref) if case == "sharded-v1" else _v2(state)
            arrays = {k: v for k, v in state.items()
                      if isinstance(v, np.ndarray)}
            meta = {k: v for k, v in state.items()
                    if not isinstance(v, np.ndarray)}
            meta["variant"] = dataclasses.asdict(ref.variant)
            jax_checkpoint.save_checkpoint(
                path, arrays, 0, extra={"anns_index_meta": meta})
        else:
            jax_ckpt.save_index(path, ref)
    finally:
        jax_checkpoint.zstd = old
    return ref, path


@pytest.mark.parametrize("zstd", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_reference_index_loads_into_the_port(tmp_path, ds, case, zstd):
    if zstd:
        pytest.importorskip("zstandard")
    ref, path = _saved_by_reference(tmp_path, ds, case, zstd)
    port = ckpt.load_index(path, device="cpu")
    assert port.name == ref.name and port.device.type == "cpu"
    assert port.variant == VariantConfig(**dataclasses.asdict(ref.variant))
    for ef in (16, 64, 256):
        np.testing.assert_array_equal(
            _ids(port, ds.queries, SearchParams(k=10, ef=ef)),
            _ids(ref, ds.queries, JaxParams(k=10, ef=ef)))
    if ref.attributes is not None:
        assert sorted(port.attributes) == sorted(ref.attributes)


@pytest.mark.parametrize("case", ["graph", "brute_force",
                                  "quantized_prefilter", "ivf", "sharded-v3"])
def test_port_index_loads_into_the_reference(tmp_path, ds, case):
    ref, path = _saved_by_reference(tmp_path, ds, case, zstd=False)
    port = ckpt.load_index(path, device="cpu")
    ckpt.save_index(str(tmp_path / "port"), port)
    # the port's raw checkpoint is the reference's raw one, byte for byte
    for name in ("shard_0.bin", "manifest.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
    back = jax_ckpt.load_index(str(tmp_path / "port"))
    assert back.name == ref.name
    for ef in (16, 64):
        np.testing.assert_array_equal(
            _ids(back, ds.queries, JaxParams(k=10, ef=ef)),
            _ids(ref, ds.queries, JaxParams(k=10, ef=ef)))


def test_load_index_restores_the_saved_variant_and_takes_an_override(tmp_path,
                                                                     ds):
    ref, path = _saved_by_reference(tmp_path, ds, "ivf", zstd=False)
    port = ckpt.load_index(path, device="cpu")
    assert port.variant.nprobe == ref.variant.nprobe
    override = dataclasses.replace(port.variant, nprobe=2)
    again = ckpt.load_index(path, override, device="cpu")
    assert again.variant.nprobe == 2


def test_load_index_refuses_a_future_state_format(tmp_path, ds):
    ref, path = _saved_by_reference(tmp_path, ds, "ivf", zstd=False)
    mpath = os.path.join(path, "manifest.json")
    manifest = json.loads(open(mpath).read())
    manifest["extra"]["anns_index_meta"]["state_format"] = 99
    open(mpath, "w").write(json.dumps(manifest))
    with pytest.raises(ckpt.ArtifactFormatError, match="newer") as e:
        ckpt.load_index(path, device="cpu")
    assert (e.value.found, e.value.supported) == (99, 2)
    assert isinstance(e.value, ValueError)


def test_load_index_refuses_streaming_deltas(tmp_path, ds):
    """Deltas replay only onto a streaming base (``test_torch_stream.py``
    holds the replay itself): a read-only backend's directory holding a
    delta is refused, as is a ``delta_*`` directory that is no delta."""
    _, path = _saved_by_reference(tmp_path, ds, "brute_force", zstd=False)
    sub = os.path.join(path, "delta_000000000003")
    jax_checkpoint.save_checkpoint(
        sub, {"tail": np.zeros(2, np.float32)}, 3,
        extra={"anns_index_delta_meta": {"seqno": 3, "delta_format": 1}})
    with pytest.raises(ValueError, match="streaming backend"):
        ckpt.load_index(path, device="cpu")
    jax_checkpoint.save_checkpoint(sub, {"tail": np.zeros(2, np.float32)}, 3)
    with pytest.raises(KeyError, match="not an index delta"):
        ckpt.load_index(path, device="cpu")


def test_load_index_refuses_a_non_index_checkpoint(tmp_path):
    ckpt.save_checkpoint(str(tmp_path / "c"), {"a": np.zeros(1)}, 0)
    with pytest.raises(KeyError, match="not an index checkpoint"):
        ckpt.load_index(str(tmp_path / "c"), device="cpu")


def test_versioning_is_the_reference_s():
    from repro.ckpt import versioning as jax_versioning
    from repro_torch.ckpt import versioning
    for found, sup in [(None, 1), (1, 2), (2, 2)]:
        versioning.check_artifact_format("state", found, sup)
    for mod in (versioning, jax_versioning):
        with pytest.raises(mod.ArtifactFormatError) as e:
            mod.check_artifact_format("frontier", 3, 2, what="w", hint="h")
        assert str(e.value) == "w is in frontier format 3, newer than the " \
            "supported 2 — h"
    for args in [(None, 3), (3, None), (2, 2), (1, 2), (4, 2), (2, 5)]:
        outs = []
        for mod in (versioning, jax_versioning):
            try:
                outs.append(mod.check_artifact_age("frontier", *args,
                                                   max_age=1))
            except mod.StaleArtifactError as err:
                outs.append((str(err), err.found_epoch, err.current_epoch))
        assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# serve --save-index / --load-index on the CPU
# ---------------------------------------------------------------------------
def test_serve_save_then_load_index_gives_the_same_recall(tmp_path, capsys):
    common = ["--backend", "ivf", "--nlist", "16", "--n-base", "600",
              "--n-query", "16", "--n-requests", "32", "--device", "cpu"]
    path = str(tmp_path / "idx")
    built = serve.main([*common, "--save-index", path])
    out = capsys.readouterr().out
    assert "index state checkpointed" in out
    loaded = serve.main([*common, "--load-index", path, "--n-shards", "2"])
    out = capsys.readouterr().out
    assert "restored 'ivf' index" in out and "no rebuild" in out
    assert "has no shard axis" in out
    assert loaded == built
    # the reference serves the port's checkpoint to the same recall
    back = jax_ckpt.load_index(path)
    assert back.name == "ivf"


@pytest.mark.parametrize("target,n_shards", [
    ("ivf", None), ("ivf", 2), ("sharded-3", 3), ("sharded-3", 2),
    ("graph", 4), ("none", 2)])
def test_shard_conflict_note_matches_the_reference(ds, target, n_shards):
    from repro.launch.serve import _shard_conflict_note as jax_note

    class Bare:                       # a backend with no index attribute
        name = "bare"
    if target == "none":
        t = Bare()
    else:
        t = _reference(ds, "sharded" if target.startswith("sharded")
                       else target)
    assert serve._shard_conflict_note(t, n_shards) == jax_note(t, n_shards)
