"""The port stands alone: it imports with JAX and the reference package
blocked, names neither in its source, and never quietly runs on the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def _modules() -> list[str]:
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_with_jax_and_repro_blocked():
    mods = _modules()
    assert "repro_torch.anns.backends.brute_force" in mods
    assert "repro_torch.launch.train_crinn" in mods
    assert "repro_torch.kernels.flash.ops" in mods
    assert "repro_torch.anns.backends.sharded" in mods
    assert "repro_torch.anns.ivf.kmeans" in mods
    assert {"repro_torch.ckpt", "repro_torch.ckpt.index_io",
            "repro_torch.anns.tune"} <= set(mods)
    assert {"repro_torch.anns.stream", "repro_torch.anns.stream.backends",
            "repro_torch.anns.stream.compactor", "repro_torch.serve",
            "repro_torch.serve.scheduler"} <= set(mods)
    assert {"repro_torch.data", "repro_torch.data.tokens",
            "repro_torch.data.prompts", "repro_torch.optim.schedule",
            "repro_torch.optim.grad_compress", "repro_torch.runtime",
            "repro_torch.runtime.fault", "repro_torch.runtime.trainer",
            "repro_torch.ckpt.manager", "repro_torch.launch.train",
            "repro_torch.configs.glm4_9b", "repro_torch.configs.stablelm_1b6",
            "repro_torch.configs.h2o_danube_1b8",
            "repro_torch.configs.gemma2_27b"} <= set(mods)
    assert {"repro_torch.models.moe", "repro_torch.models.mamba",
            "repro_torch.models.rwkv", "repro_torch.models.frontend",
            "repro_torch.configs.musicgen_medium",
            "repro_torch.configs.internvl2_26b",
            "repro_torch.configs.deepseek_moe_16b",
            "repro_torch.configs.dbrx_132b",
            "repro_torch.configs.jamba_v01_52b",
            "repro_torch.configs.rwkv6_1b6"} <= set(mods)
    assert {"repro_torch.dist", "repro_torch.dist.sharding",
            "repro_torch.dist.comm", "repro_torch.dist.seq_decode",
            "repro_torch.dist.fsdp", "repro_torch.dist.leader",
            "repro_torch.launch.mesh", "repro_torch.trace"} <= set(mods)
    # the H100 machine has neither msgpack nor zstandard
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['zstandard'] = None\n"
        f"sys.path.insert(0, {str(SRC)!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.anns import registry\n"
        "for name in registry.available():\n"
        "    registry.get(name)\n"
        "assert not any(m in ('jax', 'msgpack', 'zstandard')\n"
        "               or m.startswith(('jax.', 'repro.', 'msgpack.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_streaming_deltas_and_the_serving_tier_run_with_jax_blocked(tmp_path):
    """A stream_ivf mutated, saved as base + delta and replayed, then served
    through the continuous batcher — with jax, the reference, msgpack and
    zstandard unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'repro', 'msgpack', 'zstandard'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(SRC)!r})\n"
        "import numpy as np\n"
        "from repro_torch import ckpt\n"
        "from repro_torch.anns import SearchParams, registry\n"
        "from repro_torch.anns.engine import VariantConfig\n"
        "from repro_torch.serve import (ContinuousBatcher, TenantSpec,\n"
        "                               resolve_tenants)\n"
        "x = np.random.default_rng(0).standard_normal((300, 16))\n"
        "x = x.astype(np.float32)\n"
        "v = VariantConfig(backend='stream_ivf', nlist=8, tail_cap=32)\n"
        "b = registry.create('stream_ivf', v, device='cpu')\n"
        "b.build(x[:280])\n"
        f"path = {str(tmp_path / 'idx')!r}\n"
        "ckpt.save_index(path, b)\n"
        "b.insert(x[280:])\n"
        "b.delete(np.arange(10))\n"
        "ckpt.save_index_delta(path, b)\n"
        "r = ckpt.load_index(path, device='cpu')\n"
        "assert r.n_live() == b.n_live() == 290\n"
        "t = resolve_tenants([TenantSpec('a')],\n"
        "                    default_params=SearchParams(k=5, ef=64))\n"
        "cb = ContinuousBatcher(r, t, max_batch=4)\n"
        "tk = [cb.submit(q, 'a') for q in x[285:290]]\n"
        "assert cb.drain() == 5\n"
        "assert [k.get().ids[0] for k in tk] == list(range(285, 290))\n"
        "assert not any(m in ('jax', 'msgpack', 'zstandard')\n"
        "               or m.startswith(('jax.', 'repro.', 'msgpack.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_training_resumes_with_jax_blocked(tmp_path):
    """launch.train on the CPU, then resumed from its bfloat16 checkpoint
    in a second run — with jax, the reference, msgpack, zstandard and
    ml_dtypes (numpy's bfloat16) unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'repro', 'msgpack', 'zstandard', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(SRC)!r})\n"
        "from repro_torch.launch import train\n"
        f"argv = ['--reduced', '--device', 'cpu', '--seq', '16',\n"
        f"        '--global-batch', '2', '--ckpt-dir', {str(tmp_path)!r}]\n"
        "train.main(argv + ['--steps', '5'])\n"
        "log = train.main(argv + ['--steps', '1', '--resume'])\n"
        "assert [r['step'] for r in log] == [5]\n"
        "assert not any(m in ('jax', 'msgpack', 'zstandard', 'ml_dtypes')\n"
        "               or m.startswith(('jax.', 'repro.', 'ml_dtypes.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "resumed from step 5" in res.stdout
    assert res.stdout.rstrip().endswith("ok")


def test_families_train_and_generate_with_jax_blocked(tmp_path):
    """launch.train on reduced jamba (Mamba, attention, MoE) and
    GenerateServer on reduced rwkv6 and, from stub embeddings, musicgen,
    on the CPU with jax, the reference, msgpack, zstandard and ml_dtypes
    unimportable."""
    code = (
        "import sys\n"
        "for m in ('jax', 'repro', 'msgpack', 'zstandard', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(SRC)!r})\n"
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.launch import train\n"
        "from repro_torch.models import Runtime, frontend, model\n"
        "from repro_torch.runtime.server import GenerateServer\n"
        "log = train.main(['--arch', 'jamba-v0.1-52b', '--reduced',\n"
        "                  '--device', 'cpu', '--seq', '16', '--steps', '2',\n"
        "                  '--global-batch', '2', '--ckpt-dir',\n"
        f"                  {str(tmp_path)!r}])\n"
        "assert len(log) == 2 and all(r['aux'] > 0 for r in log)\n"
        "g = torch.Generator().manual_seed(0)\n"
        "for arch in ('rwkv6-1.6b', 'musicgen-medium'):\n"
        "    cfg = get_config(arch, reduced=True)\n"
        "    m = model.init_params(g, cfg, 'cpu')\n"
        "    srv = GenerateServer(cfg, m, Runtime(remat='none'), batch=2,\n"
        "                         max_seq=12)\n"
        "    p = (frontend.make_embeds(g, cfg, 2, 6) if cfg.frontend != 'none'\n"
        "         else torch.zeros((2, 6), dtype=torch.int32))\n"
        "    assert srv.generate(p, 4).shape == (2, 4)\n"
        "assert not any(m in ('jax', 'msgpack', 'zstandard', 'ml_dtypes')\n"
        "               or m.startswith(('jax.', 'repro.', 'ml_dtypes.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.rstrip().endswith("ok")


def test_no_source_file_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|"
                     r"from\s+(jax|repro)(\.|\s)(?!_torch))", re.M)
    hits = [f"{p}: {m.group(0).strip()}"
            for p in sorted(PORT.rglob("*.py"))
            for m in pat.finditer(p.read_text())]
    assert not hits, hits
    assert not pat.search("from repro_torch.anns import registry")
    assert pat.search("from repro.anns import registry")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")


def test_backends_default_to_cuda_and_raise_without_a_card(no_card):
    from repro_torch.anns import registry
    for name in registry.available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            registry.create(name)
        assert registry.create(name, device="cpu").device.type == "cpu"


def test_dataset_and_build_raise_without_a_card(no_card):
    from repro_torch.anns import make_dataset
    from repro_torch.anns.construction import build_graph
    import numpy as np
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_dataset("glove-25-angular", n_base=50, n_query=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_graph(np.zeros((20, 4), np.float32), metric="l2", degree=4,
                    ef_construction=8, rounds=1, alpha=1.0,
                    num_entry_points=1, quantize=False)


def test_serve_main_raises_without_a_card(no_card):
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--n-base", "50", "--n-query", "4", "--n-requests", "4"])


@pytest.mark.parametrize("mode", [
    ["--backend", "stream_ivf", "--tail-cap", "64", "--tune",
     "--target-recall", "0.5", "--drift-retune", "0.1",
     "--max-tail-frac", "0.1", "--stream-demo", "20"],
    ["--backend", "ivf", "--async"],
    ["--backend", "ivf", "--async", "--tune", "--tenants", "a:0.5,b:0.3",
     "--max-queue", "8", "--deadline-ms", "50"],
])
def test_serve_streaming_and_async_modes_raise_without_a_card(no_card, mode,
                                                               capsys):
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--n-base", "50", "--n-query", "4", "--n-requests", "4",
                    *mode])
    assert "served" not in capsys.readouterr().out


def test_train_crinn_main_defaults_to_cuda_and_raises_without_a_card(no_card,
                                                                      tmp_path):
    from repro_torch.launch import train_crinn
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_crinn.main(["--fast", "--n-base", "50",
                          "--out", str(tmp_path / "run.json")])
    assert not (tmp_path / "run.json").exists()


def test_train_main_defaults_to_cuda_and_raises_without_a_card(no_card,
                                                                tmp_path):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                    str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()


def test_policy_model_and_cache_default_to_cuda(no_card):
    from repro_torch.configs import get_config
    from repro_torch.models import model
    for arch in ("crinn-policy-100m", "jamba-v0.1-52b", "rwkv6-1.6b"):
        cfg = get_config(arch, reduced=arch != "crinn-policy-100m")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.DecoderLM(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init_cache(cfg, 2, 8)


def test_load_index_defaults_to_cuda_and_raises_without_a_card(no_card,
                                                                tmp_path):
    import numpy as np
    from repro_torch import ckpt
    from repro_torch.anns import registry
    b = registry.create("brute_force", device="cpu")
    b.build(np.zeros((8, 4), np.float32))
    ckpt.save_index(str(tmp_path / "idx"), b)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.load_index(str(tmp_path / "idx"))
    assert ckpt.load_index(str(tmp_path / "idx"),
                           device="cpu").device.type == "cpu"


def test_sweep_frontier_and_serve_tune_default_to_cuda(no_card):
    from repro_torch.anns import make_dataset
    from repro_torch.anns.tune import sweep_frontier
    from repro_torch.launch import serve
    ds = make_dataset("glove-25-angular", n_base=50, n_query=4, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_frontier(ds, backends=("brute_force",))
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--n-base", "50", "--n-query", "4", "--n-requests", "4",
                    "--backend", "ivf", "--tune"])


def test_quickstart_torch_defaults_to_cuda_and_raises_without_a_card(no_card):
    code = ("import sys\n"
            f"sys.path.insert(0, {str(SRC)!r})\n"
            "sys.argv = ['quickstart_torch.py']\n"
            "import runpy\n"
            f"runpy.run_path({str(SRC.parent / 'examples' / 'quickstart_torch.py')!r},"
            " run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device available" in res.stderr
    assert "dataset:" not in res.stdout
