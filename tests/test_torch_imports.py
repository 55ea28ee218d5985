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
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(SRC)!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.anns import registry\n"
        "for name in registry.available():\n"
        "    registry.get(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok', len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


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


def test_train_crinn_main_defaults_to_cuda_and_raises_without_a_card(no_card,
                                                                      tmp_path):
    from repro_torch.launch import train_crinn
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_crinn.main(["--fast", "--n-base", "50",
                          "--out", str(tmp_path / "run.json")])
    assert not (tmp_path / "run.json").exists()


def test_policy_model_and_cache_default_to_cuda(no_card):
    from repro_torch.configs import get_config
    from repro_torch.models import model
    cfg = get_config("crinn-policy-100m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.DecoderLM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(cfg, 2, 8)
