"""The port's nvcc loader (``repro_torch.kernels._build``) on the CPU: what
keys a library, the command it builds with and the SASS count, against
stand-in compiler tools (nothing is compiled here)."""
import shutil
import stat

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc/`` that the loader reads instead of the package's,
    and an empty build directory."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return copy


def test_every_kernel_source_includes_the_shared_header():
    for name in ("distance", "flash"):
        assert '#include "tf32x3.cuh"' in (_build.CSRC / f"{name}.cu").read_text()


def test_a_changed_header_gives_another_library(csrc):
    before = {n: _build.library_path(n) for n in ("distance", "flash", "topk")}
    assert before == {n: _build.library_path(n) for n in before}   # stable
    header = csrc / "tf32x3.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    assert all(p.parent == _build.BUILD_DIR for p in after.values())


def test_a_new_header_gives_another_library(csrc):
    before = _build.library_path("distance")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("distance") != before


def test_a_changed_source_moves_only_its_own_library(csrc):
    before = {n: _build.library_path(n) for n in ("distance", "flash")}
    src = csrc / "flash.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("flash") != before["flash"]
    assert _build.library_path("distance") == before["distance"]


def _tool(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return path


def test_build_passes_the_header_directory_and_skips_what_is_built(
        csrc, tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "nvcc.log"
    # writes its arguments to the log and an empty library to its -o path
    nvcc = _tool(bin_dir / "nvcc", f'''echo "$@" >> {log}
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then : > "$2"; fi
  shift
done
''')
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    _build.build(["distance", "flash"])
    calls = log.read_text().splitlines()
    assert len(calls) == 2
    for line in calls:
        args = line.split()
        assert args[args.index("-I") + 1] == str(csrc)
        assert "arch=compute_90a,code=sm_90a" in args
    assert _build.library_path("distance").exists()
    assert _build.library_path("flash").exists()
    assert _build.build(["distance", "flash"]) == 0.0    # nothing left to do
    assert len(log.read_text().splitlines()) == 2


def test_sass_count_reads_cuobjdump_beside_nvcc(csrc, tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = _tool(bin_dir / "nvcc", "exit 1\n")
    _tool(bin_dir / "cuobjdump", '''cat <<'EOF'
        /*0340*/                   HMMA.1688.F32.TF32 R32, R4.reuse, R40.reuse, R32 ;
        /*0350*/                   HMMA.1688.F32.TF32 R36, R4.reuse, R40.reuse, R36 ;
        /*0360*/                   FFMA R8, R4, R40, R8 ;
EOF
''')
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    assert _build.sass_count("distance", "HMMA") == 2
    assert _build.sass_count("distance", "FFMA") == 1
    assert _build.sass_count("distance", "IMMA") == 0
