"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -I csrc -o build/repro_torch/<name>-<hash>.so \
         csrc/<name>.cu

The library name carries a hash of the source, of every shared header
(``csrc/*.cuh``, found with ``-I csrc/``) and of the flags, so an edited
source or header rebuilds and an unchanged one loads from the build directory
(``build/repro_torch/`` at the root of the checkout, git-ignored).
:func:`build` starts one nvcc per missing library, all at once, and waits
for them together.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
#: compiler output of each build of this process (ptxas register and
#: shared-memory report included), by source name
BUILD_LOGS: dict[str, str] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from ``$NVCC``, then ``$PATH``, then ``$CUDA_HOME/bin``."""
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names) -> float:
    """Compile every named source whose library is missing, one nvcc each,
    all started together.  Returns the seconds spent; raises with the
    compiler's output if any build fails."""
    t0 = time.perf_counter()
    with _LOCK:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for n in todo:
            tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, p) in procs.items():
            out, _ = p.communicate()
            BUILD_LOGS[n] = out
            if p.returncode != 0:
                failed.append(f"nvcc failed on {n}.cu (exit {p.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, library_path(n))
        if failed:
            raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def sass_count(name: str, opcode: str) -> int:
    """Instructions of ``opcode`` (e.g. ``HMMA``, the tensor cores' mma) in
    the built library of ``csrc/<name>.cu``, from ``cuobjdump --dump-sass``
    (beside nvcc)."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "--dump-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return sum(f" {opcode}" in ln for ln in sass.splitlines())


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry of ``lib``
    (every source exports ``cuda_error_string`` for the message)."""
    if err != 0:
        fn = lib.cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what} failed: cudaError_t {err} "
                           f"({fn(err).decode()})")
