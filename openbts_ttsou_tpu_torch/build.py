"""Build and load the package's hand-written CUDA kernels.

Each source under `csrc/` compiles with `nvcc` for `sm_90a` into its own
shared library with a plain C interface, loaded with `ctypes`. Libraries
go to `build/kernels/` at the repository root and are built at first use
(or all at once, in parallel, by `build_all`). A library older than its
source is rebuilt.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"

#: kernel library name → CUDA source file under csrc/
SOURCES = {
    "polyphase_resample": "polyphase_resample.cu",
    "exact_walk": "exact_walk.cu",
    "viterbi": "viterbi.cu",
    "dfe_equalize": "dfe_equalize.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    src = CSRC / SOURCES[name]
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _start(name: str) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, library_path(name))
    return out


def build_all() -> dict[str, str]:
    """Compile every kernel library, one nvcc process per source, all
    started together. Returns {name: compiler output}."""
    started = {n: _start(n) for n in SOURCES}
    return {n: _finish(n, *started[n]) for n in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`. Where it is missing or stale, every
    stale library is built first, one nvcc process each, all started
    together (as `build_all`), so that a checkout's first run waits for
    the slowest build once rather than for each in turn."""
    if name not in _loaded:
        if _stale(name):
            started = {n: _start(n) for n in SOURCES if _stale(n)}
            for n, (proc, tmp) in started.items():
                _finish(n, proc, tmp)
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
