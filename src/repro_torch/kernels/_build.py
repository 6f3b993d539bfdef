"""Build ``csrc/*.cu`` with ``nvcc`` at first use and bind it with ``ctypes``.

Each source compiles on its own into ``build/lib<name>-<hash>.so`` at the
repository root (git-ignored); the hash covers the sources, the shared
headers and the flags, so an edited kernel rebuilds and an unchanged one is
reused.  Every source is compiled by its own ``nvcc`` process, all started
together.  The C entry points take plain pointers, so no PyTorch header is
compiled and a build takes seconds.

Nothing here runs at import time: the CPU tests import every module, and
this host may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build", "entry_point",
           "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# one shared library per source; the names are the .cu stems
SOURCES = ("pasm_matmul", "pasm_matmul_bf16", "pasm_conv", "pas_matmul",
           "pas_conv", "flash_attention", "decode_attention")

_loaded: dict = {}  # name → ctypes.CDLL, loaded once per process
_fns: dict = {}  # (name, symbol) → the bound C function, set up once
_log: dict = {}  # name → nvcc's stderr (ptxas register / spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels build only on a machine with the CUDA toolkit"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> float:
    """Compile every stale library among ``names`` in parallel; returns the
    wall seconds spent (0.0 when all were up to date).  Raises with nvcc's
    output when a build fails."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        out, err = p.communicate()
        _log[n] = (out or "") + (err or "")
        if p.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {p.returncode})\n{_log[n]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output for ``name`` from this process's build ('' if reused)."""
    return _log.get(name, "")


def entry_point(name: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of library ``name``, built and loaded on
    first use, with ``argtypes`` set (pointers and the stream must be
    ``ctypes.c_void_p``, or ctypes cuts them to 32 bits) and an ``int``
    return: the ``cudaError_t`` of the launch."""
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _fns[(name, symbol)] = fn
    return fn
