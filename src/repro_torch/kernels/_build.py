"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C entry point and compiles on its own
into ``build/<name>-<digest>.so`` at the repository root, where the digest
covers the sources and the flags, so an edited source is rebuilt and a
stale library is never loaded. Nothing is built at import: the first
launch of a kernel builds it (or :func:`build` builds several at once,
one ``nvcc`` process each, all started together).
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
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each source's entry point (all return a cudaError_t).
ENTRY = {
    "flash_attn_fwd": [P, P, P, P, I, I, I, I, I, I, I, I, F, I, P],
    "decode_attn": [P, P, P, P, P, I, I, I, I, I, F, I, P],
    "split_quant": [P, P, P, I, I, I, I, P],
    "mamba_scan": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    "mlstm_scan": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, I, P],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = tuple(ENTRY)) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, in parallel.
    Returns seconds per compiled kernel; the compiler's report (registers,
    shared memory, spills) is kept in ``build/<name>.log``."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    secs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}:\n{out}")
            continue
        os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            fn = getattr(lib, name)
            fn.argtypes = ENTRY[name]
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib
