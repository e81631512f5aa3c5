"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which
``ctypes`` loads. The build runs at first use, into ``_build/`` beside
this file (git-ignored), and is keyed by a hash of the flags, the source
and every header under ``csrc/`` that it includes (``#include "..."``,
followed through headers), so an edited source or header rebuilds.
``build_all`` starts one ``nvcc`` per source, all at once. A failed
build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
CSRC = "csrc"

#: library name -> source, relative to the package
SOURCES = {"fused_gates": "csrc/fused_gates.cu", "window_dot": "csrc/window_dot.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
#: library name -> seconds its nvcc took in this process (absent: cached)
build_seconds: dict[str, float] = {}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _inputs(name: str) -> list[Path]:
    """The source of ``name`` and every header under ``csrc/`` that it
    includes, directly or through another header, in a fixed order."""
    csrc = _PKG / CSRC
    seen, todo = [], [_PKG / SOURCES[name]]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = csrc / inc.decode()
            if header.is_file():
                todo.append(header)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _inputs(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    (process or None, target, temp output, start time)."""
    out = _target(name)
    if out.exists():
        return None, out, None, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(_PKG / CSRC), "-o", str(tmp),
           str(_PKG / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, tmp, time.perf_counter()


def _finish(name: str, proc, out: Path, tmp: Path, t0: float) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0


def build_all(names=None) -> dict:
    """Build every (or the named) library, one nvcc each, in parallel;
    returns {name: seconds} for the ones this call compiled."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        started = [(n, *_start(n)) for n in names]
        for n, proc, out, tmp, t0 in started:
            _finish(n, proc, out, tmp, t0)
    return {n: build_seconds[n] for n in names if n in build_seconds}


def build_log(name: str) -> str:
    """The compiler output of the last build of ``name`` in this checkout
    (register and spill counts from ``-Xptxas -v``), or ''."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


#: the C signatures of each library's exported functions
_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "fused_gates": {
        # (src, dst, n, local_n, shard_index, tile_bits, ops, num_ops,
        #  coeffs, load_k, load_hi, store_k, store_hi, pair_lo, pair_hi,
        #  staged, stream, lanes) -> cudaError_t; staged: bit 0 a lane_u op, bit 1
        #  a kraus op on 3 row qubits
        "quest_fused_run_f32": ([_VP, _VP, _CI, _CI, _CLL, _CI, _VP, _CI, _VP,
                                 _CI, _CI, _CI, _CI, _CI, _CI, _CI, _VP, _CI], _CI),
        "quest_fused_run_f64": ([_VP, _VP, _CI, _CI, _CLL, _CI, _VP, _CI, _VP,
                                 _CI, _CI, _CI, _CI, _CI, _CI, _CI, _VP, _CI], _CI),
        # (f64, tile_bits, staged) -> thread blocks per SM, or -cudaError_t
        "quest_fused_run_blocks_per_sm": ([_CI, _CI, _CI], _CI),
        "quest_cuda_error_string": ([_CI], ctypes.c_char_p),
    },
    "window_dot": {
        # (amps, mat, n, lo, span, conj, stream) -> cudaError_t
        "quest_window_dot_f32": ([_VP, _VP, _CI, _CI, _CI, _CI, _VP], _CI),
        "quest_window_dot_f64": ([_VP, _VP, _CI, _CI, _CI, _CI, _VP], _CI),
        "quest_cuda_error_string": ([_CI], ctypes.c_char_p),
    },
}


def library_path(name: str) -> Path:
    """The file of the library ``name``, built first if needed."""
    build_all([name])
    return _target(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with argtypes
    and restype set on every exported function."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (args, res) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _loaded[name] = lib
        return _loaded[name]
