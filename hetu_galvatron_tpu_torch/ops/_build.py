"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` into an object (one
``nvcc`` process per source, all started together) and linked into one
shared library with a plain C interface. The library is built at first use
into ``hetu_galvatron_tpu_torch/_build/`` (listed in ``.gitignore``) and is
cached by a hash of the sources, headers and flags, so a second process
reuses it and an edited source builds anew.

Pointers and the CUDA stream cross as ``ctypes.c_void_p``; every launch
function returns ``cudaGetLastError()`` after its launch, and
:func:`check_launch` raises when it is not 0 and otherwise counts the launch
in :data:`launch_counts`, the one registry of kernel launches. A launch
made while a CUDA graph captures is recorded, not run: it goes into the
census of the open :class:`CaptureCensus` instead, and every replay of the
graph adds that census to :data:`launch_counts` (``CaptureCensus.replayed``).

:func:`build_host_library` builds the host-side C++ helpers of ``csrc/``
(the search's DP core, ``csrc/dp_core.cpp``) with the host compiler and
the flags of the JAX package's ``csrc/Makefile``, into the same cache.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

# dtype codes of csrc/flash_common.cuh (shared by every kernel)
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1, "torch.float16": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_F = ctypes.c_float
_LL = ctypes.c_longlong
# argtypes of every exported launch function (csrc/*.cu). Flash: dtype
# code, input pointers, segment ids, output pointers, dims, strides, causal,
# scale, dropout on/seed/threshold/keep_prob, the route code (K1 and K2),
# stream. Cross-entropy: dtype code, input pointers, output pointers, T, V,
# row strides, stream.
SIGNATURES = {
    "galv_ce_fwd": [_I, _P, _P, _P, _P, _LL, _LL, _LL, _P],
    "galv_ce_bwd": [_I, _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _P],
    "galv_flash_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _I, _U32,
                       _U32, _F, _I, _P],
    "galv_flash_bwd_dkdv": [_I, *[_P] * 11, _I, _F, _I, _U32, _U32, _F, _I,
                            _P],
    "galv_flash_bwd_dq": [_I, *[_P] * 10, _I, _F, _I, _U32, _U32, _F, _P],
}

# kernel launches since the last reset, by launch function without its
# ``galv_`` prefix (a caller resets before the run it counts)
launch_counts: Dict[str, int] = {name[len("galv_"):]: 0
                                 for name in SIGNATURES}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the build this process ran


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError(
            "nvcc not found (on PATH or under $CUDA_HOME/bin): the CUDA "
            "kernels of hetu_galvatron_tpu_torch are built from csrc/ at "
            "first use and need the CUDA toolkit")
    return path


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(rebuild: bool = False) -> str:
    """Compile csrc/*.cu into the cached shared library; returns its path.
    ``rebuild`` compiles even when a library for these sources exists.
    Raises with nvcc's output when a source does not compile."""
    global build_seconds
    lib_path = os.path.join(BUILD_DIR, f"libgalv_kernels_{source_hash()}.so")
    if os.path.exists(lib_path) and not rebuild:
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {os.path.basename(src)}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
            f.write("\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                               + "\n".join(logs))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib,
             *[obj for _, obj, _ in procs]],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builders agree
    build_seconds = time.perf_counter() - t0
    return lib_path


def load_library(rebuild: bool = False) -> ctypes.CDLL:
    """The bound kernel library, built on first call (``rebuild``: compile
    even when a cached library exists; only before the first load)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build(rebuild))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


# csrc/Makefile's flags for the host-side C++ helpers (no -ffast-math: the
# search's DP must sum as the JAX package's build does)
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]


def build_host_library(source: str) -> str:
    """Compile the C++ source ``csrc/<source>`` with the host compiler
    (``$CXX``, else ``g++``) into ``_build/``, cached by a hash of the
    source and the flags; returns the library's path. Raises with the
    compiler's output when it is missing or fails."""
    src = os.path.join(CSRC_DIR, source)
    with open(src, "rb") as f:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + f.read())
    stem = os.path.splitext(source)[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    cxx = os.environ.get("CXX") or "g++"
    if shutil.which(cxx) is None:
        raise RuntimeError(
            f"the host C++ compiler {cxx!r} was not found: {source} of "
            "hetu_galvatron_tpu_torch is built with it at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp_lib, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {source}:\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(tmp_lib, lib_path)  # atomic: concurrent builds agree
    return lib_path


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class CaptureCensus:
    """The kernel launches one CUDA-graph capture recorded: open it around
    the capture (``with census:``), then call :meth:`replayed` after each
    replay of the graph, which runs them all again."""

    def __init__(self):
        self.counts: Dict[str, int] = {name: 0 for name in launch_counts}

    def __enter__(self) -> "CaptureCensus":
        global _census
        if _census is not None:
            raise RuntimeError("a capture census is already open")
        _census = self
        return self

    def __exit__(self, *exc) -> None:
        global _census
        _census = None

    def replayed(self) -> None:
        for name, n in self.counts.items():
            launch_counts[name] += n


_census: Optional[CaptureCensus] = None


def check_launch(name: str, code: int) -> None:
    """Raises on a failed launch of kernel ``name``, else counts it: in
    :data:`launch_counts`, or in the open census while a graph captures."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
    if _census is not None:
        _census.counts[name] += 1
    else:
        launch_counts[name] += 1


def int64_array(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])
