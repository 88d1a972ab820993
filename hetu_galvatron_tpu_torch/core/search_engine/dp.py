"""Per-stage knapsack DP over (layer, memory budget, strategy).

Port of ``hetu_galvatron_tpu/core/search_engine/dp.py``: ``dp_solve`` with
both of its paths. ``use_cpp_core`` runs the C++ core,
``hetu_galvatron_tpu_torch/csrc/dp_core.cpp`` (a copy of the JAX package's
``csrc/dp_core.cpp``), built at first use with the host compiler and the
flags of ``csrc/Makefile`` by ``ops/_build.build_host_library`` and bound
with ctypes; otherwise the NumPy recurrence runs. A failed build raises:
unlike JAX's ``utils/native.py``, the port never falls back to NumPy
silently.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

_lock = threading.Lock()  # threaded searches must not race the build
_lib: Optional[ctypes.CDLL] = None


def load_cpp_core() -> ctypes.CDLL:
    """The bound DP core, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            from hetu_galvatron_tpu_torch.ops._build import (
                build_host_library,
            )

            lib = ctypes.CDLL(build_host_library("dp_core.cpp"))
            lib.dp_solve.restype = ctypes.c_int
            lib.dp_solve.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
                ctypes.c_int, ctypes.c_double,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
            ]
            _lib = lib
    return _lib


def dp_solve(
    mem_cost: np.ndarray,      # [layers, strategies] int MB
    intra_cost: np.ndarray,    # [layers, strategies] seconds
    inter_cost: np.ndarray,    # [layers, strategies, strategies]
    max_mem: int,
    other_mem: int,
    other_time: float,
    use_cpp_core: bool = True,
) -> Tuple[float, Optional[list], int]:
    """Minimize the sum of intra + inter costs within the per-stage memory
    budget. Returns (total cost, per-layer strategy indices or None,
    remaining memory): the vocab layers' memory shrinks the budget and
    their time adds to the total."""
    layers, strat = intra_cost.shape
    budget = max_mem + 1  # budgets 0..max_mem inclusive
    v = np.ascontiguousarray(mem_cost, np.int32)
    intra = np.ascontiguousarray(intra_cost, np.float64)
    inter = np.ascontiguousarray(inter_cost, np.float64)

    if use_cpp_core:
        lib = load_cpp_core()
        mark = np.empty((layers, budget, strat), np.int32)
        f = np.zeros((budget, strat), np.float64)
        res = np.empty((layers,), np.int32)
        total = ctypes.c_double()
        remain = ctypes.c_int()
        rc = lib.dp_solve(layers, budget, strat, v, inter, intra,
                          int(other_mem), float(other_time),
                          mark, f, res, ctypes.byref(total),
                          ctypes.byref(remain))
        if rc != 0:
            return np.inf, None, -1
        return float(total.value), [int(x) for x in res], int(remain.value)

    # the same recurrence, vectorized over the memory axis
    f = np.zeros((budget, strat), np.float64)
    mark = np.full((layers, budget, strat), -1, np.int32)
    for i in range(layers):
        new_f = np.full((budget, strat), np.inf, np.float64)
        for s in range(strat):
            need = int(v[i, s])
            if need > max_mem:
                continue
            # candidates[m, si] = f[m - need, si] + inter[i, si, s]
            cand = f[:budget - need, :] + inter[i, :, s][None, :]
            best_si = np.argmin(cand, axis=1)
            rows = np.arange(budget - need)
            new_f[need:, s] = cand[rows, best_si] + intra[i, s]
            mark[i, need:, s] = best_si
        f = new_f

    b = max_mem - other_mem
    if b < 0:
        return np.inf, None, -1
    next_index = int(np.argmin(f[b]))
    total = f[b, next_index]
    if not total < np.inf:
        return np.inf, None, -1
    total += other_time
    next_v = b
    res = [-1] * layers
    res[layers - 1] = next_index
    for i in range(layers - 1, 0, -1):
        cur = next_index
        next_index = int(mark[i, next_v, next_index])
        next_v -= int(v[i, cur])
        res[i - 1] = next_index
    return float(total), res, next_v - int(v[0, next_index])
