"""Profile readers and hardware latency tables for the search engine.

Port of ``hetu_galvatron_tpu/core/search_engine/profiles.py``: the readers
of the four hardware files (all-reduce bandwidth with its fitted α-β
pairs, p2p bandwidth, the overlap coefficient, the sp-time latency
tables), ``load_hardware_profile``, the model-profile parsers
``parse_time_config`` / ``parse_memory_config`` (static mode reads single
points, batch mode fits time linear in the batch size, sequence mode fits
it quadratic in the sequence length; sequence-mode memory scales from the
longest profiled sequence), ``load_model_profile`` and ``write_json``.

The fits use ``scipy.optimize.curve_fit``, as JAX's do: the golden
throughputs depend on those exact fits. This is the one module of the
package that imports scipy, and only inside the fits. The calibration
feed's readers (``read_profile_provenance``, ``merge_calibrated_profile``)
come with the calibration loop (ROADMAP item 10b).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


def read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def write_json(cfg: Dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=4)


def int_keys(d: Any) -> Any:
    """'8' -> 8 recursively (reference convert_keys_to_int)."""
    if isinstance(d, dict):
        return {(int(k) if isinstance(k, str) and k.isdigit() else k):
                int_keys(v) for k, v in d.items()}
    return d


def fit_linear(x: Sequence[float], y: Sequence[float]) -> np.ndarray:
    from scipy.optimize import curve_fit

    popt, _ = curve_fit(lambda v, m, c: m * v + c, x, y)
    return popt


def fit_quadratic(x: Sequence[float], y: Sequence[float]) -> np.ndarray:
    from scipy.optimize import curve_fit

    popt, _ = curve_fit(lambda v, a, b, c: a * v * v + b * v + c, x, y)
    return popt


# ---------------------------------------------------------------------------
# hardware configs
# ---------------------------------------------------------------------------


def read_allreduce_bandwidth(config: Any, device_num: int
                             ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(bandwidth MB/ms, latency ms/MB) dicts keyed '<size>[_consec]'
    (reference read_allreduce_bandwidth_config, config_utils.py:48-76).
    The full-world group has no non-consecutive variant."""
    env = read_json(config) if isinstance(config, str) else config
    bw: Dict[str, float] = {}
    coe: Dict[str, float] = {}
    n = device_num
    if n >= 2:
        v = env[f"allreduce_size_{n}_consec_1"]
        for k in (f"{n}", f"{n}_1", f"{n}_0"):
            bw[k] = v
            coe[k] = 1.0 / v
    n //= 2
    while n >= 2:
        for consec in (0, 1):
            v = env[f"allreduce_size_{n}_consec_{consec}"]
            bw[f"{n}_{consec}"] = v
            coe[f"{n}_{consec}"] = 1.0 / v
        n //= 2
    for k in ("1", "1_1", "1_0"):
        bw[k] = np.inf
        coe[k] = 0.0
    return bw, coe


def read_alpha_beta(config: Any) -> Dict[str, Tuple[float, float]]:
    """Fitted latency-bandwidth pairs per (group size, consecutiveness)
    from the allreduce-bandwidth JSON: ``allreduce_size_{n}_consec_{c}_
    alpha_ms`` / ``..._beta_mb_per_ms`` keys (written by
    ``hardware_profiler.profile_alpha_beta``) -> {"{n}_{c}": (α ms,
    β MB/ms)}. Legacy bandwidth-only JSONs simply yield an empty dict —
    the cost model then falls back to the measured latency tables, so old
    profiles keep producing byte-identical golden costs."""
    env = read_json(config) if isinstance(config, str) else config
    out: Dict[str, Tuple[float, float]] = {}
    for key, val in env.items():
        if not (key.startswith("allreduce_size_")
                and key.endswith("_alpha_ms")):
            continue
        if "_alg_" in key:
            # namespaced per-algorithm/per-level pairs
            # (profile_alpha_beta_algos) — parsed by
            # :func:`read_alpha_beta_algos`; pairing one of their alphas
            # with the FLAT beta key here would corrupt the legacy table
            continue
        parts = key.split("_")  # allreduce_size_{n}_consec_{c}_alpha_ms
        n, c = parts[2], parts[4]
        beta = env.get(f"allreduce_size_{n}_consec_{c}_beta_mb_per_ms")
        if beta:
            out[f"{n}_{c}"] = (float(val), float(beta))
    return out


def read_alpha_beta_algos(config: Any
                          ) -> Dict[str, Dict[str, Tuple[float, float]]]:
    """Per-algorithm, per-level fitted pairs from the allreduce-bandwidth
    JSON: ``allreduce_size_{n}_consec_{c}_alg_{ring|tree}_lvl_{ici|dcn}_
    alpha_ms`` / ``..._beta_mb_per_ms`` keys (written by
    ``hardware_profiler.profile_alpha_beta_algos``) ->
    ``{"{n}_{c}": {"{alg}_{lvl}": (α ms, β MB/ms)}}``. The cost model
    prices a collective as the MIN over the curves available at its size
    and level; profiles without the namespaced keys yield an empty dict
    and every golden cost stays byte-identical."""
    env = read_json(config) if isinstance(config, str) else config
    out: Dict[str, Dict[str, Tuple[float, float]]] = {}
    for key, val in env.items():
        if not (key.startswith("allreduce_size_") and "_alg_" in key
                and key.endswith("_alpha_ms")):
            continue
        # allreduce_size_{n}_consec_{c}_alg_{alg}_lvl_{lvl}_alpha_ms
        parts = key.split("_")
        n, c, alg, lvl = parts[2], parts[4], parts[6], parts[8]
        beta = env.get(
            f"allreduce_size_{n}_consec_{c}_alg_{alg}_lvl_{lvl}"
            "_beta_mb_per_ms")
        if beta:
            out.setdefault(f"{n}_{c}", {})[f"{alg}_{lvl}"] = (
                float(val), float(beta))
    return out


def read_p2p_bandwidth(config: Any) -> Tuple[Dict[int, float], Dict[int, float]]:
    """pp_size -> (bandwidth, 1/bandwidth) (reference config_utils.py:77-89)."""
    env = read_json(config) if isinstance(config, str) else config
    bw, coe = {}, {}
    for key, val in env.items():
        if "pp_size_" in key:
            bw[int(key.split("_")[-1])] = val
            coe[int(key.split("_")[-1])] = 1.0 / val
    return bw, coe


def remap_collective_bytes(config: Dict[str, float], op: str
                           ) -> Dict[int, Dict[Any, float]]:
    """sp-time entries -> {world: {bytes: ms, 'popt': fit}} (reference
    remap_config, config_utils.py:108-145); allreduce halves to the
    all-gather/reduce-scatter equivalent."""
    out: Dict[int, Dict[Any, float]] = {}
    for key, val in config.items():
        if key.startswith(op):
            if op == "allreduce":
                val = val / 2
            split = key.split("_")
            world, mb = int(split[-3]), int(split[-2][:-2])
            out.setdefault(world, {})[mb * 1024 * 1024] = val
    for world, table in out.items():
        x = [sz // 1024 // 1024 for sz in table]
        y = list(table.values())
        if len(x) < 8:
            raise ValueError(
                f"{op} profile needs >=8 message sizes, got {len(x)}")
        table["popt"] = fit_linear(x, y)
    return out


def remap_collective_latency(config: Dict[str, float], op: str
                             ) -> Dict[int, Dict[Any, float]]:
    """{world: {MB: ms, 'popt': fit}} latency tables (reference
    remap_config_for_latency, config_utils.py:147-185). 'allgather' derives
    from the allreduce rows at half time."""
    key_string = {"allreduce": "allreduce_size", "all2all": "all2all_size",
                  "allgather": "allreduce_size"}[op]
    factor = 0.5 if op == "allgather" else 1.0
    out: Dict[int, Dict[Any, float]] = {}
    for key, val in config.items():
        if key.startswith(key_string):
            split = key.split("_")
            world, mb = int(split[-3]), int(split[-2][:-2])
            out.setdefault(world, {})[mb] = val * factor
    for world, table in out.items():
        x = list(table.keys())
        y = list(table.values())
        if len(x) < 8:
            raise ValueError(
                f"{op} profile needs >=8 message sizes, got {len(x)}")
        table["popt"] = fit_linear(x, y)
    return out


@dataclass
class HardwareProfile:
    """All hardware latency tables the cost models consume."""

    allreduce_bandwidth: Dict[str, float]
    allreduce_coe: Dict[str, float]  # ms/MB
    p2p_bandwidth: Dict[int, float]
    p2p_coe: Dict[int, float]
    overlap_coe: float
    sp_allreduce: Dict[int, Dict[Any, float]]
    sp_all2all: Dict[int, Dict[Any, float]]
    allreduce_latency: Dict[int, Dict[Any, float]]
    allgather_latency: Dict[int, Dict[Any, float]]
    all2all_latency: Dict[int, Dict[Any, float]]
    # fitted α-β pairs per "{size}_{consec}" (empty for legacy profiles)
    alpha_beta: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    # per-algorithm/per-level pairs: "{size}_{consec}" ->
    # {"{ring|tree}_{ici|dcn}": (α, β)} (empty for legacy profiles)
    alpha_beta_algos: Dict[str, Dict[str, Tuple[float, float]]] = field(
        default_factory=dict)


def load_hardware_profile(
    *,
    allreduce_path: str,
    p2p_path: str,
    overlap_path: str,
    sp_time_path: str,
    world_size: int,
) -> HardwareProfile:
    """Read the four hardware_configs JSONs (reference
    get_profiled_hardware_configs, search_engine.py:419-462)."""
    bw, coe = read_allreduce_bandwidth(allreduce_path, world_size)
    alpha_beta = read_alpha_beta(allreduce_path)
    alpha_beta_algos = read_alpha_beta_algos(allreduce_path)
    p2p_bw, p2p_coe = read_p2p_bandwidth(p2p_path)
    overlap = read_json(overlap_path)["overlap_coe"]
    sp = read_json(sp_time_path)
    return HardwareProfile(
        allreduce_bandwidth=bw,
        allreduce_coe=coe,
        p2p_bandwidth=p2p_bw,
        p2p_coe=p2p_coe,
        overlap_coe=overlap,
        sp_allreduce=remap_collective_bytes(sp, "allreduce"),
        sp_all2all=remap_collective_bytes(sp, "all2all"),
        allreduce_latency=remap_collective_latency(sp, "allreduce"),
        allgather_latency=remap_collective_latency(sp, "allgather"),
        all2all_latency=remap_collective_latency(sp, "all2all"),
        alpha_beta=alpha_beta,
        alpha_beta_algos=alpha_beta_algos,
    )


# ---------------------------------------------------------------------------
# model profiles (computation time + memory)
# ---------------------------------------------------------------------------


@dataclass
class ModelProfile:
    """Per-layertype computation fits + memory tables (reference
    get_profiled_model_configs outputs)."""

    time_profiled_list: List[Any]  # scalar or popt per layertype
    other_time_profiled_list: List[Any]
    param_sizes: List[float]
    act_sizes: List[Dict[Any, float]]
    other_memory_pp_off: Dict[str, Dict[int, float]]
    other_memory_pp_on: Dict[str, Dict[str, Dict[int, float]]]


def parse_time_config(
    time_config: Dict[str, float],
    *,
    mode: str,
    num_layertype: int,
    seqlen_list: Sequence[int],
) -> Tuple[List[Any], List[Any]]:
    """static: raw ms values; batch: linear fit of t*bsz vs bsz; sequence:
    quadratic (layers) / linear (vocab) fit over seq evaluated at the target
    seqlen (search_engine.py:289-361)."""
    times: List[Any] = []
    others: List[Any] = []
    if mode == "static":
        for i in range(num_layertype):
            for key, t in time_config.items():
                if key.startswith(f"layertype_{i}_"):
                    times.append(t)
                if key.startswith("layertype_other_"):
                    others.append(t)
    elif mode == "batch":
        for i in range(num_layertype):
            xs, ys = [], []
            for key, t in time_config.items():
                if key.startswith(f"layertype_{i}_") and \
                        f"_seq{seqlen_list[i]}" in key:
                    bsz = int(key.split("_")[-2][3:])
                    xs.append(bsz)
                    ys.append(t * bsz)
            if len(xs) < 8:
                raise ValueError(
                    f"batch-mode profile needs >=8 bsz points, got {len(xs)}")
            times.append(fit_linear(xs, ys))
        for i in range(num_layertype):
            xs, ys = [], []
            for key, t in time_config.items():
                if key.startswith("layertype_other_") and \
                        f"_seq{seqlen_list[i]}" in key:
                    bsz = int(key.split("_")[-2][3:])
                    xs.append(bsz)
                    ys.append(t * bsz)
            if len(xs) < 8:
                raise ValueError(
                    f"batch-mode profile needs >=8 bsz points, got {len(xs)}")
            others.append(fit_linear(xs, ys))
    elif mode == "sequence":
        for i in range(num_layertype):
            xs, ys = [], []
            for key, t in time_config.items():
                if key.startswith(f"layertype_{i}_") and "_bsz1_" in key:
                    xs.append(int(key.split("seq")[-1]))
                    ys.append(t)
            popt = fit_quadratic(xs, ys)
            times.append(popt[0] * seqlen_list[i] ** 2 +
                         popt[1] * seqlen_list[i] + popt[2])
        for i in range(num_layertype):
            xs, ys = [], []
            for key, t in time_config.items():
                if key.startswith("layertype_other_") and "_bsz1_" in key:
                    xs.append(int(key.split("seq")[-1]))
                    ys.append(t)
            popt = fit_linear(xs, ys)
            others.append(popt[0] * seqlen_list[i] + popt[1])
    else:
        raise ValueError(f"unknown time profile mode {mode}")
    return times, others


def parse_memory_config(
    memory_config: Dict[str, Any],
    *,
    mode: str,
    num_layertype: int,
    seqlen_list: Sequence[int],
    sequence_parallel: bool,
) -> Tuple[List[float], List[Dict], Dict, Dict]:
    """Returns (param_sizes, act_sizes, other_pp_off, other_pp_on)
    (search_engine.py:362-417)."""
    memory_config = int_keys(memory_config)
    sp_suffix = "_sp" if sequence_parallel else ""
    param_sizes: List[float] = [0.0] * num_layertype
    act_sizes: List[Dict] = [{} for _ in range(num_layertype)]

    if mode == "sequence":
        if not sequence_parallel:
            raise ValueError("sequence memory profiling requires "
                             "sequence_parallel")
        # (the reference restricts sequence-mode memory profiles to one
        # layertype; the per-layertype loop below is generic, which lets
        # encoder-decoder searches scale each stack's activations by its own
        # sequence length)
        maxseq_list = []
        for i in range(num_layertype):
            layer_mem = memory_config[f"layertype_{i}_sp"]
            seqs = [int(s) for s in layer_mem.keys()]
            maxseq, minseq = max(seqs), min(seqs)
            maxseq_list.append(maxseq)
            param_sizes[i] = layer_mem[minseq]["parameter_size"]
            act = dict(layer_mem[maxseq]["tp_activation_per_bsz_dict"])
            act_sizes[i] = {k: v / maxseq * seqlen_list[i]
                            for k, v in act.items()}
        off = memory_config["other_memory_pp_off_sp"][maxseq_list[0]]
        on = {"first_stage":
              memory_config["other_memory_pp_on_first_sp"][maxseq_list[0]],
              "last_stage":
              memory_config["other_memory_pp_on_last_sp"][maxseq_list[-1]]}
        for tp in off["activation"]:
            off["activation"][tp] = (off["activation"][tp] / maxseq_list[0] *
                                     seqlen_list[0])
            on["first_stage"]["activation"][tp] = (
                on["first_stage"]["activation"][tp] / maxseq_list[0] *
                seqlen_list[0])
            on["last_stage"]["activation"][tp] = (
                on["last_stage"]["activation"][tp] / maxseq_list[-1] *
                seqlen_list[-1])
    elif mode == "static":
        for i in range(num_layertype):
            layer_mem = memory_config[f"layertype_{i}{sp_suffix}"]
            param_sizes[i] = layer_mem[seqlen_list[i]]["parameter_size"]
            act_sizes[i] = dict(
                layer_mem[seqlen_list[i]]["tp_activation_per_bsz_dict"])
        seq_key = (seqlen_list[0] if len(seqlen_list) == 1
                   else "_".join(str(s) for s in seqlen_list))
        off = memory_config[f"other_memory_pp_off{sp_suffix}"][seq_key]
        on = {"first_stage":
              memory_config[f"other_memory_pp_on_first{sp_suffix}"][seq_key],
              "last_stage":
              memory_config[f"other_memory_pp_on_last{sp_suffix}"][seq_key]}
    else:
        raise ValueError(f"unknown memory profile mode {mode}")
    return param_sizes, act_sizes, off, on


def load_model_profile(
    *,
    time_path: str,
    memory_path: str,
    time_mode: str,
    memory_mode: str,
    num_layertype: int,
    seqlen_list: Sequence[int],
    sequence_parallel: bool,
) -> ModelProfile:
    times, others = parse_time_config(
        read_json(time_path), mode=time_mode, num_layertype=num_layertype,
        seqlen_list=seqlen_list)
    params, acts, off, on = parse_memory_config(
        read_json(memory_path), mode=memory_mode, num_layertype=num_layertype,
        seqlen_list=seqlen_list, sequence_parallel=sequence_parallel)
    return ModelProfile(
        time_profiled_list=times, other_time_profiled_list=others,
        param_sizes=params, act_sizes=acts,
        other_memory_pp_off=off, other_memory_pp_on=on)
