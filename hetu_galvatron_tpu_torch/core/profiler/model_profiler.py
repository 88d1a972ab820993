"""Model profiler: per-layer time and memory by difference of runs.

Port of ``hetu_galvatron_tpu/core/profiler/model_profiler.py``:
``ModelProfiler`` with ``profile_computation`` (static, batch and sequence
modes), ``profile_memory`` and ``run``. It runs the model at
``layernum_min`` and ``layernum_max`` layers, takes the difference of the
two runs over the layer difference as ONE decoder layer's time or memory
(clamped at 0), attributes the rest to the embedding and LM head
("other"), and writes ``computation_profiling_*.json`` /
``memory_profiling_*.json`` in the schema the search reads
(``core/search_engine/profiles.py``), with JAX's arithmetic and clamps.

* Computation (:meth:`_forward_ms`): the forward the port's runtime runs,
  in bf16, on zero tokens (t5: a zero encoder half and decoder half), with
  the attention core ``cli/train_dist.py`` picks (the flash kernel K1 on a
  CUDA device when ``model.use_flash_attn``, else the plain core). Two
  warm-up calls, then ``iters`` calls (20 on a CUDA device, 5 on the CPU)
  queued back to back and timed between two CUDA events (on the CPU, by
  the host clock), so a short forward is not timed at the host's launch
  rate.
* Memory (:meth:`_step_memory_mb`): one real training step of the port
  (``make_train_step`` with AdamW, the plan's per-layer remat flags, fused
  cross-entropy when the config asks for it), after a warm-up step. Its
  "temps" is what the forward leaves allocated for the backward: on a
  CUDA device ``torch.cuda.memory_allocated()`` when the loss exists less
  the same counter just before the step; on the CPU, which has no
  allocator statistic, the bytes of the distinct storages the autograd
  graph saves. That is the activation the cost model adds to a layer's
  model states, which count its gradient already. The step's peak beyond
  its arguments (``max_memory_allocated()`` after
  ``reset_peak_memory_stats()``, less the allocated before) is returned
  too, as "peak": it is what XLA's ``temp_size_in_bytes`` counts in JAX,
  but on the card it falls in the AdamW update, after the backward has
  freed every activation, so per layer it reads the layer's fp32
  gradient, remat or not, and would show the search no saving from
  remat. The other keys are JAX's ``compiled_memory_mb`` keys.

``tp_degs`` stops at the number of visible devices (1 on one card and on
the CPU), as JAX's stops at ``len(devices)``; a tp degree above 1 needs
the SPMD plans (ROADMAP item 10b). The two measuring methods are the seam
that tests replace.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import torch

from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs, ModelArgs
from hetu_galvatron_tpu_torch.core.search_engine.profiles import write_json
from hetu_galvatron_tpu_torch.models.builder import (
    init_causal_lm,
    named_leaves,
    param_count,
)

MB = 1024 * 1024


def _param_size_mb(params: Dict[str, Any]) -> float:
    return param_count(params) * 4 / MB  # fp32 master weights


class ModelProfiler:
    def __init__(self, args: CoreArgs,
                 device: Optional[torch.device] = None):
        self.args = args
        self.prof = args.model_profiler
        if device is None:
            from hetu_galvatron_tpu_torch.runtime.initialize import (
                resolve_device,
            )

            device = resolve_device(args)
        self.device = device
        self._params: Dict[Any, Any] = {}

    def _cfg(self, layernum: int, seq: int) -> ModelArgs:
        return dataclasses.replace(
            self.args.model, num_hidden_layers=layernum, seq_length=seq,
            max_position_embeddings=max(
                seq, self.args.model.max_position_embeddings))

    def _device_count(self) -> int:
        if self.device.type == "cuda":
            return torch.cuda.device_count()
        return 1

    def _init(self, cfg: ModelArgs):
        """The profiled model's parameters, kept for the grid points of one
        sequence length (the forward's time does not depend on them)."""
        key = (cfg.num_hidden_layers, cfg.seq_length)
        if key not in self._params:
            if any(k[1] != cfg.seq_length for k in self._params):
                self._params.clear()
            self._params[key] = init_causal_lm(cfg, seed=0,
                                               device=self.device)
        return self._params[key]

    def _overrides(self, cfg: ModelArgs) -> Dict[str, Any]:
        """The attention cores of ``cli/train_dist.py``, as loss/forward
        keyword arguments."""
        from hetu_galvatron_tpu_torch.cli.train_dist import (
            attention_overrides,
        )

        t5 = cfg.model_type == "t5"
        kw: Dict[str, Any] = {"layer_overrides": attention_overrides(
            cfg, self.device, cross=t5)}
        if t5:
            from hetu_galvatron_tpu_torch.models.encdec import encoder_layers

            kw["enc_layer_overrides"] = attention_overrides(
                cfg, self.device, n_layers=encoder_layers(cfg))
        return kw

    # -- computation --------------------------------------------------------

    def _forward_ms(self, cfg: ModelArgs, bsz: int, warmup: int = 2,
                    iters: Optional[int] = None) -> float:
        cuda = self.device.type == "cuda"
        if iters is None:  # more reps on the card: amortized-loop timing
            iters = 20 if cuda else 5
        params = self._init(cfg)
        kw = self._overrides(cfg)
        if cfg.model_type == "t5":
            from hetu_galvatron_tpu_torch.models.encdec import forward_encdec

            half = max(cfg.seq_length // 2, 1)
            enc = torch.zeros((bsz, half), dtype=torch.long,
                              device=self.device)
            dec = torch.zeros((bsz, cfg.seq_length - half),
                              dtype=torch.long, device=self.device)

            def fwd():
                return forward_encdec(params, enc, dec, cfg,
                                      compute_dtype=torch.bfloat16, **kw)
        else:
            from hetu_galvatron_tpu_torch.models.builder import (
                forward_causal_lm,
            )

            tokens = torch.zeros((bsz, cfg.seq_length), dtype=torch.long,
                                 device=self.device)

            def fwd():
                return forward_causal_lm(
                    params, tokens, cfg, compute_dtype=torch.bfloat16,
                    layer_overrides=kw["layer_overrides"])

        with torch.no_grad():
            for _ in range(warmup):
                out = fwd()
            del out
            if cuda:
                torch.cuda.synchronize(self.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    out = fwd()
                    del out
                end.record()
                end.synchronize()
                return start.elapsed_time(end) / iters
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fwd()
                del out
            return (time.perf_counter() - t0) * 1000.0 / iters

    def profile_computation(self) -> Dict[str, float]:
        """Per-layer and "other" forward ms per (bsz, seq) grid point:
        per-layer = (run[max] - run[min]) / (max - min), the rest other."""
        p = self.prof
        if p.profile_mode == "batch":
            bszs = list(range(p.profile_min_batch_size,
                              p.profile_max_batch_size + 1,
                              p.profile_batch_size_step))
            seqs = [p.profile_seq_length_list[0]]
        elif p.profile_mode == "sequence":
            bszs = [1]
            seqs = list(range(p.profile_min_seq_length,
                              p.profile_max_seq_length + 1,
                              p.profile_seq_length_step))
        else:
            bszs = [p.profile_batch_size]
            seqs = list(p.profile_seq_length_list)

        out: Dict[str, float] = {}
        n_min, n_max = p.layernum_min, p.layernum_max
        for seq in seqs:
            for bsz in bszs:
                t_min = self._forward_ms(self._cfg(n_min, seq), bsz)
                t_max = self._forward_ms(self._cfg(n_max, seq), bsz)
                per_layer = max((t_max - t_min) / (n_max - n_min), 0.0)
                other = max(t_min - n_min * per_layer, 0.0)
                out[f"layertype_0_bsz{bsz}_seq{seq}"] = per_layer
                out[f"layertype_other_bsz{bsz}_seq{seq}"] = other
        self._params.clear()
        return out

    # -- memory -------------------------------------------------------------

    def _step_memory_mb(self, cfg: ModelArgs, bsz: int, tp: int,
                        checkpoint: bool) -> Dict[str, float]:
        """One real training step's memory, in MB: JAX's
        ``compiled_memory_mb`` keys, "temps" being what the forward leaves
        allocated for the backward (see the module docstring), and "peak",
        the step's peak beyond its arguments."""
        if tp > 1:
            raise NotImplementedError(
                f"memory profile at tp={tp}: tensor parallelism needs the "
                "SPMD plans on NCCL, which are not ported yet (ROADMAP item "
                "10)")
        from hetu_galvatron_tpu_torch.runtime.hybrid_config import (
            get_hybrid_parallel_config,
        )
        from hetu_galvatron_tpu_torch.runtime.optimizer import make_optimizer
        from hetu_galvatron_tpu_torch.runtime.trainer import (
            make_loss_fn,
            make_train_step,
        )

        self._params.clear()
        args = dataclasses.replace(
            self.args, model=cfg,
            parallel=dataclasses.replace(
                self.args.parallel, config_mode="global",
                galvatron_config_path=None, pp_deg=1, global_tp_deg=1,
                global_checkpoint=int(checkpoint),
                global_train_batch_size=bsz, chunks=1))
        hpc = get_hybrid_parallel_config(args, 1)
        params = init_causal_lm(cfg, seed=0, device=self.device)
        names, leaves = zip(*named_leaves(params))
        tx = make_optimizer(self.args.train)
        opt_state = tx.init(list(leaves), names)
        kw = self._overrides(cfg)
        if cfg.model_type == "t5":
            kw.update(remat_flags=hpc.dec_flags,
                      enc_remat_flags=hpc.enc_flags)
        else:
            kw = dict(remat_flags=hpc.dec_flags,
                      layer_overrides=kw["layer_overrides"])
        loss_fn = make_loss_fn(cfg, compute_dtype=torch.bfloat16, **kw)
        cuda = self.device.type == "cuda"
        after_forward = []

        def measured_loss(p, b):
            loss = loss_fn(p, b)
            if cuda:  # a host counter: no wait for the card
                after_forward.append(torch.cuda.memory_allocated(
                    self.device))
            return loss

        step = make_train_step(measured_loss, tx)
        seq = cfg.seq_length

        def zeros(n):
            return torch.zeros((bsz, n), dtype=torch.long,
                               device=self.device)

        if cfg.model_type == "t5":
            half = max(seq // 2, 1)
            batch = {"enc_tokens": zeros(half), "tokens": zeros(seq - half),
                     "labels": zeros(seq - half)}
        else:
            batch = {"tokens": zeros(seq), "labels": zeros(seq)}
        # the warm-up step: the allocator's pools and the optimizer's state
        # exist before the measured one
        params, opt_state, _ = step(params, opt_state, batch)
        if cuda:
            torch.cuda.synchronize(self.device)
            before = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            params, opt_state, _ = step(params, opt_state, batch)
            torch.cuda.synchronize(self.device)
            peak = torch.cuda.max_memory_allocated(self.device) - before
            outputs = max(torch.cuda.memory_allocated(self.device) - before,
                          0)
            temps = after_forward[-1] - before
        else:
            before = sum(t.numel() * t.element_size() for t in leaves) + \
                sum(t.numel() * t.element_size()
                    for t in opt_state.mu + opt_state.nu)
            temps = _cpu_saved_bytes(step, params, opt_state, batch)
            peak = temps + sum(t.numel() * 4 for t in leaves)  # + grads
            outputs = 0
        del params, opt_state, leaves, batch
        return {"arguments": before / MB, "outputs": outputs / MB,
                "temps": temps / MB,
                "total": (before + outputs + temps) / MB,
                "peak": peak / MB}

    def profile_memory(self) -> Dict[str, Any]:
        """memory_profiling_*.json in the search's schema: per-layer
        parameter_size and tp_activation_per_bsz_dict (per tp degree and
        checkpoint), and the pp-off / first / last "other" tables."""
        p = self.prof
        seq = p.profile_seq_length_list[0]
        bsz = p.profile_batch_size
        n_min, n_max = p.layernum_min, p.layernum_max
        sp_suffix = "_sp"  # the schema JAX writes: sequence sharding on

        cfg_min, cfg_max = self._cfg(n_min, seq), self._cfg(n_max, seq)
        mb_min = _param_size_mb(init_causal_lm(cfg_min, seed=0,
                                               device=self.device))
        mb_max = _param_size_mb(init_causal_lm(cfg_max, seed=0,
                                               device=self.device))
        layer_param_mb = (mb_max - mb_min) / (n_max - n_min)
        other_param_mb = mb_min - n_min * layer_param_mb

        tp_degs = []
        tp = 1
        while tp <= min(p.max_tp_deg, self._device_count()):
            tp_degs.append(tp)
            tp *= 2

        act_per_bsz: Dict[Any, float] = {}
        other_act: Dict[Any, float] = {}
        for tp in tp_degs:
            m_min = self._step_memory_mb(cfg_min, bsz, tp, False)
            m_max = self._step_memory_mb(cfg_max, bsz, tp, False)
            per_layer = max(
                (m_max["temps"] - m_min["temps"]) / (n_max - n_min), 0.0)
            act_per_bsz[tp] = per_layer / bsz
            other_act[tp] = max(
                (m_min["temps"] - n_min * per_layer), 0.0) / bsz
        m_ck = self._step_memory_mb(cfg_max, bsz, 1, True)
        m_ck_min = self._step_memory_mb(cfg_min, bsz, 1, True)
        act_per_bsz["checkpoint"] = max(
            (m_ck["temps"] - m_ck_min["temps"]) / (n_max - n_min), 0.0) / bsz

        # other model states: embed/head params x4 (params+grads+adam) per tp
        other_states = {tp: 4 * other_param_mb / tp for tp in tp_degs}
        half = {tp: v / 2 for tp, v in other_states.items()}
        return {
            f"layertype_0{sp_suffix}": {
                str(seq): {
                    "parameter_size": layer_param_mb,
                    "tp_activation_per_bsz_dict": act_per_bsz,
                }
            },
            f"other_memory_pp_off{sp_suffix}": {
                str(seq): {"model_states": other_states,
                           "activation": other_act}
            },
            f"other_memory_pp_on_first{sp_suffix}": {
                str(seq): {"model_states": half,
                           "activation": {k: v / 2
                                          for k, v in other_act.items()}}
            },
            f"other_memory_pp_on_last{sp_suffix}": {
                str(seq): {"model_states": half,
                           "activation": {k: v / 2
                                          for k, v in other_act.items()}}
            },
        }

    # -- entry --------------------------------------------------------------

    def run(self, output_dir: Optional[str] = None) -> Dict[str, str]:
        p = self.prof
        out_dir = output_dir or p.output_dir
        name = self.args.model.model_name.replace("/", "_")
        precision = p.mixed_precision
        paths = {}
        if p.profile_type == "computation":
            path = os.path.join(
                out_dir, f"computation_profiling_{precision}_{name}_all.json")
            write_json(self.profile_computation(), path)
            paths["computation"] = path
        else:
            path = os.path.join(
                out_dir, f"memory_profiling_{precision}_{name}_all.json")
            write_json(self.profile_memory(), path)
            paths["memory"] = path
        return paths


def _cpu_saved_bytes(step, params, opt_state, batch) -> int:
    """The CPU's "temps" of one step: the bytes of the distinct storages
    the autograd graph saves for the backward."""
    saved: Dict[int, int] = {}

    def pack(t):
        st = t.untyped_storage()
        saved[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        step(params, opt_state, batch)
    return sum(saved.values())
