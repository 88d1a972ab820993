"""Serving engine: paged prefill / decode programs + the continuous
batching loop, on one device.

Port of ``hetu_galvatron_tpu/serving/engine.py`` (``ServingEngine`` :153).
The JAX engine jits a small set of programs; here each is an eager
function of fixed input shapes, run under ``no_grad``:

* **prefill** (one per length bucket): one request's right-padded,
  bucketed prompt through the stack, the attention of
  ``models/generate.prefill`` (``modules.xla_sdpa``), k/v written into the
  request's pool blocks, the first token sampled from the last real
  position's logits.
* **prefix prefill** (``serving.prefix_cache``): the same over the
  uncached suffix of a prompt whose block-aligned prefix the radix cache
  (``prefix_cache.py``) holds: queries are the suffix bucket, keys the
  slot's gathered block table. A fully cached prompt dispatches no
  prefill: its slot enters at ``pos = len-1`` and the next decode step
  gives its first token.
* **decode**: one token for every slot at the fixed batch shape
  ``[max_batch_size]``, per-slot positions, block tables and sampling
  parameters. Retired lanes write the scratch block and their outputs are
  dropped, so admission and retirement never change the decode shape
  (:meth:`program_shapes` records the shapes each program ran at).
* **verify** (``serving.spec_decode``): every slot's ``[last_token,
  draft_1..draft_K]`` at the fixed shape ``[max_batch_size, K+1]``;
  greedy acceptance keeps the stream equal to plain decode.
* **copy-on-write**: duplicates one block in every layer's pool.

Prefill, decode and verify attention all go through
``models/generate._cached_sdpa`` (``kv_cache.paged_sdpa`` /
``paged_sdpa_window``) or ``modules.xla_sdpa``, the plain attention the
offline ``generate`` runs: no kernel of ``ops/`` is launched here.

Weights are cast to the compute dtype once, at construction and in
:meth:`swap_weights` (``models/generate.cast_for_compute``): the JAX
engine casts them at each use inside its programs, which gives the same
bits.

Determinism: a request's stream depends only on (weights, prompt, its own
seed and temperature), never on its neighbours: greedy rows are argmax
rows, and a sampled row draws from a ``torch.Generator`` seeded from
(request seed, emitted-token index). JAX draws from threefry keys of the
same pair, so sampled streams differ between the packages; greedy
streams do not.

Host / device cadence: every step reads the sampled tokens back to the
host (they feed the streams and the retirement logic); nothing else syncs.
The background thread (:meth:`start`) sets the engine's CUDA device and
launches on the stream current at construction.

Not ported: mesh serving (``mesh`` / ``hpc`` / ``axes_tree``: plan-sharded
weights and pools) raises by name; ``step_jaxprs``, ``compile_count`` and
``maybe_record_jit_cost`` read XLA programs, which eager PyTorch has none
of.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs, ServingArgs
from hetu_galvatron_tpu_torch.models import modules as M
from hetu_galvatron_tpu_torch.models.builder import named_leaves
from hetu_galvatron_tpu_torch.models.generate import (
    _embed_at,
    _gumbel_pick,
    cast_for_compute,
)
from hetu_galvatron_tpu_torch.observability.events import EventStream
from hetu_galvatron_tpu_torch.observability.recorder import FlightRecorder
from hetu_galvatron_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
)
from hetu_galvatron_tpu_torch.serving.kv_cache import (
    SCRATCH_BLOCK,
    PagedKVCache,
    copy_block,
    gather_pages,
    paged_sdpa,
    paged_sdpa_window,
    resolve_num_blocks,
    scatter_prefill,
    scatter_token,
    scatter_window,
)
from hetu_galvatron_tpu_torch.serving.prefix_cache import PrefixCache
from hetu_galvatron_tpu_torch.serving.scheduler import (
    Request,
    RequestHandle,
    Scheduler,
    Slot,
)
from hetu_galvatron_tpu_torch.serving.spec_decode import (
    accept_length,
    make_draft,
)

Params = Dict[str, Any]
NEG = M.NEG_INF


class WeightSwapError(ValueError):
    """``swap_weights`` rejected the new checkpoint: its tree structure,
    shapes or dtypes differ from the serving model's. A hot swap replaces
    values only (the same architecture)."""


def _check_supported(cfg: ModelArgs, params: Params) -> None:
    if cfg.post_norm or cfg.model_type in ("bert", "t5"):
        raise NotImplementedError(
            "ServingEngine serves dense causal decoder families; bert/t5 "
            "have no paged decode path")
    if any("moe" in lp for lp in params["layers"]):
        raise NotImplementedError("ServingEngine: dense layers only")


def default_buckets(block_size: int, cap_tokens: int) -> List[int]:
    """Every prefill bucket ``bucket_length`` can produce: the
    power-of-two ladder plus the capped top bucket."""
    out = []
    b = block_size
    while b < cap_tokens:
        out.append(b)
        b *= 2
    out.append(cap_tokens)
    return out


def _signature(params: Params):
    """(leaf names, shapes, dtypes) of a weight tree: what a hot swap must
    keep."""
    return [(name, tuple(t.shape), t.dtype)
            for name, t in named_leaves(params)]


def request_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of one sampled token: seeded from (request seed,
    emitted-token index), so a request's draws depend on nothing else."""
    mixed = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFFFFFFFFFF, int(index)]).generate_state(
            1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(
        int(mixed) & 0x7FFFFFFFFFFFFFFF)


def _make_sampler(valid: torch.Tensor, top_k: Optional[int]):
    """[S, V] logits -> [S] tokens. Greedy rows (temperature <= 0) take
    the argmax; a sampled row draws from :func:`request_generator` of its
    (seed, index), after temperature and top-k. Vocab-padding columns
    (``valid`` False) are never produced
    (``models/generate._sample_pick``)."""

    def sample(logits: torch.Tensor, temps: Sequence[float],
               seeds: Sequence[int], gen_idx: Sequence[int]
               ) -> torch.Tensor:
        logits = torch.where(valid, logits.float(), NEG)
        out = torch.argmax(logits, dim=-1)
        for i, t in enumerate(temps):
            if t <= 0.0:
                continue
            ll = logits[i] / max(float(t), 1e-6)
            if top_k:
                kth = torch.topk(ll, top_k).values[-1]
                ll = torch.where(ll < kth, NEG, ll)
            gen = request_generator(seeds[i], gen_idx[i], logits.device)
            out[i] = _gumbel_pick(ll[None], gen)[0]
        return out

    return sample


class ServingEngine:
    """Continuous-batching inference over one loaded model on one device
    (the device of ``params``).

    ``submit()`` returns a :class:`~hetu_galvatron_tpu_torch.serving.
    scheduler.RequestHandle` streaming tokens; drive the loop with
    :meth:`step` / :meth:`run_until_idle`, or :meth:`start` a background
    thread. ``logits_hook(rid, index, logits)`` (a debug hook, None on the
    main path) sees the fp32 logits row each emitted token was picked
    from.
    """

    def __init__(
        self,
        params: Params,
        cfg: ModelArgs,
        serving: Optional[ServingArgs] = None,
        *,
        mesh=None,
        hpc=None,
        axes_tree: Optional[Params] = None,
        registry: Optional[MetricsRegistry] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        kv_dtype: Optional[torch.dtype] = None,
        draft_params: Optional[Params] = None,
        draft_cfg: Optional[ModelArgs] = None,
    ):
        serving = serving if serving is not None else ServingArgs()
        _check_supported(cfg, params)
        if mesh is not None or hpc is not None or axes_tree is not None:
            raise NotImplementedError(
                "mesh serving (mesh= / hpc= / axes_tree=: plan-sharded "
                "weights and KV pools) is not ported to "
                "hetu_galvatron_tpu_torch; the engine serves on one device")
        self.cfg = cfg
        self.serving = serving
        self.registry = registry if registry is not None else get_registry()
        self.compute_dtype = compute_dtype
        self.S = int(serving.max_batch_size)
        self.device = params["embed"]["wte"].device
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._sig = _signature(params)
        self.params, self._head_wte = self._compute_copy(params)

        max_seq_len = serving.max_seq_len or cfg.max_position_embeddings
        num_blocks = resolve_num_blocks(serving, cfg)
        self.kv = PagedKVCache(
            cfg, num_blocks=num_blocks, block_size=serving.kv_block_size,
            max_seq_len=max_seq_len,
            dtype=kv_dtype if kv_dtype is not None else compute_dtype,
            device=self.device)
        from hetu_galvatron_tpu_torch.observability.telemetry import (
            model_flops_per_token,
        )

        self.prefix: Optional[PrefixCache] = None
        if serving.prefix_cache:
            self.prefix = PrefixCache(
                self.kv.allocator, self.kv.block_size,
                max_blocks=serving.prefix_cache_max_blocks)
        # request events reach the sink only under trace_requests; the
        # flight recorder taps them when tracing is on or a dump directory
        # is set
        self.events = EventStream(self.registry,
                                  enabled=serving.trace_requests)
        self.recorder = FlightRecorder(
            registry=self.registry, out_dir=serving.flight_dir,
            capacity=serving.flight_events)
        if serving.trace_requests or serving.flight_dir:
            self.recorder.attach(self.events)
        self.scheduler = Scheduler(
            self.kv, max_slots=self.S,
            max_position_embeddings=cfg.max_position_embeddings,
            prefill_flops_budget=serving.prefill_flops_budget_g * 1e9,
            # the cost model counts forward + backward (backward 2x);
            # prefill is forward only
            flops_per_token=model_flops_per_token(cfg) / 3.0,
            max_prefill_tokens=serving.max_prefill_tokens,
            prefix_cache=self.prefix, events=self.events)

        # rope / position rows cover every storable position
        self._table_len = self.kv.max_blocks_per_seq * self.kv.block_size
        self._rope = None
        if cfg.position_embedding_type == "rope":
            self._rope = M.rope_cos_sin(self._table_len, cfg.head_dim,
                                        cfg.rope_theta, device=self.device,
                                        scaling=cfg.rope_scaling)
        self._valid = torch.arange(cfg.padded_vocab_size,
                                   device=self.device) < cfg.vocab_size
        self._sample = _make_sampler(self._valid, serving.top_k)
        if serving.spec_decode and serving.spec_k < 1:
            raise ValueError(f"serving.spec_k must be >= 1, "
                             f"got {serving.spec_k}")
        self._draft = make_draft(serving, draft_params=draft_params,
                                 draft_cfg=draft_cfg)
        self._drafted_total = 0
        self._accepted_total = 0
        self._shapes: Dict[str, set] = {}
        self.logits_hook: Optional[Callable[[int, int, torch.Tensor],
                                            None]] = None

        self.metrics_server = None
        self.metrics_port: Optional[int] = None
        if serving.metrics_port is not None:
            from hetu_galvatron_tpu_torch.observability.prometheus import (
                MetricsHTTPServer,
            )

            self.metrics_server = MetricsHTTPServer(
                self.registry, port=int(serving.metrics_port),
                host=serving.metrics_host)
            self.metrics_port = self.metrics_server.start()

        self._ttft_n = self._ttft_ok = 0
        self._itl_n = self._itl_ok = 0
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._steps = 0
        self._emitted_window: List[tuple] = []  # (t, cumulative tokens)
        self._emitted_total = 0
        self._closed = False
        self.error: Optional[BaseException] = None  # fatal thread error

    def _compute_copy(self, params: Params):
        """``params`` cast for compute on the engine's device, and the
        head's weight (a tied head multiplies by wte in the compute dtype:
        cast once too)."""
        tree = _to_device(cast_for_compute(params, self.compute_dtype),
                          self.device)
        wte = tree["embed"]["wte"]
        return tree, (wte if "whead" in tree["head"]
                      else wte.to(self.compute_dtype))

    # -- programs -----------------------------------------------------------

    def _note_shapes(self, name: str, *tensors: torch.Tensor) -> None:
        self._shapes.setdefault(name, set()).add(
            tuple(tuple(t.shape) for t in tensors))

    def program_shapes(self) -> Dict[str, set]:
        """The input shapes each program ran at: ``decode`` and ``verify``
        keep one shape whatever the admissions and retirements; a prefill
        has one per bucket (``prefill_<b>`` / ``prefix_prefill_<b>``)."""
        return {k: set(v) for k, v in self._shapes.items()}

    def _layer_stack(self, x: torch.Tensor, rope, sdpa_for) -> torch.Tensor:
        """The decoder stack, layer i with the attention closure
        ``sdpa_for(i)`` over pools[i]; returns fp32 logits."""
        cfg, p = self.cfg, self.params
        for i, lp in enumerate(p["layers"]):
            x = M.apply_decoder_layer(lp, x, cfg, rope=rope,
                                      sdpa_fn=sdpa_for(i),
                                      compute_dtype=self.compute_dtype)
        x = M.apply_norm(p["prenorm"], x, cfg)
        return M.apply_lm_head(p["head"], x, cfg, wte=self._head_wte,
                               compute_dtype=self.compute_dtype)

    def _positions(self, pos: torch.Tensor):
        """Learned-position ids clipped to the table (None for rope)."""
        if "wpe" not in self.params["embed"]:
            return None
        return pos.clamp_max(self.cfg.max_position_embeddings - 1)

    def _prefill(self, tokens: torch.Tensor, table: torch.Tensor,
                 true_len: int) -> torch.Tensor:
        """tokens [1, bucket], table [bucket // bs] -> logits of the last
        real position [1, V]. Causal attention over the right-padded
        prompt (pad rows never reach rows < true_len); k/v scattered into
        the slot's blocks."""
        bucket = tokens.shape[1]
        self._note_shapes(f"prefill_{bucket}", tokens, table)
        rope = None
        if self._rope is not None:
            rope = (self._rope[0][:bucket], self._rope[1][:bucket])
        ar = torch.arange(bucket, device=self.device)
        pos_ids = self._positions(ar)
        x = M.apply_embedding(self.params["embed"], tokens, self.cfg,
                              compute_dtype=self.compute_dtype,
                              position_ids=(None if pos_ids is None
                                            else pos_ids[None]))

        def sdpa_for(i):
            pool = self.kv.pools[i]

            def sdpa(q, k, v, *, causal=True):
                scatter_prefill(pool["k"], k[0], table)
                scatter_prefill(pool["v"], v[0], table)
                return M.xla_sdpa(q, k, v, causal=causal)

            return sdpa

        logits = self._layer_stack(x, rope, sdpa_for)
        return logits[0, true_len - 1:true_len]

    def _prefix_prefill(self, tokens: torch.Tensor, table: torch.Tensor,
                        ctx: int, true_len: int) -> torch.Tensor:
        """tokens [1, bucket] (the uncached suffix at absolute positions
        ctx..), table [MB] (the slot's whole table) -> logits of the last
        real position [1, V]. Keys are the assembled pages, masked per row
        (``paged_sdpa_window``); suffix lanes past the table's capacity
        write to scratch."""
        bucket = tokens.shape[1]
        self._note_shapes(f"prefix_prefill_{bucket}", tokens, table)
        bs = self.kv.block_size
        MB = self.kv.max_blocks_per_seq
        p_j = ctx + torch.arange(bucket, device=self.device)
        rope = None
        if self._rope is not None:
            pc = p_j.clamp_max(self._table_len - 1)
            rope = (self._rope[0][pc], self._rope[1][pc])
        pos_ids = self._positions(p_j)
        x = M.apply_embedding(self.params["embed"], tokens, self.cfg,
                              compute_dtype=self.compute_dtype,
                              position_ids=(None if pos_ids is None
                                            else pos_ids[None]))
        idx = ctx // bs + torch.arange(bucket // bs, device=self.device)
        sblocks = torch.where(idx < MB, table[idx.clamp_max(MB - 1)],
                              SCRATCH_BLOCK)

        def sdpa_for(i):
            pool = self.kv.pools[i]

            def sdpa(q, k, v, *, causal=True):
                scatter_prefill(pool["k"], k[0], sblocks)
                scatter_prefill(pool["v"], v[0], sblocks)
                ck = gather_pages(pool["k"], table[None])
                cv = gather_pages(pool["v"], table[None])
                return paged_sdpa_window(q, ck, cv, ctx)

            return sdpa

        logits = self._layer_stack(x, rope, sdpa_for)
        return logits[0, true_len - 1:true_len]

    def _state_tensors(self, state) -> torch.Tensor:
        """tokens, pos and tables of a decode state as one [S, 2 + MB]
        int64 tensor on the device (one host-to-device copy)."""
        arr = np.empty((self.S, 2 + self.kv.max_blocks_per_seq), np.int64)
        arr[:, 0] = state["pos"]
        arr[:, 1] = state["tokens"]
        arr[:, 2:] = state["tables"]
        return torch.from_numpy(arr).to(self.device)

    def _decode(self, state) -> torch.Tensor:
        """One token for every lane: -> logits [S, V]."""
        st = self._state_tensors(state)
        pos, tokens, tables = st[:, 0], st[:, 1], st[:, 2:]
        self._note_shapes("decode", tokens, pos, tables)
        bs = self.kv.block_size
        x = _embed_at(self.params["embed"], tokens, pos, self.cfg,
                      self.compute_dtype, shift=torch.zeros_like(pos))
        rope = None
        if self._rope is not None:
            rope = (self._rope[0][pos][:, None], self._rope[1][pos][:, None])
        blks = tables[torch.arange(self.S, device=self.device), pos // bs]
        offs = pos % bs

        def sdpa_for(i):
            pool = self.kv.pools[i]

            def sdpa(q, k, v, *, causal=True):
                scatter_token(pool["k"], k[:, 0], blks, offs)
                scatter_token(pool["v"], v[:, 0], blks, offs)
                ck = gather_pages(pool["k"], tables)
                cv = gather_pages(pool["v"], tables)
                return paged_sdpa(q, ck, cv, pos)

            return sdpa

        return self._layer_stack(x, rope, sdpa_for)[:, 0]

    def _verify(self, state, drafted: List[List[int]]) -> torch.Tensor:
        """The speculative window: lane s's tokens are [last_token,
        draft_1..draft_K] at positions pos..pos+K -> logits [S, K+1, V];
        row j is the model's view after the drafts before j. Writes past a
        lane's budget (``limit``) land on the scratch block. The embedding
        mirrors ``models/generate._embed_at``."""
        cfg = self.cfg
        K1 = int(self.serving.spec_k) + 1
        bs = self.kv.block_size
        st = self._state_tensors(state)
        pos, tables = st[:, 0], st[:, 2:]
        window = torch.as_tensor(
            [[t] + list(d) for t, d in zip(state["tokens"], drafted)],
            dtype=torch.long).to(self.device)
        limit = torch.as_tensor(state["limit"],
                                dtype=torch.long).to(self.device)
        self._note_shapes("verify", window, pos, tables, limit)
        p_j = pos[:, None] + torch.arange(K1, device=self.device)[None, :]
        pc = p_j.clamp_max(self._table_len - 1)
        emb = self.params["embed"]
        x = emb["wte"][window]
        if "wpe" in emb:
            x = x + emb["wpe"][p_j.clamp_max(cfg.max_position_embeddings - 1)]
        if "ln" in emb:
            x = M.apply_norm(emb["ln"], x, cfg)
        if cfg.scale_embeddings:
            x = x * torch.tensor(float(cfg.hidden_size), dtype=torch.float32,
                                 device=x.device).sqrt().to(x.dtype)
        x = x.to(self.compute_dtype)
        rope = None
        if self._rope is not None:
            rope = (self._rope[0][pc], self._rope[1][pc])
        write_ok = p_j <= limit[:, None]
        lanes = torch.arange(self.S, device=self.device)[:, None]
        blks = torch.where(write_ok, tables[lanes, pc // bs], SCRATCH_BLOCK)
        offs = pc % bs

        def sdpa_for(i):
            pool = self.kv.pools[i]

            def sdpa(q, k, v, *, causal=True):
                scatter_window(pool["k"], k, blks, offs)
                scatter_window(pool["v"], v, blks, offs)
                ck = gather_pages(pool["k"], tables)
                cv = gather_pages(pool["v"], tables)
                return paged_sdpa_window(q, ck, cv, pos)

            return sdpa

        return self._layer_stack(x, rope, sdpa_for)

    def _cow_copy(self, src: int, dst: int) -> None:
        """Duplicate one block in every layer's k/v pool: the copy-on-write
        a fully cached prompt needs before its bootstrap decode step
        rewrites the last prompt position (a shared block)."""
        for pool in self.kv.pools:
            copy_block(pool["k"], src, dst)
            copy_block(pool["v"], src, dst)

    @torch.no_grad()
    def warmup(self, buckets: Optional[List[int]] = None) -> None:
        """Run every program traffic can reach once (decode, and under
        spec decode verify, the given prefill buckets, defaulting to every
        bucket up to the per-sequence capacity, their prefix twins and the
        copy-on-write), so the first requests do not pay for the
        allocator's and the libraries' first calls. Warm-up writes only
        the scratch block: a warm engine is still empty."""
        if buckets is None:
            buckets = default_buckets(self.kv.block_size, self._table_len)
        bs = self.kv.block_size
        for b in buckets:
            toks = torch.zeros((1, b), dtype=torch.long, device=self.device)
            table = torch.zeros((b // bs,), dtype=torch.long,
                                device=self.device)
            self._sample(self._prefill(toks, table, 1), [0.0], [0],
                         [0]).tolist()
            if self.prefix is not None:
                full = torch.zeros((self.kv.max_blocks_per_seq,),
                                   dtype=torch.long, device=self.device)
                self._sample(self._prefix_prefill(toks, full, 0, 1), [0.0],
                             [0], [0]).tolist()
        if self.prefix is not None:
            self._cow_copy(SCRATCH_BLOCK, SCRATCH_BLOCK)
        state = self.scheduler.decode_state()
        if self._draft is not None:
            drafted = [[0] * int(self.serving.spec_k)
                       for _ in range(self.S)]
            torch.argmax(self._verify(state, drafted), dim=-1).tolist()
        self._sample(self._decode(state), state["temps"], state["seeds"],
                     state["gen_idx"]).tolist()

    # -- zero-downtime weight swap ------------------------------------------

    @torch.no_grad()
    def swap_weights(self, new_params: Params) -> float:
        """Hot-swap the serving weights without dropping a request.

        The new tree is checked (the same leaf names, shapes and dtypes as
        the tree the engine was built with, else :class:`WeightSwapError`)
        and cast to the compute dtype off the serving lock, so for a
        moment both copies are resident. Only the pointer flip and the
        prefix-cache invalidation hold the lock; that stall is returned in
        milliseconds and observed as ``serve/swap_stall_ms``.

        In-flight requests keep their KV (computed under the old weights)
        and finish decoding under the new ones. Requests admitted after
        the swap run entirely under the new weights and equal a fresh
        engine's streams: the radix prefix cache is invalidated at the
        flip, and the programs' shapes do not change."""
        try:
            sig = _signature(new_params)
        except (AttributeError, KeyError, TypeError) as e:
            raise WeightSwapError(
                f"new checkpoint's tree structure differs from the "
                f"serving model's: {e}") from e
        names_old = [s[0] for s in self._sig]
        names_new = [s[0] for s in sig]
        if names_old != names_new:
            raise WeightSwapError(
                "new checkpoint's tree structure differs from the serving "
                f"model's (leaves {sorted(set(names_old) ^ set(names_new))})")
        if sig != self._sig:
            raise WeightSwapError(
                "new checkpoint's shapes/dtypes differ from the serving "
                "model's — a hot swap may only replace values; start a "
                "new engine for a different architecture")
        staged, head_wte = self._compute_copy(new_params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with self._lock:
            self.params = staged
            self._head_wte = head_wte
            dropped = 0
            if self.prefix is not None:
                dropped = self.prefix.invalidate()
            stall_ms = (time.perf_counter() - t0) * 1000.0
            self.registry.counter("serve/weight_swaps").inc()
            self.registry.histogram("serve/swap_stall_ms").observe(stall_ms)
            self.events.emit("weight_swap", stall_ms=stall_ms,
                             prefix_blocks_dropped=dropped)
        return stall_ms

    # -- the serving loop ---------------------------------------------------

    def submit(
        self,
        tokens: List[int],
        *,
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        eos_id: Optional[int] = "default",
        seed: int = 0,
        timeout_s: Optional[float] = None,
    ) -> RequestHandle:
        s = self.serving
        req = Request(
            tokens=[int(t) for t in tokens],
            max_new_tokens=int(max_new_tokens if max_new_tokens is not None
                               else s.max_new_tokens),
            temperature=float(temperature if temperature is not None
                              else s.temperature),
            eos_id=s.eos_id if eos_id == "default" else eos_id,
            seed=int(seed),
            timeout_s=float(timeout_s if timeout_s is not None
                            else s.request_timeout_s),
        )
        with self._lock:
            self.registry.counter("serve/requests_submitted").inc()
            if self.error is not None:
                # the engine thread is dead: resolve now rather than queue
                # work nothing will step
                handle = RequestHandle(req)
                handle._finish("error", f"engine error: {self.error}")
                self.registry.counter("serve/requests_rejected").inc()
                self.events.emit("submit", req.rid,
                                 prompt_len=len(req.tokens),
                                 max_new=req.max_new_tokens)
                self.events.emit("retire", req.rid, status="error",
                                 reason="engine dead", generated=0)
                return handle
            handle = self.scheduler.submit(req)
            if handle.status == "rejected":
                self.registry.counter("serve/requests_rejected").inc()
            return handle

    @torch.no_grad()
    def step(self) -> bool:
        """One engine iteration: sweep retirements, admit and prefill the
        uncached suffixes (a fully cached prompt dispatches no prefill;
        the decode step gives its first token), one decode or verify step.
        Returns whether any work happened."""
        with self._lock:
            did = self._sweep() > 0
            admitted = self.scheduler.admit()
            for slot, bucket in admitted:
                h = slot.handle
                if h.admitted_t is not None:
                    self.registry.histogram("serve/queue_wait_ms").observe(
                        (h.admitted_t - h.submitted_t) * 1000.0)
                if slot.cached_len:
                    self.registry.counter("serve/prefix_hits").inc()
                    self.registry.counter("serve/prefix_cached_tokens").inc(
                        slot.cached_len)
                if slot.cow is not None:
                    self._cow_copy(*slot.cow)
                    slot.cow = None
                if bucket:
                    self._prefill_slot(slot, bucket)
                else:
                    self.scheduler.note_prefilled(slot)
                did = True
            if self.scheduler.slots:
                self._decode_active()
                did = True
            if did:
                # idle iterations advance nothing
                self._steps += 1
                self._telemetry_step()
        return did

    def run_until_idle(self, max_steps: int = 1_000_000) -> None:
        for _ in range(max_steps):
            if not self.scheduler.has_work():
                break
            self.step()
        self.flush()

    def start(self) -> None:
        """Background serving thread (sleeps 1 ms when idle). A step that
        raises aborts every in-flight and queued request with status
        "error": handles never block forever on a dead engine thread."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with (torch.cuda.stream(self._stream)
                  if self._stream is not None else contextlib.nullcontext()):
                while not self._stop.is_set():
                    try:
                        did = self.step()
                    except Exception as e:  # noqa: BLE001 — must resolve
                        self._abort(e)
                        return
                    if not did:
                        time.sleep(0.001)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="serving-engine")
        self._thread.start()

    def _abort(self, exc: BaseException) -> None:
        """Resolve every outstanding handle after a fatal engine error:
        ``serve/errors`` by exception class, a retire event per request,
        and a flight-recorder dump (which never raises)."""
        self.error = exc
        with self._lock:
            self.registry.counter("serve/engine_errors").inc()
            self.registry.counter("serve/errors",
                                  error=type(exc).__name__).inc()
            self.events.emit("engine_error", error=type(exc).__name__,
                             message=str(exc))
            for slot in list(self.scheduler.slots.values()):
                self.scheduler.retire(slot, "error", f"engine error: {exc}")
            for h in self.scheduler.waiting:
                h._finish("error", f"engine error: {exc}")
                self.events.emit("retire", h.request.rid, status="error",
                                 reason="engine error", generated=0,
                                 queued=True)
            self.scheduler.waiting = []
            self.recorder.dump("engine_error", exc=exc)

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        self.flush()

    # -- internals ----------------------------------------------------------

    def _sweep(self) -> int:
        """Retire cancelled / expired work, active and queued; both count
        toward the cancel / timeout metrics."""
        now = time.monotonic()
        sc, st = self.scheduler.sweep(now)
        wc, wt = self.scheduler.sweep_waiting(now)
        if sc + wc:
            self.registry.counter("serve/requests_cancelled").inc(sc + wc)
        if st + wt:
            self.registry.counter("serve/requests_timeout").inc(st + wt)
        return sc + st + wc + wt

    def _prefill_slot(self, slot: Slot, bucket: int) -> None:
        t0 = time.perf_counter()
        req = slot.request
        prompt_len = len(req.tokens)
        cached = slot.cached_len
        suffix = req.tokens[cached:]
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(suffix)] = suffix
        toks = torch.from_numpy(padded).to(self.device)
        if cached:
            full = torch.as_tensor(self.scheduler.padded_table(slot.blocks),
                                   dtype=torch.long).to(self.device)
            logits = self._prefix_prefill(toks, full, cached, len(suffix))
        else:
            table = torch.as_tensor(
                slot.blocks[: bucket // self.kv.block_size],
                dtype=torch.long).to(self.device)
            logits = self._prefill(toks, table, prompt_len)
        tok = int(self._sample(logits, [req.temperature], [req.seed],
                               [0]).item())
        if self.logits_hook is not None:
            self.logits_hook(req.rid, 0, logits[0])
        # dispatch-to-sync host wall of this prefill: the TTFT split reads
        # it, so it is set before the first-token emit
        slot.prefill_ms = (time.perf_counter() - t0) * 1000.0
        self.registry.counter("serve/prefill_tokens").inc(len(suffix))
        self.events.emit("prefill", req.rid, bucket=bucket,
                         suffix=len(suffix), cached=cached,
                         ms=slot.prefill_ms)
        # the radix tree adopts the prompt's blocks before the first token
        # can retire the request: a one-token budget (or an eos first
        # token) would otherwise release them first. JAX adopts after the
        # emit and raises BlockAccountingError there
        self.scheduler.note_prefilled(slot)
        self._emit(slot, tok, first=True)

    def _decode_active(self) -> None:
        if self._draft is not None and any(
                s.request.temperature <= 0.0
                for s in self.scheduler.slots.values()):
            # a greedy lane can profit from drafts; sampled lanes ride
            # along untouched
            self._verify_active()
            return
        state = self.scheduler.decode_state()
        logits = self._decode(state)
        toks = self._sample(logits, state["temps"], state["seeds"],
                            state["gen_idx"]).tolist()
        for slot in list(self.scheduler.slots.values()):
            slot.pos += 1
            self.events.emit("decode", slot.request.rid, pos=slot.pos, n=1)
            if self.logits_hook is not None:
                self.logits_hook(slot.request.rid, slot.generated,
                                 logits[slot.index])
            # a fully cached prompt skipped prefill: its first token comes
            # from this decode step (TTFT records here)
            self._emit(slot, int(toks[slot.index]),
                       first=slot.generated == 0)
        self.registry.counter("serve/decode_tokens").inc(
            sum(state["active"]))

    def _verify_active(self) -> None:
        """One speculative step: draft K tokens per greedy lane (host),
        verify the window in one fixed-shape pass, emit the accepted
        prefix and the bonus token. Sampled lanes do not speculate."""
        K = int(self.serving.spec_k)
        state = self.scheduler.decode_state()
        slots = list(self.scheduler.slots.values())
        drafted = [[0] * K for _ in range(self.S)]
        for slot in slots:
            if slot.request.temperature > 0.0:
                continue
            ctx = list(slot.request.tokens) + slot.handle.output
            prop = list(self._draft.propose(ctx, K))[:K]
            drafted[slot.index][: len(prop)] = prop
        logits = self._verify(state, drafted)
        out = torch.argmax(torch.where(self._valid, logits, NEG), dim=-1)
        for i, t in enumerate(state["temps"]):
            if t > 0.0:
                for j in range(K + 1):
                    out[i, j] = self._sample(
                        logits[i:i + 1, j], [t], [state["seeds"][i]],
                        [state["gen_idx"][i] + j])[0]
        out = out.tolist()
        emitted = 0
        for slot in slots:
            req = slot.request
            row = out[slot.index]
            budget = req.max_new_tokens - slot.generated
            k_eff = (min(K, max(budget - 1, 0))
                     if req.temperature <= 0.0 else 0)
            a = accept_length(drafted[slot.index], row, k_eff)
            self.events.emit("verify", req.rid, drafted=k_eff, accepted=a)
            if req.temperature <= 0.0:
                self._drafted_total += K
                self._accepted_total += a
                self.registry.counter("serve/drafted_tokens").inc(K)
            if a:
                self.registry.counter("serve/spec_accepted_tokens").inc(a)
            for j, tok in enumerate(row[: a + 1]):
                slot.pos += 1
                if self.logits_hook is not None:
                    self.logits_hook(req.rid, slot.generated,
                                     logits[slot.index, j])
                self._emit(slot, int(tok), first=slot.generated == 0)
                emitted += 1
                if slot.index not in self.scheduler.slots:
                    break  # retired (eos / length) mid-window
        self.registry.counter("serve/decode_tokens").inc(emitted)

    def _emit(self, slot: Slot, tok: int, first: bool = False) -> None:
        """Record one generated token: stream it, time it, retire on eos or
        the length budget."""
        req = slot.request
        now = time.monotonic()
        slot.generated += 1
        slot.last_token = tok
        h = slot.handle
        if first:
            ttft_ms = (now - h.submitted_t) * 1000.0
            self.registry.histogram("serve/ttft_ms").observe(ttft_ms)
            self._ttft_n += 1
            if ttft_ms <= self.serving.slo_ttft_ms:
                self._ttft_ok += 1
            # additive TTFT split: queue + prefill + decode (the residual)
            queue_ms = ((h.admitted_t - h.submitted_t) * 1000.0
                        if h.admitted_t is not None else 0.0)
            self.events.emit(
                "first_token", req.rid, ttft_ms=ttft_ms, queue_ms=queue_ms,
                prefill_ms=slot.prefill_ms,
                decode_ms=max(ttft_ms - queue_ms - slot.prefill_ms, 0.0))
        else:
            itl_ms = (now - slot.last_token_t) * 1000.0
            self.registry.histogram("serve/itl_ms").observe(itl_ms)
            self._itl_n += 1
            if itl_ms <= self.serving.slo_itl_ms:
                self._itl_ok += 1
        slot.last_token_t = now
        slot.handle._emit(tok)
        self._emitted_total += 1
        if req.eos_id is not None and tok == req.eos_id:
            self.scheduler.retire(slot, "done", "eos")
            self.registry.counter("serve/requests_completed").inc()
        elif slot.generated >= req.max_new_tokens:
            self.scheduler.retire(slot, "done", "length")
            self.registry.counter("serve/requests_completed").inc()

    # -- telemetry ----------------------------------------------------------

    def _telemetry_step(self) -> None:
        reg = self.registry
        reg.counter("serve/steps").inc()
        if self.metrics_server is not None:
            self.metrics_server.note_step()  # /healthz last-step age
        now = time.monotonic()
        self._emitted_window.append((now, self._emitted_total))
        if len(self._emitted_window) > 64:
            self._emitted_window = self._emitted_window[-64:]
        if self._steps % max(self.serving.flush_interval, 1) == 0:
            self.flush()

    def tokens_per_sec(self) -> float:
        w = self._emitted_window
        if len(w) < 2 or w[-1][0] <= w[0][0]:
            return 0.0
        return (w[-1][1] - w[0][1]) / (w[-1][0] - w[0][0])

    def spec_accept_rate(self) -> float:
        """Fraction of drafted tokens the verify pass accepted (0 when spec
        decode is off or nothing was drafted yet)."""
        if not self._drafted_total:
            return 0.0
        return self._accepted_total / self._drafted_total

    def defrag(self) -> None:
        """Compact live pool blocks to the low ids; the scheduler rewrites
        every referencing table (active sequences and radix nodes)."""
        with self._lock:
            self.scheduler.defrag()

    def flush(self) -> None:
        reg = self.registry
        reg.gauge("serve/queue_depth").set(self.scheduler.queue_depth)
        reg.gauge("serve/active_requests").set(len(self.scheduler.slots))
        reg.gauge("serve/kv_occupancy").set(self.kv.occupancy)
        reg.gauge("serve/kv_blocks_used").set(self.kv.allocator.used)
        reg.gauge("serve/tokens_per_sec").set(self.tokens_per_sec())
        # the eager counterpart of the jit cache size: distinct (program,
        # input shapes) pairs run so far
        reg.gauge("serve/jit_programs").set(
            sum(len(v) for v in self._shapes.values()))
        if self.prefix is not None:
            reg.gauge("serve/prefix_hit_rate").set(self.prefix.hit_rate)
            reg.gauge("serve/prefix_cache_blocks").set(
                self.prefix.blocks_held)
        if self._draft is not None:
            reg.gauge("serve/spec_accept_rate").set(self.spec_accept_rate())
        if self.serving.slo_ttft_ms > 0:
            reg.gauge("serve/slo_ttft_ms").set(self.serving.slo_ttft_ms)
            reg.gauge("serve/slo_ttft_attainment").set(
                self._ttft_ok / self._ttft_n if self._ttft_n else 1.0)
        if self.serving.slo_itl_ms > 0:
            reg.gauge("serve/slo_itl_ms").set(self.serving.slo_itl_ms)
            reg.gauge("serve/slo_itl_attainment").set(
                self._itl_ok / self._itl_n if self._itl_n else 1.0)
        reg.flush(step=self._steps)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.stop()
        self.flush()
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return {k: _to_device(v, device) for k, v in tree.items()}
