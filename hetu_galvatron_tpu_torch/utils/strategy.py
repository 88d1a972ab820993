"""Per-layer parallel strategy representation and (de)serialization.

Port of ``hetu_galvatron_tpu/utils/strategy.py``: ``DPType``,
``LayerStrategy``, ``EmbeddingLMHeadStrategy``, ``PlanFormatError``, the
plan JSON converters ``strategy_list2config`` / ``config2strategy`` (:290),
``save_strategy_config`` / ``load_strategy_config`` and ``form_strategy``.
The plan JSON (``galvatron_config_*.json``) is byte-compatible with the JAX
package's: the same keys (pp_deg / tp_sizes_enc / tp_consecutive_flags /
dp_types_enc / use_sp / cp_sizes_enc / ep_sizes_enc / tp_of_ep_sizes_enc /
checkpoint / global_bsz / chunks / pp_division / pipeline_type /
default_dp_type / vtp / vsp / vcp / embed_sdp, the legacy ``etp_sizes_enc``
on read), the same order and the same ``json.dump(indent=4)``, so a plan
searched by either package trains in either.

A strategy names no rank or process group: it is a logical description,
which ``runtime/hybrid_config.py`` resolves for the device it runs on.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace
from enum import IntEnum
from typing import Any, Dict, List, Optional, Sequence, Tuple


class PlanFormatError(ValueError):
    """A strategy/plan JSON is malformed. Carries the offending ``key``
    (and optionally the file ``path``) so the plan doctor and the runtime
    can say WHICH field is broken instead of surfacing a raw
    KeyError/ValueError traceback from deep inside the parser."""

    def __init__(self, message: str, *, key: Optional[str] = None,
                 path: Optional[str] = None):
        prefix = f"plan file {path}: " if path else ""
        super().__init__(f"{prefix}{message}")
        self.key = key
        self.path = path


class DPType(IntEnum):
    """Data-parallel flavour for one layer.

    Mirrors the reference's ddp/zero2/zero3 choices (runtime/parallel.py:119-123):
      DDP   — parameters replicated across dp; gradients all-reduced (psum).
      ZERO2 — optimizer state + gradients sharded across dp (psum_scatter grads).
      ZERO3 — parameters fully sharded across dp; gathered on use.
    """

    DDP = 0
    ZERO2 = 1
    ZERO3 = 2

    @staticmethod
    def from_name(name: str) -> "DPType":
        return {"ddp": DPType.DDP, "zero2": DPType.ZERO2, "zero3": DPType.ZERO3}[
            name.lower()
        ]

    @property
    def short(self) -> str:
        return {DPType.DDP: "ddp", DPType.ZERO2: "zero2", DPType.ZERO3: "zero3"}[self]


@dataclass(frozen=True)
class LayerStrategy:
    """Parallel plan for a single transformer layer.

    world-per-stage invariant: tp_size * cp_size * dp_size == world_size // pp_deg
    (cp and sp are mutually exclusive with each other in the reference; when
    ``sp`` is set the tp degree is reinterpreted as the Ulysses sequence-parallel
    degree — hybrid_parallel_config.py:262-267).
    """

    pp_deg: int = 1
    tp_size: int = 1
    dp_size: int = 1
    cp_size: int = 1
    sp: bool = False  # Ulysses: all_to_all head-scatter attention on the tp axis
    tp_consecutive: bool = True  # tp over adjacent devices (ICI-local) or strided
    dp_type: DPType = DPType.DDP
    checkpoint: bool = False  # activation rematerialization for this layer
    # MoE only:
    ep_size: int = 1  # expert-parallel degree (experts sharded over dp*tp grid)
    etp_size: int = 1  # tensor-parallel degree inside each expert

    @property
    def degrees(self) -> int:
        return self.tp_size * self.cp_size * self.dp_size

    def world_size(self) -> int:
        return self.pp_deg * self.degrees

    def key(self) -> Tuple:
        """Hashable identity used for strategy dedup in the search engine."""
        return (
            self.pp_deg,
            self.tp_size,
            self.dp_size,
            self.cp_size,
            int(self.sp),
            int(self.tp_consecutive),
            int(self.dp_type),
            int(self.checkpoint),
            self.ep_size,
            self.etp_size,
        )

    def with_checkpoint(self, flag: bool) -> "LayerStrategy":
        return replace(self, checkpoint=flag)

    def validate(self, world_size: int) -> None:
        if self.world_size() != world_size:
            raise ValueError(
                f"strategy {form_strategy(self)}: pp*tp*cp*dp="
                f"{self.world_size()} != world_size {world_size}"
            )
        for n, v in (("pp_deg", self.pp_deg), ("tp_size", self.tp_size),
                     ("cp_size", self.cp_size), ("dp_size", self.dp_size),
                     ("ep_size", self.ep_size), ("etp_size", self.etp_size)):
            if v < 1 or (v & (v - 1)) != 0:
                raise ValueError(f"{n}={v} must be a positive power of two")
        if self.sp and self.cp_size > 1:
            raise ValueError("Ulysses sp and ring-attention cp are exclusive per layer")


@dataclass(frozen=True)
class EmbeddingLMHeadStrategy:
    """Strategy for the embedding + LM head ("vocab") layers, searched
    independently of the decoder layers (reference args_schema.py:36-39,
    parallel_state.py:183-305)."""

    vtp: int = 1  # vocab tensor-parallel degree
    vsp: bool = False  # shard the sequence at embedding/head (vocab sp)
    vcp: int = 1  # vocab context-parallel degree
    embed_sdp: bool = False  # ZeRO-3 the embedding/head instead of default dp type

    def key(self) -> Tuple:
        return (self.vtp, int(self.vsp), self.vcp, int(self.embed_sdp))


# ---------------------------------------------------------------------------
# strategy list <-> JSON interchange
# ---------------------------------------------------------------------------


def default_pp_division(num_layers: int, pp_deg: int) -> List[int]:
    """Even stage split with the remainder folded into the last stage, matching
    the reference default (avg*(pp-1) + rest) so sum == num_layers always."""
    pp_deg = max(pp_deg, 1)
    avg = num_layers // pp_deg
    return [avg] * (pp_deg - 1) + [num_layers - avg * (pp_deg - 1)]


def _enc(values: Sequence[Any]) -> str:
    return ",".join(str(int(v)) for v in values)


def _dec(s: str) -> List[int]:
    return [int(x) for x in str(s).split(",") if x != ""]


def strategy_list2config(
    strategies: Sequence[LayerStrategy],
    *,
    global_bsz: int,
    chunks: int,
    pipeline_type: str = "pipedream_flush",
    default_dp_type: str = "ddp",
    vocab: Optional[EmbeddingLMHeadStrategy] = None,
    pp_division: Optional[Sequence[int]] = None,
    num_encoder_layers: Optional[int] = None,
    vpp_deg: Optional[int] = None,
    predicted_layer_compute_ms: Optional[Sequence[float]] = None,
    hier_dp: Optional[bool] = None,
    hier_bucket_mb: float = 0.0,
    dp_schedule: Optional[str] = None,
) -> Dict[str, Any]:
    """Serialize per-layer strategies to the interchange dict.

    ``dp_types_enc`` keeps the reference encoding: 0 means "use
    ``default_dp_type``", 1 means "force ZeRO-3 for this layer". The one-bit
    format can only carry {default, ZERO3}; any other per-layer dp_type would
    be silently coerced on round-trip, so it raises instead.
    """
    if not strategies:
        raise ValueError("empty strategy list")
    pp_deg = strategies[0].pp_deg
    default_dp = DPType.from_name(default_dp_type)
    dp_types = []
    for i, s in enumerate(strategies):
        if s.pp_deg != pp_deg:
            raise ValueError("all layers must share one pp_deg")
        if s.dp_type == default_dp:
            dp_types.append(0)
        elif s.dp_type == DPType.ZERO3:
            dp_types.append(1)
        else:
            raise ValueError(
                f"layer {i}: dp_type {s.dp_type.short} is not representable in "
                f"dp_types_enc with default_dp_type={default_dp.short} "
                f"(only the default type or zero3 can be encoded)"
            )
    vocab = vocab or EmbeddingLMHeadStrategy()
    cfg: Dict[str, Any] = {
        "pp_deg": pp_deg,
        "tp_sizes_enc": _enc([s.tp_size for s in strategies]),
        "tp_consecutive_flags": _enc([s.tp_consecutive for s in strategies]),
        "dp_types_enc": _enc(dp_types),
        "use_sp": _enc([s.sp for s in strategies]),
        "cp_sizes_enc": _enc([s.cp_size for s in strategies]),
        "ep_sizes_enc": _enc([s.ep_size for s in strategies]),
        "tp_of_ep_sizes_enc": _enc([s.etp_size for s in strategies]),
        "checkpoint": _enc([s.checkpoint for s in strategies]),
        "global_bsz": int(global_bsz),
        "chunks": int(chunks),
        "pp_division": _enc(pp_division) if pp_division is not None
        else _enc(default_pp_division(len(strategies), pp_deg)),
        "pipeline_type": pipeline_type,
        "default_dp_type": default_dp.short,
        "vtp": vocab.vtp,
        "vsp": int(vocab.vsp),
        "vcp": vocab.vcp,
        "embed_sdp": int(vocab.embed_sdp),
    }
    if num_encoder_layers is not None:
        # encoder-decoder extension (no reference equivalent — the reference
        # snapshot ships no T5): the per-layer vectors span the COMBINED
        # encoder+decoder stack, encoder layers first; this key records the
        # split point so the runtime can slice.
        cfg["num_encoder_layers"] = int(num_encoder_layers)
    if vpp_deg is not None and vpp_deg > 1:
        # interleaved virtual stages (beyond the reference): pp_division then
        # has pp_deg * vpp_deg entries, chunk c on physical group c % pp_deg
        cfg["vpp_deg"] = int(vpp_deg)
    if predicted_layer_compute_ms is not None:
        # the cost model's per-layer COMPUTE prediction (fct+bct ms, no
        # collectives — those are re-priced from plan_comm_volume at audit
        # time), embedded so the runtime's plan audit diffs the exact model
        # that picked the plan without needing the profile files
        if len(predicted_layer_compute_ms) != len(strategies):
            raise ValueError(
                f"predicted_layer_compute_ms has "
                f"{len(predicted_layer_compute_ms)} entries for "
                f"{len(strategies)} layers")
        cfg["predicted_layer_compute_ms"] = [
            float(x) for x in predicted_layer_compute_ms]
    if hier_dp:
        # the search priced this plan's dp gradient reduction with the
        # hierarchical two-level schedule (ops/hier_reduce.py); the runtime
        # enables the matching execution path (args.parallel.hier_dp ORs in)
        cfg["hier_dp"] = 1
        if hier_bucket_mb > 0:
            # ...and pipelined it at this bucket granularity
            # (cost.hier_dp_best_bucket); the runtime buckets identically
            cfg["hier_bucket_mb"] = float(hier_bucket_mb)
        if dp_schedule:
            # ...and the synthesized collective schedule family whose α-β
            # price won the space (cost.dp_schedule_choice over
            # collectives.synthesize_space); the runtime executes the
            # reduction through the matching emitted program
            cfg["dp_schedule"] = str(dp_schedule)
    return cfg


def _int_field(cfg: Dict[str, Any], key: str, default: Optional[int] = None
               ) -> int:
    """A scalar integer field, with a typed error naming the key on
    absence or a non-integer value."""
    if key not in cfg:
        if default is not None:
            return default
        raise PlanFormatError(f"missing required key '{key}'", key=key)
    v = cfg[key]
    # int() would silently TRUNCATE a fractional float ("pp_deg": 2.5 ->
    # 2) — exactly the malformed-degree class this parser exists to catch;
    # integral floats (2.0, a JSON round-trip artifact) stay accepted
    if isinstance(v, float) and not v.is_integer():
        raise PlanFormatError(
            f"key '{key}' must be an integer, got {v!r}", key=key)
    try:
        return int(v)
    except (TypeError, ValueError):
        raise PlanFormatError(
            f"key '{key}' must be an integer, got {v!r}",
            key=key) from None


def config2strategy(
    cfg: Dict[str, Any], world_size: Optional[int] = None
) -> Tuple[List[LayerStrategy], EmbeddingLMHeadStrategy, Dict[str, Any]]:
    """Parse the interchange dict back into per-layer strategies.

    Returns (layer strategies, vocab strategy, extras) where extras carries the
    non-per-layer fields (global_bsz, chunks, pipeline_type, pp_division).
    Missing optional vectors (cp/ep) default to all-ones, matching the
    reference's tolerance of older config files. Malformed input (missing
    keys, non-integer degrees, wrong-length vectors) raises
    :class:`PlanFormatError` naming the offending key — never a raw
    KeyError from deep inside the parser.
    """
    if not isinstance(cfg, dict):
        raise PlanFormatError(
            f"plan must be a JSON object, got {type(cfg).__name__}")
    pp_deg = _int_field(cfg, "pp_deg")
    if pp_deg < 1:
        raise PlanFormatError(f"pp_deg must be >= 1, got {pp_deg}",
                              key="pp_deg")
    if "tp_sizes_enc" not in cfg:
        raise PlanFormatError("missing required key 'tp_sizes_enc' (the "
                              "per-layer tp vector defines the layer count)",
                              key="tp_sizes_enc")

    def dec(key: str) -> List[int]:
        try:
            return _dec(cfg[key])
        except (TypeError, ValueError):
            raise PlanFormatError(
                f"key '{key}' must be a comma-separated integer vector, "
                f"got {cfg[key]!r}", key=key) from None

    tps = dec("tp_sizes_enc")
    n = len(tps)
    if n == 0:
        raise PlanFormatError("'tp_sizes_enc' encodes zero layers",
                              key="tp_sizes_enc")

    def vec(key: str, default: int) -> List[int]:
        if key not in cfg:
            return [default] * n
        out = dec(key)
        if len(out) != n:
            raise PlanFormatError(
                f"key '{key}' has {len(out)} entries but 'tp_sizes_enc' "
                f"defines {n} layers", key=key)
        return out

    cons = vec("tp_consecutive_flags", 1)
    dpt = vec("dp_types_enc", 0)
    sps = vec("use_sp", 0)
    cps = vec("cp_sizes_enc", 1)
    eps = vec("ep_sizes_enc", 1)
    # reference runtime key is tp_of_ep_sizes_enc; accept the legacy
    # etp_sizes_enc spelling written by early versions of this repo too
    etps = (vec("tp_of_ep_sizes_enc", 1) if "tp_of_ep_sizes_enc" in cfg
            else vec("etp_sizes_enc", 1))
    ckpt = vec("checkpoint", 0)
    try:
        default_dp = DPType.from_name(cfg.get("default_dp_type", "ddp"))
    except (KeyError, AttributeError):
        raise PlanFormatError(
            f"default_dp_type must be one of ddp/zero2/zero3, got "
            f"{cfg.get('default_dp_type')!r}",
            key="default_dp_type") from None
    strategies = []
    for i in range(n):
        dp_type = DPType.ZERO3 if dpt[i] == 1 else default_dp
        dp_size = 0
        if world_size is not None:
            denom = pp_deg * tps[i] * cps[i]
            if world_size % denom != 0:
                raise ValueError(
                    f"layer {i}: world_size {world_size} not divisible by "
                    f"pp*tp*cp = {denom}"
                )
            dp_size = world_size // denom
        s = LayerStrategy(
            pp_deg=pp_deg,
            tp_size=tps[i],
            dp_size=max(dp_size, 1),
            cp_size=cps[i],
            sp=bool(sps[i]),
            tp_consecutive=bool(cons[i]),
            dp_type=dp_type,
            checkpoint=bool(ckpt[i]),
            ep_size=eps[i],
            etp_size=etps[i],
        )
        if world_size is not None:
            s.validate(world_size)
        strategies.append(s)
    vocab = EmbeddingLMHeadStrategy(
        vtp=_int_field(cfg, "vtp", 1),
        vsp=bool(_int_field(cfg, "vsp", 0)),
        vcp=_int_field(cfg, "vcp", 1),
        embed_sdp=bool(_int_field(cfg, "embed_sdp", 0)),
    )
    extras = {
        "global_bsz": _int_field(cfg, "global_bsz", 0),
        "chunks": _int_field(cfg, "chunks", 1),
        "pipeline_type": cfg.get("pipeline_type", "pipedream_flush"),
        "pp_division": dec("pp_division") if "pp_division" in cfg else None,
        "default_dp_type": default_dp.short,
        "num_encoder_layers": (_int_field(cfg, "num_encoder_layers")
                               if "num_encoder_layers" in cfg else None),
        "vpp_deg": _int_field(cfg, "vpp_deg", 1),
        "hier_dp": bool(_int_field(cfg, "hier_dp", 0)),
        # bucketed software-pipelining granularity the search priced the
        # hierarchical reduction at (0 = monolithic); the runtime
        # pipelines at the same size unless parallel.hier_bucket_mb
        # overrides
        "hier_bucket_mb": float(cfg.get("hier_bucket_mb", 0.0) or 0.0),
        # synthesized collective schedule family the search priced the dp
        # reduction with (collectives/); None = the hand-implemented
        # three-stage hierarchical path
        "dp_schedule": str(cfg.get("dp_schedule") or "") or None,
        # optional per-layer compute prediction (see strategy_list2config);
        # a hand-edited plan whose vector no longer matches the layer count
        # is dropped rather than mis-attributed to the wrong layers
        "predicted_layer_compute_ms": (
            [float(x) for x in cfg["predicted_layer_compute_ms"]]
            if isinstance(cfg.get("predicted_layer_compute_ms"), list)
            and len(cfg["predicted_layer_compute_ms"]) == n else None),
    }
    return strategies, vocab, extras


def save_strategy_config(path: str, cfg: Dict[str, Any],
                         world_size: Optional[int] = None) -> None:
    """Write a plan dict, VALIDATING it first: the dict must round-trip
    through :func:`config2strategy` (which runs ``LayerStrategy.validate``
    on every layer when ``world_size`` is given) — a writer bug surfaces at
    save time on the machine that searched the plan, not at load time on
    the machines that train it."""
    config2strategy(cfg, world_size=world_size)
    import os

    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=4)


def load_strategy_config(path: str) -> Dict[str, Any]:
    """Read a plan JSON with typed errors: unreadable files and non-object
    JSON raise :class:`PlanFormatError` carrying the path, so launchers and
    the plan doctor can report the actual problem instead of a traceback."""
    try:
        with open(path) as f:
            cfg = json.load(f)
    except OSError as e:
        raise PlanFormatError(f"cannot read plan: {e}", path=path) from None
    except json.JSONDecodeError as e:
        raise PlanFormatError(f"invalid JSON: {e}", path=path) from None
    if not isinstance(cfg, dict):
        raise PlanFormatError(
            f"plan must be a JSON object, got {type(cfg).__name__}",
            path=path)
    return cfg


# ---------------------------------------------------------------------------
# pretty printing (reference: form_strategy / print_strategies)
# ---------------------------------------------------------------------------


def form_strategy(s: LayerStrategy) -> str:
    bits = [f"pp{s.pp_deg}", f"tp{s.tp_size}", f"dp{s.dp_size}({s.dp_type.short})"]
    if s.cp_size > 1:
        bits.append(f"cp{s.cp_size}")
    if s.sp:
        bits.append("ulysses")
    if s.ep_size > 1:
        bits.append(f"ep{s.ep_size}xetp{s.etp_size}")
    if s.checkpoint:
        bits.append("ckpt")
    if not s.tp_consecutive:
        bits.append("nonconsec")
    return "-".join(bits)


def print_strategies(strategies: Sequence[LayerStrategy]) -> str:
    """Compress a per-layer list into 'strategy*count' runs for logging."""
    out: List[str] = []
    run_start = 0
    for i in range(1, len(strategies) + 1):
        if i == len(strategies) or strategies[i].key() != strategies[run_start].key():
            count = i - run_start
            txt = form_strategy(strategies[run_start])
            out.append(f"{txt}*{count}" if count > 1 else txt)
            run_start = i
    return ", ".join(out)
