"""Argument schemas as dataclasses.

Counterpart of ``hetu_galvatron_tpu/core/args_schema.py`` (pydantic there):
the same section names, field names and defaults, for the fields this
package reads. A key that the JAX schema knows but the port does not read
yet is accepted and dropped (``JAX_ONLY_KEYS``); a key neither knows
raises, as does a value outside a field's choices.

``ServingArgs`` takes the whole ``serving`` section (JAX
``core/args_schema.py:435``); what the port does not run of it raises by
name where it is used (``serving/engine.py``, ``cli/serve.py``).

Port-only: the top-level ``device`` ("cuda" by default, "cpu" on request)
names where the entry points run.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, ClassVar, Dict, List, Optional, Tuple


@dataclass
class ModelArgs:
    model_name: str = "gpt2-small"
    model_type: str = "gpt"
    hidden_size: int = 768
    num_hidden_layers: int = 12  # t5: the decoder stack
    num_encoder_layers: Optional[int] = None  # t5: None = the decoder's
    num_attention_heads: int = 12
    num_key_value_heads: Optional[int] = None
    ffn_hidden_size: Optional[int] = None
    vocab_size: int = 50257
    max_position_embeddings: int = 1024
    seq_length: int = 1024
    hidden_act: str = "gelu"
    normalization: str = "layernorm"
    norm_position: Optional[str] = None
    layernorm_epsilon: float = 1e-5
    position_embedding_type: str = "learned"
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    mrope_section: Optional[List[int]] = None
    tie_word_embeddings: bool = True
    use_flash_attn: bool = True
    use_fused_ce: bool = False
    remat_policy: str = "full"
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    norm_zero_centered: bool = False
    scale_embeddings: bool = False
    head_dim_override: Optional[int] = None
    make_vocab_size_divisible_by: int = 128
    add_bias_linear: bool = True
    add_qkv_bias: bool = False
    # MoE (models/moe.py)
    num_experts: int = 0  # 0: a dense model
    moe_topk: int = 2
    moe_ffn_hidden_size: Optional[int] = None
    num_shared_experts: int = 0
    moe_aux_loss_coeff: float = 1e-2
    moe_z_loss_coeff: float = 0.0
    moe_router_dtype: str = "float32"
    moe_layer_freq: int = 1  # every k-th layer is MoE
    moe_dispatcher: str = "capacity"
    moe_capacity_factor: float = 1.25
    moe_router_type: str = "topk"
    moe_router_enable_expert_bias: bool = False
    moe_expert_bias_update_rate: float = 1e-3

    CHOICES: ClassVar[Dict[str, Tuple]] = {
        "model_type": ("gpt", "llama", "bert", "t5", "moe"),
        "hidden_act": ("gelu", "gelu_exact", "swiglu", "geglu", "relu",
                       "silu"),
        "normalization": ("layernorm", "rmsnorm"),
        "norm_position": (None, "pre", "post"),
        "position_embedding_type": ("learned", "rope"),
        "remat_policy": ("full", "dots", "dots_no_batch"),
        "moe_router_dtype": ("float32", "bfloat16"),
        "moe_dispatcher": ("capacity", "dropless"),
        "moe_router_type": ("topk", "sinkhorn"),
    }

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @property
    def ffn_dim(self) -> int:
        if self.ffn_hidden_size is not None:
            return self.ffn_hidden_size
        return 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    @property
    def padded_vocab_size(self) -> int:
        m = self.make_vocab_size_divisible_by
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def post_norm(self) -> bool:
        """Residual-then-norm blocks: ``norm_position``, else "post" for
        bert and "pre" for every other family."""
        pos = self.norm_position or (
            "post" if self.model_type == "bert" else "pre")
        return pos == "post"


@dataclass
class ParallelArgs:
    config_mode: str = "global"
    galvatron_config_path: Optional[str] = None
    pp_deg: int = 1
    global_tp_deg: int = 1
    global_cp_deg: int = 1
    global_ep_deg: int = 1
    sdp: int = 0
    global_checkpoint: int = 0
    use_ulysses: bool = False
    virtual_pp_deg: int = 1
    chunks: int = -1
    global_train_batch_size: int = 8
    mixed_precision: str = "bf16"
    num_devices: int = 0
    num_processes: int = 0
    hier_dp: bool = False

    CHOICES: ClassVar[Dict[str, Tuple]] = {
        "config_mode": ("global", "json"),
        "mixed_precision": ("fp32", "bf16", "fp16"),
    }


@dataclass
class TpOverlapArgs:
    enable: bool = False


@dataclass
class TrainArgs:
    lr: float = 1e-4
    min_lr: float = 1e-5
    weight_decay: float = 0.01
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_eps: float = 1e-8
    clip_grad: float = 1.0
    train_iters: int = 20
    lr_decay_style: str = "cosine"
    lr_warmup_iters: int = 0
    lr_decay_iters: Optional[int] = None
    lr_wsd_decay_iters: int = 0
    seed: int = 1234
    eval_interval: int = 0
    eval_iters: int = 0
    rampup_batch_size: Optional[List[int]] = None
    # round a ramp step down to a multiple of the micro size instead of
    # raising (runtime/microbatches.py)
    decrease_batch_size_if_needed: bool = False

    CHOICES: ClassVar[Dict[str, Tuple]] = {
        "lr_decay_style": ("constant", "linear", "cosine",
                           "inverse-square-root", "WSD"),
    }


@dataclass
class CheckpointArgs:
    """JAX ``core/args_schema.py:307``; ``runtime/checkpoint.py`` reads it.
    ``load_format=hf`` (HF weight import) is refused by the launcher."""

    save: Optional[str] = None
    load: Optional[str] = None
    save_interval: int = 0
    load_format: str = "galvatron"
    async_save: bool = False
    # resume asserts the stored plan fingerprint equals the live one
    distributed_checkpoint: bool = True
    # keep only the newest N committed step dirs (0 = keep all)
    keep_last: int = 0
    # wall-clock cadence beside save_interval (seconds; 0 = steps only)
    interval_s: float = 0.0
    # on-step device snapshot + background writer (AsyncCheckpointer)
    snapshot_async: bool = False
    # watchdog deadline for one background write
    save_timeout_s: float = 120.0

    CHOICES: ClassVar[Dict[str, Tuple]] = {
        "load_format": ("galvatron", "hf"),
    }


@dataclass
class DataArgs:
    dataset: str = "random"
    data_path: List[str] = field(default_factory=list)
    split: str = "969,30,1"
    reset_position_ids: bool = False
    reset_attention_mask: bool = False
    eod_mask_loss: bool = False

    CHOICES: ClassVar[Dict[str, Tuple]] = {"dataset": ("random", "indexed")}


@dataclass
class ProfileArgs:
    profile: int = 0
    profile_warmup: int = 2
    # non-empty: capture a torch.profiler trace of iterations
    # [profile_warmup, profile_warmup + trace_iters) into this directory
    trace_dir: str = ""
    trace_iters: int = 3


@dataclass
class LoggingArgs:
    log_interval: int = 1
    tensorboard_dir: Optional[str] = None
    wandb_project: Optional[str] = None
    log_level: str = "info"


@dataclass
class ObservabilityArgs:
    """JAX ``core/args_schema.py:370``: the telemetry stream, the flight
    recorder and the plan audit. The launcher refuses by name what this
    port does not run: ``tensorboard``, the audit over a captured trace
    (``audit`` with ``profile.trace_dir``), ``audit_hardware_config`` and
    ``calibration_dir``; the ``calibration_*`` and ``regret_threshold``
    knobs act only under ``calibration_dir``."""

    enabled: bool = False
    # JSONL metrics file; None derives <logging.tensorboard_dir or .>/
    # metrics.jsonl at train time
    metrics_path: Optional[str] = None
    tensorboard: bool = False
    flush_interval: int = 16  # steps between registry flushes
    # per-card peak TFLOP/s for MFU when the device-name table
    # (observability/telemetry.py) does not know the card; 0 = the table
    peak_tflops: float = 0.0
    audit: bool = True
    audit_hardware_config: Optional[str] = None
    # flight_<ts>.json dumps on crash / trapped signal / rerun halt; None
    # derives the metrics stream's directory when enabled
    flight_dir: Optional[str] = None
    flight_events: int = 256
    calibration_dir: Optional[str] = None
    calibration_min_points: int = 4
    calibration_window_days: float = 0.0
    calibration_max_points: int = 0
    regret_threshold: float = 0.05


@dataclass
class RerunArgs:
    """JAX ``core/args_schema.py:509``; ``runtime/rerun_machine.py``."""

    enable: bool = False
    mode: str = "disabled"
    error_injection_rate: float = 0.0
    error_injection_type: str = "transient_error"
    check_for_nan: bool = True
    check_for_spike: bool = True
    spike_factor: float = 10.0
    # one-shot drill at inject_at_iter on fresh runs (FaultDrill)
    inject_kind: str = "none"
    inject_at_iter: int = -1
    inject_spike_scale: float = 100.0

    CHOICES: ClassVar[Dict[str, Tuple]] = {
        "mode": ("disabled", "validate_results", "report_stats"),
        "error_injection_type": ("transient_error", "persistent_error",
                                 "correct_result"),
        "inject_kind": ("none", "nan", "spike", "crash", "preempt"),
    }


@dataclass
class ChaosArgs:
    """JAX ``core/args_schema.py:543``; ``runtime/chaos.py``."""

    enable: bool = False
    # comma-separated ``kind@iter`` plan; wins over kind/at_iter
    plan: Optional[str] = None
    kind: str = "none"
    at_iter: int = -1
    seed: int = 0
    io_error_count: int = 2
    io_error_op: str = "checkpoint"
    hang_s: float = 5.0
    # CHAOS_FIRED_<i> markers; None derives ckpt.save
    state_dir: Optional[str] = None

    CHOICES: ClassVar[Dict[str, Tuple]] = {
        "kind": ("none", "crash", "sigterm", "sigkill", "kill_mid_save",
                 "hung_save", "corrupt_meta", "truncate_meta", "io_error"),
    }


@dataclass
class SupervisorArgs:
    """JAX ``core/args_schema.py:581``; ``runtime/supervisor.py`` and
    ``cli/supervise.py``."""

    # trap SIGTERM/SIGINT and checkpoint-and-exit at the next step boundary
    graceful_signals: bool = True
    auto_restart: bool = False
    max_restarts: int = 3
    backoff_base_s: float = 1.0
    backoff_max_s: float = 60.0
    restart_on_error: bool = True
    # inprocess: run_with_restarts around train(); process: cli/supervise
    mode: str = "inprocess"
    # process mode: SIGTERM forwarded to the child escalates to SIGKILL
    # after this window; it must exceed one checkpoint save
    term_grace_s: float = 15.0
    state_file: Optional[str] = None
    max_world_changes: int = 8
    # /healthz port (-1 off); the endpoint is not ported yet
    metrics_port: int = -1
    poll_interval_s: float = 0.5

    CHOICES: ClassVar[Dict[str, Tuple]] = {
        "mode": ("inprocess", "process"),
    }


@dataclass
class ServingArgs:
    """JAX ``core/args_schema.py:435``: the serving engine's knobs
    (``serving/``): continuous batching, the paged KV cache, admission
    control, the prefix cache, speculative decoding, streaming and the
    serving telemetry."""

    # decode lanes: sequences decoded together at one fixed batch shape
    max_batch_size: int = 8
    # paged KV cache geometry; block 0 is reserved scratch. num_kv_blocks=0
    # derives a pool that holds max_batch_size full-length sequences
    kv_block_size: int = 16
    num_kv_blocks: int = 0
    # per-sequence cap (prompt + generation); 0 = model max positions
    max_seq_len: int = 0
    # default per-request generation budget (requests may override)
    max_new_tokens: int = 64
    # per-engine-step prefill budget in GFLOPs (forward FLOPs/token of the
    # cost model) or tokens; 0 = that bound unlimited; the tighter wins
    prefill_flops_budget_g: float = 0.0
    max_prefill_tokens: int = 0
    # the radix prefix cache (serving/prefix_cache.py); 0 blocks = bounded
    # only by the pool
    prefix_cache: bool = False
    prefix_cache_max_blocks: int = 0
    # lossless speculative decoding (serving/spec_decode.py)
    spec_decode: bool = False
    spec_k: int = 4
    spec_draft: str = "ngram"
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    # sampling defaults (requests override temperature / eos); top_k is
    # fixed per engine
    temperature: float = 0.0
    top_k: Optional[int] = None
    eos_id: Optional[int] = None
    # retire requests older than this many seconds (0 = no deadline)
    request_timeout_s: float = 0.0
    # registry flush cadence, in engine steps
    flush_interval: int = 32
    # JSONL metrics file of cli/serve.py; None = ./serve_metrics.jsonl
    metrics_path: Optional[str] = None
    # Prometheus /metrics endpoint: None off, 0 an ephemeral port, N port N
    metrics_port: Optional[int] = None
    metrics_host: str = "127.0.0.1"
    # per-request lifecycle events in the metrics stream
    trace_requests: bool = False
    # SLO targets in ms (0 = none): attainment gauges
    slo_ttft_ms: float = 0.0
    slo_itl_ms: float = 0.0
    # flight_<ts>.json dumps on a fatal engine error; None = ring only
    flight_dir: Optional[str] = None
    flight_events: int = 256

    CHOICES: ClassVar[Dict[str, Tuple]] = {
        "spec_draft": ("ngram", "model"),
    }


# keys the JAX schema defines that this package does not read (yet); a
# config naming them loads, the values are dropped
JAX_ONLY_KEYS: Dict[str, frozenset] = {
    "model": frozenset({"untie_streams"}),
    "parallel": frozenset({
        "global_tp_consec", "cp_zigzag", "global_etp_deg", "default_dp_type",
        "vocab_tp", "vocab_sp", "vocab_cp", "embed_sdp", "pipeline_type",
        "dp_axis_on_dcn", "coordinator_address", "process_id", "dcn_slices",
        "hier_bucket_mb", "dp_schedule"}),
    "pipeline": frozenset({"schedule_impl"}),
    "tp_overlap": frozenset(),
    "train": frozenset({"check_loss", "deterministic_mode"}),
    "ckpt": frozenset(),
    "data": frozenset({"tokenizer_type", "tokenizer_path", "num_workers"}),
    "profile": frozenset({"profile_type", "profile_forward",
                          "save_profiled_memory", "profiler_dir",
                          "profile_iters"}),
    "logging": frozenset(),
    "observability": frozenset(),
    "serving": frozenset(),
    "rerun": frozenset(),
    "chaos": frozenset(),
    "supervisor": frozenset(),
    "search": frozenset({
        "num_nodes", "num_devices_per_node", "memory_constraint", "min_bsz",
        "max_bsz", "bsz_scale", "settle_bsz", "settle_chunks",
        "search_space", "disable_dp", "disable_tp", "disable_pp",
        "disable_sdp", "disable_ckpt", "disable_tp_consec", "disable_cp",
        "disable_ulysses", "disable_vtp", "disable_vsp", "max_tp_deg",
        "max_pp_deg", "max_sp_deg", "max_cp_deg", "sequence_parallel",
        "global_memory_buffer", "async_grad_reduce", "time_profile_mode",
        "memory_profile_mode", "default_dp_type", "fine_grained_mode",
        "sequence_parallel_mode", "pipeline_type", "mixed_precision",
        "use_cpp_core", "parallel_search", "log_dir", "search_trace_path",
        "output_config_path", "time_profiling_path",
        "memory_profiling_path", "allreduce_bandwidth_config_path",
        "use_calibrated", "p2p_bandwidth_config_path", "overlap_coe_path",
        "sp_time_path", "sequence_length", "costmodel_coe", "dispatch_us",
        "pipeline_schedule_impl", "hbm_budget_gb", "tp_overlap", "hier_dp",
        "hier_bucket_mb", "runner_up_k"}),
    "model_profiler": frozenset({
        "profile_type", "profile_mode", "profile_batch_size",
        "profile_min_batch_size", "profile_max_batch_size",
        "profile_batch_size_step", "profile_seq_length_list",
        "profile_min_seq_length", "profile_max_seq_length",
        "profile_seq_length_step", "layernum_min", "layernum_max",
        "max_tp_deg", "profile_dp_type", "mixed_precision",
        "use_flash_attn", "output_dir", "extra_args_str"}),
    "hardware_profiler": frozenset({
        "num_nodes", "num_devices_per_node", "max_pp_deg", "max_tp_deg",
        "start_mb", "end_mb", "scale", "sub_mb_floor_kb", "profile_algos",
        "warmup_iters", "profile_iters", "avg_or_min_or_first", "output_dir",
        "backend"}),
}

MODES = ("train_dist", "search", "model_profiler", "profile_hardware")
DEVICES = ("cuda", "cpu")


def _coerce(default: Any, value: Any) -> Any:
    """The lax numeric coercions pydantic applies: int -> float fields,
    integral float -> int fields."""
    if isinstance(default, bool) or isinstance(value, bool):
        return value
    if isinstance(default, str) and isinstance(value, float) \
            and value != value:
        return "nan"  # the override parser reads a bare `nan` as float NaN
    if isinstance(default, float) and isinstance(value, int):
        return float(value)
    if isinstance(default, int) and isinstance(value, float) \
            and value.is_integer():
        return int(value)
    return value


def build_section(cls, name: str, tree: Any):
    """Validate one config section into its dataclass."""
    if tree is None:
        tree = {}
    if not isinstance(tree, dict):
        raise ValueError(f"config section {name!r} must be a mapping, got "
                         f"{type(tree).__name__}")
    own = {f.name: f for f in fields(cls)}
    defaults = cls()
    kwargs = {}
    for key, value in tree.items():
        if key in own:
            kwargs[key] = _coerce(getattr(defaults, key), value)
        elif key not in JAX_ONLY_KEYS.get(name, ()):
            raise ValueError(f"unknown config key {name}.{key}")
    obj = cls(**kwargs)
    for key, choices in getattr(cls, "CHOICES", {}).items():
        if getattr(obj, key) not in choices:
            raise ValueError(f"{name}.{key}={getattr(obj, key)!r} is not one "
                             f"of {choices}")
    return obj


SECTIONS = {
    "model": ModelArgs, "parallel": ParallelArgs, "tp_overlap": TpOverlapArgs,
    "train": TrainArgs, "ckpt": CheckpointArgs, "data": DataArgs,
    "profile": ProfileArgs, "logging": LoggingArgs,
    "observability": ObservabilityArgs, "rerun": RerunArgs,
    "chaos": ChaosArgs, "supervisor": SupervisorArgs,
    "serving": ServingArgs,
}


@dataclass
class CoreArgs:
    mode: str = "train_dist"
    device: str = "cuda"
    model: ModelArgs = field(default_factory=ModelArgs)
    parallel: ParallelArgs = field(default_factory=ParallelArgs)
    tp_overlap: TpOverlapArgs = field(default_factory=TpOverlapArgs)
    train: TrainArgs = field(default_factory=TrainArgs)
    ckpt: CheckpointArgs = field(default_factory=CheckpointArgs)
    data: DataArgs = field(default_factory=DataArgs)
    profile: ProfileArgs = field(default_factory=ProfileArgs)
    logging: LoggingArgs = field(default_factory=LoggingArgs)
    observability: ObservabilityArgs = field(
        default_factory=ObservabilityArgs)
    rerun: RerunArgs = field(default_factory=RerunArgs)
    chaos: ChaosArgs = field(default_factory=ChaosArgs)
    supervisor: SupervisorArgs = field(default_factory=SupervisorArgs)
    serving: ServingArgs = field(default_factory=ServingArgs)
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_tree(cls, tree: Dict[str, Any]) -> "CoreArgs":
        kwargs: Dict[str, Any] = {}
        for key, value in tree.items():
            if key in SECTIONS:
                kwargs[key] = build_section(SECTIONS[key], key, value)
            elif key in JAX_ONLY_KEYS:
                build_section_unread(key, value)
            elif key in ("mode", "device", "extra"):
                kwargs[key] = value
            else:
                raise ValueError(f"unknown config section {key!r}")
        args = cls(**kwargs)
        if args.mode not in MODES:
            raise ValueError(f"mode={args.mode!r} is not one of {MODES}")
        if args.device not in DEVICES:
            raise ValueError(f"device={args.device!r} is not one of "
                             f"{DEVICES}")
        if not isinstance(args.extra, dict):
            raise ValueError("extra must be a mapping")
        return args


def build_section_unread(name: str, tree: Any) -> None:
    """A section the port does not read yet: its keys must still be ones
    the JAX schema knows."""
    if tree is None:
        return
    if not isinstance(tree, dict):
        raise ValueError(f"config section {name!r} must be a mapping")
    for key in tree:
        if key not in JAX_ONLY_KEYS[name]:
            raise ValueError(f"unknown config key {name}.{key}")
