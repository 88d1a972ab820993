"""Argument schemas as dataclasses.

Counterpart of ``hetu_galvatron_tpu/core/args_schema.py`` (pydantic there):
the same section names, field names and defaults, for the fields this
package reads. A key that the JAX schema knows but the port does not read
yet is accepted and dropped (``JAX_ONLY_KEYS``); a key neither knows
raises, as does a value outside a field's choices.

``ServingArgs`` takes the whole ``serving`` section (JAX
``core/args_schema.py:435``); what the port does not run of it raises by
name where it is used (``serving/engine.py``, ``cli/serve.py``). So do
``SearchArgs``, ``ModelProfileArgs`` and ``HardwareProfileArgs`` (JAX
:620, :733, :756) for the search and the profilers; ``args_from_cli``
takes their modes (``search``, ``model_profiler``, ``profile_hardware``).

Port-only: the top-level ``device`` ("cuda" by default, "cpu" on request)
names where the entry points run.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any, ClassVar, Dict, List, Literal, Optional, Tuple


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
    global_tp_consec: int = 1
    global_cp_deg: int = 1
    global_ep_deg: int = 1
    global_etp_deg: int = 1
    sdp: int = 0
    default_dp_type: str = "ddp"
    global_checkpoint: int = 0
    use_ulysses: bool = False
    vocab_tp: int = 1
    vocab_sp: int = 0
    vocab_cp: int = 1
    embed_sdp: int = 0
    virtual_pp_deg: int = 1
    chunks: int = -1
    global_train_batch_size: int = 8
    mixed_precision: str = "bf16"
    num_devices: int = 0
    num_processes: int = 0
    hier_dp: bool = False
    pipeline_type: str = "gpipe"
    # ICI slices the job spans (JAX :187); above 1 is refused by name
    dcn_slices: int = 1

    CHOICES: ClassVar[Dict[str, Tuple]] = {
        "config_mode": ("global", "json"),
        "default_dp_type": ("ddp", "zero2", "zero3"),
        "mixed_precision": ("fp32", "bf16", "fp16"),
        "pipeline_type": ("gpipe", "pipedream_flush"),
    }


@dataclass
class PipelineArgs:
    """JAX ``core/args_schema.py:237``: how a ``pp_deg > 1`` schedule
    executes. ``host`` is the host-sequenced engine
    (``runtime/pipeline.py``); ``cli/train_dist.py`` refuses ``compiled``
    (the single-program schedule, not ported yet) by name."""

    schedule_impl: str = "host"

    CHOICES: ClassVar[Dict[str, Tuple]] = {
        "schedule_impl": ("host", "compiled"),
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



@dataclass
class SearchArgs:
    """JAX ``core/args_schema.py:620``: the strategy search's knobs
    (``core/search_engine/``). ``use_calibrated`` with a calibration
    directory is read here and raises by name where it is used (the
    calibration loop, ROADMAP item 10b)."""

    num_nodes: int = 1
    num_devices_per_node: int = 8
    memory_constraint: float = 16.0  # GB of device memory per card
    min_bsz: int = 8
    max_bsz: int = 64
    bsz_scale: int = 8
    settle_bsz: int = -1  # >0: search exactly this global batch
    settle_chunks: int = -1
    search_space: Literal["full", "dp+tp", "dp+pp", "3d", "dp", "tp", "pp",
                          "sdp"] = "full"
    disable_dp: int = 0
    disable_tp: int = 0
    disable_pp: int = 0
    disable_sdp: int = 0
    disable_ckpt: int = 0
    disable_tp_consec: int = 1
    disable_cp: int = 1
    disable_ulysses: int = 0
    disable_vtp: int = 0
    disable_vsp: int = 0
    max_tp_deg: int = 8
    max_pp_deg: int = 8
    max_sp_deg: int = 8
    max_cp_deg: int = 8
    sequence_parallel: bool = True
    global_memory_buffer: bool = True
    async_grad_reduce: bool = True
    time_profile_mode: Literal["static", "batch", "sequence"] = "static"
    memory_profile_mode: Literal["static", "batch", "sequence"] = "static"
    default_dp_type: Literal["ddp", "zero2", "zero3"] = "ddp"
    fine_grained_mode: int = 1
    sequence_parallel_mode: Literal["megatron", "ulysses"] = "megatron"
    pipeline_type: Literal["gpipe", "pipedream_flush"] = "pipedream_flush"
    mixed_precision: Literal["bf16", "fp32"] = "bf16"
    use_cpp_core: bool = True
    parallel_search: bool = False
    log_dir: str = "logs"
    # a JSONL record per explored task and the winner
    search_trace_path: Optional[str] = None
    output_config_path: Optional[str] = None
    time_profiling_path: Optional[str] = None
    memory_profiling_path: Optional[str] = None
    allreduce_bandwidth_config_path: Optional[str] = None
    use_calibrated: int = 1
    p2p_bandwidth_config_path: Optional[str] = None
    overlap_coe_path: Optional[str] = None
    sp_time_path: Optional[str] = None
    sequence_length: Optional[int] = None
    costmodel_coe: float = 1.0
    dispatch_us: float = 0.0
    pipeline_schedule_impl: Literal["host", "compiled"] = "host"
    hbm_budget_gb: float = 0.0
    tp_overlap: int = 0
    hier_dp: int = 0
    hier_bucket_mb: float = 0.0
    # feasible runner-up plans embedded in the winning plan's JSON
    runner_up_k: int = 3

    CHOICES: ClassVar[Dict[str, Tuple]] = {
        "search_space": ("full", "dp+tp", "dp+pp", "3d", "dp", "tp", "pp",
                         "sdp"),
        "time_profile_mode": ("static", "batch", "sequence"),
        "memory_profile_mode": ("static", "batch", "sequence"),
        "default_dp_type": ("ddp", "zero2", "zero3"),
        "sequence_parallel_mode": ("megatron", "ulysses"),
        "pipeline_type": ("gpipe", "pipedream_flush"),
        "mixed_precision": ("bf16", "fp32"),
        "pipeline_schedule_impl": ("host", "compiled"),
    }


@dataclass
class ModelProfileArgs:
    """JAX ``core/args_schema.py:733``: the model profiler's sweep
    (``core/profiler/model_profiler.py``)."""

    profile_type: Literal["computation", "memory"] = "computation"
    profile_mode: Literal["static", "batch", "sequence"] = "static"
    profile_batch_size: int = 1
    profile_min_batch_size: int = 1
    profile_max_batch_size: int = 8
    profile_batch_size_step: int = 1
    profile_seq_length_list: List[int] = field(
        default_factory=lambda: [1024])
    profile_min_seq_length: int = 1024
    profile_max_seq_length: int = 8192
    profile_seq_length_step: int = 1024
    layernum_min: int = 2
    layernum_max: int = 4
    max_tp_deg: int = 8
    profile_dp_type: Literal["ddp", "zero2", "zero3"] = "ddp"
    mixed_precision: Literal["bf16", "fp32"] = "bf16"
    use_flash_attn: bool = True
    output_dir: str = "configs"
    extra_args_str: str = ""

    CHOICES: ClassVar[Dict[str, Tuple]] = {
        "profile_type": ("computation", "memory"),
        "profile_mode": ("static", "batch", "sequence"),
        "profile_dp_type": ("ddp", "zero2", "zero3"),
        "mixed_precision": ("bf16", "fp32"),
    }


@dataclass
class HardwareProfileArgs:
    """JAX ``core/args_schema.py:756``: the hardware profiler's knobs
    (``core/profiler/hardware_profiler.py``)."""

    num_nodes: int = 1
    num_devices_per_node: int = 8
    max_pp_deg: int = 8
    max_tp_deg: int = 8
    start_mb: int = 1
    end_mb: int = 512
    scale: int = 2
    sub_mb_floor_kb: int = 64
    profile_algos: int = 1
    warmup_iters: int = 5
    profile_iters: int = 20
    avg_or_min_or_first: Literal["avg", "min", "first"] = "avg"
    output_dir: str = "hardware_configs"
    backend: Literal["auto", "tpu", "cpu"] = "auto"

    CHOICES: ClassVar[Dict[str, Tuple]] = {
        "avg_or_min_or_first": ("avg", "min", "first"),
        "backend": ("auto", "tpu", "cpu"),
    }

# keys the JAX schema defines that this package does not read (yet); a
# config naming them loads, the values are dropped
JAX_ONLY_KEYS: Dict[str, frozenset] = {
    "model": frozenset({"untie_streams"}),
    "parallel": frozenset({
        "cp_zigzag", "dp_axis_on_dcn", "coordinator_address", "process_id",
        "hier_bucket_mb", "dp_schedule"}),
    "pipeline": frozenset(),
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
    "model": ModelArgs, "parallel": ParallelArgs, "pipeline": PipelineArgs,
    "tp_overlap": TpOverlapArgs,
    "train": TrainArgs, "ckpt": CheckpointArgs, "data": DataArgs,
    "profile": ProfileArgs, "logging": LoggingArgs,
    "observability": ObservabilityArgs, "rerun": RerunArgs,
    "chaos": ChaosArgs, "supervisor": SupervisorArgs,
    "serving": ServingArgs, "search": SearchArgs,
    "model_profiler": ModelProfileArgs,
    "hardware_profiler": HardwareProfileArgs,
}


@dataclass
class CoreArgs:
    mode: str = "train_dist"
    device: str = "cuda"
    model: ModelArgs = field(default_factory=ModelArgs)
    parallel: ParallelArgs = field(default_factory=ParallelArgs)
    pipeline: PipelineArgs = field(default_factory=PipelineArgs)
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
    search: SearchArgs = field(default_factory=SearchArgs)
    model_profiler: ModelProfileArgs = field(
        default_factory=ModelProfileArgs)
    hardware_profiler: HardwareProfileArgs = field(
        default_factory=HardwareProfileArgs)
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


def launch_env() -> Optional[Dict[str, int]]:
    """The rank layout ``torch.distributed.run`` exports (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), or None outside
    such a launch. Read here, at the schema's boundary, like every other
    ambient setting."""
    import os

    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    return {"rank": int(os.environ["RANK"]), "world_size": world,
            "local_rank": int(os.environ.get("LOCAL_RANK", "0")),
            "local_world_size": int(os.environ.get("LOCAL_WORLD_SIZE",
                                                   str(world)))}
