"""Search-space strategy representation and enumeration.

Port of ``hetu_galvatron_tpu/core/search_engine/strategies.py``:
``SearchStrategy`` (one candidate per-layer plan, with an embedding/LM-head
variant without the checkpoint bit), ``SearchSpaceLimits``,
``enumerate_strategies``, ``filter_strategies`` and ``pp_division_even``.

The total ordering (field-lexicographic: pp, tp, sp, cp, dp, dp_type,
checkpoint) matters: the DP breaks ties by first-seen order, so the
enumeration order is part of the golden-value parity with JAX's search.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Tuple

from hetu_galvatron_tpu_torch.utils.strategy import DPType, LayerStrategy


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclass(frozen=True, order=False)
class SearchStrategy:
    """One candidate per-layer plan in the search space. ``sp_size`` is the
    Ulysses degree (exclusive with tp>1); ``tp_sp`` is whichever is active."""

    pp: int = 1
    tp: int = 1
    sp: int = 1
    cp: int = 1
    dp: int = 1
    dp_type: DPType = DPType.DDP
    checkpoint: bool = False
    is_vocab: bool = False  # embedding/LM-head row: no checkpoint dimension

    def __post_init__(self):
        if self.tp > 1 and self.sp > 1:
            raise ValueError("tp and sp (Ulysses) are exclusive")
        # a strategy with no sharded-dp group degenerates to DDP (reference
        # _check_and_fix_sdp, strategy_utils.py:49-52)
        if self.sdp == 1 and self.dp_type != DPType.DDP:
            object.__setattr__(self, "dp_type", DPType.DDP)

    @property
    def tp_sp(self) -> int:
        return max(self.tp, self.sp)

    @property
    def sdp(self) -> int:
        """The group size ZeRO shards states over: dp x sp x cp (reference
        sdp_size, strategy_utils.py:62-64)."""
        return self.dp * self.sp * self.cp

    @property
    def world(self) -> int:
        return self.pp * self.tp * self.sp * self.cp * self.dp

    def sort_key(self) -> Tuple:
        return (self.pp, self.tp, self.sp, self.cp, self.dp,
                self.dp_type.value, self.checkpoint)

    def vocab_variant(self) -> "SearchStrategy":
        return replace(self, checkpoint=False, is_vocab=True)

    def simple_string(self) -> str:
        """Compact form matching the reference to_simple_string
        (strategy_utils.py:73-92): pp-tpsp[*]-dp[f][-c][-sp]."""
        s = f"{self.pp}-"
        s += f"{self.tp_sp}*-" if self.tp_sp != 1 else f"{self.tp_sp}-"
        s += f"{self.dp}f" if self.dp_type == DPType.ZERO3 else f"{self.dp}"
        if self.checkpoint:
            s += "-c"
        if self.sp > 1:
            s += "-sp"
        return s

    def to_runtime(self) -> LayerStrategy:
        """Convert to the runtime LayerStrategy (tp carries the Ulysses
        degree with the sp flag set)."""
        return LayerStrategy(
            pp_deg=self.pp, tp_size=self.tp_sp, dp_size=self.dp,
            cp_size=self.cp, sp=self.sp > 1, dp_type=self.dp_type,
            checkpoint=self.checkpoint,
        )


@dataclass
class SearchSpaceLimits:
    """Enumeration bounds + disable switches (reference
    SearchEngineSearchSpaceArgs, search_engine/args_schema.py:27-41)."""

    max_pp_deg: int = 8
    max_tp_deg: int = 8
    max_sp_deg: int = 8
    max_cp_deg: int = 8
    disable_pp: int = 0
    disable_tp: int = 0
    disable_sp: int = 0
    disable_cp: int = 1
    disable_dp: int = 0
    disable_ckpt: int = 0
    disable_fsdp: int = 0
    disable_vocab_tp: int = 0
    disable_vocab_sp: int = 0


def enumerate_strategies(
    world_size: int,
    total_layer_num: int,
    limits: SearchSpaceLimits,
    default_dp_type: str = "ddp",
) -> Tuple[List[SearchStrategy], List[SearchStrategy]]:
    """Power-of-two sweep over pp x {tp|sp} x cp x dp-type x checkpoint
    (reference generate_strategy_list, search_engine.py:106-181). Returns
    (layer strategies, vocab strategies), each sorted and deduped."""
    degrees = []
    d = 1
    while d <= world_size:
        degrees.append(d)
        d *= 2

    out: List[SearchStrategy] = []
    for pp in degrees:
        if pp > total_layer_num or pp > limits.max_pp_deg:
            continue
        for mode in ("tp", "sp"):
            for tp_sp in degrees:
                if mode == "tp" and limits.max_tp_deg != -1 and \
                        tp_sp > limits.max_tp_deg:
                    continue
                if mode == "sp" and limits.max_sp_deg != -1 and \
                        tp_sp > limits.max_sp_deg:
                    continue
                if tp_sp * pp > world_size:
                    continue
                for cp in degrees:
                    if limits.max_cp_deg != -1 and cp > limits.max_cp_deg:
                        continue
                    if pp * tp_sp * cp > world_size:
                        continue
                    dp = world_size // pp // tp_sp // cp
                    if dp == 1 and cp == 1:
                        dp_types = [DPType.DDP]
                    elif dp == 1:
                        # cp>1 with dp=1: ZeRO still shards states over the
                        # ring group (sdp = dp*sp*cp > 1) — without this the
                        # long-sequence cp regime would carry fully
                        # replicated model states (beyond the reference,
                        # which never enumerates cp)
                        dp_types = ([DPType.DDP, DPType.ZERO3]
                                    if default_dp_type == "ddp"
                                    else [DPType.ZERO2, DPType.ZERO3])
                    elif default_dp_type == "ddp":
                        dp_types = [DPType.DDP, DPType.ZERO3]
                    else:
                        dp_types = [DPType.ZERO2, DPType.ZERO3]
                    for dpt in dp_types:
                        for ckpt in (False, True):
                            out.append(SearchStrategy(
                                pp=pp,
                                tp=tp_sp if mode == "tp" else 1,
                                sp=tp_sp if mode == "sp" else 1,
                                cp=cp, dp=dp, dp_type=dpt, checkpoint=ckpt))
    layer = sorted(set(out), key=SearchStrategy.sort_key)
    vocab = sorted({s.vocab_variant() for s in layer},
                   key=SearchStrategy.sort_key)
    return filter_strategies(layer, limits), filter_strategies(
        vocab, limits, vocab=True)


def filter_strategies(
    strategies: List[SearchStrategy],
    limits: SearchSpaceLimits,
    vocab: bool = False,
) -> List[SearchStrategy]:
    """Apply the disable_* switches (reference filter_strategy_list,
    search_engine.py:182-255)."""
    out = strategies
    if limits.disable_pp:
        out = [s for s in out if s.pp == 1]
    if limits.disable_tp or (vocab and limits.disable_vocab_tp):
        out = [s for s in out if s.tp == 1]
    if limits.disable_sp or (vocab and limits.disable_vocab_sp):
        out = [s for s in out if s.sp == 1]
    if limits.disable_cp:
        out = [s for s in out if s.cp == 1]
    if limits.disable_dp:
        out = [s for s in out if s.dp == 1]
    if limits.disable_ckpt and not vocab:
        out = [s for s in out if not s.checkpoint]
    if limits.disable_fsdp:
        out = [s for s in out if s.dp_type != DPType.ZERO3]
    return sorted(set(out), key=SearchStrategy.sort_key)


def pp_division_even(layernum_list: List[int], pp_deg: int) -> List[int]:
    """Even stage division, remainder to the last stage (reference
    pp_division_even, search_engine.py:1094-1099)."""
    total = sum(layernum_list)
    avg = total // pp_deg
    return [avg] * (pp_deg - 1) + [total - avg * (pp_deg - 1)]
