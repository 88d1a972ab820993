"""Lossless speculative decoding: pluggable drafts + batched verify.

Port of ``hetu_galvatron_tpu/serving/spec_decode.py`` (``NgramDraft`` :52,
``ModelDraft`` :77, ``make_draft`` :134, ``accept_length`` :151). A draft
proposes K candidate tokens per sequence cheaply; the engine verifies
all of them in one fixed-shape ``[max_batch_size, K+1]`` pass
(``ServingEngine._verify``) and keeps the longest prefix the target model
agrees with.

**Losslessness.** Window row j of the verify pass computes the target's
next token given the context including the drafts before j, through the
same attention as a decode step (``kv_cache.paged_sdpa_window``). Greedy
acceptance keeps a drafted token only while it equals the target's own
choice, so the emitted stream is the plain stream; the draft changes how
many steps it takes, never the tokens. Sampled rows do not speculate.

**Drafts**, anything with ``propose(context, k) -> tokens``:

* :class:`NgramDraft`: prompt lookup. The most recent earlier occurrence
  of the context's trailing n-gram proposes the tokens that followed it.
  No model, no device work.
* :class:`ModelDraft`: a small causal LM through the offline
  ``models/generate.generate`` on a context clipped to a window and
  left-padded to a power-of-two bucket (greedy).
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, runtime_checkable

import torch


@runtime_checkable
class DraftProvider(Protocol):
    """The draft interface: given the request's full context (prompt +
    emitted tokens, host ints), propose up to ``k`` next tokens. Fewer (or
    none) are fine: unfilled lanes are padded and fail verification."""

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ...


class NgramDraft:
    """Prompt-lookup decoding: tries the longest trailing n-gram first
    (``max_n`` down to ``min_n``); on a hit at position i, proposes
    ``context[i+n : i+n+k]``."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not (1 <= min_n <= max_n):
            raise ValueError(f"bad ngram range [{min_n}, {max_n}]")
        self.max_n = int(max_n)
        self.min_n = int(min_n)

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        ctx = list(context)
        L = len(ctx)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            tail = ctx[L - n:]
            # most recent earlier occurrence first
            for i in range(L - n - 1, -1, -1):
                if ctx[i:i + n] == tail:
                    return ctx[i + n:i + n + k]
        return []


class ModelDraft:
    """A small causal LM as the draft. The context is clipped to its
    trailing ``window`` tokens and left-padded to a power-of-two bucket
    (at least 8), as in JAX; the clip is an approximation the verifier
    makes harmless. Runs on the device of ``params``."""

    def __init__(self, params, cfg, *, window: int = 128,
                 compute_dtype: Optional[torch.dtype] = None):
        self.params = params
        self.cfg = cfg
        self.window = int(min(window, cfg.max_position_embeddings))
        self.compute_dtype = (compute_dtype if compute_dtype is not None
                              else torch.float32)
        self.device = params["embed"]["wte"].device

    def propose(self, context: Sequence[int], k: int) -> List[int]:
        from hetu_galvatron_tpu_torch.models.generate import generate

        ctx = [t for t in context if t < self.cfg.vocab_size][-self.window:]
        if not ctx or k < 1:
            return []
        bucket = 8
        while bucket < len(ctx):
            bucket *= 2
        bucket = min(bucket, self.window)
        ctx = ctx[-bucket:]
        if len(ctx) + k > self.cfg.max_position_embeddings:
            return []
        padded = torch.zeros((1, bucket), dtype=torch.long,
                             device=self.device)
        padded[0, bucket - len(ctx):] = torch.as_tensor(ctx,
                                                        dtype=torch.long)
        out = generate(self.params, padded, self.cfg, k,
                       prompt_lens=torch.tensor([len(ctx)],
                                                device=self.device),
                       pad_id=0, compute_dtype=self.compute_dtype)
        return out[0, bucket:].tolist()


def make_draft(serving, *, draft_params=None, draft_cfg=None
               ) -> Optional[DraftProvider]:
    """The draft the serving args ask for (None when spec decode is off).
    ``spec_draft="model"`` needs the draft checkpoint passed to the engine
    (``draft_params`` / ``draft_cfg``)."""
    if not serving.spec_decode:
        return None
    if serving.spec_draft == "model":
        if draft_params is None or draft_cfg is None:
            raise ValueError(
                "serving.spec_draft='model' needs draft_params + draft_cfg "
                "(the small draft checkpoint) passed to ServingEngine")
        return ModelDraft(draft_params, draft_cfg)
    return NgramDraft(max_n=serving.spec_ngram_max,
                      min_n=serving.spec_ngram_min)


def accept_length(drafted: Sequence[int], targets: Sequence[int],
                  k_eff: int) -> int:
    """Greedy acceptance: the longest prefix of ``drafted`` the target
    reproduced. ``targets[j]`` is the model's choice after seeing
    drafted[0..j-1]; drafted[j] survives iff it equals targets[j]. The
    emitted tokens are ``targets[0..a]`` (a accepted drafts + the bonus
    token), which is exactly the plain stream."""
    a = 0
    while a < k_eff and a < len(drafted) and drafted[a] == targets[a]:
        a += 1
    return a
