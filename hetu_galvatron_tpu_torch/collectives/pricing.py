"""α-β pricing of any :class:`~.ir.Schedule`.

Port of ``hetu_galvatron_tpu/collectives/pricing.py``: ``invert_ring_fit``
:31, ``link_curves_from_algos`` :41, ``price_schedule_ms`` :78 and
``price_space`` :117, operation for operation (the search's dp-schedule
rankings are written into the plan JSON, so the floats must be JAX's).

The price is a per-link-class fill/drain walk over the wavefront slots:
steps sharing a slot on different link classes overlap, same-class peers
serialize, and each step bills one α plus its per-rank payload over the
link's β. The per-link curves are inverted out of the fitted
per-algorithm ring curves of the hardware profile: a fitted ring
all-reduce over ``m`` ranks is ``2(m-1)`` hops of ``1/m`` payload, so

    T_fit(mb) = α_fit + mb/β_fit  =  2(m-1)·α_link + 2(m-1)·mb/(m·β_link)
    ⇒  α_link = α_fit / (2(m-1)),   β_link = β_fit · 2(m-1)/m

which makes the pricer exact on the ring schedule it was inverted from.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

from hetu_galvatron_tpu_torch.collectives.ir import Schedule

LinkCurves = Dict[str, Tuple[float, float]]  # class -> (α ms, β MB/ms)


def invert_ring_fit(alpha_fit: float, beta_fit: float,
                    m: int) -> Tuple[float, float]:
    """Per-hop link (α, β) from a fitted ``m``-rank ring all-reduce
    curve (docstring math)."""
    if m < 2:
        raise ValueError(f"ring fit inversion needs m >= 2, got {m}")
    hops = 2 * (m - 1)
    return alpha_fit / hops, beta_fit * hops / m


def link_curves_from_algos(
        algos: Mapping[str, Mapping[str, Tuple[float, float]]],
        n_ici: int, n_dcn: int = 1) -> LinkCurves:
    """ici/dcn link curves inverted from the profiled per-algorithm
    tables (``CostContext.alpha_beta_algos`` layout:
    ``"{size}_{consec}" -> {"{alg}_{lvl}": (α, β)}``). The ici link
    prefers the ring fit at exactly ``n_ici`` consecutive ranks, the dcn
    link the strided/multi-host fit at ``n_dcn``; when the exact size
    was not profiled, the nearest profiled size at that level is
    inverted instead (the link is the same wire — only the fit's hop
    count changes, which the inversion divides back out)."""
    out: LinkCurves = {}
    for lvl, consec, want in (("ici", 1, n_ici), ("dcn", 0, n_dcn)):
        if want < 2:
            continue
        best: Optional[Tuple[int, float, float]] = None
        for key, table in algos.items():
            try:
                size_s, consec_s = key.rsplit("_", 1)
                size = int(size_s)
            except ValueError:
                continue
            if int(consec_s) != consec and lvl == "dcn":
                # dcn groups may also be profiled consec=1 on true
                # multi-host meshes; accept either, prefer consec match
                pass
            pair = table.get(f"ring_{lvl}")
            if pair is None:
                continue
            rank = abs(size - want)
            if best is None or rank < abs(best[0] - want):
                best = (size, pair[0], pair[1])
        if best is not None:
            out[lvl] = invert_ring_fit(best[1], best[2], best[0])
    return out


def price_schedule_ms(sched: Schedule, payload_mb: float,
                      curves: Mapping[str, Tuple[float, float]]
                      ) -> Optional[float]:
    """Milliseconds for one execution of ``sched`` moving a
    ``payload_mb``-MB per-device buffer, or None when a link class the
    schedule uses has no curve. Fill/drain over wavefront slots: per
    slot, same-class steps serialize (sum), classes overlap (max).

    ICI bandwidth bills × the torus hop distance
    (``Schedule.hop_distance``): the ICI mesh is nearest-neighbour
    links, so a stride-``2^k`` halving-doubling exchange occupies
    ``2^k`` links and its translation-invariant all-ranks pattern puts
    ``2^k`` messages on every link — which is exactly why the ring is
    bandwidth-optimal on a torus and the tree families only win the
    α-dominated small-payload regime. dcn exchanges are switch-routed:
    distance 1 always."""
    if sched.n_chunks < 1:
        return None
    chunk_mb = payload_mb / sched.n_chunks
    slots: Dict[int, Dict[str, float]] = {}
    for step in sched.steps:
        if step.op != "exchange" or not step.xfers:
            continue
        pair = curves.get(step.link)
        if pair is None:
            return None
        alpha, beta = pair
        if step.link == "ici":
            load = max(len(x.chunks) * sched.hop_distance(x.src, x.dst)
                       for x in step.xfers)
        else:
            load = sched.step_max_chunks_sent(step)
        mb = load * chunk_mb
        per = slots.setdefault(step.slot, {})
        per[step.link] = per.get(step.link, 0.0) + alpha + mb / beta
    return sum(max(per.values()) for per in slots.values()) if slots \
        else 0.0


def price_space(space: Mapping[str, Schedule], payload_mb: float,
                curves: Mapping[str, Tuple[float, float]]
                ) -> Dict[str, float]:
    """Price every schedule in a synthesized space; families a missing
    curve cannot price are dropped (min-over-curves never invents a
    number)."""
    out: Dict[str, float] = {}
    for name, sched in space.items():
        ms = price_schedule_ms(sched, payload_mb, curves)
        if ms is not None:
            out[name] = ms
    return out
