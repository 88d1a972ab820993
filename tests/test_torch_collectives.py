"""The port's collective-schedule IR, synthesis, verifier and pricing
(``hetu_galvatron_tpu_torch/collectives/``) against the JAX package's,
exactly: every synthesized schedule field for field, the broken-schedule
corpus of ``tests/collectives/test_verify_corpus.py`` (the same mutations,
the same diagnostic text), the prices of ``tests/collectives/
test_pricing.py`` (the same floats, ``==``), the link curves inverted from
profiled per-algorithm tables, and the IR's structural helpers."""

import dataclasses

import pytest

from hetu_galvatron_tpu.collectives import ir as JI
from hetu_galvatron_tpu.collectives import pricing as JP
from hetu_galvatron_tpu.collectives import synthesize as JS
from hetu_galvatron_tpu.collectives import verify as JV
from hetu_galvatron_tpu_torch.collectives import ir as TI
from hetu_galvatron_tpu_torch.collectives import pricing as TP
from hetu_galvatron_tpu_torch.collectives import synthesize as TS
from hetu_galvatron_tpu_torch.collectives import verify as TV

SIDES = {"jax": (JI, JS, JV, JP), "port": (TI, TS, TV, TP)}
SHAPES = [(2, 1), (4, 1), (6, 1), (8, 1), (8, 2), (12, 3), (16, 4), (16, 1),
          (32, 4)]
A_FIT, B_FIT = 0.05, 10.0


def plain(sched):
    """A schedule as nested plain values (the two packages' classes
    differ, their fields must not)."""
    return dataclasses.asdict(sched)


@pytest.mark.parametrize("n,cross", SHAPES)
def test_torch_synthesize_space_matches_jax(n, cross):
    theirs, ours = JS.synthesize_space(n, cross), TS.synthesize_space(n, cross)
    assert list(ours) == list(theirs) and ours
    for name in theirs:
        assert plain(ours[name]) == plain(theirs[name]), name
        assert TV.verify(ours[name]) is ours[name]


GENERATORS = [
    ("ring_all_reduce", (5,)), ("ring_reduce_scatter", (6,)),
    ("ring_all_gather", (6,)), ("halving_doubling_all_reduce", (16,)),
    ("tree_all_reduce", (8,)), ("torus2d_all_reduce", (3, 4)),
    ("hier_all_reduce", (3, 4)), ("hier_all_reduce", (2, 2)),
]


@pytest.mark.parametrize("fn,args", GENERATORS,
                         ids=[f"{f}{a}" for f, a in GENERATORS])
def test_torch_each_generator_matches_jax(fn, args):
    theirs, ours = getattr(JS, fn)(*args), getattr(TS, fn)(*args)
    assert plain(ours) == plain(theirs)
    slc = tuple(r % 2 for r in range(ours.n_ranks))
    if fn in ("ring_all_reduce", "halving_doubling_all_reduce"):
        # with a slice map the steps crossing it are tagged dcn
        assert plain(getattr(TS, fn)(*args, slc)) == \
            plain(getattr(JS, fn)(*args, slc))


DP_CASES = [("ring", 8, 1), ("tree_hd", 8, 2), ("tree_bcast", 4, 1),
            ("torus2d", 8, 2), ("torus2d", 6, 1), ("hier_rings", 8, 2),
            ("torus2d", 5, 1), ("tree_hd", 6, 1), ("nope", 8, 1)]


@pytest.mark.parametrize("name,lanes,cross", DP_CASES)
def test_torch_synthesize_dp_schedule_matches_jax(name, lanes, cross):
    out = {}
    for side, (_, syn, _, _) in SIDES.items():
        try:
            out[side] = plain(syn.synthesize_dp_schedule(name, lanes, cross))
        except ValueError as e:
            out[side] = ("ValueError", str(e))
    assert out["port"] == out["jax"]


def _mutate_step(sched, i, **fields):
    steps = list(sched.steps)
    steps[i] = dataclasses.replace(steps[i], **fields)
    return dataclasses.replace(sched, steps=tuple(steps))


def _dropped(syn):
    s = syn.ring_all_reduce(4)
    return _mutate_step(s, 0, xfers=s.steps[0].xfers[1:])


def _dup_reduction(syn):
    s = syn.ring_all_reduce(4)
    return dataclasses.replace(s, steps=(s.steps[0], s.steps[0])
                               + s.steps[1:])


def _ici_lie(syn):
    s = syn.hier_all_reduce(2, 2)
    i = next(i for i, st in enumerate(s.steps) if st.link == "dcn")
    return _mutate_step(s, i, link="ici")


def _cyclic(syn):
    return _mutate_step(syn.ring_all_reduce(4), 2, slot=0)


def _under_declared(syn):
    s = syn.ring_all_reduce(4)
    return dataclasses.replace(
        s, declared_sends_per_rank=s.declared_sends_per_rank - 1)


def _dup_source(syn):
    s = syn.ring_all_reduce(4)
    x = s.steps[0].xfers
    return _mutate_step(s, 0, xfers=x + (x[0],))


def _dup_destination(syn):
    s = syn.ring_all_reduce(4)
    x = s.steps[0].xfers
    return _mutate_step(s, 0, xfers=(dataclasses.replace(
        x[0], dst=x[1].dst),) + x[1:])


def _send_of_nothing(syn):
    s = syn.ring_all_gather(4)
    x0 = s.steps[0].xfers[0]
    wrong = tuple(k for k in range(s.n_chunks) if s.owner[k] != x0.src)[:1]
    return _mutate_step(s, 0, xfers=(dataclasses.replace(
        x0, chunks=wrong),) + s.steps[0].xfers[1:])


def _chunk_range(syn):
    s = syn.ring_all_reduce(4)
    x = s.steps[0].xfers
    return _mutate_step(s, 0, xfers=(dataclasses.replace(
        x[0], chunks=(s.n_chunks,)),) + x[1:])


def _rank_range(syn):
    s = syn.ring_all_reduce(4)
    x = s.steps[0].xfers
    return _mutate_step(s, 0, xfers=(dataclasses.replace(
        x[0], dst=s.n_ranks),) + x[1:])


def _truncated(syn):
    s = syn.ring_all_reduce(4)
    return dataclasses.replace(s, steps=s.steps[:-2],
                               declared_sends_per_rank=None)


def _over_reduced(syn):
    s = syn.ring_all_reduce(2)
    again = tuple(dataclasses.replace(st, slot=st.slot + 100)
                  for st in s.steps if st.combine == "add")
    return dataclasses.replace(s, steps=s.steps + again,
                               declared_sends_per_rank=None)


def _bad_kind(syn):
    return dataclasses.replace(syn.ring_all_reduce(4), kind="gossip")


def _short_slice_map(syn):
    return dataclasses.replace(syn.ring_all_reduce(4), slice_of=(0, 0))


def _no_owner(syn):
    return dataclasses.replace(syn.ring_reduce_scatter(4), owner=None)


def _bad_copy(syn):
    s = syn.ring_all_reduce(4)
    step = dataclasses.replace(s.steps[0], op="copy", xfers=(),
                               copies=((0, 0, 9),))
    return dataclasses.replace(s, steps=(step,) + s.steps[1:])


CORPUS = {
    "dropped_transfer": (_dropped, "incomplete all_reduce"),
    "duplicate_reduction": (_dup_reduction, "duplicate reduction"),
    "ici_tag_on_cross_slice": (_ici_lie, "link-class violation"),
    "cyclic_wavefront": (_cyclic, "cyclic/non-monotone"),
    "under_declared_budget": (_under_declared, "count/byte mismatch"),
    "duplicate_source": (_dup_source, "source of two transfers"),
    "duplicate_destination": (_dup_destination, "destination of two"),
    "send_of_nothing": (_send_of_nothing, "holds no contribution"),
    "chunk_out_of_range": (_chunk_range, "out of range"),
    "rank_out_of_range": (_rank_range, "out of range"),
    "unknown_link": (lambda syn: _mutate_step(
        syn.ring_all_reduce(4), 0, link="nvlink"), "unknown link"),
    "unknown_combine": (lambda syn: _mutate_step(
        syn.ring_all_reduce(4), 0, combine="max"), "unknown combine"),
    "unknown_op": (lambda syn: _mutate_step(
        syn.ring_all_reduce(4), 0, op="gather"), "unknown op"),
    "truncated": (_truncated, "incomplete all_reduce"),
    "over_reduction": (_over_reduced, "duplicate reduction"),
    "unknown_kind": (_bad_kind, "unknown kind"),
    "short_slice_map": (_short_slice_map, "slice_of has 2 entries"),
    "missing_owner_map": (_no_owner, "needs an owner map"),
    "copy_out_of_range": (_bad_copy, "copy on rank 0 names chunk 9"),
}


@pytest.mark.parametrize("case", list(CORPUS))
def test_torch_verify_corpus_rejects_with_jax_text(case):
    """Each mutation of the JAX corpus (and a few more of the structure
    checks) raises ``ScheduleError`` on both sides with the same text."""
    make, needle = CORPUS[case]
    msgs = {}
    for side, (ir, syn, ver, _) in SIDES.items():
        with pytest.raises(ir.ScheduleError) as err:
            ver.verify(make(syn))
        msgs[side] = str(err.value)
    assert msgs["port"] == msgs["jax"] and needle in msgs["port"], msgs


@pytest.mark.parametrize("m", [2, 4, 8, 16])
@pytest.mark.parametrize("mb", [0.001, 1.0, 64.0])
def test_torch_ring_inversion_prices_match_jax(m, mb):
    ours = TP.price_schedule_ms(TS.ring_all_reduce(m), mb,
                                {"ici": TP.invert_ring_fit(A_FIT, B_FIT, m)})
    theirs = JP.price_schedule_ms(JS.ring_all_reduce(m), mb, {
        "ici": JP.invert_ring_fit(A_FIT, B_FIT, m)})
    assert ours == theirs
    assert ours == pytest.approx(A_FIT + mb / B_FIT, rel=1e-9)


PRICE_CASES = [(n, cross, mb, curves) for n, cross in SHAPES
               for mb in (0.0005, 8.0, 64.0)
               for curves in ("ici", "dcn", "both")]


@pytest.mark.parametrize("n,cross,mb,curves", PRICE_CASES)
def test_torch_price_space_matches_jax(n, cross, mb, curves):
    """Every family's price and the dict's key order (what the plan JSON
    writes); a family a missing link curve cannot price is dropped on
    both sides."""
    intra = n // cross if cross > 1 else n
    out = {}
    for side, (_, syn, _, pr) in SIDES.items():
        c = {}
        if curves in ("ici", "both"):
            c["ici"] = pr.invert_ring_fit(A_FIT, B_FIT, max(intra, 2))
        if curves in ("dcn", "both"):
            c["dcn"] = pr.invert_ring_fit(0.5, 1.0, max(cross, 2))
        out[side] = list(pr.price_space(syn.synthesize_space(n, cross), mb,
                                        c).items())
    assert out["port"] == out["jax"]


ALGOS = [
    {"8_1": {"ring_ici": (0.8, 8.0)}, "4_1": {"ring_ici": (0.4, 4.0)},
     "2_0": {"ring_dcn": (2.0, 1.0)}},
    {"8_1": {"tree_ici": (1.0, 1.0)}},
    {"2_1": {"ring_ici": (0.05, 300.0), "ring_dcn": (1.0, 10.0)},
     "bad": {"ring_ici": (9.0, 9.0)}, "16_0": {"ring_dcn": (3.0, 2.0)}},
    {},
]


@pytest.mark.parametrize("algos", ALGOS)
@pytest.mark.parametrize("n_ici,n_dcn", [(8, 2), (6, 1), (2, 4), (1, 16)])
def test_torch_link_curves_from_algos_match_jax(algos, n_ici, n_dcn):
    assert TP.link_curves_from_algos(algos, n_ici, n_dcn) == \
        JP.link_curves_from_algos(algos, n_ici, n_dcn)


def test_torch_invert_ring_fit_rejects_a_group_of_one():
    for pr in (JP, TP):
        with pytest.raises(ValueError, match="m >= 2"):
            pr.invert_ring_fit(A_FIT, B_FIT, 1)


def test_torch_schedule_helpers_match_jax():
    """hop distances on the torus, exchange counts, padding and byte
    predictions, scope prefixes."""
    for n, cross in SHAPES:
        for name, ours in TS.synthesize_space(n, cross).items():
            theirs = JS.synthesize_space(n, cross)[name]
            for a in range(ours.n_ranks):
                for b in range(ours.n_ranks):
                    assert ours.hop_distance(a, b) == \
                        theirs.hop_distance(a, b)
                    assert ours.link_of(a, b) == theirs.link_of(a, b)
            assert ours.n_exchanges == theirs.n_exchanges
            assert ours.sends_per_rank() == theirs.sends_per_rank()
            for elems in (1, 7, 1000, 123457):
                assert ours.padded_elems(elems) == theirs.padded_elems(elems)
                assert ours.chunk_elems(elems) == theirs.chunk_elems(elems)
                assert ours.exchange_bytes_per_rank(elems, 2) == \
                    theirs.exchange_bytes_per_rank(elems, 2)
            assert [ours.step_max_chunks_sent(s) for s in ours.steps] == \
                [theirs.step_max_chunks_sent(s) for s in theirs.steps]
            assert plain(ours.with_scope_prefix("x/")) == \
                plain(theirs.with_scope_prefix("x/"))
