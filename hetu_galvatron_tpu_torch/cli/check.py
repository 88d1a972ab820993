"""Static checks CLI: ``python -m hetu_galvatron_tpu_torch.cli.check``.

Port of ``hetu_galvatron_tpu/cli/check.py``'s host passes. They run on the
CPU with no card and no training step:

* ``--plan plan.json [--model cfg.yaml [key=value ...]] [--world N]
  [--schedule-impl compiled|host] [--no-tp-overlap]`` — Pass 1, the plan
  doctor (``analysis/plan_doctor.py``). The ``key=value`` overrides after
  the YAML are the port's addition (``model.num_hidden_layers=4`` cuts a
  searched model's depth, as the launchers take it).
* ``--lint [--update-baseline | --prune-baseline]`` — Pass 3, the port's
  own lint (``analysis/lint.py``) against its committed baseline
  (``analysis/lint_baseline.json``): zero new findings, no stale entry,
  every entry justified.
* ``--memory [--hbm-gb N]`` — Pass 4, the memory doctor over the committed
  example plans (``profiles/example_plans/``, byte-equal to JAX's) plus a
  serving-mode row on the acceptance plan, as JAX's (:186). With
  ``--plan`` it diagnoses that plan instead, under ``--model`` and
  ``--world`` (the port's addition: how a searched plan is checked before
  it is trained).
* ``--schedules`` — Pass 7, the collective-schedule self-check, check for
  check JAX's ``run_schedules`` (:440).
* ``--all`` — passes 1, 3, 4 and 7 on the committed examples.

``--census`` and ``--flow`` (Passes 2 and 5) read JAX programs; their torch
counterparts are ROADMAP item 16b. ``--calibration`` (Pass 6) checks the
calibration loop, ROADMAP item 10b. Each exits 2 naming its item, and
``--all`` lists them as not ported, never as passed.

Exit code 0 = clean, 1 = findings/errors, 2 = usage, as in JAX.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional, Sequence

EXAMPLE_PLAN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "profiles", "example_plans")
ACCEPTANCE_PLAN = os.path.join(
    EXAMPLE_PLAN_DIR, "galvatron_config_acceptance_tp2dp2pp2.json")

# the passes that wait for a later slice, and the ROADMAP item each needs
NOT_PORTED = {
    "census": "the collective census reads JAX programs; its torch "
              "counterpart is ROADMAP item 16b",
    "flow": "the sharding-flow byte census reads JAX programs; its torch "
            "counterpart is ROADMAP item 16b",
    "calibration": "the calibration loop it checks is ROADMAP item 10b",
}


def _example_model():
    """The tiny 4-layer model the committed example plans were written
    for (JAX ``cli/check.py::_example_model`` :78)."""
    from hetu_galvatron_tpu_torch.core.arguments import load_config

    return load_config({
        "model": {
            "hidden_size": 64, "num_hidden_layers": 4,
            "num_attention_heads": 4, "vocab_size": 256,
            "seq_length": 16, "max_position_embeddings": 32,
            "hidden_act": "swiglu", "normalization": "rmsnorm",
            "position_embedding_type": "rope", "tie_word_embeddings": False,
            "add_bias_linear": False, "add_qkv_bias": False,
            "make_vocab_size_divisible_by": 1, "ffn_hidden_size": 128,
        },
    })


def _load_model(model_path: Optional[str], overrides: Sequence[str] = ()):
    """--model: a train_dist-style YAML (with key=value overrides), or None
    for the example model."""
    if model_path is None:
        if overrides:
            raise ValueError(f"overrides {list(overrides)} need --model")
        return _example_model().model
    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli
    from hetu_galvatron_tpu_torch.utils.hf_config_adapter import (
        resolve_model_config,
    )

    args = args_from_cli([model_path, *overrides], mode="train_dist")
    return resolve_model_config(args).model


def run_doctor(plan: str, model_path: Optional[str], world: Optional[int],
               *, schedule_impl: str = "compiled", tp_overlap: bool = True,
               overrides: Sequence[str] = ()) -> int:
    from hetu_galvatron_tpu_torch.analysis.plan_doctor import diagnose_plan

    cfg = _load_model(model_path, overrides)
    report = diagnose_plan(plan, cfg, world, schedule_impl=schedule_impl,
                           tp_overlap=tp_overlap)
    report.render()
    return 0 if report.ok else 1


def _census_serving_args():
    """The serving shape of the serving-mode memory row (JAX :176)."""
    from hetu_galvatron_tpu_torch.core.args_schema import ServingArgs

    return ServingArgs(max_batch_size=2, kv_block_size=8,
                       max_seq_len=32, num_kv_blocks=10,
                       prefix_cache=True, spec_decode=True, spec_k=2)


def run_memory(hbm_gb: Optional[float] = None, verbose: bool = True,
               schedule_impl: str = "compiled") -> int:
    """Pass 4: the memory doctor over every committed example plan, plus
    a serving-mode row (KV pool + prefix budget) on the acceptance plan."""
    from hetu_galvatron_tpu_torch.analysis.memory_doctor import (
        diagnose_memory,
    )

    model = _example_model().model
    rc = 0
    for plan in sorted(glob.glob(os.path.join(EXAMPLE_PLAN_DIR, "*.json"))):
        report = diagnose_memory(plan, model, 8, hbm_gb=hbm_gb,
                                 schedule_impl=schedule_impl)
        if verbose:
            report.render()
            print()
        rc |= 0 if report.ok else 1
    serving = _census_serving_args()
    report = diagnose_memory(ACCEPTANCE_PLAN, model, 8, hbm_gb=hbm_gb,
                             serving=serving,
                             schedule_impl=schedule_impl)
    if verbose:
        print("(serving mode: paged KV pool + prefix-cache budget)")
        report.render()
    rc |= 0 if report.ok else 1
    print(f"memory doctor: {'OK' if rc == 0 else 'FAILED'} (all plans)")
    return rc


def run_plan_memory(plan: str, model_path: Optional[str],
                    world: Optional[int], *, hbm_gb: Optional[float] = None,
                    schedule_impl: str = "compiled",
                    overrides: Sequence[str] = ()) -> int:
    """Pass 4 on one plan (``--plan P --memory``)."""
    from hetu_galvatron_tpu_torch.analysis.memory_doctor import (
        diagnose_memory,
    )

    report = diagnose_memory(plan, _load_model(model_path, overrides), world,
                             hbm_gb=hbm_gb, schedule_impl=schedule_impl)
    report.render()
    return 0 if report.ok else 1


def run_lint(update_baseline: bool = False, prune_stale: bool = False,
             verbose: bool = True) -> int:
    from hetu_galvatron_tpu_torch.analysis.lint import (
        lint_package,
        load_baseline,
        new_findings,
        prune_baseline,
        save_baseline,
        stale_baseline,
        unjustified_baseline,
    )

    findings = lint_package()
    baseline = load_baseline()
    if prune_stale:
        removed = prune_baseline(findings)
        print(f"lint: pruned {len(removed)} stale baseline entr"
              f"{'y' if len(removed) == 1 else 'ies'}")
        for k in removed[:10]:
            print(f"  pruned: {k}")
        baseline = load_baseline()
        # fall through: a prune that leaves new findings stays red
    if update_baseline:
        save_baseline(findings, keep=baseline)
        print(f"lint: baseline rewritten with {len(findings)} finding(s); "
              "fill in any 'TODO: justify or fix' entries")
        return 0
    new = new_findings(findings, baseline)
    stale = stale_baseline(findings, baseline)
    bare = unjustified_baseline(baseline)
    if verbose:
        print(f"lint: {len(findings)} finding(s), "
              f"{len(findings) - len(new)} baselined, {len(new)} new")
    for f in new:
        print(f"LINT: {f}")
    if stale:
        print(f"lint: {len(stale)} baselined finding(s) no longer occur — "
              "prune them with --prune-baseline:")
        for k in stale[:10]:
            print(f"  stale: {k}")
    for k in bare:
        print(f"LINT: baseline entry without a justification: {k}")
    if new:
        verdict = ("FAILED (new findings — fix them or baseline with a "
                   "justification via --update-baseline)")
    elif stale:
        verdict = "FAILED (stale baseline — prune with --prune-baseline)"
    elif bare:
        verdict = "FAILED (unjustified baseline entries)"
    else:
        verdict = "OK"
    print(f"lint: {verdict}")
    return 0 if verdict == "OK" else 1


def run_schedules() -> int:
    """Pass 7 — the collective-schedule self-check, check for check JAX's
    ``run_schedules`` (:440): synthesize the schedule space over a set of
    group shapes, verify every schedule, price the space with synthetic
    link curves (ring-fit inversion exactness, the small/large-payload
    winner flip, a missing curve dropping a family), and probe that a
    mutated schedule is rejected naming its step."""
    import dataclasses

    from hetu_galvatron_tpu_torch.collectives.ir import ScheduleError
    from hetu_galvatron_tpu_torch.collectives.pricing import (
        invert_ring_fit,
        price_schedule_ms,
        price_space,
    )
    from hetu_galvatron_tpu_torch.collectives.synthesize import (
        ring_all_reduce,
        synthesize_space,
    )
    from hetu_galvatron_tpu_torch.collectives.verify import verify

    print("== collective-schedule self-check ==")
    failures: List[str] = []

    def check(ok: bool, what: str) -> None:
        print(f"  {'ok' if ok else 'FAIL'}: {what}")
        if not ok:
            failures.append(what)

    shapes = ((2, 1), (4, 1), (6, 1), (8, 1), (8, 2), (12, 3), (16, 4))
    for n, cross in shapes:
        space = synthesize_space(n, cross=cross)
        bad: List[str] = []
        for name, sched in space.items():
            try:
                verify(sched)
            except ScheduleError as e:
                bad.append(f"{name}: {e}")
        check(not bad,
              f"n={n} cross={cross}: all {len(space)} schedules verify"
              + (f" — {bad[0]}" if bad else ""))
        intra = n // cross if cross > 1 else n
        curves = {"ici": invert_ring_fit(0.05, 10.0, max(intra, 2))}
        if cross > 1:
            curves["dcn"] = invert_ring_fit(0.5, 1.0, max(cross, 2))
        prices = price_space(space, 8.0, curves)
        check(set(prices) == set(space)
              and all(v > 0 for v in prices.values()),
              f"n={n} cross={cross}: every family prices > 0 "
              f"({len(prices)}/{len(space)})")

    # ring-fit inversion exactness on the ring it was inverted from
    a_fit, b_fit = 0.05, 10.0
    ici8 = {"ici": invert_ring_fit(a_fit, b_fit, 8)}
    exact = True
    for mb in (0.001, 1.0, 64.0):
        got = price_schedule_ms(ring_all_reduce(8), mb, ici8)
        want = a_fit + mb / b_fit
        exact = exact and got is not None and abs(got - want) <= 1e-9 * want
    check(exact, "ring-fit inversion is exact on the ring schedule")

    # the flip the search keys on: tiny payloads to a tree, bulk to a ring
    space8 = synthesize_space(8)
    tiny = price_space(space8, 0.0005, ici8)
    bulk = price_space(space8, 64.0, ici8)
    check(min(tiny, key=tiny.get) in ("tree_hd", "tree_bcast"),
          f"tiny payload winner is a tree ({min(tiny, key=tiny.get)})")
    check(min(bulk, key=bulk.get) in ("ring", "torus2d"),
          f"bulk payload winner is ring/torus ({min(bulk, key=bulk.get)})")

    # a link class with no curve drops the family, never invents a price
    dcn_only = price_space(synthesize_space(8, cross=2), 8.0,
                           {"dcn": invert_ring_fit(0.5, 1.0, 2)})
    check("ring" in dcn_only and "tree_hd" not in dcn_only,
          "missing ici curve drops the trees, keeps the dcn-only ring")

    # the verifier has teeth: a duplicated source rank names the step
    sched = ring_all_reduce(4)
    step0 = sched.steps[0]
    mutated = dataclasses.replace(
        sched, steps=(dataclasses.replace(
            step0, xfers=step0.xfers + (step0.xfers[0],)),)
        + sched.steps[1:])
    try:
        verify(mutated)
        check(False, "mutated schedule (duplicate source) is rejected")
    except ScheduleError as e:
        check("step 0" in str(e),
              f"duplicate-source rejection names the step ({e})")

    print(f"schedules: {'OK' if not failures else 'FAILED'}")
    return 0 if not failures else 1


def run_all(hbm_gb: Optional[float] = None,
            schedule_impl: str = "compiled") -> int:
    """The ported passes on the committed examples: the plan doctor over
    every example plan, the memory doctor with its cost-model cross-check,
    the lint baseline gate and the schedule self-check."""
    rc = 0
    for plan in sorted(glob.glob(os.path.join(EXAMPLE_PLAN_DIR, "*.json"))):
        rc |= run_doctor(plan, None, 8, schedule_impl=schedule_impl)
        print()
    rc |= run_memory(hbm_gb=hbm_gb, schedule_impl=schedule_impl)
    print()
    rc |= run_lint()
    print()
    rc |= run_schedules()
    print()
    for name, why in NOT_PORTED.items():
        print(f"--{name}: not ported ({why})")
    print(f"check --all: {'OK' if rc == 0 else 'FAILED'} (plan, memory, "
          f"lint, schedules; not ported: "
          f"{', '.join('--' + n for n in NOT_PORTED)})")
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m hetu_galvatron_tpu_torch.cli.check",
        description="static checks: plan doctor, memory doctor, the port's "
                    "lint, the collective-schedule self-check")
    p.add_argument("overrides", nargs="*", metavar="key=value",
                   help="overrides of the --model YAML "
                   "(e.g. model.num_hidden_layers=4)")
    p.add_argument("--plan", help="plan JSON to diagnose (Pass 1)")
    p.add_argument("--model", help="train_dist-style YAML config for the "
                   "model the plan targets (default: the tiny example "
                   "model the committed plans were written for)")
    p.add_argument("--world", type=int, default=None,
                   help="world size to validate the plan against "
                   "(default: the smallest world the plan fits)")
    p.add_argument("--schedule-impl", choices=("compiled", "host"),
                   default="compiled", help="pipeline schedule impl the "
                   "doctors account for (default compiled)")
    p.add_argument("--no-tp-overlap", action="store_true",
                   help="doctor: assume tp_overlap.enable is off")
    p.add_argument("--lint", action="store_true",
                   help="run the port's lint against the baseline (Pass 3)")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the lint baseline from current findings, "
                   "preserving existing justifications")
    p.add_argument("--prune-baseline", action="store_true",
                   help="remove STALE lint-baseline fingerprints only "
                   "(never accepts new findings), then run the gate")
    p.add_argument("--memory", action="store_true",
                   help="run the memory doctor (Pass 4) on the committed "
                   "example plans, or on --plan")
    p.add_argument("--hbm-gb", type=float, default=None,
                   help="per-device memory budget in GB: the memory doctor "
                   "rejects plans whose predicted peak exceeds it (the "
                   "predicate search.hbm_budget_gb prunes with)")
    p.add_argument("--schedules", action="store_true",
                   help="run the collective-schedule self-check (Pass 7)")
    for name, why in NOT_PORTED.items():
        p.add_argument(f"--{name}", action="store_true",
                       help=f"not ported: {why}")
    p.add_argument("--all", action="store_true",
                   help="every ported pass on the committed examples")
    a = p.parse_args(argv)

    asked = [n for n in NOT_PORTED if getattr(a, n)]
    if asked:
        for n in asked:
            print(f"check: --{n} is not ported yet: {NOT_PORTED[n]}",
                  file=sys.stderr)
        return 2
    bad = [o for o in a.overrides if "=" not in o]
    if bad or (a.overrides and a.model is None):
        p.print_usage(sys.stderr)
        print(f"check: key=value overrides need --model (got "
              f"{a.overrides})", file=sys.stderr)
        return 2
    if a.all:
        return run_all(hbm_gb=a.hbm_gb, schedule_impl=a.schedule_impl)
    rc = None
    if a.plan:
        rc = run_doctor(a.plan, a.model, a.world,
                        schedule_impl=a.schedule_impl,
                        tp_overlap=not a.no_tp_overlap,
                        overrides=a.overrides)
    if a.memory:
        if a.plan:
            print()
            rc = (rc or 0) | run_plan_memory(
                a.plan, a.model, a.world, hbm_gb=a.hbm_gb,
                schedule_impl=a.schedule_impl, overrides=a.overrides)
        else:
            rc = (rc or 0) | run_memory(hbm_gb=a.hbm_gb,
                                        schedule_impl=a.schedule_impl)
    if a.schedules:
        rc = (rc or 0) | run_schedules()
    if a.lint or a.update_baseline or a.prune_baseline:
        rc = (rc or 0) | run_lint(update_baseline=a.update_baseline,
                                  prune_stale=a.prune_baseline)
    if rc is None:
        p.print_help()
        return 2
    return rc


if __name__ == "__main__":
    sys.exit(main())
