"""The port's ``cli/check.py``, in process: ``--all`` exits 0 on the
committed examples and names the passes it does not run; ``--schedules``
prints JAX's self-check line for line; ``--plan`` (with ``--model`` and
overrides), ``--memory`` (the examples, or one plan) and ``--lint`` give
JAX's exit codes; usage errors exit 2; ``--census``, ``--flow`` and
``--calibration`` exit 2 naming their ROADMAP items."""

import json
import os

import pytest

from hetu_galvatron_tpu.cli import check as JCK
from hetu_galvatron_tpu_torch.cli import check as TCK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QWEN = os.path.join(ROOT, "hetu_galvatron_tpu", "models", "configs",
                    "qwen2.5-7b.yaml")


def run(capsys, *argv):
    rc = TCK.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_torch_check_all_is_green(capsys):
    rc, out, _ = run(capsys, "--all")
    assert rc == 0, out[-3000:]
    assert "check --all: OK" in out and "lint: OK" in out
    assert "memory doctor: OK (all plans)" in out and "schedules: OK" in out
    assert out.count("plan doctor: OK") == 2
    for name in ("census", "flow", "calibration"):
        assert f"--{name}: not ported" in out
    assert "not ported: --census, --flow, --calibration" in out


def test_torch_schedules_pass_prints_jax_lines(capsys):
    assert JCK.run_schedules() == 0
    theirs = capsys.readouterr().out
    rc, ours, _ = run(capsys, "--schedules")
    assert rc == 0 and ours == theirs


@pytest.mark.parametrize("name,item", [("census", "16b"), ("flow", "16b"),
                                       ("calibration", "10")])
def test_torch_unported_passes_exit_2_naming_their_item(name, item, capsys):
    rc, out, err = run(capsys, f"--{name}")
    assert rc == 2 and not out
    assert f"--{name} is not ported yet" in err
    assert f"ROADMAP item {item}" in err
    rc, _, err = run(capsys, "--all", f"--{name}")
    assert rc == 2 and f"ROADMAP item {item}" in err


@pytest.mark.parametrize("argv", [[], ["model.num_hidden_layers=4"],
                                  ["--model", QWEN, "nonsense"],
                                  ["--bogus"]])
def test_torch_usage_errors_exit_2(argv, capsys):
    if argv == ["--bogus"]:
        with pytest.raises(SystemExit) as err:
            TCK.main(argv)
        assert err.value.code == 2
        return
    rc, _, _ = run(capsys, *argv)
    assert rc == 2


def _plan(tmp_path, **kw):
    plan = {"pp_deg": 1, "tp_sizes_enc": "1,1,1,1",
            "tp_consecutive_flags": "1,1,1,1", "dp_types_enc": "0,0,0,0",
            "use_sp": "0,0,0,0", "cp_sizes_enc": "1,1,1,1",
            "checkpoint": "1,0,1,0", "global_bsz": 2, "chunks": 2,
            "pp_division": "4", "pipeline_type": "pipedream_flush",
            "default_dp_type": "ddp", "vtp": 1, "vsp": 0, "embed_sdp": 0}
    plan.update(kw)
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan))
    return str(path)


def test_torch_plan_and_memory_of_a_searched_plan(tmp_path, capsys):
    """The commands phase 15 runs on the card: a world-1 plan of the
    Qwen widths cut to 4 layers, doctor and memory, exit 0; a budget it
    busts exits 1 with the doctor's reason; a plan of the wrong depth
    exits 1."""
    plan = _plan(tmp_path)
    base = ["--plan", plan, "--model", QWEN, "model.num_hidden_layers=4",
            "--world", "1"]
    rc, out, _ = run(capsys, *base)
    assert rc == 0 and "plan doctor: OK" in out
    assert "pipeline engine: spmd" in out and "refuses" not in out
    rc, out, _ = run(capsys, *base, "--memory", "--hbm-gb", "80")
    assert rc == 0 and out.count("OK") == 2
    assert "per-device peak" in out and "(budget 80 GB)" in out
    rc, out, _ = run(capsys, *base, "--memory", "--hbm-gb", "8")
    assert rc == 1 and "exceeds the --hbm-gb budget 8 GB" in out
    rc, out, _ = run(capsys, "--plan", plan, "--model", QWEN, "--world",
                     "1")
    assert rc == 1 and "plan has 4 layers, model has 28" in out


def test_torch_example_plans_match_jax_exit_codes(capsys):
    """``--plan`` on each committed example and ``--memory`` over all of
    them give JAX's exit codes; ``--hbm-gb`` below the examples' peak
    fails both."""
    for plan in sorted(os.listdir(TCK.EXAMPLE_PLAN_DIR)):
        path = os.path.join(TCK.EXAMPLE_PLAN_DIR, plan)
        jpath = os.path.join(JCK.EXAMPLE_PLAN_DIR, plan)
        for world in ("8", "6"):
            rc = TCK.main(["--plan", path, "--world", world])
            assert rc == JCK.run_doctor(jpath, None, int(world)), (plan,
                                                                   world)
    capsys.readouterr()
    for hbm in (None, 0.0000001):
        argv = ["--memory"] + ([] if hbm is None else ["--hbm-gb",
                                                       str(hbm)])
        rc = TCK.main(argv)
        assert rc == JCK.run_memory(hbm_gb=hbm) == (0 if hbm is None else 1)
        capsys.readouterr()


def test_torch_lint_pass_and_baseline_flags(tmp_path, monkeypatch, capsys):
    """``--lint`` is green on the tree; against a baseline with a stale
    and an unjustified entry it fails, ``--prune-baseline`` removes the
    stale one only, and ``--update-baseline`` rewrites from the live
    findings."""
    from hetu_galvatron_tpu_torch.analysis import lint as L

    rc, out, _ = run(capsys, "--lint")
    assert rc == 0 and "lint: OK" in out
    live = L.load_baseline()
    path = tmp_path / "baseline.json"
    first = sorted(live)[0]
    bad = dict(live, **{"GAL001:x.py:f:gone()#0": "was fixed",
                        first: "TODO: justify or fix"})
    path.write_text(json.dumps({"findings": bad}))
    monkeypatch.setattr(L, "DEFAULT_BASELINE", str(path))
    rc, out, _ = run(capsys, "--lint")
    assert rc == 1 and "stale: GAL001:x.py:f:gone()#0" in out
    assert f"without a justification: {first}" in out
    rc, out, _ = run(capsys, "--prune-baseline")
    assert rc == 1 and "pruned 1 stale baseline entry" in out
    assert "unjustified baseline entries" in out
    assert set(L.load_baseline(str(path))) == set(live)
    rc, out, _ = run(capsys, "--update-baseline")
    assert rc == 0 and L.load_baseline(str(path))[first].startswith("TODO")
