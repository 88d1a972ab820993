"""The port's own lint (``analysis/lint.py``): each rule on synthetic
snippets (what it flags and what it leaves alone), the line-number-free
fingerprint, the baseline's load / save / prune round trip and its
justification rule, and the port's tree clean against its committed
baseline, every entry justified."""

import json
import textwrap

import pytest

from hetu_galvatron_tpu_torch.analysis import lint as L


def findings(tmp_path, src, rel="pkg/mod.py", hot=False):
    path = tmp_path / "mod.py"
    path.write_text(textwrap.dedent(src))
    return L.lint_file(str(path), rel, hot)


SNIPPETS = {
    # GAL001: host syncs, in a step-path module only
    "item": ("GAL001", True, "def f(x):\n    return x.item()\n", 1),
    "cpu": ("GAL001", True, "def f(x):\n    return x.cpu()\n", 1),
    "tolist": ("GAL001", True, "def f(x):\n    return x.sum().tolist()\n",
               1),
    "numpy": ("GAL001", True, "def f(x):\n    return x.numpy()\n", 1),
    "synchronize": ("GAL001", True,
                    "import torch\ndef f():\n    torch.cuda.synchronize()\n",
                    1),
    "item_off_the_step_path": ("GAL001", False,
                               "def f(x):\n    return x.item()\n", 0),
    "method_with_args_is_no_sync": ("GAL001", True,
                                    "def f(d):\n    return d.cpu(1)\n", 0),
    "train_only": ("GAL001", ("train",),
                   "def train(x):\n    def step():\n        return x.item()\n"
                   "    return step()\n\ndef main(x):\n    return x.item()\n",
                   1),
    # GAL002: compile / capture / build inside loops only
    "compile_in_loop": ("GAL002", False,
                        "import torch\nfor m in ms:\n    torch.compile(m)\n",
                        1),
    "jit_in_comprehension": ("GAL002", False,
                             "import torch\n[torch.jit.script(m) for m in ms]\n",
                             1),
    "graph_in_while": ("GAL002", False,
                       "import torch\nwhile go:\n    with torch.cuda.graph("
                       "g):\n        pass\n", 1),
    "load_library_in_loop": ("GAL002", False,
                             "from x import _build\nfor i in r:\n"
                             "    _build.load_library()\n", 1),
    "compile_outside_loop": ("GAL002", False,
                             "import torch\nf = torch.compile(m)\n", 0),
    "def_inside_loop_resets": ("GAL002", False,
                               "import torch\nfor i in r:\n    def g():\n"
                               "        return torch.compile(m)\n", 0),
    # GAL004: computed span / record_function names
    "fstring_span": ("GAL004", False, "def f(i):\n    span(f'step{i}')\n", 1),
    "computed_record_function": ("GAL004", False,
                                 "def f(a):\n    record_function('x' + a)\n",
                                 1),
    "constant_span": ("GAL004", False,
                      "NAME = 'x'\ndef f():\n    span('step')\n"
                      "    record_function(NAME)\n", 0),
    # GAL005: bare and silent excepts
    "bare_except": ("GAL005", False,
                    "try:\n    f()\nexcept:\n    raise\n", 1),
    "silent_exception": ("GAL005", False,
                         "try:\n    f()\nexcept Exception:\n    pass\n", 1),
    "silent_base_exception_continue": (
        "GAL005", False,
        "for x in y:\n    try:\n        f()\n    except BaseException:\n"
        "        continue\n", 1),
    "logged_exception": ("GAL005", False,
                         "try:\n    f()\nexcept Exception as e:\n"
                         "    print(e)\n", 0),
    # GAL006: env reads outside the schema and cli/
    "getenv": ("GAL006", False, "import os\nos.getenv('X')\n", 1),
    "environ_get": ("GAL006", False, "import os\nos.environ.get('X')\n", 1),
    "environ_subscript": ("GAL006", False, "import os\nos.environ['X']\n",
                          1),
}


@pytest.mark.parametrize("case", list(SNIPPETS))
def test_torch_each_rule_on_snippets(case, tmp_path):
    rule, hot, src, want = SNIPPETS[case]
    got = [f for f in findings(tmp_path, src, hot=hot) if f.rule == rule]
    assert len(got) == want, [str(f) for f in got]


@pytest.mark.parametrize("rel", ["cli/x.py", "core/args_schema.py"])
def test_torch_env_reads_are_allowed_at_the_boundary(rel, tmp_path):
    src = "import os\nos.getenv('X')\nos.environ['Y']\n"
    assert findings(tmp_path, src, rel=rel) == []


def test_torch_syntax_error_is_a_finding(tmp_path):
    (f,) = findings(tmp_path, "def f(:\n")
    assert f.rule == "GAL000" and "syntax error" in f.message


def test_torch_fingerprint_survives_line_shifts(tmp_path):
    """The fingerprint is rule:file:function:snippet#occurrence: adding
    lines above a finding keeps it, a second identical line in the same
    function numbers it #1."""
    src = "def f(x):\n    a = x.item()\n    a = x.item()\n"
    a = findings(tmp_path, src, hot=True)
    b = findings(tmp_path, "import os\n\n\n" + src, hot=True)
    assert [f.fingerprint for f in a] == [f.fingerprint for f in b]
    assert [f.line for f in a] != [f.line for f in b]
    assert [f.fingerprint for f in a] == [
        "GAL001:pkg/mod.py:f:a = x.item()#0",
        "GAL001:pkg/mod.py:f:a = x.item()#1"]
    assert str(a[0]).startswith("pkg/mod.py:2 [GAL001]")


def test_torch_baseline_round_trip_and_prune(tmp_path):
    """save keeps justifications and writes TODO for new entries (which
    the gate refuses); new / stale are set differences; prune only
    removes stale entries and keeps every live justification."""
    path = str(tmp_path / "baseline.json")
    fs = findings(tmp_path, "def f(x):\n    x.item()\n    x.cpu()\n",
                  hot=True)
    L.save_baseline(fs, path, keep={fs[0].fingerprint: "emit boundary"})
    base = L.load_baseline(path)
    assert base == {fs[0].fingerprint: "emit boundary",
                    fs[1].fingerprint: L.TODO}
    assert L.unjustified_baseline(base) == [fs[1].fingerprint]
    assert L.new_findings(fs, base) == [] and L.stale_baseline(fs, base) == []
    live = fs[:1]
    assert L.stale_baseline(live, base) == [fs[1].fingerprint]
    assert L.prune_baseline(live, path) == [fs[1].fingerprint]
    assert L.load_baseline(path) == {fs[0].fingerprint: "emit boundary"}
    assert L.prune_baseline(live, path) == []
    assert L.new_findings(fs, L.load_baseline(path)) == fs[1:]
    assert L.unjustified_baseline({"k": " "}) == ["k"]
    with open(path) as f:
        assert list(json.load(f)) == ["findings"]
    assert L.load_baseline(str(tmp_path / "missing.json")) == {}


def test_torch_port_tree_is_clean_against_its_baseline():
    """The gate ``cli/check.py --lint`` runs: no new finding, no stale
    entry, every entry with a one-line justification."""
    fs = L.lint_package()
    base = L.load_baseline()
    assert L.new_findings(fs, base) == [], [str(f) for f in
                                            L.new_findings(fs, base)]
    assert L.stale_baseline(fs, base) == []
    assert L.unjustified_baseline(base) == []
    assert all("\n" not in v and len(v) > 20 for v in base.values())
    # the step-path modules are walked, and the one-function entry applies
    assert L.HOT_PATH_MODULES["cli/train_dist.py"] == ("train",)
    assert {f.path for f in fs} >= {"serving/engine.py"}
