"""The port's own AST lint over the port's own tree (stdlib ``ast`` only).

Port of ``hetu_galvatron_tpu/analysis/lint.py``: ``Finding`` :90 with its
line-number-free fingerprint (rule:file:function:snippet#occurrence),
``lint_file`` :298, ``lint_package`` :322, the committed baseline
(``load_baseline`` :354, ``save_baseline`` :364, ``new_findings`` :381,
``stale_baseline`` :386, ``prune_baseline`` :395) and the gate of zero
NEW findings. JAX's rules are JAX idioms (``jax.device_get``, ``jax.jit``
in loops, ``named_scope``); each rule here keeps its number and its
intent, over what the port writes instead:

* **GAL001 host sync in the step path** — ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()`` and ``torch.cuda.synchronize`` in the
  step-path modules (:data:`HOT_PATH_MODULES`; of ``cli/train_dist.py``
  only ``train``, which holds the loop). Each one waits for the card and
  drains the launch queue: one blocking scalar copy a layer cost 35% of
  the serving decode step on an H100.
* **GAL002 build in a loop** — ``torch.compile``, ``torch.jit.*``, CUDA
  graph capture (``torch.cuda.graph``, ``CUDAGraph``,
  ``make_graphed_callables``) and ``_build.load_library`` inside a ``for``
  / ``while`` body or a comprehension: a recompile, re-capture or rebuild
  hazard when the loop is a step loop.
* **GAL004 computed span names** — an f-string or computed name as the
  first argument of ``span(...)`` or ``record_function(...)``:
  ``observability/trace_analysis.attribute`` matches spans by name.
* **GAL005 silent exception swallowing** — bare ``except:`` anywhere, and
  ``except Exception`` / ``BaseException`` whose body is only ``pass`` /
  ``continue`` (JAX's rule as it is).
* **GAL006 env reads outside the schema** — ``os.environ[...]``,
  ``os.environ.get`` and ``os.getenv`` anywhere but
  ``core/args_schema.py`` and ``cli/`` (JAX's rule as it is).

GAL003 (mesh-axis literals) waits for ROADMAP item 10b: the port's process
groups are built from ``runtime/mesh.py``'s axis tuples, and the rule's
canon is to be their names.

The committed baseline (``analysis/lint_baseline.json``: fingerprint ->
one-line justification) lists the accepted findings. The gate fails on a
new finding, on a stale entry, and on an entry without a justification
(:func:`unjustified_baseline`).
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

# step-path modules for GAL001 (relative to the package root): True = the
# whole module, a tuple = those top-level functions and what nests in them
HOT_PATH_MODULES: Dict[str, Union[bool, Sequence[str]]] = {
    "runtime/trainer.py": True,
    # the pipeline's schedule: a host sync there would serialize the
    # stages' launches (JAX runtime/pipeline.py:970-971)
    "runtime/pipeline.py": True,
    "cli/train_dist.py": ("train",),
    "serving/engine.py": True,
    "serving/scheduler.py": True,
    "observability/events.py": True,
    "observability/recorder.py": True,
}

# zero-argument tensor methods that copy to the host and wait for the card
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
_SYNC_CALLS = ("torch.cuda.synchronize", "cuda.synchronize")

# calls that compile, capture or build (GAL002)
_BUILD_CALLS = ("torch.compile", "torch.cuda.graph", "torch.cuda.CUDAGraph",
                "torch.cuda.make_graphed_callables", "CUDAGraph",
                "make_graphed_callables", "load_library",
                "_build.load_library")

# calls whose first argument names a span the trace attribution matches
_SPAN_CALLS = ("span", "record_function")

# modules where GAL006 permits ambient-environment reads: the schema is
# where config is defined, and cli/ is the process boundary that feeds it
_ENV_EXEMPT_PREFIXES = ("cli/",)
_ENV_EXEMPT_FILES = ("core/args_schema.py",)

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "lint_baseline.json")
TODO = "TODO: justify or fix"


@dataclass
class Finding:
    rule: str
    path: str          # package-relative, '/'-separated
    line: int
    func: str          # enclosing function ('<module>' at top level)
    snippet: str       # normalized source of the offending expression
    message: str
    occurrence: int = 0  # index among same-snippet findings in one func

    @property
    def fingerprint(self) -> str:
        return (f"{self.rule}:{self.path}:{self.func}:{self.snippet}"
                f"#{self.occurrence}")

    def __str__(self) -> str:
        return (f"{self.path}:{self.line} [{self.rule}] {self.message} "
                f"(in {self.func})")


def _callee(node: ast.Call) -> str:
    """Dotted name of a call target ('torch.compile', 'x.item')."""
    f = node.func
    parts: List[str] = []
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


def _snippet(node: ast.AST, src_lines: List[str]) -> str:
    line = src_lines[node.lineno - 1].strip() if node.lineno <= \
        len(src_lines) else ""
    return line[:120]


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, src: str,
                 hot_path: Union[bool, Sequence[str]]):
        self.path = path
        self.src_lines = src.splitlines()
        self.hot_path = hot_path
        self.env_exempt = (path in _ENV_EXEMPT_FILES
                           or path.startswith(_ENV_EXEMPT_PREFIXES))
        self.findings: List[Finding] = []
        self._func_stack: List[str] = []
        self._loop_depth = 0

    @property
    def func(self) -> str:
        return self._func_stack[-1] if self._func_stack else "<module>"

    @property
    def in_hot_path(self) -> bool:
        if self.hot_path is True:
            return True
        return bool(self.hot_path) and bool(self._func_stack) and \
            self._func_stack[0] in self.hot_path

    def _add(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.path, line=getattr(node, "lineno", 0),
            func=self.func, snippet=_snippet(node, self.src_lines),
            message=message))

    # -- scope / loop tracking -------------------------------------------

    def visit_FunctionDef(self, node):
        self._func_stack.append(node.name)
        # a def nested inside a loop runs its body only when called, so the
        # enclosing loop must not taint build-in-loop detection inside it
        outer_depth, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        self._loop_depth = outer_depth
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _visit_loop(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = visit_While = _visit_loop
    visit_ListComp = visit_SetComp = visit_DictComp = _visit_loop
    visit_GeneratorExp = _visit_loop

    # -- the rules --------------------------------------------------------

    def visit_Call(self, node: ast.Call):
        callee = _callee(node)
        short = callee.rsplit(".", 1)[-1]
        # GAL001: host syncs in the step path
        if self.in_hot_path:
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS
                    and not node.args and not node.keywords):
                self._add("GAL001", node,
                          f".{node.func.attr}() copies to the host and "
                          "waits for the card")
            elif callee in _SYNC_CALLS:
                self._add("GAL001", node,
                          "torch.cuda.synchronize waits for the card")
        # GAL002: compile / capture / build inside a loop
        if self._loop_depth > 0 and (
                callee in _BUILD_CALLS or callee.startswith("torch.jit.")):
            self._add("GAL002", node,
                      f"{callee}() inside a loop is a recompile/recapture/"
                      "rebuild hazard")
        # GAL006: ambient-environment reads outside the schema/CLI boundary
        if not self.env_exempt:
            if callee in ("os.getenv", "getenv"):
                self._add("GAL006", node,
                          "os.getenv outside core/args_schema.py / cli/ — "
                          "config must flow through the schema")
            elif callee in ("os.environ.get", "environ.get"):
                self._add("GAL006", node,
                          "os.environ.get outside core/args_schema.py / "
                          "cli/ — config must flow through the schema")
        # GAL004: computed span names
        if short in _SPAN_CALLS and node.args:
            a = node.args[0]
            if isinstance(a, ast.JoinedStr):
                self._add("GAL004", node,
                          f"f-string {short} name breaks trace attribution "
                          "(use a module-level constant)")
            elif not isinstance(a, (ast.Constant, ast.Name, ast.Attribute)):
                self._add("GAL004", node,
                          f"computed {short} name breaks trace attribution "
                          "(use a module-level constant)")
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript):
        # GAL006: os.environ["X"] reads (and writes)
        if not self.env_exempt:
            v = node.value
            if (isinstance(v, ast.Attribute) and v.attr == "environ"
                    and isinstance(v.value, ast.Name)
                    and v.value.id == "os"):
                self._add("GAL006", node,
                          "os.environ[...] outside core/args_schema.py / "
                          "cli/ — config must flow through the schema")
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if node.type is None:
            self._add("GAL005", node,
                      "bare 'except:' swallows KeyboardInterrupt/"
                      "SystemExit too — name the exception")
        elif (isinstance(node.type, ast.Name)
              and node.type.id in ("Exception", "BaseException")
              and all(isinstance(s, (ast.Pass, ast.Continue))
                      for s in node.body)):
            self._add("GAL005", node,
                      f"except {node.type.id} with a silent body hides "
                      "the audit trail — log what is swallowed")
        self.generic_visit(node)


def lint_file(path: str, rel: str,
              hot_path: Union[bool, Sequence[str]] = False) -> List[Finding]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding(rule="GAL000", path=rel, line=e.lineno or 0,
                        func="<module>", snippet=str(e),
                        message=f"syntax error: {e.msg}")]
    v = _Visitor(rel, src, hot_path)
    v.visit(tree)
    _number_occurrences(v.findings)
    return v.findings


def _number_occurrences(findings: List[Finding]) -> None:
    seen: Dict[str, int] = {}
    for f in findings:
        key = f"{f.rule}:{f.path}:{f.func}:{f.snippet}"
        f.occurrence = seen.get(key, 0)
        seen[key] = f.occurrence + 1


def lint_package(root: Optional[str] = None) -> List[Finding]:
    """Lint every .py file of the port (``root`` defaults to the
    hetu_galvatron_tpu_torch package directory)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            findings.extend(lint_file(full, rel,
                                      HOT_PATH_MODULES.get(rel, False)))
    return findings


# ---------------------------------------------------------------------------
# baseline (committed accepted findings, each with a justification)
# ---------------------------------------------------------------------------


def load_baseline(path: Optional[str] = None) -> Dict[str, str]:
    path = path or DEFAULT_BASELINE  # resolved at call time (testable)
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        obj = json.load(f)
    return {k: str(v) for k, v in obj.get("findings", obj).items()}


def _write_baseline(entries: Dict[str, str], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"findings": dict(sorted(entries.items()))}, f, indent=1)
        f.write("\n")


def save_baseline(findings: List[Finding], path: Optional[str] = None,
                  keep: Optional[Dict[str, str]] = None) -> None:
    """Write the baseline for the current findings, keeping existing
    justifications; new entries get a TODO placeholder, which the gate
    refuses until a person replaces it (:func:`unjustified_baseline`)."""
    keep = keep or {}
    _write_baseline({f.fingerprint: keep.get(f.fingerprint, TODO)
                     for f in findings}, path or DEFAULT_BASELINE)


def new_findings(findings: List[Finding],
                 baseline: Dict[str, str]) -> List[Finding]:
    return [f for f in findings if f.fingerprint not in baseline]


def stale_baseline(findings: List[Finding],
                   baseline: Dict[str, str]) -> List[str]:
    """Baselined fingerprints that no longer occur (fixed code)."""
    live = {f.fingerprint for f in findings}
    return [k for k in baseline if k not in live]


def unjustified_baseline(baseline: Dict[str, str]) -> List[str]:
    """Baselined fingerprints whose justification is empty or still the
    TODO placeholder: each counts as a finding."""
    return [k for k, v in baseline.items()
            if not v.strip() or v.strip().startswith("TODO")]


def prune_baseline(findings: List[Finding], path: Optional[str] = None
                   ) -> List[str]:
    """Drop the stale entries from the baseline in place and return them.
    Live entries keep their justifications and no new finding is
    accepted (``cli/check.py --prune-baseline``)."""
    path = path or DEFAULT_BASELINE
    baseline = load_baseline(path)
    stale = stale_baseline(findings, baseline)
    if not stale:
        return []
    _write_baseline({k: v for k, v in baseline.items() if k not in stale},
                    path)
    return stale
