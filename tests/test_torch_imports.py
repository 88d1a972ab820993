"""The port stands alone: it imports neither JAX nor the JAX package, nor
the packages its card's machine lacks (PyYAML, pydantic, optax, orbax,
transformers), and scipy only in the profile readers' fits. The lifecycle
modules the cross-process supervisor runs import no torch either: the card
belongs to its children; nor do the strategy search, the static checks and
the collective schedules, which are host arithmetic."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hetu_galvatron_tpu_torch")
BLOCKED = ("jax", "jaxlib", "yaml", "pydantic", "optax", "orbax",
           "transformers", "tensorboardX", "prometheus_client")
# every module of the checkpoint and fault lifecycle and of observability;
# the first ten are what the process supervisor imports, and they must not
# need torch
LIFECYCLE = (
    "hetu_galvatron_tpu_torch.cli.supervise",
    "hetu_galvatron_tpu_torch.runtime.supervisor",
    "hetu_galvatron_tpu_torch.runtime.ckpt_paths",
    "hetu_galvatron_tpu_torch.runtime.rerun_machine",
    "hetu_galvatron_tpu_torch.utils.retrying",
    "hetu_galvatron_tpu_torch.observability.registry",
    "hetu_galvatron_tpu_torch.observability.sinks",
    "hetu_galvatron_tpu_torch.observability.recorder",
    "hetu_galvatron_tpu_torch.observability.prometheus",
    "hetu_galvatron_tpu_torch.cli.summarize",
    "hetu_galvatron_tpu_torch.runtime.chaos",
    "hetu_galvatron_tpu_torch.cli.train_dist",
    "hetu_galvatron_tpu_torch.runtime.checkpoint",
    "hetu_galvatron_tpu_torch.runtime.dataloader",
    "hetu_galvatron_tpu_torch.runtime.trainer",
    "hetu_galvatron_tpu_torch.runtime.microbatches",
    "hetu_galvatron_tpu_torch.observability.goodput",
    "hetu_galvatron_tpu_torch.observability.tracing",
    "hetu_galvatron_tpu_torch.observability.telemetry",
    "hetu_galvatron_tpu_torch.observability.trace_analysis",
    "hetu_galvatron_tpu_torch.runtime.pipeline",
    # the compiled pipeline and the reshard between the engine layouts
    "hetu_galvatron_tpu_torch.runtime.compiled_pipeline",
    "hetu_galvatron_tpu_torch.runtime.reshard",
)
# the modules of the profile -> search -> train loop; the search side (all
# but the model profiler and the profiler launcher) imports no torch
SEARCH = (
    "hetu_galvatron_tpu_torch.utils.strategy",
    "hetu_galvatron_tpu_torch.utils.hf_config_adapter",
    "hetu_galvatron_tpu_torch.analysis.eligibility",
    "hetu_galvatron_tpu_torch.core.search_engine.strategies",
    "hetu_galvatron_tpu_torch.core.search_engine.profiles",
    "hetu_galvatron_tpu_torch.core.search_engine.dp",
    "hetu_galvatron_tpu_torch.core.search_engine.engine",
    "hetu_galvatron_tpu_torch.core.cost_model.cost",
    "hetu_galvatron_tpu_torch.core.profiler.hardware_profiler",
    "hetu_galvatron_tpu_torch.cli.search_dist",
    "hetu_galvatron_tpu_torch.core.profiler.model_profiler",
    "hetu_galvatron_tpu_torch.cli.profiler",
)
# the static checks and the collective-schedule pricing: host arithmetic
# that imports no torch either (the plan doctor reads models/moe.py, which
# does, only when it diagnoses a plan)
STATIC = (
    "hetu_galvatron_tpu_torch.collectives",
    "hetu_galvatron_tpu_torch.collectives.ir",
    "hetu_galvatron_tpu_torch.collectives.synthesize",
    "hetu_galvatron_tpu_torch.collectives.verify",
    "hetu_galvatron_tpu_torch.collectives.pricing",
    "hetu_galvatron_tpu_torch.analysis.memory_doctor",
    "hetu_galvatron_tpu_torch.analysis.plan_doctor",
    "hetu_galvatron_tpu_torch.analysis.lint",
    "hetu_galvatron_tpu_torch.cli.check",
)
# the SPMD plans over ranks: the rank grid and lowering (host arithmetic,
# no torch at import), the collectives, the step and the spawner
SPMD = (
    "hetu_galvatron_tpu_torch.runtime.mesh",
    "hetu_galvatron_tpu_torch.parallel",
    "hetu_galvatron_tpu_torch.parallel.comm",
    "hetu_galvatron_tpu_torch.parallel.spmd",
    "hetu_galvatron_tpu_torch.parallel.launch",
)
# scipy (curve_fit) is allowed in the profile readers alone
SCIPY_ALLOWED = os.path.join("hetu_galvatron_tpu_torch", "core",
                             "search_engine", "profiles.py")
JAX_PKG = "hetu_galvatron_tpu"


def _is_blocked(module: str) -> bool:
    # exact name or name + "." : hetu_galvatron_tpu_torch shares the prefix
    return any(module == b or module.startswith(b + ".")
               for b in BLOCKED + (JAX_PKG,))


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_torch_blocked_name_check_respects_the_prefix():
    assert _is_blocked("hetu_galvatron_tpu")
    assert _is_blocked("hetu_galvatron_tpu.models.modules")
    assert _is_blocked("jax.numpy") and _is_blocked("yaml")
    assert _is_blocked("orbax.checkpoint")
    assert not _is_blocked("hetu_galvatron_tpu_torch.models.modules")
    assert not _is_blocked("jaxtyping") and not _is_blocked("yamlish")


def test_torch_port_sources_import_nothing_blocked():
    """AST scan of every port file and chip_smoke.py, including imports
    inside functions."""
    files = _port_files()
    assert len(files) > 15 and os.path.exists(files[0])
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            rel = os.path.relpath(path, ROOT)
            bad += [(rel, n) for n in names if _is_blocked(n) or (
                (n == "scipy" or n.startswith("scipy."))
                and rel != SCIPY_ALLOWED)]
    assert not bad, bad


def test_torch_every_port_module_imports_with_jax_blocked():
    """In a fresh interpreter (tests/conftest.py has already imported jax
    here) with the blocked packages poisoned in sys.modules."""
    code = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r} + ("scipy",):
    sys.modules[name] = None
import hetu_galvatron_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
assert set({LIFECYCLE!r}) <= set(mods), set({LIFECYCLE!r}) - set(mods)
assert set({SEARCH!r}) <= set(mods), set({SEARCH!r}) - set(mods)
assert set({STATIC!r}) <= set(mods), set({STATIC!r}) - set(mods)
assert set({SPMD!r}) <= set(mods), set({SPMD!r}) - set(mods)
import chip_smoke
leaked = sorted(m for m in sys.modules if m == {JAX_PKG!r}
                or m.startswith({JAX_PKG!r} + "."))
assert not leaked, leaked
print(len(mods))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20


def test_torch_supervisor_side_imports_no_torch():
    """The supervisor process (``cli/supervise.py`` and what it imports,
    with ``cli/train_dist.py``'s flag check) runs with torch poisoned."""
    code = f"""
import importlib, sys
for name in {BLOCKED!r} + ("torch",):
    sys.modules[name] = None
for m in {LIFECYCLE[:10] + LIFECYCLE[11:12]!r}:
    importlib.import_module(m)
from hetu_galvatron_tpu_torch.cli.train_dist import check_flags
from hetu_galvatron_tpu_torch.core.arguments import load_config
check_flags(load_config("hetu_galvatron_tpu/models/configs/gpt2-small.yaml",
                        ["supervisor.auto_restart=true",
                         "supervisor.mode=process",
                         "supervisor.metrics_port=0",
                         "observability.enabled=true"]))
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "ok"


def test_torch_search_side_imports_no_torch():
    """The strategy search is host arithmetic: its modules (and the
    world-1 hardware profiler), the static checks, the collective
    schedules and the rank grid import with torch poisoned, and the scipy fits load only
    when a profile is fitted."""
    code = f"""
import importlib, sys
for name in {BLOCKED!r} + ("torch",):
    sys.modules[name] = None
for m in {SEARCH[:-2] + STATIC + SPMD[:1]!r}:
    importlib.import_module(m)
assert "scipy" not in sys.modules
from hetu_galvatron_tpu_torch.core.search_engine.profiles import fit_linear
assert [round(float(v), 6) for v in fit_linear([1, 2, 3], [3, 5, 7])] == [
    2.0, 1.0]
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "ok"
