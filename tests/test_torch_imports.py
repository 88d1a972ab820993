"""The port stands alone: it imports neither JAX nor the JAX package, nor
the packages its card's machine lacks (PyYAML, pydantic, optax,
transformers)."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hetu_galvatron_tpu_torch")
BLOCKED = ("jax", "jaxlib", "yaml", "pydantic", "optax", "transformers")
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
            bad += [(os.path.relpath(path, ROOT), n) for n in names
                    if _is_blocked(n)]
    assert not bad, bad


def test_torch_every_port_module_imports_with_jax_blocked():
    """In a fresh interpreter (tests/conftest.py has already imported jax
    here) with the blocked packages poisoned in sys.modules."""
    code = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import hetu_galvatron_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
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
