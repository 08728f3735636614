"""The port stands alone: no JAX, nothing of ``repro``, CUDA by default.

* every module of ``repro_torch`` imports in a subprocess whose import
  system refuses ``jax``, ``jaxlib`` and ``repro`` (but not
  ``repro_torch``);
* a static scan of ``src/repro_torch`` and ``chip_smoke.py`` finds no
  JAX and no ``repro.`` import;
* entry points default to CUDA and raise without a card;
* ``chip_smoke.py`` fails, printing no result, without a card and in a
  directory that holds nothing else of the repo;
* public symbols of the port carry docstrings (ruff's D1, re-checked).
"""
import ast
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _port_files():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


_BLOCKER = """
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro")
               for m in sys.modules), sorted(sys.modules)
print(len(names))
"""


def test_every_port_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKER], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n_modules = int(proc.stdout.strip().splitlines()[-1])
    assert n_modules == len(list(_port_files()))


@pytest.mark.parametrize("path", list(_port_files()) + [SMOKE],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_static_scan_finds_no_jax_or_repro_import(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Scheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-0.6b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_lm(cfg)
    model = init_lm(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scheduler(cfg, model)
    Scheduler(cfg, model, device="cpu")          # asked for: fine


def test_scheduler_raises_on_unported_arguments():
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Scheduler

    cfg = get_config("qwen3-0.6b", smoke=True)
    model = init_lm(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="spec_tokens"):
        Scheduler(cfg, model, device="cpu", spec_tokens=2)
    with pytest.raises(NotImplementedError, match="layout"):
        Scheduler(cfg, model, device="cpu", layout="dense")
    with pytest.raises(TypeError):
        Scheduler(cfg, model, device="cpu", no_such_option=1)


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run_smoke(ROOT, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _run_smoke(tmp_path, env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _missing_docstrings(path):
    tree = ast.parse(open(path).read())
    missing = [] if ast.get_docstring(tree) else ["<module>"]

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.ClassDef)) \
                    and not child.name.startswith("_"):
                if ast.get_docstring(child) is None:
                    missing.append(prefix + child.name)
                if isinstance(child, ast.ClassDef):
                    walk(child, f"{prefix}{child.name}.")
    walk(tree, "")
    return missing


def test_public_port_symbols_have_docstrings():
    problems = {os.path.relpath(p, ROOT): m for p in _port_files()
                if (m := _missing_docstrings(p))}
    assert problems == {}
