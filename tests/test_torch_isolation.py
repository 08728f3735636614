"""The port stands alone: no JAX, nothing of ``repro``, CUDA by default.

* every module of ``repro_torch`` imports in a subprocess whose import
  system refuses ``jax``, ``jaxlib`` and ``repro`` (but not
  ``repro_torch``);
* a static scan of ``src/repro_torch`` and ``chip_smoke.py`` finds no
  JAX and no ``repro.`` import;
* entry points (serving, the surrogate engine, LM and CycleGAN training,
  LTFB tournaments of either, the train and ltfb CLI modules included)
  default to CUDA and raise without a card;
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


def test_train_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch):
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as tlaunch
    from repro_torch.train.steps import init_lm_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-0.6b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_lm_state(cfg, OptimizerConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1"])
    init_lm_state(cfg, OptimizerConfig(), device="cpu")    # asked for


def test_ltfb_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.configs.icf_cyclegan import SMOKE
    from repro_torch.core.tournament import (DataPlan, TournamentConfig,
                                             TournamentOrchestrator)
    from repro_torch.data import jag
    from repro_torch.launch import ltfb
    from repro_torch.launch import train as tlaunch
    from repro_torch.train.steps import make_gan_steps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_gan_steps(SMOKE, OptimizerConfig())
    fns = ltfb.build_fns(ltfb.finish_args(ltfb.build_parser().parse_args(
        ["--smoke", "--device", "cpu"])))                  # asked for
    files = jag.write_bundles(str(tmp_path), 64, 16, image_size=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TournamentOrchestrator(fns, DataPlan.jag_cyclegan(files),
                               TournamentConfig(trainers=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ltfb.main(["--smoke", "--data-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--arch", "icf-cyclegan", "--smoke", "--steps", "1"])


def test_serving_and_lm_tournament_entry_points_default_to_cuda(
        monkeypatch, tmp_path):
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.configs.icf_cyclegan import SMOKE
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import ltfb, serve
    from repro_torch.models.icf_cyclegan import init_cyclegan
    from repro_torch.serve.surrogate import SurrogateEngine
    from repro_torch.train.steps import make_lm_population_fns

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-0.6b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_lm_population_fns(cfg, OptimizerConfig())
    make_lm_population_fns(cfg, OptimizerConfig(), device="cpu")
    params = init_cyclegan(SMOKE, 0, "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SurrogateEngine(SMOKE, params)
    SurrogateEngine(SMOKE, params, device="cpu")          # asked for
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "icf-cyclegan", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ltfb.main(["--arch", "qwen3-0.6b", "--smoke", "--data-dir",
                   str(tmp_path)])
    assert not list(tmp_path.iterdir())        # nothing written first


def test_gateway_and_journal_entry_points_default_to_cuda(monkeypatch,
                                                         tmp_path):
    """The serve CLI's gateway, journal and resume paths raise without a
    card before they bind a port or write a journal; asked for the CPU,
    the gateway's scheduler runs there."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.gateway import Gateway
    from repro_torch.serve.scheduler import Scheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    journal = tmp_path / "j.jsonl"
    for extra in (["--gateway", "--port", "0"],
                  ["--resume-journal", str(journal)],
                  ["--fault-spec", "kill@1"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--arch", "qwen3-0.6b", "--smoke", "--journal",
                        str(journal), *extra])
    assert not journal.exists()
    cfg = get_config("qwen3-0.6b", smoke=True)
    gw = Gateway(Scheduler(cfg, init_lm(cfg, device="cpu"), device="cpu"))
    assert gw.sched.device.type == "cpu"


def test_train_cli_module_raises_without_a_card():
    """``python -m repro_torch.launch.train`` with its default ``--device
    cuda`` exits non-zero, naming the missing card, and trains nothing."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-0.6b", "--smoke", "--steps", "1"], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "[train] done" not in proc.stdout


def test_ltfb_cli_module_raises_without_a_card(tmp_path):
    """``python -m repro_torch.launch.ltfb`` with its default ``--device
    cuda`` exits non-zero, naming the missing card, and trains nothing."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.ltfb", "--arch",
         "icf-cyclegan", "--smoke", "--data-dir", str(tmp_path)], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "[ltfb] round=" not in proc.stdout


def test_scheduler_raises_on_unported_arguments():
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Scheduler

    from repro_torch.serve.arena import Arena
    from repro_torch.serve.faults import FaultInjector

    cfg = get_config("qwen3-0.6b", smoke=True)
    model = init_lm(cfg, device="cpu")
    # every argument of the JAX scheduler is taken now: the arena loads
    # its champion into the target and its challenger into the drafter,
    # and refuses to run without a drafter model of its own
    weights = {n: t.detach().clone()
               for n, t in model.state_dict().items()}
    challenger = {n: t + 1 for n, t in weights.items()}
    drafter = init_lm(cfg, seed=1, device="cpu")
    arena = Arena({"a": weights, "b": challenger}, "a")
    sched = Scheduler(cfg, model, device="cpu", draft_params=drafter,
                      spec_tokens=2, arena=arena)
    assert sched.arena is arena
    assert torch.equal(drafter.embed.weight, challenger["embed.weight"])
    with pytest.raises(ValueError, match="speculative path"):
        Scheduler(cfg, model, device="cpu", arena=arena)
    with pytest.raises(ValueError, match="model of its own"):
        Scheduler(cfg, model, device="cpu", draft_params=model,
                  spec_tokens=2, arena=arena)
    # telemetry, the bounded queue, the journal and fault injection are
    # ported
    sched = Scheduler(cfg, model, device="cpu", telemetry=False,
                      trace_capacity=16, max_queue=2, journal=None,
                      faults=FaultInjector("stall@1:secs=0"))
    assert not sched.telemetry.enabled
    assert sched.telemetry.tracer.capacity == 16
    assert sched.max_queue == 2 and sched.faults.events[0].kind == "stall"
    with pytest.raises(ValueError, match="max_queue"):
        Scheduler(cfg, model, device="cpu", max_queue=0)
    with pytest.raises(ValueError, match="layout"):
        Scheduler(cfg, model, device="cpu", layout="bogus")
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
