"""LTFB across process ranks: the port's mesh backend against the JAX
package's, on the CPU over gloo.

Every multi-rank case runs in subprocesses with their own timeout: four
torch ranks (``repro_torch.launch.mesh.start``, one thread each) that run
``make_ltfb_step`` (full and int8), ``compressed_psum_pod``, the rank
groups of ``make_ltfb_mesh`` and the mesh orchestrator over the SMOKE
CycleGAN; the ltfb CLI under ``--backend mesh`` (it spawns its own four
ranks); a killed and a stalled rank; and one JAX process with four host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``) that
runs the same cases through JAX's ``make_ltfb_step`` / ``shard_map``,
its mesh orchestrator (``tests/test_tournament.py``'s ``MESH_SCRIPT``
config) and its CLI.  All of them start together in one module fixture.

Inputs are made with numpy from a seed (the tournament steps' weights are
multiples of 1/8, so that both packages compute every metric exactly);
the orchestrators start from the same JAX initial weights, crossed
through ``repro_torch.bridge``.  Tolerances are stated per test.
"""
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.checkpoint import ckpt as jckpt
from repro.optim import compression as jcomp
from repro_torch import bridge
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.base import OptimizerConfig
from repro_torch.configs.icf_cyclegan import SMOKE
from repro_torch.core.population import TrainerFns
from repro_torch.core.tournament import (DataPlan, TournamentConfig,
                                         TournamentOrchestrator)
from repro_torch.data import jag as tjag
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import compression as tcomp
from repro_torch.train import steps as tsteps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, ROUNDS = 4, 4              # make_ltfb_step: trainers, rounds
JOB_TIMEOUT = 150             # seconds any one subprocess job may take
# the host backend's tolerance on a tournament metric
# (tests/test_torch_ltfb.py::test_population_matches_jax)
METRIC_RTOL = 1e-5
# the orchestrator's run: tests/test_tournament.py's MESH_SCRIPT config
ORCH = dict(trainers=4, scope="generator", batch_size=8, num_ranks=2,
            tournament_batches=1, tournament_batch_size=16, seed=0)
ORCH_ROUNDS, ORCH_STEPS = 2, 1
CLI_FLAGS = ["--backend", "mesh", "--smoke", "--trainers", "4",
             "--rounds", "2", "--steps-per-round", "2", "--log-json"]
TIMEOUT_DRILL_S = 4.0         # --dist-timeout of the stalled-rank drill


def _port_fns():
    """The SMOKE CycleGAN's trainer functions on the CPU with the ltfb
    launcher's checkpoint layout (JAX's)."""
    return TrainerFns(*tsteps.make_gan_steps(
        SMOKE, OptimizerConfig(name="adam", lr=1e-3), device="cpu"),
        to_ckpt=lambda p, o: (bridge.cyclegan_params_to_jax_layout(p),
                              bridge.cyclegan_opt_state_to_jax_layout(o)),
        from_ckpt=lambda p, o: (bridge.cyclegan_params_from_jax(p),
                                bridge.cyclegan_opt_state_from_jax(o)))


def _step_inputs():
    """Per-trainer weights and batches for the tournament steps: two
    leaves each, every value a multiple of 1/8."""
    rng = np.random.default_rng(7)
    w = rng.integers(-40, 40, size=(K, 5)).astype(np.float32) / 8
    b = rng.integers(-40, 40, size=(K, 2, 3)).astype(np.float32) / 8
    t = rng.integers(-40, 40, size=(K, 2)).astype(np.float32) / 8
    return {"w": w, "b": b, "t": t}


def _psum_inputs():
    """Gradients of two leaves a rank; ranks 0 and 1 hold
    tests/test_optim.py's two pods, ranks 2 and 3 two more ramps."""
    ramp = [np.linspace(-1, 1, 64), np.linspace(2, -2, 64),
            np.linspace(-0.5, 1.5, 64), np.linspace(0.3, -0.7, 64)]
    g = np.stack(ramp).astype(np.float32)
    h = np.stack([np.linspace(-0.9, 0.9, 15).reshape(3, 5) * (r - 1.5)
                  for r in range(K)]).astype(np.float32)
    return {"g": g, "h": h, "eg": np.zeros_like(g), "eh": np.zeros_like(h)}


# ---------------------------------------------------------------------------
# the jobs
# ---------------------------------------------------------------------------

RANK_SCRIPT = r"""
import json, os, sys, time
import numpy as np
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import bridge
from repro_torch.configs.base import OptimizerConfig
from repro_torch.configs.icf_cyclegan import SMOKE
from repro_torch.core import ltfb
from repro_torch.core.population import TrainerFns
from repro_torch.core.tournament import (DataPlan, TournamentConfig,
                                         TournamentOrchestrator)
from repro_torch.launch import mesh
from repro_torch.optim import compression as comp
from repro_torch.train import steps as tsteps
from repro_torch.train.telemetry import GenealogyLog, TrainTelemetry
from repro_torch.telemetry import write_trace

work = sys.argv[1]
cfg = json.load(open(os.path.join(work, "cfg.json")))
ranks = mesh.init_ranks("gloo", "cpu", timeout_s=60)
r = ranks.rank
out = {}

# -- the rank groups of a 2 x 2 LTFB grid, and a grid too large
grid = mesh.make_ltfb_mesh(2, per_trainer_model=2)
for axis in grid.axes:
    got = [None] * 2
    dist.all_gather_object(got, r, group=grid.groups[axis])
    out[f"group_{axis}"] = got
try:
    mesh.make_ltfb_mesh(4, per_trainer_model=2)
    out["too_large"] = None
except mesh.RankLayoutError as e:
    out["too_large"] = str(e)

# -- make_ltfb_step, full and int8
inp = np.load(os.path.join(work, "step_inputs.npz"))
def metric(p, b):      # an abs between each product and sum (see JAX's)
    return (torch.abs(torch.abs(p["w"][0]) - b["t"][0])
            + torch.abs(torch.abs(p["b"][1, 2]) - b["t"][1]))
batch = {"t": torch.from_numpy(inp["t"][r])}
for mode, quant in (("full", False), ("int8", True)):
    step = ltfb.make_ltfb_step(metric, 4, None, "full", quant)
    p = {"w": torch.from_numpy(inp["w"][r]), "b": torch.from_numpy(inp["b"][r])}
    rec = {"w": [], "b": [], "ml": [], "mo": [], "partner": []}
    for rnd in range(cfg["rounds"]):
        old, before = p, {k: v.clone() for k, v in p.items()}
        p, ml, mo = step(p, batch, rnd)
        for k in ("w", "b"):
            rec[k].append(p[k].numpy().copy())
        rec["ml"].append(np.float32(ml)); rec["mo"].append(np.float32(mo))
        rec["partner"].append(step.partner(rnd))
        # the received model is unpacked into new tensors: the local
        # weights are never written through
        assert all(torch.equal(before[k], old[k]) for k in before)
    np.savez(os.path.join(work, f"step_{mode}_{r}.npz"),
             **{k: np.stack(v) for k, v in rec.items()})
    out[f"wire_{mode}"] = step.last["wire_bytes"]

# -- compressed_psum_pod: pods of 2 ({0,1}, {2,3}) and of 4
ps = np.load(os.path.join(work, "psum_inputs.npz"))
pods2 = [dist.new_group([0, 1]), dist.new_group([2, 3])]
for pods, group in ((2, pods2[r // 2]), (4, None)):
    g = {"g": torch.from_numpy(ps["g"][r]), "h": torch.from_numpy(ps["h"][r])}
    e = {"g": torch.from_numpy(ps["eg"][r]), "h": torch.from_numpy(ps["eh"][r])}
    mean, err = comp.compressed_psum_pod(g, e, group, pods)
    np.savez(os.path.join(work, f"psum_{pods}_{r}.npz"),
             mean_g=mean["g"].numpy(), mean_h=mean["h"].numpy(),
             err_g=err["g"].numpy(), err_h=err["h"].numpy())

# -- the mesh orchestrator from JAX's initial weights (the JAX job's)
t0 = time.monotonic()
while not os.path.exists(os.path.join(work, "inits.npz")):
    assert time.monotonic() - t0 < 120, "the JAX job wrote no weights"
    time.sleep(0.1)
inits = np.load(os.path.join(work, "inits.npz"))
def unflat(prefix):
    tree = {}
    for key in inits.files:
        if not key.startswith(prefix):
            continue
        node, parts = tree, key[len(prefix):].split("/")
        for a in parts[:-1]:
            node = node.setdefault(a, {})
        node[parts[-1]] = inits[key]
    def fix(n):
        if isinstance(n, dict) and n and all(k.isdigit() for k in n):
            return [fix(n[str(i)]) for i in range(len(n))]
        return {k: fix(v) for k, v in n.items()} if isinstance(n, dict) else n
    return fix(tree)
tinit, tstep, tmetric = tsteps.make_gan_steps(
    SMOKE, OptimizerConfig(name="adam", lr=1e-3), device="cpu")
def init(seed):
    _, opt, h = tinit(seed)
    return bridge.cyclegan_params_from_jax(unflat(f"{seed}/")), opt, h
fns = TrainerFns(   # the launcher's checkpoint layout: JAX's
    init, tstep, tmetric,
    to_ckpt=lambda p, o: (bridge.cyclegan_params_to_jax_layout(p),
                          bridge.cyclegan_opt_state_to_jax_layout(o)),
    from_ckpt=lambda p, o: (bridge.cyclegan_params_from_jax(p),
                            bridge.cyclegan_opt_state_from_jax(o)))
files = cfg["files"]
tel = TrainTelemetry()
# every rank is handed a genealogy; rank 0 alone keeps and writes it
gen = GenealogyLog(os.path.join(work, f"genealogy_{r}.jsonl"))
oc = TournamentConfig(backend="mesh", device="cpu", ckpt_dir=cfg["ckpt"],
                      **cfg["orch"])
orch = TournamentOrchestrator(fns, DataPlan.jag_cyclegan(files), oc,
                              telemetry=tel, genealogy=gen)
assert (orch.genealogy is not None) == (r == 0)
logs = []
orig = orch.tournament
orch.tournament = lambda: logs.append(orig()) or logs[-1]
orch.run(cfg["orch_rounds"], cfg["orch_steps"], ckpt_every=1)
st = orch.stats()
me = orch.population.trainers[r]
np.savez(os.path.join(work, f"final_{r}.npz"),
         **{f"{h}/{n}": t.numpy() for h in ("gen", "disc")
            for n, t in me.params[h].items()})
orch.gather_trace()
if r == 0:
    write_trace(tel.tracer, os.path.join(work, "trace.json"))
out["orch"] = {"logs": [dict({k: v for k, v in lg.items()
                              if k not in ("seconds", "exchange_seconds")},
                             exchange_timed=lg["exchange_seconds"] > 0)
                        for lg in logs],
               "wins": [d["wins"] for d in st["per_trainer"]],
               "adoptions": [d["adoptions"] for d in st["per_trainer"]],
               "steps": [d["steps"] for d in st["per_trainer"]],
               "bytes": st["tournament_exchange_bytes"],
               "round": st["round"], "cache_hits": st["total"]["cache_hits"]}
out["lr"] = me.hparams["lr"]
out["remote"] = [t.remote for t in orch.population.trainers]
# a dead trainer stops the static schedule (RuntimeError on every rank);
# recovering it clones the best trainer's weights from that rank
orch.fail(1)
try:
    orch.tournament()
    out["dead"] = None
except RuntimeError as e:
    out["dead"] = str(e)
scores = [None] * 4
dist.all_gather_object(scores, float(tmetric(me.params, orch.val_batch)))
orch.recover(1, from_best=True)
out["recover_src"] = min((v, i) for i, v in enumerate(scores))[1]
out["recovered_val"] = float(tmetric(orch.population.trainers[r].params,
                                     orch.val_batch))
out["scores"] = scores
orch.close()
gen.close()

# -- the host backend's checkpoint (the "host" job's) resumes under the
# mesh backend: each rank reads its own member's weights and every
# member's counters
t0 = time.monotonic()
while not os.path.exists(os.path.join(work, "host.json")):
    assert time.monotonic() - t0 < 120, "the host job wrote nothing"
    time.sleep(0.1)
hc = TournamentConfig(backend="mesh", device="cpu",
                      ckpt_dir=cfg["host_ckpt"], **cfg["orch"])
with TournamentOrchestrator(fns, DataPlan.jag_cyclegan(files), hc) as o3:
    assert o3.maybe_resume()
    mine = o3.population.trainers[r].params
    want = np.load(os.path.join(work, f"host_final_{r}.npz"))
    out["host_resume"] = {
        "round": o3.population.round,
        "equal": all(np.array_equal(mine[h][n].numpy(), want[f"{h}/{n}"])
                     for h in ("gen", "disc") for n in mine[h]),
        "wins": [t.wins for t in o3.population.trainers],
        "steps": [t.steps for t in o3.population.trainers]}

# -- one concatenated tournament batch (JAX's mesh backend), no
# perturbation: a metric that counts the rows it is given
count = TrainerFns(init, tstep, lambda p, b: torch.tensor(
    float(b["x"].shape[0])))
cc = dict(cfg["orch"], tournament_batches=2)
with TournamentOrchestrator(count, DataPlan.jag_cyclegan(files),
                            TournamentConfig(backend="mesh", device="cpu",
                                             **cc)) as o2:
    out["count_metrics"] = o2.tournament()["metrics"]
json.dump(out, open(os.path.join(work, f"rank_{r}.json"), "w"))
dist.destroy_process_group()
print("RANK", r, "OK")
"""

JAX_SCRIPT = r"""
import collections, contextlib, io, json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs.base import OptimizerConfig
from repro.configs import icf_cyclegan as jc
from repro.core import ltfb
from repro.core.population import TrainerFns
from repro.core.tournament import (DataPlan, TournamentConfig,
                                   TournamentOrchestrator)
from repro.optim import compression as comp
from repro.parallel.sharding import shard_map_compat
from repro.train.steps import make_gan_steps
from repro.train.telemetry import GenealogyLog

work = sys.argv[1]
cfg = json.load(open(os.path.join(work, "cfg.json")))
# the orchestrator's initial weights, first: the torch ranks start from
# them
fns = TrainerFns(*make_gan_steps(jc.SMOKE,
                                 OptimizerConfig(name="adam", lr=1e-3)))
def flat(tree, prefix):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}
inits = {}
for i in range(cfg["orch"]["trainers"]):
    seed = cfg["orch"]["seed"] + 1000 * i + 1
    inits.update(flat(fns.init(seed)[0], f"{seed}/"))
np.savez(os.path.join(work, "inits.tmp.npz"), **inits)
os.replace(os.path.join(work, "inits.tmp.npz"),
           os.path.join(work, "inits.npz"))
K = 4
devs = np.asarray(jax.devices())
mesh = Mesh(devs.reshape(K, 1), ("trainer", "model"))
inp = np.load(os.path.join(work, "step_inputs.npz"))
# XLA contracts a product followed by a sum into one fused multiply-add:
# an abs between the dequantizing product and the subtraction keeps every
# operation of the metric singly rounded in both packages
def metric(p, b):
    return (jnp.abs(jnp.abs(p["w"][0]) - b["t"][0])
            + jnp.abs(jnp.abs(p["b"][1, 2]) - b["t"][1]))
for mode, quant in (("full", False), ("int8", True)):
    step = ltfb.make_ltfb_step(metric, K, mesh, axis="trainer", scope="full",
                               quantize=quant)
    p = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
    batch = {"t": jnp.asarray(inp["t"])}
    rec = {"w": [], "b": [], "ml": [], "mo": []}
    for rnd in range(cfg["rounds"]):
        p, ml, mo = step(p, batch, jnp.int32(rnd))
        rec["w"].append(np.asarray(p["w"])); rec["b"].append(np.asarray(p["b"]))
        rec["ml"].append(np.asarray(ml)); rec["mo"].append(np.asarray(mo))
    np.savez(os.path.join(work, f"jax_step_{mode}.npz"),
             **{k: np.stack(v) for k, v in rec.items()})

ps = np.load(os.path.join(work, "psum_inputs.npz"))
for pods, rows in ((2, (0, 1)), (2, (2, 3)), (4, (0, 1, 2, 3))):
    pm = Mesh(devs[:pods].reshape(pods,), ("pod",))
    def body(g, h, eg, eh):
        mean, err = comp.compressed_psum_pod({"g": g[0], "h": h[0]},
                                             {"g": eg[0], "h": eh[0]},
                                             "pod", pods)
        return (mean["g"][None], mean["h"][None], err["g"][None],
                err["h"][None])
    f = jax.jit(shard_map_compat(body, mesh=pm, in_specs=(P("pod"),) * 4,
                                 out_specs=(P("pod"),) * 4))
    idx = list(rows)
    mg, mh, eg, eh = f(*(jnp.asarray(ps[k][idx]) for k in ("g", "h", "eg",
                                                           "eh")))
    for n, row in enumerate(rows):
        np.savez(os.path.join(work, f"jax_psum_{pods}_{row}.npz"),
                 mean_g=np.asarray(mg[n]), mean_h=np.asarray(mh[n]),
                 err_g=np.asarray(eg[n]), err_h=np.asarray(eh[n]))

gen = GenealogyLog(os.path.join(work, "jax_genealogy.jsonl"))
orch = TournamentOrchestrator(fns, DataPlan.jag_cyclegan(cfg["files"]),
                              TournamentConfig(backend="mesh", **cfg["orch"]),
                              genealogy=gen)
orch.run(rounds=cfg["orch_rounds"], steps_per_round=cfg["orch_steps"])
st = orch.stats()
out = {"wins": [d["wins"] for d in st["per_trainer"]],
       "adoptions": [d["adoptions"] for d in st["per_trainer"]],
       "steps": [d["steps"] for d in st["per_trainer"]],
       "bytes": st["tournament_exchange_bytes"], "round": st["round"],
       "lr": [t.hparams["lr"] for t in orch.population.trainers]}
orch.close()
gen.close()

from repro.launch import ltfb as cli
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = cli.main(cfg["cli"] + ["--data-dir", os.path.join(work, "jax_cli")])
out["cli_rc"] = rc
out["cli_events"] = collections.Counter(
    json.loads(ln)["event"] for ln in buf.getvalue().splitlines()
    if ln.startswith("{"))
json.dump(out, open(os.path.join(work, "jax.json"), "w"))
print("JAX OK")
"""

HOST_SCRIPT = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import bridge
from repro_torch.configs.base import OptimizerConfig
from repro_torch.configs.icf_cyclegan import SMOKE
from repro_torch.core.population import TrainerFns
from repro_torch.core.tournament import (DataPlan, TournamentConfig,
                                         TournamentOrchestrator)
from repro_torch.train import steps as tsteps

work = sys.argv[1]
cfg = json.load(open(os.path.join(work, "cfg.json")))
host = TournamentConfig(device="cpu", ckpt_dir=cfg["host_ckpt"],
                        **cfg["orch"])
fns = TrainerFns(*tsteps.make_gan_steps(
    SMOKE, OptimizerConfig(name="adam", lr=1e-3), device="cpu"),
    to_ckpt=lambda p, o: (bridge.cyclegan_params_to_jax_layout(p),
                          bridge.cyclegan_opt_state_to_jax_layout(o)))
with TournamentOrchestrator(fns, DataPlan.jag_cyclegan(cfg["files"]),
                            host) as orch:
    orch.run(rounds=1, steps_per_round=1, ckpt_every=1)
    for i, t in enumerate(orch.population.trainers):
        np.savez(os.path.join(work, f"host_final_{i}.npz"),
                 **{f"{h}/{n}": v.numpy() for h in ("gen", "disc")
                    for n, v in t.params[h].items()})
    wins = [t.wins for t in orch.population.trainers]
json.dump({"wins": wins}, open(os.path.join(work, "host.json.tmp"), "w"))
os.replace(os.path.join(work, "host.json.tmp"),
           os.path.join(work, "host.json"))
"""

DRILL_SCRIPT = r"""
import datetime, os, signal, sys, time
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.core import ltfb
from repro_torch.launch import mesh
mode, timeout = sys.argv[1], float(sys.argv[2])
ranks = mesh.init_ranks("gloo", "cpu", timeout_s=60)
# the exchange's own group waits ``timeout`` (the default group's 60 s
# leave room for a slow start)
group = dist.new_group([0, 1], timeout=datetime.timedelta(seconds=timeout))
step = ltfb.make_ltfb_step(lambda p, b: p["w"].sum(), 2, group)
p = {"w": torch.ones(8) * ranks.rank}
step(p, None, 0)                            # one exchange that completes
if ranks.rank == 1:
    if mode == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(10 * timeout)                # stalled, alive
t0 = time.monotonic()
try:
    step(p, None, 1)
except RuntimeError as e:
    print(f"RAISED {time.monotonic() - t0:.3f} {str(e)[:120]}", flush=True)
    sys.exit(3)
sys.exit(0)
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    return env


class _Jobs:
    """Every subprocess job of the module, started together."""

    def __init__(self, work):
        self.work = str(work)
        self.procs = {}
        self.t0 = time.monotonic()

    def add(self, name, procs):
        self.procs[name] = procs

    def wait(self, name, first=None):
        """(exit codes, output texts) of ``name``'s processes (of its
        ``first`` ones only, when given)."""
        procs = self.procs[name][:first]
        left = JOB_TIMEOUT - (time.monotonic() - self.t0)
        try:
            outs = [p.communicate(timeout=max(left, 1)) for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        return [p.returncode for p in procs], \
            [(o or b"").decode() + (e or b"").decode()[-3000:]
             for o, e in outs]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_ltfb")
    files = tjag.write_bundles(str(work / "bundles"), 128,
                               samples_per_file=32, image_size=8, seed=0)
    cfg = {"rounds": ROUNDS, "files": files, "orch": ORCH,
           "orch_rounds": ORCH_ROUNDS, "orch_steps": ORCH_STEPS,
           "ckpt": str(work / "ck"), "cli": CLI_FLAGS,
           "host_ckpt": str(work / "host_ck")}
    (work / "cfg.json").write_text(json.dumps(cfg))
    np.savez(work / "step_inputs.npz", **_step_inputs())
    np.savez(work / "psum_inputs.npz", **_psum_inputs())
    env = _env()
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    j = _Jobs(work)
    j.add("jax", [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(work)], cwd=ROOT,
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        **pipe)])
    j.add("ranks", tmesh.start([sys.executable, "-c", RANK_SCRIPT, str(work)],
                               4, env, stdout=lambda r: subprocess.PIPE,
                               stderr=lambda r: subprocess.PIPE))
    j.add("host", [subprocess.Popen(
        [sys.executable, "-c", HOST_SCRIPT, str(work)], cwd=ROOT, env=env,
        **pipe)])
    j.add("cli", [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.ltfb", *CLI_FLAGS,
         "--device", "cpu", "--data-dir", str(work / "cli")], cwd=ROOT,
        env=env, **pipe)])
    for mode, timeout in (("kill", 60.0), ("stall", TIMEOUT_DRILL_S)):
        j.add(mode, tmesh.start(
            [sys.executable, "-c", DRILL_SCRIPT, mode, str(timeout)], 2, env,
            stdout=lambda r: subprocess.PIPE,
            stderr=lambda r: subprocess.PIPE))
    yield j
    for procs in j.procs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def ranks_out(jobs):
    rcs, texts = jobs.wait("ranks")
    assert rcs == [0] * 4, "\n".join(texts)
    return [json.load(open(os.path.join(jobs.work, f"rank_{r}.json")))
            for r in range(4)]


@pytest.fixture(scope="module")
def jax_out(jobs):
    rcs, texts = jobs.wait("jax")
    assert rcs == [0], texts[0]
    return json.load(open(os.path.join(jobs.work, "jax.json")))


# ---------------------------------------------------------------------------
# quantizer, ranks, backends (in this process)
# ---------------------------------------------------------------------------

TIES = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                np.float32)


@pytest.mark.parametrize("case", ["ties", 0, 1, 2, "tiny", "bf16"])
def test_quantize_int8_is_bit_equal_to_jax(case):
    """q and the scale bit-equal, rounding half to even at exact ties."""
    if case == "ties":
        x = TIES
    elif case == "tiny":
        x = np.array([1e-14, -3e-14, 0.0], np.float32)
    elif case == "bf16":                 # values exact in bf16
        x = np.array(jnp.asarray(np.random.default_rng(3).normal(
            size=(65,)), jnp.bfloat16).astype(jnp.float32))
    else:
        x = np.random.default_rng(case).normal(
            scale=10.0 ** case, size=(33, 7)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if case == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    # JAX's exchange and pod ladder run the quantizer compiled, where XLA
    # turns ``/ 127.0`` into a product with its f32 reciprocal
    jq, js = jax.jit(jcomp.quantize_int8)(jx)
    tq, ts = tcomp.quantize_int8(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.dtype == torch.float32
    assert np.float32(ts).tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(
        tcomp.dequantize_int8(tq, ts).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js)))
    if case == "ties":                     # 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
        assert tq.tolist() == [127, 0, 2, 2, 0, -2, 4, -126]


def test_jax_eager_quantizer_divides_where_its_compiled_one_multiplies():
    """A reference behaviour: JAX's eager ``quantize_int8`` divides by 127,
    its compiled one (the path of the exchange) multiplies by the f32
    reciprocal, and the two scales differ in the last bit for some
    inputs.  The port follows the compiled one."""
    x = jnp.asarray([4.5, -1.0], jnp.float32)
    eager = np.asarray(jcomp.quantize_int8(x)[1])
    compiled = np.asarray(jax.jit(jcomp.quantize_int8)(x)[1])
    assert eager == np.float32(4.5) / np.float32(127)
    assert compiled == np.float32(4.5) * (np.float32(1) / np.float32(127))
    assert eager != compiled
    assert float(tcomp.quantize_int8(torch.tensor([4.5, -1.0]))[1]) \
        == float(compiled)


def test_error_feedback_and_ratio_equal_jax():
    params = {"a": torch.ones(2, 3), "b": [torch.ones(4, dtype=torch.bfloat16)]}
    err = tcomp.init_error_feedback(params)
    assert err["a"].dtype == torch.float32 and err["b"][0].shape == (4,)
    assert not err["a"].any() and not err["b"][0].any()
    for td, jd in ((torch.float32, jnp.float32), (torch.bfloat16,
                                                   jnp.bfloat16)):
        assert tcomp.compression_ratio(td) == jcomp.compression_ratio(jd)


def test_rank_layouts_follow_jaxs_device_reshape():
    """Row-major grids: trainer t's model shard m is rank t * P + m; the
    production grids hold 256 and 512 ranks."""
    g = tmesh.ltfb_layout(4, 2)
    assert g.axes == ("trainer", "model") and g.shape == (4, 2)
    assert g.lines("trainer") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert g.lines("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert g.coords(5) == (2, 1) and g.line("trainer", 5) == [1, 3, 5, 7]
    p = tmesh.production_layout()
    assert p.axes == ("data", "model") and p.size == 256
    assert p.line("model", 17) == list(range(16, 32))
    assert p.line("data", 17) == list(range(1, 256, 16))
    m = tmesh.production_layout(multi_pod=True)
    assert m.axes == ("pod", "data", "model") and m.shape == (2, 16, 16)
    assert m.line("pod", 3) == [3, 259] and len(m.lines("pod")) == 256
    assert m.coords(300) == (1, 2, 12)
    h = tmesh.host_layout(8, ("data", "model"))
    assert h.shape == (8, 1) and h.lines("model") == [[r] for r in range(8)]
    assert tmesh.ltfb_layout(32, 16).size == 512
    with pytest.raises(tmesh.RankLayoutError, match="need 512 ranks"):
        tmesh.production_layout(multi_pod=True, world=256)
    # no process group here: one rank, and the builders say so
    with pytest.raises(tmesh.RankLayoutError):
        tmesh.make_production_mesh()
    with pytest.raises(tmesh.RankLayoutError):
        tmesh.make_ltfb_mesh(4, per_trainer_model=1)


@pytest.mark.parametrize("backend,device,local,cards,want", [
    (None, "cpu", 4, 0, "gloo"), (None, "cuda", 2, 2, "nccl"),
    ("gloo", "cuda", 4, 1, "gloo"), ("gloo", "cpu", 2, 0, "gloo"),
    ("nccl", "cpu", 2, 0, "needs --device cuda"),
    ("nccl", "cuda", 2, 1, "NCCL refuses two ranks"),
    (None, "cuda", 4, 1, "NCCL refuses two ranks")])
def test_backend_choice_never_swaps_nccl_for_gloo(backend, device, local,
                                                   cards, want):
    """nccl on cuda, gloo on cpu by default; gloo on a card only when
    asked; nccl on the CPU or with ranks sharing a card raises."""
    if want in ("gloo", "nccl"):
        assert tmesh.choose_backend(backend, device, local, cards) == want
        return
    with pytest.raises(tmesh.RankLayoutError, match=want):
        tmesh.choose_backend(backend, device, local, cards)


def test_init_ranks_refuses_nccl_before_any_process_group(monkeypatch):
    """Two ranks on one card under nccl, and nccl on the CPU, raise the
    port's error before ``init_process_group``."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(tmesh.RankLayoutError, match="needs --device cuda"):
        tmesh.init_ranks("nccl", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(tmesh.RankLayoutError, match="NCCL refuses"):
        tmesh.init_ranks("nccl", "cuda")
    with pytest.raises(tmesh.RankLayoutError, match="NCCL refuses"):
        tmesh.init_ranks(None, "cuda")
    assert not calls
    monkeypatch.delenv("RANK")
    with pytest.raises(tmesh.RankLayoutError, match="RANK is not set"):
        tmesh.init_ranks("gloo", "cpu")


def test_spawn_sets_torchruns_environment_and_reports_failure():
    """Each rank sees RANK / WORLD_SIZE / LOCAL_RANK / MASTER_*; the job's
    status is the first failure's, which takes the others down."""
    code = ("import os, sys, time; r = int(os.environ['RANK']); "
            "assert os.environ['WORLD_SIZE'] == '3'; "
            "assert os.environ['LOCAL_RANK'] == str(r); "
            "assert int(os.environ['MASTER_PORT']) > 0; "
            "time.sleep(30) if r == 0 else sys.exit(5 if r == 2 else 0)")
    t0 = time.monotonic()
    assert tmesh.spawn([sys.executable, "-c", code], 3, _env(),
                       timeout=JOB_TIMEOUT) == 5
    assert time.monotonic() - t0 < 20
    assert tmesh.spawn([sys.executable, "-c", "pass"], 2, _env()) == 0


# ---------------------------------------------------------------------------
# the tournament step and the pod reduction against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", range(K))
@pytest.mark.parametrize("mode", ["full", "int8"])
def test_make_ltfb_step_equals_jax(jobs, ranks_out, jax_out, mode, rank):
    """Four rounds of the butterfly over 4 ranks: every rank's params,
    m_local and m_other exactly JAX's at f32 (full and int8)."""
    got = np.load(os.path.join(jobs.work, f"step_{mode}_{rank}.npz"))
    want = np.load(os.path.join(jobs.work, f"jax_step_{mode}.npz"))
    for key in ("w", "b"):
        np.testing.assert_array_equal(got[key], want[key][:, rank])
    np.testing.assert_array_equal(got["ml"], want["ml"][:, rank])
    np.testing.assert_array_equal(got["mo"], want["mo"][:, rank])
    n_bits = K.bit_length() - 1
    assert got["partner"].tolist() == [rank ^ (1 << (r % n_bits))
                                       for r in range(ROUNDS)]
    # one int8 buffer (aligned to 16 bytes a tensor) + one f32 scale a
    # tensor; or one f32 buffer
    wire = ranks_out[rank][f"wire_{mode}"]
    assert wire == (16 + 16 + 2 * 4 if mode == "int8" else (8 + 8) * 4)


@pytest.mark.parametrize("rank", range(K))
@pytest.mark.parametrize("pods", [2, 4])
def test_compressed_psum_pod_matches_jax(jobs, ranks_out, jax_out, pods,
                                         rank):
    """The log2(P) ladder over the pod group against JAX's shard_map run.
    Two pods (one rung): mean and error within 1e-7.  Four pods (two
    rungs): within one int8 step of the last rung.  XLA contracts some of
    JAX's products and sums into fused multiply-adds, so a rung's sum can
    differ from the port's in its last bit, and the next rung can round
    that element to the neighbouring int8 value."""
    got = np.load(os.path.join(jobs.work, f"psum_{pods}_{rank}.npz"))
    want = np.load(os.path.join(jobs.work, f"jax_psum_{pods}_{rank}.npz"))
    ins = _psum_inputs()
    members = [rank // 2 * 2, rank // 2 * 2 + 1] if pods == 2 else range(K)
    for leaf in ("g", "h"):
        total = np.sum([ins[leaf][m] for m in members], axis=0)
        step = np.abs(np.sum([np.abs(ins[leaf][m]) for m in members],
                             axis=0)).max() / 127
        tol = 1e-7 if pods == 2 else step
        for key in ("mean_", "err_"):
            np.testing.assert_allclose(got[key + leaf], want[key + leaf],
                                       rtol=0, atol=tol)
        # every pod holds the mean within the quantization error
        assert np.abs(got["mean_" + leaf] - total / pods).max() <= step


def test_rank_groups_of_a_2x2_ltfb_grid(ranks_out):
    """make_ltfb_mesh(2, 2) on 4 ranks: trainer groups {0,2} and {1,3},
    model groups {0,1} and {2,3}; a 4 x 2 grid needs 8 ranks."""
    for r, out in enumerate(ranks_out):
        assert out["group_trainer"] == [r % 2, r % 2 + 2]
        assert out["group_model"] == [r // 2 * 2, r // 2 * 2 + 1]
        assert out["too_large"] == "need 8 ranks, have 4"


# ---------------------------------------------------------------------------
# the mesh orchestrator against JAX's mesh backend
# ---------------------------------------------------------------------------


def _matches(path):
    return [json.loads(ln) for ln in open(path) if '"match"' in ln]


def test_mesh_orchestrator_decisions_equal_jax(jobs, ranks_out, jax_out):
    """Same partners (the butterfly), same adoptions, wins and exchange
    bytes as JAX's mesh backend; metrics within the host backend's
    tolerance; every rank holds the same log and counters."""
    got = _matches(os.path.join(jobs.work, "genealogy_0.jsonl"))
    want = _matches(os.path.join(jobs.work, "jax_genealogy.jsonl"))
    assert len(got) == len(want) == ORCH_ROUNDS * K
    for g, w in zip(got, want):
        assert (g["round"], g["trainer"], g["partner"]) == \
            (w["round"], w["trainer"], w["partner"])
        np.testing.assert_allclose([g["m_local"], g["m_other"]],
                                   [w["m_local"], w["m_other"]],
                                   rtol=METRIC_RTOL)
        assert g["adopted"] == w["adopted"]
    orch = [out["orch"] for out in ranks_out]
    assert all(o == orch[0] for o in orch[1:])     # the same on every rank
    assert orch[0]["wins"] == jax_out["wins"]
    assert orch[0]["adoptions"] == jax_out["adoptions"]
    assert orch[0]["bytes"] == jax_out["bytes"] > 0
    assert orch[0]["steps"] == jax_out["steps"] == [ORCH_ROUNDS] * K
    assert orch[0]["round"] == jax_out["round"] == ORCH_ROUNDS
    assert sum(orch[0]["wins"]) == ORCH_ROUNDS * K
    assert any(orch[0]["adoptions"])


def test_mesh_orchestrator_logs_like_jax(ranks_out, jax_out):
    """The log: butterfly partners, JAX's ``per_model * K`` bytes (int8:
    ``// 4`` whatever the dtype), and the bytes on the wire."""
    gen_bytes = sum(np.prod(s) * 4 for s in _gen_shapes())
    for rnd, lg in enumerate(ranks_out[0]["orch"]["logs"]):
        assert lg["partner"] == [i ^ (1 << (rnd % 2)) for i in range(K)]
        assert lg["exchange_bytes"] == gen_bytes * K
        assert lg["exchanged"] + lg["kept_local"] == K
        assert lg["wire_bytes"] >= gen_bytes
        assert lg["exchange_timed"]


def _gen_shapes():
    from repro_torch.models.icf_cyclegan import init_cyclegan
    return [t.shape for t in init_cyclegan(SMOKE, 0, "cpu")["gen"].values()]


def test_mesh_orchestrator_never_perturbs_and_holds_one_trainer(ranks_out,
                                                                jax_out):
    """No hyper-parameter perturbation on adoption (JAX's mesh backend has
    none), and each rank holds its own trainer only."""
    assert jax_out["lr"] == [1e-3] * K
    for r, out in enumerate(ranks_out):
        assert out["lr"] == 1e-3
        assert out["remote"] == [i != r for i in range(K)]
        assert out["orch"]["cache_hits"] > 0


def test_mesh_tournament_evaluates_one_concatenated_batch(ranks_out):
    """The tournament set is one batch: a metric that counts its rows
    sees both tournament batches (2 x 16 rows) at once, where the host
    backend averages batch by batch (16)."""
    for out in ranks_out:
        assert [m[2:] for m in out["count_metrics"]] == [[32.0, 32.0]] * K


def test_dead_trainer_stops_the_mesh_and_recovers_from_the_best(ranks_out):
    """A dead trainer raises RuntimeError on every rank (the static
    schedule cannot self-pair); recover clones the best trainer."""
    src = ranks_out[0]["recover_src"]
    for r, out in enumerate(ranks_out):
        assert "recover() them first" in out["dead"]
        assert out["recover_src"] == src
    assert ranks_out[1]["recovered_val"] == ranks_out[src]["scores"][src]


def test_mesh_trace_holds_every_ranks_trainer_spans(jobs, ranks_out):
    """Rank 0's trace: its ``mesh_tournament`` spans and every trainer's
    step spans, the other ranks' gathered to it."""
    trace = json.load(open(os.path.join(jobs.work, "trace.json")))
    spans = collections.Counter(
        (e["name"], e["args"].get("rid")) for e in trace["traceEvents"]
        if e["ph"] == "X")
    assert spans[("mesh_tournament", None)] == ORCH_ROUNDS
    for r in range(K):
        assert spans[("step", str(r))] == ORCH_ROUNDS * ORCH_STEPS
        assert spans[("train_round", str(r))] == ORCH_ROUNDS


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_mesh_checkpoint_restores_under_the_host_backend(jobs, ranks_out):
    """Each rank wrote its member, rank 0 the manifest: the host backend
    resumes the population bit-equal, with the gathered counters."""
    ck = os.path.join(jobs.work, "ck")
    assert tckpt.latest_population_step(ck) == ORCH_ROUNDS
    files = json.load(open(os.path.join(jobs.work, "cfg.json")))["files"]
    cfg = TournamentConfig(device="cpu", ckpt_dir=ck, **ORCH)
    with TournamentOrchestrator(_port_fns(), DataPlan.jag_cyclegan(files),
                                cfg) as host:
        assert host.maybe_resume()
        assert host.population.round == ORCH_ROUNDS
        for r, t in enumerate(host.population.trainers):
            final = np.load(os.path.join(jobs.work, f"final_{r}.npz"))
            for key in final.files:
                half, name = key.split("/", 1)
                np.testing.assert_array_equal(t.params[half][name].numpy(),
                                              final[key])
            assert t.wins == ranks_out[0]["orch"]["wins"][r]
            assert t.adoptions == ranks_out[0]["orch"]["adoptions"][r]
            assert t.steps == ORCH_ROUNDS * ORCH_STEPS
        host.run(rounds=1, steps_per_round=1)      # and trains on


def test_host_checkpoint_resumes_under_the_mesh_backend(jobs, ranks_out):
    """The other way round: a host backend's population checkpoint
    resumes under the mesh backend, each rank with its member's weights
    bit-equal and every member's counters."""
    rcs, texts = jobs.wait("host")
    assert rcs == [0], texts[0]
    wins = json.load(open(os.path.join(jobs.work, "host.json")))["wins"]
    for out in ranks_out:
        hr = out["host_resume"]
        assert hr["round"] == 1 and hr["equal"]
        assert hr["wins"] == wins and hr["steps"] == [1] * K


def test_mesh_checkpoint_is_read_by_jaxs_restore_population(jobs, ranks_out):
    ck = os.path.join(jobs.work, "ck")
    fns = _port_fns()
    p, o, _ = fns.init(0)           # JAX's tree, through the bridge
    p, o = fns.to_ckpt(p, o)
    got = jckpt.restore_population(ck, ORCH_ROUNDS,
                                   {"params": p, "opt_state": o})
    assert got["round"] == ORCH_ROUNDS and got["scope"] == "generator"
    assert len(got["trainers"]) == K
    for r, tr in enumerate(got["trainers"]):
        final = np.load(os.path.join(jobs.work, f"final_{r}.npz"))
        port = bridge.cyclegan_params_from_jax(jax.tree.map(np.asarray,
                                                            tr["params"]))
        for key in final.files:
            half, name = key.split("/", 1)
            np.testing.assert_array_equal(port[half][name].numpy(),
                                          final[key])
        assert tr["wins"] == ranks_out[0]["orch"]["wins"][r]
        assert int(tr["opt_state"]["gen"]["step"]) == ORCH_ROUNDS


# ---------------------------------------------------------------------------
# the CLI and the failure drills
# ---------------------------------------------------------------------------


def test_mesh_cli_records_equal_jaxs(jobs, jax_out):
    """``--backend mesh --device cpu --smoke --trainers 4`` spawns its
    ranks and exits 0; rank 0's records carry JAX's names and counts."""
    rcs, texts = jobs.wait("cli")
    assert rcs == [0], texts[0]
    events = collections.Counter(
        json.loads(ln)["event"] for ln in texts[0].splitlines()
        if ln.startswith("{"))
    assert jax_out["cli_rc"] == 0
    assert events == jax_out["cli_events"]
    start = [json.loads(ln) for ln in texts[0].splitlines()
             if '"ltfb_start"' in ln]
    assert start[0]["backend"] == "mesh" and start[0]["trainers"] == K


def test_a_killed_rank_fails_the_run(jobs):
    """Rank 1 SIGKILLed mid-run: rank 0 raises at its next exchange on its
    own (nonzero, long before the 60 s timeout), and nothing hangs."""
    rcs, texts = jobs.wait("kill")
    assert rcs[1] == -9
    assert rcs[0] == 3, texts[0]
    took = float(texts[0].split("RAISED ")[1].split()[0])
    assert took < 30


def test_a_stalled_rank_fails_the_run_within_the_timeout(jobs):
    """Rank 1 alive but stalled: rank 0 raises once ``--dist-timeout``
    passes, instead of hanging."""
    rcs, texts = jobs.wait("stall", first=1)
    for p in jobs.procs["stall"]:
        p.kill()
    assert rcs[0] == 3, texts[0]
    took = float(texts[0].split("RAISED ")[1].split()[0])
    assert TIMEOUT_DRILL_S * 0.9 <= took < TIMEOUT_DRILL_S + 10
