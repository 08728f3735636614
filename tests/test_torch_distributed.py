"""Multi-process mesh serving of the port (``repro_torch.launch.
distributed``) on the CPU over gloo.

Every job runs in subprocesses with a timeout of its own, all started
together in one module fixture: a 1-process run and a 2-process run
(``--procs``) of the same SMOKE trace on a ``2,1`` mesh, and a 2-process
run with ``--feed replicated`` whose two workers are started by hand with
``--process-id``, ``--num-processes`` and ``--coordinator``, as JAX's are;
a kill drill (``kill@4:rank=1`` with ``--restart-on-failure 1
--journal``); and two ranks of a plan channel, one of which dies before
the first plan.  The parser is held against JAX's ``build_parser``.
"""
import json
import os
import re
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import distributed as tdist
from repro_torch.launch import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT = 240             # seconds any one job may take
DEAD_TIMEOUT_S = 3.0          # the dead-peer channel's step timeout
TRACE = ["--smoke", "--device", "cpu", "--requests", "3", "--max-new", "6",
         "--prompt-lens", "8,12", "--mesh", "2,1", "--step-timeout", "120"]

_DEAD_PEER = r"""
import os, sys, time
from repro_torch.launch import mesh
mesh.init_ranks("gloo", "cpu", timeout_s=60)
from repro_torch.serve.mesh import ProcessGroupChannel, StepPlan
ch = ProcessGroupChannel(timeout_s=float(sys.argv[1]))
if ch.rank == 1:
    os._exit(0)          # dies before the first plan
t0 = time.perf_counter()
try:
    for _ in range(50):
        ch.broadcast(StepPlan())
        ch.gather(b"{}")
except RuntimeError as e:
    assert "peer process likely died" in str(e), e
    print("FAILED-OK %.3f" % (time.perf_counter() - t0), flush=True)
    os._exit(0)
print("UNEXPECTED: no error", flush=True)
os._exit(1)
"""


def _env():
    env = dict(os.environ)
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               PYTHONUNBUFFERED="1")
    return env


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Start every job at once; returns name -> (returncode, stdout,
    out-json path)."""
    tmp = tmp_path_factory.mktemp("dist")
    cli = [sys.executable, "-m", "repro_torch.launch.distributed"]
    coordinator = f"127.0.0.1:{tmesh.find_free_port()}"
    specs = {
        "one": [["--procs", "1"]],
        "two": [["--procs", "2"]],
        "rep": [["--feed", "replicated", "--process-id", str(r),
                 "--num-processes", "2", "--coordinator", coordinator]
                for r in range(2)],
        "kill": [["--procs", "2", "--journal", str(tmp / "j.jsonl"),
                  "--fault-spec", "kill@4:rank=1",
                  "--restart-on-failure", "1"]],
    }
    procs = {}
    for name, workers in specs.items():
        out = str(tmp / f"{name}.json")
        procs[name] = ([subprocess.Popen(
            cli + TRACE + extra + ["--out-json", out], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for extra in workers], out)
    dead = tmesh.start([sys.executable, "-c", _DEAD_PEER,
                        str(DEAD_TIMEOUT_S)], 2, env=_env(),
                       stdout=lambda r: subprocess.PIPE,
                       stderr=lambda r: subprocess.STDOUT)
    res = {}
    deadline = time.monotonic() + JOB_TIMEOUT
    for name, (ps, out) in procs.items():
        texts = []
        for p in ps:
            try:
                texts.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                texts.append(p.communicate()[0] + "\n[test] job timed out")
        rc = next((p.returncode for p in ps if p.returncode), 0)
        res[name] = (rc, "\n".join(texts), out)
    texts = []
    for p in dead:
        try:
            texts.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            p.kill()
            texts.append(p.communicate()[0] + "\n[test] rank timed out")
    res["dead"] = ([p.returncode for p in dead], texts[0], None)
    res["tmp"] = tmp
    return res


def _load(path):
    with open(path) as f:
        return json.load(f)


def _ok(jobs, name):
    rc, text, out = jobs[name]
    assert rc == 0, text[-4000:]
    return text, out


def test_parser_flags_and_defaults_match_jax():
    pytest.importorskip("jax")
    from repro.launch.distributed import build_parser as jax_parser

    def table(ap):
        return {a.dest: (a.option_strings, a.default, a.choices, a.nargs)
                for a in ap._actions if a.dest != "help"}

    got, want = table(tdist.build_parser()), table(jax_parser())
    assert set(got) - set(want) == {"device", "dtype", "dist_backend"}
    assert {k: got[k] for k in want} == want
    assert got["device"][1] == "cuda" and got["dist_backend"][1] is None
    assert got["dtype"][1] is None
    args = tdist.build_parser().parse_args(
        ["--procs", "2", "--step-timeout", "5"])
    assert args.procs == 2 and args.step_timeout == 5.0


def test_model_axis_is_refused_before_any_rank_starts():
    """A model axis that ``--procs`` cannot hold (a multiple of MODEL
    ranks) is refused by the spawner, naming the CLI's form."""
    for procs, mesh in (("3", "2,2"), ("2", "1,4")):
        with pytest.raises(tmesh.RankLayoutError,
                           match="repro_torch.launch.distributed"):
            tdist.main(["--procs", procs, "--mesh", mesh])


def test_two_processes_serve_the_one_process_streams(jobs):
    text, two = _ok(jobs, "two")
    _, one = _ok(jobs, "one")
    a, b, follower = _load(one), _load(two), _load(two + ".p1")
    assert "channel=ProcessGroupChannel" in text
    assert "channel=LoopbackChannel" in jobs["one"][1]
    assert a["results"] == b["results"] == follower["results"]
    assert len(a["results"]) == 3
    assert all(len(t) == 6 for t in a["results"].values())
    # both ranks took the same trajectory
    for k in ("decode_steps", "prefills", "decode_tokens"):
        assert b["stats"][k] == follower["stats"][k], k
    assert b["stats"]["plan_retries"] == 0
    # rank 0's export covers every rank, each counter the rank's own
    ms = b["mesh_stats"]
    assert sorted(ms) == ["0", "1"]
    for rank, own in (("0", b), ("1", follower)):
        for k in ("completed", "decode_steps", "prefills", "decode_tokens"):
            assert ms[rank][k] == own["stats"][k], (rank, k)
        # the 2,1 mesh: two data shards' pools a rank
        assert len(ms[rank]["shards"]) == 2
        assert sum(s["high_water_blocks"] for s in ms[rank]["shards"]) > 0
    with open(two + ".prom") as f:
        prom = f.read()
    assert prom.startswith("# HELP repro_serve_")
    assert f'repro_serve_mesh_completed_total{{rank="1"}} ' \
           f'{follower["stats"]["completed"]}' in prom
    assert 'repro_serve_mesh_pool_high_water_blocks{rank="1",shard="1"}' \
        in prom


def test_replicated_feed_dedupes(jobs):
    _, rep = _ok(jobs, "rep")
    _, one = _ok(jobs, "one")
    host0, follower = _load(rep), _load(rep + ".p1")
    assert host0["results"] == follower["results"] == _load(one)["results"]
    assert follower["stats"]["completed"] == 3
    assert follower["stats"]["submitted"] == 3


def test_a_dead_peer_makes_rank0_raise_within_the_step_timeout(jobs):
    rcs, text, _ = jobs["dead"]
    assert rcs == [0, 0], text[-4000:]
    assert b"FAILED-OK" in text
    took = float(text.split(b"FAILED-OK")[1].split()[0])
    assert took < DEAD_TIMEOUT_S + 5.0


def test_kill_drill_resumes_token_identically(jobs):
    text, kill = _ok(jobs, "kill")
    _, one = _ok(jobs, "one")
    assert "[faults] SIGKILL self at step 4 (rank 1)" in text
    # rank 0 fails on its own (rc 1) as soon as gloo sees the closed
    # connection, or the supervisor sees rank 1's SIGKILL (rc -9) first
    assert re.search(r"\[dist\] worker failure \(rc=(1|-9)\); restarting "
                     r"the job \(attempt 1/1\), resuming from the "
                     r"generation-0 journal", text)
    assert "[dist] rank=0 journal: replayed 3 request(s)" in text
    assert os.path.exists(str(jobs["tmp"] / "j.jsonl.r1"))
    assert _load(kill)["results"] == _load(one)["results"]
