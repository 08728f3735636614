"""Tensor-parallel serving of the port over the ``model`` axis, on the CPU
over gloo (and, ``cuda``-marked, the paged kernel at a model rank's
shape).

One module fixture starts every job at once, each with its own timeout,
as ``tests/test_torch_distributed.py`` does:

* three jobs of a rank script that drives ``MeshScheduler`` on qwen3
  SMOKE in f32 over a trace that mixes greedy and T = 0.8 requests: two
  ranks at ``--mesh 1,2`` (the full model handed in, the scheduler cuts
  it; then, on the same ranks, what the axis refuses and the batch
  engine's dense rows), two at ``2,2`` (each rank's shard carried
  straight from a JAX-layout tree by ``bridge.shard_from_jax``), and
  four ranks at ``1,2``, two replicas of two model ranks;
* two jobs of ``repro_torch.launch.distributed``: ``--procs 2 --mesh 1,2``
  greedy and ``--procs 4 --mesh 2,2`` at T = 0.8;
* a dead and a stalled model peer: rank 1 exits, or sleeps past the
  timeout, inside a model-group all-reduce, and rank 0 must raise within
  the timeout.

Every stream is held to JAX's single-device ``Scheduler`` on the same
weights (the port's seeded weights carried to JAX's layout) and trace:
the reference holds its own (4, 2) mesh to those streams
(``tests/test_mesh_serve.py``).  JAX is imported inside the tests, so the
``cuda`` test also runs where JAX is not installed.
"""
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import distributed as tdist
from repro_torch.launch import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT = 240             # seconds any one job may take
STEP_TIMEOUT_S = 3.0          # the drills' plan and model-group timeout
GEOMETRY = dict(num_slots=4, max_len=32, block_size=4)
CLI = ["--smoke", "--device", "cpu", "--dtype", "float32", "--requests",
       "4", "--max-new", "6", "--prompt-lens", "8,12", "--step-timeout",
       "120"]

_RANK = r"""
import json, os, sys, time
from repro_torch.launch import mesh as ml
out, data, model, load, fault, timeout = sys.argv[1:7]
data, model, timeout = int(data), int(model), float(timeout)
ranks = ml.init_ranks("gloo", "cpu", timeout_s=timeout)
import numpy as np
from repro_torch import bridge
from repro_torch.configs.base import replace
from repro_torch.configs.registry import get_config
from repro_torch.models.lm import init_lm
from repro_torch.parallel.tensor import tensor_parallel
from repro_torch.serve.mesh import MeshScheduler
from repro_torch.serve.scheduler import Request
cfg = replace(get_config("qwen3-0.6b", smoke=True), dtype="float32")
weights = init_lm(cfg, seed=0, device="cpu")
if load == "bridge":
    grid = ml.make_serve_mesh(model, timeout_s=timeout)
    weights = bridge.shard_from_jax(
        bridge.params_to_jax_layout(weights, cfg), cfg, {"model": model},
        grid.coords(ranks.rank)[1], grid.groups["model"], device="cpu")
sched = MeshScheduler(cfg, weights, mesh_shape=(data, model),
                      step_timeout_s=timeout, device="cpu", num_slots=4,
                      max_len=32, block_size=4)
tp = tensor_parallel(sched.session.model)
if fault != "none" and ranks.rank == 1:
    plain, calls = tp.all_reduce, [0]
    def hooked(x):
        calls[0] += 1
        if calls[0] == 20:
            if fault == "stall":
                time.sleep(3 * timeout)
            os._exit(0)
        return plain(x)
    tp.all_reduce = hooked
with open(os.environ["TRACE"]) as f:
    trace = json.load(f)
record = {"rank": ranks.rank, "model_rank": tp.rank,
          "heads": [sched.session.model.cfg.num_heads,
                    sched.session.model.cfg.num_kv_heads],
          "pool_kv_heads": int(sched.pool.cache[0]["k"].shape[2])}
try:
    if ranks.rank == 0:
        for r in trace:
            sched.submit(Request(rid=r["rid"], prompt=np.asarray(
                r["prompt"], np.int32), max_new=r["max_new"],
                temperature=r["temperature"], seed=r["seed"]))
        while sched.queue or sched.active or sched.prefilling:
            t0 = time.perf_counter()
            sched.step()
        sched.shutdown()
        results = sched.results
    else:
        results = sched.run_follower()
except RuntimeError as e:
    if fault == "none":
        raise
    print("FAILED-OK %.3f %s" % (time.perf_counter() - t0, str(e)[:300]),
          flush=True)
    os._exit(0)
if fault != "none":
    print("UNEXPECTED: no error", flush=True)
    os._exit(1)
record.update(results={str(k): [int(t) for t in v]
                       for k, v in results.items()},
              stats=sched.stats.as_dict(), timing=tp.timing,
              decode=sched.session.decode_collectives)
if os.environ.get("REFUSE"):
    # what the model axis refuses, each naming its queue (every rank
    # makes the plan channel and the model group on the way, in order)
    def refused(arch, draft):
        c = get_config(arch, smoke=True)
        m = init_lm(c, device="cpu")
        try:
            MeshScheduler(c, m, mesh_shape=(data, model), device="cpu",
                          draft_params=m if draft else None,
                          spec_tokens=2 if draft else 0)
        except NotImplementedError as e:
            return str(e)
        return "served"
    record["refused"] = [refused(a, d) for a, d in (
        ("qwen3-0.6b", True), ("deepseek-moe-16b", False),
        ("xlstm-125m", False), ("jamba-1.5-large-398b", False))]
    # the batch engine's dense rows over the same cut
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.mesh import ServeMesh
    eng = Engine(cfg, init_lm(cfg, seed=0, device="cpu"), max_len=16,
                 mesh=ServeMesh(data, model))
    toks = np.arange(10, dtype=np.int64).reshape(2, 5) * 7
    record["engine"] = eng.generate(toks, 4).tolist()
    record["engine_rows"] = list(eng._sessions[2].layout.cache[0]["k"].shape)
with open(out + (".p%d" % ranks.rank if ranks.rank else ""), "w") as f:
    json.dump(record, f)
"""

def _trace():
    """Six requests, prompts 5-14 tokens (two share their first pages);
    even rids greedy, odd ones at T = 0.8."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, 14)
    prompts = [base[:9], np.concatenate([base[:8], rng.integers(0, 256, 4)]),
               rng.integers(0, 256, 14), rng.integers(0, 256, 5),
               base[:12], rng.integers(0, 256, 7)]
    return [dict(rid=i, prompt=[int(t) for t in p], max_new=6,
                 temperature=0.8 if i % 2 else 0.0,
                 seed=70 + i if i % 2 else None)
            for i, p in enumerate(prompts)]


def _env(**extra):
    env = dict(os.environ)
    env.update(PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               PYTHONUNBUFFERED="1", **extra)
    return env


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Start every job at once; returns name -> (returncode, output,
    out-json path)."""
    tmp = tmp_path_factory.mktemp("tp")
    trace = tmp / "trace.json"
    trace.write_text(json.dumps(_trace()))
    env = _env(TRACE=str(trace))
    scripts = {"tp12": (2, 1, 2, "full", "none", 120),
               "tp22": (2, 2, 2, "bridge", "none", 120),
               "tp4": (4, 1, 2, "full", "none", 120),
               "dead": (2, 1, 2, "full", "dead", STEP_TIMEOUT_S),
               "stall": (2, 1, 2, "full", "stall", STEP_TIMEOUT_S)}
    procs = {}
    for name, (n, data, model, load, fault, timeout) in scripts.items():
        out = str(tmp / f"{name}.json")
        procs[name] = (tmesh.start(
            [sys.executable, "-c", _RANK, out, str(data), str(model), load,
             fault, str(timeout)], n,
            env=dict(env, REFUSE="1") if name == "tp12" else env,
            stdout=lambda r: subprocess.PIPE,
            stderr=lambda r: subprocess.STDOUT), out)
    cli = [sys.executable, "-m", "repro_torch.launch.distributed"] + CLI
    for name, extra in (("cli12", ["--procs", "2", "--mesh", "1,2"]),
                        ("cli4", ["--procs", "4", "--mesh", "2,2",
                                  "--temperature", "0.8"])):
        out = str(tmp / f"{name}.json")
        procs[name] = ([subprocess.Popen(
            cli + extra + ["--out-json", out], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)],
            out)
    res = {}
    deadline = time.monotonic() + JOB_TIMEOUT
    for name, (ps, out) in procs.items():
        texts = []
        for p in ps:
            try:
                text = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0]
            except subprocess.TimeoutExpired:
                p.kill()
                text = p.communicate()[0] + "\n[test] job timed out"
            texts.append(text if isinstance(text, str)
                         else text.decode(errors="replace"))
        rc = next((p.returncode for p in ps if p.returncode), 0)
        res[name] = (rc, "\n".join(texts), out)
    return res


def _load(path):
    with open(path) as f:
        return json.load(f)


def _ok(jobs, name):
    rc, text, out = jobs[name]
    assert rc == 0, text[-4000:]
    return out


def _jax_streams(requests, **kw):
    """JAX's single-device Scheduler on the port's seeded SMOKE weights
    (f32, carried to JAX's layout) over ``requests``."""
    jax = pytest.importorskip("jax")
    import dataclasses

    import jax.numpy as jnp
    from repro.configs.registry import get_config as jax_get_config
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.bridge import params_to_jax_layout
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import init_lm

    tcfg = replace(get_config("qwen3-0.6b", smoke=True), dtype="float32")
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", smoke=True),
                               dtype="float32")
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          params_to_jax_layout(init_lm(tcfg, seed=0,
                                                       device="cpu"), tcfg))
    js = JScheduler(jcfg, params, telemetry=False, **kw)
    for r in requests:
        js.submit(JRequest(**r))
    return {str(k): [int(t) for t in v] for k, v in js.run().items()}


@pytest.fixture(scope="module")
def jax_mixed():
    return _jax_streams([dict(r, prompt=np.asarray(r["prompt"], np.int32))
                         for r in _trace()], **GEOMETRY)


@pytest.mark.parametrize("name,ranks", [("tp12", 2), ("tp22", 2),
                                        ("tp4", 4)])
def test_model_ranks_serve_jax_single_device_streams(jobs, jax_mixed, name,
                                                     ranks):
    """Greedy and T = 0.8 streams of every rank of every replica equal
    JAX's single-device scheduler's; each rank holds its cut (2 of 4 q
    heads, 1 of 2 kv heads, in its weights and its pools) and ran the
    model group's collectives: per decode step two all-reduces a layer,
    the lookup's and the logits' gather."""
    out = _ok(jobs, name)
    recs = [_load(out if r == 0 else f"{out}.p{r}") for r in range(ranks)]
    assert sorted(jax_mixed) == [str(i) for i in range(6)]
    for rec in recs:
        assert rec["results"] == jax_mixed, rec["rank"]
        assert rec["heads"] == [2, 1] and rec["pool_kv_heads"] == 1
        st = rec["stats"]
        assert rec["decode"]["calls"] == (2 * 2 + 2) * st["decode_steps"]
        assert rec["timing"]["calls"] > rec["decode"]["calls"]
        assert rec["decode"]["bytes"] > 0
    assert [r["model_rank"] for r in recs] == [r % 2 for r in range(ranks)]
    for k in ("decode_steps", "prefills", "decode_tokens"):
        assert len({r["stats"][k] for r in recs}) == 1, k


def test_the_distributed_cli_serves_jax_streams_over_the_model_axis(jobs):
    """``--procs 2 --mesh 1,2`` greedy and ``--procs 4 --mesh 2,2`` (two
    replicas of two model ranks) at T = 0.8: every rank's streams equal
    JAX's single-device scheduler's on the CLI's weights and trace."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_requests

    cfg = get_config("qwen3-0.6b", smoke=True)
    outs = {}
    for name, temperature, n in (("cli12", 0.0, 2), ("cli4", 0.8, 4)):
        out = _ok(jobs, name)
        text = jobs[name][1]
        assert "channel=ProcessGroupChannel" in text
        assert len(re.findall(r"model_rank=\d/2 heads=2/1 "
                              r"cut=heads,mlp,vocab", text)) == n
        reqs = build_requests(cfg, 4, [8, 12], 6, temperature=temperature)
        want = _jax_streams(
            [dict(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                  temperature=r.temperature, seed=r.seed) for r in reqs],
            num_slots=4, max_len=18)
        recs = [_load(out if r == 0 else f"{out}.p{r}") for r in range(n)]
        for rec in recs:
            assert rec["results"] == want, (name, rec["rank"])
            mg = rec["model_group"]
            assert mg["decode"]["calls"] == \
                (2 * 2 + 2) * rec["stats"]["decode_steps"]
            assert mg["all"]["seconds"] >= mg["decode"]["seconds"] > 0
        outs[name] = recs
    # rank 0 of cli4 gathered all four ranks' series
    assert sorted(outs["cli4"][0]["mesh_stats"]) == ["0", "1", "2", "3"]


def test_the_engine_serves_dense_rows_over_the_cut(jobs):
    """``Engine(mesh=ServeMesh(1, 2))`` on each of the two ranks: rows of
    the rank's one kv head, and the single-device engine's greedy
    tokens."""
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.engine import Engine

    cfg = replace(get_config("qwen3-0.6b", smoke=True), dtype="float32")
    toks = np.arange(10, dtype=np.int64).reshape(2, 5) * 7
    want = Engine(cfg, init_lm(cfg, seed=0, device="cpu"),
                  max_len=16).generate(toks, 4).tolist()
    out = _ok(jobs, "tp12")
    for rec in (_load(out), _load(out + ".p1")):
        assert rec["engine"] == want
        assert rec["engine_rows"] == [2, 16, 1, 16]


@pytest.mark.parametrize("name", ["dead", "stall"])
def test_a_lost_model_peer_fails_the_survivor_within_the_timeout(jobs, name):
    """Rank 1 exits (dead) or sleeps (stall) inside a model-group
    all-reduce: rank 0's next collective raises within the step timeout,
    and nothing hangs."""
    rc, text, _ = jobs[name]
    assert rc == 0, text[-4000:]
    m = re.search(r"FAILED-OK ([0-9.]+) (.*)", text)
    assert m, text[-4000:]
    assert float(m.group(1)) < STEP_TIMEOUT_S + 2.0, m.group(0)
    assert "peer process likely died" in m.group(2)


def test_ranks_refuse_spec_moe_and_recurrent_stacks_naming_their_queues(
        jobs):
    """On a real (1, 2) mesh of two ranks: the speculative round (A18),
    a MoE FFN (A19) and recurrent or hybrid mixers (A20) raise, each
    naming its ROADMAP.md queue; nothing falls back to ``model = 1``."""
    out = _ok(jobs, "tp12")
    for rec in (_load(out), _load(out + ".p1")):
        assert len(rec["refused"]) == 4
        for msg, queue in zip(rec["refused"], ("A18", "A19", "A20", "A20")):
            assert f"ROADMAP.md queue {queue}" in msg, (queue, msg)


# ---------------------------------------------------------------------------
# one process: refusals, and the state check
# ---------------------------------------------------------------------------


def test_the_model_axis_refuses_one_process_naming_the_distributed_cli():
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.mesh import MeshScheduler, ServeMesh

    cfg = get_config("qwen3-0.6b", smoke=True)
    for make in (lambda: ServeMesh(1, 2),
                 lambda: MeshScheduler(cfg, init_lm(cfg, device="cpu"),
                                       mesh_shape=(2, 2), device="cpu")):
        with pytest.raises(tmesh.RankLayoutError,
                           match="repro_torch.launch.distributed"):
            make()
    with pytest.raises(tmesh.RankLayoutError, match="multiple of 2"):
        tdist.main(["--procs", "3", "--mesh", "1,2"])
    with pytest.raises(tmesh.RankLayoutError):
        tmesh.serve_layout(2, world=3)
    grid = tmesh.serve_layout(2, world=6)
    assert grid.shape == (3, 2) and grid.line("model", 3) == [2, 3]


def test_the_serve_cli_refuses_the_model_axis_alone():
    from repro_torch.launch import serve as tserve

    with pytest.raises(tmesh.RankLayoutError,
                       match="repro_torch.launch.distributed"):
        tserve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                     "--requests", "2", "--mesh", "1,2"])


def test_the_pools_follow_the_scheduler_config_at_model_1():
    """At ``model = 1`` the pools take the scheduler's config, not the
    model's: a bf16 model cast to f32 and served under an f32 config gets
    f32 pools (the kernel refuses pools of another dtype than q's)."""
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.mesh import MeshScheduler

    cfg = get_config("qwen3-0.6b", smoke=True)
    model = init_lm(cfg, device="cpu").float()
    sched = MeshScheduler(replace(cfg, dtype="float32"), model,
                          mesh_shape=(2, 1), device="cpu", **GEOMETRY)
    assert sched.pool.cache[0]["k"].dtype == torch.float32
    assert sched.pool.cache[0]["k"].shape[2] == cfg.num_kv_heads


def test_a_diverged_rank_raises_at_the_stats_exchange():
    """Rank 0 compares every rank's digest of the tokens it accepted: a
    follower that sampled another token fails the step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.mesh import LoopbackChannel, MeshScheduler
    from repro_torch.serve.scheduler import Request

    class TwoRanks(LoopbackChannel):
        def gather(self, payload):
            other = json.loads(payload.decode())
            other.update(rank=1, state_digest=other["state_digest"] ^ 1)
            return [bytes(payload), json.dumps(other).encode()]

    cfg = get_config("qwen3-0.6b", smoke=True)
    sched = MeshScheduler(cfg, init_lm(cfg, device="cpu"),
                          channel=TwoRanks(), device="cpu", **GEOMETRY)
    sched.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                         max_new=3))
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[1\] accepted "
                                           "other tokens"):
        sched.run()


# ---------------------------------------------------------------------------
# the card: the paged kernel at a model rank's shape
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_paged_kernel_at_a_model_rank_shape_matches_its_plain_version():
    """qwen3-0.6b at model 2 gives each rank 8 q heads over 4 kv heads:
    bf16 B = 8, D = 128, 16-token pages, K = 1, rows of 170-569 tokens
    (the last idle), held to the plain version within bf16's tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(30)
    B, H, Hkv, D, bs = 8, 8, 4, 128, 16
    lengths = torch.randint(170, 570, (B,), generator=gen, device="cuda")
    lengths[-1] = 1
    W = -(-int(lengths.max()) // bs)
    P = B * W
    q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16()
    kp = torch.randn((P + 1, bs, Hkv, D), generator=gen,
                     device="cuda").bfloat16()
    vp = torch.randn(kp.shape, generator=gen, device="cuda").bfloat16()
    tables = torch.randperm(P, generator=gen, device="cuda").reshape(
        B, W).int()
    for b in range(B):
        used = -(-int(lengths[b]) // bs)
        tables[b, used:] = P
    tables[-1] = P
    lengths = lengths.int()
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, kp, vp, tables, lengths)
    want = ref.paged_attention_ref(q, kp, vp, tables, lengths)
    assert pa.paged_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
