"""Mesh serving of the port against the JAX package's (CPU, one process).

The JAX mesh needs as many devices as shards, so every JAX comparison
here runs in-process on what needs none: ``parse_mesh``, the step plan's
wire bytes, the sharded ``PagedLayout`` (built with no placer), the
paged-attention oracle over the global tables, the single-device
``Scheduler`` the mesh must agree with, the engine and the Prometheus
text.  The port's ``MeshScheduler`` runs at ``data`` 2 and 4 on the SMOKE
configs in f32 (weights crossed from JAX through ``repro_torch.bridge``).
Token streams must be identical; logits within 1e-5.
"""
import dataclasses
import functools
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.registry import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.serve import kv_cache as jkv
from repro.serve import mesh as jmesh
from repro.serve import metrics as jmetrics
from repro.serve import telemetry as jtel
from repro_torch.bridge import load_jax_params
from repro_torch.configs.base import replace
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.models import lm as tlm
from repro_torch.serve import journal as tjournal
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve import mesh as tmesh
from repro_torch.serve import metrics as tmetrics
from repro_torch.serve import telemetry as ttel
from repro_torch.serve.arena import Arena, ArenaConfig
from repro_torch.serve.engine import Engine
from repro_torch.serve.faults import FaultInjector, InjectedFault
from repro_torch.serve.scheduler import Request, Scheduler

KW = dict(num_slots=4, max_len=32, block_size=4)
STEP_COUNTERS = ("completed", "prefills", "prefill_chunks", "prefill_tokens",
                 "padded_prefill_tokens", "decode_steps", "decode_tokens",
                 "decode_slot_steps", "spec_rounds", "spec_draft_steps",
                 "spec_draft_proposed", "spec_draft_accepted",
                 "spec_replays", "cancelled", "shed_deadline", "hot_swaps",
                 "arena_promotions")
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _serving_runs_without_gradients():
    with torch.no_grad():
        yield


def _cfgs(arch):
    """(JAX config, port config), SMOKE at f32; jamba without experts, as
    the recurrent and dense tests serve it."""
    j = dataclasses.replace(jax_get_config(arch, smoke=True),
                            dtype="float32")
    t = replace(get_config(arch, smoke=True), dtype="float32")
    if arch.startswith("jamba"):
        j, t = dataclasses.replace(j, moe=None), replace(t, moe=None)
    return j, t


@functools.lru_cache(maxsize=None)
def _weights(arch, key=0):
    """JAX weights of ``arch`` (PRNGKey ``key``) and a port model holding
    them."""
    jcfg, tcfg = _cfgs(arch)
    params = jax.jit(lambda k: jlm.init_lm(jcfg, k)[0])(
        jax.random.PRNGKey(key))
    model = tlm.init_lm(tcfg, seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, model


def _trace(vocab, temperature=0.0, n=6):
    """``n`` requests, prompts 5-14 tokens; 1 and 4 repeat the first
    pages of 0 (prefix sharing at block size 4)."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, vocab, 14).astype(np.int32)

    def fresh(k):
        return rng.integers(0, vocab, k).astype(np.int32)

    prompts = [base[:9], np.concatenate([base[:8], fresh(4)]), fresh(14),
               fresh(5), np.concatenate([base[:12], fresh(2)]), fresh(7),
               fresh(10), fresh(6)][:n]
    return tuple(dict(rid=i, prompt=p, max_new=6, temperature=temperature,
                      seed=None if temperature <= 0 else 70 + i)
                 for i, p in enumerate(prompts))


def _tokens(results):
    return {rid: [int(t) for t in v] for rid, v in results.items()}


def _counters(sched):
    d = sched.stats.as_dict()
    return {k: d[k] for k in STEP_COUNTERS}


# ---------------------------------------------------------------------------
# the mesh's geometry and the step plan's wire format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["4", "2,1", "data=2,model=1", "model=2",
                                  " 4 , 2 ", "data=3"])
def test_parse_mesh_equals_jax(spec):
    assert tmesh.parse_mesh(spec) == jmesh.parse_mesh(spec)


@pytest.mark.parametrize("spec", ["", "1,2,3", "x", "data=y"])
def test_parse_mesh_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        jmesh.parse_mesh(spec)
    with pytest.raises(ValueError):
        tmesh.parse_mesh(spec)


def test_model_axis_raises_naming_its_queue():
    """``model > 1`` is parsed, not ignored: in one process it is refused
    naming the distributed CLI (the axis spans process ranks), and the
    stacks it cannot cut yet name their queues (MoE A19, recurrent and
    hybrid A20; the speculative round's A18 needs ranks and is held in
    ``tests/test_torch_mesh_tp.py``)."""
    from repro_torch.launch.mesh import RankLayoutError
    from repro_torch.parallel.tensor import plan_shards

    assert tmesh.parse_mesh("2,2") == (2, 2)
    for make in (lambda: tmesh.ServeMesh(2, 2),
                 lambda: tmesh.MeshScheduler(
                     _cfgs("qwen3-0.6b")[1], _weights("qwen3-0.6b")[2],
                     mesh_shape=(1, 2), device="cpu", **KW)):
        with pytest.raises(RankLayoutError, match=r"spans process ranks.*"
                           r"repro_torch\.launch\.distributed"):
            make()
    for arch, queue in (("deepseek-moe-16b", "A19"), ("xlstm-125m", "A20"),
                        ("jamba-1.5-large-398b", "A20")):
        with pytest.raises(NotImplementedError, match=queue):
            plan_shards(get_config(arch, smoke=True), {"model": 2})
    with pytest.raises(ValueError):
        tmesh.ServeMesh(0, 1)
    assert (tmesh.ServeMesh(4).data, tmesh.ServeMesh(4).model) == (4, 1)


def _plans(mod, req_cls):
    reqs = [req_cls(rid=3, prompt=np.array([5, 6, 7], np.int32), max_new=4,
                    eos_id=2, temperature=0.8, seed=11,
                    ttft_deadline_ms=250.0, tpot_deadline_ms=12.5,
                    ntok_base=2),
            req_cls(rid="r-1", prompt=np.array([1], np.int32), max_new=1)]
    enc = [mod.encode_request(r) for r in reqs]
    return [mod.StepPlan(),
            mod.StepPlan(winner=4, admits=[3, "r-1"], submits=enc,
                         cancels=[[3, "cancel"], ["r-1", "deadline"]]),
            mod.StepPlan(admits=[0], promote="trainer_1"),
            mod.StepPlan(stop=True)]


def test_step_plan_wire_bytes_equal_jax():
    from repro.serve.scheduler import Request as JRequest

    tplans, jplans = _plans(tmesh, Request), _plans(jmesh, JRequest)
    for tp, jp in zip(tplans, jplans):
        assert tp.encode() == jp.encode()
        # each package decodes the other's bytes
        assert tmesh.StepPlan.decode(jp.encode()) == tp
        assert jmesh.StepPlan.decode(tp.encode()) == jp
    sub = tplans[1].submits[0]
    assert json.dumps(sub) == json.dumps(jplans[1].submits[0])
    r = tmesh.decode_request(sub)
    assert isinstance(r, Request) and r.prompt.dtype == np.int32
    assert (r.rid, r.prompt.tolist(), r.max_new, r.eos_id, r.temperature,
            r.seed, r.ttft_deadline_ms, r.tpot_deadline_ms, r.ntok_base) \
        == (3, [5, 6, 7], 4, 2, 0.8, 11, 250.0, 12.5, 2)
    # plans from a writer without the later fields decode, as in JAX
    old = b'{"winner": null, "admits": [1]}'
    assert tmesh.StepPlan.decode(old) == tmesh.StepPlan(admits=[1])


def test_loopback_channel_round_trips_and_refuses_a_follower():
    ch = tmesh.LoopbackChannel()
    plan = tmesh.StepPlan(admits=[1, 2], promote="x")
    got = ch.broadcast(plan)
    assert got == plan and got is not plan
    assert ch.gather(b"abc") == [b"abc"] and ch.rank == 0
    with pytest.raises(RuntimeError, match="no peer"):
        ch.broadcast(None)
    assert isinstance(tmesh.make_plan_channel(), tmesh.LoopbackChannel)


# ---------------------------------------------------------------------------
# the sharded PagedLayout against JAX's
# ---------------------------------------------------------------------------


def _layout_script(vocab):
    """One sequence of admits (each with its prefix probe), page growth,
    prefix registration and releases that fills the shards, hits shared
    prefixes (one in a shard whose slots are full) and, pinned, reclaims."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, vocab, 16).astype(np.int32)
    fresh = [rng.integers(0, vocab, n).astype(np.int32)
             for n in (7, 11, 6, 9, 13, 5)]
    p = {0: base[:9], 1: np.concatenate([base[:8], fresh[0][:3]]),
         2: fresh[1], 3: fresh[2], 4: np.concatenate([base[:12], fresh[3]]),
         5: fresh[4], 6: np.concatenate([base[:8], fresh[5]]), 7: fresh[3]}
    ops_ = []
    for rid in (0, 2):
        ops_ += [("admit", rid, p[rid], len(p[rid]) + 4),
                 ("ensure", rid, len(p[rid])), ("register", rid, p[rid])]
    ops_ += [("admit", 1, p[1], len(p[1]) + 5), ("ensure", 1, len(p[1])),
             ("release", 0), ("admit", 3, p[3], len(p[3]) + 8),
             ("ensure", 3, len(p[3]) + 8), ("admit", 4, p[4], 20),
             ("ensure", 4, 16), ("register", 4, p[4]), ("release", 2),
             ("admit", 5, p[5], 24), ("admit", 6, p[6], 12),
             ("release", 1), ("release", 3), ("admit", 7, p[7], 20),
             ("admit", 6, p[6], 12), ("ensure", 6, 12),
             ("register", 6, p[6]), ("release", 4), ("release", 6),
             ("admit", 0, p[0], 30), ("ensure", 0, 30), ("release", 0)]
    return ops_


def _drive_layout(L, script):
    """Run ``script`` on layout ``L``; every op's observable result and
    the layout's state after it."""
    log, live = [], set()
    for op, rid, *args in script:
        if op == "admit":
            if rid in live:
                continue
            shared = L.find_shared_prefix(args[0])
            ok = bool(L.can_admit(args[1], shared_pages=shared[0]))
            peek = L.peek_shard(args[1], shared[0])
            got = None
            if ok:
                slot, n = L.admit(rid, args[1], prompt=args[0],
                                  shared=shared)
                got = (slot, n, L.shard_of_slot(slot), L.null_page_of(slot))
                live.add(rid)
            log.append((op, rid, [int(x) for x in shared[0]], shared[1],
                        ok, peek, got))
        elif rid not in live:
            continue
        elif op == "ensure":
            L.ensure(rid, args[0])
        elif op == "register":
            L.register_prefix(rid, args[0])
        else:
            log.append((op, rid, L.release(rid)))
            live.discard(rid)
        log.append((L.tables.tolist(), dict(L._shard_of_rid), L.as_dict(),
                    L.free_slots, [s.blocks.as_dict() for s in L.shards]))
    return log


@pytest.mark.parametrize("pin", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_paged_layout_equals_jax(shards, pin):
    jcfg, tcfg = _cfgs("qwen3-0.6b")
    kw = dict(block_size=4, pin_prefix=pin, data_shards=shards)
    J = jkv.PagedLayout(jcfg, 4, 16, **kw)
    T = tkv.PagedLayout(tcfg, 4, 16, device="cpu", **kw)
    script = _layout_script(jcfg.vocab_size)
    got, want = _drive_layout(T, script), _drive_layout(J, script)
    assert got == want
    assert [s.offset for s in T.shards] == [s.offset for s in J.shards]
    assert [T.null_page_of(s) for s in range(4)] == \
        [J.null_page_of(s) for s in range(4)]
    # one pool tensor a layer in global id order: shard i's sub-pool is a
    # contiguous view of (pps + 1) pages
    pps = 16 // shards
    assert T.cache[0]["k"].shape[0] == shards * (pps + 1)
    assert T.shard_dicts() == [s.blocks.as_dict() for s in J.shards]
    admits = [e for e in got if e[0] == "admit"]
    if shards < 4:
        # a shared prefix mapped in (at 4 shards of one slot the donor's
        # shard is full whenever a sharer arrives)
        assert any(e[3] and e[6] for e in admits)
    if pin and shards == 4:
        assert T.as_dict()["block_reclaims"] > 0
    with pytest.raises(ValueError, match="divisible"):
        tkv.PagedLayout(tcfg, 6, 16, data_shards=4, device="cpu")


def test_single_shard_layout_keeps_its_surface():
    """``data_shards=1`` is the single-device layout: one shard at offset
    0, the null page ``num_pages``, the shard's own accountant."""
    _, tcfg = _cfgs("qwen3-0.6b")
    L = tkv.PagedLayout(tcfg, 2, 8, block_size=4, device="cpu")
    assert L.null_page == 8 == L.null_page_of(1)
    assert L.blocks is L.shards[0].blocks and L.shards[0].offset == 0
    assert (L.tables == 8).all() and L.as_dict()["data_shards"] == 1


# ---------------------------------------------------------------------------
# the sharded paged dispatch against JAX's oracle over the global tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_paged_dispatch_matches_jax_oracle(shards, K):
    """JAX's ``test_sharded_paged_gather_matches_oracle`` case (GQA, two
    real pages and the null page a row), with an idle row a shard: the
    port's dispatch, shard by shard over rebased tables, equals
    ``ref.paged_attention_ref`` over the global pool and tables."""
    bs, Hkv, H, hd, pps, B, W = 4, 2, 4, 8, 3, 8, 3
    P_tot = shards * (pps + 1)
    rng = np.random.default_rng(0)
    k_pages = rng.normal(size=(P_tot, bs, Hkv, hd)).astype(np.float32)
    v_pages = rng.normal(size=(P_tot, bs, Hkv, hd)).astype(np.float32)
    tables = np.zeros((B, W), np.int32)
    lengths = np.zeros((B,), np.int32)
    rows = B // shards
    for b in range(B):
        s = b // rows
        base = s * (pps + 1)
        tables[b] = [base + (b % pps), base + ((b + 1) % pps), base + pps]
        lengths[b] = 1 + b % (2 * bs - 3)
        if b % rows == rows - 1:            # idle: the shard's null page
            tables[b] = base + pps
            lengths[b] = 1
    q = rng.normal(size=(B, K, H, hd)).astype(np.float32)
    qq = q[:, 0] if K == 1 else q
    want = np.asarray(jref.paged_attention_ref(
        jnp.asarray(qq), jnp.asarray(k_pages), jnp.asarray(v_pages),
        jnp.asarray(tables), jnp.asarray(lengths)))
    got = ops.paged_attention_sharded(
        shards, torch.from_numpy(qq), torch.from_numpy(k_pages),
        torch.from_numpy(v_pages), torch.from_numpy(tables),
        torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    # the single-pool call over the global tables reads the same
    whole = ops.paged_attention(
        torch.from_numpy(qq), torch.from_numpy(k_pages),
        torch.from_numpy(v_pages), torch.from_numpy(tables),
        torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **LOGIT_TOL)
    with pytest.raises(ValueError, match="divisible"):
        ops.paged_attention_sharded(
            3, torch.from_numpy(qq), torch.from_numpy(k_pages),
            torch.from_numpy(v_pages), torch.from_numpy(tables),
            torch.from_numpy(lengths))


# ---------------------------------------------------------------------------
# token streams: MeshScheduler against Scheduler and JAX's Scheduler
# ---------------------------------------------------------------------------

# (arch, scheduler keywords, temperature, drafter)
CASES = {
    "qwen3_paged": ("qwen3-0.6b", (), 0.0, False),
    "qwen3_chunked_t08": ("qwen3-0.6b", (("prefill_chunk", 4),), 0.8,
                          False),
    "qwen3_dense": ("qwen3-0.6b", (("layout", "dense"),), 0.0, False),
    "jamba_paged": ("jamba-1.5-large-398b", (), 0.0, False),
    "qwen3_spec_t08": ("qwen3-0.6b", (("spec_tokens", 2),), 0.8, True),
}


@functools.lru_cache(maxsize=None)
def _baselines(case):
    """The case's token streams from JAX's Scheduler and the port's."""
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler

    arch, kw, temperature, draft = CASES[case]
    jcfg, params, model = _weights(arch)
    kw = {**KW, **dict(kw)}
    js = JScheduler(jcfg, params, telemetry=False,
                    draft_params=params if draft else None, **kw)
    ts = Scheduler(model.cfg, model, device="cpu",
                   draft_params=model if draft else None, **kw)
    for r in _trace(jcfg.vocab_size, temperature):
        js.submit(JRequest(**r))
        ts.submit(Request(**r))
    return _tokens(js.run(max_steps=400)), _tokens(ts.run(max_steps=400))


def _mesh_run(case, shards, **extra):
    arch, kw, temperature, draft = CASES[case]
    _, _, model = _weights(arch)
    kw = {**KW, **dict(kw), **extra}
    sched = tmesh.MeshScheduler(model.cfg, model, mesh_shape=(shards, 1),
                                device="cpu",
                                draft_params=model if draft else None, **kw)
    for r in _trace(model.cfg.vocab_size, temperature):
        sched.submit(Request(**r))
    return sched, _tokens(sched.run(max_steps=400))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_scheduler_streams_equal_single_device_and_jax(case, shards):
    jtok, ttok = _baselines(case)
    assert ttok == jtok and len(jtok) == 6
    sched, got = _mesh_run(case, shards)
    assert got == ttok
    if sched.paged:
        assert sched.pool.data_shards == shards
        assert len({sched.pool.shard_of_slot(s)
                    for s in range(sched.pool.num_slots)}) == shards
        # every page back, every idle row on its shard's null page
        assert sched.pool.as_dict()["used_blocks"] == 0
        assert [int(sched.pool.tables[s, 0]) for s in range(4)] == \
            [sched.pool.null_page_of(s) for s in range(4)]
    assert sched.stats.ragged_splits == 0      # no subset dispatch
    assert sched.remote_stats[0]["completed"] == 6


def test_mesh_scheduler_rounds_its_geometry_and_counts_its_dispatch(
        monkeypatch):
    """Slots and pages round up to multiples of ``data``; each decode step
    reads attention once a shard a layer (the dispatch's calls counted on
    the CPU path); the explicit-tables subset step raises."""
    _, _, model = _weights("qwen3-0.6b")
    calls = []
    plain = ops.paged_attention
    monkeypatch.setattr(ops, "paged_attention",
                        lambda *a: calls.append(a[0].shape[0]) or plain(*a))
    sched = tmesh.MeshScheduler(model.cfg, model, mesh_shape=(4, 1),
                                device="cpu", num_slots=6, max_len=32,
                                block_size=4, num_blocks=30)
    assert sched.pool.num_slots == 8 and sched.pool.blocks.num_blocks == 8
    for r in _trace(model.cfg.vocab_size, n=4):
        sched.submit(Request(**r))
    sched.run()
    layers = sum(1 for s in tlm.layer_specs(model.cfg) if s.kind == "a")
    assert calls and all(b == 2 for b in calls)
    assert len(calls) == 4 * layers * sched.stats.decode_steps
    with pytest.raises(ValueError, match="shard"):
        sched.session.step(np.zeros((8, 1), np.int32),
                           np.full((8,), -1, np.int32),
                           tables=np.zeros((8, 1), np.int32))


# ---------------------------------------------------------------------------
# follower replay: rank 0's plans drive a replica to its state
# ---------------------------------------------------------------------------


def _pair(shards=2, **kw):
    """Rank 0's mesh scheduler and a follower replica (qwen3, one model)."""
    _, _, model = _weights("qwen3-0.6b")
    mk = functools.partial(tmesh.MeshScheduler, model.cfg, model,
                           mesh_shape=(shards, 1), device="cpu",
                           **{**KW, **kw})
    return mk(), mk()


def _lockstep(host0, follower, max_steps=300, hook=None):
    """Step rank 0, replay each plan (through its wire bytes) on the
    follower; returns the plans."""
    plans = []
    while (host0.queue or host0.active or host0.prefilling) \
            and len(plans) < max_steps:
        if hook is not None:
            hook(host0, len(plans))
        plan = host0.step()
        follower.step(plan=tmesh.StepPlan.decode(plan.encode()))
        plans.append(plan)
    return plans


def _same_state(a, b):
    assert _tokens(a.results) == _tokens(b.results)
    assert a.pool.as_dict() == b.pool.as_dict()
    assert a.pool.tables.tolist() == b.pool.tables.tolist()
    assert a._index.tolist() == b._index.tolist()
    assert _counters(a) == _counters(b)


@pytest.mark.parametrize("shards", [2, 4])
def test_follower_replays_rank0_plans_to_an_identical_state(shards):
    host0, follower = _pair(shards=shards, prefill_chunk=4)
    for r in _trace(host0.cfg.vocab_size, 0.8, n=8):
        host0.submit(Request(**r))          # the follower sees none
    plans = _lockstep(host0, follower)
    assert sum(len(p.admits) for p in plans) == 8
    assert sum(len(p.submits) for p in plans) == 8
    _same_state(host0, follower)
    if shards == 2:
        assert host0.pool.prefix_hits >= 1


def test_a_diverged_follower_raises():
    host0, follower = _pair()
    reqs = _trace(host0.cfg.vocab_size, n=3)
    for r in reqs:
        host0.submit(Request(**r))
    plan = host0.step()
    with pytest.raises(RuntimeError, match="diverged"):
        follower.step(plan=tmesh.StepPlan(admits=[2], submits=plan.submits))
    # a follower that holds the request but cannot admit it
    full = tmesh.MeshScheduler(host0.cfg, host0.session.model,
                               mesh_shape=(2, 1), device="cpu",
                               **{**KW, "num_slots": 2})
    for r in reqs[:2]:
        Scheduler.submit(full, Request(**r))
    full._admit(full.queue.popleft())
    full._admit(full.queue.popleft())
    with pytest.raises(RuntimeError, match="cannot admit"):
        full.step(plan=tmesh.StepPlan(admits=[2], submits=[
            tmesh.encode_request(Request(**reqs[2]))]))


def test_replicated_submits_are_deduped_and_max_queue_suspended():
    """A follower that holds the trace already (``--feed replicated``)
    skips the plan's copies by rid, and takes a new one even with its
    queue at ``max_queue`` (rank 0 ruled on overload at its intake)."""
    host0, follower = _pair(max_queue=2)
    for r in _trace(host0.cfg.vocab_size, n=2):
        host0.submit(Request(**r))
        Scheduler.submit(follower, Request(**r))
    follower.max_queue = 1
    extra = tmesh.encode_request(Request(
        rid=9, prompt=np.arange(1, 6, dtype=np.int32), max_new=2))
    follower._apply_submits(list(host0._pending_submits) + [extra])
    assert [q.rid for q in follower.queue] == [0, 1, 9]
    assert follower.max_queue == 1 and follower.stats.submitted == 3


class _Registry:
    """A registry of in-memory winners: ``avail`` is the newest step the
    trainer has written (rank 0's poll sees it; a follower loads what
    the plan names)."""

    def __init__(self, steps):
        self.steps, self.avail = steps, 1
        self.step, self.params = 1, steps[1]
        self.rejected_corrupt = 0

    def refresh(self):
        if self.avail > self.step:
            return self.load_step(self.avail)
        return False

    def load_step(self, step, strict=True):
        if step == self.step:
            return False
        self.step, self.params = step, self.steps[step]
        return True


def test_hot_swap_rides_the_plan_winner():
    """Drain-mode swap: rank 0 finds winner 2 mid-flight; the plan's
    ``winner`` makes the follower load exactly that step; both swap on
    the same step after the in-flight rows drain."""
    _, _, model = _weights("qwen3-0.6b")
    _, p2, _ = _weights("qwen3-0.6b", key=7)
    from repro_torch.bridge import params_from_jax
    steps = {1: {k: v.clone() for k, v in model.state_dict().items()},
             2: params_from_jax(jax.tree.map(np.asarray, p2), model.cfg)}
    cfg = model.cfg
    mk = functools.partial(tmesh.MeshScheduler, cfg, device="cpu",
                           mesh_shape=(2, 1), watch_every=1,
                           swap_mode="drain", **KW)
    host0 = mk(tlm.init_lm(cfg, device="cpu"), registry=_Registry(steps))
    follower = mk(tlm.init_lm(cfg, device="cpu"),
                  registry=_Registry(steps))
    for s in (host0, follower):
        s.session.set_params(steps[1])
    reqs = _trace(cfg.vocab_size, n=3)
    for r in reqs[:2]:
        host0.submit(Request(**r))

    def land(h, i):
        if i == 3:
            # the winner lands with rids 0 and 1 in flight; rid 2 waits
            # for the drain and runs on the new weights
            h.registry.avail = 2
            h.submit(Request(**reqs[2]))

    plans = _lockstep(host0, follower, hook=land)
    assert [p.winner for p in plans if p.winner is not None] == [2]
    assert host0.stats.hot_swaps == follower.stats.hot_swaps == 1
    assert follower.registry.step == 2
    _same_state(host0, follower)


def test_cancel_and_shed_ride_the_plan():
    host0, follower = _pair(num_slots=2)
    reqs = list(_trace(host0.cfg.vocab_size, n=4))
    reqs[3] = dict(reqs[3], ttft_deadline_ms=1e-6)
    for r in reqs:
        host0.submit(Request(**r))

    def act(h, i):
        if i == 0:
            assert h.shed_expired() == [3]
        if i == 2:
            assert h.cancel(0) and not h.cancel(42)

    plans = _lockstep(host0, follower, hook=act)
    cancels = [c for p in plans for c in p.cancels]
    assert cancels == [[3, "deadline"], [0, "cancel"]]
    for s in (host0, follower):
        assert s.stats.shed_deadline == 1 and s.stats.cancelled == 1
        assert sorted(s.results) == [1, 2]
    _same_state(host0, follower)


def test_journal_resume_on_the_mesh(tmp_path):
    """A mesh run crashed at step 6 resumes from its journal into a fresh
    mesh scheduler: the stitched streams equal the uninterrupted run's
    (T = 0.8: the resumed rows continue their rng streams)."""
    case = "qwen3_chunked_t08"
    _, want = _mesh_run(case, 2)
    path = str(tmp_path / "j.jsonl")
    _, _, model = _weights("qwen3-0.6b")
    mk = functools.partial(tmesh.MeshScheduler, model.cfg, model,
                           mesh_shape=(2, 1), device="cpu",
                           **{**KW, "prefill_chunk": 4})
    crashed = mk(journal=tjournal.RequestJournal(path),
                 faults=FaultInjector("crash@6"))
    for r in _trace(model.cfg.vocab_size, 0.8):
        crashed.submit(Request(**r))
    with pytest.raises(InjectedFault):
        crashed.run(max_steps=400)
    crashed.journal.close()
    entries = tjournal.replay(path)
    fresh = mk()
    prefixes = tjournal.resume_scheduler(fresh, entries)
    got = tjournal.stitched_results(fresh.run(max_steps=400), prefixes)
    assert fresh.stats.journal_replayed > 0
    assert _tokens(got) == want


def test_arena_follower_replays_the_promotion():
    """Rank 0's match evaluation promotes (an admin override); the plan's
    ``promote`` makes the follower's arena promote the same member at the
    same step, and the two arenas' snapshots stay equal."""
    _, _, model = _weights("qwen3-0.6b")
    _, p2, _ = _weights("qwen3-0.6b", key=7)
    from repro_torch.bridge import params_from_jax
    cfg = model.cfg
    members = {"trainer_0": {k: v.clone()
                             for k, v in model.state_dict().items()},
               "trainer_1": params_from_jax(jax.tree.map(np.asarray, p2),
                                            cfg)}
    acfg = ArenaConfig(policy="shadow", window=16, min_samples=10 ** 6,
                       hysteresis=1, check_every=2)

    def mk():
        arena = Arena(dict(members), "trainer_0", acfg)
        return tmesh.MeshScheduler(
            cfg, tlm.init_lm(cfg, device="cpu"), mesh_shape=(2, 1),
            device="cpu", arena=arena, spec_tokens=2,
            draft_params=tlm.init_lm(cfg, device="cpu"), **KW)

    host0, follower = mk(), mk()
    for r in _trace(cfg.vocab_size, 0.8):
        host0.submit(Request(**r))

    def force(h, i):
        if i == 3:
            h.arena_force("trainer_1")

    plans = _lockstep(host0, follower, hook=force)
    assert [p.promote for p in plans if p.promote] == ["trainer_1"]
    for s in (host0, follower):
        assert s.arena.champion == "trainer_1" and s.arena.promotions == 1
    # only rank 0 evaluates matches (its count is rank 0's, as in JAX)
    want = dict(host0.arena.snapshot(), matches=0)
    assert follower.arena.snapshot() == want
    _same_state(host0, follower)


# ---------------------------------------------------------------------------
# the engine and the per-rank Prometheus series
# ---------------------------------------------------------------------------


def test_engine_on_a_mesh_equals_the_engine_and_jax():
    from repro.serve.engine import Engine as JEngine

    jcfg, params, model = _weights("qwen3-0.6b")
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (4, 6)).astype(np.int32)
    want = np.asarray(JEngine(jcfg, params, max_len=16).generate(
        jnp.asarray(toks), 5))
    eng = Engine(model.cfg, model, max_len=16, mesh=tmesh.ServeMesh(2))
    np.testing.assert_array_equal(eng.generate(toks, 5).numpy(), want)
    np.testing.assert_array_equal(
        Engine(model.cfg, model, max_len=16).generate(toks, 5).numpy(),
        want)
    assert isinstance(eng._sessions[4], tmesh.MeshDecodeSession)
    with pytest.raises(ValueError, match="divisible"):
        eng.generate(toks[:3], 2)


def _stats(mod):
    s = mod.ServeStats(slots=4, submitted=9, completed=7, prefills=8,
                       decode_steps=30, decode_tokens=60, plan_retries=2)
    s.started, s.finished = 10.0, 12.5
    for i in range(5):
        s.ttft.append(0.003 * (i + 1))
        s.latency.append(0.05 * (i + 1))
    return s


def test_per_rank_prometheus_series_equal_jax():
    host0, follower = _pair(num_slots=2)
    for r in _trace(host0.cfg.vocab_size, n=3):
        host0.submit(Request(**r))
    _lockstep(host0, follower)
    remote = {0: ttel.stats_snapshot(host0, rank=0),
              1: ttel.stats_snapshot(follower, rank=1)}
    remote[1]["arena"] = {"promotions": 1, "members": {
        "b": {"accept_rate": 0.25, "served_tokens": 9},
        "a": {"accept_rate": 0.0, "served_tokens": 3}}}
    remote = json.loads(json.dumps(remote))
    got = ttel.prometheus_text(_stats(tmetrics), remote_stats=remote)
    assert got == jtel.prometheus_text(_stats(jmetrics), remote_stats=remote)
    assert 'repro_serve_mesh_completed_total{rank="1"} 3\n' in got
    assert 'repro_serve_mesh_arena_accept_rate{rank="1",member="b"} ' \
        '0.25\n' in got
    assert "repro_serve_plan_retries_total 2\n" in got

    def stub(mod):
        return types.SimpleNamespace(stats=_stats(mod), remote_stats=remote,
                                     queue=[1], active={}, prefilling={})
    assert ttel.scheduler_prometheus(stub(tmetrics)) == \
        jtel.scheduler_prometheus(stub(jmetrics))
    # the snapshot's keys are JAX's
    assert sorted(remote["0"]) == sorted(
        jtel.stats_snapshot(types.SimpleNamespace(
            stats=jmetrics.ServeStats()), rank=0))
