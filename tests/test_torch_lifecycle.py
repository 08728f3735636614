"""The port's request lifecycle, journal and fault injection against the
JAX package's, on the CPU.

* ``parse_fault_spec``: the same events, or the same error, for good and
  bad specs;
* the journal: the same calls write byte-equal files in the two packages,
  each package replays the other's file (a torn tail included) into the
  same entries, resume requests and arena state;
* one scripted trace through JAX's and the port's ``Scheduler`` (SMOKE
  qwen3 in f32, JAX's weights crossed through ``repro_torch.bridge``) with
  a journal, ``max_queue``, ``shed_expired``, ``cancel``, deadlines and
  three faults: equal streams, equal counters, equal span chains and
  journal files equal line for line;
* crash and resume at T = 0 and 0.8: a ``crash@N`` mid-decode, the journal
  replayed into a fresh scheduler, the stitched streams equal to the
  uninterrupted run's;
* the ``stall``, ``oom``, ``disconnect`` and ``corrupt`` faults (the last
  quarantined by the registry while the old winner serves on);
* cancels in a chunked prefill, of a prefix sharer and during a fused
  speculative round give back every page and drafter row, on the paged
  and the dense layouts; on xlstm and jamba a request admitted into the
  row a cancel freed between rounds (after a rollback) decodes as if
  alone;
* the serve CLI's SIGKILL drill in subprocesses: ``kill@K`` ends the run
  with -9, and ``--resume-journal`` completes it token-identically.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.serve import faults as jfaults
from repro.serve import journal as jjournal
from repro_torch.serve import faults as tfaults
from repro_torch.serve import journal as tjournal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = ("submitted", "completed", "rejected", "shed_overload",
            "shed_deadline", "cancelled", "ttft_deadline_misses",
            "tpot_deadline_misses", "fault_injected", "journal_replayed",
            "prefills", "prefill_chunks", "prefill_tokens", "decode_steps",
            "decode_tokens", "decode_slot_steps", "ragged_splits")


@pytest.fixture(scope="module")
def weights():
    from repro.configs import qwen3_06b as jq
    from repro.models.lm import init_lm as jax_init_lm
    from repro_torch.bridge import load_jax_params
    from repro_torch.configs import qwen3_06b as tq
    from repro_torch.models.lm import init_lm

    jcfg = dataclasses.replace(jq.SMOKE, dtype="float32")
    tcfg = dataclasses.replace(tq.SMOKE, dtype="float32")
    params = jax.jit(lambda key: jax_init_lm(jcfg, key)[0])(
        jax.random.PRNGKey(0))
    model = init_lm(tcfg, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, tcfg, model


def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# fault specs
# ---------------------------------------------------------------------------


def _events(evs):
    return [(e.kind, e.step, dict(e.args), e.rank) for e in evs]


@pytest.mark.parametrize("spec", [
    "stall@5:secs=0.2,kill@12,oom@7:hold=3:rank=1",
    " crash@3 , disconnect@1:rid=abc,,corrupt@8:dir=/x",
    "",
    "explode@3",
    "kill",
    "kill@3:rank",
    "kill@x",
])
def test_parse_fault_spec_equals_jax(spec):
    """Sorted events with their args and rank, or the same ValueError."""
    try:
        want = _events(jfaults.parse_fault_spec(spec))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfaults.parse_fault_spec(spec)
        assert str(got.value) == str(e)
        return
    assert _events(tfaults.parse_fault_spec(spec)) == want
    assert tfaults.KINDS == jfaults.KINDS
    assert tfaults.FaultInjector(spec).events == \
        tfaults.parse_fault_spec(spec)


# ---------------------------------------------------------------------------
# the journal file format
# ---------------------------------------------------------------------------


def _write_journal(mod, request_cls, path):
    """The same record sequence through one package's RequestJournal."""
    j = mod.RequestJournal(path, fsync_interval_s=0.0)
    j.record_submit(request_cls(rid=0, prompt=np.arange(4, dtype=np.int32),
                                max_new=6, temperature=0.5, seed=9,
                                idem_key="k0"))
    j.record_submit(request_cls(rid="b", prompt=np.arange(3,
                                                          dtype=np.int32),
                                max_new=4, eos_id=7))
    j.record_submit(request_cls(rid=2, prompt=np.arange(5, dtype=np.int32),
                                max_new=2, ntok_base=3))
    j.step_commit({0: [10, 11], "b": [20]}, [])
    j.step_commit({}, [])                        # nothing: no record
    j.step_commit({0: [12], 2: [5, 6]}, [2])
    j.record_match(4, {"champion": "m0", "generation": 0})
    j.record_promotion(5, "m1", "m0", 0.75, False,
                       {"champion": "m1", "generation": 1})
    j.record_cancel("b", "cancel")
    j.record_note("shutdown", drained=False)
    j.close()
    j.close()                                    # idempotent


def _entries(mod, path):
    return {rid: (e.req, e.tokens, e.done, e.cancelled)
            for rid, e in mod.replay(path).items()}


def test_journal_files_are_byte_equal(tmp_path):
    from repro.serve.scheduler import Request as JRequest
    from repro_torch.serve.scheduler import Request

    _write_journal(jjournal, JRequest, str(tmp_path / "j.jsonl"))
    _write_journal(tjournal, Request, str(tmp_path / "t.jsonl"))
    jb = (tmp_path / "j.jsonl").read_bytes()
    assert (tmp_path / "t.jsonl").read_bytes() == jb
    assert len(jb.splitlines()) == 10


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_each_package_replays_the_others_journal(tmp_path, writer, reader):
    """Entries, the unfinished rids, the idempotency map, the last note,
    the arena snapshot and every resume request agree; a torn tail stops
    both replays at the same record."""
    from repro.serve.scheduler import Request as JRequest
    from repro_torch.serve.scheduler import Request

    mods = {"jax": (jjournal, JRequest), "torch": (tjournal, Request)}
    path = str(tmp_path / "w.jsonl")
    _write_journal(*mods[writer], path)
    w, r = mods[writer][0], mods[reader][0]
    assert _entries(r, path) == _entries(w, path)
    got = r.replay(path)
    assert r.unfinished(got) == w.unfinished(w.replay(path)) == [0]
    assert r.idempotency_map(got) == {"k0": (0, False)}
    assert r.last_note(path) == w.last_note(path)
    assert r.last_note(path)["kind"] == "shutdown"
    assert r.replay_arena(path) == {"champion": "m1", "generation": 1}
    req, prefix = r.resume_request(got[0])
    wreq, wprefix = w.resume_request(w.replay(path)[0])
    assert prefix == wprefix == [10, 11, 12]
    assert req.prompt.tolist() == wreq.prompt.tolist() == [0, 1, 2, 3, 10,
                                                           11, 12]
    for f in ("rid", "max_new", "eos_id", "temperature", "seed",
              "ntok_base", "idem_key"):
        assert getattr(req, f) == getattr(wreq, f), f
    assert (req.max_new, req.ntok_base) == (3, 3)
    assert type(req).__module__ == mods[reader][1].__module__
    # torn tail: a generation that died mid-write loses only the tail
    with open(path, "ab") as f:
        f.write(b'{"t":"tokens","toks":{"0":[99')
    assert _entries(r, path) == _entries(w, path)
    assert r.replay(path)[0].tokens == [10, 11, 12]
    assert r.replay(str(tmp_path / "absent")) == {}
    assert r.replay_arena(str(tmp_path / "absent")) is None


def test_resume_scheduler_preloads_finished_and_requeues_the_rest(
        weights, tmp_path):
    """Done, budget-spent and EOS-ended entries land in ``results``;
    cancelled ones are skipped; the rest are requeued with their prefix
    folded into the prompt, as in JAX."""
    from repro_torch.serve.scheduler import Request, Scheduler

    _, _, tcfg, model = weights
    path = str(tmp_path / "j.jsonl")
    j = tjournal.RequestJournal(path)
    p = np.arange(4, dtype=np.int32)
    for rid, kw in (("done", {}), ("eos", {"eos_id": 7}), ("spent", {}),
                    ("gone", {}), ("open", {})):
        j.record_submit(Request(rid=rid, prompt=p, max_new=2
                                if rid in ("done", "spent") else 8, **kw))
    j.step_commit({"done": [1, 2], "eos": [5, 7], "spent": [3, 4],
                   "open": [6]}, ["done"])
    j.record_cancel("gone", "cancel")
    j.close()
    sched = Scheduler(tcfg, model, num_slots=2, max_len=16, block_size=4,
                      device="cpu")
    prefixes = tjournal.resume_scheduler(sched, tjournal.replay(path))
    assert prefixes == {"open": [6]}
    assert {r: v.tolist() for r, v in sched.results.items()} == {
        "done": [1, 2], "eos": [5, 7], "spent": [3, 4]}
    assert [q.rid for q in sched.queue] == ["open"]
    q = sched.queue[0]
    assert q.prompt.tolist() == [0, 1, 2, 3, 6] and q.max_new == 7 \
        and q.ntok_base == 1
    assert sched.stats.journal_replayed == 1


# ---------------------------------------------------------------------------
# the scripted trace through both schedulers
# ---------------------------------------------------------------------------


def _script(sched, request_cls, overloaded, prompts):
    """One lifecycle script: an overload, a deadline shed, a cancel in a
    chunked prefill, a TTFT and a TPOT deadline miss, an unknown cancel;
    the faults fire inside the steps (the disconnect takes rid 3).  Returns what the calls returned."""
    out = {}

    def sub(rid, **kw):
        sched.submit(request_cls(rid=rid, prompt=prompts[rid], max_new=6,
                                 **kw))

    sub(0)
    sub(1, temperature=0.8, seed=11, idem_key="k1")
    sub(2, ttft_deadline_ms=1e-6)               # expired once queued
    with pytest.raises(overloaded):
        sub(3)                                  # max_queue=3
    out["shed"] = sched.shed_expired()
    sched.step()
    sched.step()
    sub(3)                                      # disconnect@9's victim
    sub(4, ttft_deadline_ms=1e-6, temperature=0.8, seed=4)   # never shed
    sub(5, tpot_deadline_ms=1e-9)               # completes, misses TPOT
    for _ in range(2):
        sched.step()
    out["prefilling_1"] = 1 in sched.prefilling
    out["cancel_1"] = sched.cancel(1)
    out["cancel_99"] = sched.cancel(99)
    results = sched.run(max_steps=500)
    out["results"] = {rid: v.tolist() for rid, v in results.items()}
    out["counters"] = {k: getattr(sched.stats, k) for k in COUNTERS}
    out["free_slots"] = sched.pool.free_slots
    out["used_blocks"] = sched.pool.blocks.used_blocks
    return out


def _rows(tracer):
    rows = {}
    for ev in tracer.export()["traceEvents"]:
        if ev["ph"] in ("X", "i") and "rid" in ev["args"]:
            rows.setdefault(ev["args"]["rid"], []).append(ev["name"])
    return rows


def test_scripted_lifecycle_equals_jax(weights, tmp_path):
    from repro.serve.scheduler import Overloaded as JOverloaded
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.serve.scheduler import Overloaded, Request, Scheduler

    jcfg, params, tcfg, model = weights
    prompts = _prompts(jcfg.vocab_size, [10, 9, 6, 11, 7, 5])
    spec = "stall@3:secs=0.001,oom@6:hold=2,disconnect@9"
    kw = dict(num_slots=2, max_len=24, block_size=4, prefill_chunk=4,
              max_queue=3)
    js = JScheduler(jcfg, params, journal=jjournal.RequestJournal(
        str(tmp_path / "j.jsonl")), faults=jfaults.FaultInjector(spec), **kw)
    ts = Scheduler(tcfg, model, journal=tjournal.RequestJournal(
        str(tmp_path / "t.jsonl")), faults=tfaults.FaultInjector(spec),
        device="cpu", **kw)
    want = _script(js, JRequest, JOverloaded, prompts)
    got = _script(ts, Request, Overloaded, prompts)
    js.journal.close()
    ts.journal.close()
    assert got == want
    assert got["shed"] == [2] and got["prefilling_1"] and got["cancel_1"] \
        and not got["cancel_99"]
    c = got["counters"]
    assert (c["shed_overload"], c["shed_deadline"], c["cancelled"],
            c["ttft_deadline_misses"], c["tpot_deadline_misses"],
            c["fault_injected"]) == (1, 1, 2, 1, 1, 3)
    assert sorted(got["results"]) == [0, 4, 5]
    assert (got["free_slots"], got["used_blocks"]) == (2, 0)
    jl = (tmp_path / "j.jsonl").read_text().splitlines()
    tl = (tmp_path / "t.jsonl").read_text().splitlines()
    assert tl == jl
    assert sum('"t":"cancel"' in ln for ln in tl) == 3
    rows, jrows = _rows(ts.telemetry.tracer), _rows(js.telemetry.tracer)
    assert rows == jrows
    assert rows["2"] == ["enqueue", "shed"] and rows["1"][-1] == "cancel"


# ---------------------------------------------------------------------------
# crash and resume
# ---------------------------------------------------------------------------


def _trace(vocab, temperature):
    return [dict(rid=i, prompt=p, max_new=8, temperature=temperature,
                 seed=None if temperature <= 0 else 50 + i)
            for i, p in enumerate(_prompts(vocab, [9, 6, 12, 7], seed=8))]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_crash_resume_token_identity(weights, tmp_path, temperature):
    """``crash@6`` stops the run mid-decode; the journal (flushed every
    step) replayed into a fresh scheduler resumes every unfinished
    request, and the stitched streams equal the uninterrupted run's."""
    from repro_torch.serve.scheduler import Request, Scheduler

    _, _, tcfg, model = weights
    kw = dict(num_slots=2, max_len=24, block_size=4, device="cpu")
    trace = _trace(tcfg.vocab_size, temperature)
    base = Scheduler(tcfg, model, **kw)
    for r in trace:
        base.submit(Request(**r))
    want = {rid: v.tolist() for rid, v in base.run().items()}

    path = str(tmp_path / "j.jsonl")
    crashed = Scheduler(tcfg, model, journal=tjournal.RequestJournal(path),
                        faults=tfaults.FaultInjector("crash@6"), **kw)
    for r in trace:
        crashed.submit(Request(**r))
    with pytest.raises(tfaults.InjectedFault, match="step 6"):
        crashed.run()
    assert crashed.stats.fault_injected == 1
    entries = tjournal.replay(path)
    assert set(entries) == {0, 1, 2, 3}
    assert any(e.tokens for e in entries.values())
    fresh = Scheduler(tcfg, model, journal=tjournal.RequestJournal(path),
                      **kw)
    free0 = fresh.pool.blocks.available_blocks
    prefixes = tjournal.resume_scheduler(fresh, entries)
    assert fresh.stats.journal_replayed == len(prefixes) > 0
    assert any(prefixes.values())               # resumed mid-stream
    got = tjournal.stitched_results(fresh.run(), prefixes)
    fresh.journal.close()
    assert {rid: v.tolist() for rid, v in got.items()} == want
    assert fresh.pool.blocks.available_blocks == free0
    assert fresh.pool.blocks.used_blocks == 0
    # the second generation appended to the same file: a resumed rid's
    # new submit record (the longer prompt) replaces its first, so the
    # file now replays every request as done, its prefix in the prompt
    final = tjournal.replay(path)
    assert all(e.done for e in final.values())
    assert {rid: prefixes.get(rid, []) + e.tokens
            for rid, e in final.items()} == want


# ---------------------------------------------------------------------------
# the other fault kinds
# ---------------------------------------------------------------------------


def test_stall_oom_disconnect_faults(weights):
    """A stall slows one step, oom holds admission shut for ``hold``
    steps, disconnect cancels the named (else the oldest) in-flight
    request; each is counted, every resource comes back."""
    from repro_torch.serve.scheduler import Request, Scheduler

    _, _, tcfg, model = weights
    prompts = _prompts(tcfg.vocab_size, [6, 6, 6, 6])
    sched = Scheduler(tcfg, model, num_slots=2, max_len=24, block_size=4,
                      device="cpu", faults=tfaults.FaultInjector(
                          "stall@1:secs=0.01,oom@2:hold=3,disconnect@6:rid=0,"
                          "disconnect@9"))
    free0 = sched.pool.blocks.available_blocks
    for i in range(4):
        sched.submit(Request(rid=i, prompt=prompts[i], max_new=8))
    sched.step()                                 # stall; admits rid 0
    assert len(sched.queue) == 3
    for _ in range(3):                           # steps 2..4: held shut
        sched.step()
        assert len(sched.queue) == 3
    sched.step()                                 # step 5 admits again
    assert len(sched.queue) == 2
    res = sched.run(max_steps=200)
    assert sched.stats.fault_injected == 4 and sched.faults.injected == 4
    assert sched.stats.cancelled == 2 and 0 not in res and len(res) == 2
    assert all(len(t) == 8 for t in res.values())
    assert sched.pool.free_slots == 2
    assert sched.pool.blocks.available_blocks == free0
    assert sched.pool.blocks.used_blocks == 0


def test_corrupt_fault_is_quarantined_and_the_old_winner_serves_on(
        weights, tmp_path, capsys):
    """``corrupt@1`` truncates the newest winner before step 1's poll:
    the registry quarantines it, no swap happens, every request
    completes on the old weights."""
    from repro_torch import bridge
    from repro_torch.checkpoint import ckpt
    from repro_torch.serve import registry as reg
    from repro_torch.serve.scheduler import Request, Scheduler
    from repro_torch.train.steps import params_from_ckpt

    _, _, tcfg, model = weights
    like = bridge.params_to_jax_layout(model, tcfg)
    d = str(tmp_path)
    for step in (1, 2):
        path = reg.winner_path(d, step)
        ckpt.save(path, {"params": like}, metadata={"step": step,
                                                    "trainer": 0})
        reg.write_checksum(path)
    registry = reg.ModelRegistry(d, like, from_ckpt=lambda tree:
                                 params_from_ckpt(tcfg, tree, "cpu"))
    registry.load_step(1)
    sched = Scheduler(tcfg, model, num_slots=2, max_len=24, block_size=4,
                      registry=registry, watch_every=1, device="cpu",
                      faults=tfaults.FaultInjector("corrupt@1"))
    for i, p in enumerate(_prompts(tcfg.vocab_size, [6, 7])):
        sched.submit(Request(rid=i, prompt=p, max_new=6))
    res = sched.run(max_steps=100)
    assert len(res) == 2 and sched.stats.completed == 2
    assert sched.stats.fault_injected == 1
    assert sched.stats.swap_rejected_corrupt == 1
    assert registry.step == 1 and sched.stats.hot_swaps == 0
    assert os.path.exists(reg.winner_path(d, 2) + ".corrupt")
    out = capsys.readouterr().out
    assert "[faults] truncated" in out and "REJECTED corrupt winner" in out


# ---------------------------------------------------------------------------
# cancels give everything back
# ---------------------------------------------------------------------------


def _accounting(sched):
    pools = [sched.pool] + ([sched.draft.layout] if sched.draft else [])
    return [(p.free_slots, p.blocks.available_blocks, p.blocks.used_blocks)
            for p in pools]


def test_cancel_in_a_chunked_prefill_and_of_a_prefix_sharer(weights):
    """A cancel mid chunked prefill frees the request's pages; a cancel
    of a request that maps another's prompt pages drops one reference on
    each shared page and frees none of them; the survivor completes with
    the tokens it gets alone."""
    from repro_torch.serve.scheduler import Request, Scheduler

    _, _, tcfg, model = weights
    kw = dict(num_slots=2, max_len=32, block_size=4, prefill_chunk=4,
              device="cpu")
    rng = np.random.default_rng(5)
    base = rng.integers(0, tcfg.vocab_size, 16).astype(np.int32)
    sharer = np.concatenate([base[:12], rng.integers(
        0, tcfg.vocab_size, 3).astype(np.int32)])
    alone = Scheduler(tcfg, model, **kw)
    alone.submit(Request(rid="a", prompt=base, max_new=6))
    want = alone.run()["a"].tolist()

    sched = Scheduler(tcfg, model, **kw)
    start = _accounting(sched)
    sched.submit(Request(rid="a", prompt=base, max_new=6))
    sched.submit(Request(rid="long", prompt=rng.integers(
        0, tcfg.vocab_size, 20).astype(np.int32), max_new=4))
    for _ in range(3):
        sched.step()                  # a: 3 of 4 chunks; long admitted
    assert "a" in sched.prefilling and "long" in sched.prefilling
    assert sched.cancel("long")       # never got a chunk, pages reserved
    sched.step()                      # a's last chunk: 4 pages registered
    assert "a" in sched.active
    sched.submit(Request(rid="s", prompt=sharer, max_new=4))
    sched.step()                      # s admitted: maps a's 3 pages
    table = sched.pool.blocks.table("s")
    shared = [p for p in table if sched.pool.blocks.refcount(p) == 2]
    assert len(shared) == 3 and sched.pool.prefix_hits == 1
    assert sched.cancel("s")
    assert all(sched.pool.blocks.refcount(p) == 1 for p in shared)
    assert all(p in sched.pool.blocks.table("a") for p in shared)
    assert sched.run()["a"].tolist() == want
    assert sched.stats.cancelled == 2
    assert _accounting(sched) == start


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_cancel_during_fused_speculation_reclaims_drafter_rows(weights,
                                                               layout):
    """A cancel between fused speculative rounds frees the target's and
    the drafter's slot and pages; the other request's stream equals
    target-only decoding."""
    from repro_torch.serve.scheduler import Request, Scheduler

    _, _, tcfg, model = weights
    kw = dict(num_slots=2, max_len=32, block_size=4, layout=layout,
              device="cpu")
    prompts = _prompts(tcfg.vocab_size, [7, 9], seed=12)
    plain = Scheduler(tcfg, model, **kw)
    plain.submit(Request(rid=1, prompt=prompts[1], max_new=12))
    want = plain.run()[1].tolist()

    sched = Scheduler(tcfg, model, draft_params=model, spec_tokens=3,
                      spec_fused=True, **kw)
    start = _accounting(sched)
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new=12))
    while sched.stats.spec_rounds < 2:
        sched.step()
    assert 0 in sched.active and sched.draft.layout.free_slots == 0
    assert sched.cancel(0)
    assert sched.draft.layout.free_slots == 1 == sched.pool.free_slots
    assert sched.run()[1].tolist() == want
    assert 0 not in sched.results and sched.stats.cancelled == 1
    assert _accounting(sched) == start


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-1.5-large-398b"])
def test_cancel_during_recurrent_speculation_frees_the_row(arch):
    """A recurrent stack restores its state rows from the round's
    snapshot and replays them after every rejected draft.  A request
    cancelled between two such fused rounds frees its slot: a new request
    admitted into it decodes the tokens it gets alone (fresh target and
    drafter state rows), the survivor too, and the pools' accounting is
    back at its start."""
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Request, Scheduler

    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    model = init_lm(cfg, seed=0, device="cpu")
    drafter = init_lm(cfg, seed=7, device="cpu")
    kw = dict(num_slots=2, max_len=32, block_size=4, device="cpu")
    prompts = _prompts(cfg.vocab_size, [7, 9, 6], seed=14)
    want = {}
    for rid in (1, 2):
        alone = Scheduler(cfg, model, **kw)
        alone.submit(Request(rid=rid, prompt=prompts[rid], max_new=10))
        want[rid] = alone.run()[rid].tolist()

    sched = Scheduler(cfg, model, draft_params=drafter, spec_tokens=3,
                      spec_fused=True, **kw)
    start = _accounting(sched)
    for rid in (0, 1):
        sched.submit(Request(rid=rid, prompt=prompts[rid], max_new=10))
    while sched.stats.spec_rounds < 2:
        sched.step()
    assert sched.stats.spec_replays > 0 and 0 in sched.active
    slot = sched.active[0].slot
    assert sched.cancel(0)
    assert sched.draft.layout.free_slots == 1 == sched.pool.free_slots
    sched.submit(Request(rid=2, prompt=prompts[2], max_new=10))
    sched.step()
    assert sched.active[2].slot == slot
    got = sched.run()
    assert {rid: got[rid].tolist() for rid in (1, 2)} == want
    assert 0 not in sched.results and sched.stats.cancelled == 1
    assert _accounting(sched) == start


# ---------------------------------------------------------------------------
# the serve CLI's SIGKILL drill
# ---------------------------------------------------------------------------


def test_serve_cli_sigkill_and_resume_token_identity(tmp_path):
    """``--fault-spec kill@6`` SIGKILLs the CLI mid-decode (return code
    -9) with its journal on disk; ``--resume-journal`` finishes every
    request, and ``--out-json`` holds the stitched streams, equal to an
    uninterrupted run of the same trace."""
    from repro_torch.launch import serve

    args = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--dtype", "float32", "--requests", "4", "--max-new", "8",
            "--temperature", "0.8"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    journal = str(tmp_path / "j.jsonl")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args]
    killed = subprocess.run(cmd + ["--journal", journal, "--fault-spec",
                                   "kill@6"], env=env, capture_output=True,
                            text=True, timeout=300)
    assert killed.returncode == -9, killed.stderr[-2000:]
    assert "[faults] SIGKILL self at step 6" in killed.stdout
    entries = tjournal.replay(journal)
    assert len(entries) == 4 and not all(e.done for e in entries.values())
    out = str(tmp_path / "r.json")
    resumed = subprocess.run(cmd + ["--resume-journal", journal,
                                    "--out-json", out], env=env,
                             capture_output=True, text=True, timeout=300)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "[serve] journal: replayed 4 request(s)" in resumed.stdout
    assert "journal_replayed=" in resumed.stdout
    ref = str(tmp_path / "u.json")
    assert serve.main(args + ["--out-json", ref]) == 0
    got = json.load(open(out))["results"]
    assert got == json.load(open(ref))["results"]
    assert len(got) == 4 and all(len(v) == 8 for v in got.values())
