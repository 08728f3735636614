"""The online LTFB arena of the port (``repro_torch.serve.arena``) against
the JAX package's (``repro.serve.arena``), on the CPU.

* the rules: one seeded script of rotations, speculative samples,
  finished requests, match evaluations, promotions, an admin override
  and a restore drives both packages' arenas under each routing policy;
  every snapshot and counter dict is equal (rates are ratios of integers
  and compare exactly), and so are ``safe_rate``, ``MemberStats``,
  ``ArenaConfig``'s clamps and the roster's checks;
* the write-back: the same streams give byte-equal shard files and
  state files through both writers; the dedup of request ids across a crash,
  the out-of-vocab refusal, the fallback from a corrupt state file and
  the reingest through the port's ``DataStore``;
* ``archive_member`` across packages: each package's archive passes the
  other's ``verify_checkpoint`` and restores through the other's
  ``ckpt.restore`` as the member's weights;
* the scheduler end to end, SMOKE qwen3 in f32: one population directory
  (two distinct members, and twins) served through JAX's
  ``Scheduler(arena=...)`` and the port's with a journal and write-back:
  equal streams, final snapshots (windows included), promotions (step,
  winner, rate, forced), journal record kinds in order and shards; twins
  stream exactly what target-only decoding does;
* a crash (``crash@N``, after the promotion) and a resume from the
  journal (``replay_arena`` into a fresh ``Arena.from_population``),
  the stitched streams equal to the uninterrupted run's;
* the gateway's ``/population`` and ``/arena/promote`` (unknown member,
  the champion, a challenger: 400, 400, 200), the override applied by
  the next scheduler step (the driver's steps gated by the test, no
  sleeps), the arena's Prometheus families text-equal to JAX's, 404
  without an arena;
* the serve CLI: ``--arena`` with ``--ckpt-dir`` or ``--draft-ckpt``
  exits; an ``--arena --journal`` run, then ``--resume-journal``, prints
  the restored champion and generation; the lineage CLI walks the
  promotion it appended to the genealogy.
"""
import asyncio
import dataclasses
import json
import os
import threading
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.base import replace
from repro_torch.configs.registry import get_config
from repro_torch.models.lm import init_lm
from repro_torch.serve import arena as tarena
from repro_torch.serve import journal as tjournal
from repro_torch.serve import registry as treg
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.train.steps import params_from_ckpt

N_PROMPTS, MAX_NEW = 4, 8
KW = dict(num_slots=2, max_len=48, block_size=4, spec_tokens=3,
          swap_mode="drain")
# distinct members promote at a margin of 0 (each match's best
# challenger qualifies once its window holds 4 proposals); twins accept
# nearly every proposal, so they cross a margin of 0.3
ARENA_KW = {"distinct": dict(policy="shadow", window=64, min_samples=4,
                             margin=0.0, hysteresis=1, check_every=2,
                             seq_len=16, samples_per_file=2),
            "twin": dict(policy="shadow", window=64, min_samples=4,
                         margin=0.3, hysteresis=1, check_every=2,
                         seq_len=16, samples_per_file=4)}


@pytest.fixture(autouse=True)
def _serving_runs_without_gradients():
    with torch.no_grad():
        yield


def _jax_arena():
    pytest.importorskip("jax")
    from repro.serve import arena as jarena

    return jarena


def _dummy(mod, n=3, **kw):
    """An arena over tiny stand-in weights (for the rules alone)."""
    members = {f"trainer_{i}": {"w": np.full((2,), float(i))}
               for i in range(n)}
    return mod.Arena(members, "trainer_0", mod.ArenaConfig(**kw))


# ---------------------------------------------------------------------------
# the rules against JAX
# ---------------------------------------------------------------------------


def _script(seed=7, steps=120):
    """One seeded sequence of scheduler-like events: per step the rows'
    (offered, accepted) samples and the finished requests' token counts,
    an admin override at step 50 (a challenger) and 80 (the champion,
    ignored), a crash-and-restore at step 90."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(1, steps + 1):
        rows = []
        for _ in range(int(rng.integers(0, 4))):
            o = int(rng.integers(0, 5))
            rows.append((o, int(rng.integers(0, o + 1))))
        done = [int(rng.integers(1, 9)) for _ in range(int(rng.integers(0, 2)))]
        out.append((step, rows, done))
    return out


def _drive(mod, policy, script):
    """Run ``script`` through a 3-member arena of ``mod`` as the
    scheduler drives one; returns every step's (snapshot, counters,
    winner, forced)."""
    kw = dict(policy=policy, window=6, min_samples=5, margin=0.05,
              hysteresis=2, check_every=3, rotate_every=4, epsilon=0.5)
    a = _dummy(mod, **kw)
    seen = []
    for step, rows, done in script:
        if step == 90:                        # crash: state from a snapshot
            b = _dummy(mod, **kw)
            b.restore(json.loads(json.dumps(a.snapshot())))
            a = b
        if step == 50:
            a.forced = a.challengers[-1]
        if step == 80:
            a.forced = a.champion
        want = a.drafter_for_step(step)
        if want != a.active_drafter:
            a.set_drafter(want)
        winner = None
        if a.forced is not None or step % a.cfg.check_every == 0:
            winner = a.decide(step)
            if winner is not None:
                a.promote(a.prepare_promotion(winner), step)
        for o, acc in rows:
            a.record_spec(o, acc)
        for i, n in enumerate(done):
            a.record_finished(f"{step}.{i}", [1, 2], list(range(n)))
        seen.append((a.snapshot(), a.counters(), winner, a.last_forced))
    return seen


@pytest.mark.parametrize("policy", tarena.POLICIES)
def test_rules_match_jax_step_by_step(policy):
    """Rotation, scoring, the promotion rule, the override and a restore:
    the two packages' arenas agree on every snapshot and counter dict."""
    jarena = _jax_arena()
    script = _script()
    got, want = _drive(tarena, policy, script), _drive(jarena, policy,
                                                       script)
    assert got == want
    final = got[-1][0]
    forced = [w for _, _, w, f in got if w is not None and f]
    assert final["promotions"] >= 2 and len(forced) == 1
    assert len({s["drafter"] for s, _, _, _ in got}) >= 2


def test_rates_scorecards_config_and_roster_checks_match_jax():
    jarena = _jax_arena()
    for acc, off in ((0, 0), (3, 4), (5, 5), (0, 7)):
        assert tarena.safe_rate(acc, off) == jarena.safe_rate(acc, off)
    rng = np.random.default_rng(3)
    ms = [mod.MemberStats(window=4) for mod in (tarena, jarena)]
    assert ms[0].rate == 0.0 and ms[0].win_offered == 0
    for _ in range(9):
        o = int(rng.integers(0, 6))
        a = int(rng.integers(0, o + 1))
        for m in ms:
            m.add(o, a)
        assert ms[0].as_dict() == ms[1].as_dict()
    again = tarena.MemberStats(window=4)
    again.load(ms[0].as_dict())
    assert again.as_dict() == ms[0].as_dict()
    clamp = dict(window=0, min_samples=-3, hysteresis=0, check_every=0,
                 rotate_every=-1)
    assert dataclasses.asdict(tarena.ArenaConfig(**clamp)) == \
        dataclasses.asdict(jarena.ArenaConfig(**clamp))
    for bad in (lambda m: m.ArenaConfig(policy="random"),
                lambda m: m.Arena({"trainer_0": {}}, "trainer_0"),
                lambda m: m.Arena({"a": {}, "b": {}}, "c")):
        with pytest.raises(ValueError) as t_err:
            bad(tarena)
        with pytest.raises(ValueError) as j_err:
            bad(jarena)
        assert str(t_err.value) == str(j_err.value)
    a = _dummy(tarena)
    json.dumps(a.snapshot()), json.dumps(a.counters())
    assert all(c["accept_rate"] == 0.0
               for c in a.counters()["members"].values())


def test_scorecards_read_whole_while_the_driver_appends():
    """The gateway's event loop reads scorecards (``/population``,
    ``/metrics``) while the scheduler's driver thread appends: with the
    interpreter switching threads every microsecond, every read is one
    whole window (its rate and sums agree with its own samples) and none
    raises."""
    import sys

    a = _dummy(tarena, 2, window=8)
    member = a.members["trainer_1"]
    stop = threading.Event()
    errors, reads = [], [0]

    def write():
        i = 0
        while not stop.is_set():
            member.add(4, i % 5)
            i += 1

    def read():
        try:
            while not stop.is_set():
                d = a.snapshot()["members"]["trainer_1"]
                off = sum(o for o, _ in d["window"])
                acc = sum(x for _, x in d["window"])
                assert d["win_offered"] == off
                assert d["rate"] == tarena.safe_rate(acc, off)
                a.counters()
                reads[0] += 1
        except Exception as e:      # noqa: BLE001 (reported below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=write)] + [
        threading.Thread(target=read) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        stop.wait(1.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert reads[0] > 0 and member.offered > 0


# ---------------------------------------------------------------------------
# the write-back
# ---------------------------------------------------------------------------


def _npy_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def test_writeback_matches_jax_byte_for_byte(tmp_path, monkeypatch):
    """The same streams through both writers: the same adds, state file
    and shard files byte for byte (the zip entries' timestamps pinned to
    one second, as ``np.savez`` stamps the wall clock)."""
    import time

    jarena = _jax_arena()
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    rng = np.random.default_rng(11)
    streams = [(f"r{i}", rng.integers(1, 100, int(rng.integers(1, 16))))
               for i in range(10)]
    streams += [("r3", [1, 2]), (7, [5, 6, 7])]      # a dup, an int rid
    dirs = {}
    for name, mod in (("t", tarena), ("j", jarena)):
        root = str(tmp_path / name)
        wb = mod.TokenWriteback(root, seq_len=8, vocab=100,
                                samples_per_file=3)
        dirs[name] = (root, [wb.add(r, s) for r, s in streams])
        wb.close()
    (troot, tadds), (jroot, jadds) = dirs["t"], dirs["j"]
    assert tadds == jadds and tadds.count(False) == 1
    assert sorted(os.listdir(troot)) == sorted(os.listdir(jroot))
    state = tarena.TokenWriteback.STATE
    assert open(os.path.join(troot, state), "rb").read() == \
        open(os.path.join(jroot, state), "rb").read()
    from repro_torch.data.tokens import list_token_shards
    shards = list_token_shards(troot)
    assert len(shards) == 3
    for p in shards:
        with open(p, "rb") as a, open(os.path.join(
                jroot, os.path.basename(p)), "rb") as b:
            assert a.read() == b.read()


def test_writeback_dedup_vocab_corrupt_state_and_reingest(tmp_path):
    from repro_torch.data.tokens import list_token_shards, read_token_shard
    from repro_torch.datastore.store import DataStore

    root = str(tmp_path / "wb")
    wb = tarena.TokenWriteback(root, seq_len=4, vocab=50,
                               samples_per_file=2)
    assert wb.add("a", [1, 2]) and wb.add("b", [3, 4])
    assert not wb.add("a", [1, 2])          # same generation
    assert wb.add("c", [5])                 # buffered
    # a crash (no close): the next generation over the same directory
    wb2 = tarena.TokenWriteback(root, seq_len=4, vocab=50,
                                samples_per_file=2)
    assert not wb2.add("a", [1, 2]) and not wb2.add("c", [5])
    assert wb2.add("d", list(range(1, 9)))  # truncated to 5 ids
    shards = list_token_shards(root)
    rows = np.concatenate([read_token_shard(p)["tokens"] for p in shards])
    assert rows.tolist() == [[1, 2, 0, 0, 0], [3, 4, 0, 0, 0],
                             [5, 0, 0, 0, 0], [1, 2, 3, 4, 5]]
    assert wb2.as_dict()["rows_written"] == 4
    # the shard directory is a datastore manifest
    store = DataStore(shards, read_token_shard, num_ranks=2, mode="preload")
    store.preload()
    assert store.num_samples == 4 and store.samples_per_file == 2
    batch = store.get_batch(store.epoch_permutation(0), 0, 4,
                            consumer_rank=0)
    assert sorted(map(list, batch["tokens"])) == sorted(rows.tolist())
    with pytest.raises(ValueError, match="token id 51 >= vocab 50"):
        wb2.add("e", [1, 51])
    # a torn state file: the shards on disk say where the next one goes
    open(os.path.join(root, tarena.TokenWriteback.STATE), "w").write("{")
    assert tarena.TokenWriteback(root, seq_len=4, vocab=50)._next_shard \
        == 2


# ---------------------------------------------------------------------------
# weights, populations, archives
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    """The SMOKE qwen3 config in f32 and two members' weights: each as a
    port model and as a numpy tree in the checkpoint's layout."""
    cfg = replace(get_config("qwen3-0.6b", smoke=True), dtype="float32")
    models = [init_lm(cfg, seed=s, device="cpu") for s in (0, 1)]
    trees = [_np_tree(bridge.params_to_jax_layout(m, cfg)) for m in models]
    return cfg, models, trees


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    return tree.numpy()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _population(path, trees, wins=(1, 0)):
    """A population checkpoint directory as the ltfb launcher writes
    one (step 0; each trainer's params, a stand-in optimizer state)."""
    pop = {"round": 0, "trainers": [
        {"params": t, "opt_state": {"t": np.zeros((1,), np.float32)},
         "hparams": {"lr": 1e-3}, "steps": 1, "alive": True, "wins": w,
         "adoptions": 0} for t, w in zip(trees, wins)]}
    tckpt.save_population(str(path), 0, pop)
    return str(path)


def test_archive_member_crosses_packages(tmp_path, smoke):
    pytest.importorskip("jax")
    from repro.checkpoint import ckpt as jckpt
    from repro.serve import registry as jreg

    _, _, (tree, other) = smoke
    path = treg.archive_member(str(tmp_path / "t"), "trainer_1", tree, 3,
                               tag="champion")
    name = os.path.basename(path)
    assert name.startswith("gen_0003_") and \
        name.endswith("_champion_trainer_1.ckpt")
    jreg.verify_checkpoint(path)
    back, meta = jckpt.restore(path, {"params": other})
    assert meta["member"] == "trainer_1" and meta["generation"] == 3 \
        and meta["tag"] == "champion"
    assert [(k, v.tolist()) for k, v in _leaves(back["params"])] == \
        [(k, v.tolist()) for k, v in _leaves(tree)]
    jpath = jreg.archive_member(str(tmp_path / "j"), "trainer_0", other, 1)
    treg.verify_checkpoint(jpath)
    back, meta = tckpt.restore(jpath, {"params": tree})
    assert meta["tag"] == "retired" and meta["member"] == "trainer_0"
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(
        _leaves(back["params"]), _leaves(other)))
    with open(jpath, "r+b") as f:            # one byte flipped
        f.seek(os.path.getsize(jpath) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 1]))
    for reg in (treg, jreg):
        with pytest.raises(ValueError, match="sha256"):
            reg.verify_checkpoint(jpath)


# ---------------------------------------------------------------------------
# the scheduler end to end
# ---------------------------------------------------------------------------


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(1, vocab, 6 + i).astype(np.int32)
            for i in range(N_PROMPTS)]


def _port_arena(cfg, pop, acfg, writeback=None):
    return tarena.Arena.from_population(
        pop, bridge.params_to_jax_layout(init_lm(cfg, device="cpu"), cfg),
        acfg, writeback_dir=writeback, vocab=cfg.vocab_size,
        from_ckpt=lambda t: params_from_ckpt(cfg, t, "cpu", torch.float32),
        to_ckpt=lambda p: bridge.params_to_jax_layout(p, cfg))


def _port_sched(cfg, arena, journal, **kw):
    return Scheduler(cfg, init_lm(cfg, seed=7, device="cpu"),
                     draft_params=init_lm(cfg, seed=8, device="cpu"),
                     journal=journal, arena=arena, device="cpu",
                     **{**KW, **kw})


def _records(path):
    recs = [json.loads(ln) for ln in open(path) if ln.strip()]
    for r in recs:                          # the writer's root is per run
        wb = (r.get("arena") or {}).get("writeback")
        if wb:
            wb["root"] = None
    return recs


def _snap(arena):
    s = arena.snapshot()
    if s["writeback"]:
        s["writeback"] = dict(s["writeback"], root=None)
    return s


def _tokens(results):
    return {rid: [int(t) for t in v] for rid, v in results.items()}


def _serve_port(cfg, trees, variant, work, **kw):
    pop = _population(work / "pop", trees)
    acfg = tarena.ArenaConfig(**ARENA_KW[variant])
    arena = _port_arena(cfg, pop, acfg, writeback=str(work / "wb"))
    path = str(work / "journal.jsonl")
    sched = _port_sched(cfg, arena, tjournal.RequestJournal(path), **kw)
    for i, p in enumerate(_prompts(cfg.vocab_size)):
        sched.submit(Request(rid=i, prompt=p, max_new=MAX_NEW))
    try:
        results = sched.run(max_steps=400)
    finally:
        sched.journal.close()
        arena.close()
    return {"tokens": _tokens(results), "snapshot": _snap(arena),
            "records": _records(path), "pop": pop, "wb": str(work / "wb"),
            "stats": sched.stats.as_dict(), "journal": path}


def _serve_jax(smoke, variant, work):
    pytest.importorskip("jax")
    from repro.configs.registry import get_config as jget
    from repro.serve.arena import Arena as JArena
    from repro.serve.arena import ArenaConfig as JConfig
    from repro.serve.journal import RequestJournal as JJournal
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler

    cfg, _, trees = smoke
    jcfg = dataclasses.replace(jget("qwen3-0.6b", smoke=True),
                               dtype="float32")
    member = trees if variant == "distinct" else [trees[0], trees[0]]
    pop = _population(work / "pop", member)
    arena = JArena.from_population(pop, trees[0],
                                   JConfig(**ARENA_KW[variant]),
                                   writeback_dir=str(work / "wb"),
                                   vocab=cfg.vocab_size)
    path = str(work / "journal.jsonl")
    sched = JScheduler(jcfg, arena.champion_params,
                       draft_params=arena.drafter_params,
                       journal=JJournal(path), arena=arena,
                       telemetry=False, **KW)
    for i, p in enumerate(_prompts(cfg.vocab_size)):
        sched.submit(JRequest(rid=i, prompt=p, max_new=MAX_NEW))
    results = sched.run(max_steps=400)
    sched.journal.close()
    arena.close()
    return {"tokens": _tokens(results), "snapshot": _snap(arena),
            "records": _records(path), "wb": str(work / "wb"),
            "stats": sched.stats.as_dict()}


@pytest.fixture(scope="module")
def port_runs(smoke, tmp_path_factory):
    """The port's arena scheduler over the distinct and the twin roster,
    and target-only decoding of the same prompts."""
    cfg, models, trees = smoke
    out = {}
    for variant, members in (("distinct", trees),
                             ("twin", [trees[0], trees[0]])):
        out[variant] = _serve_port(cfg, members, variant,
                                   tmp_path_factory.mktemp(variant))
    plain = Scheduler(cfg, models[0], num_slots=2, max_len=48,
                      block_size=4, device="cpu")
    for i, p in enumerate(_prompts(cfg.vocab_size)):
        plain.submit(Request(rid=i, prompt=p, max_new=MAX_NEW))
    out["target_only"] = _tokens(plain.run(max_steps=400))
    return out


@pytest.fixture(scope="module")
def jax_runs(smoke, tmp_path_factory):
    """JAX's arena scheduler over the same rosters (one jit for both)."""
    return {v: _serve_jax(smoke, v, tmp_path_factory.mktemp(f"jax_{v}"))
            for v in ("distinct", "twin")}


def _promotions(recs):
    return [(r["step"], r["winner"], r["loser"], r["rate"], r["forced"])
            for r in recs if r["t"] == "promotion"]


@pytest.mark.parametrize("variant", ["distinct", "twin"])
def test_arena_scheduler_matches_jax(variant, port_runs, jax_runs):
    """Streams, the final snapshot (windows included), every promotion,
    the journal's records and the write-back shards are the JAX
    scheduler's."""
    from repro_torch.data.tokens import list_token_shards

    got, want = port_runs[variant], jax_runs[variant]
    assert got["tokens"] == want["tokens"]
    assert got["snapshot"] == want["snapshot"]
    assert _promotions(got["records"]) == _promotions(want["records"])
    assert [r["t"] for r in got["records"]] == \
        [r["t"] for r in want["records"]]
    assert [r for r in got["records"] if r["t"] in ("match", "promotion")] \
        == [r for r in want["records"] if r["t"] in ("match", "promotion")]
    for k in ("arena_matches", "arena_promotions", "spec_draft_proposed",
              "spec_draft_accepted", "hot_swaps"):
        assert got["stats"][k] == want["stats"][k], k
    shards = list_token_shards(got["wb"])
    assert [os.path.basename(p) for p in shards] == \
        [os.path.basename(p) for p in list_token_shards(want["wb"])]
    for p in shards:
        assert _npy_members(p) == _npy_members(
            os.path.join(want["wb"], os.path.basename(p)))
    assert got["snapshot"]["promotions"] >= 1


def test_twins_promote_once_and_stream_target_only_tokens(smoke,
                                                         port_runs):
    """Twins: one rule-driven promotion to trainer_1 through the archive,
    the drain-aware swap and the genealogy, and the streams of
    target-only decoding; the write-back holds every request's row."""
    from repro_torch.data.tokens import list_token_shards, read_token_shard

    run = port_runs["twin"]
    snap = run["snapshot"]
    assert snap["champion"] == "trainer_1" and snap["promotions"] == 1
    assert 0.3 < snap["baseline"] <= 1.0
    assert run["stats"]["arena_promotions"] == 1
    assert run["stats"]["arena_matches"] == snap["matches"] > 0
    assert run["tokens"] == port_runs["target_only"]
    (promo,) = [r for r in run["records"] if r["t"] == "promotion"]
    assert promo["winner"] == "trainer_1" and not promo["forced"]
    archives = sorted(os.listdir(os.path.join(run["pop"], "arena")))
    assert len(archives) == 4
    for f in archives:
        if f.endswith(".ckpt"):
            treg.verify_checkpoint(os.path.join(run["pop"], "arena", f))
    assert any("_retired_trainer_0.ckpt" in f for f in archives)
    assert any("_champion_trainer_1.ckpt" in f for f in archives)
    (shard,) = list_token_shards(run["wb"])
    rows = read_token_shard(shard)["tokens"]
    assert rows.shape == (N_PROMPTS, 17)
    want = [(list(p) + run["tokens"][i] + [0] * 17)[:17]
            for i, p in enumerate(_prompts(smoke[0].vocab_size))]
    assert sorted(rows.tolist()) == sorted(want)
    from repro_torch.launch import lineage

    genealogy = os.path.join(run["pop"], "genealogy.jsonl")
    records = [json.loads(ln) for ln in open(genealogy)]
    assert [r["t"] for r in records] == ["promotion"]
    chain = lineage.ancestry(records, lineage.default_champion(records))
    assert chain[0]["winner"] == "trainer_1"


def test_crash_resumes_the_journaled_arena(smoke, port_runs, tmp_path):
    """``crash@N`` two steps after the twins' promotion; a fresh
    ``Arena.from_population`` restored from the journal holds the
    journaled snapshot and serves the new champion, the resumed streams
    stitched equal the uninterrupted run's, and the write-back holds
    each request once."""
    from repro_torch.data.tokens import list_token_shards, read_token_shard
    from repro_torch.serve.faults import FaultInjector, InjectedFault

    cfg, _, trees = smoke
    ref = port_runs["twin"]
    (step,) = [r["step"] for r in ref["records"] if r["t"] == "promotion"]
    pop = _population(tmp_path / "pop", [trees[0], trees[0]])
    acfg = tarena.ArenaConfig(**ARENA_KW["twin"])
    wb, path = str(tmp_path / "wb"), str(tmp_path / "journal.jsonl")
    arena = _port_arena(cfg, pop, acfg, writeback=wb)
    sched = _port_sched(cfg, arena, tjournal.RequestJournal(path),
                        faults=FaultInjector(f"crash@{step + 2}"))
    for i, p in enumerate(_prompts(cfg.vocab_size)):
        sched.submit(Request(rid=i, prompt=p, max_new=MAX_NEW))
    with pytest.raises(InjectedFault):
        sched.run(max_steps=400)
    sched.journal.close()
    state = tjournal.replay_arena(path)
    entries = tjournal.replay(path)
    assert state["promotions"] == 1 and tjournal.unfinished(entries)
    fresh = _port_arena(cfg, pop, acfg, writeback=wb)
    fresh.restore(state)
    assert fresh.snapshot() == dict(state, writeback=fresh.snapshot()[
        "writeback"])
    assert fresh.champion == "trainer_1" and fresh.generation == 1
    resumed = _port_sched(cfg, fresh, tjournal.RequestJournal(path))
    assert torch.equal(resumed.session.model.embed.weight,
                       fresh.champion_params["embed.weight"])
    prefixes = tjournal.resume_scheduler(resumed, entries)
    got = tjournal.stitched_results(resumed.run(max_steps=400), prefixes)
    resumed.journal.close()
    fresh.close()
    assert _tokens(got) == ref["tokens"]
    rows = np.concatenate([read_token_shard(p)["tokens"]
                           for p in list_token_shards(wb)])
    want = np.concatenate([read_token_shard(p)["tokens"]
                           for p in list_token_shards(ref["wb"])])
    assert sorted(rows.tolist()) == sorted(want.tolist())
    # a roster without the journaled members refuses the state
    tiny = tarena.Arena({"x": {}, "y": {}}, "x", acfg)
    with pytest.raises(ValueError, match="trainer_0"):
        tiny.restore(state)


# ---------------------------------------------------------------------------
# the gateway and the Prometheus families
# ---------------------------------------------------------------------------


async def _http(port, method, path, body=None):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    w.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
             f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload)
    await w.drain()
    data = await r.read()
    w.close()
    status = int(data.split()[1])
    head, _, body = data.decode().partition("\r\n\r\n")
    return status, body


class _Gate:
    """Holds the gateway's driver before every scheduler step until the
    test lets that step through; ``arrived_at(n)`` returns once the
    driver has reached its n-th step (everything before it is done),
    ``finished(n)`` once it has run it."""

    def __init__(self, sched):
        self._cv = threading.Condition()
        self.arrived = self.allowed = self.done = 0
        step = sched.step

        def gated():
            with self._cv:
                self.arrived += 1
                n = self.arrived
                self._cv.notify_all()
                self._cv.wait_for(lambda: self.allowed >= n, 120)
            step()
            with self._cv:
                self.done += 1
                self._cv.notify_all()
        sched.step = gated

    def allow(self, n=1):
        with self._cv:
            self.allowed += n
            self._cv.notify_all()

    async def _until(self, pred):
        def wait():
            with self._cv:
                return self._cv.wait_for(pred, 120)
        assert await asyncio.get_running_loop().run_in_executor(None, wait)

    async def arrived_at(self, n):
        await self._until(lambda: self.arrived >= n)

    async def finished(self, n):
        await self._until(lambda: self.done >= n)


def test_gateway_population_promote_and_prometheus(smoke):
    """``/population``; ``/arena/promote`` of an unknown member, of the
    champion, of a challenger (400, 400, 200 queued); the override lands
    in the next step, not before; ``/metrics`` carries the arena's
    families; the families equal JAX's text for the same counters; with
    no arena both routes answer 404."""
    pytest.importorskip("jax")
    from repro.serve import metrics as jmetrics
    from repro.serve import telemetry as jtel
    from repro_torch.serve import metrics as tmetrics
    from repro_torch.serve import telemetry as ttel
    from repro_torch.serve.gateway import Gateway

    cfg, models, _ = smoke
    weights = {n: t.clone() for n, t in models[0].state_dict().items()}
    arena = tarena.Arena(
        {"trainer_0": weights, "trainer_1": weights}, "trainer_0",
        tarena.ArenaConfig(policy="shadow", min_samples=10 ** 6,
                           hysteresis=1, check_every=1))
    sched = Scheduler(cfg, init_lm(cfg, seed=3, device="cpu"),
                      draft_params=init_lm(cfg, seed=4, device="cpu"),
                      num_slots=2, max_len=32, block_size=4, spec_tokens=2,
                      arena=arena, device="cpu")
    gate = _Gate(sched)
    gw = Gateway(sched)
    bare = Gateway(Scheduler(cfg, models[0], num_slots=1, max_len=16,
                             block_size=4, device="cpu"))

    async def go():
        await gw.start()
        await bare.start()
        try:
            out = {"pop": await _http(gw.port, "GET", "/population")}
            for who in ("nope", "trainer_0", "trainer_1"):
                out[who] = await _http(gw.port, "POST", "/arena/promote",
                                       {"member": who})
            gen = asyncio.ensure_future(_http(
                gw.port, "POST", "/v1/generate",
                {"rid": "g", "prompt": [1, 2, 3], "max_new": 4,
                 "stream": False}))
            await gate.arrived_at(1)        # the override is queued
            out["before"] = await _http(gw.port, "GET", "/population")
            gate.allow(1)
            await gate.finished(1)
            out["after"] = await _http(gw.port, "GET", "/population")
            gate.allow(10 ** 6)
            out["gen"] = await asyncio.wait_for(gen, 120)
            out["metrics"] = await _http(gw.port, "GET", "/metrics")
            out["bare"] = [await _http(bare.port, m, p) for m, p in (
                ("GET", "/population"), ("POST", "/arena/promote"))]
        finally:
            await gw.stop()
            await bare.stop()
        return out

    out = asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(go(), 300))
    assert gw.driver_error is None
    status, body = out["pop"]
    assert status == 200 and json.loads(body)["champion"] == "trainer_0"
    assert out["nope"][0] == 400 and "unknown arena member" in out["nope"][1]
    assert out["trainer_0"][0] == 400 and "already the champion" in \
        out["trainer_0"][1]
    assert out["trainer_1"][0] == 200 and json.loads(out["trainer_1"][1]) \
        == {"queued": True, "member": "trainer_1", "champion": "trainer_0"}
    before, after = (json.loads(out[k][1]) for k in ("before", "after"))
    assert before["champion"] == "trainer_0" and before["promotions"] == 0
    assert after["champion"] == "trainer_1" and after["promotions"] == 1
    assert out["gen"][0] == 200 and len(json.loads(out["gen"][1])[
        "tokens"]) == 4
    assert sched.stats.arena_promotions == 1
    text = out["metrics"][1]
    assert "repro_serve_arena_promotions_total 1\n" in text
    assert 'repro_serve_arena_served_tokens{member="trainer_1"} 4\n' in text
    assert [s for s, _ in out["bare"]] == [404, 404]
    assert all("--arena" in b for _, b in out["bare"])
    # the families against JAX's, from the same counters
    a = _dummy(tarena, 2)
    a.record_spec(8, 6)
    a.members["trainer_0"].served_tokens = 42
    a.promotions = 1
    stats = [m.ServeStats() for m in (tmetrics, jmetrics)]
    for s in stats:
        s.arena_matches, s.arena_promotions = 3, 1
    got = ttel.prometheus_text(stats[0], arena=a.counters())
    assert got == jtel.prometheus_text(stats[1], arena=a.counters())
    assert 'repro_serve_arena_accept_rate{member="trainer_1"} 0.75' in got
    assert "repro_serve_arena_matches_total 3" in got
    assert ttel.stats_snapshot(sched)["arena"] == arena.counters()


# ---------------------------------------------------------------------------
# the serve CLI and the lineage CLI
# ---------------------------------------------------------------------------


def test_serve_cli_arena_journal_resume_and_lineage(smoke, tmp_path,
                                                    capsys):
    """``--arena`` refuses ``--ckpt-dir`` and ``--draft-ckpt``; a SMOKE
    ``--arena --journal`` run promotes trainer_1 and reports it; a second
    generation with ``--resume-journal`` prints the restored champion and
    generation; the lineage CLI walks from the population's init to the
    promotion."""
    from repro_torch.launch import lineage
    from repro_torch.launch import serve as tserve
    from repro_torch.train.telemetry import GenealogyLog

    _, _, trees = smoke
    pop = _population(tmp_path / "pop", [trees[0], trees[0]])
    log = GenealogyLog(os.path.join(pop, "genealogy.jsonl"))
    log.append("init", trainers=2, seed=0)
    log.close()
    base = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--dtype",
            "float32", "--arena", pop]
    for extra in (["--ckpt-dir", pop], ["--draft-ckpt", pop]):
        with pytest.raises(SystemExit):
            tserve.main([*base, *extra, "--requests", "1"])
    journal = str(tmp_path / "journal.jsonl")
    flags = [*base, "--arena-policy", "shadow", "--arena-min-samples", "4",
             "--arena-margin", "0.3", "--arena-hysteresis", "1",
             "--arena-check-every", "2", "--requests", "4", "--max-new", "8",
             "--swap-mode", "drain"]
    out_json = str(tmp_path / "out.json")
    assert tserve.main([*flags, "--journal", journal, "--arena-writeback",
                        str(tmp_path / "wb"), "--out-json", out_json]) == 0
    text = capsys.readouterr().out
    assert "[serve] arena: " in text and "spec_tokens=4" in text
    assert "[arena] policy=shadow champion=trainer_1 generation=1" in text
    assert "[serve] arena: matches=" in text
    snap = json.load(open(out_json))["arena"]
    assert snap["champion"] == "trainer_1" and snap["promotions"] == 1
    assert tserve.main([*flags, "--resume-journal", journal]) == 0
    text = capsys.readouterr().out
    assert "[serve] arena: restored from journal — champion=trainer_1 " \
        "generation=1 promotions=1" in text
    assert lineage.main(["--genealogy", os.path.join(pop, "genealogy.jsonl"),
                         "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["champion"] == "trainer_1"
    assert [r["t"] for r in rep["ancestry"]] == ["init", "promotion"]
