"""Population speculative decoding of the port against the JAX package.

Both packages serve SMOKE configs at f32 on the CPU with the same weights
(carried across by ``repro_torch.bridge``): a drafter proposes up to K
tokens a row, the target verifies them in one (K+1)-token step, and the
output must equal target-only decoding and the JAX speculative
scheduler's, greedy and at temperature > 0, with a fused or a sequential
draft, over attention, MoE and recurrent stacks (the rollback).  The
recurrent K-token decode with ``valid`` agrees with JAX's at atol = rtol
= 1e-4, the tolerance of ``tests/test_torch_recurrent.py``; a restored
and replayed row gives its logits again within 1e-5.  The ``cuda`` tests
hold the paged kernel at the verify shapes against its plain version on
the card and skip here.
"""
import dataclasses
import functools
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import load_jax_params
from repro_torch.configs.base import replace
from repro_torch.configs.registry import get_config
from repro_torch.models import lm as tlm
from repro_torch.serve import registry as treg
from repro_torch.serve.kv_cache import PagedLayout
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.session import DecodeSession

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("qwen3-0.6b", "deepseek-moe-16b", "jamba-1.5-large-398b")
SPEC_COUNTERS = ("spec_rounds", "spec_draft_steps", "spec_draft_proposed",
                 "spec_draft_accepted", "spec_replays", "decode_steps",
                 "decode_tokens")
KW = dict(num_slots=2, max_len=28, block_size=4)


@pytest.fixture(autouse=True)
def _serving_runs_without_gradients():
    with torch.no_grad():
        yield


def _jax():
    return pytest.importorskip("jax")


def _cfgs(arch):
    """(JAX config, port config), SMOKE at f32."""
    from repro.configs.registry import get_config as jax_get_config

    return (dataclasses.replace(jax_get_config(arch, smoke=True),
                                dtype="float32"),
            replace(get_config(arch, smoke=True), dtype="float32"))


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg):
    """JAX's ``init_lm`` for ``jcfg`` under one jit (one compile a
    config)."""
    jax = _jax()
    from repro.models import lm as jlm

    return jax.jit(lambda k: jlm.init_lm(jcfg, k)[0])


@functools.lru_cache(maxsize=None)
def _weights(arch, key):
    """JAX weights of ``arch`` from PRNGKey(key) and a port model holding
    them."""
    jax = _jax()
    jcfg, tcfg = _cfgs(arch)
    params = _jax_init(jcfg)(jax.random.PRNGKey(key))
    model = tlm.init_lm(tcfg, seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, model


def _prompts(vocab, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _reqs(vocab, lens=(5, 8, 11), max_new=6, temperature=0.0, eos=None):
    return [dict(rid=i, prompt=p, max_new=max_new, eos_id=eos,
                 temperature=temperature,
                 seed=None if temperature <= 0 else 42 + i)
            for i, p in enumerate(_prompts(vocab, lens))]


def _serve_port(model, reqs, draft=None, k=0, **kw):
    s = Scheduler(model.cfg, model, device="cpu", draft_params=draft,
                  spec_tokens=k, **{**KW, **kw})
    for r in reqs:
        s.submit(Request(**r))
    res = s.run(max_steps=400)
    assert len(res) == len(reqs)
    return {rid: v.tolist() for rid, v in res.items()}, s


def _serve_jax(jcfg, params, reqs, draft=None, k=0, **kw):
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler

    s = JScheduler(jcfg, params, telemetry=False, draft_params=draft,
                   spec_tokens=k, **{**KW, **kw})
    for r in reqs:
        s.submit(JRequest(**r))
    res = s.run(max_steps=400)
    assert len(res) == len(reqs)
    return {rid: v.tolist() for rid, v in res.items()}, s


def _same_spec_counters(ts, js):
    td, jd = ts.stats.as_dict(), js.stats.as_dict()
    for k in SPEC_COUNTERS:
        assert td[k] == jd[k], k


# ---------------------------------------------------------------------------
# token identity: target-only, and the JAX speculative scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("drafter", ["self", "other"])
def test_greedy_identity_with_target_only_and_jax(arch, drafter):
    """Greedy, K = 3: the port's speculative tokens equal its target-only
    tokens and the JAX speculative scheduler's, with the same round,
    proposal and replay counts; a self drafter accepts most proposals."""
    jcfg, params, model = _weights(arch, 0)
    _, dparams, dmodel = _weights(arch, 0 if drafter == "self" else 11)
    reqs = _reqs(jcfg.vocab_size)
    base, _ = _serve_port(model, reqs)
    spec, ts = _serve_port(model, reqs, draft=dmodel, k=3)
    jspec, js = _serve_jax(jcfg, params, reqs, draft=dparams, k=3)
    assert spec == base == jspec
    _same_spec_counters(ts, js)
    d = ts.stats.as_dict()
    assert d["spec_rounds"] > 0
    if drafter == "self":
        assert d["spec_accept_rate"] > 0.5
        assert d["spec_rounds"] < d["decode_tokens"]


@pytest.mark.parametrize("temperature", [0.8, 0.9])
def test_temperature_identity_with_a_divergent_drafter(temperature):
    """At temperature > 0 the host resamples the fused draft's proposals,
    which part from the greedy feed of a drafter that disagrees: the
    repair keeps the tokens equal to target-only decoding and to JAX."""
    jcfg, params, model = _weights("qwen3-0.6b", 0)
    _, dparams, dmodel = _weights("qwen3-0.6b", 11)
    reqs = _reqs(jcfg.vocab_size, lens=(8, 8), temperature=temperature)
    base, _ = _serve_port(model, reqs)
    spec, ts = _serve_port(model, reqs, draft=dmodel, k=2)
    jspec, js = _serve_jax(jcfg, params, reqs, draft=dparams, k=2)
    assert spec == base == jspec
    _same_spec_counters(ts, js)
    assert ts.stats.spec_replays > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_fused_and_sequential_drafts_agree(arch):
    """The fused draft is one drafter dispatch a round, the sequential
    K+1: equal tokens and rounds either way, as in JAX."""
    jcfg, params, model = _weights(arch, 0)
    reqs = _reqs(jcfg.vocab_size, lens=(7, 7))
    base, _ = _serve_port(model, reqs)
    fused, sf = _serve_port(model, reqs, draft=model, k=3)
    seq, ss = _serve_port(model, reqs, draft=model, k=3, spec_fused=False)
    assert fused == seq == base
    df, ds = sf.stats.as_dict(), ss.stats.as_dict()
    assert df["spec_rounds"] == ds["spec_rounds"]
    assert df["spec_draft_steps"] == df["spec_rounds"]
    assert ds["spec_draft_steps"] > 3 * ds["spec_rounds"]
    jseq, js = _serve_jax(jcfg, params, reqs, draft=params, k=3,
                          spec_fused=False)
    assert jseq == seq
    _same_spec_counters(ss, js)


@pytest.mark.parametrize("drafter", ["self", "other"])
def test_spec_adapt_depths_equal_jax(drafter):
    """``spec_adapt``: identical tokens, and each request's final depth in
    ``spec_k_by_rid`` equals the JAX scheduler's."""
    jcfg, params, model = _weights("qwen3-0.6b", 0)
    _, dparams, dmodel = _weights("qwen3-0.6b",
                                  0 if drafter == "self" else 11)
    reqs = _reqs(jcfg.vocab_size, lens=(6, 9), max_new=10)
    base, _ = _serve_port(model, reqs, max_len=40)
    spec, ts = _serve_port(model, reqs, draft=dmodel, k=4, spec_adapt=True,
                           max_len=40)
    jspec, js = _serve_jax(jcfg, params, reqs, draft=dparams, k=4,
                           spec_adapt=True, max_len=40)
    assert spec == base == jspec
    assert ts.spec_k_by_rid == js.spec_k_by_rid
    assert set(ts.spec_k_by_rid) == {0, 1}
    assert ts.stats.as_dict()["spec_k_mean"] == \
        js.stats.as_dict()["spec_k_mean"]


def test_eos_inside_an_accepted_block_stops_at_the_eos():
    """A self drafter's block accepts past the EOS token: the request
    stops AT it, on the paged layout, as target-only decoding does."""
    jcfg, _, model = _weights("qwen3-0.6b", 0)
    (req,) = _reqs(jcfg.vocab_size, lens=(8,), max_new=8)
    gen = _serve_port(model, [req], num_slots=1, max_len=32)[0][0]
    eos = int(gen[2])
    want = gen[:gen.index(eos) + 1]
    req = dict(req, eos_id=eos)
    assert _serve_port(model, [req], num_slots=1, max_len=32)[0][0] == want
    spec, s = _serve_port(model, [req], draft=model, k=3, num_slots=1,
                          max_len=32)
    assert spec[0] == want
    assert s.stats.spec_rounds == 1


def test_spec_round_crossing_two_page_boundaries():
    """4-token pages and K = 5: a round writes six positions, across two
    page boundaries for a row at a page's last position.  Every page is
    materialized before the verify (the target's and the drafter's), so
    no write lands in the null page and the tokens equal target-only
    decoding."""
    jcfg, _, model = _weights("qwen3-0.6b", 0)
    reqs = _reqs(jcfg.vocab_size, lens=(7, 11), max_new=14)
    base, _ = _serve_port(model, reqs, max_len=32)
    spec, ts = _serve_port(model, reqs, draft=model, k=5, max_len=32)
    assert spec == base
    assert ts.stats.as_dict()["spec_accept_rate"] > 0.5


# ---------------------------------------------------------------------------
# drafter compatibility and loading
# ---------------------------------------------------------------------------


def test_draft_compat_refuses_another_tokenizer(tmp_path):
    """``check_draft_compat``, the scheduler and ``load_draft`` raise the
    JAX package's tokenizer errors for a drafter of another vocab."""
    from repro_torch import bridge

    _, tcfg = _cfgs("qwen3-0.6b")
    bad = replace(tcfg, vocab_size=tcfg.vocab_size * 2, name="wide")
    with pytest.raises(ValueError, match="tokenizer"):
        treg.check_draft_compat(tcfg, bad)
    with pytest.raises(ValueError, match="draft member 'm3'"):
        treg.check_draft_compat(tcfg, bad, member="m3")
    model = tlm.init_lm(tcfg, device="cpu")
    small = tlm.init_lm(bad, device="cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        Scheduler(tcfg, model, device="cpu", num_slots=1, max_len=16,
                  draft_params=small, spec_tokens=2, draft_cfg=bad)
    from repro_torch.checkpoint import ckpt

    like = bridge.params_to_jax_layout(small, bad)
    path = str(tmp_path / "draft.ckpt")
    ckpt.save(path, {"params": like}, metadata={})
    with pytest.raises(ValueError, match="tokenizer-incompatible"):
        treg.load_draft(path, like, expect_vocab=tcfg.vocab_size)


def test_smaller_draft_arch_serves_identical_tokens():
    """A drafter of fewer layers (its own config, pool and weights) serves
    the target-only tokens, as JAX's test of it asks."""
    jcfg, _, model = _weights("qwen3-0.6b", 0)
    tsmall = replace(model.cfg, num_layers=1, name="qwen3-draft")
    small = tlm.init_lm(tsmall, seed=3, device="cpu")
    reqs = _reqs(jcfg.vocab_size, lens=(6, 6))
    base, _ = _serve_port(model, reqs, max_len=32)
    spec, ts = _serve_port(model, reqs, draft=small, k=3, draft_cfg=tsmall,
                           max_len=32)
    assert spec == base
    assert len(ts.draft.model.blocks) == 1
    assert ts.draft.layout.cfg is tsmall
    assert ts.stats.spec_rounds > 0


def _population(root, jcfg, keys_by_step):
    """A population in JAX's layout written by the JAX package: step s
    holds trainers initialised from ``keys_by_step[s]``, trainer 1 with
    the most wins."""
    jax = _jax()
    from repro.checkpoint import ckpt as jckpt

    for step, keys in keys_by_step.items():
        trainers = [{"params": _jax_init(jcfg)(jax.random.PRNGKey(key)),
                     "opt_state": {}, "hparams": {"lr": 1e-3},
                     "steps": step, "alive": True, "wins": i,
                     "adoptions": 0} for i, key in enumerate(keys)]
        jckpt.save_population(root, step, {"round": step,
                                           "trainers": trainers})
    return root


@pytest.mark.parametrize("step", [None, 2])
def test_load_draft_from_a_population_equals_jax(tmp_path, step):
    """``load_draft`` on a population directory takes the earliest step
    by default (``step`` picks another), exports its winner on demand,
    and restores the JAX package's ``load_draft`` tree leaf for leaf."""
    jax = _jax()
    from repro.serve import registry as jreg
    from repro_torch import bridge
    from repro_torch.bridge import params_from_jax

    jcfg, jlike, model = _weights("qwen3-0.6b", 0)
    root = _population(str(tmp_path / "pop"), jcfg, {1: (3, 4), 2: (5, 6)})
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(root, jdir)
    shutil.copytree(root, tdir)
    jparams, jinfo = jreg.load_draft(jdir, jlike, step=step,
                                     expect_vocab=jcfg.vocab_size)
    tparams, tinfo = treg.load_draft(
        tdir, bridge.params_to_jax_layout(model, model.cfg), step=step,
        expect_vocab=model.cfg.vocab_size,
        from_ckpt=lambda tree: params_from_jax(tree, model.cfg))
    want_step = step or 1
    assert tinfo["step"] == jinfo["step"] == want_step
    assert tinfo["trainer"] == jinfo["trainer"] == 1
    assert os.path.exists(treg.winner_path(tdir, want_step))
    want = params_from_jax(jax.tree.map(np.asarray, jparams), model.cfg)
    assert sorted(tparams) == sorted(want)
    for n, t in want.items():
        assert torch.equal(tparams[n], t), n


# ---------------------------------------------------------------------------
# rollback: snapshot / restore, and the K-token recurrent decode
# ---------------------------------------------------------------------------


def _session(arch, slots=2, key=0):
    _, _, model = _weights(arch, key)
    layout = PagedLayout(model.cfg, slots, 16, block_size=4, device="cpu")
    return DecodeSession(model.cfg, model, layout)


def _prefilled(sess, lens):
    prompts = _prompts(sess.cfg.vocab_size, lens, seed=3)
    for i, p in enumerate(prompts):
        sess.layout.admit(i, len(p) + 8)
        sess.prefill(i, p)
        sess.layout.ensure(i, len(p) + 8)
    return np.asarray([len(p) for p in prompts], np.int32)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m"])
def test_snapshot_restore_roundtrip(arch):
    """snapshot, step, step again, restore row 0 and replay it: its logits
    come back within 1e-5; row 1, not restored, has moved on."""
    sess = _session(arch)
    index = _prefilled(sess, (6, 6))
    snap = sess.snapshot()
    assert len(snap) > 0 and sess.layout.has_recurrent
    feed = _prompts(sess.cfg.vocab_size, (1, 1), seed=4)
    feed = np.stack(feed)
    first = sess.step(feed, index).numpy()
    sess.step(feed + 1, index + 1)
    sess.restore(snap, np.asarray([True, False]))
    again = sess.step(feed, index, valid=np.asarray([1, 0], np.int32))
    np.testing.assert_allclose(again[0].numpy(), first[0], atol=1e-5,
                               rtol=1e-5)
    assert not np.allclose(again[1].numpy(), first[1], atol=1e-5)


def test_snapshot_is_a_copy_not_a_view():
    """The decode step writes the state rows in place: a snapshot taken
    before three steps is unchanged after them; an attention-only stack's
    snapshot is empty."""
    sess = _session("xlstm-125m", slots=1)
    index = _prefilled(sess, (6,))
    snap = sess.snapshot()
    before = [s.clone() for s in snap]
    leaves = [sess.layout.cache[i][k] for i, k in sess.layout._rec_leaves]
    for t in range(3):
        sess.step(np.asarray([[5]], np.int32), index + t)
    for b, s, leaf in zip(before, snap, leaves):
        assert torch.equal(b, s)
        assert s.data_ptr() != leaf.data_ptr()
    assert any(not torch.equal(b, leaf) for b, leaf in zip(before, leaves))
    assert _session("qwen3-0.6b").snapshot() == ()


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-1.5-large-398b"])
def test_k_token_decode_with_valid_matches_jax(arch):
    """``lm_decode`` over K = 3 tokens with ``valid`` = (3, 1) on a
    recurrent stack, through both packages' paged sessions from the same
    prefilled state: equal logits, and a following one-token step equal
    too (row 1's state froze after its first token in both)."""
    jax = _jax()
    from repro.serve.kv_cache import PagedLayout as JPagedLayout
    from repro.serve.session import DecodeSession as JDecodeSession

    jcfg, params, _ = _weights(arch, 0)
    tsess = _session(arch)
    jsess = JDecodeSession(jcfg, params, JPagedLayout(jcfg, 2, 16,
                                                      block_size=4))
    prompts = _prompts(jcfg.vocab_size, (6, 9), seed=3)
    for i, p in enumerate(prompts):
        for sess in (tsess, jsess):
            sess.layout.admit(i, len(p) + 8)
            sess.prefill(i, p)
            sess.layout.ensure(i, len(p) + 8)
    index = np.asarray([6, 9], np.int32)
    toks = np.stack(_prompts(jcfg.vocab_size, (3, 3), seed=5))
    valid = np.asarray([3, 1], np.int32)
    got = tsess.step(toks, index, valid=valid, width=4).numpy()
    want = np.asarray(jsess.step(toks, index, valid=valid, width=4))
    assert got.shape == want.shape == (2, 3, jcfg.vocab_size)
    np.testing.assert_allclose(got, want, **TOL)
    nxt = toks[:, :1]
    index2 = index + valid
    got = tsess.step(nxt, index2, width=4).numpy()
    want = np.asarray(jsess.step(nxt, index2, width=4))
    np.testing.assert_allclose(got, want, **TOL)
    assert jax.tree.leaves(jsess.layout.cache)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_serve_cli_with_a_drafter_matches_the_jax_cli(tmp_path, monkeypatch,
                                                      capsys):
    """``--ckpt-dir POP --draft-ckpt POP --spec-tokens 3 --spec-adapt``:
    the winner of the latest step serves, the earliest step's winner
    drafts, and the port's CLI (``--device cpu --dtype float32``) emits
    the JAX CLI's tokens (its configs cast to f32) and prints the
    drafter and speculative lines."""
    _jax()
    from repro.configs import registry as jregistry
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    jcfg, _, _ = _weights("qwen3-0.6b", 0)
    root = _population(str(tmp_path / "pop"), jcfg, {1: (3, 4), 2: (5, 6)})
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(root, jdir)
    shutil.copytree(root, tdir)
    monkeypatch.setattr(jserve, "get_config", lambda a, smoke=False:
                        dataclasses.replace(jregistry.get_config(a, smoke),
                                            dtype="float32"))
    flags = ["--arch", "qwen3-0.6b", "--smoke", "--spec-tokens", "3",
             "--spec-adapt", "--requests", "4", "--slots", "2",
             "--max-new", "8", "--prompt-lens", "5,9"]
    jout = jserve.run_lm(jserve.build_parser().parse_args(
        flags + ["--ckpt-dir", jdir, "--draft-ckpt", jdir]))
    capsys.readouterr()
    assert tserve.main(flags + ["--ckpt-dir", tdir, "--draft-ckpt", tdir,
                                "--device", "cpu", "--dtype",
                                "float32"]) == 0
    out = capsys.readouterr().out
    for tag in ("[serve] winner: step=2 trainer=1",
                "[serve] drafter: " + tdir, "step=1 trainer=1",
                "spec_tokens=3 fused=True adapt=True",
                "[serve] speculative: rounds=",
                "[serve] spec-adapt per-row K"):
        assert tag in out, tag
    tout = tserve.run_lm(tserve.build_parser().parse_args(
        flags + ["--ckpt-dir", tdir, "--draft-ckpt", tdir, "--device",
                 "cpu", "--dtype", "float32"]))
    assert {k: v.tolist() for k, v in tout["results"].items()} == \
        {k: v.tolist() for k, v in jout["results"].items()}
    for k in SPEC_COUNTERS:
        assert tout["stats"][k] == jout["stats"][k], k


def test_serve_cli_refuses_the_arena_and_implies_four_spec_tokens(
        tmp_path, monkeypatch):
    """``--arena`` and ``--draft-ckpt`` without ``--spec-tokens`` each
    speculate four tokens a round, as in JAX, and an explicit
    ``--spec-tokens`` stands."""
    from repro_torch.launch import serve as tserve

    seen = []

    def fake_run_lm(args):
        seen.append(args.spec_tokens)
        return {}

    monkeypatch.setattr(tserve, "run_lm", fake_run_lm)
    for flags in (["--draft-ckpt", str(tmp_path)],
                  ["--arena", str(tmp_path)],
                  ["--arena", str(tmp_path), "--spec-tokens", "2"]):
        assert tserve.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                            "cpu", *flags]) == 0
    assert seen == [4, 4, 2]


def test_scheduler_refuses_a_verify_wider_than_the_kernel(monkeypatch):
    """On the card (its presence mocked here, so nothing is allocated) a
    verify of K+1 tokens at g query heads per KV head needs (K+1) g of
    the paged kernel's 64 rows: K = 8 at g = 8 raises with both numbers
    before anything is built; the CPU's plain version takes any K."""
    from repro_torch.kernels.paged_attention import MAX_ROWS

    _, tcfg = _cfgs("qwen3-0.6b")
    cfg = replace(tcfg, num_heads=16, num_kv_heads=2)       # g = 8
    model = tlm.init_lm(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=f"72 .*at most {MAX_ROWS}"):
        Scheduler(cfg, model, device="cuda:0", draft_params=model,
                  spec_tokens=8, **KW)
    with pytest.raises(ValueError, match="spec_tokens > 0 needs"):
        Scheduler(cfg, model, device="cpu", spec_tokens=2, **KW)
    monkeypatch.undo()
    s = Scheduler(cfg, model, device="cpu", draft_params=model,
                  spec_tokens=8, **KW)
    assert s.spec_tokens == 8


def test_hot_swap_changes_only_the_target():
    """``set_params`` on a scheduler whose self drafter shares the
    target's model: the target takes the new weights, the drafter keeps
    the old ones, and the tokens still equal target-only decoding on the
    new weights."""
    jcfg, _, model = _weights("qwen3-0.6b", 0)
    _, _, other = _weights("qwen3-0.6b", 11)
    target = tlm.init_lm(model.cfg, device="cpu")
    target.load_state_dict(model.state_dict())
    s = Scheduler(target.cfg, target, device="cpu", draft_params=target,
                  spec_tokens=3, **KW)
    s.set_params(other.state_dict())
    assert s.draft.model is not target
    assert torch.equal(s.draft.model.embed.weight, model.embed.weight)
    assert torch.equal(target.embed.weight, other.embed.weight)
    reqs = _reqs(jcfg.vocab_size, lens=(6,))
    for r in reqs:
        s.submit(Request(**r))
    got = {k: v.tolist() for k, v in s.run(max_steps=200).items()}
    assert got == _serve_port(other, reqs)[0]


# ---------------------------------------------------------------------------
# on the card: the paged kernel at the verify shapes
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("H,Hkv,K,dtype", [
    (16, 2, 5, "bfloat16"),     # qwen2.5-3b, K = 4 proposals + 1
    (16, 2, 8, "bfloat16"),     # qwen2.5-3b at the kernel's 64 rows
    (16, 8, 5, "bfloat16"),     # qwen3-0.6b
    (16, 8, 5, "float32"),
])
def test_paged_kernel_at_verify_shapes_on_card(H, Hkv, K, dtype):
    """The paged-attention kernel over K query tokens a row against its
    plain version on the card, lengths 114-499 and an idle row, within
    f32 2e-5 / bf16 2e-2 (``chip_smoke.py``'s ``TOL``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(K)
    lengths = [114, 499, 256, 300, 128, 200, 411, 1]
    bs, D, B = 16, 128, len(lengths)
    W = -(-(max(lengths) + K - 1) // bs)
    P = B * W
    q = torch.randn((B, K, H, D), generator=gen, device="cuda").to(dt)
    kp = torch.randn((P + 1, bs, Hkv, D), generator=gen,
                     device="cuda").to(dt)
    vp = torch.randn_like(kp)
    tables = torch.randperm(P, generator=gen, device="cuda").to(
        torch.int32).reshape(B, W).contiguous()
    tables[-1] = P                                   # an idle row
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = pa.paged_attention(q, kp, vp, tables, lens)
    want = ref.paged_attention_ref(q, kp, vp, tables, lens)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol + tol * want.float().abs()).all()), \
        err.max().item()


@pytest.mark.cuda
def test_spec_scheduler_on_card_matches_cpu():
    """A speculative run on the card (the paged kernel in its verify form)
    gives the CPU's tokens at f32, and launched the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.kernels import paged_attention as pa

    cfg = replace(get_config("qwen3-0.6b", smoke=True), dtype="float32")
    cpu_model = tlm.init_lm(cfg, device="cpu")
    prompts = _prompts(cfg.vocab_size, (5, 9, 13))
    results = {}
    for device in ("cpu", "cuda"):
        model = tlm.init_lm(cfg, device=device)
        model.load_state_dict(cpu_model.state_dict())
        s = Scheduler(cfg, model, device=device, draft_params=model,
                      spec_tokens=3, **KW)
        for i, p in enumerate(prompts):
            s.submit(Request(rid=i, prompt=p, max_new=6))
        before = pa.paged_attention.launches
        results[device] = {k: v.tolist() for k, v in s.run().items()}
    assert results["cuda"] == results["cpu"]
    assert pa.paged_attention.launches > before
