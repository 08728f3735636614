"""The port's dense slot layout and batch engine against the JAX package.

Both packages serve SMOKE configs at f32 on the CPU with the same weights
(carried across by ``repro_torch.bridge``) over ``layout="dense"``: slot
rows of ``max_len`` tokens, prompts right-padded to their pow2 bucket on
attention-only stacks and prefilled at exact length on recurrent ones.
Tokens must be identical to the JAX scheduler's (continuous and static,
greedy and T = 0.8, with and without a K = 2 self drafter) and to the
JAX engine's greedy ``generate``; the pool's and the step counters must
match.  The dense ``lm_decode`` logits agree with JAX's within 1e-5,
including a K = 3 row one token short of ``max_len`` (JAX drops the two
writes past it) and a 5-token prompt padded to 8.  The JAX sides run
under ``jax.jit``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.registry import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch.bridge import load_jax_params
from repro_torch.configs.base import replace
from repro_torch.configs.registry import get_config
from repro_torch.models import lm as tlm
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request, Scheduler

ARCHS = ("qwen3-0.6b", "xlstm-125m", "jamba-1.5-large-398b")
KW = dict(num_slots=2, max_len=24, block_size=4, layout="dense")
STEP_COUNTERS = ("completed", "prefills", "prefill_chunks", "prefill_tokens",
                 "padded_prefill_tokens", "decode_steps", "decode_tokens",
                 "decode_slot_steps", "spec_rounds", "spec_draft_steps",
                 "spec_draft_proposed", "spec_draft_accepted",
                 "spec_replays")
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _serving_runs_without_gradients():
    with torch.no_grad():
        yield


def _cfgs(arch):
    """(JAX config, port config), SMOKE at f32; jamba without experts
    (``NOEXP``: the port serves its MoE layers only dropless at full
    width, as the recurrent tests do)."""
    j = dataclasses.replace(jax_get_config(arch, smoke=True),
                            dtype="float32")
    t = replace(get_config(arch, smoke=True), dtype="float32")
    if arch.startswith("jamba"):
        j, t = dataclasses.replace(j, moe=None), replace(t, moe=None)
    return j, t


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """JAX weights of ``arch`` (PRNGKey 0) and a port model holding
    them."""
    jcfg, tcfg = _cfgs(arch)
    params = jax.jit(lambda k: jlm.init_lm(jcfg, k)[0])(
        jax.random.PRNGKey(0))
    model = tlm.init_lm(tcfg, seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, model


def _reqs(vocab, lens=(5, 12, 12), max_new=6, temperature=0.0):
    rng = np.random.default_rng(3)
    return [dict(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                 max_new=max_new, temperature=temperature,
                 seed=None if temperature <= 0 else 50 + i)
            for i, n in enumerate(lens)]


def _serve_both(arch, reqs, **kw):
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler

    jcfg, params, model = _weights(arch)
    spec = {}
    if kw.pop("self_draft", False):
        spec = dict(spec_tokens=2)
    js = JScheduler(jcfg, params, telemetry=False,
                    draft_params=params if spec else None, **spec,
                    **{**KW, **kw})
    ts = Scheduler(model.cfg, model, device="cpu",
                   draft_params=model if spec else None, **spec,
                   **{**KW, **kw})
    for r in reqs:
        js.submit(JRequest(**r))
        ts.submit(Request(**r))
    jres, tres = js.run(max_steps=400), ts.run(max_steps=400)
    assert sorted(tres) == sorted(jres) == [r["rid"] for r in reqs]
    for rid in jres:
        assert tres[rid].tolist() == jres[rid].tolist(), rid
    assert ts.pool.as_dict() == js.pool.as_dict()
    jd, td = js.stats.as_dict(), ts.stats.as_dict()
    for k in STEP_COUNTERS:
        assert td[k] == jd[k], k
    return ts


@pytest.mark.parametrize("policy", ["continuous", "static"])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_scheduler_token_identity_with_jax(arch, temperature, policy):
    """Three requests over two dense slots: the same tokens, pool and
    step counters as JAX's ``Scheduler(layout="dense")``.  An
    attention-only stack pads each prompt to its bucket (5 -> 8, 12 ->
    16), a recurrent one prefills at the exact length."""
    jcfg = _weights(arch)[0]
    ts = _serve_both(arch, _reqs(jcfg.vocab_size, temperature=temperature),
                     policy=policy)
    padded = ts.stats.as_dict()["padded_prefill_tokens"]
    assert padded == (40 if ts._can_pad else 29)
    assert not ts.prefix_sharing and ts._idle_index == 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_dense_speculative_self_drafter_matches_jax(arch):
    """K = 2 with the target as its own drafter (a mirror slot pool):
    tokens, pool and speculative counters equal JAX's.  Rows near the
    end of a round write past their reservation (masked), and jamba's
    recurrent rows roll back."""
    jcfg = _weights(arch)[0]
    ts = _serve_both(arch, _reqs(jcfg.vocab_size, max_new=7),
                     self_draft=True)
    assert ts.stats.as_dict()["spec_rounds"] > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "xlstm-125m"])
def test_engine_generate_greedy_matches_jax(arch):
    """``Engine.generate`` over a uniform (2, 6) batch, 5 steps, greedy:
    the JAX engine's tokens."""
    from repro.serve.engine import Engine as JEngine

    jcfg, params, model = _weights(arch)
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    want = np.asarray(JEngine(jcfg, params, max_len=16).generate(
        jnp.asarray(toks), 5))
    eng = Engine(model.cfg, model, max_len=16)
    got = eng.generate(toks, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    # the session (and its rows) is kept for the batch size
    np.testing.assert_array_equal(eng.generate(toks, 5).numpy(), want)
    assert len(eng._sessions) == 1


def test_engine_refuses_sampling_without_a_generator_and_a_mesh():
    _, _, model = _weights("qwen3-0.6b")
    eng = Engine(model.cfg, model, max_len=16)
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError, match="Generator"):
        eng.generate(toks, 2, temperature=0.7)
    gen = torch.Generator().manual_seed(0)
    out = eng.generate(toks, 3, temperature=0.7, generator=gen)
    assert out.shape == (1, 7) and bool((out[:, :4] == 0).all())
    # a serving mesh: its data axis serves (the same tokens), its model
    # axis spans process ranks and is refused in one process, naming the
    # distributed CLI
    from repro_torch.launch.mesh import RankLayoutError
    from repro_torch.serve.mesh import ServeMesh
    on_mesh = Engine(model.cfg, model, max_len=16, mesh=ServeMesh(1))
    assert torch.equal(on_mesh.generate(toks, 3), eng.generate(toks, 3))
    with pytest.raises(RankLayoutError,
                       match=r"repro_torch\.launch\.distributed"):
        Engine(model.cfg, model, mesh=ServeMesh(1, 2))
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(toks, 13)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_dense_prefill_and_decode_logits_match_jax(arch):
    """``lm_prefill_dense`` of a (3, 8) batch read at ``last_pos`` (a
    5-token prompt in bucket 8 among them), the cache copied into rows of
    12, then a K = 3 ``lm_decode``: row 2 sits at index 11, one token
    short of ``max_len``, so JAX drops two of its writes.  Logits and
    the rows after the step within 1e-5 of JAX's."""
    from repro_torch.serve.kv_cache import SlotLayout

    jcfg, params, model = _weights(arch)
    rng = np.random.default_rng(9)
    B, L, ML = 3, 8, 12
    toks = rng.integers(0, jcfg.vocab_size, (B, L)).astype(np.int32)
    last = np.array([4, 7, 6], np.int32)
    if not all(s.kind == "a" for s in tlm.layer_specs(model.cfg)):
        last = np.full((B,), L - 1, np.int32)   # recurrent: exact length
    jl, jc = jax.jit(lambda p, t, lp: jlm.lm_prefill(
        p, jcfg, {"tokens": t}, last_pos=lp))(params, jnp.asarray(toks),
                                              jnp.asarray(last))
    tl, tc = tlm.lm_prefill_dense(model, torch.from_numpy(toks).long(),
                                  torch.from_numpy(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jcache, _ = jlm.init_cache(jcfg, B, ML)
    jcache = jax.tree.map(
        lambda d, s: d.at[:, :, :s.shape[2]].set(s) if d.ndim == 5 else s,
        jcache, jc)
    layout = SlotLayout(model.cfg, B, ML, device="cpu")
    layout.insert_batch(tc)
    index = np.array([5, 8, ML - 1], np.int32)
    nxt = rng.integers(0, jcfg.vocab_size, (B, 3)).astype(np.int32)
    jd, jc2 = jax.jit(lambda p, t, c, i: jlm.lm_decode(p, jcfg, t, c, i))(
        params, jnp.asarray(nxt), jcache, jnp.asarray(index))
    td = tlm.lm_decode(model, torch.from_numpy(nxt).long(), layout.cache,
                       torch.from_numpy(index).long())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **LOGIT_TOL)
    specs = tlm.layer_specs(model.cfg)
    k0, R, P = tlm.grouping(model.cfg)
    for i, spec in enumerate(specs):
        if spec.kind != "a":
            continue
        j, p = (i - k0) % R, (i - k0) // R
        for name in ("k", "v"):
            np.testing.assert_allclose(
                layout.cache[i][name].numpy(),
                np.asarray(jc2["body"][j][name][p]), **LOGIT_TOL)


def test_slot_layout_rows_are_overwritten_on_reuse():
    """A slot's second occupant sees no K/V of the first past its own
    prompt (zeros, as JAX pads its prefill cache to the row), and
    admission obeys ``max_len`` and the block budget."""
    from repro_torch.serve.kv_cache import SlotLayout
    from repro_torch.serve.session import DecodeSession

    _, _, model = _weights("qwen3-0.6b")
    layout = SlotLayout(model.cfg, 1, 16, block_size=4, device="cpu")
    sess = DecodeSession(model.cfg, model, layout)
    assert layout.admit("a", 16) == 0 and not layout.can_admit(4)
    sess.prefill("a", np.arange(1, 13, dtype=np.int32))
    assert layout.release("a") == 0
    assert not layout.can_admit(17)
    layout.admit("b", 8)
    sess.prefill("b", np.arange(1, 4, dtype=np.int32), bucket=4)
    k = layout.cache[0]["k"]
    assert bool((k[0, 4:] == 0).all()) and bool((k[0, :4] != 0).any())
    d = layout.as_dict()
    assert (d["num_slots"], d["max_len"], d["free_slots"]) == (1, 16, 0)
    assert d["block_allocs"] == 4 + 2 and d["block_frees"] == 4


def test_dense_scheduler_refuses_a_max_seq_other_than_max_len():
    _, _, model = _weights("qwen3-0.6b")
    with pytest.raises(ValueError, match="max_len"):
        Scheduler(model.cfg, model, device="cpu", layout="dense",
                  max_len=24, max_seq=32)


def test_serve_cli_layout_dense_and_pin_prefix_on_cpu(capsys):
    """``--layout dense`` serves the trace with no prefix-cache line (as
    the JAX launcher prints it only for paged); ``--pin-prefix`` keeps a
    paged run's prompt pages pinned."""
    from repro_torch.launch import serve as tserve

    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "3", "--prompt-lens", "5,9",
            "--block-size", "4"]
    out = tserve.run_lm(tserve.build_parser().parse_args(
        argv + ["--layout", "dense"]))
    text = capsys.readouterr().out
    assert "layout=dense" in text and "[serve] prefix-cache" not in text
    assert out["pool"]["max_len"] == 12 and out["stats"]["completed"] == 3
    dense = out["results"]
    out = tserve.run_lm(tserve.build_parser().parse_args(
        argv + ["--pin-prefix", "--dtype", "float32"]))
    text = capsys.readouterr().out
    assert "[serve] prefix-cache:" in text and out["pool"]["pinned_blocks"] > 0
    out = tserve.run_lm(tserve.build_parser().parse_args(
        argv + ["--dtype", "float32"]))
    capsys.readouterr()
    # the f32 paged run serves the dense run's tokens once both are f32
    f32_dense = tserve.run_lm(tserve.build_parser().parse_args(
        argv + ["--layout", "dense", "--dtype", "float32"]))["results"]
    assert {k: v.tolist() for k, v in f32_dense.items()} == \
        {k: v.tolist() for k, v in out["results"].items()}
    assert set(dense) == {0, 1, 2}
