"""The port's recurrent families against the JAX package at f32 on the CPU.

xlstm-125m SMOKE (an mLSTM and an sLSTM block) and jamba SMOKE without
experts (``MMaM``: Mamba blocks around one attention block, dense SwiGLU
FFNs) on both sides, with the JAX weights carried across by
``repro_torch.bridge``; inputs are made with numpy.  Blocks, decode steps
and the full forward agree at atol = rtol = 1e-4 (f32; the two frameworks
sum in different orders); the schedulers must emit identical tokens.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import jamba_15_large as jax_jamba
from repro.configs import xlstm_125m as jax_xlstm
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro_torch.bridge import load_jax_params, params_from_jax
from repro_torch.configs import jamba_15_large, xlstm_125m
from repro_torch.configs.base import replace
from repro_torch.configs.registry import get_config
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl

TOL = dict(atol=1e-4, rtol=1e-4)
STEP_COUNTERS = ("completed", "prefills", "prefill_chunks", "prefill_tokens",
                 "padded_prefill_tokens", "decode_steps", "decode_tokens",
                 "decode_slot_steps", "ragged_splits")
# (JAX config, port config) pairs at f32
CONFIGS = {
    "xlstm": (dataclasses.replace(jax_xlstm.SMOKE, dtype="float32"),
              replace(xlstm_125m.SMOKE, dtype="float32")),
    "jamba": (dataclasses.replace(jax_jamba.SMOKE, moe=None, dtype="float32"),
              replace(jamba_15_large.SMOKE, moe=None, dtype="float32")),
}


@pytest.fixture(autouse=True)
def _serving_runs_without_gradients():
    with torch.no_grad():
        yield


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_init(cfg, key):
    return jlm.init_lm(cfg, key)[0]


@functools.lru_cache(maxsize=None)
def _both(family):
    """JAX smoke weights at f32 and the port's model loaded with them."""
    jcfg, tcfg = CONFIGS[family]
    params = _jax_init(jcfg, jax.random.PRNGKey(0))
    model = tlm.init_lm(tcfg, seed=0, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, model


def _layer(params, j):
    """The JAX mixer weights of the first layer of period position j."""
    return jax.tree.map(lambda a: a[0], params["body"][j]["mixer"])


def _np(x):
    return np.asarray(x) if not torch.is_tensor(x) else x.numpy()


def _states_match(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("family", ["xlstm", "jamba"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_jax_field_by_field(family, smoke):
    """Every field, sub-configs included, equals the JAX package's."""
    arch = {"xlstm": "xlstm-125m", "jamba": "jamba-1.5-large-398b"}[family]
    mod = {"xlstm": jax_xlstm, "jamba": jax_jamba}[family]
    mine, ref = get_config(arch, smoke=smoke), \
        (mod.SMOKE if smoke else mod.FULL)
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert mine.layer_kinds() == ref.layer_kinds()
    assert [mine.is_moe_layer(i) for i in range(mine.num_layers)] == \
        [ref.is_moe_layer(i) for i in range(ref.num_layers)]
    assert tlm.layer_specs(mine) == tuple(tuple(s) for s in
                                          jlm.layer_specs(ref))
    assert tlm.grouping(mine) == jlm._grouping(ref)


def test_moe_layers_raise_naming_the_roadmap():
    """The published jamba config keeps its experts: SMOKE builds with its
    MoE layers, whose layer specs equal JAX's; the served cut has none."""
    smoke = get_config("jamba-1.5-large-398b", smoke=True)
    model = tlm.init_lm(smoke, device="cpu")
    assert tlm.layer_specs(smoke) == tuple(
        tuple(s) for s in jlm.layer_specs(jax_jamba.SMOKE))
    assert [b.ffn_kind for b in model.blocks] == [
        s.ffn for s in jlm.layer_specs(jax_jamba.SMOKE)] == \
        ["dense", "moe", "dense", "moe"]
    served = jamba_15_large.NOEXP_8L
    assert served.moe is None and served.layer_kinds() == tuple("MMMMaMMM")
    assert all(s.ffn == "dense" and s.d_ff == 24576
               for s in tlm.layer_specs(served))


@pytest.mark.parametrize("family", ["xlstm", "jamba"])
def test_bridge_loads_every_jax_weight(family):
    jcfg, params, model = _both(family)
    tree = jax.tree.map(np.asarray, params)
    sd = params_from_jax(tree, model.cfg)
    assert set(sd) == set(model.state_dict())
    # jamba SMOKE's period is MMaM (R = 4, P = 1): layer 2 is body[2][0]
    j = 1 if family == "xlstm" else 2
    name = {"xlstm": "mixer.w_x", "jamba": "mixer.wq"}[family]
    np.testing.assert_array_equal(
        model.state_dict()[f"blocks.{j}.{name}.weight"].numpy(),
        tree["body"][j]["mixer"][name.split(".")[1]][0].T)


def test_mamba_core_and_decode_match_jax():
    """Output == ``ssm.mamba_prefill``; the state after S = 20 steps ==
    JAX's ``mamba_decode`` stepped token by token; one decode step from a
    random state == JAX's, output and state."""
    jcfg, params, model = _both("jamba")
    p, mixer = _layer(params, 0), model.blocks[0].mixer
    x = _x((2, 20, jcfg.d_model), 1)

    @jax.jit
    def jax_side(x):
        out, _ = jssm.mamba_prefill(p, jcfg, x)
        state, _ = jssm.init_mamba_state(jcfg, x.shape[0])
        stepped, _ = jax.lax.scan(
            lambda st, xt: (jssm.mamba_decode(p, jcfg, xt[:, None], st)[1],
                            None), state, x.swapaxes(0, 1))
        return out, stepped

    want, stepped = jax_side(jnp.asarray(x))
    out, state = tssm.mamba_core(mixer, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    _states_match(state, stepped)

    d_in = 2 * jcfg.d_model
    st = {"ssm": _x((2, d_in, jcfg.mamba.d_state), 2),
          "conv": _x((2, jcfg.mamba.d_conv - 1, d_in), 3)}
    x1 = _x((2, 1, jcfg.d_model), 4)
    want, want_st = jax.jit(lambda x, s: jssm.mamba_decode(p, jcfg, x, s))(
        jnp.asarray(x1), jax.tree.map(jnp.asarray, st))
    out, new = tssm.mamba_decode(
        mixer, torch.from_numpy(x1),
        {k: torch.from_numpy(v) for k, v in st.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    _states_match(new, want_st)


def test_jax_mamba_prefill_state_is_wrong_past_a_padded_chunk():
    """The reference fault at S = 130 (JAX pads to 256 steps, and a pad
    step's dt = softplus(dt_bias) ~ 0.01 decays the state): the JAX
    ``mamba_prefill`` state differs from its own stepped ``mamba_decode``,
    while the port's equals the stepped one.  Both outputs agree."""
    jcfg, params, model = _both("jamba")
    p, mixer = _layer(params, 0), model.blocks[0].mixer
    x = _x((1, 130, jcfg.d_model), 5)

    @jax.jit
    def jax_side(x):
        out, st = jssm.mamba_prefill(p, jcfg, x)
        state, _ = jssm.init_mamba_state(jcfg, 1)
        stepped, _ = jax.lax.scan(
            lambda st, xt: (jssm.mamba_decode(p, jcfg, xt[:, None], st)[1],
                            None), state, x.swapaxes(0, 1))
        return out, st["ssm"], stepped["ssm"]

    want, jax_ssm, stepped = map(np.asarray, jax_side(jnp.asarray(x)))
    out, state = tssm.mamba_core(mixer, torch.from_numpy(x))
    assert np.abs(jax_ssm - stepped).max() > 1e-2 * np.abs(stepped).max()
    np.testing.assert_allclose(state["ssm"].numpy(), stepped, **TOL)
    np.testing.assert_allclose(out.numpy(), want, **TOL)


def test_mlstm_block_and_decode_match_jax():
    """S = 20 over 16-step chunks (a padded tail chunk): output and the
    (C, n, m) state == ``xlstm.mlstm_block``; one decode step == JAX's."""
    jcfg, params, model = _both("xlstm")
    p, mixer = _layer(params, 0), model.blocks[0].mixer
    x = _x((2, 20, jcfg.d_model), 6)
    want, want_st = jax.jit(lambda x: jxl.mlstm_block(
        p, jcfg, x, return_state=True))(jnp.asarray(x))
    out, state = txl.mlstm_block(mixer, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    _states_match(state, want_st)

    x1 = _x((2, 1, jcfg.d_model), 7)
    want, want_new = jax.jit(lambda x, s: jxl.mlstm_decode(p, jcfg, x, s))(
        jnp.asarray(x1), want_st)
    out, new = txl.mlstm_decode(mixer, torch.from_numpy(x1),
                                {k: torch.from_numpy(np.array(v))
                                 for k, v in want_st.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    _states_match(new, want_new)


def test_slstm_block_and_decode_match_jax():
    """Output and the final (h, c, n, m) == ``xlstm.slstm_block``; one
    decode step (``_slstm_cell``) == JAX's."""
    jcfg, params, model = _both("xlstm")
    p, mixer = _layer(params, 1), model.blocks[1].mixer
    x = _x((2, 20, jcfg.d_model), 8)
    want, want_st = jax.jit(lambda x: jxl.slstm_block(
        p, jcfg, x, return_state=True))(jnp.asarray(x))
    out, state = txl.slstm_block(mixer, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    _states_match(state, want_st)

    x1 = _x((2, 1, jcfg.d_model), 9)
    want, want_new = jax.jit(lambda x, s: jxl.slstm_decode(p, jcfg, x, s))(
        jnp.asarray(x1), want_st)
    out, new = txl.slstm_decode(mixer, torch.from_numpy(x1),
                                {k: torch.from_numpy(np.array(v))
                                 for k, v in want_st.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    _states_match(new, want_new)


@pytest.mark.parametrize("family", ["xlstm", "jamba"])
def test_lm_forward_matches_jax(family):
    jcfg, params, model = _both(family)
    toks = np.random.default_rng(10).integers(
        0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    want = jax.jit(lambda p, t: jlm.lm_forward(p, jcfg, {"tokens": t})[0])(
        params, jnp.asarray(toks))
    with torch.no_grad():
        got = tlm.lm_forward(model, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_recurrent_stacks_refuse_gradients_and_chunking():
    """A gradient now flows through a recurrent stack (the scans' backward
    kernels have plain versions on the CPU): finite and nonzero on every
    parameter.  Chunked prefill over recurrent state is not ported and
    raises.  The K-token decode over recurrent state is ported
    (speculative decoding's verify; ``tests/test_torch_spec.py`` holds it
    against JAX): two tokens a row step the state rows and return a logit
    row per token."""
    _, _, model = _both("xlstm")
    with torch.enable_grad():
        toks = torch.arange(8, dtype=torch.long).reshape(2, 4)
        tlm.lm_forward(model, toks).float().square().mean().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert bool(torch.isfinite(p.grad).all()), name
        assert bool((p.grad != 0).any()), name
        p.grad = None
    cache = tlm.init_cache(model.cfg, pages=(4, 4), num_slots=2,
                           device="cpu")
    logits = tlm.lm_decode(model, torch.zeros((2, 2), dtype=torch.long),
                           cache, torch.zeros(2, dtype=torch.long),
                           torch.zeros((2, 1), dtype=torch.int32))
    assert logits.shape == (2, 2, model.cfg.vocab_size)
    with pytest.raises(ValueError, match="attention-only"):
        tlm.lm_prefill(model, torch.zeros((1, 4), dtype=torch.long), [],
                       torch.zeros((1, 1), dtype=torch.int32), 0, 4, 3)


def _requests(vocab, lens, max_new, seed=11):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                 max_new=max_new) for i, n in enumerate(lens)]


@pytest.mark.parametrize("family,lens", [("xlstm", (6, 9, 20)),
                                         ("jamba", (6, 9))])
def test_scheduler_token_identity_with_jax(family, lens):
    """Greedy, f32, 2 slots, 4-token pages: the same tokens as the JAX
    scheduler (exact-length one-shot prefill, state in slot rows), the
    same pool counters and step counters; no prefix sharing, no padding."""
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.serve.scheduler import Request, Scheduler

    jcfg, params, model = _both(family)
    kw = dict(num_slots=2, max_len=28, block_size=4)
    js = JScheduler(jcfg, params, telemetry=False, **kw)
    ts = Scheduler(model.cfg, model, device="cpu", **kw)
    assert not ts._can_pad and not ts.prefix_sharing
    for r in _requests(jcfg.vocab_size, lens, max_new=5):
        js.submit(JRequest(**r))
        ts.submit(Request(**r))
    jres, tres = js.run(max_steps=200), ts.run(max_steps=200)
    assert sorted(tres) == sorted(jres) == list(range(len(lens)))
    for rid in jres:
        assert tres[rid].tolist() == jres[rid].tolist(), rid
    assert ts.pool.as_dict() == js.pool.as_dict()
    jd, td = js.stats.as_dict(), ts.stats.as_dict()
    for k in STEP_COUNTERS:
        assert td[k] == jd[k], k
    assert td["padded_prefill_tokens"] == td["prefill_tokens"] == sum(lens)


def test_long_hybrid_prompt_serves_the_argmax_of_jax_forward():
    """A 200-token prompt (past JAX's 128-step chunk, not a multiple of
    it): every one of the 8 tokens the port serves is the argmax of the
    JAX package's full forward over the served sequence, save top-2 ties
    within 1e-4.  The JAX scheduler is not the yardstick here: its
    ``mamba_prefill`` hands decode a wrongly decayed state at this length
    (see ``test_jax_mamba_prefill_state_is_wrong_past_a_padded_chunk``)."""
    from repro_torch.serve.scheduler import Request, Scheduler

    jcfg, params, model = _both("jamba")
    (req,) = _requests(jcfg.vocab_size, (200,), max_new=8, seed=0)
    ts = Scheduler(model.cfg, model, device="cpu", num_slots=1,
                   max_len=208, block_size=16)
    ts.submit(Request(**req))
    ts.run()
    served = ts.full_sequence(Request(**req))
    logits = np.asarray(jax.jit(
        lambda p, t: jlm.lm_forward(p, jcfg, {"tokens": t})[0])(
            params, jnp.asarray(served[None, :-1])))[0]
    P, checked = 200, 0
    for i in range(8):
        row = logits[P - 1 + i]
        top2 = np.sort(row)[-2:]
        if top2[1] - top2[0] >= 1e-4:
            assert int(row.argmax()) == int(served[P + i]), i
            checked += 1
    assert checked >= 6


def test_serve_cli_serves_xlstm_smoke_on_cpu(capsys):
    from repro_torch.launch import serve as tserve

    out = tserve.run_lm(tserve.build_parser().parse_args(
        ["--arch", "xlstm-125m", "--smoke", "--device", "cpu", "--requests",
         "3", "--max-new", "4", "--prompt-lens", "5,9"]))
    assert "[serve] throughput" in capsys.readouterr().out
    assert out["stats"]["completed"] == 3
    assert out["pool"]["prefix_hits"] == 0
    assert all(len(v) == 4 for v in out["results"].values())

