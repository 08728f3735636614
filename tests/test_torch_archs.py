"""Every arch of the JAX registry resolves in the port, and the archs this
slice adds run as the JAX package runs them, on the CPU.

Configs field by field (FULL and SMOKE); the dense, audio and MoE token
archs at SMOKE in f32 (forward at atol = rtol = 1e-4, the paged scheduler
token-identical to JAX's); qwen2-vl SMOKE (the stub frontend's batch,
M-RoPE, forward, loss and gradients over embeddings, a paged decode step
with text positions, the scheduler's refusal); the train CLI's losses
against JAX's launcher from the same weights; the ltfb CLI over a MoE
arch, and its refusal of the VLM.  Weights come from the JAX package and
cross through ``repro_torch.bridge``; inputs are made with numpy.
"""
import dataclasses
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jbase
from repro.configs import qwen2_vl as jax_vl
from repro.configs import registry as jregistry
from repro.data import tokens as jtokens
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.train import steps as jsteps
from repro_torch.bridge import load_jax_params, params_from_jax
from repro_torch.configs import qwen2_vl
from repro_torch.configs.base import replace
from repro_torch.configs.registry import get_config
from repro_torch.data import tokens as ttokens
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

TOL = dict(atol=1e-4, rtol=1e-4)
STEP_COUNTERS = ("completed", "prefills", "prefill_chunks", "prefill_tokens",
                 "padded_prefill_tokens", "decode_steps", "decode_tokens",
                 "decode_slot_steps", "ragged_splits")
TOKEN_ARCHS = ("qwen2.5-3b", "codeqwen1.5-7b", "granite-8b",
               "musicgen-medium", "deepseek-moe-16b", "phi3.5-moe-42b-a6.6b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_init(cfg, key):
    return jlm.init_lm(cfg, key)[0]


@functools.lru_cache(maxsize=None)
def _both(arch):
    """JAX SMOKE weights at f32 and the port's model loaded with them."""
    jcfg = dataclasses.replace(jregistry.get_config(arch, smoke=True),
                               dtype="float32")
    tcfg = replace(get_config(arch, smoke=True), dtype="float32")
    params = _jax_init(jcfg, jax.random.PRNGKey(0))
    model = load_jax_params(tlm.init_lm(tcfg, device="cpu"), _np(params))
    return jcfg, params, tcfg, model


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", sorted(jregistry.ARCHS))
def test_every_jax_arch_resolves_equal_field_by_field(arch, smoke):
    """``get_config`` resolves every arch of the JAX registry, each field
    (sub-configs included), the derived widths and the parameter counts
    equal to JAX's."""
    mine = get_config(arch, smoke=smoke)
    ref = jregistry.get_config(arch, smoke=smoke)
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    if arch == "icf-cyclegan":
        return
    for prop in ("resolved_head_dim", "q_dim", "kv_dim"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    for active in (False, True):
        assert mine.param_count(active) == ref.param_count(active)
    assert tlm.layer_specs(mine) == tuple(tuple(s) for s in
                                          jlm.layer_specs(ref))
    assert tlm.grouping(mine) == jlm._grouping(ref)


def _requests(vocab, lens, max_new, seed=11):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                 max_new=max_new) for i, n in enumerate(lens)]


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_token_arch_forward_and_scheduler_match_jax(arch):
    """``lm_forward`` == JAX's at 1e-4 (MoE with capacity), and greedy
    serving through the paged scheduler (2 slots, 4-token pages, padded
    one-shot prefills, a shared prefix, MoE dropless) emits the JAX
    scheduler's tokens, with the same pool and step counters."""
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.serve.scheduler import Request, Scheduler

    jcfg, params, tcfg, model = _both(arch)
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    ref = jax.jit(lambda p, t: jlm.lm_forward(p, jcfg, {"tokens": t})[0])(
        params, jnp.asarray(toks))
    with torch.no_grad():
        out = tlm.lm_forward(model, torch.from_numpy(toks).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    kw = dict(num_slots=2, max_len=24, block_size=4)
    js = JScheduler(jcfg, params, telemetry=False, **kw)
    ts = Scheduler(tcfg, model, device="cpu", **kw)
    reqs = _requests(jcfg.vocab_size, (6, 9, 13), max_new=4)
    reqs[2]["prompt"][:8] = reqs[1]["prompt"][:8]    # a shared prefix
    for r in reqs:
        js.submit(JRequest(**r))
        ts.submit(Request(**r))
    jres, tres = js.run(max_steps=200), ts.run(max_steps=200)
    assert sorted(tres) == sorted(jres) == [0, 1, 2]
    for rid in jres:
        assert tres[rid].tolist() == jres[rid].tolist(), rid
    assert ts.pool.as_dict() == js.pool.as_dict()
    jd, td = js.stats.as_dict(), ts.stats.as_dict()
    for k in STEP_COUNTERS:
        assert td[k] == jd[k], k


# ---------------------------------------------------------------------------
# qwen2-vl-7b: the stub frontend's embeddings and M-RoPE
# ---------------------------------------------------------------------------


def test_vlm_train_batch_bit_identical_to_jax():
    for seed in (0, 987654):
        want = jtokens.train_batch(jax_vl.SMOKE, 3, 17, seed=seed)
        got = ttokens.train_batch(qwen2_vl.SMOKE, 3, 17, seed=seed)
        assert set(got) == set(want) == {"embeds", "positions", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert got["positions"].shape == (3, 3, 17)


@pytest.mark.parametrize("sections", [(4, 2, 2), (16, 24, 24)])
def test_mrope_tables_rotate_as_jax_apply_mrope(sections):
    """``apply_rope`` over ``mrope_cos_sin``'s tables == JAX's
    ``apply_mrope`` on random positions of each component, f32 1e-5."""
    D = 2 * sum(sections)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 3, D)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 2, 5)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                               sections)
    cos, sin = tlayers.mrope_cos_sin(torch.from_numpy(pos), D, 1e6,
                                     sections)
    got = tlayers.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="M-RoPE"):
        tlayers.mrope_cos_sin(torch.from_numpy(pos[0]), D, 1e6, sections)


def test_vlm_forward_loss_and_gradients_match_jax():
    """Over ``train_batch``'s embeddings and (3, B, S) positions:
    ``lm_forward``'s logits at 1e-4, then the loss and the gradient of
    every weight == ``jax.value_and_grad`` of ``lm.lm_loss`` at 1e-5 (the
    token embedding gets none: the embeddings replace it)."""
    jcfg, params, tcfg, model = _both("qwen2-vl-7b")
    b = jtokens.train_batch(jcfg, 2, 12, seed=3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
          b.items()}
    (jloss, _), jgrads = jax.jit(lambda p, bb: jax.value_and_grad(
        lambda q: jlm.lm_loss(q, jcfg, bb), has_aux=True)(p))(params, jb)
    jlogits, _ = jax.jit(lambda p, bb: jlm.lm_forward(p, jcfg, bb))(params,
                                                                    jb)
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        logits = tlm.lm_forward(model, None, embeds=tb["embeds"],
                                positions=tb["positions"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    loss, _ = tlm.lm_loss(model, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5,
                               rtol=1e-5)
    want = params_from_jax(_np(jgrads), tcfg)
    for n, p in model.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        np.testing.assert_allclose(got, want[n].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=n)
    with pytest.raises(ValueError, match="M-RoPE"):
        tlm.lm_forward(model, torch.zeros((1, 4), dtype=torch.long))


def test_vlm_decode_with_text_positions_matches_jax():
    """Chunked prefill of a 6-token prompt into the paged pool, then one
    paged decode step: text positions broadcast to all three M-RoPE
    components on both sides; logits at 1e-4."""
    jcfg, params, tcfg, model = _both("qwen2-vl-7b")
    prompt = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (1, 8)).astype(np.int32)
    prompt[0, 6:] = 0                              # right-padded chunk
    tables = np.asarray([[2, 0, 4]], np.int32)      # page 4 is null
    jcache, _ = jlm.init_cache(jcfg, 1, pages=(4, 4))
    jpre, jcache = jax.jit(lambda p, c: jlm.lm_prefill(
        p, jcfg, {"tokens": jnp.asarray(prompt)}, last_pos=jnp.asarray([5]),
        cache=c, tables=jnp.asarray(tables), hist_len=jnp.int32(0),
        prompt_len=jnp.int32(6)))(params, jcache)
    nxt = np.asarray([[int(np.asarray(jpre)[0, -1].argmax())]], np.int32)
    jdec, _ = jax.jit(lambda p, c: jlm.lm_decode(
        p, jcfg, jnp.asarray(nxt), c, jnp.asarray([6]),
        tables=jnp.asarray(tables)))(params, jcache)
    cache = tlm.init_cache(tcfg, pages=(4, 4), device="cpu")
    t_tables = torch.from_numpy(tables)
    with torch.no_grad():
        pre = tlm.lm_prefill(model, torch.from_numpy(prompt).long(), cache,
                             t_tables, 0, 6, 5)
        dec = tlm.lm_decode(model, torch.from_numpy(nxt).long(), cache,
                            torch.tensor([6]), t_tables)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), **TOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), **TOL)


def test_vlm_is_refused_by_the_scheduler_and_the_ltfb_cli():
    """Both schedulers refuse a vlm (its prompts would be embeddings) with
    the same ValueError; the ltfb CLI, whose token shards hold no
    embeddings, raises naming the ROADMAP queue, where JAX's model fails
    on token positions in ``apply_mrope``."""
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.launch import ltfb as tltfb
    from repro_torch.serve.scheduler import Scheduler

    jcfg, params, tcfg, model = _both("qwen2-vl-7b")
    with pytest.raises(ValueError, match="token-input") as jerr:
        JScheduler(jcfg, params, telemetry=False)
    with pytest.raises(ValueError, match="token-input") as terr:
        Scheduler(tcfg, model, device="cpu")
    assert str(terr.value) == str(jerr.value)
    toks = jnp.zeros((1, 4), jnp.int32)
    with pytest.raises(ValueError):
        jlm.lm_loss(params, jcfg, {"tokens": toks, "labels": toks})
    with pytest.raises(NotImplementedError, match="ROADMAP.*A15"):
        tltfb.main(["--arch", "qwen2-vl-7b", "--smoke", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the train and ltfb CLIs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen2-vl-7b"])
def test_train_cli_losses_match_the_jax_launcher(arch, tmp_path, capsys):
    """Both train CLIs resume the same JAX initial state (``step_0.ckpt``,
    bf16 weights as the SMOKE config keeps them) and take 3 steps on the
    same batches: every printed loss and the validation loss agree to one
    bf16 rounding (2**-8 relative): both sides hold bf16 weights and
    activations and round in different orders, which moves a routing
    choice or a dropped pair now and then (the f32 parity of the same
    steps is held at 1e-5 in ``test_torch_moe.py``)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    jcfg = jregistry.get_config(arch, smoke=True)
    state, _ = jsteps.init_lm_state(jcfg, jbase.OptimizerConfig(),
                                    jax.random.PRNGKey(0))
    jckpt.save(str(tmp_path / "step_0.ckpt"), state, {"step": 0})
    argv = ["--arch", arch, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    pattern = re.compile(r"(?:loss|val)=([-\d.]+)")
    capsys.readouterr()
    jtrain.main(argv)
    want = [float(v) for v in pattern.findall(capsys.readouterr().out)]
    ttrain.main([*argv, "--device", "cpu"])
    text = capsys.readouterr().out
    got = [float(v) for v in pattern.findall(text)]
    assert "resumed from" in text and "active=" in text
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)


def test_ltfb_cli_runs_lm_tournaments_over_a_moe_arch(tmp_path, capsys):
    """Two deepseek SMOKE trainers, 2 rounds of 2 steps over token shards:
    finite losses, a population checkpoint in JAX's layout (the dense
    prefix and the expert stacks) that a rerun resumes."""
    from repro_torch.launch import ltfb as tltfb

    argv = ["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
            "--trainers", "2", "--rounds", "2", "--steps-per-round", "2",
            "--batch", "4", "--seq", "16", "--samples", "96",
            "--samples-per-file", "32", "--data-dir", str(tmp_path / "d"),
            "--ckpt-dir", str(tmp_path / "p")]
    assert tltfb.main(argv) == 0
    text = capsys.readouterr().out
    vals = [float(v) for v in re.findall(r"best_val=([-\d.]+)", text)]
    assert len(vals) == 2 and all(map(np.isfinite, vals))
    assert tltfb.main([*argv, "--rounds", "3"]) == 0
    assert "resumed at round 2" in capsys.readouterr().out
