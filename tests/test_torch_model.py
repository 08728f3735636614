"""The port's qwen3 model against the JAX package at f32 on the CPU.

Weights come from ``repro.models.lm.init_lm`` and cross through
``repro_torch.bridge``; the same tokens, block tables and write indices
(made with numpy) go through both packages.  Logits and the updated KV
pools must agree at atol = rtol = 1e-4 (f32; the two frameworks sum in
different orders).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import qwen3_06b as jax_qwen3
from repro.models import lm as jlm
from repro_torch.bridge import load_jax_params, params_from_jax
from repro_torch.configs import qwen3_06b
from repro_torch.configs.registry import get_config
from repro_torch.models import lm as tlm

TOL = dict(atol=1e-4, rtol=1e-4)
PAGES, BS = 12, 4


@pytest.fixture(scope="module")
def both():
    """JAX smoke weights at f32 and the port's model loaded with them."""
    jcfg = dataclasses.replace(jax_qwen3.SMOKE, dtype="float32")
    tcfg = dataclasses.replace(qwen3_06b.SMOKE, dtype="float32")
    params = _jax_init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = tlm.init_lm(tcfg, seed=0, device="cpu")
    load_jax_params(model, tree)
    return jcfg, params, tree, model


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_init(cfg, key):
    """JAX weights, initialised under jit: one compile instead of one
    dispatch per jnp op (the values need only be the same on both sides,
    which the bridge makes them)."""
    return jlm.init_lm(cfg, key)[0]


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_forward(params, cfg, toks):
    return jlm.lm_forward(params, cfg, {"tokens": toks})[0]


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_chunk(params, cfg, toks, last_pos, cache, tables, hist, plen):
    return jlm.lm_prefill(params, cfg, {"tokens": toks}, last_pos=last_pos,
                          cache=cache, tables=tables, hist_len=hist,
                          prompt_len=plen)


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_decode(params, cfg, toks, cache, index, tables, valid):
    return jlm.lm_decode(params, cfg, toks, cache, index, tables=tables,
                         valid=valid)


def _pools_match(jcache, tcache):
    """Every page but the null page (duplicate dead writes land there in
    an order neither framework fixes)."""
    jk = np.asarray(jcache["body"][0]["k"])
    jv = np.asarray(jcache["body"][0]["v"])
    for i, layer in enumerate(tcache):
        np.testing.assert_allclose(layer["k"][:-1].numpy(), jk[i, :-1],
                                   **TOL)
        np.testing.assert_allclose(layer["v"][:-1].numpy(), jv[i, :-1],
                                   **TOL)


def test_bridge_loads_every_jax_weight(both):
    jcfg, _, tree, model = both
    sd = params_from_jax(tree, model.cfg)
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(
        model.blocks[1].mixer.wq.weight.detach().numpy(),
        tree["body"][0]["mixer"]["wq"][1].T)
    np.testing.assert_array_equal(model.embed.weight.detach().numpy(),
                                  tree["embed"])
    assert not any(k.startswith("lm_head") for k in sd)   # tied head


def test_bridge_carries_bf16_exactly():
    cfg = qwen3_06b.SMOKE                                   # bfloat16
    params = _jax_init(jax_qwen3.SMOKE, jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, params)
    model = load_jax_params(tlm.init_lm(cfg, device="cpu"), tree)
    assert model.embed.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.blocks[0].ffn.wo.weight.detach().float().numpy(),
        np.asarray(tree["body"][0]["ffn"]["wo"][0], np.float32).T)


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_jax_field_by_field(smoke):
    mine = get_config("qwen3-0.6b", smoke=smoke)
    ref = jax_qwen3.SMOKE if smoke else jax_qwen3.FULL
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(b):         # a sub-config (frontend)
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    for prop in ("resolved_head_dim", "q_dim", "kv_dim"):
        assert getattr(mine, prop) == getattr(ref, prop), prop


def test_unported_arch_names_the_roadmap():
    """No arch is left unported: every arch of the JAX registry resolves
    (FULL and SMOKE, to a config of that name), and an unknown one raises
    ``KeyError``."""
    from repro.configs.registry import ARCHS as JAX_ARCHS

    for arch in JAX_ARCHS:
        for smoke in (False, True):
            assert get_config(arch, smoke=smoke).name.startswith(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


def test_lm_forward_matches_jax(both):
    jcfg, params, _, model = both
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    ref = _jax_forward(params, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        out = tlm.lm_forward(model, torch.from_numpy(toks).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _prefill_both(jcfg, params, model, tables, prompts, chunk):
    """Chunk-prefill each prompt into both packages' pools."""
    jcache, _ = jlm.init_cache(jcfg, 1, pages=(PAGES, BS))
    tcache = tlm.init_cache(model.cfg, pages=(PAGES, BS), device="cpu")
    for row, prompt in enumerate(prompts):
        P = len(prompt)
        for hist in range(0, P, chunk):
            n = min(chunk, P - hist)
            toks = np.zeros((1, chunk), np.int32)
            toks[0, :n] = prompt[hist:hist + n]
            tbl = tables[row:row + 1]
            jl, jcache = _jax_chunk(
                params, jcfg, jnp.asarray(toks),
                jnp.asarray([n - 1], jnp.int32), jcache, jnp.asarray(tbl),
                jnp.int32(hist), jnp.int32(P))
            tl = tlm.lm_prefill(model, torch.from_numpy(toks).long(), tcache,
                                torch.from_numpy(tbl), hist, P, n - 1)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    return jcache, tcache


def _tables():
    null = PAGES
    tables = np.full((3, 4), null, np.int32)
    tables[0, :3] = [3, 7, 1]          # row 0: 10-token prompt + decode
    tables[1, :3] = [5, 0, 9]          # row 1: 6-token prompt + decode
    return tables                      # row 2: idle, null pages only


def test_chunked_prefill_matches_jax(both):
    jcfg, params, _, model = both
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (10, 6)]
    jcache, tcache = _prefill_both(jcfg, params, model, _tables(), prompts,
                                   chunk=4)
    _pools_match(jcache, tcache)


@pytest.mark.parametrize("K,valid", [(1, None), (3, [3, 2, 0])])
def test_lm_decode_matches_jax(both, K, valid):
    """Paged decode (K=1) and K-token verify with ``valid`` and an idle
    row (index -1, null-page table) match JAX logits and pools."""
    jcfg, params, _, model = both
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (10, 6)]
    tables = _tables()
    jcache, tcache = _prefill_both(jcfg, params, model, tables, prompts,
                                   chunk=8)
    index = np.asarray([10, 6, -1], np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (3, K)).astype(np.int32)
    jvalid = None if valid is None else jnp.asarray(valid, jnp.int32)
    tvalid = None if valid is None else torch.tensor(valid)
    jl, jcache = _jax_decode(params, jcfg, jnp.asarray(toks), jcache,
                             jnp.asarray(index), jnp.asarray(tables), jvalid)
    tl = tlm.lm_decode(model, torch.from_numpy(toks).long(), tcache,
                       torch.from_numpy(index).long(),
                       torch.from_numpy(tables), valid=tvalid)
    assert tl.shape == (3, K, jcfg.vocab_size)
    # the idle row's logits are garbage both packages discard
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], **TOL)
    _pools_match(jcache, tcache)
