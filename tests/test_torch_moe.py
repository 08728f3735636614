"""The port's mixture of experts against the JAX package on the CPU.

``moe_block`` alone (both dispatch forms, with capacity and dropless, a
capacity that drops pairs, two dispatch groups), then deepseek-moe-16b
SMOKE (a dense prefix layer, shared experts) and phi3.5-moe SMOKE through
the model: forward, loss and gradients, three train steps, Adafactor over
the stacked expert leaves, the bridge and checkpoints both ways; and
jamba SMOKE with its experts (Mamba + attention + MoE): forward, prefill
and a decode step.  Weights come from the JAX package and cross through
``repro_torch.bridge``; inputs are made with numpy.  f32 on both sides;
tolerances are stated per test, the JAX sides run under ``jax.jit``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jbase
from repro.configs import deepseek_moe as jax_deepseek
from repro.configs import jamba_15_large as jax_jamba
from repro.configs import phi35_moe as jax_phi
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.bridge import (load_jax_params, opt_state_from_jax,
                                opt_state_to_jax_layout, params_from_jax,
                                params_to_jax_layout)
from repro_torch.configs import deepseek_moe, jamba_15_large, phi35_moe
from repro_torch.configs.base import OptimizerConfig, replace
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps as tsteps

# f32; the two packages sum in different orders
TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 12
ARCHS = {"deepseek": (jax_deepseek, deepseek_moe),
         "phi": (jax_phi, phi35_moe)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_named(got, want, **tol):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(_f32(got[n]), _f32(want[n]), err_msg=n,
                                   **tol)


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_init(cfg, key):
    return jlm.init_lm(cfg, key)[0]


@functools.lru_cache(maxsize=None)
def _cfgs(arch, **kw):
    jmod, tmod = ARCHS[arch]
    kw = {"dtype": "float32", **kw}
    return (dataclasses.replace(jmod.SMOKE, **kw), replace(tmod.SMOKE, **kw))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    return _jax_init(_cfgs(arch)[0], jax.random.PRNGKey(0))


def _port_model(tcfg, params):
    model = tlm.init_lm(tcfg, seed=0, device="cpu")
    return load_jax_params(model, _np(params)).train()


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)).long()
             for k, v in b.items()})


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------


def _jax_keep(params, cfg, x, dropless):
    """The kept (token, choice) pairs of JAX's ``moe_block`` (the routing
    lines of ``repro.models.layers.moe_block``, which returns no mask):
    (G, Tg, k) bool."""
    m = cfg.moe
    Bx, Sx, d = x.shape
    T = Bx * Sx
    Tg = min(T, jlayers.MOE_GROUP_TOKENS)
    while T % Tg:
        Tg -= 1
    xt = x.reshape(T // Tg, Tg, d)
    logits = jnp.einsum("gtd,de->gte", xt, params["router"].astype(xt.dtype),
                        preferred_element_type=jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    cap = Tg if dropless else max(1, int(m.capacity_factor * Tg * m.top_k
                                         / m.num_experts))
    onehot = jax.nn.one_hot(idx, m.num_experts, dtype=jnp.int32)
    flat = onehot.reshape(T // Tg, Tg * m.top_k, m.num_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    return np.asarray(jnp.sum(pos * onehot, axis=-1) < cap)


def _port_moe(tcfg, p):
    moe = tlayers.MoE(tcfg, torch.float32)
    with torch.no_grad():
        for name in ("router", "wi", "wg", "wo"):
            getattr(moe, name).copy_(torch.from_numpy(np.array(p[name])))
        if "shared" in p:
            for name in ("wi", "wg", "wo"):
                getattr(moe.shared, name).weight.copy_(torch.from_numpy(
                    np.array(p["shared"][name]).T))
    return moe


@pytest.mark.parametrize("dispatch,dropless,cf,seq", [
    ("einsum", False, 1.25, 12), ("scatter", False, 1.25, 12),
    ("einsum", True, 1.25, 12), ("scatter", True, 1.25, 12),
    ("einsum", False, 0.5, 12), ("scatter", False, 0.5, 12),
    ("scatter", False, 1.25, 600)])
def test_moe_block_matches_jax(dispatch, dropless, cf, seq):
    """out, ``moe_load_balance`` and ``moe_z`` at atol = rtol = 1e-5 and
    the same kept (token, choice) pairs as JAX's ``moe_block``; at cf 0.5
    pairs are dropped, at S = 600 (T = 1200) the tokens route in two
    groups of 600."""
    moe_kw = {"moe.dispatch": dispatch, "moe.capacity_factor": cf}
    jcfg = jbase.replace(_cfgs("deepseek")[0], **moe_kw)
    tcfg = replace(_cfgs("deepseek")[1], **moe_kw)
    p, _ = jlayers.init_moe(jlayers.KeyGen(jax.random.PRNGKey(3)), jcfg)
    x = np.random.default_rng(4).standard_normal(
        (B, seq, jcfg.d_model)).astype(np.float32)
    jout, jaux = jax.jit(functools.partial(
        jlayers.moe_block, cfg=jcfg, dropless=dropless))(p, x=jnp.asarray(x))
    moe = _port_moe(tcfg, p)
    with torch.no_grad():
        out, aux = tlayers.moe_block(moe, tcfg, torch.from_numpy(x),
                                     dropless)
        routing = tlayers.route(moe, tcfg, torch.from_numpy(x).reshape(
            -1, tlayers.moe_group_size(B * seq), jcfg.d_model), dropless)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for k in ("moe_load_balance", "moe_z"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), **TOL)
    keep = _jax_keep(p, jcfg, jnp.asarray(x), dropless)
    np.testing.assert_array_equal(routing.keep.numpy(), keep)
    dropped, pairs = moe.routed
    assert pairs == keep.size and int(dropped) == int((~keep).sum())
    if dropless:
        assert int(dropped) == 0
    if cf < 1:
        assert int(dropped) > 0


# ---------------------------------------------------------------------------
# deepseek and phi through the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek", "phi"])
def test_bridge_carries_prefix_and_expert_leaves(arch):
    """Every JAX leaf lands on a port weight (deepseek's dense prefix layer
    from ``prefix``, the expert stacks untransposed, the shared experts
    transposed), and JAX -> port -> JAX is the identity bit for bit."""
    jcfg, tcfg = _cfgs(arch)
    tree = _np(_weights(arch))
    model = _port_model(tcfg, _weights(arch))
    sd = params_from_jax(tree, tcfg)
    assert set(sd) == set(model.state_dict())
    k0, R, P = tlm.grouping(tcfg)
    layer = k0                               # the first MoE layer
    np.testing.assert_array_equal(
        model.blocks[layer].ffn.wi.detach().numpy(),
        tree["body"][0]["ffn"]["wi"][0])
    assert model.blocks[layer].ffn.router.dtype == torch.float32
    if arch == "deepseek":
        assert k0 == 1 and model.blocks[0].ffn_kind == "dense"
        np.testing.assert_array_equal(
            model.blocks[0].ffn.wi.weight.detach().numpy(),
            tree["prefix"]["ffn"]["wi"][0].T)
        np.testing.assert_array_equal(
            model.blocks[1].ffn.shared.wo.weight.detach().numpy(),
            tree["body"][0]["ffn"]["shared"]["wo"][0].T)
    back = params_to_jax_layout(model, tcfg)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, back)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("arch", ["deepseek", "phi"])
def test_lm_loss_and_every_gradient_match_jax(arch):
    """``lm_forward``'s logits, then the loss with its aux metrics and the
    gradient of every weight, router and experts included, ==
    ``jax.value_and_grad`` of ``lm.lm_loss`` (capacity dispatch)."""
    jcfg, tcfg = _cfgs(arch)
    jb, tb = _batch(jcfg, seed=5)
    params = _weights(arch)

    @jax.jit
    def jax_side(params, batch):
        return jax.value_and_grad(
            lambda p: jlm.lm_loss(p, jcfg, batch, remat="full"),
            has_aux=True)(params)

    jlogits, _ = jax.jit(lambda p, b: jlm.lm_forward(p, jcfg, b))(params, jb)
    (jloss, jmetrics), jgrads = jax_side(params, jb)
    model = _port_model(tcfg, params)
    with torch.no_grad():
        logits = tlm.lm_forward(model, tb["tokens"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)
    loss, metrics = tlm.lm_loss(model, tb, remat="full")
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert set(metrics) == set(jmetrics) == {"ce", "moe_load_balance",
                                             "moe_z"}
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   err_msg=k, **TOL)
    assert metrics["moe_load_balance"].item() > 0
    want = params_from_jax(_np(jgrads), tcfg)
    _assert_named({n: p.grad for n, p in model.named_parameters()}, want,
                  **TOL)


@pytest.mark.parametrize("arch", ["deepseek", "phi"])
def test_three_train_steps_match_jax(arch):
    """Three ``make_lm_train_step`` steps (Adam, clip 1.0, warmup 2) ==
    the jitted JAX step: loss, lr and grad norm per step, then every
    weight and Adam's m and step count; the state crosses to JAX's layout
    and back bit for bit."""
    jcfg, tcfg = _cfgs(arch)
    weights = _weights(arch)
    opt = jbase.OptimizerConfig(lr=1e-3, warmup_steps=2)
    jstep = jax.jit(jsteps.make_lm_train_step(
        jcfg, opt, jbase.MeshConfig(remat="full")))
    jstate = {"params": weights,
              "opt_state": jopt.make_optimizer(opt).init(weights)}
    topt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2)
    tstate = tsteps.init_lm_state(tcfg, topt_cfg, device="cpu")
    tstate["model"] = _port_model(tcfg, weights)
    tstep = tsteps.make_lm_train_step(tcfg, topt_cfg, remat="full")
    for i in range(3):
        jb, tb = _batch(jcfg, seed=i)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        for key in ("loss", "lr", "grad_norm", "moe_load_balance", "moe_z"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
    _assert_named(dict(tstate["model"].named_parameters()),
                  params_from_jax(_np(jstate["params"]), tcfg), **TOL)
    want = opt_state_from_jax(_np(jstate["opt_state"]), tcfg)
    assert int(tstate["opt_state"]["step"]) == int(want["step"]) == 3
    _assert_named(tstate["opt_state"]["m"], want["m"], **TOL)
    back = opt_state_to_jax_layout(want, tcfg)
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(_np(jstate["opt_state"]))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_adafactor_over_stacked_expert_leaves_matches_jax():
    """Two Adafactor updates of deepseek SMOKE's weights with the same
    random gradients: the port groups its per-layer tensors into JAX's
    ``prefix`` and ``body`` leaves, so an expert stack (P, E, d, d_e) is
    factored over its last two axes and clipped as one leaf; the factored
    moments cross the bridge group by group and every weight agrees to
    1e-5 relative."""
    _, tcfg = _cfgs("deepseek")
    weights = _weights("deepseek")
    rng = np.random.default_rng(11)
    tree = _np(weights)
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    jo = jopt.make_adafactor(jbase.OptimizerConfig(name="adafactor"))
    to = topt.make_adafactor(OptimizerConfig(name="adafactor"),
                             functools.partial(tlm.param_groups, tcfg))
    jp, tp = weights, params_from_jax(tree, tcfg)
    tg = params_from_jax(grads, tcfg)
    js, ts = jo.init(jp), to.init(tp)
    jupdate = jax.jit(jo.update)
    for lr in (1e-3, 2e-3):
        jp, js = jupdate(grads, js, jp, jnp.float32(lr))
        tp, ts = to.update(tg, ts, tp, torch.tensor(lr))
    want = opt_state_from_jax(_np(js), tcfg)
    for key in ("vr", "vc"):
        assert set(ts[key]) == set(want[key])
        _assert_named(ts[key], want[key], atol=1e-7, rtol=1e-5)
    k0, R, P = tlm.grouping(tcfg)
    assert ts["vr"][f"blocks[{k0}::{R}].ffn.wi"].shape == \
        (P, tcfg.moe.num_experts, tcfg.d_model)
    assert "blocks[0:1].ffn.wi.weight" in ts["vr"]
    _assert_named(tp, params_from_jax(_np(jp), tcfg), atol=1e-7, rtol=1e-5)


def _cli_args(tmp_path, *extra):
    return tlaunch.build_parser().parse_args(
        ["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
         "--batch", "2", "--seq", "16", "--log-every", "1", "--ckpt-dir",
         str(tmp_path), *extra])


def test_moe_checkpoints_cross_both_ways(tmp_path):
    """A ``step_2.ckpt`` the port's train CLI writes for deepseek SMOKE
    (bf16 weights, f32 Adam moments) restores bit for bit in JAX's
    ``ckpt.restore`` into JAX's state template; a JAX state with nonzero
    moments restores bit for bit into the port's trainer."""
    tlaunch.train_lm(_cli_args(tmp_path, "--steps", "3", "--ckpt-every",
                               "2"))
    tr = tlaunch.build_trainer(_cli_args(tmp_path))
    assert tlaunch.restore_trainer(tr, str(tmp_path / "step_2.ckpt")) == 2
    jstate, _ = jsteps.init_lm_state(jax_deepseek.SMOKE,
                                     jbase.OptimizerConfig(),
                                     jax.random.PRNGKey(0))
    got, meta = jckpt.restore(str(tmp_path / "step_2.ckpt"), jstate)
    assert meta == {"step": 2} and int(got["opt_state"]["step"]) == 3
    mine = tlaunch.checkpoint_tree(tr)
    for a, b in zip(jax.tree.leaves(_np(got)), jax.tree.leaves(mine)):
        b = b.view(torch.int16).numpy().view(np.uint16) \
            if b.dtype == torch.bfloat16 else np.asarray(b)
        a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(a, b)
    p = jstate["params"]
    jstate["opt_state"] = {
        "m": jax.tree.map(lambda x: (x * 0.5).astype(jnp.float32), p),
        "v": jax.tree.map(lambda x: (x * x).astype(jnp.float32), p),
        "step": jnp.asarray(5, jnp.int32)}
    path = str(tmp_path / "jax" / "step_5.ckpt")
    jckpt.save(path, jstate, {"step": 5})
    tr = tlaunch.build_trainer(_cli_args(tmp_path))
    assert tlaunch.restore_trainer(tr, path) == 5
    want = params_from_jax(_np(p), deepseek_moe.SMOKE)
    for n, t in tr.state["model"].named_parameters():
        assert t.dtype == want[n].dtype and torch.equal(t, want[n]), n
    want_o = opt_state_from_jax(_np(jstate["opt_state"]), deepseek_moe.SMOKE)
    for n, t in want_o["v"].items():
        assert torch.equal(tr.state["opt_state"]["v"][n], t), n


# ---------------------------------------------------------------------------
# jamba with experts: Mamba + attention + MoE
# ---------------------------------------------------------------------------


def test_jamba_with_experts_forward_prefill_and_decode_match_jax():
    """jamba SMOKE with its MoE layers (``MMaM``, experts at layers 1 and
    3): ``lm_forward`` == JAX's (capacity dispatch); a 7-token prompt's
    exact-length prefill and one decode step after it == JAX's dense-cache
    ``lm_prefill`` and ``lm_decode`` (dropless), logits at 1e-4."""
    jcfg = dataclasses.replace(jax_jamba.SMOKE, dtype="float32")
    tcfg = replace(jamba_15_large.SMOKE, dtype="float32")
    params = _jax_init(jcfg, jax.random.PRNGKey(0))
    model = load_jax_params(tlm.init_lm(tcfg, device="cpu"), _np(params))
    assert [b.ffn_kind for b in model.blocks] == ["dense", "moe"] * 2
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    jlogits = jax.jit(lambda p, t: jlm.lm_forward(p, jcfg, {"tokens": t})[0])(
        params, jnp.asarray(toks))
    prompt = toks[:1, :7]
    jpre, jcache = jax.jit(lambda p, t: jlm.lm_prefill(
        p, jcfg, {"tokens": t}))(params, jnp.asarray(prompt))
    nxt = np.asarray([[int(np.asarray(jpre)[0, -1].argmax())]], np.int32)
    jcache = jax.tree.map(
        lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, 1)] + [(0, 0)] * (c.ndim - 3))
        if c.ndim == 5 else c, jcache)      # room for the decoded token
    jdec, _ = jax.jit(lambda p, t, c: jlm.lm_decode(p, jcfg, t, c, 7))(
        params, jnp.asarray(nxt), jcache)
    cache = tlm.init_cache(tcfg, pages=(4, 4), num_slots=1, device="cpu")
    tables = torch.tensor([[0, 1, 4, 4]], dtype=torch.int32)
    with torch.no_grad():
        logits = tlm.lm_forward(model, torch.from_numpy(toks).long())
        pre = tlm.lm_prefill_exact(model, torch.from_numpy(prompt).long(),
                                   cache, tables, 0)
        dec = tlm.lm_decode(model, torch.from_numpy(nxt).long(), cache,
                            torch.tensor([7]), tables)
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), **tol)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), **tol)
