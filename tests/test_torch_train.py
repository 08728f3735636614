"""The port's LM training path against the JAX package on the CPU.

The SMOKE qwen3 config in f32 with ``attn_impl="chunked"`` and
``attn_chunk=8`` on both sides, so the flash route (the plain versions
inside ``ops.flash_attention``'s autograd Function) runs at small S.
Weights come from ``repro.models.lm.init_lm`` and cross through
``repro_torch.bridge``; batches are made with numpy.  Tolerances are
stated per test; the JAX sides run under ``jax.jit``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.configs import qwen3_06b as jax_qwen3
from repro.data import tokens as jtokens
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.bridge import (load_jax_params, opt_state_from_jax,
                                params_from_jax)
from repro_torch.configs import qwen3_06b
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data import tokens as ttokens
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps as tsteps

SMOKE_KW = dict(dtype="float32", attn_impl="chunked", attn_chunk=8)
B, S = 2, 12
# f32 on both sides; the packages sum in different orders (and the JAX
# step fuses under jit), so values agree to a few ulps of their scale
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_init(cfg, key):
    return jlm.init_lm(cfg, key)[0]


@pytest.fixture(scope="module")
def cfgs():
    jcfg = dataclasses.replace(jax_qwen3.SMOKE, **SMOKE_KW)
    tcfg = dataclasses.replace(qwen3_06b.SMOKE, **SMOKE_KW)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights(cfgs):
    jcfg, _ = cfgs
    return _jax_init(jcfg, jax.random.PRNGKey(0))


def _port_model(tcfg, params):
    model = tlm.init_lm(tcfg, seed=0, device="cpu")
    return load_jax_params(model, _np(params)).train()


def _batch(cfg, seed):
    b = jtokens.train_batch(cfg, B, S, seed=seed)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.ascontiguousarray(v)).long()
             for k, v in b.items()})


def _f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_named(got, want, **tol):
    """Two {name: tensor-or-array} dicts agree name by name."""
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(_f32(got[n]), _f32(want[n]), err_msg=n,
                                   **tol)


def test_train_batch_and_lm_batches_bit_identical_to_jax(cfgs):
    jcfg, tcfg = cfgs
    for seed in (0, 987654):
        want = jtokens.train_batch(jcfg, 3, 17, seed=seed)
        got = ttokens.train_batch(tcfg, 3, 17, seed=seed)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for want, got in zip(jtokens.lm_batches(3, 2, 9, 100, seed=4),
                         ttokens.lm_batches(3, 2, 9, 100, seed=4)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_configs_carry_attention_dispatch_and_optimizer_fields():
    """The fields this slice adds equal the JAX package's, with its
    defaults."""
    from repro_torch.configs.base import ModelConfig

    for f in ("attn_impl", "attn_chunk"):
        assert getattr(ModelConfig(), f) == getattr(jbase.ModelConfig(), f)
    mine, ref = OptimizerConfig(), jbase.OptimizerConfig()
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("remat", ["none", "full"])
def test_lm_loss_and_every_gradient_match_jax(cfgs, weights, remat):
    """Loss and the gradient of every weight == ``jax.value_and_grad`` of
    ``lm.lm_loss`` (the flash route on both sides); one label masked."""
    jcfg, tcfg = cfgs
    jb, tb = _batch(jcfg, seed=5)
    jb["labels"] = jb["labels"].at[0, 3].set(-1)
    tb["labels"][0, 3] = -1

    @jax.jit
    def jax_side(params, batch):
        return jax.value_and_grad(
            lambda p: jlm.lm_loss(p, jcfg, batch, remat=remat),
            has_aux=True)(params)

    (jloss, jmetrics), jgrads = jax_side(weights, jb)
    model = _port_model(tcfg, weights)
    loss, metrics = tlm.lm_loss(model, tb, remat=remat)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    np.testing.assert_allclose(metrics["ce"].item(), float(jmetrics["ce"]),
                               **TOL)
    want = params_from_jax(_np(jgrads), tcfg)
    _assert_named({n: p.grad for n, p in model.named_parameters()}, want,
                  **TOL)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_three_train_steps_match_jax(cfgs, weights, remat):
    """Three ``make_lm_train_step`` steps (Adam, clip 1.0, warmup 2, so
    the lr runs 0, 5e-4, 1e-3) == the JAX step under ``jax.jit``: loss,
    lr and grad norm per step, then every weight and Adam's m, v and step
    count, name by name."""
    jcfg, tcfg = cfgs
    opt = jbase.OptimizerConfig(lr=1e-3, warmup_steps=2)
    jstep = jax.jit(jsteps.make_lm_train_step(
        jcfg, opt, jbase.MeshConfig(remat=remat)))
    jstate = {"params": weights,
              "opt_state": jopt.make_optimizer(opt).init(weights)}
    tstate = {"model": _port_model(tcfg, weights)}
    tstate["opt_state"] = topt.make_optimizer(OptimizerConfig(
        lr=1e-3, warmup_steps=2)).init(dict(
            tstate["model"].named_parameters()))
    tstep = tsteps.make_lm_train_step(tcfg, OptimizerConfig(
        lr=1e-3, warmup_steps=2), remat=remat)
    lrs = []
    for i in range(3):
        jb, tb = _batch(jcfg, seed=i)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        for key in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       err_msg=f"step {i} {key}", **TOL)
        lrs.append(tm["lr"].item())
    assert lrs == pytest.approx([0.0, 5e-4, 1e-3])
    _assert_named(dict(tstate["model"].named_parameters()),
                  params_from_jax(_np(jstate["params"]), tcfg), **TOL)
    want = opt_state_from_jax(_np(jstate["opt_state"]), tcfg)
    assert int(tstate["opt_state"]["step"]) == int(want["step"]) == 3
    # m to 1e-5 of its scale; v holds squared gradients (1e-6 and below):
    # its atol is scaled down with it, and its rtol is twice the
    # gradients' (a square doubles a relative error)
    _assert_named(tstate["opt_state"]["m"], want["m"], **TOL)
    _assert_named(tstate["opt_state"]["v"], want["v"], atol=1e-10,
                  rtol=2e-5)


def _random_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w3": (3, 4, 5), "w2": (6, 7), "b": (8,)}
    return {n: rng.standard_normal(s).astype(np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adamw", 0.01),
                                     ("adafactor", 0.0), ("sgd", 0.0)])
def test_optimizers_match_jax_on_a_random_tree(name, wd):
    """Three updates at lrs 1e-3, 5e-3, 1e-2 of each optimizer == the JAX
    package's on the same {name: leaf} tree; f32, 1e-6."""
    cfg_kw = dict(name=name, weight_decay=wd)
    jo = jopt.make_optimizer(jbase.OptimizerConfig(**cfg_kw))
    to = topt.make_optimizer(OptimizerConfig(**cfg_kw))
    params = _random_tree(0)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for i, lr in enumerate((1e-3, 5e-3, 1e-2)):
        grads = _random_tree(i + 1)
        jp, js = jo.update({n: jnp.asarray(g) for n, g in grads.items()},
                           js, jp, jnp.float32(lr))
        tp, ts = to.update({n: torch.from_numpy(g) for n, g in grads.items()},
                           ts, tp, torch.tensor(lr))
    tol = dict(atol=1e-6, rtol=1e-6)
    _assert_named(tp, jp, **tol)
    for key in js:
        if key == "step":
            assert int(ts["step"]) == int(js["step"]) == 3
        else:
            _assert_named(ts[key], js[key], **tol)


def test_adafactor_state_crosses_the_bridge_name_by_name(cfgs, weights):
    """Two Adafactor updates of the model's weights with the same random
    gradients in both packages.  The port groups its per-layer tensors
    into the JAX package's stacked leaves (``lm.param_groups``), so the
    update clip spans a stack and a stacked norm scale is factored as an
    (L, d) matrix, as in JAX: ``opt_state_from_jax`` maps every leaf's
    factored moments onto the port's group (row and column factors swap
    with the transposed dense weights), nothing left out, and every weight
    after the two updates agrees to 1e-5 relative."""
    _, tcfg = cfgs
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
    assert {k for k in ts["vr"] if k.startswith("blocks[")} == \
        {f"blocks[0::1].{n.split('.', 2)[2]}" for n in tp
         if n.startswith("blocks.")}
    _assert_named(tp, params_from_jax(_np(jp), tcfg), atol=1e-7, rtol=1e-5)
    assert int(ts["step"]) == int(want["step"]) == 2


@pytest.mark.parametrize("schedule", ["constant", "cosine", "linear"])
def test_lr_schedule_matches_jax(schedule):
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=50, schedule=schedule)
    jcfg, tcfg = jbase.OptimizerConfig(**kw), OptimizerConfig(**kw)
    for step in (0, 1, 5, 10, 11, 30, 50, 70):
        want = float(jopt.lr_schedule(jcfg, jnp.int32(step)))
        got = topt.lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    """Clipped (0.5) and untouched (1e3) trees and the norm == JAX's; the
    clip casts back to each gradient's dtype (a bf16 leaf stays bf16)."""
    tree = _random_tree(7)
    jgrads, jnorm = jopt.clip_by_global_norm(
        {n: jnp.asarray(a) for n, a in tree.items()}, max_norm)
    tgrads, tnorm = topt.clip_by_global_norm(
        {n: torch.from_numpy(a) for n, a in tree.items()}, max_norm)
    np.testing.assert_allclose(tnorm.item(), float(jnorm), rtol=1e-6)
    _assert_named(tgrads, jgrads, atol=1e-7, rtol=1e-6)
    clipped, _ = topt.clip_by_global_norm(
        {"x": torch.ones(4, dtype=torch.bfloat16)}, 1.0)
    assert clipped["x"].dtype == torch.bfloat16


def test_remat_dots_policies_name_the_roadmap(cfgs):
    _, tcfg = cfgs
    model = tlm.init_lm(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlm.lm_forward(model, torch.zeros((1, 4), dtype=torch.long),
                       remat="dots")


def test_train_cli_on_cpu_prints_its_lines_and_a_finite_val(capsys):
    out = tlaunch.train_lm(tlaunch.build_parser().parse_args(
        ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps",
         "3", "--batch", "2", "--seq", "16", "--log-every", "1"]))
    text = capsys.readouterr().out
    lines = [ln for ln in text.splitlines() if ln.startswith("step ")]
    assert len(lines) == 3 and "loss=" in lines[0] and "lr=" in lines[0]
    assert "lr=0.00e+00" in lines[0]                 # step 0 runs at lr 0
    assert "[train] done: val=" in text
    assert np.isfinite(out["val"]) and all(map(np.isfinite, out["losses"]))
    # the paper's CycleGAN trains through the same CLI
    assert tlaunch.main(["--arch", "icf-cyclegan", "--smoke", "--device",
                         "cpu", "--steps", "2"]) == 0
    text = capsys.readouterr().out
    assert "step     0 g=" in text
    val = float(text.split("[train] done: val=")[1].split()[0])
    assert np.isfinite(val)
