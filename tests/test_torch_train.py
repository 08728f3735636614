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
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jbase
from repro.configs import qwen3_06b as jax_qwen3
from repro.data import tokens as jtokens
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.bridge import (load_jax_params, opt_state_from_jax,
                                opt_state_to_jax_layout, params_from_jax,
                                params_to_jax_layout)
from repro_torch.checkpoint import ckpt as tckpt
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


def test_train_cli_on_cpu_prints_its_lines_and_a_finite_val(capsys,
                                                            tmp_path):
    out = tlaunch.train_lm(tlaunch.build_parser().parse_args(
        ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps",
         "3", "--batch", "2", "--seq", "16", "--log-every", "1",
         "--ckpt-dir", str(tmp_path)]))
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


# ---------------------------------------------------------------------------
# the reverse bridge and the train CLI's checkpoints
# ---------------------------------------------------------------------------


def _bits(x):
    """A leaf's raw bits as a numpy array (bf16 as uint16)."""
    if torch.is_tensor(x):
        x = x.detach()
        return x.view(torch.int16).numpy().view(np.uint16) \
            if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _assert_same_tree(got, want):
    """Equal structure (JAX's tree, tuples included), dtype and bits."""
    assert jax.tree.structure(jax.tree.map(lambda x: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
        assert _bits(a).dtype == _bits(b).dtype


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reverse_bridge_round_trips_params_bit_exact(dtype):
    """JAX -> port -> JAX and port -> JAX -> port are the identity, bit
    for bit, and the tree of a bridged model is the JAX tree it came
    from."""
    jcfg = dataclasses.replace(jax_qwen3.SMOKE, dtype=dtype)
    tcfg = dataclasses.replace(qwen3_06b.SMOKE, dtype=dtype)
    jp = _np(_jax_init(jcfg, jax.random.PRNGKey(3)))
    _assert_same_tree(params_to_jax_layout(params_from_jax(jp, tcfg), tcfg),
                      jp)
    model = load_jax_params(tlm.init_lm(tcfg, device="cpu"), jp)
    _assert_same_tree(params_to_jax_layout(model, tcfg), jp)
    own = dict(tlm.init_lm(tcfg, seed=5, device="cpu").named_parameters())
    back = params_from_jax(params_to_jax_layout(own, tcfg), tcfg)
    assert set(back) == set(own)
    for n, t in own.items():
        assert back[n].dtype == t.dtype and torch.equal(back[n], t), n


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adamw", 0.01),
                                     ("sgd", 0.0)])
def test_reverse_bridge_round_trips_optimizer_state(cfgs, weights, name,
                                                    wd):
    """A JAX optimizer state after two updates crosses to the port and
    back bit for bit (moments and the int32 step), and the port's own
    state crosses to JAX's layout and back."""
    jcfg, tcfg = cfgs
    ocfg = dict(name=name, weight_decay=wd, lr=1e-3)
    jo = jopt.make_optimizer(jbase.OptimizerConfig(**ocfg))
    state = jo.init(weights)
    params = weights
    for seed in (1, 2):
        grads = jax.tree.map(
            lambda p, s=seed: jnp.asarray(np.random.default_rng(s).normal(
                size=p.shape), p.dtype), params)
        params, state = jo.update(grads, state, params, 1e-3)
    want = _np(state)
    ported = opt_state_from_jax(want, tcfg)
    _assert_same_tree(opt_state_to_jax_layout(ported, tcfg), want)
    assert want["step"].dtype == np.int32 and int(want["step"]) == 2
    back = opt_state_from_jax(opt_state_to_jax_layout(ported, tcfg), tcfg)
    for key, tree in ported.items():
        if key == "step":
            assert int(back["step"]) == 2
            continue
        for n, t in tree.items():
            assert torch.equal(back[key][n], t), (key, n)


def _cli_args(tmp_path, *extra):
    return tlaunch.build_parser().parse_args(
        ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch",
         "2", "--seq", "16", "--log-every", "1", "--ckpt-dir",
         str(tmp_path), *extra])


def test_port_checkpoint_restores_bit_equal_in_jax(tmp_path):
    """A ``step_<n>.ckpt`` the train CLI writes (SMOKE, bf16 weights, f32
    Adam moments) restores in JAX's ``ckpt.restore`` into JAX's state
    template, every leaf bit for bit, at its step."""
    tlaunch.train_lm(_cli_args(tmp_path, "--steps", "3", "--ckpt-every",
                               "2"))
    path = str(tmp_path / "step_2.ckpt")
    assert tckpt.latest_step_path(str(tmp_path)) == path
    tr = tlaunch.build_trainer(_cli_args(tmp_path))
    assert tlaunch.restore_trainer(tr, path) == 2
    jstate, _ = jsteps.init_lm_state(jax_qwen3.SMOKE,
                                     jbase.OptimizerConfig(),
                                     jax.random.PRNGKey(0))
    got, meta = jckpt.restore(path, jstate)
    assert meta == {"step": 2}
    _assert_same_tree(_np(got), tlaunch.checkpoint_tree(tr))
    assert int(got["opt_state"]["step"]) == 3


def test_jax_checkpoint_resumes_in_the_port(tmp_path, capsys):
    """A ``step_<n>.ckpt`` JAX's train launcher would write (its state
    tree with nonzero moments, ``{"step": 5}``) restores bit-equal into
    the port's trainer, and the CLI resumes there; ``--no-resume`` starts
    at 0."""
    opt = jbase.OptimizerConfig()
    jstate, _ = jsteps.init_lm_state(jax_qwen3.SMOKE, opt,
                                     jax.random.PRNGKey(9))
    p = jstate["params"]
    jstate["opt_state"] = {
        "m": jax.tree.map(lambda x: (x * 0.5).astype(jnp.float32), p),
        "v": jax.tree.map(lambda x: (x * x).astype(jnp.float32), p),
        "step": jnp.asarray(5, jnp.int32)}
    path = str(tmp_path / "step_5.ckpt")
    jckpt.save(path, jstate, {"step": 5})
    tr = tlaunch.build_trainer(_cli_args(tmp_path))
    assert tlaunch.restore_trainer(tr, path) == 5
    want = params_from_jax(_np(p), qwen3_06b.SMOKE)
    for n, t in tr.state["model"].named_parameters():
        assert t.dtype == torch.bfloat16 and torch.equal(t, want[n]), n
    want_o = opt_state_from_jax(_np(jstate["opt_state"]), qwen3_06b.SMOKE)
    for key in ("m", "v"):
        for n, t in want_o[key].items():
            assert torch.equal(tr.state["opt_state"][key][n], t), (key, n)
    assert int(tr.state["opt_state"]["step"]) == 5
    out = tlaunch.train_lm(_cli_args(tmp_path, "--steps", "7",
                                     "--ckpt-every", "0"))
    text = capsys.readouterr().out
    assert f"[train] resumed from {path} at step 5" in text
    assert out["start"] == 5 and len(out["losses"]) == 2
    assert all(map(np.isfinite, out["losses"]))
    out = tlaunch.train_lm(_cli_args(tmp_path, "--steps", "2",
                                     "--ckpt-every", "0", "--no-resume"))
    assert out["start"] == 0 and len(out["losses"]) == 2
    assert "resumed" not in capsys.readouterr().out


def test_train_cli_rerun_resumes_at_the_saved_step(tmp_path, capsys):
    first = tlaunch.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                          "cpu", "--steps", "5", "--batch", "2", "--seq",
                          "16", "--ckpt-every", "2", "--ckpt-dir",
                          str(tmp_path)])
    assert first == 0
    assert sorted(os.listdir(tmp_path)) == ["step_2.ckpt", "step_4.ckpt"]
    capsys.readouterr()
    out = tlaunch.train_lm(_cli_args(tmp_path, "--steps", "5"))
    assert out["start"] == 4 and len(out["losses"]) == 1
    assert "at step 4" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="Adafactor.*A14"):
        tlaunch.train_lm(_cli_args(tmp_path, "--steps", "5",
                                   "--optimizer", "adafactor"))


def test_population_step_equals_the_in_place_step(cfgs, weights):
    """``make_lm_population_fns``' functional step gives the in-place
    train step's weights, moments and metrics bit for bit over three
    steps, and leaves every tensor it was given as it was."""
    _, tcfg = cfgs
    opt = OptimizerConfig(lr=1e-3, warmup_steps=2)
    init, step, metric, to_ckpt, from_ckpt = \
        tsteps.make_lm_population_fns(tcfg, opt, device="cpu")
    params, opt_state = from_ckpt(_np(weights), _np(
        jopt.make_optimizer(jbase.OptimizerConfig()).init(weights)))
    state = {"model": _port_model(tcfg, weights)}
    state["opt_state"] = tsteps.make_optimizer(tcfg, opt).init(
        dict(state["model"].named_parameters()))
    in_place = tsteps.make_lm_train_step(tcfg, opt)
    for i in range(3):
        _, tb = _batch(tcfg, seed=i)
        before = {n: t.clone() for n, t in params.items()}
        new_params, new_opt, m = step(params, opt_state, tb, {"lr": 1e-3})
        for n, t in params.items():
            assert torch.equal(t, before[n]), n
        state, m2 = in_place(state, tb)
        for k in ("loss", "lr", "grad_norm"):
            assert torch.equal(m[k], m2[k]), k
        params, opt_state = new_params, new_opt
    model_params = dict(state["model"].named_parameters())
    for n, t in params.items():
        assert torch.equal(t, model_params[n]), n
        assert torch.equal(opt_state["v"][n], state["opt_state"]["v"][n])
    _, vb = _batch(tcfg, seed=99)
    assert torch.equal(metric(params, vb),
                       tsteps.make_lm_eval_metric(tcfg)(state["model"], vb))
