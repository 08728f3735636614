"""The port's CycleGAN slice against the JAX package on the CPU: the
config, the JAG data, the model's functions, losses and gradients, the GAN
train step, the bridge and the train CLI.

The SMOKE config in f32 on both sides; weights come from
``repro.models.icf_cyclegan.init_cyclegan`` and cross through
``repro_torch.bridge``; inputs are JAG samples made with numpy.
Tolerances are stated per test; the JAX sides run under ``jax.jit``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.configs import icf_cyclegan as jcfgs
from repro.data import jag as jjag
from repro.models import icf_cyclegan as jcg
from repro.train import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import icf_cyclegan as tcfgs
from repro_torch.configs.base import OptimizerConfig
from repro_torch.configs.registry import get_config
from repro_torch.data import jag as tjag
from repro_torch.launch import train as tlaunch
from repro_torch.models import icf_cyclegan as tcg
from repro_torch.train import steps as tsteps

CFG = tcfgs.SMOKE
B = 8
# f32 on both sides; the packages sum the products in other orders, so
# values agree to a few ulps of their scale
RTOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(n=B, seed=3):
    sim = tjag.jag_simulate(tjag.sample_inputs(n, seed=seed), CFG.image_size)
    return {"x": sim["x"], "y": tjag.flatten_outputs(sim)}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def weights():
    """JAX SMOKE weights (numpy) and the same weights in the port."""
    jp = _np(jax.jit(lambda k: jcg.init_cyclegan(jcfgs.SMOKE, k)[0])(
        jax.random.PRNGKey(0)))
    return jp, bridge.cyclegan_params_from_jax(jp)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (err, scale)


# ---------------------------------------------------------------------------
# config and registry
# ---------------------------------------------------------------------------


def test_config_matches_jax_and_counts_parameters():
    for t, j in ((tcfgs.FULL, jcfgs.FULL), (tcfgs.SMOKE, jcfgs.SMOKE)):
        assert t.__dict__ == j.__dict__
        assert t.output_dim == j.output_dim
        assert t.param_count() == j.param_count()
    assert tcfgs.FULL.param_count() == 101_322_365
    assert tcfgs.FULL.output_dim == 49_167
    assert tcfgs.SMOKE.param_count() == 108_221
    assert tcfgs.SMOKE.output_dim == 783
    # the module holds exactly the counted weights
    model = tcg.CycleGAN(tcfgs.SMOKE)
    assert sum(p.numel() for p in model.parameters()) == 108_221


def test_registry_resolves_the_cyclegan_and_lm_paths_refuse_it(capsys):
    from repro_torch.launch import serve as tserve
    from repro_torch.models import lm as tlm

    assert get_config("icf-cyclegan") is tcfgs.FULL
    assert get_config("icf-cyclegan", smoke=True) is tcfgs.SMOKE
    with pytest.raises(ValueError, match="not an LM"):
        tlm.layer_specs(tcfgs.FULL)
    # the serve CLI serves it as the surrogate workload, not as an LM
    assert tserve.main(["--arch", "icf-cyclegan", "--smoke", "--device",
                        "cpu", "--queries", "3", "--query-batch", "5"]) == 0
    out = capsys.readouterr().out
    assert "workload=surrogate" in out and "completed=3" in out
    with pytest.raises(SystemExit, match="needs an LM arch"):
        tserve.main(["--arch", "icf-cyclegan", "--workload", "lm",
                     "--device", "cpu"])


# ---------------------------------------------------------------------------
# JAG data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [8, 64])
def test_jag_is_bit_identical_to_jax(size):
    """sample_inputs, jag_simulate and flatten_outputs: equal bit for bit
    (same dtype, same values) at image size ``size``."""
    tx, jx = tjag.sample_inputs(size, seed=5), jjag.sample_inputs(size,
                                                                  seed=5)
    assert tx.dtype == jx.dtype and np.array_equal(tx, jx)
    ts, js = tjag.jag_simulate(tx, size), jjag.jag_simulate(jx, size)
    for k in js:
        assert ts[k].dtype == js[k].dtype
        assert np.array_equal(ts[k], js[k]), k
    ty, jy = tjag.flatten_outputs(ts), jjag.flatten_outputs(js)
    assert ty.dtype == jy.dtype and np.array_equal(ty, jy)


def test_jag_bundles_cross_between_the_packages(tmp_path):
    tfiles = tjag.write_bundles(str(tmp_path / "t"), 96, 32, image_size=8,
                                seed=2)
    jfiles = jjag.write_bundles(str(tmp_path / "j"), 96, 32, image_size=8,
                                seed=2)
    assert [p.rsplit("/", 1)[1] for p in tfiles] == \
        [p.rsplit("/", 1)[1] for p in jfiles]
    assert tjag.list_bundles(str(tmp_path / "j")) == jfiles
    assert jjag.list_bundles(str(tmp_path / "t")) == tfiles
    for tf, jf in zip(tfiles, jfiles):
        a, b = jjag.read_bundle(tf), tjag.read_bundle(jf)
        assert sorted(a) == sorted(b) == ["images", "scalars", "x"]
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# bridge
# ---------------------------------------------------------------------------


def test_bridge_transposes_dense_weights_and_round_trips(weights):
    jp, tp = weights
    assert list(tp["gen"])[:4] == ["fwd.0.weight", "fwd.0.bias",
                                   "fwd.1.weight", "fwd.1.bias"]
    # every weight of the port's module, in its nn.Linear layout
    model = tcg.CycleGAN(CFG)
    mine = model.params()
    for half in ("gen", "disc"):
        assert list(tp[half]) == list(mine[half])
        for n, t in tp[half].items():
            assert t.shape == mine[half][n].shape, n
    # non-square: 5 -> 32 in, 32 -> 783 out
    assert tp["gen"]["fwd.0.weight"].shape == (32, 5)
    np.testing.assert_array_equal(tp["gen"]["fwd.0.weight"].numpy(),
                                  jp["gen"]["fwd"]["w"][0].T)
    back = bridge.cyclegan_params_to_jax_layout(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(back) == jax.tree.structure(jp)


def test_init_draws_from_an_explicit_generator():
    a = tcg.init_cyclegan(CFG, seed=4, device="cpu")
    b = tcg.init_cyclegan(CFG, seed=4, device="cpu")
    c = tcg.init_cyclegan(CFG, seed=5, device="cpu")
    for n in a["gen"]:
        assert torch.equal(a["gen"][n], b["gen"][n])
    w = a["gen"]["enc.0.weight"]            # N(0, 1/d_in)
    assert abs(float(w.std()) * CFG.output_dim ** 0.5 - 1.0) < 0.05
    assert not torch.equal(w, c["gen"]["enc.0.weight"])
    assert not a["gen"]["enc.0.bias"].any()


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def test_model_functions_match_jax(weights):
    """predict, the encoder/inverse paths and both tournament metrics to
    1e-5 of their scale."""
    jp, tp = weights
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _tbatch(batch)
    _close(tcg.predict(tp["gen"], tb["x"]),
           jax.jit(jcg.predict)(jp["gen"], jb["x"]))
    _close(tcg.encode(tp["gen"], tb["y"]),
           jax.jit(jcg.encode)(jp["gen"], jb["y"]))
    z = tcg.forward_model(tp["gen"], tb["x"])
    _close(tcg.inverse_model(tp["gen"], z),
           jax.jit(lambda g, x: jcg.inverse_model(
               g, jcg.forward_model(g, x)))(jp["gen"], jb["x"]))
    _close(tcg.discriminate(tp["disc"], z),
           jax.jit(lambda p, x: jcg.discriminate(
               p["disc"], jcg.forward_model(p["gen"], x)))(jp, jb["x"]))
    _close(tcg.validation_metric(tp, CFG, tb),
           jax.jit(jcg.validation_metric, static_argnums=1)(
               jp, jcfgs.SMOKE, jb))
    _close(tcg.discriminator_metric(tp, CFG, tb),
           jax.jit(jcg.discriminator_metric, static_argnums=1)(
               jp, jcfgs.SMOKE, jb))
    # the module's forward is the prediction
    model = tcg.CycleGAN(CFG)
    model.load_state_dict({f"{h}.{n}": t for h in tp for n, t in
                           tp[h].items()})
    _close(model(tb["x"]).detach(), jax.jit(jcg.predict)(jp["gen"], jb["x"]))


def test_softplus_follows_jax():
    x = np.linspace(-40, 40, 161, dtype=np.float32)
    got = tcg.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=1e-7)
    t = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(tcg.softplus(t).sum(), t)
    np.testing.assert_allclose(
        g.numpy(), np.asarray(jax.grad(lambda v: jax.nn.softplus(v).sum())(
            x)), rtol=1e-6, atol=1e-7)


def _grad_leaves(tp_half):
    return {n: t.detach().clone().requires_grad_() for n, t in
            tp_half.items()}


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_losses_metrics_and_gradients_match_jax(weights, which):
    """The loss and every metric to 1e-5 relative; every gradient to 1e-5
    of its largest entry (the port's dense gradients transposed back)."""
    jp, tp = weights
    batch = _batch(seed=11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _tbatch(batch)
    if which == "generator":
        wrt, other = "gen", "disc"
        jfn, tfn = jcg.generator_loss, tcg.generator_loss
    else:
        wrt, other = "disc", "gen"
        jfn, tfn = jcg.discriminator_loss, tcg.discriminator_loss
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True),
                              static_argnums=2)(jp[wrt], jp[other],
                                                jcfgs.SMOKE, jb)
    leaves = _grad_leaves(tp[wrt])
    frozen = _grad_leaves(tp[other])        # must receive no gradient
    loss, tm = tfn(leaves, frozen, CFG, tb)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert loss.grad_fn is not None
    assert all(p.grad is None for p in frozen.values())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=RTOL,
                                   err_msg=k)
    tgrads = bridge.cyclegan_params_to_jax_layout(
        {wrt: dict(zip(leaves, grads)),
         other: {n: torch.zeros_like(t) for n, t in tp[other].items()}})
    for a, b in zip(jax.tree.leaves(tgrads[wrt]), jax.tree.leaves(_np(jg))):
        _close(a, b)
    # the frozen side: the generator loss reaches no discriminator weight
    frozen_loss, _ = tfn(_grad_leaves(tp[wrt]), frozen, CFG, tb)
    frozen_loss.backward()
    assert all(p.grad is None for p in frozen.values())


def test_disc_acc_is_a_mean_of_booleans(weights):
    _, tp = weights
    _, m = tcg.discriminator_loss(tp["disc"], tp["gen"], CFG,
                                  _tbatch(_batch(n=10)))
    assert m["disc_acc"].dtype == torch.float32
    assert float(m["disc_acc"] * 20) == round(float(m["disc_acc"] * 20))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

# three Adam steps at lr 1e-3: each weight and moment tensor to 1e-5 of
# its largest entry, the metrics to 1e-5 relative (Adam's first step moves
# a weight by ~lr * sign(g), so a gradient near zero would show a rounding
# gap as a visible fraction of lr; none does at this size)
STEP_TOL = 1e-5


def test_three_gan_steps_match_jax(weights):
    jp, tp = weights
    jinit, jstep, jmetric = jsteps.make_gan_steps(
        jcfgs.SMOKE, jbase.OptimizerConfig(name="adam", lr=1e-3))
    tinit, tstep, tmetric = tsteps.make_gan_steps(
        CFG, OptimizerConfig(name="adam", lr=1e-3), device="cpu")
    _, jopt, jh = jinit(0)
    tparams, topt, th = tinit(0)
    assert th == jh == {"lr": 1e-3}
    jparams = jax.tree.map(jnp.asarray, jp)
    tparams = {h: {n: t.clone() for n, t in d.items()} for h, d in
               tp.items()}
    for step in range(3):
        batch = _batch(n=16, seed=20 + step)
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jh)
        tparams, topt, tm = tstep(tparams, topt, _tbatch(batch), th)
        assert sorted(tm) == sorted(jm) == sorted(
            ["g_loss", "d_loss", "disc_loss", "disc_acc", "recon",
             "forward", "cycle", "adv_gen", "latent"])
        for k in jm:
            assert tm[k].dim() == 0 and not tm[k].requires_grad
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       rtol=RTOL, atol=1e-7, err_msg=k)
        got = bridge.cyclegan_params_to_jax_layout(tparams)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(_np(jparams))):
            _close(a, b, rtol=STEP_TOL)
        assert int(topt["gen"]["step"]) == int(jopt["gen"]["step"]) \
            == step + 1
    val = _tbatch(_batch(n=16, seed=99))
    np.testing.assert_allclose(
        tmetric(tparams, val).item(),
        float(jmetric(jparams, {k: jnp.asarray(v.numpy())
                                for k, v in val.items()})), rtol=1e-4)
    # the Adam moments cross through the bridge too
    jm_back = bridge.cyclegan_opt_state_to_jax_layout(topt)
    for a, b in zip(jax.tree.leaves(jm_back["gen"]["m"]),
                    jax.tree.leaves(_np(jopt["gen"]["m"]))):
        _close(a, b, rtol=STEP_TOL)


def test_gan_step_writes_into_no_tensor(weights):
    """The step returns new weight and moment tensors and leaves the ones
    it was given as they were."""
    _, tp = weights
    init, step, _ = tsteps.make_gan_steps(CFG, OptimizerConfig(),
                                          device="cpu")
    _, opt, h = init(0)
    params = {hf: {n: t.clone() for n, t in d.items()} for hf, d in
              tp.items()}
    snap = {hf: {n: t.clone() for n, t in d.items()} for hf, d in
            params.items()}
    new, new_opt, _ = step(params, opt, _tbatch(_batch()), h)
    for hf in params:
        for n in params[hf]:
            assert torch.equal(params[hf][n], snap[hf][n])
            assert new[hf][n].data_ptr() != params[hf][n].data_ptr()
            assert not torch.equal(new[hf][n], params[hf][n])
    assert int(opt["gen"]["step"]) == 0 and int(new_opt["gen"]["step"]) == 1
    assert not opt["gen"]["m"]["fwd.0.weight"].any()


def test_metrics_build_no_graph_on_worker_threads(weights):
    """Grad mode is per thread: the tournament's metric runs without
    gradients on an executor's thread as on the main one."""
    from concurrent.futures import ThreadPoolExecutor

    _, tp = weights
    _, _, metric = tsteps.make_gan_steps(CFG, OptimizerConfig(),
                                         device="cpu")
    disc_metric = tsteps.make_gan_disc_metric(CFG)
    leaves = {h: {n: t.clone().requires_grad_() for n, t in d.items()}
              for h, d in tp.items()}
    batch = _tbatch(_batch())
    with ThreadPoolExecutor(2) as ex:
        outs = [ex.submit(metric, leaves, batch).result(),
                ex.submit(disc_metric, leaves, batch).result()]
    assert all(o.grad_fn is None and not o.requires_grad for o in outs)
    np.testing.assert_allclose(
        outs[1].item(), tcg.discriminator_metric(tp, CFG, batch).item(),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# train CLI
# ---------------------------------------------------------------------------


def test_train_cli_trains_the_cyclegan_on_cpu(capsys):
    out = tlaunch.train_cyclegan(tlaunch.build_parser().parse_args(
        ["--arch", "icf-cyclegan", "--smoke", "--device", "cpu", "--steps",
         "3", "--samples", "512", "--log-every", "1"]))
    text = capsys.readouterr().out
    lines = [ln for ln in text.splitlines() if ln.startswith("step ")]
    assert len(lines) == 3
    assert all(" g=" in ln and " d=" in ln and " val=" in ln
               for ln in lines)
    assert "[train] done: val=" in text
    assert np.isfinite(out["val"])
    assert all(map(np.isfinite, out["g_losses"] + out["d_losses"]))
    # the JAX launcher's config, not FULL
    ccfg = tlaunch.cyclegan_config(smoke=True)
    assert (ccfg.image_size, ccfg.enc_hidden, ccfg.dec_hidden) == \
        (16, (256, 64), (64, 256))
