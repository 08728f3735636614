"""Training the recurrent families in the port against the JAX package on
the CPU.

The selective scan's and the sLSTM's plain backwards (the CPU's stand-ins
for the backward kernels) against ``jax.vjp`` of the JAX oracles and
against autograd of the port's plain forwards; the Mamba, mLSTM and sLSTM
blocks, ``lm_loss`` and Adam train steps of xlstm-125m and jamba SMOKE
(with and without experts) against ``jax.value_and_grad`` and the jitted
JAX step; the train CLI; and a 2-trainer xlstm tournament against JAX's
population, its checkpoint crossing both ways.  f32 throughout, inputs
made with numpy, JAX weights carried across by ``repro_torch.bridge``.
The card's backward kernels are held against the plain backwards by the
``cuda``-marked tests of ``tests/test_torch_kernels.py`` and by
``chip_smoke.py``.
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jbase
from repro.configs import jamba_15_large as jax_jamba
from repro.configs import xlstm_125m as jax_xlstm
from repro.core import tournament as jtour
from repro.core.population import TrainerFns as JTrainerFns
from repro.data import tokens as jtokens
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.models import xlstm as jxl
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.bridge import (load_jax_params, opt_state_from_jax,
                                params_from_jax)
from repro_torch.configs import jamba_15_large, xlstm_125m
from repro_torch.configs.base import OptimizerConfig, replace
from repro_torch.core.population import TrainerFns
from repro_torch.core.tournament import (DataPlan, TournamentConfig,
                                         TournamentOrchestrator)
from repro_torch.data import tokens as ttokens
from repro_torch.kernels import ops, ref
from repro_torch.launch import ltfb as tltfb
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps as tsteps

# f32 on both sides, summed in different orders: tests/test_torch_train.py's
# tolerance, its atol taken relative to the compared tensor's largest entry
# where that exceeds 1 (gradients through the recurrences reach ~10, and an
# absolute 1e-5 would ask their rounding for 1e-6 of their scale)
TOL = dict(atol=1e-5, rtol=1e-5)
# (JAX config, port config) at f32
CONFIGS = {
    "xlstm": (dataclasses.replace(jax_xlstm.SMOKE, dtype="float32"),
              replace(xlstm_125m.SMOKE, dtype="float32")),
    "jamba": (dataclasses.replace(jax_jamba.SMOKE, moe=None,
                                  dtype="float32"),
              replace(jamba_15_large.SMOKE, moe=None, dtype="float32")),
    "jamba_moe": (dataclasses.replace(jax_jamba.SMOKE, dtype="float32"),
                  replace(jamba_15_large.SMOKE, dtype="float32")),
}
B, S = 2, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, what="", **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    tol = dict(tol or TOL)
    tol["atol"] *= max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_init(cfg, key):
    return jlm.init_lm(cfg, key)[0]


@functools.lru_cache(maxsize=None)
def _weights(family):
    return _jax_init(CONFIGS[family][0], jax.random.PRNGKey(0))


def _port_model(family, params=None):
    tcfg = CONFIGS[family][1]
    model = tlm.init_lm(tcfg, seed=0, device="cpu")
    return load_jax_params(model, _np(_weights(family) if params is None
                                      else params)).train()


def _scan_inputs(Bn, Sn, d, N, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((Bn, Sn, d)) - 2.0))
    a = -np.tile(np.arange(1, N + 1), (d, 1)) * rng.uniform(0.2, 1.0, (d, 1))
    return tuple(x.astype(np.float32) for x in (
        dt, rng.standard_normal((Bn, Sn, d)), rng.standard_normal((Bn, Sn, N)),
        rng.standard_normal((Bn, Sn, N)), a))


def _slstm_inputs(Bn, Sn, d, H, seed):
    dh = d // H
    return (_x((Bn, Sn, 4 * d), seed),
            _x((H, dh, 4 * dh), seed + 1, 1 / np.sqrt(dh)))


# ---------------------------------------------------------------------------
# (a), (b): the plain backwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 37, 12, 8), (1, 70, 5, 16)])
def test_mamba_scan_bwd_ref_matches_jax_vjp(shape):
    """A ragged S (not a multiple of the 32-step checkpoint tile) and a
    channel count no block divides: every input's gradient == ``jax.vjp``
    of ``repro.kernels.ref.mamba_scan_ref``."""
    args = _scan_inputs(*shape, seed=sum(shape))
    dy = _x(args[0].shape, 1)
    _, vjp = jax.vjp(jref.mamba_scan_ref, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    got = ref.mamba_scan_bwd_ref(*map(_t, args), _t(dy))
    for g, w, name in zip(got, want, ("dt", "xc", "bm", "cm", "a")):
        _close(g, w, name)


@pytest.mark.parametrize("shape", [(2, 23, 16, 2), (3, 9, 32, 4)])
def test_slstm_bwd_ref_matches_jax_vjp(shape):
    """Several heads, a ragged S: d_gx and d_r_h == ``jax.vjp`` of
    ``repro.kernels.ref.slstm_ref`` (gradients through the stabiliser m
    and the n clamp, JAX's tie rule)."""
    Bn, Sn, d, H = shape
    gx, r_h = _slstm_inputs(*shape, seed=Sn)
    dy = _x((Bn, Sn, d), 2)
    _, vjp = jax.vjp(lambda g, r: jref.slstm_ref(g, r, H), jnp.asarray(gx),
                     jnp.asarray(r_h))
    want = vjp(jnp.asarray(dy))
    got = ref.slstm_bwd_ref(_t(gx), _t(r_h), _t(dy))
    for g, w, name in zip(got, want, ("gx", "r_h")):
        _close(g, w, name)


def _slstm_tie_inputs(Bn, Sn, d, H, seed):
    """sLSTM inputs at which JAX's 1/2 : 1/2 rule for ``max(lf + m, i)``
    decides every step after the first: the i gate a constant 0.5, the f
    gate 100 (log sigmoid(100) vanishes beside 0.5 in f32), and r_h's i
    and f columns zero, so that lf + m_{t-1} == i from t = 1 on."""
    gx, r_h = _slstm_inputs(Bn, Sn, d, H, seed)
    dh = d // H
    gx[..., :d], gx[..., d:2 * d] = 0.5, 100.0
    r_h[..., :2 * dh] = 0.0
    return gx, r_h


def test_slstm_bwd_ref_matches_jax_vjp_at_exact_ties():
    """At exact ties of the stabiliser's max (checked step by step on the
    plain forward), d_gx and d_r_h == ``jax.vjp`` of
    ``repro.kernels.ref.slstm_ref``: both take half of the max's cotangent
    to each side."""
    Bn, Sn, d, H = 2, 19, 16, 2
    gx, r_h = _slstm_tie_inputs(Bn, Sn, d, H, 5)
    gxt, rt = _t(gx), _t(r_h)
    z = torch.zeros((Bn, d))
    state = (z, z, z, torch.full_like(z, -1e9))
    ties = []
    for t in range(Sn):
        gates = gxt[:, t] + ref.slstm_recurrent(state[0], rt)
        it, ft = gates[:, :d], gates[:, d:2 * d]
        ties.append(bool((torch.nn.functional.logsigmoid(ft) + state[3]
                          == it).all()))
        state = ref.slstm_step(gates, state)
    assert ties == [False] + [True] * (Sn - 1)
    dy = _x((Bn, Sn, d), 6)
    _, vjp = jax.vjp(lambda g, r: jref.slstm_ref(g, r, H), jnp.asarray(gx),
                     jnp.asarray(r_h))
    want = vjp(jnp.asarray(dy))
    got = ref.slstm_bwd_ref(gxt, rt, _t(dy))
    for g, w, name in zip(got, want, ("gx", "r_h")):
        _close(g, w, name)


def test_slstm_bwd_ref_matches_jax_cell_vjp_at_ties_with_final_cotangents():
    """At the same ties, with nonzero cotangents of the final (h, c, n, m):
    the plain backward == ``jax.vjp`` of a ``lax.scan`` over the JAX
    model's own cell (``xlstm._slstm_cell``).  Through the outputs alone
    the stabiliser's cotangent cancels to rounding (h does not depend on
    m), so it is the final m's cotangent that makes the 1/2 : 1/2 share
    of the tied max count."""
    Bn, Sn, d, H = 2, 19, 16, 2
    gx, r_h = _slstm_tie_inputs(Bn, Sn, d, H, 7)
    cfg = SimpleNamespace(num_heads=H, d_model=d)

    def scan(g, r):
        z = jnp.zeros((Bn, d), jnp.float32)
        st = {"h": z, "c": z, "n": z, "m": jnp.full((Bn, d), -1e9)}
        st, hs = jax.lax.scan(lambda s, x: jxl._slstm_cell({"r_h": r}, cfg,
                                                            s, x)[::-1],
                              st, g.swapaxes(0, 1))
        return hs.swapaxes(0, 1), (st["h"], st["c"], st["n"], st["m"])

    dy = _x((Bn, Sn, d), 8)
    dfin = tuple(_x((Bn, d), 9 + i) for i in range(4))
    _, vjp = jax.vjp(scan, jnp.asarray(gx), jnp.asarray(r_h))
    want = vjp((jnp.asarray(dy), tuple(map(jnp.asarray, dfin))))
    got = ref.slstm_bwd_ref(_t(gx), _t(r_h), _t(dy), tuple(map(_t, dfin)))
    for g, w, name in zip(got, want, ("gx", "r_h")):
        _close(g, w, name)


def test_scan_bwd_refs_match_autograd_with_final_state_cotangents():
    """Nonzero cotangents of the final states (JAX's oracles return none):
    both plain backwards == ``torch.autograd`` of the port's plain
    forwards, and the ops' autograd Functions on the CPU run them."""
    args = [_t(a).requires_grad_() for a in _scan_inputs(2, 41, 6, 8, 3)]
    y, h_last = ref.mamba_scan_ref(*args)
    dy, dh = _t(_x(y.shape, 11)), _t(_x(h_last.shape, 12))
    torch.autograd.backward([y, h_last], [dy, dh])
    got = ref.mamba_scan_bwd_ref(*(a.detach() for a in args), dy, dh)
    for g, a in zip(got, args):
        _close(g, a.grad)
    y2, h2 = ops.mamba_scan(*args)
    grads = torch.autograd.grad([y2, h2], args, [dy, dh])
    for g, want in zip(grads, got):
        assert torch.equal(g, want)

    Bn, Sn, d, H = 2, 17, 16, 2
    gx, r_h = (_t(a).requires_grad_() for a in _slstm_inputs(Bn, Sn, d, H, 4))
    out, state = ref.slstm_ref(gx, r_h)
    dout = _t(_x(out.shape, 13))
    dfin = tuple(_t(_x(s.shape, 14 + i)) for i, s in enumerate(state))
    torch.autograd.backward([out, *state], [dout, *dfin])
    got = ref.slstm_bwd_ref(gx.detach(), r_h.detach(), dout, dfin)
    _close(got[0], gx.grad, "gx")
    _close(got[1], r_h.grad, "r_h")
    out2, state2 = ops.slstm_scan(gx, r_h)
    grads = torch.autograd.grad([out2, *state2], [gx, r_h], [dout, *dfin])
    assert torch.equal(grads[0], got[0]) and torch.equal(grads[1], got[1])


# ---------------------------------------------------------------------------
# (c): the blocks
# ---------------------------------------------------------------------------

BLOCKS = {  # family, period position of the block, JAX block function
    "mamba": ("jamba", 0, jssm.mamba_block),
    "mlstm": ("xlstm", 0, jxl.mlstm_block),
    "slstm": ("xlstm", 1, jxl.slstm_block),
}
PORT_BLOCKS = {"mamba": tssm.mamba_core, "mlstm": txl.mlstm_block,
               "slstm": txl.slstm_block}


@pytest.mark.parametrize("kind,seq", [("mamba", 150), ("mlstm", 11),
                                      ("slstm", 11)])
def test_block_output_and_every_gradient_match_jax(kind, seq):
    """A block's output and the gradient of every one of its weights and
    of its input under a random output cotangent == ``jax.vjp`` of the
    JAX block; S = 150 runs past JAX's 128-step Mamba chunk (its pad
    steps touch no gradient)."""
    family, j, jax_block = BLOCKS[kind]
    jcfg = CONFIGS[family][0]
    p = jax.tree.map(lambda a: a[0], _weights(family)["body"][j]["mixer"])
    mixer = _port_model(family).blocks[j].mixer
    x = _x((B, seq, jcfg.d_model), 5)
    ct = _x((B, seq, jcfg.d_model), 6)

    @jax.jit
    def jax_side(p, x, ct):
        out, vjp = jax.vjp(lambda p, x: jax_block(p, jcfg, x), p, x)
        return out, vjp(ct)

    want, (gp, gx) = jax_side(p, jnp.asarray(x), jnp.asarray(ct))
    xt = _t(x).requires_grad_()
    out, _ = PORT_BLOCKS[kind](mixer, xt)
    out.backward(_t(ct))
    _close(out, want, "out")
    _close(xt.grad, gx, "x")
    got = {n: p.grad for n, p in mixer.named_parameters()}
    assert all(g is not None for g in got.values())
    for name, g in got.items():
        leaf = gp[name.split(".")[0]]
        want_g = np.asarray(leaf)
        if g.dim() == 2 and name.endswith(".weight"):
            want_g = want_g.T                     # nn.Linear stores (out, in)
        _close(g, want_g, name)


# ---------------------------------------------------------------------------
# (d), (e): the LM loss, its gradients and train steps
# ---------------------------------------------------------------------------


def _batch(jcfg, seed):
    b = jtokens.train_batch(jcfg, B, S, seed=seed)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: _t(v).long() for k, v in b.items()})


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(family):
    jcfg = CONFIGS[family][0]
    jb, _ = _batch(jcfg, seed=5)
    jb["labels"] = jb["labels"].at[0, 3].set(-1)
    (loss, metrics), grads = jax.jit(lambda p, b: jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, b), has_aux=True)(p))(
            _weights(family), jb)
    return float(loss), float(metrics["ce"]), _np(grads)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("family", ["xlstm", "jamba", "jamba_moe"])
def test_lm_loss_and_every_gradient_match_jax(family, remat):
    """``lm_loss`` (one label masked) and the gradient of every weight ==
    ``jax.value_and_grad`` of ``lm.lm_loss`` for xlstm-125m SMOKE and
    jamba SMOKE without and with its experts; ``remat="full"`` recomputes
    each block's scan forward inside the backward and must give the same
    values (JAX's remat leaves its values as they are, so one JAX run
    holds both)."""
    jcfg, tcfg = CONFIGS[family]
    jloss, jce, jgrads = _jax_loss_and_grads(family)
    _, tb = _batch(jcfg, seed=5)
    tb["labels"][0, 3] = -1
    model = _port_model(family)
    loss, metrics = tlm.lm_loss(model, tb, remat=remat)
    loss.backward()
    _close(loss, jloss, "loss")
    _close(metrics["ce"], jce, "ce")
    want = params_from_jax(jgrads, tcfg)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        _close(got[n], want[n], n)
        assert bool(torch.isfinite(got[n]).all())
    # every weight the loss reads trains, the recurrent ones included
    assert all(bool((g != 0).any()) for n, g in got.items()
               if "r_h" in n or "A_log" in n or "conv_w" in n
               or "w_if" in n or "dt_bias" in n)


@pytest.mark.parametrize("family", ["xlstm", "jamba"])
def test_three_train_steps_match_jax(family):
    """Three ``make_lm_train_step`` steps (Adam, clip 1.0, warmup 2,
    remat full) == the jitted JAX step: loss, lr and grad norm per step,
    then every weight and Adam's m, v and step count, name by name."""
    jcfg, tcfg = CONFIGS[family]
    weights = _weights(family)
    opt = jbase.OptimizerConfig(lr=1e-3, warmup_steps=2)
    jstep = jax.jit(jsteps.make_lm_train_step(
        jcfg, opt, jbase.MeshConfig(remat="full")))
    jstate = {"params": weights,
              "opt_state": jopt.make_optimizer(opt).init(weights)}
    topt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2)
    model = _port_model(family)
    tstate = {"model": model, "opt_state": topt.make_optimizer(
        topt_cfg).init(dict(model.named_parameters()))}
    tstep = tsteps.make_lm_train_step(tcfg, topt_cfg, remat="full")
    for i in range(3):
        jb, tb = _batch(jcfg, seed=i)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        for key in ("loss", "lr", "grad_norm"):
            _close(tm[key], float(jm[key]), f"step {i} {key}")
    want_p = params_from_jax(_np(jstate["params"]), tcfg)
    for n, p in tstate["model"].named_parameters():
        _close(p, want_p[n], n)
    want = opt_state_from_jax(_np(jstate["opt_state"]), tcfg)
    assert int(tstate["opt_state"]["step"]) == int(want["step"]) == 3
    for n in want["m"]:
        _close(tstate["opt_state"]["m"][n], want["m"][n], "m " + n)
        # v holds squared gradients: tests/test_torch_train.py's scaling
        _close(tstate["opt_state"]["v"][n], want["v"][n], "v " + n,
               atol=1e-10, rtol=2e-5)


# ---------------------------------------------------------------------------
# (f): the train CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-1.5-large-398b"])
def test_train_cli_trains_the_recurrent_archs(arch, capsys, tmp_path):
    """``--arch xlstm-125m`` / ``jamba-1.5-large-398b --smoke --device
    cpu``: finite losses and a finite validation loss; a checkpoint in
    JAX's layout, from which a rerun resumes."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path)]
    out = tlaunch.train_lm(tlaunch.build_parser().parse_args(
        argv + ["--steps", "3"]))
    text = capsys.readouterr().out
    assert sum(ln.startswith("step ") for ln in text.splitlines()) == 3
    assert np.isfinite(out["val"]) and all(map(np.isfinite, out["losses"]))
    assert (tmp_path / "step_2.ckpt").exists()
    again = tlaunch.train_lm(tlaunch.build_parser().parse_args(
        argv + ["--steps", "3"]))
    assert again["start"] == 2 and len(again["losses"]) == 1
    assert np.isfinite(again["losses"][0])


# ---------------------------------------------------------------------------
# (g): an xlstm tournament
# ---------------------------------------------------------------------------

LM_K, LM_ROUNDS, LM_STEPS, LM_SEQ, LM_B = 2, 2, 2, 12, 2


def _tour_cfg(**kw):
    return dict(trainers=LM_K, scope="full", batch_size=LM_B, num_ranks=2,
                tournament_batches=1, tournament_batch_size=LM_B, seed=0,
                **kw)


@pytest.fixture(scope="module")
def xlstm_fns():
    jcfg, tcfg = CONFIGS["xlstm"]
    opt = dict(name="adam", lr=1e-3, warmup_steps=1)
    jfns = JTrainerFns(*jsteps.make_lm_population_fns(
        jcfg, jbase.OptimizerConfig(**opt)))
    tfns = TrainerFns(*tsteps.make_lm_population_fns(
        tcfg, OptimizerConfig(**opt), device="cpu"))

    def init(seed):
        jp, jo, h = jfns.init(seed)
        return (*tfns.from_ckpt(_np(jp), _np(jo)), h)

    return jfns, dataclasses.replace(tfns, init=init)


@pytest.fixture(scope="module")
def xlstm_runs(xlstm_fns, tmp_path_factory):
    """Both packages' orchestrators after LM_ROUNDS rounds over the same
    token shards, their tournament logs and a population checkpoint each."""
    jfns, tfns = xlstm_fns
    root = tmp_path_factory.mktemp("torch_recurrent_ltfb")
    files = ttokens.write_token_shards(
        str(root / "shards"), 48, seq_len=LM_SEQ,
        vocab=CONFIGS["xlstm"][1].vocab_size, samples_per_file=8, seed=0)
    jorch = jtour.TournamentOrchestrator(
        jfns, jtour.DataPlan.lm_tokens(files),
        jtour.TournamentConfig(**_tour_cfg(ckpt_dir=str(root / "jax"))))
    torch_orch = TournamentOrchestrator(
        tfns, DataPlan.lm_tokens(files),
        TournamentConfig(**_tour_cfg(ckpt_dir=str(root / "port"),
                                     device="cpu")))
    logs = []
    try:
        for _ in range(LM_ROUNDS):
            jorch.train_round(LM_STEPS)
            torch_orch.train_round(LM_STEPS)
            logs.append((jorch.tournament(), torch_orch.tournament()))
        jorch.save_checkpoint()
        torch_orch.save_checkpoint()
        yield jorch, torch_orch, logs
    finally:
        jorch.close()
        torch_orch.close()


def test_xlstm_tournament_matches_jax(xlstm_runs):
    """Same pairings, metrics (1e-5 relative), decisions, wins and losses
    as JAX's population over 2 rounds x 2 steps of 2 xlstm trainers."""
    jorch, torch_orch, logs = xlstm_runs
    for jlog, tlog in logs:
        assert tlog["partner"] == jlog["partner"] == [1, 0]
        assert tlog["exchange_bytes"] == jlog["exchange_bytes"] > 0
        assert (tlog["exchanged"], tlog["kept_local"]) == \
            (jlog["exchanged"], jlog["kept_local"])
        for (i, j, jl, jo), (ti, tj, tl, to) in zip(jlog["metrics"],
                                                    tlog["metrics"]):
            assert (ti, tj) == (i, j)
            np.testing.assert_allclose([tl, to], [jl, jo], rtol=1e-5)
            assert (to < tl) == (jo < jl)
    for jt, tt in zip(jorch.population.trainers,
                      torch_orch.population.trainers):
        assert (tt.steps, tt.wins, tt.adoptions) == \
            (jt.steps, jt.wins, jt.adoptions)
        np.testing.assert_allclose(tt.last_metrics["loss"],
                                   jt.last_metrics["loss"], rtol=1e-5)


def test_xlstm_population_checkpoints_cross_both_ways(xlstm_runs,
                                                      xlstm_fns):
    """The port's population checkpoint restores in JAX bit for bit,
    weights and Adam state (``r_h``, the mLSTM gates and the rest), and
    JAX's into a fresh port orchestrator."""
    jfns, tfns = xlstm_fns
    jorch, torch_orch, _ = xlstm_runs
    jp, jo, _ = jfns.init(0)
    got = jckpt.restore_population(torch_orch.cfg.ckpt_dir, LM_ROUNDS,
                                   {"params": jp, "opt_state": jo})
    for t, tr in zip(torch_orch.population.trainers, got["trainers"]):
        want_p, want_o = tfns.to_ckpt(t.params, t.opt_state)
        for a, b in zip(jax.tree.leaves(_np({"p": tr["params"],
                                             "o": tr["opt_state"]})),
                        jax.tree.leaves({"p": want_p, "o": want_o})):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    fresh = TournamentOrchestrator(
        tfns, DataPlan.lm_tokens(torch_orch.plan.files),
        TournamentConfig(**_tour_cfg(ckpt_dir=jorch.cfg.ckpt_dir,
                                     device="cpu")))
    try:
        assert fresh.maybe_resume()
        for jt, tt in zip(jorch.population.trainers,
                          fresh.population.trainers):
            p, o = tfns.from_ckpt(_np(jt.params), _np(jt.opt_state))
            assert any("r_h" in n for n in p)
            for n in p:
                assert torch.equal(tt.params[n], p[n]), n
                for mom in ("m", "v"):
                    assert torch.equal(tt.opt_state[mom][n], o[mom][n])
    finally:
        fresh.close()


def test_ltfb_cli_runs_an_xlstm_tournament(capsys, tmp_path):
    """``python -m repro_torch.launch.ltfb --arch xlstm-125m``: two
    trainers, two rounds, a checkpoint and a rerun that resumes."""
    argv = ["--arch", "xlstm-125m", "--smoke", "--device", "cpu",
            "--trainers", "2", "--rounds", "1", "--steps-per-round", "1",
            "--batch", "2", "--seq", "12", "--samples", "48",
            "--samples-per-file", "16", "--ckpt-dir", str(tmp_path / "c"),
            "--data-dir", str(tmp_path / "d")]
    assert tltfb.main(argv) == 0
    text = capsys.readouterr().out
    assert "[ltfb] round=" in text
    best = float(text.split("best_val=")[1].split()[0])
    assert np.isfinite(best)
    assert tltfb.main(argv[:7] + ["--rounds", "2"] + argv[9:]) == 0
    assert "[ltfb] resumed at round 1" in capsys.readouterr().out
