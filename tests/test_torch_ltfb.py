"""The port's LTFB path against the JAX package on the CPU: pairings, the
population's decisions, checkpoints crossing between the packages, the
datastore, the orchestrator and the ltfb CLI, for the CycleGAN and for LM
trainers over token shards.

The SMOKE CycleGAN and the SMOKE qwen3 in f32 on both sides; JAX weights
cross through ``repro_torch.bridge``; every batch is made with numpy and
fed to both packages.  Tolerances are stated per test.
"""
import dataclasses
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jbase
from repro.configs import icf_cyclegan as jcfgs
from repro.configs import qwen3_06b as jqwen3
from repro.core import ltfb as jltfb
from repro.core import tournament as jtour
from repro.core.population import Population as JPopulation
from repro.core.population import TrainerFns as JTrainerFns
from repro.data import jag as jjag
from repro.data import tokens as jtokens
from repro.datastore import store as jstore
from repro.train import steps as jsteps
from repro.train import telemetry as jtel
from repro_torch import bridge
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import icf_cyclegan as tcfgs
from repro_torch.configs import qwen3_06b as tqwen3
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core import ltfb as tltfb
from repro_torch.core.population import Population, TrainerFns
from repro_torch.core.tournament import (DataPlan, TournamentConfig,
                                         TournamentOrchestrator)
from repro_torch.data import jag as tjag
from repro_torch.data import tokens as ttokens
from repro_torch.datastore import store as tstore
from repro_torch.launch import ltfb as tlaunch
from repro_torch.train import steps as tsteps
from repro_torch.train import telemetry as ttel

CFG = tcfgs.SMOKE


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(n, seed):
    sim = tjag.jag_simulate(tjag.sample_inputs(n, seed=seed),
                            CFG.image_size)
    return {"x": sim["x"], "y": tjag.flatten_outputs(sim)}


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _cpu_args(*extra):
    return tlaunch.finish_args(tlaunch.build_parser().parse_args(
        ["--smoke", "--device", "cpu", *extra]))


@pytest.fixture(scope="module")
def fns():
    """The ltfb launcher's SMOKE trainer functions on the CPU."""
    return tlaunch.build_fns(_cpu_args())


@pytest.fixture(scope="module")
def bundle_files(tmp_path_factory):
    # 9 bundles: the orchestrator holds the last one out, leaving 8
    root = tmp_path_factory.mktemp("torch_ltfb_jag")
    return tjag.write_bundles(str(root), num_samples=288,
                              samples_per_file=32, image_size=8, seed=0)


# ---------------------------------------------------------------------------
# pairing, scope, accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 16])
def test_random_pairing_equals_jax(k):
    """Exact equality over rounds, seeds and dead-trainer patterns."""
    rng = np.random.default_rng(k)
    for round_idx in (0, 1, 2, 7, 123):
        for seed in (0, 1, 42):
            for alive in (None, list(rng.random(k) < 0.6),
                          [i % 3 != 1 for i in range(k)]):
                got = tltfb.random_pairing(k, round_idx, seed, alive)
                want = jltfb.random_pairing(k, round_idx, seed, alive)
                np.testing.assert_array_equal(got, want)
                assert np.array_equal(got[got], np.arange(k))


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_butterfly_pairing_and_perm_equal_jax(k):
    for round_idx in range(6):
        got = tltfb.butterfly_pairing(k, round_idx)
        np.testing.assert_array_equal(got, jltfb.butterfly_pairing(
            k, round_idx))
        assert tltfb.pairing_to_perm(got) == jltfb.pairing_to_perm(got)


def test_scope_split_merge_and_bytes_match_jax(fns):
    params, _, _ = fns.init(0)
    for scope in ("full", "generator"):
        exch, local = tltfb.split_scope(params, scope)
        assert tltfb.merge_scope(exch, local, scope) == params
    exch, local = tltfb.split_scope(params, "generator")
    assert exch is params["gen"] and local == {"disc": params["disc"]}
    jgen = bridge.cyclegan_params_to_jax_layout(params)["gen"]
    assert tltfb.tree_nbytes(exch) == jltfb.tree_nbytes(jgen) \
        == 4 * sum(t.numel() for t in exch.values())
    with pytest.raises(ValueError):
        tltfb.split_scope(params, "nope")


def test_efficiency_snapshot_equals_jax():
    per = [{"steps": 25, "train_seconds": 2.0, "data_wait_seconds": 0.1},
           {"steps": 25, "train_seconds": 2.5, "data_wait_seconds": 0.0},
           {"steps": 0, "train_seconds": 0.0}]
    for args in ((per, 32, 0.5, 6.0), ([], 32, 0.0, 0.0)):
        assert ttel.efficiency_snapshot(*args) == \
            jtel.efficiency_snapshot(*args)


# ---------------------------------------------------------------------------
# population against JAX's
# ---------------------------------------------------------------------------

K, ROUNDS, STEPS = 4, 2, 2
# a decision is compared where the two metrics of the pair differ by more
# than this (relative): closer pairs may fall either way in f32
DECIDE_REL = 1e-4


def test_population_matches_jax():
    """Same partners, same adoptions (where the metrics are apart), same
    perturbed lrs, best_val to 1e-5 relative, over 2 rounds x 2 steps of
    4 trainers fed the same numpy batches."""
    opt = dict(name="adam", lr=1e-3)
    jinit, jstep, jmetric = jsteps.make_gan_steps(
        jcfgs.SMOKE, jbase.OptimizerConfig(**opt))
    tinit, tstep, tmetric = tsteps.make_gan_steps(
        CFG, OptimizerConfig(**opt), device="cpu")

    def init(seed):                  # the JAX weights, the port's Adam
        jp, _, h = jinit(seed)
        tp = bridge.cyclegan_params_from_jax(_np(jp))
        _, topt, _ = tinit(seed)
        return tp, topt, h

    batches = [[_batch(16, 100 * i + s) for s in range(ROUNDS * STEPS)]
               for i in range(K)]
    held = [[_batch(16, 7000 + i)] for i in range(K)]
    val = _batch(32, 9999)

    def loaders(wrap):
        out = []
        for bs in batches:
            it = iter(bs)
            out.append(lambda it=it: wrap(next(it)))
        return out

    jpop = JPopulation(JTrainerFns(jinit, jstep, jmetric), loaders(
        lambda b: b), held, scope="generator", seed=0)
    tpop = Population(TrainerFns(init, tstep, tmetric), loaders(_tb),
                      [[_tb(b) for b in h] for h in held],
                      scope="generator", seed=0)
    compared = 0
    for _ in range(ROUNDS):
        jpop.train_round(STEPS)
        tpop.train_round(STEPS)
        jlog, tlog = jpop.tournament(), tpop.tournament()
        assert tlog["partner"] == jlog["partner"]
        assert tlog["exchange_bytes"] == jlog["exchange_bytes"]
        for (i, j, jl, jo), (ti, tj, tl, to) in zip(jlog["metrics"],
                                                    tlog["metrics"]):
            assert (ti, tj) == (i, j)
            np.testing.assert_allclose([tl, to], [jl, jo], rtol=1e-5)
            if abs(jo - jl) > DECIDE_REL * abs(jl):
                assert (to < tl) == (jo < jl), (i, j, jl, jo, tl, to)
                compared += 1
        for jt, tt in zip(jpop.trainers, tpop.trainers):
            assert tt.hparams["lr"] == jt.hparams["lr"]
            assert (tt.adoptions, tt.wins) == (jt.adoptions, jt.wins)
    print(f"compared {compared} tournament decisions")
    assert compared >= 1
    assert any(t.adoptions for t in tpop.trainers)
    assert any(t.hparams["lr"] != 1e-3 for t in tpop.trainers)
    np.testing.assert_allclose(
        tpop.best_metric(_tb(val)),
        jpop.best_metric({k: jnp.asarray(v) for k, v in val.items()}),
        rtol=1e-5)


def test_adopted_generator_is_never_written_through(fns):
    """Trainer 0 adopts trainer 1's generator (the same tensors, by
    reference); a step of either leaves the other's weights as they were,
    and the two keep their own Adam states."""
    batch = _tb(_batch(16, 5))

    def metric(params, b):
        # trainer 1's generator wins every comparison it is in
        return 0.0 if params["gen"] is gen1 else 1.0

    pop = Population(TrainerFns(fns.init, fns.train_step, metric),
                     [lambda: batch] * 2, [[batch]] * 2, scope="generator")
    gen1 = pop.trainers[1].params["gen"]
    log = pop.tournament()
    t0, t1 = pop.trainers
    assert log["exchanged"] == 1 and t0.adoptions == 1
    assert t0.params["gen"] is t1.params["gen"]
    assert t0.params["disc"] is not t1.params["disc"]
    assert t0.opt_state is not t1.opt_state

    def snap(gen):
        return {n: t.clone() for n, t in gen.items()}

    before = snap(t0.params["gen"])
    pop.fail(0)
    pop.train_round(1)                       # trainer 1 steps alone
    assert t1.steps == 1 and t0.steps == 0
    assert all(torch.equal(t0.params["gen"][n], before[n]) for n in before)
    assert not torch.equal(t1.params["gen"]["fwd.0.weight"],
                           before["fwd.0.weight"])
    assert int(t0.opt_state["gen"]["step"]) == 0
    pop.recover(0)
    pop.fail(1)
    before1 = snap(t1.params["gen"])
    pop.train_round(1)                       # and now trainer 0 alone
    assert all(torch.equal(t1.params["gen"][n], before1[n])
               for n in before1)
    assert int(t0.opt_state["gen"]["step"]) == 1
    assert int(t1.opt_state["gen"]["step"]) == 1


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _port_population_state(fns, k=3):
    """A port population state after one step each (Adam moments set)."""
    trainers = []
    for i in range(k):
        p, o, h = fns.init(10 + i)
        p, o, _ = fns.train_step(p, o, _tb(_batch(16, 50 + i)), h)
        trainers.append({"params": p, "opt_state": o,
                         "hparams": {"lr": h["lr"] * (i + 1)},
                         "steps": 5 * i, "alive": i != 1, "wins": i,
                         "adoptions": 2 * i})
    return {"round": 2, "seed": 3, "scope": "generator",
            "trainers": trainers}


def _saved(fns, state):
    out = dict(state, trainers=[])
    for tr in state["trainers"]:
        p, o = fns.to_ckpt(tr["params"], tr["opt_state"])
        out["trainers"].append(dict(tr, params=p, opt_state=o))
    return out


def _jax_like():
    init, _, _ = jsteps.make_gan_steps(jcfgs.SMOKE, jbase.OptimizerConfig())
    p, o, _ = init(0)
    return {"params": p, "opt_state": o}


def test_population_saved_by_the_port_restores_in_jax(fns, tmp_path):
    state = _saved(fns, _port_population_state(fns))
    tckpt.save_population(str(tmp_path), 7, state)
    got = jckpt.restore_population(str(tmp_path), 7, _jax_like())
    assert (got["round"], got["seed"], got["scope"]) == (2, 3, "generator")
    for want, tr in zip(state["trainers"], got["trainers"]):
        for key in ("hparams", "steps", "alive", "wins", "adoptions"):
            assert tr[key] == want[key], key
        w = {"params": want["params"], "opt_state": want["opt_state"]}
        g = {"params": tr["params"], "opt_state": tr["opt_state"]}
        assert jax.tree.structure(_np(g)) == jax.tree.structure(w)
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(np.asarray(a), b)


def test_population_saved_by_jax_restores_in_the_port(fns, tmp_path):
    jinit, jstep, _ = jsteps.make_gan_steps(jcfgs.SMOKE,
                                            jbase.OptimizerConfig())
    trainers = []
    for i in range(2):
        p, o, h = jinit(i)
        b = _batch(16, 60 + i)
        p, o, _ = jstep(p, o, {k: jnp.asarray(v) for k, v in b.items()}, h)
        trainers.append({"params": p, "opt_state": o, "hparams": h,
                         "steps": i + 1, "alive": True})
    jckpt.save_population(str(tmp_path), 4, {"round": 1, "seed": 0,
                                             "scope": "generator",
                                             "trainers": trainers})
    p0, o0, _ = fns.init(0)
    like_p, like_o = fns.to_ckpt(p0, o0)
    got = tckpt.restore_population(str(tmp_path), 4,
                                   {"params": like_p, "opt_state": like_o},
                                   num_trainers=3)      # K' = 3 != K = 2
    assert got["round"] == 1 and len(got["trainers"]) == 3
    for i, tr in enumerate(got["trainers"]):
        src = trainers[i % 2]
        p, o = fns.from_ckpt(tr["params"], tr["opt_state"])
        want_p = bridge.cyclegan_params_from_jax(_np(src["params"]))
        want_o = bridge.cyclegan_opt_state_from_jax(_np(src["opt_state"]))
        for half in ("gen", "disc"):
            assert list(p[half]) == list(p0[half])
            for n in want_p[half]:
                assert p[half][n].dtype == torch.float32
                assert torch.equal(p[half][n], want_p[half][n]), n
                for mom in ("m", "v"):
                    assert torch.equal(o[half][mom][n],
                                       want_o[half][mom][n]), (mom, n)
            assert int(o[half]["step"]) == 1
        assert tr["steps"] == src["steps"]
    # K' = 1 < K: the first trainer only
    one = tckpt.restore_population(str(tmp_path), 4,
                                   {"params": like_p, "opt_state": like_o},
                                   num_trainers=1)
    assert len(one["trainers"]) == 1


def _tree_pair():
    t = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "b": (torch.ones(4, dtype=torch.bfloat16) * 1.5,
               {"c": torch.tensor(3, dtype=torch.int32)})}
    j = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
         "b": (jnp.ones((4,), jnp.bfloat16) * 1.5,
               {"c": jnp.array(3, jnp.int32)})}
    return t, j


def test_checkpoint_files_match_jax_and_write_atomically(tmp_path,
                                                         monkeypatch):
    """The same tree saved by each package: the same keys, dtype markers
    and bits; the write goes to ``.tmp``, is fsynced, then renamed."""
    t, j = _tree_pair()
    tpath, jpath = str(tmp_path / "t.ckpt"), str(tmp_path / "j.ckpt")
    calls = []
    real_fsync, real_replace = os.fsync, os.replace
    monkeypatch.setattr(tckpt.os, "fsync", lambda fd: (
        calls.append(("fsync", os.readlink(f"/proc/self/fd/{fd}"))),
        real_fsync(fd)))
    monkeypatch.setattr(tckpt.os, "replace", lambda a, b: (
        calls.append(("replace", a, b)), real_replace(a, b)))
    tckpt.save(tpath, t, {"step": 7})
    monkeypatch.undo()
    assert calls[0] == ("fsync", tpath + ".tmp.npz")
    assert calls[1] == ("replace", tpath + ".tmp.npz", tpath)
    assert not os.path.exists(tpath + ".tmp") and \
        not os.path.exists(tpath + ".tmp.npz")
    jckpt.save(jpath, j, {"step": 7})
    with np.load(tpath) as zt, np.load(jpath) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        assert json.loads(str(zt["__dtypes__"])) == \
            json.loads(str(zj["__dtypes__"]))
        assert "kb::i0" in zt.files and "kb::i1::kc" in zt.files
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype
            np.testing.assert_array_equal(zt[k], zj[k])
    # each package restores the other's file
    got, meta = tckpt.restore(jpath, t)
    assert meta == {"step": 7}
    for n, (a, b) in enumerate(zip(jax.tree.leaves(got),
                                   jax.tree.leaves(t))):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    back, _ = jckpt.restore(tpath, j)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(j)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_async_checkpointer_snapshots_before_writing(tmp_path):
    t, _ = _tree_pair()
    path = str(tmp_path / "step_3.ckpt")
    ac = tckpt.AsyncCheckpointer()
    ac.save(path, t, {"step": 3})
    t["a"].add_(100.0)                      # a later step changes it
    ac.wait()
    got, meta = tckpt.restore(path, t)
    assert meta["step"] == 3
    assert torch.equal(got["a"], torch.arange(6.0).reshape(2, 3))
    assert tckpt.latest_step_path(str(tmp_path)) == path
    assert tckpt.latest_step_path(str(tmp_path / "none")) is None
    assert tckpt.latest_population_step(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# datastore against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["preload", "dynamic", "none"])
def test_datastore_equals_jax(bundle_files, mode):
    """Permutations, batches and every counter, step by step."""
    files = bundle_files[:5]
    kw = dict(num_ranks=2, mode=mode, seed=3)
    ts = tstore.DataStore(files, tjag.read_bundle, **kw)
    js = jstore.DataStore(files, jjag.read_bundle, **kw)
    if mode == "preload":
        ts.preload(parallel=False)
        js.preload(parallel=False)
    assert ts.num_samples == js.num_samples == 160
    for epoch in range(3):
        np.testing.assert_array_equal(ts.epoch_permutation(epoch),
                                      js.epoch_permutation(epoch))
        perm = js.epoch_permutation(epoch)
        for step in range(ts.steps_per_epoch(24) + 1):     # one wrap
            a = ts.get_batch(perm, step, 24, consumer_rank=step % 2)
            b = js.get_batch(perm, step, 24, consumer_rank=step % 2)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        stats = ts.stats.as_dict()
        want = js.stats.as_dict()
        stats.pop("preload_seconds"), want.pop("preload_seconds")
        assert stats == want
    assert tstore.aggregate_stats([ts]) == {
        k: float(v) for k, v in ts.stats.as_dict().items()}
    for k in (1, 2, 3, 5):
        for i in range(k):
            for strategy in ("stride", "block"):
                assert tstore.partition_files(files, k, i, strategy) == \
                    jstore.partition_files(files, k, i, strategy)


def test_prefetch_loader_delivers_jax_batches(bundle_files):
    ts = tstore.DataStore(bundle_files[:4], tjag.read_bundle, num_ranks=2,
                          seed=1)
    js = jstore.DataStore(bundle_files[:4], jjag.read_bundle, num_ranks=2,
                          seed=1)
    ts.preload()
    js.preload()
    tl = tstore.PrefetchLoader(ts, 40, consumer_rank=None)
    jl = jstore.PrefetchLoader(js, 40, consumer_rank=None)
    try:
        for _ in range(7):                  # past an epoch (3 steps)
            a, b = tl.next(timeout=30), jl.next(timeout=30)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        assert tl.batches_delivered == 7
    finally:
        tl.close()
        jl.close()
    assert not tl._thread.is_alive()


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------


def _orch(fns, files, k=4, **kw):
    cfg = TournamentConfig(trainers=k, scope="generator", batch_size=16,
                           num_ranks=2, tournament_batches=1,
                           tournament_batch_size=32, seed=0, device="cpu",
                           **kw)
    return TournamentOrchestrator(fns, DataPlan.jag_cyclegan(files), cfg)


def test_orchestrator_rounds_fail_recover_rescale(fns, bundle_files):
    with _orch(fns, bundle_files) as orch:
        trace = orch.run(rounds=2, steps_per_round=2)
        assert len(trace) == 2 and all(np.isfinite(trace))
        st = orch.stats()
        assert [d["steps"] for d in st["per_trainer"]] == [4] * 4
        assert sum(d["wins"] for d in st["per_trainer"]) == 4 * 2
        gen_bytes = tltfb.tree_nbytes(orch.population.trainers[0]
                                      .params["gen"])
        assert st["tournament_exchange_bytes"] == 2 * 4 * gen_bytes
        assert st["total"]["cache_hits"] > 0
        assert isinstance(orch.val_batch["y"], torch.Tensor)
        assert orch.val_batch["y"].shape == (32, CFG.output_dim)
        eff = st["efficiency"]
        assert eff["trainers"] == 4 and eff["speedup"] > 0
        orch.fail(1)
        orch.run(rounds=1, steps_per_round=2)
        st = orch.stats()
        assert st["per_trainer"][1]["steps"] == 4    # sat the round out
        assert st["per_trainer"][0]["steps"] == 6
        orch.recover(1)
        assert orch.population.trainers[1].alive
        orch.rescale(6)
        orch.run(rounds=1, steps_per_round=1)
        st = orch.stats()
        assert len(st["per_trainer"]) == 6 and st["round"] == 4
        assert st["events"] == {"rescales": 1, "failures": 1,
                                "recoveries": 1, "checkpoints": 0,
                                "restores": 0}
        assert sum(d["files"] for d in st["per_trainer"]) == 8
        orch.rescale(2)
        assert len(orch.population.trainers) == 2
        assert orch.stats()["total"]["file_opens"] > 0


def test_orchestrator_checkpoint_resumes_bit_equal(fns, bundle_files,
                                                   tmp_path):
    ck = str(tmp_path / "ck")
    with _orch(fns, bundle_files, ckpt_dir=ck) as orch:
        orch.run(rounds=2, steps_per_round=2, ckpt_every=1)
        saved = [(t.params, t.opt_state, t.hparams, t.wins)
                 for t in orch.population.trainers]
    assert tckpt.latest_population_step(ck) == 2
    with _orch(fns, bundle_files, ckpt_dir=ck) as fresh:
        assert fresh.maybe_resume()
        assert fresh.population.round == 2
        assert fresh.stats()["events"]["restores"] == 1
        for t, (p, o, h, w) in zip(fresh.population.trainers, saved):
            assert (t.hparams, t.wins) == (h, w)
            for half in ("gen", "disc"):
                for n in p[half]:
                    assert torch.equal(t.params[half][n], p[half][n])
                    assert torch.equal(t.opt_state[half]["v"][n],
                                       o[half]["v"][n])


def test_orchestrator_refuses_what_is_not_ported(fns, bundle_files):
    with pytest.raises(NotImplementedError, match="A6"):
        _orch(fns, bundle_files, backend="mesh")
    with pytest.raises(NotImplementedError, match="A6"):
        _orch(fns, bundle_files, quantize_exchange=True)
    # telemetry and the genealogy (A5) are ported: the orchestrator
    # takes both
    cfg = TournamentConfig(trainers=2, device="cpu")
    plan = DataPlan.jag_cyclegan(bundle_files)
    tel = ttel.TrainTelemetry()
    with TournamentOrchestrator(fns, plan, cfg, telemetry=tel,
                                genealogy=None) as orch:
        assert orch.telemetry is tel and orch.population.telemetry is tel


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_ltfb_cli_on_cpu_prints_its_lines(tmp_path, capsys):
    argv = ["--arch", "icf-cyclegan", "--smoke", "--device", "cpu",
            "--trainers", "4", "--rounds", "2", "--steps-per-round", "2",
            "--samples", "576", "--data-dir", str(tmp_path / "data"),
            "--ckpt-dir", str(tmp_path / "ck")]
    assert tlaunch.main(argv) == 0
    text = capsys.readouterr().out
    rounds = [ln for ln in text.splitlines()
              if ln.startswith("[ltfb] round=")]
    assert len(rounds) == 2
    for ln in rounds:
        best = float(ln.split("best_val=")[1].split()[0])
        assert np.isfinite(best) and "speedup=" in ln
    assert text.count("[ltfb] trainer ") == 4
    for tag in ("[ltfb] manifest: 9 JAG bundles", "[ltfb] datastore total:",
                "[ltfb] tournament: rounds=2", "[ltfb] efficiency:",
                "device=cpu", "scope=generator"):
        assert tag in text, tag
    # a rerun resumes from the checkpoint and reuses the manifest
    assert tlaunch.main(argv[:7] + ["--rounds", "1"] + argv[9:]) == 0
    text = capsys.readouterr().out
    assert "[ltfb] resumed at round 2" in text
    assert "[ltfb] tournament: rounds=3" in text


@pytest.mark.parametrize("flags,queue", [
    (["--backend", "mesh"], "A6"), (["--quantize-exchange"], "A6"),
    (["--optimizer", "adafactor"], "CycleGAN checkpoint layout")])
def test_ltfb_cli_refuses_unported_flags(flags, queue):
    with pytest.raises(NotImplementedError, match=queue):
        tlaunch.main(["--smoke", "--device", "cpu", *flags])


# ---------------------------------------------------------------------------
# LM trainers in a tournament (token shards)
# ---------------------------------------------------------------------------

LM_K, LM_ROUNDS, LM_STEPS, LM_SEQ, LM_B = 2, 2, 2, 16, 4


@pytest.fixture(scope="module")
def lm_cfgs():
    return (dataclasses.replace(jqwen3.SMOKE, dtype="float32"),
            dataclasses.replace(tqwen3.SMOKE, dtype="float32"))


@pytest.fixture(scope="module")
def shard_files(tmp_path_factory, lm_cfgs):
    # 6 shards of 16 rows: the orchestrator holds the last one out
    root = tmp_path_factory.mktemp("torch_ltfb_tokens")
    return ttokens.write_token_shards(str(root), 96, seq_len=LM_SEQ,
                                      vocab=lm_cfgs[1].vocab_size,
                                      samples_per_file=16, seed=0)


@pytest.fixture(scope="module")
def lm_fns(lm_cfgs):
    """(JAX's LM trainer functions, the port's with JAX's initial weights
    crossed through the bridge)."""
    jcfg, tcfg = lm_cfgs
    opt = dict(name="adam", lr=1e-3, warmup_steps=1)
    jfns = JTrainerFns(*jsteps.make_lm_population_fns(
        jcfg, jbase.OptimizerConfig(**opt)))
    tfns = TrainerFns(*tsteps.make_lm_population_fns(
        tcfg, OptimizerConfig(**opt), device="cpu"))

    def init(seed):
        jp, jo, h = jfns.init(seed)
        return (*tfns.from_ckpt(_np(jp), _np(jo)), h)

    return jfns, dataclasses.replace(tfns, init=init)


def _lm_tcfg(**kw):
    return dict(trainers=LM_K, scope="full", batch_size=LM_B, num_ranks=2,
                tournament_batches=2, tournament_batch_size=LM_B, seed=0,
                **kw)


@pytest.fixture(scope="module")
def lm_runs(lm_fns, shard_files, tmp_path_factory):
    """Both packages' orchestrators after LM_ROUNDS rounds of LM_STEPS
    steps each, their tournament logs, and a population checkpoint of
    each."""
    jfns, tfns = lm_fns
    root = tmp_path_factory.mktemp("torch_ltfb_lm_ckpt")
    jorch = jtour.TournamentOrchestrator(
        jfns, jtour.DataPlan.lm_tokens(shard_files),
        jtour.TournamentConfig(**_lm_tcfg(ckpt_dir=str(root / "jax"))))
    torch_orch = TournamentOrchestrator(
        tfns, DataPlan.lm_tokens(shard_files),
        TournamentConfig(**_lm_tcfg(ckpt_dir=str(root / "port"),
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


def test_token_shards_are_byte_identical_to_jax(tmp_path, monkeypatch,
                                                lm_cfgs):
    """The same shard files byte for byte (the zip entries' timestamps
    pinned to one second, as ``np.savez`` stamps the wall clock), read
    back and batched alike by either package."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    vocab = lm_cfgs[1].vocab_size
    kw = dict(num_samples=50, seq_len=12, vocab=vocab, samples_per_file=16,
              seed=3)
    jf = jtokens.write_token_shards(str(tmp_path / "jax"), **kw)
    tf = ttokens.write_token_shards(str(tmp_path / "port"), **kw)
    assert [os.path.basename(f) for f in tf] == \
        [os.path.basename(f) for f in jf] == \
        [f"tokens_{i:05d}.npz" for i in range(4)]
    assert ttokens.list_token_shards(str(tmp_path / "port")) == tf
    assert ttokens.list_token_shards(str(tmp_path / "none")) == []
    for a, b in zip(jf, tf):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        got, want = ttokens.read_token_shard(a), jtokens.read_token_shard(b)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["tokens"].dtype == np.int32
        tb, jb = ttokens.lm_shard_batch(got), jtokens.lm_shard_batch(want)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k], jb[k])
        tplan = DataPlan.lm_tokens([a])
        jplan = jtour.DataPlan.lm_tokens([a])
        for k, v in jplan.adapt(jplan.reader(a)).items():
            np.testing.assert_array_equal(tplan.adapt(tplan.reader(a))[k], v)


def test_lm_tournament_matches_jax(lm_runs):
    """Same pairings, exchange bytes, metrics (1e-5 relative), decisions,
    wins and adoptions, over 2 rounds x 2 steps of 2 trainers fed the
    same shards."""
    jorch, torch_orch, logs = lm_runs
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
        assert tt.hparams == jt.hparams
        np.testing.assert_allclose(tt.last_metrics["loss"],
                                   jt.last_metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(
        torch_orch.population.best_metric(torch_orch.val_batch),
        jorch.population.best_metric(jorch.val_batch), rtol=1e-5)


def test_lm_population_checkpoints_cross_both_ways(lm_runs, lm_fns):
    """Each package restores the other's population checkpoint bit for
    bit: the port's into JAX's templates, JAX's into a fresh port
    orchestrator's trainers."""
    jfns, tfns = lm_fns
    jorch, torch_orch, _ = lm_runs
    jp, jo, _ = jfns.init(0)
    got = jckpt.restore_population(torch_orch.cfg.ckpt_dir, LM_ROUNDS,
                                   {"params": jp, "opt_state": jo})
    for t, tr in zip(torch_orch.population.trainers, got["trainers"]):
        want_p, want_o = tfns.to_ckpt(t.params, t.opt_state)
        g = {"params": tr["params"], "opt_state": tr["opt_state"]}
        w = {"params": want_p, "opt_state": want_o}
        assert jax.tree.structure(_np(g)) == jax.tree.structure(
            jax.tree.map(lambda x: 0, w))
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert (tr["steps"], tr["wins"]) == (t.steps, t.wins)
    fresh = TournamentOrchestrator(
        tfns, DataPlan.lm_tokens(torch_orch.plan.files),
        TournamentConfig(**_lm_tcfg(ckpt_dir=jorch.cfg.ckpt_dir,
                                    device="cpu")))
    try:
        assert fresh.maybe_resume()
        assert fresh.population.round == LM_ROUNDS
        for jt, tt in zip(jorch.population.trainers,
                          fresh.population.trainers):
            p, o = tfns.from_ckpt(_np(jt.params), _np(jt.opt_state))
            assert list(tt.params) == list(p)
            for n in p:
                assert torch.equal(tt.params[n], p[n]), n
                for mom in ("m", "v"):
                    assert torch.equal(tt.opt_state[mom][n], o[mom][n])
            assert int(tt.opt_state["step"]) == int(jt.opt_state["step"])
            assert (tt.steps, tt.wins, tt.hparams) == \
                (jt.steps, jt.wins, jt.hparams)
    finally:
        fresh.close()


def _lm_population(fns, batches, **kw):
    holder = []
    loaders = [lambda i=i: batches[i][holder[0].trainers[i].steps]
               for i in range(LM_K)]
    pop = Population(fns, loaders, [[b[-1]] for b in batches], **kw)
    holder.append(pop)
    return pop


def _lm_batches(cfg, n, seed):
    stream = ttokens.token_stream(n * LM_B * (LM_SEQ + 1), cfg.vocab_size,
                                  seed).reshape(n, LM_B, LM_SEQ + 1)
    return [_tb(ttokens.lm_shard_batch({"tokens": s})) for s in stream]


def test_lm_adopted_weights_are_never_written_through(lm_cfgs):
    """Trainer 0 adopts trainer 1's whole model (the same tensors, by
    reference); a step of either leaves the other's weights as they were,
    and the two keep their own Adam states."""
    tcfg = lm_cfgs[1]
    fns = TrainerFns(*tsteps.make_lm_population_fns(
        tcfg, OptimizerConfig(name="adam", lr=1e-2, warmup_steps=1),
        device="cpu"))
    batches = [_lm_batches(tcfg, 4, 50 + i) for i in range(LM_K)]

    def metric(params, b):
        # trainer 1's weights win every comparison they are in
        return 0.0 if params is p1 else 1.0

    pop = _lm_population(TrainerFns(fns.init, fns.train_step, metric),
                         batches, scope="full")
    p1 = pop.trainers[1].params
    log = pop.tournament()
    t0, t1 = pop.trainers
    assert log["exchanged"] == 1 and t0.adoptions == 1
    assert t0.params is t1.params and t0.opt_state is not t1.opt_state
    snap = {n: t.clone() for n, t in p1.items()}
    pop.train_round(2)                       # both step from p1
    assert all(torch.equal(p1[n], snap[n]) for n in snap)
    assert t0.params is not t1.params
    assert not torch.equal(t0.params["embed.weight"], snap["embed.weight"])
    assert not torch.equal(t0.params["embed.weight"],
                           t1.params["embed.weight"])
    assert int(t0.opt_state["step"]) == int(t1.opt_state["step"]) == 2


def test_lm_resumed_population_equals_an_uninterrupted_one(lm_cfgs,
                                                           tmp_path):
    """Round 1, a population checkpoint, a fresh population restored from
    it, round 2: bit for bit the weights and Adam state of 2 rounds run
    without a stop (the same batches by step count)."""
    tcfg = lm_cfgs[1]
    fns = TrainerFns(*tsteps.make_lm_population_fns(
        tcfg, OptimizerConfig(name="adam", lr=1e-3, warmup_steps=1),
        device="cpu"))
    batches = [_lm_batches(tcfg, 2 * LM_STEPS + 1, 70 + i)
               for i in range(LM_K)]
    whole = _lm_population(fns, batches)
    for _ in range(2):
        whole.train_round(LM_STEPS)
        whole.tournament()
    first = _lm_population(fns, batches)
    first.train_round(LM_STEPS)
    first.tournament()
    state = first.state_dict()
    for tr in state["trainers"]:
        tr["params"], tr["opt_state"] = fns.to_ckpt(tr["params"],
                                                    tr["opt_state"])
    tckpt.save_population(str(tmp_path), 1, state)
    like_p, like_o = fns.to_ckpt(*fns.init(0)[:2])
    restored = tckpt.restore_population(
        str(tmp_path), 1, {"params": like_p, "opt_state": like_o})
    for tr in restored["trainers"]:
        tr["params"], tr["opt_state"] = fns.from_ckpt(tr["params"],
                                                      tr["opt_state"])
    resumed = _lm_population(fns, batches)
    resumed.load_state_dict(restored)
    resumed.train_round(LM_STEPS)
    resumed.tournament()
    for a, b in zip(whole.trainers, resumed.trainers):
        assert (a.steps, a.wins, a.adoptions) == (b.steps, b.wins,
                                                  b.adoptions)
        for n in a.params:
            assert torch.equal(a.params[n], b.params[n]), n
            assert torch.equal(a.opt_state["m"][n], b.opt_state["m"][n])
            assert torch.equal(a.opt_state["v"][n], b.opt_state["v"][n])


def test_lm_metric_from_many_threads_sees_each_calls_own_weights(
        lm_cfgs):
    """The tournament evaluates metrics on a pool; the one weight-less
    module binds each call's weights in turn: 24 calls over 3 weight sets
    from 8 threads, under a short switch interval, equal the serial
    results bit for bit."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    tcfg = lm_cfgs[1]
    fns = TrainerFns(*tsteps.make_lm_population_fns(
        tcfg, OptimizerConfig(), device="cpu"))
    params = [fns.init(s)[0] for s in range(3)]
    batch = _lm_batches(tcfg, 1, 5)[0]
    want = [float(fns.metric(p, batch)) for p in params]
    assert len(set(want)) == 3
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=8) as ex:
            got = list(ex.map(lambda i: float(fns.metric(params[i % 3],
                                                         batch)),
                              range(24), timeout=120))
    finally:
        sys.setswitchinterval(old)
    assert got == [want[i % 3] for i in range(24)]


def _adafactor_cfgs(arch):
    """(JAX config, port config) SMOKE at f32; jamba without experts."""
    from repro.configs.registry import get_config as jax_get_config
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config

    j = dataclasses.replace(jax_get_config(arch, smoke=True),
                            dtype="float32")
    t = replace(get_config(arch, smoke=True), dtype="float32")
    if arch.startswith("jamba"):
        j, t = dataclasses.replace(j, moe=None), replace(t, moe=None)
    return j, t


def _noisy_adafactor_state(fns, seed):
    """A trainer's weights and an Adafactor state with random factors
    and step 3 (the zero state would hide a swapped or misplaced
    factor)."""
    p, o, _ = fns.init(seed)
    gen = torch.Generator().manual_seed(seed)
    for which in ("vr", "vc"):
        o[which] = {k: torch.rand(v.shape, generator=gen)
                    for k, v in o[which].items()}
    o["step"] = torch.tensor(3, dtype=torch.int32)
    return p, o


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_adafactor_state_crosses_to_the_jax_layout_and_back(arch):
    """The port's grouped Adafactor factors go to JAX's leaves (the tree
    of ``make_adafactor(...).init``: its structure and every shape, row
    and column factors swapped for transposed dense weights, the
    unfactored leaves' (1,) pad slot) and come back bit for bit."""
    from repro.models import lm as jlm
    from repro.optim import optimizers as jopt

    jcfg, tcfg = _adafactor_cfgs(arch)
    fns = TrainerFns(*tsteps.make_lm_population_fns(
        tcfg, OptimizerConfig(name="adafactor"), device="cpu"))
    p, o = _noisy_adafactor_state(fns, 1)
    _, jax_o = fns.to_ckpt(p, o)
    like = jopt.make_adafactor(jbase.OptimizerConfig(name="adafactor")).init(
        jax.eval_shape(lambda k: jlm.init_lm(jcfg, k)[0],
                       jax.random.PRNGKey(0)))
    assert jax.tree.structure(jax.tree.map(lambda x: 0, jax_o)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, like))
    for a, b in zip(jax.tree.leaves(jax_o), jax.tree.leaves(like)):
        assert tuple(a.shape) == tuple(b.shape)
    _, back = fns.from_ckpt(fns.to_ckpt(p, o)[0], jax_o)
    assert int(back["step"]) == 3
    for which in ("vr", "vc"):
        assert list(back[which]) == list(o[which])
        for k, t in o[which].items():
            assert torch.equal(back[which][k], t), (which, k)


def test_jax_restores_the_ports_adafactor_population(tmp_path, lm_cfgs):
    """A population checkpoint the port writes with Adafactor state
    restores in JAX's ``restore_population`` against JAX's own trainer
    template, leaf for leaf equal to the port's JAX layout."""
    jcfg, tcfg = lm_cfgs
    fns = TrainerFns(*tsteps.make_lm_population_fns(
        tcfg, OptimizerConfig(name="adafactor"), device="cpu"))
    trainers = []
    for i in range(2):
        p, o = _noisy_adafactor_state(fns, i)
        jp, jo = fns.to_ckpt(p, o)
        trainers.append({"params": jp, "opt_state": jo, "hparams":
                         {"lr": 1e-3}, "steps": 4 + i, "wins": i,
                         "alive": True})
    tckpt.save_population(str(tmp_path), 2, {"round": 2,
                                             "trainers": trainers})
    jfns = JTrainerFns(*jsteps.make_lm_population_fns(
        jcfg, jbase.OptimizerConfig(name="adafactor")))
    jp, jo, _ = jfns.init(0)
    got = jckpt.restore_population(str(tmp_path), 2,
                                   {"params": jp, "opt_state": jo})
    assert len(got["trainers"]) == 2
    for want, tr in zip(trainers, got["trainers"]):
        g = {"params": tr["params"], "opt_state": tr["opt_state"]}
        w = {"params": want["params"], "opt_state": want["opt_state"]}
        assert jax.tree.structure(_np(g)) == jax.tree.structure(
            jax.tree.map(lambda x: 0, w))
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert (tr["steps"], tr["wins"]) == (want["steps"], want["wins"])


def test_ltfb_cli_lm_adafactor_checkpoints_and_resumes(tmp_path, capsys):
    """The ltfb CLI trains two qwen3 SMOKE trainers with Adafactor,
    checkpoints the population and resumes from it."""
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--trainers", "2", "--rounds", "2", "--steps-per-round", "2",
            "--batch", "4", "--seq", "16", "--samples", "96",
            "--samples-per-file", "32", "--optimizer", "adafactor",
            "--data-dir", str(tmp_path / "data"), "--ckpt-dir",
            str(tmp_path / "ck")]
    assert tlaunch.main(argv) == 0
    text = capsys.readouterr().out
    assert text.count("[ltfb] round=") == 2
    assert tckpt.latest_population_step(str(tmp_path / "ck")) == 2
    assert tlaunch.main(argv[:7] + ["--rounds", "1"] + argv[9:]) == 0
    text = capsys.readouterr().out
    assert "[ltfb] resumed at round 2" in text
    assert "[ltfb] tournament: rounds=3" in text


def test_ltfb_cli_lm_on_cpu_prints_its_lines(tmp_path, capsys):
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--trainers", "2", "--rounds", "2", "--steps-per-round", "2",
            "--batch", "4", "--seq", "16", "--samples", "96",
            "--samples-per-file", "32", "--data-dir",
            str(tmp_path / "data"), "--ckpt-dir", str(tmp_path / "ck")]
    assert tlaunch.main(argv) == 0
    text = capsys.readouterr().out
    rounds = [ln for ln in text.splitlines()
              if ln.startswith("[ltfb] round=")]
    assert len(rounds) == 2
    for ln in rounds:
        assert np.isfinite(float(ln.split("best_val=")[1].split()[0]))
    for tag in ("[ltfb] manifest: 3 token shards", "scope=full",
                "device=cpu", "[ltfb] tournament: rounds=2",
                "[ltfb] datastore total:"):
        assert tag in text, tag
    assert text.count("[ltfb] trainer ") == 2
    assert tckpt.latest_population_step(str(tmp_path / "ck")) == 2
    # a rerun resumes, and a shard directory of another length refuses
    assert tlaunch.main(argv[:7] + ["--rounds", "1"] + argv[9:]) == 0
    assert "[ltfb] resumed at round 2" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="seq 16"):
        tlaunch.main(argv[:13] + ["--seq", "8"] + argv[15:])
