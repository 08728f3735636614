"""The port's winner registry against the JAX package's on the CPU.

Two SMOKE CycleGAN populations in f32, one written by the JAX package and
one by the port (each trainer's weights after one seeded step, with
metadata that orders the trainers by wins), go through both packages'
``repro.serve.registry`` functions: sidecar bytes, winner selection by
wins and by metric, each package loading the other's exported winner,
``auto_export`` following a new population step, and the quarantine of a
torn winner.  Weights cross through ``repro_torch.bridge``.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.checkpoint import ckpt as jckpt
from repro.configs import base as jbase
from repro.configs import icf_cyclegan as jcfgs
from repro.serve import registry as jreg
from repro.train import steps as jsteps
from repro_torch import bridge
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import icf_cyclegan as tcfgs
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data import jag as tjag
from repro_torch.serve import registry as treg
from repro_torch.train import steps as tsteps
from repro_torch.train.steps import tree_to

CFG = tcfgs.SMOKE
K = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(n, seed):
    sim = tjag.jag_simulate(tjag.sample_inputs(n, seed=seed),
                            CFG.image_size)
    return {"x": sim["x"], "y": tjag.flatten_outputs(sim)}


def _from_ckpt(tree):
    return tree_to(bridge.cyclegan_params_from_jax(tree), "cpu")


def _meta(i):
    # trainer 1 holds the most wins
    return {"hparams": {"lr": 1e-3}, "steps": 2 + i, "alive": True,
            "wins": [1, 4, 2][i], "adoptions": i}


@pytest.fixture(scope="module")
def pops(tmp_path_factory):
    """(jax_dir, port_dir): a population step 1 written by each package."""
    root = tmp_path_factory.mktemp("torch_registry")
    jinit, jstep, _ = jsteps.make_gan_steps(jcfgs.SMOKE,
                                            jbase.OptimizerConfig())
    tinit, tstep, _ = tsteps.make_gan_steps(CFG, OptimizerConfig(),
                                            device="cpu")
    jtr, ttr = [], []
    for i in range(K):
        b = _batch(16, 40 + i)
        p, o, h = jinit(i)
        p, o, _ = jstep(p, o, {k: jnp.asarray(v) for k, v in b.items()}, h)
        jtr.append({"params": p, "opt_state": o, **_meta(i)})
        p, o, h = tinit(i)
        p, o, _ = tstep(p, o, {k: torch.from_numpy(v) for k, v in b.items()},
                        h)
        ttr.append({"params": bridge.cyclegan_params_to_jax_layout(p),
                    "opt_state": bridge.cyclegan_opt_state_to_jax_layout(o),
                    **_meta(i)})
    jdir, tdir = str(root / "jax"), str(root / "port")
    jckpt.save_population(jdir, 1, {"round": 1, "trainers": jtr})
    tckpt.save_population(tdir, 1, {"round": 1, "trainers": ttr})
    return jdir, tdir


@pytest.fixture(scope="module")
def likes():
    """(JAX template, port template in the checkpoint layout)."""
    jlike = jsteps.make_gan_steps(jcfgs.SMOKE, jbase.OptimizerConfig())[0](
        0)[0]
    tparams = tsteps.make_gan_steps(CFG, OptimizerConfig(),
                                    device="cpu")[0](0)[0]
    return jlike, bridge.cyclegan_params_to_jax_layout(tparams)


def _fresh(src, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(src, dst)
    return dst


def _metric_fns():
    _, _, jmetric = jsteps.make_gan_steps(jcfgs.SMOKE,
                                          jbase.OptimizerConfig())
    _, _, tmetric = tsteps.make_gan_steps(CFG, OptimizerConfig(),
                                          device="cpu")
    val = _batch(32, 999)
    return (jmetric, {k: jnp.asarray(v) for k, v in val.items()},
            tmetric, {k: torch.from_numpy(v) for k, v in val.items()})


def _same_params(port_params, jax_tree):
    want = bridge.cyclegan_params_from_jax(_np(jax_tree))
    for half in want:
        assert list(port_params[half]) == list(want[half])
        for n, t in want[half].items():
            assert torch.equal(port_params[half][n], t), (half, n)


def test_sidecar_files_are_byte_identical(pops, tmp_path):
    src = os.path.join(pops[0], "step_1_trainer_0.ckpt")
    for name, mod in (("jax", jreg), ("port", treg)):
        path = str(tmp_path / f"{name}.ckpt")
        shutil.copy(src, path)
        assert mod.write_checksum(path) == mod.checksum_path(path)
    with open(tmp_path / "jax.ckpt.sha256", "rb") as a, \
            open(tmp_path / "port.ckpt.sha256", "rb") as b:
        assert a.read() == b.read()
    treg.verify_checkpoint(str(tmp_path / "jax.ckpt"))
    jreg.verify_checkpoint(str(tmp_path / "port.ckpt"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_same_winner_by_wins_and_by_metric(pops, likes, tmp_path, writer):
    """Both packages pick the same trainer from the same population, by
    recorded wins and by the validation metric (f32, 1e-5 relative)."""
    src = pops[0] if writer == "jax" else pops[1]
    jlike, tlike = likes
    jmetric, jval, tmetric, tval = _metric_fns()
    jd, td = _fresh(src, tmp_path, "j"), _fresh(src, tmp_path, "t")
    _, jinfo = jreg.export_winner(jd, jlike)
    _, tinfo = treg.export_winner(td, tlike)
    assert tinfo == jinfo and jinfo["trainer"] == 1
    assert jinfo["selected_by"] == "wins"
    _, jinfo = jreg.export_winner(jd, jlike, metric_fn=jmetric,
                                  val_batch=jval)
    _, tinfo = treg.export_winner(td, tlike, metric_fn=tmetric,
                                  val_batch=tval, from_ckpt=_from_ckpt)
    assert tinfo["trainer"] == jinfo["trainer"]
    assert tinfo["selected_by"] == "metric"
    np.testing.assert_allclose(tinfo["metric"], jinfo["metric"], rtol=1e-5)
    assert treg.population_steps(td) == jreg.population_steps(jd) == [1]
    assert treg.latest_winner_step(td) == jreg.latest_winner_step(jd) == 1


@pytest.mark.parametrize("exporter", ["jax", "port"])
def test_each_package_loads_the_others_winner(pops, likes, tmp_path,
                                              exporter):
    jlike, tlike = likes
    d = _fresh(pops[0] if exporter == "jax" else pops[1], tmp_path, "pop")
    if exporter == "jax":
        jreg.export_winner(d, jlike)
    else:
        treg.export_winner(d, tlike)
    # the port serves it in its own layout
    tr = treg.ModelRegistry(d, tlike, from_ckpt=_from_ckpt)
    tp = tr.load()
    assert tr.step == 1 and tr.info["trainer"] == 1 and not tr.swaps
    # JAX serves it in its own
    jr = jreg.ModelRegistry(d, jlike)
    jp = jr.load()
    assert jr.step == 1 and jr.info == tr.info
    _same_params(tp, jp)
    member, _ = jckpt.restore(os.path.join(d, "step_1_trainer_1.ckpt"),
                              {"params": jlike})
    _same_params(tp, member["params"])


def test_refresh_follows_new_population_steps_with_auto_export(
        pops, likes, tmp_path):
    _, tlike = likes
    d = _fresh(pops[1], tmp_path, "pop")
    r = treg.ModelRegistry(d, tlike, auto_export=True, from_ckpt=_from_ckpt)
    r.load()
    assert r.step == 1 and not r.refresh()       # nothing newer
    state = tckpt.restore_population(d, 1, {"params": tlike,
                                            "opt_state": {}})
    for tr in state["trainers"]:
        tr["wins"] = 0
    state["trainers"][2]["wins"] = 9             # a new leader
    tckpt.save_population(d, 2, state)
    assert r.refresh() and r.step == 2 and r.swaps == 1
    assert r.info["trainer"] == 2 and treg.latest_winner_step(d) == 2
    assert sorted(os.listdir(d)) == sorted(
        [f"step_{s}_trainer_{i}.ckpt" for s in (1, 2) for i in range(K)]
        + ["step_1.manifest", "step_2.manifest"]
        + [f"winner_step_{s}.ckpt{x}" for s in (1, 2)
           for x in ("", ".sha256")])


def test_torn_winner_is_quarantined_and_previous_keeps_serving(
        pops, likes, tmp_path, capsys):
    jlike, tlike = likes
    d = _fresh(pops[1], tmp_path, "pop")
    treg.export_winner(d, tlike)
    r = treg.ModelRegistry(d, tlike, from_ckpt=_from_ckpt)
    first = r.load()
    # a newer winner lands torn: half its bytes, its sidecar intact
    shutil.copy(treg.winner_path(d, 1), treg.winner_path(d, 2))
    treg.write_checksum(treg.winner_path(d, 2))
    with open(treg.winner_path(d, 2), "r+b") as f:
        f.truncate(os.path.getsize(treg.winner_path(d, 2)) // 2)
    assert r.refresh() is False                  # never raises
    assert r.step == 1 and r.rejected_corrupt == 1 and r.params is first
    assert os.path.exists(treg.winner_path(d, 2) + ".corrupt")
    assert os.path.exists(treg.checksum_path(treg.winner_path(d, 2))
                          + ".corrupt")
    assert "[registry] REJECTED corrupt winner step 2" in \
        capsys.readouterr().out
    assert r.refresh() is False and r.rejected_corrupt == 1   # no re-trip
    # the next good export swaps in
    shutil.copy(treg.winner_path(d, 1), treg.winner_path(d, 3))
    treg.write_checksum(treg.winner_path(d, 3))
    assert r.refresh() is True and r.step == 3 and r.swaps == 1
    # JAX's registry rejects the same torn file the same way
    shutil.copy(treg.winner_path(d, 3), treg.winner_path(d, 4))
    jreg.write_checksum(treg.winner_path(d, 4))
    with open(treg.winner_path(d, 4), "r+b") as f:
        f.truncate(10)
    jr = jreg.ModelRegistry(d, jlike)
    jr.load_step(3)
    assert jr.refresh() is False and jr.rejected_corrupt == 1


def test_strict_load_raises_on_a_corrupt_winner(pops, likes, tmp_path):
    _, tlike = likes
    d = _fresh(pops[1], tmp_path, "pop")
    path, _ = treg.export_winner(d, tlike)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    r = treg.ModelRegistry(d, tlike, from_ckpt=_from_ckpt)
    with pytest.raises(ValueError, match="corrupt or torn"):
        r.load_step(1, strict=True)
    assert r.params is None and r.rejected_corrupt == 0
    os.remove(treg.checksum_path(path))          # no sidecar: restore fails
    with pytest.raises(ValueError, match="corrupt or torn"):
        r.load_step(1)
    with pytest.raises(FileNotFoundError):
        treg.ModelRegistry(str(tmp_path / "none"), tlike).load()
