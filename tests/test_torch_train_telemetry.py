"""The port's training telemetry against the JAX package's, on the CPU:
the Prometheus text, the genealogy log and its lineage report, a SMOKE
CycleGAN tournament traced by both packages, and the ltfb CLI's
telemetry flags.

* ``train_prometheus`` of one fixed stats dict is byte-equal in the two
  packages;
* a genealogy written by either package replays in the other, a torn
  tail included, and the two lineage modules agree on it;
* 2 trainers x 2 rounds x 2 steps of the SMOKE CycleGAN (f32, JAX's
  initial weights crossed through ``repro_torch.bridge``, the same JAG
  bundles) with telemetry and genealogy on: the same ``match`` and
  ``round`` records in every non-timing field (metrics within 1e-5
  relative, as ``test_population_matches_jax``), the same multiset of
  span names on every trainer row, ``flops_per_step`` within 5% of JAX's
  XLA count, and trainer 0 untouched by the FLOP probe;
* the ltfb CLI's ``--log-json`` (JAX's event names), ``--trace-out``,
  ``--prom-out``, ``--metrics-port 0`` (served over HTTP, equal to the
  file) and ``--genealogy`` (and its default under ``--ckpt-dir``).
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import urllib.request
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import telemetry as jtelemetry
from repro.configs import base as jbase
from repro.configs import icf_cyclegan as jcfgs
from repro.core import tournament as jtour
from repro.core.population import TrainerFns as JTrainerFns
from repro.launch import lineage as jlineage
from repro.launch import ltfb as jlaunch
from repro.train import steps as jsteps
from repro.train import telemetry as jtel
from repro_torch import bridge
from repro_torch import telemetry as ttelemetry
from repro_torch.core.tournament import (DataPlan, TournamentConfig,
                                         TournamentOrchestrator)
from repro_torch.data import jag as tjag
from repro_torch.launch import lineage as tlineage
from repro_torch.launch import ltfb as tlaunch
from repro_torch.train import telemetry as ttel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def json_logs_off():
    """The JSON-log switch is global per package: every test starts and
    ends with both switched off (xdist runs a file in one process)."""
    for mod in (jtelemetry, ttelemetry):
        mod.enable_json_logs(False)
    yield
    for mod in (jtelemetry, ttelemetry):
        mod.enable_json_logs(False)


# ---------------------------------------------------------------------------
# Prometheus text and the efficiency figures
# ---------------------------------------------------------------------------

_PER = [{"samples_fetched": 64, "file_opens": 2, "bytes_read": 4096,
         "exchange_bytes": 512, "cache_hits": 60, "cache_misses": 4,
         "files": 2, "partition_samples": 64, "wins": 3, "adoptions": 1,
         "steps": 8, "alive": True, "train_seconds": 1.5,
         "data_wait_seconds": 0.25,
         "train_metrics": {"g_loss": 0.5, "d_loss": 1.25},
         "tournament_metric": 0.75},
        {"samples_fetched": 32, "file_opens": 1, "bytes_read": 2048,
         "exchange_bytes": 0, "cache_hits": 30, "cache_misses": 2,
         "files": 1, "partition_samples": 32, "wins": 0, "adoptions": 2,
         "steps": 8, "alive": False, "train_seconds": 2.0,
         "data_wait_seconds": 0.0, "train_metrics": {},
         "tournament_metric": None}]
_EFF = {"trainers": 2, "single_trainer_samples_per_s": 100.5,
        "parallel_samples_per_s": 180.25, "speedup": 1.79,
        "efficiency": 0.895, "flops_per_step": 3.0e7,
        "model_flops_per_s": 1.2e9}
STATS = {
    "full": ({"per_trainer": _PER,
              "total": {"samples_fetched": 96, "file_opens": 3.0,
                        "bytes_read": 6144, "exchange_bytes": 512,
                        "cache_hits": 90, "cache_misses": 6},
              "tournament_exchange_bytes": 123456, "round": 3,
              "train_seconds": 3.5, "data_wait_seconds": 0.25,
              "tournament_seconds": 0.5, "checkpoint_seconds": 1.0,
              "restore_seconds": 0.0, "prefetch_wait_seconds": 0.125,
              "events": {"rescales": 1, "failures": 1, "recoveries": 1,
                         "checkpoints": 3, "restores": 1},
              "efficiency": _EFF},
             {"compute": 3.25, "data_wait": 0.25, "tournament_eval": 0.4,
              "partner_exchange": 0.01, "checkpoint": 1.0}),
    "no_flops": ({"per_trainer": _PER[:1], "total": {}, "round": 1,
                  "efficiency": {k: v for k, v in _EFF.items()
                                 if "flops" not in k}}, None),
    "empty": ({}, {}),
}


@pytest.mark.parametrize("case", sorted(STATS))
def test_train_prometheus_is_byte_equal_to_jax(case):
    stats, phases = STATS[case]
    got = ttel.train_prometheus(stats, phases)
    assert got == jtel.train_prometheus(stats, phases)
    assert got.startswith("# HELP repro_train_rounds_total ")


def test_efficiency_snapshot_with_flops_equals_jax():
    per = [{"steps": 25, "train_seconds": 2.0, "data_wait_seconds": 0.1},
           {"steps": 20, "train_seconds": 2.5, "data_wait_seconds": 0.0}]
    for flops in (None, 0.0, 3.0e7):
        got = ttel.efficiency_snapshot(per, 32, 0.5, 6.0,
                                       flops_per_step=flops)
        assert got == jtel.efficiency_snapshot(per, 32, 0.5, 6.0,
                                               flops_per_step=flops)
    assert got["model_flops_per_s"] == pytest.approx(3.0e7 * 45 / 3.0)


# ---------------------------------------------------------------------------
# genealogy and lineage
# ---------------------------------------------------------------------------


def _write_genealogy(mod, path):
    g = mod.GenealogyLog(path)
    g.append("init", trainers=2, backend="host", scope="generator",
             seed=0, partition="stride", files=8)
    g.append("match", round=0, trainer=0, partner=1, m_local=0.5,
             m_other=0.25, winner=1, adopted=True, seed=0)
    g.append("match", round=0, trainer=1, partner=0, m_local=0.25,
             m_other=0.5, winner=1, adopted=False, seed=0)
    g.append("round", round=0, best_val=0.25, best_trainer=1, exchanged=1,
             exchange_bytes=4096, efficiency={"trainers": 2})
    g.append("rescale", round=1, from_k=2, to_k=3, cloned=[2],
             clone_src=0, kept=[0, 1])
    g.append("fail", trainer=1, round=1)
    g.append("recover", trainer=1, cloned_from=2, round=1)
    g.append("match", round=1, trainer=0, partner=1, m_local=0.4,
             m_other=0.2, winner=1, adopted=True, seed=0)
    g.append("round", round=1, best_val=0.2, best_trainer=0, exchanged=1,
             exchange_bytes=4096, efficiency={"trainers": 3})
    g.append("checkpoint", round=2, seconds=0.5)
    assert g.records_written == 10
    g.close()
    g.close()                                      # idempotent
    with open(path, "a") as f:                     # a torn final record
        f.write('{"t": "resume", "round": 2, "st')


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_genealogy_crosses_both_ways_and_lineage_agrees(writer, tmp_path):
    path = str(tmp_path / "sub" / "genealogy.jsonl")
    _write_genealogy(ttel if writer == "port" else jtel, path)
    jrecs, trecs = jtel.replay_genealogy(path), ttel.replay_genealogy(path)
    assert trecs == jrecs and len(trecs) == 10      # torn tail dropped
    assert ttel.replay_genealogy(str(tmp_path / "none.jsonl")) == []
    assert tlineage.summarize(trecs) == jlineage.summarize(jrecs) == {
        "records": 10, "rounds": 2, "trainers": 3,
        "kinds": {"init": 1, "match": 3, "round": 2, "rescale": 1,
                  "fail": 1, "recover": 1, "checkpoint": 1}}
    champ = tlineage.default_champion(trecs)
    assert champ == jlineage.default_champion(jrecs) == "trainer_0"
    for who in ("trainer_0", "trainer_1", "2"):
        assert tlineage.ancestry(trecs, who) == jlineage.ancestry(jrecs, who)
    chain = tlineage.ancestry(trecs, champ)
    # trainer 0 adopted trainer 1's model, which recovered as a clone of
    # trainer 2, a rescale clone of trainer 0, which had adopted trainer
    # 1's in round 0: back to the init
    assert [r["t"] for r in chain] == ["init", "match", "rescale",
                                       "recover", "match"]


def test_lineage_cli_equals_jax(tmp_path, capsys):
    path = str(tmp_path / "genealogy.jsonl")
    _write_genealogy(ttel, path)
    for flags in (["--json"], [], ["--champion", "trainer_1", "--json"]):
        assert jlineage.main(["--genealogy", path, *flags]) == 0
        want = capsys.readouterr().out
        assert tlineage.main(["--genealogy", path, *flags]) == 0
        assert capsys.readouterr().out == want
    assert tlineage.main(["--genealogy", str(tmp_path / "none")]) == 1
    # the module runs as ``python -m`` (it reads files only)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lineage", "--genealogy",
         path], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[lineage] champion: trainer_0" in proc.stdout


# ---------------------------------------------------------------------------
# a SMOKE CycleGAN tournament traced by both packages
# ---------------------------------------------------------------------------

K, ROUNDS, STEPS = 2, 2, 2
OPT = dict(name="adam", lr=1e-3, warmup_steps=1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def bundle_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_tel_jag")
    return tjag.write_bundles(str(root), num_samples=160,
                              samples_per_file=32, image_size=8, seed=0)


def _cpu_args(*extra):
    return tlaunch.finish_args(tlaunch.build_parser().parse_args(
        ["--smoke", "--device", "cpu", *extra]))


def _tcfg(**kw):
    return dict(trainers=K, scope="generator", batch_size=16, num_ranks=2,
                tournament_batches=1, tournament_batch_size=32, seed=0,
                **kw)


def _rows(tracer):
    """Span names per trace row, keyed by the row's name."""
    events = tracer.export()["traceEvents"]
    names = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    rows = {}
    for e in events:
        if e["ph"] == "X":
            rows.setdefault(names[e["tid"]], Counter())[e["name"]] += 1
    return rows


@pytest.fixture(scope="module")
def traced_runs(bundle_files, tmp_path_factory):
    """Both packages' orchestrators after ROUNDS x STEPS with telemetry
    and genealogy on, a checkpoint each round; trainer 0's state around
    the port's FLOP probe."""
    root = tmp_path_factory.mktemp("torch_tel_runs")
    jfns = JTrainerFns(*jsteps.make_gan_steps(
        jcfgs.SMOKE, jbase.OptimizerConfig(**OPT)))
    fns = tlaunch.build_fns(_cpu_args())

    def init(seed):                   # JAX's weights, the port's Adam
        jp, _, h = jfns.init(seed)
        _, topt, _ = fns.init(seed)
        return bridge.cyclegan_params_from_jax(_np(jp)), topt, h

    tfns = dataclasses.replace(fns, init=init)
    jtele, ttele = jtel.TrainTelemetry(), ttel.TrainTelemetry()
    jgen = jtel.GenealogyLog(str(root / "jax.jsonl"))
    tgen = ttel.GenealogyLog(str(root / "port.jsonl"))
    jorch = jtour.TournamentOrchestrator(
        jfns, jtour.DataPlan.jag_cyclegan(bundle_files),
        jtour.TournamentConfig(**_tcfg(ckpt_dir=str(root / "jck"))),
        telemetry=jtele, genealogy=jgen)
    torch_orch = TournamentOrchestrator(
        tfns, DataPlan.jag_cyclegan(bundle_files),
        TournamentConfig(**_tcfg(ckpt_dir=str(root / "tck"),
                                 device="cpu")),
        telemetry=ttele, genealogy=tgen)
    try:
        t0 = torch_orch.population.trainers[0]
        before = [{k: v.clone() for k, v in t0.params[h].items()}
                  for h in ("gen", "disc")] + \
            [{k: v.clone() for k, v in t0.opt_state[h][m].items()}
             for h in ("gen", "disc") for m in ("m", "v")]
        torch_orch._maybe_probe_flops()
        after = [t0.params[h] for h in ("gen", "disc")] + \
            [t0.opt_state[h][m] for h in ("gen", "disc") for m in ("m", "v")]
        jorch.run(ROUNDS, STEPS, ckpt_every=1)
        torch_orch.run(ROUNDS, STEPS, ckpt_every=1)
        jstats, tstats = jorch.stats(), torch_orch.stats()
    finally:
        for o, g in ((jorch, jgen), (torch_orch, tgen)):
            o.close()
            g.close()
    yield dict(jtel=jtele, ttel=ttele, jstats=jstats, tstats=tstats,
               jrecs=jtel.replay_genealogy(jgen.path),
               trecs=ttel.replay_genealogy(tgen.path),
               probe=(before, after))


def test_tournament_genealogy_equals_jax(traced_runs):
    jrecs, trecs = traced_runs["jrecs"], traced_runs["trecs"]
    assert [r["t"] for r in trecs] == [r["t"] for r in jrecs] == \
        ["init"] + (["match"] * K + ["round", "checkpoint"]) * ROUNDS
    adopted = 0
    for j, t in zip(jrecs, trecs):
        if t["t"] in ("init", "checkpoint"):
            t, j = dict(t), dict(j)
            t.pop("seconds", None), j.pop("seconds", None)
            assert t == j
        elif t["t"] == "match":
            np.testing.assert_allclose([t["m_local"], t["m_other"]],
                                       [j["m_local"], j["m_other"]],
                                       rtol=1e-5)
            for k in ("round", "trainer", "partner", "winner", "adopted",
                      "seed"):
                assert t[k] == j[k], (k, t, j)
            adopted += t["adopted"]
        else:
            np.testing.assert_allclose(t["best_val"], j["best_val"],
                                       rtol=1e-5)
            for k in ("round", "best_trainer", "exchanged",
                      "exchange_bytes"):
                assert t[k] == j[k], (k, t, j)
            te, je = t["efficiency"], j["efficiency"]
            assert (te["trainers"], te["samples"]) == \
                (je["trainers"], je["samples"])
            assert te["flops_per_step"] == pytest.approx(
                je["flops_per_step"], rel=0.05)
            assert te["model_flops_per_s"] > 0
    assert adopted >= 1


def test_tournament_spans_equal_jax(traced_runs):
    """Each trainer row carries the same multiset of span names (steps,
    data waits, rounds, evals from the executor threads, exchanges), the
    orchestrator row the same tournaments and checkpoints, and the phase
    calls agree."""
    jrows, trows = _rows(traced_runs["jtel"].tracer), \
        _rows(traced_runs["ttel"].tracer)
    assert trows == jrows
    for i in range(K):
        assert trows[f"trainer {i}"] == Counter(
            data_wait=ROUNDS * STEPS, step=ROUNDS * STEPS,
            train_round=ROUNDS, tournament_eval=2 * ROUNDS,
            partner_exchange=ROUNDS)
    assert trows["orchestrator"] == Counter(tournament=ROUNDS,
                                            checkpoint=ROUNDS)
    assert traced_runs["ttel"].phase_calls == \
        traced_runs["jtel"].phase_calls
    assert traced_runs["ttel"].tracer.dropped == 0


def test_flop_probe_matches_jax_and_leaves_trainer_0_untouched(
        traced_runs):
    """``flops_per_step`` within 5% of JAX's XLA count (FlopCounterMode
    counts the products only); trainer 0's weights and Adam state
    bit-equal around the probe; the probe's batch read from trainer 0's
    store, so the datastore counters equal JAX's."""
    jf, tf = traced_runs["jstats"]["flops_per_step"], \
        traced_runs["tstats"]["flops_per_step"]
    assert tf == pytest.approx(jf, rel=0.05) and tf > 0
    before, after = traced_runs["probe"]
    for b, a in zip(before, after):
        for k in b:
            assert torch.equal(b[k], a[k]), k
    def counters(st):
        return {k: v for k, v in st["total"].items()
                if not k.endswith("_seconds")}

    assert counters(traced_runs["tstats"]) == \
        counters(traced_runs["jstats"])


def test_lm_step_flops_is_none_in_both_packages():
    """JAX's LM step is a Python wrapper XLA cannot cost; the port's
    launches kernels FlopCounterMode cannot see: neither counts."""
    from repro.configs import qwen3_06b as jq
    from repro_torch.configs import qwen3_06b as tq
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.train.steps import make_lm_population_fns

    jinit, jstep, _ = jsteps.make_lm_population_fns(
        jq.SMOKE, jbase.OptimizerConfig(**OPT))
    assert jtel.step_flops(jstep, None, None, None, None) is None
    init, step, *_ = make_lm_population_fns(
        tq.SMOKE, OptimizerConfig(**OPT), device="cpu")
    p, o, h = init(0)
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32),
             "labels": torch.zeros((2, 8), dtype=torch.int32)}
    assert step.hidden_kernel_flops
    assert ttel.step_flops(step, p, o, batch, h) is None
    assert ttel.step_flops(lambda *a: 1 / 0) is None     # fails: None


# ---------------------------------------------------------------------------
# the ltfb CLI's telemetry flags
# ---------------------------------------------------------------------------

CLI = ["--arch", "icf-cyclegan", "--smoke", "--trainers", "2", "--rounds",
       "2", "--steps-per-round", "1", "--batch", "16", "--samples", "160",
       "--samples-per-file", "32"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The port's ltfb CLI with ``--trace-out --prom-out --metrics-port 0
    --ckpt-dir`` (the genealogy at its default path); the endpoint's body
    is read just before the CLI closes it."""
    root = tmp_path_factory.mktemp("torch_tel_cli")
    scraped = []
    close = ttel.MetricsServer.close

    def scrape_then_close(self):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}/metrics", timeout=30) as r:
            scraped.append((r.headers["Content-Type"], r.read().decode()))
        close(self)

    ttel.MetricsServer.close = scrape_then_close
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = tlaunch.main(CLI + [
                "--device", "cpu", "--data-dir", str(root / "data"),
                "--ckpt-dir", str(root / "ck"), "--trace-out",
                str(root / "trace.json"), "--prom-out",
                str(root / "m.prom"), "--metrics-port", "0"])
    finally:
        ttel.MetricsServer.close = close
    return dict(rc=rc, root=root, out=out.getvalue(), scraped=scraped)


def test_ltfb_cli_trace_out(cli_run):
    assert cli_run["rc"] == 0
    path = cli_run["root"] / "trace.json"
    assert f"[ltfb] wrote {path}" in cli_run["out"]
    trace = json.load(open(path))
    assert trace["otherData"]["dropped"] == 0
    rows = {}
    names = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M"}
    for e in trace["traceEvents"]:
        if e["ph"] == "X":
            rows.setdefault(names[e["tid"]], set()).add(e["name"])
    for i in range(2):
        assert rows[f"trainer {i}"] == {"data_wait", "step", "train_round",
                                        "tournament_eval",
                                        "partner_exchange"}
    assert rows["orchestrator"] == {"tournament", "checkpoint"}


def test_ltfb_cli_prom_out(cli_run):
    text = open(cli_run["root"] / "m.prom").read()
    assert not os.path.exists(cli_run["root"] / "m.prom.tmp")
    assert "repro_train_rounds_total 2\n" in text
    assert "repro_train_steps_total 4\n" in text
    samples = dict(ln.rsplit(" ", 1) for ln in text.splitlines()
                   if not ln.startswith("#"))
    flops = float(samples["repro_train_model_flops_per_s"])
    assert np.isfinite(flops) and flops > 0
    assert 'repro_train_phase_seconds_total{phase="compute"}' in text
    for line in text.splitlines():
        assert line.startswith("# ") or len(line.split()) == 2, line


def test_ltfb_cli_metrics_port_serves_the_prom_file(cli_run):
    port = int(cli_run["out"].split("http://127.0.0.1:")[1].split("/")[0])
    assert port > 0
    (ctype, body), = cli_run["scraped"]
    assert ctype.startswith("text/plain")
    assert body == open(cli_run["root"] / "m.prom").read()


def test_ltfb_cli_genealogy_default_and_explicit(cli_run, tmp_path):
    """Under ``--ckpt-dir`` the genealogy lands in it by default and the
    registry's scans ignore it; ``--genealogy`` names another file, and a
    resumed run appends to it."""
    from repro_torch.serve import registry as treg

    ck = cli_run["root"] / "ck"
    recs = ttel.replay_genealogy(str(ck / "genealogy.jsonl"))
    assert [r["t"] for r in recs] == \
        ["init"] + ["match", "match", "round", "checkpoint"] * 2
    assert treg.population_steps(str(ck)) == [1, 2]
    assert treg.latest_winner_step(str(ck)) is None
    gpath = str(tmp_path / "g" / "lineage.jsonl")
    argv = CLI + ["--device", "cpu", "--data-dir",
                  str(cli_run["root"] / "data"), "--ckpt-dir",
                  str(tmp_path / "ck"), "--genealogy", gpath]
    with contextlib.redirect_stdout(io.StringIO()):
        assert tlaunch.main(argv) == 0
        assert tlaunch.main(argv[:6] + ["1"] + argv[7:]) == 0
    assert not os.path.exists(tmp_path / "ck" / "genealogy.jsonl")
    kinds = [r["t"] for r in ttel.replay_genealogy(gpath)]
    assert kinds.count("init") == 2 and kinds.count("resume") == 1
    assert tlineage.summarize(ttel.replay_genealogy(gpath))["rounds"] == 3


def test_ltfb_cli_log_json_records_carry_jaxs_event_names(tmp_path,
                                                          capsys):
    """Every line is one JSON record, and the records' event names follow
    the JAX launcher's on the same flags."""
    events = {}
    for name, main in (("jax", jlaunch.main), ("port", tlaunch.main)):
        extra = ["--device", "cpu"] if name == "port" else []
        assert main(CLI + extra + ["--log-json", "--data-dir",
                                   str(tmp_path / f"d{name}")]) == 0
        lines = capsys.readouterr().out.splitlines()
        recs = [json.loads(ln) for ln in lines]
        events[name] = [r["event"] for r in recs]
        for mod in (jtelemetry, ttelemetry):
            mod.enable_json_logs(False)
    assert events["port"] == events["jax"]
    assert events["port"][:2] == ["ltfb_manifest", "ltfb_start"]
    assert events["port"].count("ltfb_round") == 2
