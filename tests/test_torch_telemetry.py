"""The port's telemetry core and serving telemetry against the JAX
package's, on the CPU.

* the shared core (``repro_torch.telemetry``): the same ``Tracer`` calls
  with explicit times and an equal epoch export the same Chrome trace,
  ring eviction included; the Prometheus building blocks give the same
  text; JSON log records carry the same fields;
* the serving exposition: ``prometheus_text`` of two ``ServeStats`` holding
  the same counters, samples and clock is byte-equal in the two packages;
* the scheduler: the same SMOKE qwen3 trace (f32, JAX's weights crossed
  through ``repro_torch.bridge``) through both schedulers leaves the same
  span and instant names on every request's row, the same
  ``phase_calls`` and the same counters in the exposition, under the same
  family names and HELP/TYPE lines; ``telemetry=False`` serves the same
  tokens with no events and the counters kept; a two-step
  ``torch.profiler`` window writes one trace file.
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import telemetry as jtelemetry
from repro.serve import metrics as jmetrics
from repro.serve import telemetry as jserve_tel
from repro_torch import telemetry as ttelemetry
from repro_torch.serve import metrics as tmetrics
from repro_torch.serve import telemetry as tserve_tel


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
# the shared core
# ---------------------------------------------------------------------------


def _drive_tracer(mod, capacity):
    tr = mod.Tracer(capacity, row_name="scheduler", row_prefix="req")
    tr.epoch = 100.0
    for i in range(7):
        t = 100.0 + 0.25 * i
        tr.complete("decode", mod.SCHED_TID, t, t + 0.125, step=i)
        tr.req_instant("enqueue", f"r{i % 3}", t, queue_depth=i)
        tr.req_span("prefill", i % 3, t, t + 0.5, tokens=8 + i)
        tr.instant("hot_swap", mod.SCHED_TID, t + 0.01, swaps=i)
    tr.complete("negative", 5, 101.0, 100.5)          # clamped to 0
    return tr


@pytest.mark.parametrize("capacity", [4, 64])
def test_tracer_export_equals_jax(capacity, tmp_path):
    """Same events, rows, metadata and ``otherData``; with capacity 4 the
    ring has evicted most of them (``dropped``)."""
    jt, tt = _drive_tracer(jtelemetry, capacity), \
        _drive_tracer(ttelemetry, capacity)
    assert tt.export() == jt.export()
    assert (tt.emitted, tt.dropped) == (jt.emitted, jt.dropped)
    assert tt.dropped == max(0, 29 - capacity)
    jtelemetry.write_trace(jt, str(tmp_path / "j.json"))
    ttelemetry.write_trace(tt, str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "t.json")) == \
        json.load(open(tmp_path / "j.json"))


VALUES = [True, False, 0, 7, -3, 2.5, 1e-300, 123456.789, float("nan"),
          float("inf"), float("-inf"), np.float32(0.1).item()]


def test_prometheus_building_blocks_equal_jax():
    for v in VALUES:
        assert ttelemetry.prom_fmt(v) == jtelemetry.prom_fmt(v), v
    outs = []
    for mod in (jtelemetry, ttelemetry):
        out = []
        mod.prom_counter(out, "x_total", "a counter", 3)
        mod.prom_gauge(out, "y", "a gauge", float("nan"))
        mod.prom_labeled(out, "z", "gauge", "labelled",
                         [({"trainer": 0, "metric": "loss"}, 0.5),
                          ({"trainer": 1, "metric": "loss"}, float("inf")),
                          ({}, 2)])
        mod.prom_labeled(out, "empty", "counter", "no samples", [])
        outs.append(out)
    assert outs[1] == outs[0]


def test_json_log_records_carry_jaxs_fields(capsys):
    fields = dict(rid=3, ok=True, nan=float("nan"), nested={"a": (1, 2)},
                  obj=object)
    recs = []
    for mod in (jtelemetry, ttelemetry):
        mod.log_event("nothing")                 # off: no output
        assert capsys.readouterr().out == ""
        mod.enable_json_logs()
        assert mod.json_logs_enabled()
        mod.log_event("shed", **fields)
        mod.enable_json_logs(False)
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == 1
        recs.append(json.loads(lines[0]))
    jrec, trec = recs
    for rec in (jrec, trec):
        assert rec.pop("ts_monotonic") > 0 and rec.pop("ts_unix") > 0
    assert trec == jrec == {"event": "shed", "rid": 3, "ok": True,
                            "nan": None, "nested": {"a": [1, 2]},
                            "obj": str(object)}


# ---------------------------------------------------------------------------
# the serving exposition
# ---------------------------------------------------------------------------

_COUNTERS = dict(slots=4, submitted=9, completed=7, rejected=1, prefills=8,
                 prefill_chunks=5, prefill_tokens=120,
                 padded_prefill_tokens=128, decode_steps=40,
                 decode_tokens=90, decode_slot_steps=160, spec_rounds=3,
                 spec_draft_steps=3, spec_draft_proposed=9,
                 spec_draft_accepted=5, spec_replays=1, spec_k_sum=9,
                 spec_k_rows=3, ragged_splits=2, hot_swaps=1,
                 swap_rejected_corrupt=1, steps=44, queue_depth_sum=30,
                 queue_depth_max=5, slot_busy_sum=120)


def _stats(mod):
    s = mod.ServeStats(**_COUNTERS)
    s.started, s.finished = 10.0, 12.5
    for i in range(12):
        s.ttft.append(0.003 * (i + 1) ** 2)
        s.tpot.append(0.0004 * (i + 1))
        s.latency.append(0.05 * (i + 1))
    s.latency.append(500.0)                      # the +Inf bucket
    return s


def test_serve_prometheus_text_is_byte_equal_to_jax():
    shards = [{"used_blocks": 3, "committed_blocks": 5, "pinned_blocks": 1,
               "high_water_blocks": 9, "num_blocks": 12}]
    phases = {"decode": 1.25, "admit": 0.01, "prefill": 0.5}
    kw = dict(pool_shards=shards, phase_seconds=phases, queue_depth=2,
              slots_busy=3)
    got = tserve_tel.prometheus_text(_stats(tmetrics), **kw)
    want = jserve_tel.prometheus_text(_stats(jmetrics), **kw)
    assert got == want
    # the counters the port does not keep read 0, as in JAX
    assert "repro_serve_cancelled_total 0\n" in got
    assert tserve_tel.prometheus_text(tmetrics.ServeStats()) == \
        jserve_tel.prometheus_text(jmetrics.ServeStats())


def test_unported_exposition_parts_raise_naming_their_queue():
    s = tmetrics.ServeStats()
    # the mesh's per-rank series render (ported since the mesh-serving
    # slice), as JAX's
    remote = {1: {"rank": 1, "completed": 3, "shards": [
        {"high_water_blocks": 5}]}}
    got = tserve_tel.prometheus_text(s, remote_stats=remote)
    assert got == jserve_tel.prometheus_text(jmetrics.ServeStats(),
                                             remote_stats=remote)
    assert 'repro_serve_mesh_completed_total{rank="1"} 3\n' in got
    # the arena's families render, as JAX's
    counters = {"promotions": 2, "members": {
        "b": {"accept_rate": 0.5, "served_tokens": 7},
        "a": {"accept_rate": 0.0, "served_tokens": 0}}}
    got = tserve_tel.prometheus_text(s, arena=counters)
    assert got == jserve_tel.prometheus_text(jmetrics.ServeStats(),
                                             arena=counters)
    assert 'repro_serve_arena_accept_rate{member="b"} 0.5\n' in got
    assert "repro_serve_arena_promotions_total 2\n" in got
    # empty ones are no series at all, as in JAX
    assert tserve_tel.prometheus_text(s, remote_stats={}, arena={}) == \
        tserve_tel.prometheus_text(s)


def test_serve_report_emits_a_json_record_under_log_json(capsys):
    s = _stats(tmetrics)
    s.report()
    assert not any(ln.startswith("{")
                   for ln in capsys.readouterr().out.splitlines())
    ttelemetry.enable_json_logs()
    s.report()
    lines = capsys.readouterr().out.splitlines()
    recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert len(recs) == 1 and recs[0]["event"] == "serve_report"
    assert recs[0]["completed"] == 7 and recs[0]["decode_tokens"] == 90
    assert any(ln.startswith("[serve] throughput:") for ln in lines)


# ---------------------------------------------------------------------------
# the scheduler's span chain, phases and counters against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    from repro.configs import qwen3_06b as jq
    from repro.models.lm import init_lm as jax_init_lm
    from repro_torch.bridge import load_jax_params
    from repro_torch.configs import qwen3_06b as tq
    from repro_torch.models.lm import init_lm

    jcfg = dataclasses.replace(jq.SMOKE, dtype="float32")
    tcfg = dataclasses.replace(tq.SMOKE, dtype="float32")
    params = jax.jit(lambda key: jax_init_lm(jcfg, key)[0])(
        jax.random.PRNGKey(0))
    model = init_lm(tcfg, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, tcfg, model


def _trace(vocab):
    """Five requests over two slots: prompts 5-14 tokens, request 1
    sharing request 0's first pages, so admission waits and queues."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, vocab, 14).astype(np.int32)
    prompts = [base[:9], np.concatenate([base[:8], rng.integers(
        0, vocab, 4).astype(np.int32)]), base, base[3:8],
        rng.integers(0, vocab, 7).astype(np.int32)]
    return [dict(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]


KW = dict(num_slots=2, max_len=24, block_size=4)


def _serve(sched, request_cls, trace):
    for r in trace:
        sched.submit(request_cls(**r))
    out = sched.run(max_steps=400)
    return {rid: v.tolist() for rid, v in out.items()}


def _rows(tracer):
    """Every request's event names, in emission order, keyed by rid."""
    rows = {}
    for ev in tracer.export()["traceEvents"]:
        if ev["ph"] in ("X", "i") and "rid" in ev["args"]:
            rows.setdefault(ev["args"]["rid"], []).append(ev["name"])
    return rows


def _families(text):
    return [ln for ln in text.splitlines() if ln.startswith("#")]


def _counter_samples(text):
    return {ln.split()[0]: ln.split()[1] for ln in text.splitlines()
            if not ln.startswith("#") and "_total" in ln.split()[0]
            and "phase_seconds" not in ln}


@pytest.mark.parametrize("case", ["chunked", "dense", "spec"])
def test_scheduler_trace_phases_and_exposition_equal_jax(weights, case):
    """Chunked prefill over the paged pool, one-shot prefill over dense
    rows, and a speculative round with a self drafter (K = 2)."""
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.serve.scheduler import Request, Scheduler

    jcfg, params, tcfg, model = weights
    kw = dict(KW)
    jx, tx = {}, {}
    if case == "chunked":
        kw["prefill_chunk"] = 4
    elif case == "dense":
        kw["layout"] = "dense"
    else:
        jx, tx = dict(draft_params=params, spec_tokens=2), \
            dict(draft_params=model, spec_tokens=2)
    js = JScheduler(jcfg, params, **kw, **jx)
    ts = Scheduler(tcfg, model, device="cpu", **kw, **tx)
    trace = _trace(jcfg.vocab_size)
    jres, tres = _serve(js, JRequest, trace), _serve(ts, Request, trace)
    assert tres == jres
    jrows, trows = _rows(js.telemetry.tracer), _rows(ts.telemetry.tracer)
    assert trows == jrows
    for rid, names in trows.items():
        assert names[:3] == ["enqueue", "queued", "admit"], names
        assert names[-1] == "finish" and "first_token" in names
        # paged attention-only prompts prefill in chunks (one, when the
        # chunk size is 0); dense rows in one shot
        assert ("prefill" if case == "dense" else "prefill_chunk") \
            in names
    assert ts.telemetry.phase_calls == js.telemetry.phase_calls
    want_phases = {"admit", "prefill", "decode"} | (
        {"draft", "verify"} if case == "spec" else set())
    assert set(ts.telemetry.phase_seconds) == want_phases
    assert ts.telemetry.tracer.dropped == 0
    # the scheduler's row: phase spans only where a phase had work
    sched_names = {ev["name"]
                   for ev in ts.telemetry.tracer.export()["traceEvents"]
                   if ev["ph"] == "X" and ev["tid"] == 0}
    jsched_names = {ev["name"]
                    for ev in js.telemetry.tracer.export()["traceEvents"]
                    if ev["ph"] == "X" and ev["tid"] == 0}
    assert sched_names == jsched_names
    got = tserve_tel.scheduler_prometheus(ts)
    want = jserve_tel.scheduler_prometheus(js)
    assert _families(got) == _families(want)
    assert _counter_samples(got) == _counter_samples(want)
    assert _counter_samples(got)["repro_serve_completed_total"] == "5"
    snap = tserve_tel.stats_snapshot(ts)
    jsnap = jserve_tel.stats_snapshot(js)
    assert snap == jsnap


def test_telemetry_off_serves_the_same_tokens_with_no_events(weights):
    from repro_torch.serve.scheduler import Request, Scheduler

    _, _, tcfg, model = weights
    trace = _trace(tcfg.vocab_size)
    on = Scheduler(tcfg, model, device="cpu", **KW)
    off = Scheduler(tcfg, model, device="cpu", telemetry=False, **KW)
    assert _serve(off, Request, trace) == _serve(on, Request, trace)
    assert off.telemetry.tracer.emitted == 0
    assert on.telemetry.tracer.emitted > 0
    for k in ("completed", "decode_steps", "decode_tokens", "prefills"):
        assert getattr(off.stats, k) == getattr(on.stats, k) > 0, k
    assert off.telemetry.phase_calls == on.telemetry.phase_calls
    text = tserve_tel.scheduler_prometheus(off)
    assert 'repro_serve_phase_seconds_total{phase="decode"}' in text


def test_profile_window_writes_one_trace(weights, tmp_path):
    """Two steps under ``torch.profiler``: one Chrome trace file whose
    events include the scheduler's model calls; later steps run
    unprofiled; a second profiler that cannot start is recorded, not
    raised."""
    from repro_torch.serve.scheduler import Request, Scheduler

    _, _, tcfg, model = weights
    sched = Scheduler(tcfg, model, device="cpu", **KW)
    sched.profile_steps(2, str(tmp_path / "prof"))
    assert sched.telemetry.profile_armed()
    res = _serve(sched, Request, _trace(tcfg.vocab_size))
    tel = sched.telemetry
    assert len(res) == 5 and sched.stats.steps > 2
    assert (tel.profiles_taken, tel.profile_error) == (1, None)
    files = os.listdir(tmp_path / "prof")
    assert files == ["profile_step1.json"] == [
        os.path.basename(p) for p in tel.profile_files]
    events = json.load(open(tmp_path / "prof" / files[0]))["traceEvents"]
    assert any("aten::" in str(e.get("name")) for e in events)
    assert not tel.profile_armed()
    # an outer profiler already records: the window reports its error
    sched2 = Scheduler(tcfg, model, device="cpu", **KW)
    sched2.profile_steps(1, str(tmp_path / "prof2"))
    with torch.profiler.profile():
        _serve(sched2, Request, _trace(tcfg.vocab_size)[:1])
    assert sched2.telemetry.profiles_taken == 0
    assert sched2.telemetry.profile_error is not None


def test_hot_swap_is_an_event_and_a_json_record(weights, capsys):
    from repro_torch.serve.scheduler import Scheduler

    _, _, tcfg, model = weights
    sched = Scheduler(tcfg, model, device="cpu", **KW)
    ttelemetry.enable_json_logs()
    sched.set_params(model.state_dict())
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert (rec["event"], rec["swaps"]) == ("hot_swap", 1)
    evs = [e for e in sched.telemetry.tracer.export()["traceEvents"]
           if e["name"] == "hot_swap"]
    assert len(evs) == 1 and evs[0]["ph"] == "i" and evs[0]["tid"] == 0


def test_surrogate_events_equal_jax():
    """The surrogate engine's query events and collect phases, as JAX's
    engine emits them for the same queries."""
    from repro.configs import icf_cyclegan as jcfgs
    from repro.models.icf_cyclegan import init_cyclegan as jinit
    from repro.serve.surrogate import SurrogateEngine as JEngine
    from repro_torch.bridge import cyclegan_params_from_jax
    from repro_torch.configs import icf_cyclegan as tcfgs
    from repro_torch.serve.surrogate import SurrogateEngine

    jp, _ = jinit(jcfgs.SMOKE, jax.random.PRNGKey(0))
    tp = cyclegan_params_from_jax(jax.tree.map(np.asarray, jp))
    xs = np.random.default_rng(0).random((10, tcfgs.SMOKE.input_dim)) \
        .astype(np.float32)
    engines = (JEngine(jcfgs.SMOKE, jp, max_batch=8, bucket=4),
               SurrogateEngine(tcfgs.SMOKE, tp, max_batch=8, bucket=4,
                               device="cpu"))
    for eng in engines:
        for i, n in enumerate((3, 4, 2, 1)):
            eng.submit(i, xs[sum((3, 4, 2, 1)[:i]):][:n])
        eng.run()
    jrows, trows = (_rows(e.telemetry.tracer) for e in engines)
    assert trows == jrows and set(trows) == {"0", "1", "2", "3"}
    calls = engines[1].telemetry.phase_calls
    assert calls == engines[0].telemetry.phase_calls
    assert list(calls) == ["surrogate_collect"] and calls[
        "surrogate_collect"] == engines[1].stats.decode_steps >= 2
    off = SurrogateEngine(tcfgs.SMOKE, tp, device="cpu", telemetry=False)
    off.submit(0, xs[:2])
    off.run()
    assert off.telemetry.tracer.emitted == 0 and off.stats.completed == 1


def test_serve_cli_telemetry_flags(tmp_path, capsys):
    """``--trace-out``, ``--profile-steps``/``--profile-dir``,
    ``--log-json`` and ``--no-telemetry`` on the CPU."""
    from repro_torch.launch import serve as tserve

    base = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "4"]
    trace = tmp_path / "tr.json"
    assert tserve.main(base + ["--trace-out", str(trace), "--profile-steps",
                               "2", "--profile-dir",
                               str(tmp_path / "p")]) == 0
    out = capsys.readouterr().out
    assert f"[serve] trace: {trace} events=" in out and "dropped=0" in out
    assert "[serve] profile: taken=1" in out and "error=None" in out
    assert os.listdir(tmp_path / "p") == ["profile_step1.json"]
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
    assert {"enqueue", "queued", "admit", "first_token", "finish",
            "decode"} <= names
    assert tserve.main(base + ["--no-telemetry", "--trace-out",
                               str(trace), "--log-json"]) == 0
    lines = capsys.readouterr().out.splitlines()
    recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r["event"] for r in recs] == ["serve_report"]
    assert recs[0]["completed"] == 3
    assert json.load(open(trace))["otherData"]["emitted"] == 0
    assert not math.isnan(recs[0]["tokens_per_s"])
