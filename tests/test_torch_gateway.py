"""The port's HTTP gateway on the CPU (``repro_torch.serve.gateway``).

Every in-flight state a test asserts on is held deterministically: a
``_Gate`` wraps the scheduler's ``step`` so that the gateway's driver
thread blocks before each step until the test lets it through, and the
overload test holds admission shut the same way.  Nothing sleeps and
hopes; the gateway itself carries no hook for this.

* a streamed, a non-streamed and a sampled request give the tokens the
  JAX package's scheduler gives for the same weights and prompts;
* 429 with ``Retry-After`` on overload (``max_queue``) and on a missed
  TTFT deadline, 400 on a bad body or a refused request;
* backpressure cancels a consumer that stops draining its buffer, and a
  client that disconnects mid-stream has its slot freed;
* a drain answers 503 on ``/v1/generate`` and ``/readyz`` while the
  in-flight request finishes;
* ``Idempotency-Key``: 409 while the original is in flight, a replay once
  it finished, and the same from a map seeded from a journal;
* a driver thread that raises fails the open request and every later
  one instead of leaving them waiting, and ``stop`` ends a stream the
  driver left unfinished instead of waiting on its connection;
* ``/metrics`` as Prometheus text and as JSON, ``/debug/trace``,
  ``/debug/profile``, and 404 from ``/population`` and
  ``/arena/promote`` with no arena attached;
* the serve CLI's ``--gateway`` drains on SIGTERM and leaves a
  ``shutdown`` note in its ``--journal``.
"""
import asyncio
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def served():
    from repro_torch.configs import qwen3_06b as tq
    from repro_torch.models.lm import init_lm

    cfg = dataclasses.replace(tq.SMOKE, dtype="float32")
    return cfg, init_lm(cfg, seed=0, device="cpu")


def _sched(served, **kw):
    from repro_torch.serve.scheduler import Scheduler

    cfg, model = served
    kw.setdefault("num_slots", 1)
    kw.setdefault("max_len", 48)
    return Scheduler(cfg, model, block_size=4, device="cpu", **kw)


def _prompt(cfg, n=8, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n).tolist()


class _Gate:
    """Holds the gateway's driver thread before every scheduler step
    until the test lets that step through (``allow``) or opens the gate
    (``open``).  ``arrived_at(n)`` returns once the driver has reached its
    n-th step, so everything it did before that step is done; ``until``
    waits for a condition that a step's arrival or a cancel makes true."""

    def __init__(self, sched):
        self._cv = threading.Condition()
        self.arrived = 0
        self.allowed = 0
        self.opened = False
        step, cancel = sched.step, sched.cancel

        def gated():
            with self._cv:
                self.arrived += 1
                n = self.arrived
                self._cv.notify_all()
                self._cv.wait_for(lambda: self.opened or self.allowed >= n)
            step()

        def notified(rid):
            out = cancel(rid)
            with self._cv:
                self._cv.notify_all()
            return out
        sched.step, sched.cancel = gated, notified

    def allow(self, n=1):
        with self._cv:
            self.allowed += n
            self._cv.notify_all()

    def open(self):
        with self._cv:
            self.opened = True
            self._cv.notify_all()

    async def until(self, pred, timeout=120):
        def wait():
            with self._cv:
                return self._cv.wait_for(pred, timeout)
        assert await asyncio.get_running_loop().run_in_executor(None, wait)

    async def arrived_at(self, n):
        await self.until(lambda: self.arrived >= n)


# -- raw HTTP client (stdlib only, like the gateway itself) -----------------


async def _http(port, method, path, body=None, headers=None, raw=None):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    payload = raw if raw is not None else \
        (json.dumps(body).encode() if body is not None else b"")
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    w.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n{extra}"
             f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload)
    await w.drain()
    data = await r.read()
    w.close()
    return data.decode()


async def _open_stream(port, body, headers=None):
    """Send a generate request and return the open connection."""
    r, w = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    w.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n{extra}"
             f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload)
    await w.drain()
    return r, w


def _status(resp: str) -> int:
    return int(resp.split()[1])


def _body(resp: str):
    return json.loads(resp.split("\r\n\r\n", 1)[1])


def _header(resp: str, name: str):
    for line in resp.split("\r\n\r\n", 1)[0].split("\r\n")[1:]:
        k, _, v = line.partition(":")
        if k.strip().lower() == name.lower():
            return v.strip()
    return None


def _ndjson(resp: str):
    """Decode a chunked NDJSON body into its records."""
    body = resp.split("\r\n\r\n", 1)[1]
    recs = []
    while body:
        size, _, rest = body.partition("\r\n")
        n = int(size, 16)
        if n == 0:
            break
        recs.append(json.loads(rest[:n]))
        body = rest[n + 2:]
    return recs


def _run(gw, coro_fn, timeout=300):
    """Start the gateway, run the test's coroutine, stop the gateway."""
    async def go():
        await gw.start()
        try:
            return await coro_fn()
        finally:
            await gw.stop()
    return asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(go(), timeout))


# ---------------------------------------------------------------------------


def test_stream_nonstream_and_jax_scheduler_give_the_same_tokens(served):
    """One request at a time through the port's gateway, streamed, not
    streamed and sampled at T = 0.8, against JAX's scheduler serving each
    request alone on the same weights."""
    jax = pytest.importorskip("jax")
    from repro.configs import qwen3_06b as jq
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.bridge import params_to_jax_layout
    from repro_torch.serve.gateway import Gateway

    cfg, model = served
    sched = _sched(served, num_slots=2)
    gw = Gateway(sched)
    bodies = [{"rid": "s", "prompt": _prompt(cfg), "max_new": 6},
              {"rid": "p", "prompt": _prompt(cfg), "max_new": 6,
               "stream": False},
              {"rid": "t", "prompt": _prompt(cfg, 11, seed=4), "max_new": 7,
               "temperature": 0.8, "seed": 5}]

    async def go():
        return [await _http(gw.port, "POST", "/v1/generate", b)
                for b in bodies]

    streamed, plain, sampled = _run(gw, go)
    recs = _ndjson(streamed)
    toks = [r["token"] for r in recs if "token" in r]
    assert recs[-1] == {"rid": "s", "done": True, "ntok": 6}
    assert _status(plain) == 200 and _body(plain) == {"rid": "p",
                                                      "tokens": toks}
    stoks = [r["token"] for r in _ndjson(sampled) if "token" in r]
    jcfg = dataclasses.replace(jq.SMOKE, dtype="float32")
    params = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()),
                          params_to_jax_layout(model, cfg))
    js = JScheduler(jcfg, params, num_slots=2, max_len=48, block_size=4,
                    telemetry=False)
    want = []
    for b in bodies[1:]:
        js.submit(JRequest(rid=b["rid"], prompt=np.asarray(b["prompt"],
                                                           np.int32),
                           max_new=b["max_new"],
                           temperature=b.get("temperature", 0.0),
                           seed=b.get("seed")))
        want.append(js.run()[b["rid"]].tolist())
    assert [toks, stoks] == want
    assert sched.stats.completed == 3 and sched.stats.submitted == 3


def test_overload_and_missed_deadline_are_429_with_retry_after(served):
    """Admission is held shut while two requests fill ``max_queue=2``:
    the third is shed (429, ``Retry-After``); a request whose TTFT
    deadline has passed when the driver sheds is a 429 too, streamed or
    not; the held requests then complete."""
    from repro_torch.serve.gateway import Gateway

    cfg, _ = served
    sched = _sched(served, max_queue=2)
    admit = sched._admission_phase
    hold = threading.Event()
    sched._admission_phase = lambda: admit() if hold.is_set() else 0
    queued = threading.Semaphore(0)
    submit = sched.submit

    def counted(req):
        submit(req)
        queued.release()
    sched.submit = counted
    gw = Gateway(sched)

    async def go():
        loop = asyncio.get_running_loop()
        held = [asyncio.ensure_future(_http(
            gw.port, "POST", "/v1/generate",
            {"rid": f"q{i}", "prompt": _prompt(cfg), "max_new": 3,
             "stream": False})) for i in range(2)]
        for _ in range(2):
            assert await loop.run_in_executor(None, queued.acquire, True,
                                              120)
        over = await _http(gw.port, "POST", "/v1/generate",
                           {"rid": "over", "prompt": _prompt(cfg),
                            "max_new": 3})
        hold.set()
        done = await asyncio.gather(*held)
        late = [await _http(gw.port, "POST", "/v1/generate",
                            {"rid": f"late{s}", "prompt": _prompt(cfg),
                             "max_new": 3, "ttft_deadline_ms": 1e-6,
                             "stream": s}) for s in (True, False)]
        return over, done, late

    over, done, late = _run(gw, go)
    assert _status(over) == 429 and _header(over, "Retry-After") == "1"
    assert _body(over)["rid"] == "over" and "max_queue=2" in over
    assert [_status(d) for d in done] == [200, 200]
    for resp in late:
        assert _status(resp) == 429 and _header(resp, "Retry-After")
        assert "deadline" in _body(resp)["error"]
    st = sched.stats
    assert (st.shed_overload, st.shed_deadline, st.completed,
            st.rejected) == (1, 2, 2, 0)


def test_bad_bodies_are_400(served):
    from repro_torch.serve.gateway import Gateway

    cfg, _ = served
    sched = _sched(served)
    gw = Gateway(sched)

    async def go():
        return [await _http(gw.port, "POST", "/v1/generate", body, raw=raw)
                for body, raw in (
                    ({}, None),                              # no prompt
                    (None, b"{not json"),
                    ({"prompt": _prompt(cfg), "max_new": "x"}, None),
                    ({"prompt": _prompt(cfg), "max_new": 4096}, None),
                    ({"prompt": _prompt(cfg), "max_new": 2,
                      "temperature": 0.7}, None))]          # no seed

    resps = _run(gw, go)
    assert [_status(r) for r in resps] == [400] * 5
    assert "bad request" in _body(resps[0])["error"]
    assert "seed" in _body(resps[4])["error"]
    assert sched.stats.rejected == 2 and sched.stats.submitted == 0


def test_backpressure_cancels_a_slow_consumer(served):
    """A consumer that stops draining its bounded buffer gets its
    request cancelled; later tokens are dropped, not queued."""
    from repro_torch.serve.gateway import Gateway, _Stream

    gw = Gateway(_sched(served), stream_buffer=2)
    loop = asyncio.new_event_loop()
    gw.loop = loop
    st = _Stream(rid="slow", q=asyncio.Queue())
    gw._streams["slow"] = st
    for i in range(5):                # the consumer never drains
        gw._post(st, ("tok", i))
    loop.run_until_complete(asyncio.sleep(0))
    assert st.error is not None and "backpressure" in st.error
    assert list(gw._cancels) == ["slow"]
    assert st.q.qsize() == 2 and "slow" not in gw._streams
    gw._post(st, ("tok", 99))
    assert st.q.qsize() == 2
    loop.close()


def test_client_disconnect_frees_its_slot(served):
    """The client aborts after its first token; the driver, let through
    one step at a time, publishes tokens until the gateway notices and
    cancels; the freed slot then serves the next request."""
    from repro_torch.serve.gateway import Gateway

    cfg, _ = served
    sched = _sched(served)
    free0 = sched.pool.blocks.available_blocks
    gate = _Gate(sched)
    gw = Gateway(sched)

    async def go():
        r, w = await _open_stream(gw.port, {"rid": "gone", "max_new": 32,
                                            "prompt": _prompt(cfg)})
        await gate.arrived_at(1)
        gate.allow()                              # prefill: first token
        await r.readuntil(b"token")
        w.transport.abort()
        n = 1
        while "gone" in sched.active and n < 30:
            gate.allow()
            n += 1
            await gate.until(lambda: gate.arrived >= n
                             or "gone" not in sched.active)
        gate.open()
        nxt = await _http(gw.port, "POST", "/v1/generate",
                          {"rid": "after", "prompt": _prompt(cfg, seed=5),
                           "max_new": 4, "stream": False})
        return nxt, n

    nxt, n = _run(gw, go)
    assert n < 30
    assert _status(nxt) == 200 and len(_body(nxt)["tokens"]) == 4
    assert sched.stats.cancelled == 1 and "gone" not in sched.results
    assert sched.pool.blocks.available_blocks == free0
    assert sched.pool.free_slots == 1


def test_drain_refuses_new_work_with_503(served):
    """``begin_drain``: ``/readyz`` and new generates answer 503 with
    ``Retry-After`` while the in-flight request streams to its end."""
    from repro_torch.serve.gateway import Gateway

    cfg, _ = served
    sched = _sched(served)
    gate = _Gate(sched)
    gw = Gateway(sched)

    async def go():
        ready = await _http(gw.port, "GET", "/readyz")
        r, w = await _open_stream(gw.port, {"rid": "inflight",
                                            "prompt": _prompt(cfg),
                                            "max_new": 6})
        await gate.arrived_at(1)                  # admitted, held
        gw.begin_drain()
        drained_early = gw.drained()
        after = await _http(gw.port, "GET", "/readyz")
        refused = await _http(gw.port, "POST", "/v1/generate",
                              {"rid": "late", "prompt": _prompt(cfg),
                               "max_new": 2, "stream": False})
        health = await _http(gw.port, "GET", "/healthz")
        gate.open()
        rest = (await r.read()).decode()
        w.close()
        for _ in range(1000):           # the driver drops the stream
            if gw.drained():
                break
            await asyncio.sleep(0.001)
        return ready, after, refused, health, rest, drained_early

    ready, after, refused, health, rest, early = _run(gw, go)
    assert _status(ready) == 200 and _body(ready)["ready"]
    assert _status(after) == 503 and _header(after, "Retry-After")
    assert _body(after)["draining"]
    assert _status(refused) == 503 and _header(refused, "Retry-After")
    assert "draining" in _body(refused)["error"]
    assert _status(health) == 200 and _body(health)["live"]
    recs = _ndjson(rest)
    assert recs[-1] == {"rid": "inflight", "done": True, "ntok": 6}
    assert not early and gw.drained()
    assert "late" not in sched.results and "inflight" in sched.results


def test_idempotency_conflict_in_flight_then_replay(served):
    """A retry with the same ``Idempotency-Key`` while the original is
    held in flight gets 409 + ``Retry-After``; once it finished, a retry
    replays its tokens without admitting anything."""
    from repro_torch.serve.gateway import Gateway

    cfg, _ = served
    sched = _sched(served)
    gate = _Gate(sched)
    gw = Gateway(sched)
    key = {"Idempotency-Key": "race"}

    async def go():
        first = asyncio.ensure_future(_http(
            gw.port, "POST", "/v1/generate",
            {"rid": "orig", "prompt": _prompt(cfg), "max_new": 5,
             "stream": False}, headers=key))
        await gate.arrived_at(1)                  # submitted, held
        for _ in range(100):                      # the loop records the key
            if "race" in gw._idem:
                break
            await asyncio.sleep(0)
        dup = await _http(gw.port, "POST", "/v1/generate",
                          {"prompt": _prompt(cfg), "max_new": 5},
                          headers=key)
        gate.open()
        first = await first
        replay = await _http(gw.port, "POST", "/v1/generate",
                             {"prompt": _prompt(cfg), "max_new": 5},
                             headers=key)
        body_key = await _http(gw.port, "POST", "/v1/generate",
                               {"prompt": _prompt(cfg), "max_new": 5,
                                "idempotency_key": "race"})
        return dup, first, replay, body_key

    dup, first, replay, body_key = _run(gw, go)
    assert _status(dup) == 409 and _header(dup, "Retry-After")
    assert _body(dup)["rid"] == "orig"
    assert _status(first) == 200
    for resp in (replay, body_key):
        assert _status(resp) == 200
        assert _body(resp) == {"rid": "orig",
                               "tokens": _body(first)["tokens"],
                               "idempotent_replay": True}
    assert sched.stats.submitted == 1


def test_seed_idempotency_from_a_journal(served, tmp_path):
    """Across a restart: a journal holds one finished and one unfinished
    keyed request.  The next generation replays it
    (``resume_scheduler``), seeds the gateway's key map
    (``idempotency_map``), answers the finished key with the journaled
    tokens and the unfinished one with 409 while it resumes, then with
    its stitched stream's new tokens."""
    from repro_torch.serve import journal as tjournal
    from repro_torch.serve.gateway import Gateway
    from repro_torch.serve.scheduler import Request

    cfg, _ = served
    path = str(tmp_path / "j.jsonl")
    first = _sched(served, num_slots=2,
                   journal=tjournal.RequestJournal(path))
    for rid, key, n in (("done", "k-done", 4), ("open", "k-open", 9)):
        first.submit(Request(rid=rid, prompt=np.asarray(_prompt(cfg),
                                                        np.int32),
                             max_new=n, idem_key=key))
    while "done" not in first.results:
        first.step()
    first.journal.close()                         # the generation dies
    entries = tjournal.replay(path)
    assert entries["done"].done and not entries["open"].done

    sched = _sched(served, num_slots=2)
    prefixes = tjournal.resume_scheduler(sched, entries)
    assert list(prefixes) == ["open"] and sched.stats.journal_replayed == 1
    gate = _Gate(sched)
    gw = Gateway(sched)
    gw.seed_idempotency(tjournal.idempotency_map(entries))

    async def go():
        await gate.arrived_at(1)                  # "open" queued, held
        done = await _http(gw.port, "POST", "/v1/generate",
                           {"prompt": _prompt(cfg), "max_new": 4},
                           headers={"Idempotency-Key": "k-done"})
        busy = await _http(gw.port, "POST", "/v1/generate",
                           {"prompt": _prompt(cfg), "max_new": 9},
                           headers={"Idempotency-Key": "k-open"})
        gate.open()
        while "open" not in sched.results:
            await asyncio.sleep(0.001)            # the resumed run drains
        again = await _http(gw.port, "POST", "/v1/generate",
                            {"prompt": _prompt(cfg), "max_new": 9},
                            headers={"Idempotency-Key": "k-open"})
        return done, busy, again

    done, busy, again = _run(gw, go)
    assert _status(done) == 200
    assert _body(done)["tokens"] == first.results["done"].tolist()
    assert _status(busy) == 409 and _body(busy)["rid"] == "open"
    assert _status(again) == 200 and _body(again)["idempotent_replay"]
    stitched = tjournal.stitched_results(sched.results, prefixes)["open"]
    assert len(stitched) == 9
    assert prefixes["open"] + _body(again)["tokens"] == stitched.tolist()
    assert sched.stats.submitted == 1             # the resume only


def test_metrics_trace_profile_and_unrouted_endpoints(served, tmp_path):
    """``/metrics`` as Prometheus text (the exposition of
    ``scheduler_prometheus``, lifecycle counters above 0) and as JSON
    (``as_dict`` plus the phase seconds); ``/debug/trace`` exports every
    request's span chain; ``/debug/profile`` arms a one-step
    ``torch.profiler`` window that writes one trace; the arena's routes
    and unknown ones answer 404."""
    from repro_torch.serve.gateway import Gateway

    cfg, _ = served
    sched = _sched(served, num_slots=2, max_queue=1)
    gw = Gateway(sched)
    prof_dir = str(tmp_path / "prof")

    async def go():
        bad_prof = await _http(gw.port, "POST", "/debug/profile",
                               {"steps": 0})
        armed = await _http(gw.port, "POST", "/debug/profile",
                            {"steps": 1, "dir": prof_dir})
        ok = await _http(gw.port, "POST", "/v1/generate",
                         {"rid": "a", "prompt": _prompt(cfg), "max_new": 3,
                          "stream": False})
        shed = await _http(gw.port, "POST", "/v1/generate",
                           {"rid": "b", "prompt": _prompt(cfg), "max_new": 3,
                            "ttft_deadline_ms": 1e-6})
        text = await _http(gw.port, "GET", "/metrics")
        js = await _http(gw.port, "GET", "/metrics",
                         headers={"Accept": "application/json"})
        trace = await _http(gw.port, "GET", "/debug/trace")
        others = [await _http(gw.port, m, p) for m, p in (
            ("GET", "/population"), ("POST", "/arena/promote"),
            ("GET", "/nope"))]
        return bad_prof, armed, ok, shed, text, js, trace, others

    bad_prof, armed, ok, shed, text, js, trace, others = _run(gw, go)
    assert _status(bad_prof) == 400
    assert _status(armed) == 200 and _body(armed) == {
        "armed": True, "steps": 1, "dir": prof_dir}
    assert _status(ok) == 200 and _status(shed) == 429
    assert _status(text) == 200
    assert "text/plain; version=0.0.4" in _header(text, "Content-Type")
    exposition = text.split("\r\n\r\n", 1)[1]
    assert "repro_serve_completed_total 1\n" in exposition
    assert "repro_serve_shed_deadline_total 1\n" in exposition
    assert "# TYPE repro_serve_ttft_seconds histogram" in exposition
    d = _body(js)
    assert d["completed"] == 1 and d["shed_deadline"] == 1
    assert set(d["phase_seconds"]) >= {"admit", "prefill", "decode"}
    rows = {}
    for ev in _body(trace)["traceEvents"]:
        if ev["ph"] in ("X", "i") and "rid" in ev["args"]:
            rows.setdefault(ev["args"]["rid"], []).append(ev["name"])
    assert rows["a"][0] == "enqueue" and rows["a"][-1] == "finish"
    assert rows["b"] == ["enqueue", "shed"]
    assert [_status(o) for o in others] == [404, 404, 404]
    assert "--arena" in _body(others[0])["error"]
    assert "--arena" in _body(others[1])["error"]
    tel = sched.telemetry
    assert tel.profiles_taken == 1 and tel.profile_error is None
    assert os.listdir(prof_dir) == ["profile_step1.json"]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_failed_driver_fails_open_and_later_requests(served):
    """``crash@2`` raises inside the driver's second step: the open
    request ends with the driver's error instead of waiting forever, and
    every later submit answers 500."""
    from repro_torch.serve.faults import FaultInjector
    from repro_torch.serve.gateway import Gateway

    cfg, _ = served
    sched = _sched(served, faults=FaultInjector("crash@2"))
    gw = Gateway(sched)

    async def go():
        first = await _http(gw.port, "POST", "/v1/generate",
                            {"rid": "a", "prompt": _prompt(cfg),
                             "max_new": 4, "stream": False})
        later = await _http(gw.port, "POST", "/v1/generate",
                            {"rid": "b", "prompt": _prompt(cfg),
                             "max_new": 4})
        return first, later

    first, later = _run(gw, go)
    assert "injected crash at step 2" in gw.driver_error
    assert "gateway driver failed" in _body(first)["error"]
    assert _status(later) == 500 and "InjectedFault" in later
    assert "a" not in sched.results


def test_stop_ends_a_stream_the_driver_left_unfinished(served):
    """``stop`` while a long request streams: the driver quits after its
    current step, the stream ends with an error record, and ``stop``
    returns instead of waiting on the open connection."""
    from repro_torch.serve.gateway import Gateway

    cfg, _ = served
    sched = _sched(served)
    gate = _Gate(sched)
    gw = Gateway(sched)

    async def go():
        await gw.start()
        r, w = await _open_stream(gw.port, {"rid": "long", "max_new": 40,
                                            "prompt": _prompt(cfg)})
        await gate.arrived_at(1)                  # admitted, held
        stopping = asyncio.ensure_future(gw.stop())
        await asyncio.sleep(0)                    # stop() sets its flags
        gate.open()                               # one step, then out
        await asyncio.wait_for(stopping, 120)
        resp = (await r.read()).decode()
        w.close()
        return resp

    resp = asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(go(), 300))
    assert "gateway stopped" in resp
    assert "long" not in sched.results and "long" in sched.active
    assert gw.draining and not gw._streams


def test_serve_cli_gateway_drains_on_sigterm(tmp_path):
    """``python -m repro_torch.launch.serve --gateway --port 0
    --journal J``: a request is served over HTTP; SIGTERM drains and
    exits 0, with a ``shutdown`` note in the journal."""
    from repro_torch.serve import journal as tjournal

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    journal = str(tmp_path / "j.jsonl")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--smoke", "--device", "cpu", "--gateway", "--port",
         "0", "--max-queue", "4", "--journal", journal, "--drain-grace",
         "5"], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port = None
        for line in proc.stdout:
            if line.startswith("[serve] gateway: http://"):
                port = int(line.split()[2].rsplit(":", 1)[1])
                assert "max_queue=4" in line
                break
        assert port is not None, proc.stderr.read()[-2000:]
        resp = asyncio.new_event_loop().run_until_complete(_http(
            port, "POST", "/v1/generate", {"rid": "c", "prompt": [1, 2, 3],
                                           "max_new": 4, "stream": False}))
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    assert _status(resp) == 200 and len(_body(resp)["tokens"]) == 4
    assert "[serve] SIGTERM: draining (grace=5.0s, journal=on)" in out
    assert "[serve] requests: submitted=1 completed=1" in out
    assert tjournal.last_note(journal) == {"t": "note", "kind": "shutdown",
                                           "drained": True}
    assert tjournal.replay(journal)["c"].done
