"""Async serving gateway of the port: the HTTP front door over a scheduler.

The counterpart of ``repro.serve.gateway``: stdlib only (``asyncio`` and
hand-rolled HTTP/1.1, no framework).  One :class:`Gateway` owns one
:class:`repro_torch.serve.scheduler.Scheduler` and splits the work across
two execution domains:

* **event loop** (asyncio): accepts connections, parses requests, streams
  tokens out as NDJSON chunks; it touches no tensor;
* **driver thread**: the only thread that touches the scheduler, and so
  the only one that touches the card.  It makes the scheduler's device
  current in itself first (CUDA's current device is per thread), then
  drains the ingress queue into :meth:`Scheduler.submit`, applies cancels
  and the profiler window, sheds expired requests, runs
  :meth:`Scheduler.step`, and publishes each request's newly decoded
  tokens back into the loop via ``call_soon_threadsafe``.

SLO-aware admission lives at this boundary:

* ``max_queue`` (configured on the scheduler) bounds the request queue —
  an over-bound submit raises
  :class:`repro_torch.serve.scheduler.Overloaded`, which the gateway maps
  to **HTTP 429** with a ``Retry-After`` hint;
* requests may declare ``ttft_deadline_ms`` / ``tpot_deadline_ms``;
  queued requests whose TTFT deadline already passed are shed (429)
  instead of admitted late, and completed requests that missed a
  deadline increment the ``[serve]`` miss counters;
* each streaming response has a bounded token buffer (``stream_buffer``);
  a consumer too slow to drain it gets its request **cancelled**
  (backpressure) rather than buffering without bound, and a client that
  disconnects mid-stream has its request cancelled to free the slot.

Fault tolerance rides the same boundary.  :meth:`Gateway.begin_drain`
flips the gateway into a **draining** state (rolling restart step 1):
new ``/v1/generate`` submits get **503** with a ``Retry-After`` hint,
``/readyz`` answers 503 so load balancers stop routing here, and
in-flight requests run to completion (or get journaled for the next
generation — see :mod:`repro_torch.serve.journal`).  Clients may send an
``Idempotency-Key`` header: a retry with the same key replays the
finished result (``idempotent_replay``) or gets **409** while the
original is still in flight, instead of double-admitting.
:meth:`Gateway.seed_idempotency` preloads the key→rid map from a
replayed journal.  A driver thread that raises ends every open stream
with its error (before a first token, as the 429 of a shed) and answers
every later submit with **500**, and :meth:`Gateway.stop` ends the
streams a stopped driver left unfinished the same way, instead of
leaving clients (and ``stop`` itself) waiting.

Endpoints: ``POST /v1/generate`` (streaming NDJSON by default,
``"stream": false`` for a single JSON body), ``GET /healthz``
(liveness), ``GET /readyz`` (readiness: 503 until the warmup step ran and
the driver is up), ``GET /metrics`` (Prometheus text by default, the
:meth:`ServeStats.as_dict` JSON summary under ``Accept:
application/json``), ``GET /debug/trace`` (the Chrome-trace ring buffer),
``POST /debug/profile`` (arm ``torch.profiler`` around the next N
scheduler steps; one Chrome trace lands under ``dir``), ``GET
/population`` (the online arena's :meth:`Arena.snapshot`) and ``POST
/arena/promote`` (an admin override: ``{"member": name}`` promotes that
challenger at the next match evaluation, through the archive and the
drain-aware swap; 400 for an unknown member or the champion itself);
both arena routes answer 404 with no arena attached.  The debug and
arena endpoints route through a control queue the driver drains,
preserving the single-scheduler-caller invariant.
"""
from __future__ import annotations

import asyncio
import collections
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serve import telemetry as telemetry_mod
from repro_torch.serve.scheduler import Overloaded, Request, Scheduler
from repro_torch.serve.telemetry import log_event

# where POST /debug/profile writes its trace when the body names no dir
DEFAULT_PROFILE_DIR = os.path.join(tempfile.gettempdir(),
                                   "repro_torch_profile")
_NO_ARENA = {"error": "no arena attached (serve with --arena)"}


@dataclass
class _Stream:
    """Loop-side state of one in-flight request."""

    rid: Any
    q: asyncio.Queue                 # ("tok", t) / ("end",) / ("err", msg)
    sent: int = 0                    # tokens published so far (driver side)
    inflight: int = 0                # published - consumed (the bound;
    #                                  incremented by the driver BEFORE the
    #                                  loop callback runs, so it can't lag
    #                                  behind qsize the way qsize does)
    error: Optional[str] = None      # set on overflow/shed/cancel
    done: bool = False


@dataclass
class _Ingress:
    """One submit waiting to cross into the driver thread."""

    req: Request
    fut: asyncio.Future    # -> ("ok"|"overloaded"|"invalid"|"failed", msg)
    stream: Optional[_Stream] = None


class Gateway:
    """Asyncio HTTP/1.1 front door around one scheduler.

    ``stream_buffer`` bounds each response's unconsumed-token queue —
    overflow cancels the request (backpressure) instead of growing the
    buffer.  ``port=0`` binds an ephemeral port (read :attr:`port`
    after :meth:`start`).  The scheduler must be constructed by the
    caller (with ``max_queue`` for bounded admission); the gateway
    never touches it outside the driver thread.
    """

    def __init__(self, sched: Scheduler, host: str = "127.0.0.1",
                 port: int = 0, stream_buffer: int = 64,
                 idle_sleep_s: float = 0.002,
                 warmup: Optional[Callable[[], None]] = None):
        self.sched = sched
        self.host = host
        self.port = port
        self.stream_buffer = int(stream_buffer)
        self.idle_sleep_s = float(idle_sleep_s)
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._driver: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._ingress: collections.deque = collections.deque()
        self._cancels: collections.deque = collections.deque()
        # control ops from debug endpoints, drained by the driver (the
        # only scheduler caller): ("profile", steps, outdir)
        self._control: collections.deque = collections.deque()
        self._streams: Dict[Any, _Stream] = {}   # driver-owned tracking
        self._next_rid = 0
        # readiness: set by the driver AFTER the optional warmup
        # callable (weight load / first compile) completes — /readyz
        # answers 503 until then, so load balancers wait out cold start
        self._warmup = warmup
        self._ready = threading.Event()
        # rolling-restart drain: set by begin_drain(); new submits are
        # refused (503 + Retry-After) while in-flight work finishes
        self._draining = threading.Event()
        # Idempotency-Key -> rid of the admitted request (loop-owned;
        # seeded from a replayed journal across restarts)
        self._idem: Dict[str, Any] = {}
        # set when the driver thread raised: every open stream and every
        # later submit fails with it
        self.driver_error: Optional[str] = None

    # -- lifecycle (event loop side) ----------------------------------------
    async def start(self) -> None:
        """Bind the listener and start the scheduler driver thread."""
        self.loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._driver = threading.Thread(target=self._drive,
                                        name="gateway-driver", daemon=True)
        self._driver.start()

    async def stop(self) -> None:
        """Stop admitting, stop the driver thread, end what it left open
        (a stream gets an error record, or a 429 before its first token;
        a submit not yet taken a 500), close the listener.  Without the
        third step a stream the driver left unfinished would hold its
        connection, and ``wait_closed`` would wait for it forever."""
        self._draining.set()
        self._stop.set()
        if self._driver is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._driver.join)
        self._fail_open("gateway stopped")
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        """:meth:`start` then block until the server is closed."""
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # -- rolling restart ----------------------------------------------------
    def begin_drain(self) -> None:
        """Stop admitting new work (rolling-restart step 1).

        After this call new ``/v1/generate`` submits answer 503 with a
        ``Retry-After`` hint and ``/readyz`` flips to 503; in-flight
        requests keep streaming.  Thread-safe (signal handlers call it
        from the event loop, tests from anywhere)."""
        if not self._draining.is_set():
            self._draining.set()
            log_event("gateway_drain")

    @property
    def draining(self) -> bool:
        """Whether :meth:`begin_drain` has been called."""
        return self._draining.is_set()

    def drained(self) -> bool:
        """True once no queued/in-flight work remains (the drain is
        complete and the process can exit or hand off its journal)."""
        sched = self.sched
        return not (sched.queue or sched.active or sched.prefilling
                    or self._streams)

    def seed_idempotency(self, mapping: Dict[str, Any]) -> None:
        """Preload the Idempotency-Key map from a replayed journal.

        ``mapping`` is ``{key: (rid, done)}`` as produced by
        :func:`repro_torch.serve.journal.idempotency_map`; only the rid is
        kept — completion is re-checked against ``sched.results`` at
        lookup time.  Call before :meth:`start`."""
        for key, (rid, _done) in mapping.items():
            self._idem[key] = rid

    def _retry_after(self) -> str:
        """Load-aware Retry-After hint: roughly one second per queued
        batch the scheduler has to chew through first."""
        sched = self.sched
        return str(max(1, round(len(sched.queue)
                                / max(sched.stats.slots, 1))))

    # -- driver thread: the ONLY scheduler caller ---------------------------
    def _drive(self) -> None:
        """Run :meth:`_drive_loop`; if it raises, record the error, fail
        every open stream and waiting submit, and re-raise."""
        try:
            self._drive_loop()
        except BaseException as e:
            self.driver_error = f"{type(e).__name__}: {e}"
            log_event("gateway_driver_error", error=self.driver_error)
            self._fail_open(f"gateway driver failed: {self.driver_error}")
            raise

    def _fail_open(self, msg: str) -> None:
        """End every open stream and every submit still waiting for the
        driver with ``msg`` (called once the driver is gone)."""
        for rid in list(self._streams):
            self._post_error(rid, msg)
        with self._lock:
            pending = list(self._ingress)
            self._ingress.clear()
        for entry in pending:
            self._resolve(entry.fut, ("failed", msg))

    def _drive_loop(self) -> None:
        """Scheduler loop: drain ingress/cancels/control, shed, step,
        publish.  Makes the scheduler's device current in this thread,
        runs the warmup callable, then flips readiness."""
        sched = self.sched
        device = getattr(sched, "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)
        if self._warmup is not None:
            self._warmup()
        self._ready.set()
        log_event("gateway_ready", host=self.host, port=self.port)
        while not self._stop.is_set():
            busy = self._drain_ingress()
            while self._cancels:
                rid = self._cancels.popleft()
                sched.cancel(rid)
                busy = True
            while self._control:
                op = self._control.popleft()
                if op[0] == "profile":
                    sched.profile_steps(op[1], op[2])
                elif op[0] == "promote":
                    sched.arena_force(op[1])
                busy = True
            for rid in sched.shed_expired():
                self._post_error(rid, "shed: TTFT deadline expired "
                                      "before admission")
            if sched.queue or sched.active or sched.prefilling:
                sched.step()
                self._publish_progress()
                busy = True
            if not busy:
                time.sleep(self.idle_sleep_s)
        sched.stats.stop()

    def _drain_ingress(self) -> bool:
        """Submit queued ingress entries; resolve their futures."""
        busy = False
        while True:
            with self._lock:
                if not self._ingress:
                    return busy
                entry = self._ingress.popleft()
            busy = True
            try:
                self.sched.submit(entry.req)
            except Overloaded as e:
                self._resolve(entry.fut, ("overloaded", str(e)))
                continue
            except ValueError as e:
                self._resolve(entry.fut, ("invalid", str(e)))
                continue
            if entry.stream is not None:
                self._streams[entry.req.rid] = entry.stream
            self._resolve(entry.fut, ("ok", ""))

    def _publish_progress(self) -> None:
        """Diff scheduler state against each stream's published count
        and push the new tokens (then completion) into the loop."""
        sched = self.sched
        for rid, st in list(self._streams.items()):
            if rid in sched.results:
                toks = sched.results[rid]
                for t in toks[st.sent:]:
                    self._post(st, ("tok", int(t)))
                st.sent = len(toks)
                self._post(st, ("end",))
                del self._streams[rid]
                continue
            act = sched.active.get(rid) or sched.prefilling.get(rid)
            if act is not None:
                for t in act.tokens[st.sent:]:
                    self._post(st, ("tok", int(t)))
                st.sent = len(act.tokens)
            elif not any(q.rid == rid for q in sched.queue) \
                    and not any(a.req.rid == rid
                                for a in sched._pending_onepass):
                # vanished without a result: cancelled or shed
                self._post_error(rid, "request cancelled")

    def _post(self, st: _Stream, item: Tuple) -> None:
        """Publish one stream item into the event loop, enforcing the
        bounded buffer: overflow cancels the request (backpressure)."""
        if st.error is not None:
            return
        if st.inflight >= self.stream_buffer:
            st.error = (f"backpressure: consumer fell more than "
                        f"{self.stream_buffer} tokens behind; "
                        "request cancelled")
            log_event("backpressure", rid=st.rid,
                      buffer=self.stream_buffer)
            self._cancels.append(st.rid)
            self._streams.pop(st.rid, None)
            return
        st.inflight += 1
        assert self.loop is not None
        self.loop.call_soon_threadsafe(st.q.put_nowait, item)

    def _post_error(self, rid: Any, msg: str) -> None:
        """Terminate a stream with an error item (driver side)."""
        st = self._streams.pop(rid, None)
        if st is None or st.error is not None:
            return
        st.error = msg
        assert self.loop is not None
        self.loop.call_soon_threadsafe(st.q.put_nowait, ("err", msg))

    def _resolve(self, fut: asyncio.Future, value: Tuple[str, str]) -> None:
        """Resolve an ingress future from the driver thread."""
        assert self.loop is not None
        self.loop.call_soon_threadsafe(
            lambda: fut.done() or fut.set_result(value))

    # -- HTTP layer ---------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        """Parse one HTTP/1.1 request and dispatch it (no keep-alive)."""
        try:
            line = await reader.readline()
            parts = line.decode("latin1").split()
            if len(parts) < 2:
                return
            method, path = parts[0].upper(), parts[1]
            clen = 0
            accept = ""
            idem_key: Optional[str] = None
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                name, _, val = h.decode("latin1").partition(":")
                hname = name.strip().lower()
                if hname == "content-length":
                    clen = int(val.strip())
                elif hname == "accept":
                    accept = val.strip().lower()
                elif hname == "idempotency-key":
                    idem_key = val.strip()
            body = await reader.readexactly(clen) if clen else b""
            await self._route(method, path, body, accept, writer,
                              idem_key=idem_key)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, OSError):
                pass

    async def _route(self, method: str, path: str, body: bytes,
                     accept: str, writer: asyncio.StreamWriter,
                     idem_key: Optional[str] = None) -> None:
        """Dispatch to an endpoint handler."""
        sched = self.sched
        busy = len(sched.active) + len(sched.prefilling)
        if method == "GET" and path == "/healthz":
            # liveness: the process is up and parsing HTTP — readiness
            # is reported but does NOT change the status code
            await _respond(writer, 200, {
                "ok": True, "live": True,
                "ready": self._ready.is_set(),
                "slots": sched.stats.slots,
                "queued": len(sched.queue), "active": busy})
        elif method == "GET" and path == "/readyz":
            # readiness: 503 until weights are loaded / mesh is up
            # (the driver's warmup), and again once draining — load
            # balancers gate on this to stop routing during a rolling
            # restart
            ready = self._ready.is_set() and not self._draining.is_set()
            await _respond(
                writer, 200 if ready else 503, {
                    "ready": ready, "draining": self._draining.is_set(),
                    "slots": sched.stats.slots,
                    "queued": len(sched.queue), "slots_busy": busy},
                extra_headers=None if ready
                else [("Retry-After", self._retry_after())])
        elif method == "GET" and path == "/metrics":
            if "application/json" in accept:
                d = dict(sched.stats.as_dict())
                d["phase_seconds"] = dict(sched.telemetry.phase_seconds)
                await _respond(writer, 200, d)
            else:
                await _respond_text(
                    writer, 200, telemetry_mod.scheduler_prometheus(sched),
                    content_type="text/plain; version=0.0.4; "
                                 "charset=utf-8")
        elif method == "GET" and path == "/population":
            arena = getattr(sched, "arena", None)
            if arena is None:
                await _respond(writer, 404, _NO_ARENA)
            else:
                await _respond(writer, 200, arena.snapshot())
        elif method == "POST" and path == "/arena/promote":
            await self._arena_promote(body, writer)
        elif method == "GET" and path == "/debug/trace":
            await _respond(writer, 200, sched.telemetry.tracer.export())
        elif method == "POST" and path == "/debug/profile":
            await self._profile(body, writer)
        elif method == "POST" and path == "/v1/generate":
            await self._generate(body, writer, idem_key=idem_key)
        else:
            await _respond(writer, 404, {"error": f"no route "
                                                  f"{method} {path}"})

    async def _profile(self, body: bytes,
                       writer: asyncio.StreamWriter) -> None:
        """``POST /debug/profile``: arm ``torch.profiler`` around the
        next ``steps`` scheduler steps, one Chrome trace under ``dir``.
        The arm rides the control queue — the driver applies it, keeping
        the scheduler single-callered."""
        try:
            d = json.loads(body.decode() or "{}")
            steps = int(d.get("steps", 8))
            outdir = str(d.get("dir", DEFAULT_PROFILE_DIR))
            if steps < 1:
                raise ValueError("steps must be >= 1")
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            await _respond(writer, 400, {"error": f"bad request: {e}"})
            return
        self._control.append(("profile", steps, outdir))
        await _respond(writer, 200,
                       {"armed": True, "steps": steps, "dir": outdir})

    async def _arena_promote(self, body: bytes,
                             writer: asyncio.StreamWriter) -> None:
        """``POST /arena/promote``: the admin override -- the named
        challenger wins the next match evaluation (still through the
        transactional archive and the drain-aware swap).  The override
        rides the control queue, so the driver stays the scheduler's only
        caller."""
        arena = getattr(self.sched, "arena", None)
        if arena is None:
            await _respond(writer, 404, _NO_ARENA)
            return
        try:
            d = json.loads(body.decode() or "{}")
            member = d.get("member")
            if not isinstance(member, str) or member not in arena.members:
                raise ValueError(
                    f"unknown arena member {member!r}; roster is "
                    f"{sorted(arena.members)}")
            if member == arena.champion:
                raise ValueError(
                    f"{member!r} is already the champion")
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            await _respond(writer, 400, {"error": f"bad request: {e}"})
            return
        self._control.append(("promote", member))
        await _respond(writer, 200,
                       {"queued": True, "member": member,
                        "champion": arena.champion})

    async def _generate(self, body: bytes,
                        writer: asyncio.StreamWriter,
                        idem_key: Optional[str] = None) -> None:
        """``POST /v1/generate``: admit, then stream tokens (NDJSON
        chunks) or collect the full completion (``"stream": false``).

        While draining, answers 503 + ``Retry-After`` without
        admitting.  A repeated ``Idempotency-Key`` replays the finished
        result (200, ``idempotent_replay``) or answers 409 while the
        original request is still in flight.  After the driver thread
        failed, answers 500."""
        if self.driver_error is not None:
            await _respond(writer, 500, {"error": "gateway driver failed: "
                                                  f"{self.driver_error}"})
            return
        if self._draining.is_set():
            await _respond(
                writer, 503,
                {"error": "gateway is draining for restart; retry "
                          "against the next generation"},
                extra_headers=[("Retry-After", self._retry_after())])
            return
        try:
            d = json.loads(body.decode() or "{}")
            idem = idem_key or d.get("idempotency_key")
            known = self._idem.get(idem) if idem else None
            if known is not None:
                res = self.sched.results.get(known)
                if res is not None:
                    await _respond(writer, 200, {
                        "rid": known,
                        "tokens": [int(t) for t in res],
                        "idempotent_replay": True})
                else:
                    await _respond(
                        writer, 409,
                        {"error": "a request with this "
                                  "Idempotency-Key is still in flight",
                         "rid": known},
                        extra_headers=[("Retry-After",
                                        self._retry_after())])
                return
            prompt = np.asarray(d["prompt"], np.int32)
            req = Request(
                rid=d.get("rid", self._make_rid()), prompt=prompt,
                max_new=int(d.get("max_new", 16)),
                eos_id=d.get("eos_id"),
                temperature=float(d.get("temperature", 0.0)),
                seed=d.get("seed"),
                ttft_deadline_ms=d.get("ttft_deadline_ms"),
                tpot_deadline_ms=d.get("tpot_deadline_ms"),
                idem_key=idem)
        except (KeyError, ValueError, TypeError,
                json.JSONDecodeError) as e:
            await _respond(writer, 400, {"error": f"bad request: {e}"})
            return
        streaming = bool(d.get("stream", True))
        assert self.loop is not None
        st = _Stream(rid=req.rid,
                     q=asyncio.Queue(maxsize=self.stream_buffer + 2))
        entry = _Ingress(req=req, fut=self.loop.create_future(), stream=st)
        with self._lock:
            self._ingress.append(entry)
        status, msg = await entry.fut
        if status == "overloaded":
            await _respond(writer, 429, {"error": msg, "rid": req.rid},
                           extra_headers=[("Retry-After", "1")])
            return
        if status == "invalid":
            await _respond(writer, 400, {"error": msg, "rid": req.rid})
            return
        if status == "failed":
            await _respond(writer, 500, {"error": msg, "rid": req.rid})
            return
        if idem:
            self._idem[idem] = req.rid
        if streaming:
            await self._stream_out(req.rid, st, writer)
        else:
            await self._collect_out(req.rid, st, writer)

    async def _stream_out(self, rid: Any, st: _Stream,
                          writer: asyncio.StreamWriter) -> None:
        """Send tokens as they decode: chunked NDJSON, one object per
        token, a final ``done`` record, or an ``error`` record when the
        request was shed/cancelled after headers went out."""
        # headers wait for the FIRST item so a pre-admission shed can
        # still become a clean 429 instead of a broken 200
        item = await st.q.get()
        st.inflight -= 1
        if item[0] == "err" and st.sent == 0:
            await _respond(writer, 429, {"error": item[1], "rid": rid},
                           extra_headers=[("Retry-After", "1")])
            return
        writer.write(_stream_head(200))
        ntok = 0
        try:
            while True:
                kind = item[0]
                if kind == "tok":
                    ntok += 1
                    _chunk(writer, {"rid": rid, "token": item[1]})
                elif kind == "end":
                    _chunk(writer, {"rid": rid, "done": True,
                                    "ntok": ntok})
                    break
                else:
                    _chunk(writer, {"rid": rid, "error": item[1]})
                    break
                await writer.drain()
                item = await st.q.get()
                st.inflight -= 1
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            # client went away mid-stream: cancel to free the slot
            self._cancels.append(rid)

    async def _collect_out(self, rid: Any, st: _Stream,
                           writer: asyncio.StreamWriter) -> None:
        """Non-streaming mode: wait for completion, answer once."""
        tokens: List[int] = []
        while True:
            item = await st.q.get()
            st.inflight -= 1
            if item[0] == "tok":
                tokens.append(item[1])
            elif item[0] == "end":
                await _respond(writer, 200, {"rid": rid,
                                             "tokens": tokens})
                return
            else:
                await _respond(writer, 429,
                               {"error": item[1], "rid": rid,
                                "tokens": tokens},
                               extra_headers=[("Retry-After", "1")])
                return

    def _make_rid(self) -> str:
        """Allocate a gateway-unique request id."""
        self._next_rid += 1
        return f"g{self._next_rid}"


# -- wire helpers -----------------------------------------------------------

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            409: "Conflict", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable"}


async def _respond(writer: asyncio.StreamWriter, code: int, obj: Dict,
                   extra_headers: Optional[List[Tuple[str, str]]] = None
                   ) -> None:
    """Write one complete JSON response and flush it."""
    payload = json.dumps(obj).encode()
    head = [f"HTTP/1.1 {code} {_REASONS.get(code, '')}",
            "Content-Type: application/json",
            f"Content-Length: {len(payload)}",
            "Connection: close"]
    head += [f"{k}: {v}" for k, v in (extra_headers or [])]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + payload)
    await writer.drain()


async def _respond_text(writer: asyncio.StreamWriter, code: int,
                        text: str,
                        content_type: str = "text/plain; charset=utf-8"
                        ) -> None:
    """Write one complete plain-text response (Prometheus scrapes)."""
    payload = text.encode()
    head = [f"HTTP/1.1 {code} {_REASONS.get(code, '')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(payload)}",
            "Connection: close"]
    writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + payload)
    await writer.drain()


def _stream_head(code: int) -> bytes:
    """Response head for a chunked NDJSON token stream."""
    return (f"HTTP/1.1 {code} {_REASONS.get(code, '')}\r\n"
            "Content-Type: application/x-ndjson\r\n"
            "Transfer-Encoding: chunked\r\n"
            "Connection: close\r\n\r\n").encode()


def _chunk(writer: asyncio.StreamWriter, obj: Dict) -> None:
    """Write one NDJSON record as an HTTP chunk (no flush)."""
    b = json.dumps(obj).encode() + b"\n"
    writer.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")
