"""Serving launcher of the port (``python -m repro.launch.serve``): an LM
trace through the scheduler, or the CycleGAN surrogate's queries.

Two workloads, on the CUDA card unless ``--device cpu`` is given:

* ``lm``: a mixed-length request trace (prompts from the synthetic token
  stream) through the continuous-batching scheduler, over the paged KV
  pool or, with ``--layout dense``, over dense slot rows (``--pin-prefix``
  keeps registered prompt pages resident on the paged pool);
* ``surrogate`` (the default for ``--arch icf-cyclegan``): ``--queries``
  batches of ``--query-batch`` JAG input rows through the micro-batching
  :class:`~repro_torch.serve.surrogate.SurrogateEngine`, in f32.

Weights are random, drawn from ``--seed``, unless ``--ckpt-dir`` names an
LTFB population directory: then the tournament's winner is exported (if
it is not yet) and served, and with ``--watch-every N`` the server polls
for newer winners every N steps and hot-swaps them in (``--swap-mode
drain`` lets in-flight LM requests finish on the old weights first).
``--draft-ckpt`` adds population speculative decoding: a checkpoint file
or a population directory (its earliest step's winner by default) drafts
``--spec-tokens`` tokens a round (4 when a drafter is given without it)
that the served model verifies, with the same output as serving alone;
``--draft-arch`` names a drafter of another arch with the same vocab.

Telemetry is on by default, as in JAX (``--no-telemetry`` drops the trace
spans and keeps the counters): ``--trace-out`` writes every request's
span chain as a Chrome trace, ``--profile-steps N`` records the first N
scheduler steps with ``torch.profiler`` into a Chrome trace under
``--profile-dir``, and ``--log-json`` adds a JSON record for the
``[serve]`` report, hot swaps, sheds, cancels and profiler windows.

With ``--gateway`` the trace is replaced by the HTTP front door
(:mod:`repro_torch.serve.gateway`) on ``--host:--port``: requests arrive
over ``POST /v1/generate``, admission is bounded by ``--max-queue`` (429
on overload), tokens stream back as NDJSON chunks, and SIGTERM drains
in-flight work for up to ``--drain-grace`` seconds before exiting.
``--journal`` appends every admitted request and every decoded token to
a write-ahead journal (:mod:`repro_torch.serve.journal`); after a crash,
or a SIGTERM restart of the gateway, the next generation passes
``--resume-journal`` and resumes every unfinished request
token-identically (``--out-json`` then holds the stitched full streams).
``--fault-spec`` arms the deterministic fault harness
(:mod:`repro_torch.serve.faults`) for crash drills.

``--arena POP`` serves an LTFB population as an online tournament
(:mod:`repro_torch.serve.arena`): every trainer of the newest population
step is resident on the card, the one with the most recorded wins serves,
the challengers draft for it in turn (``--arena-policy``), their
speculative accept rates score the matches, and a challenger that beats
the champion's rate by ``--arena-margin`` over ``--arena-hysteresis``
matches is archived, journaled and hot-swapped in.  It replaces both
``--ckpt-dir`` and ``--draft-ckpt`` and implies ``--spec-tokens 4``;
``--arena-writeback`` writes the served streams back as token shards,
and ``--resume-journal`` restores the arena's state from the journal.

``--mesh DATA,MODEL`` serves through the serving mesh's scheduler
(:mod:`repro_torch.serve.mesh`): the slots and every page pool split into
DATA private shards on the one device, paged attention read once a
shard, every step's decisions round-tripping the step plan's wire format.
Several processes serve one mesh through
``python -m repro_torch.launch.distributed``.  ``--mesh DATA,MODEL`` with
MODEL > 1 cuts the weights over MODEL process ranks: the CLI then runs as
the ranks of a job (``torchrun --nproc-per-node N``, a card a rank over
nccl, or :func:`repro_torch.launch.mesh.spawn`), rank 0 serving the trace
and the others replaying its plans; alone it raises naming
``repro_torch.launch.distributed``.

  python -m repro_torch.launch.serve --arch qwen3-0.6b
  python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --device cpu
  python -m repro_torch.launch.serve --arch qwen3-0.6b --layout dense
  python -m repro_torch.launch.serve --arch icf-cyclegan --ckpt-dir POP
  python -m repro_torch.launch.serve --arch qwen3-0.6b --ckpt-dir POP \
      --watch-every 2 --swap-mode drain
  python -m repro_torch.launch.serve --arch qwen3-0.6b --ckpt-dir POP \
      --draft-ckpt POP --spec-tokens 3 --spec-adapt
  python -m repro_torch.launch.serve --arch qwen3-0.6b --gateway \
      --port 8000 --max-queue 32
  python -m repro_torch.launch.serve --arch qwen3-0.6b --journal J \
      --fault-spec kill@12; python -m repro_torch.launch.serve \
      --arch qwen3-0.6b --resume-journal J --out-json R
  python -m repro_torch.launch.serve --arch qwen3-0.6b --arena POP \
      --arena-policy shadow --arena-writeback WB --swap-mode drain
  python -m repro_torch.launch.serve --arch qwen3-0.6b --mesh 2,1
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np

from repro_torch import bridge, resolve_device
from repro_torch.configs.base import replace
from repro_torch.configs.icf_cyclegan import ARCH_ID as CYCLEGAN_ID
from repro_torch.configs.icf_cyclegan import FULL as CYCLEGAN_FULL
from repro_torch.configs.icf_cyclegan import SMOKE as CYCLEGAN_SMOKE
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.data import jag
from repro_torch.data.tokens import token_stream
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.icf_cyclegan import init_cyclegan
from repro_torch.models.lm import init_lm
from repro_torch.serve import journal as journal_mod
from repro_torch.serve.arena import Arena, ArenaConfig
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.mesh import MeshScheduler, parse_mesh
from repro_torch.serve.registry import (ModelRegistry, check_draft_compat,
                                        load_draft)
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.surrogate import SurrogateEngine
from repro_torch.serve.telemetry import enable_json_logs, write_trace
from repro_torch.train.steps import params_from_ckpt, tree_to


def parse_lens(spec: str) -> List[int]:
    """Parse a comma-separated prompt-length list ("8,16,24")."""
    return [int(x) for x in spec.split(",") if x]


def build_requests(cfg, requests: int, prompt_lens: List[int],
                   max_new: int, eos_id: Optional[int] = None,
                   temperature: float = 0.0, seed: int = 0
                   ) -> List[Request]:
    """Deterministic mixed-length trace: prompt lengths cycle through
    `prompt_lens`, token ids from the synthetic stream (the same trace
    ``repro.launch.serve.build_requests`` builds)."""
    lens = list(prompt_lens)
    stream = token_stream(sum(lens[i % len(lens)] for i in
                              range(requests)) + requests,
                          cfg.vocab_size, seed=seed)
    reqs, off = [], 0
    for i in range(requests):
        n = lens[i % len(lens)]
        reqs.append(Request(
            rid=i, prompt=np.asarray(stream[off:off + n], np.int32),
            max_new=max_new, eos_id=eos_id, temperature=temperature,
            seed=None if temperature <= 0 else seed + i))
        off += n
    return reqs


def make_registry(args, like_params, from_ckpt=None
                  ) -> Optional[ModelRegistry]:
    """The winner registry over ``--ckpt-dir`` (None without one), with
    ``auto_export`` on: a population step without a winner file gets one.
    ``like_params`` is a template in the checkpoint's layout,
    ``from_ckpt`` turns a restored tree into the served weights."""
    if not args.ckpt_dir:
        return None
    return ModelRegistry(args.ckpt_dir, like_params, auto_export=True,
                         from_ckpt=from_ckpt)


def _print_winner(registry: ModelRegistry) -> None:
    print(f"[serve] winner: step={registry.step} "
          f"trainer={registry.info.get('trainer')} "
          f"wins={registry.info.get('wins')}")


def load_drafter(args, cfg, device):
    """The drafter ``--draft-ckpt`` names, as an LM on ``device`` (None
    without the flag), and its config when ``--draft-arch`` differs from
    ``--arch`` (else None); prints the ``[serve] drafter:`` line."""
    if not args.draft_ckpt:
        return None, None
    draft_cfg = None
    dcfg = cfg
    if args.draft_arch and args.draft_arch != args.arch:
        # another arch: the vocab check comes before any restore
        draft_cfg = get_config(args.draft_arch, smoke=args.smoke)
        if args.dtype:
            draft_cfg = replace(draft_cfg, dtype=args.dtype)
        check_draft_compat(cfg, draft_cfg)
        dcfg = draft_cfg
    dmodel = init_lm(dcfg, seed=args.seed, device=device)
    dtype = dmodel.embed.weight.dtype
    params, info = load_draft(
        args.draft_ckpt, bridge.params_to_jax_layout(dmodel, dcfg),
        step=args.draft_step, expect_vocab=cfg.vocab_size,
        from_ckpt=lambda tree: params_from_ckpt(dcfg, tree, device, dtype))
    dmodel.load_state_dict(params)
    print(f"[serve] drafter: {args.draft_ckpt} arch={dcfg.name} "
          f"step={info.get('step')} trainer={info.get('trainer')} "
          f"spec_tokens={args.spec_tokens} fused={not args.no_spec_fused} "
          f"adapt={args.spec_adapt}")
    return dmodel, draft_cfg


def make_arena(args, cfg, model, device, rank: int = 0) -> Optional[Arena]:
    """The online arena ``--arena`` names (None without the flag), its
    members in the port's layout on ``device`` in ``model``'s dtype.
    With ``--resume-journal`` its state (champion, windows, generation)
    is restored from the journal before the scheduler is built, so the
    resumed server serves the journaled champion from its first step.
    ``rank``: this process's mesh rank (only rank 0 archives, writes back
    and appends to the genealogy)."""
    if not args.arena:
        return None
    acfg = ArenaConfig(policy=args.arena_policy,
                       window=args.arena_window,
                       min_samples=args.arena_min_samples,
                       margin=args.arena_margin,
                       hysteresis=args.arena_hysteresis,
                       check_every=args.arena_check_every,
                       seq_len=args.arena_seq)
    dtype = model.embed.weight.dtype
    arena = Arena.from_population(
        args.arena, bridge.params_to_jax_layout(model, cfg), acfg,
        writeback_dir=args.arena_writeback, vocab=cfg.vocab_size,
        rank=rank,
        from_ckpt=lambda tree: params_from_ckpt(cfg, tree, device, dtype),
        to_ckpt=lambda params: bridge.params_to_jax_layout(params, cfg))
    if args.resume_journal:
        state = journal_mod.replay_arena(args.resume_journal)
        if state:
            arena.restore(state)
            print(f"[serve] arena: restored from journal — champion="
                  f"{arena.champion} generation={arena.generation} "
                  f"promotions={arena.promotions}")
    print(f"[serve] arena: {args.arena} policy={acfg.policy} "
          f"members={len(arena.members)} champion={arena.champion} "
          f"drafter={arena.active_drafter} window={acfg.window} "
          f"margin={acfg.margin} min_samples={acfg.min_samples} "
          f"hysteresis={acfg.hysteresis} "
          f"writeback={args.arena_writeback}")
    return arena


def _maybe_write_trace(args, sched) -> None:
    """Export the Chrome-trace ring buffer if --trace-out was given."""
    if not args.trace_out:
        return
    tr = sched.telemetry.tracer
    write_trace(tr, args.trace_out)
    print(f"[serve] trace: {args.trace_out} events={len(tr.events)} "
          f"dropped={tr.dropped} (chrome://tracing / ui.perfetto.dev)")


def run_lm(args) -> Dict[str, object]:
    """Serve the trace the flags describe (from ``--ckpt-dir``'s winner
    when given, or ``--arena``'s population as an online tournament), or
    the gateway with ``--gateway``; returns stats, pool and results (and
    the arena's snapshot; all written with ``--out-json``).  With
    ``--resume-journal`` the journal's unfinished requests are requeued
    first and the results are the stitched full streams."""
    if args.arena and (args.ckpt_dir or args.draft_ckpt):
        raise SystemExit(
            "--arena replaces both --ckpt-dir (promotions ARE the hot "
            "swap) and --draft-ckpt (challengers ARE the drafters); "
            "drop those flags")
    device = resolve_device(args.device)
    rank, world = 0, 1
    if args.mesh and mesh_lib.launched() and mesh_lib.world_env() > 1:
        # a rank of a job (torchrun or the spawner): the model axis spans
        # the ranks; rank 0 serves, the others replay its plans
        if args.gateway:
            raise SystemExit("--gateway serves from one process; a "
                             "multi-rank mesh serves the request trace")
        ranks = mesh_lib.init_ranks(None, args.device)
        rank, world, device = ranks.rank, ranks.world, ranks.device
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.dtype:
        cfg = replace(cfg, dtype=args.dtype)
    if args.num_layers:
        cfg = replace(cfg, num_layers=args.num_layers)
    model = init_lm(cfg, seed=args.seed, device=device)
    dtype = model.embed.weight.dtype
    registry = make_registry(
        args, bridge.params_to_jax_layout(model, cfg) if args.ckpt_dir
        else None, from_ckpt=lambda tree: params_from_ckpt(
            cfg, tree, device, dtype))
    if registry is not None:
        model.load_state_dict(registry.load())
        _print_winner(registry)
    draft_model, draft_cfg = load_drafter(args, cfg, device)
    arena = make_arena(args, cfg, model, device)
    if arena is not None:
        # the scheduler loads the champion and the active challenger
        # into these two models
        draft_model = init_lm(cfg, seed=args.seed, device=device)
    journal = None
    if args.journal and rank == 0:      # host 0 journals a mesh's requests
        journal = journal_mod.RequestJournal(args.journal)
        print(f"[serve] journal: {args.journal} (write-ahead, fsync "
              f"per step)")
    faults = None
    if args.fault_spec:
        faults = FaultInjector(args.fault_spec, rank=rank)
        print(f"[serve] fault harness armed: {args.fault_spec}")
    max_len = args.max_len or max(parse_lens(args.prompt_lens)) \
        + args.max_new
    mesh_kw = {}
    if args.mesh:
        mesh_kw = dict(mesh_shape=parse_mesh(args.mesh))
    sched = (MeshScheduler if args.mesh else Scheduler)(
        cfg, model, num_slots=args.slots, max_len=max_len,
        block_size=args.block_size, num_blocks=args.num_blocks,
        max_seq=args.max_seq, layout=args.layout, policy=args.policy,
        prefill_chunk=args.prefill_chunk,
        prefix_sharing=not args.no_prefix_sharing,
        pin_prefix=args.pin_prefix,
        max_prefills_per_step=args.prefill_per_step, registry=registry,
        watch_every=args.watch_every, swap_mode=args.swap_mode,
        draft_params=draft_model, spec_tokens=args.spec_tokens,
        draft_cfg=draft_cfg, spec_fused=not args.no_spec_fused,
        spec_adapt=args.spec_adapt, max_queue=args.max_queue,
        telemetry=not args.no_telemetry, journal=journal, faults=faults,
        arena=arena, device=device, **mesh_kw)
    if args.mesh:
        data, mdl = mesh_kw["mesh_shape"]
        print(f"[serve] mesh: data={data} model={mdl} "
              f"devices={data * mdl} slots={sched.pool.num_slots} "
              f"(host-0 scheduler, per-shard page pools)")
    if args.profile_steps > 0:
        sched.profile_steps(args.profile_steps, args.profile_dir)
        print(f"[serve] profiler armed: steps={args.profile_steps} "
              f"dir={args.profile_dir}")
    prefixes: Dict = {}
    entries = None
    if args.resume_journal:
        entries = journal_mod.replay(args.resume_journal)
        prefixes = journal_mod.resume_scheduler(sched, entries)
        print(f"[serve] journal: replayed {len(entries)} request(s) from "
              f"{args.resume_journal} (requeued "
              f"{sched.stats.journal_replayed} unfinished)")
    if rank > 0:
        results = sched.run_follower()
        print(f"[serve] rank={rank}/{world} replayed rank 0's plans: "
              f"{len(results)} results")
        return {"stats": sched.stats.as_dict(), "results": results,
                "device": str(device)}
    if args.gateway:
        out = run_gateway(args, sched, journal_entries=entries)
        _maybe_write_trace(args, sched)
        if arena is not None:
            arena.report()
            arena.close()
            out["arena"] = arena.snapshot()
        if journal is not None:
            journal.close()
        return out
    reqs = build_requests(cfg, args.requests, parse_lens(args.prompt_lens),
                          args.max_new, eos_id=args.eos_id,
                          temperature=args.temperature, seed=args.seed)
    print(f"[serve] arch={cfg.name} dtype={cfg.dtype} device={device} "
          f"layout={args.layout} "
          f"policy={args.policy} slots={args.slots} max_len={max_len} "
          f"max_seq={sched.max_seq} block_size={args.block_size} "
          f"prefill_chunk={args.prefill_chunk} "
          f"swap_mode={args.swap_mode} requests={len(reqs)} "
          f"max_new={args.max_new} spec_tokens={sched.spec_tokens}")
    for r in reqs:
        if entries is not None and r.rid in entries:
            continue                # the journal already owns this rid
        try:
            sched.submit(r)
        except ValueError as e:     # counted in the rejected stat
            print(f"[serve] rejected request {r.rid}: {e}")
    results = sched.run()
    if world > 1:
        sched.shutdown()
    if prefixes:
        results = journal_mod.stitched_results(results, prefixes)
    sched.stats.report()
    pd = sched.pool.as_dict()
    print(f"[serve] pool: slots={pd['num_slots']} "
          f"blocks_used_high_water={pd['high_water_blocks']}/"
          f"{pd['num_blocks']} block_allocs={pd['block_allocs']} "
          f"block_frees={pd['block_frees']}")
    if args.layout == "paged":
        print(f"[serve] prefix-cache: hits={pd['prefix_hits']} "
              f"shared_tokens={pd['prefix_shared_tokens']} "
              f"pinned={pd['pinned_blocks']} "
              f"prefill_chunks={sched.stats.prefill_chunks}")
    if args.spec_adapt and sched.spec_k_by_rid:
        ks = sched.spec_k_by_rid
        print(f"[serve] spec-adapt per-row K (final): "
              f"{ {r: ks[r] for r in sorted(ks, key=str)} } "
              f"k_mean={sched.stats.as_dict()['spec_k_mean']:.2f}")
    if registry is not None:
        print(f"[serve] registry: serving_step={registry.step} "
              f"hot_swaps={sched.stats.hot_swaps}")
    if arena is not None:
        arena.report()
        arena.close()
    if args.profile_steps > 0:
        tel = sched.telemetry
        print(f"[serve] profile: taken={tel.profiles_taken} "
              f"files={tel.profile_files} error={tel.profile_error}")
    _maybe_write_trace(args, sched)
    if journal is not None:
        journal.close()
    out = {"stats": sched.stats.as_dict(), "pool": pd,
           "device": str(device), "results": results,
           "registry_step": registry.step if registry else None}
    if arena is not None:
        out["arena"] = arena.snapshot()
    if args.out_json:
        payload = {"stats": out["stats"], "pool": pd, "device": str(device),
                   "results": {str(k): [int(t) for t in v]
                               for k, v in results.items()}}
        if arena is not None:
            payload["arena"] = out["arena"]
        with open(args.out_json, "w") as f:
            json.dump(payload, f)
        print(f"[serve] wrote {args.out_json}")
    return out


def run_gateway(args, sched, journal_entries=None) -> Dict[str, object]:
    """Serve HTTP on ``--host:--port`` until interrupted.

    Ctrl-C prints the ``[serve]`` report and returns.  SIGTERM drains:
    admission stops (:meth:`Gateway.begin_drain`), in-flight requests get
    up to ``--drain-grace`` seconds to finish, a ``shutdown`` note goes
    into the journal, and the call returns (the next generation resumes
    with ``--resume-journal``).  A replayed journal seeds the gateway's
    Idempotency-Key map."""
    import asyncio

    from repro_torch.serve.gateway import Gateway

    gw = Gateway(sched, host=args.host, port=args.port,
                 stream_buffer=args.stream_buffer)
    if journal_entries:
        gw.seed_idempotency(journal_mod.idempotency_map(journal_entries))

    async def _serve():
        await gw.start()
        print(f"[serve] gateway: http://{gw.host}:{gw.port} "
              f"max_queue={sched.max_queue} "
              f"stream_buffer={gw.stream_buffer} "
              f"(POST /v1/generate, GET /healthz, GET /readyz, "
              f"GET /metrics, GET /debug/trace, POST /debug/profile)",
              flush=True)
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()

        def _on_sigterm():
            print(f"[serve] SIGTERM: draining "
                  f"(grace={args.drain_grace:.1f}s, journal="
                  f"{'on' if sched.journal is not None else 'off'})",
                  flush=True)
            gw.begin_drain()
            stop.set()

        try:
            loop.add_signal_handler(signal.SIGTERM, _on_sigterm)
        except (NotImplementedError, ValueError, RuntimeError):
            pass                      # not the main thread
        await stop.wait()
        # with a journal the queue is already durable; either way give
        # in-flight requests up to --drain-grace to finish streaming
        deadline = loop.time() + args.drain_grace
        while not gw.drained() and loop.time() < deadline:
            await asyncio.sleep(0.05)
        if sched.journal is not None:
            sched.journal.record_note("shutdown", drained=gw.drained())
        await gw.stop()

    try:
        asyncio.run(_serve())
    except KeyboardInterrupt:
        pass
    sched.stats.report()
    return {"stats": sched.stats.as_dict()}


def run_surrogate(args) -> Dict[str, object]:
    """Answer ``--queries`` batches of ``--query-batch`` JAG input rows
    through the surrogate engine (from ``--ckpt-dir``'s winner when
    given); returns stats, the serving step and the results."""
    device = resolve_device(args.device)
    ccfg = CYCLEGAN_SMOKE if args.smoke else CYCLEGAN_FULL
    params = init_cyclegan(ccfg, args.seed, device)
    registry = make_registry(
        args, bridge.cyclegan_params_to_jax_layout(params)
        if args.ckpt_dir else None,
        from_ckpt=lambda tree: tree_to(
            bridge.cyclegan_params_from_jax(tree), device))
    if registry is not None:
        params = registry.load()
        _print_winner(registry)
    eng = SurrogateEngine(ccfg, params, max_batch=args.slots * 16,
                          bucket=8, registry=registry,
                          watch_every=args.watch_every,
                          telemetry=not args.no_telemetry, device=device)
    print(f"[serve] arch={ccfg.name} workload=surrogate device={device} "
          f"queries={args.queries} query_batch={args.query_batch} "
          f"max_batch={eng.max_batch}")
    xs = jag.sample_inputs(args.queries * args.query_batch, args.seed)
    for i in range(args.queries):
        eng.submit(i, xs[i * args.query_batch:(i + 1) * args.query_batch])
    results = eng.run()
    eng.stats.report()
    mean = float(np.mean([r.mean() for r in results.values()]))
    print(f"[serve] surrogate: rows={args.queries * args.query_batch} "
          f"overlapped_stages={eng.overlapped_stages} "
          f"output_mean={mean:.6f}")
    if registry is not None:
        print(f"[serve] registry: serving_step={registry.step} "
              f"hot_swaps={eng.stats.hot_swaps}")
    _maybe_write_trace(args, eng)
    return {"stats": eng.stats.as_dict(),
            "registry_step": registry.step if registry else None,
            "results": results}


def build_parser() -> argparse.ArgumentParser:
    """The port's serve CLI argument parser."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="Continuous-batching LM serving and the CycleGAN "
                    "surrogate over tournament winners, on one CUDA card "
                    "(PyTorch port)")
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--workload", default=None,
                    choices=("lm", "surrogate"),
                    help="default: surrogate for icf-cyclegan, else lm")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="LTFB population checkpoint dir to serve the "
                         "tournament winner from")
    ap.add_argument("--watch-every", type=int, default=0,
                    help="poll for newer winners every N steps (0 = off)")
    ap.add_argument("--mesh", default=None,
                    help="serve over a serving mesh: 'DATA,MODEL' (e.g. "
                         "'4,1') or 'data=4,model=1' — the decode batch "
                         "and every page pool split into DATA private "
                         "shards on the one device, paged attention read "
                         "once a shard, admission decided on host 0 and "
                         "broadcast as a step plan (lm workload); MODEL "
                         "> 1 cuts the weights over MODEL process ranks "
                         "and runs only as ranks of a job (torchrun, or "
                         "repro_torch.launch.distributed)")
    ap.add_argument("--swap-mode", default="immediate",
                    choices=("immediate", "drain"),
                    help="hot-swap policy: immediate applies new weights "
                         "to in-flight requests; drain lets them finish "
                         "on the old weights first")
    ap.add_argument("--draft-ckpt", default=None,
                    help="drafter for speculative decoding: a .ckpt file, "
                         "or a population dir (its earliest step's "
                         "winner by default)")
    ap.add_argument("--draft-step", type=int, default=None,
                    help="population step to draft from (with a dir "
                         "--draft-ckpt; default: the earliest)")
    ap.add_argument("--draft-arch", default=None, choices=sorted(ARCHS),
                    help="the drafter's arch when it differs from --arch "
                         "(its vocab must equal the target's)")
    ap.add_argument("--spec-tokens", type=int, default=0,
                    help="draft tokens proposed a speculative round (0 = "
                         "off; 4 when --draft-ckpt is given); the output "
                         "equals serving without a drafter")
    ap.add_argument("--no-spec-fused", action="store_true",
                    help="draft with K+1 single steps a round instead of "
                         "one fused call")
    ap.add_argument("--spec-adapt", action="store_true",
                    help="adapt each row's speculative depth within "
                         "[1, --spec-tokens] from its accept history")
    # online LTFB arena (serve/arena.py: the live-traffic tournament)
    ap.add_argument("--arena", default=None,
                    help="serve an N-member population roster from this "
                         "LTFB checkpoint dir as an ONLINE tournament: "
                         "the champion serves, challengers draft "
                         "speculatively, accept rate scores matches, "
                         "and winners are hot-swapped in (replaces "
                         "--ckpt-dir and --draft-ckpt; lm workload)")
    ap.add_argument("--arena-policy", default="champion",
                    choices=("champion", "epsilon", "shadow"),
                    help="challenger routing: champion = best "
                         "challenger drafts (exploit); epsilon = mostly "
                         "best, periodically round-robin (explore/"
                         "exploit); shadow = round-robin every stint "
                         "(even sampling)")
    ap.add_argument("--arena-window", type=int, default=128,
                    help="sliding accept-rate window per member, in "
                         "speculative row-rounds (the match metric)")
    ap.add_argument("--arena-margin", type=float, default=0.02,
                    help="a challenger must beat the champion's "
                         "promotion-time accept rate by this margin to "
                         "win a match")
    ap.add_argument("--arena-min-samples", type=int, default=32,
                    help="proposals a challenger's window must hold "
                         "before it can qualify for promotion")
    ap.add_argument("--arena-hysteresis", type=int, default=2,
                    help="consecutive winning match evaluations before "
                         "a promotion fires")
    ap.add_argument("--arena-check-every", type=int, default=8,
                    help="scheduler steps between match evaluations")
    ap.add_argument("--arena-writeback", default=None,
                    help="write finished request/response streams back "
                         "as datastore token shards in this dir — the "
                         "next repro_torch.launch.ltfb round ingests "
                         "served traffic (train->serve->train)")
    ap.add_argument("--arena-seq", type=int, default=64,
                    help="write-back row width minus one: rows are "
                         "(seq+1) tokens, matching the ltfb launcher's "
                         "--seq so shards re-ingest directly")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where weights, KV pools and kernels run; cuda "
                         "raises when no card is visible")
    ap.add_argument("--dtype", default=None,
                    choices=("bfloat16", "float32"),
                    help="override the config's dtype")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the LM arch to its first N layers, at full "
                         "width: serves a population trained at that depth "
                         "(repro_torch.launch.ltfb --num-layers N)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=0,
                    help="default per-request cap + pool sizing unit "
                         "(0 = fit the trace)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV page size in tokens")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="page-pool size (default: slots*max_len worth)")
    ap.add_argument("--max-seq", type=int, default=None,
                    help="per-request length cap (paged layout; default "
                         "max_len)")
    ap.add_argument("--layout", default="paged",
                    choices=("paged", "dense"),
                    help="paged: scattered KV pages + the paged-attention "
                         "kernel; dense: contiguous slot rows of max_len "
                         "(the baseline)")
    ap.add_argument("--policy", default="continuous",
                    choices=("continuous", "static"))
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill prompts in N-token chunks interleaved "
                         "with decode (0 = one pow2-bucketed shot)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable copy-on-admit prompt prefix sharing")
    ap.add_argument("--pin-prefix", action="store_true",
                    help="keep registered prompt-prefix pages resident "
                         "across idle periods (paged layout; reclaimed "
                         "oldest-first under pool pressure)")
    ap.add_argument("--prefill-per-step", type=int, default=1)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-lens", default="8,16,24",
                    help="comma list; requests cycle through these")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--queries", type=int, default=16,
                    help="surrogate queries")
    ap.add_argument("--query-batch", type=int, default=8,
                    help="JAG input rows a surrogate query")
    ap.add_argument("--seed", type=int, default=0)
    # gateway (HTTP front door)
    ap.add_argument("--gateway", action="store_true",
                    help="serve HTTP (POST /v1/generate, GET /healthz, "
                         "GET /metrics) instead of the synthetic trace "
                         "(lm workload)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="gateway bind address")
    ap.add_argument("--port", type=int, default=8000,
                    help="gateway bind port (0 = ephemeral)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the request queue; submits beyond it "
                         "are shed with HTTP 429 (default: unbounded)")
    ap.add_argument("--stream-buffer", type=int, default=64,
                    help="per-response token buffer; a consumer that "
                         "falls further behind is cancelled "
                         "(backpressure)")
    # fault tolerance (journal / crash recovery / fault injection)
    ap.add_argument("--journal", default=None,
                    help="write-ahead request journal (JSONL): every "
                         "admitted request and decoded token, fsync'd "
                         "per scheduler step — a crashed or restarted "
                         "server resumes from it token-identically "
                         "(lm workload)")
    ap.add_argument("--resume-journal", default=None,
                    help="replay a previous generation's --journal on "
                         "startup: finished requests return their "
                         "recorded tokens, unfinished ones are "
                         "requeued and resume token-identically")
    ap.add_argument("--fault-spec", default=None,
                    help="deterministic fault injection: comma list of "
                         "kind@step[:key=val...], kinds kill|crash|"
                         "stall|corrupt|oom|disconnect (e.g. "
                         "'kill@12,stall@4:secs=0.2') — crash drills "
                         "for the journal/recovery path")
    ap.add_argument("--out-json", default=None,
                    help="write final stats + per-request token "
                         "streams as JSON (stitched across a "
                         "--resume-journal)")
    ap.add_argument("--drain-grace", type=float, default=5.0,
                    help="seconds SIGTERM waits for in-flight gateway "
                         "requests to finish before exiting (admission "
                         "stops immediately; the journal preserves "
                         "whatever does not finish)")
    # telemetry (tracing / profiler / JSON logs)
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable per-request trace spans and phase "
                         "spans (counters, histograms, phase times and "
                         "the profiler window stay on)")
    ap.add_argument("--trace-out", default=None,
                    help="write the per-request trace ring buffer as "
                         "Chrome-trace JSON on exit (open in "
                         "chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="record the first N scheduler steps with "
                         "torch.profiler (0 = off; lm workload)")
    ap.add_argument("--profile-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_profile"),
                    help="output dir of --profile-steps' Chrome trace")
    ap.add_argument("--log-json", action="store_true",
                    help="emit the [serve] report and lifecycle events "
                         "(shed, cancel, hot swap, profiler window) as "
                         "one-line JSON records on stdout too")
    return ap


def main(argv=None) -> int:
    """CLI entry point: parse args, pick the workload, run it."""
    args = build_parser().parse_args(argv)
    if args.log_json:
        enable_json_logs()
    if (args.draft_ckpt or args.arena) and args.spec_tokens <= 0:
        args.spec_tokens = 4            # a drafter implies speculation
    workload = args.workload or \
        ("surrogate" if args.arch == CYCLEGAN_ID else "lm")
    if workload == "surrogate":
        run_surrogate(args)
    else:
        if args.arch == CYCLEGAN_ID:
            raise SystemExit("lm workload needs an LM arch")
        run_lm(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
