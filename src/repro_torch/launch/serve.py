"""Serving launcher of the port: a synthetic LM trace through the scheduler.

The counterpart of ``python -m repro.launch.serve`` for the lm workload:
a mixed-length request trace (prompts from the synthetic token stream)
through the continuous-batching paged scheduler, on the CUDA card unless
``--device cpu`` is given.  Weights are random, drawn from ``--seed``.

  python -m repro_torch.launch.serve --arch qwen3-0.6b
  python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import replace
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.data.tokens import token_stream
from repro_torch.models.lm import init_lm
from repro_torch.serve.scheduler import Request, Scheduler


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


def run_lm(args) -> Dict[str, object]:
    """Serve the trace the flags describe; returns stats, pool and
    results (and writes them with ``--out-json``)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.dtype:
        cfg = replace(cfg, dtype=args.dtype)
    model = init_lm(cfg, seed=args.seed, device=device)
    max_len = args.max_len or max(parse_lens(args.prompt_lens)) \
        + args.max_new
    sched = Scheduler(
        cfg, model, num_slots=args.slots, max_len=max_len,
        block_size=args.block_size, num_blocks=args.num_blocks,
        max_seq=args.max_seq, policy=args.policy,
        prefill_chunk=args.prefill_chunk,
        prefix_sharing=not args.no_prefix_sharing,
        max_prefills_per_step=args.prefill_per_step, device=device)
    reqs = build_requests(cfg, args.requests, parse_lens(args.prompt_lens),
                          args.max_new, eos_id=args.eos_id,
                          temperature=args.temperature, seed=args.seed)
    print(f"[serve] arch={cfg.name} dtype={cfg.dtype} device={device} "
          f"policy={args.policy} slots={args.slots} max_len={max_len} "
          f"max_seq={sched.max_seq} block_size={args.block_size} "
          f"prefill_chunk={args.prefill_chunk} requests={len(reqs)} "
          f"max_new={args.max_new}")
    for r in reqs:
        try:
            sched.submit(r)
        except ValueError as e:     # counted in the rejected stat
            print(f"[serve] rejected request {r.rid}: {e}")
    results = sched.run()
    sched.stats.report()
    pd = sched.pool.as_dict()
    print(f"[serve] pool: slots={pd['num_slots']} "
          f"blocks_used_high_water={pd['high_water_blocks']}/"
          f"{pd['num_blocks']} block_allocs={pd['block_allocs']} "
          f"block_frees={pd['block_frees']}")
    print(f"[serve] prefix-cache: hits={pd['prefix_hits']} "
          f"shared_tokens={pd['prefix_shared_tokens']} "
          f"prefill_chunks={sched.stats.prefill_chunks}")
    out = {"stats": sched.stats.as_dict(), "pool": pd,
           "device": str(device), "results": results}
    if args.out_json:
        payload = {"stats": out["stats"], "pool": pd, "device": str(device),
                   "results": {str(k): [int(t) for t in v]
                               for k, v in results.items()}}
        with open(args.out_json, "w") as f:
            json.dump(payload, f)
        print(f"[serve] wrote {args.out_json}")
    return out


def build_parser() -> argparse.ArgumentParser:
    """The port's serve CLI argument parser."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="Continuous-batching LM serving on one CUDA card "
                    "(PyTorch port)")
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where weights, KV pools and kernels run; cuda "
                         "raises when no card is visible")
    ap.add_argument("--dtype", default=None,
                    choices=("bfloat16", "float32"),
                    help="override the config's dtype")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=0,
                    help="default per-request cap + pool sizing unit "
                         "(0 = fit the trace)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV page size in tokens")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="page-pool size (default: slots*max_len worth)")
    ap.add_argument("--max-seq", type=int, default=None,
                    help="per-request length cap (default max_len)")
    ap.add_argument("--policy", default="continuous",
                    choices=("continuous", "static"))
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill prompts in N-token chunks interleaved "
                         "with decode (0 = one pow2-bucketed shot)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable copy-on-admit prompt prefix sharing")
    ap.add_argument("--prefill-per-step", type=int, default=1)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-lens", default="8,16,24",
                    help="comma list; requests cycle through these")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-json", default=None,
                    help="write final stats + per-request token streams "
                         "as JSON")
    return ap


def main(argv=None) -> int:
    """CLI entry point."""
    run_lm(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
