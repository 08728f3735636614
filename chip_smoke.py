#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (a failing run exits non-zero
and never prints the final ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the build: both kernels from a cold ``build/repro_torch`` (nvcc for
   the CUDA C++ paged attention, Triton's JIT for RMSNorm), in parallel;
3. each kernel against its plain PyTorch version on the card at the
   serving shapes (decode rows; a free slot's idle row in a pow2-wide
   table; the widest one-shot prefill's norm rows) within f32 2e-5,
   bf16 2e-2, with its time (CUDA events,
   median of 30 after warm-up, L2 flushed before each launch), the plain
   version's time, one PyTorch library call's time and the bound;
4. serve: qwen3-0.6b at full width in bf16 (random weights from a seed)
   through the continuous-batching paged scheduler: 16 requests, 8
   slots, prompts 128/256/512, 64 new tokens each, greedy; every logit
   row must be finite and both kernels' launch counters must match the
   decode and prefill steps taken;
5. an f32 recompute at full width: 2 served requests re-run through the
   dense causal forward (no pages, no paged kernel) must pick the served
   token at every generated position, save top-2 ties within 1e-4;
6. a ``kernels`` line, the ``nvidia-smi`` line, and the ``ok`` line.

Needs one CUDA card, the CUDA toolkit (``nvcc``) and ``triton``; exits 1
without a card and 2 when run outside a checkout of the repo.
"""
import json
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet: HBM3 rate and dense peak rates (the paged
# kernel and the plain versions compute in f32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
REPLACES = {"paged_attention": "src/repro/kernels/paged_attention.py:106",
            "rmsnorm": "src/repro/kernels/rmsnorm.py:25"}
SOURCES = {"paged_attention": "src/repro_torch/csrc/paged_attention.cu",
           "rmsnorm": "src/repro_torch/kernels/rmsnorm.py"}
ROUTES = {"paged_attention": "cuda", "rmsnorm": "triton"}


def emit(obj) -> None:
    """Print one JSON line."""
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    """Raise unless ``cond``: every phase's checks go through here."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


class Timer:
    """Median device time of a callable (CUDA events), L2 flushed first.

    The device is held in a spin kernel while the host enqueues every
    timed launch, so the events bracket device work only: the host's
    launch overhead (large for Triton's launcher) is not counted.
    """

    def __init__(self, torch, reps: int = 30, warmup: int = 5):
        self.torch = torch
        self.reps, self.warmup = reps, warmup
        # larger than the H100's 50 MB L2: every timed launch reads cold
        self._flush = torch.empty(96 << 20, dtype=torch.uint8,
                                  device="cuda")

    def ms(self, fn) -> float:
        """Median milliseconds of ``fn()`` over ``reps`` launches."""
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(self.reps)]
        torch.cuda._sleep(200_000_000)        # ~0.1 s: covers the enqueue
        for start, end in events:
            self._flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(bytes_moved: float, ops: float, dtype: str):
    """Least time the card could take: (ms, 'bytes' | 'operations')."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": line,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "torch_cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return line


def phase_build(torch):
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rn

    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)    # cold build

    def nvcc():
        t0 = time.perf_counter()
        log = build.build_library(["-Xptxas", "-v"])
        build.load_library()
        return time.perf_counter() - t0, log

    def triton():
        t0 = time.perf_counter()
        for d in (1024, 128):                  # one compile per BLOCK
            x = torch.ones((2, d), device="cuda", dtype=torch.bfloat16)
            rn.rmsnorm(x, torch.ones(d, device="cuda"))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        f_nvcc, f_triton = pool.submit(nvcc), pool.submit(triton)
        nvcc_s, log = f_nvcc.result()
        triton_s = f_triton.result()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "paged_attention_nvcc_s": round(nvcc_s, 3),
          "rmsnorm_triton_s": round(triton_s, 3), "ptxas": ptxas})


def _paged_inputs(torch, gen, B, H, Hkv, D, bs, K, dtype, lengths, W=None):
    """Random q and pools, scattered tables with null-page tails.  ``W``
    widens the tables past the longest reach (the scheduler's pow2 width
    bucket); a row of length 1 is idle, as the scheduler passes a free
    slot: its table holds the null page only."""
    W = W or -(-(int(max(lengths)) + K - 1) // bs)
    P = B * W                                   # pages; page P is null
    dt = getattr(torch, dtype)
    q = torch.randn((B, K, H, D), generator=gen, device="cuda").to(dt)
    kp = torch.randn((P + 1, bs, Hkv, D), generator=gen,
                     device="cuda").to(dt)
    vp = torch.randn((P + 1, bs, Hkv, D), generator=gen,
                     device="cuda").to(dt)
    perm = torch.randperm(P, generator=gen, device="cuda").to(torch.int32)
    tables = perm.reshape(B, W).clone()
    for b, n in enumerate(lengths):
        used = -(-(int(n) + K - 1) // bs)
        tables[b, used:] = P                    # null-page tail
        if n == 1:
            tables[b] = P                       # idle row
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables.contiguous(), lens


def _sdpa_call(torch, q, kp, vp, tables, lengths):
    """One SDPA call over pages gathered beforehand: the library yardstick
    (the gather itself is not timed)."""
    import torch.nn.functional as F

    B, K, H, D = q.shape
    _, bs, Hkv, _ = kp.shape
    t = tables.long()
    k = kp[t].reshape(B, -1, Hkv, D).transpose(1, 2)
    v = vp[t].reshape(B, -1, Hkv, D).transpose(1, 2)
    k = k.repeat_interleave(H // Hkv, dim=1).contiguous()
    v = v.repeat_interleave(H // Hkv, dim=1).contiguous()
    qh = q.transpose(1, 2).contiguous()         # (B, H, K, D)
    pos = torch.arange(k.shape[2], device=q.device)
    reach = lengths.long()[:, None] + torch.arange(K, device=q.device)
    mask = (pos[None, None, :] < reach[..., None])[:, None]  # (B,1,K,S)
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def phase_kernels(torch, timer):
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng_lengths = torch.randint(100, 601, (8,), generator=gen,
                                device="cuda").tolist()
    # the serve phase's decode step: its widths are pow2 buckets capped at
    # 36 pages (32 for up to 512 tokens), free slots are idle rows
    bucket_lengths = [min(n, 500) for n in rng_lengths[:-1]] + [1]
    results = {"paged_attention": [], "rmsnorm": []}
    cases = [(D, K, dt, rng_lengths, None) for dt in ("bfloat16", "float32")
             for K in (1, 5) for D in (128,)]
    cases += [(64, 1, "bfloat16", rng_lengths, None)]
    cases += [(128, 1, dt, bucket_lengths, 32)
              for dt in ("bfloat16", "float32")]
    for D, K, dtype, case_lengths, width in cases:
        B, H, Hkv, bs = 8, 16, 8, 16
        args = _paged_inputs(torch, gen, B, H, Hkv, D, bs, K, dtype,
                             case_lengths, W=width)
        q, kp, vp, tables, lengths = args
        got = pa.paged_attention(*args)
        want = ref.paged_attention_ref(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = TOL[dtype]
        check(bool((err <= tol + tol * want.float().abs()).all()),
              f"paged_attention {dtype} D={D} K={K}: max |err| "
              f"{err.max().item()} over tolerance {tol}")
        lib_fn = _sdpa_call(torch, *args)
        lib_err = (lib_fn().transpose(1, 2).float() - want.float()).abs()
        esize = q.element_size()
        reach = sum(int(n) + K - 1 for n in case_lengths)
        moved = 2 * q.numel() * esize + 2 * reach * Hkv * D * esize \
            + tables.numel() * 4 + lengths.numel() * 4
        ops = sum((int(n) + t) * H * D * 4 for n in case_lengths
                  for t in range(K))
        b_ms, b_by = bound(moved, ops, dtype)
        case = {"kernel": "paged_attention", "dtype": dtype, "B": B, "H": H,
                "Hkv": Hkv, "D": D, "bs": bs, "K": K, "W": tables.shape[1],
                "lengths": case_lengths, "max_abs_err": err.max().item(),
                "tol": tol, "library_max_abs_err": lib_err.max().item(),
                "kernel_ms": timer.ms(lambda: pa.paged_attention(*args)),
                "plain_ms": timer.ms(
                    lambda: ref.paged_attention_ref(*args)),
                "library_ms": timer.ms(lib_fn), "bound_ms": b_ms,
                "bound_by": b_by, "bytes": moved}
        emit(case)
        results["paged_attention"].append(case)

    # decode rows (ln1/ln2/final, q-norm, k-norm) in both dtypes, and the
    # serve phase's widest one-shot prefill (a 512-token bucket) in bf16
    rms_shapes = [((8, 1024), dt) for dt in ("bfloat16", "float32")]
    rms_shapes += [((8, 16, 128), dt) for dt in ("bfloat16", "float32")]
    rms_shapes += [((8, 8, 128), dt) for dt in ("bfloat16", "float32")]
    rms_shapes += [((512, 1024), "bfloat16"), ((512, 16, 128), "bfloat16"),
                   ((512, 8, 128), "bfloat16")]
    for shape, dtype in rms_shapes:
        dt = getattr(torch, dtype)
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        s = torch.randn(shape[-1], generator=gen, device="cuda").to(dt)
        got = rn.rmsnorm(x, s, 1e-6)
        want = ref.rmsnorm_ref(x, s, 1e-6)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = TOL[dtype]
        check(bool((err <= tol + tol * want.float().abs()).all()),
              f"rmsnorm {dtype} {shape}: max |err| {err.max().item()} "
              f"over tolerance {tol}")
        moved = 2 * x.numel() * x.element_size() + s.numel() * s.element_size()
        b_ms, b_by = bound(moved, 4 * x.numel(), dtype)
        case = {"kernel": "rmsnorm", "dtype": dtype, "shape": list(shape),
                "max_abs_err": err.max().item(), "tol": tol,
                "kernel_ms": timer.ms(lambda: rn.rmsnorm(x, s, 1e-6)),
                "plain_ms": timer.ms(lambda: ref.rmsnorm_ref(x, s, 1e-6)),
                "library_ms": timer.ms(
                    lambda: F.rms_norm(x, (shape[-1],), s, 1e-6)),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": moved}
        emit(case)
        results["rmsnorm"].append(case)
    return results


def _check_finite(torch, session, counter):
    """Wrap a session's step/prefill so every logit row is checked."""
    import numpy as np

    step, prefill = session.step, session.prefill_chunk

    def checked_step(*a, **k):
        out = step(*a, **k)
        check(bool(torch.isfinite(out).all()), "non-finite decode logits")
        counter[0] += out.shape[0] * out.shape[1]
        return out

    def checked_prefill(*a, **k):
        out = prefill(*a, **k)
        check(bool(np.isfinite(out).all()), "non-finite prefill logits")
        counter[0] += 1
        return out

    session.step, session.prefill_chunk = checked_step, checked_prefill


def phase_serve(torch):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Scheduler

    cfg = get_config("qwen3-0.6b")                     # FULL, bfloat16
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompt_lens, max_new, n_req = [128, 256, 512], 64, 16
    sched = Scheduler(cfg, model, num_slots=8, block_size=16,
                      max_len=max(prompt_lens) + max_new, device="cuda")
    rows = [0]
    _check_finite(torch, sched.session, rows)
    reqs = build_requests(cfg, n_req, prompt_lens, max_new, seed=0)
    for r in reqs:
        sched.submit(r)
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention.launches = 0
    rn.rmsnorm.launches = 0
    results = sched.run()
    launches = {"paged_attention": pa.paged_attention.launches,
                "rmsnorm": rn.rmsnorm.launches}
    st = sched.stats.as_dict()
    check(st["completed"] == n_req and len(results) == n_req,
          f"{st['completed']} of {n_req} requests completed")
    check(all(len(results[r.rid]) == max_new for r in reqs),
          "a request ended short of max_new")
    per_step = len(model.blocks)
    norms_per_call = 4 * len(model.blocks) + 1
    check(launches["paged_attention"] == per_step * st["decode_steps"] > 0,
          f"paged_attention launches {launches['paged_attention']} != "
          f"{per_step} x {st['decode_steps']} decode steps")
    calls = st["decode_steps"] + st["prefill_chunks"]
    check(launches["rmsnorm"] == norms_per_call * calls > 0,
          f"rmsnorm launches {launches['rmsnorm']} != {norms_per_call} x "
          f"{calls} model calls")
    emit({"phase": "serve", "arch": cfg.name, "dtype": cfg.dtype,
          "params": n_params, "init_s": init_s, "requests": n_req,
          "slots": 8, "block_size": 16, "prompt_lens": prompt_lens,
          "max_new": max_new, "completed": st["completed"],
          "tokens_per_s": st["tokens_per_s"], "wall_s": st["wall_s"],
          "ttft_p50_s": st["ttft_p50_s"], "ttft_p99_s": st["ttft_p99_s"],
          "tpot_mean_s": st["tpot_mean_s"],
          "decode_steps": st["decode_steps"],
          "prefill_chunks": st["prefill_chunks"],
          "logit_rows_checked": rows[0], "launches": launches,
          "paged_attention_per_decode_step":
              launches["paged_attention"] / st["decode_steps"],
          "rmsnorm_per_model_call": launches["rmsnorm"] / calls,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "sample": results[0][:8].tolist()})
    return launches


def phase_recompute(torch):
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.lm import init_lm, lm_forward
    from repro_torch.serve.scheduler import Scheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(get_config("qwen3-0.6b"), dtype="float32")
    model = init_lm(cfg, seed=1, device="cuda")
    prompt_lens, max_new = [64, 200], 16
    sched = Scheduler(cfg, model, num_slots=2, block_size=16,
                      max_len=max(prompt_lens) + max_new, device="cuda")
    reqs = build_requests(cfg, 2, prompt_lens, max_new, seed=1)
    for r in reqs:
        sched.submit(r)
    sched.run()
    ties, mismatches, checked = [], [], 0
    with torch.no_grad():
        for r in reqs:
            seq = torch.from_numpy(sched.full_sequence(r)).long().cuda()
            logits = lm_forward(model, seq[None, :-1])[0]
            P = r.prompt_len
            for i in range(max_new):
                row = logits[P - 1 + i]
                top2 = torch.topk(row, 2).values
                served = int(seq[P + i])
                gap = (top2[0] - top2[1]).item()
                checked += 1
                if gap < 1e-4:
                    ties.append({"rid": r.rid, "pos": P + i, "gap": gap})
                elif int(row.argmax()) != served:
                    mismatches.append({"rid": r.rid, "pos": P + i,
                                       "served": served,
                                       "recompute": int(row.argmax()),
                                       "gap": gap})
    emit({"phase": "recompute", "dtype": "float32", "allow_tf32": False,
          "positions": checked, "ties": ties, "tie_count": len(ties),
          "mismatches": mismatches})
    check(not mismatches, f"served tokens differ from the f32 dense "
          f"recompute at {len(mismatches)} positions")


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repo (src/repro_torch "
              "not found next to this script)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    smi_line = phase_card(torch)
    phase_build(torch)
    timer = Timer(torch)
    cases = phase_kernels(torch, timer)
    launches = phase_serve(torch)
    torch.cuda.empty_cache()
    phase_recompute(torch)

    # the kernels line reports each kernel at the shape the serve phase
    # gives it most: bf16, one query token, head_dim 128 / d = 1024
    headline = {
        "paged_attention": lambda c: (c["dtype"], c["D"], c["K"])
        == ("bfloat16", 128, 1),
        "rmsnorm": lambda c: (c["dtype"], c["shape"]) == ("bfloat16",
                                                          [8, 1024])}
    kernels = []
    for name, rows in cases.items():
        main_case = next(c for c in rows if headline[name](c))
        kernels.append({
            "name": name, "route": ROUTES[name], "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "checks_passed": len(rows)})
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
