#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (a failing run exits non-zero
and never prints the final ``ok`` line):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. the build: every kernel from a cold ``build/repro_torch`` (one nvcc
   per CUDA C++ source — paged attention, flash attention, the selective
   scan, the sLSTM — started
   together and linked into one library; Triton's JIT for the RMSNorm
   forward and backward), nvcc and Triton in parallel;
3. each serving kernel against its plain PyTorch version on the card at
   the serving shapes (decode rows; a free slot's idle row in a pow2-wide
   table; the widest one-shot prefill's norm rows) within f32 2e-5,
   bf16 2e-2, with its time (CUDA events,
   median of 30 after warm-up, L2 flushed before each launch), the plain
   version's time, one PyTorch library call's time and the bound;
4. the training kernels the same way: flash-attention forward and
   backward at the train cell's heads with B = 1 and the train step's
   B = 4 (S = 4096), a ragged S = 1000 (bf16 and f32), MHA, and bf16 at
   D = 64 (S = 1000) and D = 16 (S = 300), and the RMSNorm forward and
   backward at the train cell's three row shapes;
5. serve: qwen3-0.6b at full width in bf16 (random weights from a seed)
   through the continuous-batching paged scheduler: 16 requests, 8
   slots, prompts 128/256/512, 64 new tokens each, greedy; every logit
   row must be finite and both kernels' launch counters must match the
   decode and prefill steps taken;
6. an f32 recompute at full width: 2 served requests re-run through the
   dense causal forward (no pages, no paged kernel) must pick the served
   token at every generated position, save top-2 ties within 1e-4;
7. train: qwen3-0.6b at full width in bf16 (seed 0), B = 4, S = 4096,
   Adam lr 1e-3, clip 1.0, remat full, 6 steps through
   ``repro_torch.launch.train``'s functions; every loss finite, the
   validation loss (seed 987654) lower after the steps than before, a
   nonzero finite gradient on every parameter, and per step 56 flash
   forward, 28 flash backward, 225 RMSNorm forward and 113 RMSNorm
   backward launches; prints step time, tokens/s, peak memory and mfu,
   then profiles one more step (device time by kernel group, busy share);
8. train parity: full width at 2 layers, f32, TF32 off, B = 1,
   S = 4096: two train steps through the kernels against two through
   their plain versions on the same card (loss, every gradient, each
   tensor's weight update; tolerances at ``PARITY_TOL``);
9. the recurrent slice's kernels against their plain versions in f32
   (``|err| <= 1e-4 + 1e-4 |want|`` over up to 500 sequential steps, y /
   h and the final state): the selective scan at jamba's serve shape
   (B = 1, S = 500, d_in = 16384, N = 16), a ragged S = 37 and B = 2; the
   sLSTM at xlstm-125m's (B = 1, S = 500, d = 768, H = 4) and at (3, 33,
   96, 2); and the kernels the recurrent serve phases give new widths:
   paged attention at jamba's 8 query heads per KV head, RMSNorm at
   d = 768 and d = 8192;
10. serve_xlstm: xlstm-125m FULL in bf16 (seed 0), 16 requests, 8 slots,
    16-token pages, prompts 100/300/500, 64 new tokens, greedy; every
    logit row finite, 3 sLSTM-scan launches per prefill and 13 RMSNorm
    launches per model call;
11. serve_hybrid: jamba without experts, one period at the published
    widths (``jamba_15_large.NOEXP_8L``, ~9.0 B parameters) in bf16 (seed
    0), 8 requests, 8 slots, prompts 100/300/500, 32 new tokens; every
    logit row finite, 7 selective-scan launches per prefill, 1
    paged-attention launch per decode step and 17 RMSNorm launches per
    model call;
12. recompute_recurrent: both configs in f32, TF32 off, 2 requests each
    (prompts 100 and 300, 16 new tokens): every served token is the
    argmax of ``lm_forward`` over the served sequence, save top-2 ties
    within 1e-4;
13. a ``kernels`` line, the ``nvidia-smi`` line, and the ``ok`` line.

Needs one CUDA card, the CUDA toolkit (``nvcc``) and ``triton``; exits 1
without a card and 2 when run outside a checkout of the repo.
"""
import json
import math
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
            "rmsnorm": "src/repro/kernels/rmsnorm.py:25",
            "rmsnorm_bwd": "src/repro/kernels/rmsnorm.py:25",
            "flash_attention_fwd": "src/repro/kernels/flash_attention.py:85",
            "flash_attention_bwd": "src/repro/kernels/flash_attention.py:85",
            "mamba_scan": "src/repro/kernels/mamba_scan.py:65",
            "slstm_scan": "src/repro/kernels/slstm.py:86"}
SOURCES = {"paged_attention": "src/repro_torch/csrc/paged_attention.cu",
           "rmsnorm": "src/repro_torch/kernels/rmsnorm.py",
           "rmsnorm_bwd": "src/repro_torch/kernels/rmsnorm.py",
           "flash_attention_fwd": "src/repro_torch/csrc/flash_attention.cu",
           "flash_attention_bwd": "src/repro_torch/csrc/flash_attention.cu",
           "mamba_scan": "src/repro_torch/csrc/mamba_scan.cu",
           "slstm_scan": "src/repro_torch/csrc/slstm.cu"}
ROUTES = {"paged_attention": "cuda", "rmsnorm": "triton",
          "rmsnorm_bwd": "triton", "flash_attention_fwd": "cuda",
          "flash_attention_bwd": "cuda", "mamba_scan": "cuda",
          "slstm_scan": "cuda"}
# the scans: f32 over up to 500 sequential steps
SCAN_TOL = 1e-4
# the train phase: qwen3-0.6b FULL, bf16
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 4096, 6
# kernel launches per train step with remat full: 28 attention layers,
# each forward once and recomputed once; 4 norms per block (ln1, ln2,
# q-norm, k-norm) plus the final norm, the block norms recomputed
TRAIN_PER_STEP = {"flash_attention_fwd": 56, "flash_attention_bwd": 28,
                  "rmsnorm": 225, "rmsnorm_bwd": 113}
# train parity (f32, TF32 off): the loss to 1e-5 of itself; each gradient
# to 1e-4 of its largest entry (attention sums 64-key tiles on the card
# and 1024-key chunks in the plain version, the norms reduce in other
# orders); each weight tensor's Adam update (lr 1e-3) to 1e-3 of its L2
# norm, and no weight more than one lr apart: Adam's first steps move an
# element by about lr * g / (|g| + 1e-8), so where |g| is near 1e-8 an
# f32 rounding gap in g shows as a visible fraction of lr
PARITY_TOL = {"loss_rel": 1e-5, "grad_rel": 1e-4, "update_rel": 1e-3,
              "weight_abs": 1e-3}


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
        for d in (1024, 128, 8192):            # one compile per BLOCK
            x = torch.ones((2, d), device="cuda", dtype=torch.bfloat16)
            s = torch.ones(d, device="cuda", dtype=torch.bfloat16)
            rn.rmsnorm(x, s)
            rn.rmsnorm_bwd(x, s, x)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=2) as pool:
        f_nvcc, f_triton = pool.submit(nvcc), pool.submit(triton)
        nvcc_s, log = f_nvcc.result()
        triton_s = f_triton.result()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "nvcc_s": round(nvcc_s, 3),
          "sources": [str(p.relative_to(ROOT)) for p in build.sources()],
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


def _paged_check(torch, timer, gen, B, H, Hkv, D, bs, K, dtype, lengths,
                 width=None):
    """The paged kernel against its plain version on one random case,
    timed beside SDPA over pages gathered beforehand; returns the case."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref

    args = _paged_inputs(torch, gen, B, H, Hkv, D, bs, K, dtype, lengths,
                         W=width)
    q, kp, vp, tables, lens = args
    got = pa.paged_attention(*args)
    want = ref.paged_attention_ref(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    check(bool((err <= tol + tol * want.float().abs()).all()),
          f"paged_attention {dtype} H={H} Hkv={Hkv} D={D} K={K}: max |err| "
          f"{err.max().item()} over tolerance {tol}")
    lib_fn = _sdpa_call(torch, *args)
    lib_err = (lib_fn().transpose(1, 2).float() - want.float()).abs()
    esize = q.element_size()
    reach = sum(int(n) + K - 1 for n in lengths)
    moved = 2 * q.numel() * esize + 2 * reach * Hkv * D * esize \
        + tables.numel() * 4 + lens.numel() * 4
    ops = sum((int(n) + t) * H * D * 4 for n in lengths for t in range(K))
    b_ms, b_by = bound(moved, ops, dtype)
    case = {"kernel": "paged_attention", "dtype": dtype, "B": B, "H": H,
            "Hkv": Hkv, "D": D, "bs": bs, "K": K, "W": tables.shape[1],
            "lengths": lengths, "max_abs_err": err.max().item(),
            "tol": tol, "library_max_abs_err": lib_err.max().item(),
            "kernel_ms": timer.ms(lambda: pa.paged_attention(*args)),
            "plain_ms": timer.ms(lambda: ref.paged_attention_ref(*args)),
            "library_ms": timer.ms(lib_fn), "bound_ms": b_ms,
            "bound_by": b_by, "bytes": moved}
    emit(case)
    return case


def _rms_check(torch, timer, gen, shape, dtype):
    """The RMSNorm kernel against its plain version on one random case,
    timed beside ``F.rms_norm``; returns the case."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

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
    return case


def phase_kernels(torch, timer):
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
        results["paged_attention"].append(_paged_check(
            torch, timer, gen, 8, 16, 8, D, 16, K, dtype, case_lengths,
            width))

    # decode rows (ln1/ln2/final, q-norm, k-norm) in both dtypes, and the
    # serve phase's widest one-shot prefill (a 512-token bucket) in bf16
    rms_shapes = [((8, 1024), dt) for dt in ("bfloat16", "float32")]
    rms_shapes += [((8, 16, 128), dt) for dt in ("bfloat16", "float32")]
    rms_shapes += [((8, 8, 128), dt) for dt in ("bfloat16", "float32")]
    rms_shapes += [((512, 1024), "bfloat16"), ((512, 16, 128), "bfloat16"),
                   ((512, 8, 128), "bfloat16")]
    for shape, dtype in rms_shapes:
        results["rmsnorm"].append(_rms_check(torch, timer, gen, shape,
                                             dtype))
    return results


def _check_finite(torch, session, counter):
    """Wrap a session's step and both prefills so every logit row is
    checked."""
    import numpy as np

    step = session.step

    def checked_step(*a, **k):
        out = step(*a, **k)
        check(bool(torch.isfinite(out).all()), "non-finite decode logits")
        counter[0] += out.shape[0] * out.shape[1]
        return out

    def checked(prefill):
        def run(*a, **k):
            out = prefill(*a, **k)
            check(bool(np.isfinite(out).all()), "non-finite prefill logits")
            counter[0] += 1
            return out
        return run

    session.step = checked_step
    session.prefill = checked(session.prefill)
    session.prefill_chunk = checked(session.prefill_chunk)


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
    from repro_torch.models.lm import init_lm
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
    checked, ties, mismatches = _recompute_check(torch, model, sched, reqs,
                                                 max_new)
    emit({"phase": "recompute", "dtype": "float32", "allow_tf32": False,
          "positions": checked, "ties": ties, "tie_count": len(ties),
          "mismatches": mismatches})
    check(not mismatches, f"served tokens differ from the f32 dense "
          f"recompute at {len(mismatches)} positions")


def _recompute_check(torch, model, sched, reqs, max_new):
    """Re-run each served request through ``lm_forward`` (no cache): every
    generated token must be the argmax of its position's logits, save
    top-2 ties within 1e-4.  Returns (positions, ties, mismatches)."""
    from repro_torch.models.lm import lm_forward

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
    return checked, ties, mismatches


def _within(got, want, tol) -> tuple:
    """(ok, max |err|) of ``|got - want| <= tol + tol * |want|``, in f32."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all())
    return ok, err.max().item()


def _sdpa_train(torch, q, k, v, causal):
    """SDPA on the (B, S, H, D) tensors viewed as (B, H, S, D): forward,
    and a retained graph whose backward is the library's backward time."""
    import torch.nn.functional as F

    def fwd(a, b, c):
        return F.scaled_dot_product_attention(
            a.transpose(1, 2), b.transpose(1, 2), c.transpose(1, 2),
            is_causal=causal, enable_gqa=True)

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = fwd(*leaves)
    return (lambda: fwd(q, k, v)), out, leaves


def phase_train_kernels(torch, timer):
    """Flash attention and the RMSNorm forward/backward at the train
    phase's shapes, each against its plain version (same inputs)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    results = {"flash_attention_fwd": [], "flash_attention_bwd": [],
               "rmsnorm": [], "rmsnorm_bwd": []}
    # (B, S, H, Hkv, D, dtype): the train cell's heads at B = 1 and at the
    # train step's B = 4, a ragged S in both dtypes, MHA, and bf16 at the
    # other head dims the kernels serve (D = 64 and 16, S not a multiple of
    # the 128-row tile)
    cases = [(1, 4096, 16, 8, 128, "bfloat16"),
             (TRAIN_B, TRAIN_S, 16, 8, 128, "bfloat16"),
             (1, 1000, 16, 8, 128, "bfloat16"),
             (1, 1000, 16, 8, 128, "float32"),
             (1, 4096, 16, 16, 128, "bfloat16"),
             (1, 1000, 16, 8, 64, "bfloat16"),
             (2, 300, 4, 2, 16, "bfloat16")]
    for B, S, H, Hkv, D, dtype in cases:
        dt = getattr(torch, dtype)
        q, do = (torch.randn((B, S, H, D), generator=gen,
                             device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((B, S, Hkv, D), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        tol = TOL[dtype]
        out, lse = fa.flash_attention_fwd(q, k, v, True)
        want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v, True)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do, True)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True)
        torch.cuda.synchronize()
        errs = {}
        for name, got, w in (("out", out, want_out), ("lse", lse, want_lse),
                             ("dq", grads[0], want[0]),
                             ("dk", grads[1], want[1]),
                             ("dv", grads[2], want[2])):
            ok, errs[name] = _within(got, w, tol)
            check(ok, f"flash attention {dtype} B={B} S={S} H={H} "
                  f"Hkv={Hkv}: {name} max |err| {errs[name]} over {tol}")
        del want_out, want_lse, want
        es = q.element_size()
        pairs = B * H * S * (S + 1) // 2          # causal (query, key) pairs
        qo = B * S * H * D * es
        kv = 2 * B * S * Hkv * D * es
        lse_b = B * S * H * 4
        lib_fwd, lib_out, leaves = _sdpa_train(torch, q, k, v, True)
        shape = {"dtype": dtype, "B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
                 "causal": True, "tol": tol}
        b_ms, b_by = bound(2 * qo + kv + lse_b, 4 * D * pairs, dtype)
        case = {"kernel": "flash_attention_fwd", **shape,
                "max_abs_err": max(errs["out"], errs["lse"]),
                "kernel_ms": timer.ms(
                    lambda: fa.flash_attention_fwd(q, k, v, True)),
                "plain_ms": timer.ms(
                    lambda: ref.flash_attention_fwd_ref(q, k, v, True)),
                "library_ms": timer.ms(lib_fwd), "bound_ms": b_ms,
                "bound_by": b_by, "flops": 4 * D * pairs}
        emit(case)
        results["flash_attention_fwd"].append(case)
        b_ms, b_by = bound(3 * qo + 2 * kv + lse_b, 10 * D * pairs, dtype)
        case = {"kernel": "flash_attention_bwd", **shape,
                "max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]),
                "kernel_ms": timer.ms(lambda: fa.flash_attention_bwd(
                    q, k, v, out, lse, do, True)),
                "plain_ms": timer.ms(lambda: ref.flash_attention_bwd_ref(
                    q, k, v, out, lse, do, True)),
                "library_ms": timer.ms(lambda: torch.autograd.grad(
                    lib_out, leaves, do.transpose(1, 2), retain_graph=True)),
                "bound_ms": b_ms, "bound_by": b_by, "flops": 10 * D * pairs}
        emit(case)
        results["flash_attention_bwd"].append(case)
        del lib_out, leaves, grads
        torch.cuda.empty_cache()

    # the train cell's norm rows: ln1/ln2/final (B*S, 1024), q-norm
    # (B*S*16, 128), k-norm (B*S*8, 128)
    rows = TRAIN_B * TRAIN_S
    for shape in ((rows, 1024), (rows * 16, 128), (rows * 8, 128)):
        dtype = "bfloat16"
        x, dy = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        s = torch.randn(shape[-1], generator=gen, device="cuda").to(
            torch.bfloat16)
        tol = TOL[dtype]
        ok, err = _within(rn.rmsnorm(x, s, 1e-6), ref.rmsnorm_ref(x, s, 1e-6),
                          tol)
        check(ok, f"rmsnorm {shape}: max |err| {err} over {tol}")
        xs = x.numel() * x.element_size()
        ss = s.numel() * s.element_size()
        b_ms, b_by = bound(2 * xs + ss, 4 * x.numel(), dtype)
        case = {"kernel": "rmsnorm", "dtype": dtype, "shape": list(shape),
                "path": "train", "max_abs_err": err, "tol": tol,
                "kernel_ms": timer.ms(lambda: rn.rmsnorm(x, s, 1e-6)),
                "plain_ms": timer.ms(lambda: ref.rmsnorm_ref(x, s, 1e-6)),
                "library_ms": timer.ms(
                    lambda: F.rms_norm(x, (shape[-1],), s, 1e-6)),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": 2 * xs + ss}
        emit(case)
        results["rmsnorm"].append(case)

        dx, ds = rn.rmsnorm_bwd(x, s, dy, 1e-6)
        rdx, rds = ref.rmsnorm_bwd_ref(x, s, dy, 1e-6)
        ok_x, err_x = _within(dx, rdx, tol)
        ok_s, err_s = _within(ds, rds, tol)
        check(ok_x and ok_s, f"rmsnorm_bwd {shape}: max |err| dx {err_x}, "
              f"dscale {err_s} over {tol}")
        xl, sl = x.detach().requires_grad_(), s.detach().requires_grad_()
        lib_y = F.rms_norm(xl, (shape[-1],), sl, 1e-6)
        moved = 3 * xs + 2 * ss
        b_ms, b_by = bound(moved, 8 * x.numel(), dtype)
        case = {"kernel": "rmsnorm_bwd", "dtype": dtype,
                "shape": list(shape), "max_abs_err": max(err_x, err_s),
                "tol": tol,
                "kernel_ms": timer.ms(lambda: rn.rmsnorm_bwd(x, s, dy, 1e-6)),
                "plain_ms": timer.ms(
                    lambda: ref.rmsnorm_bwd_ref(x, s, dy, 1e-6)),
                "library_ms": timer.ms(lambda: torch.autograd.grad(
                    lib_y, (xl, sl), dy, retain_graph=True)),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": moved}
        emit(case)
        results["rmsnorm_bwd"].append(case)
        del lib_y, xl, sl
    return results


def _train_counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "rmsnorm": rn.rmsnorm, "rmsnorm_bwd": rn.rmsnorm_bwd}


def _check_grads(torch, model, where):
    """Every parameter holds a finite gradient with a nonzero entry."""
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or not bool((p.grad != 0).any())]
    check(not bad, f"{where}: {len(bad)} parameters without a nonzero "
          f"finite gradient, e.g. {bad[:5]}")


# device-time groups of the profiled train step and serve calls, by
# kernel name
PROFILE_GROUPS = (("flash_attention_fwd", ("flash_fwd",)),
                  ("flash_attention_bwd", ("flash_bwd",)),
                  ("rmsnorm", ("rmsnorm",)),
                  ("paged_attention", ("paged_attention",)),
                  ("mamba_scan", ("mamba_scan",)),
                  ("slstm_scan", ("slstm_scan",)),
                  ("matmul", ("gemm", "sm90", "cutlass", "nvjet", "xmma",
                              "cublas")))


def _profile(torch, fn):
    """One call of ``fn`` under torch.profiler: device time by kernel
    group, the busiest kernels, and the device's busy share of the call's
    wall time (None where the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    busy = sum(kernels.values())
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other"] = 0.0
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in PROFILE_GROUPS
                      if any(k in low for k in keys)), "other")
        groups[group] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "busy_share": busy / (wall * 1e3) if busy else None,
            "group_ms": groups, "kernels": len(kernels),
            "top": [[name[:80], ms] for name, ms in top]}


def phase_train(torch):
    """Train qwen3-0.6b FULL through the launcher's functions."""
    from repro_torch.launch import train as tl

    args = tl.build_parser().parse_args([
        "--arch", "qwen3-0.6b", "--steps", str(TRAIN_STEPS), "--batch",
        str(TRAIN_B), "--seq", str(TRAIN_S), "--lr", "1e-3", "--optimizer",
        "adam", "--remat", "full", "--seed", "0"])
    t0 = time.perf_counter()
    tr = tl.build_trainer(args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, model = tr.cfg, tr.state["model"]
    check(cfg.dtype == "bfloat16" and tr.opt_cfg.grad_clip_norm == 1.0,
          "train config: bf16 weights and clip 1.0 expected")
    n_params = sum(p.numel() for p in model.parameters())
    val = tl.device_batch(cfg, TRAIN_B, TRAIN_S, tl.VAL_SEED, tr.device)
    val_before = float(tr.metric(model, val))
    batches = [tl.device_batch(cfg, TRAIN_B, TRAIN_S, i, tr.device)
               for i in range(TRAIN_STEPS)]
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, lrs, gnorms, step_s, per_step = [], [], [], [], []
    for i, batch in enumerate(batches):
        before = {n: fn.launches for n, fn in counters.items()}
        t0 = time.perf_counter()
        _, m = tr.step(tr.state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append({n: fn.launches - before[n]
                         for n, fn in counters.items()})
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        gnorms.append(float(m["grad_norm"]))
        if i in (0, TRAIN_STEPS - 1):
            _check_grads(torch, model, f"train step {i}")
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    val_after = float(tr.metric(model, val))
    profile = _profile(torch, lambda: tr.step(tr.state, batches[0]))
    check(all(map(math.isfinite, losses + gnorms)),
          f"non-finite train loss or grad norm: {losses} {gnorms}")
    check(math.isfinite(val_after) and val_after < val_before,
          f"validation loss did not fall: {val_before} -> {val_after}")
    for i, got in enumerate(per_step):
        check(got == TRAIN_PER_STEP, f"train step {i} launches {got} != "
              f"{TRAIN_PER_STEP}")
    step = statistics.median(step_s[-4:])
    tokens = TRAIN_B * TRAIN_S
    attn_flops = 2 * TRAIN_B * cfg.num_heads * TRAIN_S ** 2 \
        * cfg.resolved_head_dim
    model_flops = 6 * n_params * tokens + 3 * attn_flops * cfg.num_layers
    stats = {"phase": "train", "arch": cfg.name, "dtype": cfg.dtype,
             "params": n_params, "batch": TRAIN_B, "seq": TRAIN_S,
             "steps": TRAIN_STEPS, "optimizer": tr.opt_cfg.name,
             "lr": tr.opt_cfg.lr, "warmup_steps": tr.opt_cfg.warmup_steps,
             "remat": args.remat, "init_s": init_s, "losses": losses,
             "lrs": lrs, "grad_norms": gnorms, "step_s": step_s,
             "step_ms": step * 1e3, "tokens_per_s": tokens / step,
             "peak_mem_gib": peak / 2**30,
             "mfu": model_flops / step / PEAK_OPS_PER_S["bfloat16"],
             "model_flops_per_step": model_flops,
             "val_before": val_before, "val_after": val_after,
             "launches": launches, "launches_per_step": per_step[-1],
             "grads_checked": "every parameter, steps 0 and last",
             "profiled_step": profile}
    emit(stats)
    del tr, model, batches, val
    return launches, stats


def phase_train_parity(torch):
    """Two f32 train steps through the kernels == through the plain
    versions (same card, same weights and batches)."""
    from repro_torch.configs.base import OptimizerConfig, replace
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch import train as tl
    from repro_torch.train.steps import init_lm_state, make_lm_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(get_config("qwen3-0.6b"), dtype="float32", num_layers=2)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=1)
    batches = [tl.device_batch(cfg, 1, TRAIN_S, i, "cuda") for i in range(2)]
    plain = {(fa, "flash_attention_fwd"): fa.flash_attention_fwd_ref,
             (fa, "flash_attention_bwd"): fa.flash_attention_bwd_ref,
             (rn, "rmsnorm"): rn.rmsnorm_ref,
             (rn, "rmsnorm_bwd"): rn.rmsnorm_bwd_ref}

    def run(use_plain):
        saved = {key: getattr(*key) for key in plain}
        if use_plain:                  # the ops dispatch reads these names
            for (mod, name), fn in plain.items():
                setattr(mod, name, fn)
        try:
            state = init_lm_state(cfg, opt_cfg, seed=0, device="cuda")
            step = make_lm_train_step(cfg, opt_cfg, remat="full")
            losses, grads = [], []
            init = {n: p.detach().clone() for n, p in
                    state["model"].named_parameters()}
            for batch in batches:
                _, m = step(state, batch)
                losses.append(float(m["loss"]))
                grads.append({n: p.grad.clone() for n, p in
                              state["model"].named_parameters()})
            updates = {n: p.detach() - init[n] for n, p in
                       state["model"].named_parameters()}
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
        return losses, grads, updates

    k_loss, k_grads, k_u = run(False)
    p_loss, p_grads, p_u = run(True)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, p_loss))
    grad_rel, worst = 0.0, ""
    for kg, pg in zip(k_grads, p_grads):
        for n in pg:
            rel = ((kg[n] - pg[n]).abs().max()
                   / pg[n].abs().max().clamp(min=1e-30)).item()
            if rel > grad_rel:
                grad_rel, worst = rel, n
    # the two runs start from the same weights: the weights' gap is the
    # updates' gap
    w_err = max((k_u[n] - p_u[n]).abs().max().item() for n in p_u)
    upd_rel = max((torch.linalg.vector_norm(k_u[n] - p_u[n])
                   / torch.linalg.vector_norm(p_u[n]).clamp(min=1e-30)
                   ).item() for n in p_u)
    check(min(torch.linalg.vector_norm(u).item() for u in p_u.values()) > 0,
          "train parity: a weight tensor did not move")
    emit({"phase": "train_parity", "dtype": "float32", "allow_tf32": False,
          "layers": cfg.num_layers, "batch": 1, "seq": TRAIN_S, "steps": 2,
          "optimizer": "adam", "lr": opt_cfg.lr,
          "losses_kernel": k_loss, "losses_plain": p_loss,
          "loss_rel_err": loss_rel, "grad_rel_err": grad_rel,
          "worst_grad": worst, "update_rel_err": upd_rel,
          "weight_abs_err": w_err, "tol": PARITY_TOL})
    check(loss_rel <= PARITY_TOL["loss_rel"],
          f"train parity: loss rel err {loss_rel}")
    check(grad_rel <= PARITY_TOL["grad_rel"],
          f"train parity: gradient {worst} rel err {grad_rel}")
    check(upd_rel <= PARITY_TOL["update_rel"],
          f"train parity: weight update rel err {upd_rel}")
    check(w_err <= PARITY_TOL["weight_abs"],
          f"train parity: weight abs err {w_err}")


def _scan_case(torch, timer, name, fn, plain, args, moved, ops):
    """A scan kernel against its plain version (every output, f32, within
    ``SCAN_TOL``), timed; ``library_ms`` is None: no PyTorch call computes
    either recurrence."""
    got = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    flat = lambda out: [t for x in out for t in
                        (x if isinstance(x, (tuple, list)) else (x,))]
    errs = []
    for g, w in zip(flat(got), flat(want)):
        ok, err = _within(g, w, SCAN_TOL)
        check(ok, f"{name} {[tuple(a.shape) for a in args]}: max |err| "
              f"{err} over tolerance {SCAN_TOL}")
        errs.append(err)
    b_ms, b_by = bound(moved, ops, "float32")
    return {"kernel": name, "dtype": "float32", "max_abs_err": max(errs),
            "tol": SCAN_TOL, "kernel_ms": timer.ms(lambda: fn(*args)),
            "plain_ms": timer.ms(lambda: plain(*args)), "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": moved, "ops": ops}


def phase_recurrent_kernels(torch, timer):
    """The selective scan and the sLSTM against their plain versions at
    the recurrent serve phases' shapes, and paged attention and RMSNorm at
    the new widths those phases give them."""
    import torch.nn.functional as F

    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm as sl

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    results = {"mamba_scan": [], "slstm_scan": [], "paged_attention": [],
               "rmsnorm": []}
    for B, S, d, N in ((1, 500, 16384, 16), (1, 37, 16384, 16),
                       (2, 500, 16384, 16)):
        rand = lambda *shape: torch.randn(shape, generator=gen,
                                          device="cuda")
        # dt around the model's softplus(dt_bias = -4.6) ~ 0.01
        dt = F.softplus(rand(B, S, d) - 4.6)
        a = -torch.arange(1, N + 1, dtype=torch.float32,
                          device="cuda").repeat(d, 1)
        args = (dt, rand(B, S, d), rand(B, S, N), rand(B, S, N), a)
        moved = 4 * (3 * B * S * d + 2 * B * S * N + d * N + B * d * N)
        # per (step, channel, state): exp, two products, two fmas
        case = _scan_case(torch, timer, "mamba_scan", ms.mamba_scan,
                          ref.mamba_scan_ref, args, moved, 5 * B * S * d * N)
        case.update(B=B, S=S, d_in=d, N=N)
        emit(case)
        results["mamba_scan"].append(case)
    for B, S, d, H in ((1, 500, 768, 4), (3, 33, 96, 2)):
        dh = d // H
        gx = torch.randn((B, S, 4 * d), generator=gen, device="cuda")
        r = torch.randn((H, dh, 4 * dh), generator=gen,
                        device="cuda") / math.sqrt(dh)
        moved = 4 * (5 * B * S * d + H * dh * 4 * dh + 4 * B * d)
        # per step: the (dh x 4dh) product of every head, ~16 flops of
        # gate math per channel
        ops = B * S * (8 * d * dh + 16 * d)
        case = _scan_case(torch, timer, "slstm_scan", sl.slstm_scan,
                          ref.slstm_ref, (gx, r), moved, ops)
        case.update(B=B, S=S, d=d, H=H)
        emit(case)
        results["slstm_scan"].append(case)
    # jamba's decode step: 64 query heads over 8 KV heads (g = 8), one
    # attention layer, prompts up to 500 + 32 new tokens
    lengths = torch.randint(100, 533, (8,), generator=gen,
                            device="cuda").tolist()
    for dtype in ("bfloat16", "float32"):
        results["paged_attention"].append(_paged_check(
            torch, timer, gen, 8, 64, 8, 128, 16, 1, dtype, lengths))
    # xlstm-125m (d = 768, a masked 1024 block) and jamba (d = 8192, one
    # 8192-wide row per program): decode rows and a 500-token prefill
    for d in (768, 8192):
        for shape, dtype in (((8, d), "bfloat16"), ((8, d), "float32"),
                             ((500, d), "bfloat16")):
            results["rmsnorm"].append(_rms_check(torch, timer, gen, shape,
                                                 dtype))
    return results


def _serve_phase(torch, phase, cfg, n_req, prompt_lens, max_new, expect):
    """Serve a trace through the scheduler on the card and hold the kernel
    counters to ``expect``: {kernel: (step counter, launches per count)},
    the counters set to 0 just before the run and read just after."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import slstm as sl
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Scheduler

    counters = {"mamba_scan": ms.mamba_scan, "slstm_scan": sl.slstm_scan,
                "paged_attention": pa.paged_attention, "rmsnorm": rn.rmsnorm}
    t0 = time.perf_counter()
    model = init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    sched = Scheduler(cfg, model, num_slots=8, block_size=16,
                      max_len=max(prompt_lens) + max_new, device="cuda")
    rows = [0]
    _check_finite(torch, sched.session, rows)
    reqs = build_requests(cfg, n_req, prompt_lens, max_new, seed=0)
    for r in reqs:
        sched.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    results = sched.run()
    launches = {n: fn.launches for n, fn in counters.items()}
    st = sched.stats.as_dict()
    profiled = _profile_serve(torch, sched, reqs[prompt_lens.index(
        max(prompt_lens))].prompt)
    check(st["completed"] == n_req and len(results) == n_req,
          f"{phase}: {st['completed']} of {n_req} requests completed")
    check(all(len(results[r.rid]) == max_new for r in reqs),
          f"{phase}: a request ended short of max_new")
    check(st["prefill_chunks"] == 0 and st["prefills"] == n_req
          and st["padded_prefill_tokens"] == st["prefill_tokens"]
          == sum(r.prompt_len for r in reqs),
          f"{phase}: expected one exact-length prefill per request, got "
          f"{st['prefills']} prefills, {st['prefill_chunks']} chunks")
    counts = {"prefills": st["prefills"],
              "decode_steps": st["decode_steps"],
              "model_calls": st["prefills"] + st["decode_steps"]}
    for name, (per, k) in expect.items():
        check(launches[name] == k * counts[per] > 0,
              f"{phase}: {name} launches {launches[name]} != {k} x "
              f"{counts[per]} {per}")
    emit({"phase": phase, "arch": cfg.name, "dtype": cfg.dtype,
          "params": n_params, "init_s": init_s, "requests": n_req,
          "slots": 8, "block_size": 16, "prompt_lens": prompt_lens,
          "max_new": max_new, "completed": st["completed"],
          "tokens_per_s": st["tokens_per_s"], "wall_s": st["wall_s"],
          "ttft_p50_s": st["ttft_p50_s"], "ttft_p99_s": st["ttft_p99_s"],
          "tpot_mean_s": st["tpot_mean_s"], **counts,
          "logit_rows_checked": rows[0], "launches": launches,
          "expected_per": {n: list(v) for n, v in expect.items()},
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "sample": results[0][:8].tolist(), "profiled": profiled})
    return {n: launches[n] for n in expect}


def _profile_serve(torch, sched, prompt):
    """After a serve run (every slot free): one more exact-length prefill
    of ``prompt`` and one decode step over all slots, each under
    torch.profiler."""
    import numpy as np

    pool, session = sched.pool, sched.session
    P = len(prompt)
    pool.admit("profiled", P + 1)
    index = np.full((pool.num_slots,), -1, np.int32)
    index[pool.slot_of("profiled")] = P
    tokens = np.zeros((pool.num_slots, 1), np.int32)
    out = {"prompt_len": P,
           "prefill": _profile(torch, lambda: session.prefill("profiled",
                                                             prompt)),
           "decode_step": _profile(torch, lambda: session.step(
               tokens, index, width=pool.table_width_for(P + 1)))}
    pool.release("profiled")
    return out


def phase_serve_recurrent(torch):
    """serve_xlstm and serve_hybrid: the two recurrent families at full
    width in bf16 through the scheduler."""
    from repro_torch.configs.jamba_15_large import NOEXP_8L
    from repro_torch.configs.registry import get_config

    out = {"serve_xlstm": _serve_phase(
        torch, "serve_xlstm", get_config("xlstm-125m"), 16, [100, 300, 500],
        64, {"slstm_scan": ("prefills", 3),
             "rmsnorm": ("model_calls", 13)})}
    torch.cuda.empty_cache()
    out["serve_hybrid"] = _serve_phase(
        torch, "serve_hybrid", NOEXP_8L, 8, [100, 300, 500], 32,
        {"mamba_scan": ("prefills", 7), "paged_attention": ("decode_steps", 1),
         "rmsnorm": ("model_calls", 17)})
    torch.cuda.empty_cache()
    return out


def phase_recompute_recurrent(torch):
    """Both recurrent configs in f32 (TF32 off): two served requests each
    re-run through ``lm_forward`` must pick every served token."""
    from repro_torch.configs.base import replace
    from repro_torch.configs.jamba_15_large import NOEXP_8L
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import build_requests
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Scheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prompt_lens, max_new = [100, 300], 16
    report = {}
    for base in (get_config("xlstm-125m"), NOEXP_8L):
        cfg = replace(base, dtype="float32")
        model = init_lm(cfg, seed=1, device="cuda")
        sched = Scheduler(cfg, model, num_slots=2, block_size=16,
                          max_len=max(prompt_lens) + max_new, device="cuda")
        reqs = build_requests(cfg, 2, prompt_lens, max_new, seed=1)
        for r in reqs:
            sched.submit(r)
        sched.run()
        checked, ties, mismatches = _recompute_check(torch, model, sched,
                                                     reqs, max_new)
        report[cfg.name] = {"positions": checked, "ties": ties,
                            "tie_count": len(ties),
                            "mismatches": mismatches}
        del model, sched
        torch.cuda.empty_cache()
    emit({"phase": "recompute_recurrent", "dtype": "float32",
          "allow_tf32": False, "prompt_lens": prompt_lens,
          "max_new": max_new, **report})
    for name, r in report.items():
        check(not r["mismatches"], f"{name}: served tokens differ from the "
              f"f32 recompute at {len(r['mismatches'])} positions")


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
    for more in (phase_train_kernels(torch, timer),
                 phase_recurrent_kernels(torch, timer)):
        for name, rows in more.items():
            cases.setdefault(name, []).extend(rows)
    del timer
    torch.cuda.empty_cache()
    serve_launches = phase_serve(torch)
    torch.cuda.empty_cache()
    phase_recompute(torch)
    torch.cuda.empty_cache()
    train_launches, _ = phase_train(torch)
    torch.cuda.empty_cache()
    phase_train_parity(torch)
    torch.cuda.empty_cache()
    recurrent_launches = phase_serve_recurrent(torch)
    phase_recompute_recurrent(torch)

    # the kernels line reports each kernel at the shape its path gives it
    # most: paged attention and the RMSNorm forward at the serve decode
    # shape (bf16, one query token, head_dim 128 / d = 1024), the training
    # kernels at the train cell's (bf16, B = 4, S = 4096; 16384 x 1024),
    # the scans at the recurrent serve phases' longest prompt (f32, B = 1,
    # S = 500)
    headline = {
        "paged_attention": lambda c: (c["dtype"], c["D"], c["K"])
        == ("bfloat16", 128, 1),
        "rmsnorm": lambda c: (c["dtype"], c["shape"]) == ("bfloat16",
                                                          [8, 1024]),
        "rmsnorm_bwd": lambda c: c["shape"] == [TRAIN_B * TRAIN_S, 1024],
        "flash_attention_fwd": lambda c: (c["dtype"], c["B"], c["S"],
                                          c["Hkv"])
        == ("bfloat16", TRAIN_B, TRAIN_S, 8),
        "flash_attention_bwd": lambda c: (c["dtype"], c["B"], c["S"],
                                          c["Hkv"])
        == ("bfloat16", TRAIN_B, TRAIN_S, 8),
        "mamba_scan": lambda c: (c["B"], c["S"]) == (1, 500),
        "slstm_scan": lambda c: (c["B"], c["S"]) == (1, 500)}
    by_path = {"serve": serve_launches, "train": train_launches,
               **recurrent_launches}
    kernels = []
    for name, rows in cases.items():
        main_case = next(c for c in rows if headline[name](c))
        counts = {path: launches[name] for path, launches in by_path.items()
                  if name in launches}
        kernels.append({
            "name": name, "route": ROUTES[name], "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": sum(counts.values()),
            "launches_by_path": counts,
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
