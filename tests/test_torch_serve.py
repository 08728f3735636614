"""The port's scheduler against the JAX scheduler on the same trace (CPU).

Both packages serve the qwen3 smoke config at f32 with the same weights
(carried across by ``repro_torch.bridge``) through 2 slots and 4-token
pages; the trace mixes prompt lengths 5-24 and shares prompt prefixes.
Generated tokens must be identical, as must the pool's block and
prefix-sharing counters and the scheduler's step counters.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_COUNTERS = ("completed", "prefills", "prefill_chunks", "prefill_tokens",
                 "padded_prefill_tokens", "decode_steps", "decode_tokens",
                 "decode_slot_steps", "ragged_splits")


def _trace(vocab: int, temperature: float):
    """Six requests, prompts 5..24 tokens; request 1 reuses the first
    pages of request 0 while it is live (prefix sharing); requests 2 and
    3 (24 and 5 tokens) decode side by side, which triggers the CPU
    path's ragged width split."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, vocab, 24).astype(np.int32)

    def fresh(n):
        return rng.integers(0, vocab, n).astype(np.int32)

    prompts = [base[:13], np.concatenate([base[:12], fresh(6)]), fresh(24),
               fresh(5), fresh(9), np.concatenate([base[:8], fresh(3)])]
    return [dict(rid=i, prompt=p, max_new=6, temperature=temperature,
                 seed=None if temperature <= 0 else 100 + i)
            for i, p in enumerate(prompts)]


@pytest.fixture(scope="module")
def weights():
    jax = pytest.importorskip("jax")
    from repro.configs import qwen3_06b as jq
    from repro.models.lm import init_lm as jax_init_lm
    from repro_torch.bridge import load_jax_params
    from repro_torch.configs import qwen3_06b as tq
    from repro_torch.models.lm import init_lm

    jcfg = dataclasses.replace(jq.SMOKE, dtype="float32")
    tcfg = dataclasses.replace(tq.SMOKE, dtype="float32")
    # initialised under jit: one compile instead of one dispatch per op
    params = jax.jit(lambda key: jax_init_lm(jcfg, key)[0])(
        jax.random.PRNGKey(0))
    model = init_lm(tcfg, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, params, tcfg, model


@pytest.mark.parametrize("temperature,chunk,policy,pin", [
    (0.0, 0, "continuous", False),
    (0.8, 0, "continuous", False),
    (0.0, 4, "continuous", False),
    (0.8, 4, "static", False),
    (0.0, 0, "continuous", True),
])
def test_scheduler_token_identity_with_jax(weights, temperature, chunk,
                                           policy, pin):
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.serve.scheduler import Request, Scheduler

    jcfg, params, tcfg, model = weights
    kw = dict(num_slots=2, max_len=30, block_size=4, prefill_chunk=chunk,
              policy=policy, pin_prefix=pin)
    js = JScheduler(jcfg, params, telemetry=False, **kw)
    ts = Scheduler(tcfg, model, device="cpu", **kw)
    for r in _trace(jcfg.vocab_size, temperature):
        js.submit(JRequest(**r))
        ts.submit(Request(**r))
    jres, tres = js.run(max_steps=400), ts.run(max_steps=400)
    assert sorted(tres) == sorted(jres) == list(range(6))
    for rid in jres:
        assert tres[rid].tolist() == jres[rid].tolist(), rid
    assert ts.pool.as_dict() == js.pool.as_dict()
    jd, td = js.stats.as_dict(), ts.stats.as_dict()
    for k in STEP_COUNTERS:
        assert td[k] == jd[k], k
    if policy == "continuous":
        # static admits a whole batch before any prompt is prefilled, so
        # only the continuous trace shares prefixes and splits widths
        assert ts.pool.prefix_hits >= 1
        assert td["ragged_splits"] > 0
    if pin:
        assert ts.pool.as_dict()["pinned_blocks"] > 0


# ---------------------------------------------------------------------------
# hot swap (registry, immediate and drain) against the JAX scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def second():
    """A second weight set (JAX key 7), and the port's copy of it as a
    state dict."""
    jax = pytest.importorskip("jax")
    from repro.configs import qwen3_06b as jq
    from repro.models.lm import init_lm as jax_init_lm
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import qwen3_06b as tq

    jcfg = dataclasses.replace(jq.SMOKE, dtype="float32")
    p2 = jax.jit(lambda key: jax_init_lm(jcfg, key)[0])(
        jax.random.PRNGKey(7))
    tcfg = dataclasses.replace(tq.SMOKE, dtype="float32")
    return p2, params_from_jax(jax.tree.map(np.asarray, p2), tcfg)


class _ArmedRegistry:
    """refresh() reports a new winner exactly once, when armed (the JAX
    package's test double)."""

    def __init__(self):
        self.params = None
        self.armed_params = None

    def refresh(self):
        if self.armed_params is not None:
            self.params, self.armed_params = self.armed_params, None
            return True
        return False


def _both(weights, **kw):
    """A JAX and a port scheduler over the same weights (the port's on a
    fresh copy: a swap writes into its model)."""
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Scheduler

    jcfg, params, tcfg, model = weights
    fresh = init_lm(tcfg, device="cpu")
    fresh.load_state_dict(model.state_dict())
    return (JScheduler(jcfg, params, telemetry=False, **kw),
            Scheduler(tcfg, fresh, device="cpu", **kw))


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def test_scheduler_hot_swap_mid_stream_matches_jax(weights, second):
    """``tests/test_serve.py``'s mid-stream swap: four steps on the first
    weights, ``set_params``, the rest on the second; token-identical in
    both packages, and the swap changes the tail of the stream."""
    from repro.serve.scheduler import Request as JRequest
    from repro_torch.serve.scheduler import Request

    prompt = _prompts(weights[0].vocab_size, [8], 0)[0]
    out = {}
    for swap in (False, True):
        js, ts = _both(weights, num_slots=1, max_len=32)
        js.submit(JRequest(rid=0, prompt=prompt, max_new=10))
        ts.submit(Request(rid=0, prompt=prompt, max_new=10))
        for _ in range(4):
            js.step()
            ts.step()
        if swap:
            js.set_params(second[0])
            ts.set_params(second[1])
        jr, tr = js.run(max_steps=100)[0], ts.run(max_steps=100)[0]
        assert tr.tolist() == jr.tolist()
        assert ts.stats.hot_swaps == js.stats.hot_swaps == int(swap)
        out[swap] = tr.tolist()
    assert out[True][:5] == out[False][:5]    # 1 prefill + 4 decode tokens
    assert out[True] != out[False]


def test_immediate_and_drain_swaps_over_a_registry_match_jax(weights,
                                                             second):
    """``tests/test_paged.py``'s drain case over an armed registry: drain
    finishes the in-flight requests on the old weights, immediate swaps
    under them, the late admission runs on the new weights in both; every
    stream and ``hot_swaps`` as JAX's scheduler gives them."""
    from repro.serve.scheduler import Request as JRequest
    from repro_torch.serve.scheduler import Request

    prompts = _prompts(weights[0].vocab_size, [8, 8, 8], 1)

    def serve(swap, mode):
        regs = (_ArmedRegistry(), _ArmedRegistry())
        runs = _both(weights, num_slots=2, max_len=32, block_size=4,
                     watch_every=1, swap_mode=mode)
        outs = []
        for s, reg, req, new in zip(runs, regs, (JRequest, Request),
                                    second):
            s.registry = reg
            s.submit(req(rid=0, prompt=prompts[0], max_new=8))
            s.submit(req(rid=1, prompt=prompts[1], max_new=8))
            for _ in range(3):
                s.step()
            if swap:
                reg.armed_params = new
            s.submit(req(rid=2, prompt=prompts[2], max_new=4))
            res = s.run(max_steps=200)
            assert not s.draining
            outs.append(({k: v.tolist() for k, v in res.items()},
                         s.stats.hot_swaps))
        assert outs[1] == outs[0]
        return outs[1]

    (base, n0), (drain, n1), (imm, n2) = (serve(False, "drain"),
                                          serve(True, "drain"),
                                          serve(True, "immediate"))
    assert (n0, n1, n2) == (0, 1, 1)
    assert drain[0] == base[0] and drain[1] == base[1]
    assert imm[0] != base[0]
    assert drain[2] == imm[2] != base[2]


def test_hot_swap_invalidates_prefix_cache(weights, second):
    """``tests/test_paged.py``'s prefix case: after an immediate swap a
    request with a live request's prompt maps none of its old-weight
    pages (pinned ones included), and its tokens are the second weights'
    alone, as in JAX."""
    from repro.serve.scheduler import Request as JRequest
    from repro_torch.serve.scheduler import Request, Scheduler

    prompt = _prompts(weights[0].vocab_size, [9], 2)[0]
    outs = []
    for s, req, new in zip(_both(weights, num_slots=2, max_len=32,
                                 block_size=4, pin_prefix=True),
                           (JRequest, Request), second):
        s.submit(req(rid="a", prompt=prompt, max_new=8))
        for _ in range(3):
            s.step()            # "a" prefilled + registered, still decoding
        assert s.pool.find_shared_prefix(prompt)[1] == 8
        assert s.pool.as_dict()["pinned_blocks"] == 2
        s.set_params(new)
        assert s.pool.find_shared_prefix(prompt)[1] == 0    # flushed
        assert s.pool.as_dict()["pinned_blocks"] == 0
        s.submit(req(rid="b", prompt=prompt, max_new=4))
        out = s.run(max_steps=200)
        assert s.pool.prefix_hits == 0
        outs.append({k: v.tolist() for k, v in out.items()})
    assert outs[1] == outs[0]
    from repro_torch.models.lm import init_lm

    model = init_lm(weights[2], device="cpu")
    model.load_state_dict(second[1])
    ref = Scheduler(weights[2], model, num_slots=1, max_len=32,
                    block_size=4, device="cpu")
    ref.submit(Request(rid=0, prompt=prompt, max_new=4))
    assert outs[1]["b"] == ref.run(max_steps=100)[0].tolist()


def test_serve_cli_lm_from_a_population_with_hot_swap(tmp_path,
                                                      monkeypatch, capsys):
    """The port's serve CLI serves the winner of a population the port's
    ltfb CLI wrote, and hot-swaps a newer population step that lands
    mid-stream (``auto_export``), as ``tests/test_serve.py``'s CLI case."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import ltfb, serve
    from repro_torch.serve import registry as reg
    from repro_torch.serve import scheduler as sched_mod

    pop = str(tmp_path / "pop")
    assert ltfb.main([
        "--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--trainers",
        "2", "--rounds", "1", "--steps-per-round", "1", "--batch", "4",
        "--seq", "16", "--samples", "96", "--samples-per-file", "32",
        "--num-ranks", "1", "--ckpt-dir", pop, "--data-dir",
        str(tmp_path / "data")]) == 0
    assert ckpt.latest_population_step(pop) == 1
    orig_step = sched_mod.Scheduler.step
    fired = []

    def step_with_new_ckpt(self):
        if self._step_count == 3 and not fired:
            fired.append(True)
            # step 1's weights again, as a later round would write them
            ckpt.save_population(pop, 2, ckpt.restore_population(
                pop, 1, {"params": self.registry.like_params,
                         "opt_state": {}}))
        orig_step(self)

    monkeypatch.setattr(sched_mod.Scheduler, "step", step_with_new_ckpt)
    capsys.readouterr()
    assert serve.main([
        "--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--ckpt-dir",
        pop, "--watch-every", "2", "--swap-mode", "drain", "--requests",
        "6", "--slots", "2", "--max-new", "8", "--prompt-lens",
        "8,12"]) == 0
    out = capsys.readouterr().out
    for tag in ("[serve] winner: step=1", "swap_mode=drain",
                "completed=6", "hot_swaps=1",
                "[serve] registry: serving_step=2 hot_swaps=1"):
        assert tag in out, tag
    assert reg.latest_winner_step(pop) == 2


def test_cli_serves_smoke_on_cpu(tmp_path):
    out = tmp_path / "serve.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--smoke", "--device", "cpu", "--requests", "4",
         "--max-new", "5", "--out-json", str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[serve] throughput" in proc.stdout
    payload = json.loads(out.read_text())
    assert payload["stats"]["completed"] == 4
    assert payload["device"] == "cpu"
    assert sorted(payload["results"]) == ["0", "1", "2", "3"]
    assert all(len(v) == 5 for v in payload["results"].values())


@pytest.mark.cuda
def test_scheduler_on_card_matches_cpu():
    """The smoke trace served on the card (CUDA and Triton kernels) gives
    the CPU path's tokens at f32, and both kernels were launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.configs import qwen3_06b as tq
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.scheduler import Request, Scheduler

    cfg = dataclasses.replace(tq.SMOKE, dtype="float32")
    cpu_model = init_lm(cfg, device="cpu")
    results = {}
    for device in ("cpu", "cuda"):
        model = init_lm(cfg, device=device)
        model.load_state_dict(cpu_model.state_dict())
        s = Scheduler(cfg, model, num_slots=2, max_len=30, block_size=4,
                      device=device)
        for r in _trace(cfg.vocab_size, 0.0):
            s.submit(Request(**r))
        before = (pa.paged_attention.launches, rn.rmsnorm.launches)
        results[device] = {k: v.tolist() for k, v in s.run().items()}
    assert results["cuda"] == results["cpu"]
    assert pa.paged_attention.launches > before[0]
    assert rn.rmsnorm.launches > before[1]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-1.5-large-398b"])
def test_recurrent_scheduler_on_card_matches_cpu(arch):
    """The recurrent families' smoke configs (jamba without experts) served
    on the card (the scan, paged-attention and RMSNorm kernels) give the
    CPU path's tokens at f32, the scan kernel launched once per recurrent
    layer of each exact-length prefill."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from repro_torch.configs.base import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import slstm as sl
    from repro_torch.models.lm import init_lm, layer_specs
    from repro_torch.serve.scheduler import Request, Scheduler

    cfg = replace(get_config(arch, smoke=True), moe=None, dtype="float32")
    counter = sl.slstm_scan if arch == "xlstm-125m" else ms.mamba_scan
    per_prefill = sum(s.kind in "Ms" for s in layer_specs(cfg))
    cpu_model = init_lm(cfg, device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 20)]
    results = {}
    for device in ("cpu", "cuda"):
        model = init_lm(cfg, device=device)
        model.load_state_dict(cpu_model.state_dict())
        s = Scheduler(cfg, model, num_slots=2, max_len=28, block_size=4,
                      device=device)
        for i, p in enumerate(prompts):
            s.submit(Request(rid=i, prompt=p, max_new=5))
        before = counter.launches
        results[device] = {k: v.tolist() for k, v in s.run().items()}
    assert results["cuda"] == results["cpu"]
    assert counter.launches - before == len(prompts) * per_prefill
