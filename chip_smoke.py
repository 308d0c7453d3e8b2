#!/usr/bin/env python3
"""Smoke test of deepspeed_tpu_torch on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It builds the CUDA
kernels from ``deepspeed_tpu_torch/csrc`` with nvcc, holds each kernel
against its plain PyTorch version on the card and times both, then serves
8 requests with ``InferenceEngineV2`` on Llama-3-8B at full width and depth
(bf16, random weights from a seed), checks that the serving path went
through the kernels, and profiles batched decode steps on the same engine
(``torch.profiler``). Each phase prints one JSON line; the card's name and
power limit (``nvidia-smi``) and the ``kernels`` line come before the last
line, ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without that line, as does a machine with no CUDA device or a directory
without the package. Imports nothing of JAX.
"""

import json
import math
import re
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
BF16_ULPS = 4                      # kernel vs plain: bf16 ulps of max |plain|
LOGITS_TOL = 0.05                  # auto vs gather logits, share of spread
ENGINE_REQUESTS, NEW_TOKENS = 8, 32
PROFILE_STEPS = 8                  # decode steps timed, then profiled


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------
def phase_device():
    check(torch.cuda.is_available(), "no CUDA device; this smoke test runs "
          "on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi: not available"
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit({"phase": "device", **dev, "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return dev, smi_line


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def _demangle(names):
    try:
        res = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=30)
        out = res.stdout.splitlines()
        return out if res.returncode == 0 and len(out) == len(names) else names
    except OSError:
        return names


def phase_build(kernels):
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.paged_attention import dynamic_smem_bytes
    t0 = time.monotonic()
    results = build.build(kernels)
    info = {}
    for name, res in results.items():
        entries, regs, spills = [], [], []
        for line in res.log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entries.append(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(int(m.group(1)))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spills.append(int(m.group(1)))
        info[name] = {"nvcc_s": round(res.seconds, 3),
                      "entries": [{"kernel": k, "registers": r, "spill_stores": s}
                                  for k, r, s in zip(_demangle(entries), regs,
                                                     spills)]}
    smem = {f"d{d}_rows{rows}": dynamic_smem_bytes(d, rows)
            for d in (64, 128) for rows in (8, 32)}
    emit({"phase": "build", "wall_s": round(time.monotonic() - t0, 3),
          "kernels": info, "paged_attention_dynamic_smem_bytes": smem})


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain on the card
# ---------------------------------------------------------------------------
def _paged_inputs(gen, b, t, ctx, start, fp8=False, ragged=False, hkv=8,
                  rep=4, d=128, bs=64):
    """Seeded kernel inputs on the card; ``ragged`` draws each sequence's
    start in [0, ctx - t] instead of ``start``."""
    dev = "cuda"
    mb = -(-ctx // bs)
    nb = b * mb + 1
    q = torch.randn(b, t, hkv * rep, d, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(hkv, nb, bs, d, generator=gen, device=dev)
    v = torch.randn(hkv, nb, bs, d, generator=gen, device=dev)
    kw = {}
    if fp8:
        ks = torch.rand(hkv, nb, generator=gen, device=dev) + 0.5
        vs = torch.rand(hkv, nb, generator=gen, device=dev) + 0.5
        k = (k / ks[..., None, None]).to(torch.float8_e4m3fn)
        v = (v / vs[..., None, None]).to(torch.float8_e4m3fn)
        kw = {"k_scales": ks, "v_scales": vs}
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    tables = torch.randperm(nb - 1, generator=gen, device=dev)[:b * mb]
    tables = tables.reshape(b, mb).to(torch.int32)
    start_pos = torch.full((b,), start, dtype=torch.int32, device=dev)
    if ragged:
        start_pos = torch.randint(0, ctx - t + 1, (b,), generator=gen,
                                  device=dev).to(torch.int32)
    return (q, k, v, tables, start_pos), kw


def _bf16_tol(want):
    """BF16_ULPS bf16 ulps at the largest |value| of the plain output."""
    top = want.float().abs().max().item()
    return BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0


def _bound_ms(args, start):
    """Least time for one call at these inputs: each live KV byte, q, out
    and the tables read or written once, against the operations of QK^T and
    PV over the live (causal) keys at the bf16 peak."""
    q, k, _, tables, start_pos = args
    b, t, h, d = q.shape
    hkv = k.shape[0]
    ctx = start + t                                  # keys any row sees
    live_pairs = t * start + t * (t + 1) // 2        # (row, key) pairs
    kv_bytes = 2 * b * ctx * hkv * d * k.element_size()
    nbytes = kv_bytes + 2 * q.numel() * q.element_size() + \
        tables.numel() * 4 + start_pos.numel() * 4
    flops = 4 * b * h * live_pairs * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _library_ms(args, ctx):
    """One F.scaled_dot_product_attention over the gathered context (causal
    when the chunk starts at 0): a yardstick only, the port never calls
    it."""
    import torch.nn.functional as F
    q, k, v, tables, start = args
    b, t, _, d = q.shape
    hkv = k.shape[0]

    def gather(pages):
        return pages[:, tables.long()].permute(1, 0, 2, 3, 4).reshape(
            b, hkv, -1, d)[:, :, :ctx].contiguous()
    kc, vc = gather(k), gather(v)
    qs = q.transpose(1, 2).contiguous()                  # [B, H, T, d]
    return time_ms(lambda: F.scaled_dot_product_attention(
        qs, kc, vc, is_causal=t > 1, enable_gqa=True), iters=50)


def phase_kernel_parity():
    from deepspeed_tpu_torch.ops.paged_attention import (paged_attention,
                                                         paged_attention_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    # Each mutant is the plain version with one thing a faulty kernel could
    # get wrong; it must land farther from the plain output than the case's
    # tolerance, or the case could not tell that fault from a right kernel.
    def mask_off_by_one(args, kw):
        q, k, v, tables, start = args
        return (q, k, v, tables, start + 1), kw

    def without(key):
        return lambda args, kw: (args, {**kw, key: None})

    def unscaled(args, kw):
        return args, {**kw, "k_scales": torch.ones_like(kw["k_scales"]),
                      "v_scales": torch.ones_like(kw["v_scales"])}

    decode = dict(b=16, t=1, ctx=2048, start=2047)
    cases = [
        ("decode", decode, {}, None),
        ("prefill_chunk", dict(b=1, t=512, ctx=512, start=0), {},
         mask_off_by_one),
        ("continued_chunk", dict(b=1, t=256, ctx=512, start=256), {},
         mask_off_by_one),
        ("decode_ragged", {**decode, "ragged": True}, {}, mask_off_by_one),
        ("decode_window", decode, {"window": 1024}, without("window")),
        ("decode_softcap", decode, {"softcap": 5.0}, without("softcap")),
        ("decode_fp8", {**decode, "fp8": True}, {}, unscaled),
    ]
    worst = 0.0
    timing = None
    for name, shape, opts, mutant in cases:
        args, kw = _paged_inputs(gen, **shape)
        kw.update(opts)
        got = paged_attention(*args, **kw)
        torch.cuda.synchronize()
        want = paged_attention_plain(*args, **kw)
        err = (got.float() - want.float()).abs().max().item()
        tol = _bf16_tol(want)
        finite = bool(torch.isfinite(got).all())
        row = {"phase": "kernel_parity", "case": name, "max_abs_err": err,
               "tol": tol, "max_abs_plain": want.float().abs().max().item(),
               "finite": finite}
        if mutant is not None:
            m_args, m_kw = mutant(args, kw)
            row["mutant_err"] = (paged_attention_plain(*m_args, **m_kw).float()
                                 - want.float()).abs().max().item()
        emit(row)
        check(finite and err <= tol,
              f"paged_attention {name}: max_abs_err {err} > {tol}")
        check(row.get("mutant_err", math.inf) > tol,
              f"paged_attention {name}: its mutant is within {tol} of the "
              f"plain output, so the case cannot catch that fault")
        worst = max(worst, err)
        if name in ("decode", "prefill_chunk"):
            kernel_ms = time_ms(lambda: paged_attention(*args, **kw), iters=100)
            plain_ms = time_ms(lambda: paged_attention_plain(*args, **kw), iters=10)
            library_ms = _library_ms(args, shape["ctx"])
            bound_ms, bound_by = _bound_ms(args, shape["start"])
            times = {"ms": kernel_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
            emit({"phase": "kernel_timing", "kernel": "paged_attention",
                  "case": name, "shape": shape,
                  "heads": "H=32 Hkv=8 d=128 bs=64 bf16", **times,
                  "share_of_bound": bound_ms / kernel_ms})
            if name == "decode":              # the kernels line's numbers
                timing = times
        del args, kw, got, want
    return worst, timing


# ---------------------------------------------------------------------------
# phase 4: the serving path
# ---------------------------------------------------------------------------
def run_engine(cfg, device, kv_num_blocks, prompt_lens, new_tokens,
               prefill_buckets=(128, 256, 512), seed=SEED):
    """Serve ``len(prompt_lens)`` seeded requests admitted together through
    ``InferenceEngineV2`` (greedy), each to ``new_tokens`` tokens. Returns
    the engine, the prompts, per-request outputs and the run's numbers."""
    from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2,
                                                            V2EngineConfig)
    from deepspeed_tpu_torch.inference.v2.scheduler import SchedulerConfig
    from deepspeed_tpu_torch.models.convert import init_llama_params
    from deepspeed_tpu_torch.ops import build

    params = init_llama_params(cfg, seed=seed, device=device)
    eng = InferenceEngineV2(params, cfg, V2EngineConfig(
        kv_block_size=64, kv_num_blocks=kv_num_blocks,
        scheduler=SchedulerConfig(max_tokens_per_step=2048,
                                  prefill_buckets=prefill_buckets)),
        device=device)
    finite = torch.ones((), dtype=torch.bool, device=device)
    sample = eng._sample_batch

    def checked_sample(logits):          # every logit the run samples from
        finite.logical_and_(torch.isfinite(logits).all())
        return sample(logits)
    eng._sample_batch = checked_sample

    rng = np.random.default_rng(seed)
    eng.generate(rng.integers(0, cfg.vocab_size, 16).tolist(),
                 max_new_tokens=2, uid=10_000)            # warm-up request
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in prompt_lens]
    chunks0 = eng.sched_ledger.chunks_total
    decode_ticks0 = eng.sched_ledger.decode_ticks
    if device.type == "cuda":
        torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.monotonic()
    for uid, p in enumerate(prompts):
        eng.admit(uid, p)
    ttft, decode_s, decode_tokens = {}, 0.0, 0
    while eng.has_work():
        out = eng.step()
        now = time.monotonic()
        decode_s += eng.last_step_timing["decode_s"]
        decode_tokens += eng.last_step_counters["decode_tokens"]
        for uid in out:
            ttft.setdefault(uid, now - t0)
            if len(eng.state.get(uid).generated) >= new_tokens:
                eng.finish(uid)
    outputs = eng.reap_finished()
    wall = time.monotonic() - t0
    launches = build.launch_counts()
    stats = {"requests": len(outputs),
             "tokens": sum(len(v) for v in outputs.values()),
             "wall_s": wall,
             "decode_tokens": decode_tokens,
             "decode_tokens_per_s": decode_tokens / decode_s if decode_s else 0.0,
             "ttft_p50_s": float(np.median(list(ttft.values()))),
             "prefill_chunks": eng.sched_ledger.chunks_total - chunks0,
             "decode_steps": eng.sched_ledger.decode_ticks - decode_ticks0,
             "launches": launches,
             "logits_finite": bool(finite.item())}
    return eng, prompts, outputs, stats


def prefill_decode_logits(eng, tokens, attn_impl):
    """Last-token logits of one prefill chunk on a fresh small cache, then
    of one decode step that feeds back the prefill's greedy token."""
    from deepspeed_tpu_torch.inference.v2.generic_decode import (
        decode_step_g, prefill_chunk_g)
    from deepspeed_tpu_torch.inference.v2.kv_cache import (BlockedKVCache,
                                                           KVCacheConfig)
    spec = eng.policy.cache_spec(eng.model_config)
    dev, bs = eng.device, 64
    n_blocks = -(-(len(tokens) + 1) // bs)
    kv = BlockedKVCache(KVCacheConfig(
        num_layers=spec.num_layers, num_kv_heads=spec.num_kv_heads,
        head_dim=spec.head_dim, block_size=bs, num_blocks=n_blocks + 1,
        dtype=spec.dtype), dev)
    bucket = -(-len(tokens) // 128) * 128
    padded = torch.zeros(bucket, dtype=torch.int32)
    padded[:len(tokens)] = torch.tensor(tokens, dtype=torch.int32)
    table = torch.arange(n_blocks, dtype=torch.int32, device=dev)
    kw = dict(policy=eng.policy, cfg=eng.model_config, block_size=bs,
              attn_impl=attn_impl)
    prefill, _ = prefill_chunk_g(eng.params, kv.data, padded.to(dev), 0,
                                 table, len(tokens), **kw)
    decode, _ = decode_step_g(
        eng.params, kv.data, prefill.argmax().to(torch.int32).reshape(1),
        torch.tensor([len(tokens)], dtype=torch.int32, device=dev),
        table[None], torch.ones(1, dtype=torch.bool, device=dev), **kw)
    return prefill.float(), decode[0].float()


def phase_engine(dev, smi_line):
    from deepspeed_tpu_torch.models.llama import LLAMA3_8B
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(SEED + 1)
    lens = rng.integers(100, 501, ENGINE_REQUESTS)
    eng, prompts, outputs, st = run_engine(
        LLAMA3_8B, torch.device("cuda"), kv_num_blocks=1024, prompt_lens=lens,
        new_tokens=NEW_TOKENS)
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "engine", "model": "LLAMA3_8B bf16 (32 layers, full width)",
          "requests": st["requests"], "tokens_generated": st["tokens"],
          "wall_s": st["wall_s"], "decode_tokens": st["decode_tokens"],
          "decode_tokens_per_s": st["decode_tokens_per_s"],
          "ttft_p50_s": st["ttft_p50_s"], "prefill_chunks": st["prefill_chunks"],
          "decode_steps": st["decode_steps"], "launches": st["launches"],
          "max_memory_allocated": peak, "card": dev["kind"],
          "nvidia_smi": smi_line, "prompt_lens": [int(n) for n in lens]})
    check(st["requests"] == ENGINE_REQUESTS, f"served {st['requests']} requests")
    check(all(len(v) == NEW_TOKENS for v in outputs.values()),
          "a request did not produce all its tokens")
    check(st["logits_finite"], "non-finite logits")
    want = 32 * (st["prefill_chunks"] + st["decode_steps"])
    got = st["launches"].get("paged_attention", 0)
    check(got >= want, f"paged_attention launched {got} times, expected "
          f">= {want} (32 layers x (chunks + decode steps))")

    auto = prefill_decode_logits(eng, prompts[0], "auto")
    gather = prefill_decode_logits(eng, prompts[0], "gather")
    for step, a, g in zip(("prefill", "decode"), auto, gather):
        spread = (g.max() - g.min()).item()
        err = (a - g).abs().max().item()
        finite = bool(torch.isfinite(a).all())
        emit({"phase": "engine_vs_gather", "step": step,
              "prompt_len": len(prompts[0]), "max_abs_err": err,
              "spread": spread, "tol": LOGITS_TOL * spread,
              "same_argmax": int(a.argmax()) == int(g.argmax()),
              "finite": finite})
        check(finite and err <= LOGITS_TOL * spread,
              f"auto vs gather {step} logits differ by {err} (spread {spread})")
    return st, eng, lens


# ---------------------------------------------------------------------------
# phase 5: where a decode step's time goes
# ---------------------------------------------------------------------------
def _top(events, device_type, key, n=15):
    rows = sorted((e for e in events if e.device_type == device_type),
                  key=lambda e: getattr(e, key), reverse=True)[:n]
    return [{"name": e.key[:90], "count": e.count,
             "total_ms": getattr(e, key) / 1e3} for e in rows]


def phase_profile(eng, lens, dev, smi_line):
    """Admit ``len(lens)`` fresh seeded prompts of the engine phase's
    lengths to its engine, prefill them, then time PROFILE_STEPS batched
    decode steps on the host clock, and as many again under
    ``torch.profiler``: device busy time per step (the summed kernel
    durations; the engine runs on one stream), idle share, kernels per step,
    top kernels and top host ops."""
    rng = np.random.default_rng(SEED + 2)
    for i, n in enumerate(lens):
        eng.admit(20_000 + i, rng.integers(0, eng.model_config.vocab_size,
                                           int(n)).tolist())
    while eng.state.prefilling():
        eng.step()
    for _ in range(3):                                   # warm decode steps
        eng.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(PROFILE_STEPS):
        eng.step()                     # ends in the [B] sampled-id readback
    host_ms = (time.monotonic() - t0) * 1e3 / PROFILE_STEPS

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        for _ in range(PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        window_ms = (time.monotonic() - t0) * 1e3
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernels = [e for e in prof.events() if e.device_type == cuda]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    events = prof.key_averages()
    emit({"phase": "profile", "batch": len(eng.state.decoding()),
          "steps": PROFILE_STEPS, "step_ms": host_ms,
          "step_ms_profiled": window_ms / PROFILE_STEPS,
          "device_busy_ms_per_step": busy_ms / PROFILE_STEPS,
          "device_idle_share": 1.0 - busy_ms / window_ms,
          "kernels_per_step": len(kernels) / PROFILE_STEPS,
          "card": dev["kind"], "nvidia_smi": smi_line,
          "top_device": _top(events, cuda, "self_device_time_total"),
          "top_host": _top(events, cpu, "self_cpu_time_total")})
    check(kernels, "the profiler saw no kernel on the card")


def main() -> int:
    phase = "device"
    try:
        dev, smi_line = phase_device()
        phase = "import"
        import deepspeed_tpu_torch  # noqa: F401  (the package of this repo)
        torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 stays fp32
        torch.backends.cudnn.allow_tf32 = False
        phase = "build"
        phase_build(["paged_attention"])
        phase = "kernel_parity"
        worst, timing = phase_kernel_parity()
        phase = "engine"
        st, eng, lens = phase_engine(dev, smi_line)
        phase = "profile"
        phase_profile(eng, lens, dev, smi_line)
    except Exception as exc:  # any failed phase: report it, exit non-zero
        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(exc).__name__}: {exc}"})
        return 1
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/paged_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:35",
        "tpu": "ops/pallas/paged_attention.py:_paged_kernel",
        "launches": st["launches"].get("paged_attention", 0),
        "max_abs_err": worst, "ok": True, **timing}]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": dev})
    return 0


if __name__ == "__main__":
    sys.exit(main())
