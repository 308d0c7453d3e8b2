#!/usr/bin/env python3
"""Smoke test of deepspeed_tpu_torch on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py``. It builds the CUDA
kernels from ``deepspeed_tpu_torch/csrc`` with nvcc (and checks that the bf16
flash forward, dQ and dK/dV entries hold tensor-core products and TMA loads
in their SASS, the bf16 evoformer forward, dQ, dK/dV and dbias2 and the
block-sparse entries ``mma.sync`` products and ``cp.async`` loads, and the
fp8 dequantize and the bf16 8-column dropout entries 128-bit loads and
stores, the latter with no spills), holds each kernel against its
plain PyTorch version on the card (the flash backward, the paged kernel and
the bf16 evoformer forward and block-sparse kernel also against a second
call, bit for bit) and times both, then drives the port's paths:

- serving: 8 requests through ``InferenceEngineV2`` on Llama-3-8B at full
  width and depth (bf16, random weights from a seed), with a check that the
  path went through the paged-attention kernel and a profile of batched
  decode steps (``torch.profiler``); then the same engine behind
  ``InferenceServer`` and its HTTP front door: one request alone, the 8
  prompts from 8 client threads (latencies, launches, ``/healthz``,
  ``/metrics``), a ``bench_serve`` scenario with its conservation checks,
  drain to an empty KV ledger, the lone request again bit for bit, a host
  KV tier drill, and the card's idle share of a served window, with no
  step fault, quarantine or sticky 503 anywhere; then the prefill/decode
  role split over the same weights (``DisaggregatedEngine`` behind the
  server: full-width handoffs give the single engine's greedy tokens bit
  for bit, int8 handoffs land as the host round trip within its bound,
  one 512-token handoff timed part by part), two replicas behind
  ``FleetRouter`` (prefix affinity, router vs replica latency stitched by
  ``reqtrace``, a retirement whose int8 prefix handoff the successor
  serves as hits) and the fleet's chaos drill over two ``fleet_worker``
  processes on the card (a replica killed mid-decode, no request lost,
  the relaunch back in rotation); then MoE serving (``serve_moe``):
  Qwen1.5-MoE-A2.7B at full width and depth and Mixtral-8x7B at full width
  cut to 16 layers, the same 8 requests through ``MixtralPolicy`` /
  ``Qwen2MoEPolicy`` and the paged kernel, auto against gather, layer 0's
  gating on the card against the CPU's bit for bit;
- quantization kernels: int8 and fp8 (e4m3, e5m2) quantize and dequantize
  held bit for bit against their plain versions over seeded and
  constructed rows (zeros, exact ties, an absmax that scales onto the
  format's maximum or, for int8, a hair above it, a last-element maximum,
  a row where the reciprocal's product differs from the quotient), with
  the faults they expose as mutants, then timed at the path shapes;
- ZeRO-Inference: Llama-3-8B at full depth with fp8 e4m3 weights (A1),
  resident and streamed from pinned host memory, and the int8 store at 4
  layers (A2): exact quantize/dequantize launch counts, every weight within
  its group's error bound, resident vs streamed logits, generation, and
  A1's whole-store dequantization timed;
- training: ``deepspeed_tpu_torch.initialize`` -> ``train_batch`` on
  Llama-3-8B at full width cut to 4 layers (bf16, seq 2048, micro-batch 1,
  gas 2, AdamW, remat, the flash backend), with the flash backend held
  against the plain one on one micro-batch (loss, gradient norm and each
  attention weight's gradient), 1 + 4 steps whose loss must fall, exact
  flash-kernel launch counts per step, a profiled step, a probe that
  reruns the steps at a tenth of the lr (the loss must fall at every step)
  and with the plain attention backend, and the same lr with qgZ
  (``zero_quantized_gradients``): exact int8 launches per step, a loss that
  falls every step, the step-1 gradient norm beside the probe's;
- distribution: the recipe at ZeRO stages 1, 2 and 3 on one rank over NCCL
  (``init_distributed``), bit for bit with stage 0; then two processes on
  the card over gloo (spawned by ``testing.run_distributed``): stage 3 and
  stage 2 at fsdp=2 within twice the distance of two stage-0 runs that
  differ only in summation order, each rank's state, peak HBM and comm
  bytes; and qgZ at data=2 (the int8 wire through ``quantized_all_reduce``)
  with exact quantize/dequantize launches, step 1's synced gradients bit
  for bit against the plain codec, and the six quantized collectives at
  two ranks bit for bit against their plain versions;
- MoE training: Mixtral-8x7B at full width cut to 2 layers with the
  recipe on one rank (``train_moe``: exact flash launches, layer 0's
  gating on the card against the CPU's bit for bit, the aux and z losses,
  the choices dropped at capacity), then at ``expert=2`` on two gloo
  processes (``train_moe_ranks``): against the one-rank run step by step,
  replicated masters the same bytes on both ranks, half the expert state
  a rank, the exchanges' bytes against the count from the shapes, and the
  int8 combine (``quantized_dispatch``) with exact launches and step 1's
  combine bit for bit the plain codec's;
- evoformer attention: the five kernels against their plain versions in 15
  cases (fp32 and bf16, head dims 8 to 128, every bias combination, Lq !=
  Lk, groups of MSA rows with N not a multiple of the group) with mutants,
  every entry by profiler name per dtype, then
  ``DS4Sci_EvoformerAttention`` forward and backward at OpenFold's widths
  (E1 MSA row attention with pair bias, E2 MSA column, E3 triangle, E4
  extra-MSA row) with exact launch counts, held against the chunked plain
  versions, and the kernels timed at E1 (the forward at E4 too) beside
  SDPA;
- slice 5: the RMSNorm kernel (7 cases), the four fused bias + activation
  (+ dropout) kernels (13 cases, every activation, both column paths,
  dropout masks bit for bit, a second backward bit for bit)
  and the block-sparse attention kernel (13 cases, blocks 16 to 128, head
  dims 32 to 128, causal and per-head layouts, groups mixing empty and live
  query blocks) against their plain versions with mutants and its entry by
  profiler name per dtype; then the paths: ``SparseSelfAttention`` forward and backward
  at BigBird-base (S1) and the Fixed pattern (S2), 4096 tokens; ``rms_norm``
  at Llama-3-8B's width (R); ``fused_bias_act`` and
  ``fused_bias_act_dropout`` at BERT-base's FFN (F); exact launch counts,
  every output and gradient held against the plain versions, and the six
  kernels timed by the profiler's device time beside their bounds, plain
  versions and library calls;
- the memory tiers (the host sources ``csrc/cpu_adam.cpp`` and
  ``csrc/aio.cpp`` built by g++ in the build phase): Llama-3-8B with
  ``offload_optimizer`` cpu, then ``bench.py``'s 8b tiers (``offload_param``
  cpu, 4 layers a group, with ``offload_optimizer`` cpu), each at all 32
  layers or the deepest depth whose host state fits MemAvailable with a
  25% margin (the cut and the reading on their own line): losses that
  fall, exact flash launches, each step's split (device, device->host,
  host optimizer, host->device; streamed bytes), no fp32 state on the
  card, peak HBM; then at 4 layers the optimizer tier against in-HBM, the
  NVMe tier against the CPU tier bit for bit, and the parameter tier
  against the optimizer tier.

Each phase prints one JSON line; the card's name and power limit
(``nvidia-smi``) and the ``kernels`` line come before the last line,
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero without
that line, as does a machine with no CUDA device or a directory without the
package. Imports nothing of JAX.
"""

import functools
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
BF16_ULPS = 4                      # kernel vs plain: bf16 ulps of a row's max |plain|
LOGITS_TOL = 0.05                  # auto vs gather logits, share of spread
ENGINE_REQUESTS, NEW_TOKENS = 8, 32
PROFILE_STEPS = 8                  # decode steps timed, then profiled
LSE_TOL = 1e-4                     # flash lse, kernel vs plain (fp32, absolute)
F32_REL = 1e-4                     # float32 flash cases: share of a row's max |plain|
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_GAS = 4, 2048, 2
TRAIN_STEPS = 4                    # timed train_batch steps after 1 warm-up
LOW_LR = 3e-5                      # the probe's lr, a tenth of the recipe's
# flash vs plain backend on one micro-batch, relative: loss, global gradient
# norm, worst attention-weight gradient (2.7e-5, 5.0e-5 and 0.026 on the
# H100 80GB HBM3 at 700 W, PERF.md)
LOSS_REL, GRAD_NORM_REL, ATTN_GRAD_REL = 1e-4, 1e-3, 0.05
FLASH_PER_STEP = {"flash_fwd": 2, "flash_dq": 1, "flash_dkv": 1}  # per layer x micro


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def host_us(fn, iters: int = 200, warmup: int = 3) -> float:
    """Host time of one call of ``fn`` in microseconds: the wall time of
    ``iters`` back-to-back calls with no synchronize among them, over
    ``iters``. The card runs behind the host and its time is not in it
    while the launch queue has room."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


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


# the redesigned entries of each library (label: library, entry stems,
# the SASS instructions each must hold, how many instances there are):
# HGMMA (wgmma) and UTMALDG (a TMA tile load) in the flash library; HMMA
# (mma.sync) and LDGSTS (cp.async) in the evoformer forward, dQ and dK/dV
# (5 head dims, with and without a pair bias each), its dbias2 and dbias1
# (5 head dims each) and the block-sparse kernel (3 head dims x 4 blocks);
# 128-bit global loads and stores in the fp8 dequantize (2 formats x 3
# output dtypes); in the int8 quantize, 128-bit global loads in the warp
# and block kernels and 128-bit `cp.async` copies in the cluster kernel (3
# input dtypes x 3 warp, 6 block and 3 cluster instances; its stores write
# a chunk's 4 or 8 codes, consecutive across the warp); 128-bit global
# loads and stores in the bf16 8-column entries of the four bias_act
# kernels (4 activations each), none of whose 80 entries may spill.
# Ops are regular expressions searched in each SASS line.
FLASH_HEAD_DIMS = (64, 128)
SASS_CHECKS = {
    "flash_attention": ("flash_attention",
                        ("flash_fwd_kernel_wgmma", "flash_dq_kernel_wgmma",
                         "flash_dkv_kernel_wgmma"), ("HGMMA", "UTMALDG"),
                        3 * len(FLASH_HEAD_DIMS)),
    "evoformer": ("evoformer",
                  ("evo_fwd_kernel_mma", "evo_dq_kernel_mma",
                   "evo_dkv_kernel_mma", "evo_dbias2_kernel_mma",
                   "evo_dbias1_kernel_mma"), ("HMMA", "LDGSTS"), 40),
    "sparse_attention": ("sparse_attention", ("sparse_attention_kernel_mma",),
                         ("HMMA", "LDGSTS"), 12),
    "quant": ("quant", ("dequantize_fp8",), ("LDG.E.128", "STG.E.128"), 6),
    "quant_int8_regs": ("quant", ("quantize_int8_warp", "quantize_int8_block"),
                        (r"LDG\.E\.128",), 27),
    "quant_int8_cluster": ("quant", ("quantize_int8_cluster",),
                           (r"LDGSTS\S*\.128",), 9),
    "fused_bias_act": ("fused_bias_act",
                       tuple(f"{k}_kernelI13__nv_bfloat16Li8ELb1E"
                             for k in ("bias_act", "bias_act_bwd", "bias_act_dropout",
                                       "bias_act_dropout_bwd")),
                       (r"LDG\.E\.128", r"STG\.E\.128"), 16),
}
# (n, d) the bias_act launch plan of ops/fused_bias_act.py is held against
# the library's at, for each kind, activation, dtype and operand address
# offset (0, 2, 4, 8 bytes): BERT-base's FFN, widths a multiple of 4 but
# not 8, odd, narrow and Llama-3-8B's, one row
BIAS_ACT_PLAN_SHAPES = ((8192, 3072), (1000, 3076), (1003, 1001), (140001, 6),
                        (513, 4096), (1, 3072), (7, 2048), (5, 24), (3, 520))
# (n, d, first row, input dtype) the int8 quantize plan of ops/quant.py is
# held against the library's at: qgZ's four widths, odd widths, views one
# row in, bf16 input
QUANT_PLAN_CHECKS = [(n, d, r, dt) for n, d in ((64, 128), (8, 4096),
                                                 (4, 14336), (2, 128256),
                                                 (16, 130), (8, 1000), (3, 5))
                     for r in (0, 1) for dt in (torch.float32, torch.bfloat16)]


def _sass_counts(library, entries, ops):
    """{demangled entry: {op: count}} of ``ops`` in each entry of
    ``library`` whose name holds one of ``entries`` (``cuobjdump
    --dump-sass``, from nvcc's folder)."""
    import os
    from deepspeed_tpu_torch.ops import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    res = subprocess.run([tool, "--dump-sass", str(library)],
                         capture_output=True, text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-400:]}")
    counts, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in entries) else None
            if cur:
                counts[cur] = dict.fromkeys(ops, 0)
            continue
        if cur:
            for op in ops:
                counts[cur][op] += re.search(op, line) is not None
    names = _demangle(list(counts))
    return {n: c for n, c in zip(names, counts.values())}


def phase_build(kernels):
    from deepspeed_tpu_torch.ops import build, evoformer, flash_attention
    from deepspeed_tpu_torch.ops.paged_attention import dynamic_smem_bytes
    kv_dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16,
                 "fp8": torch.float8_e4m3fn}
    from deepspeed_tpu_torch.ops.sparse_attention import attention as sparse
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
                      "compiler": "g++" if name in HOST_SOURCES else "nvcc",
                      "entries": [{"kernel": k, "registers": r, "spill_stores": s}
                                  for k, r, s in zip(_demangle(entries), regs,
                                                     spills)]}
    sass = {label: _sass_counts(results[lib].path, entries, ops)
            for label, (lib, entries, ops, _) in SASS_CHECKS.items()}
    smem = {f"d{d}_rows{rows}_{name}": dynamic_smem_bytes(d, rows, dt)
            for d in (32, 64, 128) for rows in (4, 8, 32)
            for name, dt in kv_dtypes.items()}
    emit({"phase": "build", "wall_s": round(time.monotonic() - t0, 3),
          "kernels": info, "paged_attention_dynamic_smem_bytes": smem,
          "flash_dynamic_smem_bytes": {
              f"d{d}": flash_attention.dynamic_smem_bytes(d)
              for d in FLASH_HEAD_DIMS},
          "flash_sass": sass["flash_attention"],
          "evo_dynamic_smem_bytes": {
              f"d{d}": evoformer.dynamic_smem_bytes(d)
              for d in evoformer.HEAD_DIMS},
          "quant_sass": sass["quant"],
          "quant_int8_sass": {**sass["quant_int8_regs"], **sass["quant_int8_cluster"]},
          "quant_int8_ptxas": {
              e["kernel"]: {"registers": e["registers"],
                            "spill_stores": e["spill_stores"]}
              for e in info["quant"]["entries"] if "quantize_int8" in e["kernel"]},
          "bias_act_sass": sass["fused_bias_act"],
          "bias_act_plans_checked": _check_bias_act_plans(),
          "sparse_dynamic_smem_bytes": {
              f"d{d}_block{blk}": sparse.dynamic_smem_bytes(d, blk)
              for d in sparse.HEAD_DIMS for blk in sparse.BLOCKS}})
    def ptxas(lib, stem):
        return {e["kernel"]: {"registers": e["registers"],
                              "spill_stores": e["spill_stores"]}
                for e in info[lib]["entries"] if stem in e["kernel"]}
    emit({"phase": "build_wgmma", "ptxas": ptxas("flash_attention", "_wgmma"),
          "sass": sass["flash_attention"]})
    plans = {f"d{d}_{'pair' if pair else 'no_pair'}": evoformer.evo_fwd_plan(d, pair)
             for d in evoformer.HEAD_DIMS for pair in (True, False)}
    bwd_plans = {f"d{d}_{'pair' if pair else 'no_pair'}": evoformer.evo_bwd_plan(d, pair)
                 for d in evoformer.HEAD_DIMS for pair in (True, False)}
    emit({"phase": "build_mma",
          "ptxas": {**ptxas("evoformer", "_mma"),
                    **ptxas("sparse_attention", "_mma")},
          "sass": {lib: sass[lib] for lib in ("evoformer", "sparse_attention")},
          "evo_fwd_plan": plans, "evo_bwd_plan": bwd_plans,
          "evo_dbias2_blocks_per_sm": {
              f"d{d}": evoformer.dbias2_blocks_per_sm(torch.device("cuda"), d)
              for d in evoformer.HEAD_DIMS}})
    for label, (lib, entries, ops, count) in SASS_CHECKS.items():
        check(len(sass[label]) == count, f"{label}: expected {count} "
              f"redesigned entries, found {list(sass[label])}")
        for entry, n in sass[label].items():
            check(all(n[op] > 0 for op in ops),
                  f"{entry}: {n} (an instruction of {ops} missing)")
    _check_quant_plans()
    for e in info["fused_bias_act"]["entries"]:
        check(e["spill_stores"] == 0, f"{e['kernel']}: {e['spill_stores']} "
              "bytes of spill stores")
    for d in evoformer.HEAD_DIMS:
        lib_smem = evoformer.dynamic_smem_bytes(d)
        for pair, key in ((True, "evo_fwd_mma_pair"), (False, "evo_fwd_mma")):
            want = evoformer.evo_fwd_plan(d, pair)["smem_bytes"]
            check(lib_smem[key] == want, f"evo_fwd_plan({d}, {pair}) says "
                  f"{want} bytes of shared memory, the kernel {lib_smem[key]}")
        for pair, kernel, key in ((True, "dq", "evo_dq_mma_pair"),
                                  (False, "dq", "evo_dq_mma"),
                                  (True, "dkv", "evo_dkv_mma_pair"),
                                  (False, "dkv", "evo_dkv_mma"),
                                  (True, "dbias2", "evo_dbias2_mma"),
                                  (True, "dbias1", "evo_dbias1_mma_pair"),
                                  (False, "dbias1", "evo_dbias1_mma")):
            want = evoformer.evo_bwd_plan(d, pair)[kernel]["smem_bytes"]
            check(lib_smem[key] == want, f"evo_bwd_plan({d}, {pair}) says "
                  f"{want} bytes of shared memory for {kernel}, the kernel "
                  f"{lib_smem[key]}")
    return info


def _check_quant_plans():
    """ops/quant.py's ``quant_plan`` equals the library's at every
    QUANT_PLAN_CHECKS case, on real tensors' addresses (a view one row in
    where the first row is 1)."""
    from deepspeed_tpu_torch.ops.quant import quant_plan, quant_plan_of_library
    for n, d, first, dtype in QUANT_PLAN_CHECKS:
        x = torch.empty(n + first, d, dtype=dtype, device="cuda")[first:]
        q = torch.empty(n, d, dtype=torch.int8, device="cuda")
        lib = quant_plan_of_library(x.data_ptr(), q.data_ptr(), n, d, dtype)
        mine = quant_plan(n, d, x.data_ptr() % 16, q.data_ptr() % 16,
                          x.element_size())
        check(lib == mine, f"quant_plan({n}, {d}, row {first}, {dtype}): "
              f"ops/quant.py says {mine}, the library {lib}")


def _check_bias_act_plans():
    """ops/fused_bias_act.py's ``launch_plan`` equals the library's at
    every BIAS_ACT_PLAN_SHAPES case, kind, activation, dtype and address
    offset, on this card's SM count; returns the cases checked."""
    from deepspeed_tpu_torch.ops.fused_bias_act import (launch_plan,
                                                        launch_plan_of_library)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = 0
    for (n, d), kind, act, dtype, off in itertools.product(
            BIAS_ACT_PLAN_SHAPES, range(4), range(4),
            (torch.float32, torch.bfloat16), (0, 2, 4, 8)):
        lib = launch_plan_of_library(kind, act, n, d, dtype, 4096 + off, sms)
        mine = launch_plan(kind, act, n, d, dtype, off, sms)
        check(lib == mine, f"bias_act plan ({kind}, {act}, {n}, {d}, {dtype}, "
              f"address offset {off}): ops says {mine}, the library {lib}")
        cases += 1
    return cases


def _build_of(info, source, kernel):
    """(nvcc seconds of ``source``, most registers of its entries named
    ``kernel``) from phase_build's info."""
    regs = [e["registers"] for e in info[source]["entries"]
            if re.search(rf"(?<![A-Za-z_]){kernel}", e["kernel"])]
    return info[source]["nvcc_s"], max(regs) if regs else None


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain on the card
# ---------------------------------------------------------------------------
def _paged_inputs(gen, b, t, ctx, start, fp8=False, ragged=False, hkv=8,
                  rep=4, d=128, bs=64, dtype=torch.bfloat16):
    """Seeded kernel inputs on the card; ``ragged`` draws each sequence's
    start in [0, ctx - t] instead of ``start``, which may also be a list of
    per-sequence starts."""
    dev = "cuda"
    mb = -(-ctx // bs)
    nb = b * mb + 1
    q = torch.randn(b, t, hkv * rep, d, generator=gen, device=dev).to(dtype)
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
        k, v = k.to(dtype), v.to(dtype)
    tables = torch.randperm(nb - 1, generator=gen, device=dev)[:b * mb]
    tables = tables.reshape(b, mb).to(torch.int32)
    start_pos = torch.tensor(start, dtype=torch.int32, device=dev).expand(
        b).contiguous()
    if ragged:
        start_pos = torch.randint(0, ctx - t + 1, (b,), generator=gen,
                                  device=dev).to(torch.int32)
    return (q, k, v, tables, start_pos), kw


def _row_tol(want):
    """Tolerance of each row of a plain output (the last axis is the row):
    BF16_ULPS bf16 ulps of the row's largest |value| for bf16, F32_REL of it
    for float32. A row is one query row of one head (out, dq) or one key
    row of one KV head (dk, dv), so a late row with small values is held to
    its own scale, not to that of row 0 or key 0."""
    top = want.float().abs().amax(-1, keepdim=True)
    if want.dtype == torch.float32:
        return F32_REL * top
    ulp = torch.exp2(torch.floor(torch.log2(top.clamp_min(1e-30))) - 7)
    return torch.where(top > 0, BF16_ULPS * ulp, torch.zeros_like(top))


def _err_ratio(got, want, tol):
    """Largest |got - want| / tol (tol broadcast over the row); a row whose
    tolerance is 0 (all plain values 0) must match exactly, and a
    non-finite difference counts as infinitely far."""
    diff = (got.float() - want.float()).abs()
    diff = torch.where(torch.isfinite(diff), diff, math.inf)
    ratio = torch.where(tol > 0, diff / tol.clamp_min(1e-30),
                        torch.where(diff > 0, math.inf, 0.0))
    return ratio.max().item() if ratio.numel() else 0.0


def _bound_ms(args):
    """Least time for one call at these inputs: each live KV byte, q, out
    and the tables read or written once, against the operations of QK^T and
    PV over the live (causal) keys at the bf16 peak, summed over the
    sequences' own start positions."""
    q, k, _, tables, start_pos = args
    b, t, h, d = q.shape
    hkv = k.shape[0]
    starts = start_pos.long()
    ctx = int((starts + t).sum())                    # keys the rows see, all sequences
    live_pairs = int((t * starts).sum()) + b * t * (t + 1) // 2
    kv_bytes = 2 * ctx * hkv * d * k.element_size()
    nbytes = kv_bytes + 2 * q.numel() * q.element_size() + \
        tables.numel() * 4 + start_pos.numel() * 4
    flops = 4 * h * live_pairs * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _library_ms(args, ctx):
    """Device time of one F.scaled_dot_product_attention over the gathered
    context (causal when the chunk starts at 0): a yardstick only, the port
    never calls it."""
    import torch.nn.functional as F
    q, k, v, tables, start = args
    b, t, _, d = q.shape
    hkv = k.shape[0]

    def gather(pages):
        return pages[:, tables.long()].permute(1, 0, 2, 3, 4).reshape(
            b, hkv, -1, d)[:, :, :ctx].contiguous()
    kc, vc = gather(k), gather(v)
    qs = q.transpose(1, 2).contiguous()                  # [B, H, T, d]
    return _call_device_ms(lambda: F.scaled_dot_product_attention(
        qs, kc, vc, is_causal=t > 1, enable_gqa=True), iters=50)


# forced split counts timed beside the wrapper's own plan, in the decode
# cases of SWEPT_CASES (bf16 B=16, fp8 B=16, the serving batch's B=8)
SPLIT_SWEEP = (1, 2, 3, 4, 8)
SWEPT_CASES = ("decode", "decode_fp8", "decode_serving_batch")


def _plan_of(args):
    """The wrapper's (n_split, tiles_per_split) for these inputs, and the
    blocks of the instantiation that fit on an SM."""
    from deepspeed_tpu_torch.ops import paged_attention as pa
    q, k, _, tables, _ = args
    fold = q.shape[1] * q.shape[2] // k.shape[0]
    per_sm = pa.blocks_per_sm(q.device, q.shape[3], pa.rows_per_block(fold),
                              q.dtype, k.dtype)
    return pa.split_plan(
        q.shape[0], k.shape[0], fold, tables.shape[1] * k.shape[2],
        torch.cuda.get_device_properties(q.device).multi_processor_count,
        per_sm), per_sm


def _split_sweep(args, kw):
    """Kernel device ms with the split count forced to each of SPLIT_SWEEP
    (the wrapper's ``split_plan`` replaced for the call)."""
    from deepspeed_tpu_torch.ops import paged_attention as pa
    q, k, _, tables, _ = args
    n_tiles = -(-tables.shape[1] * k.shape[2] // pa.KEYS_PER_TILE)
    plan, out = pa.split_plan, {}
    try:
        for n in SPLIT_SWEEP:
            per = -(-n_tiles // n)
            pa.split_plan = lambda *_, per=per: (-(-n_tiles // per), per)
            out[str(n)] = _kernel_device_ms(
                lambda: pa.paged_attention(*args, **kw), ["paged_attention"],
                iters=50)["paged_attention"]
    finally:
        pa.split_plan = plan
    return out


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
        # what the split over pages newly risks: the serving batch's
        # decode (B=8, contexts of 1 to 576 keys, three splits of three
        # tiles), sequences whose second split is dead (two splits of 1024
        # keys), a window that kills the first split, fp8 at a context and
        # a span that are not multiples of the split length (23 tiles in
        # four splits of 6, fp8's blocks fitting four to an SM)
        ("decode_serving_batch", dict(b=8, t=1, ctx=576, start=0,
                                      ragged=True), {}, mask_off_by_one),
        ("decode_empty_splits",
         dict(b=16, t=1, ctx=2048,
              start=[0, 1, 62, 63, 64, 100, 447, 448, 449, 895, 1022, 1023,
                     1024, 1025, 2046, 2047]), {}, mask_off_by_one),
        ("decode_window_early_dead", decode, {"window": 300},
         without("window")),
        ("decode_fp8_ragged_span", dict(b=16, t=1, ctx=1450, start=1449,
                                        fp8=True), {}, unscaled),
        # the tiny fp32 serving model (TINY_LLAMA: head_dim 32, 4 heads
        # over 2 KV heads, 16-token blocks) that the fleet drill's workers
        # serve: a prefill chunk and a ragged decode batch
        ("tiny_fp32_d32_prefill", dict(b=1, t=64, ctx=64, start=0, hkv=2,
                                       rep=2, d=32, bs=16,
                                       dtype=torch.float32), {},
         mask_off_by_one),
        ("tiny_fp32_d32_decode", dict(b=8, t=1, ctx=96, start=0,
                                      ragged=True, hkv=2, rep=2, d=32,
                                      bs=16, dtype=torch.float32), {},
         mask_off_by_one),
    ]
    worst = 0.0
    timing = None
    for name, shape, opts, mutant in cases:
        args, kw = _paged_inputs(gen, **shape)
        kw.update(opts)
        got = paged_attention(*args, **kw)
        again = paged_attention(*args, **kw)
        torch.cuda.synchronize()
        repeats = torch.equal(got, again)
        del again
        want = paged_attention_plain(*args, **kw)
        err = (got.float() - want.float()).abs().max().item()
        tol = _row_tol(want)
        ratio = _err_ratio(got, want, tol)
        finite = bool(torch.isfinite(got).all())
        splits, per_sm = _plan_of(args)
        row = {"phase": "kernel_parity", "case": name, "max_abs_err": err,
               "err_over_tol": ratio, "min_row_tol": tol.min().item(),
               "max_row_tol": tol.max().item(), "finite": finite,
               "repeats_bitwise": repeats, "splits": list(splits)}
        if mutant is not None:
            m_args, m_kw = mutant(args, kw)
            row["mutant_over_tol"] = _err_ratio(
                paged_attention_plain(*m_args, **m_kw), want, tol)
        emit(row)
        check(finite and ratio <= 1.0,
              f"paged_attention {name}: error {ratio} times its row tolerance")
        check(repeats, f"paged_attention {name}: a second call gave other bits")
        check(row.get("mutant_over_tol", math.inf) > 1.0,
              f"paged_attention {name}: its mutant is within the row "
              f"tolerance of the plain output, so the case cannot catch that "
              f"fault")
        worst = max(worst, err)
        if name in ("decode", "prefill_chunk", "decode_serving_batch"):
            kernel_ms = _kernel_device_ms(lambda: paged_attention(*args, **kw),
                                          ["paged_attention"],
                                          iters=50)["paged_attention"]
            wrapper_ms = time_ms(lambda: paged_attention(*args, **kw), iters=100)
            wrapper_host_us = host_us(lambda: paged_attention(*args, **kw))
            plain_ms = time_ms(lambda: paged_attention_plain(*args, **kw), iters=10)
            library_ms = _library_ms(args, shape["ctx"])
            bound_ms, bound_by = _bound_ms(args)
            times = {"ms": kernel_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by}
            emit({"phase": "kernel_timing", "kernel": "paged_attention",
                  "case": name, "shape": shape, "splits": list(splits),
                  "heads": "H=32 Hkv=8 d=128 bs=64 bf16", **times,
                  "wrapper_ms": wrapper_ms,
                  "wrapper_host_us": wrapper_host_us,
                  "share_of_bound": bound_ms / kernel_ms,
                  "notes": "ms: profiler device time of the kernel and its "
                           "combine; library_ms: device time of one SDPA "
                           "over the gathered context; wrapper_ms and "
                           "plain_ms: CUDA events over back-to-back calls "
                           "(host work included); wrapper_host_us: host "
                           "time of one wrapper call"})
            if name == "decode":              # the kernels line's numbers
                timing = times
        if name in SWEPT_CASES:
            sweep = _split_sweep(args, kw)
            emit({"phase": "paged_split_sweep", "case": name, "shape": shape,
                  "plan": list(splits),
                  "blocks_per_sm": per_sm,
                  "ms_by_splits": sweep,
                  "notes": "profiler device ms of the kernel and its combine "
                           "with the split count forced; plan: the "
                           "wrapper's (n_split, tiles_per_split)"})
        del args, kw, got, want
    return worst, timing


# ---------------------------------------------------------------------------
# phase 3b: the flash-attention kernels vs their plain mirrors
# ---------------------------------------------------------------------------
def _flash_inputs(gen, b, s, h, hkv, d, dtype, sk=None, seg=False):
    """Seeded (q, k, v, dO) on the card, and [B,S] segment ids when asked."""
    sk = sk or s
    q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dtype)
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
    segs = None
    if seg:
        segs = torch.sort(torch.randint(0, 3, (b, s), generator=gen,
                                        device="cuda"), dim=1).values
    return (q, k, v, do), segs


def _flash_plain_all(args, segs, opts, residuals):
    """(out, lse, dq, dk, dv) of the plain mirrors; the backward runs on
    ``residuals`` (the kernel's own out, lse) so both sides see the same."""
    from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd_plain,
                                                         flash_fwd_plain)
    q, k, v, do = args
    out, lse = flash_fwd_plain(q, k, v, segment_ids=segs, **opts)
    grads = flash_bwd_plain(q, k, v, *residuals, do, segment_ids=segs, **opts)
    return [out, lse, *grads]


FLASH_OUTPUTS = ("out", "lse", "dq", "dk", "dv")


def _dq_one_key_rows(args, segs, opts):
    """([B, Sq, H] bool, [B, Sq, H] fp32): the query rows with exactly one
    live key under the plain mask, and in each a bound on |kernel dQ -
    plain dQ|. Such a row's exact dQ is 0: P = 1 and out = V_j, so dP =
    dO.V_j equals delta = dO.out, and each side's dQ is only its fp32 sum
    dP against the shared delta, times p, scale and K_j. Two fp32 sums of
    the D products dO_d V_jd, in any orders, differ by at most
    2 (D - 1) 2^-24 sum_d |dO_d V_jd|; the roundings of dS and dQ to bf16
    and p's distance from 1 are inside the factor 1 + 2^-5."""
    from deepspeed_tpu_torch.ops.flash_attention import _kernel_mask
    q, k, v, do = args
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    mask = _kernel_mask(q, k, opts.get("causal", True), opts.get("window"),
                        opts.get("causal_shift", 0), segs)[:, 0]
    mask = mask.expand(b, sq, k.shape[1])
    one = (mask.sum(-1) == 1)[..., None].expand(b, sq, h)
    key = mask.int().argmax(-1)[..., None, None].expand(b, sq, hkv, d)
    v_j = torch.gather(v, 1, key).float().repeat_interleave(h // hkv, dim=2)
    k_j = torch.gather(k, 1, key).float().abs().amax(-1).repeat_interleave(
        h // hkv, dim=2)
    dot = (do.float() * v_j).abs().sum(-1)
    bound = (2 * (d - 1) * 2.0 ** -24 * dot / math.sqrt(d) * k_j
             * (1 + 2.0 ** -5))
    return one, torch.where(one, bound, 0.0)


def _one_key_row_count(shape, opts, segs):
    """Query rows x heads with exactly one live key, counted from the
    mask's definition and not from ``_kernel_mask``: row i's live keys are
    the interval of causal (k <= i - causal_shift), window (k > i - W) and
    its segment (sorted ids, so one interval)."""
    b, s, h = shape["b"], shape["s"], shape["h"]
    sk = shape.get("sk") or s
    i = np.arange(s)
    lo, hi = np.zeros(s, dtype=np.int64), np.full(s, sk - 1)
    if opts.get("causal", True) or opts.get("window") is not None:
        hi = np.minimum(hi, i - opts.get("causal_shift", 0))
    if opts.get("window") is not None:
        lo = np.maximum(lo, i - opts["window"] + 1)
    rows = 0
    for bi in range(b):
        first, last = lo, hi
        if segs is not None:
            ids = segs[bi].cpu().numpy()
            first = np.maximum(lo, np.searchsorted(ids, ids, side="left"))
            last = np.minimum(hi, np.searchsorted(ids, ids, side="right") - 1)
        rows += int((last == first).sum())
    return rows * h


def _flash_tols(want, one_key):
    """Tolerance of each output: per row (``_row_tol``), LSE_TOL for lse,
    and in dQ's rows with one live key (``one_key``: the rows and their
    bounds from ``_dq_one_key_rows``) the bound of their rounding."""
    tols = [torch.full_like(w, LSE_TOL) if n == "lse" else _row_tol(w)
            for n, w in zip(FLASH_OUTPUTS, want)]
    one, bound = one_key
    tols[2] = torch.where(one[..., None], bound[..., None], tols[2])
    return tols


def _flash_ratio(got, want, tol, name):
    if name == "lse":                  # rows with no live key sit near -1e30
        live = want > -1e29
        got, want, tol = got[live], want[live], tol[live]
    return _err_ratio(got, want, tol)


def _max_err(got, want, name):
    diff = (got.float() - want.float()).abs()
    if name == "lse":
        diff = diff[want > -1e29]
    return diff.max().item() if diff.numel() else 0.0


# Mutants: the plain mirrors with one fault a kernel could have, built from
# the unchanged plain functions. Each takes (args, segs, opts, residuals,
# want) and returns the five outputs; each must land outside the tolerance
# on every output it names.
def _changed_opts(change):
    return lambda args, segs, opts, res, want: _flash_plain_all(
        args, segs, change(opts), res)


def _off_by_one(opts):
    return {**opts, "causal": True,
            "causal_shift": 1 - opts.get("causal_shift", 0)}


def _segments_dropped(args, segs, opts, res, want):
    return _flash_plain_all(args, None, opts, res)


def _kv_per_query_head(args, res, segs, opts, head_of, fold):
    """The plain mirrors with KV head ``head_of[h]`` expanded for query
    head h (one KV head per query head), dK/dV folded back by ``fold``."""
    q, k, v, do = args
    out, lse, dq, dk, dv = _flash_plain_all(
        (q, k[:, :, head_of].contiguous(), v[:, :, head_of].contiguous(), do),
        segs, opts, res)
    return [out, lse, dq, fold(dk).to(dk.dtype), fold(dv).to(dv.dtype)]


def _kv_head_mod(args, segs, opts, res, want):
    """Query head h reads KV head h % Hkv instead of h // rep."""
    b, _, h, d = args[0].shape
    hkv = args[1].shape[2]
    head_of = torch.arange(h, device=args[0].device) % hkv
    return _kv_per_query_head(      # head h = r * Hkv + g wrote KV head g
        args, res, segs, opts, head_of,
        lambda x: x.float().reshape(b, -1, h // hkv, hkv, d).sum(2))


def _dkv_rep_minus_1(args, segs, opts, res, want):
    """dK/dV sum only rep - 1 of the rep query heads of each KV head."""
    b, _, h, d = args[0].shape
    hkv = args[1].shape[2]
    rep = h // hkv
    head_of = torch.arange(h, device=args[0].device) // rep
    return _kv_per_query_head(
        args, res, segs, opts, head_of,
        lambda x: x.float().reshape(b, -1, hkv, rep, d)[:, :, :, :rep - 1].sum(3))


LATE_TILE = 64


def _late_tile_dropped(args, segs, opts, res, want):
    """The last LATE_TILE query rows skip the key tile
    [Sk - 3*LATE_TILE, Sk - 2*LATE_TILE) in the forward and dQ, and that key
    tile's dK/dV skip those rows: a fault confined to late rows and keys,
    where values are smallest."""
    q, k, v, do = args
    b, s = q.shape[:2]
    sk = k.shape[1]
    rows = slice(s - LATE_TILE, s)
    keys = slice(sk - 3 * LATE_TILE, sk - 2 * LATE_TILE)
    check(segs is None, "the late-tile mutant takes no segment ids")
    q_ids = torch.zeros(b, s, dtype=torch.int32, device=q.device)
    k_ids = torch.zeros(b, sk, dtype=torch.int32, device=q.device)
    k_ids[:, keys] = 1                 # the tile alone in a segment: no row sees it
    out, lse, dq, dk, dv = (w.clone() for w in want)
    m_out, m_lse, m_dq, _, _ = _flash_plain_all(args, (q_ids, k_ids), opts, res)
    out[:, rows], lse[:, :, rows], dq[:, rows] = (
        m_out[:, rows], m_lse[:, :, rows], m_dq[:, rows])
    do_early = do.clone()
    do_early[:, rows] = 0              # rows with dO = 0 add nothing to dK/dV
    _, _, _, e_dk, e_dv = _flash_plain_all((q, k, v, do_early), segs, opts, res)
    dk[:, keys], dv[:, keys] = e_dk[:, keys], e_dv[:, keys]
    return [out, lse, dq, dk, dv]


def _dq_tile_dropped(args, segs, opts, res, want):
    """dQ alone skips the middle key tile [64 * (n / 2), + 64) of the n
    64-key tiles, in every row; the other outputs stay right."""
    q, k = args[:2]
    b, s = q.shape[:2]
    sk = k.shape[1]
    keys = slice(LATE_TILE * (sk // LATE_TILE // 2),
                 LATE_TILE * (sk // LATE_TILE // 2 + 1))
    check(segs is None, "the dQ-tile mutant takes no segment ids")
    q_ids = torch.zeros(b, s, dtype=torch.int32, device=q.device)
    k_ids = torch.zeros(b, sk, dtype=torch.int32, device=q.device)
    k_ids[:, keys] = 1                 # the tile alone in a segment: no row sees it
    m_dq = _flash_plain_all(args, (q_ids, k_ids), opts, res)[2]
    return [*want[:2], m_dq, *want[3:]]


ANY = ("any",)
DQ_TILE = {"dq_tile_dropped": (_dq_tile_dropped, ("dq",))}
FLASH_CASES = [
    # name, shape, options, mutants {name: (function, outputs it must miss)}
    ("train_shape", dict(b=1, s=2048, h=32, hkv=8, d=128, dtype=torch.bfloat16),
     dict(causal=True),
     {"mask_off_by_one": (_changed_opts(_off_by_one), ANY),
      "kv_head_mod": (_kv_head_mod, ANY),
      "dkv_rep_minus_1": (_dkv_rep_minus_1, ("dk", "dv")),
      "late_tile_dropped": (_late_tile_dropped, FLASH_OUTPUTS), **DQ_TILE}),
    ("unaligned_gqa", dict(b=2, s=300, h=8, hkv=2, d=128, dtype=torch.bfloat16),
     dict(causal=True),
     {"kv_head_mod": (_kv_head_mod, ANY),
      "mask_off_by_one": (_changed_opts(_off_by_one), ANY),
      "late_tile_dropped": (_late_tile_dropped, FLASH_OUTPUTS), **DQ_TILE}),
    ("noncausal_sq_ne_sk_fp32", dict(b=1, s=200, h=4, hkv=2, d=64,
                                     dtype=torch.float32, sk=333),
     dict(causal=False),
     {"kv_head_mod": (_kv_head_mod, ANY),
      "late_tile_dropped": (_late_tile_dropped, FLASH_OUTPUTS), **DQ_TILE}),
    ("window", dict(b=1, s=1024, h=8, hkv=2, d=128, dtype=torch.bfloat16),
     dict(causal=True, window=256),
     {"window_dropped": (_changed_opts(lambda o: {**o, "window": None}), ANY),
      **DQ_TILE}),
    ("segments", dict(b=2, s=512, h=8, hkv=2, d=128, dtype=torch.bfloat16,
                      seg=True),
     dict(causal=True),
     {"segment_mask_dropped": (_segments_dropped, ANY)}),
    ("causal_shift", dict(b=1, s=512, h=8, hkv=2, d=128, dtype=torch.bfloat16),
     dict(causal=True, causal_shift=1),
     {"mask_off_by_one": (_changed_opts(_off_by_one), ANY), **DQ_TILE}),
    # what the tensor-core kernels newly risk: d=64 atoms and Sq != Sk in
    # bf16, a window narrower than a tile, and one row/key past the tiles
    ("noncausal_sq_ne_sk_d64", dict(b=1, s=200, h=4, hkv=2, d=64,
                                    dtype=torch.bfloat16, sk=333),
     dict(causal=False),
     {"kv_head_mod": (_kv_head_mod, ANY),
      "late_tile_dropped": (_late_tile_dropped, FLASH_OUTPUTS), **DQ_TILE}),
    ("window_100", dict(b=1, s=512, h=8, hkv=2, d=128, dtype=torch.bfloat16),
     dict(causal=True, window=100),
     {"window_dropped": (_changed_opts(lambda o: {**o, "window": None}), ANY),
      "window_off_by_one": (_changed_opts(lambda o: {**o, "window": 101}),
                            ANY), **DQ_TILE}),
    ("one_past_128", dict(b=2, s=257, h=8, hkv=2, d=128, dtype=torch.bfloat16),
     dict(causal=True),
     {"mask_off_by_one": (_changed_opts(_off_by_one), ANY),
      "kv_head_mod": (_kv_head_mod, ANY),
      "late_tile_dropped": (_late_tile_dropped, FLASH_OUTPUTS), **DQ_TILE}),
]


def _json_ratio(x):
    # a mutant's mask can make a row live whose lse is -1e30: inf there,
    # written as 1e30 for JSON
    return x if math.isfinite(x) else 1e30


def run_flash_cases(gen):
    """Every FLASH_CASES case: the three kernels against the plain mirrors
    (each output within its per-row tolerance, finite), and each mutant of
    the plain version outside the tolerance on the outputs it names (on at
    least one when it names ``any``), and a second backward on the same
    inputs repeating dQ, dK and dV bit for bit. Returns the rows; raises
    PhaseError on any failure. The ``gpu`` test runs this too."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    rows = []
    for name, shape, opts, mutants in FLASH_CASES:
        args, segs = _flash_inputs(gen, **shape)
        q, k, v, do = args
        before = build.launch_counts()
        out, lse = flash_fwd(q, k, v, segment_ids=segs, **opts)
        grads = flash_bwd(q, k, v, out, lse, do, segment_ids=segs, **opts)
        torch.cuda.synchronize()
        after = build.launch_counts()
        check(all(after.get(n, 0) == before.get(n, 0) + 1
                  for n in FLASH_PER_STEP),
              f"flash {name}: each kernel should have launched once")
        again = flash_bwd(q, k, v, out, lse, do, segment_ids=segs, **opts)
        repeats = all(torch.equal(a, g) for a, g in zip(again, grads))
        del again
        got = (out, lse) + grads
        res = (out, lse)
        want = _flash_plain_all(args, segs, opts, res)
        one_key = _dq_one_key_rows(args, segs, opts)
        tols = _flash_tols(want, one_key)
        errs = {n: _max_err(g, w, n) for n, g, w in zip(FLASH_OUTPUTS, got, want)}
        ratios = {n: _flash_ratio(g, w, t, n) for n, g, w, t in
                  zip(FLASH_OUTPUTS, got, want, tols)}
        finite = all(bool(torch.isfinite(g).all()) for n, g in
                     zip(FLASH_OUTPUTS, got) if n != "lse")
        one, bound = one_key
        n_one = int(one.sum())
        b_one = bound[one][:, None]
        dq_one = {"rows": n_one, "expected_rows": _one_key_row_count(
                      shape, opts, segs),
                  "max_bound": b_one.max().item() if n_one else 0.0,
                  "kernel_over_bound": _err_ratio(
                      got[2][one], torch.zeros_like(got[2][one]), b_one),
                  "plain_over_bound": _err_ratio(
                      want[2][one], torch.zeros_like(want[2][one]), b_one),
                  "err_over_bound": _err_ratio(got[2][one], want[2][one],
                                               b_one)}
        row = {"phase": "flash_parity", "case": name,
               "shape": {k_: (str(v_) if k_ == "dtype" else v_)
                         for k_, v_ in shape.items()},
               "options": opts, "max_abs_err": errs, "err_over_tol": ratios,
               "row_tol_range": {n: [t.min().item(), t.max().item()]
                                 for n, t in zip(FLASH_OUTPUTS, tols)},
               "finite": finite, "bwd_repeats_bitwise": repeats,
               "dq_one_key_rows": dq_one, "mutants": {}}
        for m_name, (mutant, must) in mutants.items():
            m_want = mutant(args, segs, opts, res, want)
            row["mutants"][m_name] = {
                n: _json_ratio(_flash_ratio(m, w, t, n)) for n, m, w, t in
                zip(FLASH_OUTPUTS, m_want, want, tols)}
            del m_want
        emit(row)
        check(finite, f"flash {name}: non-finite output")
        check(repeats, f"flash {name}: a second backward gave other dQ/dK/dV "
              "bits")
        check(dq_one["rows"] == dq_one["expected_rows"],
              f"flash {name}: {dq_one['rows']} dQ rows with one live key, "
              f"{dq_one['expected_rows']} expected")
        check(dq_one["plain_over_bound"] <= 1.0 and
              dq_one["kernel_over_bound"] <= 1.0,
              f"flash {name}: a dQ row with one live key is not 0 within "
              f"its rounding bound ({dq_one})")
        for n in FLASH_OUTPUTS:
            check(ratios[n] <= 1.0, f"flash {name}: {n} error {ratios[n]} "
                  "times its row tolerance")
        for m_name, (_, must) in mutants.items():
            m_ratios = row["mutants"][m_name]
            caught = (max(m_ratios.values()) > 1.0 if must == ANY else
                      all(m_ratios[n] > 1.0 for n in must))
            check(caught, f"flash {name}: mutant {m_name} lands within the "
                  f"tolerance of {must} ({m_ratios}), so the case cannot "
                  "catch that fault")
        rows.append(row)
        del args, got, want, out, lse, grads, res
    return rows


def _flash_work(b, s, h, hkv, d, elem):
    """(causal live (row, key) pairs, operand bytes of the forward, of dQ,
    of dK/dV) at this shape; each input read once, each output written
    once."""
    pairs = b * h * s * (s + 1) // 2
    qo = b * s * h * d * elem                     # q, out, dO or dq
    kv = b * s * hkv * d * elem
    rows = b * h * s * 4                          # lse or delta (fp32)
    fwd = 2 * qo + 2 * kv + rows                  # q k v -> out lse
    dq = 3 * qo + 2 * kv + 2 * rows               # q k v dO lse delta -> dq
    dkv = 2 * qo + 4 * kv + 2 * rows              # q k v dO lse delta -> dk dv
    return pairs, fwd, dq, dkv


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


PROFILE_TRIES = 8
PROFILE_RETRY_PAUSE_S = 0.2


def _device_events(fn, iters):
    """The CUDA kernel events of ``iters`` calls of ``fn`` (torch.profiler,
    after a warm-up call). A profiling window that delivers no CUDA event
    at all (seen in long runs of short windows on the H100, up to three in
    a row) is taken again after a short pause, up to PROFILE_TRIES
    windows; the callers raise if all are empty."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(PROFILE_TRIES):
        if attempt:
            time.sleep(PROFILE_RETRY_PAUSE_S)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == cuda]
        if events:
            break
    return events


def _per_call_ms(durations_us, iters):
    """Device ms per call of a kernel whose events in an ``iters``-call
    window took ``durations_us``: the mean event times the launches per
    call (the event count over iters, rounded), which stays right when the
    profiler drops some of a window's events (seen on the H100: 3 of 20
    delivered)."""
    per_call = max(1, round(len(durations_us) / iters))
    return sum(durations_us) / len(durations_us) * per_call / 1e3


def _kernel_device_ms(fn, names, iters=10):
    """Mean device time per call of each named CUDA kernel inside ``fn``;
    a name that matches no kernel event raises. A window whose event count
    of some name is not a multiple of ``iters`` lost events and is taken
    again (up to PROFILE_TRIES windows)."""
    for _ in range(PROFILE_TRIES):
        events = _device_events(fn, iters)
        mine = {n: [e.time_range.elapsed_us() for e in events if n in e.name]
                for n in names}
        if all(len(t) % iters == 0 for t in mine.values()):
            break
    for n, t in mine.items():
        check(t, f"the profiler saw no kernel whose name holds {n!r}")
    return {n: _per_call_ms(t, iters) for n, t in mine.items()}


def _call_device_ms(fn, iters=10):
    """Mean device time per call of every kernel ``fn`` launches (a library
    call's yardstick, without the host's share)."""
    events = _device_events(fn, iters)
    check(events, "the profiler saw no kernel")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters


def phase_flash_timing(gen):
    """Kernel, plain and SDPA times at the training path's attention shape
    (B=1, S=2048, H=32, Hkv=8, d=128, causal, bf16), with the bounds."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import (flash_bwd,
                                                         flash_bwd_plain,
                                                         flash_fwd,
                                                         flash_fwd_plain)
    b, s, h, hkv, d = 1, TRAIN_SEQ, 32, 8, 128
    (q, k, v, do), _ = _flash_inputs(gen, b, s, h, hkv, d, torch.bfloat16)
    out, lse = flash_fwd(q, k, v, causal=True)
    fwd_ms = _kernel_device_ms(lambda: flash_fwd(q, k, v, causal=True),
                               ["flash_fwd_kernel"], iters=20)["flash_fwd_kernel"]
    wrapper_fwd_ms = time_ms(lambda: flash_fwd(q, k, v, causal=True), iters=20)
    bwd_ms = time_ms(lambda: flash_bwd(q, k, v, out, lse, do, causal=True),
                     iters=10)
    per_kernel = _kernel_device_ms(
        lambda: flash_bwd(q, k, v, out, lse, do, causal=True),
        ["flash_dq_kernel", "flash_dkv_kernel"])
    plain_fwd_ms = time_ms(lambda: flash_fwd_plain(q, k, v, causal=True), iters=5)
    plain_bwd_ms = time_ms(lambda: flash_bwd_plain(q, k, v, out, lse, do,
                                                   causal=True), iters=5)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(      # noqa: E731
        qs, ks, vs, is_causal=True, enable_gqa=True)
    sdpa_fwd_ms = _call_device_ms(sdpa, iters=20)
    o_sdpa = sdpa()
    g = do.transpose(1, 2)
    sdpa_bwd_ms = _call_device_ms(lambda: torch.autograd.grad(
        o_sdpa, (qs, ks, vs), g, retain_graph=True), iters=20)
    pairs, fwd_b, dq_b, dkv_b = _flash_work(b, s, h, hkv, d, 2)
    mm = 2 * pairs * d                       # one causal-half matmul, flops
    bounds = {"flash_fwd": _bound(2 * mm, fwd_b),
              "flash_dq": _bound(3 * mm, dq_b),
              "flash_dkv": _bound(4 * mm, dkv_b)}
    timing = {
        "flash_fwd": {"ms": fwd_ms, "plain_ms": plain_fwd_ms,
                      "library_ms": sdpa_fwd_ms},
        "flash_dq": {"ms": per_kernel["flash_dq_kernel"],
                     "plain_ms": plain_bwd_ms, "library_ms": sdpa_bwd_ms},
        "flash_dkv": {"ms": per_kernel["flash_dkv_kernel"],
                      "plain_ms": plain_bwd_ms, "library_ms": sdpa_bwd_ms},
    }
    for name, (bound_ms, bound_by) in bounds.items():
        timing[name].update(bound_ms=bound_ms, bound_by=bound_by)
    emit({"phase": "flash_timing",
          "shape": "B=1 S=2048 H=32 Hkv=8 d=128 causal bf16",
          **{n: {**t, "share_of_bound": t["bound_ms"] / t["ms"]}
             for n, t in timing.items()},
          "fwd_plus_bwd_ms": wrapper_fwd_ms + bwd_ms,
          "plain_fwd_plus_bwd_ms": plain_fwd_ms + plain_bwd_ms,
          "sdpa_fwd_plus_bwd_ms": sdpa_fwd_ms + sdpa_bwd_ms,
          "flops": {"fwd": 2 * mm, "bwd_two_kernel": 7 * mm,
                    "bwd_minimum": 5 * mm},
          "bwd_minimum_bound_ms": 5 * mm / BF16_FLOPS * 1e3,
          "notes": "ms and library_ms are profiler device time (a "
                   "kernel's, or all kernels of one SDPA call); "
                   "fwd_plus_bwd_ms is CUDA-event time of back-to-back "
                   "wrapper calls (host work included); plain_ms of dq/dkv "
                   "is the whole plain backward; library_ms of dq/dkv is one "
                   "SDPA backward (dq, dk, dv)"})
    return timing


def phase_flash_parity():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    rows = run_flash_cases(gen)
    worst = {}
    for row in rows:                        # worst error per kernel
        errs = row["max_abs_err"]
        for kernel, outs in (("flash_fwd", ("out", "lse")), ("flash_dq", ("dq",)),
                             ("flash_dkv", ("dk", "dv"))):
            worst[kernel] = max(worst.get(kernel, 0.0),
                                max(errs[o] for o in outs))
    return worst, phase_flash_timing(gen)


# ---------------------------------------------------------------------------
# phase 3c: the int8 and fp8 quantize/dequantize kernels vs their plain
# versions, bit for bit
# ---------------------------------------------------------------------------
QUANT_QMAX = {"int8": 127.0, "e4m3": 448.0, "e5m2": 57344.0}
# the last two outnumber the kernels' grids on a 132-SM card (the warp
# kernel's 4,224 blocks of 8 rows, the block kernel's 1,056 blocks, the
# dequantize's 540,672 threads), so every grid-stride loop takes more than one
# pass; the timing phase holds the path shapes bit for bit as well
QUANT_SHAPES = [(4099, 64), (1000, 128), (37, 4096), (9, 14336), (3, 128256),
                (1, 130), (70001, 64), (2200, 1000)]
QUANT_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
QUANT_KERNELS = ("quantize_int8", "dequantize_int8", "quantize_fp8",
                 "dequantize_fp8")
# the path shapes timed: one w_gate of A1 in groups of 64, and the lm_head
# gradient of the qgZ training step
QUANT_TIMING_SHAPES = {"A1_w_gate": (917504, 64), "B_lm_head": (4096, 128256)}
# qgZ's four row widths in the 4-layer Llama-3-8B recipe, each at its
# largest leaf ([n, d] with rows its last axis: wq [4096, 32, 128], the
# embedding [128256, 4096], w_gate [4096, 14336], the lm_head [4096,
# 128256])
QGZ_WIDTH_SHAPES = {128: (131072, 128), 4096: (128256, 4096),
                    14336: (4096, 14336), 128256: (4096, 128256)}
# each special row and the fault of the quantize kernel it exposes
# (None: a parity row only; no fault of the kernel changes its bits)
QUANT_ROWS = {"zero": "scale_floor_dropped", "ties": "round_half_away",
              "top": None, "last_max": "absmax_but_last",
              "reciprocal": "reciprocal_multiply"}
# the int8 cases' further rows: a NaN in one spot (in one middle segment of
# a row the cluster kernel splits), an inf (in the last segment there), and
# on the cluster path a row whose only maximum opens the last segment
QUANT_INT8_ROWS = {"nan": "nan_dropped", "inf": None,
                   "segment_max": "absmax_one_segment_dropped"}


def _fp8_dtype(fmt):
    return {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}[fmt]


def _through(v, dtype):
    """fp32 numpy values rounded through ``dtype`` (exactly representable
    there, and back in fp32)."""
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        dtype).float().numpy()


def _host_scale(absmax, qmax):
    """The kernels' scale on the host: absmax times the fp32 reciprocal of
    qmax, floored at 1e-12."""
    recip = np.float32(1.0) / np.float32(qmax)
    return np.maximum(np.float32(absmax) * recip, np.float32(1e-12))


def _host_codes(v, fmt):
    """Codes of already-scaled fp32 values v: int8 rint and clip, fp8 the
    conversion (as fp32 values, for comparing)."""
    t = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    if fmt == "int8":
        return torch.clamp(torch.round(t), -127, 127).numpy()
    return t.to(_fp8_dtype(fmt)).float().numpy()


def _grid_midpoints(fmt):
    """Midpoints between neighbouring non-negative codes of ``fmt``."""
    if fmt == "int8":
        grid = np.arange(128, dtype=np.float32)
    else:
        vals = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
            _fp8_dtype(fmt)).float()
        grid = np.unique(vals[torch.isfinite(vals) & (vals >= 0)].numpy())
    return ((grid[:-1] + grid[1:]) / 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reciprocal_hits(fmt, dtype):
    """(absmax a, values x < a representable in ``dtype``) where dividing
    x by a's scale and multiplying by the scale's reciprocal give other
    codes; no values when ``dtype`` has none (bf16 inputs do not land that
    close to an fp8 rounding boundary)."""
    rng = np.random.default_rng(SEED + 5)
    qmax = QUANT_QMAX[fmt]
    mids = _grid_midpoints(fmt)
    x = np.float32([])
    for _ in range(32):
        a = _through(rng.uniform(1.0, 4.0), dtype)[0]
        s = _host_scale(a, qmax)
        if dtype == torch.float32:       # a few ulps around each midpoint
            near = [(mids * s).astype(np.float32)]
            for toward in (np.float32(0), np.float32(np.inf)):
                step = near[0]
                for _ in range(3):
                    step = np.nextafter(step, toward)
                    near.append(step)
            x = np.unique(np.concatenate(near))
        else:                            # every bf16 value below a
            x = torch.arange(0, 1 << 15, dtype=torch.int32).to(
                torch.int16).view(torch.bfloat16).float().numpy()
            x = np.unique(x[np.isfinite(x) & (x > a / 512)])
        x = x[np.abs(x) < a]
        x = x[_host_codes(x / s, fmt) != _host_codes(x * (np.float32(1) / s),
                                                      fmt)]
        if x.size:
            return a, x
    return None, x


def _reciprocal_row(d, fmt, dtype, rng):
    """A row of _reciprocal_hits values (random signs) and its absmax, or
    None."""
    a, hits = _reciprocal_hits(fmt, dtype)
    if a is None:
        return None
    row = np.resize(rng.permutation(hits), d).astype(np.float32)
    row *= rng.choice(np.float32([-1.0, 1.0]), size=d)
    row[rng.integers(d)] = a
    return row


def quant_special_rows(d, fmt, dtype, rng):
    """{name: row [d] fp32, representable in ``dtype``}: each row exposes
    the fault named in QUANT_ROWS (``reciprocal`` is left out where no row
    can expose it)."""
    qmax = QUANT_QMAX[fmt]
    rows = {"zero": np.zeros(d, np.float32)}
    # absmax qmax/8 gives a scale of exactly 1/8, so x/scale lands on exact
    # midpoints between codes: half to even and half away then differ
    mids = _grid_midpoints(fmt)
    pick = np.concatenate([[0], rng.integers(0, len(mids), size=d - 2)])
    ties = mids[pick] * np.float32(0.125)
    ties *= rng.choice(np.float32([-1.0, 1.0]), size=d - 1)
    rows["ties"] = np.concatenate([[np.float32(qmax / 8)], ties]).astype(
        np.float32)
    # the absmax element: for int8, x / scale lands a hair above 127 (rint
    # and the clip bring it back); for fp8 the reciprocal's scale never puts
    # it above fmax (checked over every fp32 in [1, 2)), and it lands on fmax
    for _ in range(1000):
        a = _through(rng.uniform(0.5, 2.0), dtype)[0]
        if fmt != "int8" or \
                np.float32(a) / _host_scale(a, qmax) > np.float32(qmax):
            break
    row = _through(rng.uniform(-a / 2, a / 2, size=d), dtype)
    row[rng.integers(d)] = -a if rng.random() < 0.5 else a
    rows["top"] = row
    # the last element is the row's only maximum
    row = _through(rng.normal(size=d) * 3.0, dtype)
    row[-1] = _through(1.5 * np.abs(row[:-1]).max() * rng.choice([-1, 1]),
                       dtype)[0]
    rows["last_max"] = row
    row = _reciprocal_row(d, fmt, dtype, rng)
    if row is not None:
        rows["reciprocal"] = row
    for name, r in rows.items():
        check(np.array_equal(_through(r, dtype), r),
              f"special row {name} is not exact in {dtype}")
    return rows


def _int8_segments(d, dtype):
    """[(first, end)) columns of each segment of an aligned row of width
    d that the int8 quantize kernel's CTAs hold (one segment off the
    cluster path), from ops/quant.py's ``quant_plan``."""
    from deepspeed_tpu_torch.ops.quant import quant_plan
    pl = quant_plan(1, d, 0, 0, torch.tensor([], dtype=dtype).element_size())
    vec, seg, chunks = pl["vec"], max(pl["seg"], 1), pl["chunks"]
    return [(c * seg * vec, min(chunks, (c + 1) * seg) * vec)
            for c in range(pl["cluster"])]


def quant_int8_rows(d, dtype, rng):
    """{name: row [d] fp32} of QUANT_INT8_ROWS for width d: seeded normal
    rows (times 3) with a NaN inside the second segment (the row's middle
    off the cluster path), with an inf (sign at random) inside the last,
    and on the cluster path one whose only maximum is the last segment's
    first element."""
    segs = _int8_segments(d, dtype)
    rows = {}
    row = _through(rng.normal(size=d) * 3.0, dtype)
    first, end = segs[min(1, len(segs) - 1)]
    row[rng.integers(first, end) if len(segs) > 1 else d // 2] = np.nan
    rows["nan"] = row
    row = _through(rng.normal(size=d) * 3.0, dtype)
    first, end = segs[-1]
    row[rng.integers(first, end) if len(segs) > 1 else d - 1 - d // 3] = \
        np.inf * rng.choice([-1, 1])
    rows["inf"] = row
    if len(segs) > 1:
        row = _through(rng.normal(size=d) * 3.0, dtype)
        row[segs[-1][0]] = _through(1.5 * np.abs(row).max(), dtype)[0]
        rows["segment_max"] = row
    return rows


def quant_cases(seed=SEED):
    """Every case: (name, x [N, D] fp32 numpy, fmt, dtype name, special row
    names it holds). Each QUANT_SHAPES shape of seeded normal rows (times
    3), its leading rows replaced by the special rows (for int8 also
    QUANT_INT8_ROWS') where N allows; where it does not, one more case of
    the special rows alone at that width."""
    rng = np.random.default_rng(seed)
    cases = []
    for fmt in QUANT_QMAX:
        for dname, dtype in QUANT_DTYPES.items():
            for n, d in QUANT_SHAPES:
                x = _through(rng.normal(size=(n, d)) * 3.0, dtype)
                special = quant_special_rows(d, fmt, dtype, rng)
                if fmt == "int8":
                    special.update(quant_int8_rows(d, dtype, rng))
                rows = list(special)
                if n >= len(rows):
                    x[:len(rows)] = np.stack([special[r] for r in rows])
                    cases.append((f"{n}x{d}", x, fmt, dname, rows))
                else:
                    cases.append((f"{n}x{d}", x, fmt, dname, []))
                    cases.append((f"special_{len(rows)}x{d}",
                                  np.stack([special[r] for r in rows]), fmt,
                                  dname, rows))
    return cases


def _quant_plain(x, fmt):
    from deepspeed_tpu_torch.ops.fp_quant import quantize_fp8_plain
    from deepspeed_tpu_torch.ops.quant import quantize_int8_plain
    return quantize_int8_plain(x) if fmt == "int8" else \
        quantize_fp8_plain(x, fmt)


def _quant_mutant(x, fmt, fault):
    """The plain quantize with one fault a kernel could have (codes,
    scales): the absmax without the last element, without the last cluster
    segment's chunks (`absmax_one_segment_dropped`) or by a max that drops
    NaN (as fmaxf does), no 1e-12 floor, a product with the reciprocal
    scale, ties rounded away from 0."""
    from deepspeed_tpu_torch.ops.quant import reciprocal
    qmax = QUANT_QMAX[fmt]
    x2d = x.float()
    mag = x2d.abs()
    if fault == "absmax_but_last":
        mag = mag[:, :-1]
    elif fault == "absmax_one_segment_dropped":
        first, end = _int8_segments(x.shape[-1], x.dtype)[-1]
        mag = torch.cat([mag[:, :first], mag[:, end:]], dim=1)
    elif fault == "nan_dropped":
        mag = torch.nan_to_num(mag, nan=0.0)
    scale = mag.amax(dim=-1, keepdim=True) * reciprocal(qmax)
    if fault != "scale_floor_dropped":
        scale = torch.clamp_min(scale, 1e-12)
    v = x2d * (1.0 / scale) if fault == "reciprocal_multiply" else x2d / scale
    if fault == "round_half_away":
        v = torch.nextafter(v, 2.0 * v)          # ties now round away from 0
    if fmt == "int8":
        return torch.clamp(torch.round(v), -127, 127).to(torch.int8), scale
    return v.to(_fp8_dtype(fmt)), scale


def _bits(t):
    """A tensor's bits, for exact comparison (int view of its width)."""
    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32}[t.element_size()])


def _differs(a, b) -> int:
    """Elements whose bits differ; two NaNs count as equal (a NaN's
    payload is not part of the function)."""
    diff = _bits(a) != _bits(b)
    if a.dtype in (torch.float32, torch.bfloat16, torch.float16):
        diff &= ~(torch.isnan(a) & torch.isnan(b))
    return int(diff.sum())


def run_quant_cases(seed=SEED, device="cuda"):
    """Every quant_cases case on the card: the quantize kernel of its
    format against the plain version (codes and scales bit for bit), the
    dequantize kernel against the plain version on the plain codes (bit for
    bit, to the case's dtype, and again on a view one row in, whose codes
    start d bytes past the tensor's: at d = 130 off every 16-byte
    boundary, at d = 1000 on the fp8 kernel's chunks after a scalar head),
    each quantize fault of a special row the case holds changing a code or
    a scale, a dequantize reading the next row's scale changing an output
    and, where d % 16 != 0, one dropping each row's last d % 16 values
    (the fp8 kernel's scalar tail) changing one. Returns the rows; raises
    PhaseError on any failure. The ``gpu`` test runs this too; on
    ``device="cpu"`` the wrappers run the plain versions, which checks the
    cases and their mutants without the card."""
    from deepspeed_tpu_torch.ops.fp_quant import dequantize_fp8, quantize_fp8
    from deepspeed_tpu_torch.ops.quant import (DEQ_CHUNK, dequantize_int8,
                                               dequantize_plain, quantize_int8)
    rows = []
    for name, xnp, fmt, dname, special in quant_cases(seed):
        dtype = QUANT_DTYPES[dname]
        x = torch.from_numpy(xnp).to(device=device, dtype=dtype)
        quant, dequant = (quantize_int8, dequantize_int8) if fmt == "int8" \
            else (lambda t: quantize_fp8(t, fmt), dequantize_fp8)
        q_k, s_k = quant(x)
        q_p, s_p = _quant_plain(x, fmt)
        d_k = dequant(q_p, s_p, dtype)
        if device == "cuda":
            torch.cuda.synchronize()
        d_p = dequantize_plain(q_p, s_p, dtype)
        row = {"phase": "quant_parity", "case": name, "fmt": fmt,
               "dtype": dname, "codes_differ": _differs(q_k, q_p),
               "scales_differ": _differs(s_k, s_p),
               "dequant_differ": _differs(d_k, d_p),
               "max_abs_err": max(
                   (q_k.float() - q_p.float()).abs().max().item(),
                   (s_k - s_p).abs().max().item(),
                   (d_k.float() - d_p.float()).abs().max().item()),
               "special_rows": special, "mutants": {}}
        for r in special:
            fault = {**QUANT_ROWS, **QUANT_INT8_ROWS}[r]
            if fault is None:
                continue
            m_q, m_s = _quant_mutant(x, fmt, fault)
            row["mutants"][fault] = _differs(m_q, q_p) + _differs(m_s, s_p)
        if special:
            shifted = dequantize_plain(q_p, s_p.roll(1, 0), dtype)
            row["mutants"]["dequant_row_shift"] = _differs(shifted, d_p)
        d = x.shape[-1]
        if d % DEQ_CHUNK:
            dropped = d_p.clone()
            dropped[:, d - d % DEQ_CHUNK:] = 0
            row["mutants"]["dequant_tail_dropped"] = _differs(dropped, d_p)
        if x.shape[0] >= 2:
            q_v, s_v = q_p[1:], s_p[1:]          # codes d bytes in
            row["view_dequant_differ"] = _differs(
                dequant(q_v, s_v, dtype), dequantize_plain(q_v, s_v, dtype))
            x_v = x[1:]                          # inputs d elements in
            (qk_v, sk_v), (qp_v, sp_v) = quant(x_v), _quant_plain(x_v, fmt)
            row["view_quant_differ"] = _differs(qk_v, qp_v) + _differs(sk_v, sp_v)
        emit(row)
        check(row["codes_differ"] == row["scales_differ"] == 0,
              f"quantize {fmt} {dname} {name}: {row['codes_differ']} codes, "
              f"{row['scales_differ']} scales differ from the plain version")
        check(row["dequant_differ"] == 0,
              f"dequantize {fmt} {dname} {name}: {row['dequant_differ']} "
              "outputs differ from the plain version")
        view_differ = row.get("view_dequant_differ", 0)
        check(view_differ == 0, f"dequantize {fmt} {dname} {name} one row "
              f"in: {view_differ} outputs differ from the plain version")
        view_differ = row.get("view_quant_differ", 0)
        check(view_differ == 0, f"quantize {fmt} {dname} {name} one row "
              f"in: {view_differ} codes or scales differ from the plain "
              "version")
        for fault, n in row["mutants"].items():
            check(n > 0, f"{fmt} {dname} {name}: mutant {fault} gives the "
                  "plain version's bits, so the case cannot catch that fault")
        rows.append(row)
        del x, q_k, s_k, q_p, s_p, d_k, d_p
    return rows


def phase_quant_parity():
    rows = run_quant_cases()
    worst = {k: 0.0 for k in QUANT_KERNELS}
    for row in rows:
        q = "quantize_int8" if row["fmt"] == "int8" else "quantize_fp8"
        worst[q] = max(worst[q], row["max_abs_err"])
        worst["de" + q] = max(worst["de" + q], row["max_abs_err"])
    faults = sorted({f for r in rows for f in r["mutants"]})
    emit({"phase": "quant_parity_summary", "cases": len(rows),
          "bit_identical": True, "mutants_caught": faults,
          "reciprocal_rows": sorted({(r["fmt"], r["dtype"]) for r in rows
                                     if "reciprocal" in r["special_rows"]})})
    return worst


def _quant_bound(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def qgz_leaf_shapes(cfg, layers):
    """[n, d] of each gradient qgZ quantizes in one micro-batch of a Llama
    model of ``cfg`` cut to ``layers`` layers (rows are a leaf's last axis,
    leaves of at least 2048 elements): the embedding, per layer wq, wk, wv,
    wo, w_gate, w_up, w_down and the two norm scales, the final norm scale,
    the lm_head."""
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd = cfg.head_dim or h // cfg.num_heads
    layer = [(h * cfg.num_heads, hd), (h * cfg.num_kv_heads, hd),
             (h * cfg.num_kv_heads, hd), (cfg.num_heads * hd, h), (h, f),
             (h, f), (f, h), (1, h), (1, h)]
    return [(v, h)] + layer * layers + [(1, h), (h, v)]


def _qgz_width_timing(gen):
    """``quantize_int8`` at each of qgZ's row widths (QGZ_WIDTH_SHAPES,
    fp32): its codes and scales bit for bit against the plain version's,
    the device time of its entries by exact name (profiler) beside its
    bytes bound and its CUDA-event time; then the device time of one qgZ
    step's 78 launches (TRAIN_GAS micro-batches of the recipe's
    ``qgz_leaf_shapes``, seeded fp32 leaves) beside their bytes bound."""
    from deepspeed_tpu_torch.models.llama import LLAMA3_8B
    from deepspeed_tpu_torch.ops.quant import quantize_int8, quantize_int8_plain
    rows = {}
    for d, (n, _) in QGZ_WIDTH_SHAPES.items():
        x = torch.randn(n, d, generator=gen, device="cuda")
        q, s = quantize_int8(x)
        q_p, s_p = quantize_int8_plain(x)
        n_diff = _differs(q, q_p) + _differs(s, s_p)
        del q, s, q_p, s_p
        check(n_diff == 0, f"quantize_int8 at qgZ width {d} [{n}, {d}]: "
              f"{n_diff} codes or scales differ from the plain version")
        call = lambda: quantize_int8(x)    # noqa: E731
        entries = {k: v for k, v in _entry_ms(call, iters=10).items()
                   if "quantize_int8" in k}
        ms = sum(entries.values())
        nbytes = x.numel() * 5 + n * 4
        bound_ms = _quant_bound(nbytes)[0]
        rows[str(d)] = {"shape": [n, d], "ms": ms, "entries_ms": entries,
                        "events_ms": time_ms(call, iters=10),
                        "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
                        "bytes": nbytes}
        del x
        torch.cuda.empty_cache()
    shapes = qgz_leaf_shapes(LLAMA3_8B, TRAIN_LAYERS)
    check(len(shapes) == QGZ_LEAVES, f"{len(shapes)} qgZ leaves, expected "
          f"{QGZ_LEAVES}")
    leaves = [torch.randn(n, d, generator=gen, device="cuda") for n, d in shapes]

    def step():
        for _ in range(TRAIN_GAS):
            for x in leaves:
                quantize_int8(x)
    step_ms = sum(v for k, v in _entry_ms(step, iters=3).items()
                  if "quantize_int8" in k)
    nbytes = TRAIN_GAS * sum(x.numel() * 5 + x.shape[0] * 4 for x in leaves)
    del leaves
    torch.cuda.empty_cache()
    return {"widths": rows, "step_launches": TRAIN_GAS * len(shapes),
            "step_ms": step_ms, "step_bound_ms": _quant_bound(nbytes)[0],
            "step_share_of_bound": _quant_bound(nbytes)[0] / step_ms}


def phase_quant_timing(dev, smi_line):
    """Kernel and plain times of the four kernels at the two path shapes
    (fp32 input; dequantize to bf16 at A1's shape, to fp32 at B's), beside
    the bytes bound: input + codes + scales for quantize, codes + scales +
    output for dequantize. A kernel's ``ms`` is the profiler's device time
    of its entries by exact name (``_stem_entries_ms``), ``wrapper_ms`` the
    CUDA-event time of the wrapper's calls. No single PyTorch call computes
    these functions, so there is no library time. At both shapes each
    kernel's codes, scales and outputs are held bit for bit against the
    plain version's (each grid-stride loop runs many passes there)."""
    from deepspeed_tpu_torch.ops.fp_quant import (dequantize_fp8, quantize_fp8,
                                                  quantize_fp8_plain)
    from deepspeed_tpu_torch.ops.quant import (dequantize_int8,
                                               dequantize_plain, quantize_int8,
                                               quantize_int8_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    out, parity = {}, {}
    for where, (n, d) in QUANT_TIMING_SHAPES.items():
        x = torch.randn(n, d, generator=gen, device="cuda")
        dt = torch.bfloat16 if where.startswith("A1") else torch.float32
        codes = {"int8": quantize_int8(x), "fp8": quantize_fp8(x)}
        for fmt, (q, s) in codes.items():
            qname = f"quantize_{fmt}"
            qk = quantize_int8 if fmt == "int8" else quantize_fp8
            qp = quantize_int8_plain if fmt == "int8" else quantize_fp8_plain
            dk = dequantize_int8 if fmt == "int8" else dequantize_fp8
            q_p, s_p = qp(x)
            differ = {qname: _differs(q, q_p) + _differs(s, s_p),
                      "de" + qname: _differs(dk(q, s, dt),
                                             dequantize_plain(q, s, dt))}
            del q_p, s_p
            parity.setdefault(where, {}).update(differ)
            for name, n_diff in differ.items():
                check(n_diff == 0, f"{name} at {where} {[n, d]}: {n_diff} "
                      "codes, scales or outputs differ from the plain version")
            q_bytes = x.numel() * 4 + q.numel() + s.numel() * 4
            d_bytes = q.numel() + s.numel() * 4 + q.numel() * dt.itemsize
            for name, fn, plain, nbytes in (
                    (qname, lambda: qk(x), lambda: qp(x), q_bytes),
                    ("de" + qname, lambda: dk(q, s, dt),
                     lambda: dequantize_plain(q, s, dt), d_bytes)):
                bound_ms, bound_by = _quant_bound(nbytes)
                ms, entries = _stem_entries_ms(fn, name, iters=20)
                row = {"ms": ms, "entries": entries,
                       "wrapper_ms": time_ms(fn, iters=20),
                       "plain_ms": time_ms(plain, iters=3),
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": None, "bytes": nbytes}
                out.setdefault(name, {})[where] = row
        del x, codes
        torch.cuda.empty_cache()
    widths = _qgz_width_timing(gen)
    emit({"phase": "quant_timing", "shapes": {k: list(v) for k, v in
                                              QUANT_TIMING_SHAPES.items()},
          "input": "fp32; dequantize to bf16 at A1_w_gate, fp32 at B_lm_head",
          "quantize_int8_qgz_widths": widths,
          "elements_differing_from_plain": parity,
          "kernels": {k: {w: {**r, "share_of_bound": r["bound_ms"] / r["ms"]}
                          for w, r in v.items()} for k, v in out.items()},
          "library": "no single PyTorch call computes these functions",
          "card": dev["kind"], "nvidia_smi": smi_line})
    # the kernels line: each kernel at the shape of its main path
    path_shape = {"quantize_fp8": "A1_w_gate", "dequantize_fp8": "A1_w_gate",
                  "quantize_int8": "B_lm_head", "dequantize_int8": "B_lm_head"}
    return {k: {key: out[k][w][key] for key in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for k, w in path_shape.items()}


# ---------------------------------------------------------------------------
# phase 3d: the evoformer kernels vs their plain versions, the E1-E4 path
# and the kernels' times
# ---------------------------------------------------------------------------
EVO_KERNELS = ("evo_fwd", "evo_dq", "evo_dkv", "evo_dbias2", "evo_dbias1")
EVO_OUTPUTS = ("out", "lse", "dq", "dk", "dv", "db1", "db2")
# db1/db2, kernel vs plain: share of each panel's largest |plain| value (a
# panel is one (b, n) key row of db1, one (b, h) [Lq, Lk] panel of db2);
# both sides sum the same fp32 dS in other orders
DB_REL = 1e-3
EVO_MASKED = 0.1                   # share of keys OpenFold's mask removes

# name, shape: (B, N, Lq, Lk, H, D, dtype, bias1, bias2). Every head dim in
# both dtypes, every bias combination, L never a multiple of the tiles,
# Lq != Lk; the d8 bf16 case has 2,400 (b, n, h) rows (4,800 forward blocks,
# more than the card holds at once) and a 150-row dbias2 loop, the d32 one
# OpenFold's widths with a shorter N. Then three for the bf16 forward's
# groups of MSA rows: D = 8 with a pair bias over Lk = 130 (4-byte bias
# copies, a partial key tile), a group whose last row is OpenFold's fully
# masked one, N = 7 not a multiple of the group of 4. The last two are for
# the bf16 backward: N = 37 over at least three dbias2 splits, the last
# one short; Lq = 65, whose last 64-row query tile has one live row (4-byte
# lse/delta copies)
EVO_CASES = [
    ("d8_fp32_both", (2, 3, 100, 100, 4, 8, torch.float32, True, True)),
    ("d16_fp32_mask_lq_ne_lk", (2, 2, 70, 130, 4, 16, torch.float32, True, False)),
    ("d32_fp32_pair", (2, 2, 200, 200, 4, 32, torch.float32, False, True)),
    ("d64_fp32_none_lq_ne_lk", (1, 2, 50, 96, 2, 64, torch.float32, False, False)),
    ("d128_fp32_both", (2, 2, 80, 80, 2, 128, torch.float32, True, True)),
    ("d8_bf16_many_rows", (2, 150, 40, 72, 8, 8, torch.bfloat16, True, True)),
    ("d16_bf16_pair", (2, 4, 130, 130, 4, 16, torch.bfloat16, False, True)),
    ("d32_bf16_openfold", (2, 8, 384, 384, 8, 32, torch.bfloat16, True, True)),
    ("d64_bf16_mask_lq_ne_lk", (1, 3, 100, 200, 4, 64, torch.bfloat16, True, False)),
    ("d128_bf16_both", (2, 2, 130, 130, 4, 128, torch.bfloat16, True, True)),
    ("d8_bf16_pair_lk130", (2, 6, 100, 130, 4, 8, torch.bfloat16, False, True)),
    ("d32_bf16_masked_row_n7", (1, 7, 130, 130, 4, 32, torch.bfloat16, True, True)),
    ("d16_bf16_both_n9", (2, 9, 64, 200, 2, 16, torch.bfloat16, True, True)),
    ("d32_bf16_both_n37_splits", (2, 37, 130, 130, 2, 32, torch.bfloat16, True, True)),
    ("d8_bf16_pair_lq65", (2, 3, 65, 100, 2, 8, torch.bfloat16, False, True)),
]


def _evo_inputs(gen, b, n, lq, lk, h, d, dtype, with_b1, with_b2):
    """Seeded canonical (q, k, v, dO) on the card, bias1 [B, N, Lk] (normal,
    with EVO_MASKED of the keys at -1e9 and row (0, N-1) fully masked) and
    bias2 [B, H, Lq, Lk] (normal), each None when not asked for."""
    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")
    q, do = (rnd(b, n, lq, h, d).to(dtype) for _ in range(2))
    k, v = (rnd(b, n, lk, h, d).to(dtype) for _ in range(2))
    b1 = b2 = None
    if with_b1:
        b1 = rnd(b, n, lk)
        b1[torch.rand(b, n, lk, generator=gen, device="cuda") < EVO_MASKED] = -1e9
        b1[0, n - 1] = -1e9
    if with_b2:
        b2 = rnd(b, h, lq, lk)
    return (q, k, v, do), b1, b2


def _evo_plain_all(args, b1, b2, res=None):
    """(out, lse, dq, dk, dv, db1, db2) of the plain versions; the backward
    runs on ``res`` (the kernel's own out, lse) where given."""
    from deepspeed_tpu_torch.ops.evoformer import evo_bwd_plain, evo_fwd_plain
    q, k, v, do = args
    out, lse = evo_fwd_plain(q, k, v, b1, b2)
    grads = evo_bwd_plain(q, k, v, b1, b2, *(res or (out, lse)), do)
    return [out, lse, *grads]


def _evo_tol(name, want):
    if want is None:
        return None
    if name == "lse":
        return torch.full_like(want, LSE_TOL)
    if name == "db1":
        return DB_REL * want.abs().amax(-1, keepdim=True)
    if name == "db2":
        return DB_REL * want.abs().amax((-2, -1), keepdim=True)
    return _row_tol(want)


# Mutants: the plain versions with one fault a kernel could have. Each takes
# (args, b1, b2, res, want) and returns the seven outputs; each must land
# outside the tolerance on the outputs it names (on one at least for ANY).
def _evo_b1_dropped_in_bwd(args, b1, b2, res, want):
    """The backward's recompute leaves bias1 out."""
    from deepspeed_tpu_torch.ops.evoformer import evo_bwd_plain
    q, k, v, do = args
    dq, dk, dv, _, db2 = evo_bwd_plain(q, k, v, None, b2, *res, do)
    return want[:2] + [dq, dk, dv, want[5], db2]


def _evo_scaled_bias_grad(args, b1, b2, res, want):
    """The bias gradients carry ``scale`` as dq and dk do."""
    scale = 1.0 / math.sqrt(args[0].shape[-1])
    return want[:5] + [None if g is None else g * scale for g in want[5:]]


def _evo_last_key_tile_dropped(args, b1, b2, res, want):
    """The last KEY_TILE-key tile is skipped everywhere."""
    from deepspeed_tpu_torch.ops.evoformer import KEY_TILE, NEG_INF
    lk = args[1].shape[2]
    b1m = torch.zeros(*args[0].shape[:2], lk, device=args[0].device) \
        if b1 is None else b1.clone()
    b1m[..., (lk - 1) // KEY_TILE * KEY_TILE:] = NEG_INF
    got = _evo_plain_all(args, b1m, b2)
    got[5] = got[5] if b1 is not None else None
    return got


def _evo_db2_wrong_batch(args, b1, b2, res, want):
    """Panel b of db2 sums the rows of batch entry b + 1."""
    from deepspeed_tpu_torch.ops.evoformer import evo_bwd_plain
    roll = lambda x: None if x is None else torch.roll(x, 1, 0)   # noqa: E731
    q, k, v, do = (roll(x) for x in args)
    db2 = evo_bwd_plain(q, k, v, roll(b1), b2, roll(res[0]), roll(res[1]),
                        do, need_db1=False)[4]
    return want[:6] + [db2]


def _evo_pair_of_next_head(args, b1, b2, res, want):
    """The forward scores head h with the pair panel of head (h + 1) mod H
    (a wrong panel index in a block that walks several MSA rows)."""
    from deepspeed_tpu_torch.ops.evoformer import evo_fwd_plain
    q, k, v, _ = args
    out, lse = evo_fwd_plain(q, k, v, b1, torch.roll(b2, -1, 1).contiguous())
    return [out, lse] + want[2:]


def _evo_last_query_tile_dropped(args, b1, b2, res, want):
    """The backward skips the last 64-row query tile (dO zeroed there, so
    its rows add nothing to dk, dv or db2)."""
    from deepspeed_tpu_torch.ops.evoformer import MMA_ROWS, evo_bwd_plain
    q, k, v, do = args
    lq = q.shape[2]
    do = do.clone()
    do[:, :, (lq - 1) // MMA_ROWS * MMA_ROWS:] = 0
    grads = evo_bwd_plain(q, k, v, b1, b2, *res, do)
    return want[:2] + list(grads[:3]) + [want[5], grads[4]]


def _evo_pair_transposed_in_bwd(args, b1, b2, res, want):
    """The backward's recompute reads the pair panel transposed (a slip of
    the S^T side's indexing; Lq = Lk only)."""
    from deepspeed_tpu_torch.ops.evoformer import evo_bwd_plain
    q, k, v, do = args
    grads = evo_bwd_plain(q, k, v, b1, b2.transpose(-1, -2).contiguous(),
                          *res, do)
    return want[:2] + list(grads)


def _evo_db2_split_dropped(args, b1, b2, res, want):
    """db2 leaves out the rows of the last split the wrapper launches at
    this shape (``dbias2_split_for``)."""
    from deepspeed_tpu_torch.ops.evoformer import (dbias2_split_for,
                                                   evo_bwd_plain)
    q, k, v, do = args
    b, n, lq, h, d = q.shape
    splits, per = dbias2_split_for(q.device, b, h, n, lq, k.shape[2], d,
                                   q.dtype)
    m = (splits - 1) * per
    if m == 0:
        return want[:6] + [torch.zeros_like(want[6])]
    rows = lambda x: None if x is None else x[:, :m].contiguous()  # noqa: E731
    db2 = evo_bwd_plain(rows(q), rows(k), rows(v), rows(b1), b2,
                        rows(res[0]), rows(res[1]), rows(do),
                        need_db1=False)[4]
    return want[:6] + [db2]


def _evo_dq_row_stats_of_group_neighbour(args, b1, b2, res, want):
    """dQ of each MSA row past the first of a bf16 dQ block's group
    (``evo_bwd_plan``'s ``dq`` group) takes the first row's lse and
    delta."""
    from deepspeed_tpu_torch.ops.evoformer import (_bwd_delta, evo_bwd_plain,
                                                   evo_bwd_plan)
    q, k, v, do = args
    out, lse = res
    n = q.shape[1]
    group = evo_bwd_plan(q.shape[-1], b2 is not None)["dq"]["group"]
    rows = torch.arange(n, device=q.device)
    first = rows - rows % group
    lse_m, delta_m = lse[:, first], _bwd_delta(out, do)[:, first]
    dq = evo_bwd_plain(q, k, v, b1, b2, out, lse_m, do, need_db1=False,
                       need_db2=False, delta=delta_m)[0]
    return want[:2] + [dq] + want[3:]


def _evo_dq_dead_keys_live(args, b1, b2, res, want):
    """dQ scores the keys past Lk in the last 64-key tile from their
    zero-filled K and V rows (and zero biases) and does not mask them."""
    from deepspeed_tpu_torch.ops.evoformer import KEY_TILE, evo_bwd_plain
    q, k, v, do = args
    pad = -k.shape[2] % KEY_TILE
    grow = lambda x, dim: torch.cat(   # noqa: E731
        [x, x.new_zeros(*x.shape[:dim], pad, *x.shape[dim + 1:])], dim)
    dq = evo_bwd_plain(q, grow(k, 2), grow(v, 2),
                       None if b1 is None else grow(b1, 2),
                       None if b2 is None else grow(b2, 3), *res, do,
                       need_db1=False, need_db2=False)[0]
    return want[:2] + [dq] + want[3:]


def _evo_db1_row_stats_of_group_neighbour(args, b1, b2, res, want):
    """db1 of each MSA row past the first of a bf16 dbias1 block's group
    (``evo_bwd_plan``'s ``dbias1`` group) is summed on the first row's lse
    and delta."""
    from deepspeed_tpu_torch.ops.evoformer import (_bwd_delta, evo_bwd_plain,
                                                   evo_bwd_plan)
    q, k, v, do = args
    out, lse = res
    n = q.shape[1]
    group = evo_bwd_plan(q.shape[-1], b2 is not None)["dbias1"]["group"]
    rows = torch.arange(n, device=q.device)
    first = rows - rows % group
    db1 = evo_bwd_plain(q, k, v, b1, b2, out, lse[:, first], do,
                        need_db2=False, delta=_bwd_delta(out, do)[:, first])[3]
    return want[:5] + [db1, want[6]]


def _evo_db1_dead_keys_live(args, b1, b2, res, want):
    """db1 writes the dead keys of the last 64-key tile (scored from their
    zero-filled K and V rows and zero biases, not masked) past the end of
    each (b, n) row, over the first keys of the rows after it: no store
    guard at Lk. In OpenFold's fully masked row exp(0 - lse) is infinite
    there."""
    from deepspeed_tpu_torch.ops.evoformer import KEY_TILE, evo_bwd_plain
    q, k, v, do = args
    lk = k.shape[2]
    pad = -lk % KEY_TILE
    grow = lambda x, dim: torch.cat(   # noqa: E731
        [x, x.new_zeros(*x.shape[:dim], pad, *x.shape[dim + 1:])], dim)
    db1_pad = evo_bwd_plain(q, grow(k, 2), grow(v, 2), grow(b1, 2),
                            None if b2 is None else grow(b2, 3), *res, do,
                            need_db2=False)[3]
    rows = db1_pad.shape[0] * db1_pad.shape[1]
    flat = want[5].reshape(-1).clone()
    dead = db1_pad.reshape(rows, lk + pad)[:, lk:]
    for r in range(rows):              # in row order: a later row's write wins
        at = (r + 1) * lk
        m = min(pad, flat.numel() - at)
        if m > 0:
            flat[at:at + m] = dead[r, :m]
    return want[:5] + [flat.reshape(want[5].shape), want[6]]


def _evo_mutants(shape):
    """{name: (mutant, outputs it must miss)} that apply to a case of
    EVO_CASES' shape."""
    from deepspeed_tpu_torch.ops.evoformer import KEY_TILE, evo_bwd_plan
    b, n, lq, lk, h, d, dtype, with_b1, with_b2 = shape
    mutants = {"last_key_tile_dropped": (_evo_last_key_tile_dropped,
                                         ("out", "dk", "dv")),
               "last_query_tile_dropped": (
                   _evo_last_query_tile_dropped,
                   ("dk", "dv") + (("db2",) if with_b2 else ()))}
    if with_b2 and lq == lk:
        mutants["pair_transposed_in_bwd"] = (_evo_pair_transposed_in_bwd,
                                             ("dk",))
    if with_b2:
        mutants["db2_split_dropped"] = (_evo_db2_split_dropped, ("db2",))
    if with_b2 and h >= 2:
        mutants["pair_of_next_head"] = (_evo_pair_of_next_head, ("out", "lse"))
    if with_b1:
        mutants["bias1_dropped_in_bwd"] = (_evo_b1_dropped_in_bwd, ANY)
    if with_b1 or with_b2:
        mutants["scale_on_bias_grad"] = (
            _evo_scaled_bias_grad,
            tuple(n for n, on in (("db1", with_b1), ("db2", with_b2)) if on))
    if with_b2 and b >= 2:
        mutants["db2_wrong_batch"] = (_evo_db2_wrong_batch, ("db2",))
    # the bf16 dQ's groups of MSA rows; its dead keys where the last key
    # tile has some and a fully masked row (lse near -1e9) overflows them
    if dtype == torch.bfloat16 and n >= 2 and \
            evo_bwd_plan(d, with_b2)["dq"]["group"] >= 2:
        mutants["dq_row_stats_of_group_neighbour"] = (
            _evo_dq_row_stats_of_group_neighbour, ("dq",))
    if with_b1 and lk % KEY_TILE:
        mutants["dq_dead_keys_live"] = (_evo_dq_dead_keys_live, ("dq",))
    # the bf16 dbias1's groups of MSA rows, and its store guard at Lk
    if dtype == torch.bfloat16 and with_b1 and n >= 2 and \
            evo_bwd_plan(d, with_b2)["dbias1"]["group"] >= 2:
        mutants["db1_row_of_group_neighbour"] = (
            _evo_db1_row_stats_of_group_neighbour, ("db1",))
    if dtype == torch.bfloat16 and with_b1 and lk % KEY_TILE and b * n >= 2:
        mutants["db1_dead_keys_live"] = (_evo_db1_dead_keys_live, ("db1",))
    return mutants


def _entries(fn, stem):
    """The exact entry names (``evo_fwd_kernel``, not a prefix of
    ``evo_fwd_kernel_mma``) of the CUDA kernels one call of ``fn``
    launches whose names hold ``stem``, from the profiler."""
    names = set()
    for e in _device_events(fn, 1):
        m = re.match(r"(?:void\s+)?(?:\(anonymous namespace\)::)?(\w+)", e.name)
        if m and stem in m.group(1):
            names.add(m.group(1))
    return sorted(names)


# the forward's entry by dtype: bf16 on the tensor cores, fp32 on CUDA cores
EVO_FWD_ENTRY = {torch.bfloat16: "evo_fwd_kernel_mma", torch.float32: "evo_fwd_kernel"}
# the backward's entries by dtype
EVO_BWD_ENTRY = {
    torch.bfloat16: {"evo_dq": "evo_dq_kernel_mma", "evo_dkv": "evo_dkv_kernel_mma",
                     "evo_dbias2": "evo_dbias2_kernel_mma",
                     "evo_dbias1": "evo_dbias1_kernel_mma"},
    torch.float32: {"evo_dq": "evo_dq_kernel", "evo_dkv": "evo_dkv_kernel",
                    "evo_dbias2": "evo_dbias2_kernel",
                    "evo_dbias1": "evo_dbias1_kernel"}}
DB2_COMBINE = "evo_dbias2_combine_kernel"


def _evo_bwd_entries(dtype, with_b1, with_b2, splits):
    """The exact entries one backward launches: dQ, dK/dV, dbias2 (and its
    combine for more than one split) with a pair bias, dbias1 with a
    mask."""
    want = dict(EVO_BWD_ENTRY[dtype])
    if not with_b1:
        del want["evo_dbias1"]
    if not with_b2:
        del want["evo_dbias2"]
    names = set(want.values())
    if with_b2 and splits > 1:
        names.add(DB2_COMBINE)
    return sorted(names)


def run_evo_cases(gen):
    """Every EVO_CASES case: the five kernels (each bias kernel where its
    bias is present) against the plain versions, each output within its
    tolerance and finite, each kernel launched exactly once, and each
    mutant that applies outside the tolerance on the outputs it names; the
    forward's and the backward's entries by exact profiler name (bf16
    ``evo_fwd_kernel_mma``, ``evo_dq_kernel_mma``, ``evo_dkv_kernel_mma``
    and ``evo_dbias2_kernel_mma`` plus its combine where the case takes more
    than one split; fp32 the CUDA-core kernels alone) and, in bf16, a second
    forward that repeats out and lse and a second backward that repeats
    every gradient bit for bit. Returns the rows; raises PhaseError on any
    failure. The ``gpu`` test runs this too."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.evoformer import (dbias2_split_for, evo_bwd,
                                                   evo_fwd)
    rows = []
    for name, shape in EVO_CASES:
        b, n, lq, lk, h, d, dtype, with_b1, with_b2 = shape
        args, b1, b2 = _evo_inputs(gen, *shape)
        q, k, v, do = args
        before = build.launch_counts()
        out, lse = evo_fwd(q, k, v, b1, b2)
        grads = evo_bwd(q, k, v, b1, b2, out, lse, do)
        torch.cuda.synchronize()
        after = build.launch_counts()
        want_n = {"evo_fwd": 1, "evo_dq": 1, "evo_dkv": 1,
                  "evo_dbias2": int(with_b2), "evo_dbias1": int(with_b1)}
        launched = {n: after.get(n, 0) - before.get(n, 0) for n in want_n}
        check(launched == want_n, f"evo {name}: launches {launched}, "
              f"expected {want_n}")
        entries = _entries(lambda: evo_fwd(q, k, v, b1, b2), "evo_")
        check(entries == [EVO_FWD_ENTRY[dtype]],
              f"evo {name}: the forward launched {entries}")
        splits = dbias2_split_for(q.device, b, h, n, lq, lk, d, dtype)[0]
        bwd_entries = _entries(
            lambda: evo_bwd(q, k, v, b1, b2, out, lse, do), "evo_")
        want_bwd = _evo_bwd_entries(dtype, with_b1, with_b2, splits)
        check(bwd_entries == want_bwd, f"evo {name}: the backward launched "
              f"{bwd_entries}, expected {want_bwd}")
        repeat = bwd_repeat = None
        if dtype == torch.bfloat16:
            again = evo_fwd(q, k, v, b1, b2)
            repeat = torch.equal(again[0], out) and torch.equal(again[1], lse)
            check(repeat, f"evo {name}: a second forward gave other bits")
            again = evo_bwd(q, k, v, b1, b2, out, lse, do)
            bwd_repeat = all(torch.equal(x, y) for x, y in zip(again, grads)
                             if x is not None)
            check(bwd_repeat, f"evo {name}: a second backward gave other bits")
            del again
        got = [out, lse, *grads]
        res = (out, lse)
        want = _evo_plain_all(args, b1, b2, res)
        tols = [_evo_tol(n, w) for n, w in zip(EVO_OUTPUTS, want)]
        check(all((g is None) == (w is None) for g, w in zip(got, want)),
              f"evo {name}: the kernels and the plain version return "
              "different sets of outputs")
        errs = {n: _max_err(g, w, n) for n, g, w in zip(EVO_OUTPUTS, got, want)
                if w is not None}
        ratios = {n: _err_ratio(g, w, t) for n, g, w, t in
                  zip(EVO_OUTPUTS, got, want, tols) if w is not None}
        finite = all(bool(torch.isfinite(g).all()) for g in got if g is not None)
        row = {"phase": "evo_parity", "case": name,
               "shape": dict(zip(("b", "n", "lq", "lk", "h", "d"), shape[:6]),
                             dtype=str(dtype), bias1=with_b1, bias2=with_b2),
               "max_abs_err": errs, "err_over_tol": ratios, "finite": finite,
               "launches": launched, "fwd_entries": entries,
               "bwd_entries": bwd_entries, "dbias2_splits": splits,
               "fwd_repeats_bit_for_bit": repeat,
               "bwd_repeats_bit_for_bit": bwd_repeat, "mutants": {}}
        mutants = _evo_mutants(shape)
        for m_name, (mutant, _) in mutants.items():
            m_want = mutant(args, b1, b2, res, want)
            row["mutants"][m_name] = {
                n: _json_ratio(_err_ratio(m, w, t)) for n, m, w, t in
                zip(EVO_OUTPUTS, m_want, want, tols)
                if w is not None and m is not None}
            del m_want
        emit(row)
        check(finite, f"evo {name}: non-finite output")
        for n, r in ratios.items():
            check(r <= 1.0, f"evo {name}: {n} error {r} times its tolerance")
        for m_name, (_, must) in mutants.items():
            m_ratios = row["mutants"][m_name]
            caught = (max(m_ratios.values()) > 1.0 if must == ANY else
                      all(m_ratios[n] > 1.0 for n in must))
            check(caught, f"evo {name}: mutant {m_name} lands within the "
                  f"tolerance of {must} ({m_ratios}), so the case cannot "
                  "catch that fault")
        rows.append(row)
        del args, got, want, out, lse, grads, res
    return rows


def phase_evo_parity():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    rows = run_evo_cases(gen)
    outs = {"evo_fwd": ("out", "lse"), "evo_dq": ("dq",),
            "evo_dkv": ("dk", "dv"), "evo_dbias2": ("db2",),
            "evo_dbias1": ("db1",)}
    worst = {n: 0.0 for n in EVO_KERNELS}
    worst_ratio = {n: 0.0 for n in EVO_KERNELS}
    for row in rows:
        for kernel, names in outs.items():
            for o in names:
                if o in row["max_abs_err"]:
                    worst[kernel] = max(worst[kernel], row["max_abs_err"][o])
                    worst_ratio[kernel] = max(worst_ratio[kernel],
                                              row["err_over_tol"][o])
    emit({"phase": "evo_parity_summary", "cases": len(rows),
          "worst_err_over_tol": worst_ratio, "db_rel_tol": DB_REL,
          "mutants_caught": sorted({m for r in rows for m in r["mutants"]})})
    return worst


# OpenFold's published widths (openfold/config.py: model.evoformer_stack,
# model.extra_msa; fine-tuning crop_size 384, max_msa_clusters 512,
# max_extra_msa 5120; AlphaFold2 supplement Table 4), B = 1, bf16:
# name: (call, N, L, H, D, pair bias, mask bias takes a gradient)
EVO_PATH_CASES = {
    "E1": ("MSA row attention with pair bias", 512, 384, 8, 32, True, True),
    "E2": ("MSA column attention", 384, 512, 8, 32, False, False),
    "E3": ("triangle attention, starting node", 384, 384, 4, 32, True, False),
    "E4": ("extra-MSA row attention with pair bias", 5120, 384, 8, 8, True,
           False),
}


def _evo_path_inputs(gen, n, l, h, d, pair):
    """q/k/v/w [1, N, L, H, D] bf16, OpenFold's mask bias ``1e9 * (mask -
    1)`` [1, N, 1, 1, L] (EVO_MASKED of the keys masked, row N-1 fully) and
    the pair bias [1, 1, H, L, L] (or None), seeded on the card."""
    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")
    q, k, v, w = (rnd(1, n, l, h, d).to(torch.bfloat16) for _ in range(4))
    keep = (torch.rand(1, n, 1, 1, l, generator=gen, device="cuda")
            >= EVO_MASKED).float()
    keep[0, n - 1] = 0.0
    mask = 1e9 * (keep - 1.0)
    pair_bias = rnd(1, 1, h, l, l) if pair else None
    return (q, k, v, w), mask, pair_bias


def phase_evoformer(dev, smi_line):
    """E1-E4 through ``DS4Sci_EvoformerAttention``: forward, then
    ``.backward()`` of a seeded weighted sum, gradients to q, k, v and the
    pair bias (and in E1 the mask bias). Each case's launches are counted
    from 0 around that run and held exactly; the output and every gradient
    is held against the chunked plain versions (on the kernel's own out and
    lse), and a second backward gives the same bits. Returns the launches
    summed over the cases."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.evoformer import (canonicalize, evo_bwd,
                                                   evo_fwd)
    from deepspeed_tpu_torch.ops.evoformer_attn import DS4Sci_EvoformerAttention
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    total = {}
    for name, (call, n, l, h, d, pair, mask_grad) in EVO_PATH_CASES.items():
        (q, k, v, w), mask, pair_bias = _evo_path_inputs(gen, n, l, h, d, pair)
        for x in (q, k, v):
            x.requires_grad_(True)
        mask.requires_grad_(mask_grad)
        if pair_bias is not None:
            pair_bias.requires_grad_(True)
        biases = [mask, pair_bias]
        torch.cuda.synchronize()
        build.reset_launch_counts()      # the main path's run starts here
        t0 = time.monotonic()
        out = DS4Sci_EvoformerAttention(q, k, v, biases)
        (out.float() * w.float()).sum().backward()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
        launches = build.launch_counts()
        for kname, count in launches.items():
            total[kname] = total.get(kname, 0) + count
        want_n = {"evo_fwd": 1, "evo_dq": 1, "evo_dkv": 1}
        if pair:
            want_n["evo_dbias2"] = 1
        if mask_grad:
            want_n["evo_dbias1"] = 1
        # the plain versions on the kernel's own (out, lse)
        with torch.no_grad():
            q5, k5, v5, b1, b2 = canonicalize(q.detach(), k.detach(),
                                              v.detach(), [mask.detach(),
                                                           pair_bias])
            b1 = b1.contiguous()
            b2 = None if b2 is None else b2.detach().contiguous()
            out_k, lse_k = evo_fwd(q5, k5, v5, b1, b2)
            do = w
            again = evo_bwd(q5, k5, v5, b1, b2, out_k, lse_k, do,
                            need_db1=mask_grad, need_db2=pair)
            want = _evo_plain_all((q5, k5, v5, do), b1, b2, (out_k, lse_k))
            # need_db1 as on the path: the plain db1 only where asked
            want[5] = want[5] if mask_grad else None
        got = [out.detach(), lse_k, q.grad, k.grad, v.grad,
               None if not mask_grad else mask.grad.reshape(1, n, l),
               None if pair_bias is None else pair_bias.grad.reshape(1, h, l, l)]
        tols = [_evo_tol(nm, x) for nm, x in zip(EVO_OUTPUTS, want)]
        ratios = {nm: _err_ratio(g, x, t) for nm, g, x, t in
                  zip(EVO_OUTPUTS, got, want, tols) if x is not None}
        repeat = [torch.equal(a, b) for a, b in
                  zip(again, got[2:]) if a is not None]
        finite = all(bool(torch.isfinite(g).all()) for g in got
                     if g is not None)
        emit({"phase": "evoformer", "case": name, "call": call,
              "shape": {"q": [1, n, l, h, d], "mask": [1, n, 1, 1, l],
                        "pair": [1, 1, h, l, l] if pair else None},
              "grads": ["q", "k", "v"] + (["pair"] if pair else []) +
                       (["mask"] if mask_grad else []),
              "launches": launches, "expected": want_n,
              "err_over_tol": ratios, "finite": finite,
              "same_out_as_path": torch.equal(out_k, out.detach()),
              "backward_repeats_bit_for_bit": all(repeat),
              "wall_ms_fwd_bwd": wall_ms,
              "card": dev["kind"], "nvidia_smi": smi_line})
        check(launches == want_n, f"evoformer {name}: launches {launches}, "
              f"expected {want_n}")
        check(finite, f"evoformer {name}: non-finite output or gradient")
        check(out.shape == q.shape, f"evoformer {name}: output {out.shape}")
        for nm, r in ratios.items():
            check(r <= 1.0, f"evoformer {name}: {nm} {r} times its tolerance")
        check(all(repeat) and torch.equal(out_k, out.detach()),
              f"evoformer {name}: a rerun gave other bits")
        del q, k, v, w, mask, pair_bias, out, got, want, again
        gc.collect()
        torch.cuda.empty_cache()
    return total


def _evo_work(b, n, lq, lk, h, d, elem):
    """(flops of one [Lq, Lk, D] product over all rows, {kernel: unique
    bytes}), each input read once and each output written once."""
    mm = 2 * b * n * h * lq * lk * d
    qo = b * n * lq * h * d * elem                 # q, out, dO or dq
    kv = b * n * lk * h * d * elem                 # k, v, dk or dv
    stats = b * n * h * lq * 4                     # lse or delta
    bias = b * n * lk * 4 + b * h * lq * lk * 4    # bias1 + bias2 (fp32)
    bwd_in = 2 * qo + 2 * kv + bias + 2 * stats    # q k v dO b1 b2 lse delta
    return mm, {"evo_fwd": 2 * qo + 2 * kv + bias + stats,
                "evo_dq": bwd_in + qo, "evo_dkv": bwd_in + 2 * kv,
                "evo_dbias2": bwd_in + b * h * lq * lk * 4,
                "evo_dbias1": bwd_in + b * n * lk * 4}


def _sdpa_yardstick(q5, k5, v5, b1, b2):
    """One ``F.scaled_dot_product_attention`` over the same problem (rows
    [B*N, H, L, D], the summed bias materialized as a bf16 ``attn_mask``),
    forward and backward (q, k, v and the mask), on the first backend that
    takes it, each by the device time of every kernel it launches; a
    yardstick only, the port never calls it."""
    import torch.nn.functional as F
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel
    except ImportError as e:
        return {"backend": "none", "errors": {"import": str(e)}}
    b, n, lq, h, d = q5.shape
    lk = k5.shape[2]
    rows = lambda x: x.permute(0, 1, 3, 2, 4).reshape(b * n, h, -1, d)  # noqa: E731
    qs, ks, vs = (rows(x).contiguous() for x in (q5, k5, v5))
    mask = torch.zeros(b, n, h, lq, lk, dtype=q5.dtype, device=q5.device)
    if b1 is not None:
        mask += b1.to(q5.dtype)[:, :, None, None, :]
    if b2 is not None:
        mask += b2.to(q5.dtype)[:, None]
    mask = mask.reshape(b * n, h, lq, lk)
    errors = {}
    for name, backend in (("efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION)):
        try:
            with sdpa_kernel([backend]):
                fwd_ms = _call_device_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask), iters=5)
                leaves = [x.detach().requires_grad_() for x in (qs, ks, vs, mask)]
                o = F.scaled_dot_product_attention(*leaves[:3],
                                                   attn_mask=leaves[3])
                g = torch.ones_like(o)
                bwd_ms = _call_device_ms(lambda: torch.autograd.grad(
                    o, leaves, g, retain_graph=True), iters=5)
                del o, leaves, g
            return {"backend": name, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
                    "fwd_plus_bwd_ms": fwd_ms + bwd_ms, "errors": errors}
        except RuntimeError as e:
            errors[name] = str(e).splitlines()[0][:200] if str(e) else "error"
        finally:
            torch.cuda.empty_cache()
    return {"backend": "none", "errors": errors}


def _entry_ms(fn, iters):
    """{exact entry name: mean device ms per call} of every CUDA kernel one
    call of ``fn`` launches (profiler; a window that lost events is taken
    again, as in ``_kernel_device_ms``)."""
    for _ in range(PROFILE_TRIES):
        durations = {}
        for e in _device_events(fn, iters):
            m = re.match(r"(?:void\s+)?(?:\(anonymous namespace\)::)?(\w+)", e.name)
            if m:
                durations.setdefault(m.group(1), []).append(e.time_range.elapsed_us())
        if all(len(t) % iters == 0 for t in durations.values()):
            break
    return {k: _per_call_ms(t, iters) for k, t in durations.items()}


def _stem_entries_ms(fn, stem, iters=20):
    """(mean device ms per call, entry names) of the CUDA kernels of one
    call of ``fn`` whose exact entry name is ``stem`` or ``stem_<path>``
    (``quantize_int8_block``, not ``dequantize_int8``); raises if there is
    none."""
    per = {e: t for e, t in _entry_ms(fn, iters).items()
           if e == stem or e.startswith(stem + "_")}
    check(per, f"the profiler saw no kernel entry named {stem!r} or "
          f"{stem + '_...'!r}")
    return sum(per.values()), sorted(per)


DB2_SPLIT_SWEEP = (1, 2, 4, 8, 16)


def _evo_l2_reads(n, l, h, d, group, pair, dq_group):
    """L2 read bytes of the bf16 dQ, dK/dV and dbias2 tilings at B = 1, Lq
    = Lk = l, beside those of the CUDA-core kernels they replace (dQ: 32
    query rows a block and one MSA row; dK/dV: 32 keys a block and one MSA
    row; dbias2: 32 query rows x 64 keys)."""
    row = n * l * h * d * 2                        # one of q, k, v, dO
    t64, t32 = -(-l // 64), -(-l // 32)
    panel = h * l * l * 4 if pair else 0
    return {
        "evo_dq": {"kv": 2 * t64 * row, "kv_before": 2 * t32 * row,
                   "pair_panel": -(-n // dq_group) * panel,
                   "pair_panel_before": n * panel},
        "evo_dkv": {"qdo": 2 * t64 * row, "qdo_before": 2 * t32 * row,
                    "pair_panel": -(-n // group) * panel,
                    "pair_panel_before": n * panel},
        "evo_dbias2": {"qdo_kv": 2 * t64 * row + 2 * t64 * row,
                       "qdo_kv_before": 2 * t64 * row + 2 * t32 * row}}


def phase_evo_timing(dev, smi_line):
    """At E1 and E4: each kernel's time by the profiler's device time, by
    exact entry name (the forward alone, beside its wrapper call by CUDA
    events; the backward kernels in one profiled backward: dQ, dK/dV and
    dbias2 with its combine, and at E1 dbias1, whose mask takes a gradient
    there alone), each against its bound from ``_evo_work``; the bf16
    tilings' L2 reads beside the CUDA-core kernels'; dbias2 at forced split
    counts beside the wrapper's plan; at E1 the plain versions (whole
    forward, whole backward); at both the SDPA yardstick. Returns the
    kernels line's numbers (E1)."""
    from deepspeed_tpu_torch.ops import evoformer as te
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    timing, sdpa, fwd, bwd = {}, {}, {}, {}
    flops_of = {"evo_fwd": 2, "evo_dq": 3, "evo_dkv": 4, "evo_dbias2": 2,
                "evo_dbias1": 2}                   # [Lq, Lk, D] products
    for name in ("E1", "E4"):
        _, n, l, h, d, pair, mask_grad = EVO_PATH_CASES[name]
        (q, k, v, do), mask, pair_bias = _evo_path_inputs(gen, n, l, h, d, pair)
        q5, k5, v5, b1, b2 = te.canonicalize(q, k, v, [mask, pair_bias])
        b1, b2 = b1.contiguous(), b2.contiguous()
        call = lambda: te.evo_fwd(q5, k5, v5, b1, b2)  # noqa: E731
        mm, nbytes = _evo_work(1, n, l, l, h, d, 2)
        bound_ms, bound_by = _bound(2 * mm, nbytes["evo_fwd"])
        plan = te.evo_fwd_plan(d, pair)
        bplan = te.evo_bwd_plan(d, pair)
        fwd[name] = {
            "ms": _kernel_device_ms(call, ["evo_fwd_kernel"])["evo_fwd_kernel"],
            "wrapper_ms": time_ms(call, iters=10), "bound_ms": bound_ms,
            "bound_by": bound_by, "plan": plan,
            # L2 reads of the tiling: K/V once per 64-row query tile, the
            # pair panel once per group of rows and query tile
            "l2_read_bytes": {
                "kv": 2 * -(-l // 64) * n * l * h * d * 2,
                "pair_panel": -(-n // plan["group"]) * h * l * l * 4 if pair else 0}}
        out, lse = call()
        bwd_call = lambda: te.evo_bwd(q5, k5, v5, b1, b2, out, lse, do,  # noqa: E731
                                      need_db1=mask_grad)
        entries = _entry_ms(bwd_call, iters=5 if name == "E1" else 3)
        splits, per = te.dbias2_split_for(q5.device, 1, h, n, l, l, d,
                                          torch.bfloat16)
        want = _evo_bwd_entries(torch.bfloat16, mask_grad, pair, splits)
        got = sorted(e for e in entries if e.startswith("evo_"))   # not delta's
        check(got == want, f"evo_timing {name}: the backward launched "
              f"{got}, expected {want}")
        names = EVO_BWD_ENTRY[torch.bfloat16]
        kernels = ["evo_dq", "evo_dkv", "evo_dbias2"] + (
            ["evo_dbias1"] if mask_grad else [])
        per_kernel = {kn: entries[names[kn]] for kn in kernels}
        per_kernel["evo_dbias2"] += entries.get(DB2_COMBINE, 0.0)
        # dbias2 at forced split counts, the plan's beside (CUDA events over
        # the launches alone: the kernel and its combine)
        ints = (1, n, l, l, h, d)
        delta = te._bwd_delta(out, do)
        db2 = torch.empty(1, h, l, l, device="cuda")
        sweep = {}
        for sp in sorted(set(DB2_SPLIT_SWEEP) | {splits}):
            if -(-n // -(-n // sp)) != sp:         # a count that leaves a split empty
                continue
            sweep[str(sp)] = time_ms(lambda: te._launch_dbias2(
                ints, q5, k5, v5, b1, b2, do, lse, delta, db2, splits=sp),
                iters=3, warmup=1)
        bwd[name] = {
            "entries_ms": entries,
            **{kn: {"ms": per_kernel[kn],
                    "bound_ms": _bound(flops_of[kn] * mm, nbytes[kn])[0],
                    "bound_by": _bound(flops_of[kn] * mm, nbytes[kn])[1],
                    "share_of_bound": _bound(flops_of[kn] * mm,
                                             nbytes[kn])[0] / per_kernel[kn]}
               for kn in kernels},
            "dq_plan": bplan["dq"], "dkv_plan": bplan["dkv"],
            "dbias2_plan": bplan["dbias2"],
            "dbias2_splits": {"plan": splits, "rows_per_split": per,
                              "blocks_per_sm": te.dbias2_blocks_per_sm(
                                  q5.device, d),
                              "forced_ms": sweep},
            "l2_read_bytes": _evo_l2_reads(n, l, h, d, bplan["dkv"]["group"],
                                           pair, bplan["dq"]["group"])}
        if name == "E1":
            plain_fwd = time_ms(lambda: te.evo_fwd_plain(q5, k5, v5, b1, b2),
                                iters=2, warmup=1)
            plain_bwd = time_ms(lambda: te.evo_bwd_plain(
                q5, k5, v5, b1, b2, out, lse, do), iters=2, warmup=1)
            for kn in EVO_KERNELS:
                bound_ms, bound_by = _bound(flops_of[kn] * mm, nbytes[kn])
                timing[kn] = {
                    "ms": fwd[name]["ms"] if kn == "evo_fwd" else per_kernel[kn],
                    "plain_ms": plain_fwd if kn == "evo_fwd" else plain_bwd,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "flops": flops_of[kn] * mm, "bytes": nbytes[kn]}
            timing["evo_fwd"]["wrapper_ms"] = fwd[name]["wrapper_ms"]
        del out, lse, delta, db2
        sdpa[name] = _sdpa_yardstick(q5, k5, v5, b1, b2)
        fwd[name]["sdpa_fwd_ms"] = sdpa[name].get("fwd_ms")
        bwd[name]["sdpa_bwd_ms"] = sdpa[name].get("bwd_ms")
        del q, k, v, do, mask, pair_bias, q5, k5, v5, b1, b2
        gc.collect()
        torch.cuda.empty_cache()
    e1 = sdpa["E1"]
    for kn in EVO_KERNELS:
        timing[kn]["library_ms"] = (None if e1["backend"] == "none" else
                                    e1["fwd_ms"] if kn == "evo_fwd" else
                                    e1["bwd_ms"])
    emit({"phase": "evo_timing", "shape": "E1: B=1 N=512 L=384 H=8 D=32 "
          "bf16, mask + pair bias, both bias gradients; E4: B=1 N=5120 "
          "L=384 H=8 D=8 bf16, mask + pair bias, the pair bias's gradient",
          **{kn: {**t, "share_of_bound": t["bound_ms"] / t["ms"]}
             for kn, t in timing.items()},
          "evo_fwd_by_path": fwd, "evo_bwd_by_path": bwd, "sdpa": sdpa,
          "notes": "ms: profiler device time by exact entry name (dbias2: "
                   "kernel + combine; its forced split counts by CUDA "
                   "events); plain_ms of the four backward "
                   "kernels is the whole plain backward; library_ms of them "
                   "is one SDPA backward (q, k, v, mask) at E1, by device "
                   "time",
          "card": dev["kind"], "nvidia_smi": smi_line})
    return {kn: {key: t[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}
            for kn, t in timing.items()}


# ---------------------------------------------------------------------------
# phase 3e: slice 5 — RMSNorm, fused bias + activation (+ dropout) and
# block-sparse attention: each kernel vs its plain version, the S1, S2, R
# and F paths, and the kernels' times
# ---------------------------------------------------------------------------
F32_ULPS = 4            # fp32 row-kernel outputs: ulps of each row's max |plain|
REDUCE_REL = 1e-5       # db, dscale: share of their largest |plain|
RMS_EPS = 1e-5          # Meta's Llama-3 config
DROPOUT_RATE = 0.1      # BERT's published hidden dropout
BLOCK_ROWS = 256        # the reference's default block_rows (the db mutant)
RMS_MUTANTS = ("eps_dropped", "mean_over_d_minus_1")

# name, (N, D, x dtype, scale dtype, x std), mutants that must land outside.
# fp32 and bf16, N never a multiple of a block, D odd and unaligned, two
# shapes with more rows than one grid pass holds (20011 rows of the warp
# kernel, 2500 of the block kernel), Llama-3-8B's width; a bf16 case with
# x at 1e-3, where eps outweighs the mean of squares
RMS_CASES = [
    ("f32_w64_many_rows", (20011, 64, torch.float32, torch.float32, 1.0), RMS_MUTANTS),
    ("f32_w4096", (1001, 4096, torch.float32, torch.float32, 1.0), RMS_MUTANTS),
    ("f32_w3001_bf16_scale", (257, 3001, torch.float32, torch.bfloat16, 1.0),
     RMS_MUTANTS),
    ("bf16_w4096", (1001, 4096, torch.bfloat16, torch.bfloat16, 1.0), ()),
    ("bf16_w100_f32_scale", (3001, 100, torch.bfloat16, torch.float32, 1.0), ()),
    ("bf16_w2048_many_rows", (2500, 2048, torch.bfloat16, torch.bfloat16, 1.0), ()),
    ("bf16_small_x", (513, 256, torch.bfloat16, torch.bfloat16, 1e-3), ("eps_dropped",)),
]

# name, (N, D, dtype, act, rate, offset): every activation in both dtypes,
# D odd or not a multiple of 4 (element-wise accesses, quads across two
# Philox counters), N uneven, [140001, 6] and [4097, 3072] with more rows
# than one grid pass holds; bf16 D a multiple of 4 but not of 8 and views
# 8 bytes in (the 4-column path where 8 columns would not align), N odd over
# the dropout kernels' unrolled passes, one row, rate 0.999; rate 0 runs
# the two plain kernels only. x and g are views ``offset`` elements into
# their allocations.
BIAS_ACT_CASES = [
    ("f32_gelu", (1000, 3072, torch.float32, "gelu", 0.1, 0)),
    ("f32_relu_uneven", (1001, 100, torch.float32, "relu", 0.0, 0)),
    ("f32_silu_d1001", (777, 1001, torch.float32, "silu", 0.25, 0)),
    ("f32_identity", (300, 512, torch.float32, "identity", 0.5, 0)),
    ("bf16_gelu_bert", (4097, 3072, torch.bfloat16, "gelu", 0.1, 0)),
    ("bf16_relu_d6_many_rows", (140001, 6, torch.bfloat16, "relu", 0.3, 0)),
    ("bf16_silu_w4096", (513, 4096, torch.bfloat16, "silu", 0.0, 0)),
    ("bf16_identity_d1001", (1003, 1001, torch.bfloat16, "identity", 0.2, 0)),
    ("bf16_gelu_d3076", (1000, 3076, torch.bfloat16, "gelu", 0.1, 0)),
    ("bf16_gelu_view_8_bytes_in", (1000, 3072, torch.bfloat16, "gelu", 0.1, 4)),
    ("bf16_gelu_n1001", (1001, 3072, torch.bfloat16, "gelu", 0.1, 0)),
    ("bf16_silu_one_row", (1, 3072, torch.bfloat16, "silu", 0.1, 0)),
    ("bf16_gelu_rate_0999", (2048, 1024, torch.bfloat16, "gelu", 0.999, 0)),
]
BIAS_ACT_KERNELS = ("bias_act", "bias_act_bwd", "bias_act_dropout",
                    "bias_act_dropout_bwd")


def _elem_tol(want):
    """Tolerance of a row kernel's output: 1 bf16 ulp of each plain value
    (0 where it is 0), or F32_ULPS fp32 ulps of each row's largest
    |plain|."""
    if want.dtype == torch.bfloat16:
        a, ulps, bits = want.float().abs(), 1, 7
    else:
        a, ulps, bits = want.float().abs().amax(-1, keepdim=True), F32_ULPS, 23
    ulp = torch.exp2(torch.floor(torch.log2(a.clamp_min(1e-30))) - bits)
    return torch.where(a > 0, ulps * ulp, torch.zeros_like(a))


def _reduce_tol(want):
    """db, dscale: REDUCE_REL of the largest |plain| value."""
    return (REDUCE_REL * want.float().abs().max()).reshape(1)


def _rms_mutant(name, x, scale):
    from deepspeed_tpu_torch.ops.rms_norm import rms_norm_plain
    if name == "eps_dropped":
        return rms_norm_plain(x, scale, 0.0)
    x32 = x.float()                         # mean_over_d_minus_1
    var = x32.square().sum(-1, keepdim=True) / (x.shape[-1] - 1)
    return (x32 * torch.rsqrt(var + RMS_EPS) * scale.float()).to(x.dtype)


def _launched(before, names):
    """Launches of ``names`` since the counts ``before``."""
    from deepspeed_tpu_torch.ops import build
    after = build.launch_counts()
    return {n: after.get(n, 0) - before.get(n, 0) for n in names}


def run_rms_cases(gen):
    """Every RMS_CASES case: the kernel (one launch) against the plain
    version within its tolerance, each named mutant outside it. Returns
    the rows; raises PhaseError on any failure. The ``gpu`` test runs this
    too."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.rms_norm import rms_norm_cuda, rms_norm_plain
    rows = []
    for name, (n, d, dtype, sdtype, std), must in RMS_CASES:
        x = (torch.randn(n, d, generator=gen, device="cuda") * std).to(dtype)
        scale = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(sdtype)
        before = build.launch_counts()
        got = rms_norm_cuda(x, scale, RMS_EPS)
        torch.cuda.synchronize()
        launched = _launched(before, ("rms_norm",))
        want = rms_norm_plain(x, scale, RMS_EPS)
        tol = _elem_tol(want)
        ratio = _err_ratio(got, want, tol)
        mutants = {m: _json_ratio(_err_ratio(_rms_mutant(m, x, scale), want, tol))
                   for m in RMS_MUTANTS}
        finite = bool(torch.isfinite(got).all())
        row = {"phase": "rms_parity", "case": name,
               "shape": [n, d], "dtype": str(dtype), "scale_dtype": str(sdtype),
               "max_abs_err": _max_err(got, want, "out"), "err_over_tol": ratio,
               "finite": finite, "launches": launched, "mutants": mutants,
               "must_miss": list(must)}
        emit(row)
        check(launched == {"rms_norm": 1}, f"rms {name}: launches {launched}")
        check(finite and ratio <= 1.0,
              f"rms {name}: error {ratio} times its tolerance")
        for m in must:
            check(mutants[m] > 1.0, f"rms {name}: mutant {m} lands within the "
                  f"tolerance ({mutants[m]}), so the case cannot catch that fault")
        rows.append(row)
        del x, got, want, tol
    return rows


def _dropout_masks(n, d, dtype, seed, rate):
    """(forward mask, backward mask) the two dropout kernels draw, read by
    running them on ones with the identity activation and a zero bias."""
    from deepspeed_tpu_torch.ops.fused_bias_act import (bias_act_dropout_bwd,
                                                        bias_act_dropout_fwd)
    ones = torch.ones(n, d, dtype=dtype, device="cuda")
    zero = torch.zeros(d, dtype=dtype, device="cuda")
    fwd = bias_act_dropout_fwd(ones, zero, seed, "identity", rate) != 0
    bwd = bias_act_dropout_bwd(ones, zero, ones, seed, "identity", rate)[0] != 0
    return fwd, bwd


def _gelu_erf(x, bias, dtype):
    xb = x.float() + bias.float()
    return (0.5 * xb * (1.0 + torch.erf(xb / math.sqrt(2.0)))).to(dtype)


def _draws_swapped(keep):
    """The mask with the two Philox draws of each thread's 8 columns
    (counters 2k and 2k + 1 of the flat index) traded."""
    return keep.reshape(-1, 2, 4).flip(1).reshape(keep.shape)


def run_bias_act_cases(gen):
    """Every BIAS_ACT_CASES case: bias_act and bias_act_bwd (and, at a
    rate > 0, the two dropout kernels), one launch each, against the plain
    versions: outputs and dx within the row kernels' tolerance, db within
    REDUCE_REL of its largest |plain|, the dropout masks of forward and
    backward bit-identical to the plain mask, a second backward's dx and db
    bit-identical to the first's; the mutants outside (erf-gelu in the fp32
    gelu cases, db from the first BLOCK_ROWS rows where N is larger, the
    mask's counter shifted by one row, and where the dropout kernels take 8
    columns a thread, the thread's two draws swapped). Returns the rows;
    raises PhaseError on any failure. The ``gpu`` test runs this too."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.fused_bias_act import (
        ACTS, bias_act_bwd, bias_act_bwd_plain, bias_act_dropout_bwd,
        bias_act_dropout_fwd, bias_act_fwd, bias_act_plain, dropout_keep,
        launch_plan)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for idx, (name, (n, d, dtype, act, rate, off)) in enumerate(BIAS_ACT_CASES):
        seed = 1000 + idx
        if off:
            x, g = (torch.randn(n * d + off, generator=gen, device="cuda")
                    .to(dtype)[off:].view(n, d) for _ in range(2))
        else:
            x, g = (torch.randn(n, d, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
        # an fp32 bias (the master weight): db stays fp32, so its tolerance
        # sees the partials' order, not a final bf16 rounding
        bias = torch.randn(d, generator=gen, device="cuda")
        before = build.launch_counts()
        got = {"out": bias_act_fwd(x, bias, act)}
        got["dx"], got["db"] = bias_act_bwd(x, bias, g, act)
        if rate > 0:
            got["drop_out"] = bias_act_dropout_fwd(x, bias, seed, act, rate)
            got["drop_dx"], got["drop_db"] = bias_act_dropout_bwd(
                x, bias, g, seed, act, rate)
        torch.cuda.synchronize()
        launched = _launched(before, BIAS_ACT_KERNELS)
        repeat = dict(zip(("dx", "db"), bias_act_bwd(x, bias, g, act)))
        if rate > 0:
            repeat.update(zip(("drop_dx", "drop_db"), bias_act_dropout_bwd(
                x, bias, g, seed, act, rate)))
        repeat_differs = {k: _differs(v, got[k]) for k, v in repeat.items()}
        del repeat
        want_n = {k: int(k in ("bias_act", "bias_act_bwd") or rate > 0)
                  for k in BIAS_ACT_KERNELS}
        keep = dropout_keep(n, d, seed, rate, "cuda") if rate > 0 else None
        want = {"out": bias_act_plain(x, bias, act)}
        want["dx"], want["db"] = bias_act_bwd_plain(x, bias, g, act)
        if rate > 0:
            want["drop_out"] = bias_act_plain(x, bias, act, keep, rate)
            want["drop_dx"], want["drop_db"] = bias_act_bwd_plain(
                x, bias, g, act, keep, rate)
        tols = {k: _reduce_tol(w) if k.endswith("db") else _elem_tol(w)
                for k, w in want.items()}
        ratios = {k: _err_ratio(got[k], w, tols[k]) for k, w in want.items()}
        mutants = {}
        if n > BLOCK_ROWS:
            first_db = bias_act_bwd_plain(x[:BLOCK_ROWS], bias, g[:BLOCK_ROWS],
                                          act)[1]
            mutants["db_first_block_only"] = _json_ratio(
                _err_ratio(first_db, want["db"], tols["db"]))
        if act == "gelu" and dtype == torch.float32:
            mutants["erf_gelu"] = _json_ratio(
                _err_ratio(_gelu_erf(x, bias, dtype), want["out"], tols["out"]))
        mask = {}
        if rate > 0:
            shifted = dropout_keep(n + 1, d, seed, rate, "cuda")[1:]
            mutants["mask_shifted_one_row"] = _json_ratio(_err_ratio(
                bias_act_plain(x, bias, act, shifted, rate), want["drop_out"],
                tols["drop_out"]))
            addr = x.data_ptr() | g.data_ptr()
            cols = {k: launch_plan(k, ACTS.index(act), n, d, dtype, addr & 15,
                                   sms)[0] for k in (2, 3)}
            if cols[2] == 8:
                mutants["draws_of_8_columns_swapped"] = _json_ratio(_err_ratio(
                    bias_act_plain(x, bias, act, _draws_swapped(keep), rate),
                    want["drop_out"], tols["drop_out"]))
            fwd_mask, bwd_mask = _dropout_masks(n, d, dtype, seed, rate)
            mask = {"fwd_vs_plain": int((fwd_mask != keep).sum()),
                    "bwd_vs_plain": int((bwd_mask != keep).sum()),
                    "fwd_vs_bwd": int((fwd_mask != bwd_mask).sum()),
                    "shifted_vs_plain": int((shifted != keep).sum()),
                    "drop_share": 1.0 - keep.float().mean().item()}
            del shifted, fwd_mask, bwd_mask
        finite = all(bool(torch.isfinite(t).all()) for t in got.values())
        row = {"phase": "bias_act_parity", "case": name, "shape": [n, d],
               "dtype": str(dtype), "act": act, "rate": rate,
               "max_abs_err": {k: _max_err(got[k], w, k) for k, w in want.items()},
               "err_over_tol": ratios, "finite": finite, "launches": launched,
               "mutants": mutants, "mask_differences": mask,
               "repeat_bits_differing": repeat_differs,
               "dropout_cols": cols if rate > 0 else None}
        emit(row)
        check(launched == want_n, f"bias_act {name}: launches {launched}, "
              f"expected {want_n}")
        check(finite, f"bias_act {name}: non-finite output")
        check(not any(repeat_differs.values()), f"bias_act {name}: a second "
              f"backward differs from the first {repeat_differs}")
        for k, r in ratios.items():
            check(r <= 1.0, f"bias_act {name}: {k} error {r} times its tolerance")
        if mask:
            check(mask["fwd_vs_plain"] == 0 and mask["bwd_vs_plain"] == 0 and
                  mask["fwd_vs_bwd"] == 0, f"bias_act {name}: dropout masks "
                  f"differ {mask}")
            check(mask["shifted_vs_plain"] > 0, f"bias_act {name}: the shifted "
                  "mask equals the mask")
        for m, r in mutants.items():
            check(r > 1.0, f"bias_act {name}: mutant {m} lands within the "
                  f"tolerance ({r}), so the case cannot catch that fault")
        rows.append(row)
        del x, g, bias, got, want, tols, keep
    return rows


def _last_live_dropped(layout):
    lay = np.array(layout, copy=True)
    h, nb, _ = lay.shape
    for hh in range(h):
        for qi in range(nb):
            live = np.nonzero(lay[hh, qi])[0]
            if live.size:
                lay[hh, qi, live[-1]] = 0
    return lay


def _sparse_case_layouts():
    """name -> (layout [H, nb, nb], block, causal, B, S, H, D, dtype,
    layouts differ per head): every block and head dim, both dtypes, causal
    on and off, per-head random layouts, and a layout with query blocks that
    have no live key block. The last four are for the bf16 kernel's groups
    of query blocks: a group that mixes empty and live query blocks, per-head
    Fixed groups with the causal diagonal inside them, block 128 at D = 64,
    and block 128 with ``half_max`` inputs (``_sparse_inputs``)."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
        FixedSparsityConfig, LocalSlidingWindowSparsityConfig,
        VariableSparsityConfig)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {}

    def add(name, cfg, s, b, d, dtype, causal, per_head=False, edit=None):
        lay = cfg.make_layout(s)
        if edit is not None:
            lay = edit(lay)
        cases[name] = (lay, cfg.block, causal, b, s, cfg.num_heads, d, dtype,
                       per_head)

    def empty_rows(lay):
        lay = lay.copy()
        lay[:, 3] = 0
        lay[1, 5] = 0
        return lay

    add("b16_d64_bf16_fixed_causal", FixedSparsityConfig(
        4, block=16, num_local_blocks=4, attention="unidirectional"),
        512, 2, 64, bf16, True)
    add("b32_d32_f32_bigbird_per_head", BigBirdSparsityConfig(
        4, block=32, different_layout_per_head=True, num_random_blocks=2),
        512, 2, 32, f32, False, per_head=True)
    add("b64_d128_bf16_bigbird_per_head_causal", BigBirdSparsityConfig(
        4, block=64, different_layout_per_head=True, num_random_blocks=1,
        attention="unidirectional"), 1024, 2, 128, bf16, True, per_head=True)
    add("b128_d64_f32_longformer", BSLongformerSparsityConfig(
        2, block=128, global_block_indices=[0]), 1024, 2, 64, f32, False)
    add("b128_d128_bf16_variable_per_head_causal", VariableSparsityConfig(
        2, block=128, different_layout_per_head=True, num_random_blocks=1,
        local_window_blocks=[2], global_block_indices=[1],
        attention="unidirectional"), 1024, 2, 128, bf16, True, per_head=True)
    add("b16_d128_f32_local_causal", LocalSlidingWindowSparsityConfig(
        2, block=16), 256, 2, 128, f32, True)
    add("b32_d64_bf16_dense", DenseSparsityConfig(2, block=32), 256, 2, 64,
        bf16, False)
    add("b64_d32_bf16_bigbird", BigBirdSparsityConfig(
        4, block=64, num_random_blocks=2), 1024, 2, 32, bf16, False)
    add("b32_d128_f32_empty_rows", BigBirdSparsityConfig(
        2, block=32, different_layout_per_head=True), 256, 2, 128, f32, False,
        per_head=True, edit=empty_rows)
    add("b16_d64_bf16_empty_rows", BigBirdSparsityConfig(
        2, block=16, different_layout_per_head=True), 256, 2, 64, bf16, False,
        per_head=True, edit=empty_rows)
    add("b16_d32_bf16_fixed_per_head_causal", FixedSparsityConfig(
        4, block=16, different_layout_per_head=True, num_local_blocks=4,
        num_global_blocks=1, num_different_global_patterns=4,
        attention="unidirectional"), 512, 2, 32, bf16, True, per_head=True)
    add("b128_d64_bf16_bigbird", BigBirdSparsityConfig(
        2, block=128, num_random_blocks=1), 1024, 2, 64, bf16, False)
    add("b128_d64_bf16_half_max", BSLongformerSparsityConfig(
        2, block=128, global_block_indices=[0]), 1024, 2, 64, bf16, False)
    return cases


def _sparse_inputs(gen, name, b, s, h, d, dtype):
    """Seeded q, k, v [B, S, H, D] on the card. For ``half_max`` cases batch
    entry 0 is built so that its exact output is 0 and a running max that
    moves per 64-key half of a 128-key block shows: q is the unit vector
    e0, the first 64 keys of every block score -1 and take v = 1, the last
    64 score 0 and take v = -round_bf16(exp(-1)); with one max over the
    block each block adds 64 p v = 0 exactly, with a max per half the first
    half's p = 1 is scaled by the unrounded exp(-1) and the sums miss 0."""
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    if "half_max" in name:
        first = (torch.arange(s, device="cuda") % 128) < 64
        q[0] = 0
        q[0, ..., 0] = 1
        k[0] = 0
        k[0, first, :, 0] = -math.sqrt(d)          # score -1 after 1/sqrt(D)
        v[0] = torch.where(first[:, None, None], 1.0,
                           -torch.tensor(math.exp(-1.0)).to(dtype).item()).to(dtype)
    return q, k, v


def _group_or(layout, block):
    """Every query block of a bf16 kernel group takes the union of the
    group's live key blocks (the group CSR's bit masks ignored)."""
    from deepspeed_tpu_torch.ops.sparse_attention.attention import group_size
    g = group_size(block)
    h, nb, _ = layout.shape
    ng = -(-nb // g)
    lay = np.zeros((h, ng * g, nb), layout.dtype)
    lay[:, :nb] = layout
    lay = lay.reshape(h, ng, g, nb)
    lay[:] = lay.max(2, keepdims=True)
    return lay.reshape(h, ng * g, nb)[:, :nb].copy()


def _half_max(layout):
    """The layout at block 64 with each 128-key block split in two, so the
    running max moves per 64-key half."""
    return np.kron(np.asarray(layout), np.ones((1, 2, 2), layout.dtype))


# the kernel's entry by dtype: bf16 on the tensor cores, fp32 on CUDA cores
SPARSE_ENTRY = {torch.bfloat16: "sparse_attention_kernel_mma",
                torch.float32: "sparse_attention_kernel"}


def run_sparse_cases(gen):
    """Every sparse case: the kernel (one launch) against the plain
    blockwise version, each row within BF16_ULPS bf16 ulps (fp32: F32_REL)
    of its largest |plain|, and the mutants outside: the last live key block
    of every (head, query block) dropped, head 0's layout for every head
    (layouts that differ per head), token-level causal dropped (causal
    cases), in bf16 at blocks 16 and 32 every query block of a group taking
    the group's union (where that adds a block), and at block 128 the max
    per 64-key half (``half_max`` cases); the entry by profiler name (bf16
    ``sparse_attention_kernel_mma`` alone, fp32 ``sparse_attention_kernel``
    alone) and, in bf16, a second call that repeats the output bit for bit.
    Returns the rows; raises PhaseError on any failure. The ``gpu`` test
    runs this too."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.sparse_attention import (
        block_sparse_attention, sparse_attention_cuda)
    rows = []
    for name, (lay, block, causal, b, s, h, d, dtype, per_head) in \
            _sparse_case_layouts().items():
        q, k, v = _sparse_inputs(gen, name, b, s, h, d, dtype)
        before = build.launch_counts()
        got = sparse_attention_cuda(q, k, v, lay, block, causal)
        torch.cuda.synchronize()
        launched = _launched(before, ("sparse_attention",))
        call = lambda: sparse_attention_cuda(q, k, v, lay, block, causal)  # noqa: E731
        entries = _entries(call, "sparse_attention")
        repeat = torch.equal(call(), got) if dtype == torch.bfloat16 else None
        want = block_sparse_attention(q, k, v, lay, block, causal)
        tol = _row_tol(want)
        ratio = _err_ratio(got, want, tol)
        mutants = {"last_live_block_dropped": block_sparse_attention(
            q, k, v, _last_live_dropped(lay), block, causal)}
        if per_head:
            mutants["head0_layout_everywhere"] = block_sparse_attention(
                q, k, v, np.broadcast_to(lay[:1], lay.shape).copy(), block, causal)
        if causal:
            mutants["causal_dropped"] = block_sparse_attention(
                q, k, v, lay, block, False)
        union = _group_or(lay, block)
        # blocks above the diagonal add nothing to a causal row
        tri = np.tril(np.ones(lay.shape[1:], lay.dtype)) if causal else 1
        if dtype == torch.bfloat16 and not np.array_equal(union * tri, lay * tri):
            mutants["group_union_everywhere"] = block_sparse_attention(
                q, k, v, union, block, causal)
        if "half_max" in name:
            mutants["max_per_64_key_half"] = block_sparse_attention(
                q, k, v, _half_max(lay), 64, causal)
        m_ratios = {m: _json_ratio(_err_ratio(o, want, tol))
                    for m, o in mutants.items()}
        finite = bool(torch.isfinite(got).all())
        dead_rows = int((want.float().abs().amax(-1) == 0).sum())
        row = {"phase": "sparse_parity", "case": name,
               "shape": {"b": b, "s": s, "h": h, "d": d, "block": block},
               "dtype": str(dtype), "causal": causal,
               "live_blocks": int(lay.sum()), "all_blocks": int(lay.size),
               "rows_without_live_key": dead_rows,
               "max_abs_err": _max_err(got, want, "out"), "err_over_tol": ratio,
               "finite": finite, "launches": launched, "entries": entries,
               "repeats_bit_for_bit": repeat, "mutants": m_ratios}
        emit(row)
        check(launched == {"sparse_attention": 1},
              f"sparse {name}: launches {launched}")
        check(entries == [SPARSE_ENTRY[dtype]],
              f"sparse {name}: the call launched {entries}")
        check(repeat is not False, f"sparse {name}: a second call gave other bits")
        check(finite and ratio <= 1.0,
              f"sparse {name}: error {ratio} times its row tolerance")
        for m, r in m_ratios.items():
            check(r > 1.0, f"sparse {name}: mutant {m} lands within the row "
                  f"tolerance ({r}), so the case cannot catch that fault")
        rows.append(row)
        del q, k, v, got, want, tol, mutants
    return rows


def phase_slice5_parity():
    """The six slice-5 kernels against their plain versions; returns the
    worst absolute error of each."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    worst = {n: 0.0 for n in SLICE5_KERNELS}
    for row in run_rms_cases(gen):
        worst["rms_norm"] = max(worst["rms_norm"], row["max_abs_err"])
    outs = {"bias_act": ("out",), "bias_act_bwd": ("dx", "db"),
            "bias_act_dropout": ("drop_out",),
            "bias_act_dropout_bwd": ("drop_dx", "drop_db")}
    for row in run_bias_act_cases(gen):
        for kernel, names in outs.items():
            for o in names:
                if o in row["max_abs_err"]:
                    worst[kernel] = max(worst[kernel], row["max_abs_err"][o])
    for row in run_sparse_cases(gen):
        worst["sparse_attention"] = max(worst["sparse_attention"],
                                        row["max_abs_err"])
    emit({"phase": "slice5_parity_summary", "worst_max_abs_err": worst,
          "rms_cases": len(RMS_CASES), "bias_act_cases": len(BIAS_ACT_CASES),
          "sparse_cases": len(_sparse_case_layouts())})
    return worst


# The slice-5 paths, published widths, bf16, nothing cut:
# S1 BigBird-base (google/bigbird-roberta-base: hidden 768, 12 heads, block
#    64, 3 random blocks, 4096 positions), bidirectional, B = 4;
# S2 the reference's FixedSparsityConfig defaults at BERT-base widths
#    (12 heads, D = 64), block 16, unidirectional (token-level causal), B = 4;
# R  RMSNorm at Llama-3-8B's width, [2048, 4096], eps 1e-5 (Meta's config);
# F  bias + gelu at BERT-base's FFN, [16 * 512, 3072], rate 0 then 0.1.
SPARSE_PATHS = {"S1": ("BigBird", 4, 4096, 12, 64, 488),
                "S2": ("Fixed", 4, 4096, 12, 64, 8704)}
RMS_PATH = (2048, 4096)
BIAS_ACT_PATH = (16 * 512, 3072)
DROPOUT_SEED = 1234


def _sparse_path_config(name):
    from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig,
                                                          FixedSparsityConfig)
    if name == "S1":
        return BigBirdSparsityConfig(num_heads=12, block=64, num_random_blocks=3,
                                     num_sliding_window_blocks=3,
                                     num_global_blocks=1)
    return FixedSparsityConfig(num_heads=12, block=16, num_local_blocks=4,
                               num_global_blocks=1, attention="unidirectional")


def phase_sparse_path(dev, smi_line):
    """S1 and S2 through ``SparseSelfAttention``: forward, then
    ``.backward()`` of a seeded output gradient. Launches counted from 0
    around each run: exactly one ``sparse_attention`` (the backward
    recomputes through the plain version). The output and the q, k, v
    gradients are held against the plain blockwise version and its autograd
    on the card. Returns {path: launches}."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.sparse_attention import (SparseSelfAttention,
                                                          block_sparse_attention)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 10)
    launches_by_path = {}
    for name, (kind, b, s, h, d, live_per_head) in SPARSE_PATHS.items():
        cfg = _sparse_path_config(name)
        attn = SparseSelfAttention(cfg)
        q, k, v, gy = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        for x in (q, k, v):
            x.requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()      # the main path's run starts here
        t0 = time.monotonic()
        out = attn(q, k, v)
        out.backward(gy)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
        launches = build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        launches_by_path[name] = launches
        lay = attn.layout(s)
        with torch.enable_grad():
            qp, kp, vp = (x.detach().requires_grad_(True) for x in (q, k, v))
            want = block_sparse_attention(qp, kp, vp, lay, cfg.block, attn.causal)
            wgrads = torch.autograd.grad(want, (qp, kp, vp), gy)
        got = [out.detach(), q.grad, k.grad, v.grad]
        wants = [want.detach(), *wgrads]
        ratios = {nm: _err_ratio(g, w, _row_tol(w)) for nm, g, w in
                  zip(("out", "dq", "dk", "dv"), got, wants)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        live = [int(x) for x in lay.reshape(h, -1).sum(1)]
        emit({"phase": "sparse_path", "path": name, "config": kind,
              "shape": [b, s, h, d], "block": cfg.block, "causal": attn.causal,
              "live_blocks_per_head": sorted(set(live)),
              "blocks_per_head": int(lay[0].size),
              "launches": launches, "err_over_tol": ratios, "finite": finite,
              "wall_ms_fwd_bwd": wall_ms, "peak_gb": peak / 1e9,
              "card": dev["kind"], "nvidia_smi": smi_line})
        check(launches == {"sparse_attention": 1},
              f"{name}: launches {launches}, expected one sparse_attention")
        check(attn.causal == (name == "S2"), f"{name}: causal {attn.causal}")
        check(set(live) == {live_per_head},
              f"{name}: live blocks per head {sorted(set(live))}")
        check(finite, f"{name}: non-finite output or gradient")
        for nm, r in ratios.items():
            check(r <= 1.0, f"{name}: {nm} {r} times its row tolerance")
        del q, k, v, gy, out, want, wgrads, got, wants, qp, kp, vp, attn
        gc.collect()
        torch.cuda.empty_cache()
    return launches_by_path


def phase_rms_path(dev, smi_line):
    """R: ``rms_norm`` forward and backward on [2048, 4096] bf16 with an
    fp32 scale (the master weight); exactly one ``rms_norm`` launch; output,
    dx and dscale held against autograd through ``rms_norm_reference``."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.rms_norm import rms_norm, rms_norm_reference
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    n, d = RMS_PATH
    x = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    gy = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    x.requires_grad_(True)
    scale.requires_grad_(True)
    torch.cuda.synchronize()
    build.reset_launch_counts()          # the main path's run starts here
    out = rms_norm(x, scale, RMS_EPS)
    out.backward(gy)
    torch.cuda.synchronize()
    launches = build.launch_counts()
    with torch.enable_grad():
        xp, sp = x.detach().requires_grad_(True), scale.detach().requires_grad_(True)
        want = rms_norm_reference(xp, sp, RMS_EPS)
        wdx, wds = torch.autograd.grad(want, (xp, sp), gy)
    ratios = {"out": _err_ratio(out, want, _elem_tol(want)),
              "dx": _err_ratio(x.grad, wdx, _row_tol(wdx)),
              "dscale": _err_ratio(scale.grad, wds, _reduce_tol(wds))}
    finite = all(bool(torch.isfinite(t).all()) for t in (out, x.grad, scale.grad))
    emit({"phase": "rms_path", "path": "R", "shape": [n, d], "eps": RMS_EPS,
          "dtype": "bf16, fp32 scale", "launches": launches,
          "err_over_tol": ratios, "finite": finite,
          "card": dev["kind"], "nvidia_smi": smi_line})
    check(launches == {"rms_norm": 1}, f"R: launches {launches}")
    check(finite, "R: non-finite output or gradient")
    for nm, r in ratios.items():
        check(r <= 1.0, f"R: {nm} {r} times its tolerance")
    return launches


def phase_bias_act_path(dev, smi_line):
    """F: ``fused_bias_act`` (gelu) forward and backward on [8192, 3072]
    bf16 with an fp32 bias (the master weight), then
    ``fused_bias_act_dropout`` at rate 0.1: exactly one launch of each
    kernel per run; outputs, dx and db held against the plain versions; the
    dropout masks of the forward and the backward
    bit-identical to the plain mask (read after the counted run by the
    kernels on ones with the identity activation), and the run's output 0
    at every dropped position."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.fused_bias_act import (
        bias_act_bwd_plain, bias_act_plain, dropout_keep, fused_bias_act,
        fused_bias_act_dropout)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 12)
    n, d = BIAS_ACT_PATH
    x = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    gy = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    bias = 0.1 * torch.randn(d, generator=gen, device="cuda")   # fp32 master
    total = {}
    keep = dropout_keep(n, d, DROPOUT_SEED, DROPOUT_RATE, "cuda")
    for run, rate in (("rate_0", 0.0), ("rate_0.1", DROPOUT_RATE)):
        xr, br = x.detach().requires_grad_(True), bias.detach().requires_grad_(True)
        torch.cuda.synchronize()
        build.reset_launch_counts()      # the main path's run starts here
        out = fused_bias_act_dropout(xr, br, DROPOUT_SEED, "gelu", rate) \
            if rate > 0 else fused_bias_act(xr, br, "gelu")
        out.backward(gy)
        torch.cuda.synchronize()
        launches = build.launch_counts()
        for kname, c in launches.items():
            total[kname] = total.get(kname, 0) + c
        mask = keep if rate > 0 else None
        want = bias_act_plain(x, bias, "gelu", mask, rate)
        wdx, wdb = bias_act_bwd_plain(x, bias, gy, "gelu", mask, rate)
        ratios = {"out": _err_ratio(out, want, _elem_tol(want)),
                  "dx": _err_ratio(xr.grad, wdx, _elem_tol(wdx)),
                  "db": _err_ratio(br.grad, wdb, _reduce_tol(wdb))}
        expected = ({"bias_act_dropout": 1, "bias_act_dropout_bwd": 1} if rate > 0
                    else {"bias_act": 1, "bias_act_bwd": 1})
        row = {"phase": "bias_act_path", "path": "F", "run": run,
               "shape": [n, d], "act": "gelu", "rate": rate,
               "launches": launches, "expected": expected,
               "err_over_tol": ratios,
               "finite": all(bool(torch.isfinite(t).all())
                             for t in (out, xr.grad, br.grad))}
        if rate > 0:
            fwd_mask, bwd_mask = _dropout_masks(n, d, torch.bfloat16,
                                                DROPOUT_SEED, rate)
            row["mask_differences"] = {
                "fwd_vs_plain": int((fwd_mask != keep).sum()),
                "bwd_vs_plain": int((bwd_mask != keep).sum()),
                "fwd_vs_bwd": int((fwd_mask != bwd_mask).sum()),
                "nonzero_at_dropped": int(((out != 0) & ~keep).sum())}
            row["drop_share"] = 1.0 - keep.float().mean().item()
        emit({**row, "card": dev["kind"], "nvidia_smi": smi_line})
        check(launches == expected, f"F {run}: launches {launches}")
        check(row["finite"], f"F {run}: non-finite output or gradient")
        for nm, r in ratios.items():
            check(r <= 1.0, f"F {run}: {nm} {r} times its tolerance")
        if rate > 0:
            check(all(v == 0 for v in row["mask_differences"].values()),
                  f"F {run}: masks differ {row['mask_differences']}")
        del xr, br, out, want, wdx, wdb
    return total


def phase_slice5_timing(dev, smi_line):
    """Each slice-5 kernel's time at its path shape beside its bound, its
    plain version's time and one PyTorch call's (``F.rms_norm``; SDPA with
    the dense boolean layout mask; none for the bias kernels). A kernel's
    ``ms`` is the profiler's device time of its entries by exact name,
    ``wrapper_ms`` the CUDA-event time of the wrapper's calls and
    ``host_us`` the host's time per call. Returns the kernels line's
    numbers."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.fused_bias_act import (
        bias_act_bwd, bias_act_bwd_plain, bias_act_dropout_bwd,
        bias_act_dropout_bwd_plain, bias_act_dropout_fwd,
        bias_act_dropout_plain, bias_act_fwd, bias_act_plain)
    from deepspeed_tpu_torch.ops.rms_norm import rms_norm_cuda, rms_norm_plain
    from deepspeed_tpu_torch.ops.sparse_attention import (
        SparseLayout, block_sparse_attention, dense_mask_from_layout,
        sparse_attention_cuda)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    timing = {}

    def kernel_times(fn, stem):
        ms, entries = _stem_entries_ms(fn, stem, iters=20)
        return {"ms": ms, "entries": entries,
                "wrapper_ms": time_ms(fn, iters=50), "host_us": host_us(fn)}
    # R
    n, d = RMS_PATH
    x = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    # F.rms_norm with the path's fp32 weight (the same function), and with
    # the weight in x's dtype, which torch may send to a fused kernel
    lib = {}
    for weight in (scale, scale.to(x.dtype)):
        try:
            lib[str(weight.dtype)] = _call_device_ms(
                lambda: F.rms_norm(x, (d,), weight, RMS_EPS), iters=20)
        except (AttributeError, RuntimeError):
            lib[str(weight.dtype)] = None
    timing["rms_norm"] = {
        **kernel_times(lambda: rms_norm_cuda(x, scale, RMS_EPS), "rms_norm"),
        "plain_ms": time_ms(lambda: rms_norm_plain(x, scale, RMS_EPS), iters=20),
        "library_ms": lib["torch.float32"], "library_ms_by_weight": lib,
        "bytes": 2 * x.numel() * 2 + d * 4, "flops": 0}
    del x
    # F
    n, d = BIAS_ACT_PATH
    x, g = (torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    bias = 0.1 * torch.randn(d, generator=gen, device="cuda")
    s, r = DROPOUT_SEED, DROPOUT_RATE
    fwd_bytes = 2 * x.numel() * 2 + d * 4
    bwd_bytes = 3 * x.numel() * 2 + 2 * d * 4
    for name, call, plain, nbytes, plain_iters in (
            ("bias_act", lambda: bias_act_fwd(x, bias),
             lambda: bias_act_plain(x, bias), fwd_bytes, 10),
            ("bias_act_bwd", lambda: bias_act_bwd(x, bias, g),
             lambda: bias_act_bwd_plain(x, bias, g), bwd_bytes, 10),
            ("bias_act_dropout",
             lambda: bias_act_dropout_fwd(x, bias, s, "gelu", r),
             lambda: bias_act_dropout_plain(x, bias, s, "gelu", r), fwd_bytes, 5),
            ("bias_act_dropout_bwd",
             lambda: bias_act_dropout_bwd(x, bias, g, s, "gelu", r),
             lambda: bias_act_dropout_bwd_plain(x, bias, g, s, "gelu", r),
             bwd_bytes, 5)):
        timing[name] = {**kernel_times(call, ENTRY_NAMES[name]),
                        "plain_ms": time_ms(plain, iters=plain_iters),
                        "library_ms": None, "bytes": nbytes, "flops": 0}
    del x, g
    # S1 and S2
    sparse = {}
    for name, (_, b, s_len, h, dh, _) in SPARSE_PATHS.items():
        cfg = _sparse_path_config(name)
        causal = name == "S2"
        lay = SparseLayout(cfg.make_layout(s_len))
        q, k, v = (torch.randn(b, s_len, h, dh, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        dense = torch.as_tensor(dense_mask_from_layout(lay, cfg.block, s_len),
                                device="cuda")
        if causal:
            pos = torch.arange(s_len, device="cuda")
            dense = dense & (pos[:, None] >= pos[None, :])
        pairs = int(dense.sum()) * b                 # live (row, key) pairs
        qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        try:
            lib_ms = _call_device_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=dense[None]), iters=5)
        except RuntimeError:
            lib_ms = None
        call = lambda: sparse_attention_cuda(q, k, v, lay, cfg.block, causal)  # noqa: E731
        cols = lay.csr("cuda")[1]
        gcols = lay.group_csr("cuda", cfg.block)[1]
        sparse[name] = {
            "ms": _kernel_device_ms(call, ["sparse_attention_kernel"],
                                    iters=20)["sparse_attention_kernel"],
            "wrapper_ms": time_ms(call, iters=20),
            # key blocks loaded from L2: one per (row, live block) before,
            # one per (group, union entry) now, K and V of B heads each
            "l2_read_bytes": {
                "per_query_block": int(cols.numel()) * b * 2 * cfg.block * dh * 2,
                "per_group": int(gcols.numel()) * b * 2 * cfg.block * dh * 2},
            "plain_ms": time_ms(lambda: block_sparse_attention(
                q, k, v, lay, cfg.block, causal), iters=2, warmup=1),
            "library_ms": lib_ms,
            "bytes": 4 * q.numel() * 2 + sum(t.numel() * 4 for t in lay.csr("cuda")),
            "flops": 4 * pairs * dh, "live_pairs": pairs}
        del q, k, v, qs, ks, vs, dense
        gc.collect()
        torch.cuda.empty_cache()
    timing["sparse_attention"] = sparse["S1"]
    for t in list(timing.values()) + [sparse["S2"]]:
        t["bound_ms"], t["bound_by"] = _bound(t["flops"], t["bytes"])
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
    emit({"phase": "slice5_timing",
          "shapes": {"rms_norm": "R [2048, 4096] bf16, fp32 scale",
                     "bias_act*": "F [8192, 3072] bf16, fp32 bias, gelu, rate 0.1",
                     "sparse_attention": "S1 (S2 beside it)"},
          **timing, "sparse_attention_S2": sparse["S2"],
          "notes": "bytes: each input read once, each output written once; "
                   "sparse flops 4 * live (row, key) pairs * D; ms by "
                   "profiler device time of each kernel's entries by exact "
                   "name, wrapper_ms by events; library of "
                   "sparse_attention: SDPA with the dense boolean layout "
                   "mask (and the causal triangle for S2), of rms_norm: "
                   "F.rms_norm, both device time",
          "card": dev["kind"], "nvidia_smi": smi_line})
    return {kn: {key: t[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}
            for kn, t in timing.items()}


# ---------------------------------------------------------------------------
# phase 4: the serving path
# ---------------------------------------------------------------------------
def check_finite(eng, finite):
    """Fold every logit ``eng`` samples from into the device flag
    ``finite`` (no sync; read it once at the end)."""
    sample = eng._sample_batch

    def checked_sample(logits):
        finite.logical_and_(torch.isfinite(logits).all())
        return sample(logits)
    eng._sample_batch = checked_sample


def run_engine(cfg, device, kv_num_blocks, prompt_lens, new_tokens,
               prefill_buckets=(128, 256, 512), seed=SEED, params=None):
    """Serve ``len(prompt_lens)`` seeded requests admitted together through
    ``InferenceEngineV2`` (greedy), each to ``new_tokens`` tokens, over
    ``params`` (by default Llama weights drawn from ``seed``). Returns the
    engine, the prompts, per-request outputs and the run's numbers."""
    from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2,
                                                            V2EngineConfig)
    from deepspeed_tpu_torch.inference.v2.scheduler import SchedulerConfig
    from deepspeed_tpu_torch.models.convert import init_llama_params
    from deepspeed_tpu_torch.ops import build

    if params is None:
        params = init_llama_params(cfg, seed=seed, device=device)
    vocab = getattr(cfg, "base", cfg).vocab_size
    eng = InferenceEngineV2(params, cfg, V2EngineConfig(
        kv_block_size=64, kv_num_blocks=kv_num_blocks,
        scheduler=SchedulerConfig(max_tokens_per_step=2048,
                                  prefill_buckets=prefill_buckets)),
        device=device)
    finite = torch.ones((), dtype=torch.bool, device=device)
    check_finite(eng, finite)

    rng = np.random.default_rng(seed)
    eng.generate(rng.integers(0, vocab, 16).tolist(),
                 max_new_tokens=2, uid=10_000)            # warm-up request
    prompts = [rng.integers(0, vocab, int(n)).tolist()
               for n in prompt_lens]
    chunks0 = eng.sched_ledger.chunks_total
    decode_ticks0 = eng.sched_ledger.decode_ticks
    if device.type == "cuda":
        torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.monotonic()
    for uid, p in enumerate(prompts):
        eng.admit(uid, p)
    ttft, done, decode_s, decode_tokens = {}, {}, 0.0, 0
    while eng.has_work():
        out = eng.step()
        now = time.monotonic()
        decode_s += eng.last_step_timing["decode_s"]
        decode_tokens += eng.last_step_counters["decode_tokens"]
        for uid in out:
            ttft.setdefault(uid, now - t0)
            if len(eng.state.get(uid).generated) >= new_tokens:
                done[uid] = now - t0
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
             # time per output token after the first, per request
             "tpot_p50_s": float(np.median([
                 (done[u] - ttft[u]) / max(new_tokens - 1, 1) for u in done])),
             "prefill_chunks": eng.sched_ledger.chunks_total - chunks0,
             "decode_steps": eng.sched_ledger.decode_ticks - decode_ticks0,
             "launches": launches,
             "logits_finite": bool(finite.item()),
             "finite_flag": finite}
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
    return st, eng, lens, prompts


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


# ---------------------------------------------------------------------------
# phase 5b: the serving layer over the engine (InferenceServer + HTTP)
# ---------------------------------------------------------------------------
# bench_serve's scenario at full width: 32 requests, prompts of 100-500
# tokens, 16-32 new tokens, 8 closed-loop users
SERVE_SCENARIO = dict(num_requests=32, concurrency=8, prompt_len=(100, 501),
                      max_new_tokens=(16, 33))
TIER_BLOCKS = 48        # the tier drill's KV pool, 64-token blocks
TIER_DEMOTE = 0.3       # its demote line, a share of the usable blocks


def _post_generate(url, prompt, max_new):
    """POST /generate; returns (status, body, seconds) by the host clock."""
    from deepspeed_tpu_torch.serving import http_util
    t0 = time.monotonic()
    reply = http_util.request_json(
        "POST", url + "/generate",
        {"prompt_tokens": [int(t) for t in prompt], "max_new_tokens": max_new},
        timeout_s=600.0)
    return reply.status, reply.json(), time.monotonic() - t0


def _metric(text, name):
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise PhaseError(f"/metrics has no {name}")


def _no_faults(server, label):
    """Fault isolation must not become a fallback: a kernel that failed
    would surface as a retry, a quarantine or the sticky 503."""
    snap, health = server.metrics.snapshot(), server.health()
    faults = {k: snap[k] for k in ("engine_step_faults",
                                   "requests_quarantined",
                                   "degraded_latches")}
    check(not any(faults.values()), f"{label}: {faults}")
    check(health["status"] != "degraded" and health["level"] != "degraded",
          f"{label}: health {health}")
    return faults


def _concurrent_generate(url, prompts, server=None):
    """POST each prompt from its own client thread, all in flight at once.
    With ``server`` (built, its loop not started) each thread starts once
    the one before it is queued, and the loop starts when all are: the
    first tick admits them together in prompt order, so the batch is the
    one ``_engine_batch`` replays. Returns the replies and the host time
    from the loop's start to the last reply."""
    replies = [None] * len(prompts)

    def client(i):
        replies[i] = _post_generate(url, prompts[i], NEW_TOKENS)
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(prompts))]
    if server is not None:
        base = server.metrics.snapshot()["requests_submitted"]
    for i, t in enumerate(threads):
        t.start()
        deadline = time.monotonic() + 60.0
        while (server is not None and server.metrics.snapshot()
               ["requests_submitted"] < base + i + 1):
            check(time.monotonic() < deadline, f"request {i} never queued")
            time.sleep(0.001)
    t0 = time.monotonic()
    if server is not None:
        server.start()
    for t in threads:
        t.join(timeout=600)
    check(all(r is not None for r in replies), "a client thread hung")
    return replies, time.monotonic() - t0


def _engine_batch(eng, prompts, uid0):
    """The prompts admitted together in order on ``eng`` as it stands,
    greedy, each finished at ``NEW_TOKENS`` tokens as the server does."""
    for i, p in enumerate(prompts):
        eng.admit(uid0 + i, p)
    while eng.has_work():
        for uid in eng.step():
            if len(eng.state.get(uid).generated) >= NEW_TOKENS:
                eng.finish(uid)
    out = eng.reap_finished()
    return [out[uid0 + i] for i in range(len(prompts))]


def _span_stats(events):
    """Per-tick host time of the serve window from the tracer ring: ticks,
    the engine's step inside them and the server's own remainder."""
    tick = [e[5] for e in events if e[1] == "serve/tick" and e[3] == "X"]
    step = [e[5] for e in events
            if e[1] == "serve/engine_step" and e[3] == "X"]
    decode = [e for e in events if e[1] == "serve/step_decode"]
    decode_tokens = sum(int((e[7] or {}).get("batch", 0)) for e in decode)
    decode_s = sum(e[5] for e in decode)
    return {"ticks": len(tick), "tick_ms": 1e3 * sum(tick) / max(len(tick), 1),
            "engine_step_ms": 1e3 * sum(step) / max(len(step), 1),
            "server_ms_per_tick": 1e3 * (sum(tick) - sum(step))
            / max(len(tick), 1),
            "decode_tokens": decode_tokens,
            "decode_tokens_per_s": decode_tokens / decode_s if decode_s
            else 0.0}


def _quantiles(vals):
    from deepspeed_tpu_torch.telemetry.tracer import _quantile
    s = sorted(vals)
    return {"p50": _quantile(s, 0.5), "p99": _quantile(s, 0.99), "n": len(s)}


def phase_serve(eng, prompts, st, dev, smi_line):
    """The engine phase's 32-layer Llama-3-8B engine behind
    ``InferenceServer`` and its HTTP front door, started once: the 8
    prompts from 8 client threads at once (queued before the loop starts,
    so they are admitted together), one request alone, bench_serve's
    scenario, stop and drain, then on the same engine as the server left it
    the lone request through ``generate`` and the 8 prompts admitted
    together (each reply bit for bit), a host-KV-tier drill on a second
    engine over the same weights, and last the 8 requests again under the
    profiler (the card's idle share).
    Returns the kernels' launches over the 8-request window."""
    from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2,
                                                            V2EngineConfig)
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.serving import (InferenceServer, ServingConfig,
                                             ServingFrontend)
    from deepspeed_tpu_torch.serving.bench_serve import (ServeScenario,
                                                         _span_latencies,
                                                         run_scenario)
    from deepspeed_tpu_torch.telemetry.tracer import get_tracer
    phase_t0 = time.monotonic()
    cfg, vocab = eng.model_config, eng.model_config.vocab_size
    finite = st["finite_flag"]
    for uid in [s.uid for s in eng.state.all()]:     # the profile's batch
        eng.finish(uid)
    eng.reap_finished()
    tracer = get_tracer().configure(enabled=True)
    tracer.clear()
    server = InferenceServer(eng, ServingConfig(max_queue_depth=64))
    fe = ServingFrontend(server, host="127.0.0.1", port=0).start()
    try:
        # 1-3: the 8 prompts at once from 8 client threads, queued before
        # the serve loop starts (it starts here, once)
        ledger0 = (eng.sched_ledger.chunks_total, eng.sched_ledger.decode_ticks)
        tracer.clear()
        finite.fill_(True)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        replies, window_s = _concurrent_generate(fe.url, prompts, server)
        torch.cuda.synchronize()
        launches = build.launch_counts()
        events = tracer.events_snapshot()
        chunks = eng.sched_ledger.chunks_total - ledger0[0]
        decode_steps = eng.sched_ledger.decode_ticks - ledger0[1]
        for i, (status, body, _) in enumerate(replies):
            toks = body.get("tokens", ())
            check(status == 200 and len(toks) == NEW_TOKENS
                  and all(0 <= t < vocab for t in toks),
                  f"request {i}: {status} {body}")
        check(bool(finite.item()), "non-finite logits through the server")
        want = cfg.num_layers * (chunks + decode_steps)
        got = launches.get("paged_attention", 0)
        check(got >= want, f"paged_attention launched {got} times through "
              f"the server, expected >= {want} ({cfg.num_layers} layers x "
              f"({chunks} chunks + {decode_steps} decode steps))")
        # one request alone, then the front door's own account of all 9
        status, lone, lone_s = _post_generate(fe.url, prompts[0], NEW_TOKENS)
        check(status == 200 and len(lone.get("tokens", ())) == NEW_TOKENS,
              f"lone request: {status} {lone}")
        check(bool(finite.item()), "non-finite logits in the lone request")
        from deepspeed_tpu_torch.serving import http_util
        health = http_util.request_json("GET", fe.url + "/healthz")
        check(health.status == 200, f"/healthz {health.status}")
        page = http_util.request_json("GET", fe.url + "/metrics").body.decode()
        completed = _metric(page, "dstpu_serving_requests_completed")
        failed = _metric(page, "dstpu_serving_requests_failed")
        check(completed == 1 + len(prompts) and failed == 0,
              f"/metrics: {completed} completed, {failed} failed")
        ttft, tpot = _span_latencies(events)
        window = {"http_latency_s": _quantiles([r[2] for r in replies]),
                  "ttft_s": _quantiles(ttft), "tpot_s": _quantiles(tpot),
                  "window_s": window_s, "prefill_chunks": chunks,
                  "decode_steps": decode_steps,
                  "tokens_per_s_wall": len(prompts) * NEW_TOKENS / window_s,
                  "engine_phase_decode_tokens_per_s":
                      st["decode_tokens_per_s"],
                  **_span_stats(events)}
        _no_faults(server, "serve, 8 requests")

        # 4: bench_serve's scenario at full width, in process
        scenario = ServeScenario(name="smoke_serve", vocab=vocab, seed=SEED,
                                 **SERVE_SCENARIO)
        before = server.metrics.snapshot()
        slo_before = server.metrics.slo_snapshot()
        tracer.clear()
        report = run_scenario(server, scenario)
        m = report["metrics"]
        terminal = (m["requests_completed"] + m["requests_failed"]
                    + m["requests_cancelled"] + m["requests_timed_out"])
        engine_tokens = m["tokens_generated"] - before["tokens_generated"]
        ttft_obs = (server.metrics.slo_snapshot()["dstpu_req_ttft_seconds"]
                    ["count"] - slo_before["dstpu_req_ttft_seconds"]["count"])
        check(m["requests_submitted"] == terminal and m["requests_failed"] == 0
              and report["requests"]["states"]
              == {"finished": SERVE_SCENARIO["num_requests"]},
              f"bench_serve conservation: {report['requests']}, {terminal} "
              f"terminal of {m['requests_submitted']}")
        check(engine_tokens == report["requests"]["client_tokens"],
              f"engine tokens {engine_tokens} != client tokens "
              f"{report['requests']['client_tokens']}")
        check(ttft_obs == SERVE_SCENARIO["num_requests"],
              f"{ttft_obs} TTFT observations")
        check(report["drained"] and report["ladder"]["level"] == "healthy",
              f"bench_serve: drained {report['drained']}, ladder "
              f"{report['ladder']}")
        check(bool(finite.item()), "non-finite logits in bench_serve")
        faults = _no_faults(server, "serve, bench_serve")
        shares = {k: v["last"] for k, v in tracer.counter_series(
            "serve/tick_stage_share").get("serve/tick_stage_share",
                                          {}).items()}
        bench = {"requests": report["requests"], "wall_s": report["wall_s"],
                 "client_tokens": report["requests"]["client_tokens"],
                 "tokens_per_s_wall": report["requests"]["client_tokens"]
                 / report["wall_s"],
                 "latency_from_trace": report["latency_from_trace"],
                 "ticks": _span_stats(tracer.events_snapshot()),
                 "faults": faults}
    finally:
        fe.stop()
        server.stop(drain_timeout=60.0)
    # 5: drained and stopped: nothing left in either tier
    ledger = eng.kv_ledger()
    check(ledger["device_blocks_reserved"] == 0 and ledger["host_entries"] == 0
          and ledger["host_bytes"] == 0, f"ledger after the drain: {ledger}")
    # 6: the same engine, as the server left it, repeats the lone request
    again = eng.generate(prompts[0], max_new_tokens=NEW_TOKENS, uid=30_000)
    check(again == lone["tokens"], "the lone request through generate "
          f"differs from the server's: {again} vs {lone['tokens']}")
    # and the 8 prompts admitted together: each reply bit for bit (a token
    # stream delivered to the wrong request fails here)
    batch = _engine_batch(eng, prompts, 40_000)
    for i, (_, body, _) in enumerate(replies):
        check(batch[i] == body["tokens"], f"request {i} through the server "
              f"differs from the engine's batch: {body['tokens']} vs "
              f"{batch[i]}")

    # the host KV tier: a second engine on the same weights, a small pool
    tier_eng = InferenceEngineV2(eng.params, cfg, V2EngineConfig(
        kv_block_size=64, kv_num_blocks=TIER_BLOCKS,
        scheduler=eng.config.scheduler), device=eng.device)
    check_finite(tier_eng, finite)
    finite.fill_(True)
    tier = InferenceServer(tier_eng, ServingConfig(
        kv_offload_enabled=True, host_kv_quantize="int8",
        kv_demote_watermark=TIER_DEMOTE,
        kv_demote_watermark_brownout=TIER_DEMOTE,
        host_kv_budget_bytes=4 << 30, idle_poll_s=0.001)).start()
    try:
        t0 = time.monotonic()
        reqs = [tier.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        for r in reqs:
            check(r.wait(timeout=600), f"tier drill: request {r.uid} hung")
        tier_s = time.monotonic() - t0
        check(all(r.state.value == "finished"
                  and len(r.tokens) == NEW_TOKENS for r in reqs),
              f"tier drill: {[r.describe() for r in reqs]}")
        tier_faults = _no_faults(tier, "tier drill")
        snap = tier.metrics.snapshot()
    finally:
        tier.stop(drain_timeout=60.0)
    tier_ledger = tier_eng.kv_ledger()
    check(snap["kv_demotions"] > 0, "tier drill: no page moved")
    check(snap["kv_demotions"] == snap["kv_promotions"]
          and snap["kv_demoted_bytes"] == snap["kv_promoted_bytes"],
          f"tier drill: demotions {snap['kv_demotions']} / "
          f"{snap['kv_demoted_bytes']} B, promotions {snap['kv_promotions']}"
          f" / {snap['kv_promoted_bytes']} B")
    check(tier_ledger["device_blocks_reserved"] == 0
          and tier_ledger["host_entries"] == 0
          and tier_ledger["host_bytes"] == 0,
          f"tier drill ledger after the drain: {tier_ledger}")
    check(bool(finite.item()), "non-finite logits in the tier drill")
    del tier_eng
    # last, so that no profiler runs in the windows above: the 8 requests
    # through a fresh server over the same engine under the profiler,
    # kernels only (host-side op records slowed the host-bound step up to
    # 2.5x, PERF.md §6 PR 13) — the card's busy and idle share of a window
    server = InferenceServer(eng, ServingConfig(max_queue_depth=64)).start()
    fe = ServingFrontend(server, host="127.0.0.1", port=0).start()
    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, profiled_s = _concurrent_generate(fe.url, prompts)
            torch.cuda.synchronize()
        _no_faults(server, "serve, profiled")
    finally:
        fe.stop()
        server.stop(drain_timeout=60.0)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events() if e.device_type == cuda]
    check(kernels, "the profiler saw no kernel on the card")
    busy_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    window["profiled"] = {"window_s": profiled_s, "device_busy_s": busy_s,
                          "device_idle_share": 1.0 - busy_s / profiled_s,
                          "kernels": len(kernels)}
    emit({"phase": "serve", "model": "LLAMA3_8B bf16 (32 layers, full width)",
          "lone": {"http_latency_s": lone_s, "ttft_s": lone["ttft_s"],
                   "tpot_s": lone["tpot_s"]},
          "concurrent": window, "bench_serve": bench,
          "tick_stage_share": shares, "repeat_bit_exact": True,
          "batch_bit_exact": True,
          "tier": {"demotions": snap["kv_demotions"],
                   "promotions": snap["kv_promotions"],
                   "demoted_bytes": snap["kv_demoted_bytes"],
                   "promoted_bytes": snap["kv_promoted_bytes"],
                   "host_compression_ratio": tier_ledger[
                       "host_compression_ratio"],
                   "wall_s": tier_s, "faults": tier_faults},
          "phase_wall_s": time.monotonic() - phase_t0,
          "launches": launches, "card": dev["kind"], "nvidia_smi": smi_line})
    return launches, batch


# ---------------------------------------------------------------------------
# phases 5b-5d: the role split, the fleet router and its chaos drill
# ---------------------------------------------------------------------------
ROLE_BLOCKS = 256       # each role/replica engine's KV pool, 64-token blocks
CHAIN_TOKENS = 512      # the chain whose handoff is timed part by part
FLEET_PREFIX, FLEET_SUFFIX, FLEET_NEW = 256, 64, 16   # fleet prompt shape
FLEET_WAVE = 3          # concurrent requests per shared prefix after a seed
DRILL_CLIENTS, DRILL_NEW = 12, 6


def _side_engine(eng):
    """An engine over ``eng``'s weights (the same tensors, not a copy) with
    a KV pool of its own."""
    from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2,
                                                            V2EngineConfig)
    return InferenceEngineV2(eng.params, eng.model_config, V2EngineConfig(
        kv_block_size=64, kv_num_blocks=ROLE_BLOCKS,
        scheduler=eng.config.scheduler), device=eng.device)


def _recording_handoffs(pair):
    """Keep a copy of every handoff latency the serve loop drains."""
    lat = []
    pop = pair.pop_handoff_latencies

    def recording():
        out = pop()
        lat.extend(s for _, s in out)
        return out
    pair.pop_handoff_latencies = recording
    return lat


def _serve_pair(pair, prompts, finite):
    """The prompts through ``InferenceServer`` over ``pair``, queued before
    the loop starts (admitted together, as the serve phase's 8). Returns
    the replies, the launches, the pair's chunks and decode ticks and the
    handoff latencies."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.serving import (InferenceServer, ServingConfig,
                                             ServingFrontend)
    lat = _recording_handoffs(pair)
    server = InferenceServer(pair, ServingConfig(max_queue_depth=64))
    fe = ServingFrontend(server, host="127.0.0.1", port=0).start()
    led = pair.sched_ledger
    ledger0 = (led.chunks_total, led.decode_ticks)
    try:
        finite.fill_(True)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        replies, window_s = _concurrent_generate(fe.url, prompts, server)
        torch.cuda.synchronize()
        launches = build.launch_counts()
        faults = _no_faults(server, "disagg")
    finally:
        fe.stop()
        server.stop(drain_timeout=60.0)
    return {"replies": replies, "window_s": window_s, "launches": launches,
            "chunks": led.chunks_total - ledger0[0],
            "decode_steps": led.decode_ticks - ledger0[1],
            "latencies": lat, "faults": faults}


def _chain_split(pair, cfg, finite):
    """One CHAIN_TOKENS-token sequence prefilled on the prefill engine and
    handed across with the int8 codec: its D2H gather, host codec and H2D
    scatter timed part by part on a copy, then the pair's own handoff; the
    adopted pages held against the host round trip (bit for bit) and the
    round trip against the donor (``quantize_error_bound``)."""
    from deepspeed_tpu_torch.inference.v2.kv_offload import (
        dequantize_pages, quantize_error_bound, quantize_pages)
    prefill, decode = pair.prefill, pair.decode
    uid = 50_000
    prompt = np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, CHAIN_TOKENS).tolist()
    prefill.admit(uid, prompt)
    while prefill.state.get(uid).in_prefill:
        prefill.step()
    blocks = list(prefill.state.get(uid).blocks)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    data, _ = prefill.kv.gather_blocks(blocks)          # D2H (pageable)
    t1 = time.monotonic()
    codes, qs = quantize_pages(data, "int8")            # host codec
    t2 = time.monotonic()
    back = dequantize_pages(codes, qs, "int8", torch.float32)
    t3 = time.monotonic()
    spare = decode.kv.reserve(len(blocks))
    decode.kv.scatter_blocks(spare, back)               # H2D
    torch.cuda.synchronize()
    t4 = time.monotonic()
    decode.kv.release(spare)
    bound = quantize_error_bound(qs, "int8")
    round_trip_err = (back - data.float()).abs().max().item()
    pair._handoff()
    (_, lat_s), = pair.pop_handoff_latencies()
    seq = decode.state.get(uid)
    check(seq is not None and uid not in prefill.state,
          "the 512-token chain did not cross")
    adopted, _ = decode.kv.gather_blocks(seq.blocks)
    decode.finish(uid)
    decode.reap_finished()
    check(torch.equal(adopted, back.to(adopted.dtype)),
          "int8 handoff: the adopted pages are not the host round trip")
    check(round_trip_err <= bound, f"int8 handoff: round trip error "
          f"{round_trip_err} over its bound {bound}")
    return {"tokens": CHAIN_TOKENS, "blocks": len(blocks),
            "raw_bytes": data.numel() * data.element_size(),
            "stored_bytes": codes.numel() + qs.numel() * 4,
            "d2h_s": t1 - t0, "quantize_s": t2 - t1, "dequantize_s": t3 - t2,
            "h2d_s": t4 - t3, "handoff_s": lat_s,
            "round_trip_max_abs_err": round_trip_err, "bound": bound,
            "adopted_vs_donor_max_abs_err":
                (adopted.float() - data.float()).abs().max().item()}


def phase_disagg(eng, prompts, batch, finite, dev, smi_line):
    """A prefill-role and a decode-role ``InferenceEngineV2`` over the
    engine phase's Llama-3-8B weights, each with its own KV pool, as one
    ``DisaggregatedEngine`` behind ``InferenceServer``: the 8 prompts with
    the "none" codec (greedy tokens bit for bit the single engine's, every
    uid across, no host bytes left), then with "int8" (every request in
    full), and one 512-token chain's int8 handoff timed part by part.
    Returns the paged kernel's launches over the "none" run."""
    from deepspeed_tpu_torch.serving import DisaggregatedEngine
    phase_t0 = time.monotonic()
    cfg, vocab = eng.model_config, eng.model_config.vocab_size
    prefill, decode = _side_engine(eng), _side_engine(eng)
    check(prefill.params is eng.params and decode.params is eng.params,
          "a role engine copied the weights")
    for e in (prefill, decode):
        check_finite(e, finite)
    runs = {}
    for codec in ("none", "int8"):
        pair = DisaggregatedEngine(prefill, decode, handoff_quantize=codec)
        run = _serve_pair(pair, prompts, finite)
        for i, (status, body, _) in enumerate(run["replies"]):
            toks = body.get("tokens", ())
            check(status == 200 and len(toks) == NEW_TOKENS
                  and all(0 <= t < vocab for t in toks),
                  f"disagg {codec}, request {i}: {status} {body}")
        check(bool(finite.item()), f"disagg {codec}: non-finite logits")
        stats = dict(pair.handoff_stats)
        check(stats["handoffs"] == len(prompts) and
              pair.host_kv_bytes() == 0,
              f"disagg {codec}: {stats}, {pair.host_kv_bytes()} host bytes")
        want = cfg.num_layers * (run["chunks"] + run["decode_steps"])
        got = run["launches"].get("paged_attention", 0)
        check(got >= want, f"disagg {codec}: paged_attention launched {got} "
              f"times, expected >= {want}")
        lat = sorted(run["latencies"])
        runs[codec] = {"handoff_stats": stats,
                       "handoff_latency_s": _quantiles(lat),
                       "window_s": run["window_s"],
                       "http_latency_s": _quantiles(
                           [r[2] for r in run["replies"]]),
                       "prefill_chunks": run["chunks"],
                       "decode_steps": run["decode_steps"],
                       "launches": run["launches"], "faults": run["faults"]}
        if codec == "none":
            for i, (_, body, _) in enumerate(run["replies"]):
                check(body["tokens"] == batch[i],
                      f"disagg none, request {i}: {body['tokens']} differs "
                      f"from the single engine's {batch[i]}")
            launches = run["launches"]
        else:
            check(stats["handoff_bytes"] < stats["handoff_raw_bytes"],
                  f"disagg int8: stored {stats['handoff_bytes']} not under "
                  f"raw {stats['handoff_raw_bytes']}")
            chain = _chain_split(pair, cfg, finite)
    for e in (prefill, decode):
        led = e.kv_ledger()
        check(led["device_blocks_reserved"] == 0 and led["host_bytes"] == 0,
              f"disagg: a role engine's ledger after the drain: {led}")
    emit({"phase": "disagg", "model": "LLAMA3_8B bf16 (32 layers, full width)",
          "role_blocks": ROLE_BLOCKS, "none": runs["none"],
          "int8": runs["int8"], "tokens_bit_exact": True,
          "chain_512": chain, "phase_wall_s": time.monotonic() - phase_t0,
          "card": dev["kind"], "nvidia_smi": smi_line})
    del prefill, decode
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _fleet_prompts(vocab):
    """Two shared 256-token prefixes; every prompt is one of them plus a
    64-token suffix of its own."""
    rng = np.random.default_rng(SEED + 6)
    heads = [rng.integers(0, vocab, FLEET_PREFIX).tolist() for _ in range(2)]
    return heads, lambda h: heads[h] + rng.integers(
        0, vocab, FLEET_SUFFIX).tolist()


def _timed(obj, name, log):
    """Wrap ``obj.name`` to append (seconds, result) of each call to log."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        t0 = time.monotonic()
        out = fn(*a, **kw)
        log.append((time.monotonic() - t0, out))
        return out
    setattr(obj, name, timed)


def phase_fleet(eng, finite, dev, smi_line):
    """Two in-process replicas (``InferenceServer`` + ``ServingFrontend``
    over engines that share the engine phase's weights, prefix caches on)
    behind ``FleetRouter``: one seed request per shared prefix (the second
    sent while the first is in flight, so each prefix starts on its own
    replica), then a concurrent wave that affinity must keep on the seed's
    replica, every reply in full; then replica 1 retires through
    ``/admin/drain`` with an int8 prefix handoff and replica 0, its
    successor, must serve the retiree's prefix as a hit. Returns the paged
    kernel's launches over the seed and the wave."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.serving import (FleetConfig, FleetRouter,
                                             InferenceServer, ReplicaHandle,
                                             ServingConfig, ServingFrontend)
    from deepspeed_tpu_torch.telemetry import reqtrace
    from deepspeed_tpu_torch.telemetry.tracer import get_tracer
    phase_t0 = time.monotonic()
    cfg, vocab = eng.model_config, eng.model_config.vocab_size
    workdir = tempfile.mkdtemp(prefix="smoke-fleet-")
    engines = [_side_engine(eng) for _ in range(2)]
    for e in engines:
        check_finite(e, finite)
    servers = [InferenceServer(e, ServingConfig(
        max_queue_depth=64, prefix_cache_enabled=True)).start()
        for e in engines]
    for rid, server in enumerate(servers):
        server.replica_id = rid
    fes = [ServingFrontend(s, host="127.0.0.1", port=0).start()
           for s in servers]
    router = FleetRouter(FleetConfig(
        replicas=2, affinity_block_tokens=64, poll_interval_s=0.05,
        drain_deadline_s=300.0, handoff_dir=workdir,
        handoff_quantize="int8", request_timeout_s=600.0),
        handles=[ReplicaHandle(i, fe.url) for i, fe in enumerate(fes)])
    tracer = get_tracer().configure(enabled=True)
    tracer.clear()
    router.start()
    try:
        heads, prompt_of = _fleet_prompts(vocab)
        led0 = [(e.sched_ledger.chunks_total, e.sched_ledger.decode_ticks)
                for e in engines]
        finite.fill_(True)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        out = {}

        def send(key, prompt):
            out[key] = _post_generate(router.url, prompt, FLEET_NEW)
        seed0 = threading.Thread(target=send, args=(("seed", 0),
                                                    prompt_of(0)))
        seed0.start()
        deadline = time.monotonic() + 60.0
        while router._handles[0].pending == 0:
            check(time.monotonic() < deadline and seed0.is_alive(),
                  "the first seed was never routed")
            time.sleep(0.001)
        send(("seed", 1), prompt_of(1))
        seed0.join(timeout=600)
        wave = [threading.Thread(target=send, args=((h, j), prompt_of(h)))
                for h in range(2) for j in range(FLEET_WAVE)]
        for t in wave:
            t.start()
        for t in wave:
            t.join(timeout=600)
        torch.cuda.synchronize()
        launches = build.launch_counts()
        check(len(out) == 2 + 2 * FLEET_WAVE, "a fleet client hung")
        for key, (status, body, _) in out.items():
            toks = body.get("tokens", ())
            check(status == 200 and len(toks) == FLEET_NEW
                  and all(0 <= t < vocab for t in toks),
                  f"fleet request {key}: {status} {body}")
        home = {h: out[("seed", h)][1]["replica_id"] for h in range(2)}
        check(home == {0: 0, 1: 1}, f"the seeds' replicas: {home}")
        for (h, j), (_, body, _) in out.items():
            if h != "seed":
                check(body["replica_id"] == home[h],
                      f"prefix {h} request {j} went to replica "
                      f"{body['replica_id']}, its prefix lives on {home[h]}")
        check(bool(finite.item()), "fleet: non-finite logits")
        chunks = sum(e.sched_ledger.chunks_total - c for e, (c, _) in
                     zip(engines, led0))
        decode_steps = sum(e.sched_ledger.decode_ticks - d for e, (_, d) in
                           zip(engines, led0))
        want = cfg.num_layers * (chunks + decode_steps)
        got = launches.get("paged_attention", 0)
        check(got >= want, f"fleet: paged_attention launched {got} times, "
              f"expected >= {want}")
        counters = router.counters_snapshot()
        check(counters["completed"] == len(out)
              and counters["requests_lost"] == 0
              and counters["affinity_hits"] == 2 * FLEET_WAVE,
              f"fleet counters: {counters}")
        stats = [e.prefix_stats() for e in engines]
        hit = sum(st["prefix_hit_tokens"] for st in stats)
        looked = sum(st["prefix_lookup_tokens"] for st in stats)
        ring = os.path.join(workdir, "ring.json")
        tracer.export_chrome(ring)
        stitched = reqtrace.stitch_requests([ring])
        check(stitched["requests_stitched"] == len(out)
              and not stitched["tie_out_violations"],
              f"reqtrace: {stitched['requests_stitched']} stitched, "
              f"violations {stitched['tie_out_violations']}")
        rows = list(stitched["traces"].values())
        wall = [r["wall"]["dur_us"] / 1e6 for r in rows]
        replica = [r["span_sum_us"] / 1e6 for r in rows]
        gaps = [r["gap_us"] / 1e6 for r in rows]

        # retire replica 1 through /admin/drain; replica 0 adopts
        exports, imports = [], []
        _timed(servers[1], "export_prefix_handoff", exports)
        _timed(engines[0], "import_prefix_handoff", imports)
        before = engines[0].prefix_stats()["prefix_hit_tokens"]
        router._retire_one()
        deadline = time.monotonic() + 300.0
        while router.counters_snapshot()["handoffs"] < 1:
            check(time.monotonic() < deadline, "the retirement never "
                  f"handed off: {router.counters_snapshot()}")
            time.sleep(0.05)
        check(exports and imports and imports[0][1]["chains"] > 0
              and imports[0][1]["skipped"] == 0,
              f"handoff: export {exports}, import {imports}")
        warm = [_post_generate(router.url, prompt_of(1), FLEET_NEW)
                for _ in range(2)]
        for status, body, _ in warm:
            check(status == 200 and len(body.get("tokens", ())) == FLEET_NEW
                  and body["replica_id"] == 0,
                  f"warm request after the retirement: {status} {body}")
        hits = engines[0].prefix_stats()["prefix_hit_tokens"] - before
        check(hits >= len(warm) * FLEET_PREFIX,
              f"the successor served the retiree's prefix with {hits} hit "
              f"tokens, expected >= {len(warm) * FLEET_PREFIX}")
        faults = [_no_faults(s, f"fleet replica {i}")
                  for i, s in enumerate(servers)]
        snaps = {s["id"]: s for s in router.health()["replicas"]}
        check(snaps[1]["retired"] and snaps[0]["in_rotation"],
              f"after the retirement: {snaps}")
        counters = router.counters_snapshot()
    finally:
        router.stop(terminate_replicas=False)
        for fe in fes:
            fe.stop()
        for server in servers:
            if server.running:
                server.stop(drain_timeout=60.0)
        tracer.configure(enabled=False)
        tracer.clear()
        shutil.rmtree(workdir, ignore_errors=True)
    served = [b["replica_id"] for _, b, _ in out.values()]
    ex_s, ex = exports[0]
    im_s, im = imports[0]
    emit({"phase": "fleet", "model": "LLAMA3_8B bf16 (32 layers, full width)",
          "replicas": 2, "replica_blocks": ROLE_BLOCKS,
          "requests": len(out), "new_tokens": FLEET_NEW,
          "router_latency_s": _quantiles(wall),
          "replica_latency_s": _quantiles(replica),
          "router_gap_s": _quantiles(gaps),
          "client_latency_s": _quantiles([r[2] for r in out.values()]),
          "replica_share": {str(i): served.count(i) / len(served)
                            for i in range(2)},
          "fleet_hit_ratio": hit / max(looked, 1),
          "export": {"seconds": ex_s, **ex}, "import": {"seconds": im_s,
                                                        **im},
          "warm_hit_tokens": hits, "counters": counters, "faults": faults,
          "replica_ttft_p50_s": [s.metrics.snapshot()["ttft_p50_s"]
                                 for s in servers],
          "phase_wall_s": time.monotonic() - phase_t0, "card": dev["kind"],
          "nvidia_smi": smi_line})
    del engines, servers
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_fleet_drill(dev, smi_line):
    """Two ``fleet_worker`` processes on the card (``build_tiny_server``,
    fp32), launched by ``subprocess_launcher``, with
    ``DSTPU_CHAOS_REPLICA_KILL=1:4``: replica 1 kills itself mid-decode,
    and the router's exact counters must show no request lost (every
    client holds its full token count), replica 1 lost exactly once, its
    streams rerouted and recomputed, and the relaunch back in rotation."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.serving import FleetConfig, FleetRouter, http_util
    from deepspeed_tpu_torch.serving.fleet import subprocess_launcher
    phase_t0 = time.monotonic()
    workdir = tempfile.mkdtemp(prefix="smoke-drill-")
    saved = os.environ.get("DSTPU_CHAOS_REPLICA_KILL")
    os.environ["DSTPU_CHAOS_REPLICA_KILL"] = "1:4"
    router = None
    try:
        launcher = subprocess_launcher(
            workdir, worker_args=[
                "--kv-num-blocks", "64", "--kv-block-size", "16",
                "--serving-overrides", json.dumps(
                    {"idle_poll_s": 0.001, "max_queue_depth": 32})],
            start_timeout_s=300.0)
        router = FleetRouter(FleetConfig(
            replicas=2, poll_interval_s=0.1, poll_timeout_s=2.0,
            lost_after_s=0.5, retry_budget=3, retry_backoff_s=0.01,
            retry_backoff_max_s=0.1, relaunch_budget=1,
            affinity_enabled=False, request_timeout_s=240.0,
            flight_dir=workdir), launcher=launcher)
        t0 = time.monotonic()
        router.start()
        start_s = time.monotonic() - t0
        results = {}

        def client(i):
            tokens, final, status = [], {}, -1
            try:
                reply = http_util.open_stream(
                    router.url + "/generate",
                    {"prompt_tokens": [(i * 7 + j) % 96 + 1
                                       for j in range(8 + i % 4)],
                     "max_new_tokens": DRILL_NEW, "stream": True},
                    timeout_s=240.0)
                status = reply.status
                for rec in reply.records():
                    if "token" in rec:
                        tokens.append(rec["token"])
                    elif rec.get("done"):
                        final = rec
            except Exception as e:
                final = {"error": repr(e)}
            results[i] = (status, tokens, final)
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(DRILL_CLIENTS)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        clients_s = time.monotonic() - t0
        check(len(results) == DRILL_CLIENTS, "a drill client hung")
        for i, (status, tokens, final) in sorted(results.items()):
            check(status == 200 and len(tokens) == DRILL_NEW
                  and final.get("state") == "finished",
                  f"drill client {i}: {status} {tokens} {final}")
        c = router.counters_snapshot()
        rerouted = [f for _, _, f in results.values()
                    if f.get("rerouted", 0) > 0]
        check(c["requests_lost"] == 0 and c["completed"] == DRILL_CLIENTS
              and c["replicas_lost"] == 1 and c["reroutes"] >= 1
              and c["recomputed_tokens"] > 0 and rerouted
              and sum(f["recomputed_tokens"] for f in rerouted)
              == c["recomputed_tokens"], f"drill counters: {c}")
        deadline = time.monotonic() + 300.0
        while True:
            c = router.counters_snapshot()
            snaps = {s["id"]: s for s in router.health()["replicas"]}
            if (c["relaunches"] == 1 and snaps[1]["in_rotation"]
                    and snaps[1]["relaunches"] == 1):
                break
            check(time.monotonic() < deadline,
                  f"replica 1 never rejoined: {router.health()}")
            time.sleep(0.25)
        rejoin_s = time.monotonic() - t0
        flight = router.discover_flight_dumps()
        check(any(os.path.basename(p).startswith("flight_replica1_")
                  for p in flight), f"no flight dump of replica 1: {flight}")
    finally:
        if router is not None:
            router.stop()
        if saved is None:
            os.environ.pop("DSTPU_CHAOS_REPLICA_KILL", None)
        else:
            os.environ["DSTPU_CHAOS_REPLICA_KILL"] = saved
        shutil.rmtree(workdir, ignore_errors=True)
    emit({"phase": "fleet_drill", "model": "TINY_LLAMA fp32",
          "workers": 2, "clients": DRILL_CLIENTS, "new_tokens": DRILL_NEW,
          "counters": c, "rerouted_requests": len(rerouted),
          "fleet_start_s": start_s, "clients_s": clients_s,
          "rejoined_after_s": rejoin_s,
          "phase_wall_s": time.monotonic() - phase_t0, "card": dev["kind"],
          "nvidia_smi": smi_line})


# ---------------------------------------------------------------------------
# phase 5e: MoE serving (Qwen1.5-MoE-A2.7B, Mixtral-8x7B)
# ---------------------------------------------------------------------------
MIXTRAL_SERVE_LAYERS = 16   # of 32: all 32 take ~93 GB in bf16, 16 take ~47 GB
MOE_SERVE_BLOCKS = 256      # each engine's KV pool, 64-token blocks


def moe_serve_models():
    """(label, config, depth note) of the two MoE serving models: the
    published widths, random weights from the seed."""
    import dataclasses
    from deepspeed_tpu_torch.models.mixtral import MIXTRAL_8X7B
    from deepspeed_tpu_torch.models.qwen2_moe import Qwen2MoEConfig
    mix = dataclasses.replace(MIXTRAL_8X7B, base=dataclasses.replace(
        MIXTRAL_8X7B.base, num_layers=MIXTRAL_SERVE_LAYERS))
    return [("Qwen1.5-MoE-A2.7B", Qwen2MoEConfig(),
             "24 layers (full depth), 60 experts top-4, shared expert"),
            ("Mixtral-8x7B", mix,
             f"{MIXTRAL_SERVE_LAYERS} of 32 layers (all 32 exceed the card "
             "in bf16), 8 experts top-2")]


class _FirstCall:
    """Within the block ``module.name`` keeps its first call's arguments
    and result (detached copies): a gate's first call is layer 0 of the
    first forward."""

    def __init__(self, module, name):
        self.module, self.name = module, name

    def __enter__(self):
        self.fn, self.args, self.out = getattr(self.module, self.name), None, \
            None

        def recording(*args):
            out = self.fn(*args)
            if self.args is None:
                keep = (lambda t: t.detach().clone()
                        if isinstance(t, torch.Tensor) else t)
                self.args = [keep(a) for a in args]
                self.out = [keep(t) for t in out]
            return out
        setattr(self.module, self.name, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _serve_gate_vs_cpu(rec) -> dict:
    """The serving gate's first call again from the same logits on the
    CPU: the chosen experts and their weights, bit for bit."""
    logits, k, norm = rec.args
    cpu_i, cpu_w = rec.fn(logits.cpu(), k, norm)
    return {"tokens": int(logits.shape[0]),
            "experts_equal": bool(torch.equal(cpu_i, rec.out[0].cpu())),
            "weights_equal": bool(torch.equal(cpu_w, rec.out[1].cpu()))}


def phase_serve_moe(dev, smi_line):
    """The two MoE families through ``InferenceEngineV2`` on the card, one
    after the other: the engine phase's 8 seeded prompts (100-500 tokens),
    32 greedy tokens each, through the paged kernel (``MixtralPolicy`` /
    ``Qwen2MoEPolicy``: the dense all-expert combine); the kernel against
    the plain paged attention at one prefill and one decode step; layer 0's
    gating on the card against the CPU's from the same logits, bit for
    bit."""
    from deepspeed_tpu_torch.inference.v2 import modules
    from deepspeed_tpu_torch.models.convert import init_moe_params
    rng = np.random.default_rng(SEED + 1)
    lens = rng.integers(100, 501, ENGINE_REQUESTS)
    path, rows = {}, []
    for label, cfg, depth in moe_serve_models():
        _release()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        params = init_moe_params(cfg, seed=SEED, device="cuda")
        n_params = sum(t.numel() for t in _leaves(params))
        with _FirstCall(modules, "serve_route") as rec:
            eng, prompts, outputs, st = run_engine(
                cfg, torch.device("cuda"), kv_num_blocks=MOE_SERVE_BLOCKS,
                prompt_lens=lens, new_tokens=NEW_TOKENS, params=params)
        gating = _serve_gate_vs_cpu(rec)
        layers = cfg.base.num_layers
        want = layers * (st["prefill_chunks"] + st["decode_steps"])
        got = st["launches"].get("paged_attention", 0)
        cmp = []
        for step, a, g in zip(("prefill", "decode"),
                              prefill_decode_logits(eng, prompts[0], "auto"),
                              prefill_decode_logits(eng, prompts[0],
                                                    "gather")):
            spread = (g.max() - g.min()).item()
            cmp.append({"step": step,
                        "max_abs_err": (a - g).abs().max().item(),
                        "spread": spread, "tol": LOGITS_TOL * spread,
                        "same_argmax": int(a.argmax()) == int(g.argmax()),
                        "finite": bool(torch.isfinite(a).all())})
        row = {"phase": "serve_moe", "model": f"{label} bf16, {depth}",
               "params": n_params, "requests": st["requests"],
               "tokens_generated": st["tokens"], "wall_s": st["wall_s"],
               "ttft_p50_s": st["ttft_p50_s"], "tpot_p50_s": st["tpot_p50_s"],
               "decode_tokens": st["decode_tokens"],
               "decode_tokens_per_s": st["decode_tokens_per_s"],
               "prefill_chunks": st["prefill_chunks"],
               "decode_steps": st["decode_steps"], "launches": st["launches"],
               "paged_launches_min": want, "vs_gather": cmp,
               "gating_vs_cpu": gating,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "phase_s": time.monotonic() - t0, "card": dev["kind"],
               "nvidia_smi": smi_line}
        emit(row)
        rows.append(row)
        check(st["requests"] == ENGINE_REQUESTS,
              f"{label}: served {st['requests']} requests")
        check(all(len(v) == NEW_TOKENS for v in outputs.values()),
              f"{label}: a request did not produce all its tokens")
        check(st["logits_finite"], f"{label}: non-finite logits")
        check(got >= want, f"{label}: paged_attention launched {got} times, "
              f"expected >= {want} ({layers} layers x (chunks + decode "
              "steps))")
        for c in cmp:
            check(c["finite"] and c["max_abs_err"] <= c["tol"],
                  f"{label}: auto vs gather {c['step']} logits differ by "
                  f"{c['max_abs_err']} (spread {c['spread']})")
        check(gating["experts_equal"] and gating["weights_equal"],
              f"{label}: layer 0's gating on the card differs from the "
              f"CPU's: {gating}")
        for n, k in st["launches"].items():
            path[n] = path.get(n, 0) + k
        del eng, params
    _release()
    return path


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# phase 6: ZeRO-Inference on the quantized weight store
# ---------------------------------------------------------------------------
ZI_PROMPT_LEN, ZI_PROMPTS, ZI_NEW = 128, 4, 32   # resident generate
ZI_STREAM_NEW = 8                               # streamed generate
A2_LAYERS = 4
# a weight within its group's bound: fp8 e4m3 scale * 448 * 2^-4 (the bound
# kv_offload.quantize_error_bound uses), int8 scale / 2; the slack covers
# the fp32 rounding of x / scale and of code * scale
ZI_BOUND = {"fp8": 448.0 * 2.0 ** -4, "int8": 0.5}
ZI_BOUND_SLACK = 1e-4


def _quantized_leaves(store):
    from deepspeed_tpu_torch.inference.zero_inference import (QuantizedTensor,
                                                              _items)
    return [(p, n) for p, n in _items(store) if isinstance(n, QuantizedTensor)]


def _weight_bound_ratio(params, store):
    """Largest |dequantized - source| over its group's bound across every
    quantized weight (dequantized by the plain version, so this check
    launches no kernel)."""
    from deepspeed_tpu_torch.inference.zero_inference import _items
    from deepspeed_tpu_torch.ops.quant import dequantize_plain
    source = dict(_items(params))
    worst = 0.0
    for path, node in _quantized_leaves(store):
        src = source[path].float().reshape(-1)
        n = src.numel()
        deq = dequantize_plain(node.codes, node.scale,
                               torch.float32).reshape(-1)[:n]
        group = node.codes.shape[-1]
        bound = node.scale.reshape(-1).repeat_interleave(group)[:n] * \
            ZI_BOUND[node.fmt]
        worst = max(worst, ((deq - src).abs() / bound).max().item())
        del src, deq, bound
    return worst


def _counted(fn, names):
    """Run fn; return (its result, launches of ``names`` it made, host
    seconds ending in a synchronize)."""
    from deepspeed_tpu_torch.ops import build
    before = build.launch_counts()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    after = build.launch_counts()
    return out, {n: after.get(n, 0) - before.get(n, 0) for n in names}, seconds


def _logits_agree(resident, streamed):
    spread = (resident.max() - resident.min()).item()
    err = (resident - streamed).abs().max().item()
    same = (resident.argmax(-1) == streamed.argmax(-1)).float().mean().item()
    return err, spread, same


def run_zero_inference(cfg, fmt, q_bits, n_prompts, new_tokens, stream_new,
                       seed=SEED, keep_store=False):
    """ZeRO-Inference on seeded ``cfg`` weights, resident and host-streamed,
    through ``ZeROInferenceEngine`` (bf16): quantize, check every weight
    against its group's bound, forward one ZI_PROMPT_LEN-token prompt in
    both modes, generate ``n_prompts`` x ``new_tokens`` resident and one x
    ``stream_new`` streamed. Returns the numbers and each step's launches
    (the caller resets the counts before), and with ``keep_store`` the
    resident store under ``"store"``."""
    from deepspeed_tpu_torch.inference.zero_inference import (
        ZeROInferenceEngine, _items, quantized_nbytes)
    from deepspeed_tpu_torch.models.convert import init_llama_params
    names = ("quantize_fp8", "dequantize_fp8", "quantize_int8",
             "dequantize_int8", "paged_attention")
    kw = dict(model_config=cfg, q_bits=q_bits, group_size=64, fmt=fmt,
              dtype=torch.bfloat16)
    params = init_llama_params(cfg, seed=seed, device="cuda")
    model_bytes = sum(t.numel() * t.element_size()
                      for _, t in _items(params))
    torch.cuda.reset_peak_memory_stats()
    st = {"model_bytes": model_bytes, "launches": {}}
    resident, st["launches"]["quantize_resident"], st["quantize_s"] = _counted(
        lambda: ZeROInferenceEngine(None, params, offload="none", **kw), names)
    st["weight_err_over_bound"] = _weight_bound_ratio(params, resident.qstore)
    streamed, st["launches"]["quantize_streamed"], st["quantize_streamed_s"] \
        = _counted(lambda: ZeROInferenceEngine(None, params, offload="cpu",
                                               **kw), names)
    del params                       # the bf16 source is no longer needed
    gc.collect()
    torch.cuda.empty_cache()
    st["store_bytes"] = quantized_nbytes(resident.qstore)
    rng = np.random.default_rng(seed + 6)
    prompts = [rng.integers(0, cfg.vocab_size, ZI_PROMPT_LEN).tolist()
               for _ in range(n_prompts)]
    batch = {"input_ids": np.asarray([prompts[0]], np.int32)}
    logits_r, st["launches"]["forward_resident"], st["forward_resident_s"] = \
        _counted(lambda: resident.forward(batch), names)
    moved = streamed.streamed_bytes
    logits_s, st["launches"]["forward_streamed"], st["forward_streamed_s"] = \
        _counted(lambda: streamed.forward(batch), names)
    st["forward_streamed_bytes"] = streamed.streamed_bytes - moved
    st["h2d_gb_per_s"] = st["forward_streamed_bytes"] / \
        st["forward_streamed_s"] / 1e9
    st["logits_finite"] = bool(torch.isfinite(logits_r).all()
                               and torch.isfinite(logits_s).all())
    st["logits_max_abs_err"], st["logits_spread"], st["argmax_agreement"] = \
        _logits_agree(logits_r[0], logits_s[0])
    del logits_r, logits_s
    outs, gen_launches, gen_s = [], [], 0.0
    for p in prompts:
        out, launches, seconds = _counted(
            lambda: resident.generate(p, max_new_tokens=new_tokens), names)
        outs.append(out)
        gen_launches.append(launches)
        gen_s += seconds
    st["launches"]["generate_resident"] = gen_launches
    st["generate_resident_tokens_per_s"] = sum(map(len, outs)) / gen_s
    moved = streamed.streamed_bytes
    out_s, st["launches"]["generate_streamed"], seconds = _counted(
        lambda: streamed.generate(prompts[0], max_new_tokens=stream_new), names)
    st["generate_streamed_tokens_per_s"] = len(out_s) / seconds
    st["generate_streamed_h2d_gb_per_s"] = \
        (streamed.streamed_bytes - moved) / seconds / 1e9
    st["greedy_agreement"] = float(np.mean(
        [a == b for a, b in zip(outs[0], out_s)]))
    st["tokens"] = {"resident": [len(o) for o in outs], "streamed": len(out_s)}
    st["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    if keep_store:
        st["store"] = resident.qstore
    del resident, streamed
    gc.collect()
    torch.cuda.empty_cache()
    return st


def _zi_checks(st, cfg, quant_name, deq_name, quant_launches, label):
    """The exact launch counts of one ZeRO-Inference run: one quantize per
    quantized leaf per engine, one dequantize per quantized leaf per
    dequantization (the streamed generate dequantizes the embedding and the
    head once and every layer once per token)."""
    leaves = 2 + 7 * cfg.num_layers           # embed, lm_head, 7 per layer
    per_token = 7 * cfg.num_layers
    ln = st["launches"]
    for step in ("quantize_resident", "quantize_streamed"):
        check(ln[step][quant_name] == quant_launches,
              f"{label}: {step} launched {quant_name} {ln[step][quant_name]} "
              f"times, expected {quant_launches}")
    for step in ("forward_resident", "forward_streamed"):
        check(ln[step][deq_name] == leaves,
              f"{label}: {step} launched {deq_name} {ln[step][deq_name]} "
              f"times, expected {leaves}")
    for i, g in enumerate(ln["generate_resident"]):
        check(g[deq_name] == leaves, f"{label}: generate {i} launched "
              f"{deq_name} {g[deq_name]} times, expected {leaves}")
        check(g["paged_attention"] >= cfg.num_layers * ZI_NEW // 2,
              f"{label}: generate {i} launched paged_attention only "
              f"{g['paged_attention']} times")
    want = 2 + ZI_STREAM_NEW * per_token
    got = ln["generate_streamed"][deq_name]
    check(got == want, f"{label}: streamed generate launched {deq_name} "
          f"{got} times, expected {want}")
    check(st["weight_err_over_bound"] <= 1.0 + ZI_BOUND_SLACK,
          f"{label}: a weight is {st['weight_err_over_bound']} times its "
          "group's bound away from its source")
    check(st["logits_finite"], f"{label}: non-finite logits")
    check(st["logits_max_abs_err"] <= LOGITS_TOL * st["logits_spread"],
          f"{label}: resident vs streamed logits differ by "
          f"{st['logits_max_abs_err']} (spread {st['logits_spread']})")
    check(st["tokens"]["resident"] == [ZI_NEW] * len(ln["generate_resident"])
          and st["tokens"]["streamed"] == ZI_STREAM_NEW,
          f"{label}: generated {st['tokens']} tokens")


def _store_dequant_timing(store, deq_name):
    """One whole-store ``dequantize_model_params`` to bf16 (each quantized
    leaf through its dequantize kernel): the kernels' device time summed
    over the call, the call by CUDA events, against the bytes bound of the
    codes and scales read and the outputs written once."""
    from deepspeed_tpu_torch.inference.zero_inference import (
        dequantize_model_params)
    leaves = _quantized_leaves(store)
    codes = sum(node.codes.numel() for _, node in leaves)
    nbytes = sum(node.codes.numel() * (node.codes.element_size() + 2)
                 + node.scale.numel() * 4 for _, node in leaves)
    call = lambda: dequantize_model_params(store, torch.bfloat16)  # noqa: E731
    return {"ms": _kernel_device_ms(call, [deq_name], iters=3)[deq_name],
            "call_ms": time_ms(call, iters=3, warmup=1),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "leaves": len(leaves), "codes": codes, "bytes": nbytes}


def phase_zero_inference(dev, smi_line):
    """A1: Llama-3-8B at full depth, fp8 e4m3 weights in groups of 64; A2:
    the default int8 store at full width, A2_LAYERS layers. Each is one main
    path run of its kernels (counts reset before, read after). After A1's
    run, one whole-store dequantization of its resident store is timed
    (outside the path's counts)."""
    import dataclasses
    from deepspeed_tpu_torch.models.llama import LLAMA3_8B
    from deepspeed_tpu_torch.ops import build
    runs = {}
    for label, cfg, fmt, deq, quant_launches in (
            ("A1", LLAMA3_8B, "fp", "dequantize_fp8", 2 + 7 * 32),
            ("A2", dataclasses.replace(LLAMA3_8B, num_layers=A2_LAYERS),
             "int", "dequantize_int8", 0)):
        build.reset_launch_counts()       # the main path's run starts here
        st = run_zero_inference(cfg, fmt, 8, ZI_PROMPTS if label == "A1"
                                else 1, ZI_NEW, ZI_STREAM_NEW,
                                keep_store=label == "A1")
        st["path_launches"] = build.launch_counts()
        store = st.pop("store", None)
        if store is not None:
            st["store_dequantize"] = _store_dequant_timing(store, deq)
            del store
            gc.collect()
            torch.cuda.empty_cache()
        emit({"phase": "zero_inference", "config": label,
              "model": f"LLAMA3_8B, {cfg.num_layers} layers, bf16, "
              f"{'fp8 e4m3' if fmt == 'fp' else 'int8'} weights, groups of 64",
              **st, "card": dev["kind"], "nvidia_smi": smi_line})
        quant = "quantize_fp8" if fmt == "fp" else "quantize_int8"
        _zi_checks(st, cfg, quant, deq, quant_launches, label)
        runs[label] = st
    return runs


# ---------------------------------------------------------------------------
# phase 7: the training path
# ---------------------------------------------------------------------------
def train_config(lr=3e-4, backend="flash"):
    """Llama-3-8B at its published width, cut to TRAIN_LAYERS layers, with
    bench.py's 8b recipe (seq 2048, micro-batch 1, gas 2, AdamW 3e-4, bf16
    with bf16 gradient accumulation, ZeRO 0, flash, remat); the probe
    changes ``lr`` or ``backend``."""
    import dataclasses
    from deepspeed_tpu_torch.models.llama import LLAMA3_8B
    cfg = dataclasses.replace(
        LLAMA3_8B, num_layers=TRAIN_LAYERS, max_seq_len=TRAIN_SEQ,
        dtype=torch.bfloat16, attention_backend=backend, remat=True,
        remat_policy="dots_with_no_batch_dims_saveable")
    ds_config = {
        "train_batch_size": TRAIN_GAS, "gradient_accumulation_steps": TRAIN_GAS,
        "optimizer": {"type": "AdamW", "params": {"lr": lr}},
        "bf16": {"enabled": True},
        "data_types": {"grad_accum_dtype": "bf16"},
        "zero_optimization": {"stage": 0},
        "steps_per_print": 1000000,
    }
    return cfg, ds_config


def _flash_vs_xla(engine, cfg, micro):
    """One micro-batch through the flash backend (the engine's model) and
    through the plain backend on a copy of the same weights: the two losses,
    global gradient norms, and per attention weight (wq, wk, wv, wo of each
    layer, where a faulty kernel shows first) the relative distance
    |g_flash - g_xla| / |g_xla| of the gradients."""
    import dataclasses
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.runtime.precision import global_grad_norm
    names = engine._param_names
    attn = [i for i, n in enumerate(names) if ".attn.w" in n]
    loss_f, grads = engine._grads_one_micro(micro, 1.0)
    norm_f = global_grad_norm(grads).item()
    attn_f = [grads[i] for i in attn]
    del grads
    xla = LlamaForCausalLM(dataclasses.replace(cfg, attention_backend="xla"),
                           device="cuda", seed=SEED)
    xla.load_state_dict(engine.model.state_dict())
    check([n for n, _ in xla.named_parameters()] == names,
          "the plain-backend copy lists its parameters in another order")
    loss_x = xla(micro, compute_dtype=engine.compute_dtype)
    grads = torch.autograd.grad(loss_x, list(xla.parameters()))
    norm_x = global_grad_norm(grads).item()
    attn_rel = {names[i]: ((f - grads[i]).norm() / grads[i].norm()).item()
                for i, f in zip(attn, attn_f)}
    del grads, xla, attn_f
    return loss_f.item(), loss_x.item(), norm_f, norm_x, attn_rel


def _train_steps(engine, batch, steps, names=tuple(FLASH_PER_STEP)):
    """``steps`` train_batch calls on one batch: losses, host ms per step
    (each ends in the loss readback), launches of ``names`` per step and
    the gradient norm of each step."""
    from deepspeed_tpu_torch.ops import build
    losses, step_ms, per_step, norms = [], [], [], []
    for _ in range(steps):
        before = build.launch_counts()
        t0 = time.monotonic()
        loss = engine.train_batch(batch=batch)
        losses.append(loss.item())     # the readback ends the step
        step_ms.append((time.monotonic() - t0) * 1e3)
        after = build.launch_counts()
        per_step.append({n: after.get(n, 0) - before.get(n, 0)
                         for n in names})
        norms.append(engine.get_global_grad_norm())
    return losses, step_ms, per_step, norms


def phase_train(dev, smi_line):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, random_tokens
    from deepspeed_tpu_torch.ops import build
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, ds_config = train_config()
    t0 = time.monotonic()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=LlamaForCausalLM(cfg, device="cuda", seed=SEED),
        config=ds_config)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(p.numel() for p in engine.model.parameters())
    batch = random_tokens(1, TRAIN_SEQ, vocab_size=cfg.vocab_size,
                          seed=SEED, gas=TRAIN_GAS)
    micro = {"input_ids": torch.from_numpy(batch["input_ids"][0]).cuda()}
    loss_f, loss_x, norm_f, norm_x, attn_rel = _flash_vs_xla(engine, cfg, micro)
    worst_attn = max(attn_rel.values())
    cmp_row = {"phase": "train_flash_vs_xla", "loss_flash": loss_f,
               "loss_xla": loss_x, "grad_norm_flash": norm_f,
               "grad_norm_xla": norm_x,
               "loss_rel": abs(loss_f - loss_x) / abs(loss_x),
               "grad_norm_rel": abs(norm_f - norm_x) / abs(norm_x),
               "attn_grad_rel_max": worst_attn, "attn_grad_rel": attn_rel,
               "limits": {"loss_rel": LOSS_REL, "grad_norm_rel": GRAD_NORM_REL,
                          "attn_grad_rel_max": ATTN_GRAD_REL}}
    emit(cmp_row)
    check(math.isfinite(loss_f) and cmp_row["loss_rel"] <= LOSS_REL,
          f"flash vs xla loss {loss_f} vs {loss_x}")
    check(math.isfinite(norm_f) and cmp_row["grad_norm_rel"] <= GRAD_NORM_REL,
          f"flash vs xla grad norm {norm_f} vs {norm_x}")
    check(worst_attn <= ATTN_GRAD_REL,
          f"flash vs xla attention-weight gradients differ by {worst_attn}")

    torch.cuda.synchronize()
    build.reset_launch_counts()        # the main path's run starts here
    losses, step_ms, per_step, _ = _train_steps(engine, batch,
                                                1 + TRAIN_STEPS)
    launches = build.launch_counts()
    timed = step_ms[1:]
    mean_ms = sum(timed) / len(timed)
    tokens = TRAIN_GAS * TRAIN_SEQ
    want = {n: k * TRAIN_LAYERS * TRAIN_GAS for n, k in FLASH_PER_STEP.items()}
    emit({"phase": "train", "model": f"LLAMA3_8B width, {TRAIN_LAYERS} layers, "
          "bf16, remat dots_with_no_batch_dims_saveable, flash",
          "params": n_params, "seq": TRAIN_SEQ, "micro_batch": 1,
          "gas": TRAIN_GAS, "init_s": init_s, "losses": losses,
          "step_ms": step_ms, "step_ms_mean": mean_ms,
          "tokens_per_s": tokens / (mean_ms / 1e3),
          "launches_per_step": per_step, "launches": launches,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "card": dev["kind"], "nvidia_smi": smi_line})
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(s == want for s in per_step),
          f"flash launches per step {per_step}, expected {want}")
    return engine, batch, launches, losses


def _profiled_step(engine, batch):
    """One warm-up step, then one training step under torch.profiler: the
    host ms of the window, its CUDA kernel events, their busy ms, and the
    key averages."""
    engine.train_batch(batch=batch).item()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        engine.train_batch(batch=batch).item()
        torch.cuda.synchronize()
        window_ms = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return window_ms, kernels, busy_ms, prof.key_averages()


def phase_train_profile(engine, batch, dev, smi_line):
    """One training step under torch.profiler: device busy time, idle
    share, kernels, top device and host ops."""
    window_ms, kernels, busy_ms, events = _profiled_step(engine, batch)
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    flash_ms = {n: sum(e.time_range.elapsed_us() for e in kernels
                       if f"{n}_kernel" in e.name) / 1e3
                for n in FLASH_PER_STEP}
    emit({"phase": "train_profile", "step_ms_profiled": window_ms,
          "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / window_ms,
          "kernels": len(kernels), "flash_kernel_ms": flash_ms,
          "card": dev["kind"], "nvidia_smi": smi_line,
          "top_device": _top(events, cuda, "self_device_time_total"),
          "top_host": _top(events, cpu, "self_cpu_time_total")})
    check(kernels, "the profiler saw no kernel on the card")


def phase_train_probe(batch, recipe_losses, dev, smi_line):
    """The recipe's 1 + TRAIN_STEPS steps again from the same seeded
    weights, twice: at LOW_LR (a tenth of the recipe's lr), where the loss
    must fall at every step, and with the plain attention backend at the
    recipe's lr, whose losses stand beside the flash run's. Separates the
    optimizer's step size from the kernels as the cause of a loss that
    rises between steps."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    runs, norms = {}, {}
    for name, lr, backend in (("flash_lr_3e-5", LOW_LR, "flash"),
                              ("xla_lr_3e-4", 3e-4, "xla")):
        cfg, ds_config = train_config(lr=lr, backend=backend)
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=LlamaForCausalLM(cfg, device="cuda", seed=SEED),
            config=ds_config)
        runs[name], _, _, norms[name] = _train_steps(engine, batch,
                                                     1 + TRAIN_STEPS)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    low = runs["flash_lr_3e-5"]
    emit({"phase": "train_probe", "flash_lr_3e-4": recipe_losses, **runs,
          "xla_minus_flash_lr_3e-4": [x - f for x, f in
                                      zip(runs["xla_lr_3e-4"], recipe_losses)],
          "card": dev["kind"], "nvidia_smi": smi_line})
    check(all(math.isfinite(x) for r in runs.values() for x in r),
          f"non-finite probe loss {runs}")
    check(all(b < a for a, b in zip(low, low[1:])),
          f"loss at lr {LOW_LR} did not fall at every step: {low}")
    return norms["flash_lr_3e-5"][0]


# ---------------------------------------------------------------------------
# phase 8: training with qgZ (int8 gradients)
# ---------------------------------------------------------------------------
QGZ_STEPS = 3                      # train_batch steps after the first
QGZ_LEAVES = 3 + 9 * TRAIN_LAYERS  # gradients of >= 2048 elements at this width
QGZ_NORM_REL = 0.01                # step-1 gradient norm vs no qgZ
QGZ_KERNELS = ("quantize_int8", "dequantize_int8")


def phase_train_qgz(batch, plain_norm1, dev, smi_line):
    """The probe's lr-3e-5 recipe with ``zero_quantized_gradients``: 1 +
    QGZ_STEPS steps whose loss falls at every step, exactly QGZ_LEAVES int8
    quantize and dequantize launches per micro-batch (flash unchanged), the
    step-1 gradient norm within QGZ_NORM_REL of the same step without qgZ,
    and the qgZ kernels' share of a profiled step."""
    import warnings
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.ops import build
    cfg, ds_config = train_config(lr=LOW_LR)
    ds_config["zero_optimization"]["zero_quantized_gradients"] = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=LlamaForCausalLM(cfg, device="cuda", seed=SEED),
            config=ds_config)
    warned = any("NO bytes are saved" in str(w.message) for w in caught)
    torch.cuda.synchronize()
    build.reset_launch_counts()        # the main path's run starts here
    names = tuple(FLASH_PER_STEP) + QGZ_KERNELS
    losses, step_ms, per_step, norms = _train_steps(engine, batch,
                                                    1 + QGZ_STEPS, names)
    launches = build.launch_counts()
    window_ms, kernels, busy_ms, _ = _profiled_step(engine, batch)
    qgz_ms = {n: sum(e.time_range.elapsed_us() for e in kernels
                     if re.search(rf"(?<![A-Za-z_]){n}", e.name)) / 1e3
              for n in QGZ_KERNELS}
    want = {**{n: k * TRAIN_LAYERS * TRAIN_GAS
               for n, k in FLASH_PER_STEP.items()},
            **{n: QGZ_LEAVES * TRAIN_GAS for n in QGZ_KERNELS}}
    norm_rel = abs(norms[0] - plain_norm1) / plain_norm1
    timed = step_ms[1:]
    emit({"phase": "train_qgz", "model": f"LLAMA3_8B width, {TRAIN_LAYERS} "
          "layers, bf16, flash, lr 3e-5, zero_quantized_gradients",
          "warned": warned, "losses": losses, "step_ms": step_ms,
          "step_ms_mean": sum(timed) / len(timed), "grad_norms": norms,
          "grad_norm_step1_without_qgz": plain_norm1,
          "grad_norm_step1_rel": norm_rel, "launches_per_step": per_step,
          "launches": launches, "profiled_step_ms": window_ms,
          "device_busy_ms": busy_ms, "qgz_kernel_ms": qgz_ms,
          "qgz_share_of_busy": sum(qgz_ms.values()) / busy_ms,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "card": dev["kind"], "nvidia_smi": smi_line})
    check(warned, "qgZ on one card did not warn that no bytes are saved")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"qgZ loss did not fall at every step: {losses}")
    check(all(s == want for s in per_step),
          f"launches per step {per_step}, expected {want}")
    check(norm_rel <= QGZ_NORM_REL, f"step-1 gradient norm {norms[0]} with "
          f"qgZ vs {plain_norm1} without ({norm_rel:.4f} relative)")
    return launches


# ---------------------------------------------------------------------------
# phase 8b: distribution: ZeRO stages 1-3 and qgZ over ranks
# ---------------------------------------------------------------------------
ZERO_STEPS = 3                     # train_zero: steps after 1 warm-up
RANKS = 2                          # processes of the two-rank phases, one card
RANKS_STEPS = 2                    # train_batch steps of each two-rank run
RANKS_TIMEOUT = 420                # seconds one spawned two-rank job may take
# depth of the two-rank runs: the recipe's, cut only if gloo's host copies
# make full width too slow (width is never cut)
RANKS_LAYERS = TRAIN_LAYERS
RANKS_BATCH = 4                    # sequences a step: micro 1 x gas 2 x 2 ranks
# a master "moved apart" from the reference's when the two differ by more
# than this share of one AdamW step (lr): a step moves each weight by about
# lr, so a gradient whose sign flips in another summation order moves it
# ~2 lr, while the rest agree to rounding; the check counts such elements
MASTERS_ATOL_LR = 0.1
QGZ_RANKS_STEPS = 2                # train_qgz_ranks: steps after the first
# its depth: two ranks with the whole fp32 state (12 bytes a parameter) and
# a step's activations peak at ~36 GB each at 4 layers, which with the
# spawning process's blocks does not fit the 80 GB card; 2 layers leave
# ~8 GB a rank (width is never cut)
QGZ_RANKS_LAYERS = 2
RANK_OUT_ENV = "DSTPU_SMOKE_OUT"   # where a spawned rank writes its rows
RANK_MODEL_ENV = "DSTPU_SMOKE_MODEL"   # "8b" (the recipe) or "tiny" (tests)
RANK_DEVICE_ENV = "DSTPU_SMOKE_DEVICE"  # "cuda" (the card) or "cpu" (tests)
COLLECTIVE_SHAPE = (4096, 4096)    # the quantized collectives' input, bf16


def _init_world1():
    """The port's process group at one rank on the card: NCCL."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm.mesh import init_distributed
    from deepspeed_tpu_torch.testing import free_port
    if not dist.is_initialized():
        init_distributed(coordinator_address=f"127.0.0.1:{free_port()}",
                         num_processes=1, process_id=0, device="cuda")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"world-1 group is {dist.get_backend()} x {dist.get_world_size()}")


def _zero_recipe(stage, layers=TRAIN_LAYERS, model="8b", **zero):
    """``train_config()`` at ZeRO ``stage`` (for the card tests the tiny
    model in fp32 with the plain attention backend: at its few tokens a
    bf16 forward turns master differences far inside the tolerance into
    flipped bf16 weights)."""
    import dataclasses
    cfg, ds_config = train_config()
    if model == "tiny":
        from deepspeed_tpu_torch.models.llama import TINY_LLAMA
        cfg = dataclasses.replace(TINY_LLAMA, dtype=torch.float32,
                                  attention_backend="xla", remat=True,
                                  remat_policy=cfg.remat_policy)
    cfg = dataclasses.replace(cfg, num_layers=layers)
    ds_config["zero_optimization"].update(stage=stage, **zero)
    return cfg, ds_config


def _rank_device() -> str:
    return os.environ.get(RANK_DEVICE_ENV, "cuda")


def _engine(cfg, ds_config, mesh=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    dev = _rank_device()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=LlamaForCausalLM(cfg, device=dev, seed=SEED),
        config=ds_config, mesh=mesh, device=dev)
    return engine


def _peak_reset() -> None:
    if _rank_device() == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak() -> int:
    return torch.cuda.max_memory_allocated() if _rank_device() == "cuda" \
        else 0


def _state_bytes_of(shapes) -> dict:
    """fp32 masters and Adam's two moments of leaves ``shapes``, whole."""
    n = sum(math.prod(s) for s in shapes)
    return {"masters": 4 * n, "moments": 8 * n}


def _state_bytes(engine) -> dict:
    """What the engine holds on its rank: fp32 masters (a stage-3 leaf's
    block) and Adam's two moments (blocks from stage 1 on)."""
    opt = engine.optimizer
    return {"masters": sum(m.numel() * m.element_size()
                           for m in engine._masters),
            "moments": sum(t.numel() * t.element_size()
                           for t in list(opt.mu) + list(opt.nu))}


def phase_train_zero(batch, dev, smi_line):
    """ZeRO stages 1, 2 and 3 at one rank over NCCL (``init_distributed``
    on the card), 1 + ZERO_STEPS steps each on the ``train`` phase's batch,
    against the same steps at stage 0: losses, gradient norms and every
    fp32 master bit for bit (nothing is sharded and every reduction divides
    by 1), exactly FLASH_PER_STEP x layers x gas flash launches a step."""
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    from deepspeed_tpu_torch.ops import build
    _init_world1()
    comms = get_comms_logger()
    comms.reset()
    comms.configure(enabled=True)
    want = {n: k * TRAIN_LAYERS * TRAIN_GAS for n, k in FLASH_PER_STEP.items()}
    rows, ref, ref_masters, path = {}, None, None, {}
    for stage in (0, 1, 2, 3):
        engine = _engine(*_zero_recipe(stage))
        torch.cuda.synchronize()
        if stage == 1:
            build.reset_launch_counts()      # the main path's run starts here
        losses, step_ms, per_step, norms = _train_steps(engine, batch,
                                                        1 + ZERO_STEPS)
        row = {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
               "launches_per_step": per_step, **_state_bytes(engine)}
        check(all(s == want for s in per_step),
              f"stage {stage} flash launches per step {per_step}, "
              f"expected {want}")
        masters = [m for _, m in engine.named_masters()]
        if stage == 0:
            ref = (losses, norms)
            ref_masters = [m.detach().cpu() for m in masters]
        else:
            same = sum(torch.equal(m, r.to(m.device))
                       for m, r in zip(masters, ref_masters))
            row.update(masters_equal=same, leaves=len(masters))
            check(losses == ref[0] and norms == ref[1],
                  f"stage {stage} at world 1: losses {losses} norms {norms}"
                  f", stage 0: {ref}")
            check(same == len(masters), f"stage {stage} at world 1: "
                  f"{len(masters) - same} masters differ from stage 0's")
        rows[stage] = row
        del engine, masters
        _release()
    path = build.launch_counts()
    emit({"phase": "train_zero", "model": f"LLAMA3_8B width, {TRAIN_LAYERS} "
          "layers, bf16, flash, world 1 (NCCL)", "stages": rows,
          "comms": comms.per_op_totals(), "launches": path,
          "card": dev["kind"], "nvidia_smi": smi_line})
    comms.configure(enabled=False)
    del ref_masters
    _release()
    import torch.distributed as dist
    dist.destroy_process_group()
    return path


def _expected_comm(engine, stage, gas, bf16=2):
    """The facade bytes one step moves at two fsdp ranks, from the leaves'
    shapes: ``all_gather`` (stage 3: every sharded block in the compute
    dtype once a micro-batch, and again for the layers' blocks under remat;
    stages 1-2: the fp32 blocks after the update) and ``reduce_scatter``
    (each sharded leaf's full gradient a micro-batch: compute dtype under
    stage 3, fp32 under stage 2)."""
    ag = rs = 0
    for name, p, d_opt, d_par in zip(engine._param_names, engine._masters,
                                     engine._opt_dim, engine._param_dim):
        if d_opt is None:
            continue
        n = p.numel()                 # a block (stage 3) or the full leaf
        if stage == 3:
            gathers = 2 if ".layer_" in name else 1
            ag += gathers * n * bf16 * gas
            rs += 2 * n * bf16 * gas
        else:
            ag += n // 2 * 4
            rs += n * 4 * gas if stage == 2 else 0
    return {"all_gather": ag, "reduce_scatter": rs}


def _rank_out(name):
    return os.path.join(os.environ[RANK_OUT_ENV], name)


def _rank_steps(engine, batch, steps, comms):
    """``_train_steps`` with the comms logger's bytes of each step."""
    from deepspeed_tpu_torch.ops import build
    rows = []
    for _ in range(steps):
        before = build.launch_counts()
        ops0 = comms.per_op_totals()
        t0 = time.monotonic()
        loss = engine.train_batch(batch=batch).item()
        ms = (time.monotonic() - t0) * 1e3
        after = build.launch_counts()
        ops1 = comms.per_op_totals()
        rows.append({
            "loss": loss, "step_ms": ms,
            "grad_norm": engine.get_global_grad_norm(),
            "launches": {n: after.get(n, 0) - before.get(n, 0)
                         for n in set(after) | set(before)},
            "comm": {op: {k: t[k] - ops0.get(op, {}).get(k, 0)
                          for k in ("count", "bytes", "wire_bytes",
                                    "seconds")}
                     for op, t in ops1.items()}})
    return rows


def _recipe_lr(model) -> float:
    return float(_zero_recipe(0, 1, model)[1]["optimizer"]["params"]["lr"])


def _masters_apart(got, want, atol):
    """(share of elements more than ``atol`` apart, largest distance)."""
    n = apart = 0
    worst = 0.0
    for a, b in zip(got, want):
        d = (a - b).abs()
        n += d.numel()
        apart += int((d > atol).sum())
        worst = max(worst, float(d.max()))
    return apart / n, worst


def _world1_mesh():
    from deepspeed_tpu_torch.comm.mesh import MESH_AXES, Mesh
    return Mesh({a: 1 for a in MESH_AXES}, 0, torch.device(_rank_device()))


def zero_ranks_body():
    """One rank of ``train_zero_ranks`` (spawned by ``run_distributed`` on
    the card over gloo): rank 0 first runs the stage-0 reference on its own
    (a one-rank mesh) in three summation orders over the same sequences:
    micro 2 x gas 2 (the reference), micro 1 x gas 4, and micro 1 x gas 4
    with each micro-batch's two sequences swapped; the tolerance is twice
    the larger distance of the latter two from the reference. Then both
    ranks run stage 3 and stage 2 at fsdp=2, and rank 0 holds each against
    the reference. Three readings: each step's loss and global gradient
    norm (a reduction that forgets to divide by the world, or drops a
    rank's rows, moves the norm at once, where AdamW's masters barely
    notice the scale), and the share of master elements more than
    ``MASTERS_ATOL_LR`` x lr from the reference's (summation order flips
    the sign of a few near-zero gradients, each such element ~2 lr away,
    so a largest distance cannot tell a fault from those flips)."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    from deepspeed_tpu_torch.models.llama import random_tokens
    r = dist.get_rank()
    model = os.environ.get(RANK_MODEL_ENV, "8b")
    layers = int(os.environ.get("DSTPU_SMOKE_LAYERS", RANKS_LAYERS))
    out = {"rank": r, "runs": {}}
    gas = TRAIN_GAS
    cfg0, _ = _zero_recipe(0, layers, model)
    batch = random_tokens(RANKS_BATCH // gas, TRAIN_SEQ if model == "8b"
                          else 64, vocab_size=cfg0.vocab_size, seed=SEED,
                          gas=gas)
    flat = {k: v.reshape(gas * v.shape[1], 1, -1) for k, v in batch.items()}
    swapped = {k: v[:, ::-1].reshape(gas * v.shape[1], 1, -1)
               for k, v in batch.items()}
    atol = MASTERS_ATOL_LR * _recipe_lr(model)
    ref, tol = None, None
    if r == 0:
        runs = {}
        for name, b, g in (("micro2_gas2", batch, gas),
                           ("micro1_gas4", flat, 2 * gas),
                           ("micro1_gas4_swapped", swapped, 2 * gas)):
            cfg, ds = _zero_recipe(0, layers, model)
            ds.update(train_batch_size=RANKS_BATCH,
                      gradient_accumulation_steps=g)
            engine = _engine(cfg, ds, mesh=_world1_mesh())
            losses, norms = [], []
            for _ in range(RANKS_STEPS):
                losses.append(engine.train_batch(batch=b).item())
                norms.append(engine.get_global_grad_norm())
            runs[name] = (losses, norms, [m.detach().cpu() for _, m
                                          in engine.named_masters()])
            del engine
            _release()
        la, na, ma = runs.pop("micro2_gas2")
        apart = {k: _masters_apart(mb, ma, atol) for k, (_, _, mb)
                 in runs.items()}
        tol = {"loss": 2 * max(abs(a - b) for lb, _, _ in runs.values()
                               for a, b in zip(la, lb)),
               "grad_norm": 2 * max(abs(a - b) for _, nb, _ in runs.values()
                                    for a, b in zip(na, nb)),
               "masters_share": 2 * max(s for s, _ in apart.values())}
        ref = (la, na, ma)
        out["reference"] = {
            "losses_micro2_gas2": la, "grad_norms_micro2_gas2": na,
            "tolerance": tol, "masters_atol": atol,
            **{f"losses_{k}": v[0] for k, v in runs.items()},
            **{f"grad_norms_{k}": v[1] for k, v in runs.items()},
            **{f"masters_share_{k}": s for k, (s, _) in apart.items()},
            **{f"masters_max_abs_{k}": m for k, (_, m) in apart.items()}}
        del runs
    dist.barrier()
    comms = get_comms_logger()
    comms.configure(enabled=True)
    for stage in (3, 2):
        cfg, ds = _zero_recipe(stage, layers, model)
        ds.update(train_batch_size=RANKS_BATCH, mesh={"fsdp": RANKS,
                                                      "data": 1})
        _peak_reset()
        engine = _engine(cfg, ds)
        comms.reset()
        steps = _rank_steps(engine, batch, RANKS_STEPS, comms)
        run = {"steps": steps, **_state_bytes(engine),
               "peak_hbm": _peak(),
               "expected_comm_per_step": _expected_comm(engine, stage, gas),
               "opt_dims": engine._opt_dim, "param_dims": engine._param_dim}
        # every rank reads them (a stage-3 master is gathered); rank 0 keeps
        masters = [m.detach().cpu() for _, m in engine.named_masters()
                   if r == 0]
        if r == 0:
            run["masters_share"], run["masters_max_abs"] = _masters_apart(
                masters, ref[2], atol)
            run["loss_gap"] = max(abs(s["loss"] - a)
                                  for s, a in zip(steps, ref[0]))
            run["grad_norm_gap"] = max(abs(s["grad_norm"] - a)
                                       for s, a in zip(steps, ref[1]))
        out["runs"][stage] = run
        del engine, masters
        _release()
    comms.configure(enabled=False)
    with open(_rank_out(f"zero_ranks{r}.json"), "w") as f:
        json.dump(out, f)


def _read_ranks(stem, tmp):
    rows = []
    for r in range(RANKS):
        with open(os.path.join(tmp, f"{stem}{r}.json")) as f:
            rows.append(json.load(f))
    return rows


def _spawn(body, tmp, device="cuda", timeout=RANKS_TIMEOUT, **env):
    """Run ``body`` of this file in RANKS processes over gloo (on the card
    unless ``device`` says otherwise); the seconds it took."""
    from deepspeed_tpu_torch.testing import run_distributed
    t0 = time.monotonic()
    # the ranks share one card: segments that grow in place leave no
    # reserved-but-unusable blocks between them
    run_distributed(f"chip_smoke:{body}", RANKS, timeout=timeout,
                    env={RANK_OUT_ENV: tmp, RANK_DEVICE_ENV: device,
                         "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
                         **env},
                    backend="gloo", device=device)
    return time.monotonic() - t0


def _host_side(dev_type="cuda") -> dict:
    """What this (spawning) process holds on the card while ranks run."""
    if dev_type != "cuda":
        return {}
    return {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved()}


def phase_train_zero_ranks(dev, smi_line, tmp):
    """Two processes on the one card over gloo (named: NCCL refuses two
    ranks on one device), spawned through ``testing.run_distributed``:
    Llama-3-8B at full width, RANKS_LAYERS layers, stage 3 then stage 2 at
    fsdp=2, RANKS_STEPS steps each; losses, gradient norms and the share
    of masters apart within twice the distance of stage-0 runs that differ
    only in summation order, every rank's losses and norms equal; each
    rank's fp32 masters + moments, peak HBM, and the all_gather /
    reduce_scatter bytes a step beside the count from the leaves' shapes;
    exact flash launches a step."""
    _release()
    spawner = _host_side()
    seconds = _spawn("zero_ranks_body", tmp)
    rows = _read_ranks("zero_ranks", tmp)
    ref = rows[0]["reference"]
    tol = ref["tolerance"]
    want = {n: k * RANKS_LAYERS * TRAIN_GAS for n, k in FLASH_PER_STEP.items()}
    path = {n: 0 for n in FLASH_PER_STEP}
    summary = {}
    for stage in ("3", "2"):
        r0 = rows[0]["runs"][stage]
        per_rank = [{"masters": row["runs"][stage]["masters"],
                     "moments": row["runs"][stage]["moments"],
                     "peak_hbm": row["runs"][stage]["peak_hbm"]}
                    for row in rows]
        comm = [{op: s["comm"].get(op, {}).get("bytes", 0)
                 for op in ("all_gather", "reduce_scatter")}
                for s in r0["steps"]]
        summary[stage] = {"losses": [s["loss"] for s in r0["steps"]],
                          "step_ms": [s["step_ms"] for s in r0["steps"]],
                          "grad_norms": [s["grad_norm"] for s in r0["steps"]],
                          "masters_share": r0["masters_share"],
                          "masters_max_abs": r0["masters_max_abs"],
                          "loss_gap": r0["loss_gap"],
                          "grad_norm_gap": r0["grad_norm_gap"],
                          "per_rank": per_rank,
                          "comm_bytes_per_step": comm,
                          "comm_expected_per_step":
                              r0["expected_comm_per_step"],
                          "comm_per_step": r0["steps"][-1]["comm"]}
        check(r0["masters_share"] <= tol["masters_share"],
              f"stage {stage} x {RANKS}: a share {r0['masters_share']} of the"
              f" masters more than {ref['masters_atol']} from the stage-0 "
              f"run's, tolerance {tol['masters_share']}")
        check(r0["loss_gap"] <= tol["loss"], f"stage {stage} x {RANKS}: "
              f"losses {r0['loss_gap']} from stage 0, tolerance {tol['loss']}")
        check(r0["grad_norm_gap"] <= tol["grad_norm"],
              f"stage {stage} x {RANKS}: gradient norms {r0['grad_norm_gap']}"
              f" from stage 0, tolerance {tol['grad_norm']}")
        for row in rows:
            check([(s["loss"], s["grad_norm"]) for s in
                   row["runs"][stage]["steps"]] ==
                  [(s["loss"], s["grad_norm"]) for s in r0["steps"]],
                  f"stage {stage}: rank {row['rank']}'s losses or gradient "
                  "norms differ from rank 0's")
        check(all(c == r0["expected_comm_per_step"] for c in comm),
              f"stage {stage}: comm bytes {comm}, expected "
              f"{r0['expected_comm_per_step']}")
        for row in rows:
            for s in row["runs"][stage]["steps"]:
                got = {n: s["launches"].get(n, 0) for n in FLASH_PER_STEP}
                check(got == want, f"rank {row['rank']} stage {stage} flash "
                      f"launches {got}, expected {want}")
                for n in FLASH_PER_STEP:
                    path[n] += got[n]
    s3 = summary["3"]["per_rank"][0]
    emit({"phase": "train_zero_ranks", "model": f"LLAMA3_8B width, "
          f"{RANKS_LAYERS} layers (depth cut from 32 for gloo's host copies)"
          f", bf16, flash, {RANKS} ranks on one card over gloo",
          "reference": ref, "stages": summary, "seconds": seconds,
          "spawner_hbm": spawner,
          "stage3_state_share_of_stage0": (s3["masters"] + s3["moments"]) / (
              12 * llama_params(_zero_recipe(0)[0], RANKS_LAYERS)),
          "launches": path, "card": dev["kind"], "nvidia_smi": smi_line})
    check(s3["masters"] + s3["moments"] < 0.55 * 12 * llama_params(
        _zero_recipe(0)[0], RANKS_LAYERS),
          f"stage 3 holds {s3['masters'] + s3['moments']} bytes a rank")
    return path


QUANT_COLLECTIVES = ("quantized_all_gather", "quantized_psum_scatter",
                     "all_to_all_quant_reduce", "quantized_psum",
                     "quantized_all_to_all", "quantized_all_gather_fp8")


def _collectives(x):
    """The six quantized collectives of ``ops/quant.py`` and
    ``ops/fp_quant.py`` on ``x`` over the mesh's ``data`` axis."""
    from deepspeed_tpu_torch.ops import fp_quant, quant
    return {"quantized_all_gather": quant.quantized_all_gather(x, "data"),
            "quantized_psum_scatter": quant.quantized_psum_scatter(
                x, "data", mean=True),
            "all_to_all_quant_reduce": quant.all_to_all_quant_reduce(
                x, "data"),
            "quantized_psum": quant.quantized_psum(x, ("data",)),
            "quantized_all_to_all": quant.quantized_all_to_all(x, "data"),
            "quantized_all_gather_fp8": fp_quant.quantized_all_gather_fp8(
                x, "data")}


class _Plain:
    """Within the block the quantize / dequantize wrappers run their plain
    versions (torch ops on the card); the wire codec and the collectives
    call them through their modules."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops import fp_quant, quant
        self.saved = [(quant, "quantize_int8", quant.quantize_int8_plain),
                      (quant, "dequantize_int8", quant.dequantize_int8_plain),
                      (fp_quant, "quantize_fp8", fp_quant.quantize_fp8_plain),
                      (fp_quant, "dequantize_fp8",
                       fp_quant.dequantize_fp8_plain)]
        self.saved = [(m, n, getattr(m, n), new) for m, n, new in self.saved]
        for m, n, _, new in self.saved:
            setattr(m, n, new)
        return self

    def __exit__(self, *exc):
        for m, n, old, _ in self.saved:
            setattr(m, n, old)


def qgz_ranks_body():
    """One rank of ``train_qgz_ranks``: mesh data=2, qgZ, 1 + QGZ_RANKS_STEPS
    steps; the gradient sync of step 1 recorded, then run again on the same
    inputs with the plain codec, leaf by leaf, bit for bit; then the six
    quantized collectives once with the kernels (the ``quant_collectives``
    path) and once with the plain versions."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    from deepspeed_tpu_torch.models.llama import random_tokens
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    from deepspeed_tpu_torch.runtime.zero import qgz
    r = dist.get_rank()
    model = os.environ.get(RANK_MODEL_ENV, "8b")
    layers = int(os.environ.get("DSTPU_SMOKE_LAYERS", QGZ_RANKS_LAYERS))
    cfg, ds = _zero_recipe(0, layers, model, zero_quantized_gradients=True)
    ds.update(train_batch_size=RANKS_BATCH, mesh={"data": RANKS})
    ds["optimizer"]["params"]["lr"] = LOW_LR
    engine = _engine(cfg, ds)
    batch = random_tokens(RANKS_BATCH // TRAIN_GAS, TRAIN_SEQ if model == "8b"
                          else 64, vocab_size=cfg.vocab_size, seed=SEED,
                          gas=TRAIN_GAS)
    n_leaves = len(engine._masters)
    record = {"inputs": [], "outputs": []}
    sync = engine_mod.quantized_grad_sync

    def recording(grads, axes):       # step 1's calls, a leaf each
        out = sync(grads, axes)
        if len(record["inputs"]) < n_leaves:
            record["inputs"] += [g.detach().cpu() for g in grads]
            record["outputs"] += [g.detach().cpu() for g in out]
            record["axes"] = axes
        return out

    engine_mod.quantized_grad_sync = recording
    comms = get_comms_logger()
    comms.reset()
    comms.configure(enabled=True)
    try:
        build.reset_launch_counts()        # the main path's run starts here
        steps = _rank_steps(engine, batch, 1 + QGZ_RANKS_STEPS, comms)
        path = build.launch_counts()
    finally:
        engine_mod.quantized_grad_sync = sync
        comms.configure(enabled=False)
    peak = _peak()
    shapes = [tuple(m.shape) for m in engine._masters]
    itemsize = torch.empty((), dtype=engine.config.grad_accum_dtype
                           ).element_size()
    quantized = qgz.quantized_leaves(shapes, RANKS, itemsize)
    del engine
    _release()
    # the same sync with the plain codec, a leaf at a time
    same, launched = 0, 0
    with _Plain():
        before = sum(build.launch_counts().values())
        for g, want in zip(record["inputs"], record["outputs"]):
            got = qgz.quantized_grad_sync([g.to(_rank_device())],
                                          record["axes"])[0]
            same += int(torch.equal(got.cpu(), want))
        launched = sum(build.launch_counts().values()) - before
    # the quantized collectives, kernels then plain versions
    dev = _rank_device()
    gen = torch.Generator(device=dev).manual_seed(SEED + r)
    x = torch.randn(COLLECTIVE_SHAPE if model == "8b" else (64, 256),
                    generator=gen, device=dev).to(torch.bfloat16)
    build.reset_launch_counts()
    kern = _collectives(x)
    coll_path = build.launch_counts()
    with _Plain():
        plain = _collectives(x)
    coll = {n: bool(torch.equal(kern[n].view(torch.int16),
                                plain[n].view(torch.int16)))
            for n in QUANT_COLLECTIVES}
    out = {"rank": r, "steps": steps, "path": path, "quantized_leaves":
           quantized, "leaves": len(shapes), "sync_equal": same,
           "sync_leaves": len(record["outputs"]), "plain_launches": launched,
           "collectives_equal": coll, "collectives_path": coll_path,
           "layers": layers, "peak_hbm": peak, **_state_bytes_of(shapes)}
    with open(_rank_out(f"qgz_ranks{r}.json"), "w") as f:
        json.dump(out, f)


def phase_train_qgz_ranks(dev, smi_line, tmp):
    """Two processes on the card over gloo, mesh data=2 with
    ``zero_quantized_gradients``: the step's gradient sync is
    ``quantized_all_reduce`` through the int8 kernels, exactly 2 quantize
    and 2 dequantize launches a step for each leaf that passes
    MIN_QUANT_SIZE and the wire test; step 1's synced gradients bit for bit
    those of the plain codec on the same inputs; the six quantized
    collectives once at world 2, bit for bit against their plain
    versions."""
    _release()
    spawner = _host_side()
    seconds = _spawn("qgz_ranks_body", tmp)
    rows = _read_ranks("qgz_ranks", tmp)
    want_flash = {n: k * QGZ_RANKS_LAYERS * TRAIN_GAS
                  for n, k in FLASH_PER_STEP.items()}
    path, coll_path = {}, {}
    for row in rows:
        q = row["quantized_leaves"]
        want = {**want_flash, "quantize_int8": 2 * q, "dequantize_int8": 2 * q}
        for s in row["steps"]:
            got = {n: s["launches"].get(n, 0) for n in want}
            check(got == want, f"rank {row['rank']} launches {got}, "
                  f"expected {want}")
        check(row["sync_equal"] == row["sync_leaves"], f"rank {row['rank']}:"
              f" {row['sync_leaves'] - row['sync_equal']} synced gradients "
              "differ from the plain codec's")
        check(row["plain_launches"] == 0, "the plain codec launched kernels")
        check(all(row["collectives_equal"].values()),
              f"rank {row['rank']} collectives vs plain "
              f"{row['collectives_equal']}")
        losses = [s["loss"] for s in row["steps"]]
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        for n, k in row["path"].items():
            path[n] = path.get(n, 0) + k
        for n, k in row["collectives_path"].items():
            coll_path[n] = coll_path.get(n, 0) + k
    r0 = rows[0]
    emit({"phase": "train_qgz_ranks", "model": f"LLAMA3_8B width, "
          f"{QGZ_RANKS_LAYERS} layers (depth cut from 32 for two ranks' "
          f"state on one card), bf16, flash, lr 3e-5, qgZ, data={RANKS} on "
          "one card over gloo", "seconds": seconds, "spawner_hbm": spawner,
          "per_rank": [{k: row[k] for k in ("masters", "moments", "peak_hbm")}
                       for row in rows],
          "losses": [s["loss"] for s in r0["steps"]],
          "step_ms": [s["step_ms"] for s in r0["steps"]],
          "quantized_leaves": r0["quantized_leaves"], "leaves": r0["leaves"],
          "launches_per_step": [s["launches"] for s in r0["steps"]],
          "comm_per_step": r0["steps"][-1]["comm"],
          "sync_equal": [row["sync_equal"] for row in rows],
          "collectives_equal": r0["collectives_equal"], "launches": path,
          "collectives_launches": coll_path, "card": dev["kind"],
          "nvidia_smi": smi_line})
    return path, coll_path


# ---------------------------------------------------------------------------
# phase 8c: MoE training (Mixtral-8x7B) on one rank and over two expert ranks
# ---------------------------------------------------------------------------
MOE_TRAIN_LAYERS = 2         # of 32: 3.16 B parameters, ~51 GB at 16 B each
MOE_TRAIN_STEPS = 2          # train_moe: steps after 1 warm-up
EP = 2                       # train_moe_ranks' expert axis: 4 experts a rank
# a rank's peak bytes a parameter: fp32 master 4, Adam's moments 8, a
# micro-batch's fp32 gradient 4, the bf16 gradient sum 2; and its
# activations at seq 2048 under remat (the fp32 logits and their softmax
# lead), with the card's other tenants
MOE_RANK_BYTES = 18
MOE_RANK_ACTIVATIONS = 3 << 30
MOE_QUANT_PER_COMBINE = 2    # int8 quantize (and dequantize) launches of one
                             # quantized_psum over one axis: scatter + regather


def moe_train_config(layers=MOE_TRAIN_LAYERS, model="8b", quantized=False):
    """Mixtral-8x7B at its published width cut to ``layers`` layers, with
    ``train_config()``'s recipe (seq 2048, micro 1, gas 2, AdamW 3e-4, bf16
    with bf16 gradient sums, flash, remat); for the CPU tests the tiny
    Mixtral in fp32 on the plain attention backend."""
    import dataclasses
    from deepspeed_tpu_torch.models.mixtral import (MIXTRAL_8X7B,
                                                    TINY_MIXTRAL,
                                                    MixtralConfig)
    llama_cfg, ds_config = train_config()
    if model == "tiny":
        base = dataclasses.replace(TINY_MIXTRAL.base, dtype=torch.float32,
                                   attention_backend="xla")
        moe = dataclasses.replace(TINY_MIXTRAL.moe, dtype=torch.float32)
    else:
        base = dataclasses.replace(MIXTRAL_8X7B.base, max_seq_len=TRAIN_SEQ,
                                   dtype=llama_cfg.dtype,
                                   attention_backend="flash")
        moe = MIXTRAL_8X7B.moe
    base = dataclasses.replace(base, num_layers=layers, remat=True,
                               remat_policy=llama_cfg.remat_policy)
    moe = dataclasses.replace(moe, quantized_dispatch=quantized)
    return MixtralConfig(base=base, moe=moe), ds_config


def _moe_engine(cfg, ds_config, mesh=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.mixtral import MixtralForCausalLM
    dev = _rank_device()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=MixtralForCausalLM(cfg, device=dev, seed=SEED),
        config=ds_config, mesh=mesh, device=dev)
    return engine


def moe_params(cfg, ep=1) -> int:
    """Parameters of the Mixtral ``cfg`` a rank holds over ``ep`` expert
    ranks."""
    b, m = cfg.base, cfg.moe
    d, hd = b.hidden_size, b.head_dim_
    attn = d * hd * (2 * b.num_heads + 2 * b.num_kv_heads) + 2 * d + d * \
        m.num_experts
    experts = 3 * m.num_experts * d * b.intermediate_size // ep
    return 2 * b.vocab_size * d + d + b.num_layers * (attn + experts)


def _moe_batch(cfg, model):
    from deepspeed_tpu_torch.models.llama import random_tokens
    return random_tokens(1, TRAIN_SEQ if model == "8b" else 64,
                         vocab_size=cfg.base.vocab_size, seed=SEED,
                         gas=TRAIN_GAS)


def _gating_vs_cpu(rec, cfg) -> dict:
    """The first gating ``rec`` kept (``sharded_moe.route``: layer 0 of
    step 1's first micro-batch) against the same fp32 logits gated on the
    CPU: ``dispatch`` and ``combine`` (the card's built from its route as
    ``MOELayer`` builds it) bit for bit, the aux and z losses."""
    from deepspeed_tpu_torch.moe.sharded_moe import combine_of, top_k_gating
    logits, _, capacity, _ = rec.args
    experts, slots, keep, weights, aux, z = rec.out
    e = cfg.moe.num_experts
    card = combine_of(experts, slots, keep, weights, capacity, 0, e).cpu()
    d, c, cpu_aux, cpu_z = top_k_gating(logits.cpu(), cfg.moe, capacity)
    t = logits.shape[0]
    return {"tokens": t, "capacity": capacity,
            "dispatch_equal": bool(torch.equal(d, card > 0)),
            "combine_equal": bool(torch.equal(c, card)),
            "aux_loss": float(aux), "z_loss": float(z),
            "aux_z_equal": float(cpu_aux) == float(aux) and
            float(cpu_z) == float(z),
            "dropped_choices": t * cfg.moe.top_k - int(keep.sum())}


def phase_train_moe(dev, smi_line):
    """Mixtral-8x7B at full width, MOE_TRAIN_LAYERS layers, one rank:
    1 + MOE_TRAIN_STEPS ``train_batch`` steps on one batch with the
    recipe; finite losses that fall, exactly FLASH_PER_STEP x layers x gas
    flash launches a step, layer 0's gating on the card equal to the CPU's
    from the same logits bit for bit, the aux and z losses and the choices
    dropped at capacity factor 1.25."""
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.ops import build
    _release()
    torch.cuda.reset_peak_memory_stats()
    cfg, ds_config = moe_train_config()
    t0 = time.monotonic()
    engine = _moe_engine(cfg, ds_config)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    batch = _moe_batch(cfg, "8b")
    build.reset_launch_counts()        # the main path's run starts here
    with _FirstCall(sharded_moe, "route") as rec:
        losses, step_ms, per_step, norms = _train_steps(engine, batch,
                                                        1 + MOE_TRAIN_STEPS)
    launches = build.launch_counts()
    gating = _gating_vs_cpu(rec, cfg)
    want = {n: k * MOE_TRAIN_LAYERS * TRAIN_GAS
            for n, k in FLASH_PER_STEP.items()}
    timed = step_ms[1:]
    mean_ms = sum(timed) / len(timed)
    emit({"phase": "train_moe", "model": f"Mixtral-8x7B width, "
          f"{MOE_TRAIN_LAYERS} of 32 layers, bf16, remat "
          f"{cfg.base.remat_policy}, flash, one rank",
          "params": moe_params(cfg), "seq": TRAIN_SEQ, "micro_batch": 1,
          "gas": TRAIN_GAS, "init_s": init_s, "losses": losses,
          "grad_norms": norms, "step_ms": step_ms, "step_ms_mean": mean_ms,
          "tokens_per_s": TRAIN_GAS * TRAIN_SEQ / (mean_ms / 1e3),
          "launches_per_step": per_step, "launches": launches,
          "gating_vs_cpu": gating,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "card": dev["kind"], "nvidia_smi": smi_line})
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(s == want for s in per_step),
          f"flash launches per step {per_step}, expected {want}")
    check(gating["dispatch_equal"] and gating["combine_equal"],
          f"layer 0's gating on the card differs from the CPU's: {gating}")
    del engine, rec
    _release()
    return launches


def _moe_state(engine) -> dict:
    """fp32 masters and Adam's moments this rank holds, expert leaves
    (its block) and the rest apart."""
    from deepspeed_tpu_torch.moe.sharded_moe import moe_tensor_rules
    opt = engine.optimizer
    out = {"expert": 0, "replicated": 0}
    for name, m, mu, nu in zip(engine._param_names, engine._masters, opt.mu,
                               opt.nu):
        n = (m.numel() + mu.numel() + nu.numel()) * 4
        out["expert" if moe_tensor_rules(name, m) else "replicated"] += n
    return out


def _replicated_digests(engine) -> dict:
    """sha1 of each leaf no rule shards (every rank's must be the same)."""
    import hashlib
    return {n: hashlib.sha1(m.detach().cpu().contiguous().numpy()
                            .view(np.uint8)).hexdigest()
            for n, m, e in zip(engine._param_names, engine._masters,
                               engine._expert_dim) if e is None}


def _expected_moe_comm(cfg, tokens, gas, quantized, w=EP):
    """Bytes the facade records a step at ``expert=w`` and no data axis:
    no dispatch exchange (no token axis); the combine's [T, D] in the
    compute dtype once a layer and micro-batch, dense (all_reduce) or int8
    (the codes and fp32 row scales of quantized_psum's all_to_all and
    regather); the backward's expert-grad sums of the tokens [T, D] and
    the kept weights [T, K] fp32. The remat recompute stops at the block's
    last activation the backward reads (``torch.utils.checkpoint``'s early
    stop), which is before the combine: its exchange runs once."""
    t, d, k = tokens, cfg.base.hidden_size, cfg.moe.top_k
    elt = torch.empty((), dtype=cfg.base.dtype).element_size()
    calls = grads = cfg.base.num_layers * gas
    out = {"moe_expert_grad/all_reduce": grads * (t * d * elt + t * k * 4)}
    if quantized:
        out["moe_combine/all_to_all"] = calls * (t * d + t * 4)
        out["moe_combine/all_gather"] = calls * (t * d + t * 4) // w
    else:
        out["moe_combine/all_reduce"] = calls * t * d * elt
    return out


def moe_ranks_body():
    """One rank of ``train_moe_ranks`` (spawned over gloo on the card): rank
    0 first runs the one-rank reference alone (``train_moe``'s run: micro 1
    x gas 2) and, for the tolerance, the same two sequences as one
    micro-batch in both orders (micro 2 x gas 1: for an MoE this also
    moves the capacity's token set and the aux loss's means, so it bounds
    more than summation order); then both ranks run the recipe at
    ``expert=2`` dense and with ``quantized_dispatch``. Rank 0 holds the
    dense run against the reference: each step's loss and gradient norm
    (step 1's, from the same weights, is the tight one) and the share of
    its masters (the replicated leaves and its expert block) more than
    ``MASTERS_ATOL_LR`` x lr apart. Every rank writes its losses,
    norms, launches, comm bytes, its state by kind, digests of its
    replicated masters and, with the int8 wire, step 1's layer-0 combine
    against the same ``quantized_psum`` with the plain codec."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.ops import build, quant
    r = dist.get_rank()
    model = os.environ.get(RANK_MODEL_ENV, "8b")
    layers = int(os.environ.get("DSTPU_SMOKE_LAYERS", MOE_TRAIN_LAYERS))
    gas = TRAIN_GAS
    cfg0, _ = moe_train_config(layers, model)
    batch = _moe_batch(cfg0, model)
    merged = {k: v.reshape(1, gas * v.shape[1], -1) for k, v in batch.items()}
    swapped = {k: v[::-1].reshape(1, gas * v.shape[1], -1)
               for k, v in batch.items()}
    atol = MASTERS_ATOL_LR * _recipe_lr(model)
    out = {"rank": r, "layers": layers, "runs": {}}
    ref = None
    if r == 0:
        runs = {}
        for name, b, g in (("micro1_gas2", batch, gas),
                           ("micro2_gas1", merged, 1),
                           ("micro2_gas1_swapped", swapped, 1)):
            cfg, ds = moe_train_config(layers, model)
            ds.update(train_batch_size=gas, gradient_accumulation_steps=g)
            _peak_reset()
            engine = _moe_engine(cfg, ds, mesh=_world1_mesh())
            losses, norms = [], []
            for _ in range(RANKS_STEPS):
                losses.append(engine.train_batch(batch=b, stacked=True).item())
                norms.append(engine.get_global_grad_norm())
            masters = [m.detach().cpu() for _, m in engine.named_masters()]
            state = _moe_state(engine)
            del engine
            _release()
            if ref is None:
                ref = (losses, norms, masters, state, _peak())
            else:
                runs[name] = (losses, norms,
                              _masters_apart(masters, ref[2], atol))
            del masters
        la, na = ref[0], ref[1]
        # step by step: routing near capacity makes later steps drift far
        # apart, so each step keeps its own tolerance
        tol = {"loss": [2 * max(abs(la[i] - v[0][i]) for v in runs.values())
                        for i in range(len(la))],
               "grad_norm": [2 * max(abs(na[i] - v[1][i])
                                     for v in runs.values())
                             for i in range(len(na))],
               "masters_share": 2 * max(v[2][0] for v in runs.values())}
        out["reference"] = {
            "losses_micro1_gas2": la, "grad_norms_micro1_gas2": na,
            "state": ref[3], "peak_hbm": ref[4], "tolerance": tol,
            "masters_atol": atol,
            **{f"losses_{k}": v[0] for k, v in runs.items()},
            **{f"grad_norms_{k}": v[1] for k, v in runs.items()},
            **{f"masters_share_{k}": v[2][0] for k, v in runs.items()},
            **{f"masters_max_abs_{k}": v[2][1] for k, v in runs.items()}}
        del runs
    dist.barrier()
    comms = get_comms_logger()
    comms.configure(enabled=True)
    for label, quantized in (("dense", False), ("int8", True)):
        cfg, ds = moe_train_config(layers, model, quantized)
        ds.update(mesh={"expert": EP, "data": 1})
        _peak_reset()
        engine = _moe_engine(cfg, ds)
        record = {}
        combine = sharded_moe._quantized_expert_sum

        def recording(x):           # step 1's first combine: layer 0
            y = combine(x)
            if "in" not in record:
                record["in"], record["out"] = x.detach().clone(), \
                    y.detach().clone()
            return y

        sharded_moe._quantized_expert_sum = recording
        comms.reset()
        try:
            build.reset_launch_counts()     # the main path's run starts here
            steps = _rank_steps(engine, batch, RANKS_STEPS, comms)
            path = build.launch_counts()
        finally:
            sharded_moe._quantized_expert_sum = combine
        run = {"steps": steps, "path": path, "state": _moe_state(engine),
               "peak_hbm": _peak(), "digests": _replicated_digests(engine),
               "expert_coord": engine.mesh.coords["expert"],
               "expected_comm_per_step": _expected_moe_comm(
                   cfg, batch["input_ids"].shape[-1], gas, quantized)}
        if r == 0 and not quantized:
            c = engine.mesh.coords["expert"]
            got, want = [], []
            for m, full, e in zip(engine._masters, ref[2],
                                  engine._expert_dim):
                if e is not None:
                    n = m.shape[0]
                    full = full[c * n:(c + 1) * n]
                got.append(m.detach().cpu())
                want.append(full)
            run["masters_share"], run["masters_max_abs"] = _masters_apart(
                got, want, atol)
            run["loss_gaps"] = [abs(s["loss"] - a)
                                for s, a in zip(steps, ref[0])]
            run["grad_norm_gaps"] = [abs(s["grad_norm"] - a)
                                     for s, a in zip(steps, ref[1])]
            del got, want
        del engine
        _release()
        if quantized:
            with _Plain():
                before = sum(build.launch_counts().values())
                plain = quant.quantized_psum(record["in"], ("expert",))
                run["plain_launches"] = sum(build.launch_counts().values()) \
                    - before
            run["combine_equal"] = bool(torch.equal(
                plain.view(torch.int16) if plain.dtype == torch.bfloat16
                else plain, record["out"].view(torch.int16)
                if record["out"].dtype == torch.bfloat16 else record["out"]))
            run["combine_shape"] = list(record["in"].shape)
        out["runs"][label] = run
    comms.configure(enabled=False)
    with open(_rank_out(f"moe_ranks{r}.json"), "w") as f:
        json.dump(out, f)


def check_moe_ranks(rows, layers, device="cuda", model="8b"):
    """The ``moe_ranks_body`` results of every rank: (flash launches over
    both runs, the int8 run's launches; on the CPU nothing launches, and
    the tiny model's plain attention launches no flash kernel)."""
    ref = rows[0]["reference"]
    tol = ref["tolerance"]
    flash = {n: k * layers * TRAIN_GAS if device == "cuda" and model == "8b"
             else 0 for n, k in FLASH_PER_STEP.items()}
    quant_want = MOE_QUANT_PER_COMBINE * layers * TRAIN_GAS
    path, int8_path = {}, {}
    d0 = rows[0]["runs"]["dense"]
    for key in ("loss", "grad_norm"):
        gaps = d0[f"{key}_gaps"]
        check(all(g <= t for g, t in zip(gaps, tol[key])),
              f"expert={EP}: each step's {key} {gaps} from one rank's, "
              f"tolerance {tol[key]}")
    check(d0["masters_share"] <= tol["masters_share"], f"expert={EP}: a "
          f"share {d0['masters_share']} of rank 0's masters more than "
          f"{ref['masters_atol']} from one rank's, tolerance "
          f"{tol['masters_share']}")
    for label in ("dense", "int8"):
        r0 = rows[0]["runs"][label]
        for row in rows:
            run = row["runs"][label]
            check([(s["loss"], s["grad_norm"]) for s in run["steps"]] ==
                  [(s["loss"], s["grad_norm"]) for s in r0["steps"]],
                  f"{label}: rank {row['rank']}'s losses or norms differ "
                  "from rank 0's")
            check(run["digests"] == r0["digests"], f"{label}: rank "
                  f"{row['rank']}'s replicated masters differ from rank 0's")
            check(2 * run["state"]["expert"] == ref["state"]["expert"],
                  f"{label}: rank {row['rank']} holds {run['state']['expert']}"
                  f" expert bytes, one rank {ref['state']['expert']}")
            check(all(math.isfinite(s["loss"]) for s in run["steps"]),
                  f"{label}: losses {[s['loss'] for s in run['steps']]}")
            for s in run["steps"]:
                got = {n: s["launches"].get(n, 0) for n in FLASH_PER_STEP}
                check(got == flash, f"{label} rank {row['rank']} flash "
                      f"launches {got}, expected {flash}")
                q = {n: s["launches"].get(n, 0) for n in QGZ_KERNELS}
                want = {n: quant_want if label == "int8" and
                        device == "cuda" else 0 for n in QGZ_KERNELS}
                check(q == want, f"{label} rank {row['rank']} int8 "
                      f"launches {q}, expected {want}")
                comm = {op: s["comm"].get(op, {}).get("bytes", 0)
                        for op in run["expected_comm_per_step"]}
                check(comm == run["expected_comm_per_step"],
                      f"{label}: comm bytes {comm}, expected "
                      f"{run['expected_comm_per_step']}")
            for n in FLASH_PER_STEP:
                path[n] = path.get(n, 0) + run["path"].get(n, 0)
            if label == "int8":
                check(run["combine_equal"], f"rank {row['rank']}: step 1's "
                      "int8 combine differs from the plain codec's")
                check(run["plain_launches"] == 0,
                      "the plain codec launched kernels")
                for n in QGZ_KERNELS:
                    int8_path[n] = int8_path.get(n, 0) + run["path"].get(n, 0)
    return path, int8_path


def plan_moe_rank_layers():
    """MOE_TRAIN_LAYERS when two ranks' peaks fit the card's free memory,
    else 1 (depth is cut, never width)."""
    _release()
    free, _ = torch.cuda.mem_get_info()
    for layers in (MOE_TRAIN_LAYERS, 1):
        cfg_l, _ = moe_train_config(layers)
        need = RANKS * (MOE_RANK_BYTES * moe_params(cfg_l, EP) +
                        MOE_RANK_ACTIVATIONS)
        if need <= free:
            return layers, free, need
    return 1, free, need


def phase_train_moe_ranks(dev, smi_line, tmp):
    """Two processes on the one card over gloo, mesh ``expert=2`` (each
    rank 4 of the 8 experts): dense against the one-rank reference within
    twice the distance of the same sequences batched otherwise, replicated
    masters the same bytes on both ranks, half the expert state a rank;
    then with ``quantized_dispatch``: exactly MOE_QUANT_PER_COMBINE x
    layers x gas int8 quantize and dequantize launches a step (the remat
    recompute stops before the combine), step 1's layer-0 combine bit for
    bit the plain codec's; the combine and expert-grad bytes a step beside
    the count from [T, D] and [T, K]."""
    layers, free, need = plan_moe_rank_layers()
    spawner = _host_side()
    seconds = _spawn("moe_ranks_body", tmp,
                     DSTPU_SMOKE_LAYERS=str(layers))
    rows = _read_ranks("moe_ranks", tmp)
    path, int8_path = check_moe_ranks(rows, layers)
    cfg, _ = moe_train_config(layers)
    c = cfg.moe.num_experts // EP * _capacity_of(cfg) * cfg.base.hidden_size
    r0 = rows[0]
    cut = "" if layers == MOE_TRAIN_LAYERS else \
        f" (cut from {MOE_TRAIN_LAYERS}: two ranks did not fit)"
    emit({"phase": "train_moe_ranks", "model": f"Mixtral-8x7B width, {layers} "
          f"layers{cut}, bf16, flash, expert={EP} "
          f"({cfg.moe.num_experts // EP} experts a rank) on one card over "
          "gloo", "free_hbm": free,
          "planned_peak": need, "seconds": seconds, "spawner_hbm": spawner,
          "reference": r0["reference"],
          "dense": {k: r0["runs"]["dense"][k] for k in (
              "loss_gaps", "grad_norm_gaps", "masters_share",
              "masters_max_abs", "state", "peak_hbm",
              "expected_comm_per_step")},
          "int8": {k: r0["runs"]["int8"][k] for k in (
              "combine_equal", "combine_shape", "state", "peak_hbm",
              "expected_comm_per_step")},
          "per_rank_state": [{lab: row["runs"][lab]["state"]
                              for lab in ("dense", "int8")} for row in rows],
          "steps": {lab: [{"loss": s["loss"], "grad_norm": s["grad_norm"],
                           "step_ms": s["step_ms"], "comm": s["comm"]}
                          for s in r0["runs"][lab]["steps"]]
                    for lab in ("dense", "int8")},
          "dispatch_payload_bytes_if_token_axis": 2 * c,
          "launches": path, "int8_launches": int8_path,
          "card": dev["kind"], "nvidia_smi": smi_line})
    return path, int8_path


def _capacity_of(cfg) -> int:
    from deepspeed_tpu_torch.moe.sharded_moe import _capacity
    m = cfg.moe
    return _capacity(TRAIN_SEQ * m.top_k, m.num_experts, m.capacity_factor,
                     m.min_capacity)


# ---------------------------------------------------------------------------
# phase 9: the memory tiers (ZeRO-Offload, ZeRO-Infinity)
# ---------------------------------------------------------------------------
HOST_SOURCES = ("cpu_adam", "aio")  # g++ builds them beside the CUDA sources
PARITY_STEPS = 2                   # train_batch steps of each parity engine
OFFLOAD_STEPS = 2                  # timed steps after 1 warm-up, optimizer tier
PARAM_OFFLOAD_STEPS = 1            # the parameter tier's, cut for time
HOST_MARGIN = 1.25                 # host RAM a tier may plan on: MemAvailable / this
SETTLE_MAX_S = 90.0                # wait at most this for MemAvailable to settle
SETTLE_STEP_BYTES = 256 << 20      # settled: it rose less than this in a second
TIER_LOSS_REL = 1e-3               # optimizer tier vs in-HBM, each step's loss
MASTERS_ATOL, MASTERS_RTOL = 2e-5, 2e-4   # tests/test_offload.py's tolerance
PARAM_LOSS_REL = 1e-5              # parameter tier vs optimizer tier, step 1
# two bf16 pipelines whose masters differ in last bits: the share of
# elements beyond MASTERS_ATOL/RTOL (tests/test_torch_train.py's bf16 case)
BF16_SHARE = 5e-3
# what the engine may hold on the card beside its bf16 parameters and rope
# tables after the optimizer tier's init: less than the fp32 master of any
# weight matrix of the model (the smallest, wk, is 16 MiB)
CARD_SLACK = 8 << 20
# host bytes a parameter: the fp32 master and two Adam moments; the
# parameter tier adds its bf16 store and the fp32 gradient accumulators
HOST_BYTES = {"optimizer": 12, "param": 18}
ADAM_BYTES = 28                    # the fused host Adam: reads p, g, m, v; writes p, m, v
# flash launches per layer and micro-batch under the parameter tier: the
# stream's forward, the group's forward and remat's recompute; one backward
FLASH_PER_STEP_PARAM = {"flash_fwd": 3, "flash_dq": 1, "flash_dkv": 1}


def _release() -> None:
    """Free what the last phase left: Python garbage, the card's cached
    blocks and the pinned host blocks the caching allocator keeps."""
    gc.collect()
    torch.cuda.empty_cache()
    empty_host = getattr(torch._C, "_host_emptyCache", None)
    if empty_host is not None:
        empty_host()


def _kb_line(path, key) -> int:
    with open(path) as f:
        for line in f:
            if line.startswith(key):
                return int(line.split()[1]) * 1024
    raise PhaseError(f"no {key} in {path}")


def mem_available() -> int:
    """/proc/meminfo's MemAvailable, in bytes."""
    return _kb_line("/proc/meminfo", "MemAvailable:")


def host_memory() -> dict:
    """MemAvailable and this process's resident bytes."""
    return {"mem_available": mem_available(),
            "rss": _kb_line("/proc/self/status", "VmRSS:")}


def llama_params(cfg, layers):
    """Parameters of ``cfg`` at ``layers`` layers (untied head)."""
    d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    layer = d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads) + 3 * d * f + 2 * d
    return 2 * cfg.vocab_size * d + d + layers * layer


def settled_mem_available():
    """MemAvailable once it stops rising, and the seconds waited: the card
    machine hands memory a process freed back to MemAvailable over several
    seconds (32 -> 79 GB in ~15 s after a 23-layer tier, PERF.md)."""
    _release()
    t0 = time.monotonic()
    last = mem_available()
    while time.monotonic() - t0 < SETTLE_MAX_S:
        time.sleep(1.0)
        now = mem_available()
        if now - last < SETTLE_STEP_BYTES:
            return now, time.monotonic() - t0
        last = now
    return last, time.monotonic() - t0


def plan_depth(tier, cfg):
    """The deepest depth up to the model's whose host state, times
    HOST_MARGIN, fits in MemAvailable; emits the reading on its own line."""
    avail, settle_s = settled_mem_available()
    per = HOST_BYTES[tier]
    depth = max((n for n in range(1, cfg.num_layers + 1)
                 if per * llama_params(cfg, n) * HOST_MARGIN <= avail),
                default=0)
    need = per * llama_params(cfg, cfg.num_layers)
    row = {"phase": f"host_memory_{tier}", "mem_available_bytes": avail,
           "settle_s": settle_s, "rss_bytes": host_memory()["rss"],
           "cores": os.cpu_count(), "host_bytes_per_param": per,
           "host_bytes_full_depth": need, "margin": HOST_MARGIN,
           "layers": depth, "full_depth": cfg.num_layers,
           "cut": depth < cfg.num_layers}
    if row["cut"]:
        row["reason"] = (f"{cfg.num_layers} layers need {need / 1e9:.1f} GB of "
                         f"host state, x{HOST_MARGIN} > MemAvailable "
                         f"{avail / 1e9:.1f} GB; {depth} layers fit")
    emit(row)
    check(depth >= 1, f"not one layer fits in {avail} bytes of host memory")
    return depth


def _tier_engine(cfg, zero, weight_decay=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    _, ds_config = train_config()
    ds_config["zero_optimization"].update(zero)
    if weight_decay is not None:
        ds_config["optimizer"]["params"]["weight_decay"] = weight_decay
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=LlamaForCausalLM(cfg, device="cuda", seed=SEED), config=ds_config)
    return engine


def _tier_steps(engine, batch, steps):
    """``steps`` train_batch calls: per step the loss, host ms (ending in
    the loss readback), flash launches, phase seconds and bytes."""
    from deepspeed_tpu_torch.ops import build
    rows = []
    for _ in range(steps):
        before = build.launch_counts()
        t0 = time.monotonic()
        loss = engine.train_batch(batch=batch).item()
        ms = (time.monotonic() - t0) * 1e3
        after = build.launch_counts()
        rows.append({"loss": loss, "step_ms": ms,
                     "grad_norm": engine.get_global_grad_norm(),
                     "launches": {n: after.get(n, 0) - before.get(n, 0)
                                  for n in FLASH_PER_STEP},
                     "phase_s": dict(engine.phase_seconds),
                     "bytes": dict(engine.phase_bytes)})
    return rows


def _host_masters(engine):
    """The engine's fp32 masters on the host (copied down from the card
    through pinned staging for the in-HBM engine)."""
    from deepspeed_tpu_torch.runtime.staging import Staging
    stage = Staging(torch.device("cuda"))
    return [stage.to_host(m) for _, m in engine.named_masters()]


def _masters_gap(got, want):
    """Over every element: the largest |got - want| / (MASTERS_ATOL +
    MASTERS_RTOL |want|), the share of elements where that exceeds 1, and
    the largest |got - want|."""
    worst, over, n, gap = 0.0, 0, 0, 0.0
    for a, b in zip(got, want):
        d = (a - b).abs()
        r = d / (MASTERS_ATOL + MASTERS_RTOL * b.abs())
        worst = max(worst, float(r.max()))
        over += int((r > 1.0).sum())
        n += r.numel()
        gap = max(gap, float(d.max()))
        del d, r
    return {"over_tol": worst, "share_over_tol": over / n, "max_abs": gap}


def _close(engine) -> None:
    """Unregister a parameter tier's page-locked store before the engine
    goes (the caller then drops it and calls ``_release``)."""
    po = getattr(engine, "_param_offload", None)
    if po is not None:
        po.close()


def phase_train_offload_parity(batch, dev, smi_line):
    """The recipe at TRAIN_LAYERS layers, PARITY_STEPS steps each (AdamW's
    decay stated as none, as in ``tests/test_offload.py::
    test_offload_matches_in_hbm_adamw``: the in-HBM AdamW decays 0.01 by
    default, the host kernels none, as the JAX package's do; ROADMAP
    Queue 3):

    - the optimizer tier against in-HBM: each loss within TIER_LOSS_REL;
      the masters after step 1, where both took the same gradients of the
      same bf16 weights, within MASTERS_ATOL/RTOL. The two Adams round at
      other points, a last-bit difference flips a few bf16 shadows, and
      step 2's gradients differ at bf16 noise, which Adam's normalised step
      turns into up to lr an element where a moment nearly cancels: the
      final masters are held to the bound of two bf16 pipelines of
      ``tests/test_torch_train.py`` (none beyond 2 lr a step, at most
      BF16_SHARE beyond the tolerance);
    - the NVMe tier with swapped masters against the CPU tier: bit for bit,
      the state files present;
    - the parameter tier (2 layers a group) against the optimizer tier:
      step 1's loss within PARAM_LOSS_REL (the same bf16 weights through
      the same kernels: a wider gap is a stream-ordering fault); it sums
      the two micro-batches' bf16 gradients in fp32 on the host, the
      optimizer tier in bf16 on the card (the recipe's grad_accum_dtype),
      so its final masters take the same two-pipeline bound."""
    import shutil
    import tempfile
    cfg, ds_config = train_config()
    lr = ds_config["optimizer"]["params"]["lr"]
    _release()
    runs, gaps = {"start": {"host_after": host_memory()}}, {}
    t0 = time.monotonic()

    def run(label, zero, keep_step1=False):
        engine = _tier_engine(cfg, zero, weight_decay=0.0)
        rows = _tier_steps(engine, batch, 1)
        step1 = [m.clone() for m in _host_masters(engine)] if keep_step1 else None
        rows += _tier_steps(engine, batch, PARITY_STEPS - 1)
        runs[label] = {"losses": [r["loss"] for r in rows],
                       "step_ms": [r["step_ms"] for r in rows]}
        final = _host_masters(engine)
        _close(engine)
        del engine
        _release()
        runs[label]["host_after"] = host_memory()
        return step1, final

    hbm1, hbm = run("in_hbm", {}, keep_step1=True)
    cpu_zero = {"offload_optimizer": {"device": "cpu", "ratio": 0.0}}
    cpu1, cpu = run("cpu", cpu_zero, keep_step1=True)
    gaps["cpu_vs_in_hbm_step1"] = _masters_gap(cpu1, hbm1)
    del cpu1, hbm1
    gaps["cpu_vs_in_hbm"] = _masters_gap(cpu, hbm)
    del hbm
    nvme_dir = tempfile.mkdtemp(prefix="dstpu_nvme_")
    try:
        _, nvme = run("nvme", {"offload_optimizer": {
            "device": "nvme", "nvme_path": nvme_dir, "swap_masters": True}})
        files = {kind: len([f for f in os.listdir(os.path.join(nvme_dir, "proc0"))
                            if f.startswith(kind)])
                 for kind in ("state0_", "state1_", "master_")}
    finally:
        shutil.rmtree(nvme_dir, ignore_errors=True)
    nvme_equal = all(torch.equal(a, b) for a, b in zip(nvme, cpu))
    del nvme
    _, param = run("param", {**cpu_zero, "offload_param": {
        "device": "cpu", "layers_per_group": 2}})
    gaps["param_vs_cpu"] = _masters_gap(param, cpu)
    n_leaves = len(cpu)
    del param, cpu
    _release()
    runs["end"] = {"host_after": host_memory()}
    l_hbm, l_cpu, l_param = (runs[k]["losses"] for k in ("in_hbm", "cpu", "param"))
    tier_rel = max(abs(a - b) / abs(b) for a, b in zip(l_cpu, l_hbm))
    param_rel = abs(l_param[0] - l_cpu[0]) / abs(l_cpu[0])
    bound = 2 * lr * PARITY_STEPS + MASTERS_ATOL
    emit({"phase": "train_offload_parity",
          "model": f"LLAMA3_8B width, {cfg.num_layers} layers, bf16, flash, "
          "remat, AdamW lr 3e-4 without decay", "runs": runs,
          "tier_loss_rel_max": tier_rel, "masters": gaps,
          "nvme_masters_bit_equal": nvme_equal, "nvme_files": files,
          "param_step1_loss_rel": param_rel,
          "limits": {"tier_loss_rel": TIER_LOSS_REL,
                     "masters_atol": MASTERS_ATOL, "masters_rtol": MASTERS_RTOL,
                     "two_pipelines_max_abs": bound,
                     "two_pipelines_share_over_tol": BF16_SHARE,
                     "param_step1_loss_rel": PARAM_LOSS_REL},
          "phase_s": time.monotonic() - t0,
          "card": dev["kind"], "nvidia_smi": smi_line})
    check(all(math.isfinite(x) for r in runs.values() for x in r.get("losses", [])),
          f"non-finite loss {runs}")
    check(tier_rel <= TIER_LOSS_REL, f"optimizer tier vs in-HBM loss {tier_rel}")
    check(gaps["cpu_vs_in_hbm_step1"]["over_tol"] <= 1.0,
          f"optimizer tier step-1 masters vs in-HBM {gaps['cpu_vs_in_hbm_step1']}")
    for key in ("cpu_vs_in_hbm", "param_vs_cpu"):
        check(gaps[key]["max_abs"] <= bound
              and gaps[key]["share_over_tol"] <= BF16_SHARE,
              f"{key} final masters {gaps[key]}, bound {bound}, share "
              f"{BF16_SHARE}")
    check(nvme_equal, "NVMe tier masters differ from the CPU tier's")
    check(all(n == n_leaves for n in files.values()),
          f"NVMe state files {files}, expected {n_leaves} of each")
    check(param_rel <= PARAM_LOSS_REL, f"parameter tier step-1 loss "
          f"{l_param[0]} vs {l_cpu[0]} ({param_rel} relative)")


def _tier_summary(rows, n_params, tier):
    """Mean phase seconds and bytes over the timed steps (after the
    warm-up), tokens/s, and the host optimizer's rate and share."""
    timed = rows[1:]
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    step_s = mean([r["step_ms"] for r in timed]) / 1e3
    phases = {k: mean([r["phase_s"][k] for r in timed])
              for k in timed[0]["phase_s"]}
    out = {"step_ms_mean": step_s * 1e3, "phase_s_mean": phases,
           "bytes_per_step": timed[-1]["bytes"],
           "tokens_per_s": TRAIN_GAS * TRAIN_SEQ / step_s,
           "host_optimizer_share": phases["host_optimizer"] / step_s}
    if tier == "optimizer":
        out["host_adam_gb_per_s"] = ADAM_BYTES * n_params / phases["host_optimizer"] / 1e9
    return out


def phase_train_offload(batch, dev, smi_line):
    """Llama-3-8B with ``offload_optimizer`` cpu (ratio 0.0), the recipe
    otherwise as ``train_config``, at full depth or the deepest the host
    RAM holds: 1 warm-up and OFFLOAD_STEPS timed steps whose loss falls at
    every step, exact flash launches, no fp32 state on the card."""
    import dataclasses
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.cpu_adam import host_threads
    _release()
    cfg, _ = train_config()
    cfg = dataclasses.replace(cfg, num_layers=32)
    layers = plan_depth("optimizer", cfg)
    cfg = dataclasses.replace(cfg, num_layers=layers)
    n_params = llama_params(cfg, layers)
    before_init = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    engine = _tier_engine(cfg, {"offload_optimizer": {"device": "cpu",
                                                      "ratio": 0.0}})
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    held = torch.cuda.memory_allocated() - before_init
    module_dtypes = sorted({str(p.dtype) for p in engine.model.parameters()})
    host_state = {str(t.device) for leaf in engine._offload.leaves
                  for t in (leaf.master, *leaf.states)}
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()        # the main path's run starts here
    rows = _tier_steps(engine, batch, 1 + OFFLOAD_STEPS)
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    threads = host_threads()
    _close(engine)
    del engine
    _release()
    losses = [r["loss"] for r in rows]
    want = {n: k * layers * TRAIN_GAS for n, k in FLASH_PER_STEP.items()}
    bf16_bytes = 2 * n_params
    row = {"phase": "train_offload", "model": f"LLAMA3_8B, {layers} layers, "
           "bf16, flash, remat, offload_optimizer cpu", "layers": layers,
           "params": n_params, "init_s": init_s, "losses": losses,
           "steps": rows, **_tier_summary(rows, n_params, "optimizer"),
           "host_threads": threads, "cores": os.cpu_count(),
           "card_bytes_held_after_init": held,
           "bf16_param_bytes": bf16_bytes, "module_dtypes": module_dtypes,
           "host_state_devices": sorted(host_state),
           "max_memory_allocated": peak, "launches": launches,
           "card": dev["kind"], "nvidia_smi": smi_line}
    emit(row)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"loss did not fall at every step: {losses}")
    check(all(r["launches"] == want for r in rows),
          f"flash launches per step {[r['launches'] for r in rows]}, "
          f"expected {want}")
    check(module_dtypes == ["torch.bfloat16"], f"module holds {module_dtypes}")
    check(host_state == {"cpu"}, f"masters and moments on {host_state}")
    rope = 2 * 4 * cfg.max_seq_len * cfg.head_dim_ // 2
    check(bf16_bytes + rope <= held <= bf16_bytes + rope + CARD_SLACK,
          f"the engine holds {held} bytes on the card after init; its bf16 "
          f"parameters and rope tables are {bf16_bytes + rope}: an fp32 "
          "master or moment stayed there")
    return launches, peak


def phase_train_param_offload(batch, opt_peak, dev, smi_line):
    """bench.py's 8b tiers as written: ``offload_param`` cpu with
    ``layers_per_group`` 4 and ``offload_optimizer`` cpu (ratio 0.0), at
    full depth or the deepest the host RAM holds: 1 warm-up and
    PARAM_OFFLOAD_STEPS timed steps, the loss falls, exact flash launches,
    and a peak HBM far below the optimizer tier's."""
    import dataclasses
    from deepspeed_tpu_torch.ops import build
    _release()
    cfg, _ = train_config()
    cfg = dataclasses.replace(cfg, num_layers=32)
    layers = plan_depth("param", cfg)
    cfg = dataclasses.replace(cfg, num_layers=layers)
    n_params = llama_params(cfg, layers)
    t0 = time.monotonic()
    engine = _tier_engine(cfg, {
        "offload_optimizer": {"device": "cpu", "ratio": 0.0},
        "offload_param": {"device": "cpu", "layers_per_group": 4}})
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    after_init = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()        # the main path's run starts here
    rows = _tier_steps(engine, batch, 1 + PARAM_OFFLOAD_STEPS)
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    groups = engine._param_offload._layer_groups
    _close(engine)
    del engine
    _release()
    losses = [r["loss"] for r in rows]
    want = {n: k * layers * TRAIN_GAS for n, k in FLASH_PER_STEP_PARAM.items()}
    summary = _tier_summary(rows, n_params, "param")
    streamed = summary["bytes_per_step"]["h2d"]
    copy_s = summary["phase_s_mean"]["h2d_copy_device"]
    emit({"phase": "train_param_offload", "model": f"LLAMA3_8B, {layers} "
          "layers, bf16, flash, remat, offload_param cpu x4 layers, "
          "offload_optimizer cpu", "layers": layers, "groups": len(groups),
          "params": n_params, "init_s": init_s, "losses": losses,
          "steps": rows, **summary,
          "h2d_gb_per_s_copy": streamed / copy_s / 1e9 if copy_s else None,
          "memory_allocated_after_init": after_init,
          "max_memory_allocated": peak,
          "optimizer_tier_max_memory_allocated": opt_peak,
          "launches": launches, "card": dev["kind"], "nvidia_smi": smi_line})
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"loss did not fall at every step: {losses}")
    check(all(r["launches"] == want for r in rows),
          f"flash launches per step {[r['launches'] for r in rows]}, "
          f"expected {want}")
    check(peak < 0.5 * opt_peak, f"peak HBM {peak} under the parameter tier, "
          f"{opt_peak} under the optimizer tier")
    return launches


# where each kernel's source lives and which TPU kernel it replaces
KERNEL_TABLE = {
    "paged_attention": ("paged_attention",
                        "deepspeed_tpu/ops/pallas/paged_attention.py:35"),
    "flash_fwd": ("flash_attention",
                  "deepspeed_tpu/ops/pallas/flash_attention.py:80"),
    "flash_dq": ("flash_attention",
                 "deepspeed_tpu/ops/pallas/flash_attention.py:238"),
    "flash_dkv": ("flash_attention",
                  "deepspeed_tpu/ops/pallas/flash_attention.py:279"),
    "quantize_int8": ("quant", "deepspeed_tpu/ops/pallas/quant.py:22"),
    "dequantize_int8": ("quant", "deepspeed_tpu/ops/pallas/quant.py:31"),
    "quantize_fp8": ("quant", "deepspeed_tpu/ops/pallas/fp_quant.py:29"),
    "dequantize_fp8": ("quant", "deepspeed_tpu/ops/pallas/fp_quant.py:37"),
    "evo_fwd": ("evoformer", "deepspeed_tpu/ops/pallas/evoformer.py:58"),
    "evo_dq": ("evoformer", "deepspeed_tpu/ops/pallas/evoformer.py:92"),
    "evo_dkv": ("evoformer", "deepspeed_tpu/ops/pallas/evoformer.py:119"),
    "evo_dbias2": ("evoformer", "deepspeed_tpu/ops/pallas/evoformer.py:152"),
    "evo_dbias1": ("evoformer", "deepspeed_tpu/ops/pallas/evoformer.py:179"),
    "rms_norm": ("rms_norm", "deepspeed_tpu/ops/pallas/rms_norm.py:15"),
    "bias_act": ("fused_bias_act",
                 "deepspeed_tpu/ops/pallas/fused_bias_act.py:39"),
    "bias_act_bwd": ("fused_bias_act",
                     "deepspeed_tpu/ops/pallas/fused_bias_act.py:44"),
    "bias_act_dropout": ("fused_bias_act",
                         "deepspeed_tpu/ops/pallas/fused_bias_act.py:146"),
    "bias_act_dropout_bwd": ("fused_bias_act",
                             "deepspeed_tpu/ops/pallas/fused_bias_act.py:156"),
    "sparse_attention": ("sparse_attention",
                         "deepspeed_tpu/ops/sparse_attention/attention.py:107"),
}
SLICE5_KERNELS = ("rms_norm",) + BIAS_ACT_KERNELS + ("sparse_attention",)
# entry names where the table's name is the prefix of several kernels'
ENTRY_NAMES = {n: f"{n}_kernel" for n in BIAS_ACT_KERNELS}
# the main paths each kernel lies on; the first is the one whose shape the
# kernel's timing uses (serve: InferenceEngineV2, serve_http: the engine
# behind InferenceServer and its HTTP front door, train: the recipe, A1/A2:
# ZeRO-Inference fp8/int8, B: training with qgZ, evoformer: E1-E4 through
# DS4Sci_EvoformerAttention, timed at E1; S1/S2: SparseSelfAttention at
# BigBird-base and Fixed, timed at S1; R: rms_norm; F: fused_bias_act and
# fused_bias_act_dropout; train_zero: stages 1-3 at one rank;
# train_zero_ranks: stages 3 and 2 on two ranks; train_qgz_ranks: qgZ's
# int8 wire on two ranks; quant_collectives: the six quantized collectives
# at two ranks; serve_moe: Qwen1.5-MoE-A2.7B and Mixtral-8x7B through
# InferenceEngineV2; train_moe: Mixtral-8x7B on one rank; train_moe_ranks:
# Mixtral-8x7B over two expert ranks, dense and int8; moe_int8: that run's
# int8 combine)
KERNEL_PATHS = {"paged_attention": ("serve", "serve_http", "disagg", "fleet",
                                     "A1", "A2", "serve_moe"),
                **{n: ("train", "train_offload", "train_param_offload",
                       "train_zero", "train_zero_ranks", "train_qgz_ranks",
                       "train_moe", "train_moe_ranks")
                   for n in FLASH_PER_STEP},
                "quantize_fp8": ("A1", "quant_collectives"),
                "dequantize_fp8": ("A1", "quant_collectives"),
                "quantize_int8": ("B", "train_qgz_ranks", "quant_collectives",
                                  "moe_int8"),
                "dequantize_int8": ("B", "A2", "train_qgz_ranks",
                                    "quant_collectives", "moe_int8"),
                **{n: ("evoformer",) for n in EVO_KERNELS},
                "rms_norm": ("R",), **{n: ("F",) for n in BIAS_ACT_KERNELS},
                "sparse_attention": ("S1", "S2")}


def main() -> int:
    phase = "device"
    try:
        dev, smi_line = phase_device()
        phase = "import"
        import deepspeed_tpu_torch  # noqa: F401  (the package of this repo)
        torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 stays fp32
        torch.backends.cudnn.allow_tf32 = False
        phase = "build"
        build_info = phase_build(["paged_attention", "flash_attention", "quant",
                                  "evoformer", "rms_norm", "fused_bias_act",
                                  "sparse_attention", *HOST_SOURCES])
        phase = "kernel_parity"
        worst, timing = phase_kernel_parity()
        phase = "flash_parity"
        flash_worst, flash_timing = phase_flash_parity()
        phase = "quant_parity"
        quant_worst = phase_quant_parity()
        phase = "quant_timing"
        quant_timing = phase_quant_timing(dev, smi_line)
        phase = "evo_parity"
        evo_worst = phase_evo_parity()
        phase = "evoformer"
        evo_launches = phase_evoformer(dev, smi_line)
        phase = "evo_timing"
        evo_timing = phase_evo_timing(dev, smi_line)
        phase = "slice5_parity"
        slice5_worst = phase_slice5_parity()
        phase = "sparse_path"
        sparse_launches = phase_sparse_path(dev, smi_line)
        phase = "rms_path"
        rms_launches = phase_rms_path(dev, smi_line)
        phase = "bias_act_path"
        bias_act_launches = phase_bias_act_path(dev, smi_line)
        phase = "slice5_timing"
        slice5_timing = phase_slice5_timing(dev, smi_line)
        gc.collect()
        torch.cuda.empty_cache()
        phase = "engine"
        st, eng, lens, prompts = phase_engine(dev, smi_line)
        phase = "profile"
        phase_profile(eng, lens, dev, smi_line)
        phase = "serve"
        serve_launches, batch = phase_serve(eng, prompts, st, dev, smi_line)
        phase = "disagg"
        disagg_launches = phase_disagg(eng, prompts, batch, st["finite_flag"],
                                       dev, smi_line)
        phase = "fleet"
        fleet_launches = phase_fleet(eng, st["finite_flag"], dev, smi_line)
        phase = "fleet_drill"
        phase_fleet_drill(dev, smi_line)
        del eng                          # free the serving engine's 25 GB
        gc.collect()
        torch.cuda.empty_cache()
        phase = "serve_moe"
        serve_moe_launches = phase_serve_moe(dev, smi_line)
        phase = "zero_inference"
        zi = phase_zero_inference(dev, smi_line)
        torch.cuda.reset_peak_memory_stats()
        phase = "train"
        engine, batch, train_launches, losses = phase_train(dev, smi_line)
        phase = "train_profile"
        phase_train_profile(engine, batch, dev, smi_line)
        del engine                       # free the recipe's 40 GB
        gc.collect()
        torch.cuda.empty_cache()
        phase = "train_probe"
        plain_norm1 = phase_train_probe(batch, losses, dev, smi_line)
        phase = "train_qgz"
        qgz_launches = phase_train_qgz(batch, plain_norm1, dev, smi_line)
        _release()
        phase = "train_zero"
        zero_launches = phase_train_zero(batch, dev, smi_line)
        tmp = tempfile.mkdtemp(prefix="dstpu-ranks-")
        try:
            phase = "train_zero_ranks"
            zero_ranks_launches = phase_train_zero_ranks(dev, smi_line, tmp)
            phase = "train_qgz_ranks"
            qgz_ranks_launches, coll_launches = phase_train_qgz_ranks(
                dev, smi_line, tmp)
            phase = "train_moe"
            moe_launches = phase_train_moe(dev, smi_line)
            phase = "train_moe_ranks"
            moe_ranks_launches, moe_int8_launches = phase_train_moe_ranks(
                dev, smi_line, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        phase = "train_offload_parity"
        phase_train_offload_parity(batch, dev, smi_line)
        phase = "train_offload"
        offload_launches, opt_peak = phase_train_offload(batch, dev, smi_line)
        phase = "train_param_offload"
        param_launches = phase_train_param_offload(batch, opt_peak, dev,
                                                   smi_line)
        phase = "kernels"
        # each kernel's launches on every main path run it lies on, each run
        # with its own reset; the line's count is that of the path its
        # timing shape comes from (first listed)
        path_counts = {"serve": st["launches"], "serve_http": serve_launches,
                       "disagg": disagg_launches, "fleet": fleet_launches,
                       "train": train_launches,
                       "train_offload": offload_launches,
                       "train_param_offload": param_launches,
                       "A1": zi["A1"]["path_launches"],
                       "A2": zi["A2"]["path_launches"], "B": qgz_launches,
                       "train_zero": zero_launches,
                       "train_zero_ranks": zero_ranks_launches,
                       "train_qgz_ranks": qgz_ranks_launches,
                       "quant_collectives": coll_launches,
                       "serve_moe": serve_moe_launches,
                       "train_moe": moe_launches,
                       "train_moe_ranks": moe_ranks_launches,
                       "moe_int8": moe_int8_launches,
                       "evoformer": evo_launches, **sparse_launches,
                       "R": rms_launches, "F": bias_act_launches}
        launches_by_path = {
            name: {p: path_counts[p].get(name, 0) for p in paths}
            for name, paths in KERNEL_PATHS.items()}
        check(all(n > 0 for by in launches_by_path.values()
                  for n in by.values()),
              f"a kernel was not launched on its path: {launches_by_path}")
    except Exception as exc:  # any failed phase: report it, exit non-zero
        traceback.print_exc()
        emit({"phase": phase, "ok": False, "error": f"{type(exc).__name__}: {exc}"})
        return 1
    numbers = {"paged_attention": {"max_abs_err": worst, **timing},
               **{n: {"max_abs_err": flash_worst[n], **flash_timing[n]}
                  for n in FLASH_PER_STEP},
               **{n: {"max_abs_err": quant_worst[n], **quant_timing[n]}
                  for n in QUANT_KERNELS},
               **{n: {"max_abs_err": evo_worst[n], **evo_timing[n]}
                  for n in EVO_KERNELS},
               **{n: {"max_abs_err": slice5_worst[n], **slice5_timing[n]}
                  for n in SLICE5_KERNELS}}
    rows = []
    for name, (source, replaces) in KERNEL_TABLE.items():
        build_s, registers = _build_of(build_info, source,
                                       ENTRY_NAMES.get(name, name))
        rows.append({"name": name, "route": "cuda",
                     "source": f"deepspeed_tpu_torch/csrc/{source}.cu",
                     "replaces": replaces,
                     "launches": launches_by_path[name][KERNEL_PATHS[name][0]],
                     "launches_by_path": launches_by_path[name],
                     "build_s": build_s, "registers": registers, "ok": True,
                     **numbers[name]})
    emit({"kernels": rows})
    print(smi_line, flush=True)
    emit({"ok": True, "device": dev})
    return 0


if __name__ == "__main__":
    sys.exit(main())
