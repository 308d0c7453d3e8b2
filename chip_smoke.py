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
- the training carry-overs: the recipe through DeepSpeed's loop
  (``engine(micro)`` / ``backward`` / ``step``, ``train_micro_steps``) and
  with the async pipeline (``sync_every`` 4, the staged prefetch, batches
  from ``initialize(training_data=)``'s loader through ``RepeatingLoader``,
  ``train_async``), each on ``train``'s batch from the same seeded weights:
  losses and masters ``train``'s bit for bit, exact flash launches, the
  boundaries, the ring's transfers and drained steps, the staged batches
  waited on, dispatch against reconciled step time and the idle share of a
  profiled step; then LAMB, Lion, Adagrad, SGD (Nesterov) and RMSprop at
  Llama-3-8B width x 1 layer (``train_optimizers``): two steps each, the
  card's step-2 update of the embedding, an MLP kernel and the final norm
  against the same optimizer on the CPU from the same state and gradients,
  state bytes and step ms;
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
- sequence parallelism (``train_sp``): Llama-3-8B at full width cut to 2
  layers, one sequence of 8192 tokens (4096 if two ranks would not fit)
  over ``sequence=2``, two gloo processes on the card (the flash kernels
  timed at the ring's blocks and Ulysses' gathered sequence beside the
  other flash timings, early in the run): the striped
  and contiguous flash rings and Ulysses against their plain versions at a
  rank's shard, forward and backward, with the ring's last step dropped
  as a mutant; then Ulysses, the striped ring, the contiguous ring and the
  striped ring with the chunked loss, two steps each, step 1 against the
  one-rank flash run on the same weights and tokens, a planted fault
  (every rank rotating with local positions) outside that tolerance,
  exact flash launches per rank and the ``sequence/*`` bytes a step equal
  to the count from the shapes; ``train_chunked_loss``: the training
  recipe with ``loss_chunk_size=1024`` against the dense loss (step 1's
  loss and norm, exact launches, peak HBM of each);
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

import concurrent.futures
import contextlib
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


_T0 = time.monotonic()
_PHASE_SECONDS = {}                  # phase line -> seconds since the last line
_LAST_LINE = [_T0]
# every line also goes to this file (gitignored), opened by main(): it keeps
# the whole run where a caller keeps only the output's end
LINES_PATH = os.path.join("chiprun_out", "chip_smoke.jsonl")
_LINES = []


def emit(obj) -> None:
    """Print one JSON line; a phase's line also records the seconds since
    the previous one under its phase name (``phase_seconds``)."""
    if "phase" in obj:
        now = time.monotonic()
        name = obj["phase"]
        _PHASE_SECONDS[name] = _PHASE_SECONDS.get(name, 0.0) + now - \
            _LAST_LINE[0]
        _LAST_LINE[0] = now
    line = json.dumps(obj)
    print(line, flush=True)
    for f in _LINES:
        f.write(line + "\n")
        f.flush()


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


def _dump_sass(library) -> str:
    """``cuobjdump --dump-sass`` of ``library`` (from nvcc's folder)."""
    from deepspeed_tpu_torch.ops import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    res = subprocess.run([tool, "--dump-sass", str(library)],
                         capture_output=True, text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-400:]}")
    return res.stdout


def _sass_counts(sass, entries, ops):
    """{demangled entry: {op: count}} of ``ops`` in each entry of the
    dumped ``sass`` whose name holds one of ``entries``."""
    counts, cur = {}, None
    for line in sass.splitlines():
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
    # one dump a library, all at once (each takes seconds)
    libs = sorted({lib for lib, _, _, _ in SASS_CHECKS.values()})
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        dumps = dict(zip(libs, pool.map(
            lambda lib: _dump_sass(results[lib].path), libs)))
    sass = {label: _sass_counts(dumps[lib], entries, ops)
            for label, (lib, entries, ops, _) in SASS_CHECKS.items()}
    del dumps
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
    """Seeded (q, k, v, dO) on the card, and sorted segment ids when asked:
    ``seg=True`` one [B,S] set that queries and keys share, ``"pair"`` a
    ``(q_ids, k_ids)`` pair of two draws (the ring's: the key half rode
    from another rank)."""
    sk = sk or s
    q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device="cuda").to(dtype)
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)

    def ids(n):
        return torch.sort(torch.randint(0, 3, (b, n), generator=gen,
                                        device="cuda"), dim=1).values
    segs = None
    if seg == "pair":
        segs = (ids(s), ids(sk))
    elif seg:
        segs = ids(s)
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
    q_ids, k_ids = segs if isinstance(segs, tuple) else (segs, segs)
    rows = 0
    for bi in range(b):
        first, last = lo, hi
        if segs is not None:       # sorted key ids: a query's keys are one run
            qi, ki = q_ids[bi].cpu().numpy(), k_ids[bi].cpu().numpy()
            first = np.maximum(lo, np.searchsorted(ki, qi, side="left"))
            last = np.minimum(hi, np.searchsorted(ki, qi, side="right") - 1)
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


def _pair_swapped(args, segs, opts, res, want):
    """The ring's segment pair read the other way round: queries take the
    key block's ids and keys the queries'."""
    return _flash_plain_all(args, (segs[1], segs[0]), opts, res)


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
    # a tensor rank's heads (32/2 and 8/2): train_tp_ranks' shape, and
    # infer_tp_ranks' (two prompts of 512); half the heads is another grid
    ("tp_rank", dict(b=1, s=2048, h=16, hkv=4, d=128, dtype=torch.bfloat16),
     dict(causal=True),
     {"mask_off_by_one": (_changed_opts(_off_by_one), ANY),
      "kv_head_mod": (_kv_head_mod, ANY),
      "dkv_rep_minus_1": (_dkv_rep_minus_1, ("dk", "dv")),
      "late_tile_dropped": (_late_tile_dropped, FLASH_OUTPUTS), **DQ_TILE}),
    ("tp_serve", dict(b=2, s=512, h=16, hkv=4, d=128, dtype=torch.bfloat16),
     dict(causal=True),
     {"mask_off_by_one": (_changed_opts(_off_by_one), ANY),
      "kv_head_mod": (_kv_head_mod, ANY),
      "late_tile_dropped": (_late_tile_dropped, FLASH_OUTPUTS)}),
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
    # the flash ring's blocks at train_sp's shape (a rank's 4096 of 8192
    # tokens): a striped step from a later rank (causal_shift=1, row 0 has
    # no live key) and a contiguous ring's earlier step (full), each with a
    # (q_ids, k_ids) pair whose key half rode from another rank
    ("ring_block", dict(b=1, s=4096, h=32, hkv=8, d=128,
                        dtype=torch.bfloat16, seg="pair"),
     dict(causal=True, causal_shift=1),
     {"mask_off_by_one": (_changed_opts(_off_by_one), ANY),
      "pair_swapped": (_pair_swapped, ANY)}),
    ("ring_full", dict(b=1, s=4096, h=32, hkv=8, d=128,
                       dtype=torch.bfloat16, seg="pair"),
     dict(causal=False),
     {"pair_swapped": (_pair_swapped, ANY),
      "segment_mask_dropped": (_segments_dropped, ANY)}),
]


def _json_ratio(x):
    # a mutant's mask can make a row live whose lse is -1e30: inf there,
    # written as 1e30 for JSON
    return x if math.isfinite(x) else 1e30


def run_flash_cases(gen, names=None):
    """Every FLASH_CASES case (or those ``names`` lists): the three kernels
    against the plain mirrors (each output within its per-row tolerance,
    finite), and each mutant of the plain version outside the tolerance on
    the outputs it names (on at least one when it names ``any``), and a
    second backward on the same inputs repeating dQ, dK and dV bit for bit.
    Returns the rows; raises PhaseError on any failure. The ``gpu`` tests
    run this too."""
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    rows = []
    for name, shape, opts, mutants in FLASH_CASES:
        if names is not None and name not in names:
            continue
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
    of some name is not a positive multiple of ``iters`` lost events and is
    taken again (up to PROFILE_TRIES windows; a window late in a long run
    has delivered events of none of the named kernels)."""
    for _ in range(PROFILE_TRIES):
        events = _device_events(fn, iters)
        mine = {n: [e.time_range.elapsed_us() for e in events if n in e.name]
                for n in names}
        if all(t and len(t) % iters == 0 for t in mine.values()):
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
                 "dequantize_fp8", "quantize_int8_scaled")
# the given-scale int8 encode's faults: a product with the reciprocal
# scale, ties rounded away from 0, the next row's scale
SCALED_FAULTS = ("reciprocal_multiply", "round_half_away", "scale_row_shift")
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


def _scaled_mutant(x, scales, fault):
    """The plain given-scale encode with one of SCALED_FAULTS."""
    x2d, sc = x.float(), scales.float()
    if fault == "scale_row_shift":
        sc = sc.roll(1, 0)
    v = x2d * (1.0 / sc) if fault == "reciprocal_multiply" else x2d / sc
    if fault == "round_half_away":
        v = torch.nextafter(v, 2.0 * v)
    return torch.clamp(torch.round(v), -127, 127).to(torch.int8)


def run_quant_scaled_cases(seed=SEED, device="cuda"):
    """``quantize_int8_scaled`` on every int8 case of ``quant_cases`` (the
    special rows included) against its plain version bit for bit, and on a
    view one row in, with given scales: each row's own scale, every odd
    row's times 1.5 (a wider row's, as qwZ's max over a row's pieces
    gives). Each of SCALED_FAULTS must change a code in some case.
    Returns (rows, largest |kernel - plain| code distance)."""
    from deepspeed_tpu_torch.ops.quant import (quantize_int8_plain,
                                               quantize_int8_scaled,
                                               quantize_int8_scaled_plain)
    rows, worst = [], 0.0
    caught = dict.fromkeys(SCALED_FAULTS, 0)
    for name, xnp, fmt, dname, special in quant_cases(seed):
        if fmt != "int8":
            continue
        x = torch.from_numpy(xnp).to(device=device, dtype=QUANT_DTYPES[dname])
        scales = quantize_int8_plain(x)[1].clone()
        scales[1::2] *= 1.5
        q_k = quantize_int8_scaled(x, scales)
        q_p = quantize_int8_scaled_plain(x, scales)
        row = {"case": name, "dtype": dname, "codes_differ": _differs(q_k, q_p)}
        if x.shape[0] >= 2:
            row["view_differ"] = _differs(
                quantize_int8_scaled(x[1:], scales[1:]),
                quantize_int8_scaled_plain(x[1:], scales[1:]))
        worst = max(worst, (q_k.float() - q_p.float()).abs().max().item())
        for fault in SCALED_FAULTS:
            caught[fault] += _differs(_scaled_mutant(x, scales, fault), q_p)
        check(row["codes_differ"] == 0 and row.get("view_differ", 0) == 0,
              f"quantize_int8_scaled {dname} {name}: {row} codes differ "
              "from the plain version")
        rows.append(row)
    for fault, n in caught.items():
        check(n > 0, f"quantize_int8_scaled: mutant {fault} gives the plain "
              "version's codes in every case")
    emit({"phase": "quant_scaled_parity", "cases": len(rows),
          "bit_identical": True, "mutants_caught": caught})
    return rows, worst


def phase_quant_parity():
    rows = run_quant_cases()
    worst = {k: 0.0 for k in QUANT_KERNELS}
    worst["quantize_int8_scaled"] = run_quant_scaled_cases()[1]
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
    qwz = _qwz_kernel_timing(train_config()[0])
    emit({"phase": "quant_timing", "shapes": {k: list(v) for k, v in
                                              QUANT_TIMING_SHAPES.items()},
          "qwz_block_shapes": {k: list(v) for k, v in qwz_timing_shapes(
              train_config()[0]).items()},
          "qwz_kernels": {k: {w: {**r, "share_of_bound": r["bound_ms"] / r["ms"]}
                              for w, r in v.items()} for k, v in qwz.items()},
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
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {**{k: {key: out[k][w][key] for key in keys}
               for k, w in path_shape.items()},
            "quantize_int8_scaled": {key: qwz["quantize_int8_scaled"][
                "lm_head_block"][key] for key in keys}}


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
def train_config(lr=3e-4, backend="flash", layers=TRAIN_LAYERS):
    """Llama-3-8B at its published width, cut to TRAIN_LAYERS layers, with
    bench.py's 8b recipe (seq 2048, micro-batch 1, gas 2, AdamW 3e-4, bf16
    with bf16 gradient accumulation, ZeRO 0, flash, remat); the probe
    changes ``lr`` or ``backend``, the card test of ``train_resume`` the
    depth."""
    import dataclasses
    from deepspeed_tpu_torch.models.llama import LLAMA3_8B
    cfg = dataclasses.replace(
        LLAMA3_8B, num_layers=layers, max_seq_len=TRAIN_SEQ,
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
    return engine, batch, launches, losses, mean_ms


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
    return 1.0 - busy_ms / window_ms


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
# phase 7b: the training carry-overs (the micro-step protocol, the async
# step pipeline with the loader, the optimizers other than Adam)
# ---------------------------------------------------------------------------
ASYNC_SYNC_EVERY = 4               # train_async's drain cadence
OPT_LAYERS = 1                     # train_optimizers' depth, Llama-3-8B width
OPT_STEPS = 2                      # train_batch steps of each optimizer
# each optimizer at an lr of its own kind; the three leaves whose step-2
# update the CPU repeats: the embedding, an MLP kernel, a norm scale
OPTIMIZERS = {
    "lamb": {"type": "lamb", "params": {"lr": 3e-4, "weight_decay": 0.1}},
    "lion": {"type": "lion", "params": {"lr": 3e-5, "weight_decay": 0.1}},
    "adagrad": {"type": "adagrad", "params": {"lr": 3e-3}},
    "sgd": {"type": "sgd", "params": {"lr": 3e-3, "momentum": 0.9,
                                      "nesterov": True}},
    "rmsprop": {"type": "rmsprop", "params": {"lr": 3e-5, "momentum": 0.9}},
}
OPT_LEAVES = ("model.embed.embedding", "model.layer_0.mlp.w_down.kernel",
              "model.final_norm.scale")
# card vs CPU, the same fp32 step: each element within OPT_ULPS ulps of its
# value (the card's elementwise kernels fuse a multiply-add the CPU rounds
# twice, and its rsqrt is within 2 ulps) plus OPT_UPDATE_REL of the leaf's
# largest update (LAMB's norms are sums in another order)
OPT_ULPS, OPT_UPDATE_REL = 2, 1e-5


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def host_masters(engine) -> dict:
    """Every fp32 master of a one-rank engine copied to the host, by name:
    the reference the micro-step and async runs are held against."""
    return {n: _host_copy(p) for n, p in engine.named_masters()}


def masters_vs(engine, ref) -> dict:
    """``engine``'s masters against ``ref`` (host copies), leaf by leaf on
    the card: bit for bit, and the largest distance and the share of
    elements apart where they are not."""
    apart = total = 0
    worst = 0.0
    for n, p in engine.named_masters():
        want = ref[n].to(p.device)
        d = (p.detach() - want).abs()
        apart += int((d > 0).sum())
        total += d.numel()
        worst = max(worst, float(d.max()))
        del want, d
    return {"bitwise": apart == 0, "max_abs": worst,
            "share_apart": apart / max(total, 1)}


def phase_train_micro_steps(batch, ref, dev, smi_line):
    """The recipe through DeepSpeed's loop, ``engine(micro)`` /
    ``engine.backward(loss)`` / ``engine.step()`` a micro-batch at a time,
    1 + TRAIN_STEPS steps on ``train``'s batch from the same seeded
    weights: each step's mean micro-batch loss and the final masters
    ``train``'s bit for bit (one rank: the same kernels, the same bf16
    fold and the same division), the boundary after each second
    ``backward``, and ``train``'s flash launches a step."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.ops import build
    cfg, ds_config = train_config()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=LlamaForCausalLM(cfg, device="cuda", seed=SEED),
        config=ds_config)
    micros = [{"input_ids": batch["input_ids"][i]} for i in range(TRAIN_GAS)]
    torch.cuda.synchronize()
    build.reset_launch_counts()        # the main path's run starts here
    losses, step_ms, per_step, boundaries = [], [], [], []
    for _ in range(1 + TRAIN_STEPS):
        before = build.launch_counts()
        t0 = time.monotonic()
        loss_sum = torch.zeros((), device=engine.device)
        for m in micros:
            loss = engine(m)
            engine.backward(loss)
            boundaries.append(engine.is_gradient_accumulation_boundary())
            engine.step()
            loss_sum += loss
        losses.append((loss_sum / TRAIN_GAS).item())   # ends the step
        step_ms.append((time.monotonic() - t0) * 1e3)
        after = build.launch_counts()
        per_step.append({n: after.get(n, 0) - before.get(n, 0)
                         for n in FLASH_PER_STEP})
    launches = build.launch_counts()
    cmp = masters_vs(engine, ref["masters"])
    want = {n: k * TRAIN_LAYERS * TRAIN_GAS for n, k in FLASH_PER_STEP.items()}
    timed = step_ms[1:]
    emit({"phase": "train_micro_steps", "model": f"LLAMA3_8B width, "
          f"{TRAIN_LAYERS} layers, bf16, remat, flash, seq {TRAIN_SEQ}, gas "
          f"{TRAIN_GAS}: engine(micro) / backward / step",
          "losses": losses, "train_losses": ref["losses"],
          "masters_vs_train": cmp, "boundaries": boundaries,
          "global_steps": engine.global_steps, "step_ms": step_ms,
          "step_ms_mean": sum(timed) / len(timed),
          "train_step_ms_mean": ref["step_ms_mean"],
          "launches_per_step": per_step, "launches": launches,
          "tolerance": "bit for bit", "card": dev["kind"],
          "nvidia_smi": smi_line})
    check(losses == ref["losses"],
          f"micro-step losses {losses} != train_batch's {ref['losses']}")
    check(cmp["bitwise"], f"micro-step masters apart from train_batch's: "
          f"{cmp}")
    check(boundaries == [False, True] * (1 + TRAIN_STEPS),
          f"accumulation boundaries {boundaries}")
    check(engine.global_steps == 1 + TRAIN_STEPS,
          f"global_steps {engine.global_steps}")
    check(all(s == want for s in per_step),
          f"flash launches per step {per_step}, expected {want}")
    del engine
    _release()
    return launches


def _profile_window(fn):
    """``fn`` once under torch.profiler, ending in a synchronize: the host
    ms of the window, the CUDA events, their busy ms."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.monotonic() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return window_ms, kernels, busy_ms


def phase_train_async(batch, ref, dev, smi_line):
    """The recipe with ``async_pipeline`` {sync_every ASYNC_SYNC_EVERY,
    prefetch}: ``train``'s micro-batches as a dataset through
    ``initialize(training_data=)``'s loader and ``RepeatingLoader``, 1 +
    TRAIN_STEPS ``train_batch(data_iter=)`` calls and ``flush_metrics()``:
    the losses and masters ``train``'s bit for bit, exactly
    ceil(steps / sync_every) transfers, the drained entries steps 1..N in
    order, every staged batch waited on by the compute stream; the
    dispatch and reconciled ms a step, and one step + drain under the
    profiler for the card's idle share."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
    from deepspeed_tpu_torch.utils.timer import (TRAIN_BATCH_DISPATCH_TIMER,
                                                 TRAIN_BATCH_TIMER)
    cfg, ds_config = train_config()
    ds_config["async_pipeline"] = {"enabled": True,
                                   "sync_every": ASYNC_SYNC_EVERY,
                                   "prefetch": True}
    dataset = [{"input_ids": batch["input_ids"][i][0]}
               for i in range(TRAIN_GAS)]
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=LlamaForCausalLM(cfg, device="cuda", seed=SEED),
        config=ds_config, training_data=dataset)
    it = RepeatingLoader(loader)
    steps = 1 + TRAIN_STEPS
    torch.cuda.synchronize()
    build.reset_launch_counts()        # the main path's run starts here
    t0 = time.monotonic()
    out = [engine.train_batch(data_iter=it) for _ in range(steps)]
    t_dispatched = time.monotonic()
    engine.flush_metrics()
    t_end = time.monotonic()
    launches = build.launch_counts()
    transfers = engine._sched.transfers
    waits = engine.staged_waits
    drained = engine.take_drained_metrics()
    losses = [x.item() for x in out]
    cmp = masters_vs(engine, ref["masters"])
    dispatch = list(engine.timers(TRAIN_BATCH_DISPATCH_TIMER)._records)
    reconciled = list(engine.timers(TRAIN_BATCH_TIMER)._records)
    window_ms, kernels, busy_ms = _profile_window(
        lambda: (engine.train_batch(data_iter=it), engine.flush_metrics()))
    engine._staged.close()
    want = {n: k * TRAIN_LAYERS * TRAIN_GAS * steps
            for n, k in FLASH_PER_STEP.items()}
    emit({"phase": "train_async", "model": f"LLAMA3_8B width, "
          f"{TRAIN_LAYERS} layers, bf16, remat, flash, seq {TRAIN_SEQ}, gas "
          f"{TRAIN_GAS}: async_pipeline sync_every {ASYNC_SYNC_EVERY}, "
          "prefetch, initialize(training_data=) + RepeatingLoader",
          "losses": losses, "train_losses": ref["losses"],
          "masters_vs_train": cmp, "transfers": transfers,
          "drained_steps": [e["step"] for e in drained],
          "staged_waits": waits,
          "dispatch_ms": [x * 1e3 for x in dispatch],
          "reconciled_step_ms": [x * 1e3 for x in reconciled],
          "run_ms": (t_end - t0) * 1e3,
          "dispatch_window_ms": (t_dispatched - t0) * 1e3,
          "train_step_ms_mean": ref["step_ms_mean"],
          "profiled_window_ms": window_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / window_ms,
          "train_profile_idle_share": ref.get("idle_share"),
          "launches": launches, "tolerance": "bit for bit",
          "card": dev["kind"], "nvidia_smi": smi_line})
    check(losses == ref["losses"],
          f"async losses {losses} != train_batch's {ref['losses']}")
    check(cmp["bitwise"], f"async masters apart from train_batch's: {cmp}")
    check(transfers == -(-steps // ASYNC_SYNC_EVERY),
          f"{transfers} transfers for {steps} steps at sync_every "
          f"{ASYNC_SYNC_EVERY}")
    check([e["step"] for e in drained] == list(range(1, steps + 1)),
          f"drained steps {[e['step'] for e in drained]}")
    check(waits == steps, f"{waits} staged batches waited on, {steps} steps")
    check({n: launches.get(n, 0) for n in FLASH_PER_STEP} == want,
          f"flash launches {launches}, expected {want}")
    check(kernels, "the profiler saw no kernel on the card")
    del engine, out
    _release()
    return launches


# ---------------------------------------------------------------------------
# phase 7c: checkpoint and resume (train_resume, serve_from_checkpoint)
# ---------------------------------------------------------------------------
RESUME_SAVE_STEP = 2               # the sync save's step; the async one's is 3
RESUME_CHILD_TIMEOUT = 600         # seconds the fresh process may take
RESUME_GO_FILE = "resume.go"       # the parent's word that the tag is torn
CKPT_STATE_BYTES = 12              # a tag's bytes a parameter: fp32 master + Adam
CKPT_HOST_MARGIN = 8 << 30         # MemAvailable kept beside the two tags
TORN_LEAF = "params/model/layer_0/mlp/w_up/kernel.npy"   # truncated after commit
TORN_BYTES = 4096
SERVE_CKPT_PROMPTS, SERVE_CKPT_NEW = 4, 16
SERVE_CKPT_BLOCKS = 64             # each serving engine's KV pool, 64-token blocks
SERVE_CKPT_PRESET = "LLAMA3_8B"    # serving/cli.py's preset of the recipe's width


def _tag_array_bytes(cfg, layers) -> int:
    """The array bytes of one tag of the recipe: every parameter's fp32
    master and its two Adam moments (the npy headers and JSON aside)."""
    return CKPT_STATE_BYTES * llama_params(cfg, layers)


def _ckpt_rates(stats) -> dict:
    out = {k: stats[k] for k in ("bytes", "seconds", "write_s", "manifest_s",
                                 "snapshot_s", "verify_s", "read_s",
                                 "snapshot") if k in stats}
    if stats.get("bytes") and stats.get("seconds"):
        out["gb_per_s"] = stats["bytes"] / stats["seconds"] / 1e9
    return out


def _filesystem_of(path: str) -> str:
    """The type of the filesystem that holds ``path`` (/proc/mounts)."""
    path, best = os.path.realpath(path), ("", "?")
    with open("/proc/mounts") as f:
        for line in f:
            _, point, kind = line.split()[:3]
            if (path == point or path.startswith(point.rstrip("/") + "/")) \
                    and len(point) > len(best[0]):
                best = (point, kind)
    return f"{best[1]} at {best[0]}"


def _serve_ckpt_prompts(vocab):
    rng = np.random.default_rng(SEED + 7)
    return [list(map(int, rng.integers(0, vocab, int(n))))
            for n in rng.integers(48, 97, SERVE_CKPT_PROMPTS)]


def _warm_remat(cfg, device) -> None:
    """One small product under ``cfg``'s remat policy: selective
    checkpointing imports ``torch._dynamo`` and its kin at its first use
    (most of a fresh process's first step on the card's machine, PERF.md
    §6 PR 24), so a process that waits anyway takes that cost first."""
    from torch.utils.checkpoint import checkpoint
    from deepspeed_tpu_torch.models.llama import REMAT_POLICIES
    ctx = REMAT_POLICIES[cfg.remat_policy] if cfg.remat else None
    x = torch.ones(8, 8, device=device, requires_grad=True)
    checkpoint(lambda t: (t @ t).sum(), x, use_reentrant=False,
               **({"context_fn": ctx} if ctx is not None else {})).backward()


def resume_child_main(save_dir: str, layers, device: str = "cuda") -> int:
    """``--resume-child DIR LAYERS [DEVICE]``: the fresh process of
    ``train_resume`` and ``serve_from_checkpoint``. Makes the card's
    context, waits for ``DIR/RESUME_GO_FILE``, builds the recipe's engine
    from another seed, names the torn ``global_step3`` (must raise
    ``CheckpointCorruptionError``), resumes from the newest committed tag
    (must be ``global_step2``), deletes both tags and trains to the
    ``train`` phase's last step with flash launches counted. Then it saves
    the final tag with ``async_save`` while an engine on its in-memory
    masters answers greedy requests, consolidates the committed tag to the
    fp32 npz and answers them again from an engine built through
    ``serving/cli.py --checkpoint`` on that npz. Writes
    ``DIR/child.json``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.engine import (
        CheckpointCorruptionError, wait_pending_checkpoint)
    from deepspeed_tpu_torch.checkpoint.universal import consolidate_to_fp32
    from deepspeed_tpu_torch.models.convert import (llama_params_from_jax,
                                                    to_flax_tree)
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, random_tokens
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.resilience import resume_from_latest
    from deepspeed_tpu_torch.serving import cli
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry_wall = time.time()
    torch.zeros(1, device=device)            # the card's context, made early
    _warm_remat(train_config(layers=int(layers))[0], device)
    t_wait = time.monotonic()
    go = os.path.join(save_dir, RESUME_GO_FILE)
    while not os.path.exists(go):            # the parent tears the tag first
        check(time.monotonic() - t_wait < RESUME_CHILD_TIMEOUT,
              f"no {go} after {RESUME_CHILD_TIMEOUT} s")
        time.sleep(0.05)
    t_start = time.monotonic()
    layers = int(layers)
    cfg, ds_config = train_config(layers=layers)
    batch = random_tokens(1, TRAIN_SEQ, vocab_size=cfg.vocab_size, seed=SEED,
                          gas=TRAIN_GAS)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=LlamaForCausalLM(cfg, device=device, seed=SEED + 1),
        config=ds_config, device=device)
    out = {"init_s": time.monotonic() - t_start, "entry_wall": entry_wall,
           "go_wait_s": t_start - t_wait}
    t0 = time.monotonic()
    try:
        engine.load_checkpoint(save_dir, tag=f"global_step{RESUME_SAVE_STEP + 1}")
        out["torn_raised"] = False
    except CheckpointCorruptionError as e:
        out["torn_raised"], out["torn_error"] = True, str(e)[:300]
    out["torn_s"] = time.monotonic() - t0
    out["untouched_after_torn"] = engine.global_steps == 0
    t0 = time.monotonic()
    tag, _ = resume_from_latest(engine, save_dir)
    out.update(resumed_tag=tag, resume_s=time.monotonic() - t0,
               load=_ckpt_rates(engine.ckpt_stats),
               resumed_step=engine.global_steps)
    check(tag == f"global_step{RESUME_SAVE_STEP}",
          f"resume_from_latest picked {tag}")
    t0 = time.monotonic()
    for name in os.listdir(save_dir):        # each tag once it is checked
        if name.startswith("global_step") or name == "latest":
            path = os.path.join(save_dir, name)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
    out["remove_s"] = time.monotonic() - t0
    build.reset_launch_counts()              # the resumed run's path
    losses, step_ms, per_step, _ = _train_steps(
        engine, batch, 1 + TRAIN_STEPS - RESUME_SAVE_STEP)
    out.update(losses=losses, step_ms=step_ms, per_step=per_step,
               launches=build.launch_counts(),
               train_s=time.monotonic() - t_start)
    # serve_from_checkpoint: the final tag is written while an engine on
    # the in-memory masters answers the requests
    t_serve = time.monotonic()
    final = engine.save_checkpoint(save_dir, async_save=True)
    out["final_tag"] = os.path.basename(final)
    args = cli.build_parser().parse_args(
        ["--preset", SERVE_CKPT_PRESET, "--num-layers", str(layers),
         "--checkpoint", os.path.join(save_dir, "model.npz"),
         "--kv-block-size", "64", "--kv-num-blocks", str(SERVE_CKPT_BLOCKS),
         "--device", device])
    scfg = cli.model_config(args)
    prompts = _serve_ckpt_prompts(scfg.vocab_size)
    from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2,
                                                            V2EngineConfig)
    mem = InferenceEngineV2(
        llama_params_from_jax(to_flax_tree(engine.named_masters()), scfg,
                              device=device),
        scfg, V2EngineConfig(kv_block_size=64,
                             kv_num_blocks=SERVE_CKPT_BLOCKS), device=device)
    want = [mem.generate(p, SERVE_CKPT_NEW, uid=i)
            for i, p in enumerate(prompts)]
    out["in_memory_s"] = time.monotonic() - t_serve
    del mem
    wait_pending_checkpoint(engine)
    out["final_save"] = {"committed_s": time.monotonic() - t_serve,
                         **_ckpt_rates(engine.ckpt_stats)}
    del engine
    _release()
    t0 = time.monotonic()
    npz = consolidate_to_fp32(final, args.checkpoint)
    out["consolidate_s"] = time.monotonic() - t0
    shutil.rmtree(final)
    t0 = time.monotonic()
    served = cli.build_engine(args)
    out["serve_build_s"] = time.monotonic() - t0
    build.reset_launch_counts()              # the served path
    got = [served.generate(p, SERVE_CKPT_NEW, uid=i)
           for i, p in enumerate(prompts)]
    out.update(serve_launches=build.launch_counts(), tokens=got,
               tokens_in_memory=want, serve_s=time.monotonic() - t_serve,
               npz=npz, exit_wall=time.time())
    with open(os.path.join(save_dir, "child.json"), "w") as f:
        json.dump(out, f)
    return 0


def run_train_resume(save_dir: str, ref=None, layers: int = TRAIN_LAYERS,
                     device: str = "cuda") -> dict:
    """The recipe from the ``train`` phase's seeded weights: two steps, a
    sync save, the third step, an async save; ``resume_child_main`` starts
    in a fresh process while that tag is written, and goes on once it is
    committed and one of its leaves truncated. Its losses must be the
    uninterrupted run's (``ref``: the ``train`` phase's losses and host
    masters; made here when None) bit for bit, and so must the final
    masters (read back from the consolidated npz), with exact flash
    launches a step. MemAvailable must hold the two tags first."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.engine import wait_pending_checkpoint
    from deepspeed_tpu_torch.checkpoint.universal import load_fp32_state
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, random_tokens
    cfg, ds_config = train_config(layers=layers)
    batch = random_tokens(1, TRAIN_SEQ, vocab_size=cfg.vocab_size, seed=SEED,
                          gas=TRAIN_GAS)

    def build_engine():
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=LlamaForCausalLM(cfg, device=device, seed=SEED),
            config=ds_config, device=device)
        return engine

    if ref is None:
        engine = build_engine()
        losses, _, _, _ = _train_steps(engine, batch, 1 + TRAIN_STEPS)
        ref = {"losses": losses, "masters": host_masters(engine)}
        del engine
        _release()
    tag_bytes = _tag_array_bytes(cfg, layers)
    avail = mem_available()
    if avail < 2 * tag_bytes + CKPT_HOST_MARGIN:
        avail, _ = settled_mem_available()
    row = {"model": f"LLAMA3_8B width, {layers} layers, bf16, flash",
           "save_fs": _filesystem_of(save_dir),
           "tag_array_bytes": tag_bytes, "mem_available": avail,
           "needs": 2 * tag_bytes + CKPT_HOST_MARGIN}
    check(avail >= row["needs"], f"MemAvailable {avail} cannot hold two "
          f"tags of {tag_bytes} bytes and {CKPT_HOST_MARGIN} more")
    engine = build_engine()
    losses, _, _, _ = _train_steps(engine, batch, RESUME_SAVE_STEP)
    engine.save_checkpoint(save_dir)
    row["save"] = _ckpt_rates(engine.ckpt_stats)
    losses += _train_steps(engine, batch, 1)[0]
    t0 = time.monotonic()
    engine.save_checkpoint(save_dir, async_save=True)
    returned = time.monotonic() - t0
    # the fresh process starts while the step-3 tag is written, and resumes
    # once that tag is committed and torn (it waits for RESUME_GO_FILE)
    t_child, spawn_wall = time.monotonic(), time.time()
    err_path = os.path.join(save_dir, "child.err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--resume-child",
             save_dir, str(layers), device], stdout=subprocess.DEVNULL,
            stderr=err, cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        wait_pending_checkpoint(engine)
        row["async_save"] = {"returned_s": returned,
                             "committed_s": time.monotonic() - t0,
                             **_ckpt_rates(engine.ckpt_stats)}
        row["parent_losses"] = losses
        check(losses == ref["losses"][:RESUME_SAVE_STEP + 1],
              f"the saving run's losses {losses} are not the train phase's "
              f"{ref['losses'][:RESUME_SAVE_STEP + 1]}")
        check(row["save"]["bytes"] == tag_bytes,
              f"a tag holds {row['save']['bytes']} array bytes, not "
              f"{tag_bytes}")
        del engine
        _release()
        torn = os.path.join(save_dir, f"global_step{RESUME_SAVE_STEP + 1}",
                            TORN_LEAF)
        os.truncate(torn, os.path.getsize(torn) - TORN_BYTES)
        open(os.path.join(save_dir, RESUME_GO_FILE), "w").close()
        rc = proc.wait(timeout=RESUME_CHILD_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    row["child_s"] = time.monotonic() - t_child
    end_wall = time.time()
    with open(err_path) as f:
        check(rc == 0, f"the resumed process failed ({rc}): "
              f"{f.read()[-3000:]}")
    with open(os.path.join(save_dir, "child.json")) as f:
        child = json.load(f)
    row["child_start_s"] = child["entry_wall"] - spawn_wall
    row["child_exit_s"] = end_wall - child["exit_wall"]
    want_losses = ref["losses"][RESUME_SAVE_STEP:]
    want_launch = {n: k * layers * TRAIN_GAS
                   for n, k in FLASH_PER_STEP.items()}
    final = load_fp32_state(child["npz"])
    apart = [n for n, m in ref["masters"].items()
             if not np.array_equal(final[n.replace(".", "/")],
                                   m.float().numpy())]
    del final
    row.update(child=child, bitwise_losses=child["losses"] == want_losses,
               bitwise_masters=not apart, masters_apart=apart[:5],
               resumed_tag=child["resumed_tag"],
               flash_per_step_want=want_launch)
    os.remove(child["npz"])
    check(child["torn_raised"] and child["untouched_after_torn"],
          "the torn tag named explicitly did not raise "
          "CheckpointCorruptionError before touching the engine")
    check(row["bitwise_losses"], f"resumed losses {child['losses']} are not "
          f"the uninterrupted {want_losses}")
    check(row["bitwise_masters"], f"resumed masters apart: {apart[:5]}")
    check(all(s == want_launch for s in child["per_step"]),
          f"flash launches per step {child['per_step']}, expected "
          f"{want_launch}")
    check(child["tokens"] == child["tokens_in_memory"],
          "the --checkpoint server's tokens are not the in-memory engine's")
    check(all(len(t) == SERVE_CKPT_NEW and all(0 <= x < cfg.vocab_size
                                               for x in t)
              for t in child["tokens"]), f"tokens {child['tokens']}")
    check(child["serve_launches"].get("paged_attention", 0) > 0,
          "the --checkpoint server launched no paged kernel")
    return row


def phase_train_resume(ref, dev, smi_line):
    """``train_resume`` then ``serve_from_checkpoint``, one line each; the
    checkpoints in a temporary directory, removed whatever happens."""
    save_dir = tempfile.mkdtemp(prefix="dstpu-ckpt-")
    try:
        row = run_train_resume(save_dir, ref)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    child = row.pop("child")
    emit({"phase": "train_resume", **row,
          **{k: child[k] for k in ("resumed_tag", "torn_raised", "torn_s",
                                   "go_wait_s", "remove_s",
                                   "resume_s", "load", "losses", "step_ms",
                                   "per_step", "init_s")},
          "card": dev["kind"], "nvidia_smi": smi_line})
    emit({"phase": "serve_from_checkpoint", "tokens": child["tokens"],
          "bitwise_tokens": child["tokens"] == child["tokens_in_memory"],
          "launches": child["serve_launches"],
          **{k: child[k] for k in ("final_save", "in_memory_s",
                                   "consolidate_s", "serve_build_s",
                                   "serve_s")},
          "card": dev["kind"], "nvidia_smi": smi_line})
    # the fresh process served after it trained: its serving seconds are
    # the second phase's
    _PHASE_SECONDS["train_resume"] -= child["serve_s"]
    _PHASE_SECONDS["serve_from_checkpoint"] += child["serve_s"]
    return child["launches"], child["serve_launches"]


def _pinned_copy(t: torch.Tensor, pool: dict, key) -> torch.Tensor:
    """``t`` copied into the pinned host buffer ``pool[key]`` (made, or
    made again, for its shape), without waiting: the caller synchronizes.
    The pool is reused from one optimizer to the next."""
    buf = pool.get(key)
    if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
        buf = pool[key] = torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True)
    buf.copy_(t.detach(), non_blocking=True)
    return buf


class _StepCapture:
    """Wraps an engine optimizer's ``step``: at the update whose count is
    ``at``, copies each named leaf's parameter, gradient and state to the
    host (``pool``'s pinned buffers) before the step and keeps the
    parameter after it (``after``); ``seconds`` is the time the copies
    took, out of that step's time."""

    def __init__(self, engine, names, at, pool):
        opt = engine.optimizer
        idx = [engine._param_names.index(n) for n in names]
        real = opt.step
        self.after, self.seconds = [], 0.0

        def step(params, grads):
            if opt.count != at:
                return real(params, grads)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            self.count = opt.count
            self.params = [_pinned_copy(params[i], pool, ("p", k))
                           for k, i in enumerate(idx)]
            self.grads = [_pinned_copy(grads[i], pool, ("g", k))
                          for k, i in enumerate(idx)]
            self.state = {name: [_pinned_copy(getattr(opt, name)[i], pool,
                                              ("s", j, k))
                                 for k, i in enumerate(idx)]
                          for j, name in enumerate(opt.STATE)}
            torch.cuda.synchronize()
            self.seconds = time.monotonic() - t0
            real(params, grads)
            self.after = [params[i].detach() for i in idx]

        opt.step = step


def _cpu_step_apart(cap, opt_cfg, lr_schedule, pool) -> dict:
    """The captured step repeated by the port's optimizer on the CPU: per
    leaf, the card's new values against the CPU's, in ulps of the value
    plus OPT_UPDATE_REL of the leaf's largest update (<= 1 passes)."""
    from deepspeed_tpu_torch.ops.optimizers import build_optimizer
    opt = build_optimizer(opt_cfg["type"], dict(opt_cfg["params"]),
                          lr_schedule=lr_schedule)
    params = [p.clone() for p in cap.params]
    opt.init(params)
    opt.load_state_dict({"count": cap.count, **cap.state})
    opt.step(params, [g.clone() for g in cap.grads])
    rows = []
    for k, (before, cpu, card) in enumerate(zip(cap.params, params,
                                                cap.after)):
        cpu_d = _pinned_copy(cpu, pool, ("r", k)).to(card.device,
                                                      non_blocking=True)
        before_d = before.to(card.device, non_blocking=True)
        upd = float((cpu_d - before_d).abs().max())
        mag = cpu_d.abs()
        ulp = torch.nextafter(mag, torch.full_like(mag, math.inf)) - mag
        apart = (card - cpu_d).abs()
        ratio = apart / (OPT_ULPS * ulp + OPT_UPDATE_REL * upd)
        rows.append({"numel": card.numel(), "max_abs": float(apart.max()),
                     "max_update": upd, "worst": float(ratio.max()),
                     "share_apart": float((apart > 0).float().mean())})
        del cpu_d, before_d, mag, ulp, apart, ratio
    return dict(zip(OPT_LEAVES, rows))


def phase_train_optimizers(batch, dev, smi_line):
    """Each optimizer of OPTIMIZERS through ``initialize()`` at
    Llama-3-8B's width cut to OPT_LAYERS layer, OPT_STEPS ``train_batch``
    steps of the recipe: the card's step-2 update of OPT_LEAVES against
    the port's same optimizer on the CPU from the same masters, state and
    step gradients (copied to the host), each optimizer's state bytes and
    step ms (step 2's without the capture's copies)."""
    import dataclasses
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    rows, pool = {}, {}
    for name, opt_cfg in OPTIMIZERS.items():
        cfg, ds_config = train_config()
        cfg = dataclasses.replace(cfg, num_layers=OPT_LAYERS)
        ds_config = dict(ds_config, optimizer=opt_cfg)
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=LlamaForCausalLM(cfg, device="cuda", seed=SEED),
            config=ds_config)
        cap = _StepCapture(engine, OPT_LEAVES, OPT_STEPS - 1, pool)
        step_ms, losses = [], []
        for _ in range(OPT_STEPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            losses.append(engine.train_batch(batch=batch).item())
            step_ms.append((time.monotonic() - t0) * 1e3)
        step_ms[-1] -= cap.seconds * 1e3          # the capture's copies
        apart = _cpu_step_apart(cap, opt_cfg, engine.lr_schedule, pool)
        rows[name] = {"class": type(engine.optimizer).__name__,
                      "state_bytes": engine.optimizer.state_bytes(),
                      "params": sum(p.numel() for p in engine._masters),
                      "step_ms": step_ms, "capture_s": cap.seconds,
                      "losses": losses, "card_vs_cpu": apart}
        del engine, cap
        _release()
    del pool
    _release()
    emit({"phase": "train_optimizers", "model": f"LLAMA3_8B width, "
          f"{OPT_LAYERS} layer, bf16, remat, flash, seq {TRAIN_SEQ}, gas "
          f"{TRAIN_GAS}", "optimizers": rows,
          "tolerance": f"fp32: per element {OPT_ULPS} ulps of the value + "
          f"{OPT_UPDATE_REL} of the leaf's largest update",
          "card": dev["kind"], "nvidia_smi": smi_line})
    for name, row in rows.items():
        check(all(math.isfinite(x) for x in row["losses"]),
              f"{name}: non-finite loss {row['losses']}")
        for leaf, r in row["card_vs_cpu"].items():
            check(r["worst"] <= 1.0 and r["max_update"] > 0,
                  f"{name}: {leaf}'s step-2 update on the card vs the "
                  f"CPU: {r}")


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
# train_batch steps of each two-rank run: cut from 2 to 1 to keep the
# smoke inside its time limit beside train_zeropp_ranks
RANKS_STEPS = 1
RANKS_TIMEOUT = 420                # seconds one spawned two-rank job may take
# depth of the two-rank runs: cut from the recipe's 4 layers to 2 to keep
# the smoke inside its time limit beside train_sp, and to 1 beside
# train_zeropp_ranks (width is never cut)
RANKS_LAYERS = 1
RANKS_BATCH = 4                    # sequences a step: micro 1 x gas 2 x 2 ranks
# the stages train_zero_ranks runs: stage 2 only since train_zeropp_ranks,
# whose MiCS variant runs stage 3 over the same fsdp=2 groups (the same
# gathers and reduce-scatters) under the same gates; the rank body runs 3
# and 2 unless told (the CPU test runs both)
ZERO_RANKS_STAGES = (2,)
ZERO_STAGES_ENV = "DSTPU_SMOKE_ZERO_STAGES"
# a master "moved apart" from the reference's when the two differ by more
# than this share of one AdamW step (lr): a step moves each weight by about
# lr, so a gradient whose sign flips in another summation order moves it
# ~2 lr, while the rest agree to rounding; the check counts such elements
MASTERS_ATOL_LR = 0.1
QGZ_RANKS_STEPS = 0                # train_qgz_ranks: steps after the first
#                                    (2 before train_zeropp_ranks)
# its depth: two ranks with the whole fp32 state (12 bytes a parameter) and
# a step's activations peak at ~36 GB each at 4 layers, which with the
# spawning process's blocks does not fit the 80 GB card; 2 layers leave
# ~8 GB a rank (width is never cut)
QGZ_RANKS_LAYERS = 1                # (2 before train_zeropp_ranks: the time)
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
    """(share of elements more than ``atol`` apart, largest distance), a
    leaf at a time on this rank's device: the same numbers as on the host
    (a difference, its magnitude and a comparison round nothing), where a
    billion fp32 elements take ~10 s of a rank's two host threads."""
    dev = _rank_device()
    n = apart = 0
    worst = 0.0
    for a, b in zip(got, want):
        d = (a.to(dev) - b.to(dev)).abs()
        n += d.numel()
        apart += int((d > atol).sum())
        worst = max(worst, float(d.max()))
        del d
    return apart / n, worst


def _save_masters(masters, stem) -> None:
    """Each fp32 master of ``masters`` to the ranks' folder, one ``.npy`` a
    leaf, for ``_blocks_apart`` on every rank."""
    for i, m in enumerate(masters):
        np.save(_rank_out(f"{stem}{i}.npy"), m.cpu().numpy())


def _remove_masters(stem) -> None:
    folder = os.environ[RANK_OUT_ENV]
    for name in os.listdir(folder):
        if name.startswith(stem) and name.endswith(".npy"):
            os.remove(os.path.join(folder, name))


def _blocks_apart(engine, stem, atol):
    """``_masters_apart`` of the engine's masters against those
    ``_save_masters`` wrote, with no gather: each rank compares the blocks
    it holds (of a tensor-parallel leaf, its ZeRO block of its tensor
    block), on its device, the first rank of those holding a block
    counts it, and the counts and the largest distance are reduced over
    the ranks (the same numbers: the counted blocks tile every leaf once,
    which the element count checks). Every rank must call it."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm.mesh import MESH_AXES
    from deepspeed_tpu_torch.runtime.zero import partition
    mesh, dev = engine.mesh, _rank_device()
    n = apart = 0
    worst = 0.0
    for i, (m, d, e, t) in enumerate(zip(engine._masters, engine._param_dim,
                                         engine._expert_dim,
                                         engine._tensor_dim)):
        check(e is None, "_blocks_apart: an expert leaf")
        held = tuple(engine._block_axes) if d is not None else ()
        tensor = ("tensor",) if t is not None else ()
        if mesh.axis_index(tuple(a for a in MESH_AXES
                                 if a not in held + tensor)):
            continue                   # a rank before this one counts it
        want = torch.from_numpy(np.load(_rank_out(f"{stem}{i}.npy"),
                                        mmap_mode="c"))
        if t is not None:              # this rank's tensor block first
            want = partition.shard_of(want, t, mesh, tensor)
        if d is not None:
            want = partition.shard_of(want, d, mesh, held)
        check(want.shape == m.shape, f"_blocks_apart: leaf {i}'s block "
              f"{tuple(m.shape)}, the reference's {tuple(want.shape)}")
        diff = (m.detach() - want.to(dev)).abs()
        n += diff.numel()
        apart += int((diff > atol).sum())
        worst = max(worst, float(diff.max()))
        del want, diff
    counts = torch.tensor([n, apart], dtype=torch.int64)
    dist.all_reduce(counts)
    largest = torch.tensor([worst], dtype=torch.float64)
    dist.all_reduce(largest, op=dist.ReduceOp.MAX)
    total = sum(math.prod(s) for s in engine._full_shapes.values())
    check(int(counts[0]) == total, f"_blocks_apart counted {int(counts[0])} "
          f"elements of {total}")
    return int(counts[1]) / total, float(largest[0])


def _world1_mesh():
    from deepspeed_tpu_torch.comm.mesh import MESH_AXES, Mesh
    return Mesh({a: 1 for a in MESH_AXES}, 0, torch.device(_rank_device()))


def stage0_orders(batch, layers, model, rows, steps):
    """The stage-0 reference on this rank alone (a one-rank mesh) in three
    summation orders over the same ``rows`` sequences a step: micro ``rows
    / gas`` x gas (the reference), micro 1 x ``rows``, and micro 1 x
    ``rows`` with each micro-batch's sequences reversed; ``steps`` steps
    each. Returns ((losses, norms, masters) of the reference, its summary
    with the tolerance: twice the larger distance of the other two
    orders). The masters stay on this rank's device."""
    gas = batch["input_ids"].shape[0]
    atol = MASTERS_ATOL_LR * _recipe_lr(model)
    flat = {k: v.reshape(gas * v.shape[1], 1, -1) for k, v in batch.items()}
    swapped = {k: v[:, ::-1].reshape(gas * v.shape[1], 1, -1)
               for k, v in batch.items()}
    micro = rows // gas
    runs = {}
    for name, b, g in ((f"micro{micro}_gas{gas}", batch, gas),
                       (f"micro1_gas{rows}", flat, rows),
                       (f"micro1_gas{rows}_swapped", swapped, rows)):
        cfg, ds = _zero_recipe(0, layers, model)
        ds.update(train_batch_size=rows, gradient_accumulation_steps=g)
        engine = _engine(cfg, ds, mesh=_world1_mesh())
        losses, norms = [], []
        for _ in range(steps):
            losses.append(engine.train_batch(batch=b).item())
            norms.append(engine.get_global_grad_norm())
        # kept on the card (15 GB at 1 layer beside a free card): the
        # comparisons below and the caller's need no host round trip
        runs[name] = (losses, norms, [m.detach().clone() for _, m
                                      in engine.named_masters()])
        del engine
        _release()
    la, na, ma = runs.pop(f"micro{micro}_gas{gas}")
    apart = {k: _masters_apart(mb, ma, atol) for k, (_, _, mb)
             in runs.items()}
    tol = {"loss": 2 * max(abs(a - b) for lb, _, _ in runs.values()
                           for a, b in zip(la, lb)),
           "grad_norm": 2 * max(abs(a - b) for _, nb, _ in runs.values()
                                for a, b in zip(na, nb)),
           "masters_share": 2 * max(s for s, _ in apart.values())}
    summary = {
        f"losses_micro{micro}_gas{gas}": la,
        f"grad_norms_micro{micro}_gas{gas}": na,
        "tolerance": tol, "masters_atol": atol,
        **{f"losses_{k}": v[0] for k, v in runs.items()},
        **{f"grad_norms_{k}": v[1] for k, v in runs.items()},
        **{f"masters_share_{k}": s for k, (s, _) in apart.items()},
        **{f"masters_max_abs_{k}": m for k, (_, m) in apart.items()}}
    return (la, na, ma), summary


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
    so a largest distance cannot tell a fault from those flips).
    ``$DSTPU_SMOKE_ZERO_STAGES`` (default ``3,2``) names the stages run."""
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
    atol = MASTERS_ATOL_LR * _recipe_lr(model)
    ref = None
    if r == 0:
        ref, out["reference"] = stage0_orders(batch, layers, model,
                                              RANKS_BATCH, RANKS_STEPS)
    dist.barrier()
    comms = get_comms_logger()
    comms.configure(enabled=True)
    stages = [int(x) for x in
              os.environ.get(ZERO_STAGES_ENV, "3,2").split(",")]
    for stage in stages:
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
        # every rank reads them (a stage-3 master is gathered); rank 0
        # compares them on its device
        masters = [m.detach() for _, m in engine.named_masters() if r == 0]
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


def _read_ranks(stem, tmp, world=RANKS):
    rows = []
    for r in range(world):
        with open(os.path.join(tmp, f"{stem}{r}.json")) as f:
            rows.append(json.load(f))
    return rows


def _spawn(body, tmp, device="cuda", timeout=RANKS_TIMEOUT, world=RANKS,
           **env):
    """Run ``body`` of this file in ``world`` processes over gloo (on the
    card unless ``device`` says otherwise); the seconds it took."""
    from deepspeed_tpu_torch.testing import run_distributed
    t0 = time.monotonic()
    # the ranks share one card: segments that grow in place leave no
    # reserved-but-unusable blocks between them
    run_distributed(f"chip_smoke:{body}", world, timeout=timeout,
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


BODIES_ENV = "DSTPU_SMOKE_BODIES"
# the two-rank phases' bodies, run in turn by one spawned pair
# (``phase_train_ranks``): one process start and card context for all five
TWO_RANK_BODIES = ("zero_ranks_body", "qgz_ranks_body", "moe_ranks_body",
                   "sp_ranks_body", "tp_infer_body")


def ranks_bodies():
    """Rank bodies of this file in turn in one spawned world, as
    ``$DSTPU_SMOKE_BODIES`` (comma-separated) names them; each body's
    seconds to ``<body>_seconds<rank>.json`` in the ranks' folder."""
    import torch.distributed as dist
    for name in os.environ[BODIES_ENV].split(","):
        t = time.monotonic()
        globals()[name]()
        _release()
        dist.barrier()
        with open(_rank_out(f"{name}_seconds{dist.get_rank()}.json"),
                  "w") as f:
            json.dump(time.monotonic() - t, f)


def _body_seconds(tmp, body) -> float:
    with open(os.path.join(tmp, f"{body}_seconds0.json")) as f:
        return json.load(f)


def phase_train_ranks(tmp) -> dict:
    """The two-rank phases' bodies (TWO_RANK_BODIES) in one pair of
    processes on the card over gloo, after planning the MoE depth and the
    sequence length on the card's free memory; the phases that follow
    (``train_zero_ranks`` to ``train_sp``) read and gate their rows."""
    _release()
    spawner = _host_side()
    moe = plan_moe_rank_layers()
    sp = plan_sp_seq()
    seconds = _spawn("ranks_bodies", tmp,
                     timeout=3 * RANKS_TIMEOUT + SP_TIMEOUT + TP_TIMEOUT,
                     **{BODIES_ENV: ",".join(TWO_RANK_BODIES),
                        ZERO_STAGES_ENV: ",".join(
                            str(k) for k in ZERO_RANKS_STAGES),
                        MOE_LAYERS_ENV: str(moe[0]),
                        "DSTPU_SMOKE_SEQ": str(sp[0])})
    emit({"phase": "train_ranks", "seconds": seconds,
          "bodies": {b: _body_seconds(tmp, b) for b in TWO_RANK_BODIES}})
    return {"spawner_hbm": spawner, "moe": moe, "sp": sp}


def phase_train_zero_ranks(dev, smi_line, tmp, spawn):
    """Two processes on the one card over gloo (named: NCCL refuses two
    ranks on one device), spawned through ``testing.run_distributed``:
    Llama-3-8B at full width, RANKS_LAYERS layers, the stages of
    ZERO_RANKS_STAGES at fsdp=2, RANKS_STEPS steps each; losses, gradient
    norms and the share of masters apart within twice the distance of
    stage-0 runs that differ only in summation order, every rank's losses
    and norms equal; each
    rank's fp32 masters + moments, peak HBM, and the all_gather /
    reduce_scatter bytes a step beside the count from the leaves' shapes;
    exact flash launches a step. The rows of ``phase_train_ranks``."""
    stages = [str(k) for k in ZERO_RANKS_STAGES]
    seconds = _body_seconds(tmp, "zero_ranks_body")
    spawner = spawn["spawner_hbm"]
    rows = _read_ranks("zero_ranks", tmp)
    ref = rows[0]["reference"]
    tol = ref["tolerance"]
    want = {n: k * RANKS_LAYERS * TRAIN_GAS for n, k in FLASH_PER_STEP.items()}
    path = {n: 0 for n in FLASH_PER_STEP}
    summary = {}
    for stage in stages:
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
    stage0 = 12 * llama_params(_zero_recipe(0)[0], RANKS_LAYERS)
    emit({"phase": "train_zero_ranks", "model": f"LLAMA3_8B width, "
          f"{RANKS_LAYERS} layers (depth cut from 32 for gloo's host copies)"
          f", bf16, flash, {RANKS} ranks on one card over gloo",
          "reference": ref, "stages": summary, "seconds": seconds,
          "spawner_hbm": spawner,
          "state_share_of_stage0": {
              k: (v["per_rank"][0]["masters"] + v["per_rank"][0]["moments"])
              / stage0 for k, v in summary.items()},
          "launches": path, "card": dev["kind"], "nvidia_smi": smi_line})
    for k, v in summary.items():
        held = v["per_rank"][0]["masters"] + v["per_rank"][0]["moments"]
        # stage 3 shards the masters too (half); stages 1-2 the moments
        check(held < (0.55 if k == "3" else 0.7) * stage0,
              f"stage {k} holds {held} bytes a rank of stage 0's {stage0}")
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
    _peak_reset()
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


def phase_train_qgz_ranks(dev, smi_line, tmp, spawn):
    """Two processes on the card over gloo, mesh data=2 with
    ``zero_quantized_gradients``: the step's gradient sync is
    ``quantized_all_reduce`` through the int8 kernels, exactly 2 quantize
    and 2 dequantize launches a step for each leaf that passes
    MIN_QUANT_SIZE and the wire test; step 1's synced gradients bit for bit
    those of the plain codec on the same inputs; the six quantized
    collectives once at world 2, bit for bit against their plain
    versions. The rows of ``phase_train_ranks``."""
    seconds = _body_seconds(tmp, "qgz_ranks_body")
    spawner = spawn["spawner_hbm"]
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
# phase 8b': the hierarchical ZeRO world and the replica-axis wire over four
# ranks (MiCS, ZeRO++ hpZ and qwZ, comm_compression, sparse gradients)
# ---------------------------------------------------------------------------
ZPP_RANKS = 4                      # train_zeropp_ranks' processes, one card
ZPP_VARIANTS = ("mics", "hpz", "hpz_qwz", "mics_compress")
ZPP_STEPS = 2                      # train_batch steps of each variant
ZPP_TIMEOUT = 900                  # seconds the spawned four may take
ZPP_BATCH = 8                      # sequences a step: micro 1 x gas 2 x 4
# depth: 1 layer of 32 (width is never cut). On the H100 at 1 layer the
# ranks peaked at 10.5 (hpz) to 17.6 GB (mics_compress) each beside a
# 0.55 GB spawner, 83.4 GB free (PERF.md); a second layer's 218 M
# parameters add ~2.6 GB a rank of MiCS state and error feedback, ~81 GB
# for the four: no margin on the card, and none in the time limit
ZPP_LAYERS = 1
ZPP_QWZ = "hpz_qwz"
# hpz_qwz against hpz and mics_compress against mics, relative, step 1
# and step 2 (``zeropp_gaps``): int8 weights move the loss and the norm,
# the int8 wire the norm, and the loss from step 2 on (step 1's is the same
# bits). Each limit is about four times the sound gap read at that step
# (8b: ``chip_smoke.py --zeropp-faults`` on the H100, the same gaps as the
# smoke's runs to the bit; tiny: the larger of its readings on the CPU
# and on the card, whose random weights differ, printed by ``pytest -s
# tests/test_torch_zeropp_card.py``). The planted faults' readings are
# the upper ones: at step 1 (8b) the missing fsdp_out sum moves the norm
# 0.29, a bucket summed 0.077, the fp8 wire 5.2e-4; one scale a block
# (1.1e-4) stays inside, and the bit-for-bit gate on the blocks is what
# catches it (PERF.md)
ZPP_GAP_LIMITS = {
    "8b": {"qwz_loss_rel": [1e-4, 6.4e-3], "qwz_norm_rel": [2.3e-4, 3.6e-3],
           "compress_loss_rel": [0.0, 1.4e-2],
           "compress_norm_rel": [3.2e-4, 6.2e-3]},
    "tiny": {"qwz_loss_rel": [8.4e-4, 1.2e-3],
             "qwz_norm_rel": [2.8e-3, 2.7e-3],
             "compress_loss_rel": [0.0, 3e-5],
             "compress_norm_rel": [2.6e-4, 3.7e-4]}}
# planted faults of ``chip_smoke.py --zeropp-faults`` (never in the default
# run), ZPP_STEPS steps each: the upper readings of ZPP_GAP_LIMITS
ZPP_FAULTS = ("hpz_qwz_block_scale", "hpz_qwz_no_second_hop",
              "mics_compress_bucket_summed", "mics_compress_fp8")
ZPP_FAULTS_ENV = "DSTPU_SMOKE_ZPP_FAULTS"
ZPP_VARIANTS_ENV = "DSTPU_SMOKE_ZPP_VARIANTS"   # a subset (the card tests)
ZPP_REF_STEM = "zeropp_reference_master"   # the reference's masters, a leaf a file
# a rank's masters and moments over stage 0's 12 bytes a parameter: MiCS
# shards them over fsdp (half), hpZ over fsdp_out x fsdp (a quarter); the
# few leaves no axis divides stay whole
ZPP_STATE_SHARE = {"mics": 0.55, "hpz": 0.3}


def zeropp_config(variant, layers, model="8b"):
    """The training recipe at stage 3 over ``mesh.fsdp`` = ZPP_RANKS, which
    the engine splits into fsdp_out 2 x fsdp 2: MiCS (``mics``,
    ``mics_compress``: + ``comm_compression`` int8 with error feedback in
    4 MiB buckets, and ``sparse_gradients``) or hpZ (``hpz``, ``hpz_qwz``:
    + ``zero_quantized_weights``). A planted fault's variant is the one
    its name starts with (``mics_compress_fp8``: the wire at fp8)."""
    cfg, ds = _zero_recipe(3, layers, model)
    ds.update(train_batch_size=ZPP_BATCH, mesh={"fsdp": ZPP_RANKS, "data": 1})
    zero = ds["zero_optimization"]
    if variant.startswith("mics"):
        zero["mics_shard_size"] = 2
    else:
        zero["zero_hpz_partition_size"] = 2
    if variant.startswith(ZPP_QWZ):
        zero["zero_quantized_weights"] = True
    if variant.startswith("mics_compress"):
        ds["comm_compression"] = {"enabled": True}
        ds["sparse_gradients"] = True
    if variant == "mics_compress_fp8":
        ds["comm_compression"]["wire_dtype"] = "fp8"
    return cfg, ds


@contextlib.contextmanager
def zeropp_fault(name, engine):
    """Plant a fault of ZPP_FAULTS for one run, then remove it:
    ``hpz_qwz_block_scale``: qwZ codes on one scale a block (its largest
    row's) in place of one a row; ``hpz_qwz_no_second_hop``: qwZ's
    backward keeps this rank's piece of the secondary block's gradient, no
    sum over fsdp_out; ``mics_compress_bucket_summed``: the last bucket's
    all-reduce summed over fsdp_out, not averaged."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops.quant import quantize_int8_scaled
    from deepspeed_tpu_torch.runtime.zero import partition
    saved = []
    if name == "hpz_qwz_block_scale":
        codes_of = partition.qwz_codes

        def block_scale(block, dim, row_axes):
            _, scales = codes_of(block, dim, row_axes)
            scales = scales.amax().expand_as(scales).contiguous()
            return quantize_int8_scaled(block, scales), scales
        saved.append((partition, "qwz_codes", codes_of))
        partition.qwz_codes = block_scale
    elif name == "hpz_qwz_no_second_hop":
        def backward(ctx, g):
            return (partition.shard_of(g, ctx.dim, engine.mesh, ctx.axes)
                    .contiguous(), None, None, None)
        saved.append((partition.QwzHop, "backward",
                      partition.QwzHop.__dict__["backward"]))
        partition.QwzHop.backward = staticmethod(backward)
    elif name == "mics_compress_bucket_summed":
        reduce, calls = comm.quantized_all_reduce, [0]
        n = len(engine._comm_compress.buckets)
        world = engine.mesh.axis_world(engine._wire_axes)

        def summed(*args, **kwargs):
            out, err = reduce(*args, **kwargs)
            calls[0] += 1
            return (out * world if calls[0] % n == 0 else out), err
        saved.append((comm, "quantized_all_reduce", reduce))
        comm.quantized_all_reduce = summed
    try:
        yield
    finally:
        for obj, attr, value in saved:
            setattr(obj, attr, value)


def _qwz_leaves(engine):
    """(index, name, dim) of the leaves qwZ quantizes: hpZ's sharded
    leaves of two or more dimensions."""
    return [(i, engine._param_names[i], pz.dim) for i, pz
            in engine._hpz_leaves if engine._masters[i].dim() >= 2]


def _qwz_round_trips(engine):
    """Per quantized leaf, this rank's secondary block of the plain int8
    round trip of the gathered full compute-dtype leaf (what the hop must
    give bit for bit), and of the planted fault: each primary block's rows
    quantized on their own scales (a leaf cut along its last axis holds
    pieces of rows)."""
    from deepspeed_tpu_torch.ops.quant import (dequantize_plain,
                                               quantize_int8_plain)
    from deepspeed_tpu_torch.runtime.zero import partition
    mesh, cdt = engine.mesh, engine.compute_dtype
    want, fault = {}, {}
    for i, name, d in _qwz_leaves(engine):
        full = partition.gather_full(engine._masters[i].detach().to(cdt), d,
                                     engine._block_axes)
        rt = dequantize_plain(*quantize_int8_plain(full), dtype=cdt)
        want[name] = partition.shard_of(rt, d, mesh, ("fsdp",)).clone()
        pieces = full.chunk(ZPP_RANKS, dim=d) if d == full.dim() - 1 \
            else (full,)
        bad = torch.cat([dequantize_plain(*quantize_int8_plain(p), dtype=cdt)
                         for p in pieces], dim=d)
        fault[name] = partition.shard_of(bad, d, mesh, ("fsdp",)).clone()
        del full, rt, bad
    return want, fault


@contextlib.contextmanager
def _secondary_capture(engine):
    """While active, the secondary blocks the engine's hpZ hop makes for
    its first micro-batch, by leaf name: ``partition.QwzHop.apply`` and
    ``GatherParam.apply`` under the hop's label are wrapped (called in
    the order of ``engine._hpz_leaves``)."""
    from deepspeed_tpu_torch.runtime.zero import partition
    names = [engine._param_names[i] for i, _ in engine._hpz_leaves]
    hop, gather = partition.QwzHop.apply, partition.GatherParam.apply
    got = {}

    def keep(out):
        if len(got) < len(names):
            got[names[len(got)]] = out.detach().clone()
        return out

    def qwz(*args):
        return keep(hop(*args))

    def gather_param(block, dim, axes, label=None):
        out = gather(block, dim, axes, label)
        return keep(out) if label == partition.HPZ_LABEL else out

    partition.QwzHop.apply = staticmethod(qwz)
    partition.GatherParam.apply = staticmethod(gather_param)
    try:
        yield got
    finally:
        del partition.QwzHop.apply, partition.GatherParam.apply


class _EFCapture:
    """Wraps ``comm.compress.ef_step`` to keep, for each step it is armed
    for, the step's first call with a residual (the first bucket's worker
    step): its input, residual, codes, scales and new residual."""

    def __init__(self):
        from deepspeed_tpu_torch.comm import compress
        self.compress, self.orig = compress, compress.ef_step
        self.armed, self.got = False, []
        compress.ef_step = self

    def __call__(self, x, error, wire_dtype="int8", chunk=256):
        out = self.orig(x, error, wire_dtype, chunk)
        if self.armed and error is not None:
            self.got.append((x.clone(), error.clone(), *out, chunk))
            self.armed = False
        return out

    def restore(self):
        self.compress.ef_step = self.orig


def _ef_invariant(got) -> dict:
    """``new_error == comp - codes * scale`` rounded once (``comp = x +
    error``; the product and the difference exact in float64), bit for
    bit, and its distance from ``comp - dequantize_int8(codes, scales)``
    (the kernel's fp32 product, rounded twice); the residual it started
    from (``residual_max_abs``: 0 on the first step)."""
    from deepspeed_tpu_torch.ops.quant import dequantize_int8
    x, error, codes, scales, new_error, chunk = got
    comp = x + error
    exact = (comp.double() - (codes.reshape(-1, chunk).double()
                              * scales.reshape(-1, 1).double()).reshape(-1)
             ).float()
    deq = dequantize_int8(codes.reshape(-1, chunk), scales.reshape(-1, 1),
                          dtype=torch.float32).reshape(-1)
    return {"elements": new_error.numel(),
            "differ": _differs(new_error, exact),
            "residual_max_abs": error.abs().max().item(),
            "max_abs_vs_two_roundings": (new_error - (comp - deq)).abs()
            .max().item()}


def sparse_wins(engine, path, k_tokens) -> bool:
    """The engine's sparse-wire rule for leaf ``path`` (reference
    ``_sparse_wire_policy``): ``k (d + 1) world < v d`` on the whole leaf,
    ``k = min(v, k_tokens)``."""
    v, d = engine._full_shapes[path]
    world = engine.mesh.axis_world(engine._wire_axes)
    return min(v, k_tokens) * (d + 1) * world < v * d


def expected_zeropp_comm(engine, gas: int, k_tokens: int = 0,
                         remat: bool = True) -> dict:
    """The comms logger's bytes a step per op (labels included), from the
    leaves' shapes: under hpZ the hop over ``fsdp_out`` (``hpz/...``: the
    primary block in the compute dtype, or int8 codes and fp32 row scales
    under qwZ, a scale all-reduce where a block holds pieces of rows; its
    backward the secondary block), the ``fsdp`` gathers of each use (twice
    a micro-batch for a layer's leaf under remat) and reduce-scatters of
    the full compute-dtype gradient; the per-micro-batch fp32 all-reduce
    over the batch axes the ZeRO axes leave (MiCS's ``fsdp_out`` unless
    it is a wire axis) and of the replicated leaves; each step's loss and
    norm all-reduces; ``comm_compression``'s buckets and the embedding's
    sparse gather (the dense block's bytes) where ``sparse_wins`` at
    ``k_tokens``, else its full-precision mean in the accumulation
    dtype."""
    mesh = engine.mesh
    cdt = torch.empty((), dtype=engine.compute_dtype).element_size()
    adt = torch.empty((), dtype=engine.config.grad_accum_dtype).element_size()
    hpz, qwz = bool(engine._hpz_leaves), engine._quantized_weights
    hop_world = mesh.shape["fsdp_out"] * mesh.shape["fsdp"] if hpz \
        else mesh.shape["fsdp"]
    micro_left = mesh.live_axes([a for a in engine._micro_axes
                                 if a not in engine._zero_axes])
    e = {}

    def add(op, n):
        e[op] = e.get(op, 0) + n

    sharded = 0
    for i, name in enumerate(engine._param_names):
        shape = engine._full_shapes[engine._paths[i]]
        full = math.prod(shape)
        d = engine._param_dim[i]
        if d is None:
            if engine._micro_axes:
                add("all_reduce", full * 4 * gas)
            if engine._wire_axes and engine._comm_compress is not None and \
                    not any(engine._paths[i] in b.paths
                            for b in engine._comm_compress.buckets):
                add("all_reduce", full * adt)
            continue
        sharded += 1
        uses = 2 if remat and ".layer_" in name else 1
        sec = full // mesh.shape["fsdp"]
        if hpz:
            block = full // hop_world
            if qwz and len(shape) >= 2:
                rows = block // (shape[-1] // (hop_world if d == len(shape) - 1
                                               else 1))
                add("hpz/all_gather", block * gas)
                add("hpz/all_reduce" if d == len(shape) - 1
                    else "hpz/all_gather", rows * 4 * gas)
            else:
                add("hpz/all_gather", block * cdt * gas)
            add("hpz/reduce_scatter", sec * cdt * gas)
        add("all_gather", sec * cdt * uses * gas)
        add("reduce_scatter", full * cdt * gas)
        if micro_left:
            add("all_reduce", sec * 4 * gas)
    add("all_reduce", 4 + 4 * sharded)
    comp = engine._comm_compress
    if comp is not None:
        add("quantized_all_reduce", sum(b.logical_bytes for b in comp.buckets))
    for p in engine._sparse_grad_paths:
        add("sparse_all_gather" if sparse_wins(engine, p, k_tokens)
            else "all_reduce",
            math.prod(engine._full_shapes[p]) // mesh.shape["fsdp"] * adt)
    return e


def expected_zeropp_launches(engine, variant, layers, gas, on_card) -> dict:
    """Kernel launches a step on one rank: the flash kernels of the
    recipe (none for the tiny model's plain backend), qwZ's int8 codes,
    given-scale codes (blocks cut along their last axis) and dequantize a
    quantized leaf and micro-batch, and two quantize and two dequantize
    launches a bucket (the worker and the server step, each dequantized)
    under ``comm_compression``; none of the int8 kernels on the CPU."""
    flash = on_card and engine.model.cfg.attention_backend == "flash"
    out = {n: (k * layers * gas if flash else 0)
           for n, k in FLASH_PER_STEP.items()}
    q = qs = dq = 0
    if variant == ZPP_QWZ:
        leaves = _qwz_leaves(engine)
        q = dq = len(leaves) * gas
        qs = sum(d == engine._masters[i].dim() - 1
                 for i, _, d in leaves) * gas
    if engine._comm_compress is not None:
        q += 2 * len(engine._comm_compress.buckets)
        dq += 2 * len(engine._comm_compress.buckets)
    if not on_card:
        q = qs = dq = 0
    return {**out, "quantize_int8": q, "quantize_int8_scaled": qs,
            "dequantize_int8": dq}



def _zeropp_run(variant, layers, model, batch, ref, comms, on_card):
    """One variant of ``train_zeropp_ranks`` on this rank (see
    ``zeropp_ranks_body``); a planted fault of ZPP_FAULTS records its
    losses and norms only. ``seconds``: the engine's
    build, the plain round trips, the steps, the masters' readback."""
    import torch.distributed as dist
    r = dist.get_rank()
    gas = TRAIN_GAS
    cfg, ds = zeropp_config(variant, layers, model)
    _peak_reset()
    t = time.monotonic()
    engine = _engine(cfg, ds)
    seconds = {"build": time.monotonic() - t}
    if variant in ZPP_FAULTS:
        t = time.monotonic()
        with zeropp_fault(variant, engine):
            steps = _rank_steps(engine, batch, ZPP_STEPS, comms)
        seconds["steps"] = time.monotonic() - t
        del engine
        _release()
        return {"steps": steps, "seconds": seconds}
    # the sparse wire's k: this rank's stacked [gas, 1, S] batch
    k_tokens = engine._batch_token_count(
        {k: torch.as_tensor(v[:, :1]) for k, v in batch.items()})
    run = {**_state_bytes(engine),
           "held": sum(m.numel() for m in engine._masters),
           "params": sum(math.prod(s) for s in engine._full_shapes.values()),
           "wire_axes": list(engine._wire_axes),
           "zero_axes": list(engine._zero_axes),
           "mesh": {a: engine.mesh.shape[a] for a in ("fsdp_out", "fsdp")},
           "expected_comm_per_step": expected_zeropp_comm(engine, gas,
                                                          k_tokens),
           "expected_launches_per_step": expected_zeropp_launches(
               engine, variant, layers, gas, on_card)}
    t = time.monotonic()
    want_copy = fault_copy = None
    if variant == ZPP_QWZ:
        want_copy, fault_copy = _qwz_round_trips(engine)
    seconds["round_trips"] = time.monotonic() - t
    capture = _EFCapture() if engine._comm_compress is not None else None
    comms.reset()
    steps, got_copy = [], {}
    t = time.monotonic()
    for k in range(ZPP_STEPS):
        if capture is not None:
            capture.armed = True
        with (_secondary_capture(engine) if want_copy is not None and k == 0
              else contextlib.nullcontext({})) as got:
            steps += _rank_steps(engine, batch, 1, comms)
        got_copy.update(got)
    seconds["steps"] = time.monotonic() - t
    if capture is not None:
        capture.restore()
        run["ef_invariant"] = [_ef_invariant(g) for g in capture.got]
        # each step starts from the residual the last one left, bit for bit
        run["ef_carried_differ"] = [_differs(b[1], a[4]) for a, b
                                    in zip(capture.got, capture.got[1:])]
        comp = engine._comm_compress
        recs = comms.timed_records.get("quantized_all_reduce", [])
        run["buckets"] = comp.bucket_summaries()
        run["bucket_records"] = [[int(rec[0]), int(rec[3])] for rec in recs]
        run["sparse_records"] = [
            [int(rec[0]), int(rec[3])]
            for rec in comms.timed_records.get("sparse_all_gather", [])]
        # k rows of int32 indices and values in the accumulation dtype
        d = cfg.hidden_size
        adt = torch.empty((), dtype=engine.config.grad_accum_dtype
                          ).element_size()
        run["sparse_k"] = k_tokens
        run["sparse_wire_expected"] = [
            min(math.prod(engine._full_shapes[p]) // d
                // engine.mesh.shape["fsdp"], k_tokens) * (4 + d * adt)
            for p in engine._sparse_grad_paths
            if sparse_wins(engine, p, k_tokens)]
        del capture
    if want_copy is not None:
        run["qwz_leaves"] = len(want_copy)
        run["qwz_last_axis_leaves"] = sum(
            d == engine._masters[i].dim() - 1
            for i, _, d in _qwz_leaves(engine))
        run["qwz_copy_differ"] = {
            n: _differs(got_copy[n], w) if n in got_copy else -1
            for n, w in want_copy.items()}
        run["qwz_fault_differ"] = sum(_differs(got_copy[n], w)
                                      for n, w in fault_copy.items()
                                      if n in got_copy)
        del want_copy, fault_copy
    del got_copy
    run["steps"] = steps
    run["peak_hbm"] = _peak()
    t = time.monotonic()
    if variant in ("mics", "hpz"):
        run["masters_share"], run["masters_max_abs"] = _blocks_apart(
            engine, ZPP_REF_STEM, MASTERS_ATOL_LR * _recipe_lr(model))
    seconds["masters"] = time.monotonic() - t
    if r == 0:
        run["loss_gap"] = max(abs(s["loss"] - a)
                              for s, a in zip(steps, ref[0]))
        run["grad_norm_gap"] = max(abs(s["grad_norm"] - a)
                                   for s, a in zip(steps, ref[1]))
    run["seconds"] = seconds
    del engine
    _release()
    return run


def zeropp_ranks_body():
    """One rank of ``train_zeropp_ranks`` (four processes over gloo on the
    card): rank 0 first runs the stage-0 reference alone in three
    summation orders (``stage0_orders``) and writes its masters to the
    ranks' folder (``_save_masters``); then every rank runs the
    variants, ZPP_STEPS steps each, recording losses, norms, launches and
    the comms logger's bytes a step, peak HBM, state bytes, and: under
    qwZ each quantized leaf's first secondary block bit for bit against
    the plain round trip of the gathered leaf (and the planted
    local-row-scale fault against it), under ``comm_compression`` each
    bucket's recorded bytes and wire bytes and the first bucket's
    error-feedback step of every step (``_ef_invariant``) with the
    residual carried from one step to the next; and the share of masters
    apart from the reference's (MiCS and hpZ, ``_blocks_apart``); then
    ``tp_zero3`` (``_tp_run``: fsdp 2 x tensor 2, the ``train_tp_ranks``
    line). ``$DSTPU_SMOKE_ZPP_VARIANTS`` names a subset of the variants.
    With ``$DSTPU_SMOKE_ZPP_FAULTS`` = 1 the planted faults of ZPP_FAULTS
    follow; with ``$DSTPU_SMOKE_TP_FAULTS`` = 1 those of TP_TRAIN_FAULTS
    in ``tp_zero3``."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    from deepspeed_tpu_torch.models.llama import random_tokens
    r = dist.get_rank()
    model = os.environ.get(RANK_MODEL_ENV, "8b")
    layers = int(os.environ.get("DSTPU_SMOKE_LAYERS", ZPP_LAYERS))
    faults = ZPP_FAULTS if os.environ.get(ZPP_FAULTS_ENV) == "1" else ()
    gas = TRAIN_GAS
    cfg0, _ = _zero_recipe(0, layers, model)
    batch = random_tokens(ZPP_BATCH // gas, TRAIN_SEQ if model == "8b"
                          else 64, vocab_size=cfg0.vocab_size, seed=SEED,
                          gas=gas)
    on_card = _rank_device() == "cuda"
    out = {"rank": r, "runs": {}, "layers": layers, "model": model}
    ref = None
    t = time.monotonic()
    if r == 0:
        ref, out["reference"] = stage0_orders(batch, layers, model,
                                              ZPP_BATCH, ZPP_STEPS)
        _save_masters(ref[2], ZPP_REF_STEM)
        ref = ref[:2]
        _release()
    dist.barrier()
    out["reference_seconds"] = time.monotonic() - t
    comms = get_comms_logger()
    comms.configure(enabled=True)
    variants = os.environ.get(ZPP_VARIANTS_ENV)
    variants = tuple(variants.split(",")) if variants else \
        ZPP_VARIANTS + TP_VARIANTS
    for variant in variants + faults:
        run = _tp_run if variant in TP_VARIANTS else _zeropp_run
        out["runs"][variant] = run(variant, layers, model, batch, ref, comms,
                                   on_card)
    if os.environ.get(TP_FAULTS_ENV) == "1":
        for fault in TP_TRAIN_FAULTS:
            out["runs"][f"tp_zero3_{fault}"] = _tp_run(
                "tp_zero3", layers, model, batch, ref, comms, on_card,
                fault=fault)
    comms.configure(enabled=False)
    dist.barrier()                     # every rank has read the reference
    if r == 0:
        _remove_masters(ZPP_REF_STEM)
    with open(_rank_out(f"zeropp_ranks{r}.json"), "w") as f:
        json.dump(out, f)


def zeropp_gaps(runs) -> dict:
    """Per step, relative: hpz_qwz's loss and norm against hpz's,
    mics_compress's against mics'; and each planted fault's present in
    ``runs`` against the variant it plants into."""

    def rel(a, b, key):
        return [abs(x[key] - y[key]) / abs(y[key])
                for x, y in zip(runs[a]["steps"], runs[b]["steps"])]

    gaps = {"qwz_loss_rel": rel(ZPP_QWZ, "hpz", "loss"),
            "qwz_norm_rel": rel(ZPP_QWZ, "hpz", "grad_norm"),
            "compress_loss_rel": rel("mics_compress", "mics", "loss"),
            "compress_norm_rel": rel("mics_compress", "mics", "grad_norm")}
    for f in ZPP_FAULTS:
        if f in runs:
            base = "hpz" if f.startswith(ZPP_QWZ) else "mics"
            gaps[f] = {"loss_rel": rel(f, base, "loss"),
                       "norm_rel": rel(f, base, "grad_norm")}
    return gaps


def check_zeropp_ranks(rows, on_card=True) -> dict:
    """The gates of ``train_zeropp_ranks`` on every rank's rows; returns
    the launches of the path summed over ranks, variants and steps, and
    the gaps of ``zeropp_gaps``."""
    ref = rows[0]["reference"]
    tol = ref["tolerance"]
    path = {}
    for variant in ZPP_VARIANTS:
        r0 = rows[0]["runs"][variant]
        for row in rows:
            run = row["runs"][variant]
            check(len(run["steps"]) == ZPP_STEPS,
                  f"{variant}: {len(run['steps'])} steps, not {ZPP_STEPS}")
            check([(s["loss"], s["grad_norm"]) for s in run["steps"]] ==
                  [(s["loss"], s["grad_norm"]) for s in r0["steps"]],
                  f"{variant}: rank {row['rank']}'s losses or gradient norms "
                  "differ from rank 0's")
            check(run["mesh"] == {"fsdp_out": 2, "fsdp": 2},
                  f"{variant}: the engine split fsdp into {run['mesh']}")
            share = (run["masters"] + run["moments"]) / (12 * run["params"])
            lim = ZPP_STATE_SHARE[variant.split("_")[0]]
            check(share < lim, f"{variant} rank {row['rank']}: masters and "
                  f"moments {share} of stage 0's, limit {lim}")
            for k, s in enumerate(run["steps"]):
                got = {op: int(t["bytes"]) for op, t in s["comm"].items()
                       if t["count"]}
                check(got == run["expected_comm_per_step"],
                      f"{variant} rank {row['rank']} step {k}: comm bytes "
                      f"{got}, expected {run['expected_comm_per_step']}")
                want = run["expected_launches_per_step"]
                launched = {n: s["launches"].get(n, 0) for n in want}
                check(launched == want, f"{variant} rank {row['rank']} step "
                      f"{k}: launches {launched}, expected {want}")
                for n, c in launched.items():
                    path[n] = path.get(n, 0) + c
            if variant == ZPP_QWZ:
                differ = run["qwz_copy_differ"]
                check(run["qwz_leaves"] > 0 and not any(differ.values()),
                      f"qwZ rank {row['rank']}: secondary blocks differ from "
                      f"the plain round trip of the gathered leaf (-1: not "
                      f"captured): {differ}")
                check(run["qwz_last_axis_leaves"] > 0 and
                      run["qwz_fault_differ"] > 0,
                      f"qwZ rank {row['rank']}: the local-row-scale fault "
                      "gives the same blocks, so the gate cannot catch it")
            if variant == "mics_compress":
                buckets = run["buckets"]
                want = [[b["bytes"], b["wire_bytes"]] for b in buckets]
                check(run["bucket_records"] == want * ZPP_STEPS,
                      f"rank {row['rank']}: bucket records "
                      f"{run['bucket_records'][:4]}..., plan {want[:4]}...")
                check([rec[1] for rec in run["sparse_records"]] ==
                      run["sparse_wire_expected"] * ZPP_STEPS,
                      f"rank {row['rank']}: sparse gathers "
                      f"{run['sparse_records']}, wire expected "
                      f"{run['sparse_wire_expected']}")
                inv = run["ef_invariant"]
                check(len(inv) == ZPP_STEPS and all(
                    i["elements"] > 0 and i["differ"] == 0 for i in inv),
                      f"rank {row['rank']}: error feedback {inv}")
                # the engine starts from zero residuals; every later step
                # from the last one's, which is not zero
                check(inv[0]["residual_max_abs"] == 0.0 and all(
                    i["residual_max_abs"] > 0 for i in inv[1:]) and
                      run["ef_carried_differ"] == [0] * (ZPP_STEPS - 1),
                      f"rank {row['rank']}: error-feedback residuals not "
                      f"carried: {run['ef_carried_differ']}, {inv}")
        if variant in ("mics", "hpz"):
            check(r0["masters_share"] <= tol["masters_share"],
                  f"{variant}: a share {r0['masters_share']} of the masters "
                  f"more than {ref['masters_atol']} from the stage-0 run's, "
                  f"tolerance {tol['masters_share']}")
            check(r0["loss_gap"] <= tol["loss"], f"{variant}: losses "
                  f"{r0['loss_gap']} from stage 0, tolerance {tol['loss']}")
            check(r0["grad_norm_gap"] <= tol["grad_norm"],
                  f"{variant}: gradient norms {r0['grad_norm_gap']} from "
                  f"stage 0, tolerance {tol['grad_norm']}")
    gaps = zeropp_gaps(rows[0]["runs"])
    # the wire does not touch the forward: step 1's loss limit is 0
    for key, lim in ZPP_GAP_LIMITS[rows[0]["model"]].items():
        check(all(g <= m for g, m in zip(gaps[key], lim)),
              f"{key}: gaps {gaps[key]} a step, limits {lim}")
    return path, gaps


def _exchange_share(run) -> list:
    """Per step: the comms logger's seconds over the step's."""
    return [sum(t["seconds"] for t in s["comm"].values())
            / (s["step_ms"] / 1e3) for s in run["steps"]]


def phase_train_zeropp_ranks(dev, smi_line, tmp, faults=False):
    """Four processes on the one card over gloo, spawned through
    ``testing.run_distributed``: Llama-3-8B at full width, ``mesh.fsdp`` =
    4 split by the engine into fsdp_out 2 x fsdp 2, stage 3, the training
    recipe, ZPP_STEPS steps of each variant (``zeropp_config``), against
    the stage-0 reference in three summation orders on rank 0. Gates
    (``check_zeropp_ranks``): MiCS and hpZ within twice the orders'
    distance (loss, norm, share of masters apart after the last step);
    qwZ's secondary blocks bit for bit the plain round trip of the
    gathered leaf, a planted local-row-scale fault outside it, each step
    within ZPP_GAP_LIMITS of hpZ; ``comm_compression``'s step-1 loss the
    same bits as MiCS's, each step's norm within ZPP_GAP_LIMITS, one
    quantized all-reduce a bucket of the plan's bytes and wire bytes, the
    embedding's sparse gather of ``k (d + 1)`` 4-byte words, the first
    bucket's error-feedback step exact on every step and step 2 starting
    from step 1's residual; every rank's losses and norms equal; every
    op's bytes a step and every kernel's launches a step as reckoned.
    ``faults``: the planted faults of ZPP_FAULTS follow, and their gaps
    are reported (never gated)."""
    _release()
    spawner = _host_side()
    free, total = torch.cuda.mem_get_info()
    env = {"DSTPU_SMOKE_LAYERS": str(ZPP_LAYERS)}
    if faults:
        env[ZPP_FAULTS_ENV] = "1"
    seconds = _spawn("zeropp_ranks_body", tmp, timeout=ZPP_TIMEOUT,
                     world=ZPP_RANKS, **env)
    rows = _read_ranks("zeropp_ranks", tmp, world=ZPP_RANKS)
    runs = rows[0]["runs"]
    # the readings first: a gate that fails still leaves them
    emit({"phase": "train_zeropp_ranks_readings", "seconds": seconds,
          "reference_seconds": rows[0]["reference_seconds"],
          "gaps": zeropp_gaps(runs), "tp_gaps": tp_train_gaps(runs),
          "variants": {v: {"seconds": r["seconds"],
                           "losses": [s["loss"] for s in r["steps"]],
                           "grad_norms": [s["grad_norm"] for s in r["steps"]],
                           "step_ms": [s["step_ms"] for s in r["steps"]],
                           "peak_hbm": [row["runs"][v].get("peak_hbm")
                                        for row in rows]}
                       for v, r in runs.items()}})
    path, gaps = check_zeropp_ranks(rows)
    tp_path = check_tp_ranks(rows)
    check(runs["mics_compress"]["sparse_wire_expected"],
          "mics_compress: the embedding's gradient did not take the sparse "
          f"wire at k = {runs['mics_compress']['sparse_k']}")
    emit({"phase": "train_zeropp_ranks", "model": f"LLAMA3_8B width, "
          f"{ZPP_LAYERS} layer of 32, bf16, flash, remat, stage 3, fsdp=4 "
          f"split into fsdp_out=2 x fsdp=2, {ZPP_RANKS} ranks on one card "
          "over gloo", "free_hbm": free, "seconds": seconds,
          "spawner_hbm": spawner, "reference": rows[0]["reference"],
          "reference_seconds": rows[0]["reference_seconds"],
          "gaps": gaps, "gap_limits": ZPP_GAP_LIMITS["8b"],
          "variants": {v: {
              "losses": [s["loss"] for s in runs[v]["steps"]],
              "grad_norms": [s["grad_norm"] for s in runs[v]["steps"]],
              "step_ms": [s["step_ms"] for s in runs[v]["steps"]],
              "exchange_share": _exchange_share(runs[v]),
              "seconds": runs[v]["seconds"],
              **({"peak_hbm": [row["runs"][v]["peak_hbm"] for row in rows],
                  "masters": runs[v]["masters"],
                  "moments": runs[v]["moments"],
                  "comm_per_step": runs[v]["steps"][-1]["comm"],
                  "launches_per_step": runs[v]["expected_launches_per_step"]}
                 if v in ZPP_VARIANTS else {}),
              **{k: runs[v][k] for k in (
                  "masters_share", "masters_max_abs", "loss_gap",
                  "grad_norm_gap", "qwz_leaves", "qwz_last_axis_leaves",
                  "qwz_fault_differ", "ef_invariant", "ef_carried_differ",
                  "sparse_k", "sparse_records") if k in runs[v]},
              **({"buckets": len(runs[v]["buckets"])}
                 if "buckets" in runs[v] else {})}
              for v in runs},
          "launches": path, "card": dev["kind"], "nvidia_smi": smi_line})
    tp = runs["tp_zero3"]
    emit({"phase": "train_tp_ranks", "model": f"LLAMA3_8B width, "
          f"{ZPP_LAYERS} layer of 32, bf16, flash, remat, stage 3, fsdp=2 x "
          f"tensor={TP}, {ZPP_RANKS} ranks on one card over gloo",
          "limits": TP_TRAIN_LIMITS["8b"],
          "losses": [s_["loss"] for s_ in tp["steps"]],
          "grad_norms": [s_["grad_norm"] for s_ in tp["steps"]],
          "step_ms": [s_["step_ms"] for s_ in tp["steps"]],
          "exchange_share": _exchange_share(tp),
          **{k: tp[k] for k in ("masters_share", "masters_max_abs",
                                "loss_gap", "grad_norm_gap", "masters",
                                "moments", "seconds")},
          "peak_hbm": [row["runs"]["tp_zero3"]["peak_hbm"] for row in rows],
          "comm_per_step": tp["steps"][-1]["comm"],
          "launches_per_step": tp["expected_launches_per_step"],
          "launches": tp_path, "card": dev["kind"], "nvidia_smi": smi_line})
    return path, tp_path


# ---------------------------------------------------------------------------
# tensor parallelism: infer_tp_ranks (the gloo pair) and train_tp_ranks
# (the four-process spawn of train_zeropp_ranks)
# ---------------------------------------------------------------------------
TP = 2                             # tensor ranks of both phases, one card
TP_PROMPTS, TP_PROMPT_LEN = 2, 512   # infer_tp_ranks' batch (tiny: 64)
# the planted faults of infer_tp_ranks (``--tp-faults``, never in the
# default run; always in the CPU test): every rank serving the other
# rank's kv heads, and layer 0's wo all-reduce dropped
TP_FAULTS = ("kv_wrong_rank", "wo_reduce_dropped")
TP_FAULTS_ENV = "DSTPU_SMOKE_TP_FAULTS"
# the training faults (``--tp-faults`` and the CPU tests, never in the
# default run): the norm summing every leaf's square over tensor, and
# layer 0's copy-to-tensor backward dropped
TP_TRAIN_FAULTS = ("norm_all_tensor", "copy_dropped")
# train_tp_ranks' gate against the stage-0 reference: each step's loss
# and norm (absolute) and the share of masters apart after the last step,
# about four times the sound reading. The TP forward rounds each
# row-parallel sum of two bf16 partials, which no summation order of the
# reference does, so the orders' distance is no limit for it. 8b on the
# H100: 1.9e-4, 1.683e-4, 0.003537, the same bits in every run; the
# planted faults (``--tp-faults``) read a norm gap of 3.49e-3
# (norm_all_tensor) and 0.167 / 0.702 / 0.113 (copy_dropped). Tiny: the
# larger of the CPU's and the card's (card: 1.43e-6, 4.77e-5, 0.00135).
TP_TRAIN_LIMITS = {"8b": {"loss": 8e-4, "grad_norm": 7e-4,
                          "masters_share": 0.015},
                   "tiny": {"loss": 6e-6, "grad_norm": 2e-4,
                            "masters_share": 0.0054}}
TP_VARIANTS = ("tp_zero3",)        # train_tp_ranks' variant of the four
TP_TIMEOUT = 300                   # seconds tp_infer_body may add to the pair
# the serving gate: the TP logits against the one-rank logits (fp32,
# relative L2, and the share of rows whose argmax moves), about four times
# the sound reading (8b on the H100: 0.0200 and 0.0566, ``--tp-faults``,
# whose planted faults read 1.15-1.41 and 1.0; tiny: the CPU's fp32
# reading, 6.7e-7 and 0)
TP_LOGITS_LIMITS = {"8b": {"rel_l2": 0.08, "argmax_moved": 0.23},
                    "tiny": {"rel_l2": 4e-6, "argmax_moved": 0.0}}


@contextlib.contextmanager
def default_dtype(dtype):
    """Parameters made inside are ``dtype``: the serving model built at
    its compute dtype (Llama-3-8B's fp32 tree would take 32 GB a rank)."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(saved)


def tp_serving_cfg(model="8b"):
    """Llama-3-8B at full width and depth on the flash backend in bf16;
    the tiny model in fp32 on the plain backend for the CPU tests."""
    import dataclasses
    from deepspeed_tpu_torch.models.llama import LLAMA3_8B, TINY_LLAMA
    if model == "tiny":
        return dataclasses.replace(TINY_LLAMA, dtype=torch.float32,
                                   attention_backend="xla")
    return dataclasses.replace(LLAMA3_8B, dtype=torch.bfloat16,
                               attention_backend="flash")


def tp_prompts(cfg, model="8b"):
    """TP_PROMPTS seeded prompts; the first row opens with ids at the
    vocabulary blocks' edges (0, the last of block 0, the first and last
    of block 1), which the vocab-parallel lookup's mask must keep."""
    from deepspeed_tpu_torch.models.llama import random_tokens
    s = TP_PROMPT_LEN if model == "8b" else 64
    batch = random_tokens(TP_PROMPTS, s, cfg.vocab_size, seed=SEED + 20)
    v = cfg.vocab_size
    batch["input_ids"][0, :4] = [0, v // TP - 1, v // TP, v - 1]
    return batch


def tp_logit_gaps(got, want) -> dict:
    """fp32 relative L2 of ``got`` against ``want`` and the share of rows
    whose argmax moves."""
    got, want = got.float(), want.float()
    return {"rel_l2": ((got - want).norm() / want.norm()).item(),
            "argmax_moved": (got.argmax(-1) != want.argmax(-1)
                             ).float().mean().item()}


def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def expected_tp_infer_comm(cfg, b, s, elem) -> dict:
    """The comms logger's bytes of one TP forward a rank: the embedding's
    sum and two row-parallel sums a layer of ``[b, s, D]`` in the hidden
    dtype (``elem`` bytes), and the head's fp32 vocabulary block
    gathered."""
    d = cfg.hidden_size
    return {"tensor/embed/all_reduce": b * s * d * elem,
            "tensor/reduce/all_reduce": 2 * cfg.num_layers * b * s * d * elem,
            "tensor/gather/all_gather": b * s * (cfg.vocab_size // TP) * 4}


def _swap_kv_blocks(sd, tp=TP):
    """The full tree with each wk/wv kernel's head blocks in reverse rank
    order: each rank's cut holds another rank's kv heads."""
    out = dict(sd)
    for n, v in sd.items():
        if n.endswith((".wk.kernel", ".wv.kernel")):
            out[n] = torch.cat(v.chunk(tp, dim=1)[::-1], dim=1)
    return out


@contextlib.contextmanager
def tp_fault(name, model=None, engine=None):
    """Plant a fault of TP_FAULTS / TP_TRAIN_FAULTS for one run:
    ``wo_reduce_dropped`` / ``copy_dropped``: layer 0's attention without
    its row-parallel sum / its copy-to-tensor (whose backward sums dX);
    ``norm_all_tensor``: the engine's norm sums every leaf's square over
    ``tensor``. ``kv_wrong_rank`` is planted in the weights
    (``_swap_kv_blocks``)."""
    from deepspeed_tpu_torch.models import llama
    saved = []
    if name in ("wo_reduce_dropped", "copy_dropped"):
        fn = "reduce_from_tensor" if name == "wo_reduce_dropped" \
            else "copy_to_tensor"
        orig = getattr(llama, fn)
        inside = [False]
        attn = model.model.layer_0.attn
        saved.append(attn.register_forward_pre_hook(
            lambda *_: inside.__setitem__(0, True)))
        saved.append(attn.register_forward_hook(
            lambda *_: inside.__setitem__(0, False)))
        setattr(llama, fn, lambda x, *a, **k: x if inside[0]
                else orig(x, *a, **k))
        saved.append(lambda: setattr(llama, fn, orig))
    elif name == "norm_all_tensor":
        orig_norm = engine._global_norm

        def norm(grads):
            kept = engine._tensor_dim
            engine._tensor_dim = [0] * len(kept)
            try:
                return orig_norm(grads)
            finally:
                engine._tensor_dim = kept
        engine._global_norm = norm
        saved.append(lambda: delattr(engine, "_global_norm"))
    elif name not in (None, "kv_wrong_rank"):
        raise ValueError(f"unknown TP fault {name!r}")
    try:
        yield
    finally:
        for undo in reversed(saved):
            undo() if callable(undo) else undo.remove()


def tp_infer_body():
    """One rank of ``infer_tp_ranks`` (the gloo pair): rank 0 first serves
    the one-rank logits of Llama-3-8B (full width and depth, flash, bf16,
    random weights from SEED) on TP_PROMPTS prompts of TP_PROMPT_LEN
    tokens and keeps them; then both ranks build the same full model, call
    ``deepspeed_tpu_torch.init_inference(model, config={"dtype": ...,
    "tensor_parallel": {"tp_size": TP}}, params=state_dict)`` (AutoTP
    resolves the rules and cuts this rank's blocks) and run one
    ``forward``: the logits' digest, the flash launches, the comms
    logger's bytes, the seconds and peak HBM; rank 0 the gaps to the
    one-rank logits. With ``$DSTPU_SMOKE_TP_FAULTS`` = 1 the planted
    faults of TP_FAULTS follow."""
    import torch.distributed as dist

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    from deepspeed_tpu_torch.comm.mesh import set_global_mesh
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.ops import build
    r = dist.get_rank()
    model = os.environ.get(RANK_MODEL_ENV, "8b")
    dev = _rank_device()
    cfg = tp_serving_cfg(model)
    batch = tp_prompts(cfg, model)
    faults = TP_FAULTS if os.environ.get(TP_FAULTS_ENV) == "1" else ()
    out = {"rank": r, "model": model, "runs": {}}
    ref = None
    set_global_mesh(None)
    if r == 0:
        t = time.monotonic()
        with default_dtype(cfg.dtype):
            m = LlamaForCausalLM(cfg, device=dev, seed=SEED)
        with torch.no_grad():
            ref = m.logits({"input_ids": torch.from_numpy(
                batch["input_ids"]).to(dev)})
        out["reference_seconds"] = time.monotonic() - t
        del m
        _release()
    dist.barrier()
    comms = get_comms_logger()
    comms.configure(enabled=True)
    for fault in (None,) + faults:
        _peak_reset()
        t = time.monotonic()
        with default_dtype(cfg.dtype):
            m = LlamaForCausalLM(cfg, device=dev, seed=SEED)
        out["params"] = sum(p.numel() for p in m.parameters())
        sd = m.state_dict()
        if fault == "kv_wrong_rank":
            sd = _swap_kv_blocks(sd)
        eng = deepspeed_tpu_torch.init_inference(
            m, config={"dtype": "bf16" if model == "8b" else "fp32",
                       "tensor_parallel": {"tp_size": TP}},
            params=sd, device=dev)
        del sd
        _release()
        built = time.monotonic() - t
        held = sum(p.numel() for p in m.parameters())
        comms.reset()
        before = build.launch_counts()
        t = time.monotonic()
        with tp_fault(fault, m):
            logits = eng.forward(batch)
        if dev == "cuda":
            torch.cuda.synchronize()
        seconds = time.monotonic() - t
        after = build.launch_counts()
        run = {"build_seconds": built, "forward_seconds": seconds,
               "held": held, "shape": list(logits.shape),
               "finite": bool(torch.isfinite(logits).all()),
               "launches": {n: after.get(n, 0) - before.get(n, 0)
                            for n in FLASH_PER_STEP},
               "comm": {op: {k: v[k] for k in ("count", "bytes", "seconds")}
                        for op, v in comms.per_op_totals().items()},
               "peak_hbm": _peak(), "digest": _digest(logits)}
        if r == 0:
            run.update(tp_logit_gaps(logits, ref))
        out["runs"][fault or "sound"] = run
        del eng, m, logits
        set_global_mesh(None)
        _release()
    comms.configure(enabled=False)
    out["expected_comm"] = expected_tp_infer_comm(
        cfg, TP_PROMPTS, batch["input_ids"].shape[1],
        torch.empty((), dtype=cfg.dtype).element_size())
    with open(_rank_out(f"tp_infer{r}.json"), "w") as f:
        json.dump(out, f)


def check_tp_infer(rows, flash: bool = True) -> dict:
    """The gates of ``infer_tp_ranks``: finite logits of the whole
    vocabulary, bit-identical on both ranks; rank 0's gaps to the
    one-rank logits within TP_LOGITS_LIMITS and every planted fault's
    outside; num_layers flash forwards a rank (none on the plain
    backend); each rank's ``tensor/*`` bytes as ``expected_tp_infer_comm``
    reckons them; each rank holds half of the sharded leaves. Returns the
    launches summed over the ranks' sound runs."""
    model = rows[0]["model"]
    cfg = tp_serving_cfg(model)
    lim = TP_LOGITS_LIMITS[model]
    sound = [row["runs"]["sound"] for row in rows]
    s0 = sound[0]
    check(all(s["finite"] for s in sound) and s0["shape"][-1] ==
          cfg.vocab_size, f"TP logits not finite or not the whole "
          f"vocabulary: {s0['shape']}")
    check(len({s["digest"] for s in sound}) == 1,
          "the tensor ranks' logits differ")
    for k in lim:
        check(s0[k] <= lim[k], f"TP logits {k} {s0[k]} against the one-rank "
              f"logits, limit {lim[k]}")
    for f, run in rows[0]["runs"].items():
        if f != "sound":
            check(any(run[k] > lim[k] for k in lim), f"planted fault {f}: "
                  f"{ {k: run[k] for k in lim} } inside the limits {lim}")
    want_fwd = cfg.num_layers if flash else 0
    path = {n: 0 for n in FLASH_PER_STEP}
    for row, s in zip(rows, sound):
        check(s["launches"] == {"flash_fwd": want_fwd, "flash_dq": 0,
                                "flash_dkv": 0},
              f"rank {row['rank']}: flash launches {s['launches']}, want "
              f"{want_fwd} forwards")
        got = {op: int(v["bytes"]) for op, v in s["comm"].items()
               if op.startswith("tensor/") and v["count"]}
        check(got == row["expected_comm"], f"rank {row['rank']}: tensor "
              f"bytes {got}, reckoned {row['expected_comm']}")
        check(s["held"] < 0.55 * row["params"], f"rank {row['rank']} holds "
              f"{s['held']} of {row['params']} parameters")
        for n, c in s["launches"].items():
            path[n] += c
    return path


def phase_infer_tp_ranks(dev, smi_line, tmp):
    """Rows of ``tp_infer_body`` (run in the gloo pair of
    ``phase_train_ranks``), gated by ``check_tp_infer``."""
    seconds = _body_seconds(tmp, "tp_infer_body")
    rows = _read_ranks("tp_infer", tmp)
    r0 = rows[0]["runs"]
    # the readings first: a gate that fails still leaves them
    emit({"phase": "infer_tp_ranks_readings",
          "gaps": {f: {k: r.get(k) for k in ("rel_l2", "argmax_moved")}
                   for f, r in r0.items()}})
    path = check_tp_infer(rows)
    emit({"phase": "infer_tp_ranks", "model": "LLAMA3_8B full width and "
          f"depth, bf16, flash, init_inference tp_size={TP} (AutoTP) over "
          f"gloo on one card, {TP_PROMPTS} prompts x {TP_PROMPT_LEN}",
          "seconds": seconds,
          "reference_seconds": rows[0].get("reference_seconds"),
          "limits": TP_LOGITS_LIMITS["8b"],
          "runs": {f: {k: r[k] for k in (
              "rel_l2", "argmax_moved", "forward_seconds", "build_seconds",
              "launches", "peak_hbm", "held") if k in r}
              for f, r in r0.items()},
          "peak_hbm": [row["runs"]["sound"]["peak_hbm"] for row in rows],
          "comm": r0["sound"]["comm"], "expected_comm":
          rows[0]["expected_comm"], "launches": path, "card": dev["kind"],
          "nvidia_smi": smi_line})
    return path


def tp_train_config(layers, model="8b"):
    """The training recipe at stage 3 over ``fsdp`` 2 x ``tensor`` 2 on
    ZPP_BATCH sequences a step (micro 2 x gas 2 x 2 batch ranks: the
    global batch of the phase's other variants)."""
    cfg, ds = _zero_recipe(3, layers, model)
    ds.update(train_batch_size=ZPP_BATCH,
              mesh={"fsdp": ZPP_RANKS // TP, "tensor": TP, "data": 1})
    return cfg, ds


def expected_tp_comm(engine, gas: int, rows: int, seq: int,
                     remat: bool = True) -> dict:
    """The comms logger's bytes a step a rank at ``fsdp`` x ``tensor``,
    stage 3, from the shapes. A micro-batch of ``rows`` x ``seq`` tokens
    sums the embedding's rows (``tensor/embed``) and two row-parallel
    outputs a layer (``tensor/reduce``; remat's recompute sums the
    attention's again and stops before the MLP's, whose output no
    backward needs) in the hidden dtype, sums dX over ``tensor`` before the column-parallel
    products in the backward (``tensor/copy``: two a layer and the
    head's), and takes the vocab-parallel loss's max, sum and target over
    the next-token positions in fp32 (``tensor/vocab_ce``); the ZeRO
    gathers and reduce-scatters of each sharded leaf's tensor block over
    ``fsdp`` in the compute dtype (twice a micro-batch for a layer's leaf
    under remat), the replicated leaves' fp32 all-reduce over ``fsdp``,
    and each step's loss and norm all-reduces (the norm's over ``fsdp``
    and over ``tensor``)."""
    cfg = engine.model.cfg
    cdt = torch.empty((), dtype=engine.compute_dtype).element_size()
    hdt = torch.empty((), dtype=cfg.dtype).element_size()
    fs = engine.mesh.shape["fsdp"]
    hidden = rows * seq * cfg.hidden_size * hdt
    layers = cfg.num_layers
    e = {"tensor/embed/all_reduce": hidden * gas,
         "tensor/reduce/all_reduce": (3 if remat else 2) * layers * hidden
         * gas,
         "tensor/copy/all_reduce": (2 * layers + 1) * hidden * gas,
         "tensor/vocab_ce/all_reduce": 3 * rows * (seq - 1) * 4 * gas}
    ag = rs = ar = sharded = 0
    for i, name in enumerate(engine._param_names):
        n = engine._masters[i].numel()        # this rank's block
        if engine._param_dim[i] is None:
            ar += n * 4 * gas
            continue
        sharded += 1
        uses = 2 if remat and ".layer_" in name else 1
        ag += n * cdt * uses * gas
        rs += n * fs * cdt * gas
    tensor_sharded = sum(d is not None for d in engine._tensor_dim)
    e.update({"all_gather": ag, "reduce_scatter": rs,
              "all_reduce": ar + 4 + 4 * sharded + 4 * tensor_sharded})
    return e


def _replicated_digest(engine) -> str:
    """One digest of every master ``tensor`` does not shard (the norm
    scales; under stage 3 this rank's fsdp block of them), the same bits
    on every tensor rank of an fsdp group."""
    import hashlib
    h = hashlib.sha256()
    for m, t in zip(engine._masters, engine._tensor_dim):
        if t is None:
            h.update(m.detach().cpu().contiguous().view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def _tp_run(variant, layers, model, batch, ref, comms, on_card, fault=None):
    """``tp_zero3`` (or one of TP_TRAIN_FAULTS planted in it) on this rank of the four: ZPP_STEPS steps of the recipe at
    stage 3 over fsdp 2 x tensor 2; per step the loss, norm, flash
    launches, the comms logger's bytes and the replicated masters'
    digest; the state bytes, the peak HBM, and the share of masters apart
    from the stage-0 reference's after the last step."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    import deepspeed_tpu_torch
    r = dist.get_rank()
    gas = TRAIN_GAS
    cfg, ds = tp_train_config(layers, model)
    _peak_reset()
    t = time.monotonic()
    m = LlamaForCausalLM(cfg, device=_rank_device(), seed=SEED)
    with tp_fault(fault, m) if fault == "copy_dropped" \
            else contextlib.nullcontext():
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=m, config=ds, device=_rank_device())
        seconds = {"build": time.monotonic() - t}
        rows = batch["input_ids"].shape[1] // engine.dp_world_size
        run = {**_state_bytes(engine),
               "held": sum(x.numel() for x in engine._masters),
               "params": sum(math.prod(s)
                             for s in engine._full_shapes.values()),
               "coords": {a: engine.mesh.coords[a]
                          for a in ("fsdp", "tensor")},
               "tensor_dims": engine._tensor_dim,
               "param_dims": engine._param_dim,
               "expected_comm_per_step": expected_tp_comm(
                   engine, gas, rows, batch["input_ids"].shape[2],
                   cfg.remat),
               "expected_launches_per_step": {
                   n: (k * layers * gas
                       if on_card and cfg.attention_backend == "flash"
                       else 0) for n, k in FLASH_PER_STEP.items()}}
        comms.reset()
        t = time.monotonic()
        steps = []
        with tp_fault(fault, engine=engine) if fault == "norm_all_tensor" \
                else contextlib.nullcontext():
            for _ in range(ZPP_STEPS):
                steps += _rank_steps(engine, batch, 1, comms)
                steps[-1]["replicated_digest"] = _replicated_digest(engine)
        seconds["steps"] = time.monotonic() - t
    run["steps"] = steps
    run["peak_hbm"] = _peak()
    t = time.monotonic()
    run["masters_share"], run["masters_max_abs"] = _blocks_apart(
        engine, ZPP_REF_STEM, MASTERS_ATOL_LR * _recipe_lr(model))
    seconds["masters"] = time.monotonic() - t
    if r == 0:
        run["loss_gap"] = max(abs(s["loss"] - a)
                              for s, a in zip(steps, ref[0]))
        run["grad_norm_gap"] = max(abs(s["grad_norm"] - a)
                                   for s, a in zip(steps, ref[1]))
    run["seconds"] = seconds
    del engine, m
    _release()
    return run


def tp_train_gaps(runs) -> dict:
    """tp_zero3's and each planted training fault's (those in ``runs``)
    distance from the stage-0 reference: the largest loss and norm gap
    over the steps, the share of masters apart after the last step."""
    return {v: {k: runs[v][k] for k in ("loss_gap", "grad_norm_gap",
                                         "masters_share")}
            for v in ("tp_zero3", *(f"tp_zero3_{f}" for f in TP_TRAIN_FAULTS))
            if v in runs}


def check_tp_train_faults(rows) -> dict:
    """Each planted training fault caught by the gate that stands for it:
    ``norm_all_tensor`` moves a step's norm past TP_TRAIN_LIMITS,
    ``copy_dropped`` splits the replicated masters of each fsdp group
    between its tensor ranks. Returns the faults' gaps."""
    gaps = tp_train_gaps(rows[0]["runs"])
    lim = TP_TRAIN_LIMITS[rows[0]["model"]]
    check(gaps["tp_zero3_norm_all_tensor"]["grad_norm_gap"] > lim["grad_norm"],
          "norm_all_tensor: the norm stayed within its limit "
          f"({gaps['tp_zero3_norm_all_tensor']}, limits {lim})")
    digests = {}
    for row in rows:
        run = row["runs"]["tp_zero3_copy_dropped"]
        digests.setdefault(run["coords"]["fsdp"], set()).add(
            run["steps"][-1]["replicated_digest"])
    check(all(len(d) == TP for d in digests.values()),
          "copy_dropped: the replicated masters stayed equal on the tensor "
          "ranks")
    return gaps


def check_tp_ranks(rows) -> dict:
    """The gates of ``train_tp_ranks``: each step's loss and norm and the
    masters' share apart after the last step within TP_TRAIN_LIMITS of
    the stage-0 reference; every rank's losses and norms equal; the replicated
    masters the same bits on the two tensor ranks of each fsdp group
    after every step; flash launches a rank and step exact; every op's
    bytes a step as ``expected_tp_comm`` reckons them; each rank's
    masters and moments a quarter of stage 0's (the leaves both axes
    divide). Returns the launches summed over ranks and steps."""
    path = {}
    tol = TP_TRAIN_LIMITS[rows[0]["model"]]
    for variant in TP_VARIANTS:
        r0 = rows[0]["runs"][variant]
        groups = {}
        for row in rows:
            run = row["runs"][variant]
            check([(s["loss"], s["grad_norm"]) for s in run["steps"]] ==
                  [(s["loss"], s["grad_norm"]) for s in r0["steps"]],
                  f"{variant}: rank {row['rank']}'s losses or norms differ "
                  "from rank 0's")
            groups.setdefault(run["coords"]["fsdp"], []).append(
                [s["replicated_digest"] for s in run["steps"]])
            share = (run["masters"] + run["moments"]) / (12 * run["params"])
            check(share < 0.3, f"{variant} rank {row['rank']}: masters and "
                  f"moments {share} of stage 0's")
            for k, s in enumerate(run["steps"]):
                got = {op: int(t["bytes"]) for op, t in s["comm"].items()
                       if t["count"]}
                check(got == run["expected_comm_per_step"],
                      f"{variant} rank {row['rank']} step {k}: comm bytes "
                      f"{got}, expected {run['expected_comm_per_step']}")
                want = run["expected_launches_per_step"]
                launched = {n: s["launches"].get(n, 0) for n in want}
                check(launched == want, f"{variant} rank {row['rank']} step "
                      f"{k}: launches {launched}, expected {want}")
                for n, c in launched.items():
                    path[n] = path.get(n, 0) + c
        for f, digests in groups.items():
            check(len(digests) == TP and digests[0] == digests[1],
                  f"{variant}: the replicated masters of fsdp group {f} "
                  "differ between its tensor ranks")
        check(r0["masters_share"] <= tol["masters_share"],
              f"{variant}: a share {r0['masters_share']} of the masters "
              f"apart from the stage-0 run's, limit "
              f"{tol['masters_share']}")
        check(r0["loss_gap"] <= tol["loss"], f"{variant}: losses "
              f"{r0['loss_gap']} from stage 0, limit {tol['loss']}")
        check(r0["grad_norm_gap"] <= tol["grad_norm"],
              f"{variant}: gradient norms {r0['grad_norm_gap']} from stage "
              f"0, limit {tol['grad_norm']}")
    return path


# qwZ's primary blocks at fsdp_out 2 x fsdp 2 (a quarter of each leaf): the
# head cut along its last axis (given-scale codes), the embedding along its
# first, and the gathered secondary blocks the dequantize writes
def qwz_timing_shapes(cfg):
    v, d = cfg.vocab_size, cfg.hidden_size
    return {"lm_head_block": (d, v // ZPP_RANKS),
            "embed_block": (v // ZPP_RANKS, d),
            "lm_head_secondary": (d, v // 2),
            "embed_secondary": (v // 2, d)}


def _qwz_kernel_timing(cfg) -> dict:
    """``quantize_int8``, ``quantize_int8_scaled`` and ``dequantize_int8``
    at qwZ's bf16 block shapes (``qwz_timing_shapes``): profiler device
    time of the exact entries, the plain version's, the bytes bound; each
    output bit for bit the plain version's."""
    from deepspeed_tpu_torch.ops.quant import (dequantize_int8,
                                               dequantize_plain,
                                               quantize_int8,
                                               quantize_int8_plain,
                                               quantize_int8_scaled,
                                               quantize_int8_scaled_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    shapes = qwz_timing_shapes(cfg)
    out = {}
    bf = torch.bfloat16
    for where in ("lm_head_block", "embed_block"):
        n, d = shapes[where]
        x = torch.randn(n, d, generator=gen, device="cuda").to(bf)
        q, s = quantize_int8(x)
        q_p, s_p = quantize_int8_plain(x)
        check(_differs(q, q_p) + _differs(s, s_p) == 0,
              f"quantize_int8 at qwZ's {where} {[n, d]} differs from plain")
        calls = [("quantize_int8", lambda: quantize_int8(x),
                  lambda: quantize_int8_plain(x), x.numel() * 3 + n * 4)]
        if where == "lm_head_block":
            g = s * 1.5                    # a wider row's scale, as qwZ's max
            qs = quantize_int8_scaled(x, g)
            check(_differs(qs, quantize_int8_scaled_plain(x, g)) == 0,
                  f"quantize_int8_scaled at {where} differs from plain")
            calls.append(("quantize_int8_scaled",
                          lambda: quantize_int8_scaled(x, g),
                          lambda: quantize_int8_scaled_plain(x, g),
                          x.numel() * 3 + n * 4))
        for name, fn, plain, nbytes in calls:
            bound_ms, bound_by = _quant_bound(nbytes)
            ms, entries = _stem_entries_ms(fn, name, iters=20)
            out.setdefault(name, {})[where] = {
                "ms": ms, "entries": entries, "plain_ms": time_ms(plain, 3),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "bytes": nbytes}
        del x, q, s, q_p, s_p
    for where in ("lm_head_secondary", "embed_secondary"):
        n, d = shapes[where]
        q = torch.randint(-127, 128, (n, d), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand(n, 1, generator=gen, device="cuda") * 1e-3
        check(_differs(dequantize_int8(q, s, bf),
                       dequantize_plain(q, s, bf)) == 0,
              f"dequantize_int8 at qwZ's {where} differs from plain")
        nbytes = q.numel() * 3 + n * 4
        bound_ms, bound_by = _quant_bound(nbytes)
        ms, entries = _stem_entries_ms(lambda: dequantize_int8(q, s, bf),
                                       "dequantize_int8", iters=20)
        out.setdefault("dequantize_int8", {})[where] = {
            "ms": ms, "entries": entries,
            "plain_ms": time_ms(lambda: dequantize_plain(q, s, bf), 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "bytes": nbytes}
        del q, s
    torch.cuda.empty_cache()
    return out


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
    return launches, {"losses": losses}


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
    layers = int(os.environ.get(MOE_LAYERS_ENV, os.environ.get(
        "DSTPU_SMOKE_LAYERS", MOE_TRAIN_LAYERS)))
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
            # kept on the card (7 GB a set at 1 layer): the comparisons
            # need no host round trip
            masters = [m.detach().clone() for _, m in engine.named_masters()]
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
                got.append(m.detach())
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


# train_moe_ranks' depth: cut from MOE_TRAIN_LAYERS to 1 to keep the smoke
# inside its time limit beside train_zeropp_ranks (width is never cut)
MOE_RANK_LAYERS = 1
MOE_LAYERS_ENV = "DSTPU_SMOKE_MOE_LAYERS"   # else $DSTPU_SMOKE_LAYERS


def plan_moe_rank_layers():
    """MOE_RANK_LAYERS when two ranks' peaks fit the card's free memory,
    else 1 (depth is cut, never width)."""
    _release()
    free, _ = torch.cuda.mem_get_info()
    for layers in (MOE_RANK_LAYERS, 1):
        cfg_l, _ = moe_train_config(layers)
        need = RANKS * (MOE_RANK_BYTES * moe_params(cfg_l, EP) +
                        MOE_RANK_ACTIVATIONS)
        if need <= free:
            return layers, free, need
    return 1, free, need


def phase_train_moe_ranks(dev, smi_line, tmp, spawn):
    """Two processes on the one card over gloo, mesh ``expert=2`` (each
    rank 4 of the 8 experts): dense against the one-rank reference within
    twice the distance of the same sequences batched otherwise, replicated
    masters the same bytes on both ranks, half the expert state a rank;
    then with ``quantized_dispatch``: exactly MOE_QUANT_PER_COMBINE x
    layers x gas int8 quantize and dequantize launches a step (the remat
    recompute stops before the combine), step 1's layer-0 combine bit for
    bit the plain codec's; the combine and expert-grad bytes a step beside
    the count from [T, D] and [T, K]. The rows of ``phase_train_ranks``."""
    layers, free, need = spawn["moe"]
    spawner = spawn["spawner_hbm"]
    seconds = _body_seconds(tmp, "moe_ranks_body")
    rows = _read_ranks("moe_ranks", tmp)
    path, int8_path = check_moe_ranks(rows, layers)
    cfg, _ = moe_train_config(layers)
    c = cfg.moe.num_experts // EP * _capacity_of(cfg) * cfg.base.hidden_size
    r0 = rows[0]
    cut = f" (cut from {MOE_TRAIN_LAYERS} for the time limit)" \
        if layers == MOE_RANK_LAYERS < MOE_TRAIN_LAYERS else \
        f" (cut from {MOE_RANK_LAYERS}: two ranks did not fit)" \
        if layers < MOE_RANK_LAYERS else ""
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
# ---------------------------------------------------------------------------
# sequence parallelism: train_sp and train_chunked_loss
# ---------------------------------------------------------------------------
SP = 2                             # train_sp's sequence ranks, one card
SP_VARIANTS = ("ulysses", "ring", "ring_contiguous", "ring_chunked_loss")
SP_FAULT = "ulysses_local_positions"   # the planted fault: rope at arange(S_l)
# of 32: 1.27 B parameters (cut from 2 beside train_zeropp_ranks, for the
# smoke's time limit)
SP_LAYERS = 1
SP_SEQ = 8192                      # tokens a step, over the SP ranks
SP_SEQ_CUT = 4096                  # if SP_SEQ does not fit beside two ranks
SP_STEPS = 1                       # train_batch steps of each variant
#                                    (2 before train_zeropp_ranks)
SP_LOSS_CHUNK = 1024               # train_chunked_loss and ring_chunked_loss
SP_TIMEOUT = 900                   # seconds the spawned pair may take
# a rank's bytes a parameter at its peak (fp32 master, Adam's two moments,
# the fp32 gradient, its bf16 accumulator and the bf16 casts of the
# weights) and the fp32 [S_l, V] copies of the dense loss (logits, their
# log-softmax, its gradient): the plan of SP_SEQ against the free memory
SP_STATE_BYTES = 20
SP_LOGIT_COPIES = 3
# step 1's loss and gradient norm, each variant against the one-rank run
# on the same weights and tokens (absolute loss, relative norm): four times
# the largest distance of the four variants measured on an H100 80GB HBM3
# at 700 W (loss 8.2e-5 for both rings and the chunked loss, norm 3.9e-5
# relative for the chunked loss, 1.7e-5 for the contiguous ring); the
# planted fault landed at 7.2e-3 and 1.4e-3 (PERF.md)
SP_LOSS_TOL = 4e-4
SP_NORM_TOL = 2e-4
# train_chunked_loss: the chunked loss against the dense one, step 1
CHUNK_LOSS_REL = 1e-4
CHUNK_NORM_REL = 1e-3


def sp_train_config(variant, seq, layers=SP_LAYERS):
    """``train_config()``'s Llama-3-8B recipe (bf16, remat, AdamW 3e-4) at
    ``layers`` layers, one sequence of ``seq`` tokens a step (micro-batch
    1, gas 1), for a train_sp variant: ``one_rank`` (the flash backend on
    one rank, the reference), Ulysses or the ring over ``SP`` sequence
    ranks, the last with the chunked loss."""
    import dataclasses
    cfg, ds = train_config()
    backend = "flash" if variant == "one_rank" else \
        "ulysses" if variant.startswith("ulysses") else "ring"
    cfg = dataclasses.replace(
        cfg, num_layers=layers, max_seq_len=seq, attention_backend=backend,
        loss_chunk_size=SP_LOSS_CHUNK if variant == "ring_chunked_loss"
        else None)
    ds.update(train_batch_size=1, gradient_accumulation_steps=1,
              mesh={"data": 1, "sequence": 1 if variant == "one_rank"
                    else SP})
    return cfg, ds


def sp_batch(cfg, seq, local_positions=False):
    """The seeded sequence of ``seq`` tokens; with ``local_positions`` (the
    planted fault) positions ``arange(seq / SP)`` on every rank's block."""
    from deepspeed_tpu_torch.models.llama import random_tokens
    batch = random_tokens(1, seq, vocab_size=cfg.vocab_size, seed=SEED)
    if local_positions:
        batch["positions"] = np.tile(np.arange(seq // SP, dtype=np.int32),
                                     SP)[None]
    return batch


def sp_flash_per_step(variant, layers, sp, rank, gas=1, remat=True):
    """The flash launches of one train_sp step on sequence rank ``rank``:
    a layer's attention runs once in the forward and again in the remat
    recompute (the recompute reruns the whole block: the last tensor the
    backward needs is w_down's input), and once backward. Ulysses runs one
    block over the gathered sequence; the striped ring ``sp`` blocks; the
    contiguous causal ring ``rank + 1`` (the diagonal and the earlier
    ranks' blocks)."""
    blocks = 1 if variant == "ulysses" else \
        rank + 1 if variant == "ring_contiguous" else sp
    n = layers * gas * blocks
    return {"flash_fwd": n * (2 if remat else 1), "flash_dq": n,
            "flash_dkv": n}


def sp_comm_bytes_per_step(variant, layers, sp, b, s_l, h, hkv, d, elem,
                           gas=1):
    """The comms logger's ``sequence/*`` bytes of one train_sp step on
    every rank (an op's bytes are its input's): q/out ``Q`` and k/v ``KV``
    bytes of a rank's shard, the ring's fp32 dK/dV accumulators ``KV32``.
    Ulysses: the q, k, v and output all-to-alls in the forward, the
    recompute and the backward, 3 (2Q + 2KV) a layer. Ring: ``sp - 1`` K/V
    hops in the forward and the recompute (the last hop, which would only
    bring K/V home, is skipped), ``sp - 1`` again and ``sp`` dK/dV hops in
    the backward; striped, the three stripes and the unstripe, 3 (2Q +
    2KV) a layer. The loss's token count: one fp32 a micro-batch."""
    q = b * s_l * h * d * elem
    kv = b * s_l * hkv * d * elem
    kv32 = b * s_l * hkv * d * 4
    n = layers * gas
    out = {"sequence/loss/all_reduce": 4 * gas}
    if variant == "ulysses":
        out["sequence/ulysses/all_to_all"] = n * 3 * (2 * q + 2 * kv)
        return out
    hops = 2 * kv * (sp - 1)
    out["sequence/ring/ppermute"] = n * (3 * hops + 2 * sp * kv32)
    if variant != "ring_contiguous":
        out["sequence/stripe/all_to_all"] = n * 3 * (2 * q + 2 * kv)
    return out


class _PlainFlash(torch.autograd.Function):
    """Causal attention through the flash kernels' plain mirrors, forward
    and backward: Ulysses' plain version on the card."""

    @staticmethod
    def forward(ctx, q, k, v):
        from deepspeed_tpu_torch.ops.flash_attention import flash_fwd_plain
        out, lse = flash_fwd_plain(q, k, v, causal=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        from deepspeed_tpu_torch.ops.flash_attention import flash_bwd_plain
        return flash_bwd_plain(*ctx.saved_tensors[:5], do.contiguous(),
                               causal=True)


def _sp_case(fn, args, do):
    """(out, dq, dk, dv) of ``fn`` on fresh leaves of ``args``."""
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*leaves)
    out.backward(do)
    return [out.detach()] + [x.grad for x in leaves]


def sp_attention_checks(s_l, device="cuda"):
    """On this rank of the sequence ranks, at a rank's shard of train_sp's
    attention (B=1, S_l, H=32, Hkv=8, d=128, causal, bf16): the striped and
    the contiguous flash rings and Ulysses through the kernels against the
    same calls through the plain mirrors (``impl="interpret"``; Ulysses
    with a custom attention over ``flash_fwd_plain`` / ``flash_bwd_plain``),
    forward and backward. Each row of out, dQ, dK and dV within BF16_ULPS
    ulps of its largest |plain| value for each ring block its result may
    sum (a block's result carries the kernel's difference, and the combine
    and the accumulators add them: ``sp`` for the rings, one for Ulysses);
    the dQ row of global position 0, whose one live key makes its exact dQ
    0, within twice ``_dq_one_key_rows``' rounding bound (each side is
    within one of 0); and the plain striped ring with its last step dropped
    outside the tolerance."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.sequence import ring, ulysses
    r, sp = dist.get_rank(), dist.get_world_size()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 11)
    h, hkv, d, s = 32, 8, 128, s_l * sp

    def shard(*shape):
        x = torch.randn(1, s, *shape, generator=gen, device=device)
        return x[:, r * s_l:(r + 1) * s_l].to(torch.bfloat16).contiguous()
    q, k, v, do = shard(h, d), shard(hkv, d), shard(hkv, d), shard(h, d)
    # rank 0's local causal mask gives row 0 one key, as the global one does
    one, bound = _dq_one_key_rows((q, k, v, do), None, {"causal": True})
    with ring.default_impl(None):
        cases = {
            "ring_striped": (
                lambda *a: ring.ring_attention(*a, impl="flash"),
                lambda *a: ring.ring_attention(*a, impl="interpret"), sp),
            "ring_contiguous": (
                lambda *a: ring.ring_attention(*a, impl="flash_contiguous"),
                lambda *a: ring.ring_attention(
                    *a, impl="interpret_contiguous"), sp),
            "ulysses": (ulysses.ulysses_attention,
                        lambda *a: ulysses.ulysses_attention(
                            *a, attn_fn=_PlainFlash.apply), 1)}
        out = {}
        for name, (kernel, plain, blocks) in cases.items():
            got = _sp_case(kernel, (q, k, v), do)
            want = _sp_case(plain, (q, k, v), do)
            tols = [blocks * _row_tol(w) for w in want]
            if r == 0:
                tols[1] = torch.where(one[..., None], 2 * bound[..., None],
                                      tols[1])
            out[name] = {
                "blocks": blocks,
                "err_over_tol": {n: _err_ratio(g, w, t) for n, g, w, t in
                                 zip(("out", "dq", "dk", "dv"), got, want,
                                     tols)},
                "max_abs_err": {n: _max_err(g, w, n) for n, g, w in
                                zip(("out", "dq", "dk", "dv"), got, want)},
                "finite": all(bool(torch.isfinite(g).all()) for g in got)}
            if name == "ring_striped":
                step_block = ring.step_block
                last = (r + 1) % sp        # the block of the ring's last step
                ring.step_block = lambda mode, src, idx: (
                    None if src == last else step_block(mode, src, idx))
                try:
                    mutant = _sp_case(plain, (q, k, v), do)
                finally:
                    ring.step_block = step_block
                out[name]["last_step_dropped"] = _err_ratio(
                    mutant[0], want[0], tols[0])
            del got, want
    return out


def sp_checks_body():
    """One rank of the gpu test's ring and Ulysses checks (``$DSTPU_SMOKE_SEQ``
    tokens over the ranks); writes ``sp_checks{r}.json``."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm.mesh import create_mesh, set_global_mesh
    from deepspeed_tpu_torch.config.config import MeshConfig
    r, w = dist.get_rank(), dist.get_world_size()
    set_global_mesh(create_mesh(MeshConfig(data=1, sequence=w),
                                device=_rank_device()))
    checks = sp_attention_checks(int(os.environ["DSTPU_SMOKE_SEQ"]) // w,
                                 _rank_device())
    with open(_rank_out(f"sp_checks{r}.json"), "w") as f:
        json.dump(checks, f)


def check_sp_attention(checks):
    for name, c in checks.items():
        check(c["finite"], f"{name}: a non-finite output")
        for n, ratio in c["err_over_tol"].items():
            check(ratio <= 1.0, f"{name}: {n} kernel vs plain at {ratio} "
                  "times its tolerance")
        if "last_step_dropped" in c:
            check(c["last_step_dropped"] > 1.0, f"{name}: the ring with its "
                  "last step dropped lands within the tolerance "
                  f"({c['last_step_dropped']})")


def sp_ranks_body():
    """One rank of ``train_sp`` (spawned over gloo on the card): the ring
    and Ulysses checks at a rank's shard (``sp_attention_checks``), then
    each SP_VARIANTS run, SP_STEPS steps on the one seeded sequence of
    ``$DSTPU_SMOKE_SEQ`` tokens, and the planted fault one step: each
    step's loss, gradient norm, launches, the comms logger's bytes and
    seconds of each op and the step's host ms, and the run's peak HBM."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    from deepspeed_tpu_torch.comm.mesh import create_mesh, set_global_mesh
    from deepspeed_tpu_torch.config.config import MeshConfig
    from deepspeed_tpu_torch.ops import build
    from deepspeed_tpu_torch.sequence import ring
    r = dist.get_rank()
    seq = int(os.environ["DSTPU_SMOKE_SEQ"])
    set_global_mesh(create_mesh(MeshConfig(data=1, sequence=SP),
                                device=_rank_device()))
    _peak_reset()
    out = {"rank": r, "seq": seq,
           "checks": sp_attention_checks(seq // SP, _rank_device()),
           "checks_peak_hbm": _peak(), "runs": {}}
    _release()
    comms = get_comms_logger()
    comms.configure(enabled=True)
    for variant in SP_VARIANTS + (SP_FAULT,):
        cfg, ds = sp_train_config(variant, seq)
        _peak_reset()
        engine = _engine(cfg, ds)
        batch = sp_batch(cfg, seq, local_positions=variant == SP_FAULT)
        comms.reset()
        impl = "flash_contiguous" if variant == "ring_contiguous" else None
        with ring.default_impl(impl):
            build.reset_launch_counts()   # the main path's run starts here
            steps = _rank_steps(engine, batch,
                                1 if variant == SP_FAULT else SP_STEPS, comms)
            path = build.launch_counts()
        out["runs"][variant] = {"steps": steps, "path": path,
                                "peak_hbm": _peak()}
        del engine
        _release()
    comms.configure(enabled=False)
    with open(_rank_out(f"sp_ranks{r}.json"), "w") as f:
        json.dump(out, f)


def plan_sp_seq():
    """SP_SEQ when two ranks' planned peaks fit the card's free memory,
    else SP_SEQ_CUT (the sequence is cut, never the width)."""
    _release()
    free, _ = torch.cuda.mem_get_info()
    cfg, _ = sp_train_config("ulysses", SP_SEQ)
    params = llama_params(cfg, SP_LAYERS)
    for seq in (SP_SEQ, SP_SEQ_CUT):
        need = SP * (SP_STATE_BYTES * params + SP_LOGIT_COPIES * 4 *
                     seq // SP * cfg.vocab_size)
        if need <= free:
            return seq, free, need
    return SP_SEQ_CUT, free, need


def phase_sp_flash_timing(dev, smi_line, seq=SP_SEQ):
    """The flash kernels by the profiler's device time at train_sp's
    blocks: the ring's striped block from a later rank (S_l = seq / SP,
    causal, causal_shift 1), a full block (the contiguous ring's earlier
    step) and Ulysses' gathered sequence (S = seq, H / SP heads, causal),
    each beside its bound. Run beside the other flash timings, early in
    the smoke."""
    from deepspeed_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 12)
    s_l = seq // SP
    shapes = {"ring_block_shift1": (s_l, 32, 8, dict(causal=True,
                                                     causal_shift=1)),
              "ring_block_full": (s_l, 32, 8, dict(causal=False)),
              "ulysses_local": (seq, 32 // SP, 8 // SP, dict(causal=True))}
    names = {"flash_fwd": "flash_fwd_kernel", "flash_dq": "flash_dq_kernel",
             "flash_dkv": "flash_dkv_kernel"}
    rows = {}
    for label, (s, h, hkv, opts) in shapes.items():
        (q, k, v, do), _ = _flash_inputs(gen, 1, s, h, hkv, 128,
                                         torch.bfloat16)
        out, lse = flash_fwd(q, k, v, **opts)
        ms = _kernel_device_ms(lambda: flash_fwd(q, k, v, **opts),
                               [names["flash_fwd"]], iters=10)
        ms.update(_kernel_device_ms(
            lambda: flash_bwd(q, k, v, out, lse, do, **opts),
            [names["flash_dq"], names["flash_dkv"]], iters=10))
        _, fwd_b, dq_b, dkv_b = _flash_work(1, s, h, hkv, 128, 2)
        pairs = h * (s * s if not opts["causal"] else
                     s * (s + 1) // 2 - opts.get("causal_shift", 0) * s)
        mm = 2 * pairs * 128
        bounds = {"flash_fwd": _bound(2 * mm, fwd_b),
                  "flash_dq": _bound(3 * mm, dq_b),
                  "flash_dkv": _bound(4 * mm, dkv_b)}
        rows[label] = {n: {"ms": ms[e], "bound_ms": bounds[n][0],
                           "bound_by": bounds[n][1],
                           "share_of_bound": bounds[n][0] / ms[e]}
                       for n, e in names.items()}
        del q, k, v, do, out, lse
    emit({"phase": "train_sp_flash_timing", "seq": seq, "sp": SP,
          "blocks": rows, "card": dev["kind"], "nvidia_smi": smi_line,
          "notes": "profiler device time of each kernel's entry; bounds "
                   "count the live (row, key) pairs of the block's mask"})
    return rows


def phase_tp_flash_timing(dev, smi_line):
    """The flash kernels by the profiler's device time at a tensor rank's
    shape of the training recipe (B=1, S=TRAIN_SEQ, H=32/TP, Hkv=8/TP,
    d=128, causal, bf16), beside their bounds and one SDPA call's device
    time (forward; backward: dq, dk, dv) on the same inputs."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    b, s, h, hkv, d = 1, TRAIN_SEQ, 32 // TP, 8 // TP, 128
    (q, k, v, do), _ = _flash_inputs(gen, b, s, h, hkv, d, torch.bfloat16)
    out, lse = flash_fwd(q, k, v, causal=True)
    ms = _kernel_device_ms(lambda: flash_fwd(q, k, v, causal=True),
                           ["flash_fwd_kernel"], iters=20)
    ms.update(_kernel_device_ms(
        lambda: flash_bwd(q, k, v, out, lse, do, causal=True),
        ["flash_dq_kernel", "flash_dkv_kernel"], iters=10))
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(      # noqa: E731
        qs, ks, vs, is_causal=True, enable_gqa=True)
    sdpa_fwd = _call_device_ms(sdpa, iters=20)
    o_sdpa = sdpa()
    g = do.transpose(1, 2)
    sdpa_bwd = _call_device_ms(lambda: torch.autograd.grad(
        o_sdpa, (qs, ks, vs), g, retain_graph=True), iters=20)
    pairs, fwd_b, dq_b, dkv_b = _flash_work(b, s, h, hkv, d, 2)
    mm = 2 * pairs * d
    bounds = {"flash_fwd": _bound(2 * mm, fwd_b),
              "flash_dq": _bound(3 * mm, dq_b),
              "flash_dkv": _bound(4 * mm, dkv_b)}
    names = {"flash_fwd": "flash_fwd_kernel", "flash_dq": "flash_dq_kernel",
             "flash_dkv": "flash_dkv_kernel"}
    rows = {n: {"ms": ms[e], "bound_ms": bounds[n][0],
                "bound_by": bounds[n][1],
                "share_of_bound": bounds[n][0] / ms[e],
                "library_ms": sdpa_fwd if n == "flash_fwd" else sdpa_bwd}
            for n, e in names.items()}
    emit({"phase": "tp_flash_timing",
          "shape": f"B=1 S={s} H={h} Hkv={hkv} d={d} causal bf16 "
                   f"(a tensor rank of {TP})", "kernels": rows,
          "card": dev["kind"], "nvidia_smi": smi_line,
          "notes": "profiler device time of each kernel's entry; "
                   "library_ms one SDPA call's kernels (backward: dq, dk, "
                   "dv together)"})
    del q, k, v, do, out, lse, qs, ks, vs, o_sdpa
    return rows


def _sp_reference(seq):
    """The one-rank run (the flash backend on this process's card) of the
    train_sp recipe on the same weights and sequence: step 1's loss and
    gradient norm, its host ms and peak HBM; its memory freed after."""
    cfg, ds = sp_train_config("one_rank", seq)
    _release()
    torch.cuda.reset_peak_memory_stats()
    engine = _engine(cfg, ds, mesh=_world1_mesh())
    t0 = time.monotonic()
    loss = engine.train_batch(batch=sp_batch(cfg, seq)).item()
    ms = (time.monotonic() - t0) * 1e3
    ref = {"loss": loss, "grad_norm": engine.get_global_grad_norm(),
           "step_ms": ms, "peak_hbm": torch.cuda.max_memory_allocated()}
    del engine
    _release()
    return ref


def check_sp_ranks(rows, ref, seq, layers=SP_LAYERS):
    """Every rank's train_sp results against the one-rank run ``ref`` and
    the formulas; returns (flash launches over the variants, each
    variant's step-1 gaps, the fault's)."""
    from deepspeed_tpu_torch.models.llama import LLAMA3_8B
    cfg = LLAMA3_8B
    gaps, path = {}, {}
    for variant in SP_VARIANTS + (SP_FAULT,):
        first = rows[0]["runs"][variant]["steps"][0]
        gaps[variant] = {
            "loss": abs(first["loss"] - ref["loss"]),
            "grad_norm_rel": abs(first["grad_norm"] - ref["grad_norm"])
            / ref["grad_norm"]}
    for row in rows:
        r = row["rank"]
        check_sp_attention(row["checks"])
        for variant in SP_VARIANTS:
            run = row["runs"][variant]
            r0 = rows[0]["runs"][variant]["steps"]
            check([(s["loss"], s["grad_norm"]) for s in run["steps"]] ==
                  [(s["loss"], s["grad_norm"]) for s in r0],
                  f"{variant}: rank {r}'s losses or norms differ from "
                  "rank 0's")
            check(all(math.isfinite(s["loss"]) for s in run["steps"]),
                  f"{variant}: losses {[s['loss'] for s in run['steps']]}")
            want = sp_flash_per_step(variant, layers, SP, r)
            want_b = sp_comm_bytes_per_step(
                variant, layers, SP, 1, seq // SP, cfg.num_heads,
                cfg.num_kv_heads, cfg.head_dim_, 2)
            for s in run["steps"]:
                got = {n: s["launches"].get(n, 0) for n in FLASH_PER_STEP}
                check(got == want, f"{variant} rank {r}: flash launches "
                      f"{got} a step, expected {want}")
                got_b = {op: t["bytes"] for op, t in s["comm"].items()
                         if op.startswith("sequence/") and t["count"]}
                check(got_b == want_b, f"{variant} rank {r}: sequence/* "
                      f"bytes {got_b} a step, expected {want_b}")
            for n in FLASH_PER_STEP:
                path[n] = path.get(n, 0) + run["path"].get(n, 0)
    for variant in SP_VARIANTS:
        g = gaps[variant]
        check(g["loss"] <= SP_LOSS_TOL and g["grad_norm_rel"] <= SP_NORM_TOL,
              f"{variant}: step 1 {g} from the one-rank run, tolerance "
              f"{SP_LOSS_TOL} / {SP_NORM_TOL}")
    g = gaps[SP_FAULT]
    check(g["loss"] > SP_LOSS_TOL or g["grad_norm_rel"] > SP_NORM_TOL,
          f"the planted fault ({SP_FAULT}) lands within the tolerance: {g}")
    return path, gaps


def _sp_step_rows(run):
    rows = []
    for s in run["steps"]:
        comm_s = sum(t["seconds"] for t in s["comm"].values())
        seq_s = sum(t["seconds"] for op, t in s["comm"].items()
                    if op.startswith("sequence/"))
        rows.append({"loss": s["loss"], "grad_norm": s["grad_norm"],
                     "step_ms": s["step_ms"],
                     "exchange_share": comm_s * 1e3 / s["step_ms"],
                     "sequence_share": seq_s * 1e3 / s["step_ms"],
                     "comm": {op: {k: t[k] for k in ("count", "bytes",
                                                     "seconds")}
                              for op, t in s["comm"].items() if t["count"]}})
    return rows


def phase_train_sp(dev, smi_line, tmp, spawn):
    """Llama-3-8B at full width, SP_LAYERS layers, one sequence of SP_SEQ
    tokens (SP_SEQ_CUT if two ranks would not fit) over SP sequence ranks:
    two processes on the one card over gloo. The one-rank reference (flash
    backend) on this process; then each rank: the ring and Ulysses against their
    plain versions, and the four variants (Ulysses, the striped ring, the
    contiguous ring, the striped ring with the chunked loss), SP_STEPS
    steps each, and the planted fault one step. Gates: step 1's loss and
    gradient norm within SP_LOSS_TOL / SP_NORM_TOL of the one-rank run and
    the fault outside; every rank's losses and norms equal; the flash
    launches and the ``sequence/*`` bytes of every step equal to
    ``sp_flash_per_step`` and ``sp_comm_bytes_per_step``. The rows of
    ``phase_train_ranks``; the reference runs here, after the ranks."""
    seq, free, need = spawn["sp"]
    spawner = spawn["spawner_hbm"]
    seconds = _body_seconds(tmp, "sp_ranks_body")
    ref = _sp_reference(seq)
    rows = _read_ranks("sp_ranks", tmp)
    path, gaps = check_sp_ranks(rows, ref, seq)
    cut = "" if seq == SP_SEQ else \
        f" (cut from {SP_SEQ}: two ranks did not fit)"
    emit({"phase": "train_sp", "model": f"LLAMA3_8B width, {SP_LAYERS} "
          f"layers, bf16, remat, {seq} tokens{cut} over sequence={SP} on "
          "one card (gloo)", "free_hbm": free, "planned_peak": need,
          "seconds": seconds, "spawner_hbm": spawner, "reference": ref,
          "step1_gaps": gaps,
          "tolerance": {"loss": SP_LOSS_TOL, "grad_norm_rel": SP_NORM_TOL},
          "checks": [row["checks"] for row in rows],
          "checks_peak_hbm": [row["checks_peak_hbm"] for row in rows],
          "variants": {v: {"peak_hbm": [row["runs"][v]["peak_hbm"]
                                        for row in rows],
                           "launches_per_step_by_rank": [
                               {n: row["runs"][v]["steps"][0]["launches"]
                                .get(n, 0) for n in FLASH_PER_STEP}
                               for row in rows],
                           "steps": _sp_step_rows(rows[0]["runs"][v])}
                       for v in SP_VARIANTS + (SP_FAULT,)},
          "launches": path, "card": dev["kind"], "nvidia_smi": smi_line})
    return path


def phase_train_chunked_loss(batch, dev, smi_line):
    """The training recipe (TRAIN_LAYERS layers, seq TRAIN_SEQ, gas
    TRAIN_GAS) with the dense loss and with ``loss_chunk_size`` =
    SP_LOSS_CHUNK, one step each from the same seeded weights: step 1's
    loss within CHUNK_LOSS_REL and gradient norm within CHUNK_NORM_REL of
    the dense run's, the chunked run's flash launches exact, and each run's
    peak HBM."""
    import dataclasses
    from deepspeed_tpu_torch.ops import build
    rows, path = {}, {}
    for label, chunk in (("dense", None), ("chunked", SP_LOSS_CHUNK)):
        cfg, ds = train_config()
        cfg = dataclasses.replace(cfg, loss_chunk_size=chunk)
        _release()
        torch.cuda.reset_peak_memory_stats()
        engine = _engine(cfg, ds, mesh=_world1_mesh())
        build.reset_launch_counts()      # the main path's run starts here
        losses, step_ms, per_step, norms = _train_steps(engine, batch, 1)
        path = build.launch_counts()
        rows[label] = {"loss": losses[0], "grad_norm": norms[0],
                       "step_ms": step_ms[0], "launches": per_step[0],
                       "peak_hbm": torch.cuda.max_memory_allocated()}
        del engine
    _release()
    d, c = rows["dense"], rows["chunked"]
    gaps = {"loss_rel": abs(c["loss"] - d["loss"]) / abs(d["loss"]),
            "grad_norm_rel": abs(c["grad_norm"] - d["grad_norm"])
            / d["grad_norm"]}
    want = {n: k * TRAIN_LAYERS * TRAIN_GAS for n, k in FLASH_PER_STEP.items()}
    emit({"phase": "train_chunked_loss", "model": f"LLAMA3_8B width, "
          f"{TRAIN_LAYERS} layers, bf16, remat, flash, seq {TRAIN_SEQ}, gas "
          f"{TRAIN_GAS}", "loss_chunk_size": SP_LOSS_CHUNK, **rows,
          "gaps": gaps, "tolerance": {"loss_rel": CHUNK_LOSS_REL,
                                      "grad_norm_rel": CHUNK_NORM_REL},
          "peak_saved": d["peak_hbm"] - c["peak_hbm"],
          "card": dev["kind"], "nvidia_smi": smi_line})
    check(math.isfinite(c["loss"]), f"chunked loss {c['loss']}")
    check(gaps["loss_rel"] <= CHUNK_LOSS_REL and
          gaps["grad_norm_rel"] <= CHUNK_NORM_REL,
          f"chunked vs dense step 1: {gaps}")
    check(c["launches"] == want, f"chunked flash launches {c['launches']}, "
          f"expected {want}")
    return path


HOST_SOURCES = ("cpu_adam", "aio")  # g++ builds them beside the CUDA sources
PARITY_STEPS = 2                   # train_batch steps of each parity engine
# the parity engines' depth and the parameter tier's group there: cut from
# TRAIN_LAYERS (4, groups of 2) to 3 layers in groups of 2 beside the
# tensor-parallel phases, to 2 layers beside the tiers over ranks for the
# smoke's time limit (width is never cut); a layer a group, so the
# parity holds the stream across a group boundary (the next group's
# prefetch, each group's seeded backward)
PARITY_LAYERS, PARITY_GROUP = 2, 1
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
# the tiers' timed runs go no deeper than this (the host held 25 and 15
# layers): each layer's host state is allocated and touched at init (~24 s
# at those depths) and streamed every step; cut for the smoke's time limit
# (width is never cut); 12 / 8 until tensor parallelism joined the smoke,
# 8 / 6 until the tiers over ranks did
TIER_LAYERS = {"optimizer": 4, "param": 4}
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
    """The deepest depth up to TIER_LAYERS[tier] whose host state, times
    HOST_MARGIN, fits in MemAvailable; emits the reading on its own line."""
    avail, settle_s = settled_mem_available()
    per = HOST_BYTES[tier]
    fits = max((n for n in range(1, cfg.num_layers + 1)
                if per * llama_params(cfg, n) * HOST_MARGIN <= avail),
               default=0)
    depth = min(fits, TIER_LAYERS[tier])
    need = per * llama_params(cfg, cfg.num_layers)
    row = {"phase": f"host_memory_{tier}", "mem_available_bytes": avail,
           "settle_s": settle_s, "rss_bytes": host_memory()["rss"],
           "cores": os.cpu_count(), "host_bytes_per_param": per,
           "host_bytes_full_depth": need, "margin": HOST_MARGIN,
           "layers_that_fit": fits, "layers": depth,
           "full_depth": cfg.num_layers, "cut": depth < cfg.num_layers}
    if row["cut"]:
        row["reason"] = (f"{cfg.num_layers} layers need {need / 1e9:.1f} GB of "
                         f"host state, x{HOST_MARGIN} > MemAvailable "
                         f"{avail / 1e9:.1f} GB; {fits} layers fit"
                         if fits < TIER_LAYERS[tier] else
                         f"{fits} layers fit; cut to {depth} for the time "
                         "limit")
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


def _masters_gap(got, want, device="cuda"):
    """Over every element: the largest |got - want| / (MASTERS_ATOL +
    MASTERS_RTOL |want|), the share of elements where that exceeds 1, and
    the largest |got - want|; a leaf at a time on ``device``: the same
    numbers as on the host (elementwise fp32 arithmetic, comparisons, a
    count and maxima), in a fraction of the host's time."""
    worst, over, n, gap = 0.0, 0, 0, 0.0
    for a, b in zip(got, want):
        a, b = a.to(device), b.to(device)
        d = (a - b).abs()
        r = d / (MASTERS_ATOL + MASTERS_RTOL * b.abs())
        worst = max(worst, float(r.max()))
        over += int((r > 1.0).sum())
        n += r.numel()
        gap = max(gap, float(d.max()))
        del a, b, d, r
    return {"over_tol": worst, "share_over_tol": over / n, "max_abs": gap}


def _close(engine) -> None:
    """Unregister a parameter tier's page-locked store before the engine
    goes (the caller then drops it and calls ``_release``)."""
    po = getattr(engine, "_param_offload", None)
    if po is not None:
        po.close()


def phase_train_offload_parity(batch, dev, smi_line):
    """The recipe at PARITY_LAYERS layers, PARITY_STEPS steps each (AdamW's
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
    - the parameter tier (PARITY_GROUP layers a group) against the
      optimizer tier:
      step 1's loss within PARAM_LOSS_REL (the same bf16 weights through
      the same kernels: a wider gap is a stream-ordering fault); it sums
      the two micro-batches' bf16 gradients in fp32 on the host, the
      optimizer tier in bf16 on the card (the recipe's grad_accum_dtype),
      so its final masters take the same two-pipeline bound."""
    import dataclasses
    import shutil
    import tempfile
    cfg, ds_config = train_config()
    cfg = dataclasses.replace(cfg, num_layers=PARITY_LAYERS)
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
        if getattr(engine, "_param_offload", None) is not None:
            runs[label]["groups"] = len(engine._param_offload._layer_groups)
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
        "device": "cpu", "layers_per_group": PARITY_GROUP}})
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
    check(runs["param"]["groups"] == PARITY_LAYERS // PARITY_GROUP,
          f"parameter tier groups {runs['param']['groups']}, expected "
          f"{PARITY_LAYERS // PARITY_GROUP}")


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
    otherwise as ``train_config``, at the deepest the host RAM holds up to
    TIER_LAYERS: 1 warm-up and OFFLOAD_STEPS timed steps whose loss falls at
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
    the deepest the host RAM holds up to TIER_LAYERS: 1 warm-up and
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


# ---------------------------------------------------------------------------
# the memory tiers over ranks: two gloo ranks on the one card
# ---------------------------------------------------------------------------
# Llama-3-8B width cut to 2 of 32 layers (1.49 B parameters): a micro-batch's
# bf16 gradients (~3 GB) cross gloo's pinned host copies; a layer a group,
# so the stream crosses a group boundary
TIER_RANKS_LAYERS = 2
TIER_RANKS_STEPS = 2               # train_batch steps of each two-rank run
# one micro-batch a step (the recipe's 4 sequences over the ranks): each
# micro-batch's reduction is the pair's cost, cut for the smoke's time
TIER_RANKS_GAS = 1
TIER_RANKS_TIMEOUT = 900           # seconds the spawned pair may take
OFFLOAD_TIER = {"offload_optimizer": {"device": "cpu"}}
PARAM_TIER = {"offload_optimizer": {"device": "cpu"},
              "offload_param": {"device": "cpu", "layers_per_group": 1}}
# run -> (ZeRO stage, mesh, the tier: its one-rank reference's name)
TIER_RANK_RUNS = {
    "offload_fsdp2": (2, {"fsdp": RANKS, "data": 1}, "optimizer"),
    "param_data2": (0, {"data": RANKS}, "param"),
    "param_tensor2": (0, {"tensor": RANKS, "data": 1}, "param"),
}
TIERS = {"optimizer": OFFLOAD_TIER, "param": PARAM_TIER}
# the gap of a two-rank run from its one-rank tier: largest loss and norm
# gap over the steps, the share of masters more than MASTERS_ATOL_LR x lr
# apart; ~4x the sound readings (8b: the card's, tiny: the CPU's), by the
# mesh's axis. Over data or fsdp ranks each rank's bf16 gradient of two
# rows is summed with the other's in the reduction (gloo rounds the sum)
# where one rank takes the four rows' gradient in one product (divergences
# 25-26), a rounding no summation order of one rank has: the first card
# run read a loss gap 3x the one-rank orders' distance; at one micro-batch
# a step 3.08e-4 / 2.90e-4 / 7.5e-4 (PERF.md). Over tensor ranks the
# forward rounds each row-parallel sum of two bf16 partials: its gap is
# the in-HBM engine's own (``tests/test_torch_offload_ranks.py::
# test_tensor_gap_in_bf16_is_the_engines_own``), at two layers beyond the
# limits for one layer (TP_TRAIN_LIMITS): 1.1e-3 / 2.6e-3 / 0.0059
TIER_RANKS_LIMITS = {
    "8b": {"data": {"loss": 1.2e-3, "grad_norm": 1.2e-3,
                    "masters_share": 0.005},
           "tensor": {"loss": 4.5e-3, "grad_norm": 1e-2,
                      "masters_share": 0.024}},
    "tiny": {"data": {"loss": 4e-5, "grad_norm": 5e-4, "masters_share": 0.005},
             "tensor": TP_TRAIN_LIMITS["tiny"]}}
TIER_TRACE = "tier_ranks_trace{}.jsonl"   # a rank's progress, in chiprun_out


def expected_tier_comm(engine, gas: int) -> dict:
    """The facade bytes one step of a memory tier moves on a rank, from the
    leaves' shapes and dtypes. The optimizer tier over fsdp ranks (stages
    0-2): each micro-batch's compute-dtype gradients reduce-scattered
    where ZeRO shards the leaf (all-reduced where it does not), the loss
    (fp32) and the sharded leaves' squares (fp32) all-reduced once, the
    new shadow blocks all-gathered (``offload/all_gather``). The parameter
    tier: each micro-batch's gradients of every leaf averaged over the
    batch axes and the loss (fp64) once; over ``tensor``, the tensor
    blocks' squares (fp64). Its ``tensor/*`` ops are the model's and are
    not reckoned here."""
    out = {}

    def add(op, n):
        out[op] = out.get(op, 0) + n
    po = engine._param_offload
    if po is not None:
        elem = torch.empty((), dtype=po.compute_dtype).element_size()
        if po._batch_axes:
            add("all_reduce", gas * elem * sum(math.prod(s)
                                               for s in po._shapes) + 8)
        if po._tensor_leaves:
            add("all_reduce", 8 * len(po._tensor_leaves))
        return out
    for i, m in enumerate(engine._masters):
        n, elem = m.numel(), m.element_size()
        add("reduce_scatter" if engine._grad_dim[i] is not None
            else "all_reduce", gas * n * elem)
        if engine._gathers(i):
            add("offload/all_gather", n // engine._zero_world * elem)
    add("all_reduce", 4 + 4 * sum(d is not None for d in engine._grad_dim))
    return out


def _streamed_per_step(po, gas: int) -> dict:
    """The bytes the parameter tier streams a step (a layer group twice a
    micro-batch, the embedding and the tail once), over all leaves and
    over the tensor blocks alone."""
    elem = torch.empty((), dtype=po.compute_dtype).element_size()
    total = tensor = 0
    for i, (name, shape) in enumerate(zip(po.names, po._shapes)):
        k = gas * elem * math.prod(shape) * (2 if ".layer_" in name else 1)
        total += k
        tensor += k if i in po._tensor_leaves else 0
    return {"total": total, "tensor_blocks": tensor}


def _tier_trace(r, stage, **kw) -> None:
    """On the card, a line of process ``r``'s progress with its host
    memory, flushed to ``chiprun_out`` (it outlives a run the machine
    ends); a new file at ``start``."""
    if _rank_device() != "cuda":
        return
    os.makedirs(os.path.dirname(LINES_PATH), exist_ok=True)
    with open(os.path.join(os.path.dirname(LINES_PATH), TIER_TRACE.format(r)),
              "w" if stage == "start" else "a") as f:
        f.write(json.dumps({"stage": stage, "t": time.monotonic() - _T0,
                            **host_memory(), **kw}) + "\n")


def _enough_mem(need: int):
    """(MemAvailable, seconds waited): at once where ``need`` x
    HOST_MARGIN fits, else once it has settled."""
    avail = mem_available()
    if need * HOST_MARGIN <= avail:
        return avail, 0.0
    return settled_mem_available()


def _tier_host(engine, gas: int) -> dict:
    """A tier engine's host bytes and the parameters behind them on this
    rank (the parameter tier: and what it streams a step)."""
    po = engine._param_offload
    if po is None:
        return {"host_bytes": engine._offload.state_bytes(),
                "host_numel": sum(leaf.size
                                  for leaf in engine._offload.leaves)}
    return {"host_bytes": po.host_bytes(),
            "host_numel": sum(math.prod(s) for s in po._shapes),
            "streamed_per_step": _streamed_per_step(po, gas)}


def tier_ranks_body():
    """One rank of ``train_offload_ranks`` and ``train_param_offload_ranks``
    (spawned on the card over gloo). First, at the same time, each rank
    alone on a one-rank mesh: rank 0 runs the one-rank optimizer tier,
    rank 1 the one-rank parameter tier, over the same 4 sequences a step
    in TIER_RANKS_GAS micro-batches (the reference). Then both ranks run TIER_RANK_RUNS,
    TIER_RANKS_STEPS steps each: the optimizer tier at ZeRO stage 2 over
    fsdp=2, the parameter tier over data=2 and over tensor=2 with the
    model's tensor rules; per step the loss, norm, phase seconds and
    bytes, the comms logger's bytes and the flash launches; each rank's
    host bytes; the masters gathered whole, held against its reference by
    the rank that ran it."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
    from deepspeed_tpu_torch.models.llama import random_tokens
    r = dist.get_rank()
    model = os.environ.get(RANK_MODEL_ENV, "8b")
    layers = int(os.environ.get("DSTPU_SMOKE_LAYERS", TIER_RANKS_LAYERS))
    gas = TIER_RANKS_GAS
    cfg0, _ = _zero_recipe(0, layers, model)
    # [gas, rows, S], or [rows, S] at one micro-batch (train_batch's form)
    batch = random_tokens(RANKS_BATCH // gas, TRAIN_SEQ if model == "8b"
                          else 64, vocab_size=cfg0.vocab_size, seed=SEED,
                          gas=gas if gas > 1 else None)
    atol = MASTERS_ATOL_LR * _recipe_lr(model)
    out = {"rank": r, "model": model, "layers": layers, "runs": {},
           "params": llama_params(cfg0, layers),
           "flash": _rank_device() == "cuda"
           and cfg0.attention_backend == "flash"}
    _tier_trace(r, "start")
    mine = ("optimizer", "param")[r]
    t = time.monotonic()
    cfg, ds = _zero_recipe(0, layers, model, **TIERS[mine])
    ds.update(train_batch_size=RANKS_BATCH, gradient_accumulation_steps=gas)
    engine = _engine(cfg, ds, mesh=_world1_mesh())
    losses, norms = [], []
    for _ in range(TIER_RANKS_STEPS):
        losses.append(engine.train_batch(batch=batch).item())
        norms.append(engine.get_global_grad_norm())
    # kept on the card: the comparison needs no host round trip
    ref = (losses, norms, [m.detach().to(_rank_device(), copy=True)
                           for _, m in engine.named_masters()])
    _close(engine)
    del engine
    _release()
    out["reference"] = {"tier": mine, "losses": losses, "grad_norms": norms,
                        "seconds": time.monotonic() - t}
    _tier_trace(r, f"reference_{mine}")
    dist.barrier()
    comms = get_comms_logger()
    comms.configure(enabled=True)
    for name, (stage, mesh, tier) in TIER_RANK_RUNS.items():
        cfg, ds = _zero_recipe(stage, layers, model, **TIERS[tier])
        ds.update(train_batch_size=RANKS_BATCH,
                  gradient_accumulation_steps=gas, mesh=mesh)
        _peak_reset()
        t = time.monotonic()
        engine = _engine(cfg, ds)
        init_s = time.monotonic() - t
        _tier_trace(r, f"{name}_init", seconds=init_s)
        comms.reset()
        steps = []
        for _ in range(TIER_RANKS_STEPS):
            steps += _rank_steps(engine, batch, 1, comms)
            steps[-1].update(phase_s=dict(engine.phase_seconds),
                             bytes=dict(engine.phase_bytes))
            _tier_trace(r, f"{name}_step", ms=steps[-1]["step_ms"])
        run = {"steps": steps, "init_s": init_s, "peak_hbm": _peak(),
               "expected_comm_per_step": expected_tier_comm(engine, gas),
               "tensor_dims": engine._tensor_dim, **_tier_host(engine, gas)}
        masters = [m for _, m in engine.named_masters()]  # every rank
        if tier == mine:
            run["masters_share"], run["masters_max_abs"] = _masters_apart(
                masters, ref[2], atol)
            run["loss_gap"] = max(abs(s["loss"] - a)
                                  for s, a in zip(steps, ref[0]))
            run["grad_norm_gap"] = max(abs(s["grad_norm"] - a)
                                       for s, a in zip(steps, ref[1]))
        out["runs"][name] = run
        _close(engine)
        del engine, masters
        _release()
        _tier_trace(r, f"{name}_done")
    comms.configure(enabled=False)
    with open(_rank_out(f"tier_ranks{r}.json"), "w") as f:
        json.dump(out, f)


def _tier_run_summary(rows, name) -> dict:
    """A run's readings on every rank: losses, step ms, the mean phase
    seconds and bytes a step, the comms logger's bytes a step, host bytes
    and peak HBM."""
    r0 = rows[0]["runs"][name]
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    return {
        "losses": [s["loss"] for s in r0["steps"]],
        "grad_norms": [s["grad_norm"] for s in r0["steps"]],
        "step_ms": [[s["step_ms"] for s in row["runs"][name]["steps"]]
                    for row in rows],
        "phase_s_mean": [{k: mean([s["phase_s"][k] for s in
                                   row["runs"][name]["steps"]])
                          for k in row["runs"][name]["steps"][0]["phase_s"]}
                         for row in rows],
        "bytes_per_step": r0["steps"][-1]["bytes"],
        "comm_per_step": r0["steps"][-1]["comm"],
        "host_bytes": [row["runs"][name]["host_bytes"] for row in rows],
        "peak_hbm": [row["runs"][name]["peak_hbm"] for row in rows],
        "init_s": [row["runs"][name]["init_s"] for row in rows]}


def tier_ranks_gaps(rows) -> dict:
    """Each run's distance from its tier's one-rank reference, read by the
    rank that ran the reference."""
    holders = {row["reference"]["tier"]: row["rank"] for row in rows}
    return {name: {k: rows[holders[tier]]["runs"][name][k]
                   for k in ("loss_gap", "grad_norm_gap", "masters_share",
                             "masters_max_abs")}
            for name, (_, _, tier) in TIER_RANK_RUNS.items()}


def check_tier_ranks(rows) -> dict:
    """The gates of ``train_offload_ranks`` and ``train_param_offload_
    ranks``: each run's losses, norms and masters share against its
    one-rank reference within TIER_RANKS_LIMITS, by the mesh's axis;
    every rank's losses and norms equal; each op's bytes a step as
    ``expected_tier_comm`` reckons them; the optimizer tier's host state a
    rank the block its card holds (half the one-rank tier's, the small
    leaves whole), the parameter tier's the whole store over data ranks
    and the tensor blocks over tensor ranks, streaming exactly their
    bytes (the tensor=2 run half the sharded leaves'); flash launches a
    rank and step exact where the flash backend runs on the card. Returns
    the gaps and, per run, the launches summed over ranks and steps."""
    model, layers = rows[0]["model"], rows[0]["layers"]
    readings = tier_ranks_gaps(rows)
    per = {"offload_fsdp2": FLASH_PER_STEP, "param_data2": FLASH_PER_STEP_PARAM,
           "param_tensor2": FLASH_PER_STEP_PARAM}
    gas = TIER_RANKS_GAS
    full = 12 * rows[0]["params"]
    out = {"gaps": {}, "launches": {}}
    for name, (_, mesh, tier) in TIER_RANK_RUNS.items():
        tol = TIER_RANKS_LIMITS[model]["tensor" if "tensor" in mesh
                                       else "data"]
        gaps = readings[name]
        out["gaps"][name] = {**gaps, "tolerance": tol}
        check(gaps["loss_gap"] <= tol["loss"] and
              gaps["grad_norm_gap"] <= tol["grad_norm"] and
              gaps["masters_share"] <= tol["masters_share"],
              f"{name}: {gaps} from its one-rank reference, tolerance {tol}")
        r0 = rows[0]["runs"][name]
        want = {n: k * layers * gas if rows[0]["flash"] else 0
                for n, k in per[name].items()}
        path = {n: 0 for n in want}
        for row in rows:
            run = row["runs"][name]
            check([(s["loss"], s["grad_norm"]) for s in run["steps"]] ==
                  [(s["loss"], s["grad_norm"]) for s in r0["steps"]],
                  f"{name}: rank {row['rank']}'s losses or norms differ from "
                  "rank 0's")
            for k, s in enumerate(run["steps"]):
                got = {op: int(t["bytes"]) for op, t in s["comm"].items()
                       if t["count"] and not op.startswith("tensor/")}
                check(got == run["expected_comm_per_step"],
                      f"{name} rank {row['rank']} step {k}: comm bytes {got}"
                      f", expected {run['expected_comm_per_step']}")
                launched = {n: s["launches"].get(n, 0) for n in want}
                check(launched == want, f"{name} rank {row['rank']} step {k}"
                      f": flash launches {launched}, expected {want}")
                for n, c in launched.items():
                    path[n] += c
            if tier == "optimizer":
                check(run["host_bytes"] == 12 * run["host_numel"] and
                      run["host_bytes"] < 0.55 * full,
                      f"{name} rank {row['rank']}: host state "
                      f"{run['host_bytes']} bytes, the one-rank tier's {full}")
                check({"reduce", "gather"} <= set(run["steps"][-1]["phase_s"]),
                      f"{name}: phases {sorted(run['steps'][-1]['phase_s'])}")
            else:
                whole = run["host_numel"] == rows[0]["params"]
                check(whole == ("tensor" not in mesh),
                      f"{name} rank {row['rank']}: holds {run['host_numel']}"
                      f" of {rows[0]['params']} parameters on the host")
                streamed = run["streamed_per_step"]
                check(all(s["bytes"]["h2d"] == streamed["total"]
                          for s in run["steps"]),
                      f"{name} rank {row['rank']}: streamed "
                      f"{[s['bytes']['h2d'] for s in run['steps']]}, the "
                      f"blocks' {streamed['total']}")
        out["launches"][name] = path
    d, t = (rows[0]["runs"][k]["streamed_per_step"]
            for k in ("param_data2", "param_tensor2"))
    check(d["tensor_blocks"] == 0 and t["tensor_blocks"] > 0 and
          t["total"] == d["total"] - t["tensor_blocks"],
          f"tensor=2 streams {t}, data=2 {d}: not half the sharded leaves")
    out["streamed"] = {"data2": d, "tensor2": t}
    return out


def phase_train_tier_ranks(dev, smi_line, tmp):
    """``train_offload_ranks`` and ``train_param_offload_ranks``: the pair
    of ``tier_ranks_body`` on the one card over gloo, Llama-3-8B width at
    TIER_RANKS_LAYERS layers, gated by ``check_tier_ranks``. Returns the
    two phases' flash launches over their two-rank runs."""
    # the pair's peak: two parameter tiers' host state over data ranks
    need = 2 * HOST_BYTES["param"] * llama_params(
        _zero_recipe(0, TIER_RANKS_LAYERS)[0], TIER_RANKS_LAYERS)
    avail, settle_s = _enough_mem(need)
    host = {**host_memory(), "settle_s": settle_s, "need": need}
    _tier_trace("_spawner", "start", settle_s=settle_s)
    check(need * HOST_MARGIN <= avail, f"the tier pair's host state ({need} "
          f"bytes, x{HOST_MARGIN}) does not fit MemAvailable {avail}")
    seconds = _spawn("tier_ranks_body", tmp, timeout=TIER_RANKS_TIMEOUT)
    rows = _read_ranks("tier_ranks", tmp)
    # the readings the limits stand on, before the gates
    emit({"phase": "tier_ranks_readings", "seconds": seconds,
          "gaps": tier_ranks_gaps(rows),
          "references": [row["reference"] for row in rows],
          "limits": TIER_RANKS_LIMITS[rows[0]["model"]],
          "steps": {name: [(s["loss"], s["grad_norm"]) for s in
                           rows[0]["runs"][name]["steps"]]
                    for name in TIER_RANK_RUNS}})
    res = check_tier_ranks(rows)
    layers = rows[0]["layers"]
    model = (f"LLAMA3_8B width, {layers} of 32 layers (cut for gloo's host "
             f"copies), bf16, flash, remat, {RANKS} gloo ranks on one card")
    common = {"seconds": seconds, "host_before": host,
              "card": dev["kind"], "nvidia_smi": smi_line}
    emit({"phase": "train_offload_ranks", "model": model,
          "run": "ZeRO stage 2 over fsdp=2, offload_optimizer cpu",
          "reference": rows[0]["reference"],
          "one_rank_host_bytes": 12 * rows[0]["params"],
          **_tier_run_summary(rows, "offload_fsdp2"),
          "gaps": res["gaps"]["offload_fsdp2"],
          "launches": res["launches"]["offload_fsdp2"], **common})
    emit({"phase": "train_param_offload_ranks", "model": model,
          "runs": {k: {"mesh": TIER_RANK_RUNS[k][1],
                       **_tier_run_summary(rows, k),
                       "gaps": res["gaps"][k]}
                   for k in ("param_data2", "param_tensor2")},
          "reference": rows[1]["reference"],
          "streamed": res["streamed"],
          "launches": {k: res["launches"][k]
                       for k in ("param_data2", "param_tensor2")},
          **common})
    both = {n: res["launches"]["param_data2"][n]
            + res["launches"]["param_tensor2"][n] for n in FLASH_PER_STEP}
    return res["launches"]["offload_fsdp2"], both


# the MoE stack under offload_param against the in-HBM engine, steps 2-3:
# the tier sums micro-batches in fp32 on the host (divergence 20) and its
# host AdamW does not decay (divergence 18), and top-2 routing turns those
# last-bit differences into flipped expert choices; ~4x the first card
# reading (2.5e-3 at step 3, 3.8e-4 at step 2; PERF.md). Step 1 is held to
# PARAM_LOSS_REL: the same bf16 weights through the same kernels.
MOE_PARAM_LOSS_REL = 1e-2


MOE_PARAM_STEPS = 1          # train_param_offload_moe: steps after the first


def phase_train_param_offload_moe(moe_ref, dev, smi_line):
    """Mixtral-8x7B at full width and ``train_moe``'s MOE_TRAIN_LAYERS
    layers, one rank, ``offload_param`` cpu a layer a group (the MoE block
    stack: each group's gating aux losses on the forward carry, a unit
    cotangent seeding its backward, the head in fp32) with
    ``offload_optimizer`` cpu: 1 + MOE_PARAM_STEPS steps on ``train_moe``'s
    batch after its in-HBM engine is freed; step 1's loss within
    PARAM_LOSS_REL of the in-HBM engine's, every step's within
    MOE_PARAM_LOSS_REL, the loss falls, exact flash launches, the host
    bytes (18 a parameter planned) beside MemAvailable."""
    from deepspeed_tpu_torch.ops import build
    _release()
    cfg, ds = moe_train_config()
    n = moe_params(cfg)
    need = HOST_BYTES["param"] * n
    avail, settle_s = _enough_mem(need)
    check(need * HOST_MARGIN <= avail, f"the MoE stack's host state "
          f"({need} bytes, x{HOST_MARGIN}) does not fit MemAvailable {avail}")
    ds["zero_optimization"].update(
        offload_optimizer={"device": "cpu", "ratio": 0.0},
        offload_param={"device": "cpu", "layers_per_group": 1})
    t0 = time.monotonic()
    engine = _moe_engine(cfg, ds)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    batch = _moe_batch(cfg, "8b")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()        # the main path's run starts here
    rows = _tier_steps(engine, batch, 1 + MOE_PARAM_STEPS)
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    host_bytes = engine._param_offload.host_bytes()
    groups = len(engine._param_offload._layer_groups)
    _close(engine)
    del engine
    _release()
    losses = [r["loss"] for r in rows]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, moe_ref["losses"])]
    in_hbm = moe_ref["losses"][:len(losses)]
    want = {k: v * MOE_TRAIN_LAYERS * TRAIN_GAS
            for k, v in FLASH_PER_STEP_PARAM.items()}
    emit({"phase": "train_param_offload_moe", "model": f"Mixtral-8x7B width,"
          f" {MOE_TRAIN_LAYERS} of 32 layers, bf16, remat, flash, "
          "offload_param cpu x1 layer, offload_optimizer cpu, one rank",
          "params": n, "groups": groups, "init_s": init_s, "losses": losses,
          "in_hbm_losses": in_hbm, "loss_rel": rel,
          "limits": {"step1_loss_rel": PARAM_LOSS_REL,
                     "loss_rel": MOE_PARAM_LOSS_REL},
          "steps": rows, **_tier_summary(rows, n, "param"),
          "host_bytes": host_bytes, "host_bytes_planned": need,
          "mem_available": avail, "settle_s": settle_s,
          "max_memory_allocated": peak, "launches": launches,
          "card": dev["kind"], "nvidia_smi": smi_line})
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(rel[0] <= PARAM_LOSS_REL, f"step-1 loss {losses[0]} vs the in-HBM "
          f"engine's {in_hbm[0]} ({rel[0]} relative)")
    check(max(rel) <= MOE_PARAM_LOSS_REL, f"losses {losses} vs the in-HBM "
          f"engine's {in_hbm}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(r["launches"] == want for r in rows),
          f"flash launches per step {[r['launches'] for r in rows]}, "
          f"expected {want}")
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
    "quantize_int8_scaled": ("quant", "deepspeed_tpu/ops/pallas/quant.py:22"),
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
# int8 combine; train_zeropp_ranks: Llama-3-8B over four ranks, MiCS, hpZ,
# qwZ and comm_compression; train_sp: Llama-3-8B over two sequence ranks, Ulysses and
# the ring; train_chunked_loss: the recipe with the chunked loss;
# infer_tp_ranks: Llama-3-8B served through init_inference over two tensor
# ranks (forwards only); train_tp_ranks: Llama-3-8B at fsdp 2 x tensor 2;
# train_offload_ranks: the optimizer tier at ZeRO 2 over two fsdp ranks;
# train_param_offload_ranks: the parameter tier over two data ranks and
# over two tensor ranks; train_param_offload_moe: Mixtral-8x7B streamed;
# train_micro_steps: the recipe through engine(micro) / backward / step;
# train_async: the recipe with the async pipeline and the staged prefetch;
# train_resume: the recipe resumed from a checkpoint in a fresh process;
# serve_from_checkpoint: that run's consolidated npz served through
# serving/cli.py --checkpoint)
KERNEL_PATHS = {"paged_attention": ("serve", "serve_http", "disagg", "fleet",
                                     "A1", "A2", "serve_moe",
                                     "serve_from_checkpoint"),
                **{n: ("train", "train_micro_steps", "train_async",
                       "train_resume",
                       "train_offload", "train_param_offload",
                       "train_zero", "train_zero_ranks", "train_qgz_ranks",
                       "train_zeropp_ranks", "train_moe", "train_moe_ranks",
                       "train_sp", "train_chunked_loss", "train_tp_ranks",
                       "train_offload_ranks", "train_param_offload_ranks",
                       "train_param_offload_moe")
                   + (("infer_tp_ranks",) if n == "flash_fwd" else ())
                   for n in FLASH_PER_STEP},
                "quantize_fp8": ("A1", "quant_collectives"),
                "dequantize_fp8": ("A1", "quant_collectives"),
                "quantize_int8": ("B", "train_qgz_ranks", "quant_collectives",
                                  "moe_int8", "train_zeropp_ranks"),
                "quantize_int8_scaled": ("train_zeropp_ranks",),
                "dequantize_int8": ("B", "A2", "train_qgz_ranks",
                                    "quant_collectives", "moe_int8",
                                    "train_zeropp_ranks"),
                **{n: ("evoformer",) for n in EVO_KERNELS},
                "rms_norm": ("R",), **{n: ("F",) for n in BIAS_ACT_KERNELS},
                "sparse_attention": ("S1", "S2")}


def zeropp_faults_main(dev, smi_line) -> int:
    """``--zeropp-faults``: the flash and quant libraries built, then
    ``train_zeropp_ranks`` with its planted faults (ZPP_FAULTS) after the
    variants, for the readings its gap limits stand on. Not the smoke:
    its last line is the phase's gaps."""
    from deepspeed_tpu_torch.ops import build
    build.build(["flash_attention", "quant"])
    tmp = tempfile.mkdtemp(prefix="dstpu-ranks-")
    try:
        phase_train_zeropp_ranks(dev, smi_line, tmp, faults=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi_line, flush=True)
    return 0


def carry_overs_main(dev, smi_line) -> int:
    """``--carry-overs``: the flash library built, then ``train`` (the
    reference), ``train_micro_steps``, ``train_async`` and
    ``train_optimizers`` with their gates: this slice's phases alone. Not
    the smoke: its last line is the card's."""
    from deepspeed_tpu_torch.ops import build
    build.build(["flash_attention"])
    engine, batch, _, losses, train_ms = phase_train(dev, smi_line)
    train_ref = {"losses": losses, "step_ms_mean": train_ms,
                 "masters": host_masters(engine)}
    train_ref["idle_share"] = phase_train_profile(engine, batch, dev,
                                                  smi_line)
    del engine
    _release()
    phase_train_micro_steps(batch, train_ref, dev, smi_line)
    phase_train_async(batch, train_ref, dev, smi_line)
    del train_ref
    phase_train_optimizers(batch, dev, smi_line)
    emit({"phase": "phase_seconds",
          "seconds": {k: round(v, 1) for k, v in _PHASE_SECONDS.items()},
          "total": round(time.monotonic() - _T0, 1)})
    print(smi_line, flush=True)
    return 0


def checkpoint_main(dev, smi_line) -> int:
    """``--checkpoint``: the flash and paged libraries built, then ``train``
    (the reference) and ``train_resume`` / ``serve_from_checkpoint`` with
    their gates: this slice's phases alone. Not the smoke: its last line
    is the card's."""
    from deepspeed_tpu_torch.ops import build
    build.build(["flash_attention", "paged_attention"])
    engine, _, _, losses, _ = phase_train(dev, smi_line)
    train_ref = {"losses": losses, "masters": host_masters(engine)}
    del engine
    _release()
    phase_train_resume(train_ref, dev, smi_line)
    emit({"phase": "phase_seconds",
          "seconds": {k: round(v, 1) for k, v in _PHASE_SECONDS.items()},
          "total": round(time.monotonic() - _T0, 1)})
    print(smi_line, flush=True)
    return 0


def tier_ranks_main(dev, smi_line) -> int:
    """``--tier-ranks``: the flash library and the host sources built, then
    ``train_moe`` (the MoE stack's reference), ``train_offload_ranks``,
    ``train_param_offload_ranks`` and ``train_param_offload_moe`` with
    their gates: this slice's phases alone. Not the smoke: its last line
    is the card's."""
    from deepspeed_tpu_torch.ops import build
    build.build(["flash_attention", *HOST_SOURCES])
    _, moe_ref = phase_train_moe(dev, smi_line)
    tmp = tempfile.mkdtemp(prefix="dstpu-ranks-")
    try:
        phase_train_tier_ranks(dev, smi_line, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_train_param_offload_moe(moe_ref, dev, smi_line)
    emit({"phase": "phase_seconds",
          "seconds": {k: round(v, 1) for k, v in _PHASE_SECONDS.items()},
          "total": round(time.monotonic() - _T0, 1)})
    print(smi_line, flush=True)
    return 0


def tp_faults_main(dev, smi_line) -> int:
    """``--tp-faults``: the flash library built, the flash kernels at a
    tensor rank's shape (``tp_flash_timing``), then the pair running
    ``tp_infer_body`` alone with the planted faults of TP_FAULTS after the
    sound run, gated by ``check_tp_infer`` (each fault outside the serving
    limits: the readings the limits stand on), and the four ranks running
    ``tp_zero3`` alone after the stage-0 reference, gated by
    ``check_tp_ranks``, then with each of TP_TRAIN_FAULTS planted, each
    caught (``check_tp_train_faults``). Not the smoke: its last line is
    the card's."""
    from deepspeed_tpu_torch.ops import build
    build.build(["flash_attention"])
    phase_tp_flash_timing(dev, smi_line)
    tmp = tempfile.mkdtemp(prefix="dstpu-ranks-")
    try:
        _release()
        seconds = _spawn("ranks_bodies", tmp, timeout=TP_TIMEOUT,
                         **{BODIES_ENV: "tp_infer_body", TP_FAULTS_ENV: "1"})
        rows = _read_ranks("tp_infer", tmp)
        emit({"phase": "infer_tp_ranks_faults", "seconds": seconds,
              "runs": rows[0]["runs"], "limits": TP_LOGITS_LIMITS["8b"],
              "reference_seconds": rows[0].get("reference_seconds"),
              "peak_hbm": [row["runs"]["sound"]["peak_hbm"] for row in rows]})
        check_tp_infer(rows)
        seconds = _spawn("zeropp_ranks_body", tmp, timeout=ZPP_TIMEOUT,
                         world=ZPP_RANKS,
                         **{"DSTPU_SMOKE_LAYERS": str(ZPP_LAYERS),
                            ZPP_VARIANTS_ENV: ",".join(TP_VARIANTS),
                            TP_FAULTS_ENV: "1"})
        rows = _read_ranks("zeropp_ranks", tmp, world=ZPP_RANKS)
        tp = rows[0]["runs"]["tp_zero3"]
        emit({"phase": "train_tp_ranks_faults", "seconds": seconds,
              "reference_seconds": rows[0]["reference_seconds"],
              "orders_tolerance": rows[0]["reference"]["tolerance"],
              "limits": TP_TRAIN_LIMITS["8b"],
              "gaps": tp_train_gaps(rows[0]["runs"]),
              "run": {k: v for k, v in tp.items() if k != "steps"},
              "steps": [{k: v for k, v in st.items() if k != "launches"}
                        for st in tp["steps"]],
              "peak_hbm": [row["runs"]["tp_zero3"]["peak_hbm"]
                           for row in rows]})
        check_tp_ranks(rows)
        check_tp_train_faults(rows)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi_line, flush=True)
    return 0


def main(argv=()) -> int:
    if argv and argv[0] == "--resume-child":       # train_resume's process
        return resume_child_main(*argv[1:3], *argv[3:4])
    phase = "device"
    try:
        dev, smi_line = phase_device()
        os.makedirs(os.path.dirname(LINES_PATH), exist_ok=True)
        _LINES.append(open(LINES_PATH, "w"))
        if "--tp-faults" in argv:
            phase = "infer_tp_ranks"
            import deepspeed_tpu_torch  # noqa: F401
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            return tp_faults_main(dev, smi_line)
        if "--carry-overs" in argv:
            phase = "train"
            import deepspeed_tpu_torch  # noqa: F401
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            return carry_overs_main(dev, smi_line)
        if "--checkpoint" in argv:
            phase = "train"
            import deepspeed_tpu_torch  # noqa: F401
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            return checkpoint_main(dev, smi_line)
        if "--tier-ranks" in argv:
            phase = "tier_ranks"
            import deepspeed_tpu_torch  # noqa: F401
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            return tier_ranks_main(dev, smi_line)
        if "--zeropp-faults" in argv:
            phase = "train_zeropp_ranks"
            import deepspeed_tpu_torch  # noqa: F401
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            return zeropp_faults_main(dev, smi_line)
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
        phase = "train_sp_flash_timing"
        phase_sp_flash_timing(dev, smi_line)
        phase = "tp_flash_timing"
        phase_tp_flash_timing(dev, smi_line)
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
        engine, batch, train_launches, losses, train_ms = phase_train(
            dev, smi_line)
        # what the micro-step and async runs must land on, before the
        # profiled steps move the engine on
        train_ref = {"losses": losses, "step_ms_mean": train_ms,
                     "masters": host_masters(engine)}
        phase = "train_profile"
        train_ref["idle_share"] = phase_train_profile(engine, batch, dev,
                                                      smi_line)
        del engine                       # free the recipe's 40 GB
        _release()
        phase = "train_micro_steps"
        micro_launches = phase_train_micro_steps(batch, train_ref, dev,
                                                 smi_line)
        phase = "train_async"
        async_launches = phase_train_async(batch, train_ref, dev, smi_line)
        phase = "train_resume"
        resume_launches, serve_ckpt_launches = phase_train_resume(
            train_ref, dev, smi_line)
        del train_ref
        phase = "train_optimizers"
        phase_train_optimizers(batch, dev, smi_line)
        phase = "train_probe"
        plain_norm1 = phase_train_probe(batch, losses, dev, smi_line)
        phase = "train_qgz"
        qgz_launches = phase_train_qgz(batch, plain_norm1, dev, smi_line)
        _release()
        phase = "train_zero"
        zero_launches = phase_train_zero(batch, dev, smi_line)
        phase = "train_moe"
        moe_launches, moe_ref = phase_train_moe(dev, smi_line)
        tmp = tempfile.mkdtemp(prefix="dstpu-ranks-")
        try:
            phase = "train_ranks"
            spawn = phase_train_ranks(tmp)
            phase = "train_zero_ranks"
            zero_ranks_launches = phase_train_zero_ranks(dev, smi_line, tmp,
                                                         spawn)
            phase = "train_qgz_ranks"
            qgz_ranks_launches, coll_launches = phase_train_qgz_ranks(
                dev, smi_line, tmp, spawn)
            phase = "train_moe_ranks"
            moe_ranks_launches, moe_int8_launches = phase_train_moe_ranks(
                dev, smi_line, tmp, spawn)
            phase = "train_sp"
            sp_launches = phase_train_sp(dev, smi_line, tmp, spawn)
            phase = "infer_tp_ranks"
            infer_tp_launches = phase_infer_tp_ranks(dev, smi_line, tmp)
            phase = "train_zeropp_ranks"
            zeropp_launches, tp_train_launches = phase_train_zeropp_ranks(
                dev, smi_line, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        phase = "train_chunked_loss"
        chunked_launches = phase_train_chunked_loss(batch, dev, smi_line)
        phase = "train_offload_parity"
        phase_train_offload_parity(batch, dev, smi_line)
        phase = "train_offload"
        offload_launches, opt_peak = phase_train_offload(batch, dev, smi_line)
        phase = "train_param_offload"
        param_launches = phase_train_param_offload(batch, opt_peak, dev,
                                                   smi_line)
        tmp = tempfile.mkdtemp(prefix="dstpu-ranks-")
        try:
            phase = "train_offload_ranks"
            offload_ranks_launches, param_ranks_launches = \
                phase_train_tier_ranks(dev, smi_line, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        phase = "train_param_offload_moe"
        param_moe_launches = phase_train_param_offload_moe(moe_ref, dev,
                                                           smi_line)
        phase = "kernels"
        # each kernel's launches on every main path run it lies on, each run
        # with its own reset; the line's count is that of the path its
        # timing shape comes from (first listed)
        path_counts = {"serve": st["launches"], "serve_http": serve_launches,
                       "disagg": disagg_launches, "fleet": fleet_launches,
                       "train": train_launches,
                       "train_micro_steps": micro_launches,
                       "train_async": async_launches,
                       "train_resume": resume_launches,
                       "serve_from_checkpoint": serve_ckpt_launches,
                       "train_offload": offload_launches,
                       "train_param_offload": param_launches,
                       "train_offload_ranks": offload_ranks_launches,
                       "train_param_offload_ranks": param_ranks_launches,
                       "train_param_offload_moe": param_moe_launches,
                       "A1": zi["A1"]["path_launches"],
                       "A2": zi["A2"]["path_launches"], "B": qgz_launches,
                       "train_zero": zero_launches,
                       "train_zero_ranks": zero_ranks_launches,
                       "train_qgz_ranks": qgz_ranks_launches,
                       "train_zeropp_ranks": zeropp_launches,
                       "quant_collectives": coll_launches,
                       "serve_moe": serve_moe_launches,
                       "train_moe": moe_launches,
                       "train_moe_ranks": moe_ranks_launches,
                       "moe_int8": moe_int8_launches,
                       "train_sp": sp_launches,
                       "infer_tp_ranks": infer_tp_launches,
                       "train_tp_ranks": tp_train_launches,
                       "train_chunked_loss": chunked_launches,
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
    emit({"phase": "phase_seconds",
          "seconds": {k: round(v, 1) for k, v in _PHASE_SECONDS.items()},
          "total": round(time.monotonic() - _T0, 1)})
    emit({"kernels": rows})
    print(smi_line, flush=True)
    emit({"ok": True, "device": dev})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
