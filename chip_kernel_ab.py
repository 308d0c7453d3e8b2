"""Kernel A/B on one card: the evoformer forward and backward kernels, the
block-sparse forward, the int8 quantize, the fp8 dequantize and the slice-5
row kernels of two trees of this repo, in the order A, B, B, A.

Each run is a fresh process in the tree's own directory that builds that
tree's kernels and times, by the profiler's device time (the tree's
``chip_smoke._device_events``) and by CUDA events over wrapper calls:

- ``evo_fwd`` at E1 (``[1, 512, 384, 8, 32]``, mask and pair bias) and E4
  (``[1, 5120, 384, 8, 8]``, mask and pair bias), bf16, OpenFold's widths
  (every kernel whose name holds ``evo_fwd_kernel``);
- the backward at E1 and E4 (the pair bias's gradient, not the mask's),
  each entry by its exact name; ``evo_dq`` and ``evo_dkv`` sum the entries
  whose names hold them, ``evo_dbias2`` its kernel and combine; and at E1
  again with the mask's gradient, ``evo_dbias1`` the entry whose name
  holds it;
- ``sparse_attention`` at S1 (BigBird-base, block 64) and S2 (Fixed, block
  16, causal), B=4, S=4096, 12 heads, D=64, bf16;
- ``quantize_int8`` (fp32 in) at qgZ's four row widths, each at its
  largest leaf of the 4-layer Llama-3-8B recipe ([131072, 128], [128256,
  4096], [4096, 14336], [4096, 128256]), the entries whose names hold it,
  and over one qgZ step's 78 launches (2 micro-batches of the recipe's 39
  leaves, seeded fp32);
- ``dequantize_fp8`` (e4m3) at ``chip_smoke.QUANT_TIMING_SHAPES``: A1's
  ``w_gate`` [917504, 64] to bf16 and the qgZ lm_head [4096, 128256] to
  fp32, and one whole-store ``dequantize_model_params`` of A1's store
  (Llama-3-8B, 32 layers, fp8 in groups of 64, seeded weights) to bf16:
  the kernel's device time summed over the call's 226 launches; at the
  two shapes also ``quantize_fp8`` and ``dequantize_int8`` (to bf16 / fp32),
  which a change to the int8 quantize must leave alone;
- the four ``bias_act*`` kernels at F (BERT-base's FFN, [8192, 3072] bf16,
  an fp32 bias, gelu, dropout rate 0.1, ``chip_smoke.BIAS_ACT_PATH``), each
  by its exact entry name, with the wrapper's events time and host us per
  call; the dropout pair also in fp32 at F; ``rms_norm`` at R ([2048,
  4096] bf16, an fp32 scale); and the SASS of the ``fused_bias_act``
  library: per entry, its registers and spill bytes, its instructions in
  all and its 128-bit loads and stores, 64-bit products, high-word
  products and int-to-float converts,
  and the instructions of its row loop (the longest backward branch's
  span) with the same classes and the 3-input logic ops counted there.

``--parts`` picks the sections (``evo``, ``sparse``, ``quant``, ``fp8``,
``store``, ``slice5``; all by default). It also lists the kernel entries each call launched, by exact name. Order
A, B, B, A cancels a steady drift of the card. Two builds of one change
(another tiling, say) compare the same way: ``--a`` and ``--b`` are any two
trees.

    python3 chip_kernel_ab.py --a build/parent --b . --out build/kernel_ab
    python3 chip_kernel_ab.py --a build/parent --b . --parts slice5

Writes each run's output to ``<out>/<label><i>.log`` and prints one summary
line per run; exits non-zero if a run fails.
"""

import argparse
import json
import os
import subprocess
import sys

PARTS = ("evo", "sparse", "quant", "fp8", "store", "slice5")
# {entry: its row loop's instructions and op counts} of a library's SASS:
# the loop is the span of the longest backward branch (SASS instructions
# are 16 bytes on sm_90)
SASS_LOOPS = r"""
def sass_loops(path, stem, ops):
    import os, re, subprocess
    from deepspeed_tpu_torch.ops import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "--dump-sass", str(path)], capture_output=True,
                          text=True, timeout=300).stdout
    fns, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = fns.setdefault(m.group(1), []) if stem in m.group(1) else None
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)([^;]*)",
                      line)
        if cur is not None and m:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    out = {}
    for name, ins in fns.items():
        lo = hi = None
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            if t and int(t.group(1), 16) < addr and (
                    lo is None or addr - int(t.group(1), 16) > hi - lo):
                lo, hi = int(t.group(1), 16), addr
        body = [op for addr, op, _ in ins if lo is not None and lo <= addr <= hi]
        out[name] = {"loop_instructions": len(body),
                     **{"loop_" + o: sum(b.startswith(o) for b in body) for o in ops}}
    return out
"""
RUN = """
import json, re, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
dev, smi = cs.phase_device()
parts = sys.argv[1].split(",")
from deepspeed_tpu_torch.ops import build
build.build([lib for part, lib in (("evo", "evoformer"),
                                   ("sparse", "sparse_attention"),
                                   ("quant", "quant"), ("fp8", "quant"),
                                   ("store", "quant"), ("slice5", "fused_bias_act"),
                                   ("slice5", "rms_norm")) if part in parts])
from deepspeed_tpu_torch.ops.evoformer import canonicalize, evo_bwd, evo_fwd
from deepspeed_tpu_torch.ops.sparse_attention import (SparseLayout,
                                                      sparse_attention_cuda)
torch.backends.cuda.matmul.allow_tf32 = False


def entries(fn):
    names = {re.sub(r"\\(anonymous namespace\\)::", "", e.name)
             for e in cs._device_events(fn, 1)}
    return sorted({re.match(r"(?:void )?(\\w+)", n).group(1) for n in names})


def timed(fn, stem):
    return {"device_ms": cs._kernel_device_ms(fn, [stem])[stem],
            "wrapper_ms": cs.time_ms(fn, iters=10), "entries": entries(fn)}


def entry_ms(fn, iters):
    # a window that lost events (a count not a multiple of iters) is taken
    # again; the mean event times the launches per call stays right if not
    for _ in range(8):
        durations = {}
        for e in cs._device_events(fn, iters):
            m = re.match(r"(?:void\\s+)?(?:\\(anonymous namespace\\)::)?(\\w+)", e.name)
            durations.setdefault(m.group(1), []).append(e.time_range.elapsed_us())
        if all(len(t) % iters == 0 for t in durations.values()):
            break
    return {k: sum(t) / len(t) * max(1, round(len(t) / iters)) / 1e3
            for k, t in durations.items()}


gen = torch.Generator(device="cuda")
gen.manual_seed(cs.SEED)
out = {}
for name in ("E1", "E4") if "evo" in parts else ():
    _, n, l, h, d, pair, _ = cs.EVO_PATH_CASES[name]
    (q, k, v, do), mask, pair_bias = cs._evo_path_inputs(gen, n, l, h, d, pair)
    q5, k5, v5, b1, b2 = canonicalize(q, k, v, [mask, pair_bias])
    b1, b2 = b1.contiguous(), b2.contiguous()
    out[name] = timed(lambda: evo_fwd(q5, k5, v5, b1, b2), "evo_fwd_kernel")
    o, lse = evo_fwd(q5, k5, v5, b1, b2)
    bwd = lambda: evo_bwd(q5, k5, v5, b1, b2, o, lse, do, need_db1=False)
    per = entry_ms(bwd, 5 if name == "E1" else 3)
    out[name + "_bwd"] = {
        "entries_ms": per, "wrapper_ms": cs.time_ms(bwd, iters=5),
        **{kn: sum(t for e, t in per.items() if kn in e)
           for kn in ("evo_dq", "evo_dkv", "evo_dbias2")}}
    if name == "E1":                   # the mask takes a gradient here alone
        bwd1 = lambda: evo_bwd(q5, k5, v5, b1, b2, o, lse, do)
        per = entry_ms(bwd1, 5)
        out["E1_bwd_db1"] = {
            "entries_ms": per, "wrapper_ms": cs.time_ms(bwd1, iters=5),
            "evo_dbias1": sum(t for e, t in per.items() if "evo_dbias1" in e)}
    del q, k, v, do, mask, pair_bias, q5, k5, v5, b1, b2, o, lse
    torch.cuda.empty_cache()
for name, (_, b, s, h, d, _) in (cs.SPARSE_PATHS.items()
                                  if "sparse" in parts else ()):
    cfg = cs._sparse_path_config(name)
    lay = SparseLayout(cfg.make_layout(s))
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out[name] = timed(lambda: sparse_attention_cuda(q, k, v, lay, cfg.block,
                                                    name == "S2"),
                      "sparse_attention_kernel")
    del q, k, v
torch.cuda.empty_cache()
from deepspeed_tpu_torch.ops.quant import dequantize_int8, quantize_int8
for n, d in ((131072, 128), (128256, 4096), (4096, 14336), (4096, 128256)) \\
        if "quant" in parts else ():
    x = torch.randn(n, d, generator=gen, device="cuda")
    quant = lambda: quantize_int8(x)
    per = {e: t for e, t in entry_ms(quant, 10).items() if "quantize_int8" in e}
    out[f"quantize_int8_{d}"] = {"shape": [n, d], "device_ms": sum(per.values()),
                                 "entries_ms": per,
                                 "wrapper_ms": cs.time_ms(quant, iters=10)}
    del x
    torch.cuda.empty_cache()
# one qgZ step of the 4-layer Llama-3-8B recipe: 2 micro-batches of its 39
# leaves of at least 2048 elements, as [n, d] with rows the last axis
hid, ffn, voc, heads, kv, hd = 4096, 14336, 128256, 32, 8, 128
layer = [(hid * heads, hd), (hid * kv, hd), (hid * kv, hd), (heads * hd, hid),
         (hid, ffn), (hid, ffn), (ffn, hid), (1, hid), (1, hid)]
leaves = [torch.randn(n, d, generator=gen, device="cuda")
          for n, d in [(voc, hid)] + layer * 4 + [(1, hid), (hid, voc)]] \\
    if "quant" in parts else []
def qgz_step():
    for _ in range(2):
        for x in leaves:
            quantize_int8(x)
if leaves:
    per = {e: t for e, t in entry_ms(qgz_step, 3).items() if "quantize_int8" in e}
    out["quantize_int8_qgz_step"] = {"launches": 2 * len(leaves),
                                     "device_ms": sum(per.values()),
                                     "entries_ms": per}
del leaves
torch.cuda.empty_cache()
from deepspeed_tpu_torch.ops.fp_quant import dequantize_fp8, quantize_fp8
for where, (n, d) in (cs.QUANT_TIMING_SHAPES.items()
                     if "fp8" in parts else ()):
    x = torch.randn(n, d, generator=gen, device="cuda")
    qc, sc = quantize_fp8(x)
    dt = torch.bfloat16 if where.startswith("A1") else torch.float32
    deq = lambda: dequantize_fp8(qc, sc, dt)
    out["dequantize_fp8_" + where] = {
        "device_ms": cs._kernel_device_ms(deq, ["dequantize_fp8"],
                                          iters=20)["dequantize_fp8"],
        "wrapper_ms": cs.time_ms(deq, iters=20), "entries": entries(deq)}
    # kernels this A/B must leave alone: the fp8 quantize, the int8 dequantize
    out["quantize_fp8_" + where] = {"device_ms": cs._kernel_device_ms(
        lambda: quantize_fp8(x), ["quantize_fp8"], iters=20)["quantize_fp8"]}
    qi, si = quantize_int8(x)
    out["dequantize_int8_" + where] = {"device_ms": cs._kernel_device_ms(
        lambda: dequantize_int8(qi, si, dt), ["dequantize_int8"],
        iters=20)["dequantize_int8"]}
    del x, qc, sc, qi, si
if "store" in parts:
    from deepspeed_tpu_torch.inference.zero_inference import (
        dequantize_model_params, quantize_model_params)
    from deepspeed_tpu_torch.models.convert import init_llama_params
    from deepspeed_tpu_torch.models.llama import LLAMA3_8B
    params = init_llama_params(LLAMA3_8B, seed=cs.SEED, device="cuda")
    store = quantize_model_params(params, q_bits=8, group_size=64, fmt="fp")
    del params
    torch.cuda.empty_cache()
    deq = lambda: dequantize_model_params(store, torch.bfloat16)
    out["dequantize_fp8_A1_store"] = {
        "device_ms": cs._kernel_device_ms(deq, ["dequantize_fp8"],
                                          iters=3)["dequantize_fp8"],
        "wrapper_ms": cs.time_ms(deq, iters=3, warmup=1)}
    del store
    torch.cuda.empty_cache()


def exact(fn, entry, iters=20):
    per = entry_ms(fn, iters)
    if entry not in per:
        raise RuntimeError(f"no kernel entry named {entry}: {sorted(per)}")
    return {"device_ms": per[entry], "wrapper_ms": cs.time_ms(fn, iters=50),
            "host_us": cs.host_us(fn), "entries": sorted(per)}


if "slice5" in parts:
    from deepspeed_tpu_torch.ops.fused_bias_act import (
        bias_act_bwd, bias_act_dropout_bwd, bias_act_dropout_fwd, bias_act_fwd)
    from deepspeed_tpu_torch.ops.rms_norm import rms_norm_cuda
    n, d = cs.BIAS_ACT_PATH
    sd, rate = cs.DROPOUT_SEED, cs.DROPOUT_RATE
    for dt in (torch.bfloat16, torch.float32):
        x, g = (torch.randn(n, d, generator=gen, device="cuda").to(dt)
                for _ in range(2))
        bias = 0.1 * torch.randn(d, generator=gen, device="cuda")
        calls = {"bias_act_dropout": lambda: bias_act_dropout_fwd(x, bias, sd,
                                                                  "gelu", rate),
                 "bias_act_dropout_bwd": lambda: bias_act_dropout_bwd(
                     x, bias, g, sd, "gelu", rate)}
        if dt == torch.bfloat16:
            calls.update({"bias_act": lambda: bias_act_fwd(x, bias),
                          "bias_act_bwd": lambda: bias_act_bwd(x, bias, g)})
        for k, fn in calls.items():
            key = "F_" + k + ("" if dt == torch.bfloat16 else "_f32")
            out[key] = exact(fn, k + "_kernel")
        del x, g
    n, d = cs.RMS_PATH
    x = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    rms = lambda: rms_norm_cuda(x, scale, cs.RMS_EPS)
    per = {e: t for e, t in entry_ms(rms, 20).items() if e.startswith("rms_norm")}
    out["R_rms_norm"] = {"device_ms": sum(per.values()), "entries_ms": per,
                         "wrapper_ms": cs.time_ms(rms, iters=50),
                         "host_us": cs.host_us(rms)}
    del x
    lib = build.build(["fused_bias_act"])["fused_bias_act"]
    ptxas = dict(zip(cs._demangle(re.findall(r"Compiling entry function '(\\S+)'",
                                             lib.log)),
                     zip(re.findall(r"Used (\\d+) registers", lib.log),
                         re.findall(r"(\\d+) bytes spill stores", lib.log))))
    loops = sass_loops(lib.path, "bias_act", ("IMAD.WIDE.U32", "IMAD.HI.U32",
                                              "IMAD", "LOP3", "I2F", "MUFU"))
    loops = dict(zip(cs._demangle(list(loops)), loops.values()))
    out["fused_bias_act_sass"] = {
        k: {**v, **dict(zip(("registers", "spill_stores"), ptxas.get(k, ()))),
            **loops.get(k, {})}
        for k, v in cs._sass_counts(
            lib.path, ("bias_act",),
            (r"/\\*[0-9a-f]{4,}\\*/\\s+[@A-Z]", r"LDG\\.E\\.128",
             r"STG\\.E\\.128", r"IMAD\\.WIDE\\.U32", r"IMAD\\.HI\\.U32",
             r"I2F")).items()}
    torch.cuda.empty_cache()
print(json.dumps({"kernel_ab": out, "nvidia_smi": smi}), flush=True)
"""


def summary(lines):
    for line in lines:
        try:
            row = json.loads(line)
        except ValueError:
            continue
        if isinstance(row, dict) and "kernel_ab" in row:
            return row
    return {}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="tree run first and last")
    ap.add_argument("--b", required=True, help="tree run second and third")
    ap.add_argument("--out", default="build/kernel_ab")
    ap.add_argument("--timeout", type=int, default=600)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated sections of {PARTS}")
    opts = ap.parse_args()
    bad = set(opts.parts.split(",")) - set(PARTS)
    if bad:
        ap.error(f"unknown parts {sorted(bad)}; choose from {PARTS}")
    os.makedirs(opts.out, exist_ok=True)
    order = [("a", opts.a), ("b", opts.b), ("b", opts.b), ("a", opts.a)]
    failed = False
    for i, (label, tree) in enumerate(order):
        run = subprocess.run([sys.executable, "-c", SASS_LOOPS + RUN, opts.parts],
                             cwd=tree,
                             capture_output=True, text=True,
                             timeout=opts.timeout)
        with open(os.path.join(opts.out, f"{label}{i}.log"), "w") as f:
            f.write(run.stdout + run.stderr)
        failed |= run.returncode != 0
        print(json.dumps({"run": f"{label}{i}", "tree": tree,
                          "rc": run.returncode,
                          **summary(run.stdout.splitlines())}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
