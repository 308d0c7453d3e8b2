"""Kernel A/B on one card: the evoformer forward and backward kernels, the
block-sparse forward, the int8 quantize and the fp8 dequantize of two trees
of this repo, in the order A, B, B, A.

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
  which a change to the int8 quantize must leave alone.

It also lists the kernel entries each call launched, by exact name. Order
A, B, B, A cancels a steady drift of the card. Two builds of one change
(another tiling, say) compare the same way: ``--a`` and ``--b`` are any two
trees.

    python3 chip_kernel_ab.py --a build/parent --b . --out build/kernel_ab

Writes each run's output to ``<out>/<label><i>.log`` and prints one summary
line per run; exits non-zero if a run fails.
"""

import argparse
import json
import os
import subprocess
import sys

RUN = """
import json, re, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
dev, smi = cs.phase_device()
from deepspeed_tpu_torch.ops import build
build.build(["evoformer", "sparse_attention", "quant"])   # in parallel
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
    out = {}
    for e in cs._device_events(fn, iters):
        m = re.match(r"(?:void\\s+)?(?:\\(anonymous namespace\\)::)?(\\w+)", e.name)
        out[m.group(1)] = out.get(m.group(1), 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return out


gen = torch.Generator(device="cuda")
gen.manual_seed(cs.SEED)
out = {}
for name in ("E1", "E4"):
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
for name, (_, b, s, h, d, _) in cs.SPARSE_PATHS.items():
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
for n, d in ((131072, 128), (128256, 4096), (4096, 14336), (4096, 128256)):
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
          for n, d in [(voc, hid)] + layer * 4 + [(1, hid), (hid, voc)]]
def qgz_step():
    for _ in range(2):
        for x in leaves:
            quantize_int8(x)
per = {e: t for e, t in entry_ms(qgz_step, 3).items() if "quantize_int8" in e}
out["quantize_int8_qgz_step"] = {"launches": 2 * len(leaves),
                                 "device_ms": sum(per.values()), "entries_ms": per}
del leaves
torch.cuda.empty_cache()
from deepspeed_tpu_torch.ops.fp_quant import dequantize_fp8, quantize_fp8
for where, (n, d) in cs.QUANT_TIMING_SHAPES.items():
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
    opts = ap.parse_args()
    os.makedirs(opts.out, exist_ok=True)
    order = [("a", opts.a), ("b", opts.b), ("b", opts.b), ("a", opts.a)]
    failed = False
    for i, (label, tree) in enumerate(order):
        run = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
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
