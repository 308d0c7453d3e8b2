"""Serving A/B on one card: two trees of this repo in the order A, B, B, A.

Each run is a fresh process in the tree's own directory. It times the paged
attention wrapper's host time per call at the serving batch's decode shape
(B=8, contexts drawn in 1-576, bf16, H=32, Hkv=8, d=128; the wall time of
back-to-back calls with no synchronize among them, so the card's time is
not in it), then serves that tree's ``chip_smoke.py`` engine phase
(Llama-3-8B bf16, 8 requests) and profiles its decode steps
(``phase_profile``, PROFILES times: each admits fresh prompts, times its
decode steps on the host clock, then again under the profiler, and its
sequences are flushed before the next). Order A,
B, B, A cancels a steady drift of the host. With ``--one-split``, B's
paged kernel is held to one split (its ``split_plan`` replaced) in two
more runs, b_one, placed in the middle: A, B, b_one, b_one, B, A.

    python3 chip_serve_ab.py --a build/parent --b . --out build/serve_ab

Writes each run's JSON lines to ``<out>/<label><i>.log`` and prints one
summary line per run; exits non-zero if a run fails.
"""

import argparse
import json
import os
import subprocess
import sys

HOST_CALLS, HOST_REPEATS = 500, 5
PROFILES = 3

RUN = f"""
import json, os, time, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
dev, smi = cs.phase_device()
import deepspeed_tpu_torch
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops.paged_attention import paged_attention
if os.environ.get("SERVE_AB_ONE_SPLIT") == "1":
    pa.split_plan = lambda b, hkv, fold, span, *_: (
        1, -(-span // pa.KEYS_PER_TILE))
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda")
gen.manual_seed(cs.SEED)
args, kw = cs._paged_inputs(gen, b=8, t=1, ctx=576, start=0, ragged=True)
us = []
for _ in range({HOST_REPEATS}):
    for _ in range(10):
        paged_attention(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range({HOST_CALLS}):
        paged_attention(*args, **kw)
    us.append((time.perf_counter() - t0) / {HOST_CALLS} * 1e6)
    torch.cuda.synchronize()
cs.emit({{"phase": "paged_host", "us_per_call": us, "nvidia_smi": smi}})
st, eng, lens = cs.phase_engine(dev, smi)
for _ in range({PROFILES}):
    cs.phase_profile(eng, lens, dev, smi)
    for seq in list(eng.state.all()):     # the next profile starts afresh
        eng.finish(seq.uid)
    eng.reap_finished()
"""


def summary(lines):
    rows = {"profile": []}
    for line in lines:
        try:
            row = json.loads(line)
        except ValueError:
            continue
        if not isinstance(row, dict):
            continue
        if row.get("phase") == "profile":
            rows["profile"].append(row)
        elif row.get("phase") in ("paged_host", "engine"):
            rows[row["phase"]] = row
    host, eng, profs = (rows.get(k, {}) for k in ("paged_host", "engine",
                                                  "profile"))

    def each(key):
        return [p.get(key) for p in profs]
    return {"paged_host_us": host.get("us_per_call"),
            "decode_tokens_per_s": eng.get("decode_tokens_per_s"),
            "step_ms": each("step_ms"),
            "step_ms_profiled": each("step_ms_profiled"),
            "busy_ms_per_step": each("device_busy_ms_per_step"),
            "idle_share": each("device_idle_share"),
            "kernels_per_step": each("kernels_per_step"),
            "nvidia_smi": host.get("nvidia_smi")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="tree run first and last")
    ap.add_argument("--b", required=True, help="tree run second and third")
    ap.add_argument("--out", default="build/serve_ab")
    ap.add_argument("--one-split", action="store_true",
                    help="add two runs of B held to one split")
    ap.add_argument("--timeout", type=int, default=600)
    opts = ap.parse_args()
    os.makedirs(opts.out, exist_ok=True)
    order = [("a", opts.a), ("b", opts.b)]
    if opts.one_split:
        order += [("b_one", opts.b)]
    order += order[1:][::-1] + [("a", opts.a)]
    failed = False
    for i, (label, tree) in enumerate(order):
        one = str(int(label == "b_one"))
        env = {**os.environ, "SERVE_AB_ONE_SPLIT": one}
        run = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env,
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
