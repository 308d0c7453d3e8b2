"""The MoE slice on the device, against the CPU: no JAX.

These run where the CPU tests cannot reach the kernels (``-m gpu`` on the
card) and, at the same sizes, on the CPU:

- the gating of the same fp32 router logits on the device equals the
  CPU's bit for bit: ``dispatch``, ``combine`` and the serving gate's
  experts and weights (the float64 softmax and the stable sort make them
  independent of the device's float32 ``exp``, reductions and ``topk``);
- both MoE serving policies at head_dim 32: the paged kernel (``auto``)
  against the plain paged attention (``gather``) at one prefill and one
  decode step, within ``chip_smoke.LOGITS_TOL`` of the logits' spread;
- ``chip_smoke.moe_ranks_body`` on two gloo ranks (the tiny Mixtral):
  ``expert=2`` against the one-rank run within twice the distance of the
  same sequences batched otherwise, the replicated masters the same bytes
  on both ranks, half the expert state a rank, the comm bytes of a step
  equal to the count from the shapes, and with ``quantized_dispatch``
  step 1's int8 combine bit for bit the same ``quantized_psum`` with the
  plain codec, with exactly 2 x layers x gas quantize and dequantize
  launches a step on the card.
"""

import dataclasses
import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


def _need(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the card)")


def _logits(t, e, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(t, e, generator=g) * 2
    x[0] = 0.0
    x[1, :3] = 4.0
    return x


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("e,k,norm", [(8, 2, True), (60, 4, False),
                                      (4, 2, True)])
def test_gating_on_the_device_equals_the_cpu(device, e, k, norm):
    _need(device)
    from deepspeed_tpu_torch.inference.v2.modules import serve_route
    from deepspeed_tpu_torch.moe.sharded_moe import MoEConfig, top_k_gating
    cfg = MoEConfig(num_experts=e, top_k=k, norm_topk_prob=norm)
    x = _logits(2048, e, seed=e + k)
    for cap in (3, 2048 * k // e + 4):
        want = top_k_gating(x, cfg, cap)
        got = top_k_gating(x.to(device), cfg, cap)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    for a, b in zip(serve_route(x.to(device), k, norm),
                    serve_route(x, k, norm)):
        assert torch.equal(a.cpu(), b)


def _small(family):
    """The family's tiny config at head_dim 32 (the paged kernel's
    smallest), fp32."""
    from deepspeed_tpu_torch.models.mixtral import TINY_MIXTRAL
    from deepspeed_tpu_torch.models.qwen2_moe import TINY_QWEN2_MOE
    cfg = {"mixtral": TINY_MIXTRAL, "qwen2_moe": TINY_QWEN2_MOE}[family]
    return dataclasses.replace(
        cfg, base=dataclasses.replace(cfg.base, hidden_size=128,
                                      dtype=torch.float32),
        moe=dataclasses.replace(cfg.moe, dtype=torch.float32))


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("family", ["mixtral", "qwen2_moe"])
def test_policy_kernel_vs_gather(device, family):
    _need(device)
    import chip_smoke
    from deepspeed_tpu_torch.models.convert import init_moe_params
    cfg = _small(family)
    assert cfg.base.head_dim_ == 32
    params = init_moe_params(cfg, seed=0, device=device)
    eng, prompts, outputs, st = chip_smoke.run_engine(
        cfg, torch.device(device), kv_num_blocks=32, prompt_lens=[40, 90],
        new_tokens=4, prefill_buckets=(128,), params=params)
    assert all(len(v) == 4 for v in outputs.values()) and st["logits_finite"]
    if device == "cuda":
        want = cfg.base.num_layers * (st["prefill_chunks"] +
                                      st["decode_steps"])
        assert st["launches"].get("paged_attention", 0) >= want
    auto = chip_smoke.prefill_decode_logits(eng, prompts[0], "auto")
    gather = chip_smoke.prefill_decode_logits(eng, prompts[0], "gather")
    for a, g in zip(auto, gather):
        spread = (g.max() - g.min()).item()
        assert (a - g).abs().max().item() <= chip_smoke.LOGITS_TOL * spread


@pytest.mark.parametrize("device", DEVICES)
def test_moe_ranks_body(device, tmp_path):
    _need(device)
    import chip_smoke
    from deepspeed_tpu_torch.testing import run_distributed
    layers = 2
    run_distributed("chip_smoke:moe_ranks_body", 2, timeout=120,
                    env={chip_smoke.RANK_OUT_ENV: str(tmp_path),
                         chip_smoke.RANK_DEVICE_ENV: device,
                         chip_smoke.RANK_MODEL_ENV: "tiny",
                         "DSTPU_SMOKE_LAYERS": str(layers)},
                    backend="gloo", device=device)
    rows = []
    for r in range(2):
        with open(tmp_path / f"moe_ranks{r}.json") as f:
            rows.append(json.load(f))
    flash, int8 = chip_smoke.check_moe_ranks(rows, layers, device, "tiny")
    ref = rows[0]["reference"]
    assert all(t > 0 for t in ref["tolerance"]["loss"])   # orderings differ
    assert rows[0]["runs"]["int8"]["combine_equal"]
    if device == "cuda":
        assert int8["quantize_int8"] > 0 and int8["dequantize_int8"] > 0
