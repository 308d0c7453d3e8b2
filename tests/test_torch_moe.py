"""Port parity: the MoE slice (gating, ``MOELayer``, Mixtral, Qwen2-MoE,
their serving policies, HF interop) against the JAX package on the CPU.

- Gating: ``_capacity`` equals the reference's; ``top_k_gating``'s
  ``dispatch`` is bit for bit the reference's over a grid of expert counts,
  top-k, capacities with and without drops, ``norm_topk_prob`` on and off,
  with all-tie and partial-tie rows; ``combine`` holds the same kept slots
  with weights within ``COMBINE_RTOL`` (the reference's CPU ``exp`` is not
  correctly rounded; the port's float64 softmax is, and so is the same on
  the card); aux and z within 1e-7. RSample by its contract.
- ``MOELayer``: forward and every parameter gradient within 1e-5.
- Mixtral and Qwen2-MoE (tiny, fp32): loss, eval logits and every gradient
  within 1e-5 with the JAX parameters carried over by
  ``load_flax_params``; the same for a random numpy HF state dict through
  ``convert_hf_*``; ``*_config_from_hf`` field by field.
- Serving: both policies' greedy tokens equal the JAX ``InferenceEngineV2``'s
  and a full-recompute argmax of the training model's logits.
- The refusals of the slice's remainder, each naming ROADMAP Queue 1
  item 4; the attention's tensor-parallel rules, ported since, answer
  with Llama's (``tests/test_torch_tp.py`` holds them against JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu.models import mixtral as jmix  # noqa: E402
from deepspeed_tpu.models import qwen2_moe as jqwen  # noqa: E402
from deepspeed_tpu.moe import sharded_moe as jmoe  # noqa: E402
from deepspeed_tpu_torch.models import mixtral as tmix  # noqa: E402
from deepspeed_tpu_torch.models import qwen2_moe as tqwen  # noqa: E402
from deepspeed_tpu_torch.models.convert import (  # noqa: E402
    init_moe_params, load_flax_params, moe_param_shapes, moe_params_from_jax,
    to_flax_tree)
from deepspeed_tpu_torch.moe import sharded_moe as tmoe  # noqa: E402

# combine weights, relative: the reference's CPU exp and row sums round
# differently from the port's float64 softmax (up to ~8 ulps after the
# top-k renormalization)
COMBINE_RTOL = 1e-6
FAMILIES = {
    "mixtral": (jmix.TINY_MIXTRAL, jmix.MixtralForCausalLM,
                tmix.TINY_MIXTRAL, tmix.MixtralForCausalLM),
    "qwen2_moe": (jqwen.TINY_QWEN2_MOE, jqwen.Qwen2MoEForCausalLM,
                  tqwen.TINY_QWEN2_MOE, tqwen.Qwen2MoEForCausalLM),
}


def _fp32(cfg, dtype):
    return dataclasses.replace(
        cfg, base=dataclasses.replace(cfg.base, dtype=dtype),
        moe=dataclasses.replace(cfg.moe, dtype=dtype))


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("args", [(128, 8, 1.0, 4), (128, 8, 1.25, 4),
                                  (8, 8, 1.0, 4), (2048 * 2, 8, 1.25, 4),
                                  (512 * 4, 60, 2.0, 4), (7, 3, 1.1, 1)])
def test_capacity_equals_the_reference(args):
    assert tmoe._capacity(*args) == jmoe._capacity(*args)


def _gate_logits(t, e, seed):
    x = (np.random.default_rng(seed).normal(size=(t, e)) * 2).astype(np.float32)
    x[0] = 0.0                                  # every expert tied
    x[1] = 1.0
    x[2, [0, 1, e - 1]] = 5.0                   # a partial tie at the top
    x[3, ::2] = -1.0                            # a partial tie below it
    if e > 3:
        x[4, [1, 3]] = 2.5                      # a tie on the k-th place
    return x


GRID = [(e, k, norm, cap)
        for e in (2, 4, 8, 60) for k in (1, 2, 4) if k <= e
        for norm in (True, False) for cap in ("ample", "drops")]


@pytest.mark.parametrize("e,k,norm,cap", GRID,
                         ids=[f"E{e}-k{k}-{'norm' if n else 'raw'}-{c}"
                              for e, k, n, c in GRID])
def test_gating_matches_the_reference(e, k, norm, cap):
    t = 96
    x = _gate_logits(t, e, seed=e * 10 + k)
    capacity = tmoe._capacity(t * k, e, 2.0, 4) if cap == "ample" else 3
    jd, jc, ja, jz = jmoe.top_k_gating(
        jnp.asarray(x), jmoe.MoEConfig(num_experts=e, top_k=k,
                                       norm_topk_prob=norm), capacity)
    td, tc, ta, tz = tmoe.top_k_gating(
        torch.from_numpy(x), tmoe.MoEConfig(num_experts=e, top_k=k,
                                            norm_topk_prob=norm), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if cap == "drops":
        assert td.sum() < t * k                  # tokens were dropped
    tc, jc = tc.numpy(), np.asarray(jc)
    np.testing.assert_array_equal(tc > 0, jc > 0)
    np.testing.assert_allclose(tc, jc, rtol=COMBINE_RTOL, atol=0)
    assert abs(float(ta) - float(ja)) <= 1e-7
    assert abs(float(tz) - float(jz)) <= 1e-7


def test_ties_keep_the_lower_expert_first():
    """``jax.lax.top_k``'s order on ties; ``torch.topk`` has its own."""
    cfg = tmoe.MoEConfig(num_experts=8, top_k=2)
    rows = torch.tensor([[0.0] * 8, [0, 1, 1, 0, 1, 0, 0, 1.0]])
    r = tmoe.route(rows, cfg, capacity=8)
    assert r.experts.tolist() == [[0, 1], [1, 2]]
    j = jax.lax.top_k(jnp.asarray(rows.numpy()), 2)[1]
    assert np.asarray(j).tolist() == r.experts.tolist()


def test_gating_is_the_same_from_float64_probabilities():
    """The float64 softmax rounded once: a float32 softmax of the same
    logits may differ in its last bits, this does not depend on the
    device's float32 exp."""
    x = torch.from_numpy(_gate_logits(64, 60, 3))
    p = tmoe.gate_probs(x)
    want = torch.from_numpy(np.exp(x.numpy().astype(np.float64) -
                                   x.numpy().max(-1, keepdims=True)))
    want = (want / want.sum(-1, keepdim=True)).float()
    torch.testing.assert_close(p, want, rtol=0, atol=0)


def test_rsample_noise_contract():
    """RSample: the logits take N(0,1)/E noise drawn from the generator in
    training only; the same seed gives the same gating, another seed
    another one, eval ignores it (the draws are torch's, not jax.random's:
    ROADMAP divergence 30)."""
    e, t = 8, 256
    cfg = tmoe.MoEConfig(num_experts=e, top_k=2, noisy_gate_policy="RSample")
    x = torch.from_numpy(_gate_logits(t, e, 5)) * 0.01   # near ties: noise wins
    cap = tmoe._capacity(t * 2, e, 2.0, 4)
    runs = [tmoe.top_k_gating(x, cfg, cap,
                              generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][0], runs[2][0])
    plain = tmoe.top_k_gating(x, dataclasses.replace(
        cfg, noisy_gate_policy=None), cap)
    ev = tmoe.top_k_gating(x, cfg, cap, generator=torch.Generator()
                           .manual_seed(1), train=False)
    assert torch.equal(ev[1], plain[1])
    noise = tmoe.rsample_noise((t, e), torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(tmoe.top_k_gating(x, cfg, cap, noise=noise)[1],
                       runs[0][1])
    assert abs(float(noise.std()) * e - 1.0) < 0.1


def test_rsample_noise_survives_remat():
    """The model draws the noise before the blocks, so a checkpointed
    block's recompute sees it: remat on and off give the same gradients."""
    cfg = _fp32(tmix.TINY_MIXTRAL, torch.float32)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, noisy_gate_policy="RSample"))
    batch = {"input_ids": torch.from_numpy(
        jllama.random_tokens(2, 16, vocab_size=512)["input_ids"])}
    grads = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, base=dataclasses.replace(
            cfg.base, remat=remat))
        m = tmix.MixtralForCausalLM(c, device="cpu", seed=3)
        loss = m(batch, generator=torch.Generator().manual_seed(9))
        grads.append(torch.autograd.grad(loss, list(m.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_moe_layer_forward_and_grads_match(train):
    cfg_j = jmoe.MoEConfig(num_experts=4, top_k=2, dtype=jnp.float32)
    cfg_t = tmoe.MoEConfig(num_experts=4, top_k=2, dtype=torch.float32)
    x = np.random.default_rng(1).normal(size=(4, 16, 32)).astype(np.float32)
    layer = jmoe.MOELayer(cfg_j, hidden_size=32, intermediate_size=64)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x), train=train)

    def loss_fn(p, xx):
        out, aux = layer.apply(p, xx, train=train)
        return jnp.sum(out ** 2) + aux, out

    (_, jout), (gp, gx) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tl = tmoe.MOELayer(cfg_t, 32, 64, device="cpu")
    load_flax_params(tl, jax.tree.map(np.asarray, params["params"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tl(xt, train=train)
    ((out ** 2).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-5,
                               rtol=1e-5)
    got = to_flax_tree((n, p.grad) for n, p in tl.named_parameters())
    want = jax.tree.map(np.asarray, gp["params"])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, w, atol=1e-5, rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_moe_tensor_rules():
    assert tmoe.moe_tensor_rules("layer_0.moe.experts.w_gate",
                                 (8, 4, 16)) == ("expert", None, None)
    assert tmoe.moe_tensor_rules("layer_0/moe/experts/w_down",
                                 torch.empty(8, 16, 4)) == \
        ("expert", None, None)
    assert tmoe.moe_tensor_rules("layer_0.moe.gate.wg.kernel", (4, 8)) is None
    assert tmoe.moe_tensor_rules("layer_0.attn.wq.kernel", (4, 2, 2)) is None


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
def _jax_model(family, seed=0):
    jcfg, jcls, tcfg, tcls = FAMILIES[family]
    jc, tc = _fp32(jcfg, jnp.float32), _fp32(tcfg, torch.float32)
    batch = jllama.random_tokens(2, 16, vocab_size=512, seed=seed)
    model = jcls(jc)
    params = jax.tree.map(np.asarray,
                          model.init(jax.random.PRNGKey(seed), batch)["params"])
    return model, params, batch, tc, tcls


def _compare_model(model, params, batch, tmodel):
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: model.apply({"params": p}, batch)))(params)
    tb = {"input_ids": torch.from_numpy(batch["input_ids"])}
    tl = tmodel(tb)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    got = to_flax_tree((n, p.grad) for n, p in tmodel.named_parameters())
    for path, w in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jg))[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, w, atol=1e-5, rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    jlog = jax.jit(lambda p: model.apply({"params": p}, batch,
                                         method=type(model).logits))(params)
    with torch.no_grad():
        tlog = tmodel.logits(tb)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_model_loss_logits_grads_match(family):
    model, params, batch, tc, tcls = _jax_model(family)
    tmodel = tcls(tc, device="cpu")
    names = {n for n, _ in tmodel.named_parameters()}
    assert len(names) == len(jax.tree.leaves(params))
    load_flax_params(tmodel, params)
    _compare_model(model, params, batch, tmodel)


def _hf_mixtral_state(cfg, rng):
    b, e = cfg.base, cfg.moe.num_experts
    d, h, hkv, hd, f = (b.hidden_size, b.num_heads, b.num_kv_heads,
                        b.head_dim_, b.intermediate_size)
    r = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)  # noqa: E731
    sd = {"model.embed_tokens.weight": r(b.vocab_size, d),
          "model.norm.weight": 1 + r(d), "lm_head.weight": r(b.vocab_size, d)}
    for i in range(b.num_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": 1 + r(d),
                   p + "post_attention_layernorm.weight": 1 + r(d),
                   p + "self_attn.q_proj.weight": r(h * hd, d),
                   p + "self_attn.k_proj.weight": r(hkv * hd, d),
                   p + "self_attn.v_proj.weight": r(hkv * hd, d),
                   p + "self_attn.o_proj.weight": r(d, h * hd),
                   p + "block_sparse_moe.gate.weight": r(e, d)})
        for j in range(e):
            q = f"{p}block_sparse_moe.experts.{j}."
            sd.update({q + "w1.weight": r(f, d), q + "w2.weight": r(d, f),
                       q + "w3.weight": r(f, d)})
    return sd


def _hf_qwen_state(cfg, rng):
    b, e = cfg.base, cfg.moe.num_experts
    d, h, hkv, hd = b.hidden_size, b.num_heads, b.num_kv_heads, b.head_dim_
    f, fs = cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size
    r = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)  # noqa: E731
    sd = {"model.embed_tokens.weight": r(b.vocab_size, d),
          "model.norm.weight": 1 + r(d), "lm_head.weight": r(b.vocab_size, d)}
    for i in range(b.num_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": 1 + r(d),
                   p + "post_attention_layernorm.weight": 1 + r(d),
                   p + "self_attn.q_proj.weight": r(h * hd, d),
                   p + "self_attn.q_proj.bias": r(h * hd),
                   p + "self_attn.k_proj.weight": r(hkv * hd, d),
                   p + "self_attn.k_proj.bias": r(hkv * hd),
                   p + "self_attn.v_proj.weight": r(hkv * hd, d),
                   p + "self_attn.v_proj.bias": r(hkv * hd),
                   p + "self_attn.o_proj.weight": r(d, h * hd),
                   p + "mlp.gate.weight": r(e, d),
                   p + "mlp.shared_expert.gate_proj.weight": r(fs, d),
                   p + "mlp.shared_expert.up_proj.weight": r(fs, d),
                   p + "mlp.shared_expert.down_proj.weight": r(d, fs),
                   p + "mlp.shared_expert_gate.weight": r(1, d)})
        for j in range(e):
            q = f"{p}mlp.experts.{j}."
            sd.update({q + "gate_proj.weight": r(f, d),
                       q + "up_proj.weight": r(f, d),
                       q + "down_proj.weight": r(d, f)})
    return sd


HF = {"mixtral": (_hf_mixtral_state, jmix.convert_hf_mixtral,
                  tmix.convert_hf_mixtral),
      "qwen2_moe": (_hf_qwen_state, jqwen.convert_hf_qwen2_moe,
                    tqwen.convert_hf_qwen2_moe)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_convert_hf_matches_and_trains_alike(family):
    """A random numpy HF state dict (no transformers, no download) through
    both converters: the same trees, and the models on them alike."""
    model, _, batch, tc, tcls = _jax_model(family)
    make, jconv, tconv = HF[family]
    sd = make(tc, np.random.default_rng(4))
    jtree = jconv(sd, model.cfg)
    ttree = tconv(sd, tc)
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = jax.tree_util.tree_flatten_with_path(ttree)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (_, a), (_, b) in zip(jflat, tflat):
        np.testing.assert_array_equal(a, b)
    tmodel = load_flax_params(tcls(tc, device="cpu"), ttree)
    _compare_model(model, jax.tree.map(np.asarray, jtree), batch, tmodel)


def test_config_from_hf_field_by_field():
    mix = {"model_type": "mixtral", "vocab_size": 32000, "hidden_size": 4096,
           "intermediate_size": 14336, "num_hidden_layers": 32,
           "num_attention_heads": 32, "num_key_value_heads": 8,
           "num_local_experts": 8, "num_experts_per_tok": 2,
           "rope_theta": 1e6, "router_aux_loss_coef": 0.02,
           "sliding_window": 4096, "rms_norm_eps": 1e-5,
           "max_position_embeddings": 32768}
    qwen = {"vocab_size": 151936, "hidden_size": 2048,
            "intermediate_size": 5632, "num_hidden_layers": 24,
            "num_attention_heads": 16, "num_key_value_heads": 16,
            "num_experts": 60, "num_experts_per_tok": 4,
            "moe_intermediate_size": 1408,
            "shared_expert_intermediate_size": 5632, "rope_theta": 1e6,
            "max_position_embeddings": 8192, "rms_norm_eps": 1e-6}
    for conv_j, conv_t, hf in ((jmix.mixtral_config_from_hf,
                                tmix.mixtral_config_from_hf, mix),
                               (jqwen.qwen2_moe_config_from_hf,
                                tqwen.qwen2_moe_config_from_hf, qwen)):
        j, t = conv_j(hf), conv_t(hf)
        for f in dataclasses.fields(t):
            jv, tv = getattr(j, f.name), getattr(t, f.name)
            if dataclasses.is_dataclass(tv):
                _same_fields(jv, tv)
            else:
                assert tv == jv, f.name
    with pytest.raises(ValueError):
        tmix.mixtral_config_from_hf({**mix, "model_type": "mistral"})
    with pytest.raises(ValueError):
        tqwen.qwen2_moe_config_from_hf({**qwen, "decoder_sparse_step": 2})


def _same_fields(j, t):
    """Every field of the port's config (the dtype aside: a torch dtype
    there) equals the reference's."""
    for f in dataclasses.fields(t):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name


def test_presets_equal_the_reference():
    for j, t in ((jmix.MIXTRAL_8X7B, tmix.MIXTRAL_8X7B),
                 (jmix.TINY_MIXTRAL, tmix.TINY_MIXTRAL),
                 (jqwen.Qwen2MoEConfig(), tqwen.Qwen2MoEConfig()),
                 (jqwen.TINY_QWEN2_MOE, tqwen.TINY_QWEN2_MOE)):
        _same_fields(j.base, t.base)
        _same_fields(j.moe, t.moe)
        for f in dataclasses.fields(t):
            if f.name not in ("base", "moe"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_serving_policies_match_the_jax_engine(family):
    from deepspeed_tpu.inference.v2 import engine_v2 as jeng
    from deepspeed_tpu.inference.v2.scheduler import SchedulerConfig as JSched
    from deepspeed_tpu_torch.inference.v2 import engine_v2 as teng
    from deepspeed_tpu_torch.inference.v2.modules import (DECODE_POLICIES,
                                                          policy_for)
    from deepspeed_tpu_torch.inference.v2.scheduler import SchedulerConfig
    model, params, _, tc, tcls = _jax_model(family, seed=1)
    assert policy_for(tc) is DECODE_POLICIES[family]
    prompt = [int(t) for t in np.random.default_rng(9).integers(0, 512, 10)]
    kw = dict(kv_block_size=16, kv_num_blocks=64)
    jout = jeng.InferenceEngineV2(params, model.cfg, jeng.V2EngineConfig(
        scheduler=JSched(max_tokens_per_step=64,
                         prefill_buckets=(16, 32, 64)), **kw)).generate(
        list(prompt), max_new_tokens=4)
    tparams = moe_params_from_jax(params, tc, "cpu")
    tout = teng.InferenceEngineV2(tparams, tc, teng.V2EngineConfig(
        scheduler=SchedulerConfig(max_tokens_per_step=64,
                                  prefill_buckets=(16, 32, 64)), **kw),
        device="cpu").generate(list(prompt), max_new_tokens=4)
    assert tout == jout
    tmodel = load_flax_params(tcls(tc, device="cpu"), params)
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(4):
            logits = tmodel.logits({"input_ids": torch.tensor([ids])})
            ids.append(int(logits[0, -1].argmax()))
    assert tout == ids[len(prompt):]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_moe_params_tree(family):
    """``init_moe_params`` draws every leaf of the layout in its kind, on
    the device, from the seed."""
    tc = FAMILIES[family][2]
    a = init_moe_params(tc, seed=3, device="cpu")
    b = init_moe_params(tc, seed=3, device="cpu")
    shapes = moe_param_shapes(tc)
    flat = jax.tree_util.tree_flatten_with_path(a["model"])[0]
    assert len(flat) == len(shapes)
    for path, t in flat:
        name = "/".join(k.key for k in path)
        shape, kind, _ = shapes[name]
        assert tuple(t.shape) == shape
        assert t.dtype == (torch.float32 if kind == "fp32" else tc.base.dtype)
    for (_, x), (_, y) in zip(flat, jax.tree_util.tree_flatten_with_path(
            b["model"])[0]):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# what waits
# ---------------------------------------------------------------------------
REFUSED = [
    ({"mesh": {"expert": 2}, "zero_optimization": {"stage": 2}},
     "expert axis at stages 2-3"),
    ({"mesh": {"expert": 2}, "zero_optimization": {"stage": 3}},
     "expert axis at stages 2-3"),
    ({"mesh": {"expert": 2},
      "zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
     "memory tiers"),
    ({"mesh": {"expert": 2},
      "zero_optimization": {"offload_param": {"device": "cpu"}}},
     "memory tiers"),
]


@pytest.mark.parametrize("raw,match", REFUSED,
                         ids=["stage2", "stage3", "offload_optimizer",
                              "offload_param"])
def test_expert_axis_remainder_refused(raw, match):
    from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig
    with pytest.raises(NotImplementedError, match=match) as e:
        DeepSpeedTPUConfig(raw)
    assert "ROADMAP Queue 1 item 4: MoE" in str(e.value)


def test_expert_axis_runs_at_stages_0_and_1():
    from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig
    for stage in (0, 1):
        cfg = DeepSpeedTPUConfig({"mesh": {"expert": 2},
                                  "zero_optimization": {"stage": stage}})
        assert cfg.mesh.expert == 2


def test_offload_param_over_the_moe_stack_refused():
    """The MoE block stack streams where the reference's
    ``_MoEBlockStack`` does (``MixtralBlock``;
    ``tests/test_torch_offload_ranks.py`` holds it against JAX); a model of
    other blocks, Qwen2-MoE's, is refused by name, as the reference's
    stack fails on its params (ROADMAP Queue 3, divergence 49)."""
    from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig
    from deepspeed_tpu_torch.runtime.param_offload import \
        validate_param_offload
    cfg = DeepSpeedTPUConfig({"train_batch_size": 1, "zero_optimization": {
        "offload_param": {"device": "cpu"}}})
    model = tmix.MixtralForCausalLM(_fp32(tmix.TINY_MIXTRAL, torch.float32),
                                    device="cpu")
    validate_param_offload(cfg, model)
    qwen = tqwen.Qwen2MoEForCausalLM(tqwen.TINY_QWEN2_MOE, device="cpu")
    with pytest.raises(ValueError, match="Qwen2MoEForCausalLM's blocks are "
                                         "Qwen2MoEBlock"):
        validate_param_offload(cfg, qwen)


def test_tensor_parallel_rules_wait_for_item_2():
    from deepspeed_tpu_torch.comm.mesh import (MESH_AXES, Mesh,
                                               set_global_mesh)
    mesh = Mesh.__new__(Mesh)
    mesh.shape = {a: 1 for a in MESH_AXES}
    mesh.shape["tensor"] = 2
    set_global_mesh(mesh)
    try:
        for rules in (tmix.mixtral_tensor_rules,
                      tqwen.qwen2_moe_tensor_rules):
            assert rules("layer_0.moe.experts.w_up", (4, 8, 8)) == \
                ("expert", None, None)
            # ported since (tests/test_torch_tp.py): the attention's
            # Megatron rules, llama_tensor_rules' heads
            assert rules("layer_0.attn.wq.kernel", (8, 2, 4)) == \
                (None, "tensor", None)
    finally:
        set_global_mesh(None)


def test_noisy_gating_through_train_batch_refused():
    import deepspeed_tpu_torch
    cfg = _fp32(tmix.TINY_MIXTRAL, torch.float32)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, noisy_gate_policy="RSample"))
    with pytest.raises(NotImplementedError, match="dropout rng stream"):
        deepspeed_tpu_torch.initialize(
            model=tmix.MixtralForCausalLM(cfg, device="cpu"),
            config={"train_batch_size": 2}, device="cpu")


def test_engine_trains_mixtral_on_one_rank_like_the_jax_engine():
    """Stage 0 at one rank: three steps' losses, norms and masters within
    1e-5 of the JAX engine's on the same parameters and batches."""
    import os
    import sys
    import warnings

    import deepspeed_tpu
    import deepspeed_tpu_torch
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_moe_ranks as ranks
    from jax.sharding import Mesh

    from deepspeed_tpu.comm import mesh as jmesh
    model, params, _, tc, tcls = _jax_model("mixtral")
    cfg = ranks.engine_config(0, {}, False, 2)
    one = Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(
        jmesh.MESH_AXES)), jmesh.MESH_AXES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jeng, *_ = deepspeed_tpu.initialize(model=model, config=cfg,
                                            model_parameters=params,
                                            mesh=one)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tcls(tc, device="cpu"), config=cfg, model_parameters=params,
        device="cpu")
    for b in ranks.batches(2):
        jl = float(jeng.train_batch(batch=b, stacked=True))
        tl = float(teng.train_batch(batch=b, stacked=True))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        np.testing.assert_allclose(teng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-5)
    want = jax.tree.map(np.asarray, jeng.module_state_dict())
    got = teng.get_params()
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, w, atol=1e-5, rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("sizes", [{"data": 2, "expert": 2},
                                   {"fsdp": 2, "expert": 2},
                                   {"expert": 4, "data": 1}])
@pytest.mark.parametrize("stage", [0, 1, 3])
def test_build_param_specs_match_the_reference(sizes, stage):
    """``build_param_specs`` with the expert rules gives the reference's
    ``build_param_shardings`` specs for every Mixtral leaf, and the
    optimizer-state specs layered on them match too."""
    from jax.sharding import Mesh as JMesh

    from deepspeed_tpu.comm import mesh as jmesh
    from deepspeed_tpu.runtime.zero import partition as jpart
    from deepspeed_tpu_torch.comm import mesh as tmesh
    from deepspeed_tpu_torch.config.config import MeshConfig
    from deepspeed_tpu_torch.runtime.zero import partition as tpart
    _, params, _, tc, tcls = _jax_model("mixtral")
    w = int(np.prod(list(sizes.values())))
    full = tmesh.resolve_axis_sizes(MeshConfig(**sizes), w)
    jm = JMesh(np.array(jax.devices()[:w]).reshape(
        tuple(full[a] for a in jmesh.MESH_AXES)), jmesh.MESH_AXES)
    tm = tmesh.Mesh.__new__(tmesh.Mesh)
    tm.shape = dict(full)
    want = jpart.build_param_shardings(params, jm, stage,
                                       tensor_rules=jmoe.moe_tensor_rules)
    named = {n: tuple(p.shape) for n, p in
             tcls(tc, device="cpu").named_parameters()}
    got = tpart.build_param_specs(named, tm, stage, tmoe.moe_tensor_rules)
    axes, fsdp = tpart.zero_fsdp_axes(tm)
    t_opt = tpart.optimizer_state_spec_fn(None, stage, fsdp, fsdp_axes=axes)
    j_opt = jpart.optimizer_state_spec_fn(None, stage, fsdp, fsdp_axes=axes)
    for path, sh in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        name = ".".join(k.key for k in path)
        assert got[name] == tuple(sh.spec), name
        assert t_opt(got[name], named[name]) == \
            tuple(j_opt(sh.spec, named[name])), name
    assert sum("expert" in (s or ()) for s in got.values()) == 6
