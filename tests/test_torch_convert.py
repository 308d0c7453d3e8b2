"""Port parity: the Llama weight converter, the seeded initializer and one
``LlamaPolicy`` layer against the JAX package.

TINY_LLAMA in float32. The converter must carry every value over exactly;
one layer of the port's ``LlamaPolicy.block`` must match the JAX policy on
the same weights and inputs within float32 atol/rtol 1e-5 (matmuls sum in
other orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

# the JAX side needs jax and flax; the card's machine lacks flax
pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from deepspeed_tpu.inference.v2 import modules as jmodules
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.inference.v2 import modules as tmodules
from deepspeed_tpu_torch.inference.v2.llama_decode import _rms
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import (init_llama_params,
                                                llama_params_from_jax)


def torch_config(jcfg, dtype=torch.float32) -> tllama.LlamaConfig:
    names = {f.name for f in dataclasses.fields(tllama.LlamaConfig)} - {"dtype"}
    return tllama.LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                              dtype=dtype)


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32)
    model = jllama.LlamaForCausalLM(jcfg)
    batch = jllama.random_tokens(1, 8, vocab_size=jcfg.vocab_size)
    params = model.init(jax.random.PRNGKey(0), batch)["params"]
    return jcfg, params, jax.tree.map(np.asarray, params)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_converter_carries_every_value(tiny):
    jcfg, _, np_params = tiny
    tcfg = torch_config(jcfg)
    ported = _flatten(llama_params_from_jax(np_params, tcfg, device="cpu"))
    source = _flatten(np_params)
    assert ported.keys() == source.keys()
    for name, arr in source.items():
        np.testing.assert_array_equal(ported[name].numpy(), arr, err_msg=name)


def test_converter_casts_once_and_keeps_norms_fp32(tiny):
    jcfg, _, np_params = tiny
    tcfg = torch_config(jcfg, dtype=torch.bfloat16)
    ported = _flatten(llama_params_from_jax(np_params, tcfg, device="cpu"))
    for name, t in ported.items():
        fp32 = name.endswith("norm/scale") or name == "model/lm_head/kernel"
        assert t.dtype == (torch.float32 if fp32 else torch.bfloat16), name
    wq = ported["model/layer_0/attn/wq/kernel"]
    assert tuple(wq.shape) == (tcfg.hidden_size, tcfg.num_heads, tcfg.head_dim_)
    np.testing.assert_array_equal(
        wq.float().numpy(),
        np.asarray(jnp.asarray(np_params["model"]["layer_0"]["attn"]["wq"]
                               ["kernel"]).astype(jnp.bfloat16)
                   ).astype(np.float32))
    with pytest.raises(ValueError, match="shape"):
        llama_params_from_jax(np_params, dataclasses.replace(
            tcfg, hidden_size=64), device="cpu")


def test_random_init_builds_the_same_tree(tiny):
    jcfg, _, np_params = tiny
    tcfg = torch_config(jcfg, dtype=torch.bfloat16)
    a = _flatten(init_llama_params(tcfg, seed=3, device="cpu"))
    b = _flatten(init_llama_params(tcfg, seed=3, device="cpu"))
    c = _flatten(init_llama_params(tcfg, seed=4, device="cpu"))
    source = _flatten(np_params)
    assert a.keys() == source.keys()
    for name, arr in source.items():
        assert tuple(a[name].shape) == arr.shape, name
        assert a[name].device.type == "cpu"
        assert torch.equal(a[name], b[name]), name      # seeded
        if name.endswith("norm/scale"):
            assert a[name].dtype == torch.float32 and bool((a[name] == 1).all())
        else:
            head = name == "model/lm_head/kernel"          # the fp32 head
            assert a[name].dtype == (torch.float32 if head else torch.bfloat16)
            assert not torch.equal(a[name], c[name])


def test_rope_tables_and_rms_match_jax():
    for args in ((32, 64, 500000.0), (128, 4096, 10000.0)):
        for ours, ref in zip(tllama.rope_freqs(*args), jllama.rope_freqs(*args)):
            np.testing.assert_array_equal(ours, ref)     # bit-identical
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    from deepspeed_tpu.inference.v2.llama_decode import _rms as jax_rms
    np.testing.assert_allclose(
        _rms(torch.from_numpy(x), torch.from_numpy(scale), 1e-5).numpy(),
        np.asarray(jax_rms(jnp.asarray(x), jnp.asarray(scale), 1e-5)),
        atol=1e-6, rtol=1e-6)
    s = rng.normal(size=(4, 8)).astype(np.float32) * 100
    np.testing.assert_allclose(
        tllama.softcap_logits(torch.from_numpy(s), 30.0).numpy(),
        np.asarray(jllama.softcap_logits(jnp.asarray(s), 30.0)), rtol=1e-6)


def test_one_layer_block_matches_jax(tiny):
    """One ``LlamaPolicy.block`` with a causal attend on both sides."""
    jcfg, params, np_params = tiny
    tcfg = torch_config(jcfg)
    tparams = llama_params_from_jax(np_params, tcfg, device="cpu")
    rng = np.random.default_rng(1)
    n = 12
    x = rng.normal(size=(n, jcfg.hidden_size)).astype(np.float32)
    pos = np.arange(5, 5 + n, dtype=np.int32)
    rep = jcfg.num_heads // jcfg.num_kv_heads

    def jax_attend(q, k, v):
        return jllama._xla_attention(q[None], k[None], v[None])[0]

    def torch_attend(q, k, v):
        k = k.repeat_interleave(rep, 1)
        v = v.repeat_interleave(rep, 1)
        s = torch.einsum("qhd,khd->hqk", q, k) / np.sqrt(q.shape[-1])
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(), -1e30)
        return torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)

    want = jmodules.LlamaPolicy.block(params, 1, jnp.asarray(x), jax_attend,
                                      jnp.asarray(pos), jcfg)
    got = tmodules.LlamaPolicy.block(tparams, 1, torch.from_numpy(x),
                                     torch_attend, torch.from_numpy(pos).long(),
                                     tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    logits_j = jmodules.LlamaPolicy.unembed(params, jnp.asarray(x), jcfg)
    logits_t = tmodules.LlamaPolicy.unembed(tparams, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=1e-5, rtol=1e-5)
    assert tmodules.policy_for(tcfg) is tmodules.LlamaPolicy
    with pytest.raises(ValueError, match="no decode policy"):
        tmodules.policy_for(object())
