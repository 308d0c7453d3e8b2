"""Port parity: ZeRO-Inference (``inference/zero_inference.py``) against the
JAX package.

A tiny float32 Llama (the JAX suite's model, with grouped KV heads), the
same flax weights on both sides (``llama_params_from_jax``):

- ``quantize_model_params`` for int8, int4, fp6, fp8 and fp12: the same
  leaves quantized, codes and scales bit-identical (fp8: one-ulp code
  differences counted and held rare), module scoping and
  ``quantized_nbytes`` equal;
- ``dequantize_model_params`` on one store (the JAX store converted by
  ``quantized_tree_from_jax``) bit-identical to the JAX function, which
  shows that routing int8 and fp8 through the dequantize kernels computes
  the reference's function (fp12 decodes small exponents a few ulps apart:
  XLA's exp2 on the CPU is inexact there, torch's is exact);
- resident and streamed forward logits within 1e-5 of the JAX engine's (a
  whole forward; the matmuls sum in other orders), with and without the
  gemma-style knobs;
- resident and streamed greedy ``generate`` token-identical to JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deepspeed_tpu.inference import zero_inference as jzi  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu_torch.inference import zero_inference as tzi  # noqa: E402
from deepspeed_tpu_torch.models import llama as tllama  # noqa: E402
from deepspeed_tpu_torch.models.convert import llama_params_from_jax  # noqa: E402
from deepspeed_tpu_torch.ops import build  # noqa: E402

FORMATS = {"int8": dict(q_bits=8, fmt="int"), "int4": dict(q_bits=4, fmt="int"),
           "fp6": dict(q_bits=6, fmt="fp"), "fp8": dict(q_bits=8, fmt="fp"),
           "fp12": dict(q_bits=12, fmt="fp")}
LOGITS_TOL = 1e-5
GEMMA = dict(tie_embeddings=True, hidden_act="gelu_tanh", rms_scale_offset=True,
             scale_embeddings=True, logits_soft_cap=20.0, sliding_window=6)


def _model(**knobs):
    jcfg = jllama.LlamaConfig(vocab_size=256, hidden_size=64,
                              intermediate_size=128, num_layers=2, num_heads=4,
                              num_kv_heads=2, max_seq_len=128,
                              dtype=jnp.float32, **knobs)
    model = jllama.LlamaForCausalLM(jcfg)
    params = model.init(jax.random.PRNGKey(0), jllama.random_tokens(
        2, 16, vocab_size=jcfg.vocab_size))["params"]
    params = jax.tree.map(np.asarray, params)
    names = {f.name for f in dataclasses.fields(tllama.LlamaConfig)} - {"dtype"}
    tcfg = tllama.LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                              dtype=torch.float32)
    return jcfg, model, params, tcfg, llama_params_from_jax(params, tcfg, "cpu")


@pytest.fixture(scope="module")
def tiny():
    return _model()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + "/") if isinstance(v, dict) else {name: v})
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _tbits(t):
    return _bits(t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                      4: torch.int32}[t.element_size()]
                                     ).numpy())


@pytest.mark.parametrize("name", list(FORMATS))
def test_quantize_model_params_matches_jax(tiny, name):
    _, _, params, _, tparams = tiny
    kw = FORMATS[name]
    jq = _flat(jzi.quantize_model_params(params, group_size=64, **kw))
    tq = _flat(tzi.quantize_model_params(tparams, group_size=64, **kw))
    assert jq.keys() == tq.keys()
    one_ulp, elems = 0, 0
    for path, jleaf in jq.items():
        tleaf = tq[path]
        if not isinstance(jleaf, jzi.QuantizedTensor):
            assert not isinstance(tleaf, tzi.QuantizedTensor), path
            np.testing.assert_array_equal(tleaf.numpy(), jleaf, err_msg=path)
            continue
        assert (tleaf.shape, tleaf.fmt) == (jleaf.shape, jleaf.fmt), path
        np.testing.assert_array_equal(_tbits(tleaf.scale), _bits(jleaf.scale),
                                      err_msg=path)
        got, want = _tbits(tleaf.codes), _bits(jleaf.codes)
        assert got.shape == want.shape, path
        if name == "fp8":     # sign-magnitude codes: count one-ulp flips
            dist = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert np.all((dist <= 1) | (got == want)), path
            one_ulp += int((got != want).sum())
            elems += got.size
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    assert one_ulp <= 1e-3 * max(elems, 1)
    assert tzi.quantized_nbytes(tzi.quantize_model_params(
        tparams, group_size=64, **kw)) == jzi.quantized_nbytes(
        jzi.quantize_model_params(params, group_size=64, **kw))


@pytest.mark.parametrize("name", list(FORMATS))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_dequantize_model_params_matches_jax(tiny, name, dtype):
    """One store (the JAX one, converted) through both functions."""
    _, _, params, _, _ = tiny
    jstore = jzi.quantize_model_params(params, group_size=64, **FORMATS[name])
    tstore = tzi.quantized_tree_from_jax(jstore, device="cpu")
    jd = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    td = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    want = _flat(jax.tree.map(np.asarray, jzi.dequantize_model_params(
        jstore, jd)))
    got = _flat(tzi.dequantize_model_params(tstore, td))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        if name != "fp12":
            np.testing.assert_array_equal(_tbits(g), _bits(w), err_msg=path)
        else:            # a few fp32 ulps, which a bf16 cast may round apart
            np.testing.assert_allclose(
                g.float().numpy(), w.astype(np.float32), atol=0,
                rtol=1e-6 if dtype == "fp32" else 2.0 ** -8, err_msg=path)


def test_module_scoping_and_options(tiny):
    _, _, params, _, tparams = tiny
    q = tzi.quantize_model_params(tparams, modules=["mlp/"])
    jq = jzi.quantize_model_params(params, modules=["mlp/"])
    kinds = {p: isinstance(v, tzi.QuantizedTensor) for p, v in _flat(q).items()}
    assert kinds == {p: isinstance(v, jzi.QuantizedTensor)
                     for p, v in _flat(jq).items()}
    assert kinds["model/layer_0/mlp/w_gate/kernel"]
    assert not kinds["model/layer_0/attn/wq/kernel"]
    assert q["model"]["layer_0"]["mlp"]["w_up"]["kernel"].codes.dtype == torch.int8
    for kw, match in ((dict(q_bits=4, group_size=63), "two codes per byte"),
                      (dict(fmt="fp", q_bits=6, group_size=62), "packs 4"),
                      (dict(fmt="fp", q_bits=4), "6, 8, 12"),
                      (dict(fmt="nf"), "'int' or 'fp'")):
        with pytest.raises(ValueError, match=match):
            tzi.quantize_model_params(tparams, **kw)
    with pytest.raises(ValueError, match="offload"):
        tzi.ZeROInferenceEngine(None, tparams, offload="nvme", device="cpu")


def _engines(model_tuple, offload, **kw):
    jcfg, model, params, tcfg, tparams = model_tuple
    j = jzi.ZeROInferenceEngine(model, params, jcfg, dtype=jnp.float32,
                                offload=offload, **kw)
    t = tzi.ZeROInferenceEngine(None, tparams, tcfg, dtype=torch.float32,
                                offload=offload, device="cpu", **kw)
    return j, t


FORWARD_CASES = {"int8": {}, "fp8": dict(fmt="fp", q_bits=8),
                 "gemma_int8": dict(knobs=GEMMA)}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
@pytest.mark.parametrize("offload", ["none", "cpu"])
def test_forward_logits_match_jax(tiny, case, offload):
    kw = dict(FORWARD_CASES[case])
    knobs = kw.pop("knobs", None)
    model_tuple = _model(**knobs) if knobs else tiny
    j, t = _engines(model_tuple, offload, group_size=64, **kw)
    batch = jllama.random_tokens(2, 12, vocab_size=256, seed=3)
    want = np.asarray(j.forward(batch))
    build.reset_launch_counts()
    got = t.forward(batch)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)
    assert build.launch_counts() == {}        # CPU tensors: plain versions
    if offload == "cpu":
        assert t.streamed_bytes == tzi.quantized_nbytes(t.qstore)


@pytest.mark.parametrize("offload", ["none", "cpu"])
def test_generate_matches_jax(tiny, offload):
    j, t = _engines(tiny, offload, group_size=64)
    prompt = [int(x) for x in np.random.default_rng(5).integers(0, 256, 10)]
    want = j.generate(prompt, max_new_tokens=20)   # the host KV bucket grows
    assert t.generate(prompt, max_new_tokens=20) == want
    assert t.generate(prompt, max_new_tokens=0) == []


def test_quantized_tree_from_jax_keeps_bits(tiny):
    _, _, params, _, _ = tiny
    for name in ("fp8", "int4"):
        jstore = jzi.quantize_model_params(params, group_size=64,
                                           **FORMATS[name])
        tstore = tzi.quantized_tree_from_jax(jstore, device="cpu")
        for path, jleaf in _flat(jstore).items():
            tleaf = _flat(tstore)[path]
            if isinstance(jleaf, jzi.QuantizedTensor):
                np.testing.assert_array_equal(_tbits(tleaf.codes),
                                              _bits(jleaf.codes))
                assert tleaf.nbytes == jleaf.nbytes
