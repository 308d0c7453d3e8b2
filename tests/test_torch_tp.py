"""Port parity: tensor parallelism against the JAX package.

Four gloo ranks spawned by ``deepspeed_tpu_torch.testing.run_distributed``
run ``tests/torch_tp_ranks.py::tp_body`` (TINY_LLAMA / TINY_QWEN2_MOE in
fp32, the flax weights carried over); the JAX package runs in this
process on an explicit mesh of the same shape over the first four of the
8 CPU devices:

- the rules: ``llama_tensor_rules``, the Mixtral and Qwen2-MoE rules and
  every registered AutoTP policy against JAX's specs on the same paths
  and shapes (``HF_PARAM_TREES`` of ``tests/test_module_inject.py``,
  copied), the aliases, and the fused-QKV splitters with their errors;
- ``ColumnParallelLinear`` -> ``RowParallelLinear`` at ``tensor=2``
  against the unsharded flax block: values and gradients (1e-5);
- the logits at ``tensor=2`` against JAX's ``model.apply`` (atol 2e-4,
  rtol 1e-4, as ``tests/test_llama.py``), the loss and every gradient
  block, tied and untied, ids at the vocabulary blocks' edges; the
  ``tensor/*`` bytes as ``chip_smoke.expected_tp_infer_comm`` reckons
  them; the chunked loss on the vocabulary blocks against the dense one;
  the planted faults (another rank's kv heads, layer 0's wo sum
  dropped) outside the tolerance;
- ``init_inference`` at ``tp_size: 2`` against JAX's ``init_inference``
  on the same flax params (2e-3, ``tests/test_module_inject.py``);
- training against ``deepspeed_tpu.initialize`` on the same mesh, 3 steps:
  stage 3 at ``fsdp=2 x tensor=2`` (losses and norms rtol 1e-5, masters
  1e-5), stage 1 at ``data=2 x tensor=2`` with qgZ (the port quantizes
  its tensor blocks, JAX the whole leaf: ``block_wire_close``), and
  Qwen2-MoE at ``expert=2 x tensor=2``, stage 1; the replicated masters
  the same bits on the tensor ranks of a batch shard after every step;
  the planted faults (the norm summing every leaf over ``tensor``; layer
  0's copy-to-tensor dropped) must fail those gates;
- the refusals of the combinations this slice leaves out, and (ROADMAP
  Queue 3) a ``tp`` that does not divide the kv heads: the JAX package
  replicates those leaves, the port raises naming both head counts.
"""

import dataclasses
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec  # noqa: E402

import deepspeed_tpu  # noqa: E402
from deepspeed_tpu import module_inject as jmi  # noqa: E402
from deepspeed_tpu.comm import mesh as jmesh  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu.models import mixtral as jmix  # noqa: E402
from deepspeed_tpu.models import qwen2_moe as jqwen  # noqa: E402
from deepspeed_tpu_torch import module_inject as tmi  # noqa: E402
from deepspeed_tpu_torch.models import llama as tllama  # noqa: E402
from deepspeed_tpu_torch.models import mixtral as tmix  # noqa: E402
from deepspeed_tpu_torch.models import qwen2_moe as tqwen  # noqa: E402
from deepspeed_tpu_torch.testing import run_distributed  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import torch_tp_ranks as ranks  # noqa: E402

W = 4
SPAWN_TIMEOUT = 180

# copied from tests/test_module_inject.py: {path: (shape, sharded dim)}
HF_PARAM_TREES = {
    "gpt_neo": {
        "transformer/h/0/attn/attention/q_proj/kernel": ((64, 64), "col"),
        "transformer/h/0/attn/attention/out_proj/kernel": ((64, 64), "row"),
        "transformer/h/0/mlp/c_fc/kernel": ((64, 256), "col"),
        "transformer/h/0/mlp/c_proj/kernel": ((256, 64), "row"),
        "transformer/wte/embedding": ((1000, 64), "row"),
        "transformer/h/0/ln_1/scale": ((64,), None),
    },
    "gpt_bigcode": {
        "transformer/h/0/attn/c_attn/kernel": ((64, 80), "col"),   # fused MQA
        "transformer/h/0/attn/c_proj/kernel": ((64, 64), "row"),
        "transformer/h/0/mlp/c_fc/kernel": ((64, 256), "col"),
    },
    "t5": {
        "encoder/block/0/layer/0/SelfAttention/q/kernel": ((64, 64), "col"),
        "encoder/block/0/layer/0/SelfAttention/o/kernel": ((64, 64), "row"),
        "encoder/block/0/layer/1/DenseReluDense/wi_0/kernel": ((64, 256), "col"),
        "encoder/block/0/layer/1/DenseReluDense/wo/kernel": ((256, 64), "row"),
        "shared/embedding": ((1000, 64), "row"),
    },
    "chatglm": {
        "transformer/layers/0/self_attention/query_key_value/kernel":
            ((64, 192), "col"),
        "transformer/layers/0/self_attention/dense/kernel": ((64, 64), "row"),
        "transformer/layers/0/mlp/dense_h_to_4h/kernel": ((64, 256), "col"),
        "transformer/layers/0/mlp/dense_4h_to_h/kernel": ((256, 64), "row"),
    },
    "whisper": {
        "model/encoder/layers/0/self_attn/q_proj/kernel": ((64, 64), "col"),
        "model/encoder/layers/0/self_attn/out_proj/kernel": ((64, 64), "row"),
        "model/encoder/layers/0/fc1/kernel": ((64, 256), "col"),
        "model/encoder/layers/0/fc2/kernel": ((256, 64), "row"),
    },
}

# the paths every policy is held on: the HF trees above, the llama-family
# names of both packages, and the other archs' vocabularies (biases, norms,
# embeddings, 3-D kernels)
EXTRA_PATHS = [
    ("model/layers/0/self_attn/q_proj/kernel", (64, 64)),
    ("model/layers/0/self_attn/q_proj/bias", (64,)),
    ("model/layers/0/self_attn/o_proj/kernel", (64, 64)),
    ("model/layers/0/self_attn/o_proj/bias", (64,)),
    ("model/layers/0/mlp/gate_up_proj/kernel", (64, 256)),
    ("model/layers/0/self_attn/qkv_proj/kernel", (64, 192)),
    ("model/layers/0/self_attn/W_pack/kernel", (64, 192)),
    ("model/embed_tokens/embedding", (1000, 64)),
    ("lm_head/kernel", (64, 1000)),
    ("model/norm/scale", (64,)),
    ("model/layer_0/attn/wq/kernel", (64, 4, 16)),
    ("model/layer_0/attn/wo/kernel", (4, 16, 64)),
    ("model/layer_0/mlp/w_down/kernel", (256, 64)),
    ("model/embed/embedding", (1000, 64)),
    ("layer_0/moe/experts/w_gate", (4, 64, 32)),
    ("layer_0/moe/experts/wi/kernel", (4, 64, 32)),
    ("layer_0/shared_expert/w_up/kernel", (64, 128)),
    ("transformer/h/0/self_attention/query_key_value/kernel", (64, 192)),
    ("transformer/h/0/mlp/dense_h_to_4h/bias", (256,)),
    ("encoder/layer/0/attention/self/query/kernel", (64, 64)),
    ("encoder/layer/0/attention/output/dense/kernel", (64, 64)),
    ("encoder/layer/0/intermediate/dense/kernel", (64, 256)),
    ("transformer/layer/0/attention/q_lin/kernel", (64, 64)),
    ("transformer/layer/0/ffn/lin2/kernel", (256, 64)),
    ("up_blocks_0/attentions_0/transformer_blocks_0/ff/net_0/proj/kernel",
     (64, 256)),
    ("decoder/mid_block/attentions/0/to_out/0/kernel", (64, 64)),
    ("down_blocks_0/resnets_0/conv1/kernel", (3, 3, 8, 8)),
    ("shared/embedding", (1000, 64)),
    ("x/col_kernel", (16, 64)),
    ("x/row_bias", (16,)),
]


class _Key:
    def __init__(self, key):
        self.key = key


def _jpath(path):
    return tuple(_Key(p) for p in path.split("/"))


def _spec(jspec):
    """A JAX PartitionSpec (or None) as the port's tuple (or None)."""
    return None if jspec is None else tuple(jspec)


def _all_paths():
    out = [(p, shape) for tree in HF_PARAM_TREES.values()
           for p, (shape, _) in tree.items()]
    return out + EXTRA_PATHS


@pytest.mark.parametrize("arch", sorted(jmi.POLICIES))
def test_policies_match_jax_on_every_arch(arch):
    """Every registered arch's rules give JAX's specs on every path, as a
    ``/`` path, a dotted port name and a key sequence."""
    assert sorted(tmi.POLICIES) == sorted(jmi.POLICIES)
    assert tmi.POLICIES[arch] == tmi.get_policy(arch)
    jr = jmi.POLICIES[arch].tensor_rules()
    tr = tmi.POLICIES[arch].tensor_rules()
    for path, shape in _all_paths():
        want = _spec(jr(_jpath(path), np.zeros(shape)))
        assert tr(path, shape) == want, (arch, path)
        assert tr(path.replace("/", "."), torch.zeros(shape)) == want
        assert tr(path.split("/"), np.zeros(shape)) == want
    for path, (shape, expected) in HF_PARAM_TREES.get(arch, {}).items():
        spec = tr(path, shape)
        if expected is None:
            assert spec is None or all(s is None for s in spec), path
        else:
            assert spec[-1 if expected == "col" else 0] == "tensor", path


def test_aliases_generic_policy_and_autotp():
    names = ["LlamaForCausalLM", "MixtralForCausalLM", "GPTNeoForCausalLM",
             "starcoder", "T5ForConditionalGeneration", "Gemma2ForCausalLM",
             "CLIPTextModel", "megatron", "UNet2DConditionModel",
             "AutoencoderKL", "RWForCausalLM", "no_such_arch"]
    for n in names:
        j, t = jmi.get_policy(n), tmi.get_policy(n)
        assert (j is None and t is None) or j.arch == t.arch, n
    assert tmi.AutoTP.supported_archs() == jmi.AutoTP.supported_archs()
    jg, tg = jmi.GENERIC_POLICY.tensor_rules(), tmi.GENERIC_POLICY.tensor_rules()
    for path, shape in _all_paths():
        assert tg(path, shape) == _spec(jg(_jpath(path), np.zeros(shape)))

    class HF:                      # an HF-style config.model_type
        config = type("C", (), {"model_type": "qwen2"})()
    assert tmi.AutoTP.get_policy(HF()).arch == "qwen2"
    # the port's own models resolve to their Megatron rules (heads), the
    # arch policy would cut q/k/v's head dim (ROADMAP Queue 3)
    m = tllama.LlamaForCausalLM(tllama.TINY_LLAMA, device="cpu")
    assert tmi.AutoTP.get_policy(m).arch == "llama"
    rules = tmi.AutoTP.infer_rules(m, params=m)
    assert rules("model.layer_0.attn.wq.kernel", (128, 4, 32)) == \
        (None, "tensor", None)
    assert tmi.AutoTP.infer_rules("llama")(
        "model.layer_0.attn.wq.kernel", (128, 4, 32)) == (None, None, "tensor")


def _model_paths(flax_params):
    return jax.tree_util.tree_flatten_with_path(flax_params)[0]


def _path_str(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


@pytest.mark.parametrize("which", ["llama", "mixtral", "qwen2_moe"])
def test_model_rules_match_jax(which, flax_params, flax_qwen):
    if which == "llama":
        params, jr, tr = flax_params, jllama.llama_tensor_rules, \
            tllama.llama_tensor_rules
    elif which == "mixtral":
        params = jax.eval_shape(
            lambda r: jmix.MixtralForCausalLM(_jmix_cfg()).init(
                r, jllama.random_tokens(1, 8, vocab_size=512)),
            jax.random.PRNGKey(0))["params"]
        jr, tr = jmix.mixtral_tensor_rules, tmix.mixtral_tensor_rules
    else:
        params, jr, tr = flax_qwen, jqwen.qwen2_moe_tensor_rules, \
            tqwen.qwen2_moe_tensor_rules
    sharded = 0
    for path, leaf in _model_paths(params):
        want = _spec(jr(path, leaf))
        got = tr(_path_str(path).replace("/", "."), tuple(leaf.shape))
        assert got == want, _path_str(path)
        sharded += want is not None and "tensor" in want
    assert sharded >= 4 * 2 + 2          # attention, embedding and head
    # the model classes carry them, as the engine's default on a tensor axis
    assert tllama.LlamaForCausalLM.tensor_rules is tllama.llama_tensor_rules
    assert tmix.MixtralForCausalLM.tensor_rules is tmix.mixtral_tensor_rules
    assert tqwen.Qwen2MoEForCausalLM.tensor_rules is \
        tqwen.qwen2_moe_tensor_rules


def test_fused_qkv_splitters_match_jax():
    rng = np.random.default_rng(0)
    n_heads, n_kv, hd, d_in = 8, 4, 4, 16
    fused = rng.normal(size=(d_in, (n_heads + 2 * n_kv) * hd))
    for a, b in zip(tmi.unfuse_qkv(fused, n_heads, n_kv, hd),
                    jmi.unfuse_qkv(fused, n_heads, n_kv, hd)):
        np.testing.assert_array_equal(a, b)
    assert tmi.qkv_sizes(n_heads, n_kv, hd) == (32, 16, 16)
    for r in range(2):
        np.testing.assert_array_equal(
            tmi.split_fused_qkv(fused, n_heads, n_kv, hd, 2, r),
            jmi.split_fused_qkv(fused, n_heads, n_kv, hd, 2, r))
    inter = rng.normal(size=(d_in, 4 * 3 * 8))
    for r in range(2):
        np.testing.assert_array_equal(
            tmi.split_fused_qkv(inter, 4, 4, 8, 2, r, layout="interleaved"),
            jmi.split_fused_qkv(inter, 4, 4, 8, 2, r, layout="interleaved"))
    np.testing.assert_array_equal(
        tmi.shard_qkv_param(fused, n_heads, n_kv, hd, 2),
        jmi.shard_qkv_param(fused, n_heads, n_kv, hd, 2))
    bad = [lambda m: m.unfuse_qkv(fused[:, :-1], n_heads, n_kv, hd),
           lambda m: m.unfuse_qkv(inter, 4, 2, 8, layout="interleaved"),
           lambda m: m.unfuse_qkv(fused, n_heads, n_kv, hd, layout="x"),
           lambda m: m.split_fused_qkv(np.zeros((4, 24)), 2, 1, 4, 4, 0)]
    for fn in bad:
        with pytest.raises(ValueError) as je:
            fn(jmi)
        with pytest.raises(ValueError) as te:
            fn(tmi)
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + "/") if isinstance(v, dict) else {name: v})
    return out


def _jcfg(tie=False):
    return dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               attention_backend="xla", tie_embeddings=tie)


def _jmix_cfg():
    cfg = jmix.TINY_MIXTRAL
    return dataclasses.replace(
        cfg, base=dataclasses.replace(cfg.base, dtype=jnp.float32),
        moe=dataclasses.replace(cfg.moe, dtype=jnp.float32))


def _jqwen_cfg():
    cfg = jqwen.TINY_QWEN2_MOE
    return dataclasses.replace(
        cfg, base=dataclasses.replace(cfg.base, dtype=jnp.float32),
        moe=dataclasses.replace(cfg.moe, dtype=jnp.float32))


def _init(model, seed=0):
    batch = jllama.random_tokens(1, 8, vocab_size=512)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed),
                                               batch)["params"])


@pytest.fixture(scope="module")
def flax_params():
    return _init(jllama.LlamaForCausalLM(_jcfg()))


@pytest.fixture(scope="module")
def flax_tied():
    return _init(jllama.LlamaForCausalLM(_jcfg(True)), seed=1)


@pytest.fixture(scope="module")
def flax_qwen():
    return _init(jqwen.Qwen2MoEForCausalLM(_jqwen_cfg()))


@pytest.fixture(scope="module")
def flax_layers():
    import flax.linen as nn

    class Block(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = jmi.ColumnParallelLinear(ranks.LAYER[1], name="up")(x)
            return jmi.RowParallelLinear(ranks.LAYER[2], name="down")(
                nn.relu(h))

    model = Block()
    x = jnp.asarray(ranks.layer_input())
    params = model.init(jax.random.PRNGKey(2), x)["params"]
    params = jax.tree.map(lambda a: a + 0.01, params)   # nonzero biases

    def loss(p, xx):
        return jnp.sum(model.apply({"params": p}, xx) ** 2)

    out = model.apply({"params": params}, x)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    return (jax.tree.map(np.asarray, params), np.asarray(out),
            np.asarray(gx), jax.tree.map(np.asarray, gp))


def _jmesh(sizes):
    full = {a: sizes.get(a, 1) for a in jmesh.MESH_AXES}
    w = int(np.prod(list(full.values())))
    return Mesh(np.array(jax.devices()[:w]).reshape(
        tuple(full[a] for a in jmesh.MESH_AXES)), jmesh.MESH_AXES)


@pytest.fixture(scope="module")
def spawned(flax_params, flax_tied, flax_qwen, flax_layers,
            tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    np.savez(out / "params_untied.npz", **_flat(flax_params))
    np.savez(out / "params_tied.npz", **_flat(flax_tied))
    np.savez(out / "params_qwen.npz", **_flat(flax_qwen))
    np.savez(out / "layers.npz", **_flat(flax_layers[0]))
    run_distributed(ranks.tp_body, W, timeout=SPAWN_TIMEOUT, device="cpu",
                    env={"DSTPU_TEST_OUT": str(out)})
    per_rank = []
    for r in range(W):
        with open(out / f"tp{r}.json") as f:
            meta = json.load(f)
        per_rank.append((meta, dict(np.load(out / f"tp{r}.npz"))))
    return per_rank


def _tensor_block(full, spec, t):
    """Tensor rank ``t``'s block of ``full`` under ``spec`` (of two)."""
    if spec is None or "tensor" not in spec:
        return full
    d = list(spec).index("tensor")
    return np.split(full, 2, axis=d)[t]


def test_parallel_layers_match_the_unsharded_block(spawned, flax_layers):
    params, out, gx, gp = flax_layers
    rules = jmi.AutoTP.infer_rules(params=params)
    for meta, arr in spawned:
        t = meta["coords"]["tensor"]
        np.testing.assert_allclose(arr["layers/out"], out, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(arr["layers/x_grad"], gx, atol=1e-5,
                                   rtol=1e-5)
        for path, g in _model_paths(gp):
            name = _path_str(path)
            spec = _spec(rules(path, g))
            np.testing.assert_allclose(arr[f"layers/grad/{name}"],
                                       _tensor_block(g, spec, t), atol=1e-5,
                                       rtol=1e-5, err_msg=name)


def _jax_logits(params, tie=False):
    model = jllama.LlamaForCausalLM(_jcfg(tie))
    batch = ranks.logits_batch()
    logits = model.apply({"params": params}, batch,
                         method=jllama.LlamaForCausalLM.logits)
    loss, grads = jax.value_and_grad(
        lambda p: model.apply({"params": p}, batch))(params)
    return np.asarray(logits), float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("tag", ["untied", "tied"])
def test_logits_loss_and_gradients_at_tensor_2(spawned, flax_params,
                                               flax_tied, tag):
    """Every rank's whole logits against JAX's ``model.apply`` (atol 2e-4,
    rtol 1e-4), the loss (1e-5) and each rank's block of every gradient
    (the tied table: the lookup's rows and the head's block summed)."""
    params = flax_params if tag == "untied" else flax_tied
    logits, loss, grads = _jax_logits(params, tag == "tied")
    for meta, arr in spawned:
        t = meta["coords"]["tensor"]
        np.testing.assert_allclose(arr[f"logits/{tag}/sound"], logits,
                                   atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(float(arr[f"loss/{tag}"]), loss,
                                   rtol=1e-5)
        for path, g in _model_paths(grads):
            name = _path_str(path)
            spec = _spec(jllama.llama_tensor_rules(path, g))
            np.testing.assert_allclose(
                arr[f"grad/{tag}/{name.replace('/', '.')}"],
                _tensor_block(g, spec, t), atol=2e-5, rtol=1e-4,
                err_msg=name)
    # both tensor ranks return the same bits
    np.testing.assert_array_equal(spawned[0][1][f"logits/{tag}/sound"],
                                  spawned[1][1][f"logits/{tag}/sound"])


def test_chunked_loss_on_the_vocab_blocks(spawned):
    """``loss_chunk_size`` at ``tensor=2``: each chunk's max, sum and
    target over the vocabulary blocks give the dense loss and gradients."""
    for _, arr in spawned:
        np.testing.assert_allclose(float(arr["loss/chunked"]),
                                   float(arr["loss/untied"]), rtol=1e-6)
        for k in arr:
            if k.startswith("grad/chunked/"):
                np.testing.assert_allclose(
                    arr[k], arr[k.replace("chunked", "untied")], atol=1e-6,
                    rtol=1e-5, err_msg=k)


def test_serving_faults_miss_and_tensor_bytes(spawned, flax_params):
    """The planted faults of the serving gate fall outside the tolerance;
    the sound forward's ``tensor/*`` bytes are the shapes' reckoning."""
    logits, _, _ = _jax_logits(flax_params)
    for meta, arr in spawned:
        for fault in ("kv_wrong_rank", "wo_reduce_dropped"):
            got = arr[f"logits/untied/{fault}"]
            assert not np.allclose(got, logits, atol=2e-4, rtol=1e-4), fault
        assert meta["comm"] == meta["expected_comm"]


def test_init_inference_matches_jax_init_inference(spawned, flax_params):
    """JAX's ``init_inference`` at tp_size 2 with AutoTP's rules on the
    same flax params, serving the logits (its ``model.apply`` returns the
    loss, which the port's loss of these logits matches too)."""
    model = jllama.LlamaForCausalLM(_jcfg())
    batch = ranks.logits_batch()
    mesh = _jmesh({"data": 2, "tensor": 2})
    jmesh.set_global_mesh(mesh)
    rules = jmi.AutoTP.infer_rules(model, params=flax_params)
    eng = deepspeed_tpu.init_inference(
        lambda p, b: model.apply({"params": p}, b,
                                 method=jllama.LlamaForCausalLM.logits),
        config={"dtype": "fp32", "tensor_parallel": {"tp_size": 2}},
        params=flax_params, mesh=mesh, tensor_rules=rules)
    want = np.asarray(eng.forward(batch))
    jloss = float(deepspeed_tpu.init_inference(
        model, config={"dtype": "fp32", "tensor_parallel": {"tp_size": 2}},
        params=flax_params, mesh=mesh).forward(batch))
    jmesh.set_global_mesh(None)
    n = sum(np.size(v) for v in _flat(flax_params).values())
    for meta, arr in spawned:
        got = arr["infer/logits"]
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
        tloss = tllama.LlamaForCausalLM.loss_of(
            torch.from_numpy(got), {"input_ids": torch.from_numpy(
                batch["input_ids"])})
        np.testing.assert_allclose(float(tloss), jloss, rtol=2e-3, atol=2e-3)
        assert meta["infer_held"] < 0.55 * n


def block_wire_close(got, want, steps=ranks.STEPS, lr=1e-3):
    """``tests/test_torch_zeropp.py``'s criterion of a wire quantized on
    the port's blocks (ROADMAP Queue 3, divergence 39): JAX quantizes each
    leaf whole, the port its tensor block, so the chunks, their scales and
    every element's rounding differ. No element beyond 2 lr a step, at most
    1% of them beyond a tenth of lr."""
    diffs = np.concatenate([np.abs(got[n] - w).ravel()
                            for n, w in want.items()])
    assert diffs.max() <= 2 * lr * steps + 1e-6
    assert np.mean(diffs > 0.1 * lr) <= 1e-2


_JAX = {}


def _jax_train(name, flax_params, flax_qwen):
    if name in _JAX:
        return _JAX[name]
    model, stage, mesh, qgz, _ = ranks.CASES[name]
    jm = _jmesh(mesh)
    jmesh.set_global_mesh(jm)
    if model == "llama":
        jmodel, params, rules = jllama.LlamaForCausalLM(_jcfg()), \
            flax_params, jllama.llama_tensor_rules
    else:
        jmodel, params, rules = jqwen.Qwen2MoEForCausalLM(_jqwen_cfg()), \
            flax_qwen, jqwen.qwen2_moe_tensor_rules
    from torch_dist_ranks import zero_batches, zero_config
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng, *_ = deepspeed_tpu.initialize(
            model=jmodel, config=zero_config(stage, mesh, qgz, ranks.ROWS),
            model_parameters=params, mesh=jm, tensor_rules=rules)
    losses, norms = [], []
    for batch in zero_batches(ranks.ROWS, ranks.STEPS):
        losses.append(float(eng.train_batch(batch=batch, stacked=True)))
        norms.append(eng.get_global_grad_norm())
    jmesh.set_global_mesh(None)
    _JAX[name] = (losses, norms, _flat(jax.tree.map(
        np.asarray, eng.module_state_dict())))
    return _JAX[name]


def _masters(arr, name):
    pre = f"masters/{name}/"
    return {k[len(pre):].replace(".", "/"): v for k, v in arr.items()
            if k.startswith(pre)}


def _digests_agree(spawned, name, batch_axes=("data", "fsdp")):
    """Per batch shard, its tensor ranks' replicated-master digests after
    every step."""
    groups = {}
    for meta, _ in spawned:
        c = meta["cases"][name]["coords"]
        groups.setdefault(tuple(c[a] for a in batch_axes + ("expert",)),
                          []).append(meta["cases"][name]["digests"])
    return all(len(g) == 2 and g[0] == g[1] for g in groups.values())


@pytest.mark.parametrize("name", ["llama_s3_fsdp2_tp2",
                                  "llama_s1_qgz_data2_tp2",
                                  "qwen2_moe_s1_ep2_tp2"])
def test_training_matches_the_jax_engine(spawned, flax_params, flax_qwen,
                                         name):
    jl, jn, jm = _jax_train(name, flax_params, flax_qwen)
    _, _, _, qgz, _ = ranks.CASES[name]
    meta0, arr0 = spawned[0]
    row = meta0["cases"][name]
    rtol = 1e-4 if qgz else 1e-5
    np.testing.assert_allclose(row["losses"], jl, rtol=rtol)
    np.testing.assert_allclose(row["norms"], jn, rtol=rtol)
    got = _masters(arr0, name)
    assert got.keys() == jm.keys()
    if qgz:
        assert row["qgz_axes"] == ["data"]
        block_wire_close(got, jm)
    else:
        for k, w in jm.items():
            # the k projection's bias moves no score (the softmax is
            # invariant to it): its gradient is rounding, which AdamW
            # scales to up to lr a step in either package
            atol = 2 * 1e-3 * ranks.STEPS if k.endswith("wk/bias") else 1e-5
            np.testing.assert_allclose(got[k], w, atol=atol, rtol=1e-5,
                                       err_msg=k)
    for meta, _ in spawned[1:]:                  # every rank: the same result
        other = meta["cases"][name]
        assert other["losses"] == row["losses"]
        assert other["norms"] == row["norms"]
    assert _digests_agree(spawned, name)
    assert any(d is not None for d in row["tensor_dims"])


def test_stage3_holds_the_tensor_block_of_each_fsdp_block(spawned,
                                                          flax_params):
    """``wo`` [H, hd, D] takes tensor on dim 0 and fsdp on dim 2, the
    embedding tensor on 0 and fsdp on 1: each rank holds a quarter."""
    row = spawned[0][0]["cases"]["llama_s3_fsdp2_tp2"]
    shapes = row["shapes"]
    assert shapes["model.layer_0.attn.wo.kernel"] == [2, 32, 64]
    assert shapes["model.embed.embedding"] == [256, 64]
    assert shapes["model.layer_0.attn.wq.kernel"] == [64, 2, 32]
    n = sum(np.size(v) for v in _flat(flax_params).values())
    assert row["held"] < 0.3 * n


def test_planted_training_faults_fail(spawned, flax_params, flax_qwen):
    """(a) the norm with every leaf summed over ``tensor``: the norm moves
    beyond the gate; (b) layer 0's copy-to-tensor dropped: the replicated
    masters drift apart between the tensor ranks."""
    _, jn, _ = _jax_train("llama_s3_fsdp2_tp2", flax_params, flax_qwen)
    row = spawned[0][0]["cases"]["fault_norm_all_tensor"]
    assert not np.allclose(row["norms"], jn, rtol=1e-5)
    assert _digests_agree(spawned, "fault_norm_all_tensor")
    assert not _digests_agree(spawned, "fault_copy_dropped")


# ---------------------------------------------------------------------------
# refusals and the divergence of indivisible heads
# ---------------------------------------------------------------------------
REFUSED = [
    ({"mesh": {"tensor": 2, "sequence": 2}}, "item 3: sequence parallel"),
    ({"mesh": {"tensor": 2, "fsdp": 4},
      "zero_optimization": {"stage": 3, "mics_shard_size": 2}}, "MiCS"),
    ({"mesh": {"tensor": 2, "fsdp": 4},
      "zero_optimization": {"stage": 3, "zero_hpz_partition_size": 2}},
     "hpZ"),
    ({"mesh": {"tensor": 2},
      "zero_optimization": {"stage": 3, "zero_quantized_weights": True}},
     "qwZ"),
]


@pytest.mark.parametrize("raw,match", REFUSED,
                         ids=["sequence", "mics", "hpz", "qwz"])
def test_left_out_combinations_name_their_item(raw, match):
    from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig
    with pytest.raises(NotImplementedError, match=match) as e:
        DeepSpeedTPUConfig(raw)
    assert "ROADMAP Queue 1 item" in str(e.value)
    assert DeepSpeedTPUConfig({"mesh": {"tensor": 2}}).mesh.tensor == 2


def test_indivisible_kv_heads_raise_where_jax_replicates():
    """TINY_LLAMA's 2 kv heads at tensor=4: JAX's partition warns and
    replicates wk/wv, and its logits still match one device; the port
    splits whole heads and raises, naming both head counts."""
    from deepspeed_tpu.runtime.zero.partition import build_param_shardings
    model = jllama.LlamaForCausalLM(_jcfg())
    params = _init(model)
    batch = ranks.logits_batch()
    mesh = _jmesh({"data": 2, "tensor": 4})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sh = build_param_shardings(params, mesh, stage=0,
                                   tensor_rules=jllama.llama_tensor_rules)
    assert sh["model"]["layer_0"]["attn"]["wk"]["kernel"].spec == \
        PartitionSpec()
    sharded = jax.device_put(params, sh)
    out = jax.jit(lambda p, b: model.apply(
        {"params": p}, b, method=jllama.LlamaForCausalLM.logits))(
            sharded, batch)
    ref = model.apply({"params": params}, batch,
                      method=jllama.LlamaForCausalLM.logits)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-4,
                               rtol=1e-4)
    cfg = ranks.tiny_llama()
    with pytest.raises(ValueError, match=r"num_heads \(4\) and num_kv_heads "
                                         r"\(2\) must both be divisible by 4"):
        tllama.tensor_parallel_heads(cfg, 4)
    with pytest.raises(ValueError, match="num_kv_heads"):
        tllama.LlamaForCausalLM(cfg, device="cpu").check_tensor_parallel(4)
    with pytest.raises(ValueError, match=r"num_heads \(4\) and num_kv_heads "
                                         r"\(4\) must both be divisible by 3"):
        tqwen.Qwen2MoEForCausalLM(ranks.tiny_qwen2_moe(),
                                  device="cpu").check_tensor_parallel(3)


def test_tp_shard_and_parallel_layers_at_one_rank():
    """``tp_shard`` cuts by the rules (a flat dict, a nested tree, numpy
    leaves), passes a dim the axis does not divide through whole with a
    warning, as the JAX spec builder replicates it (ROADMAP Queue 3, fault
    B); at ``tensor`` = 1 the layers and the model call no collective."""
    from deepspeed_tpu_torch.models.convert import tp_shard
    full = {"a/wq/kernel": torch.arange(24.).reshape(2, 4, 3),
            "b": {"embed": {"embedding": np.arange(8.).reshape(4, 2)}}}
    out = tp_shard(full, tllama.llama_tensor_rules, 1, 2)
    np.testing.assert_array_equal(out["a/wq/kernel"],
                                  full["a/wq/kernel"][:, 2:])
    np.testing.assert_array_equal(out["b"]["embed"]["embedding"],
                                  full["b"]["embed"]["embedding"][2:])
    with pytest.warns(UserWarning, match="not divisible by tensor=3; "
                                         "replicating that dim"):
        whole = tp_shard(full, tllama.llama_tensor_rules, 0, 3)
    assert whole["a/wq/kernel"] is full["a/wq/kernel"]
    assert whole["b"]["embed"]["embedding"] is \
        full["b"]["embed"]["embedding"]
    up = tmi.ColumnParallelLinear(4, 8, device="cpu")
    x = torch.ones(2, 4)
    torch.testing.assert_close(up(x), x @ up.col_kernel + up.col_bias)
