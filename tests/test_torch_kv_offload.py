"""Port parity: the host KV tier of ``InferenceEngineV2`` (``kv_offload.py``,
``demote_kv`` / ``promote_kv`` and the gauges over both tiers) against the
JAX package.

- The page codecs: int8 and fp8 stored pages, scales and dequantized pages
  bit-identical to the reference's numpy codecs on the same pages, the
  error bound equal.
- The engine, TINY_LLAMA in float32 with the prefix cache on, the same
  flax weights on both sides: demote with ``codec="none"`` then promote
  (into other blocks, a second sequence holding the freed ones) gives
  tokens identical to an undisturbed run and pages identical to the ones
  demoted; int8 and fp8 promotions land within ``quantize_error_bound``;
  every gauge (``kv_ledger``, ``demoted_uids``, ``demoted_blocks``,
  ``host_kv_bytes``, ``resident_tokens``, ``kv_resident_bytes``,
  ``kv_held_blocks``) equals the JAX engine's after every operation of the
  same scenario.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deepspeed_tpu.inference.v2 import engine_v2 as jengine  # noqa: E402
from deepspeed_tpu.inference.v2 import kv_offload as jkvo  # noqa: E402
from deepspeed_tpu.inference.v2.scheduler import \
    SchedulerConfig as JSchedulerConfig  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu_torch.inference.v2 import engine_v2 as tengine  # noqa: E402
from deepspeed_tpu_torch.inference.v2 import kv_offload as tkvo  # noqa: E402
from deepspeed_tpu_torch.inference.v2.scheduler import SchedulerConfig  # noqa: E402
from deepspeed_tpu_torch.models import llama as tllama  # noqa: E402
from deepspeed_tpu_torch.models.convert import llama_params_from_jax  # noqa: E402


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               max_seq_len=512)
    params = jllama.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jllama.random_tokens(1, 8, vocab_size=512)
    )["params"]
    names = {f.name for f in dataclasses.fields(tllama.LlamaConfig)} - {"dtype"}
    tcfg = tllama.LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                              dtype=torch.float32)
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return jcfg, params, tcfg, tparams


def _engine(models, side, **kw):
    jcfg, params, tcfg, tparams = models
    shape = dict(kv_block_size=16, kv_num_blocks=24, prefix_cache_enabled=True,
                 **kw)
    if side == "jax":
        return jengine.InferenceEngineV2(params, jcfg, jengine.V2EngineConfig(
            **shape, scheduler=JSchedulerConfig(max_tokens_per_step=64,
                                                prefill_buckets=(16, 32, 64)),
            attn_impl="gather"))
    return tengine.InferenceEngineV2(tparams, tcfg, tengine.V2EngineConfig(
        **shape, scheduler=SchedulerConfig(max_tokens_per_step=64,
                                           prefill_buckets=(16, 32, 64))),
        device="cpu")


def _prompt(seed, n):
    return [int(x) for x in np.random.default_rng(seed).integers(1, 500, n)]


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_page_codecs_match_jax(codec):
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(2, 2, 2, 4, 8, 4)) * 3).astype(np.float32)
    data[0, 0, 0, 1] = 0.0                       # an all-zero page
    jstored, jqs = jkvo.quantize_pages(data, codec)
    stored, qs = tkvo.quantize_pages(torch.from_numpy(data), codec)
    np.testing.assert_array_equal(qs.numpy(), jqs)
    np.testing.assert_array_equal(
        stored.view(torch.uint8 if codec == "fp8" else torch.int8).numpy(),
        np.asarray(jstored).view(np.uint8 if codec == "fp8" else np.int8))
    deq = tkvo.dequantize_pages(stored, qs, codec, torch.float32)
    jdeq = jkvo.dequantize_pages(jstored, jqs, codec, np.float32)
    np.testing.assert_array_equal(deq.numpy(), jdeq)
    assert tkvo.quantize_error_bound(qs, codec) == \
        jkvo.quantize_error_bound(jqs, codec)
    assert torch.all(deq[0, 0, 0, 1] == 0.0)
    assert (deq.numpy() - data).__abs__().max() <= \
        tkvo.quantize_error_bound(qs, codec)
    t = torch.from_numpy(data)
    assert tkvo.quantize_pages(t, "none") == (t, None)
    assert tkvo.dequantize_pages(t, None, "none", torch.float32) is t
    with pytest.raises(ValueError, match="codec"):
        tkvo.quantize_pages(t, "int4")


GAUGES = ("kv_ledger", "demoted_uids", "host_kv_bytes", "resident_tokens",
          "kv_resident_bytes")


def _gauges(eng, uids):
    out = {g: getattr(eng, g)() for g in GAUGES}
    out["demoted_blocks"] = [eng.demoted_blocks(u) for u in uids]
    out["kv_held_blocks"] = [eng.kv_held_blocks(u) for u in uids]
    return out


def _pages(eng, uid):
    idx = np.asarray(eng.state.get(uid).blocks)
    data = eng.kv.data
    if isinstance(data, torch.Tensor):
        return data[:, :, :, torch.from_numpy(idx)].numpy()
    return np.asarray(data[:, :, :, idx])


def _scenario(eng, codec, log):
    """uid 1 decodes, is demoted; uid 3 arrives and takes the freed blocks;
    uid 1 is promoted (into other blocks) and decodes on. Gauges are logged
    after every operation; returns uid 1's tokens and its pages before the
    demotion and after the promotion."""
    uids = (1, 2, 3)
    prompt = _prompt(1, 40)
    eng.put([1], [prompt])
    eng.put([2], [prompt[:20] + [7, 8, 9, 11, 12]])   # shares the first block
    for _ in range(3):
        eng.step()
    log.append(_gauges(eng, uids))
    before = _pages(eng, 1)
    log.append(list(eng.state.get(1).blocks))
    log.append(eng.demote_kv(1, quantize=codec))
    log.append(eng.demote_kv(1, quantize=codec))      # already demoted: 0
    log.append(_gauges(eng, uids))
    eng.put([3], [_prompt(3, 33)])
    eng.step()
    log.append(_gauges(eng, uids))
    log.append(eng.promote_kv(1))
    log.append(eng.promote_kv(1))                     # nothing demoted: None
    log.append(_gauges(eng, uids))
    after = _pages(eng, 1)
    log.append(list(eng.state.get(1).blocks))
    for _ in range(3):
        eng.step()
    tokens = eng.flush(1)
    eng.flush(2)
    eng.flush(3)
    log.append(_gauges(eng, uids))
    return tokens, before, after


def _undisturbed(models):
    eng = _engine(models, "torch")
    prompt = _prompt(1, 40)
    eng.put([1], [prompt])
    eng.put([2], [prompt[:20] + [7, 8, 9, 11, 12]])
    for _ in range(6):        # the scenario's steps while uid 1 is resident
        eng.step()
    return eng.flush(1)


@pytest.mark.parametrize("codec", ["none", "int8", "fp8"])
def test_demote_promote_matches_jax(models, codec):
    jlog, tlog = [], []
    jtokens, jbefore, jafter = _scenario(_engine(models, "jax"), codec, jlog)
    tokens, before, after = _scenario(_engine(models, "torch"), codec, tlog)
    np.testing.assert_allclose(before, jbefore, atol=1e-5, rtol=1e-5)
    assert tlog == jlog
    assert tokens == jtokens
    moved = [x for x in tlog if isinstance(x, list)]
    assert set(moved[0]) != set(moved[1])          # promoted into other blocks
    if codec == "none":
        np.testing.assert_array_equal(after, before)
        assert tokens == _undisturbed(models)
    else:
        ledger = tlog[4]["kv_ledger"]
        assert ledger["host_compression_ratio"] > 3.5
        err = np.abs(after - before).max()
        assert 0 < err
        # the bound of each page's own scale holds the whole sequence
        _, qs = tkvo.quantize_pages(torch.from_numpy(before), codec)
        assert err <= tkvo.quantize_error_bound(qs, codec)
    final = tlog[-1]["kv_ledger"]
    assert final["host_entries"] == final["host_bytes"] == 0
    assert final["device_blocks_reserved"] == 0
    assert final["demotions"] == final["promotions"] == 1
