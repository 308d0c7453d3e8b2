"""Port parity: the PyTorch ``InferenceEngineV2`` against the JAX engine.

TINY_LLAMA in float32, the same flax weights on both sides (through
``llama_params_from_jax``), both engines on the CPU with the gather
attention. Greedy tokens must be identical in every serving case; logits
agree within float32 atol/rtol 1e-4 (a whole forward: the matmuls and the
softmax sum in other orders). With fp8 KV pages the two sides may round a
K/V value to fp8 one ulp apart, so fp8 logits are held to 2% of their
spread and the greedy tokens to the first 4.

Also here: the port imports neither ``jax`` nor ``deepspeed_tpu`` (a
subprocess imports every module; an AST scan reads every file).
"""

import ast
import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# the JAX side needs jax and flax; the card's machine lacks flax
pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import deepspeed_tpu_torch
from deepspeed_tpu.inference.v2 import engine_v2 as jengine
from deepspeed_tpu.inference.v2.generic_decode import (
    decode_step_g as j_decode_step_g, prefill_chunk_g as j_prefill_chunk_g)
from deepspeed_tpu.inference.v2.kv_cache import (BlockedKVCache as JBlockedKVCache,
                                                 KVCacheConfig as JKVCacheConfig)
from deepspeed_tpu.inference.v2.modules import LlamaPolicy as JLlamaPolicy
from deepspeed_tpu.inference.v2.scheduler import SchedulerConfig as JSchedulerConfig
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch.inference.v2 import engine_v2 as tengine
from deepspeed_tpu_torch.inference.v2.generic_decode import (decode_step_g,
                                                             prefill_chunk_g)
from deepspeed_tpu_torch.inference.v2.kv_cache import (BlockedKVCache,
                                                       KVCacheConfig)
from deepspeed_tpu_torch.inference.v2.modules import LlamaPolicy
from deepspeed_tpu_torch.inference.v2.scheduler import SchedulerConfig
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import llama_params_from_jax

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               max_seq_len=512)
    model = jllama.LlamaForCausalLM(jcfg)
    batch = jllama.random_tokens(1, 8, vocab_size=jcfg.vocab_size)
    params = model.init(jax.random.PRNGKey(0), batch)["params"]
    names = {f.name for f in dataclasses.fields(tllama.LlamaConfig)} - {"dtype"}
    tcfg = tllama.LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                              dtype=torch.float32)
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return jcfg, params, tcfg, tparams


SMALL = dict(kv_block_size=16, kv_num_blocks=64)


def _engines(models, sched=(64, (16, 32, 64)), **kw):
    jcfg, params, tcfg, tparams = models
    steps, buckets = sched
    j = jengine.InferenceEngineV2(params, jcfg, jengine.V2EngineConfig(
        **SMALL, scheduler=JSchedulerConfig(max_tokens_per_step=steps,
                                            prefill_buckets=buckets),
        attn_impl="gather", **kw))
    t = tengine.InferenceEngineV2(tparams, tcfg, tengine.V2EngineConfig(
        **SMALL, scheduler=SchedulerConfig(max_tokens_per_step=steps,
                                           prefill_buckets=buckets), **kw),
        device="cpu")
    return j, t


def _prompt(seed, n, vocab=512):
    return [int(x) for x in np.random.default_rng(seed).integers(0, vocab, n)]


def _serve_two(eng, p1, p2, n):
    eng.put([10, 20], [p1, p2])
    for _ in range(3 * n):
        if min(len(eng.state.get(u).generated) for u in (10, 20)) >= n:
            break
        eng.step()
    return eng.flush(10)[:n], eng.flush(20)[:n]


def _prefix_run(eng):
    shared = _prompt(5, 40)
    first = eng.generate(shared + _prompt(6, 5), max_new_tokens=4, uid=1)
    second = eng.generate(shared + _prompt(7, 9), max_new_tokens=4, uid=2)
    return first, second, eng.prefix_stats()["prefill_tokens_saved"]


SERVING_CASES = ["single", "chunked", "concurrent", "prefix_hit",
                 "speculative"]


@pytest.mark.parametrize("case", SERVING_CASES)
def test_greedy_tokens_identical_to_jax(models, case):
    if case == "single":
        j, t = _engines(models)
        p = _prompt(0, 12)
        want, got = j.generate(p, max_new_tokens=6), t.generate(p, max_new_tokens=6)
    elif case == "chunked":
        p = _prompt(1, 40)
        j, t = _engines(models, sched=(16, (16,)))
        want, got = j.generate(p, max_new_tokens=3), t.generate(p, max_new_tokens=3)
        _, t_single = _engines(models, sched=(64, (64,)))
        assert t_single.generate(p, max_new_tokens=3) == got
        assert t.sched_ledger.chunks_total == j.sched_ledger.chunks_total == 3
    elif case == "concurrent":
        j, t = _engines(models)
        p1, p2 = _prompt(2, 10), _prompt(3, 17)
        want, got = _serve_two(j, p1, p2, 4), _serve_two(t, p1, p2, 4)
        assert t.kv.free_blocks == t.kv.allocator.total_blocks
    elif case == "prefix_hit":
        j, t = _engines(models, prefix_cache_enabled=True)
        want, got = _prefix_run(j), _prefix_run(t)
        assert got[2] == 32                        # two full 16-token blocks
    else:
        j_plain, t_plain = _engines(models)
        prompt = _prompt(12, 16)
        chain = j_plain.generate(prompt, max_new_tokens=8)
        assert t_plain.generate(prompt, max_new_tokens=8) == chain
        j, t = _engines(models, speculative_k=4)
        for eng in (j, t):     # proposals: the true continuation (accepted)
            eng._propose = lambda seq, c=chain: c[len(seq.generated):
                                                  len(seq.generated) + 4]
        want = [j.generate(prompt, max_new_tokens=8), j.speculative_stats()]
        got = [t.generate(prompt, max_new_tokens=8), t.speculative_stats()]
        assert got[0] == chain
        assert got[1]["accepted"] == got[1]["proposed"] > 0
        j, t = _engines(models, speculative_k=4)   # real prompt lookup
        looped = _prompt(13, 5) * 4
        want += [j.generate(looped, max_new_tokens=10), j.speculative_stats()]
        got += [t.generate(looped, max_new_tokens=10), t.speculative_stats()]
    assert got == want


def _fresh_caches(models, jdtype, tdtype):
    jcfg, _, tcfg, _ = models
    shape = dict(num_layers=jcfg.num_layers, num_kv_heads=jcfg.num_kv_heads,
                 head_dim=jcfg.head_dim_, block_size=16, num_blocks=32)
    jkv = JBlockedKVCache(JKVCacheConfig(**shape, dtype=jdtype))
    tkv = BlockedKVCache(KVCacheConfig(**shape, dtype=tdtype), CPU)
    jc = jkv.data if jkv.scales is None else (jkv.data, jkv.scales)
    tc = tkv.data if tkv.scales is None else (tkv.data, tkv.scales)
    return jc, tc


def test_prefill_and_decode_logits_match_jax(models):
    jcfg, params, tcfg, tparams = models
    jc, tc = _fresh_caches(models, jnp.float32, torch.float32)
    tokens = np.zeros(32, np.int32)
    tokens[:20] = _prompt(5, 20)
    table = np.arange(4, dtype=np.int32)
    jl, jc = j_prefill_chunk_g(params, jc, jnp.asarray(tokens), 0,
                               jnp.asarray(table), 20, policy=JLlamaPolicy,
                               cfg=jcfg, block_size=16, attn_impl="gather")
    tl, tc = prefill_chunk_g(tparams, tc, torch.from_numpy(tokens), 0,
                             torch.from_numpy(table), 20, policy=LlamaPolicy,
                             cfg=tcfg, block_size=16, attn_impl="auto")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)
    # decode: one live row, one padding row (writes the trash page)
    tok = np.array([int(np.argmax(np.asarray(jl))), 0], np.int32)
    pos = np.array([20, 0], np.int32)
    tables = np.array([[0, 1, 2, 3], [31, 31, 31, 31]], np.int32)
    valid = np.array([True, False])
    jd, _ = j_decode_step_g(params, jc, jnp.asarray(tok), jnp.asarray(pos),
                            jnp.asarray(tables), jnp.asarray(valid),
                            policy=JLlamaPolicy, cfg=jcfg, block_size=16,
                            attn_impl="gather")
    td, _ = decode_step_g(tparams, tc, torch.from_numpy(tok),
                          torch.from_numpy(pos), torch.from_numpy(tables),
                          torch.from_numpy(valid), policy=LlamaPolicy,
                          cfg=tcfg, block_size=16, attn_impl="gather")
    np.testing.assert_allclose(td.numpy()[0], np.asarray(jd)[0], atol=1e-4,
                               rtol=1e-4)


def test_fp8_pages_within_tolerance_of_jax(models):
    jcfg, params, tcfg, tparams = models
    jc, tc = _fresh_caches(models, jnp.float8_e4m3fn, torch.float8_e4m3fn)
    tokens = np.zeros(64, np.int32)
    tokens[:50] = _prompt(8, 50)
    table = np.arange(4, dtype=np.int32)
    jl, _ = j_prefill_chunk_g(params, jc, jnp.asarray(tokens), 0,
                              jnp.asarray(table), 50, policy=JLlamaPolicy,
                              cfg=jcfg, block_size=16, attn_impl="gather")
    tl, (data, scales) = prefill_chunk_g(
        tparams, tc, torch.from_numpy(tokens), 0, torch.from_numpy(table), 50,
        policy=LlamaPolicy, cfg=tcfg, block_size=16, attn_impl="auto")
    jl = np.asarray(jl)
    spread = float(jl.max() - jl.min())
    assert float(np.abs(tl.numpy() - jl).max()) < 0.02 * spread
    assert data.dtype == torch.float8_e4m3fn and bool((scales >= 1.0).all())
    j, t = _engines(models, kv_cache_dtype="fp8")
    p = _prompt(3, 20)
    assert t.generate(p, max_new_tokens=8)[:4] == j.generate(p, max_new_tokens=8)[:4]


def test_engine_device_and_admission(models):
    _, _, tcfg, tparams = models
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tengine.InferenceEngineV2(tparams, tcfg)
    eng = tengine.InferenceEngineV2(tparams, tcfg, tengine.V2EngineConfig(
        kv_block_size=16, kv_num_blocks=5), device="cpu")  # 4 usable blocks
    assert eng.can_schedule([1], [32]) and not eng.can_schedule([1], [1000])
    with pytest.raises(RuntimeError):
        eng.put([1], [list(range(100))])
    with pytest.raises(ValueError, match="greedy"):
        tengine.InferenceEngineV2(tparams, tcfg, tengine.V2EngineConfig(
            greedy=False, speculative_k=4), device="cpu")
    seq = eng.admit(7, list(range(20)))
    assert seq.uid == 7 and eng.has_work()
    out = eng.step()
    assert list(out) == [7] and eng.kv_reserved_blocks() == 2
    assert eng.kv_block_bytes() == eng.kv.data.numel() * 4 // 5
    eng.finish(7)
    assert list(eng.reap_finished()) == [7] and eng.kv_occupancy() == 0.0


SAMPLING_CASES = [dict(), dict(temperature=1.0), dict(temperature=0.7, top_k=3),
                  dict(temperature=1.0, top_p=0.6), dict(temperature=1.0, top_k=1)]


@pytest.mark.parametrize("opts", SAMPLING_CASES,
                         ids=["greedy", "temp", "topk3", "topp0.6", "topk1"])
def test_sampling_matches_jax(opts):
    """The draws differ by design (torch.Generator vs jax.random), so the
    port is held to the reference's support and, over 4000 draws, to its
    probabilities within 0.03; greedy and top_k=1 are the argmax exactly."""
    from deepspeed_tpu.inference.v2.sampling import (
        SamplingConfig as JSamplingConfig, sample_tokens as j_sample_tokens)
    from deepspeed_tpu_torch.inference.v2.sampling import (SamplingConfig,
                                                           sample_tokens)
    logits = np.array([[2.0, 1.9, 1.7, 0.5, 0.0, -1.0, -3.0, 1.0]], np.float32)
    n = 4000
    gen = torch.Generator()
    gen.manual_seed(0)
    ours = sample_tokens(torch.from_numpy(np.repeat(logits, n, 0)), gen,
                         SamplingConfig(**opts)).numpy()
    ref = np.asarray(j_sample_tokens(jnp.asarray(np.repeat(logits, n, 0)),
                                     jax.random.PRNGKey(0),
                                     JSamplingConfig(**opts)))
    assert ours.dtype == np.int32 and ours.shape == (n,)
    assert set(ours.tolist()) == set(ref.tolist())
    freq = np.bincount(ours, minlength=8) / n
    ref_freq = np.bincount(ref, minlength=8) / n
    np.testing.assert_allclose(freq, ref_freq, atol=0.03)


def test_engine_step_emits_serve_spans(models):
    """The step's prefill/decode spans reach the tracer when it is on (the
    reference's span names), and nothing is recorded when it is off."""
    from deepspeed_tpu_torch.telemetry.tracer import configure_tracing
    _, _, tcfg, tparams = models
    eng = tengine.InferenceEngineV2(tparams, tcfg, tengine.V2EngineConfig(
        **SMALL), device="cpu")
    tracer = configure_tracing(enabled=False)
    before = len(tracer.events_snapshot())
    eng.generate(_prompt(4, 20), max_new_tokens=2, uid=1)
    assert len(tracer.events_snapshot()) == before
    configure_tracing(enabled=True)
    try:
        eng.generate(_prompt(4, 20), max_new_tokens=3, uid=2)
        names = [e[1] for e in tracer.events_snapshot()[before:]]
    finally:
        configure_tracing(enabled=False)
    assert names.count("serve/step_prefill") == 1
    assert names.count("serve/step_decode") == 2


def test_port_never_imports_jax_or_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import deepspeed_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'deepspeed_tpu' or m.startswith('deepspeed_tpu.')"
        " or m == 'ml_dtypes')\n"
        "assert not bad, bad\n"
        "from deepspeed_tpu_torch.ops import build\n"
        "assert not build._builds, 'an import built a library'\n"
        "print(len(mods))\n"
        "print(' '.join(mods))\n")
    res = subprocess.run([sys.executable, "-I", "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    scanned = set(res.stdout.split()[1:])
    # the memory tiers' modules are among those imported
    assert {"deepspeed_tpu_torch.ops.cpu_adam", "deepspeed_tpu_torch.ops.async_io",
            "deepspeed_tpu_torch.runtime.offload",
            "deepspeed_tpu_torch.runtime.param_offload",
            "deepspeed_tpu_torch.runtime.staging"} <= scanned
    # and the role split, the fleet and the request-trace stitcher
    assert {"deepspeed_tpu_torch.serving.disagg",
            "deepspeed_tpu_torch.serving.fleet",
            "deepspeed_tpu_torch.serving.fleet_worker",
            "deepspeed_tpu_torch.telemetry.reqtrace",
            "deepspeed_tpu_torch.telemetry.crossrank"} <= scanned
    # and distribution: comm/, the harness, ZeRO's placement and qgZ
    assert {"deepspeed_tpu_torch.comm.mesh", "deepspeed_tpu_torch.comm.comm",
            "deepspeed_tpu_torch.comm.comms_logging",
            "deepspeed_tpu_torch.comm.compress",
            "deepspeed_tpu_torch.comm.guard", "deepspeed_tpu_torch.testing",
            "deepspeed_tpu_torch.runtime.zero.partition",
            "deepspeed_tpu_torch.runtime.zero.qgz"} <= scanned
    # and MoE: the layer, the two families, their HF helpers and policies
    assert {"deepspeed_tpu_torch.moe", "deepspeed_tpu_torch.moe.sharded_moe",
            "deepspeed_tpu_torch.models.mixtral",
            "deepspeed_tpu_torch.models.qwen2_moe",
            "deepspeed_tpu_torch.models.families",
            "deepspeed_tpu_torch.inference.v2.modules"} <= scanned
    n_modules = int(res.stdout.split()[0])
    assert n_modules == len(list(pkgutil.walk_packages(
        deepspeed_tpu_torch.__path__, "deepspeed_tpu_torch.")))
    files = list((REPO / "deepspeed_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "tests" / "torch_dist_ranks.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "deepspeed_tpu",
                                   "ml_dtypes"), \
                    (path, name)


def test_bf16_serving_logits_match_jax():
    """bf16 serving against the JAX engine on the same flax weights. The head
    multiplies the float32 hidden state by the float32 head, as the JAX
    policy does (``inference/v2/modules.py:143-147``), so on one normalised
    hidden state the two heads agree within float32 atol/rtol 1e-5; the
    product the port used to take (bf16 x bf16 head, logits rounded to bf16)
    misses that by about a bf16 ulp of the logits. A whole bf16 prefill and
    the decode step after it agree within 1% of the logits' spread with the
    same argmax (the layers round at the same points but their bf16 matmuls
    sum in other orders)."""
    from deepspeed_tpu.inference.v2.llama_decode import _rms as j_rms
    from deepspeed_tpu_torch.inference.v2.llama_decode import _rms
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.bfloat16,
                               max_seq_len=512)
    params = jllama.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), jllama.random_tokens(1, 8, 512))["params"]
    names = {f.name for f in dataclasses.fields(tllama.LlamaConfig)} - {"dtype"}
    tcfg = tllama.LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                              dtype=torch.bfloat16)
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    assert tparams["model"]["lm_head"]["kernel"].dtype == torch.float32

    x = np.random.default_rng(2).normal(size=(6, jcfg.hidden_size))
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(JLlamaPolicy.unembed(params, jnp.asarray(x, jnp.bfloat16),
                                           jcfg))
    got = LlamaPolicy.unembed(tparams, torch.from_numpy(x).bfloat16(), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    h = _rms(torch.from_numpy(x).bfloat16(),
             tparams["model"]["final_norm"]["scale"], tcfg.rms_norm_eps)
    old = (h @ tparams["model"]["lm_head"]["kernel"].bfloat16()).float()
    assert float((old - got).abs().max()) > 1e-3     # the old head misses it
    np.testing.assert_allclose(
        np.asarray(j_rms(jnp.asarray(x, jnp.bfloat16),
                         params["model"]["final_norm"]["scale"], 1e-5),
                   np.float32), h.float().numpy(), atol=0, rtol=0)

    jc, tc = _fresh_caches((jcfg, params, tcfg, tparams), jnp.bfloat16,
                           torch.bfloat16)
    tokens = np.zeros(32, np.int32)
    tokens[:20] = _prompt(5, 20)
    table = np.arange(4, dtype=np.int32)
    jl, jc = j_prefill_chunk_g(params, jc, jnp.asarray(tokens), 0,
                               jnp.asarray(table), 20, policy=JLlamaPolicy,
                               cfg=jcfg, block_size=16, attn_impl="gather")
    tl, tc = prefill_chunk_g(tparams, tc, torch.from_numpy(tokens), 0,
                             torch.from_numpy(table), 20, policy=LlamaPolicy,
                             cfg=tcfg, block_size=16, attn_impl="auto")
    tok = np.array([int(np.argmax(np.asarray(jl)))], np.int32)
    pos, tables, valid = (np.array([20], np.int32), table[None],
                          np.array([True]))
    jd, _ = j_decode_step_g(params, jc, jnp.asarray(tok), jnp.asarray(pos),
                            jnp.asarray(tables), jnp.asarray(valid),
                            policy=JLlamaPolicy, cfg=jcfg, block_size=16,
                            attn_impl="gather")
    td, _ = decode_step_g(tparams, tc, torch.from_numpy(tok),
                          torch.from_numpy(pos), torch.from_numpy(tables),
                          torch.from_numpy(valid), policy=LlamaPolicy,
                          cfg=tcfg, block_size=16, attn_impl="gather")
    for ours, ref in ((tl, jl), (td[0], jd[0])):
        ref = np.asarray(ref, np.float32)
        spread = float(ref.max() - ref.min())
        assert float(np.abs(ours.float().numpy() - ref).max()) <= 0.01 * spread
        assert int(ours.argmax()) == int(ref.argmax())
