"""Port parity: the prefill/decode role split (``serving/disagg.py``) and
the engine's three KV handoffs (``adopt_kv_handoff``,
``export_prefix_handoff``, ``import_prefix_handoff``) against the JAX
package.

- The five role-split cases of ``tests/test_sched.py``, each under its own
  name, on TINY_LLAMA fp32 with the flax weights of the JAX tests
  (``llama_params_from_jax``, ``device="cpu"``): a "none" handoff lands
  bit-identical on the decode engine and the donor keeps nothing; an int8
  handoff lands within ``quantize_error_bound`` and travels narrow; the
  pair continues to the single engine's greedy tokens for "none" and
  "int8"; ``serving.scheduler.role_split`` through the real server serves
  the single-engine server's tokens. Each engine-level case runs the JAX
  pair on the same prompts: tokens and ``handoff_stats`` identical.
- The handoff file: a prefix chain exported by the JAX engine imports into
  the port's and the other way round, for "none" (fp32 pages) and "int8"
  (codes and scales), pages as the writer exported them and the chain
  served as a prefix hit; the port round-trips bf16 pages and fp8 device
  pages (raw bits under a dtype tag) bit for bit; chains that do not fit,
  another block geometry and another model are skipped with the
  reservations given back; adoption that cannot fit mutates nothing.
- On the card (``gpu``): the tiny fp32 pair's "none" tokens equal the
  single engine's through the paged kernel, and a bf16 prefix handoff
  round-trips bit for bit.

Tolerance: tokens, counters and "none" pages exact; JAX and port pages
(two implementations of the same fp32 model) within 1e-5; int8 pages within
the codec's bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2 import kv_offload as tkvo
from deepspeed_tpu_torch.inference.v2.engine_v2 import (InferenceEngineV2,
                                                        V2EngineConfig)
from deepspeed_tpu_torch.inference.v2.scheduler import SchedulerConfig
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.models.convert import (init_llama_params,
                                                llama_params_from_jax)
from deepspeed_tpu_torch.serving import bench_serve
from deepspeed_tpu_torch.serving.disagg import DisaggregatedEngine
from deepspeed_tpu_torch.telemetry.tracer import get_tracer


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (the card's machine has no flax: the
    parity tests skip there, the ``gpu`` tests do not need them)."""
    pytest.importorskip("flax")
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from deepspeed_tpu.inference.v2 import engine_v2 as jengine
    from deepspeed_tpu.inference.v2.scheduler import \
        SchedulerConfig as JSchedulerConfig
    from deepspeed_tpu.models import llama as jllama
    from deepspeed_tpu.serving import disagg as jdisagg
    return dict(jax=jax, jnp=jnp, engine=jengine, sched=JSchedulerConfig,
                llama=jllama, disagg=jdisagg)


@pytest.fixture(scope="module")
def models(jx):
    jax, jllama = jx["jax"], jx["llama"]
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jx["jnp"].float32,
                               max_seq_len=512)
    params = jllama.LlamaForCausalLM(jcfg).init(
        jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)}
    )["params"]
    names = {f.name for f in dataclasses.fields(tllama.LlamaConfig)} - {"dtype"}
    tcfg = tllama.LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                              dtype=torch.float32)
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                    device="cpu")
    return jcfg, params, tcfg, tparams


def _engine(models, prefix_cache=False, kv_blocks=64):
    _, _, tcfg, tparams = models
    return InferenceEngineV2(tparams, tcfg, V2EngineConfig(
        kv_block_size=16, kv_num_blocks=kv_blocks,
        prefix_cache_enabled=prefix_cache,
        scheduler=SchedulerConfig(max_tokens_per_step=64,
                                  prefill_buckets=(16, 32, 64))),
        device="cpu")


def _jax_engine(jx, models, prefix_cache=False, kv_blocks=64):
    jcfg, params, _, _ = models
    return jx["engine"].InferenceEngineV2(
        params, jcfg, jx["engine"].V2EngineConfig(
            kv_block_size=16, kv_num_blocks=kv_blocks,
            prefix_cache_enabled=prefix_cache,
            scheduler=jx["sched"](max_tokens_per_step=64,
                                  prefill_buckets=(16, 32, 64))))


def _pair(models, handoff_quantize="none"):
    return DisaggregatedEngine(_engine(models), _engine(models),
                               handoff_quantize=handoff_quantize)


def _jax_pair(jx, models, handoff_quantize="none"):
    return jx["disagg"].DisaggregatedEngine(
        _jax_engine(jx, models), _jax_engine(jx, models),
        handoff_quantize=handoff_quantize)


def _prompt(seed, n, vocab=512):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab, n)]


def _prefill_then_handoff(pair, uid, prompt):
    """Prefill ``prompt`` on the pair's prefill engine, hand it off; returns
    the donor's pages (fp32 numpy) and its first token."""
    pair.prefill.put([uid], [prompt])
    while pair.prefill.state.get(uid).in_prefill:
        pair.prefill.step()
    donor = pair.prefill.state.get(uid)
    data, scales = pair.prefill.kv.gather_blocks(donor.blocks)
    first = list(donor.generated)
    pair._handoff()
    return np.array(data, np.float32), scales, first


# ---------------------------------------------------------------------------
# the role-split cases of tests/test_sched.py
# ---------------------------------------------------------------------------
def test_disagg_handoff_roundtrip_bit_identical(jx, models):
    prompt = _prompt(7, 50)
    pair = _pair(models)
    ref, ref_scales, first = _prefill_then_handoff(pair, 7, prompt)
    assert pair.handoff_stats["handoffs"] == 1
    assert 7 not in pair.prefill.state and pair.prefill.host_kv.get(7) is None
    adopted = pair.decode.state.get(7)
    assert adopted is not None and list(adopted.generated) == first
    got, got_scales = pair.decode.kv.gather_blocks(adopted.blocks)
    # full-width codec: the pages land on the decode engine bit-identical
    assert torch.equal(torch.from_numpy(ref), got)
    assert ref_scales is None and got_scales is None
    # donor residue fully released
    assert pair.prefill.kv.free_blocks == \
        pair.prefill.kv.allocator.total_blocks
    # the JAX pair on the same prompt: same first token, same accounting,
    # the same pages within the two implementations' fp32 difference
    jpair = _jax_pair(jx, models)
    jref, _, jfirst = _prefill_then_handoff(jpair, 7, prompt)
    assert jfirst == first
    assert jpair.handoff_stats == pair.handoff_stats
    np.testing.assert_allclose(ref, jref, atol=1e-5, rtol=1e-5)


def test_disagg_handoff_quantized_tolerance_pinned(jx, models):
    prompt = _prompt(8, 40)
    pair = _pair(models, handoff_quantize="int8")
    ref, _, _ = _prefill_then_handoff(pair, 9, prompt)
    _q, qscales = tkvo.quantize_pages(torch.from_numpy(ref), "int8")
    bound = tkvo.quantize_error_bound(qscales, "int8")
    assert pair.handoff_stats["handoffs"] == 1
    # int8 travels at ~1/4 width; the wire accounting proves it
    assert pair.handoff_stats["handoff_bytes"] < \
        pair.handoff_stats["handoff_raw_bytes"]
    got, _ = pair.decode.kv.gather_blocks(pair.decode.state.get(9).blocks)
    err = float((got.float() - torch.from_numpy(ref)).abs().max())
    assert err <= bound, (err, bound)
    jpair = _jax_pair(jx, models, handoff_quantize="int8")
    _prefill_then_handoff(jpair, 9, prompt)
    assert jpair.handoff_stats == pair.handoff_stats


@pytest.mark.parametrize("handoff_quantize", ["none", "int8"])
def test_disagg_continues_to_single_engine_tokens(jx, models,
                                                  handoff_quantize):
    """Sequences handed across the role boundary continue decode to the
    single engine's greedy tokens, and to the JAX pair's."""
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(0, 512, int(n))]
               for n in rng.integers(20, 60, 4)]

    solo = _engine(models)
    solo.put(list(range(4)), prompts)
    for _ in range(40):
        solo.step()
        if all(len(solo.state.get(u).generated) >= 8 for u in range(4)):
            break
    want = {u: solo.flush(u)[:8] for u in range(4)}

    def run(pair):
        pair.prefill.put(list(range(4)), prompts)
        for _ in range(60):
            pair.step()
            if all((s := pair.state.get(u)) and len(s.generated) >= 8
                   for u in range(4)):
                break
        return {u: [int(t) for t in pair.flush(u)[:8]] for u in range(4)}

    pair = _pair(models, handoff_quantize=handoff_quantize)
    got = run(pair)
    assert got == want
    assert pair.handoff_stats["handoffs"] == 4      # every uid crossed
    # the handoff store drains: no KV bytes stranded on the boundary
    assert pair.host_kv_bytes() == 0
    jpair = _jax_pair(jx, models, handoff_quantize=handoff_quantize)
    assert run(jpair) == got
    assert jpair.handoff_stats == pair.handoff_stats
    assert set(pair.kv_ledger()) == set(jpair.kv_ledger())
    assert pair.sched_stats() == jpair.sched_stats()


def test_role_split_server_token_parity():
    """``serving.scheduler.role_split`` through the real server: the pair
    serves the same seeded prompts to the same tokens as a single-engine
    server, with every sequence crossing the handoff boundary."""
    def serve(serving_overrides):
        rng = np.random.default_rng(10)
        prompts = [list(map(int, rng.integers(0, 128, int(n))))
                   for n in rng.integers(20, 70, 6)]
        server = bench_serve.build_tiny_server(
            serving_overrides=serving_overrides, device="cpu").start()
        try:
            reqs = [server.submit(p, max_new_tokens=6, timeout_s=120.0)
                    for p in prompts]
            for r in reqs:
                r.wait(timeout=120.0)
            return [list(r.tokens) for r in reqs], server.engine
        finally:
            server.stop(drain_timeout=30.0)

    solo, _ = serve(None)
    split, engine = serve({"scheduler": {"role_split": True,
                                         "prefill_chunk_tokens": 32}})
    assert isinstance(engine, DisaggregatedEngine)
    assert split == solo
    assert engine.handoff_stats["handoffs"] == 6
    assert engine.host_kv_bytes() == 0               # boundary drained
    assert engine.sched_stats()["max_prefill_tokens_per_tick"] <= 32


# ---------------------------------------------------------------------------
# the port's own contracts around the pair
# ---------------------------------------------------------------------------
def test_adoption_that_cannot_fit_mutates_nothing(models):
    pair = _pair(models)
    pair.prefill.put([3], [_prompt(3, 40)])
    while pair.prefill.state.get(3).in_prefill:
        pair.prefill.step()
    pair.prefill.demote_kv(3)
    entry = pair.prefill.host_kv.get(3)
    seq = pair.prefill.state.get(3)
    dec = pair.decode
    free, n = dec.kv.free_blocks, len(dec.state)
    taken = dec.kv.reserve(free - entry.blocks + 1)     # one block short
    assert not dec.adopt_kv_handoff(3, seq.prompt_tokens, seq.generated,
                                    entry)
    assert len(dec.state) == n and 3 not in dec.state
    dec.kv.release(taken)
    assert dec.kv.free_blocks == free
    dec.state.create(3, [1, 2])                         # a uid collision
    assert not dec.adopt_kv_handoff(3, seq.prompt_tokens, seq.generated,
                                    entry)
    dec.state.pop(3)
    # a deferred handoff retries next tick and then crosses
    pair._handoff()
    assert pair.handoff_stats["handoffs"] == 1
    assert pair.host_kv_bytes() == 0


def test_disagg_trace_events_are_emitted():
    from deepspeed_tpu_torch.telemetry.names import TRACE_NAMES
    tracer = get_tracer()
    was = tracer.enabled
    tracer.configure(enabled=True)
    tracer.clear()
    try:
        cfg = dataclasses.replace(tllama.TINY_LLAMA, dtype=torch.float32)
        params = init_llama_params(cfg, seed=0, device="cpu")
        eng = [InferenceEngineV2(params, cfg, V2EngineConfig(
            kv_block_size=16, kv_num_blocks=16), device="cpu")
            for _ in range(2)]
        pair = DisaggregatedEngine(*eng)
        pair.admit(1, _prompt(1, 20, cfg.vocab_size))
        pair.step()
        pair.step()
        names = [e[1] for e in tracer.events_snapshot()]
    finally:
        tracer.clear()
        tracer.configure(enabled=was)
    assert names.count("disagg/handoff") == 1
    assert names.count("disagg/tick") == 2
    assert TRACE_NAMES["disagg/tick"] == ("complete",)
    assert TRACE_NAMES["disagg/handoff"] == ("instant",)
    # the pair shares the weights: neither engine copied them
    assert eng[0].params is eng[1].params is params


# ---------------------------------------------------------------------------
# the prefix-handoff file
# ---------------------------------------------------------------------------
def _warm(eng, prompt, uid=1):
    """Serve ``prompt`` once (two tokens) so its full blocks sit in the
    prefix cache."""
    eng.generate(prompt, max_new_tokens=2, uid=uid)
    return eng


def _cached_pages(eng):
    """{chain tokens: fp32 pages} of every cached chain."""
    out = {}
    for tokens, blocks in eng.prefix_cache.chains():
        data, _ = eng.kv.gather_blocks(list(blocks))
        out[tuple(int(t) for t in tokens)] = np.array(data, np.float32)
    return out


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("codec", ["none", "int8"])
def test_handoff_file_interchanges_with_jax(jx, models, tmp_path, codec,
                                            direction):
    """A chain one engine exports, the other imports: the imported pages
    are the exported ones (dequantized for int8, by the reader's codec),
    and the same prompt is then a prefix hit."""
    prompt = _prompt(11, 53)
    path = str(tmp_path / "handoff.npz")
    make = {"jax": lambda: _jax_engine(jx, models, prefix_cache=True),
            "port": lambda: _engine(models, prefix_cache=True)}
    src, dst = direction.split("_to_")
    donor = _warm(make[src](), prompt)
    got = donor.export_prefix_handoff(path, quantize=codec)
    assert got["chains"] >= 1 and got["blocks"] >= 3
    assert (got["stored_bytes"] < got["raw_bytes"]) == (codec == "int8")
    heir = make[dst]()
    adopted = heir.import_prefix_handoff(path)
    assert adopted["chains"] == got["chains"] and adopted["skipped"] == 0
    assert adopted["blocks"] == got["blocks"]
    want = _cached_pages(donor)
    have = _cached_pages(heir)
    assert set(have) == set(want)
    for key, pages in want.items():
        if codec == "none":
            np.testing.assert_array_equal(have[key], pages)
        else:
            stored, qs = tkvo.quantize_pages(torch.from_numpy(pages), "int8")
            ref = tkvo.dequantize_pages(stored, qs, "int8", torch.float32)
            np.testing.assert_allclose(have[key], ref.numpy(), rtol=1e-6,
                                       atol=1e-6)
            assert np.abs(have[key] - pages).max() <= \
                tkvo.quantize_error_bound(qs, "int8")
    before = heir.prefix_stats()["prefix_hit_tokens"]
    heir.generate(prompt, max_new_tokens=2, uid=2)
    assert heir.prefix_stats()["prefix_hit_tokens"] - before == 48


@pytest.mark.parametrize("kind", ["bf16_none", "bf16_fp8_codec", "fp8_pages"])
def test_handoff_file_round_trips_pages_numpy_lacks(tmp_path, kind):
    """bf16 pages and fp8 device pages travel as raw bits under a dtype
    tag and come back bit for bit (fp8 with their scales); bf16 through
    the fp8 codec stores fp8 codes the same way and lands within the
    codec's bound."""
    cfg = dataclasses.replace(tllama.TINY_LLAMA, dtype=torch.bfloat16)
    params = init_llama_params(cfg, seed=0, device="cpu")
    kv_dtype = "fp8" if kind == "fp8_pages" else "model"

    def engine():
        return InferenceEngineV2(params, cfg, V2EngineConfig(
            kv_block_size=16, kv_num_blocks=16, prefix_cache_enabled=True,
            kv_cache_dtype=kv_dtype), device="cpu")
    donor = _warm(engine(), _prompt(12, 40, cfg.vocab_size))
    path = str(tmp_path / "handoff.npz")
    codec = "fp8" if kind == "bf16_fp8_codec" else "none"
    got = donor.export_prefix_handoff(path, quantize=codec)
    with np.load(path) as z:
        tag = str(z["dtype_0"])
        assert z["data_0"].dtype == (np.uint16 if tag == "bfloat16"
                                     else np.uint8)
    assert tag == ("bfloat16" if kind == "bf16_none" else "float8_e4m3fn")
    heir = engine()
    assert heir.import_prefix_handoff(path)["chains"] == got["chains"] >= 1
    for (tokens, blocks), (htokens, hblocks) in zip(
            donor.prefix_cache.chains(), heir.prefix_cache.chains()):
        assert tuple(tokens) == tuple(htokens)
        d, ds = donor.kv.gather_blocks(list(blocks))
        h, hs = heir.kv.gather_blocks(list(hblocks))
        if kind == "bf16_fp8_codec":
            stored, qs = tkvo.quantize_pages(d, "fp8")
            assert (h.float() - d.float()).abs().max() <= \
                tkvo.quantize_error_bound(qs, "fp8") + \
                d.float().abs().max() * 2.0 ** -8    # the bf16 rounding
        else:
            assert torch.equal(d.view(torch.uint8), h.view(torch.uint8))
        if kind == "fp8_pages":
            assert torch.equal(ds, hs)


def test_import_skips_what_does_not_fit_and_gives_blocks_back(models,
                                                              tmp_path):
    donor = _warm(_engine(models, prefix_cache=True), _prompt(13, 53))
    path = str(tmp_path / "handoff.npz")
    got = donor.export_prefix_handoff(path)
    # too few free blocks: skipped, nothing reserved
    small = _engine(models, prefix_cache=True, kv_blocks=3)
    free = small.kv.free_blocks
    out = small.import_prefix_handoff(path)
    assert out == {"chains": 0, "blocks": 0, "skipped": got["chains"],
                   "bytes": 0}
    assert small.kv.free_blocks == free
    # another block geometry: skipped
    _, _, tcfg, tparams = models
    other_bs = InferenceEngineV2(tparams, tcfg, V2EngineConfig(
        kv_block_size=32, kv_num_blocks=16, prefix_cache_enabled=True),
        device="cpu")
    assert other_bs.import_prefix_handoff(path)["skipped"] == got["chains"]
    # another model (other KV heads): the scatter fails, the reservation
    # goes back, the engine stays healthy
    cfg = dataclasses.replace(tcfg, num_kv_heads=4)
    wide = InferenceEngineV2(init_llama_params(cfg, 0, device="cpu"), cfg,
                             V2EngineConfig(kv_block_size=16,
                                            kv_num_blocks=16,
                                            prefix_cache_enabled=True),
                             device="cpu")
    free = wide.kv.free_blocks
    assert wide.import_prefix_handoff(path)["skipped"] == got["chains"]
    assert wide.kv.free_blocks == free
    assert len(wide.generate([1, 2, 3], max_new_tokens=2)) == 2
    # no prefix cache at all: skipped
    plain = _engine(models)
    assert plain.import_prefix_handoff(path)["skipped"] == got["chains"]
    # the reference's bf16 pages (ml_dtypes), which np.load returns as raw
    # void arrays: skipped, the reservation given back
    ml_dtypes = pytest.importorskip("ml_dtypes")
    with np.load(path) as z:
        pages = z["data_0"].astype(ml_dtypes.bfloat16)
        fake = {k: z[k] for k in ("tokens_0", "codec_0", "block_size")}
    bf16_path = str(tmp_path / "bf16.npz")
    np.savez(bf16_path, data_0=pages, num_chains=np.int32(1), **fake)
    heir = _engine(models, prefix_cache=True)
    free = heir.kv.free_blocks
    assert heir.import_prefix_handoff(bf16_path) == {
        "chains": 0, "blocks": 0, "skipped": 1, "bytes": 0}
    assert heir.kv.free_blocks == free


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_disagg_and_prefix_handoff_on_card(tmp_path):
    """The tiny fp32 pair on the card (the paged kernel at head_dim 32):
    "none" handoffs continue to the single engine's greedy tokens, every
    uid crosses, nothing stays on the boundary; then a bf16 prefix chain
    (head_dim 64) exported and imported on the card round-trips bit for bit
    and the successor serves its prompt as a hit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels; no CPU mode)")
    from deepspeed_tpu_torch.ops import build
    cfg = dataclasses.replace(tllama.TINY_LLAMA, dtype=torch.float32,
                              max_seq_len=512)
    params = init_llama_params(cfg, seed=0, device="cuda")

    def engine(**kw):
        return InferenceEngineV2(params, cfg, V2EngineConfig(
            kv_block_size=16, kv_num_blocks=64,
            scheduler=SchedulerConfig(max_tokens_per_step=64,
                                      prefill_buckets=(16, 32, 64)), **kw),
            device="cuda")
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(0, 512, int(n))]
               for n in rng.integers(20, 60, 4)]
    solo = engine()
    solo.put(list(range(4)), prompts)
    while not all(len(solo.state.get(u).generated) >= 8 for u in range(4)):
        solo.step()
    want = {u: solo.flush(u)[:8] for u in range(4)}
    pair = DisaggregatedEngine(engine(), engine())
    build.reset_launch_counts()
    pair.prefill.put(list(range(4)), prompts)
    while not all((s := pair.state.get(u)) and len(s.generated) >= 8
                  for u in range(4)):
        pair.step()
    assert {u: pair.flush(u)[:8] for u in range(4)} == want
    assert pair.handoff_stats["handoffs"] == 4 and pair.host_kv_bytes() == 0
    assert build.launch_counts().get("paged_attention", 0) > 0

    bcfg = dataclasses.replace(tllama.TINY_LLAMA, num_heads=2,
                               num_kv_heads=1, dtype=torch.bfloat16)
    bparams = init_llama_params(bcfg, seed=0, device="cuda")

    def bengine():
        return InferenceEngineV2(bparams, bcfg, V2EngineConfig(
            kv_block_size=16, kv_num_blocks=16, prefix_cache_enabled=True),
            device="cuda")
    prompt = _prompt(12, 40, bcfg.vocab_size)
    donor = _warm(bengine(), prompt)
    path = str(tmp_path / "handoff.npz")
    got = donor.export_prefix_handoff(path)
    heir = bengine()
    assert heir.import_prefix_handoff(path)["chains"] == got["chains"] >= 1
    for (_, blocks), (_, hblocks) in zip(donor.prefix_cache.chains(),
                                         heir.prefix_cache.chains()):
        d, _ = donor.kv.gather_blocks(list(blocks))
        h, _ = heir.kv.gather_blocks(list(hblocks))
        assert torch.equal(d.view(torch.uint16), h.view(torch.uint16))
    before = heir.prefix_stats()["prefix_hit_tokens"]
    heir.generate(prompt, max_new_tokens=2, uid=2)
    assert heir.prefix_stats()["prefix_hit_tokens"] - before == 32
