"""Port parity: the KV cache writes and the serving bookkeeping against the
JAX package.

``write_kv_scaled`` runs on both sides on the same inputs (numpy seed, with
outliers that grow page scales): scales agree to float32 precision, and the
fp8 pages agree to one fp8 ulp (XLA/ml_dtypes and PyTorch may round a
float32 -> e4m3 cast differently). The allocator, scheduler, state manager,
prefix cache and tick ledger are copies; the same operations on both sides
must give the same results exactly.
"""

import numpy as np
import pytest
import torch

# the JAX side needs jax and flax; the card's machine lacks flax
pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from deepspeed_tpu.inference.v2 import kv_cache as jkv
from deepspeed_tpu.inference.v2.blocked_allocator import BlockedAllocator as JAllocator
from deepspeed_tpu.inference.v2.prefix_cache import PrefixCache as JPrefixCache
from deepspeed_tpu.inference.v2.ragged_manager import StateManager as JStateManager
from deepspeed_tpu.inference.v2.scheduler import (SchedulerConfig as JSchedulerConfig,
                                                  plan_step as j_plan_step)
from deepspeed_tpu.runtime.sched import TickLedger as JTickLedger
from deepspeed_tpu_torch.inference.v2 import kv_cache as tkv
from deepspeed_tpu_torch.inference.v2.blocked_allocator import BlockedAllocator
from deepspeed_tpu_torch.inference.v2.prefix_cache import PrefixCache
from deepspeed_tpu_torch.inference.v2.ragged_manager import StateManager
from deepspeed_tpu_torch.inference.v2.scheduler import (SchedulerConfig,
                                                        plan_step, snap_bucket)
from deepspeed_tpu_torch.runtime.sched import TickLedger

FP8_ULP = 2.0 ** -3          # e4m3: 3 mantissa bits -> one ulp relative


def _fp8_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def test_write_kv_scaled_matches_jax():
    rng = np.random.default_rng(0)
    layers, hkv, nb, bs, d = 2, 2, 8, 16, 32
    t = 40
    vals_k = rng.normal(size=(t, hkv, d)).astype(np.float32)
    vals_v = rng.normal(size=(t, hkv, d)).astype(np.float32)
    vals_k[5, 0] *= 2000.0                  # grows page 0's K scale
    vals_v[33, 1] *= 1500.0                 # grows page 2's V scale
    blocks = (np.arange(t) // bs).astype(np.int32)
    offs = (np.arange(t) % bs).astype(np.int32)
    halves = [(slice(0, 20), [0, 1]), (slice(20, t), [1, 2])]

    jd = jnp.zeros((layers, 2, hkv, nb, bs, d), jnp.float8_e4m3fn)
    js = jnp.ones((layers, 2, hkv, nb), jnp.float32)
    td = torch.zeros((layers, 2, hkv, nb, bs, d), dtype=torch.float8_e4m3fn)
    ts = torch.ones((layers, 2, hkv, nb), dtype=torch.float32)
    for kv, vals in ((0, vals_k), (1, vals_v)):
        for rows, touched in halves:       # two calls: regrowth + requantize
            jd, js = jkv.write_kv_scaled(
                jd, js, 1, kv, jnp.asarray(vals[rows]),
                jnp.asarray(blocks[rows]), jnp.asarray(offs[rows]),
                jnp.asarray(touched))
            tkv.write_kv_scaled(
                td, ts, 1, kv, torch.from_numpy(vals[rows]),
                torch.from_numpy(blocks[rows]), torch.from_numpy(offs[rows]),
                torch.tensor(touched))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert ts[1, 0, 0, 0] > 1.0 and ts[1, 1, 1, 2] > 1.0
    want = np.asarray(jd).astype(np.float32)
    got = _fp8_np(td)
    np.testing.assert_allclose(got, want, rtol=FP8_ULP, atol=0.0)
    assert (got == want).mean() > 0.99      # ulp flips are rare, not the rule
    assert (td[0].float() == 0).all()       # other layers untouched


def test_write_kv_and_cast_match_jax():
    """The plain page write (bf16/fp32 and clamped fp8) lands exactly where
    the reference's ``.at[i, kv, :, blk, off].set`` does, with padding rows
    on the trash page."""
    rng = np.random.default_rng(1)
    hkv, nb, bs, d, t = 2, 6, 4, 8, 5
    vals = (rng.normal(size=(t, hkv, d)) * 300).astype(np.float32)
    blocks = np.array([2, 2, 3, 5, 5], np.int32)       # 5 = trash page
    offs = np.array([2, 3, 0, 0, 0], np.int32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float8_e4m3fn, torch.float8_e4m3fn)):
        jd = jnp.zeros((1, 2, hkv, nb, bs, d), jdt)
        jd = jd.at[0, 1, :, jnp.asarray(blocks[:3]), jnp.asarray(offs[:3])].set(
            jkv.cast_to_page_dtype(jnp.asarray(vals[:3]), jdt))
        td = torch.zeros((1, 2, hkv, nb, bs, d), dtype=tdt)
        tkv.write_kv(td, 0, 1, torch.from_numpy(vals), torch.from_numpy(blocks),
                     torch.from_numpy(offs))
        got = td.float().numpy()
        got[..., 5, :, :] = 0.0                        # ignore the trash page
        np.testing.assert_allclose(got, np.asarray(jd).astype(np.float32),
                                   rtol=FP8_ULP if tdt != torch.float32 else 0)
        assert np.isfinite(got).all()


def test_blocked_kv_cache_matches_jax():
    cfg = dict(num_layers=2, num_kv_heads=2, head_dim=8, block_size=4,
               num_blocks=6)
    jc = jkv.BlockedKVCache(jkv.KVCacheConfig(**cfg, dtype=jnp.float8_e4m3fn))
    tc = tkv.BlockedKVCache(tkv.KVCacheConfig(**cfg, dtype=torch.float8_e4m3fn),
                            torch.device("cpu"))
    assert tuple(tc.data.shape) == jc.data.shape
    assert tuple(tc.scales.shape) == jc.scales.shape
    assert tc.free_blocks == jc.free_blocks == 5   # last block is trash
    assert [tc.blocks_needed(n) for n in (0, 1, 4, 5, 9)] == \
        [jc.blocks_needed(n) for n in (0, 1, 4, 5, 9)]
    assert tc.reserve(3) == jc.reserve(3)
    tc.scales.fill_(3.0)
    jc.scales = jnp.full_like(jc.scales, 3.0)
    tc.release([0, 1, 2], pinned=[1])
    jc.release([0, 1, 2], pinned=[1])
    np.testing.assert_array_equal(tc.scales.numpy(), np.asarray(jc.scales))
    assert tc.free_blocks == jc.free_blocks
    plain = tkv.BlockedKVCache(tkv.KVCacheConfig(**cfg), torch.device("cpu"))
    assert plain.scales is None and plain.data.dtype == torch.bfloat16


def test_allocator_matches_jax():
    ja, ta = JAllocator(10), BlockedAllocator(10)
    ops = [("a", 3), ("a", 4), ("f", [1, 5]), ("a", 2), ("f", [0]), ("a", 3)]
    for op, arg in ops:
        if op == "a":
            assert ta.allocate(arg) == ja.allocate(arg)
        else:
            ta.free(arg)
            ja.free(arg)
        assert ta.free_blocks == ja.free_blocks
    for a in (ja, ta):
        with pytest.raises(ValueError):
            a.allocate(a.free_blocks + 1)
        with pytest.raises(ValueError):
            a.free([99])


def _states(sm_cls):
    sm = sm_cls(max_tracked_sequences=8, max_context_length=6000)
    long_seq = sm.create(1, np.arange(5000) % 100)
    long_seq.seen_tokens = 300
    sm.create(2, list(range(40)))
    dec = sm.create(3, [1, 2, 3])
    dec.seen_tokens = 3
    dec.generated.append(7)
    done = sm.create(4, [5, 6])
    done.done = True
    return sm


@pytest.mark.parametrize("sched", [
    dict(max_tokens_per_step=2048, prefill_buckets=(128, 512, 2048)),
    dict(max_tokens_per_step=256, prefill_buckets=(16, 64, 256),
         prefill_chunk_tokens=128),
    dict(max_tokens_per_step=64, prefill_buckets=(16, 32, 64),
         max_decode_batch=1),
])
def test_state_manager_and_plan_step_match_jax(sched):
    js, ts = _states(JStateManager), _states(StateManager)
    for getter in ("decoding", "prefilling", "running", "all"):
        assert [s.uid for s in getattr(ts, getter)()] == \
            [s.uid for s in getattr(js, getter)()]
    jplan = j_plan_step(js.decoding(), js.prefilling(),
                        JSchedulerConfig(**sched), block_tokens=16)
    tplan = plan_step(ts.decoding(), ts.prefilling(),
                      SchedulerConfig(**sched), block_tokens=16)
    assert [s.uid for s in tplan.decode_seqs] == [s.uid for s in jplan.decode_seqs]
    assert [(c.seq.uid, c.start, c.length, c.bucket) for c in tplan.prefill_chunks] == \
        [(c.seq.uid, c.start, c.length, c.bucket) for c in jplan.prefill_chunks]
    assert snap_bucket(3, (4, 8)) == 4 and snap_bucket(9, (4, 8)) == 8
    for sm in (js, ts):
        with pytest.raises(ValueError):
            sm.create(1, [1])


def _drive_prefix_cache(cache):
    """A fixed op sequence: insert, hit, absorb, evict; returns observables."""
    seen = []
    a = list(range(100, 140))                           # 2.5 blocks of 16
    b = a[:32] + [7] * 20
    seen.append(cache.insert_from_seq(1, a, [10, 11, 12], 40))
    seen.append(cache.admit_match(2, b))
    seen.append(cache.lookup(a))
    cache.release_seq(1)
    seen.append(cache.insert_from_seq(2, b, [10, 11, 13], 52, pin=False))
    cache.release_seq(2)
    seen.append(cache.plan_evictions(2))
    seen.append(cache.evict_blocks(cache.plan_evictions(1)))
    seen.append(sorted(b for b in range(20) if cache.owns(b)))
    seen.append(cache.chains())
    seen.append(cache.snapshot())
    return seen


def test_prefix_cache_matches_jax():
    assert _drive_prefix_cache(PrefixCache(16)) == \
        _drive_prefix_cache(JPrefixCache(16))


def test_tick_ledger_matches_jax():
    ticks = [(256, 2, 0), (128, 1, 4), (0, 0, 8), (512, 3, 2), (64, 1, 1)]
    jl, tl = JTickLedger(), TickLedger()
    for ledger in (jl, tl):
        for i, (p, c, d) in enumerate(ticks):
            ledger.observe_tick(p, c, d, cap=256)
            ledger.attribute_request(i % 2, p, c, d)
            if i == 2:
                ledger.reset_window()
    assert tl.snapshot(cap=256) == jl.snapshot(cap=256)
    assert tl.snapshot(gap_unit_tokens=64) == jl.snapshot(gap_unit_tokens=64)
    assert tl.request_ticks == jl.request_ticks
    other_j, other_t = JTickLedger(), TickLedger()
    other_j.observe_tick(1024, 1, 0)
    other_t.observe_tick(1024, 1, 0)
    jl.merge_from(other_j)
    tl.merge_from(other_t)
    assert tl.snapshot() == jl.snapshot()
