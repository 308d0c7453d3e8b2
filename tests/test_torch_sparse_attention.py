"""Port parity: the PyTorch block-sparse attention against the JAX package.

Every sparsity config of ``deepspeed_tpu_torch.ops.sparse_attention`` (the
port's numpy copy) gives the JAX configs' layouts bit for bit for the same
arguments and seeds. The plain blockwise version and the autograd function
(CPU tensors) are held against ``pallas_block_sparse_attention(...,
interpret=True)``, ``block_sparse_attention`` and
``sparse_attention_reference`` on inputs made from a numpy seed: float32
forward within 2e-5 and gradients within 1e-4 (as
``tests/test_sparse_attention.py`` holds the JAX paths to their oracle),
bfloat16 rows (forward and dq/dk/dv) within 4 bf16 ulps of each row's
largest value.

The CUDA kernel runs only on the card: ``test_kernel_matches_plain_on_card``
is marked ``gpu`` and skips where there is none. On the card:
``python -m pytest --noconftest -m gpu tests/test_torch_sparse_attention.py``.
"""

import math

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.sparse_attention import (
    BigBirdSparsityConfig, DenseSparsityConfig, FixedSparsityConfig,
    LocalSlidingWindowSparsityConfig, SparseLayout, SparseSelfAttention,
    attention, block_sparse_attention, sparse_attention, sparse_attention_cuda,
    sparse_attention_fwd, sparse_attention_reference)

FWD_TOL, BWD_TOL = 2e-5, 1e-4


def _jax():
    """The JAX side, imported where it is used (the card's machine lacks
    flax, and the card-only test below must still be collected there)."""
    pytest.importorskip("flax")
    jax = pytest.importorskip("jax")
    from deepspeed_tpu.ops import sparse_attention as jsa
    return jax, jsa


# (config class name, kwargs, sequence lengths)
CONFIGS = {
    "dense": ("DenseSparsityConfig", dict(num_heads=2, block=16), (64, 128)),
    "fixed_bi": ("FixedSparsityConfig", dict(
        num_heads=4, block=16, num_local_blocks=4, num_global_blocks=1),
        (256, 272)),
    "fixed_uni_patterns": ("FixedSparsityConfig", dict(
        num_heads=4, block=16, different_layout_per_head=True,
        num_local_blocks=4, num_global_blocks=2, attention="unidirectional",
        num_different_global_patterns=2), (128, 208)),
    "fixed_horizontal": ("FixedSparsityConfig", dict(
        num_heads=2, block=32, num_local_blocks=3, num_global_blocks=1,
        horizontal_global_attention=True), (320, 352)),
    "variable": ("VariableSparsityConfig", dict(
        num_heads=3, block=16, different_layout_per_head=True,
        num_random_blocks=2, local_window_blocks=[2, 3, 4],
        global_block_indices=[0, 5], global_block_end_indices=[2, 7],
        horizontal_global_attention=True), (256, 400)),
    "variable_uni": ("VariableSparsityConfig", dict(
        num_heads=2, block=16, num_random_blocks=3,
        attention="unidirectional"), (256,)),
    "bigbird": ("BigBirdSparsityConfig", dict(
        num_heads=4, block=16, different_layout_per_head=True,
        num_random_blocks=3, num_sliding_window_blocks=3,
        num_global_blocks=2), (128, 512)),
    "bigbird_uni": ("BigBirdSparsityConfig", dict(
        num_heads=2, block=32, num_random_blocks=2,
        attention="unidirectional"), (256,)),
    "longformer": ("BSLongformerSparsityConfig", dict(
        num_heads=2, block=16, num_sliding_window_blocks=5,
        global_block_indices=[0, 9], global_block_end_indices=[2, 30]),
        (256, 160)),
    "local": ("LocalSlidingWindowSparsityConfig", dict(
        num_heads=2, block=16, num_sliding_window_blocks=5), (128,)),
}


def _both_configs(name, seed=None):
    _, jsa = _jax()
    import deepspeed_tpu_torch.ops.sparse_attention as tsa
    cls, kw, lens = CONFIGS[name]
    if seed is not None:
        kw = dict(kw, seed=seed)
    return getattr(tsa, cls)(**kw), getattr(jsa, cls)(**kw), lens


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layouts_equal_the_jax_ones(name):
    """Several lengths, and for the random patterns several seeds."""
    random = CONFIGS[name][0] in ("VariableSparsityConfig",
                                  "BigBirdSparsityConfig")
    for seed in ((0, 1, 7) if random else (None,)):
        port, ref, lens = _both_configs(name, seed)
        for s in lens:
            got, want = port.make_layout(s), ref.make_layout(s)
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (name, seed, s)


def test_config_errors_match_jax():
    _, jsa = _jax()
    import deepspeed_tpu_torch.ops.sparse_attention as tsa
    bad = [("FixedSparsityConfig", dict(num_heads=2, num_local_blocks=3,
                                        num_global_blocks=2)),
           ("FixedSparsityConfig", dict(num_heads=2, attention="sideways")),
           ("VariableSparsityConfig", dict(num_heads=2, global_block_indices=[0],
                                           global_block_end_indices=[1, 2])),
           ("BigBirdSparsityConfig", dict(num_heads=2, attention="sideways"))]
    for cls, kw in bad:
        with pytest.raises(Exception) as want:
            getattr(jsa, cls)(**kw)
        with pytest.raises(type(want.value)):
            getattr(tsa, cls)(**kw)
    with pytest.raises(ValueError, match="divisible"):
        tsa.DenseSparsityConfig(num_heads=1, block=16).make_layout(100)
    with pytest.raises(ValueError, match="too few"):
        tsa.BigBirdSparsityConfig(num_heads=1, block=16,
                                  num_random_blocks=5).make_layout(64)


def _qkv(b=2, s=64, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, d)).astype(np.float32)
                 for _ in range(4))


def _bigbird_layout(h=4, s=64, block=16):
    return BigBirdSparsityConfig(num_heads=h, block=block,
                                 different_layout_per_head=True,
                                 seed=1).make_layout(s)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(causal):
    jax, jsa = _jax()
    q, k, v, _ = _qkv()
    lay = _bigbird_layout()
    want = np.asarray(jsa.pallas_block_sparse_attention(q, k, v, lay, 16,
                                                        causal, True))
    ref = np.asarray(jsa.sparse_attention_reference(q, k, v, lay, 16, causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = sparse_attention(tq, tk, tv, lay, 16, causal).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(got, ref, atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(
        sparse_attention_reference(tq, tk, tv, lay, 16, causal).numpy(), ref,
        atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(
        block_sparse_attention(tq, tk, tv, lay, 16, causal).numpy(),
        np.asarray(jsa.block_sparse_attention(q, k, v, lay, 16, causal)),
        atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_rows_within_4_ulps_of_jax(causal):
    jax, jsa = _jax()
    import jax.numpy as jnp
    q, k, v, _ = _qkv(s=128, d=32, seed=1)
    lay = FixedSparsityConfig(num_heads=4, block=16, num_local_blocks=2,
                              attention="unidirectional" if causal
                              else "bidirectional").make_layout(128)
    want = np.asarray(jsa.pallas_block_sparse_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), lay, 16, causal,
        True).astype(jnp.float32))
    got = sparse_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                           lay, 16, causal).float().numpy()
    top = np.abs(want).max(-1, keepdims=True)
    tol = 4 * 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax(causal):
    jax, jsa = _jax()
    import jax.numpy as jnp
    q, k, v, w = _qkv(s=64, seed=2)
    lay = _bigbird_layout()

    def loss(q_, k_, v_):
        return jnp.sum(w * jsa.pallas_block_sparse_attention(
            q_, k_, v_, lay, 16, causal, True))

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    (torch.from_numpy(w) * sparse_attention(tq, tk, tv, lay, 16, causal)
     ).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BWD_TOL,
                                   rtol=BWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_grads_within_4_ulps_of_jax(causal):
    """bf16 dq/dk/dv (the paths S1/S2 run in bf16) against JAX's vjp of the
    Pallas kernel on bf16 inputs: each row within 4 bf16 ulps of its
    largest |JAX| value, as the bf16 forward (both sides sum in fp32 in
    other orders and round to bf16)."""
    jax, jsa = _jax()
    import jax.numpy as jnp
    q, k, v, w = _qkv(s=64, seed=2)
    lay = _bigbird_layout()

    def loss(q_, k_, v_):
        return jnp.sum(jnp.asarray(w, jnp.bfloat16) *
                       jsa.pallas_block_sparse_attention(
                           q_, k_, v_, lay, 16, causal, True)
                       ).astype(jnp.float32)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_(True)
                  for a in (q, k, v))
    (torch.from_numpy(w).bfloat16() * sparse_attention(tq, tk, tv, lay, 16,
                                                       causal)
     ).float().sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        top = np.abs(want).max(-1, keepdims=True)
        tol = 4 * 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
        assert (np.abs(got.float().numpy() - want) <= tol).all()


def test_backward_in_query_chunks_matches_whole(monkeypatch):
    """The backward recomputes in chunks of query blocks; forced to one
    block per chunk it gives what autograd through the whole blockwise
    version gives."""
    q, k, v, w = (torch.from_numpy(a) for a in _qkv(s=96, seed=3))
    lay = FixedSparsityConfig(num_heads=4, block=16, num_local_blocks=2,
                              attention="unidirectional").make_layout(96)
    monkeypatch.setattr(attention, "BWD_CHUNK_ELEMS", 1)
    assert attention.bwd_chunk_rows(2, 96, 4, 16) == 16
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (w * sparse_attention(*leaves, lay, 16, True)).sum().backward()
    whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (w * block_sparse_attention(*whole, lay, 16, True)).sum().backward()
    for a, b in zip(leaves, whole):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=1e-5)


def test_rows_without_a_live_block_give_zero():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(s=64, seed=4))
    lay = _bigbird_layout()
    lay[:, 2] = 0                                  # query block 2: nothing live
    out = sparse_attention(q, k, v, lay, 16)
    assert torch.equal(out[:, 32:48], torch.zeros_like(out[:, 32:48]))
    torch.testing.assert_close(out, sparse_attention_reference(q, k, v, lay, 16),
                               atol=FWD_TOL, rtol=FWD_TOL)


def test_csr_lists_live_blocks_in_ascending_order():
    lay = _bigbird_layout(h=2, s=128)
    row_ptr, cols = SparseLayout(lay).csr("cpu")
    h, nb, _ = lay.shape
    assert row_ptr.dtype == torch.int32 and cols.dtype == torch.int32
    assert int(row_ptr[-1]) == int(lay.sum())
    for r in range(h * nb):
        want = np.nonzero(lay.reshape(h * nb, nb)[r])[0]
        got = cols[row_ptr[r]:row_ptr[r + 1]].numpy()
        assert np.array_equal(got, want) and (np.diff(got) > 0).all()


@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_group_csr_takes_each_live_pair_once(name, block):
    """The bf16 kernel's group CSR on every config's layout (33 query
    blocks, so the last group of 2 or 4 is partial): per (head, group) the
    key blocks ascend; each live (query block, key block) pair is one
    entry's bit, exactly once; no dead pair and no query block past the
    layout has its bit set; the kernel's blocks of 64 rows are ordered by
    the length of their list, longest first; at block >= 64 (groups of
    one) it is the CSR with every mask 1."""
    import deepspeed_tpu_torch.ops.sparse_attention as tsa
    cls, kw, _ = CONFIGS[name]
    lay = getattr(tsa, cls)(**dict(kw, block=block)).make_layout(33 * block)
    g = attention.group_size(block)
    assert g == max(1, 64 // block)
    sl = SparseLayout(lay)
    ptr, cols, masks, order = sl.group_csr("cpu", block)
    assert sl.group_csr("cpu", block)[0] is ptr        # cached
    h, nb, _ = lay.shape
    ng = -(-nb // g)
    assert {t.dtype for t in (ptr, cols, masks, order)} == {torch.int32}
    assert ptr.shape == (h * ng + 1,) and int(ptr[-1]) == cols.numel()
    taken = np.zeros(lay.shape, np.int64)
    for hh in range(h):
        for gi in range(ng):
            r = hh * ng + gi
            c = cols[ptr[r]:ptr[r + 1]].numpy()
            m = masks[ptr[r]:ptr[r + 1]].numpy()
            assert (np.diff(c) > 0).all() and (m > 0).all() and (m < 1 << g).all()
            for i in range(g):
                bit = (m >> i) & 1
                qb = gi * g + i
                if qb >= nb:
                    assert not bit.any()
                    continue
                assert (bit == (lay[hh, qb, c] != 0)).all()
                taken[hh, qb, c] += bit
    assert np.array_equal(taken, (lay != 0).astype(np.int64))
    # the kernel's blocks of 64 rows, each once, longest list first
    nx = -(-33 * block // 64)
    assert sorted(order.tolist()) == list(range(h * nx))
    lens = np.diff(ptr.numpy()).reshape(h, ng)
    work = [lens[o // nx, (o % nx) * 64 // (block * g)] for o in order.tolist()]
    assert all(a >= b for a, b in zip(work, work[1:]))
    if block >= 64:
        row_ptr, csr_cols = sl.csr("cpu")
        assert torch.equal(ptr, row_ptr) and torch.equal(cols, csr_cols)
        assert bool((masks == 1).all())


def test_sparse_self_attention_picks_causal_and_caches_layouts():
    jax, jsa = _jax()
    uni = LocalSlidingWindowSparsityConfig(num_heads=4, block=16)
    bi = BigBirdSparsityConfig(num_heads=4, block=16)
    assert SparseSelfAttention(uni).causal
    assert not SparseSelfAttention(bi).causal
    assert SparseSelfAttention(bi, causal=True).causal
    assert not SparseSelfAttention(DenseSparsityConfig(num_heads=4)).causal
    sa = SparseSelfAttention(uni)
    assert sa.sparse_layout(64) is sa.sparse_layout(64)
    assert sa.layout(64) is sa.layout(64)
    assert sa.sparse_layout(128) is not sa.sparse_layout(64)
    q, k, v, _ = _qkv(s=64, seed=5)
    want = np.asarray(jsa.SparseSelfAttention(
        jsa.LocalSlidingWindowSparsityConfig(num_heads=4, block=16))(q, k, v))
    got = sa(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=FWD_TOL)


def test_shape_errors():
    q = torch.zeros(1, 64, 2, 16)
    lay = DenseSparsityConfig(num_heads=2, block=16).make_layout(64)
    with pytest.raises(ValueError, match="divisible"):
        sparse_attention(q[:, :60], q[:, :60], q[:, :60], lay, 16)
    with pytest.raises(ValueError, match="layout"):
        sparse_attention(q, q, q, lay[:1], 16)
    with pytest.raises(ValueError, match="shape"):
        sparse_attention(q, q[:, :32], q[:, :32], lay, 16)


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(s=64, seed=6))
    lay = _bigbird_layout()
    build.reset_launch_counts()
    assert torch.equal(sparse_attention_fwd(q, k, v, lay, 16, True),
                       block_sparse_attention(q, k, v, lay, 16, True))
    assert build.launch_counts() == {}
    with pytest.raises(ValueError, match="unsupported device"):
        sparse_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"), lay, 16)
    with pytest.raises(ValueError, match="sparse_attention kernel"):
        sparse_attention_cuda(q, k, v, lay, 16)     # a CPU tensor never launches
    assert math.isfinite(float(sparse_attention(q, k, v, lay, 16).sum()))


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against the plain blockwise version on the card, in
    the cases and at the tolerances of ``chip_smoke.py``
    (``run_sparse_cases``: blocks 16 to 128, head dims 32 to 128, fp32 and
    bf16, causal on and off, layouts that differ per head, query blocks
    with no live key block, groups that mix empty and live query blocks;
    bf16 rows within 4 bf16 ulps of each row's largest |plain|, fp32 within
    1e-4 of it), with the mutants outside (the last live block dropped,
    head 0's layout everywhere, causal dropped, a group's union taken by
    every query block, the max per 64-key half at block 128); the entry by
    profiler name (bf16 ``sparse_attention_kernel_mma``, fp32
    ``sparse_attention_kernel``) and a bf16 second call bit for bit. Then
    a block, head dim or dtype outside the instances raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels; no CPU mode)")
    import chip_smoke
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = chip_smoke.run_sparse_cases(gen)
    assert len(rows) == len(chip_smoke._sparse_case_layouts())
    lay8 = DenseSparsityConfig(num_heads=2, block=8).make_layout(64)
    x = torch.randn(1, 64, 2, 32, device="cuda")
    with pytest.raises(ValueError, match="block"):
        sparse_attention_cuda(x, x, x, lay8, 8)
    lay = DenseSparsityConfig(num_heads=2, block=16).make_layout(64)
    y = torch.randn(1, 64, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        sparse_attention_cuda(y, y, y, lay, 16)
    with pytest.raises(ValueError, match="dtypes"):
        sparse_attention_cuda(x.half(), x.half(), x.half(), lay, 16)
