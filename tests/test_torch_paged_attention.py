"""Port parity: the PyTorch paged attention against the JAX package.

The port's plain version (``paged_attention_plain``) is held against the
JAX Pallas kernel in interpret mode and against its gather reference, on
the same inputs made from a numpy seed. Tolerance: float32 atol/rtol 1e-5
(the two sides sum in different orders). The fp8 cases hand both sides the
same fp8 bytes, so they are held to the same float32 tolerance.

The kernel's split over pages is held here through its two CPU-side
parts: ``split_plan``, the wrapper's pure choice of splits, and
``_split_combine``, the kernel's per-split online softmax and in-order
combine written in plain torch, held against the same JAX kernel and
reference at 1, 3 and 8 splits.

The CUDA kernel itself runs only on the card: ``test_kernel_matches_plain``
is marked ``gpu`` and skips where there is none. On the card, whose
machine lacks flax: ``python -m pytest --noconftest -m gpu
tests/test_torch_*.py`` (the other port test files skip there).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2.llama_decode import _paged_attn
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.paged_attention import (KEYS_PER_TILE,
                                                     paged_attention,
                                                     paged_attention_plain,
                                                     rows_per_block,
                                                     split_plan)

ATOL = RTOL = 1e-5


def _jax():
    """The JAX side, imported where it is used: the card's machine lacks
    flax (which the JAX reference imports), and the card-only test below
    must still be collected there."""
    pytest.importorskip("flax")
    jnp = pytest.importorskip("jax.numpy")
    from deepspeed_tpu.ops.pallas import paged_attention as pa
    return jnp, pa.paged_attention, pa.paged_attention_reference


def _fp8_to_torch(arr) -> torch.Tensor:
    """A JAX/ml_dtypes float8_e4m3fn array -> the same bytes in torch."""
    return torch.from_numpy(np.asarray(arr).view(np.uint8).copy()).view(
        torch.float8_e4m3fn)


def _make_case(kind, rep, seed, fp8=False):
    """Seeded inputs as numpy (fp8 pages as JAX arrays): decode (B=3, T=1,
    per-sequence start), a prefill chunk from 0, or a continued chunk."""
    jnp = _jax()[0]
    rng = np.random.default_rng(seed)
    hkv, d, bs, nb = 2, 32, 16, 24
    if kind == "decode":
        b, t, mb = 3, 1, 4
        start = rng.integers(0, mb * bs, size=b)
    elif kind == "prefill":
        b, t, mb, start = 1, 24, 2, np.array([0])
    else:                                   # continued chunk
        b, t, mb, start = 1, 16, 4, np.array([20])
    q = rng.normal(size=(b, t, hkv * rep, d)).astype(np.float32)
    k = rng.normal(size=(hkv, nb, bs, d)).astype(np.float32)
    v = rng.normal(size=(hkv, nb, bs, d)).astype(np.float32)
    tables = rng.permutation(nb - 1)[:b * mb].reshape(b, mb).astype(np.int32)
    case = {"q": q, "k": k, "v": v, "tables": tables,
            "start": start.astype(np.int32), "ks": None, "vs": None}
    if fp8:
        ks = rng.uniform(0.5, 2.0, size=(hkv, nb)).astype(np.float32)
        vs = rng.uniform(0.5, 2.0, size=(hkv, nb)).astype(np.float32)
        case["k"] = jnp.asarray(k / ks[..., None, None]).astype(jnp.float8_e4m3fn)
        case["v"] = jnp.asarray(v / vs[..., None, None]).astype(jnp.float8_e4m3fn)
        case["ks"], case["vs"] = ks, vs
    return case


def _torch_args(case):
    page = _fp8_to_torch if case["ks"] is not None else torch.from_numpy
    return (torch.from_numpy(case["q"]), page(case["k"]), page(case["v"]),
            torch.from_numpy(case["tables"]), torch.from_numpy(case["start"]))


def _torch_scales(case):
    if case["ks"] is None:
        return {}
    return {"k_scales": torch.from_numpy(case["ks"]),
            "v_scales": torch.from_numpy(case["vs"])}


def _jax_args(case):
    jnp = _jax()[0]
    return (jnp.asarray(case["q"]), jnp.asarray(case["k"]),
            jnp.asarray(case["v"]), jnp.asarray(case["tables"]),
            jnp.asarray(case["start"]))


def _jax_scales(case):
    jnp = _jax()[0]
    if case["ks"] is None:
        return {}
    return {"k_scales": jnp.asarray(case["ks"]),
            "v_scales": jnp.asarray(case["vs"])}


CASES = ([(kind, rep, {}) for kind in ("decode", "prefill", "continued")
          for rep in (1, 2, 4)]
         + [("continued", 2, {"window": 8}),
            ("decode", 2, {"window": 20}),
            ("decode", 2, {"softcap": 5.0}),
            ("decode", 2, {"fp8": True}),
            ("continued", 4, {"fp8": True})])


@pytest.mark.parametrize("kind,rep,opts", CASES,
                         ids=[f"{k}-rep{r}-{'-'.join(o) or 'plain'}"
                              for k, r, o in CASES])
def test_plain_matches_jax_kernel_and_reference(kind, rep, opts):
    _, jax_paged_attention, jax_paged_attention_reference = _jax()
    opts = dict(opts)
    case = _make_case(kind, rep, seed=rep * 10 + len(kind),
                      fp8=opts.pop("fp8", False))
    ours = paged_attention_plain(*_torch_args(case), **opts,
                                 **_torch_scales(case)).numpy()
    kernel = np.asarray(jax_paged_attention(*_jax_args(case), **opts,
                                            **_jax_scales(case),
                                            interpret=True))
    ref = np.asarray(jax_paged_attention_reference(*_jax_args(case), **opts,
                                                   **_jax_scales(case)))
    assert ours.shape == case["q"].shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, kernel, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


def _split_combine(q, k_pages, v_pages, block_tables, start_pos, n_split,
                   tile_keys=8, window=None, softcap=None, k_scales=None,
                   v_scales=None):
    """The kernel's algebra in plain torch: the key span cut into tiles of
    ``tile_keys`` and the tiles into ``n_split`` contiguous ranges; each
    split keeps its own (m, l, acc) over its tiles by the online softmax (p
    rounded through the model dtype before P.V, l summing the unrounded p),
    a split with no live key for a row gives m = -inf, l = 0; then the
    splits are merged in order 0..n-1 and divided by max(l, 1e-30)."""
    b, t, h, d = q.shape
    hkv, _, bs, _ = k_pages.shape
    mb = block_tables.shape[1]
    tables = block_tables.long()
    gk, gv = k_pages[:, tables], v_pages[:, tables]
    if k_scales is not None:
        gk = gk.float() * k_scales[:, tables][..., None, None]
        gv = gv.float() * v_scales[:, tables][..., None, None]
    ctx_k = gk.permute(1, 2, 3, 0, 4).reshape(b, mb * bs, hkv, d)
    ctx_v = gv.permute(1, 2, 3, 0, 4).reshape(b, mb * bs, hkv, d)
    ctx_k = ctx_k.repeat_interleave(h // hkv, dim=2).to(q.dtype).float()
    ctx_v = ctx_v.repeat_interleave(h // hkv, dim=2).to(q.dtype)
    s = torch.einsum("bthd,bkhd->bhtk", q.float(), ctx_k) / np.sqrt(d)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = start_pos.long()[:, None] + torch.arange(t)[None, :]
    kpos = torch.arange(mb * bs)[None, None, :]
    mask = kpos <= qpos[..., None]
    if window is not None:
        mask = mask & (kpos > qpos[..., None] - window)
    mask = mask[:, None]                                  # [B, 1, T, keys]
    s = torch.where(mask, s, -torch.inf)
    n_tiles = -(-(mb * bs) // tile_keys)
    per = -(-n_tiles // n_split)
    parts = []
    for sp in range(n_split):
        m = torch.full((b, h, t, 1), -1e30)
        l = torch.zeros(b, h, t, 1)
        acc = torch.zeros(b, h, t, d)
        keys = range(sp * per * tile_keys,
                     min((sp + 1) * per * tile_keys, mb * bs))
        for k0 in range(keys.start, keys.stop, tile_keys):
            st = s[..., k0:k0 + tile_keys]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            p = torch.exp(st - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhtk,bkhd->bhtd", p.to(q.dtype).float(),
                ctx_v[:, k0:k0 + tile_keys].float())
            m = m_new
        live = mask[..., keys.start:keys.stop].any(-1, keepdim=True)
        parts.append((torch.where(live, m, -torch.inf), l, acc))
    m_all = torch.full((b, h, t, 1), -1e30)
    for m, _, _ in parts:
        m_all = torch.maximum(m_all, m)
    l_all = torch.zeros(b, h, t, 1)
    acc_all = torch.zeros(b, h, t, d)
    for m, l, acc in parts:
        w = torch.exp(m - m_all)
        l_all = l_all + w * l
        acc_all = acc_all + w * acc
    out = acc_all / l_all.clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("kind,rep,opts", CASES,
                         ids=[f"{k}-rep{r}-{'-'.join(o) or 'plain'}"
                              for k, r, o in CASES])
def test_split_combine_matches_jax_kernel_and_reference(kind, rep, opts):
    """The split-and-combine algebra at 1, 3 and 8 splits of 8-key tiles
    (the cases' tables span 32 or 64 keys) against the JAX kernel in
    interpret mode and the gather reference, at the plain version's
    float32 tolerance."""
    _, jax_paged_attention, jax_paged_attention_reference = _jax()
    opts = dict(opts)
    case = _make_case(kind, rep, seed=rep * 10 + len(kind) + 1,
                      fp8=opts.pop("fp8", False))
    kernel = np.asarray(jax_paged_attention(*_jax_args(case), **opts,
                                            **_jax_scales(case),
                                            interpret=True))
    ref = np.asarray(jax_paged_attention_reference(*_jax_args(case), **opts,
                                                   **_jax_scales(case)))
    for n_split in (1, 3, 8):
        ours = _split_combine(*_torch_args(case), n_split, **opts,
                              **_torch_scales(case)).numpy()
        assert ours.shape == case["q"].shape and np.isfinite(ours).all()
        np.testing.assert_allclose(ours, kernel, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


def test_split_combine_empty_splits_add_nothing():
    """A sequence whose context ends in the first split leaves the later
    splits with no live key (m = -inf): the merge equals one split."""
    case = _make_case("decode", 2, seed=5)
    case["start"] = np.array([0, 3, 9], dtype=np.int32)
    args = _torch_args(case)
    one = _split_combine(*args, 1)
    torch.testing.assert_close(_split_combine(*args, 8), one, atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(one, paged_attention_plain(*args), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("batch,kv_heads,t,rep,max_blocks,block_size,sms", [
    (16, 8, 1, 4, 32, 64, 132),      # decode at context 2048
    (8, 8, 1, 4, 9, 64, 132),        # the serving batch's decode
    (1, 8, 1, 4, 1, 64, 132),        # one tile: nothing to split
    (4, 8, 1, 8, 47, 16, 132),       # rep 8, block size 16, a ragged span
    (1, 8, 512, 4, 8, 64, 132),      # a prefill chunk fills the card
    (1, 2, 37, 1, 20, 64, 132),      # fold 37, two row tiles
    (64, 8, 1, 4, 64, 64, 132),      # 512 blocks: one split
    (2, 1, 1, 4, 200, 64, 16),       # a small card, a long context
    (3, 2, 1, 2, 5, 32, 114),        # fold 2 padded to 4 rows
])
def test_split_plan_covers_every_tile_once(batch, kv_heads, t, rep,
                                           max_blocks, block_size, sms):
    """Every key tile of the table's span falls in exactly one split, no
    split is empty by span, and a grid that already fills the card keeps
    one split."""
    fold = t * rep
    span = max_blocks * block_size
    n_split, per = split_plan(batch, kv_heads, fold, span, sms, 2)
    n_tiles = -(-span // KEYS_PER_TILE)
    owner = [tile // per for tile in range(n_tiles)]
    assert sorted(set(owner)) == list(range(n_split))
    assert n_split * per >= n_tiles and (n_split - 1) * per < n_tiles
    blocks = batch * kv_heads * -(-fold // rows_per_block(fold))
    if blocks >= sms:
        assert n_split == 1
    else:
        assert n_split >= min(2, n_tiles)
        assert blocks * n_split <= 2 * sms
    assert rows_per_block(fold) >= min(fold, 32)


@pytest.mark.parametrize("blocks_per_sm,batch,max_blocks,want", [
    (1, 16, 32, 1),      # fp32 pages, one block an SM: 128 blocks are a wave
    (2, 16, 32, 2),      # bf16 decode at context 2048
    (4, 16, 32, 4),      # fp8 pages, four blocks an SM
    (4, 16, 23, 4),      # fp8 over 23 tiles: splits of 6, the last of 5
    (2, 8, 9, 3),        # the serving batch: four wanted, three of 3 tiles
    (8, 1, 3, 3),        # more splits wanted than tiles: one tile a split
])
def test_split_plan_fills_one_wave_of_resident_blocks(blocks_per_sm, batch,
                                                      max_blocks, want):
    """The split grid stays within one wave of the instantiation's
    resident blocks (``blocks_per_sm`` an SM, 132 SMs, 8 KV heads, decode
    at rep 4), and takes as many splits as that wave holds."""
    n_split, per = split_plan(batch, 8, 4, max_blocks * 64, 132,
                              blocks_per_sm)
    n_tiles = max_blocks
    assert n_split == want
    assert n_split * per >= n_tiles and (n_split - 1) * per < n_tiles
    assert batch * 8 * n_split <= blocks_per_sm * 132


def test_workspace_is_kept_per_stream_and_grown():
    """The splits' workspace is one tensor per (device, stream): a call
    that needs no more reuses it, a larger one replaces it, and another
    stream gets its own."""
    from deepspeed_tpu_torch.ops import paged_attention as pa
    dev = torch.device("cpu")
    saved = dict(pa._workspaces)
    try:
        pa._workspaces.clear()
        first = pa._workspace(dev, 7, 100)
        assert pa._workspace(dev, 7, 60) is first
        grown = pa._workspace(dev, 7, 300)
        assert grown is not first and grown.numel() == 300
        assert grown.dtype == torch.float32
        assert pa._workspace(dev, 8, 60) is not grown
        assert pa._workspace(dev, 7, 300) is grown
    finally:
        pa._workspaces.clear()
        pa._workspaces.update(saved)


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    """On CPU tensors the wrapper and ``auto``/``gather`` run the plain
    version (no launch is counted); ``kernel`` refuses CPU tensors."""
    case = _make_case("decode", 2, seed=3)
    q, k, v, tables, start = _torch_args(case)
    want = paged_attention_plain(q, k, v, tables, start)
    build.reset_launch_counts()
    assert torch.equal(paged_attention(q, k, v, tables, start), want)
    pool = torch.stack([k, v])[None]                 # [L=1, 2, Hkv, NB, bs, d]
    for impl in ("auto", "gather"):
        got = _paged_attn(q, pool, 0, tables, start, None, impl)
        assert torch.equal(got, want)
    assert build.launch_counts() == {}
    with pytest.raises(ValueError, match="CUDA"):
        _paged_attn(q, pool, 0, tables, start, None, "kernel")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        _paged_attn(q, pool, 0, tables, start, None, "kernel_interpret")


def _card_case(gen, b, t, rep, ctx, dtype, fp8=False, window=None,
               softcap=None, ragged=False, d=128, bs=64, table_keys=None,
               starts=None, device="cuda"):
    """Seeded inputs on the card. ``ragged`` draws each sequence's start in
    [0, ctx - t], ``starts`` gives them; ``table_keys`` < ctx truncates the
    block table as the engine's context-bucket ladder does."""
    hkv = 8
    mb = -(-(table_keys or ctx) // bs)
    nb = b * mb + 1
    q = torch.randn(b, t, hkv * rep, d, generator=gen, device=device).to(dtype)
    k = torch.randn(hkv, nb, bs, d, generator=gen, device=device)
    v = torch.randn(hkv, nb, bs, d, generator=gen, device=device)
    kw = {"window": window, "softcap": softcap}
    if fp8:
        ks = torch.rand(hkv, nb, generator=gen, device=device) + 0.5
        vs = torch.rand(hkv, nb, generator=gen, device=device) + 0.5
        k = (k / ks[..., None, None]).to(torch.float8_e4m3fn)
        v = (v / vs[..., None, None]).to(torch.float8_e4m3fn)
        kw.update(k_scales=ks, v_scales=vs)
    else:
        k, v = k.to(dtype), v.to(dtype)
    perm = torch.randperm(nb - 1, generator=gen, device=device)
    tables = perm[:b * mb].reshape(b, mb).to(torch.int32)
    start = torch.full((b,), ctx - t, dtype=torch.int32, device=device)
    if ragged:
        start = torch.randint(0, ctx - t + 1, (b,), generator=gen,
                              device=device).to(torch.int32)
    if starts is not None:
        start = torch.tensor(starts, dtype=torch.int32, device=device)
    return (q, k, v, tables, start), kw


def _bf16_row_tol(want, ulps=4):
    """``ulps`` bf16 ulps at the largest |value| of each row (one query row
    of one head) of the plain output."""
    top = want.float().abs().amax(-1, keepdim=True)
    return ulps * torch.exp2(torch.floor(torch.log2(top.clamp_min(1e-30))) - 7)


def test_kernel_takes_every_serving_presets_head_dim():
    """The wrapper's head dims are the CUDA source's instantiations, and
    every Llama preset of the port, the tiny serving model (head_dim 32)
    included, has one: the tiny server, the CLI's default preset and the
    fleet's workers run on the card through this kernel."""
    import pathlib
    import re

    from deepspeed_tpu_torch.models import llama
    from deepspeed_tpu_torch.ops import paged_attention as pa
    src = (pathlib.Path(pa.__file__).resolve().parents[1] / "csrc"
           / "paged_attention.cu").read_text()
    dims = {int(d) for d in
            re.findall(r"head_dim == (\d+)\) return pick_rows", src)}
    assert dims == set(pa._HEAD_DIMS)
    assert dims == {int(d) for d in
                    re.findall(r"head_dim == (\d+)\) return smem_bytes", src)}
    for name in ("TINY_LLAMA", "LLAMA2_7B", "LLAMA3_8B"):
        assert getattr(llama, name).head_dim_ in dims, name


@pytest.mark.gpu
def test_kernel_matches_plain():
    """The CUDA kernel against the plain version on the card, at the
    serving shapes (d=128, bs=64, rep=4) and the edge cases (ragged starts,
    bs=16 with d=64, a truncated table, window, softcap, fp8, and for the
    split over pages: the serving batch's decode, sequences whose later
    splits are dead, a window that kills the early splits, fp8 over a span
    that is not a multiple of the split length; head_dim 32, the tiny
    serving model's): bf16 within 4 bf16 ulps of
    each row's largest |plain| value (both round P and the output to bf16;
    the sums run in other orders), fp32 within 1e-4; a second call repeats
    the output bit for bit. softcap=5 bites on unit-variance scores (50
    would leave them nearly unchanged)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(dict(b=16, t=1, rep=4, ctx=2048, dtype=bf16), None),
             (dict(b=1, t=512, rep=4, ctx=512, dtype=bf16), None),
             (dict(b=1, t=256, rep=4, ctx=512, dtype=bf16), None),
             (dict(b=4, t=1, rep=4, ctx=2048, dtype=bf16, window=1024), None),
             (dict(b=4, t=1, rep=4, ctx=2048, dtype=bf16, softcap=5.0), None),
             (dict(b=4, t=1, rep=4, ctx=2048, dtype=bf16, fp8=True), None),
             (dict(b=3, t=37, rep=1, ctx=200, dtype=f32), 1e-4),
             (dict(b=2, t=1, rep=8, ctx=100, dtype=f32, fp8=True), 1e-4),
             (dict(b=32, t=1, rep=4, ctx=3000, dtype=bf16, ragged=True), None),
             (dict(b=1, t=300, rep=2, ctx=700, dtype=f32, d=64, bs=16,
                   window=128, softcap=30.0), 1e-4),
             (dict(b=4, t=1, rep=4, ctx=600, dtype=f32, table_keys=256), 1e-4),
             (dict(b=8, t=1, rep=4, ctx=576, dtype=bf16, ragged=True), None),
             (dict(b=16, t=1, rep=4, ctx=2048, dtype=bf16,
                   starts=[0, 1, 62, 63, 64, 100, 447, 448, 449, 895, 1022,
                           1023, 1024, 1025, 2046, 2047]), None),
             (dict(b=16, t=1, rep=4, ctx=2048, dtype=bf16, window=300), None),
             (dict(b=16, t=1, rep=4, ctx=1450, dtype=bf16, fp8=True), None),
             # head_dim 32: the tiny serving model's (fp32, 16-token
             # blocks), and bf16 / fp8 pages at that width
             (dict(b=1, t=64, rep=2, ctx=64, dtype=f32, d=32, bs=16), 1e-4),
             (dict(b=8, t=1, rep=2, ctx=96, dtype=f32, d=32, bs=16,
                   ragged=True), 1e-4),
             (dict(b=8, t=1, rep=4, ctx=1000, dtype=bf16, d=32, bs=16,
                   fp8=True), None)]
    for spec, tol in cases:
        args, kw = _card_case(gen, **spec)
        before = build.launch_counts().get("paged_attention", 0)
        got = paged_attention(*args, **kw)
        torch.cuda.synchronize()
        assert build.launch_counts()["paged_attention"] == before + 1
        assert torch.equal(paged_attention(*args, **kw), got), spec
        want = paged_attention_plain(*args, **kw)
        diff = (got.float() - want.float()).abs()
        tol = _bf16_row_tol(want) if tol is None else tol
        assert bool((diff <= tol).all()), (spec, diff.max().item())
    # what the kernel does not take raises instead of falling back
    (q, k, v, tables, start), _ = _card_case(gen, 2, 1, 4, 128, bf16)
    with pytest.raises(ValueError):
        paged_attention(q[..., :96].contiguous(), k[..., :96].contiguous(),
                        v[..., :96].contiguous(), tables, start)
    with pytest.raises(ValueError):
        paged_attention(torch.cat([q, q], -1)[..., :128], k, v, tables,
                        start)                       # not contiguous
    with pytest.raises(ValueError):
        paged_attention(q, k, v, tables.long(), start)
