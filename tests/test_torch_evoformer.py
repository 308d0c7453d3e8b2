"""Port parity: the PyTorch evoformer attention against the JAX package.

The port's CPU path (``fused_evoformer_attention`` ->
``EvoformerAttentionFunction`` -> the plain versions of the five kernels) is
held against ``pallas_evoformer_attention(..., block_q=16, block_k=16,
interpret=True)`` on the same inputs made from a numpy seed: the forward for
each bias combination, the full gradient set (q, k, v, bias1, bias2), a
broadcast bias whose gradient sums back, one and more than two lead dims,
Lq != Lk, an OpenFold ``-1e9`` mask with a fully masked row, and L=20, which
pads keys to the 16-key blocks. The plain versions are held against the
JAX ``_evo_fwd_impl``/``_evo_bwd_impl`` outputs (lse, dq, dk, dv, db1,
db2); the blockwise path, the oracle and ``DS4Sci_EvoformerAttention`` (its
typed layout error, its route to the blockwise path, the row-varying
rejection, the >2-bias ``ValueError``) against theirs.

Tolerances: float32 forward to 2e-5 and gradients to 3e-5 (atol and rtol,
as ``tests/test_evoformer_pallas.py`` holds the JAX kernels to their oracle;
the two sides sum in other orders); bfloat16 each row (last axis) within 4
bf16 ulps of its largest |JAX| value.

The CUDA kernels run only on the card: ``test_kernels_match_plain_on_card``
is marked ``gpu`` and skips where there is none. On the card:
``python -m pytest --noconftest -m gpu tests/test_torch_evoformer.py``.
"""

import math

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops import evoformer as te
from deepspeed_tpu_torch.ops.evoformer import (
    EvoformerAttentionFunction, UnsupportedBiasLayout, canonicalize, evo_bwd,
    evo_bwd_plain, evo_fwd, evo_fwd_plain, fused_evoformer_attention)
from deepspeed_tpu_torch.ops.evoformer_attn import (
    DS4Sci_EvoformerAttention, evoformer_attention,
    evoformer_attention_reference)

B, N, L, H, D = 2, 3, 20, 2, 16     # L=20 against 16-key blocks pads keys
FWD_TOL, BWD_TOL = 2e-5, 3e-5
BF16_ULPS = 4
BLK = dict(block_q=16, block_k=16, interpret=True)
NAMES = ("q", "k", "v", "bias1", "bias2")


def _jax():
    """The JAX side, imported where it is used (the card's machine lacks
    flax, and the card-only test below must still be collected there)."""
    pytest.importorskip("flax")
    jax = pytest.importorskip("jax")
    from deepspeed_tpu.ops import evoformer_attn as jea
    from deepspeed_tpu.ops.pallas import evoformer as jpe
    return jax, jea, jpe


def _arrays(seed=0, lead=(B, N), lq=L, lk=L, h=H, d=D, mask=False):
    """Seeded numpy (q, k, v, bias1 [*lead, 1, 1, Lk], bias2 [lead[0], 1,
    H, Lq, Lk], w [*lead, Lq, H, D]); ``mask`` makes bias1 OpenFold's
    ``1e9 * (mask - 1)`` with some keys masked and row 0 fully masked."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    q, k, v = f(*lead, lq, h, d), f(*lead, lk, h, d), f(*lead, lk, h, d)
    b1 = f(*lead, 1, 1, lk)
    if mask:
        keep = (rng.random(size=b1.shape) > 0.2).astype(np.float32)
        keep.reshape(-1, lk)[0] = 0.0
        b1 = (1e9 * (keep - 1.0)).astype(np.float32)
    b2 = f(lead[0], 1, h, lq, lk)
    return q, k, v, b1, b2, f(*lead, lq, h, d)


def _t(x, dtype=torch.float32, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype) \
        .requires_grad_(grad)


def _jax_grads(arrays, biases_on, dtype=None, argnums=(0, 1, 2, 3, 4)):
    """(out, grads) of the Pallas op in interpret mode through the loss
    sum(out * w); bias slots that are off are passed as None."""
    jax, _, jpe = _jax()
    import jax.numpy as jnp
    q, k, v, b1, b2, w = (jnp.asarray(a) for a in arrays)
    if dtype is not None:
        q, k, v, w = (x.astype(dtype) for x in (q, k, v, w))
    b1 = b1 if biases_on[0] else None
    b2 = b2 if biases_on[1] else None

    def loss(q, k, v, b1, b2):
        out = jpe.pallas_evoformer_attention(q, k, v, (b1, b2), **BLK)
        return jnp.sum(out.astype(jnp.float32) * w.astype(jnp.float32)), out

    argnums = tuple(a for a in argnums if a < 3 or (b1, b2)[a - 3] is not None)
    (_, out), grads = jax.value_and_grad(loss, argnums=argnums,
                                         has_aux=True)(q, k, v, b1, b2)
    f32 = lambda x: np.asarray(x.astype(jnp.float32))      # noqa: E731
    return f32(out), dict(zip(argnums, (f32(g) for g in grads)))


def _port_grads(arrays, biases_on, dtype=torch.float32, argnums=(0, 1, 2, 3, 4)):
    q, k, v, b1, b2, w = arrays
    ts = [_t(x, dtype, i in argnums) for i, x in enumerate((q, k, v))]
    bs = [_t(b, grad=(3 + i) in argnums) if on else None
          for i, (b, on) in enumerate(zip((b1, b2), biases_on))]
    out = fused_evoformer_attention(*ts, bs)
    if argnums:
        (out.float() * _t(w, dtype).float()).sum().backward()
    grads = {i: x.grad.float().numpy() for i, x in enumerate(ts + bs)
             if x is not None and x.grad is not None}
    return out.detach().float().numpy(), grads


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def _bf16_rows_close(got, want, what):
    """Each row (last axis) within BF16_ULPS bf16 ulps of its largest |want|."""
    top = np.abs(want).max(-1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    tol = np.where(top > 0, BF16_ULPS * ulp, 0.0)
    err = np.abs(got - want)
    assert (err <= tol).all(), (what, float((err - tol).max()))


@pytest.mark.parametrize("use_b1,use_b2", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_fwd_matches_jax(use_b1, use_b2):
    arrays = _arrays()
    out_j, _ = _jax_grads(arrays, (use_b1, use_b2), argnums=(0,))
    out, _ = _port_grads(arrays, (use_b1, use_b2), argnums=())
    _close(out, out_j, FWD_TOL, "out")


def test_grads_match_jax():
    arrays = _arrays(seed=1)
    out_j, grads_j = _jax_grads(arrays, (True, True))
    out, grads = _port_grads(arrays, (True, True))
    _close(out, out_j, FWD_TOL, "out")
    assert sorted(grads) == sorted(grads_j) == [0, 1, 2, 3, 4]
    for i in grads:
        assert grads[i].shape == grads_j[i].shape
        _close(grads[i], grads_j[i], BWD_TOL, NAMES[i])


def test_broadcast_bias_grad_sums():
    """A [1, 1, H, L, L] bias broadcast over B=2 takes its gradient summed
    back to its own shape, as JAX's autodiff of ``_bcast`` does."""
    jax, _, jpe = _jax()
    import jax.numpy as jnp
    q, k, v, _, _, _ = _arrays(seed=2)
    shared = np.random.default_rng(3).normal(size=(1, 1, H, L, L)).astype(
        np.float32)
    g_j = jax.grad(lambda b: jnp.sum(jpe.pallas_evoformer_attention(
        *(jnp.asarray(x) for x in (q, k, v)), (b,), **BLK) ** 2))(
            jnp.asarray(shared))
    b = _t(shared, grad=True)
    (fused_evoformer_attention(_t(q), _t(k), _t(v), [b]) ** 2).sum().backward()
    assert b.grad.shape == shared.shape
    _close(b.grad.numpy(), np.asarray(g_j), BWD_TOL, "bias2")


@pytest.mark.parametrize("lead", [(B,), (2, 2, 3)], ids=["one", "three"])
def test_lead_dims(lead):
    """One lead dim (N = 1) and three (the first two fold into B), with a
    1-d per-key bias; forward and q's gradient."""
    _, _, jpe = _jax()
    import jax
    import jax.numpy as jnp
    q, k, v, _, _, w = _arrays(seed=4, lead=lead)
    b1 = np.random.default_rng(5).normal(size=(L,)).astype(np.float32)

    def loss(q):
        out = jpe.pallas_evoformer_attention(
            q, jnp.asarray(k), jnp.asarray(v), (jnp.asarray(b1),), **BLK)
        return jnp.sum(out * jnp.asarray(w)), out
    (_, out_j), gq_j = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(q))
    qt = _t(q, grad=True)
    out = fused_evoformer_attention(qt, _t(k), _t(v), [_t(b1)])
    assert out.shape == (*lead, L, H, D)
    (out * _t(w)).sum().backward()
    _close(out.detach().numpy(), np.asarray(out_j), FWD_TOL, "out")
    _close(qt.grad.numpy(), np.asarray(gq_j), BWD_TOL, "q")


def test_lq_ne_lk():
    arrays = _arrays(seed=6, lq=12, lk=28)
    out_j, grads_j = _jax_grads(arrays, (True, True))
    out, grads = _port_grads(arrays, (True, True))
    assert out.shape == (B, N, 12, H, D)
    _close(out, out_j, FWD_TOL, "out")
    for i in grads_j:
        _close(grads[i], grads_j[i], BWD_TOL, NAMES[i])


def test_openfold_mask_with_fully_masked_row():
    """OpenFold's ``1e9 * (mask - 1)`` bias (row 0 fully masked: uniform
    attention, as the reference gives) with a pair bias; the mask takes no
    gradient, as in OpenFold."""
    arrays = _arrays(seed=7, mask=True)
    out_j, grads_j = _jax_grads(arrays, (True, True), argnums=(0, 1, 2, 4))
    out, grads = _port_grads(arrays, (True, True), argnums=(0, 1, 2, 4))
    assert sorted(grads) == [0, 1, 2, 4]
    _close(out, out_j, FWD_TOL, "out")
    v = arrays[2]
    np.testing.assert_allclose(out[0, 0], v[0, 0].mean(0, keepdims=True)
                               .repeat(L, 0), atol=1e-5)
    for i in grads_j:
        _close(grads[i], grads_j[i], BWD_TOL, NAMES[i])


def test_bf16_matches_jax():
    import jax.numpy as jnp
    _jax()
    arrays = list(_arrays(seed=8))
    arrays[:3] = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32)) for a in arrays[:3]]
    out_j, grads_j = _jax_grads(arrays, (True, True), dtype=jnp.bfloat16)
    out, grads = _port_grads(arrays, (True, True), dtype=torch.bfloat16)
    _bf16_rows_close(out, out_j, "out")
    for i in grads_j:
        _bf16_rows_close(grads[i], grads_j[i], NAMES[i])


@pytest.mark.parametrize("case", ["both_l20", "bias1_lq_ne_lk", "bias2_only",
                                  "none"])
def test_plain_versions_match_jax_impls(case, monkeypatch):
    """``evo_fwd_plain``/``evo_bwd_plain`` against ``_evo_fwd_impl``/
    ``_evo_bwd_impl`` (interpret mode) on canonical inputs: out, lse, dq,
    dk, dv, db1, db2; the backward on the JAX forward's own (out, lse). The
    plain versions in one-row chunks give the same values."""
    _, _, jpe = _jax()
    import jax.numpy as jnp
    lq, lk, on = {"both_l20": (L, L, (1, 1)), "bias1_lq_ne_lk": (12, 28, (1, 0)),
                  "bias2_only": (L, L, (0, 1)), "none": (L, L, (0, 0))}[case]
    q, k, v, b1, b2, do = _arrays(seed=9, lq=lq, lk=lk)
    b1 = b1.reshape(B, N, lk) if on[0] else None
    b2 = b2.reshape(B, H, lq, lk) if on[1] else None
    jx = lambda x: None if x is None else jnp.asarray(x)    # noqa: E731
    # lse in the JAX kernels' own padded [B*N*H, Lq_padded, 1] layout
    out_j, (lse_raw, lq_p, _) = jpe._evo_fwd_impl(
        jx(q), jx(k), jx(v), jx(b1), jx(b2), 16, 16, True)
    lse_j = np.asarray(lse_raw).reshape(B, N, H, lq_p)[..., :lq]
    grads_j = jpe._evo_bwd_impl(jx(q), jx(k), jx(v), jx(b1), jx(b2), out_j,
                                lse_raw, jx(do), 16, 16, True)
    tq, tk, tv, tdo = (_t(x) for x in (q, k, v, do))
    tb1 = None if b1 is None else _t(b1)
    tb2 = None if b2 is None else _t(b2)
    out, lse = evo_fwd_plain(tq, tk, tv, tb1, tb2)
    _close(out.numpy(), np.asarray(out_j), FWD_TOL, "out")
    _close(lse.numpy(), lse_j, FWD_TOL, "lse")
    res = (_t(np.asarray(out_j)), torch.from_numpy(np.array(lse_j)))
    grads = evo_bwd_plain(tq, tk, tv, tb1, tb2, *res, tdo)
    for name, got, want in zip(("dq", "dk", "dv", "db1", "db2"), grads,
                               grads_j):
        assert (got is None) == (want is None), name
        if got is not None:
            _close(got.numpy(), np.asarray(want), BWD_TOL, name)
    monkeypatch.setattr(te, "PLAIN_CHUNK_ELEMS", 1)     # one-row chunks
    chunked = evo_bwd_plain(tq, tk, tv, tb1, tb2, *res, tdo)
    for got, want in zip(chunked, grads):
        if got is not None:
            _close(got.numpy(), want.numpy(), 1e-6, "chunked")
    out1, lse1 = evo_fwd_plain(tq, tk, tv, tb1, tb2)
    _close(out1.numpy(), out.numpy(), 1e-6, "chunked out")
    _close(lse1.numpy(), lse.numpy(), 1e-6, "chunked lse")


def test_blockwise_matches_jax():
    """``evoformer_attention`` (key tiles of 8 over L=20: padding and three
    tiles) and its autograd against JAX's blockwise scan and autodiff."""
    jax, jea, _ = _jax()
    import jax.numpy as jnp
    q, k, v, b1, b2, w = _arrays(seed=10)

    def loss(q, k, v, b1, b2):
        out = jea.evoformer_attention(q, k, v, (b1, b2), block_k=8)
        return jnp.sum(out * jnp.asarray(w)), out
    (_, out_j), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                             has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v, b1, b2)))
    ts = [_t(x, grad=True) for x in (q, k, v, b1, b2)]
    out = evoformer_attention(*ts[:3], ts[3:], block_k=8)
    (out * _t(w)).sum().backward()
    _close(out.detach().numpy(), np.asarray(out_j), FWD_TOL, "out")
    for name, t, g in zip(NAMES, ts, grads_j):
        _close(t.grad.numpy(), np.asarray(g), BWD_TOL, name)


def test_reference_matches_jax():
    _, jea, _ = _jax()
    import jax.numpy as jnp
    q, k, v, b1, b2, _ = _arrays(seed=11)
    want = jea.evoformer_attention_reference(
        *(jnp.asarray(x) for x in (q, k, v)), (jnp.asarray(b1), jnp.asarray(b2)))
    got = evoformer_attention_reference(_t(q), _t(k), _t(v), (_t(b1), _t(b2)))
    _close(got.numpy(), np.asarray(want), FWD_TOL, "reference")


def test_ds4sci_matches_jax_on_cpu():
    """The port's entry (the plain versions through the autograd function)
    against JAX's on the CPU (its blockwise scan), for each supported
    combination and with a None entry dropped."""
    _, jea, _ = _jax()
    import jax.numpy as jnp
    q, k, v, b1, b2, _ = _arrays(seed=12)
    for biases in ([], [b1], [b2], [b1, b2], [None, b2]):
        want = jea.DS4Sci_EvoformerAttention(
            *(jnp.asarray(x) for x in (q, k, v)),
            [None if b is None else jnp.asarray(b) for b in biases])
        got = DS4Sci_EvoformerAttention(
            _t(q), _t(k), _t(v), [None if b is None else _t(b) for b in biases])
        _close(got.numpy(), np.asarray(want), FWD_TOL, str(len(biases)))


def test_ds4sci_dispatch_contract(monkeypatch):
    """More than 2 biases raise ValueError; a layout outside the kernels'
    contract raises the typed error from the fused op and routes to the
    blockwise path (matching JAX's); a row-varying pair bias is rejected
    by the fused op; any other error of the fused op propagates."""
    _, jea, jpe = _jax()
    import jax.numpy as jnp
    import deepspeed_tpu_torch.ops.evoformer_attn as ea
    q, k, v, _, _, _ = _arrays(seed=13)
    tq, tk, tv = _t(q), _t(k), _t(v)
    zeros = torch.zeros(L)
    with pytest.raises(ValueError, match="at most 2"):
        DS4Sci_EvoformerAttention(tq, tk, tv, [zeros, zeros, zeros])
    with pytest.raises(UnsupportedBiasLayout):      # wrong key length
        fused_evoformer_attention(tq, tk, tv, [torch.zeros(L + 3)])
    with pytest.raises(jpe.UnsupportedBiasLayout):
        jpe.pallas_evoformer_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                       (jnp.zeros((L + 3,)),), **BLK)
    row_varying = np.random.default_rng(14).normal(
        size=(B, N, H, L, L)).astype(np.float32)
    with pytest.raises(UnsupportedBiasLayout, match="row"):
        fused_evoformer_attention(tq, tk, tv, [_t(row_varying)])
    calls = []
    monkeypatch.setattr(ea, "evoformer_attention",
                        lambda *a, **kw: calls.append(1) or
                        evoformer_attention(*a, **kw))
    got = DS4Sci_EvoformerAttention(tq, tk, tv, [_t(row_varying)])
    assert calls == [1]                              # the blockwise route
    want = jea.DS4Sci_EvoformerAttention(*(jnp.asarray(x) for x in (q, k, v)),
                                         [jnp.asarray(row_varying)])
    _close(got.numpy(), np.asarray(want), FWD_TOL, "blockwise route")
    calls.clear()
    DS4Sci_EvoformerAttention(tq, tk, tv, [zeros])
    assert calls == []                               # the fused route

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")
    monkeypatch.setattr(ea, "fused_evoformer_attention", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        DS4Sci_EvoformerAttention(tq, tk, tv, [zeros])
    assert calls == []


def test_canonicalize_rules():
    """The reference's ``_canon`` classification on the port's side."""
    q = torch.zeros(2, 3, 4, 5, H, 8)                  # lead (2, 3, 4)
    k = torch.zeros(2, 3, 4, 7, H, 8)
    q5, k5, _, b1, b2 = canonicalize(q, k, k, [torch.tensor(1.0)])
    assert q5.shape == (6, 4, 5, H, 8) and k5.shape == (6, 4, 7, H, 8)
    assert b1.shape == (6, 4, 7) and b2 is None and b1.dtype == torch.float32
    _, _, _, b1, b2 = canonicalize(q, k, k, [torch.zeros(H, 5, 7)])
    assert b1 is None and b2.shape == (6, H, 5, 7)
    _, _, _, b1, b2 = canonicalize(q, k, k, [torch.zeros(7), torch.zeros(1, 5, 7)])
    assert b1.shape == (6, 4, 7) and b2.shape == (6, H, 5, 7)
    for bad in ([torch.zeros(3, 5, 7)],                # head dim 3 != H
                [torch.zeros(7), torch.zeros(1, 1, 7)],  # two mask-like
                [torch.zeros(H, 5, 7), torch.zeros(H, 5, 7)],
                [torch.zeros(5, 1, 1, 1, 1, 1, 7)]):   # more dims than B,N
        with pytest.raises(UnsupportedBiasLayout):
            canonicalize(q, k, k, bad)
    with pytest.raises(UnsupportedBiasLayout):
        canonicalize(torch.zeros(5, H, 8), k, k, [])


def test_bias_grad_kernels_run_only_when_asked(monkeypatch):
    """The backward asks for a bias gradient only where autograd needs it
    (``ctx.needs_input_grad``), as the kernels' launches follow."""
    seen = []
    real = te.evo_bwd_plain
    monkeypatch.setattr(te, "evo_bwd_plain", lambda *a, **kw: seen.append(
        a[8:10]) or real(*a, **kw))
    q, k, v, b1, b2, w = _arrays(seed=15)
    for g1, g2 in ((False, True), (True, False), (True, True)):
        tb1, tb2 = _t(b1, grad=g1), _t(b2, grad=g2)
        out = fused_evoformer_attention(_t(q, grad=True), _t(k), _t(v),
                                        [tb1, tb2])
        (out * _t(w)).sum().backward()
        assert seen[-1] == (g1, g2)
        assert (tb1.grad is not None) == g1 and (tb2.grad is not None) == g2


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    q, k, v, b1, b2, do = (_t(x) for x in _arrays(seed=16))
    q5, k5, v5, c1, c2 = canonicalize(q, k, v, [b1, b2])
    c1, c2 = c1.contiguous(), c2.contiguous()
    build.reset_launch_counts()
    out, lse = evo_fwd(q5, k5, v5, c1, c2)
    want_out, want_lse = evo_fwd_plain(q5, k5, v5, c1, c2)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    got = evo_bwd(q5, k5, v5, c1, c2, out, lse, do)
    for g, w in zip(got, evo_bwd_plain(q5, k5, v5, c1, c2, out, lse, do)):
        assert torch.equal(g, w)
    assert build.launch_counts() == {}
    assert EvoformerAttentionFunction.apply(q5, k5, v5, c1, c2).shape == q5.shape
    with pytest.raises(ValueError, match="unsupported device"):
        evo_fwd(q5.to("meta"), k5.to("meta"), v5.to("meta"))


# OpenFold's E1-E4 calls (B, N, L, H, D, pair bias), as chip_smoke.py drives
# them: MSA row with pair bias, MSA column, triangle, extra-MSA row
PATH_SHAPES = {"E1": (1, 512, 384, 8, 32, True), "E2": (1, 384, 512, 8, 32, False),
               "E3": (1, 384, 384, 4, 32, True), "E4": (1, 5120, 384, 8, 8, True)}
SMEM_LIMIT = 232448        # shared memory a block may use on the H100 (227 KB)


@pytest.mark.parametrize("d", te.HEAD_DIMS)
def test_fwd_plan_fits_and_shares_the_pair_panel(d):
    """The bf16 forward's tiling at every head dim: within the card's 227
    KB of shared memory; with a pair bias G = 2 rows share each bias tile
    (two blocks fit an SM at D <= 32) but at D = 128, whose accumulators fill the
    registers, one warp group of 128 threads a row, and
    without one G = 1 (nothing else is shared across rows). The smem sum is
    the plan's own arithmetic, the kernel's FwdMma; the card test holds it
    against the library's report."""
    pair, plain = te.evo_fwd_plan(d, True), te.evo_fwd_plan(d, False)
    for plan in (pair, plain):
        assert 0 < plan["smem_bytes"] <= SMEM_LIMIT
        assert plan["threads"] == 128 * plan["group"] <= 1024
        assert plan["rows"] == 64 and plan["stages"] >= 2
    assert pair["group"] == (2 if d < 128 else 1)
    if d <= 32:                          # two blocks an SM at OpenFold's widths
        assert 2 * pair["smem_bytes"] <= 228 * 1024
    assert plain["group"] == 1
    tile = 64 * (max(d, 16) + 8) * 2
    assert plain["smem_bytes"] == tile + 2 * (2 * tile + 64 * 4)
    for name, (b, n, l, h, dd, has_pair) in PATH_SHAPES.items():
        if dd == d:
            g = te.evo_fwd_plan(d, has_pair)["group"]
            # the pair panel's L2 reads: once per group of rows and query tile
            panel_reads = b * h * -(-n // g) * -(-l // 64) * 64 * l * 4
            if has_pair:
                assert panel_reads <= b * n * h * l * l * 4 // 2, name
    with pytest.raises(ValueError, match="head dim"):
        te.evo_fwd_plan(24, True)


@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("d", te.HEAD_DIMS)
def test_bwd_plan_fits_and_shares_the_pair_panel(d, pair):
    """The bf16 backward's tilings at every head dim, with and without a
    pair bias: dK/dV and dbias2 within the card's 227 KB of shared memory;
    with a pair bias dK/dV walks DKV_GROUP MSA rows a block (one warp group
    of 4 warps x 16 keys each) that share each [64, 68] fp32 pair-bias tile
    (1 at D = 128, whose accumulators fill the registers), so the panel is
    read from L2 at most half as often as by one row a block; without one
    G = 1 and no dbias2. The smem sums are the plan's own arithmetic, the
    kernels' DkvMma and Db2Mma; the card test holds them against the
    library's report."""
    plan = te.evo_bwd_plan(d, pair)
    dkv, db2 = plan["dkv"], plan["dbias2"]
    tile = 64 * (max(d, 16) + 8) * 2
    group = (te.DKV_GROUP if d < 128 else 1) if pair else 1
    assert dkv["group"] == group and dkv["threads"] == 128 * group <= 1024
    assert dkv["keys"] == 64 and dkv["stages"] == 2
    pair_tile = 64 * 68 * 4 if pair else 0
    assert dkv["smem_bytes"] == 2 * group * tile + 2 * (
        2 * group * tile + pair_tile + 2 * group * 64 * 4)
    assert 0 < dkv["smem_bytes"] <= SMEM_LIMIT
    if pair:
        assert te.DKV_GROUP >= 2
        assert db2["threads"] == 128 and db2["rows"] == db2["keys"] == 64
        assert db2["stages"] == (3 if d <= 32 else 2)
        assert db2["smem_bytes"] == db2["stages"] * (4 * tile + 3 * 64 * 4)
        assert 0 < db2["smem_bytes"] <= SMEM_LIMIT
        if d <= 32:                      # two dbias2 blocks an SM or more
            assert 2 * db2["smem_bytes"] <= 228 * 1024
    else:
        assert db2 is None
    for name, (b, n, l, h, dd, has_pair) in PATH_SHAPES.items():
        if dd == d and has_pair == pair and pair:
            g = te.evo_bwd_plan(d, True)["dkv"]["group"]
            # the pair panel's L2 reads: once per group of rows and key tile
            panel_reads = b * h * -(-n // g) * l * l * 4
            assert panel_reads <= b * n * h * l * l * 4 // 2, name
    with pytest.raises(ValueError, match="head dim"):
        te.evo_bwd_plan(24, pair)


@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("d", te.HEAD_DIMS)
def test_bwd_dq_plan_fits_and_shares_the_pair_panel(d, pair):
    """The bf16 dQ tiling at every head dim, with and without a pair bias:
    within the card's 227 KB of shared memory, two blocks an SM at D <= 32;
    with a pair bias DQ_GROUP MSA rows a block (one warp group of 4 warps x
    16 queries each) share each [64, 72] fp32 pair-bias tile (1 at D = 128,
    whose accumulators fill the registers), so the panel is read from L2 at
    most half as often as by one row a block; without one G = 1. The smem
    sum is the plan's own arithmetic, the kernel's DqMma; the card test
    holds it against the library's report."""
    dq = te.evo_bwd_plan(d, pair)["dq"]
    tile = 64 * (max(d, 16) + 8) * 2
    group = (te.DQ_GROUP if d < 128 else 1) if pair else 1
    assert dq["group"] == group and dq["threads"] == 128 * group <= 1024
    assert dq["rows"] == 64 and dq["stages"] == 2
    pair_tile = 64 * 72 * 4 if pair else 0
    assert dq["smem_bytes"] == 2 * group * tile + 2 * (
        2 * group * tile + pair_tile + group * 64 * 4)
    assert 0 < dq["smem_bytes"] <= SMEM_LIMIT
    if d <= 32:                          # two dQ blocks an SM
        assert 2 * dq["smem_bytes"] <= 228 * 1024
    for name, (b, n, l, h, dd, has_pair) in PATH_SHAPES.items():
        if dd == d and has_pair == pair and pair:
            assert te.DQ_GROUP >= 2
            # the pair panel's L2 reads: once per group of rows and query tile
            panel_reads = b * h * -(-n // group) * l * l * 4
            assert panel_reads <= b * n * h * l * l * 4 // 2, name


@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("d", te.HEAD_DIMS)
def test_bwd_dbias1_plan_fits_and_shares_the_pair_panel(d, pair):
    """The bf16 dbias1 tiling at every head dim, with and without a pair
    bias: within the card's 227 KB of shared memory, three blocks an SM at
    D <= 32; DB1_GROUP MSA rows a block (one warp group of 4 warps x 16
    keys each; 1 at D = 128) whether or not there is a pair bias (the mask
    has no head axis, so a block of rows is one batch entry's either way),
    and with one the block's G rows share each [64, 68] fp32 pair-bias
    tile, so the panel is read from L2 once per group of rows and key tile
    (G = 1, measured faster than 2 on the card, reads it once per row);
    without one no pair tile is held. The smem sum is the plan's own
    arithmetic, the kernel's Db1Mma; the card test holds it against the
    library's report."""
    db1 = te.evo_bwd_plan(d, pair)["dbias1"]
    tile = 64 * (max(d, 16) + 8) * 2
    group = te.DB1_GROUP if d < 128 else 1
    assert db1["group"] == group and db1["threads"] == 128 * group <= 1024
    assert db1["keys"] == 64 and db1["stages"] == 2
    pair_tile = 64 * 68 * 4 if pair else 0
    assert db1["smem_bytes"] == 2 * group * tile + 2 * (
        2 * group * tile + pair_tile + 2 * group * 64 * 4)
    assert 0 < db1["smem_bytes"] <= SMEM_LIMIT
    if d <= 32:                          # three dbias1 blocks an SM
        assert 3 * db1["smem_bytes"] <= 228 * 1024
    if not pair:
        assert db1["smem_bytes"] < te.evo_bwd_plan(d, True)["dbias1"]["smem_bytes"]
    for name, (b, n, l, h, dd, has_pair) in PATH_SHAPES.items():
        if dd == d and has_pair == pair and pair:
            # the pair panel's L2 reads: once per group of rows and key tile
            panel_reads = b * h * -(-n // group) * l * l * 4
            assert panel_reads == b * n * h * l * l * 4 // group, name


# (B, H, N, Lq, Lk): OpenFold's E1, E3 and E4, the card-side split case,
# a grid of many waves, one MSA row
SPLIT_SHAPES = [(1, 8, 512, 384, 384), (1, 4, 384, 384, 384),
                (1, 8, 5120, 384, 384), (2, 2, 37, 130, 130),
                (4, 64, 64, 1024, 1024), (1, 1, 1, 64, 64), (2, 8, 150, 40, 72)]


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_dbias2_splits_cover_the_rows_once(shape, blocks_per_sm):
    """``dbias2_splits`` cuts rows 0..N-1 into consecutive non-empty splits,
    in order, with no gap or overlap, at most MAX_DB2_SPLITS of them; a grid
    that fills whole waves of resident blocks keeps one split; the answer is
    a pure function of the shapes and the card (the same on a fresh cache),
    and no split count beats it by more than the slack under its own
    model."""
    b, h, n, lq, lk = shape
    sms = 132
    splits, per = te.dbias2_splits(b, h, n, lq, lk, sms, blocks_per_sm)
    assert 1 <= splits <= min(n, te.MAX_DB2_SPLITS)
    rows = [list(range(s * per, min(n, (s + 1) * per))) for s in range(splits)]
    assert all(rows) and sum(rows, []) == list(range(n))
    te.dbias2_splits.cache_clear()
    assert te.dbias2_splits(b, h, n, lq, lk, sms, blocks_per_sm) == (splits, per)
    blocks = b * h * -(-lq // 64) * -(-lk // 64)
    wave = sms * blocks_per_sm

    def cost(s):
        p = -(-n // s)
        return -(-blocks * -(-n // p) // wave) * p
    assert cost(splits) <= (1 + te.DB2_SPLIT_SLACK) * min(
        cost(s) for s in range(1, min(n, te.MAX_DB2_SPLITS) + 1))
    if blocks % wave == 0 or n == 1:
        assert (splits, per) == (1, n)


def test_dbias2_splits_fill_the_card():
    """OpenFold's E1 (288 panel tiles on 132 SMs of 2 resident blocks, a
    second wave of 24) takes several splits, the smaller grid of the card
    case at least three; a grid of exactly one wave keeps one."""
    assert te.dbias2_splits(1, 8, 512, 384, 384, 132, 2)[0] >= 4
    assert te.dbias2_splits(2, 2, 37, 130, 130, 132, 2)[0] >= 3
    assert te.dbias2_splits(1, 33, 40, 128, 128, 132, 1) == (1, 40)
    assert te.dbias2_splits(1, 66, 40, 128, 128, 132, 2) == (1, 40)


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """The five CUDA kernels against their plain versions on the card, in
    the cases and at the tolerances of ``chip_smoke.py``
    (``run_evo_cases``: fp32 and bf16, head dims 8 to 128, every bias
    combination, L not a multiple of the tiles, Lq != Lk, groups of MSA
    rows with N not a multiple of the group; rows of out, dq, dk, dv within
    4 bf16 ulps of the row's largest |plain| value (fp32 1e-4 of it), lse
    within 1e-4, db1/db2 within a share of each panel's largest |plain|
    value), each with the mutants that apply, which must land outside; the
    forward's and the backward's entries by exact profiler name (bf16
    ``evo_fwd_kernel_mma``, ``evo_dq_kernel_mma``, ``evo_dkv_kernel_mma``,
    ``evo_dbias2_kernel_mma`` and its combine where dbias2 splits N,
    ``evo_dbias1_kernel_mma``; fp32 the CUDA-core kernels) and a bf16
    second forward and backward bit for bit. The bf16 forward's shared
    memory is ``evo_fwd_plan``'s, dQ's, dK/dV's, dbias2's and dbias1's
    ``evo_bwd_plan``'s. Then a head dim outside the instances raises, as
    does a non-contiguous operand."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels; no CPU mode)")
    import chip_smoke
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = chip_smoke.run_evo_cases(gen)
    assert len(rows) == len(chip_smoke.EVO_CASES)
    for d in te.HEAD_DIMS:
        smem = te.dynamic_smem_bytes(d)
        assert smem["evo_fwd_mma_pair"] == te.evo_fwd_plan(d, True)["smem_bytes"]
        assert smem["evo_fwd_mma"] == te.evo_fwd_plan(d, False)["smem_bytes"]
        pair, plain = te.evo_bwd_plan(d, True), te.evo_bwd_plan(d, False)
        assert smem["evo_dkv_mma_pair"] == pair["dkv"]["smem_bytes"]
        assert smem["evo_dkv_mma"] == plain["dkv"]["smem_bytes"]
        assert smem["evo_dbias2_mma"] == pair["dbias2"]["smem_bytes"]
        assert smem["evo_dq_mma_pair"] == pair["dq"]["smem_bytes"]
        assert smem["evo_dq_mma"] == plain["dq"]["smem_bytes"]
        assert smem["evo_dbias1_mma_pair"] == pair["dbias1"]["smem_bytes"]
        assert smem["evo_dbias1_mma"] == plain["dbias1"]["smem_bytes"]
    assert chip_smoke.EVO_BWD_ENTRY[torch.bfloat16]["evo_dbias1"] == \
        "evo_dbias1_kernel_mma"
    x = torch.randn(1, 2, 16, 2, 24, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        evo_fwd(x, x, x)
    x = torch.randn(1, 2, 16, 2, 32, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        evo_fwd(x.transpose(2, 3).contiguous().transpose(2, 3), x, x)
    assert math.isfinite(float(evo_fwd(x, x, x)[0].sum()))
