"""Port parity: the PyTorch flash attention against the JAX package.

The port's plain mirrors of the three kernels (``flash_fwd_plain``,
``flash_bwd_plain``) are held against the JAX Pallas kernels run in
interpret mode (``_pallas_flash_fwd_impl`` / ``_pallas_flash_bwd_impl``,
32-row blocks) on the same inputs made from a numpy seed, over the
kernels' contract: causal or not, GQA, unaligned S=100, Sq != Sk, a
window, ``[B,S]`` and pair segment ids, ``causal_shift=1``. Tolerances:
float32 atol/rtol 2e-5 on the forward and 1e-4 on the gradients (as
``tests/test_pallas_kernels.py`` holds the JAX kernels to their
reference; the two sides sum in other orders); the bfloat16 case to
2 bf16 ulps of each output's largest value (the sides round the same
values to bf16 after fp32 sums in other orders).

The CUDA kernels run only on the card: ``test_kernels_match_plain_on_card``
is marked ``gpu`` and skips where there is none. On the card, whose machine
lacks flax: ``python -m pytest --noconftest -m gpu tests/test_torch_*.py``.
"""

import math

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction, attention_reference, flash_bwd, flash_bwd_plain,
    flash_fwd, flash_fwd_plain)

FWD_TOL, BWD_TOL = 2e-5, 1e-4


def _jax():
    """The JAX side, imported where it is used (the card's machine lacks
    flax, and the card-only test below must still be collected there)."""
    pytest.importorskip("flax")
    jax = pytest.importorskip("jax")
    from deepspeed_tpu.ops import flash_attention as jfa
    from deepspeed_tpu.ops.pallas import flash_attention as jpfa
    return jax, jfa, jpfa


# (b, sq, sk, h, hkv, d, causal, window, shift, seg)
CASES = {
    "causal_gqa": (2, 64, 64, 4, 2, 32, True, None, 0, None),
    "noncausal_gqa": (1, 64, 64, 4, 1, 32, False, None, 0, None),
    "unaligned_s100": (1, 100, 100, 4, 2, 32, True, None, 0, None),
    "sq_ne_sk_causal": (1, 64, 100, 2, 2, 32, True, None, 0, None),
    "sq_ne_sk_noncausal": (1, 40, 100, 4, 2, 32, False, None, 0, None),
    "window": (1, 100, 100, 4, 2, 32, True, 24, 0, None),
    "segments": (2, 96, 96, 4, 2, 32, True, None, 0, "shared"),
    "segment_pair": (1, 64, 96, 2, 1, 32, False, None, 0, "pair"),
    "causal_shift": (1, 64, 64, 4, 2, 32, True, None, 1, "pair"),
    "d64": (1, 64, 64, 2, 2, 64, True, None, 0, None),
}


def _inputs(name, dtype=np.float32, seed=0):
    b, sq, sk, h, hkv, d, causal, window, shift, seg = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    do = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    segs = None
    if seg == "shared":
        ids = np.sort(rng.integers(0, 3, size=(b, sq)), axis=1).astype(np.int32)
        segs = ids
    elif seg == "pair":
        q_ids = np.sort(rng.integers(0, 3, size=(b, sq)), axis=1)
        k_ids = np.sort(rng.integers(0, 3, size=(b, sk)), axis=1)
        k_ids[:, -5:] = -1                      # padding keys: no segment
        segs = (q_ids.astype(np.int32), k_ids.astype(np.int32))
    opts = dict(causal=causal, window=window, causal_shift=shift)
    return (q, k, v, do), segs, opts


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _segs_torch(segs):
    if segs is None:
        return None
    if isinstance(segs, tuple):
        return tuple(torch.from_numpy(s) for s in segs)
    return torch.from_numpy(segs)


def _segs_jax(segs):
    import jax.numpy as jnp
    if segs is None:
        return None
    if isinstance(segs, tuple):
        return tuple(jnp.asarray(s) for s in segs)
    return jnp.asarray(segs)


def _jax_fwd_bwd(arrays, segs, opts, jdtype):
    jax, _, jpfa = _jax()
    import jax.numpy as jnp
    q, k, v, do = (jnp.asarray(a).astype(jdtype) for a in arrays)
    kw = dict(window=opts["window"], causal_shift=opts["causal_shift"],
              segment_ids=_segs_jax(segs))
    out, lse = jpfa._pallas_flash_fwd_impl(q, k, v, opts["causal"], 32, 32,
                                           True, **kw)
    dq, dk, dv = jpfa._pallas_flash_bwd_impl(q, k, v, out, lse, do,
                                             opts["causal"], 32, 32, True, **kw)
    b, sq, h, _ = q.shape
    lse = np.asarray(lse).reshape(b, h, -1)[:, :, :sq]
    return [np.asarray(x.astype(jnp.float32)) for x in (out, dq, dk, dv)], \
        np.asarray(out), lse


def _bf16_tol(want, ulps=2):
    top = float(np.abs(want).max())
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0


@pytest.mark.parametrize("name", list(CASES))
def test_plain_mirrors_match_jax_kernels(name):
    arrays, segs, opts = _inputs(name)
    (out_j, dq_j, dk_j, dv_j), out_raw, lse_j = _jax_fwd_bwd(
        arrays, segs, opts, np.float32)
    q, k, v, do = (_t(a) for a in arrays)
    seg_t = _segs_torch(segs)
    out, lse = flash_fwd_plain(q, k, v, segment_ids=seg_t, **opts)
    np.testing.assert_allclose(out.numpy(), out_j, atol=FWD_TOL, rtol=FWD_TOL)
    live = lse_j > -1e29                  # rows with a live key
    np.testing.assert_allclose(lse.numpy()[live], lse_j[live], atol=FWD_TOL,
                               rtol=FWD_TOL)
    assert (lse.numpy()[~live] < -1e29).all()
    # the backward on the JAX forward's own (out, lse): both sides see the
    # same residuals
    dq, dk, dv = flash_bwd_plain(q, k, v, _t(out_raw), torch.from_numpy(np.array(lse_j)),
                                 do, segment_ids=seg_t, **opts)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, atol=BWD_TOL,
                                   rtol=BWD_TOL)


def test_bf16_case_matches_jax_kernels():
    import jax.numpy as jnp
    _jax()
    arrays, segs, opts = _inputs("unaligned_s100", seed=3)
    arrays = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
              for a in arrays]
    (out_j, dq_j, dk_j, dv_j), out_raw, lse_j = _jax_fwd_bwd(
        arrays, segs, opts, jnp.bfloat16)
    q, k, v, do = (_t(a, torch.bfloat16) for a in arrays)
    out, lse = flash_fwd_plain(q, k, v, **opts)
    assert out.dtype == torch.bfloat16
    assert float(np.abs(out.float().numpy() - out_j).max()) <= _bf16_tol(out_j)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=1e-4, rtol=1e-5)
    out_ref = _t(np.asarray(jnp.asarray(out_raw).astype(jnp.float32)),
                 torch.bfloat16)
    grads = flash_bwd_plain(q, k, v, out_ref, torch.from_numpy(np.array(lse_j)), do,
                            **opts)
    for got, want in zip(grads, (dq_j, dk_j, dv_j)):
        assert got.dtype == torch.bfloat16
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= _bf16_tol(want), (err, _bf16_tol(want))


@pytest.mark.parametrize("name", ["causal_gqa", "window", "segments",
                                  "unaligned_s100"])
def test_autograd_matches_jax_grad(name):
    """``FlashAttentionFunction`` forward and autograd against ``jax.grad``
    of ``pallas_flash_attention(..., interpret=True)`` through the loss
    sum(out * dO)."""
    jax, _, jpfa = _jax()
    import jax.numpy as jnp
    arrays, segs, opts = _inputs(name, seed=5)
    qj, kj, vj, doj = (jnp.asarray(a) for a in arrays)

    def loss(q, k, v):
        out = jpfa.pallas_flash_attention(q, k, v, opts["causal"], 32, 32,
                                          True, opts["window"],
                                          _segs_jax(segs))
        return jnp.sum(out * doj), out

    (_, out_j), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(qj, kj, vj)
    q, k, v, do = (_t(a).requires_grad_(i < 3) for i, a in enumerate(arrays))
    out = FlashAttentionFunction.apply(q, k, v, opts["causal"], opts["window"],
                                       _segs_torch(segs))
    (out * do).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=FWD_TOL, rtol=FWD_TOL)
    for got, want in zip((q.grad, k.grad, v.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=BWD_TOL, rtol=BWD_TOL)


def test_reference_and_blockwise_match_jax():
    """``attention_reference`` (its causal mask offset by Sk - Sq) against
    its JAX original; the kernels' mask, aligned at row 0, differs from the
    reference's when Sq != Sk. The reference's blockwise
    ``flash_attention`` is not ported (nothing in the port calls it)."""
    _, jfa, _ = _jax()
    import jax.numpy as jnp
    arrays, _, _ = _inputs("sq_ne_sk_causal")
    q, k, v, _ = (_t(a) for a in arrays)
    qj, kj, vj = (jnp.asarray(a) for a in arrays[:3])
    for kw in (dict(causal=True), dict(causal=False), dict(window=16)):
        np.testing.assert_allclose(
            attention_reference(q, k, v, **kw).numpy(),
            np.asarray(jfa.attention_reference(qj, kj, vj, **kw)),
            atol=FWD_TOL, rtol=FWD_TOL)
    aligned, _ = flash_fwd_plain(q, k, v, causal=True)
    offset = attention_reference(q, k, v, causal=True)
    assert float((aligned - offset).abs().max()) > 0.1
    arrays, segs, _ = _inputs("segments")
    q, k, v, _ = (_t(a) for a in arrays)
    np.testing.assert_allclose(
        flash_fwd_plain(q, k, v, causal=True,
                        segment_ids=torch.from_numpy(segs))[0].numpy(),
        attention_reference(q, k, v, causal=True,
                            segment_ids=torch.from_numpy(segs)).numpy(),
        atol=FWD_TOL, rtol=FWD_TOL)


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    arrays, segs, opts = _inputs("window")
    q, k, v, do = (_t(a) for a in arrays)
    build.reset_launch_counts()
    out, lse = flash_fwd(q, k, v, **opts)
    want_out, want_lse = flash_fwd_plain(q, k, v, **opts)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    grads = flash_bwd(q, k, v, out, lse, do, **opts)
    for got, want in zip(grads, flash_bwd_plain(q, k, v, out, lse, do, **opts)):
        assert torch.equal(got, want)
    assert build.launch_counts() == {}
    with pytest.raises(ValueError, match="unsupported device"):
        flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """The CUDA kernels against the plain mirrors on the card, in the
    cases and at the tolerances of ``chip_smoke.py`` (``run_flash_cases``:
    the training shape, an unaligned GQA shape, a float32 non-causal
    Sq != Sk case, window, [B,S] segment ids, causal_shift=1, and for the
    bf16 tensor-core kernels d=64 non-causal with Sq != Sk, a window of
    100, Sq = Sk = 257; each row of a bf16 output within 4 bf16 ulps of that
    row's largest |plain| value, of a float32 output within 1e-4 of it, lse
    within 1e-4), each with its mutants (one drops a key tile from the late
    rows only, one a key tile from dQ alone), which must land outside the
    tolerance, and a second backward that repeats dQ, dK and dV bit for
    bit. Then what the kernels do not take raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels; no CPU mode)")
    import chip_smoke
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = chip_smoke.run_flash_cases(gen)
    assert len(rows) == len(chip_smoke.FLASH_CASES)
    q = torch.randn(1, 64, 4, 96, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_fwd(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous())
    q = torch.randn(1, 64, 4, 128, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(1, 64, 2, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # not contiguous
        flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError):                     # mixed dtypes
        flash_fwd(q, k.float(), k.float())
