"""Port parity: the PyTorch fused bias + activation (+ dropout) against the
JAX package.

``deepspeed_tpu_torch.ops.fused_bias_act`` (the plain versions on CPU
tensors) is held against ``fused_bias_act(..., interpret=True)`` and
``fused_bias_act_dropout(..., interpret=True)`` on the same inputs made from
a numpy seed, at the tolerances of ``tests/test_fused_bias_act.py``
(forward rtol 1e-5 / atol 1e-6, gradients 1e-4 / 1e-5), every activation,
uneven rows; in bf16 (x and dO, a bf16 or fp32 bias) out and dx bit for
bit and db within 1e-6 of its largest value (fp32) or one ulp (bf16). The dropout mask is the port's own Philox4x32-10 (the TPU's
PRNG is not reproducible elsewhere), so the dropout tests hold the
reference's contract: the forward's and the backward's masks identical,
the keep rate, seed determinism, kept values equal to JAX's
``fused_bias_act / (1 - rate)``; and the Philox against Random123's known
answers. The integer keep test against the fp32 one, word by word at the
threshold's edges; the launch plan (the mirror of the library's) covering
every element once.

The CUDA kernels run only on the card: ``test_kernels_match_plain_on_card``
is marked ``gpu`` and skips where there is none. On the card:
``python -m pytest --noconftest -m gpu tests/test_torch_fused_bias_act.py``.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops import fused_bias_act as fba
from deepspeed_tpu_torch.ops.fused_bias_act import (
    ACTS, act_fwd_plain, act_grad_plain, bias_act_bwd, bias_act_dropout_bwd,
    bias_act_dropout_fwd, bias_act_fwd, dropout_bits, dropout_keep,
    fused_bias_act, fused_bias_act_dropout, keep_threshold, launch_layout,
    launch_plan, philox4x32)


def _jax():
    """The JAX side, imported where it is used (the card's machine lacks
    flax, and the card-only test below must still be collected there)."""
    pytest.importorskip("flax")
    jax = pytest.importorskip("jax")
    from deepspeed_tpu.ops.pallas import fused_bias_act as jfba
    return jax, jfba


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape[-1:]).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", [(4, 8, 32), (13, 24)])
def test_forward_matches_jax(act, shape):
    jax, jfba = _jax()
    x, b, _ = _arrays(shape, 0)
    want = np.asarray(jfba.fused_bias_act(x, b, act, 8, True))
    got = fused_bias_act(torch.from_numpy(x), torch.from_numpy(b), act)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act", ACTS)
def test_grads_match_jax_uneven_rows(act):
    """13 rows against JAX's 8-row blocks: the padded backward's rows add
    nothing to dx or db."""
    jax, jfba = _jax()
    import jax.numpy as jnp
    x, b, g = _arrays((13, 24), 1)
    _, vjp = jax.vjp(lambda x_, b_: jfba.fused_bias_act(x_, b_, act, 8, True),
                     x, b)
    jdx, jdb = vjp(g)
    tx = torch.from_numpy(x).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    fused_bias_act(tx, tb, act).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), rtol=1e-4,
                               atol=1e-5)
    assert jnp.asarray(jdb).shape == tb.grad.shape


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bias_dtype", ["bfloat16", "float32"])
def test_bf16_grads_match_jax(act, bias_dtype):
    """bf16 x and dO (path F runs in bf16) with a bf16 or an fp32 (master)
    bias, against JAX's vjp of the Pallas kernel in interpret mode: out and
    dx bit for bit (the same fp32 operations, rounded once to bf16); db in
    the bias's dtype, within 1e-6 of its largest |JAX| value in fp32 (two
    fp32 sums over the rows in other orders) and within one bf16 ulp of each
    JAX value in bf16."""
    jax, jfba = _jax()
    import jax.numpy as jnp
    x, b, g = _arrays((13, 24), 1)
    jb = jnp.asarray(b, getattr(jnp, bias_dtype))
    out, vjp = jax.vjp(lambda x_, b_: jfba.fused_bias_act(x_, b_, act, 8, True),
                       jnp.asarray(x, jnp.bfloat16), jb)
    jdx, jdb = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    tb = torch.from_numpy(b).to(getattr(torch, bias_dtype)).requires_grad_(True)
    got = fused_bias_act(tx, tb, act)
    got.backward(torch.from_numpy(g).bfloat16())
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    assert got.dtype == tx.grad.dtype == torch.bfloat16
    assert tb.grad.dtype == tb.dtype
    np.testing.assert_array_equal(got.detach().float().numpy(), f32(out))
    np.testing.assert_array_equal(tx.grad.float().numpy(), f32(jdx))
    want_db = f32(jdb)
    if bias_dtype == "float32":
        tol = 1e-6 * np.abs(want_db).max()
    else:
        tol = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want_db), 1e-30))) - 7)
    assert (np.abs(tb.grad.float().numpy() - want_db) <= tol).all()


@pytest.mark.parametrize("act", ACTS)
def test_written_out_derivatives_match_autograd(act):
    x = torch.linspace(-6.0, 6.0, 2001, dtype=torch.float64).float()
    xr = x.clone().requires_grad_(True)
    act_fwd_plain(act, xr).sum().backward()
    torch.testing.assert_close(act_grad_plain(act, x), xr.grad, rtol=1e-5,
                               atol=1e-6)
    assert float(act_grad_plain("relu", torch.zeros(1))) == 0.0


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu's default (approximate=True), not erf-gelu, which differs
    by up to about 5e-4."""
    x = torch.linspace(-4, 4, 801)
    tanh_form = 0.5 * x * (1 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x ** 3)))
    torch.testing.assert_close(act_fwd_plain("gelu", x), tanh_form, rtol=1e-6,
                               atol=1e-6)
    erf_form = 0.5 * x * (1 + torch.erf(x / 2 ** 0.5))
    assert float((act_fwd_plain("gelu", x) - erf_form).abs().max()) > 1e-4


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors of Philox4x32-10."""
    words = philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_mask_depends_only_on_the_flat_index():
    """Element e takes word e % 4 of counter e // 4: the mask of [N, D] is
    the mask of the flat N * D elements, whatever the row width."""
    flat = dropout_keep(1, 60, 5, 0.3).reshape(-1)
    assert torch.equal(dropout_keep(6, 10, 5, 0.3).reshape(-1), flat)
    assert torch.equal(dropout_keep(12, 5, 5, 0.3).reshape(-1), flat)
    bits = dropout_bits(11, 5)
    e = 9                                        # counter 2, word 1
    z = torch.zeros(1, dtype=torch.int64)
    w = philox4x32(torch.tensor([2]), z, z, z, 5)
    assert int(bits[e]) == int(w[1])
    big = 2 ** 32 + 7                            # a counter past 32 bits
    hi = philox4x32(torch.tensor([big & 0xFFFFFFFF]), torch.tensor([big >> 32]),
                    z, z, 5)
    assert int(hi[0]) != int(philox4x32(torch.tensor([7]), z, z, z, 5)[0])
    assert fba.seed_key(-1) == 0xFFFFFFFF
    assert fba.seed_key(np.int32(7)) == fba.seed_key(torch.tensor([7])) == 7


def test_dropout_contract_against_jax():
    jax, jfba = _jax()
    x, _, _ = _arrays((64, 128), 2)
    b = np.zeros(128, np.float32)
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    a = fused_bias_act_dropout(tx, tb, 7, "identity", 0.25)
    assert torch.equal(a, fused_bias_act_dropout(tx, tb, 7, "identity", 0.25))
    assert not torch.equal(a, fused_bias_act_dropout(tx, tb, 8, "identity", 0.25))
    drop = float((a == 0).float().mean())
    assert 0.18 < drop < 0.33
    kept = (a != 0).numpy()
    want = np.asarray(jfba.fused_bias_act(x, b, "identity", 16, True)) * \
        np.float32(1.0 / 0.75)
    np.testing.assert_allclose(a.numpy()[kept], want[kept], rtol=1e-5)
    # JAX's own interpret-mode dropout keeps at the same rate, with its bits
    ja = np.asarray(jfba.fused_bias_act_dropout(x, b, 7, "identity", 0.25, 16,
                                                True))
    assert 0.18 < float(np.mean(ja == 0)) < 0.33


@pytest.mark.parametrize("act", ACTS)
def test_dropout_backward_draws_the_forward_mask(act):
    jax, jfba = _jax()
    import jax.numpy as jnp
    x, b, g = _arrays((13, 24), 3)
    rate = 0.3
    tx = torch.from_numpy(x).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    out = fused_bias_act_dropout(tx, tb, 11, act, rate)
    out.backward(torch.from_numpy(g))
    keep = dropout_keep(13, 24, 11, rate)
    assert torch.equal(out == 0, ~keep) or act == "relu"
    assert (tx.grad[~keep] == 0).all()
    # kept positions: JAX's forward and analytic gradient, scaled
    scale = np.float32(1.0 / (1.0 - rate))
    fwd = np.asarray(jfba.fused_bias_act(x, b, act, 8, True)) * scale
    k = keep.numpy()
    np.testing.assert_allclose(out.detach().numpy()[k], fwd[k], rtol=1e-5,
                               atol=1e-6)
    agrad = np.asarray(jax.grad(lambda v: jnp.sum(jfba._ACTS[act](v)))(x + b))
    np.testing.assert_allclose(tx.grad.numpy()[k], (g * agrad * scale)[k],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), tx.grad.numpy().sum(0),
                               rtol=1e-5, atol=1e-6)


def test_rate_zero_is_fused_bias_act_and_bad_rates_raise():
    x, b, _ = (torch.from_numpy(a) for a in _arrays((4, 8), 4))
    assert torch.equal(fused_bias_act_dropout(x, b, 0, "relu", 0.0),
                       fused_bias_act(x, b, "relu"))
    for rate in (1.5, 1.0, -0.1):
        with pytest.raises(ValueError, match="rate"):
            fused_bias_act_dropout(x, b, 0, "relu", rate)
    with pytest.raises(ValueError, match="activation"):
        fused_bias_act(x, b, "tanh")


@pytest.mark.parametrize("n,d", [(8192, 3072), (140001, 6), (13, 1001), (1, 1)])
def test_launch_layout_covers_every_column(n, d):
    tpr, gy = launch_layout(n, d, 132)
    assert tpr & (tpr - 1) == 0 and 1 <= tpr <= fba.THREADS
    assert 4 * tpr >= min(d, 4 * fba.THREADS)       # no idle tiles but the last
    gx = -(-d // (4 * tpr))
    assert gx * 4 * tpr >= d and 1 <= gy <= 65535
    assert gx * gy <= max(132 * fba.blocks_per_sm(0, 0), gx)


_RATES = [0.0, 2.0 ** -24, 0.1, 0.25, 0.5, 0.999, 1.0 - 2.0 ** -24,
          1.0 - 2.0 ** -30]                     # the last rounds to 1.0 in fp32


def _float_keep(words, rate):
    """The TPU kernel's keep test in fp32: (bits >> 8) * 2^-24 >= rate."""
    unit = (words >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)
    return unit >= np.float32(rate)


@pytest.mark.parametrize("rate", _RATES)
def test_integer_threshold_equals_the_float_keep_test(rate):
    """``(bits >> 8) >= keep_threshold(rate)`` keeps exactly the words the
    fp32 test keeps: at the threshold's edge (thr * 256 - 1, thr * 256), at
    0 and 2^32 - 1 and at random words; a rate whose fp32 rounds to 1.0
    keeps nothing, and thr * 256 never has to fit in 32 bits."""
    thr = keep_threshold(rate)
    assert thr == int(np.ceil(np.float64(np.float32(rate)) * 2.0 ** 24))
    assert 0 <= thr <= 1 << 24
    rng = np.random.default_rng(17)
    edge = [w for w in (thr * 256 - 1, thr * 256) if 0 <= w < 1 << 32]
    words = np.concatenate([np.array(edge + [0, (1 << 32) - 1], np.uint64),
                            rng.integers(0, 1 << 32, 100_000, dtype=np.uint64)])
    got = (words >> np.uint64(8)) >= np.uint64(thr)
    np.testing.assert_array_equal(got, _float_keep(words, rate))
    if thr * 256 < 1 << 32:
        assert got[edge.index(thr * 256)]        # the first word kept
    if thr:
        assert not got[edge.index(thr * 256 - 1)]   # the last one dropped
    if np.float32(rate) == 1.0:
        assert thr == 1 << 24 and not got.any()


@pytest.mark.parametrize("rate", [0.1, 0.999])
def test_plain_mask_takes_the_integer_threshold(rate):
    """``dropout_keep`` is the integer test on the Philox words, which is
    the fp32 test."""
    n, d, seed = 37, 53, 9
    bits = dropout_bits(n * d, seed)
    keep = dropout_keep(n, d, seed, rate)
    assert torch.equal(keep, ((bits >> 8) >= keep_threshold(rate)).reshape(n, d))
    want = _float_keep(bits.numpy().astype(np.uint64), rate).reshape(n, d)
    np.testing.assert_array_equal(keep.numpy(), want)


_PLAN_CASES = [(8192, 3072, torch.bfloat16, 0), (1000, 3076, torch.bfloat16, 0),
               (1000, 3072, torch.bfloat16, 8), (1001, 3072, torch.bfloat16, 0),
               (1, 3072, torch.bfloat16, 0), (513, 4096, torch.bfloat16, 0),
               (7, 2048, torch.bfloat16, 0), (1003, 1001, torch.bfloat16, 0),
               (140001, 6, torch.bfloat16, 2), (3, 520, torch.bfloat16, 0),
               (300, 512, torch.float32, 0), (777, 1001, torch.float32, 0),
               (5, 24, torch.float32, 8), (64, 3072, torch.float32, 4)]


@pytest.mark.parametrize("kind", range(4))
@pytest.mark.parametrize("n,d,dtype,off", _PLAN_CASES)
def test_launch_plan_covers_every_element_once(kind, n, d, dtype, off):
    """The launch plan (the mirror of the library's, which the smoke holds
    equal on the card), for every activation: every column of a row taken
    by exactly one thread of one tile, every row by exactly one pass of the
    grid-stride loop with its ``rows_per_pass`` row groups; 8 columns a
    thread only for bf16 where D % 8 == 0 and the operands start on 16-byte
    boundaries."""
    for act in range(len(ACTS)):
        cols, vec, tpr, gx, gy = launch_plan(kind, act, n, d, dtype, off, 132)
        esize = 2 if dtype == torch.bfloat16 else 4
        wide = dtype == torch.bfloat16 and d % 8 == 0 and off % 16 == 0
        assert cols == (8 if wide else 4)
        assert vec == int(wide or (d % 4 == 0 and off % (4 * esize) == 0))
        assert tpr & (tpr - 1) == 0 and 1 <= tpr <= fba.THREADS
        assert gx == -(-d // (cols * tpr)) and 1 <= gy <= 65535
        assert gx * gy <= max(132 * fba.blocks_per_sm(kind, act), gx)
        cover = np.zeros(d, np.int64)
        for c0 in range(0, gx * tpr * cols, cols):
            cover[c0:c0 + cols] += 1
        np.testing.assert_array_equal(cover, 1)
        rpi, unroll = fba.THREADS // tpr, fba.rows_per_pass(kind, act)
        groups = -(-n // rpi)
        seen = np.zeros(n, np.int64)
        for by in range(gy):
            for grp in range(by, groups, gy * unroll):
                for u in range(unroll):
                    r = (grp + u * gy) * rpi + np.arange(rpi)
                    np.add.at(seen, r[r < n], 1)
        np.testing.assert_array_equal(seen, 1)


def test_launch_plan_at_bert_base_ffn():
    """At F ([8192, 3072] bf16, 132 SMs) every kernel takes 8 columns a
    thread, 128 threads a row (three whole tiles; 256 would idle a quarter
    of the second tile's threads), one wave of its blocks (6 an SM for the
    gelu dropout forward); 8 bytes off a 16-byte boundary, 4 columns and
    256 threads; fp32, 4 columns."""
    gelu = ACTS.index("gelu")
    for kind, blocks in enumerate((4, 3, 6, 3)):
        assert fba.blocks_per_sm(kind, gelu) == blocks
        assert launch_plan(kind, gelu, 8192, 3072, torch.bfloat16, 0, 132) == (
            8, 1, 128, 3, 132 * blocks // 3)
        assert launch_plan(kind, gelu, 8192, 3072, torch.bfloat16, 8,
                           132)[:3] == (4, 1, 256)
        assert launch_plan(kind, gelu, 8192, 3072, torch.float32, 0,
                           132)[:3] == (4, 1, 256)


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    x, b, g = (torch.from_numpy(a) for a in _arrays((9, 40), 5))
    build.reset_launch_counts()
    assert torch.equal(bias_act_fwd(x, b), fba.bias_act_plain(x, b))
    for got, want in zip(bias_act_bwd(x, b, g), fba.bias_act_bwd_plain(x, b, g)):
        assert torch.equal(got, want)
    assert torch.equal(bias_act_dropout_fwd(x, b, 3),
                       fba.bias_act_dropout_plain(x, b, 3))
    for got, want in zip(bias_act_dropout_bwd(x, b, g, 3),
                         fba.bias_act_dropout_bwd_plain(x, b, g, 3)):
        assert torch.equal(got, want)
    assert build.launch_counts() == {}
    with pytest.raises(ValueError, match="unsupported device"):
        bias_act_fwd(x.to("meta"), b.to("meta"))


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """The four CUDA kernels against the plain versions on the card, in the
    cases and at the tolerances of ``chip_smoke.py``
    (``run_bias_act_cases``: every activation in fp32 and bf16, D not a
    multiple of 4, uneven N, two shapes with more rows than one grid pass
    holds, bf16 on the 4-column path (D % 8 != 0, views 8 bytes in), N odd
    over the unrolled passes, one row, rate 0.999; outputs and dx within one
    bf16 ulp of each plain value or 4 fp32 ulps of each row's largest
    |plain|, db within 1e-5 of its largest, the dropout masks of forward and
    backward bit-identical to the plain mask, a second backward bit for
    bit), with the erf-gelu, db-from-one-block, shifted-mask and
    swapped-draws mutants outside. Then a dtype the kernels do not take
    raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels; no CPU mode)")
    import chip_smoke
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = chip_smoke.run_bias_act_cases(gen)
    assert len(rows) == len(chip_smoke.BIAS_ACT_CASES)
    x = torch.randn(4, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        bias_act_fwd(x, torch.zeros(64, device="cuda"))
    with pytest.raises(ValueError, match="bias"):
        bias_act_fwd(x.float(), torch.zeros(63, device="cuda"))
