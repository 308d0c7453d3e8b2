"""Port parity: the PyTorch RMSNorm against the JAX package.

``deepspeed_tpu_torch.ops.rms_norm`` (the plain version on CPU tensors, the
analytic backward in eager torch) is held against ``pallas_rms_norm(...,
interpret=True)`` and ``rms_norm_reference`` on the same inputs made from a
numpy seed: forward and both gradients within 1e-5 (as
``tests/test_pallas_kernels.py`` holds the Pallas kernel to its reference),
bf16 outputs within one bf16 ulp; with a bf16 x and dO (fp32 or bf16
scale) out and dx bit for bit and dscale within 1e-6 of its largest value
(fp32) or one ulp (bf16).

The CUDA kernel runs only on the card: ``test_kernel_matches_plain_on_card``
is marked ``gpu`` and skips where there is none. On the card:
``python -m pytest --noconftest -m gpu tests/test_torch_rms_norm.py``.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.ops.rms_norm import (RMSNormFunction, rms_norm,
                                              rms_norm_bwd, rms_norm_cuda,
                                              rms_norm_fwd, rms_norm_plain,
                                              rms_norm_reference)

TOL = 1e-5


def _jax():
    """The JAX side, imported where it is used (the card's machine lacks
    flax, and the card-only test below must still be collected there)."""
    pytest.importorskip("flax")
    jax = pytest.importorskip("jax")
    from deepspeed_tpu.ops.pallas import rms_norm as jrms
    return jax, jrms


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return x, scale, g


@pytest.mark.parametrize("shape,block_rows", [((4, 37, 256), 64),
                                              ((13, 100), 8), ((3, 2048), 256)])
def test_forward_matches_jax(shape, block_rows):
    jax, jrms = _jax()
    x, scale, _ = _arrays(shape, 0)
    want = np.asarray(jrms.pallas_rms_norm(x, scale, 1e-5, block_rows, True))
    ref = np.asarray(jrms.rms_norm_reference(x, scale))
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(rms_norm_reference(
        torch.from_numpy(x), torch.from_numpy(scale)).numpy(), ref,
        atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", [(8, 128), (5, 3, 96)])
def test_grads_match_jax(shape):
    jax, jrms = _jax()
    import jax.numpy as jnp
    x, scale, _ = _arrays(shape, 1)

    def loss(x_, s_):
        return jnp.sum(jrms.pallas_rms_norm(x_, s_, 1e-5, 8, True) ** 3)

    jdx, jds = jax.grad(loss, argnums=(0, 1))(x, scale)
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    (rms_norm(tx, ts) ** 3).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds), atol=TOL,
                               rtol=TOL)


def test_bf16_matches_jax_within_one_ulp():
    jax, jrms = _jax()
    import jax.numpy as jnp
    x, scale, _ = _arrays((37, 256), 2)
    want = np.asarray(jrms.pallas_rms_norm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale, jnp.bfloat16), 1e-5,
        16, True).astype(jnp.float32))
    got = rms_norm(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(scale).bfloat16()).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_bf16_grads_match_jax(scale_dtype):
    """bf16 x and dO (path R runs in bf16) with an fp32 or a bf16 scale,
    against JAX's vjp of the Pallas kernel in interpret mode: out and dx bit
    for bit (the same fp32 arithmetic, rounded once to bf16); dscale in the
    scale's dtype, within 1e-6 of its largest |JAX| value in fp32 (two fp32
    sums over the rows in other orders) and within one bf16 ulp of each JAX
    value in bf16."""
    jax, jrms = _jax()
    import jax.numpy as jnp
    x, scale, g = _arrays((37, 256), 5)
    js = jnp.asarray(scale, getattr(jnp, scale_dtype))
    out, vjp = jax.vjp(lambda x_, s_: jrms.pallas_rms_norm(x_, s_, 1e-5, 16, True),
                       jnp.asarray(x, jnp.bfloat16), js)
    jdx, jds = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    ts = torch.from_numpy(scale).to(getattr(torch, scale_dtype)).requires_grad_(True)
    got = rms_norm(tx, ts)
    got.backward(torch.from_numpy(g).bfloat16())
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa: E731
    assert got.dtype == tx.grad.dtype == torch.bfloat16
    assert ts.grad.dtype == ts.dtype
    np.testing.assert_array_equal(got.detach().float().numpy(), f32(out))
    np.testing.assert_array_equal(tx.grad.float().numpy(), f32(jdx))
    want_ds = f32(jds)
    if scale_dtype == "float32":
        tol = 1e-6 * np.abs(want_ds).max()
    else:
        tol = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want_ds), 1e-30))) - 7)
    assert (np.abs(ts.grad.float().numpy() - want_ds) <= tol).all()


def test_analytic_backward_matches_autograd_of_reference():
    x, scale, g = (torch.from_numpy(a) for a in _arrays((6, 50), 3))
    dx, ds = rms_norm_bwd(x, scale, g, 1e-5)
    xr, sr = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
    rms_norm_reference(xr, sr).backward(g)
    torch.testing.assert_close(dx, xr.grad, atol=TOL, rtol=TOL)
    torch.testing.assert_close(ds, sr.grad, atol=TOL, rtol=TOL)


def test_eps_and_dtypes_follow_the_reference():
    """Output in x's dtype, the gradient of scale in scale's dtype, and eps
    inside the rsqrt (a row of zeros gives zeros, a tiny row is not blown
    up to unit RMS)."""
    x = torch.zeros(2, 8)
    assert torch.equal(rms_norm_plain(x, torch.ones(8)), x)
    tiny = torch.full((1, 8), 1e-4)
    out = rms_norm_plain(tiny, torch.ones(8), eps=1e-5)
    assert float(out.max()) < 0.1
    xb = torch.randn(3, 8).bfloat16().requires_grad_(True)
    s32 = torch.ones(8, requires_grad=True)
    out = rms_norm(xb, s32)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and s32.grad.dtype == torch.float32


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    x, scale, g = (torch.from_numpy(a) for a in _arrays((9, 64), 4))
    build.reset_launch_counts()
    assert torch.equal(rms_norm_fwd(x, scale), rms_norm_plain(x, scale))
    assert torch.equal(RMSNormFunction.apply(x, scale, 1e-5),
                       rms_norm_plain(x, scale))
    assert build.launch_counts() == {}
    with pytest.raises(ValueError, match="unsupported device"):
        rms_norm_fwd(x.to("meta"), scale.to("meta"))
    with pytest.raises(ValueError, match="rms_norm kernel"):
        rms_norm_cuda(x, scale)                 # a CPU tensor never launches


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against the plain version on the card, in the cases
    and at the tolerances of ``chip_smoke.py`` (``run_rms_cases``: fp32 and
    bf16 x and scale, uneven N, odd D, Llama-3-8B's width, two shapes with
    more rows than one grid pass holds; bf16 within one ulp of each plain
    value, fp32 within 4 ulps of each row's largest |plain|), with the eps
    and D-1 mutants outside. Then a dtype the kernel does not take raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels; no CPU mode)")
    import chip_smoke
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = chip_smoke.run_rms_cases(gen)
    assert len(rows) == len(chip_smoke.RMS_CASES)
    x = torch.randn(4, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        rms_norm_cuda(x, torch.ones(64, device="cuda"))
    with pytest.raises(ValueError, match="scale"):
        rms_norm_cuda(x.float(), torch.ones(63, device="cuda"))
