"""Port parity: the int8 / fp8 quantization kernels' plain versions and the
fp6 / fp12 software formats against the JAX package.

- ``quantize_int8`` / ``dequantize_int8`` / ``quantize_fp8`` /
  ``dequantize_fp8`` / ``selective_dequantize_fp8`` on CPU tensors (the
  plain versions) against the Pallas kernels in interpret mode, on seeded
  rows plus the card smoke's special rows (an all-zero row, exact ties
  after scaling, an absmax that lands a hair above the format's maximum, a
  last-element maximum, a row where a reciprocal product would round
  otherwise), with unaligned widths and row counts that are not a multiple
  of the Pallas ``block_rows``. Codes, scales and dequantized values must be
  bit-identical; for fp8 codes a one-ulp difference is counted and allowed
  only where it stays rare (XLA and torch convert to fp8 separately).
- The smoke's quant cases run on the CPU: every special row exposes the
  fault it was built for. An fp8 dequantize of a view one row in (d = 130)
  matches the Pallas kernel bit for bit, and ``dequant_chunks``, the fp8
  dequantize kernel's split into 16-code chunks and scalar codes, covers
  every code of every smoke shape once at aligned and offset addresses.
  ``quant_elements``, the int8 quantize kernel's split (16-byte chunks, a
  scalar head and tail, a row's segments across a thread-block cluster),
  covers every element of qgZ's widths and odd ones once, on tensors and
  on views one row in, and ``quant_plan`` sends each width to the
  instance its design names.
- ``ops.fp_formats``: packed bytes, decoded values and ``FPQuantizer`` at
  6, 8 and 12 bits equal to the JAX package's.

The card test (marked ``gpu``) runs the smoke's quant cases on the CUDA
kernels: ``python -m pytest --noconftest -m gpu tests/test_torch_*.py``.
"""

import numpy as np
import pytest
import torch

from chip_smoke import QUANT_SHAPES
from deepspeed_tpu_torch.ops import fp_formats as tfp
from deepspeed_tpu_torch.ops import fp_quant as tfq
from deepspeed_tpu_torch.ops import quant as tq

QMAX = {"int8": 127.0, "e4m3": 448.0, "e5m2": 57344.0}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# [N, D]: unaligned D, N not a multiple of the Pallas block_rows (256), a
# qgZ row width and a single row
SHAPES = [(300, 64), (257, 130), (5, 4099), (3, 14336), (1, 128)]
# the int8 quantize's also: the lm_head's width, which the kernel holds
# across a thread-block cluster
INT8_SHAPES = SHAPES + [(2, 128256)]
# fp8 codes one ulp apart between XLA's and torch's conversions: allowed
# on at most this share of the elements
FP8_ULP_SHARE = 1e-3


def _jax():
    """The JAX side, imported where it is used (the card's machine lacks
    flax, and the card-only test below must still be collected there)."""
    pytest.importorskip("flax")
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from deepspeed_tpu.ops import fp_formats as jfp
    from deepspeed_tpu.ops.pallas import fp_quant as jfq
    from deepspeed_tpu.ops.pallas import quant as jq
    return jax, jnp, jq, jfq, jfp


def _rows(shape, fmt, dname, seed):
    """Seeded rows (times 3) with the smoke's special rows in front."""
    import chip_smoke
    n, d = shape
    rng = np.random.default_rng(seed)
    dtype = DTYPES[dname]
    x = chip_smoke._through(rng.normal(size=(n, d)) * 3.0, dtype)
    special = chip_smoke.quant_special_rows(d, fmt, dtype, rng)
    k = min(n, len(special))
    x[:k] = np.stack(list(special.values())[:k])
    return x


def _to_jax(x, dname):
    _, jnp, *_ = _jax()
    return jnp.asarray(x, {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dname])


def _np_bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _t_bits(t):
    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32}[t.element_size()]
                               ).numpy().view(
        {1: np.uint8, 2: np.uint16, 4: np.uint32}[t.element_size()])


def _assert_same_bits(got, want, what):
    g, w = _t_bits(got), _np_bits(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    diff = int((g != w).sum())
    assert diff == 0, f"{what}: {diff} of {g.size} elements differ"


def _fp8_ulps(got, want):
    """(elements one code apart, elements further apart) of two fp8 code
    arrays, by the distance of their sign-magnitude bit patterns."""
    def ordinal(b):
        b = b.astype(np.int32)
        return np.where(b & 0x80, -(b & 0x7F), b & 0x7F)
    dist = np.abs(ordinal(_t_bits(got)) - ordinal(_np_bits(want)))
    return int((dist == 1).sum()), int((dist > 1).sum())


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("shape", INT8_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_int8_matches_pallas(shape, dname):
    _, jnp, jq, _, _ = _jax()
    x = _rows(shape, "int8", dname, seed=shape[0] * 7 + shape[1])
    jcodes, jscales = jq.quantize_int8(_to_jax(x, dname), interpret=True)
    xt = torch.from_numpy(x).to(DTYPES[dname])
    codes, scales = tq.quantize_int8(xt)
    assert codes.dtype == torch.int8 and scales.shape == (shape[0], 1)
    _assert_same_bits(codes, jcodes, "int8 codes")
    _assert_same_bits(scales, jscales, "int8 scales")
    assert torch.all(codes[0] == 0) and scales[0, 0].item() == np.float32(1e-12)
    for out, jout in ((torch.float32, jnp.float32), (torch.bfloat16,
                                                     jnp.bfloat16)):
        _assert_same_bits(tq.dequantize_int8(codes, scales, out),
                          jq.dequantize_int8(jcodes, jscales, dtype=jout,
                                             interpret=True),
                          f"int8 dequantize to {out}")


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fp8_matches_pallas(shape, dname, fmt):
    _, jnp, _, jfq, _ = _jax()
    x = _rows(shape, fmt, dname, seed=shape[0] * 11 + shape[1])
    jcodes, jscales = jfq.quantize_fp8(_to_jax(x, dname), fmt=fmt,
                                       interpret=True)
    codes, scales = tfq.quantize_fp8(torch.from_numpy(x).to(DTYPES[dname]),
                                     fmt)
    assert codes.dtype == tfq.FP8_FORMATS[fmt][0]
    _assert_same_bits(scales, jscales, f"{fmt} scales")
    one, more = _fp8_ulps(codes, jcodes)
    assert more == 0, f"{more} {fmt} codes more than one ulp apart"
    assert one <= FP8_ULP_SHARE * codes.numel(), \
        f"{one} of {codes.numel()} {fmt} codes one ulp apart"
    top = torch.from_numpy(np.abs(x)).amax(-1)
    assert torch.isfinite(codes.float()).all()
    assert torch.all(codes.float().abs().amax(-1)[top > 0] == QMAX[fmt])
    # dequantize the JAX codes on both sides: the same function, bit for bit
    tcodes = torch.from_numpy(_np_bits(jcodes).copy()).view(codes.dtype)
    for out, jout in ((torch.float32, jnp.float32), (torch.bfloat16,
                                                     jnp.bfloat16)):
        _assert_same_bits(tfq.dequantize_fp8(tcodes, scales, out),
                          jfq.dequantize_fp8(jcodes, jscales, dtype=jout,
                                             interpret=True),
                          f"{fmt} dequantize to {out}")


def test_selective_dequantize_fp8_matches_pallas():
    _, jnp, _, jfq, _ = _jax()
    x = np.random.default_rng(3).normal(size=(40, 96)).astype(np.float32)
    jcodes, jscales = jfq.quantize_fp8(jnp.asarray(x), interpret=True)
    codes, scales = tfq.quantize_fp8(torch.from_numpy(x))
    rows = np.asarray([7, 0, 39, 7], np.int32)
    want = jfq.selective_dequantize_fp8(jcodes, jscales, jnp.asarray(rows),
                                        dtype=jnp.float32, interpret=True)
    got = tfq.selective_dequantize_fp8(codes, scales, torch.from_numpy(rows),
                                       dtype=torch.float32)
    _assert_same_bits(got, want, "selective dequantize")


def _nonfinite_rows():
    x = np.random.default_rng(6).normal(size=(3, 96)).astype(np.float32)
    x[1, 5] = np.nan
    x[2, 7] = np.inf
    return x


def _round_trips(x):
    """Each wrapper pair's scales and fp32 round trip of x."""
    out = {}
    for name, quant, deq in (("int8", tq.quantize_int8, tq.dequantize_int8),
                             ("e4m3", tfq.quantize_fp8, tfq.dequantize_fp8)):
        q, s = quant(x)
        out[name] = (s, deq(q, s, torch.float32))
    return out


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fp8_dequantize_of_a_row_offset_view_matches_pallas(fmt):
    """Codes and scales one row in (d = 130: the codes start 130 bytes
    past the tensor's, off every 16-byte boundary, as the smoke's view case
    hands the kernel) dequantize bit for bit as the Pallas kernel does, to
    fp32 and bf16."""
    _, jnp, _, jfq, _ = _jax()
    x = _rows((9, 130), fmt, "fp32", seed=17)
    jcodes, jscales = jfq.quantize_fp8(jnp.asarray(x), fmt=fmt, interpret=True)
    codes, scales = tfq.quantize_fp8(torch.from_numpy(x), fmt)
    tcodes = torch.from_numpy(_np_bits(jcodes).copy()).view(codes.dtype)
    view, view_scales = tcodes[1:], scales[1:]
    assert view.storage_offset() == 130
    for out, jout in ((torch.float32, jnp.float32), (torch.bfloat16,
                                                     jnp.bfloat16)):
        _assert_same_bits(tfq.dequantize_fp8(view, view_scales, out),
                          jfq.dequantize_fp8(jcodes[1:], jscales[1:],
                                             dtype=jout, interpret=True),
                          f"{fmt} dequantize of a row-offset view to {out}")


def _cover_counts(n, d, q_offset, itemsize):
    starts, scalars = tq.dequant_chunks(n, d, q_offset, 0, itemsize)
    counts = np.bincount(scalars, minlength=n * d)
    if starts.size:
        counts += np.bincount((starts[:, None] + np.arange(tq.DEQ_CHUNK))
                              .reshape(-1), minlength=n * d)
    return starts, scalars, counts


@pytest.mark.parametrize("shape", QUANT_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dequant_chunks_cover_each_code_once(shape):
    """The fp8 dequantize kernel's split of a call (``dequant_chunks``, as
    ``deq_plan`` in csrc/quant.cu) covers every code of every smoke shape
    exactly once, for codes at a 16-byte boundary and 1, 8 and 130 bytes
    past one (a view one row in at d = 130), to 2- and 4-byte outputs;
    every chunk lies inside one row and starts its codes and its outputs
    on 16-byte boundaries; an aligned call of rows of a multiple of 16
    codes (A1's groups of 64) takes no scalar path at all."""
    n, d = shape
    for q_offset in (0, 1, 8, 130):
        for itemsize in (2, 4):
            starts, scalars, counts = _cover_counts(n, d, q_offset, itemsize)
            assert counts.min() == 1 and counts.max() == 1, \
                (q_offset, itemsize)
            assert np.all((q_offset + starts) % 16 == 0)
            assert np.all(starts * itemsize % 16 == 0)
            assert np.all(starts // d == (starts + tq.DEQ_CHUNK - 1) // d)
            if q_offset == 0 and d % 16 == 0:
                assert scalars.size == 0 and starts.size == n * d // 16
            if q_offset in (1, 130):     # no code boundary puts an output on one
                assert starts.size == 0
            elif d >= 31:                # every row holds a whole chunk
                assert starts.size >= n * ((d - 15) // 16)


@pytest.mark.parametrize("view", ["aligned", "one_row_in"])
@pytest.mark.parametrize("d", [128, 130, 1000, 4096, 14336, 128256])
def test_quant_plan_covers_each_element_once(d, view):
    """The int8 quantize kernel's split of a call (``quant_elements``, as
    ``quant_plan`` in csrc/quant.cu) covers every element of x [n, d]
    exactly once, for fp32 and bf16 inputs, on a tensor and on a view one
    row in (whose first element lies d elements past a 16-byte boundary:
    at d = 130 off every one): every chunk lies inside one row and starts
    on a 16-byte boundary of x; a chunk's codes go out in one store only
    where they lie on a boundary of its width; no lane or thread holds more
    than one scalar element and none more chunks than its instance has
    room for; a row on the cluster path is split into consecutive segments
    of at most ``seg`` chunks, one a CTA."""
    n = 5
    for itemsize in (4, 2):
        x_offset = d * itemsize % 16 if view == "one_row_in" else 0
        pl = tq.quant_plan(n, d, x_offset, 0, itemsize)
        assert pl["path"] in (0, 1, 2)
        vec = pl["vec"]
        starts, ctas, scalars = tq.quant_elements(n, d, x_offset, 0, itemsize)
        counts = np.bincount(scalars, minlength=n * d)
        counts += np.bincount((starts[:, None] + np.arange(vec)).reshape(-1),
                              minlength=n * d)
        assert counts.min() == 1 and counts.max() == 1, itemsize
        assert np.all((x_offset + starts * itemsize) % 16 == 0)
        assert np.all(starts // d == (starts + vec - 1) // d)
        assert pl["wide"] == int(x_offset == 0)
        lanes = 32 if pl["path"] == 0 else pl["threads"]
        assert pl["rest"] <= min(32, lanes)
        assert pl["seg"] <= lanes * pl["per"]
        if pl["path"] == 2:
            assert pl["cluster"] == tq.QUANT_CLUSTER
            per_row = ctas.reshape(n, -1)
            assert np.all(np.diff(per_row, axis=1) >= 0)
            assert np.all(np.bincount(per_row[0]) <= pl["seg"])
            assert set(per_row[0]) == set(range(pl["cluster"]))
        else:
            assert pl["cluster"] == 1 and np.all(ctas == 0)
        if x_offset == 0 and d % vec == 0:
            assert scalars.size == 0 and starts.size == n * d // vec


def test_quant_plan_picks_the_path_by_width():
    """qgZ's rows (fp32, aligned) go to the instance the design names:
    rows of 128 one warp each, a chunk a lane, 4 rows a warp; rows of 4096
    one block of 256 threads x 4 chunks; rows of 14336 one block of 512 x
    7; the lm_head's rows of 128256 a cluster of QUANT_CLUSTER CTAs of 512
    threads, each holding its segment in a ring of the smallest instance
    with room for it (2004 chunks a segment in fp32, 4 a thread). Every width to the widest a cluster holds gets an
    instance with room for its chunks, and a wider row gets none (the
    wrapper then raises)."""
    want = {128: (0, 32, 1, 4, 1), 4096: (1, 256, 4, 1, 1),
            14336: (1, 512, 7, 1, 1)}
    for d, (path, threads, per, rows, cluster) in want.items():
        pl = tq.quant_plan(4096, d, 0, 0, 4)
        assert (pl["path"], pl["threads"], pl["per"], pl["rows"],
                pl["cluster"]) == (path, threads, per, rows, cluster), d
        assert pl["rest"] == 0 and pl["wide"] == 1
    for itemsize in (4, 2):
        pl = tq.quant_plan(4096, 128256, 0, 0, itemsize)
        chunks = 128256 * itemsize // 16
        assert (pl["path"], pl["threads"], pl["cluster"]) == \
            (2, 512, tq.QUANT_CLUSTER)
        assert pl["seg"] == -(-chunks // tq.QUANT_CLUSTER)
        assert pl["seg"] <= 512 * pl["per"] < 2 * pl["seg"] + 512
    widest = tq.QUANT_CLUSTER * 4096 * 4
    for d in list(range(1, 600, 7)) + [1024, 4097, 16384, 16388, 65536,
                                       widest]:
        pl = tq.quant_plan(3, d, 0, 0, 4)
        assert pl["path"] >= 0, d
        lanes = 32 if pl["path"] == 0 else pl["threads"]
        assert pl["cluster"] * pl["seg"] >= pl["chunks"] and \
            pl["seg"] <= lanes * pl["per"], d
        assert pl["rows"] * pl["per"] == 4 if pl["path"] == 0 else pl["rows"] == 1
    assert tq.quant_plan(3, widest + 4, 0, 0, 4)["path"] == -1


def test_qgz_leaf_shapes_match_the_training_model():
    """The smoke's ``qgz_leaf_shapes`` (what its quant timing quantizes as
    one qgZ micro-batch) are the [n, d] rows of every parameter of at least
    MIN_QUANT_SIZE elements of the 4-layer Llama-3-8B training model, in
    order: 39 leaves over the four row widths."""
    import dataclasses
    import chip_smoke
    from deepspeed_tpu_torch.models.llama import LLAMA3_8B, LlamaForCausalLM
    from deepspeed_tpu_torch.runtime.zero.qgz import MIN_QUANT_SIZE
    cfg = dataclasses.replace(LLAMA3_8B, num_layers=chip_smoke.TRAIN_LAYERS)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg, device="cpu")
    want = [(p.numel() // p.shape[-1], p.shape[-1])
            for p in model.parameters() if p.numel() >= MIN_QUANT_SIZE]
    got = chip_smoke.qgz_leaf_shapes(LLAMA3_8B, chip_smoke.TRAIN_LAYERS)
    assert sorted(got) == sorted(want)
    assert len(got) == chip_smoke.QGZ_LEAVES == 39
    assert {d for _, d in got} == set(chip_smoke.QGZ_WIDTH_SHAPES)
    for d, (n, _) in chip_smoke.QGZ_WIDTH_SHAPES.items():
        assert n == max(m for m, e in got if e == d)


def test_nonfinite_rows_stay_nonfinite():
    """A NaN or inf in a row makes its scale non-finite and its whole round
    trip NaN, as in the reference (jnp.max keeps NaN), so a bad gradient
    stays visible to the engine's guard after qgZ."""
    _, jnp, jq, jfq, _ = _jax()
    x = _nonfinite_rows()
    for name, (s, back) in _round_trips(torch.from_numpy(x)).items():
        quant, deq = (jq.quantize_int8, jq.dequantize_int8) if name == "int8" \
            else (jfq.quantize_fp8, jfq.dequantize_fp8)
        jcodes, js = quant(jnp.asarray(x), interpret=True)
        jback = np.asarray(deq(jcodes, js, dtype=jnp.float32, interpret=True))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert np.isnan(back[1:].numpy()).all() and np.isnan(jback[1:]).all()
        np.testing.assert_array_equal(back[0].numpy(), jback[0])


def test_quant_cases_expose_their_faults_on_cpu():
    """The smoke's quant_parity cases through the wrappers on CPU tensors
    (the plain versions): each special row makes its mutant differ, and the
    reciprocal row exists for every fp32 format."""
    import chip_smoke
    rows = chip_smoke.run_quant_cases(device="cpu")
    assert len(rows) == len(chip_smoke.quant_cases())
    faults = {f for r in rows for f in r["mutants"]}
    assert faults == {f for f in chip_smoke.QUANT_ROWS.values() if f} | \
        {f for f in chip_smoke.QUANT_INT8_ROWS.values() if f} | \
        {"dequant_row_shift", "dequant_tail_dropped"}
    # int8: a NaN and an inf row at every width; the cluster's widest rows
    # also hold the row whose maximum opens the last segment
    for d in {d for _, d in chip_smoke.QUANT_SHAPES}:
        held = {r for row in rows if row["fmt"] == "int8"
                and row["case"].endswith(f"x{d}") for r in row["special_rows"]}
        assert {"nan", "inf"} <= held, d
        assert ("segment_max" in held) == (d == 128256), d
    seg = {r["case"] for r in rows if "absmax_one_segment_dropped" in r["mutants"]}
    assert seg == {"special_8x128256"}
    assert all(r["view_quant_differ"] == 0 for r in rows
               if "view_quant_differ" in r)
    tails = {r["case"].split("x")[-1] for r in rows
             if "dequant_tail_dropped" in r["mutants"]}
    assert tails == {"130", "1000"}
    assert all(r["view_dequant_differ"] == 0 for r in rows
               if "view_dequant_differ" in r)
    recip = {(r["fmt"], r["dtype"]) for r in rows
             if "reciprocal" in r["special_rows"]}
    assert {(f, "fp32") for f in QMAX} <= recip


def test_wrappers_refuse_what_they_do_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        tq.quantize_int8(x.to("meta"))
    with pytest.raises(ValueError, match="fp8 format"):
        tfq.quantize_fp8(x, "e3m4")
    with pytest.raises(ValueError, match="not fp8"):
        tfq.dequantize_fp8(torch.zeros(4, 8, dtype=torch.int8),
                           torch.ones(4, 1))
    # the quantized collectives run over the comm facade's global mesh
    # (tests/test_torch_comm.py holds them against JAX across ranks): with
    # none installed they refuse; at one rank each is the round trip
    from deepspeed_tpu_torch.comm import mesh as tmesh
    collectives = ((tq.quantized_all_gather, (x, "data")),
                   (tq.quantized_psum_scatter, (x, "data")),
                   (tq.all_to_all_quant_reduce, (x, "data")),
                   (tq.quantized_psum, (x, ("data",))),
                   (tq.quantized_all_to_all, (x, "data")),
                   (tfq.quantized_all_gather_fp8, (x, "data")))
    saved = tmesh.get_global_mesh()
    tmesh.set_global_mesh(None)
    try:
        for fn, args in collectives:
            with pytest.raises(RuntimeError, match="no global mesh"):
                fn(*args)
        tmesh.set_global_mesh(tmesh.Mesh({}, 0, "cpu"))
        y = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
        int8 = tq.dequantize_int8(*tq.quantize_int8(y), dtype=y.dtype)
        fp8 = tfq.dequantize_fp8(*tfq.quantize_fp8(y), dtype=y.dtype)
        for fn, args in collectives:
            want = fp8 if fn is tfq.quantized_all_gather_fp8 else int8
            assert torch.equal(fn(y, *args[1:]), want), fn.__name__
    finally:
        tmesh.set_global_mesh(saved)
    for fn, args in ((tfq.fp8_matmul, (x, x, x)),
                     (tfq.fp8_gemm_quantize, (x, x)),
                     (tfq.fp8_gemm, (x, x, x, x))):
        with pytest.raises(NotImplementedError, match="not ported"):
            fn(*args)


# ---------------------------------------------------------------------------
# fp6 / fp12
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["fp6", "fp12"])
def test_fp_format_codes_match_jax(fmt):
    _, jnp, _, _, jfp = _jax()
    e, m = tfp.FP_FORMATS[fmt]
    codes = np.arange(1 << (1 + e + m), dtype=np.int32)
    vals = tfp._decode(torch.from_numpy(codes), e, m)
    jvals = jfp._decode(jnp.asarray(codes, jnp.uint32), e, m)
    # XLA's exp2 on the CPU is a few ulps off at negative integer exponents
    # (2^-20 comes out 9.5367426e-07); torch's is exact, so the small fp12
    # values agree to a few ulps and fp6's exactly
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-6,
                               atol=0)
    if fmt == "fp6":
        _assert_same_bits(vals, jvals, f"{fmt} decode")
    back = tfp._encode(vals, e, m)
    # decode -> encode is the identity except -0.0, which re-encodes as +0.0
    bad = np.where(back.numpy() != codes)[0]
    assert all(int(codes[i]) == 1 << (e + m) for i in bad)


@pytest.mark.parametrize("fmt,group", [("fp6", 4), ("fp12", 2)])
def test_fp_format_packing_matches_jax(fmt, group):
    _, jnp, _, _, jfp = _jax()
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(33, 256)) * np.exp(rng.normal(size=(33, 1)) * 4)
         ).astype(np.float32)
    x[0] = 0.0
    x[1, :7] = [1e-30, -1e-30, 3.0, -3.0, 1e30, 0.0, -0.0]
    packed, scales = tfp.quantize_fp(torch.from_numpy(x), fmt)
    jpacked, jscales = jfp.quantize_fp(jnp.asarray(x), fmt=fmt)
    bits = 1 + sum(tfp.FP_FORMATS[fmt])
    assert packed.shape == (33, 256 * bits // 8) and packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    _assert_same_bits(scales, jscales, f"{fmt} scales")
    got = tfp.dequantize_fp(packed, scales, fmt, 256, torch.float32)
    want = jfp.dequantize_fp(jpacked, jscales, fmt, 256, dtype=jnp.float32)
    _assert_same_bits(got, want, f"{fmt} dequantize")
    rows = np.asarray([5, 0, 5], np.int32)
    sel = tfp.selective_dequantize_fp(packed, scales, torch.from_numpy(rows),
                                      fmt, 256, torch.float32)
    _assert_same_bits(sel, np.asarray(want)[rows], f"{fmt} selective")
    with pytest.raises(ValueError, match="packing group"):
        tfp.quantize_fp(torch.zeros(2, group + 1), fmt)


@pytest.mark.parametrize("q_bits", [6, 8, 12])
def test_fp_quantizer_matches_jax(q_bits):
    _, jnp, _, _, jfp = _jax()
    x = np.random.default_rng(q_bits).normal(size=(16, 128)).astype(np.float32)
    q, s = tfp.FPQuantizer(q_bits).quantize(torch.from_numpy(x))
    jqv, js = jfp.FPQuantizer(q_bits).quantize(jnp.asarray(x))
    _assert_same_bits(q, jqv, f"fp{q_bits} codes")
    _assert_same_bits(s, js, f"fp{q_bits} scales")
    kw = {} if q_bits == 8 else {"d": 128}
    _assert_same_bits(tfp.FPQuantizer(q_bits).dequantize(q, s, **kw),
                      jfp.FPQuantizer(q_bits).dequantize(jqv, js, **kw),
                      f"fp{q_bits} dequantize")
    with pytest.raises(ValueError):
        tfp.FPQuantizer(q_bits=4)
    if q_bits != 8:
        with pytest.raises(ValueError, match="unpacked dim"):
            tfp.FPQuantizer(q_bits).dequantize(q, s)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_quant_kernels_match_plain_on_card():
    """The four CUDA kernels against their plain versions on the card, in
    the cases of ``chip_smoke.py`` (``run_quant_cases``: eight shapes from
    [4099, 64] to [3, 128256], two of them with more rows than the kernels'
    grids hold, fp32 and bf16 inputs, int8, e4m3 and e5m2, with the special
    rows): codes, scales and dequantized outputs bit for
    bit, every mutant outside. Then what the kernels do not take raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels; no CPU mode)")
    import chip_smoke
    rows = chip_smoke.run_quant_cases()
    assert len(rows) == len(chip_smoke.quant_cases())
    x = torch.randn(8, 64, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        tq.quantize_int8(x.double())
    q, s = tq.quantize_int8(x)
    with pytest.raises(ValueError, match="scales"):
        tq.dequantize_int8(q, s[:4])
    with pytest.raises(ValueError, match="q on"):
        tq.dequantize_int8(q, s.cpu())
    rows = torch.from_numpy(_nonfinite_rows())
    for name, (s, back) in _round_trips(rows.cuda()).items():
        ps, pback = _round_trips(rows)[name]
        assert torch.equal(s.isnan().cpu(), ps.isnan()), name
        assert torch.equal(back.isnan().cpu(), pback.isnan()), name
        assert torch.equal(back[0].cpu(), pback[0]), name
    q8, s8 = tfq.quantize_fp8(x, "e5m2")
    assert q8.dtype == torch.float8_e5m2
    torch.testing.assert_close(tfq.dequantize_fp8(q8, s8, torch.float32),
                               tq.dequantize_plain(q8, s8, torch.float32),
                               atol=0, rtol=0)
