"""Port parity: comm_compression, sparse embedding gradients, TiledLinear.

- ``CommCompressionConfig`` accepts and refuses what the JAX package's
  does; ``plan_buckets`` and ``GradCompressor``'s ``bucket_summaries``
  equal JAX's on many leaf lists (the tree-flatten order included:
  ``layer_10`` before ``layer_2``); ``reshard_error_feedback`` equals JAX's
  on numpy input (and on torch tensors).
- ``SparseTensor`` and ``sparse_grad_sync`` (four gloo ranks, data=2 x
  fsdp=2) equal JAX's densified results, its bytes as reckoned.
- The engine in four gloo ranks (the tiny fp32 Llama, ``tests/
  test_torch_zero.py``'s recipe, 3 steps) against ``DeepSpeedTPUEngine``
  on a JAX mesh of the same shape: ``comm_compression`` over ``fsdp_out``
  under MiCS (int8 with error feedback and small buckets, plus
  ``sparse_gradients``; fp8 without error feedback) and over ``data``
  (int8, ``overlap`` false: one fused bucket, with qgZ, which it
  supersedes), and ``sparse_gradients`` alone. Losses and norms within
  rtol 1e-4, masters by ``test_torch_zeropp.block_wire_close`` (the port
  quantizes its blocks: ROADMAP Queue 3, divergence 39), the bucket plan
  equal to JAX's ``plan_buckets`` on the same block shapes, and the wire
  counters (quantized all-reduces, sparse all-gathers) exact.
- Compression without a replica axis warns and is off; under a memory
  tier it is off before that warning; the ``comm/overlap`` spans ride
  ``COMM_OVERLAP_TID``, their windows split by wire bytes.
- ``TiledLinear`` against the flax module, with ``split_tiled_weight``,
  in fp32 and bf16.
"""

import json
import math
import os
import sys
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from deepspeed_tpu.comm import compress as jcomp  # noqa: E402
from deepspeed_tpu.comm import mesh as jmesh  # noqa: E402
from deepspeed_tpu.runtime import sparse_tensor as jsparse  # noqa: E402
from deepspeed_tpu.runtime.zero import tiling as jtiling  # noqa: E402
from deepspeed_tpu_torch.comm import compress as tcomp  # noqa: E402
from deepspeed_tpu_torch.runtime import sparse_tensor as tsparse  # noqa: E402
from deepspeed_tpu_torch.runtime.zero import tiling as ttiling  # noqa: E402
from deepspeed_tpu_torch.testing import run_distributed  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_zeropp as zp  # noqa: E402
import torch_zeropp_ranks as zranks  # noqa: E402

SPAWN_TIMEOUT = 240


# ---------------------------------------------------------------------------
# the config group, the plan, the residual reshard
# ---------------------------------------------------------------------------
CONFIGS = [{}, {"enabled": True}, {"enabled": True, "wire_dtype": "fp8"},
           {"wire_dtype": "int4"}, {"chunk": 4}, {"chunk": 8},
           {"bucket_bytes": 0}, {"bucket_bytes": 1}, {"min_size": -1},
           {"min_size": 0, "overlap": False, "error_feedback": False},
           {"enabled": True, "unknown_key": 3}]


@pytest.mark.parametrize("raw", CONFIGS, ids=[str(i) for i in range(len(CONFIGS))])
def test_config_accepts_and_refuses_as_jax(raw):
    try:
        want = jcomp.CommCompressionConfig(**raw).model_dump()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tcomp.CommCompressionConfig.from_dict(raw)
        assert str(got.value) in str(e)
        return
    import dataclasses
    assert dataclasses.asdict(tcomp.CommCompressionConfig.from_dict(raw)) == \
        want


def _leaf_lists(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        n = int(rng.integers(1, 12))
        out.append([(f"p/{i}", tuple(int(x) for x in rng.integers(
            1, 300, size=int(rng.integers(0, 3))))) for i in range(n)])
    return out


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("cfg", [{}, {"bucket_bytes": 1000},
                                 {"bucket_bytes": 1, "chunk": 8},
                                 {"overlap": False, "wire_dtype": "fp8"}],
                         ids=["default", "1000B", "1B", "fused_fp8"])
def test_plan_buckets_matches_jax(world, cfg):
    jc = jcomp.CommCompressionConfig(**cfg)
    tc = tcomp.CommCompressionConfig.from_dict(cfg)
    for leaves in _leaf_lists(world):
        for itemsize in (2, 4):
            want = jcomp.plan_buckets(leaves, world, jc, itemsize=itemsize)
            got = tcomp.plan_buckets(leaves, world, tc, itemsize=itemsize)
            assert [tuple(b) for b in got] == [tuple(b) for b in want]


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


def test_grad_compressor_build_matches_jax():
    """``build`` on a nested parameter tree (JAX) and on its (path, shape,
    dtype) leaves in another order (port): the same buckets, in JAX's
    tree-flatten order, the same leaves skipped."""
    tree = {"model": {f"layer_{i}": {"w": np.zeros((40, 60 + i), np.float32),
                                     "s": np.zeros((64,), np.float32)}
                      for i in (0, 1, 2, 10, 11)},
            "embed": np.zeros((512, 16), np.float32),
            "ids": np.zeros((4096,), np.int32)}
    leaves = [("ids", (4096,), torch.int32), ("embed", (512, 16), torch.float32)]
    for i in (11, 10, 2, 1, 0):
        leaves += [(f"model/layer_{i}/s", (64,), torch.float32),
                   (f"model/layer_{i}/w", (40, 60 + i), torch.float32)]
    for cfg in ({"bucket_bytes": 10000, "min_size": 100},
                {"bucket_bytes": 1 << 20}, {"overlap": False, "min_size": 0}):
        for world in (2, 4):
            j = jcomp.GradCompressor(jcomp.CommCompressionConfig(**cfg),
                                     ("data",), _FakeMesh(data=world)).build(
                tree, exclude_paths=("embed",))
            t = tcomp.GradCompressor(tcomp.CommCompressionConfig.from_dict(
                cfg), ("data",), _FakeMesh(data=world)).build(
                leaves, exclude_paths=("embed",))
            assert t.bucket_summaries() == j.bucket_summaries()
            assert [b.paths for b in t.buckets] == [b.paths for b in j.buckets]
            assert t.ef_enabled() == j.ef_enabled()
            ef = t.zero_error_feedback()
            assert [(e.worker.shape[0], e.server.shape[0]) for e in ef] == \
                [(b.n_pad, b.n_pad // world) for b in t.buckets]


@pytest.mark.parametrize("case", [(4, 2, None), (4, 4, 2), (2, 3, None),
                                  (3, 2, 1), (4, 5, 3)])
def test_reshard_error_feedback_matches_jax(case):
    old, new, surviving = case
    rng = np.random.default_rng(old * 10 + new)
    n_pad = 768
    ef = jcomp.TensorEF(worker=rng.standard_normal((old, n_pad)).astype(
        np.float32), server=rng.standard_normal((old, n_pad // old)).astype(
        np.float32))
    want = jcomp.reshard_error_feedback(ef, new, surviving, xp=np)
    got = tcomp.reshard_error_feedback(tcomp.TensorEF(*ef), new, surviving,
                                       xp=np)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    torch_got = tcomp.reshard_error_feedback(
        tcomp.TensorEF(torch.from_numpy(ef.worker),
                       torch.from_numpy(ef.server)), new, surviving)
    for a, b in zip(torch_got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the sparse tensor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [3, 5, 8, 64])
def test_sparse_tensor_matches_jax_densified(k):
    g = zranks.sparse_inputs(0)
    j = jsparse.SparseTensor.from_dense(jnp.asarray(g), k)
    t = tsparse.SparseTensor.from_dense(torch.from_numpy(g), k)
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))
    assert t.sparse_size() == j.sparse_size()
    tt, jj = t.add(t), j.add(j)
    np.testing.assert_array_equal(tt.to_dense().numpy(),
                                  np.asarray(jj.to_dense()))
    assert t.indices.dtype == torch.int32


@pytest.fixture(scope="module")
def sparse_spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("sparse")
    run_distributed(zranks.sparse_body, 4, timeout=SPAWN_TIMEOUT, device="cpu",
                    env={"DSTPU_TEST_OUT": str(out)})
    rows = []
    for r in range(4):
        with open(out / f"sparse{r}.json") as f:
            rows.append((dict(np.load(out / f"sparse{r}.npz")), json.load(f)))
    return rows


def test_sparse_grad_sync_matches_jax(sparse_spawned):
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "fsdp"))
    g = np.stack([zranks.sparse_inputs(r) for r in range(4)])

    def run(axes, k):
        fn = jax.shard_map(
            lambda x: jsparse.sparse_grad_sync(x[0], axes, k)[None],
            mesh=mesh, in_specs=P(("data", "fsdp")),
            out_specs=P(("data", "fsdp")), check_vma=False)
        return np.asarray(jax.jit(fn)(jnp.asarray(g)))

    want = {"data": run(("data",), 8), "both": run(("data", "fsdp"), 5)}
    for r, (arrays, totals) in enumerate(sparse_spawned):
        for name in want:
            np.testing.assert_allclose(arrays[name], want[name][r],
                                       rtol=1e-6, atol=1e-7)
        # three recorded gathers: one over data (k = 8), two over both
        op = totals["sparse_all_gather"]
        assert op["count"] == 3
        assert op["bytes"] == 3 * 64 * 16 * 4
        assert op["wire_bytes"] == 8 * 17 * 4 + 5 * 17 * 4 + 10 * 17 * 4


# ---------------------------------------------------------------------------
# the engine across four ranks
# ---------------------------------------------------------------------------
MICS = {"mics_shard_size": 2}
FSDP4 = {"fsdp": 4, "data": 1}
SMALL = 64 << 10                       # bytes: several buckets at this size
CASES = {
    "mics_int8_ef_sparse": {
        "stage": 3, "zero": MICS, "mesh": FSDP4, "trace": True,
        "extra": {"comm_compression": {"enabled": True,
                                       "bucket_bytes": SMALL},
                  "sparse_gradients": True}},
    "mics_fp8_no_ef": {
        "stage": 3, "zero": MICS, "mesh": FSDP4,
        "extra": {"comm_compression": {"enabled": True, "wire_dtype": "fp8",
                                       "error_feedback": False,
                                       "bucket_bytes": SMALL}}},
    "data_fused_qgz": {
        "stage": 3, "mesh": {"data": 2, "fsdp": 2},
        "zero": {"zero_quantized_gradients": True},
        "extra": {"comm_compression": {"enabled": True, "overlap": False}}},
    "mics_sparse_only": {"stage": 3, "zero": MICS, "mesh": FSDP4,
                         "extra": {"sparse_gradients": True}},
    "no_replica_axis": {"stage": 3, "mesh": FSDP4,
                        "extra": {"comm_compression": {"enabled": True}}},
}
NAMES = list(CASES)
EMBED = "model/embed/embedding"
# the gradient norm after a wire quantized on other chunks than JAX's
# (divergence 39): int8's noise keeps it within 1e-4; e4m3's three mantissa
# bits move it 1.9e-4 (measured), held to 1e-3; a lost sum moves it ~30%
NORM_RTOL = {"int8": 1e-4, "fp8": 1e-3}


def _jax_mesh(sizes):
    full = {a: 1 for a in jmesh.MESH_AXES}
    full.update(sizes)
    return Mesh(np.array(jax.devices()[:4]).reshape(
        tuple(full[a] for a in jmesh.MESH_AXES)), jmesh.MESH_AXES)


_JAX = {}


def _jax(flax_params, name):
    if name not in _JAX:
        import deepspeed_tpu
        from deepspeed_tpu.models import llama as jllama
        case = CASES[name]
        sizes = {"fsdp_out": 2, "fsdp": 2} if "mics_shard_size" in \
            case.get("zero", {}) else {k: v for k, v in case["mesh"].items()}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            eng, *_ = deepspeed_tpu.initialize(
                model=jllama.LlamaForCausalLM(zp._jcfg()),
                config=zranks.case_config(case),
                model_parameters=flax_params, mesh=_jax_mesh(sizes))
        losses, norms = [], []
        for batch in zranks.base.zero_batches(zranks.ROWS):
            losses.append(float(eng.train_batch(batch=batch, stacked=True)))
            norms.append(eng.get_global_grad_norm())
        _JAX[name] = (losses, norms, zp._flat(jax.tree.map(
            np.asarray, eng.module_state_dict())), eng)
    return _JAX[name]


@pytest.fixture(scope="module")
def flax_params():
    from deepspeed_tpu.models import llama as jllama
    batch = jllama.random_tokens(1, 8, vocab_size=zp._jcfg().vocab_size)
    params = jllama.LlamaForCausalLM(zp._jcfg()).init(jax.random.PRNGKey(0),
                                                     batch)["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def spawned(flax_params, tmp_path_factory):
    out = tmp_path_factory.mktemp("compress")
    np.savez(out / "params.npz", **zp._flat(flax_params))
    run_distributed(zranks.cases_body, 4, timeout=SPAWN_TIMEOUT, device="cpu",
                    env={"DSTPU_TEST_OUT": str(out),
                         "DSTPU_TEST_CASES": json.dumps(
                             [CASES[n] for n in NAMES])})
    per_rank = []
    for r in range(4):
        with open(out / f"cases{r}.json") as f:
            meta = json.load(f)
        per_rank.append((meta, dict(np.load(out / f"cases{r}.npz"))))
    return per_rank


def _row(spawned, name, rank=0):
    return spawned[rank][0]["cases"][NAMES.index(name)]


def _sparse_wire(k, d):
    return k * 4 + k * d * 4            # int32 indices, fp32 values


@pytest.mark.parametrize("name", ["mics_int8_ef_sparse", "mics_fp8_no_ef",
                                  "data_fused_qgz", "mics_sparse_only"])
def test_engine_matches_jax_and_counts_its_wire(spawned, flax_params, name):
    jl, jn, jm, eng = _jax(flax_params, name)
    row = _row(spawned, name)
    case = CASES[name]
    ccfg = case["extra"].get("comm_compression")
    np.testing.assert_allclose(row["losses"], jl, rtol=1e-4)
    np.testing.assert_allclose(row["norms"], jn, rtol=NORM_RTOL[
        (ccfg or {}).get("wire_dtype", "int8")])
    zp.block_wire_close(zp._masters(spawned[0][1], NAMES.index(name)), jm)
    replica = ["fsdp_out"] if "mics_shard_size" in case.get("zero", {}) \
        else ["data"]
    assert row["replica_axes"] == replica == row["wire_axes"]
    sparse = case["extra"].get("sparse_gradients", False)
    assert row["sparse_paths"] == ([EMBED] if sparse else [])
    if sparse:
        assert list(eng._sparse_grad_paths) == [EMBED]
    for step in row["per_step"]:
        sag = step.get("sparse_all_gather", {"count": 0})
        if sparse:
            # k = gas x (8 rows / 2 replicas) x 16 tokens = 128 rows of the
            # [256, 128] block (MiCS: half the vocabulary a rank)
            assert sag == {"count": 1, "bytes": 256 * 128 * 4,
                           "wire_bytes": _sparse_wire(128, 128)}
        else:
            assert sag["count"] == 0
        qar = step.get("quantized_all_reduce", {"count": 0})
        if ccfg is None:
            assert qar["count"] == 0
            continue
        buckets = row["buckets"]
        assert qar == {"count": len(buckets),
                       "bytes": sum(b["bytes"] for b in buckets),
                       "wire_bytes": sum(b["wire_bytes"] for b in buckets)}
    if ccfg is None:
        return
    # the port's plan is JAX's plan_buckets on the blocks it reduces
    world = 2
    want = jcomp.plan_buckets([(p, tuple(s)) for p, s in row["plan"]], world,
                              jcomp.CommCompressionConfig(**ccfg))
    assert row["buckets"] == [{"index": b.index, "leaves": len(b.paths),
                               "n": b.n, "n_pad": b.n_pad,
                               "bytes": b.logical_bytes,
                               "wire_bytes": b.wire_bytes} for b in want]
    # JAX's trace-time plan is on the whole leaves (divergence 39)
    jsum = sum(b["n"] for b in eng._comm_compress.bucket_summaries())
    assert jsum >= sum(b["n"] for b in row["buckets"])
    if ccfg.get("error_feedback", True):
        assert row["ef_shapes"] == [[[b["n_pad"]], [b["n_pad"] // world]]
                                    for b in row["buckets"]]
    else:
        assert not row["ef_enabled"]
    if ccfg.get("overlap", True) is False:
        assert len(row["buckets"]) == 1
    for meta, _ in spawned[1:]:
        other = meta["cases"][NAMES.index(name)]
        assert (other["losses"], other["norms"]) == (row["losses"],
                                                     row["norms"])


def test_compression_supersedes_qgz(spawned):
    row = _row(spawned, "data_fused_qgz")
    assert row["qgz_axes"] == [] and row["quantized_gradients"] is False
    assert row["per_step"][0]["quantized_all_reduce"]["count"] == 1


def test_no_replica_axis_warns_and_disables(spawned):
    row = _row(spawned, "no_replica_axis")
    assert row["buckets"] is None and row["wire_axes"] == []
    assert any("comm_compression enabled but the mesh has NO replica batch "
               "axis" in w for w in row["warnings"])
    assert "quantized_all_reduce" not in row["per_step"][0]


def test_memory_tiers_disable_it_first():
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama as tllama
    cfg = zranks.base.zero_config(0, {}, rows=4)
    cfg["zero_optimization"]["offload_optimizer"] = {"device": "cpu"}
    cfg["comm_compression"] = {"enabled": True}
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no "no replica axis" warning
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=tllama.LlamaForCausalLM(zranks.base.tiny_fp32(),
                                          device="cpu"),
            config=cfg, device="cpu")
    assert eng._comm_compress is None and eng._wire_axes == ()


def test_overlap_spans_ride_comm_overlap_tid(spawned):
    from deepspeed_tpu_torch.telemetry.tracer import COMM_OVERLAP_TID
    from deepspeed_tpu.telemetry.tracer import COMM_OVERLAP_TID as JTID
    assert COMM_OVERLAP_TID == JTID
    row = _row(spawned, "mics_int8_ef_sparse")
    spans = row["overlap_spans"]
    buckets = row["buckets"]
    assert len(buckets) > 1 and len(spans) == 3 * len(buckets)
    assert all(tid == COMM_OVERLAP_TID for tid, *_ in spans)
    assert [b for _, b, _, _ in spans] == 3 * [b["index"] for b in buckets]
    first = spans[:len(buckets)]
    total_wire = sum(w for _, _, w, _ in first)
    window = sum(d for *_, d in first)
    for _, _, w, d in first:
        assert math.isclose(d, window * w / total_wire, rel_tol=1e-9)
    assert _row(spawned, "data_fused_qgz")["overlap_spans"] == []


# ---------------------------------------------------------------------------
# TiledLinear
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [(1, 1), (2, 3), (4, 2)])
def test_tiled_linear_matches_flax(dtype, splits):
    in_s, out_s = splits
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    full = rng.standard_normal((48, 36)).astype(np.float32) * 0.1
    bias = rng.standard_normal(36).astype(np.float32)
    mod = jtiling.TiledLinear(features=36, in_splits=in_s, out_splits=out_s,
                              dtype=jdt)
    params = {"kernel": jtiling.split_tiled_weight(jnp.asarray(full), in_s,
                                                   out_s),
              "bias": jnp.asarray(bias)}
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x))
                      .astype(jnp.float32))
    tmod = ttiling.TiledLinear(48, 36, in_s, out_s, dtype=tdt)
    kernel = ttiling.split_tiled_weight(torch.from_numpy(full), in_s, out_s)
    np.testing.assert_array_equal(kernel.numpy(), np.asarray(params["kernel"]))
    with torch.no_grad():
        tmod.kernel.copy_(kernel)
        tmod.bias.copy_(torch.from_numpy(bias))
    got = tmod(torch.from_numpy(x))
    assert got.dtype == tdt and got.shape == (3, 5, 36)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().detach().numpy(), want,
                               rtol=tol, atol=tol)
    init = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    assert {k: v.shape for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in tmod.named_parameters()}
