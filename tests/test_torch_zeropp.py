"""Port parity: the hierarchical ZeRO world (MiCS, ZeRO++ hpZ and qwZ).

- The placement functions: ``secondary_partition_spec`` over many specs,
  and the MiCS param and optimizer-state specs (``build_param_specs`` /
  ``leaf_specs`` with ``mics=True``) over many shapes, stages and
  hierarchical worlds, equal to the JAX package's.
- The engine: the tiny Llama in fp32 with ``tests/test_torch_zero.py``'s
  recipe, 3 ``train_batch`` steps in four gloo ranks (``mesh.fsdp`` = 4,
  which the engine splits into ``fsdp_out`` 2 x ``fsdp`` 2) against
  ``DeepSpeedTPUEngine(..., mesh=)`` on a JAX mesh of the same shape over
  4 of the 8 CPU devices: MiCS at stages 1, 2 and 3 and hpZ at stage 3
  within 1e-5 (masters) and rtol 1e-4 (losses, norms); hpZ + qwZ with each
  rank's first-step secondary blocks bit for bit JAX's ``_qwz_regather``
  of the same leaf (fp32), losses and norms within rtol 1e-4, and masters
  by the qgZ criterion of ``test_torch_zero.py`` (once the masters differ
  by rounding, a weight on a code boundary flips its int8 code); MiCS +
  qgZ over ``fsdp_out`` with losses and norms within rtol 1e-4 and the
  masters by ``block_wire_close`` (the port quantizes its block, JAX the
  whole leaf: ROADMAP Queue 3, divergence 39).
- The refusals and warnings: MiCS with hpZ, a split the group does not
  divide, ``mesh.fsdp`` of -1, qwZ without hpZ (ignored), a memory tier
  over ranks, and the options still unported naming their item.
- Planted faults, run as cases in the same ranks, that must fail the
  criteria: qwZ with each block's own row scales, MiCS without the sum
  over ``fsdp_out``, hpZ without its second (``fsdp_out``) hop.
"""

import dataclasses
import json
import os
import sys
import warnings

import numpy as np
import pytest

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

import deepspeed_tpu  # noqa: E402
from deepspeed_tpu.comm import mesh as jmesh  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu.runtime import engine as jengine  # noqa: E402
from deepspeed_tpu.runtime.zero import partition as jpart  # noqa: E402
from deepspeed_tpu_torch.comm import mesh as tmesh  # noqa: E402
from deepspeed_tpu_torch.config.config import (DeepSpeedTPUConfig,  # noqa: E402
                                               MeshConfig)
from deepspeed_tpu_torch.runtime.zero import partition as tpart  # noqa: E402
from deepspeed_tpu_torch.testing import run_distributed  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import torch_zeropp_ranks as zranks  # noqa: E402

SPAWN_TIMEOUT = 240
W = 4
MICS = {"mics_shard_size": 2}
HPZ = {"zero_hpz_partition_size": 2}
QWZ = {**HPZ, "zero_quantized_weights": True}
FSDP4 = {"fsdp": 4, "data": 1}
CASES = {
    "mics_s1": {"stage": 1, "zero": MICS, "mesh": FSDP4},
    "mics_s2": {"stage": 2, "zero": MICS, "mesh": FSDP4},
    "mics_s3": {"stage": 3, "zero": MICS, "mesh": FSDP4},
    "hpz_s3": {"stage": 3, "zero": HPZ, "mesh": FSDP4},
    "qwz_s3": {"stage": 3, "zero": QWZ, "mesh": FSDP4, "keep_copy": True},
    "mics_qgz_s3": {"stage": 3, "mesh": FSDP4,
                    "zero": {**MICS, "zero_quantized_gradients": True}},
    "qwz_without_hpz": {"stage": 3, "mesh": FSDP4,
                        "zero": {"zero_quantized_weights": True}},
    "mutant_local_row_scales": {"stage": 3, "zero": QWZ, "mesh": FSDP4,
                                "keep_copy": True,
                                "mutant": "local_row_scales"},
    "mutant_mics_no_fsdp_out_sum": {"stage": 3, "zero": MICS, "mesh": FSDP4,
                                    "mutant": "mics_no_fsdp_out_sum"},
    "mutant_hpz_no_second_hop": {"stage": 3, "zero": HPZ, "mesh": FSDP4,
                                 "mutant": "hpz_no_second_hop"},
}
NAMES = list(CASES)
JAX_OF = {"mics_s1": "mics_s1", "mics_s2": "mics_s2", "mics_s3": "mics_s3",
          "hpz_s3": "hpz_s3", "qwz_s3": "qwz_s3",
          "mics_qgz_s3": "mics_qgz_s3",
          "mutant_mics_no_fsdp_out_sum": "mics_s3",
          "mutant_hpz_no_second_hop": "hpz_s3"}


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
SPECS = [(), (None,), ("fsdp",), ("fsdp_out",), (("fsdp_out", "fsdp"),),
         (None, ("fsdp_out", "fsdp")), (("fsdp_out", "fsdp"), None, None),
         ("expert", ("fsdp_out", "fsdp"), None), (("tensor", "fsdp"), None),
         (("tensor", "fsdp_out", "fsdp"),), ("tensor", "fsdp"),
         ("data", None), (None, "sequence", ("fsdp_out", "fsdp"))]


@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_secondary_partition_spec_matches_jax(spec):
    want = tuple(jpart.secondary_partition_spec(P(*spec)))
    assert tpart.secondary_partition_spec(spec) == want
    assert tpart.build_secondary_specs([spec, spec]) == [want, want]


SHAPES = [(4096,), (8,), (64, 32), (2048, 1), (1000, 7), (512, 128),
          (128, 4, 32), (4, 32, 128), (128256, 4096), (14336, 4096),
          (4096, 14336), (3, 5, 7), (6, 6, 64), (2, 2048), (2047,), (512,)]
MESHES = [dict(fsdp_outer=2, fsdp=2), dict(fsdp_outer=2, fsdp=4),
          dict(fsdp_outer=4, fsdp=2), dict(data=2, fsdp_outer=2, fsdp=2),
          dict(fsdp_outer=2, fsdp=3), dict(fsdp_outer=8, fsdp=1)]


def _meshes(sizes):
    w = int(np.prod(list(sizes.values())))
    full = tmesh.resolve_axis_sizes(MeshConfig(**sizes), w)
    jm = Mesh(np.array(jax.devices()[:w]).reshape(
        tuple(full[a] for a in jmesh.MESH_AXES)), jmesh.MESH_AXES)
    tm = tmesh.Mesh.__new__(tmesh.Mesh)
    tm.shape = dict(full)
    return tm, jm


@pytest.mark.parametrize("sizes", MESHES, ids=[str(m) for m in MESHES])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_mics_specs_match_jax(sizes, stage):
    tm, jm = _meshes(sizes)
    for mics in (True, False):
        assert tpart.zero_fsdp_axes(tm, mics=mics) == \
            jpart.zero_fsdp_axes(jm, mics=mics)
    shapes = {f"l{i}": s for i, s in enumerate(SHAPES)}
    got = tpart.build_param_specs(shapes, tm, stage, mics=True)
    jsh = jpart.build_param_shardings(
        {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()},
        jm, stage, mics=True)
    want = {k: tuple(v.spec) for k, v in jsh.items()}
    assert got == want
    axes, size = jpart.zero_fsdp_axes(jm, mics=True)
    spec_of = jpart.optimizer_state_spec_fn(None, stage, size,
                                            fsdp_axes=axes)
    specs = tpart.leaf_specs(shapes, tm, stage, mics=True)
    assert dict(zip(shapes, specs["param"])) == want
    assert specs["opt"] == [tuple(spec_of(P(*want[k]), s))
                            for k, s in shapes.items()]


# ---------------------------------------------------------------------------
# the engine across four ranks
# ---------------------------------------------------------------------------
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + "/") if isinstance(v, dict) else {name: v})
    return out


def _jcfg():
    return dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               attention_backend="xla")


@pytest.fixture(scope="module")
def flax_params():
    batch = jllama.random_tokens(1, 8, vocab_size=_jcfg().vocab_size)
    params = jllama.LlamaForCausalLM(_jcfg()).init(jax.random.PRNGKey(0),
                                                  batch)["params"]
    return jax.tree.map(np.asarray, params)


def _jax_mesh(case):
    full = {a: 1 for a in jmesh.MESH_AXES}
    full.update(fsdp_out=2, fsdp=2)
    return Mesh(np.array(jax.devices()[:W]).reshape(
        tuple(full[a] for a in jmesh.MESH_AXES)), jmesh.MESH_AXES)


def jax_run(flax_params, case):
    """The JAX engine on a fsdp_out=2 x fsdp=2 mesh under ``case``'s
    config: losses, norms, masters by ``/`` path, the engine."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng, *_ = deepspeed_tpu.initialize(
            model=jllama.LlamaForCausalLM(_jcfg()),
            config=zranks.case_config(case), model_parameters=flax_params,
            mesh=_jax_mesh(case))
    losses, norms = [], []
    for batch in zranks.base.zero_batches(zranks.ROWS):
        losses.append(float(eng.train_batch(batch=batch, stacked=True)))
        norms.append(eng.get_global_grad_norm())
    return losses, norms, _flat(jax.tree.map(np.asarray,
                                             eng.module_state_dict())), eng


_JAX = {}


def _jax(flax_params, name):
    if name not in _JAX:
        _JAX[name] = jax_run(flax_params, CASES[name])
    return _JAX[name]


@pytest.fixture(scope="module")
def spawned(flax_params, tmp_path_factory):
    out = tmp_path_factory.mktemp("zeropp")
    np.savez(out / "params.npz", **_flat(flax_params))
    run_distributed(zranks.cases_body, W, timeout=SPAWN_TIMEOUT,
                    device="cpu",
                    env={"DSTPU_TEST_OUT": str(out),
                         "DSTPU_TEST_CASES": json.dumps(
                             [CASES[n] for n in NAMES])})
    per_rank = []
    for r in range(W):
        with open(out / f"cases{r}.json") as f:
            meta = json.load(f)
        per_rank.append((meta, dict(np.load(out / f"cases{r}.npz"))))
    return per_rank


def _masters(arrays, k):
    return {n.split("/", 2)[2].replace(".", "/"): v
            for n, v in arrays.items() if n.startswith(f"{k}/m/")}


def _row(spawned, name, rank=0):
    return spawned[rank][0]["cases"][NAMES.index(name)]


def _close(got, want, atol=1e-5):
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=atol, rtol=1e-5,
                                   err_msg=name)


def _qgz_close(got, want, steps=3, lr=1e-3):
    diffs = np.concatenate([np.abs(got[n] - w).ravel()
                            for n, w in want.items()])
    assert diffs.max() <= 2 * lr * steps + 1e-6
    assert np.mean(diffs > 1e-5) <= 1e-3


def block_wire_close(got, want, steps=3, lr=1e-3):
    """The criterion of a wire quantized on the port's blocks (ROADMAP
    Queue 3, divergence 39): JAX quantizes each leaf at its full ``fsdp``
    extent, so the chunks, their scales and every element's rounding
    differ, not a few codes. No element beyond 2 lr a step, at most 1% of
    them beyond a tenth of lr (measured: 0.12% for MiCS + qgZ)."""
    diffs = np.concatenate([np.abs(got[n] - w).ravel()
                            for n, w in want.items()])
    assert diffs.max() <= 2 * lr * steps + 1e-6
    assert np.mean(diffs > 0.1 * lr) <= 1e-2


@pytest.mark.parametrize("name", ["mics_s1", "mics_s2", "mics_s3", "hpz_s3"])
def test_mics_and_hpz_match_the_jax_engine(spawned, flax_params, name):
    jl, jn, jm, eng = _jax(flax_params, name)
    row = _row(spawned, name)
    np.testing.assert_allclose(row["losses"], jl, rtol=1e-4)
    np.testing.assert_allclose(row["norms"], jn, rtol=1e-4)
    _close(_masters(spawned[0][1], NAMES.index(name)), jm)
    assert row["mesh"]["fsdp_out"] == 2 and row["mesh"]["fsdp"] == 2
    assert row["zero_axes"] == (["fsdp"] if name.startswith("mics")
                                else ["fsdp_out", "fsdp"])
    assert row["replica_axes"] == list(eng._replica_axes)
    for meta, _ in spawned[1:]:             # every rank the same result
        other = meta["cases"][NAMES.index(name)]
        assert (other["losses"], other["norms"]) == (row["losses"],
                                                     row["norms"])


def test_what_each_rank_holds(spawned):
    """MiCS at stage 3 holds half of each sharded leaf, hpZ a quarter;
    below stage 3 the masters are whole."""
    full = _row(spawned, "mics_s1")["held"]
    s3 = _row(spawned, "mics_s3")["held"]
    h3 = _row(spawned, "hpz_s3")["held"]
    small = 128 * 5                       # the norm scales, whole
    assert _row(spawned, "mics_s2")["held"] == full
    assert s3 == (full - small) // 2 + small
    assert h3 == (full - small) // 4 + small


def _jax_regather(flax_params, eng):
    """JAX's ``_qwz_regather`` of every leaf the JAX engine quantizes
    (the compute copy is fp32 here: the leaf itself)."""
    flat = _flat(flax_params)
    prim = _flat(jax.tree.map(lambda s: s, eng.param_shardings,
                              is_leaf=lambda x: isinstance(x, NamedSharding)))
    sec = _flat(jax.tree.map(lambda s: s, eng._secondary_shardings,
                             is_leaf=lambda x: isinstance(x, NamedSharding)))
    out = {}
    for path, leaf in flat.items():
        if leaf.ndim < 2 or prim[path].spec == sec[path].spec:
            continue
        spec = sec[path].spec
        s_spec = P(*(list(spec)[:leaf.ndim - 1] + [None]))
        fn = jax.jit(lambda x, s=sec[path], ss=NamedSharding(
            eng.mesh, s_spec): jengine._qwz_regather(x, s, ss))
        out[path] = (np.asarray(fn(jnp.asarray(leaf))), spec)
    return out


def _secondary_block(full, spec, rank):
    """Rank ``rank``'s block of ``full`` under the secondary spec: its
    ``fsdp`` coordinate's block along the dimension ``fsdp`` shards."""
    dim = [i for i, e in enumerate(spec) if e is not None][0]
    f = rank % 2
    n = full.shape[dim] // 2
    return np.take(full, np.arange(f * n, (f + 1) * n), axis=dim)


def _copy_mismatches(spawned, name, want):
    k = NAMES.index(name)
    bad = []
    for r, (_, arrays) in enumerate(spawned):
        copy = {n.split("/", 2)[2].replace(".", "/"): v
                for n, v in arrays.items() if n.startswith(f"{k}/c/")}
        assert copy.keys() == want.keys(), (sorted(copy), sorted(want))
        for path, (full, spec) in want.items():
            block = _secondary_block(full, spec, r)
            if not np.array_equal(copy[path].view(np.uint32),
                                  block.view(np.uint32)):
                bad.append((r, path))
    return bad


def test_qwz_regather_bit_for_bit_and_masters(spawned, flax_params):
    jl, jn, jm, eng = _jax(flax_params, "qwz_s3")
    want = _jax_regather(flax_params, eng)
    # every sharded leaf of >= 2 dims, some cut along their last axis
    assert len(want) == 2 + 7 * 2
    assert any(spec[-1] is not None for _, spec in want.values())
    assert _copy_mismatches(spawned, "qwz_s3", want) == []
    row = _row(spawned, "qwz_s3")
    assert row["quantized_weights"]
    np.testing.assert_allclose(row["losses"], jl, rtol=1e-4)
    np.testing.assert_allclose(row["norms"], jn, rtol=1e-4)
    # after step 1 the masters differ by the summation order's rounding,
    # and a weight on a rounding boundary of its int8 code then flips a
    # code, as a qgZ gradient does: the qgZ criterion
    _qgz_close(_masters(spawned[0][1], NAMES.index("qwz_s3")), jm)


def test_mics_qgz_over_fsdp_out(spawned, flax_params):
    jl, jn, jm, _ = _jax(flax_params, "mics_qgz_s3")
    row = _row(spawned, "mics_qgz_s3")
    assert row["qgz_axes"] == ["fsdp_out"] == row["wire_axes"]
    np.testing.assert_allclose(row["losses"], jl, rtol=1e-4)
    np.testing.assert_allclose(row["norms"], jn, rtol=1e-4)
    block_wire_close(_masters(spawned[0][1], NAMES.index("mics_qgz_s3")), jm)
    qar = row["per_step"][0]["quantized_all_reduce"]
    assert qar["count"] > 0 and qar["wire_bytes"] < qar["bytes"] / 3


def test_planted_faults_fail(spawned, flax_params):
    """Each fault, planted in these processes for its case, lands outside
    the criterion its healthy twin meets."""
    jl, jn, jm, eng = _jax(flax_params, "qwz_s3")
    bad = _copy_mismatches(spawned, "mutant_local_row_scales",
                           _jax_regather(flax_params, eng))
    assert bad and all(r in range(W) for r, _ in bad)
    for name in ("mutant_mics_no_fsdp_out_sum", "mutant_hpz_no_second_hop"):
        _, jn, jm, _ = _jax(flax_params, JAX_OF[name])
        row = _row(spawned, name)
        rel = abs(row["norms"][0] - jn[0]) / jn[0]
        assert rel > 1e-2, (name, rel)
        with pytest.raises(AssertionError):
            _close(_masters(spawned[0][1], NAMES.index(name)), jm)


def test_qwz_without_hpz_is_ignored(spawned):
    row = _row(spawned, "qwz_without_hpz")
    assert row["quantized_weights"] is False
    assert row["zero_axes"] == ["fsdp_out", "fsdp"] or \
        row["mesh"]["fsdp"] == 4


def test_refusals_and_warnings(spawned):
    ref = spawned[0][0]["refusals"]
    assert ref["mics_and_hpz"].startswith("ValueError: mics_shard_size and "
                                          "zero_hpz_partition_size are "
                                          "mutually exclusive")
    assert ref["indivisible"] == ("ValueError: fsdp=4 not divisible by "
                                  "shard group 3")
    assert ref["fsdp_fill"] == ("ValueError: MiCS/hpZ needs an explicit "
                                "mesh.fsdp size to split")
    assert "Queue 1 item 2" in ref["offload_under_mics"]


PARSED = [
    ({"zero_optimization": {"mics_shard_size": 2}}, "mics_shard_size", 2),
    ({"zero_optimization": {"zero_hpz_partition_size": 2}},
     "zero_hpz_partition_size", 2),
    ({"zero_optimization": {"zero_quantized_weights": True}},
     "zero_quantized_weights", True),
]


@pytest.mark.parametrize("raw,key,value", PARSED, ids=[k for _, k, _ in PARSED])
def test_hierarchical_options_parse(raw, key, value):
    cfg = DeepSpeedTPUConfig(raw)
    assert getattr(cfg.zero_config, key) == value
    assert DeepSpeedTPUConfig({"mesh": {"fsdp_outer": 2}}).mesh.fsdp_outer == 2


# the tensor axis is ported (tests/test_torch_tp.py); under the
# hierarchical world it still waits
STILL_REFUSED = [({"mesh": {"tensor": 2, "fsdp": 4},
                   "zero_optimization": {"stage": 3,
                                         "mics_shard_size": 2}},
                  "tensor-parallel blocks"),
                 ({"mesh": {"pipe": 2}}, "item 7"),
                 ({"mesh": {"dcn_axes": ["data"]}}, "dcn_axes"),
                 ({"mesh": {"sequence": 2}, "sparse_gradients": True},
                  "item 3: sequence parallel"),
                 ({"mesh": {"sequence": 2},
                   "comm_compression": {"enabled": True}},
                  "item 3: sequence parallel")]


@pytest.mark.parametrize("raw,match", STILL_REFUSED,
                         ids=[str(i) for i in range(len(STILL_REFUSED))])
def test_still_unported_options_name_their_item(raw, match):
    with pytest.raises(NotImplementedError, match=match) as e:
        DeepSpeedTPUConfig(raw)
    assert "ROADMAP Queue 1 item" in str(e.value)
