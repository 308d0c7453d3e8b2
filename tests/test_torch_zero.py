"""Port parity: ZeRO stages 1-3 and qgZ over ranks against the JAX engine.

- The placement functions over many shapes, stages and worlds:
  ``param_partition_spec``, ``optimizer_state_spec_fn``, ``zero_fsdp_axes``,
  ``zero_placement`` and ``replica_grad_axes`` give the JAX package's specs
  (the port's spec is the ``PartitionSpec``'s tuple).
- The engine: the tiny Llama in fp32 with the fp32 trajectory recipe of
  ``tests/test_torch_train.py`` (gas 2, AdamW with decay, clipping,
  WarmupLR), 3 ``train_batch`` steps on the same global batches, in gloo
  ranks spawned by ``deepspeed_tpu_torch.testing.run_distributed`` against
  ``DeepSpeedTPUEngine(..., mesh=)`` on an explicit JAX mesh over the first
  W of the 8 CPU devices: stages 1, 2, 3 at fsdp=2 (W=2) and at data=2 x
  fsdp=2 (W=4), and qgZ (int8 on the wire over the replica axis) at
  data=2. Masters within atol/rtol 1e-5 of the JAX engine's and of the
  port's stage 0 on one rank, losses and gradient norms within rtol 1e-4,
  the same on every rank. Under qgZ an int8 code may differ by one step
  where the two sides' fp32 gradients (summed in other orders) straddle a
  rounding boundary, so at most 0.1% of the elements may lie beyond 1e-5,
  none beyond 2 lr per step (the one-rank qgZ case's criterion).
- What each rank holds: under stage 3 half of every sharded leaf and of
  its moments, under stages 1-2 the full masters and half the moments.
- The refusals: every option the slice leaves out raises
  ``NotImplementedError`` naming its ROADMAP item, the memory tiers with
  the ``expert`` axis, a ``sequence`` axis or MiCS included.
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

import deepspeed_tpu  # noqa: E402
from deepspeed_tpu.comm import mesh as jmesh  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu.runtime.zero import partition as jpart  # noqa: E402
from deepspeed_tpu.runtime.zero import qgz as jqgz  # noqa: E402
from deepspeed_tpu_torch.comm import mesh as tmesh  # noqa: E402
from deepspeed_tpu_torch.config.config import (DeepSpeedTPUConfig,  # noqa: E402
                                               MeshConfig)
from deepspeed_tpu_torch.runtime.zero import partition as tpart  # noqa: E402
from deepspeed_tpu_torch.runtime.zero import qgz as tqgz  # noqa: E402
from deepspeed_tpu_torch.testing import run_distributed  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402

SPAWN_TIMEOUT = 120
# qgZ: over the replica axis data=2; at stage 2 and fsdp=2 over fsdp (no
# parameter is sharded there); at stage 3 and fsdp=2 with no replica axis,
# the int8 round trip of the reduced gradients (blocks split along their
# last axis gathered first)
W2_CASES = [[1, {"fsdp": 2, "data": 1}, False], [2, {"fsdp": 2, "data": 1}, False],
            [3, {"fsdp": 2, "data": 1}, False], [2, {"data": 2}, True],
            [2, {"fsdp": 2, "data": 1}, True], [3, {"fsdp": 2, "data": 1}, True]]
W4_CASES = [[1, {"data": 2, "fsdp": 2}, False], [2, {"data": 2, "fsdp": 2}, False],
            [3, {"data": 2, "fsdp": 2}, False]]


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
SHAPES = [(4096,), (8,), (64, 32), (2048, 1), (1000, 7), (7, 1000), (512, 128),
          (128, 4, 32), (4, 32, 128), (128256, 4096), (14336, 4096),
          (4096, 14336), (3, 5, 7), (6, 6, 64), (2, 2048), (2047,)]


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_partition_specs_match_jax(stage, world):
    for shape in SHAPES:
        for mss in (jpart.DEFAULT_MIN_SHARD_SIZE, 16):
            want = jpart.param_partition_spec(shape, stage, world,
                                              min_shard_size=mss)
            got = tpart.param_partition_spec(shape, stage, world,
                                             min_shard_size=mss)
            assert got == tuple(want), (shape, stage, world)
            jfn = jpart.optimizer_state_spec_fn(None, stage, world, mss)
            tfn = tpart.optimizer_state_spec_fn(None, stage, world, mss)
            assert tfn(got, shape) == tuple(jfn(want, shape)), shape
            assert tpart._choose_fsdp_dim(shape, world, set()) == \
                jpart._choose_fsdp_dim(shape, world, set())
        for axes in (("fsdp",), ("fsdp_out", "fsdp")):
            assert tpart.param_partition_spec(shape, stage, world,
                                              fsdp_axes=axes) == \
                tuple(jpart.param_partition_spec(shape, stage, world,
                                                 fsdp_axes=axes))


@pytest.mark.parametrize("sizes", [dict(fsdp=2, data=1), dict(data=2, fsdp=2),
                                   dict(data=4), dict(fsdp=4, data=1),
                                   dict(data=2, fsdp=4)])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_axes_placement_and_replica_axes_match_jax(sizes, stage):
    w = int(np.prod(list(sizes.values())))
    full = tmesh.resolve_axis_sizes(MeshConfig(**sizes), w)
    jm = Mesh(np.array(jax.devices()[:w]).reshape(
        tuple(full[a] for a in jmesh.MESH_AXES)), jmesh.MESH_AXES)
    tm = tmesh.Mesh.__new__(tmesh.Mesh)
    tm.shape = dict(full)
    assert tpart.zero_fsdp_axes(tm) == jpart.zero_fsdp_axes(jm)
    assert tpart.zero_placement(full, stage, "cpu") == \
        jpart.zero_placement(dict(jm.shape), stage, "cpu")
    axes, world = tpart.zero_fsdp_axes(tm)
    tspecs = [tpart.param_partition_spec(s, stage, world, fsdp_axes=axes)
              for s in SHAPES]
    jshard = [NamedSharding(jm, P(*jpart.param_partition_spec(
        s, stage, world, fsdp_axes=axes))) for s in SHAPES]
    assert tqgz.replica_grad_axes(tm, tmesh.BATCH_AXES, tspecs) == \
        jqgz.replica_grad_axes(jm, P(jmesh.BATCH_AXES), jshard)


def test_quantized_leaves_counts_the_sync_wire_test():
    """``quantized_leaves`` counts the leaves ``quantized_grad_sync``
    quantizes: 2-D and larger, >= MIN_QUANT_SIZE, a wire that beats the
    dense payload."""
    shapes = [(4096,), (64, 32), (8, 256), (128, 4, 32), (2, 2048), (4, 512)]
    assert tqgz.quantized_leaves(shapes, 2, 4) == 5
    assert tqgz.quantized_leaves([(2, 1025)], 8, 2) == 0   # padding loses
    assert tqgz.MIN_QUANT_SIZE == jqgz.MIN_QUANT_SIZE


# ---------------------------------------------------------------------------
# the engine across ranks
# ---------------------------------------------------------------------------
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + "/") if isinstance(v, dict) else {name: v})
    return out


@pytest.fixture(scope="module")
def flax_params():
    jcfg = ranks_jcfg()
    batch = jllama.random_tokens(1, 8, vocab_size=jcfg.vocab_size)
    params = jllama.LlamaForCausalLM(jcfg).init(jax.random.PRNGKey(0),
                                               batch)["params"]
    return jax.tree.map(np.asarray, params)


def ranks_jcfg():
    import dataclasses
    import jax.numpy as jnp
    return dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               attention_backend="xla")


def _jax_run(flax_params, stage, sizes, qgz):
    w = int(np.prod(list(sizes.values())))
    full = {a: sizes.get(a, 1) for a in jmesh.MESH_AXES}
    mesh = Mesh(np.array(jax.devices()[:w]).reshape(
        tuple(full[a] for a in jmesh.MESH_AXES)), jmesh.MESH_AXES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        eng, *_ = deepspeed_tpu.initialize(
            model=jllama.LlamaForCausalLM(ranks_jcfg()),
            config=ranks.zero_config(stage, sizes, qgz, rows=2 * w),
            model_parameters=flax_params, mesh=mesh)
    losses, norms = [], []
    for batch in ranks.zero_batches(2 * w):
        losses.append(float(eng.train_batch(batch=batch, stacked=True)))
        norms.append(eng.get_global_grad_norm())
    return losses, norms, _flat(jax.tree.map(np.asarray,
                                             eng.module_state_dict()))


_WORLD1 = {}


def _port_world1(flax_params, rows):
    """The port's stage 0 on one rank at a global batch of ``rows``."""
    if rows not in _WORLD1:
        losses, norms, masters, _ = ranks.run_engine(
            0, {}, params=flax_params, rows=rows)
        _WORLD1[rows] = (losses, norms, {k.replace(".", "/"): v
                                         for k, v in masters.items()})
    return _WORLD1[rows]


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def spawned(request, flax_params, tmp_path_factory):
    w = request.param
    cases = W2_CASES if w == 2 else W4_CASES
    out = tmp_path_factory.mktemp(f"zero{w}")
    np.savez(out / "params.npz", **_flat(flax_params))
    run_distributed(ranks.zero_body, w, timeout=SPAWN_TIMEOUT, device="cpu",
                    env={"DSTPU_TEST_OUT": str(out),
                         "DSTPU_TEST_CASES": json.dumps(cases)})
    per_rank = []
    for r in range(w):
        with open(out / f"zero{r}.json") as f:
            meta = json.load(f)
        arrays = dict(np.load(out / f"zero{r}.npz"))
        per_rank.append((meta, arrays))
    return w, cases, per_rank


def _masters(arrays, k):
    return {name.split("/", 1)[1].replace(".", "/"): v
            for name, v in arrays.items() if name.startswith(f"{k}/")}


def _close(got, want, qgz):
    assert got.keys() == want.keys()
    if not qgz:
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, atol=1e-5, rtol=1e-5,
                                       err_msg=name)
        return
    diffs = np.concatenate([np.abs(got[n] - w).ravel() for n, w in want.items()])
    assert diffs.max() <= 2 * 1e-3 * ranks.ZERO_STEPS + 1e-6
    assert np.mean(diffs > 1e-5) <= 1e-3


def test_stages_match_the_jax_engine_and_world1(spawned, flax_params):
    w, cases, per_rank = spawned
    l1, n1, m1 = _port_world1(flax_params, 2 * w)
    for k, (stage, sizes, qgz) in enumerate(cases):
        jl, jn, jm = _jax_run(flax_params, stage, sizes, qgz)
        meta0, arr0 = per_rank[0]
        got = _masters(arr0, k)
        row = meta0["cases"][k]
        np.testing.assert_allclose(row["losses"], jl, rtol=1e-4)
        np.testing.assert_allclose(row["norms"], jn, rtol=1e-4)
        _close(got, jm, qgz)
        if not qgz:
            np.testing.assert_allclose(row["losses"], l1, rtol=1e-5)
            _close(got, m1, False)
        else:
            assert row["qgz_axes"] == ([] if stage == 3 else
                                       [a for a in ("data", "fsdp")
                                        if sizes.get(a, 1) > 1])
        for meta, arr in per_rank[1:]:     # every rank holds the same result
            assert meta["cases"][k]["losses"] == row["losses"]
            other = _masters(arr, k)
            for name in got:
                np.testing.assert_array_equal(other[name], got[name])


def test_what_each_rank_holds(spawned, flax_params):
    """Stage 3 keeps half of each sharded leaf and of its moments on each
    of two fsdp ranks; stages 1-2 keep full masters and half-size moments
    for the same leaves; the leaves under 2048 elements stay whole."""
    w, cases, per_rank = spawned
    masters = _port_world1(flax_params, 2 * w)[2]
    full = sum(v.size for v in masters.values())
    small = sum(v.size for v in masters.values() if v.size < 2048)
    for k, (stage, sizes, qgz) in enumerate(cases):
        row = per_rank[0][0]["cases"][k]
        if sizes.get("fsdp", 1) == 1:
            assert row["held"] == row["moments"] == full
            continue
        half = (full - small) // 2 + small
        assert row["moments"] == half
        assert row["held"] == (half if stage == 3 else full)
        assert (row["param_dim"] != [None] * len(row["param_dim"])) == \
            (stage == 3)


def test_memory_tiers_refused_over_ranks(spawned):
    """The tiers run over data, fsdp and tensor ranks
    (``tests/test_torch_offload_ranks.py``); with the ``expert`` axis, a
    ``sequence`` axis or MiCS they still refuse, naming their item."""
    refusals = spawned[2][0][0]["refusals"]
    for name, item in (("expert", "Queue 1 item 4"),
                       ("sequence", "Queue 1 item 3"),
                       ("mics", "Queue 1 item 2")):
        assert item in refusals[name], refusals


REFUSED = [
    ({"zero_optimization": {"mics_shard_size": 2}}, "MiCS"),
    ({"zero_optimization": {"zero_hpz_partition_size": 2}}, "hpZ"),
    ({"zero_optimization": {"zero_quantized_weights": True}}, "qwZ"),
    ({"comm_compression": {"enabled": True}}, "comm_compression"),
    ({"mesh": {"fsdp_outer": 2}}, "fsdp_outer"),
    ({"mesh": {"dcn_axes": ["data"]}}, "dcn_axes"),
    ({"mesh": {"tensor": 2}}, "tensor-parallel"),
    ({"mesh": {"sequence": 2},
      "zero_optimization": {"zero_quantized_gradients": True}},
     "item 3: sequence parallel"),
    ({"mesh": {"expert": 2}, "zero_optimization": {"stage": 2}},
     "item 4: MoE"),
    ({"mesh": {"pipe": 2}}, "item 7"),
]
# ported since (the hierarchical world and the replica-axis wire): these
# cases now check that the option is read, as tests/test_torch_zeropp.py
# and tests/test_torch_compress.py check what it does
PORTED = {"MiCS": lambda c: c.zero_config.mics_shard_size == 2,
          "hpZ": lambda c: c.zero_config.zero_hpz_partition_size == 2,
          "qwZ": lambda c: c.zero_config.zero_quantized_weights,
          "comm_compression": lambda c: c.comm_compression.enabled,
          "fsdp_outer": lambda c: c.mesh.fsdp_outer == 2,
          # ported since (tensor parallelism, tests/test_torch_tp.py)
          "tensor-parallel": lambda c: c.mesh.tensor == 2}


@pytest.mark.parametrize("raw,match", REFUSED,
                         ids=[m.split(":")[0] for _, m in REFUSED])
def test_unported_options_raise_naming_their_item(raw, match):
    if match in PORTED:
        assert PORTED[match](DeepSpeedTPUConfig(raw))
        return
    with pytest.raises(NotImplementedError, match=match) as e:
        DeepSpeedTPUConfig(raw)
    assert "ROADMAP Queue 1 item" in str(e.value)


@pytest.mark.parametrize("logger", [{"prof_all": False},
                                    {"prof_ops": ["all_reduce"]}],
                         ids=["prof_all", "prof_ops"])
def test_comms_logger_filter_is_refused(logger):
    """The JAX package's logger stores the op filter and never reads it;
    the port refuses it rather than ignore it."""
    with pytest.raises(NotImplementedError, match="records every op"):
        DeepSpeedTPUConfig({"train_batch_size": 1,
                            "comms_logger": {"enabled": True, **logger}})
    cfg = DeepSpeedTPUConfig({"train_batch_size": 1,
                              "comms_logger": {"enabled": True,
                                               "debug": True}})
    assert cfg.comms_logger.enabled and cfg.comms_logger.prof_all
