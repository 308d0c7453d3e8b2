"""Port parity: ``deepspeed_tpu_torch.comm`` on ``torch.distributed``
against ``deepspeed_tpu.comm`` on a JAX mesh.

- Pure functions over many shapes and worlds: ``resolve_axis_sizes`` (and
  its errors), ``calc_bw`` / ``canonical_op_kind``, ``padded_elems`` and
  the wire-byte counts give the JAX package's results.
- The codec: ``quantize_wire``, ``dequantize_wire`` and ``ef_step`` (int8
  and fp8, with and without a residual) bit for bit against the reference
  compiled by ``jax.jit``, as it runs inside ``shard_map``.
- The guard: ``bounded_init``'s retries, backoff, wedge and fatal paths,
  ``CommGuard``'s deadline and counters and ``CommGuardConfig``'s
  validation errors, each against the reference run on the same callables.
- The facade at W = 2 and 4 (gloo ranks spawned by
  ``deepspeed_tpu_torch.testing.run_distributed``, mesh data=2 x
  fsdp=W/2) against ``jax.lax`` through the JAX facade in ``shard_map`` over
  the first W of the 8 CPU devices laid out the same way: moving ops bit
  for bit, sums within rtol 1e-6 (four ranks may add in another order);
  ``quantized_all_reduce`` / ``quantized_reduce_scatter`` (hierarchical
  over (data, fsdp) with error feedback, int8 and fp8) within 1e-6, their
  residuals too; the six quantized collectives of ``ops/quant.py`` /
  ``ops/fp_quant.py`` within 1e-6 (the Pallas kernels in interpret mode),
  and ``quantized_psum``'s straight-through backward (g for the sum, g/W
  for the mean).
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("pydantic")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from deepspeed_tpu.comm import comm as jcomm  # noqa: E402
from deepspeed_tpu.comm import compress as jcompress  # noqa: E402
from deepspeed_tpu.comm import comms_logging as jlog  # noqa: E402
from deepspeed_tpu.comm import guard as jguard  # noqa: E402
from deepspeed_tpu.comm import mesh as jmesh  # noqa: E402
from deepspeed_tpu.config.config import MeshConfig as JMeshConfig  # noqa: E402
from deepspeed_tpu.ops.pallas import fp_quant as jfp  # noqa: E402
from deepspeed_tpu.ops.pallas import quant as jquant  # noqa: E402
from deepspeed_tpu_torch.comm import comms_logging as tlog  # noqa: E402
from deepspeed_tpu_torch.comm import compress as tcompress  # noqa: E402
from deepspeed_tpu_torch.comm import guard as tguard  # noqa: E402
from deepspeed_tpu_torch.comm import mesh as tmesh  # noqa: E402
from deepspeed_tpu_torch.config.config import MeshConfig  # noqa: E402
from deepspeed_tpu_torch.testing import run_distributed  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402

SPAWN_TIMEOUT = 120


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------
MESH_CASES = [
    (dict(), 1), (dict(), 8), (dict(fsdp=2), 4), (dict(data=2, fsdp=-1), 8),
    (dict(data=1, fsdp=-1), 4), (dict(fsdp=4, tensor=2), 8),
    (dict(data=2, fsdp=2, sequence=2), 8), (dict(pipe=2, data=-1), 6),
    (dict(data=3, fsdp=2), 6), (dict(fsdp_outer=2, fsdp=2), 4),
    # errors: two fills, indivisible, wrong product
    (dict(data=-1, fsdp=-1), 4), (dict(fsdp=3), 4), (dict(data=2, fsdp=2), 8),
]


@pytest.mark.parametrize("sizes,n", MESH_CASES,
                         ids=[f"{i}" for i in range(len(MESH_CASES))])
def test_resolve_axis_sizes_matches_jax(sizes, n):
    try:
        want = jmesh.resolve_axis_sizes(JMeshConfig(**sizes), n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.resolve_axis_sizes(MeshConfig(**sizes), n)
        assert str(got.value) == str(e)
        return
    assert tmesh.resolve_axis_sizes(MeshConfig(**sizes), n) == want
    assert tmesh.MESH_AXES == jmesh.MESH_AXES
    assert tmesh.BATCH_AXES == jmesh.BATCH_AXES
    assert tmesh.FSDP_AXES == jmesh.FSDP_AXES


def test_mesh_coordinates_are_row_major_like_the_jax_mesh():
    """Rank r of the port's mesh sits where device r sits in a JAX mesh
    built row-major over MESH_AXES, for every axis set's index."""
    sizes = tmesh.resolve_axis_sizes(MeshConfig(data=2, fsdp=2, tensor=2), 8)
    shape = tuple(sizes[a] for a in tmesh.MESH_AXES)
    grid = np.arange(8).reshape(shape)
    for r in range(8):
        m = tmesh.Mesh.__new__(tmesh.Mesh)
        m.shape, m.rank = dict(sizes), r
        m.coords = {}
        rest = r
        for a in reversed(tmesh.MESH_AXES):
            m.coords[a] = rest % m.shape[a]
            rest //= m.shape[a]
        where = dict(zip(tmesh.MESH_AXES,
                         (int(i[0]) for i in np.nonzero(grid == r))))
        assert m.coords == where
        assert tmesh.Mesh.rank_of(m, m.coords) == r
        assert tmesh.Mesh.axis_index(m, ("data", "fsdp")) == \
            where["data"] * 2 + where["fsdp"]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds the refusal where there is no card")
def test_mesh_and_harness_take_the_card_unless_asked_for_the_cpu():
    """No CPU fallback: a mesh, ``create_mesh`` and ``run_distributed``
    with no device named take the card, and raise where there is none."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.Mesh({}, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.create_mesh()
    assert tmesh.create_mesh(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        run_distributed(ranks.comm_body, 1, timeout=SPAWN_TIMEOUT)


BW_CASES = [(op, kind, nbytes, dur, world)
            for op, kind in (("all_reduce", None), ("quantized_all_reduce", None),
                             ("all_gather", None), ("reduce_scatter", None),
                             ("all_to_all", None), ("ppermute", None),
                             ("my_all_reduce_like", None),
                             ("quantized_reduce_scatter", "reduce_scatter"),
                             ("broadcast", None))
            for nbytes, dur, world in ((1 << 20, 1e-3, 1), (1 << 20, 1e-3, 2),
                                       (12345, 2e-4, 4), (10, 0.0, 4),
                                       (-1, 1.0, 2), (1 << 30, 0.5, 8))]


@pytest.mark.parametrize("op,kind,nbytes,dur,world", BW_CASES)
def test_calc_bw_and_op_kind_match_jax(op, kind, nbytes, dur, world):
    assert tlog.canonical_op_kind(op, kind) == jlog.canonical_op_kind(op, kind)
    assert tlog.calc_bw(op, nbytes, dur, world, kind=kind) == \
        jlog.calc_bw(op, nbytes, dur, world, kind=kind)


WIRE_CASES = [(n, w, c, dt) for n in (1, 255, 256, 1000, 4096, 65537, 1 << 20)
              for w in (1, 2, 4, 8) for c in (8, 256) for dt in ("int8", "fp8")]


def test_wire_accounting_matches_jax():
    for n, w, c, dt in WIRE_CASES:
        assert tcompress.padded_elems(n, w, c) == jcompress.padded_elems(n, w, c)
        assert tcompress.wire_payload_bytes(n, dt, c) == \
            jcompress.wire_payload_bytes(n, dt, c)
        assert tcompress.all_reduce_wire_bytes(n, w, dt, c) == \
            jcompress.all_reduce_wire_bytes(n, w, dt, c)
        assert tcompress.reduce_scatter_wire_bytes(n, w, dt, c) == \
            jcompress.reduce_scatter_wire_bytes(n, w, dt, c)
    assert tcompress.DEFAULT_CHUNK == jcompress.DEFAULT_CHUNK
    assert {k: (v[1], v[2]) for k, v in tcompress.WIRE_DTYPES.items()} == \
        {k: (v[1], v[2]) for k, v in jcompress.WIRE_DTYPES.items()}


# ---------------------------------------------------------------------------
# the codec, bit for bit
# ---------------------------------------------------------------------------
def _codec_input(seed, chunks=600, chunk=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(chunks * chunk) * np.repeat(
        np.exp(rng.uniform(-12, 4, chunks)), chunk)
    x[:chunk] = 0.0                                   # the scale floor
    x[chunk:2 * chunk] *= 1e-12
    return x.astype(np.float32)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a.view(np.uint32)


def _tbits(t):
    return t.view(torch.uint8).numpy() if t.element_size() == 1 \
        else t.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("chunk", [256, 64])
def test_quantize_wire_and_ef_step_bit_for_bit(wire, chunk):
    x = _codec_input(7, chunk=chunk)
    err = (np.random.default_rng(8).standard_normal(x.size) * 1e-2
           ).astype(np.float32)
    jq, js = jax.jit(lambda v: jcompress.quantize_wire(v, wire, chunk))(x)
    tq, ts = tcompress.quantize_wire(torch.from_numpy(x), wire, chunk)
    assert np.array_equal(_bits(jq), _tbits(tq))
    assert np.array_equal(_bits(js), _tbits(ts))
    jd = jax.jit(lambda c, s: jcompress.dequantize_wire(c, s, chunk))(jq, js)
    td = tcompress.dequantize_wire(tq, ts, chunk)
    assert np.array_equal(_bits(jd), _tbits(td))
    for e in (err, None):
        je = jax.jit(lambda v, r: jcompress.ef_step(v, r, wire, chunk))(
            x, e) if e is not None else jcompress.ef_step(
                jnp.asarray(x), None, wire, chunk)
        te = tcompress.ef_step(torch.from_numpy(x),
                               None if e is None else torch.from_numpy(e),
                               wire, chunk)
        if e is None:
            assert te[2] is None and je[2] is None
            continue
        for a, b in zip(je, te):
            assert np.array_equal(_bits(a), _tbits(b))


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------
class _Flaky:
    """Fails ``fails`` times with ``exc``, then returns 42."""

    def __init__(self, fails, exc):
        self.fails, self.exc, self.calls = fails, exc, 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.fails:
            raise self.exc
        return 42


GUARD_CASES = {
    "transient_then_ok": (2, ConnectionRefusedError("connection refused"), 3),
    "transient_exhausted": (9, RuntimeError("UNAVAILABLE: try again"), 2),
    "fatal": (1, ValueError("bad address"), 3),
    "auth": (1, RuntimeError("permission denied by peer"), 3),
}


def _outcome(fn):
    try:
        return ("value", fn())
    except Exception as e:   # noqa: BLE001 — compared by type and fields
        return (type(e).__name__, getattr(e, "outcome", None).value
                if getattr(e, "outcome", None) else None,
                getattr(e, "attempts", None), str(e))


@pytest.mark.parametrize("case", list(GUARD_CASES))
def test_bounded_init_retries_like_the_reference(case, monkeypatch):
    fails, exc, retries = GUARD_CASES[case]
    slept = []                       # both modules sleep through time.sleep
    monkeypatch.setattr(tguard.time, "sleep", slept.append)
    got = {}
    for side, mod in (("t", tguard), ("j", jguard)):
        slept.clear()
        fn = _Flaky(fails, exc)
        got[side] = _outcome(lambda: mod.bounded_init(
            fn, name="rdzv", deadline_s=5.0, retries=retries, backoff_s=0.5))
        got[side + "_calls"] = fn.calls
        got[side + "_sleeps"] = list(slept)
    assert got["t"] == got["j"]
    assert got["t_calls"] == got["j_calls"]
    assert got["t_sleeps"] == got["j_sleeps"]
    retried = min(fails, retries) if case.startswith("transient") else 0
    assert got["t_sleeps"] == [0.5 * 2 ** k for k in range(retried)]


def test_bounded_init_and_guard_deadlines_like_the_reference():
    for mod in (tguard, jguard):
        t0 = time.monotonic()
        with pytest.raises(mod.CommWedgeError, match="exceeded 0s deadline") \
                as e:
            mod.bounded_init(lambda: time.sleep(3), name="hang",
                             deadline_s=0.2)
        assert e.value.outcome is mod.CommOutcome.TIMEOUT
        assert time.monotonic() - t0 < 2.0
        assert mod.bounded_init(lambda: 7, deadline_s=0) == 7
    results = {}
    for side, mod in (("t", tguard), ("j", jguard)):
        g = mod.CommGuard(mod.CommGuardConfig(enabled=True, op_deadline_s=0.2))
        assert g.run("ok", lambda: 5) == 5
        with pytest.raises(mod.CommWedgeError, match="exceeded 0.2s"):
            g.run("slow", lambda: time.sleep(3))
        with pytest.raises(ConnectionResetError):
            g.run("reset", lambda: (_ for _ in ()).throw(
                ConnectionResetError("connection reset")))
        mod.set_active_guard(g)
        try:
            assert mod.guarded("via_active", lambda: 9) == 9
        finally:
            mod.clear_active_guard(g)
        assert mod.get_active_guard() is None
        results[side] = dict(g.counters)
    assert results["t"] == results["j"] == {"ok": 2, "timeout": 1,
                                            "transient": 1, "fatal": 0}


@pytest.mark.parametrize("bad", [dict(op_deadline_s=0), dict(init_deadline_s=-1),
                                 dict(straggler_factor=1.0),
                                 dict(heartbeat_interval_s=0),
                                 dict(lost_after_s=0.5)])
def test_guard_config_validation_matches_jax(bad):
    with pytest.raises(ValueError) as j:
        jguard.CommGuardConfig(**bad)
    with pytest.raises(ValueError) as t:
        tguard.CommGuardConfig(**bad)
    assert str(t.value) in str(j.value)
    assert tguard.CommGuardConfig() .__dict__ == \
        jguard.CommGuardConfig().model_dump()


def test_op_listener_and_sequence():
    seen = []
    tguard.set_comm_op_listener(seen.append)
    try:
        tguard.note_comm_op("all_gather")
    finally:
        tguard.clear_comm_op_listener(seen.append)
    tguard.note_comm_op("ignored")
    assert seen == ["all_gather"]
    a = tguard.next_op_seq()
    assert tguard.next_op_seq() == a + 1
    assert tguard.COMM_FAULT_EXIT_CODE == jguard.COMM_FAULT_EXIT_CODE


# ---------------------------------------------------------------------------
# the facade and the quantized collectives across gloo ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def spawned(request, tmp_path_factory):
    w = request.param
    out = tmp_path_factory.mktemp(f"comm{w}")
    run_distributed(ranks.comm_body, w, timeout=SPAWN_TIMEOUT, device="cpu",
                    env={"DSTPU_TEST_OUT": str(out)})
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(w)]
    return w, got


def _jax_mesh(w):
    shape = tuple({"data": 2, "fsdp": w // 2}.get(a, 1)
                  for a in jmesh.MESH_AXES)
    return Mesh(np.array(jax.devices()[:w]).reshape(shape), jmesh.MESH_AXES)


def _jax_results(w):
    """The reference's ops in shard_map over (data, fsdp), row r = device r."""
    mesh = _jax_mesh(w)
    axes = ranks.AXES
    ins = [ranks.comm_inputs(r, w) for r in range(w)]
    stacked = {k: jnp.asarray(np.stack([i[k] for i in ins])) for k in ins[0]}
    R = jcomm.ReduceOp

    def local(t):
        t = {k: v[0] for k, v in t.items()}
        out, err = jcomm.quantized_all_reduce(
            t["qx"], axes, R.AVG, "int8",
            error=jcompress.TensorEF(worker=t["we"], server=t["se"]))
        shard, werr = jcomm.quantized_reduce_scatter(
            t["qx"], axes, R.AVG, "int8", error=t["we"])
        res = {
            "ar_sum": jcomm.all_reduce(t["x"], axes, R.SUM),
            "ar_avg_fsdp": jcomm.all_reduce(t["x"], "fsdp", R.AVG),
            "ar_max_data": jcomm.all_reduce(t["x"], "data", R.MAX),
            "ag0": jcomm.all_gather(t["x"], axes, axis=0),
            "ag1_untiled": jcomm.all_gather(t["x"], "data", axis=1,
                                            tiled=False),
            "rs0": jcomm.reduce_scatter(t["y"], axes, 0),
            "rs1": jcomm.reduce_scatter(t["y"], "data", 1),
            "a2a": jcomm.all_to_all(t["z"], axes, 0, 1),
            "a2a_untiled": jcomm.all_to_all(t["u"], "data", 0, 1, tiled=False),
            "pp_ring": jcomm.ppermute(t["x"], "data", [(0, 1), (1, 0)]),
            "pp_one": jcomm.ppermute(t["x"], axes, [(0, w - 1)]),
            "bcast": jcomm.broadcast_one_to_all(t["x"], "data", root=1),
            "barrier": jcomm.barrier(axes),
            "qar_int8_ef": out, "qar_int8_ef_worker": err.worker,
            "qar_int8_ef_server": err.server,
            "qar_fp8": jcomm.quantized_all_reduce(t["qx"], axes, R.SUM,
                                                  "fp8")[0],
            "qrs_int8_ef": shard, "qrs_int8_ef_worker": werr,
            "qag": jquant.quantized_all_gather(t["m"], "data"),
            "qpss": jquant.quantized_psum_scatter(t["m2"], "data", mean=True),
            "a2aqr": jquant.all_to_all_quant_reduce(t["m"], "fsdp", "data"),
            "qpsum": jquant.quantized_psum(t["m2"], axes),
            "qa2a": jquant.quantized_all_to_all(t["m"], "data", 0, 0),
            "qag_fp8": jfp.quantized_all_gather_fp8(t["m"], "data"),
        }
        return {k: jnp.asarray(v, jnp.float32)[None] for k, v in res.items()}

    spec = P(axes)
    f = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,),
                              out_specs=spec, check_vma=False))
    return {k: np.asarray(v) for k, v in f(stacked).items()}


EXACT = ("ag0", "ag1_untiled", "a2a", "a2a_untiled", "pp_ring", "pp_one",
         "bcast", "barrier", "ar_max_data", "qag", "qa2a", "qag_fp8")
CLOSE = ("ar_sum", "ar_avg_fsdp", "rs0", "rs1", "qar_int8_ef",
         "qar_int8_ef_worker", "qar_int8_ef_server", "qar_fp8", "qrs_int8_ef",
         "qrs_int8_ef_worker", "qpss", "a2aqr", "qpsum")


def test_facade_and_quantized_collectives_match_jax(spawned):
    w, got = spawned
    want = _jax_results(w)
    assert set(EXACT) | set(CLOSE) <= set(want)
    for r in range(w):
        assert list(got[r]["coords"]) == [r // (w // 2), r % (w // 2)]
        for k in EXACT:
            np.testing.assert_array_equal(got[r][k], want[k][r],
                                          err_msg=f"rank {r} {k}")
        for k in CLOSE:
            np.testing.assert_allclose(got[r][k], want[k][r], rtol=1e-6,
                                       atol=1e-6, err_msg=f"rank {r} {k}")
        np.testing.assert_array_equal(got[r]["qpsum_grad"],
                                      np.full((10, 64), 3.0, np.float32))
        np.testing.assert_array_equal(got[r]["qpsum_mean_grad"],
                                      np.full((10, 64), 1.0 / w, np.float32))
