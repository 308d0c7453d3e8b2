"""Port parity: sequence parallelism against the JAX package.

The port's functions run in gloo CPU ranks spawned by
``deepspeed_tpu_torch.testing.run_distributed`` (rank bodies in
``tests/torch_sp_ranks.py``), each rank on its contiguous block of seeded
global inputs; JAX runs the same inputs on an explicit mesh over the first
W of the 8 virtual CPU devices, with Pallas in interpret mode. Each rank's
block is held against the matching slice of JAX's global result.

- ``ring_attention`` (``xla``, ``interpret``: striped when causal and
  ``S_l % sp == 0``, ``interpret_contiguous``) at ``sp`` = 2 and 4, causal
  and not, GQA, an unaligned ``S_l``, segment ids: forward within 1e-5 and
  the q/k/v gradients of ``sum(out ** 2)`` within 5e-4 (JAX's own
  tolerances, ``tests/test_attention.py``).
- ``ulysses_attention`` at ``sp`` = 2 and 4, GQA through the scatter, the
  uneven heads of ``test_attention.py`` (the remainder on the plain and the
  flash ring), segment ids, a sliding window (against JAX's plain windowed
  attention over the global array); ``DistributedAttention`` with a custom
  local attention, even and uneven; the refusals, in JAX's words.
- ``chunked_cross_entropy`` (kernel, tied, soft cap, unroll),
  ``vocab_parallel_cross_entropy`` at ``tensor`` = 2, and the model with
  ``loss_chunk_size`` against JAX's.
- The engine: the tiny fp32 Llama at ``data=2 x sequence=2`` (4 ranks),
  ring and Ulysses, 3 steps against the JAX engine on a mesh of the same
  shape, one case with a ``loss_mask`` that leaves the sequence ranks
  unequal token counts; a planted fault (every rank rotating with local
  positions) must miss.
- The flash launches and ``sequence/*`` bytes of a step of each
  ``chip_smoke.py`` ``train_sp`` variant, from the wrappers' calls and the
  comms logger, against the smoke's formulas.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("flax")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import deepspeed_tpu  # noqa: E402
from deepspeed_tpu.comm import mesh as jmesh  # noqa: E402
from deepspeed_tpu.models import llama as jllama  # noqa: E402
from deepspeed_tpu.ops.flash_attention import attention_reference  # noqa: E402
from deepspeed_tpu.sequence import cross_entropy as jce  # noqa: E402
from deepspeed_tpu.sequence.layer import DistributedAttention  # noqa: E402
from deepspeed_tpu.sequence.ring import ring_attention  # noqa: E402
from deepspeed_tpu.sequence.ulysses import ulysses_attention  # noqa: E402
from deepspeed_tpu_torch.models import llama as tllama  # noqa: E402
from deepspeed_tpu_torch.models.convert import load_flax_params  # noqa: E402
from deepspeed_tpu_torch.sequence import cross_entropy as tce  # noqa: E402
from deepspeed_tpu_torch.testing import run_distributed  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
import torch_dist_ranks  # noqa: E402
import torch_sp_ranks as sp_ranks  # noqa: E402

SPAWN_TIMEOUT = 180
FWD_TOL = 1e-5
GRAD_TOL = 5e-4


def _case(kind, h=4, hkv=2, s=64, causal=True, **kw):
    return dict(kind=kind, b=2, s=s, h=h, hkv=hkv, causal=causal, seed=0, **kw)


COMMON = (
    [_case("ring", impl=impl, causal=c)
     for impl in ("xla", "interpret", "interpret_contiguous")
     for c in (True, False)]
    + [_case("ring", impl="interpret", s=40, h=4, hkv=4)]    # S_l unaligned
    + [_case("ring", impl=impl, causal=c, seg=True)
       for impl, c in (("interpret", True), ("interpret_contiguous", True),
                       ("interpret", False))]
    + [_case("ulysses", h=8, hkv=8), _case("ulysses", h=8, hkv=4),
       _case("ulysses", h=8, hkv=4, causal=False),
       _case("ulysses", h=8, hkv=4, seg=True),
       _case("ulysses", h=8, hkv=4, window=12),
       _case("dist", h=8, hkv=8)])
UNEVEN = {2: [(3, 3), (5, 1)], 4: [(6, 6), (2, 2), (6, 2)]}
CASES = {w: COMMON + [_case("ulysses", h=h, hkv=hkv, ring_impl=ri)
                      for h, hkv in UNEVEN[w] for ri in (None, "interpret")]
         + [_case("dist", h=h, hkv=hkv) for h, hkv in UNEVEN[w]]
         for w in (2, 4)}


def _case_id(c):
    parts = [c["kind"], c.get("impl") or c.get("ring_impl") or "",
             "causal" if c["causal"] else "full", f"h{c['h']}kv{c['hkv']}",
             f"s{c['s']}", "seg" if c.get("seg") else "",
             f"win{c['window']}" if c.get("window") else ""]
    return "-".join(p for p in parts if p)


def _jax_mesh(**sizes):
    w = int(np.prod(list(sizes.values())))
    full = {a: sizes.get(a, 1) for a in jmesh.MESH_AXES}
    mesh = Mesh(np.array(jax.devices()[:w]).reshape(
        tuple(full[a] for a in jmesh.MESH_AXES)), jmesh.MESH_AXES)
    jmesh.set_global_mesh(mesh)
    return mesh


def _jax_case(case, w):
    """JAX's global (out, dq, dk, dv) of ``sum(out ** 2)`` and the shapes
    its custom attention saw."""
    mesh = _jax_mesh(sequence=w)
    q, k, v = (jnp.asarray(x) for x in sp_ranks.make_qkv(
        case["b"], case["s"], case["h"], case["hkv"], seed=case["seed"]))
    seg = jnp.asarray(sp_ranks.make_segments(case["b"], case["s"])) \
        if case.get("seg") else None
    seen = []
    kind = case["kind"]

    def f(q, k, v):
        if kind == "ring":
            return ring_attention(q, k, v, causal=case["causal"], mesh=mesh,
                                  impl=case["impl"], segment_ids=seg)
        if kind == "ulysses" and case.get("window"):
            # the JAX model sends a window off the flash path to plain
            # attention over the global array
            return attention_reference(q, k, v, causal=True,
                                       window=case["window"])
        if kind == "ulysses":
            return ulysses_attention(q, k, v, causal=case["causal"],
                                     mesh=mesh, segment_ids=seg,
                                     ring_impl=case.get("ring_impl"))

        def fn(qq, kk, vv, note=None):
            seen.append((tuple(qq.shape), tuple(kk.shape), note))
            return attention_reference(qq, kk, vv, causal=True)
        return DistributedAttention(fn, mesh=mesh)(q, k, v, note="hi")

    def both(q, k, v):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(2.0 * out))      # the gradients of sum(out ** 2)
    return [np.asarray(x) for x in jax.jit(both)(q, k, v)], seen


@pytest.fixture(scope="module")
def spawner(tmp_path_factory):
    """``spawner(w)``: the attention body's results at ``sequence`` = ``w``
    ranks, spawned once a world."""
    runs = {}

    def get(w):
        if w not in runs:
            out = tmp_path_factory.mktemp(f"sp{w}")
            run_distributed(sp_ranks.attention_body, w,
                            timeout=SPAWN_TIMEOUT, device="cpu",
                            env={"DSTPU_TEST_OUT": str(out),
                                 "DSTPU_TEST_CASES": json.dumps(CASES[w])})
            per_rank = []
            for r in range(w):
                with open(out / f"attn{r}.json") as f:
                    meta = json.load(f)
                per_rank.append((meta, dict(np.load(out / f"attn{r}.npz"))))
            runs[w] = per_rank
        return w, runs[w]
    return get


def _block(x, r, w):
    n = x.shape[1] // w
    return x[:, r * n:(r + 1) * n]


ATTN_PARAMS = [(w, i) for w in (2, 4) for i in range(len(CASES[w]))]


@pytest.mark.parametrize("w,i", ATTN_PARAMS,
                         ids=[f"sp{w}-{_case_id(CASES[w][i])}"
                              for w, i in ATTN_PARAMS])
def test_attention_matches_jax(spawner, w, i):
    w, per_rank = spawner(w)
    case = CASES[w][i]
    want, jseen = _jax_case(case, w)
    for r, (meta, arrays) in enumerate(per_rank):
        for name, ref, tol in zip(("out", "dq", "dk", "dv"), want,
                                  (FWD_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
            np.testing.assert_allclose(
                arrays[f"{i}/{name}"], _block(ref, r, w), atol=tol, rtol=tol,
                err_msg=f"rank {r} {name} {_case_id(case)}")
        ops = meta["ops"][str(i)]
        assert ops and all(op.startswith("sequence/") for op in ops), ops
        if case["kind"] == "dist":
            # the custom attention saw the gathered sequence and the rank's
            # head slice, as JAX's saw it per device
            got = {(tuple(a), tuple(b), n) for a, b, n in meta["seen"][str(i)]}
            assert got == set(jseen), (got, jseen)


@pytest.mark.parametrize("w", [2, 4], ids=["sp2", "sp4"])
def test_each_layout_records_its_collectives(spawner, w):
    """The ring's hops, the stripe's reshards and Ulysses' all-to-alls each
    under their ``sequence/`` label; the contiguous ring never reshards."""
    w, per_rank = spawner(w)
    ops = per_rank[0][0]["ops"]
    for i, case in enumerate(CASES[w]):
        names = set(ops[str(i)])
        if case["kind"] == "ring":
            assert "sequence/ring/ppermute" in names, names
            striped = case["impl"] == "interpret" and case["causal"] and \
                (case["s"] // w) % w == 0
            assert ("sequence/stripe/all_to_all" in names) == striped, names
        else:
            # the sp-divisible head group takes the all-to-all; with the
            # built-in attention the remainder rides the ring
            even = case["kind"] == "dist" or case["h"] >= w
            rem = case["kind"] == "ulysses" and case["h"] % w != 0
            assert ("sequence/ulysses/all_to_all" in names) == even, names
            assert ("sequence/ring/ppermute" in names) == rem, names
        if case.get("seg") and case["kind"] == "ulysses":
            assert "sequence/ulysses/all_gather" in names, names


REFUSALS = {
    "ring_xla_segments": "need the flash ring",
    "ulysses_segments_uneven": "sp-indivisible head count",
    "ulysses_segments_attn_fn": "custom local_attention is unsupported",
}
MODEL_REFUSALS = {
    "model_flash_backend": "'flash' at mesh.sequence=2",
    "model_xla_backend": "'xla' at mesh.sequence=2",
    "model_ring_window": "sliding_window with the ring backend",
    "model_no_labels": "built over the whole sequence",
    "moe_layer": "Queue 1 item 4",
    "moe_engine": "Queue 1 item 4",
}


REFUSAL_PARAMS = [(2, n) for n in sorted(REFUSALS) + sorted(MODEL_REFUSALS)] \
    + [(4, n) for n in sorted(REFUSALS)]


@pytest.mark.parametrize("w,name", REFUSAL_PARAMS,
                         ids=[f"sp{w}-{n}" for w, n in REFUSAL_PARAMS])
def test_refusals(spawner, w, name):
    _, per_rank = spawner(w)
    want = {**REFUSALS, **MODEL_REFUSALS}[name]
    for meta, _ in per_rank:
        got = meta["refusals"][name]
        assert got is not None and want in got, (name, got)
        assert got.startswith("NotImplementedError") or \
            name == "model_no_labels", got


def test_jax_refuses_the_same_calls():
    """JAX's own words for the three attention refusals."""
    mesh = _jax_mesh(sequence=2)
    q = jnp.zeros((1, 8, 5, 16))
    seg = jnp.zeros((1, 8), jnp.int32)
    with pytest.raises(NotImplementedError, match=REFUSALS["ring_xla_segments"]):
        ring_attention(q, q, q, mesh=mesh, impl="xla", segment_ids=seg)
    with pytest.raises(NotImplementedError,
                       match=REFUSALS["ulysses_segments_uneven"]):
        ulysses_attention(q, q, q, mesh=mesh, segment_ids=seg)
    q4 = q[:, :, :4]
    with pytest.raises(NotImplementedError,
                       match=REFUSALS["ulysses_segments_attn_fn"]):
        ulysses_attention(q4, q4, q4, mesh=mesh, segment_ids=seg,
                          attn_fn=lambda a, b, c: a)


def test_vocab_parallel_cross_entropy_matches_jax(spawner):
    _, per_rank = spawner(2)
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = _jax_mesh(tensor=2)
    logits, labels = sp_ranks.vocab_ce_inputs()
    sharded = jax.device_put(jnp.asarray(logits),
                             NamedSharding(mesh, P(None, None, "tensor")))
    want = np.asarray(jce.vocab_parallel_cross_entropy(
        sharded, jnp.asarray(labels), mesh=mesh))
    # JAX's pmax has no differentiation rule: the gradient of the dense CE
    # (the same function of the logits; the max cancels)
    grad = np.asarray(jax.grad(lambda x: -jnp.sum(jnp.take_along_axis(
        jax.nn.log_softmax(x, -1), jnp.asarray(labels)[..., None], -1)))(
            jnp.asarray(logits)))
    vp = logits.shape[-1] // 2
    for r, (_, arrays) in enumerate(per_rank):
        np.testing.assert_allclose(arrays["vce/loss"], want, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(arrays["vce/grad"],
                                   grad[..., r * vp:(r + 1) * vp],
                                   atol=1e-5, rtol=1e-5)
    # an axis of one rank is the dense CE
    dense = tce.vocab_parallel_cross_entropy(torch.from_numpy(logits),
                                             torch.from_numpy(labels), None)
    np.testing.assert_allclose(dense.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", [v[0] for v in sp_ranks.SP_VARIANTS])
def test_train_sp_launch_and_byte_formulas(spawner, variant):
    """A step of each ``train_sp`` variant at the tiny model: the flash
    wrappers' calls (forward, and the remat rerun; one backward for dQ and
    dK/dV) and the ``sequence/*`` bytes equal ``chip_smoke.py``'s
    formulas, rank by rank (the contiguous ring runs fewer blocks on rank
    0)."""
    w, per_rank = spawner(2)
    cfg = torch_dist_ranks.tiny_fp32()
    d = cfg.hidden_size // cfg.num_heads
    for r, (meta, _) in enumerate(per_rank):
        got = meta["launches"][variant]
        want = chip_smoke.sp_flash_per_step(variant, cfg.num_layers, w, r)
        assert got["calls"] == {"flash_fwd": want["flash_fwd"],
                                "flash_bwd": want["flash_dq"]}, (r, got)
        assert want["flash_dq"] == want["flash_dkv"]
        assert got["bytes"] == chip_smoke.sp_comm_bytes_per_step(
            variant, cfg.num_layers, w, 1, sp_ranks.LAUNCH_SEQ // w,
            cfg.num_heads, cfg.num_kv_heads, d, elem=4), (r, got)
    r0 = per_rank[0][0]["launches"][variant]["calls"]["flash_fwd"]
    r1 = per_rank[1][0]["launches"][variant]["calls"]["flash_fwd"]
    assert (r0 < r1) == (variant == "ring_contiguous"), (r0, r1)


# ---------------------------------------------------------------------------
# the chunked loss, in process
# ---------------------------------------------------------------------------
def _ce_inputs(seed=5, b=2, s=9, h=16, v=40):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, s, h)).astype(f),
            rng.integers(0, v, size=(b, s)).astype(np.int32),
            (rng.random((b, s)) > 0.3).astype(np.int32),
            (rng.standard_normal((h, v)) * 0.3).astype(f))


@pytest.mark.parametrize("tied,soft_cap,unroll", [
    (False, None, False), (True, None, False), (False, 30.0, False),
    (True, 5.0, True)], ids=["kernel", "tied", "soft_cap", "tied_cap_unroll"])
def test_chunked_cross_entropy_matches_jax(tied, soft_cap, unroll):
    hid, labels, mask, w = _ce_inputs()
    w = w.T.copy() if tied else w
    key = "embedding" if tied else "kernel"

    def jf(x, wt):
        return jce.chunked_cross_entropy(
            x, jnp.asarray(labels), jnp.asarray(mask), chunk_size=4,
            soft_cap=soft_cap, compute_dtype=jnp.float32, unroll=unroll,
            **{key: wt})
    want = float(jf(jnp.asarray(hid), jnp.asarray(w)))
    gx, gw = jax.grad(jf, argnums=(0, 1))(jnp.asarray(hid), jnp.asarray(w))
    x = torch.from_numpy(hid).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = tce.chunked_cross_entropy(
        x, torch.from_numpy(labels), torch.from_numpy(mask), chunk_size=4,
        soft_cap=soft_cap, compute_dtype=torch.float32, unroll=unroll,
        **{key: wt})
    got.backward()
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), atol=1e-6,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="exactly one"):
        tce.chunked_cross_entropy(x, torch.from_numpy(labels),
                                  torch.from_numpy(mask))


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_model_chunked_loss_matches_jax(tied):
    """The model at ``loss_chunk_size`` (24 over 2 x 36 tokens: a padded
    last chunk) against JAX's, loss and every gradient, and the port's own
    dense loss."""
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                               tie_embeddings=tied, loss_chunk_size=24)
    names = {f.name for f in dataclasses.fields(tllama.LlamaConfig)} - {"dtype"}
    tcfg = tllama.LlamaConfig(**{n: getattr(jcfg, n) for n in names},
                              dtype=torch.float32)
    batch = jllama.random_tokens(2, 36, vocab_size=jcfg.vocab_size)
    batch["loss_mask"] = (np.arange(36)[None] % 5 != 0).astype(np.int32) \
        .repeat(2, 0)
    jm = jllama.LlamaForCausalLM(jcfg)
    params = jm.init(jax.random.PRNGKey(1), batch)["params"]
    want = float(jm.apply({"params": params}, batch))
    jgrads = jax.grad(lambda p: jm.apply({"params": p}, batch))(params)
    model = tllama.LlamaForCausalLM(tcfg, device="cpu")
    load_flax_params(model, jax.tree.map(np.asarray, params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = model(tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want, rtol=1e-6)
    from deepspeed_tpu_torch.models.convert import to_flax_tree
    got = to_flax_tree((n, p.grad) for n, p in model.named_parameters())
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    gflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert gflat.keys() == jflat.keys()
    for name, g in gflat.items():
        np.testing.assert_allclose(g, jflat[name], rtol=2e-5, atol=2e-6,
                                   err_msg=name)
    dense = tllama.LlamaForCausalLM(
        dataclasses.replace(tcfg, loss_chunk_size=None), device="cpu")
    dense.load_state_dict(model.state_dict())
    np.testing.assert_allclose(dense(tb).item(), loss.item(), rtol=1e-6)


def test_model_refuses_ring_segments_on_the_cpu():
    """JAX's refusal of packed sequences off the flash ring: CPU tensors
    take the plain ring body, which carries no segment ids."""
    tcfg = dataclasses.replace(torch_dist_ranks.tiny_fp32(),
                               attention_backend="ring")
    model = tllama.LlamaForCausalLM(tcfg, device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="need the flash ring"):
        model({"input_ids": ids, "segment_ids": ids})


# ---------------------------------------------------------------------------
# the engine at data=2 x sequence=2
# ---------------------------------------------------------------------------
# [backend, loss_mask with unequal sequence-rank counts, local positions]
ENGINE_CASES = [["ring", False, False], ["ulysses", False, False],
                ["ulysses", True, False], ["ring", True, False],
                ["ulysses", False, True]]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + "/") if isinstance(v, dict) else {name: v})
    return out


@pytest.fixture(scope="module")
def flax_params():
    jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32)
    batch = jllama.random_tokens(1, 8, vocab_size=jcfg.vocab_size)
    params = jllama.LlamaForCausalLM(jcfg).init(jax.random.PRNGKey(0),
                                               batch)["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def engine_ranks(flax_params, tmp_path_factory):
    out = tmp_path_factory.mktemp("sp_engine")
    np.savez(out / "params.npz", **_flat(flax_params))
    run_distributed(sp_ranks.engine_body, 4, timeout=SPAWN_TIMEOUT,
                    device="cpu",
                    env={"DSTPU_TEST_OUT": str(out),
                         "DSTPU_TEST_CASES": json.dumps(ENGINE_CASES)})
    per_rank = []
    for r in range(4):
        with open(out / f"engine{r}.json") as f:
            meta = json.load(f)
        per_rank.append((meta, dict(np.load(out / f"engine{r}.npz"))))
    return per_rank


_JAX_RUNS = {}


def _jax_engine(flax_params, backend, mask):
    if (backend, mask) not in _JAX_RUNS:
        mesh = _jax_mesh(**sp_ranks.ENGINE_MESH)
        jcfg = dataclasses.replace(jllama.TINY_LLAMA, dtype=jnp.float32,
                                   attention_backend=backend)
        eng, *_ = deepspeed_tpu.initialize(
            model=jllama.LlamaForCausalLM(jcfg),
            config=sp_ranks.engine_config(), model_parameters=flax_params,
            mesh=mesh)
        losses = [float(eng.train_batch(batch=b, stacked=True))
                  for b in sp_ranks.engine_batches(mask=mask)]
        _JAX_RUNS[(backend, mask)] = (
            losses, _flat(jax.tree.map(np.asarray, eng.module_state_dict())))
    return _JAX_RUNS[(backend, mask)]


def _masters(arrays, k):
    return {name.split("/", 1)[1].replace(".", "/"): v
            for name, v in arrays.items() if name.startswith(f"{k}/")}


MASTERS_TOL = 1e-5
# AdamW's normalized step moves a weight by about lr whatever its
# gradient's scale, so where a gradient is zero to rounding (an embedding
# row of a token seen only at masked positions) the two sides' rounding
# can point the step either way: the port's one-rank run with the plain
# backend moves 2 of 65,536 embedding elements of the masked case past
# MASTERS_TOL this way. At most this share of the elements may lie past
# it, none farther than two full steps a step.
MASTERS_APART_SHARE = 1e-4


def _close_masters(got, want):
    diffs = np.concatenate([np.abs(got[n] - w).ravel()
                            for n, w in want.items()])
    lr = sp_ranks.engine_config()["optimizer"]["params"]["lr"]
    assert diffs.max() <= 2 * lr * sp_ranks.ENGINE_STEPS, diffs.max()
    assert np.mean(diffs > MASTERS_TOL) <= MASTERS_APART_SHARE, \
        np.sum(diffs > MASTERS_TOL)


@pytest.mark.parametrize("k", range(len(ENGINE_CASES)),
                         ids=["-".join([c[0]] + (["mask"] if c[1] else [])
                                       + (["local_positions"] if c[2] else []))
                              for c in ENGINE_CASES])
def test_engine_matches_the_jax_engine(engine_ranks, flax_params, k):
    backend, mask, local_positions = ENGINE_CASES[k]
    want_losses, want_masters = _jax_engine(flax_params, backend, mask)
    meta0, arr0 = engine_ranks[0]
    got = _masters(arr0, k)
    losses = meta0["cases"][k]["losses"]
    assert got.keys() == want_masters.keys()
    if local_positions:               # the planted fault must miss
        worst = max(np.abs(got[n] - w).max() for n, w in want_masters.items())
        assert worst > 1e-4, worst
        assert not np.allclose(losses, want_losses, rtol=1e-5), losses
        return
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _close_masters(got, want_masters)
    for meta, arr in engine_ranks[1:]:     # every rank holds the same result
        assert meta["cases"][k]["losses"] == losses
        other = _masters(arr, k)
        for name in got:
            np.testing.assert_array_equal(other[name], got[name])


def test_unequal_counts_are_not_a_mean_of_means(engine_ranks, flax_params):
    """The masked case's sequence ranks hold 4 and 16 tokens a row: a mean
    of the two ranks' means would move the loss off JAX's global mean."""
    mask = sp_ranks.engine_batches(mask=True)[0]["loss_mask"][0]
    kept = mask[:, 1:]
    s_l = sp_ranks.ENGINE_SEQ // 2
    counts = [kept[:, max(0, c * s_l - 1):(c + 1) * s_l - 1].sum()
              for c in (0, 1)]
    assert counts[0] != counts[1], counts
    k = ENGINE_CASES.index(["ulysses", True, False])
    want, _ = _jax_engine(flax_params, "ulysses", True)
    np.testing.assert_allclose(engine_ranks[0][0]["cases"][k]["losses"], want,
                               rtol=1e-5)
