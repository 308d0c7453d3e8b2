"""The port's checkpoints over ranks, on gloo CPU ranks
(``tests/torch_ckpt_ranks.py``; counterpart of ``tests/test_elastic_shrink.py
:81`` and ``:194``, ``tests/test_param_offload.py:302``).

- The reshard round trip: ZeRO-3 at data=2 x fsdp=2 (4 ranks) -> ZeRO-1 at
  data=2 (2 ranks) -> ZeRO-3 at data=2 x fsdp=2 again: every whole leaf
  and moment bit for bit the first save's; the third step's loss bit for
  bit the uninterrupted run's at the first world, and within rtol 1e-6 of
  it at the other (the same masters and batch, the mean over the ranks
  taken in another order).
- The tiers: the same checkpoint into the optimizer tier (ZeRO-2 over
  fsdp=2) and the parameter tier (data=2), their checkpoints back into
  ZeRO-3: bit for bit both ways.
- Mixtral's expert blocks (expert=2 x data=2) and a tensor=2 engine
  (fsdp=2 x tensor=2) are saved whole: the files equal the ranks' gathered
  masters, and a one-rank engine restores them bit for bit (and the
  tensor-parallel run's next loss within rtol 1e-5).
- ``comm_compression``'s residuals: saved at data=4, re-spread over data=2
  (each worker row the mean of the four saved rows, the server rows zero,
  within 1e-7 absolute: a float32 mean of four rows), and restored bit for
  bit at the same world.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_ckpt_ranks as ranks  # noqa: E402

from deepspeed_tpu_torch.testing import run_distributed  # noqa: E402

SPAWN_TIMEOUT = 300


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt_ranks")
    env = {"DSTPU_TEST_OUT": str(out)}
    for body, world in ((ranks.four_body, 4), (ranks.two_body, 2),
                        (ranks.back_body, 4)):
        run_distributed(body, world, timeout=SPAWN_TIMEOUT, device="cpu",
                        env=env)
    found = {}
    for name in ("four", "two", "back"):
        with open(out / f"{name}.json") as f:
            found[name] = json.load(f)
    return out, found


def test_reshard_round_trip_bit_identical(spawned):
    _, found = spawned
    four, two, back = found["four"], found["two"], found["back"]
    assert two["s1_apart"] == [] and two["s1_steps"] == 2
    assert back["s1_apart"] == []
    assert back["s1_next_loss"] == four["s3_next_loss"]
    np.testing.assert_allclose(two["s1_next_loss"], four["s3_next_loss"],
                               rtol=1e-6)


@pytest.mark.parametrize("tier", ["tier", "ptier"])
def test_tier_interchange_bit_identical(spawned, tier):
    _, found = spawned
    four, two, back = found["four"], found["two"], found["back"]
    assert two[f"{tier}_apart"] == [] and two[f"{tier}_steps"] == 2
    assert back[f"{tier}_apart"] == []
    assert back[f"{tier}_next_loss"] == four["s3_next_loss"]
    np.testing.assert_allclose(two[f"{tier}_next_loss"],
                               four["s3_next_loss"], rtol=1e-6)


def test_comm_compression_residuals_respread(spawned):
    _, found = spawned
    two = found["two"]
    assert found["four"]["cc4_buckets"] > 0
    assert two["cc_respread_max_abs"] <= 1e-7
    assert two["cc_same_world_bitwise"] and two["cc_nonzero"]


@pytest.mark.parametrize("name", ["moe", "tp"])
def test_blocks_saved_whole_and_reloaded_at_one_rank(spawned, name):
    out, found = spawned
    four = found["four"]
    dims = four[f"{name}_expert_dims" if name == "moe"
                else f"{name}_tensor_dims"]
    assert any(dims)                     # some leaves were blocks
    tag = out / name / "global_step1"
    gathered = dict(np.load(out / "four_masters.npz"))
    if name == "moe":
        eng = ranks.moe_engine({}, 8, seed=3)
        batch = ranks.moe.batches(8, 2)[1]
    else:
        eng = ranks.llama_engine(3, {}, seed=3)
        batch = ranks.batches()[1]
    for n, _ in eng.named_masters():
        arr = np.load(tag / "params" / (n.replace(".", "/") + ".npy"))
        np.testing.assert_array_equal(arr, gathered[f"{name}/{n}"])
    eng.load_checkpoint(str(out / name))
    assert ranks.apart_from_files(eng, str(tag)) == []
    loss = float(eng.train_batch(batch=batch, stacked=True))
    assert np.isfinite(loss)
    if name == "tp":
        np.testing.assert_allclose(loss, four["tp_next_loss"], rtol=1e-5)


class _Mesh:
    """A rank at tensor coordinate 1 and fsdp coordinate 1 of a tensor=2 x
    fsdp=2 mesh (``Mesh``'s ``axis_world`` / ``axis_index``)."""
    shape = {"tensor": 2, "fsdp": 2, "fsdp_out": 1}
    coords = {"tensor": 1, "fsdp": 1, "fsdp_out": 0}

    def axis_world(self, axes):
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_index(self, axes):
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def test_block_slices_is_shard_of_cut_after_cut():
    """The slice read: the index of a rank's block of a whole leaf is what
    ``shard_of`` takes cut after cut (tensor on dim 1, then the ZeRO block
    on dim 0; an absent cut skipped)."""
    from deepspeed_tpu_torch.runtime.zero import partition
    full = torch.arange(8 * 6).reshape(8, 6)
    mesh = _Mesh()
    cuts = [(None, ("expert",)), (1, ("tensor",)), (0, ("fsdp_out", "fsdp"))]
    want = full
    for d, axes in cuts[1:]:
        want = partition.shard_of(want, d, mesh, axes)
    sl = partition.block_slices(tuple(full.shape), cuts, mesh)
    assert torch.equal(full[sl], want)
    assert torch.equal(want, full[4:8, 3:6])
