"""ZeRO and qgZ across ranks on the device, against themselves: no JAX.

These run where the CPU tests cannot reach the kernels (``-m gpu`` on the
card) and, at the same sizes, on the CPU:

- stages 1, 2 and 3 at one rank give stage 0's losses, gradient norm and
  fp32 masters bit for bit (nothing is sharded and every reduction divides
  by 1); on the card under NCCL, the process group started by
  ``init_distributed`` in a spawned rank;
- ``chip_smoke.qgz_ranks_body`` on two gloo ranks (the tiny model): step
  1's qgZ-synced gradients bit for bit against the same sync with the plain
  codec, exactly 2 quantize and 2 dequantize launches a step for each leaf
  the sync quantizes (none on the CPU), and the six quantized collectives
  bit for bit against their plain versions;
- ``chip_smoke.zero_ranks_body`` on two gloo ranks: stage 3 and stage 2 at
  fsdp=2 within twice the distance of stage-0 runs that differ only in
  summation order, the comm bytes of a step equal to the count from the
  leaves' shapes, stage 3 holding half the masters.
"""

import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


def _need(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the card)")


@pytest.mark.parametrize("device", DEVICES)
def test_world1_stages_bit_for_bit_with_stage0(device, tmp_path):
    _need(device)
    if device == "cuda":
        from deepspeed_tpu_torch.testing import run_distributed
        run_distributed(ranks.world1_stages_body, 1, timeout=300,
                        env={"DSTPU_TEST_OUT": str(tmp_path)},
                        backend="nccl", device="cuda")
        saved = torch.load(tmp_path / "world1.pt")
        assert saved["backend"] == "nccl" and saved["world"] == 1
        res = saved["res"]
    else:
        res = ranks.world1_stages("cpu")
    losses0, norm0, masters0 = res[0]
    for stage in (1, 2, 3):
        losses, norm, masters = res[stage]
        assert losses == losses0 and norm == norm0, stage
        assert all(torch.equal(a, b) for a, b in zip(masters, masters0)), stage


def _spawn(body, device, tmp_path, **env):
    import chip_smoke
    chip_smoke._spawn(body, str(tmp_path), device=device, timeout=300,
                      DSTPU_SMOKE_MODEL="tiny", DSTPU_SMOKE_LAYERS="2", **env)
    out = []
    stem = body.replace("_body", "")
    for r in range(chip_smoke.RANKS):
        with open(tmp_path / f"{stem}{r}.json") as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("device", DEVICES)
def test_two_rank_qgz_sync_and_collectives_match_plain(device, tmp_path):
    _need(device)
    rows = _spawn("qgz_ranks_body", device, tmp_path)
    for row in rows:
        assert row["sync_equal"] == row["sync_leaves"] == row["leaves"]
        assert row["plain_launches"] == 0
        assert all(row["collectives_equal"].values()), row
        q = row["quantized_leaves"] if device == "cuda" else 0
        assert 0 < row["quantized_leaves"] < row["leaves"]
        for s in row["steps"]:
            assert s["launches"].get("quantize_int8", 0) == 2 * q
            assert s["launches"].get("dequantize_int8", 0) == 2 * q
            assert s["comm"]["quantized_all_reduce"]["count"] == \
                row["quantized_leaves"]
        if device == "cuda":
            assert all(row["collectives_path"].get(n, 0) > 0
                       for n in ("quantize_int8", "dequantize_int8",
                                 "quantize_fp8", "dequantize_fp8"))


@pytest.mark.parametrize("device", DEVICES)
def test_two_rank_stages_within_the_measured_tolerance(device, tmp_path):
    _need(device)
    rows = _spawn("zero_ranks_body", device, tmp_path)
    tol = rows[0]["reference"]["tolerance"]
    assert tol["loss"] > 0 and tol["grad_norm"] > 0
    for stage in ("3", "2"):
        r0 = rows[0]["runs"][stage]
        assert r0["masters_share"] <= tol["masters_share"]
        assert r0["loss_gap"] <= tol["loss"]
        assert r0["grad_norm_gap"] <= tol["grad_norm"]
        for s in r0["steps"]:
            got = {op: s["comm"].get(op, {}).get("bytes", 0)
                   for op in ("all_gather", "reduce_scatter")}
            assert got == r0["expected_comm_per_step"], stage
        for row in rows:
            assert [(s["loss"], s["grad_norm"])
                    for s in row["runs"][stage]["steps"]] == \
                [(s["loss"], s["grad_norm"]) for s in r0["steps"]]
    s3, s2 = rows[0]["runs"]["3"], rows[0]["runs"]["2"]
    assert s3["moments"] == s2["moments"] and s3["masters"] < 0.55 * s2["masters"]
