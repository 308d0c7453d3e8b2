"""The smoke's four-rank hierarchical-ZeRO phase, against itself: no JAX.

``chip_smoke.zeropp_ranks_body`` on four gloo ranks (the tiny model;
``-m gpu`` on the card runs it there, where the int8 kernels launch):
MiCS and hpZ within twice the distance of stage-0 runs that differ only in
summation order; qwZ's secondary blocks bit for bit the plain round trip
of the gathered leaf, with the local-row-scale fault outside it;
``comm_compression``'s step-1 loss the same bits as MiCS's, one quantized
all-reduce a bucket of the plan's bytes, the embedding's sparse gather as
reckoned, the first bucket's error-feedback step exact on both steps and
step 2 starting from step 1's residual; qwZ and the compressed wire within
the tiny model's gap limits of hpZ and MiCS at each step; every op's bytes and
every kernel's launches a step as ``expected_zeropp_comm`` /
``expected_zeropp_launches`` count them (``chip_smoke
.check_zeropp_ranks``).
"""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


@pytest.mark.parametrize("device", DEVICES)
def test_four_rank_zeropp_phase_passes_its_gates(device, tmp_path):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the card)")
    import chip_smoke
    chip_smoke._spawn("zeropp_ranks_body", str(tmp_path), device=device,
                      timeout=300, world=chip_smoke.ZPP_RANKS,
                      DSTPU_SMOKE_MODEL="tiny", DSTPU_SMOKE_LAYERS="2")
    rows = chip_smoke._read_ranks("zeropp_ranks", str(tmp_path),
                                  world=chip_smoke.ZPP_RANKS)
    # the readings the tiny model's gap limits stand on (shown with -s)
    print("gaps", chip_smoke.zeropp_gaps(rows[0]["runs"]))
    path, gaps = chip_smoke.check_zeropp_ranks(rows)
    runs = rows[0]["runs"]
    assert runs["mics"]["zero_axes"] == ["fsdp"]
    assert runs["hpz"]["zero_axes"] == ["fsdp_out", "fsdp"]
    assert runs["mics_compress"]["wire_axes"] == ["fsdp_out"]
    # hpZ holds a quarter of each sharded leaf, MiCS half
    assert runs["hpz"]["held"] < 0.6 * runs["mics"]["held"]
    assert runs["hpz_qwz"]["qwz_leaves"] > runs["hpz_qwz"][
        "qwz_last_axis_leaves"] > 0
    assert len(runs["mics_compress"]["buckets"]) > 0
    assert gaps["compress_loss_rel"][0] == 0.0
    on_card = device == "cuda"
    assert (path.get("quantize_int8_scaled", 0) > 0) == on_card
