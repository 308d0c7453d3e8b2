"""The smoke's tensor-parallel phases, against themselves: no JAX.

``chip_smoke.tp_infer_body`` on two gloo ranks and the ``tp_zero3``
variant of ``chip_smoke.zeropp_ranks_body`` on four, with the tiny model
(``-m gpu`` on the card runs them there): ``init_inference`` at
``tp_size`` 2 (AutoTP) against the one-rank logits within the tiny
model's serving limits and both planted faults outside them, the ranks'
logits bit for bit, the ``tensor/*`` bytes as
``expected_tp_infer_comm`` reckons them (``check_tp_infer``); ZeRO
stage 3 at ``fsdp=2 x tensor=2`` within the tiny model's limits of the
stage-0 reference (``TP_TRAIN_LIMITS``), the replicated masters the
same bits on the tensor ranks of each fsdp group after every step, every
op's bytes and every flash launch a step as ``expected_tp_comm`` counts
them (``check_tp_ranks``); and the two training faults: the norm summing
every leaf over ``tensor`` moves the norm past its limit, and layer 0's
copy-to-tensor dropped splits the replicated masters
(``check_tp_train_faults``).
"""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]


def _skip_without_card(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the card)")


@pytest.mark.parametrize("device", DEVICES)
def test_two_rank_tp_inference_passes_its_gates(device, tmp_path):
    _skip_without_card(device)
    import chip_smoke
    chip_smoke._spawn("ranks_bodies", str(tmp_path), device=device,
                      timeout=240, **{chip_smoke.BODIES_ENV: "tp_infer_body",
                                      chip_smoke.TP_FAULTS_ENV: "1",
                                      chip_smoke.RANK_MODEL_ENV: "tiny"})
    rows = chip_smoke._read_ranks("tp_infer", str(tmp_path))
    # the readings the tiny model's serving limits stand on (shown with -s)
    print("gaps", {f: (r["rel_l2"], r["argmax_moved"])
                   for f, r in rows[0]["runs"].items()})
    path = chip_smoke.check_tp_infer(rows, flash=False)
    assert set(rows[0]["runs"]) == {"sound", *chip_smoke.TP_FAULTS}
    assert path == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


@pytest.mark.parametrize("device", DEVICES)
def test_four_rank_tp_training_passes_its_gates(device, tmp_path):
    _skip_without_card(device)
    import chip_smoke
    chip_smoke._spawn("zeropp_ranks_body", str(tmp_path), device=device,
                      timeout=300, world=chip_smoke.ZPP_RANKS,
                      DSTPU_SMOKE_MODEL="tiny", DSTPU_SMOKE_LAYERS="2",
                      DSTPU_SMOKE_ZPP_VARIANTS="tp_zero3",
                      DSTPU_SMOKE_TP_FAULTS="1")
    rows = chip_smoke._read_ranks("zeropp_ranks", str(tmp_path),
                                  world=chip_smoke.ZPP_RANKS)
    # the readings the tiny model's training limits stand on (shown with -s)
    print("gaps", chip_smoke.tp_train_gaps(rows[0]["runs"]))
    chip_smoke.check_tp_ranks(rows)
    chip_smoke.check_tp_train_faults(rows)
    # fsdp on a block
    assert rows[0]["runs"]["tp_zero3"]["param_dims"][0] is not None
