"""Sequence parallelism's kernels on the device, against their plain
versions: no JAX.

- The flash ring's blocks at ``train_sp``'s shape (``chip_smoke.py``'s
  ``ring_block``: causal with ``causal_shift=1`` and a ``(q_ids, k_ids)``
  pair of different ids; ``ring_full``: the same, non-causal), each row
  within 4 bf16 ulps of its largest |plain| value, their mutants (the mask
  off by one, the pair swapped, the segment mask dropped) outside, and a
  second backward bit for bit (``-m gpu`` on the card).
- ``chip_smoke.sp_attention_checks`` in two gloo ranks: the striped and
  contiguous flash rings and Ulysses against the same calls through the
  plain mirrors, forward and backward, and the ring with its last step
  dropped outside the tolerance; on the card through the kernels, here
  through the plain mirrors on both sides (``device="cpu"``).
"""

import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)]
#: tokens over the two ranks: a rank holds half
SEQ = {"cpu": 64, "cuda": 2048}


@pytest.mark.gpu
def test_ring_blocks_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels; no CPU mode)")
    import chip_smoke
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    names = ("ring_block", "ring_full")
    rows = chip_smoke.run_flash_cases(gen, names=names)
    assert [r["case"] for r in rows] == list(names)


@pytest.mark.parametrize("device", DEVICES)
def test_rings_and_ulysses_match_plain(device, tmp_path):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run with -m gpu on the card)")
    import chip_smoke
    from deepspeed_tpu_torch.testing import run_distributed
    run_distributed("chip_smoke:sp_checks_body", 2, timeout=300,
                    env={chip_smoke.RANK_OUT_ENV: str(tmp_path),
                         chip_smoke.RANK_DEVICE_ENV: device,
                         "DSTPU_SMOKE_SEQ": str(SEQ[device])},
                    backend="gloo", device=device)
    for r in range(2):
        with open(tmp_path / f"sp_checks{r}.json") as f:
            checks = json.load(f)
        assert set(checks) == {"ring_striped", "ring_contiguous", "ulysses"}
        chip_smoke.check_sp_attention(checks)
