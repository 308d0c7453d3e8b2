"""Sequence parallelism on ``torch.distributed`` (port of
``deepspeed_tpu/sequence``): Ulysses (``ulysses.py``), the ring
(``ring.py``: the plain body and the flash ring, striped and contiguous),
``DistributedAttention`` (``layer.py``), the chunked and vocab-parallel
cross entropies (``cross_entropy.py``) and the differentiable collectives
they stand on (``collectives.py``). Every function takes this rank's shard
of the sequence over the global mesh's ``sequence`` axis."""

from deepspeed_tpu_torch.sequence.cross_entropy import (
    chunked_cross_entropy,
    vocab_parallel_cross_entropy,
)
from deepspeed_tpu_torch.sequence.layer import DistributedAttention
from deepspeed_tpu_torch.sequence.ring import ring_attention
from deepspeed_tpu_torch.sequence.ulysses import ulysses_attention

__all__ = ["DistributedAttention", "chunked_cross_entropy", "ring_attention",
           "ulysses_attention", "vocab_parallel_cross_entropy"]
