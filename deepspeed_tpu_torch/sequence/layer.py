"""API-compatible sequence-parallel attention layer.

Port of ``deepspeed_tpu/sequence/layer.py`` (reference
``deepspeed/sequence/layer.py:271``, ``DistributedAttention(local_attention,
sequence_process_group)``): a module wrapping any local attention;
sequence-sharded q/k/v are head-scattered by all-to-all, the wrapped
attention runs on the full sequence with a head slice, and the inverse
all-to-all restores sequence sharding. The process group is the global
mesh's ``sequence`` axis and the machinery is ``ulysses_attention``
(including the uneven-heads hybrid).
"""

from typing import Callable, Optional

from deepspeed_tpu_torch.sequence.ulysses import ulysses_attention


class DistributedAttention:
    """Call with this rank's sequence-sharded ``[B, S_l, H, D]`` q/k/v;
    extra positional/keyword args flow to the wrapped ``local_attention(q,
    k, v, *args, **kwargs)``, which sees the gathered sequence and its head
    slice (kv keep their GQA head count — densify inside the fn if
    needed). ``local_attention=None`` uses the built-in flash/reference
    attention (``causal`` applies only to the built-in). When heads don't
    divide the sequence degree, they are padded to the next multiple and
    every head still runs through ``local_attention`` (``ceil(H/sp)`` a
    rank; kv densified to q's head count first)."""

    def __init__(self, local_attention: Optional[Callable] = None,
                 mesh=None, causal: bool = True):
        self.local_attention = local_attention
        self.mesh = mesh
        self.causal = causal

    def __call__(self, query, key, value, *args, **kwargs):
        attn_fn = None
        if self.local_attention is not None:
            def attn_fn(q, k, v):
                return self.local_attention(q, k, v, *args, **kwargs)
        return ulysses_attention(query, key, value, causal=self.causal,
                                 mesh=self.mesh, attn_fn=attn_fn)
