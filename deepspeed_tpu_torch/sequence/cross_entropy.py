"""Chunked and vocab-parallel cross entropy.

Port of ``deepspeed_tpu/sequence/cross_entropy.py`` (reference
``deepspeed/sequence/cross_entropy.py``):

- ``chunked_cross_entropy``: next-token CE from the final hidden states
  without the ``[B*S, V]`` fp32 logits. The head matmul and the
  softmax-CE run per token chunk under ``torch.utils.checkpoint``, so each
  chunk's logits are recomputed in the backward and the peak logits are
  ``chunk_size x V``. JAX scans the chunks (or unrolls them, ``unroll``);
  here both are one Python loop over checkpointed chunks, and ``unroll``
  is accepted for the config's sake. The chunk's logits are the compute
  dtype's matmul widened to fp32, as the port's dense head computes them
  (JAX keeps the fp32 accumulator of the bf16 dot; ROADMAP Queue 3).
- ``vocab_parallel_cross_entropy``: CE over logits sharded on V across an
  axis of the global mesh: the max over the axis (``all_reduce`` MAX, no
  gradient: the loss does not depend on it), the sum of exponentials and
  the target logit summed over the axis. The loss is replicated, so each
  sum's backward is the identity (``collectives.psum_replicated``). At an
  axis of one rank it is the dense CE.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.mesh import get_global_mesh
from deepspeed_tpu_torch.sequence import collectives as col

LABEL = "sequence/vocab_ce"


def _local_vocab_ce(logits_local, labels, axis_name: str, mesh,
                    label: str = LABEL):
    """logits_local ``[N, V/P]`` fp32, labels ``[N]`` global vocab ids ->
    per-token loss ``[N]``, the same on every rank of the axis."""
    vp = logits_local.shape[-1]
    lo = mesh.axis_index(axis_name) * vp
    with comm.op_label(label):
        lmax = comm.all_reduce(logits_local.detach().amax(-1), axis_name,
                               comm.ReduceOp.MAX)
    shifted = logits_local - lmax[..., None]
    sumexp = col.psum_replicated(shifted.exp().sum(-1), axis_name, label)
    local_idx = labels.long() - lo
    in_shard = (local_idx >= 0) & (local_idx < vp)
    safe_idx = local_idx.clamp(0, vp - 1)
    tgt = shifted.gather(-1, safe_idx[..., None])[..., 0]
    tgt = col.psum_replicated(torch.where(in_shard, tgt, 0.0), axis_name,
                              label)
    return torch.log(sumexp) - tgt


def vocab_parallel_cross_entropy(logits, labels, mesh=None,
                                 axis_name: str = "tensor",
                                 label: str = LABEL):
    """logits: this rank's ``[B, S, V/P]`` block of the vocab over
    ``axis_name``; labels ``[B, S]`` (the same on every rank). Returns the
    per-token loss ``[B, S]``. Degrades to the dense CE when the axis is
    one rank (``logits`` then hold the whole vocab). ``label`` names its
    collectives in the comms logger."""
    mesh = mesh or get_global_mesh()
    if mesh is None or mesh.shape.get(axis_name, 1) == 1:
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, labels.long()[..., None])[..., 0]
    if mesh is not get_global_mesh():
        raise ValueError("vocab_parallel_cross_entropy runs on the global "
                         "mesh; install it with comm.set_global_mesh")
    b, s, vp = logits.shape
    loss = _local_vocab_ce(logits.float().reshape(b * s, vp),
                           labels.reshape(b * s), axis_name, mesh, label)
    return loss.reshape(b, s)


TENSOR_LABEL = "tensor/vocab_ce"


def _chunk_sum(xc, lc, mc, w, tied: bool, soft_cap,
               vocab_parallel: bool = False):
    """One chunk's sum of masked CE: xc ``[c, H]`` and ``w`` in the compute
    dtype, logits widened to fp32. ``vocab_parallel``: ``w`` is this
    rank's block of the vocabulary over ``tensor``, and the chunk's max,
    sum of exponentials and target logit are taken over ``tensor``."""
    logits = (xc @ (w.T if tied else w)).float()
    if soft_cap:
        logits = soft_cap * torch.tanh(logits / soft_cap)
    if vocab_parallel:
        nll = _local_vocab_ce(logits, lc, "tensor", get_global_mesh(),
                              TENSOR_LABEL)
        return (nll * mc).sum()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, lc[:, None])[:, 0]
    return ((lse - tgt) * mc).sum()


def chunked_ce_sum(hidden, labels, mask, *, kernel=None, embedding=None,
                   chunk_size: int = 1024, soft_cap=None,
                   compute_dtype=torch.bfloat16, vocab_parallel: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked per-token CE, the mask's sum): the two halves of
    ``chunked_cross_entropy``'s mean, for a caller whose count spans ranks.
    ``vocab_parallel``: the head is this rank's block of the vocabulary
    over ``tensor`` (the JAX model's chunked loss on a vocab-sharded
    head)."""
    if (kernel is None) == (embedding is None):
        raise ValueError("pass exactly one of kernel / embedding")
    b, s, h = hidden.shape
    n = b * s
    c = min(chunk_size, n)
    pad = (-n) % c
    xf = hidden.reshape(n, h).to(compute_dtype)
    lf = labels.reshape(n).long()
    mf = mask.reshape(n).float()
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
        lf = F.pad(lf, (0, pad))
        mf = F.pad(mf, (0, pad))
    tied = kernel is None
    w = (embedding if tied else kernel).to(compute_dtype)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, n + pad, c):
        xc, lc, mc = xf[i:i + c], lf[i:i + c], mf[i:i + c]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_sum, xc, lc, mc, w, tied, soft_cap,
                              vocab_parallel, use_reentrant=False)
        else:
            part = _chunk_sum(xc, lc, mc, w, tied, soft_cap, vocab_parallel)
        total = total + part
    return total, mf.sum()


def chunked_cross_entropy(hidden, labels, mask, *, kernel=None,
                          embedding=None, chunk_size: int = 1024,
                          soft_cap=None, compute_dtype=torch.bfloat16,
                          unroll: bool = False):
    """Next-token CE from hidden states ``[B, S, H]`` (labels/mask ``[B,
    S]``) with exactly one of ``kernel`` ``[H, V]`` / ``embedding`` ``[V,
    H]`` (tied) as the head. Returns the mean CE over the masked tokens
    (the dense loss's contract). ``unroll`` changes nothing here: the chunk
    loop is Python either way."""
    del unroll
    total, count = chunked_ce_sum(hidden, labels, mask, kernel=kernel,
                                  embedding=embedding, chunk_size=chunk_size,
                                  soft_cap=soft_cap,
                                  compute_dtype=compute_dtype)
    return total / count.clamp_min(1.0)
