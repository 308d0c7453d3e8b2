"""Top-k gating and the expert-parallel MoE layer.

Port of ``deepspeed_tpu/moe/sharded_moe.py`` (reference
``deepspeed/moe/sharded_moe.py``: ``TopKGate`` :449, ``MOELayer`` :533):
``MoEConfig``, ``_capacity``, ``top_k_gating`` (GShard dense dispatch and
combine with a static capacity), ``TopKGate`` (the fp32 router ``wg``
``[D, E]``), ``Experts`` (stacked SwiGLU experts ``w_gate``/``w_up``
``[E, D, F]``, ``w_down`` ``[E, F, D]``) and ``MOELayer``.

**The gating.** The integer parts are the reference's: the top-k choice,
the k-major exclusive cumsum of positions, the capacity drop and the
one-hot slots, so the same router logits give the same ``dispatch``. The
top-k is a stable descending sort (``jax.lax.top_k`` keeps the lower
expert first on a tie; ``torch.topk`` does not, on the CPU or on CUDA).
The probabilities, and the aux and z losses, are computed in float64 and
rounded once to float32: that makes them the same on the CPU and the card
(their float32 ``exp`` and reductions differ) and within 1e-6 of the
reference's, whose CPU ``exp`` is not correctly rounded (ROADMAP
divergence 33). ``combine`` holds each kept choice's
(renormalized, with ``norm_topk_prob``) probability at its slot, and
``dispatch`` is ``combine > 0``, as in the reference.

**One process per rank.** The reference's layer is one SPMD program:
tokens shard over the batch axes and are replicated over ``expert``; the
experts' leading dim shards over ``expert``. The port computes the same
numbers rank by rank (``MOELayer.forward``):

- the router logits ``[T_local, E]`` are all-gathered over the token axes
  in rank order and gated on every rank as one global set (the capacity
  from the global ``T``, the cumsum over every shard, the aux and z losses
  means over the global ``T``), and each rank keeps its rows;
- the dispatch partial of this rank's experts is all-reduced over the
  token axes; the rank runs its ``E / ep`` experts; the combine partial is
  all-reduced over ``expert``.

The reference differentiates the global program; here each collective's
backward is placed by hand (``torch.autograd.Function``s, ROADMAP
divergence 31): the logits
gather's is a reduce-scatter of the summed cotangents; the dispatch sum's
is a sum over the token axes (each data rank's loss is its own); the
combine sum's is the identity (every expert rank holds the same loss);
and the inputs of the expert-local compute (the tokens and the kept
probabilities, which every expert rank holds in full) pass forward as
they are and sum their cotangents over ``expert`` in the backward.

The token axes are the live batch axes, or those the engine names with
``token_axes(...)``: under qgZ the engine's gradient phase is manual over
its replica axes, so the gating and the dispatch are local to the replica
shard there, as the reference's ``_quantized_wire_axes`` filters them.

``quantized_dispatch`` sends the dispatch and the combine through
``ops/quant.py``'s int8 wire (``_quantized_psum_core``): the combine as
``quantized_psum`` (straight-through, identity backward), the dispatch
with a backward that sums the cotangents over the token axes in full
precision, which is the reference's straight-through gradient in a
process per rank (ROADMAP divergence 32).

Noisy gating (``noisy_gate_policy="RSample"``) draws its noise from an
explicit ``torch.Generator`` where the reference draws from
``jax.random`` (ROADMAP divergence 30); ``MixtralForCausalLM`` draws it
before the blocks, so a remat recompute sees the same noise.
"""

import contextlib
import dataclasses
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.models.llama import Dense, _cast


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None     # None | "RSample" | "Jitter"
    drop_tokens: bool = True
    use_rts: bool = True                        # random token selection tie-break
    aux_loss_weight: float = 0.01
    router_z_loss_weight: float = 0.001
    # renormalize the kept top-k gate probs to sum to 1 (GShard/Mixtral);
    # HF Qwen2-MoE runs with it off (raw softmax probs weight the combine)
    norm_topk_prob: bool = True
    # int8 wire format for the dispatch/combine collectives
    quantized_dispatch: bool = False
    dtype: Any = torch.bfloat16


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    cap = int(np.ceil(num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


def _softmax64(logits: torch.Tensor):
    """(softmax, logsumexp) over the experts in float64. Written out:
    ``torch.softmax`` on float64 CPU tensors leaves the worker threads in a
    state where later ``exp`` calls vary from run to run in their last
    bits (PyTorch 2.13's CPU build), which two ranks' replicated values
    could not survive. The shift is a constant of the gradient."""
    x = logits.double()
    m = x.amax(-1, keepdim=True).detach()
    e = torch.exp(x - m)
    s = e.sum(-1, keepdim=True)
    return e / s, (m + torch.log(s))[..., 0]


def gate_probs(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the experts in float64, rounded once to float32."""
    return _softmax64(logits)[0].float()


class Route(NamedTuple):
    """One gating of ``T`` tokens: per choice ``[T, K]`` the expert, its
    slot in the expert's capacity, whether it was kept, and its combine
    weight; the weighted aux and z losses."""
    experts: torch.Tensor
    slots: torch.Tensor
    keep: torch.Tensor
    weights: torch.Tensor
    aux_loss: torch.Tensor
    z_loss: torch.Tensor


def route(logits: torch.Tensor, cfg: MoEConfig, capacity: int,
          noise: Optional[torch.Tensor] = None) -> Route:
    """The reference's ``top_k_gating`` up to the combine tensor (reference
    top2gating ``sharded_moe.py:290``): softmax, top-k by a stable sort,
    the load-balancing aux loss on the full softmax, the router z-loss,
    each choice's position in its expert by a k-major cumsum (k=0 choices
    win slots first), the capacity drop and the kept weights."""
    t, e = logits.shape
    k = cfg.top_k
    logits = logits.float()
    if noise is not None:
        logits = logits + noise
    probs64, lse = _softmax64(logits)
    probs = probs64.float()
    experts = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    top_probs = probs.gather(1, experts)
    # the losses' means in float64 too: the same on the CPU and the card
    me = probs64.mean(0)
    ce = F.one_hot(experts[:, 0], e).double().mean(0)
    aux = ((me * ce).sum() * e * cfg.aux_loss_weight).float()
    z = (lse.square().mean() * cfg.router_z_loss_weight).float()
    onehot = F.one_hot(experts, e)                          # [T, K, E]
    flat = onehot.transpose(0, 1).reshape(k * t, e)         # k-major
    pos = (flat.cumsum(0) - flat).reshape(k, t, e).transpose(0, 1)
    slots = (pos * onehot).sum(-1)                          # [T, K]
    keep = slots < capacity
    kept = top_probs * keep
    if cfg.norm_topk_prob:
        kept = kept / kept.sum(-1, keepdim=True).clamp_min(1e-9)
    return Route(experts, slots, keep, kept, aux, z)


def combine_of(experts, slots, keep, weights, capacity: int, first: int,
               count: int) -> torch.Tensor:
    """``combine [T, count, C]`` of experts ``first .. first+count-1``: each
    kept choice's weight at (token, expert, slot), zero elsewhere (the
    reference's one-hot einsum, whose one non-zero term a slot holds)."""
    t, k = experts.shape
    mine = keep & (experts >= first) & (experts < first + count)
    rows = torch.arange(t, device=experts.device)[:, None].expand(t, k)
    # the other choices all land on one spare cell (no host sync for a mask)
    out = weights.new_zeros(t, count + 1, capacity + 1)
    out = out.index_put((rows, torch.where(mine, experts - first, count),
                         torch.where(mine, slots, capacity)),
                        torch.where(mine, weights, 0.0))
    return out[:, :count, :capacity]


def top_k_gating(logits, cfg: MoEConfig, capacity: int,
                 generator: Optional[torch.Generator] = None,
                 train: bool = True, noise: Optional[torch.Tensor] = None):
    """Returns (dispatch [T,E,C] bool, combine [T,E,C] fp32, aux_loss,
    z_loss). In training with ``noisy_gate_policy="RSample"`` the logits
    take ``N(0, 1) / E`` noise, ``noise`` as given or drawn from
    ``generator``."""
    t, e = logits.shape
    if not (train and cfg.noisy_gate_policy == "RSample"):
        noise = None
    elif noise is None and generator is not None:
        noise = rsample_noise((t, e), generator, logits.device)
    r = route(logits, cfg, capacity, noise)
    combine = combine_of(r.experts, r.slots, r.keep, r.weights, capacity,
                         0, e)
    return combine > 0, combine, r.aux_loss, r.z_loss


def rsample_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """RSample's logit noise: standard normal draws over the expert count."""
    return torch.randn(shape, generator=generator, device=device) / shape[-1]


class TopKGate(nn.Module):
    """Router (reference: TopKGate sharded_moe.py:449): fp32 ``wg`` [D, E]
    (flax ``gate/wg/kernel``) applied to the fp32 tokens."""

    def __init__(self, cfg: MoEConfig, hidden_size: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.wg = Dense((hidden_size, cfg.num_experts), 1, False, device)

    def logits(self, x, compute_dtype=None) -> torch.Tensor:
        return self.wg(x.float(), torch.float32, compute_dtype)

    def capacity(self, num_tokens: int, train: bool) -> int:
        cfg = self.cfg
        cf = cfg.capacity_factor if train else cfg.eval_capacity_factor
        return _capacity(num_tokens * cfg.top_k, cfg.num_experts, cf,
                         cfg.min_capacity)

    def forward(self, x, train: bool = True, compute_dtype=None,
                generator: Optional[torch.Generator] = None):
        return top_k_gating(self.logits(x, compute_dtype), self.cfg,
                            self.capacity(x.shape[0], train),
                            generator=generator, train=train)


class Experts(nn.Module):
    """E SwiGLU expert MLPs stacked on a leading experts dim (flax
    ``experts/w_gate`` ...), fp32 masters computed in ``dtype``. Under
    expert parallelism the engine keeps this rank's ``E / ep`` of them."""

    def __init__(self, num_experts: int, hidden_size: int,
                 intermediate_size: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        e, d, f = num_experts, hidden_size, intermediate_size
        self.dtype = dtype
        self.w_gate = nn.Parameter(torch.empty(e, d, f, device=device))
        self.w_up = nn.Parameter(torch.empty(e, d, f, device=device))
        self.w_down = nn.Parameter(torch.empty(e, f, d, device=device))

    def forward(self, x, compute_dtype=None):       # x: [E, C, D]
        dt = self.dtype
        x = x.to(dt)
        g = torch.bmm(x, _cast(self.w_gate, compute_dtype).to(dt))
        u = torch.bmm(x, _cast(self.w_up, compute_dtype).to(dt))
        return torch.bmm(F.silu(g) * u,
                         _cast(self.w_down, compute_dtype).to(dt))


# ---------------------------------------------------------------------------
# the collectives of one process per rank, with their backward placed
# ---------------------------------------------------------------------------
_TOKEN_AXES: Optional[Tuple[str, ...]] = None


@contextlib.contextmanager
def token_axes(axes: Sequence[str]):
    """Gate and dispatch over ``axes`` (of the global mesh) inside: the
    engine's gradient phase under qgZ names the batch axes outside its
    replica axes."""
    global _TOKEN_AXES
    saved, _TOKEN_AXES = _TOKEN_AXES, tuple(axes)
    try:
        yield
    finally:
        _TOKEN_AXES = saved


def _live_token_axes(mesh) -> Tuple[str, ...]:
    from deepspeed_tpu_torch.comm.mesh import BATCH_AXES
    return mesh.live_axes(_TOKEN_AXES if _TOKEN_AXES is not None
                          else BATCH_AXES)


def _all_reduce(x, axes, label):
    from deepspeed_tpu_torch.comm import comm
    with comm.op_label(label):
        return comm.all_reduce(x.contiguous(), axes)


class _GatherRows(torch.autograd.Function):
    """Every token shard's rows in rank order; the backward sums every
    rank's cotangent and keeps this rank's rows (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axes):
        from deepspeed_tpu_torch.comm import comm
        ctx.axes = axes
        with comm.op_label("moe_gate"):
            return comm.all_gather(x.contiguous(), axes, axis=0)

    @staticmethod
    def backward(ctx, g):
        from deepspeed_tpu_torch.comm import comm
        with comm.op_label("moe_gate"):
            return comm.reduce_scatter(g.contiguous(), ctx.axes, 0), None


class _TokenSum(torch.autograd.Function):
    """The dispatch over the token axes: a sum forward, and a sum of the
    ranks' cotangents backward (each data rank's loss is its own)."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return _all_reduce(x, axes, "moe_dispatch")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axes, "moe_dispatch"), None


class _QuantizedTokenSum(torch.autograd.Function):
    """The dispatch sum with int8 on the wire (``_quantized_psum_core``
    over rows ``[E*C, D]``); the backward is ``_TokenSum``'s in full
    precision, straight through the rounding."""

    @staticmethod
    def forward(ctx, x, axes):
        from deepspeed_tpu_torch.comm import comm
        from deepspeed_tpu_torch.ops.quant import _quantized_psum_core
        ctx.axes = axes
        e, c, d = x.shape
        with comm.op_label("moe_dispatch"):
            return _quantized_psum_core(x.reshape(e * c, d), axes,
                                        False).reshape(e, c, d)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axes, "moe_dispatch"), None


class _ExpertCopy(torch.autograd.Function):
    """An input every expert rank holds in full, into this rank's share of
    the experts: identity forward, the shares' cotangents summed over
    ``expert`` backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ("expert",), "moe_expert_grad")


class _ExpertSum(torch.autograd.Function):
    """The combine over ``expert``: a sum forward; every expert rank then
    computes the same loss and holds its whole cotangent, so the backward
    is the identity."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x, ("expert",), "moe_combine")

    @staticmethod
    def backward(ctx, g):
        return g


def _quantized_expert_sum(x):
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops.quant import quantized_psum
    with comm.op_label("moe_combine"):
        return quantized_psum(x, ("expert",))


class MOELayer(nn.Module):
    """Gate -> dispatch -> experts -> combine (reference: MOELayer
    sharded_moe.py:533). ``forward(x [B, S, D], train)`` returns
    ``([B, S, D], aux_loss + z_loss)``."""

    def __init__(self, cfg: MoEConfig, hidden_size: int,
                 intermediate_size: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.gate = TopKGate(cfg, hidden_size, device)
        self.experts = Experts(cfg.num_experts, hidden_size,
                               intermediate_size, cfg.dtype, device)

    def _expert_share(self, mesh) -> Tuple[int, int]:
        """(first expert, count) this rank computes: all of them, or its
        block of the experts' leading dim when the engine sharded it over
        ``expert``."""
        from deepspeed_tpu_torch.comm.mesh import get_expert_parallel_rank
        e = self.cfg.num_experts
        held = self.experts.w_gate.shape[0]
        if held == e:
            return 0, e
        ep = mesh.shape["expert"] if mesh is not None else 1
        if ep * held != e:
            raise ValueError(f"this rank holds {held} of {e} experts over an "
                             f"expert axis of {ep}")
        return get_expert_parallel_rank(mesh) * held, held

    def forward(self, x, train: bool = True, compute_dtype=None,
                noise: Optional[torch.Tensor] = None):
        from deepspeed_tpu_torch.comm.mesh import get_global_mesh
        cfg = self.cfg
        b, s, d = x.shape
        tokens = x.reshape(b * s, d)
        mesh = get_global_mesh()
        tok_axes = _live_token_axes(mesh) if mesh is not None else ()
        first, count = self._expert_share(mesh)
        ep = count < cfg.num_experts
        if cfg.quantized_dispatch and not ep and mesh is not None \
                and mesh.shape["expert"] > 1:
            raise ValueError("quantized_dispatch over an expert axis needs the "
                             "expert leaves sharded over it (moe_tensor_rules)")

        logits = self.gate.logits(tokens, compute_dtype)          # [T, E]
        t_local = logits.shape[0]
        row0 = 0
        if tok_axes:
            row0 = mesh.axis_index(tok_axes) * t_local
            logits = _GatherRows.apply(logits, tok_axes)
        capacity = self.gate.capacity(logits.shape[0], train)
        if not (train and cfg.noisy_gate_policy == "RSample"):
            noise = None
        r = route(logits, cfg, capacity, noise)
        rows = slice(row0, row0 + t_local)
        experts, slots = r.experts[rows], r.slots[rows]
        keep, weights = r.keep[rows], r.weights[rows]
        if ep:
            tokens = _ExpertCopy.apply(tokens)
            weights = _ExpertCopy.apply(weights)
        combine = combine_of(experts, slots, keep, weights, capacity,
                             first, count)                        # [T, e, C]
        dispatch = combine > 0
        # [T,e,C] x [T,D] -> [e,C,D]: the token collective (reference:
        # _AllToAll before the experts)
        dispatched = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), tokens)
        if tok_axes:
            dispatched = (_QuantizedTokenSum if cfg.quantized_dispatch
                          else _TokenSum).apply(dispatched, tok_axes)
        expert_out = self.experts(dispatched, compute_dtype)
        dt = torch.promote_types(x.dtype, expert_out.dtype)
        out = torch.einsum("tec,ecd->td", combine.to(dt), expert_out.to(dt))
        if ep:
            out = _quantized_expert_sum(out) if cfg.quantized_dispatch \
                else _ExpertSum.apply(out)
        return out.reshape(b, s, d), r.aux_loss + r.z_loss


def _path_name(path) -> str:
    if isinstance(path, str):
        return path.replace(".", "/")
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _ndim(leaf) -> int:
    if isinstance(leaf, (tuple, list, torch.Size)):
        return len(leaf)
    return len(getattr(leaf, "shape", ()))


def moe_tensor_rules(path, leaf) -> Optional[Tuple]:
    """Expert-parallel sharding: a stacked expert weight shards its leading
    experts dim over the ``expert`` axis (reference: expert params live in
    expert-parallel groups, utils/groups.py:117). ``path`` is a parameter
    name (dots or slashes) or a sequence of keys; ``leaf`` a tensor, an
    array or a shape. The spec is the port's tuple (``runtime/zero/
    partition.py``)."""
    if "experts/" in _path_name(path) and _ndim(leaf) == 3:
        return ("expert", None, None)
    return None


def moe_layers(module: nn.Module):
    """The MoE layers of ``module``, in module order."""
    return [m for m in module.modules() if isinstance(m, MOELayer)]

