"""ZeRO-Offload / ZeRO-Infinity: the host-DRAM and NVMe optimizer-state tiers.

Port of ``deepspeed_tpu/runtime/offload.py`` (reference
``runtime/zero/offload_config.py``, ``ops/adam/cpu_adam.py`` and the
swappers ``runtime/swap_tensor/partitioned_optimizer_swapper.py:29`` and
``pipelined_optimizer_swapper.py``). The card keeps compute-dtype (bf16)
parameters; the host keeps the fp32 masters and the optimizer moments as
CPU tensors, and the fused C++ kernel (Adam/AdamW, Adagrad or Lion, the
reference's CPU optimizers) updates them. Over ranks the engine hands each
rank's optimizer the blocks that rank holds (a leaf's ZeRO or tensor
block), and the kernel, elementwise, updates them as it would the whole
leaf. With ``device: nvme`` the moments
live in per-leaf files (``nvme_path/proc{rank}/state{s}_{i}.bin``, one
directory a ``torch.distributed`` rank, so ranks on one machine never
share a file), and the
masters too under ``swap_masters`` (``master_{i}.bin``); the files of the
next sub-group are read with the async engine while this one updates
(Infinity's pipelined swapper). Twin-Flow (``ratio`` < 1, reference
ZeRO-Offload++ ``engine.py:757``) keeps the first ``1 - ratio`` of the
leaves in host RAM.

``step`` takes the gradients whole (one fp32 CPU tensor a leaf) or as a
callable that hands over a leaf's elements a chunk at a time, so the engine
can bring them down through bounded pinned buffers; the update is
elementwise, so chunks give the same numbers as whole leaves. A callback
after each chunk sends the new compute-dtype shadow up.
"""

import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

from deepspeed_tpu_torch.config.config import OffloadConfig
from deepspeed_tpu_torch.ops.async_io import AsyncIOHandle
from deepspeed_tpu_torch.ops.cpu_adam import CPUAdagrad, CPUAdam, CPULion, to_bf16
from deepspeed_tpu_torch.utils.logging import _process_index, log_dist

# optimizer type -> host kernel (reference: cpu_adam/cpu_adagrad/cpu_lion builders)
_HOST_OPTIMIZERS = {
    "adam": CPUAdam, "adamw": CPUAdam, "cpu_adam": CPUAdam,
    "adagrad": CPUAdagrad, "cpu_adagrad": CPUAdagrad,
    "lion": CPULion, "cpu_lion": CPULion,
}

# each host kernel's moment buffers under the optax names of the in-HBM
# optimizers' state (``ops/optimizers.py``), which a checkpoint files them by,
# so moments move between the tiers (JAX ``checkpoint/engine.py:485-566``)
STATE_NAMES = {CPUAdam: ("mu", "nu"), CPUAdagrad: ("sum_of_squares",),
               CPULion: ("mu",)}

# grads(i, start, stop) -> leaf i's flat fp32 gradient elements [start, stop)
GradFetch = Callable[[int, int, int], torch.Tensor]
# after(i, start, stop, master elements [start, stop)) once they are updated
AfterChunk = Callable[[int, int, int, torch.Tensor], None]


class _LeafState:
    """Host state for one parameter leaf: the fp32 master and ``n_states``
    moment buffers. On the nvme tier with ``swap_masters`` the master also
    lives in a file and ``master`` is None while it is swapped out."""

    def __init__(self, idx: int, master: torch.Tensor, n_states: int,
                 nvme_dir: Optional[str], swap_master: bool):
        self.idx = idx
        self.shape = tuple(master.shape)
        self.size = master.numel()
        self.nvme = nvme_dir is not None
        self.master_path = None
        if self.nvme:
            self.paths = [os.path.join(nvme_dir, f"state{s}_{idx}.bin")
                          for s in range(n_states)]
            self.states: List[Optional[torch.Tensor]] = [None] * n_states
            if swap_master:
                self.master_path = os.path.join(nvme_dir, f"master_{idx}.bin")
        else:
            self.states = [torch.zeros_like(master) for _ in range(n_states)]
        self.master: Optional[torch.Tensor] = master
        self._pending_drop = False


class UnsupportedOffloadOptimizer(ValueError):
    pass


def _host_fp32(t: torch.Tensor) -> torch.Tensor:
    """A contiguous fp32 CPU tensor of ``t``'s values; ``t`` itself when it
    already is one (the optimizer takes ownership, no second copy)."""
    return t.detach().to("cpu", torch.float32).contiguous()


class HostOffloadOptimizer:
    """Fused host optimizer over offloaded states, with optional NVMe swap.

    Takes ownership of the masters it is given: a contiguous fp32 CPU
    tensor is kept as it is, anything else is copied."""

    def __init__(self, params_host: Sequence[torch.Tensor], opt_type: str,
                 opt_params: Dict[str, Any], offload: OffloadConfig,
                 sub_group_size: int = 4):
        key = (opt_type or "adamw").lower()
        if key not in _HOST_OPTIMIZERS:
            raise UnsupportedOffloadOptimizer(
                f"optimizer '{opt_type}' has no fused host kernel; offload "
                f"supports {sorted(set(_HOST_OPTIMIZERS))} (reference: CPU "
                "Adam/Adagrad/Lion only)")
        kernel_cls = _HOST_OPTIMIZERS[key]
        kwargs = dict(opt_params)
        kwargs.setdefault("adamw_mode", key != "adam")
        if "betas" in kwargs:
            kwargs["betas"] = tuple(kwargs["betas"])
        self.kernel = kernel_cls(**{k: v for k, v in kwargs.items()
                                    if k in ("lr", "betas", "eps", "weight_decay",
                                             "adamw_mode")})
        self.n_states = kernel_cls.num_states
        self.offload = offload
        nvme_dir = None
        self.aio: Optional[AsyncIOHandle] = None
        if offload.device == "nvme":
            root = offload.nvme_path or os.path.join(tempfile.gettempdir(),
                                                     "dstpu_nvme")
            nvme_dir = os.path.join(root, f"proc{_process_index()}")
            os.makedirs(nvme_dir, exist_ok=True)
            self.aio = AsyncIOHandle(num_threads=offload.buffer_count * 2)
        self._swap_masters = bool(offload.swap_masters)
        n = len(params_host)
        self.leaves = [
            _LeafState(i, _host_fp32(p), self.n_states,
                       # Twin-Flow partial offload: first (1-ratio) leaves in RAM
                       nvme_dir if (nvme_dir and i >= (1.0 - offload.ratio) * n)
                       else None,
                       swap_master=self._swap_masters)
            for i, p in enumerate(params_host)]
        if nvme_dir:
            # moment (+ master) files; the handle keeps each buffer alive
            # until its write drains
            for leaf in self.leaves:
                if leaf.nvme:
                    zeros = torch.zeros(leaf.shape, dtype=torch.float32)
                    for path in leaf.paths:
                        self.aio.async_pwrite(zeros, path)
                    if leaf.master_path:
                        self.aio.async_pwrite(leaf.master, leaf.master_path)
            errors = self.aio.drain()
            if errors:
                raise RuntimeError(f"nvme state-file init failed ({errors} errors)")
            for leaf in self.leaves:
                if leaf.master_path:
                    leaf.master = None        # authoritative copy is the file
        self.sub_group_size = max(1, sub_group_size)
        log_dist(f"host offload optimizer: kernel={kernel_cls.__name__} "
                 f"device={offload.device} leaves={len(self.leaves)} "
                 f"ratio={offload.ratio}", ranks=[0])

    # --- NVMe swap (reference: _prepare_sub_group / _release_sub_group) -----
    def _swap_in(self, group: List[_LeafState]) -> List[int]:
        reqs = []
        for leaf in group:
            if leaf.nvme and leaf.states[0] is None:
                for s in range(self.n_states):
                    leaf.states[s] = torch.empty(leaf.shape, dtype=torch.float32)
                    reqs.append(self.aio.async_pread(leaf.states[s], leaf.paths[s]))
            if leaf.master_path and leaf.master is None:
                leaf.master = torch.empty(leaf.shape, dtype=torch.float32)
                reqs.append(self.aio.async_pread(leaf.master, leaf.master_path))
        return reqs

    def _swap_out(self, group: List[_LeafState]):
        for leaf in group:
            if leaf.nvme:
                for s in range(self.n_states):
                    self.aio.async_pwrite(leaf.states[s], leaf.paths[s])
                if leaf.master_path:
                    self.aio.async_pwrite(leaf.master, leaf.master_path)
                # buffers dropped only after the writes drain WITHOUT error
                leaf._pending_drop = True

    def step(self, grads: Union[Sequence[torch.Tensor], GradFetch],
             lr: Optional[float] = None, after: Optional[AfterChunk] = None,
             chunk: Optional[int] = None) -> None:
        """One fused update over all leaves, sub-group pipelined when on NVMe
        (reference: pipelined_optimizer_swapper double buffering).

        ``grads``: one gradient a leaf (CPU, converted to contiguous fp32),
        or a ``GradFetch``. The kernel runs over ``chunk`` elements at a
        time (whole leaves when None), and ``after`` runs after each."""
        if not callable(grads):
            flat = [_host_fp32(g).view(-1) for g in grads]
            grads = lambda i, a, b: flat[i][a:b]  # noqa: E731
        groups = [self.leaves[i:i + self.sub_group_size]
                  for i in range(0, len(self.leaves), self.sub_group_size)]
        step_shared = self.kernel.step_count + 1

        pending: List[int] = self._swap_in(groups[0]) if groups else []
        for gi, group in enumerate(groups):
            for r in pending:
                if self.aio.wait(r):
                    raise RuntimeError("nvme optimizer-state swap-in failed")
            # prefetch next sub-group while this one updates
            pending = self._swap_in(groups[gi + 1]) if gi + 1 < len(groups) else []
            for leaf in group:
                master = leaf.master.view(-1)
                states = [s.view(-1) for s in leaf.states]
                size = chunk or leaf.size
                for a in range(0, leaf.size, size):
                    b = min(a + size, leaf.size)
                    self.kernel.step_count = step_shared - 1
                    self.kernel.step(master[a:b], grads(leaf.idx, a, b),
                                     *[s[a:b] for s in states], lr=lr)
                    if after is not None:
                        after(leaf.idx, a, b, master[a:b])
            self._swap_out(group)
        if self.aio is not None:
            failures = self.aio.drain()
            if failures:
                # keep the in-RAM copies: the files may be truncated/stale
                for leaf in self.leaves:
                    leaf._pending_drop = False
                raise RuntimeError(
                    f"nvme optimizer-state swap-out failed ({failures} writes); "
                    "in-RAM moments retained")
            for leaf in self.leaves:
                if leaf._pending_drop:
                    leaf.states = [None] * self.n_states
                    if leaf.master_path:
                        leaf.master = None
                    leaf._pending_drop = False
        self.kernel.step_count = step_shared

    # --- views ---------------------------------------------------------------
    def _load_master(self, leaf: _LeafState) -> torch.Tensor:
        if leaf.master is not None:
            return leaf.master
        buf = torch.empty(leaf.shape, dtype=torch.float32)
        if self.aio.wait(self.aio.async_pread(buf, leaf.master_path)):
            raise RuntimeError("nvme master swap-in failed")
        return buf

    def master(self, i: int) -> torch.Tensor:
        """Leaf ``i``'s fp32 master (read from its file when swapped out)."""
        return self._load_master(self.leaves[i])

    def iter_masters(self):
        """Yield (idx, fp32 master) one leaf at a time: NVMe masters stream
        through a transient buffer instead of all materializing at once."""
        for leaf in self.leaves:
            yield leaf.idx, self._load_master(leaf)

    def masters(self) -> List[torch.Tensor]:
        """All masters materialized (the full fp32 set when they live on
        NVMe)."""
        return [self._load_master(leaf) for leaf in self.leaves]

    def state_bytes(self) -> int:
        """The bytes of the state this optimizer keeps, in RAM or in files:
        each leaf's fp32 master and moments (over ranks, this rank's
        blocks)."""
        return sum(4 * leaf.size * (1 + self.n_states) for leaf in self.leaves)

    def leaf_shapes(self) -> List[tuple]:
        return [leaf.shape for leaf in self.leaves]

    def shadows(self, dtype: torch.dtype = torch.bfloat16) -> List[torch.Tensor]:
        """Compute-dtype shadow copies for the host->device transfer."""
        cast = to_bf16 if dtype == torch.bfloat16 else (lambda m: m.to(dtype))
        return [cast(m) for _, m in self.iter_masters()]

    # --- persistence ---------------------------------------------------------
    def _materialized_states(self, leaf: _LeafState) -> List[torch.Tensor]:
        if leaf.nvme and leaf.states[0] is None:
            for r in self._swap_in([leaf]):
                if self.aio.wait(r):
                    raise RuntimeError("nvme swap-in failed during state export")
        return list(leaf.states)

    def _store_master(self, leaf: _LeafState, value: torch.Tensor):
        value = _host_fp32(value).reshape(leaf.shape)
        if leaf.master_path:
            if self.aio.wait(self.aio.async_pwrite(value, leaf.master_path)):
                raise RuntimeError("nvme master swap-out failed")
            leaf.master = None
        elif leaf.master is not None:
            leaf.master.copy_(value)
        else:
            leaf.master = value.clone()

    def state_dict(self) -> Dict[str, Any]:
        return {
            "step_count": int(self.kernel.step_count),
            "masters": [m.clone() for m in self.masters()],
            "states": [[s.clone() for s in self._materialized_states(leaf)]
                       for leaf in self.leaves],
        }

    def load_state_dict(self, sd: Dict[str, Any]):
        self.kernel.step_count = int(sd["step_count"])
        for leaf, master, states in zip(self.leaves, sd["masters"], sd["states"]):
            self._store_master(leaf, master)
            buffers = [_host_fp32(s).reshape(leaf.shape).clone() for s in states]
            if leaf.nvme:
                for s, buf in enumerate(buffers):
                    self.aio.async_pwrite(buf, leaf.paths[s])
                if self.aio.drain():
                    raise RuntimeError("nvme state restore failed")
                leaf.states = [None] * self.n_states
            else:
                leaf.states = buffers

    # --- one leaf at a time, for a checkpoint ---------------------------------
    @property
    def state_names(self):
        """The moment buffers' names (``STATE_NAMES``), in kernel order."""
        return STATE_NAMES[type(self.kernel)]

    def leaf_states(self, i: int) -> List[torch.Tensor]:
        """Leaf ``i``'s moment buffers; on NVMe read from their files into
        transient buffers (the leaf stays swapped out)."""
        leaf = self.leaves[i]
        if leaf.nvme and leaf.states[0] is None:
            bufs = [torch.empty(leaf.shape, dtype=torch.float32)
                    for _ in leaf.paths]
            reqs = [self.aio.async_pread(b, p) for b, p in zip(bufs, leaf.paths)]
            if any([self.aio.wait(r) for r in reqs]):
                raise RuntimeError("nvme swap-in failed during state export")
            return bufs
        return list(leaf.states)

    def load_leaf(self, i: int, master: torch.Tensor,
                  states: Sequence[torch.Tensor]) -> None:
        """Overwrite leaf ``i``'s master and moment buffers (into their
        files on NVMe)."""
        leaf = self.leaves[i]
        self._store_master(leaf, master)
        buffers = [_host_fp32(s).reshape(leaf.shape) for s in states]
        if leaf.nvme:
            for s, buf in enumerate(buffers):
                self.aio.async_pwrite(buf, leaf.paths[s])
            if self.aio.drain():
                raise RuntimeError("nvme state restore failed")
            leaf.states = [None] * self.n_states
        else:
            for dst, src in zip(leaf.states, buffers):
                dst.copy_(src)

    def set_masters(self, new_masters: Sequence[torch.Tensor],
                    reset_moments: bool = False):
        """Overwrite the masters; ``reset_moments`` zeroes the moments (a
        restore that carried none)."""
        for leaf, m in zip(self.leaves, new_masters):
            self._store_master(leaf, m)
            if reset_moments:
                if leaf.nvme:
                    zeros = torch.zeros(leaf.shape, dtype=torch.float32)
                    for path in leaf.paths:
                        self.aio.async_pwrite(zeros, path)
                    if self.aio.drain():
                        raise RuntimeError("nvme moment reset failed")
                    leaf.states = [None] * self.n_states
                else:
                    leaf.states = [torch.zeros(leaf.shape, dtype=torch.float32)
                                   for _ in range(self.n_states)]
