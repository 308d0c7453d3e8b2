"""ZeRO-Infinity parameter offload: train a model whose weights do not fit
on the card, streaming them through it one layer group at a time.

Port of ``deepspeed_tpu/runtime/param_offload.py`` (reference
``runtime/swap_tensor/partitioned_param_swapper.py:37`` and
``pipelined_optimizer_swapper.py``). The model is cut into units: the
embedding, groups of ``layers_per_group`` blocks, and the tail (final norm
and head). A step is a host-driven stream over them:

  fwd:  for g in 0..G-1: H2D(group g+1) on a side stream while group g
        computes; only the boundary activations stay on the card
  loss: the tail's loss, its gradients and the gradient of its input
  bwd:  for g in G-1..0: H2D(group g-1) while group g recomputes its
        forward from its boundary activation and runs its backward; its
        gradients go down into fp32 host accumulators and leave the card
  step: the fused host optimizer (``HostOffloadOptimizer``: host or NVMe
        moment tier) updates the fp32 masters, and the compute-dtype store
        is refreshed from them.

Each unit runs through the model's own entry points (``LlamaModel.
embed_tokens``, ``run_blocks`` with the config's remat, ``head``,
``LlamaForCausalLM.loss_of``) with the module's parameters bound to the
streamed weights, so a group computes exactly what the whole model does.

``offload_param.device: cpu`` keeps the compute-dtype store in page-locked
host memory; ``nvme`` keeps each layer group in a file
(``nvme_path/params_proc{rank}/group{g}.bin``) read through the async I/O
engine into two page-locked slots (the embedding and the tail stay in RAM:
every micro-batch touches them twice). ``offload_param.ratio`` (Twin-Flow)
keeps the first ``1 - ratio`` of the layer groups in RAM. The stream's
order on the card: a group's copy waits for the compute stream's earlier
work (its buffer may be a just-freed one), the compute stream waits for
the copy's event before the group runs, and an NVMe slot is read into
again only after the copy out of it has finished.

Supported models: ``LlamaForCausalLM`` with ``scan_layers=False``.
Unsupported configs raise at engine init; the MoE block stack raises "not
ported" (ROADMAP Queue 1 item 4: MoE, its remainder).
"""

import dataclasses
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.async_io import AsyncIOHandle
from deepspeed_tpu_torch.ops.cpu_adam import to_bf16
from deepspeed_tpu_torch.runtime.offload import HostOffloadOptimizer
from deepspeed_tpu_torch.runtime.staging import STAGING_ELEMS, PinnedHost, Staging
from deepspeed_tpu_torch.utils.logging import _process_index, log_dist


def validate_param_offload(config, model) -> None:
    """Raise (never silently ignore) when ``offload_param`` cannot be
    honored. The reference's refusals of compression, eigenvalue,
    sparse_gradients and the flops profiler are not repeated: the port's
    config refuses those groups at parse time."""
    pcfg = config.zero_config.offload_param
    if pcfg.device not in ("cpu", "nvme"):
        raise ValueError(
            f"offload_param.device must be none|cpu|nvme, got {pcfg.device!r}")
    cfg = getattr(model, "cfg", None)
    if cfg is not None and hasattr(cfg, "base") and hasattr(cfg, "moe"):
        raise NotImplementedError(
            "offload_param over the MoE block stack (MixtralBlock, "
            "Qwen2MoEBlock) is not ported yet (ROADMAP Queue 1 item 4: MoE "
            "(the MoE block stack under offload_param))")
    if cfg is None or not hasattr(cfg, "num_layers"):
        raise ValueError(
            "offload_param needs a layered model exposing .cfg.num_layers "
            "(the in-repo Llama/Mixtral families); got "
            f"{type(model).__name__} — either drop offload_param or use a "
            "LlamaForCausalLM-style model")
    if getattr(cfg, "scan_layers", False):
        raise ValueError(
            "offload_param requires scan_layers=False: layer streaming "
            "addresses per-layer subtrees (model/layer_i), which nn.scan "
            "stacks into one leaf")
    if config.fp16.enabled:
        raise ValueError(
            "offload_param supports bf16/fp32 only (TPU-native precisions); "
            "fp16 dynamic loss scaling is not wired through the streamed "
            "step — use bf16")
    zc = config.zero_config
    raw = dict(config._raw.get("zero_optimization") or {})
    if (raw.get("zero_hpz_partition_size") or 1) > 1 \
            or (raw.get("mics_shard_size") or 0) > 0 \
            or raw.get("zero_quantized_weights") or zc.zero_quantized_gradients:
        raise ValueError(
            "offload_param is incompatible with hpZ/MiCS/qwZ/qgZ: those "
            "shard or compress device-resident params; offloaded params "
            "stream from host instead")
    if pcfg.device == "nvme" and not pcfg.nvme_path:
        raise ValueError("offload_param.device=nvme requires nvme_path")


@dataclasses.dataclass
class _Unit:
    """A streamed unit: leaf indices, each leaf's offset in the unit's flat
    buffer, and its total elements."""
    idx: List[int]
    offsets: List[int]
    numel: int


class ParamOffloadTrainer:
    """Streamed train step over a host-resident parameter store. Takes the
    model's weights (on the card or the CPU) as fp32 host masters and leaves
    the module with empty parameters, bound to streamed weights in turn."""

    def __init__(self, model, config, lr_schedule, device: torch.device,
                 staging_elems: int = STAGING_ELEMS):
        validate_param_offload(config, model)
        self.model = model
        self.cfg = model.cfg
        self.config = config
        self.lr_schedule = lr_schedule
        self.device = device
        self.compute_dtype = config.precision_dtype
        pcfg = config.zero_config.offload_param
        # offload_param implies host masters and moments: if the weights do
        # not fit on the card, their fp32 states do not either.
        # offload_optimizer.device picks the moment tier (cpu by default).
        ocfg = config.zero_config.offload_optimizer
        if ocfg.device == "none":
            ocfg = dataclasses.replace(ocfg, device="cpu")
            log_dist("offload_param: optimizer states implicitly offloaded "
                     "to cpu (device weights are streamed; fp32 states "
                     "cannot be device-resident)", ranks=[0])
        self.staging = Staging(device, pcfg.pin_memory, staging_elems)
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self._params = [p for _, p in named]
        host = []
        for p in self._params:        # masters leave the card one at a time
            host.append(self.staging.to_host(p.data))
            p.data = torch.empty(0, dtype=self.compute_dtype, device=device)
        self._shapes = [tuple(h.shape) for h in host]
        model.to(device)              # the buffers (rope tables)
        opt_type = config.optimizer.type if config.optimizer else "adamw"
        opt_params = dict(config.optimizer.params) if config.optimizer else {}
        self.opt = HostOffloadOptimizer(host, opt_type, opt_params, ocfg)
        del host

        # --- units ------------------------------------------------------------
        L = self.cfg.num_layers
        per = max(1, int(pcfg.layers_per_group or 1))
        self._layer_groups: List[List[int]] = [
            list(range(a, min(a + per, L))) for a in range(0, L, per)]
        self._embed = self._unit(["model.embed."])
        tail = ["model.final_norm."]
        if not self.cfg.tie_embeddings:
            tail.append("model.lm_head.")
        self._tail = self._unit(tail)
        self._groups = [self._unit([f"model.layer_{i}." for i in g])
                        for g in self._layer_groups]
        covered = sorted(i for u in (self._embed, self._tail, *self._groups)
                         for i in u.idx)
        if covered != list(range(len(self.names))):
            raise ValueError(
                "offload_param: parameters outside the Llama layout "
                "(model.embed, model.layer_i, model.final_norm[, "
                "model.lm_head]): "
                f"{sorted(set(self.names) - {self.names[i] for i in covered})}")

        # --- the compute-dtype store ------------------------------------------
        pin = bool(pcfg.pin_memory) and device.type == "cuda"
        self._nvme = pcfg.device == "nvme"
        G = len(self._groups)
        # Twin-Flow: the first (1-ratio) fraction of the groups stay in RAM
        self._nvme_groups = [self._nvme and gi >= (1.0 - pcfg.ratio) * G
                             for gi in range(G)]
        self._store: Dict[int, PinnedHost] = {}     # unit key -> RAM store
        for key, unit in self._units():
            if not (key >= 0 and self._nvme_groups[key]):
                self._store[key] = PinnedHost(unit.numel, self.compute_dtype, pin)
        if self._nvme:
            self._aio = AsyncIOHandle(num_threads=max(2, pcfg.buffer_count))
            self._nvme_dir = os.path.join(pcfg.nvme_path,
                                          f"params_proc{_process_index()}")
            os.makedirs(self._nvme_dir, exist_ok=True)
            slot = max([u.numel for u, on in zip(self._groups,
                                                 self._nvme_groups) if on],
                       default=0)
            self._slots = [PinnedHost(slot, self.compute_dtype, pin)
                           for _ in range(2)]
            self._slot_done: List[Optional[torch.cuda.Event]] = [None, None]
        self._copy_stream = (torch.cuda.Stream(device)
                             if device.type == "cuda" else None)
        self._accum: List[Optional[torch.Tensor]] = [None] * len(self.names)
        self._scratch: Optional[torch.Tensor] = None
        self._copies: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self._fresh = [True] * len(self.names)
        self.bytes_streamed = 0            # per-step H2D stream volume
        self.bytes_down = 0                # per-step gradient D2H volume
        self.phase_seconds: Dict[str, float] = {}
        self.sync_store()
        log_dist(
            f"param offload: device={pcfg.device} groups={G} x{per} layers, "
            f"store={sum(s.tensor.numel() * s.tensor.element_size() for s in self._store.values()) / 1e6:.0f}MB"
            " RAM" + (f" + nvme@{self._nvme_dir}" if self._nvme else ""),
            ranks=[0])

    # --- units and the host store -------------------------------------------
    def _unit(self, prefixes: List[str]) -> _Unit:
        idx = [i for i, n in enumerate(self.names)
               if any(n.startswith(p) for p in prefixes)]
        if not idx:
            raise ValueError(
                f"offload_param: param subtree {prefixes!r} not found "
                "(expected the Llama layout model.embed, model.layer_i, "
                "model.final_norm[, model.lm_head])")
        sizes = [math.prod(self._shapes[i]) for i in idx]
        return _Unit(idx, list(np.cumsum([0] + sizes[:-1])), sum(sizes))

    def _units(self) -> List[Tuple[int, _Unit]]:
        """(key, unit): -1 the embedding, -2 the tail, g >= 0 layer group g."""
        return [(-1, self._embed), (-2, self._tail),
                *enumerate(self._groups)]

    def _group_file(self, gi: int) -> str:
        return os.path.join(self._nvme_dir, f"group{gi}.bin")

    def sync_store(self) -> None:
        """Compute-dtype store <- fp32 masters (after every optimizer update
        and after a restore), then the NVMe groups' files. One master at a
        time, so NVMe-swapped masters never all materialize in RAM."""
        for key, unit in self._units():
            if key in self._store:
                flat = self._store[key].tensor
            else:
                flat = self._slot_host(0)[:unit.numel]
            for i, off in zip(unit.idx, unit.offsets):
                dst = flat[off:off + math.prod(self._shapes[i])]
                m = self.opt.master(i).view(-1)
                if self.compute_dtype == torch.bfloat16:
                    to_bf16(m, out=dst)
                else:
                    dst.copy_(m)
            if key not in self._store:
                if self._aio.wait(self._aio.async_pwrite(
                        flat, self._group_file(key))):
                    raise RuntimeError("offload_param: nvme write-back failed")
        if self._nvme:
            self._slot_done = [None, None]

    def _slot_host(self, slot: int) -> torch.Tensor:
        done = self._slot_done[slot]
        if done is not None:           # a copy out of the slot may be running
            done.synchronize()
            self._slot_done[slot] = None
        return self._slots[slot].tensor

    # --- streaming ----------------------------------------------------------
    def _fetch(self, key: int) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Start the unit's copy onto the card: (device buffer, its event)."""
        unit = dict(self._units())[key]
        if key in self._store:
            host, slot = self._store[key].tensor, None
        else:                          # an NVMe group: read into its slot
            slot = key % 2
            host = self._slot_host(slot)[:unit.numel]
            if self._aio.wait(self._aio.async_pread(host, self._group_file(key))):
                raise RuntimeError(f"offload_param: nvme read failed (group {key})")
        buf = torch.empty(unit.numel, dtype=self.compute_dtype, device=self.device)
        self.bytes_streamed += unit.numel * buf.element_size()
        if self._copy_stream is None:
            buf.copy_(host)
            return buf, None
        # the buffer may be memory the compute stream just freed
        self._copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._copy_stream):
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._copy_stream)
            buf.copy_(host, non_blocking=True)
            done = torch.cuda.Event(enable_timing=True)
            done.record(self._copy_stream)
        self._copies.append((start, done))
        if slot is not None:
            self._slot_done[slot] = done
        return buf, done

    def _bind(self, key: int, fetched) -> None:
        """Point the unit's parameters at its streamed weights, once the
        compute stream has waited for their copy."""
        buf, done = fetched
        if done is not None:
            torch.cuda.current_stream(self.device).wait_event(done)
        unit = dict(self._units())[key]
        for i, off in zip(unit.idx, unit.offsets):
            self._params[i].data = buf[off:off + math.prod(self._shapes[i])
                                       ].view(self._shapes[i])

    def _unbind(self, key: int) -> None:
        empty = torch.empty(0, dtype=self.compute_dtype, device=self.device)
        for i in dict(self._units())[key].idx:
            self._params[i].data = empty

    def _accumulate(self, idx: List[int], grads) -> None:
        """Device gradients -> the fp32 host accumulators, through the
        bounded staging buffers (a copy on the first micro-batch; later
        ones widened into an fp32 scratch first, which torch adds several
        times faster than a mixed-dtype add, with the same sums)."""
        if self.device.type == "cuda":   # the backward's time is the stream's
            torch.cuda.current_stream(self.device).synchronize()
        t0 = time.perf_counter()
        elems = self.staging.elems
        for i, g in zip(idx, grads):
            if self._accum[i] is None:
                self._accum[i] = torch.empty(self._shapes[i], dtype=torch.float32)
            acc, src = self._accum[i].view(-1), g.reshape(-1)
            for a in range(0, src.numel(), elems):
                b = min(a + elems, src.numel())
                host = self.staging.down(src[a:b])
                self.bytes_down += host.numel() * host.element_size()
                if self._fresh[i]:
                    acc[a:b].copy_(host)
                else:
                    if self._scratch is None:
                        self._scratch = torch.empty(elems, dtype=torch.float32)
                    wide = self._scratch[:b - a]
                    acc[a:b].add_(wide.copy_(host))
            self._fresh[i] = False
        self._d2h_s += time.perf_counter() - t0

    # --- the streamed step --------------------------------------------------
    def _micro_grads(self, micro: Dict[str, torch.Tensor]) -> torch.Tensor:
        lm = self.model.model
        cd = self.compute_dtype
        ids = micro["input_ids"]
        positions = lm.positions_of(ids, micro.get("positions"))
        seg = micro.get("segment_ids")
        G = len(self._groups)
        blocks = [[getattr(lm, f"layer_{i}") for i in g]
                  for g in self._layer_groups]

        # ---- forward stream (group g+1 copies while g computes) ----
        with torch.no_grad():
            self._bind(-1, self._fetch(-1))
            x = lm.embed_tokens(ids, lm.table(cd))
            acts = []
            nxt = self._fetch(0) if G else None
            for gi in range(G):
                cur = nxt
                nxt = self._fetch(gi + 1) if gi + 1 < G else None
                acts.append(x)
                self._bind(gi, cur)
                x = lm.run_blocks(blocks[gi], x, positions, seg, cd)
                self._unbind(gi)
                del cur

        # ---- loss, the tail's gradients and its input's ----
        self._bind(-2, self._fetch(-2))
        tail = [self._params[i] for i in self._tail.idx]
        emb = self._params[self._embed.idx[0]]
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self.model.loss_of(lm.head(x, lm.table(cd), cd), micro)
            wrt = [x, *tail] + ([emb] if self.cfg.tie_embeddings else [])
            grads = torch.autograd.grad(loss, wrt)
        gx = grads[0]
        self._unbind(-2)
        self._accumulate(self._tail.idx, grads[1:1 + len(tail)])
        if self.cfg.tie_embeddings:
            self._accumulate(self._embed.idx, grads[-1:])
        del grads, x

        # ---- backward stream (group g-1 copies while g recomputes) ----
        nxt = self._fetch(G - 1) if G else None
        for gi in range(G - 1, -1, -1):
            cur = nxt
            nxt = self._fetch(gi - 1) if gi - 1 >= 0 else None
            self._bind(gi, cur)
            params = [self._params[i] for i in self._groups[gi].idx]
            x_in = acts[gi].requires_grad_(True)
            with torch.enable_grad():
                out = lm.run_blocks(blocks[gi], x_in, positions, seg, cd)
                grads = torch.autograd.grad(out, [x_in, *params],
                                            grad_outputs=gx)
            gx = grads[0]
            self._unbind(gi)
            acts[gi] = None
            del cur, out
            self._accumulate(self._groups[gi].idx, grads[1:])
            del grads
        with torch.enable_grad():
            x = lm.embed_tokens(ids, lm.table(cd))
            (g_emb,) = torch.autograd.grad(x, [emb], grad_outputs=gx)
        self._unbind(-1)
        self._accumulate(self._embed.idx, [g_emb])
        return loss.detach()

    def train_batch(self, batch: Dict[str, torch.Tensor], step: int
                    ) -> Tuple[float, float]:
        """One full batch (leaves stacked [gas, ...] on the device): gas
        streamed micro-batches and the host optimizer update at the
        schedule's lr of ``step``. Returns (loss, grad_norm) as host floats;
        the phases' wall times land in ``phase_seconds``."""
        gas = self.config.gradient_accumulation_steps
        self._fresh = [True] * len(self.names)
        self.bytes_streamed = 0
        self.bytes_down = 0
        self._d2h_s = 0.0
        self._copies = []
        t0 = time.perf_counter()
        losses = [self._micro_grads({k: v[g] for k, v in batch.items()})
                  for g in range(gas)]
        loss = float(np.mean([float(x) for x in losses]))
        t_stream = time.perf_counter()
        # the side stream's copy time (events; it overlaps the compute)
        h2d_s = sum(a.elapsed_time(b) for a, b in self._copies) / 1e3
        self._copies = []

        grads = []
        for i, fresh in enumerate(self._fresh):
            if fresh:                  # a leaf no micro-batch reached
                self._accum[i] = torch.zeros(self._shapes[i], dtype=torch.float32)
            grads.append(self._accum[i].div_(gas))
        sq = sum(float(torch.dot(g.view(-1), g.view(-1))) for g in grads)
        norm = float(np.sqrt(sq))
        clip = self.config.gradient_clipping
        if clip and clip > 0 and norm > clip:
            scale = clip / norm
            for g in grads:
                g.mul_(scale)
        lr = float(self.lr_schedule(step))
        self.opt.step(grads, lr=lr)
        t_opt = time.perf_counter()
        self.sync_store()
        t_end = time.perf_counter()
        self.phase_seconds = {
            "stream_fwd_bwd": t_stream - t0 - self._d2h_s,
            "h2d_copy_device": h2d_s,
            "grads_down": self._d2h_s,
            "host_optimizer": t_opt - t_stream,
            "store_refresh": t_end - t_opt,
        }
        return loss, norm

    # --- checkpoint interop ----------------------------------------------------
    @property
    def treedef(self) -> List[str]:
        """The tree's structure: the masters' dotted names, in order (the
        reference's pytree treedef)."""
        return list(self.names)

    def masters_tree(self):
        """The host fp32 masters as the flax parameter tree (numpy)."""
        from deepspeed_tpu_torch.models.convert import to_flax_tree
        return to_flax_tree(zip(self.names, self.opt.masters()))

    def load_masters(self, params_tree, reset_moments: bool = False) -> None:
        """Overwrite the masters from a flax parameter tree, then the
        compute-dtype store."""
        from deepspeed_tpu_torch.models.convert import _flax_leaf
        self.opt.set_masters(
            [torch.as_tensor(np.asarray(_flax_leaf(params_tree, n)),
                             dtype=torch.float32) for n in self.names],
            reset_moments=reset_moments)
        self.sync_store()

    def close(self) -> None:
        """Unregister the page-locked store and slots and stop the I/O
        engine's threads."""
        for s in self._store.values():
            s.close()
        if self._nvme:
            for s in self._slots:
                s.close()
            self._aio.close()
