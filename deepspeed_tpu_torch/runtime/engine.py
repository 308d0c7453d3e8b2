"""The training engine: ``train_batch``, DeepSpeed's micro-step loop and
the async step pipeline.

Port of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedTPUEngine``,
reference ``deepspeed/runtime/engine.py``). The JAX engine is one SPMD
program over ``NamedSharding``s; here each rank is a process running this
engine over the global mesh (``comm/mesh.py``) with explicit collectives.
The contract: the same config, initial parameters and global batch give
the same masters, loss and gradient norm on every rank as the JAX engine
on a mesh of the same shape.

- ``train_batch`` takes the global batch; each rank keeps the rows of its
  coordinate over ``BATCH_AXES`` (data, fsdp_out, fsdp), as the
  reference's batch sharding lays rows on devices.
- ``_compute_loss`` runs the model with every floating master cast to the
  compute dtype at its use (the reference's ``cast_to_compute``), so each
  micro-batch's gradient is the gradient with respect to the fp32 master
  through the cast.
- **Where the reduction sits.** As in the reference, each micro-batch's
  gradient is reduced before it is accumulated: XLA reduces the gradient
  of the global micro-batch inside the ``lax.scan`` of
  ``_make_grads_phase`` (``engine.py:810-900``), so the scan carries
  reduced gradients. Here the fp32 gradient of the local mean loss is
  summed over the batch axes (all-reduce; stage 2 reduce-scatters the
  sharded leaves, stage 3's gather reduce-scatters them in its backward)
  and divided by their world, then cast to ``grad_accum_dtype`` and
  summed over the micro-batches (autograd's own ``.grad`` would sum in
  fp32); after the sum it divides by ``scale * gas`` in fp32
  (reference ``:993``).
- qgZ (``zero_quantized_gradients``): with replica axes (batch axes no
  parameter is sharded over, ``runtime/zero/qgz.py``) only the other batch
  axes are reduced per micro-batch, and the accumulated gradients are
  mean-reduced over the replica axes with int8 on the wire
  (``quantized_grad_sync``), as the reference's partial-manual phase does
  (``engine.py:791``, ``wrap_grads_phase``). Without one, every reduced
  micro-batch gradient takes the int8 round trip through the kernels
  (``:781-805``), with the reference's warning.
- ZeRO stages over the mesh's ``fsdp`` axis (``runtime/zero/
  partition.py``): stage 1 keeps fp32 masters replicated and moments
  sharded, each rank updates its block of a sharded leaf and the masters
  are all-gathered; stage 2 also reduce-scatters the sharded leaves'
  gradients; stage 3 holds masters and moments as blocks, the module
  reads each sharded leaf through a parametrization that casts the block
  to the compute dtype and all-gathers it (``partition.GatherParam``,
  whose backward reduce-scatters; remat gathers again). Leaves under 2048
  elements, or with no dimension the ZeRO world divides, stay replicated.
  The loss, the global gradient norm and the overflow flag are reduced
  over the ranks, so every rank takes the same skip decision.
- The hierarchical world (reference ``engine.py:160-190``): MiCS
  (``mics_shard_size``) and ZeRO++ hpZ (``zero_hpz_partition_size``)
  split an explicit ``mesh.fsdp`` into ``fsdp_outer = fsdp / inner`` x
  ``fsdp = inner``. Under MiCS every ZeRO spec shards over ``fsdp`` only,
  so ``fsdp_out`` is a replica axis: its gradients are summed by the
  per-micro-batch all-reduce, beside the reduce-scatter over ``fsdp``.
  Under hpZ at stage 3 masters and moments stay blocks of the whole world;
  each micro-batch gathers every sharded leaf's compute-dtype block over
  ``fsdp_out`` once (``_compute_copy``: the secondary block; with qwZ,
  ``zero_quantized_weights``, as int8 codes and per-row scales,
  ``partition.QwzHop``), the layers gather that block over ``fsdp`` at
  each use (and again in remat's recompute), and the backward
  reduce-scatters over ``fsdp``, then over ``fsdp_out``. Below stage 3
  hpZ only splits the world, as in the reference.
- The replica-axis wire (the ``wire`` axes: the replica axes when qgZ,
  ``sparse_gradients`` or ``comm_compression`` is on): their reduction
  waits for the summed micro-batches. ``sparse_gradients``: an embedding
  leaf (2-D, >= 512 rows, ``embed`` in its path; off for tied embeddings)
  goes over the sparse (indices, values) wire where that is smaller
  (``runtime/sparse_tensor.py``), the rest int8 under qgZ or a
  full-precision mean. ``comm_compression``: the gradients in buckets, one
  ``quantized_all_reduce`` each with error feedback (``comm/compress.py``,
  the residuals in ``optimizer.state.error_feedback``); it supersedes qgZ,
  is off under the memory tiers and without a replica axis, and emits the
  ``comm/overlap`` spans.
- The expert axis (MoE, ZeRO stages 0-1): ``tensor_rules`` (by default
  ``moe_tensor_rules`` on a mesh with ``expert`` > 1) place each stacked
  expert leaf's leading dim over ``expert``, and the engine keeps this
  rank's block of it. Its gradient, like every other, takes the mean over
  the batch axes alone; the leaves no rule shards come out the same bytes
  on every expert rank without any reduction over ``expert``
  (``moe/sharded_moe.py`` places the layer's collectives and their
  backward so). The global norm sums an expert leaf's squares over
  ``expert`` once; under qgZ the gradient phase gates and dispatches over
  the batch axes outside the replica axes (``sharded_moe.token_axes``).
  A noisy gate raises: the reference's engine hands the model only a
  dropout rng stream.
- The tensor axis (Megatron tensor parallelism, ZeRO stages 0-3):
  ``tensor_rules`` (by default the model's own, ``llama_tensor_rules`` and
  the MoE models' compositions, on a mesh with ``tensor`` > 1) place each
  tensor-parallel leaf's heads, intermediate or vocabulary over
  ``tensor``, and the engine keeps this rank's block, on which ZeRO
  layers ``fsdp`` on another dimension. Every tensor rank takes the same
  micro-batch (``tensor`` is not a batch axis, so ``dp_world_size`` leaves
  it out, as the JAX mesh does). No gradient is reduced over ``tensor``:
  a sharded leaf's is its block's, and a replicated leaf's (the norm
  scales) is whole and the same on every rank, because the model's
  ``copy_to_tensor`` sums dX over ``tensor`` before each column-parallel
  product. The global norm sums a tensor-parallel leaf's squares over
  ``tensor`` and counts a replicated leaf once; the overflow flag is
  reduced over ``tensor`` too. qgZ and ``comm_compression`` run over the
  replica axes (batch axes no parameter uses), of which ``tensor`` is
  never one.
- The sequence axis (``mesh.sequence`` > 1, the ``ulysses`` and ``ring``
  backends): before the cut, the global batch gains next-token ``labels``
  and ``loss_mask`` aligned to all S positions (the last one masked, as
  the reference's chunked loss aligns them) and global ``positions``; each
  rank keeps its rows over the batch axes and its contiguous block of the
  sequence. A rank's loss is its masked sum over the token count summed
  over ``sequence`` (``models/llama.py::token_count``), so the sequence
  ranks' losses add up to the global mean. Each gradient is therefore
  summed over ``sequence`` in the same all-reduce that sums it over the
  batch axes, and divided by the batch axes' world only; the reported loss
  is summed over ``sequence``, then averaged over the batch axes. ZeRO
  shards over the fsdp axes only: sequence ranks hold replicas, as in the
  reference (``runtime/zero/partition.py:16-19``).
- ``_update`` is the reference's (``:1018-1057``): overflow check under
  fp16 or the non-finite guard, clipping by the global norm, the Adam
  update, and on overflow the old parameters, optimizer state and step
  kept while ``skipped_steps`` grows and the loss scale moves.

JAX keeps the skip decision on the device with ``jnp.where``; eager
PyTorch reads the overflow flag once per step, and only under fp16 or the
guard, and then skips the update instead of computing and discarding it
(ROADMAP Queue 3, divergence 52). Without them a step never waits for the
device.

The micro-step protocol (reference ``engine.py:1814-1959``), DeepSpeed's
``loss = engine(batch); engine.backward(loss); engine.step()``:

- ``forward(batch)`` (and ``engine(batch)``) takes this rank's rows of the
  global micro-batch, computes its loss and gradients (the activations
  are freed before it returns), reduces them over the micro-batch axes,
  casts them to ``grad_accum_dtype`` and, unlike ``train_batch``, reduces
  them over the wire axes too, per micro-batch: qgZ's int8 wire, sparse
  gradients, or ``comm_compression`` without error feedback (the
  residuals stay untouched: the reference defines them at the
  accumulation boundary only). It returns the loss, the gradients wait.
- ``backward(loss=None)`` folds the waiting gradients into the
  accumulation buffer (the first fold is the cast itself) and counts a
  micro step; its ``loss`` is ignored, as in the reference (divergence 50:
  DeepSpeed's own ``backward`` runs autograd on it).
- ``step()`` does nothing before the boundary; at it, the buffer divided
  by ``scale * gas`` in fp32 goes through ``_update`` (or, under the
  optimizer tier, the tier's host update, ``_host_update``), as in
  ``train_batch``. Under ``offload_param`` ``forward`` and ``step`` raise
  the reference's message.

The async step pipeline (``async_pipeline``, reference ``engine.py:575-612,
1553-1812``): ``train_batch`` pushes each step's loss and gradient norm
(device tensors) with its host lr and overflow flag on a ``DispatchRing``
and reads nothing back; the ring drains in one transfer every
``sync_every`` steps, at ``flush_metrics()`` and at
``configure_async_pipeline``, books the window into ``TRAIN_BATCH_TIMER``
and the throughput timer, writes the monitor's events and queues the host
entries for ``take_drained_metrics``. With ``prefetch`` a worker thread
stacks the next batch, takes this rank's rows and copies them to the card
from pinned memory on a side stream; the compute stream waits on the
copy's event. The tiers switch the pipeline off, as in the reference.
``csv_monitor`` receives the ``Train/Samples/*`` events at the
``steps_per_print`` boundaries.

The memory tiers (reference ``engine.py:238-338,1199-1306``), over the
``data``, ``fsdp`` and ``tensor`` axes:

- ``offload_optimizer`` (ZeRO-Offload, ``cpu`` or ``nvme``): the module
  holds compute-dtype parameters on the card; the fp32 masters and moments
  live only in the host optimizer (``runtime/offload.py``). Under the
  reference's single controller one host copy of every leaf serves the
  whole mesh; here each rank's host optimizer holds the block its card
  would hold (ROADMAP Queue 3, divergence 47): the whole tree at stage 0,
  the moments' ZeRO block at stages 1-2, the parameter block at stage 3,
  a tensor block first under ``tensor_rules``. A step's gradients are
  reduced and accumulated as above (stage 2 reduce-scatters into the
  block), then cast to fp32 and divided by ``scale * gas`` on the card,
  where the overflow check and the clipping norm are taken leaf by leaf
  (no second full copy) and reduced over the ranks, so every rank clips
  by the global norm and skips an overflowed step with the others; each
  leaf's clipped fp32 gradient block goes down through bounded pinned
  buffers (``runtime/staging.py``) into the fused host step at the
  schedule's lr, and the new compute-dtype shadow block goes back up; at
  stages 1-2 the shadow blocks are all-gathered over the ZeRO axes
  (``offload/all_gather`` in the comms logger), at stage 3 the block
  stays behind the parametrization. An overflow skips the host step,
  shrinks the loss scale and counts in ``skipped_steps``.
- ``offload_param`` (ZeRO-Infinity): ``runtime/param_offload.py`` streams
  the weights through the card one layer group at a time, each rank its
  rows of the batch and its tensor blocks.

Both emit the ``engine/train_step`` span (``mode`` ``offload`` or
``param_offload``) and keep each phase's seconds in ``phase_seconds``
(over ranks also the reduction's, ``reduce`` / ``grads_reduce``, and the
shadow gather's). The tiers with the ``expert`` or ``sequence`` axis and
the optimizer tier with MiCS, hpZ or qwZ are refused
(``config/config.py``).
"""

import contextlib
import math
import time
import warnings
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.comms_logging import get_comms_logger
from deepspeed_tpu_torch.comm.mesh import (BATCH_AXES, Mesh, create_mesh,
                                           get_data_parallel_world_size,
                                           set_global_mesh)
from deepspeed_tpu_torch.config.config import ITEM_MOE, DeepSpeedTPUConfig
from deepspeed_tpu_torch.moe.sharded_moe import token_axes
from deepspeed_tpu_torch.ops.cpu_adam import to_bf16
from deepspeed_tpu_torch.ops.optimizers import build_optimizer
from deepspeed_tpu_torch.ops.quant import dequantize_int8, quantize_int8
from deepspeed_tpu_torch.runtime import precision
from deepspeed_tpu_torch.runtime.dataloader import PrefetchLoader, StagedBatch
from deepspeed_tpu_torch.runtime.lr_schedules import build_schedule, constant_lr
from deepspeed_tpu_torch.runtime.param_offload import is_moe
from deepspeed_tpu_torch.runtime.sched import DispatchRing, StagedPrefetcher
from deepspeed_tpu_torch.runtime.staging import STAGING_ELEMS, Staging
from deepspeed_tpu_torch.runtime.zero import partition
from deepspeed_tpu_torch.runtime.zero.qgz import (MIN_QUANT_SIZE,
                                                  quantized_grad_sync,
                                                  replica_grad_axes)
from deepspeed_tpu_torch.telemetry.tracer import COMM_OVERLAP_TID, get_tracer
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER,
                                             FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER,
                                             SynchronizedWallClockTimer,
                                             ThroughputTimer,
                                             TRAIN_BATCH_DISPATCH_TIMER,
                                             TRAIN_BATCH_TIMER)


#: the comms logger's label of the optimizer tier's shadow all-gather
OFFLOAD_LABEL = "offload"


class StepOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    grad_norm: torch.Tensor
    lr: float
    overflow: bool


def _int8_round_trip(g: torch.Tensor) -> torch.Tensor:
    """qgZ's numerics on one card: ``dequantize_int8(*quantize_int8(g))``
    in g's dtype; tiny leaves (norm scales, biases) keep full precision."""
    if g.dim() < 1 or g.numel() < MIN_QUANT_SIZE:
        return g
    return dequantize_int8(*quantize_int8(g), dtype=g.dtype)


def _to_device(batch: Dict[str, Any], device: torch.device,
               non_blocking: bool = False) -> Dict[str, torch.Tensor]:
    """The batch's leaves as tensors on ``device``. ``non_blocking``: a
    host leaf goes to the card from pinned memory without waiting for the
    card's queue (a pageable copy waits for the stream to drain)."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(v))
        if non_blocking and device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def sequence_batch(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A global LM batch (leaves ``[..., S]``) with the next-token
    ``labels`` and ``loss_mask`` aligned to all S positions (the last one
    masked out; a given ``loss_mask`` shifted as the dense loss shifts it)
    and ``positions`` ``arange(S)``, for a cut over sequence ranks. Given
    ``labels`` are kept as they are."""
    out = {k: v if isinstance(v, torch.Tensor)
           else torch.from_numpy(np.ascontiguousarray(v))
           for k, v in batch.items()}
    ids = out["input_ids"]
    if "labels" not in out:
        out["labels"] = torch.nn.functional.pad(ids[..., 1:], (0, 1))
        mask = out.get("loss_mask")
        mask = mask[..., 1:] if mask is not None else \
            torch.ones_like(ids[..., 1:])
        out["loss_mask"] = torch.nn.functional.pad(mask.float(), (0, 1))
    if "positions" not in out:
        out["positions"] = torch.arange(
            ids.shape[-1], dtype=torch.int32).expand(ids.shape).contiguous()
    return out


QGZ_NO_REPLICA_MSG = (
    "zero_quantized_gradients=true but the mesh has NO replica batch axis "
    "(pure-fsdp ZeRO-3): there is no pure-DP all-reduce hop to compress, so "
    "NO bytes are saved on the wire. Gradients still pay the int8 "
    "round-trip quantization noise (reference-fidelity numerics). Either "
    "add a replica axis (a 'data' mesh axis, or split fsdp via "
    "mics_shard_size < world so 'fsdp_out' replicates) or disable "
    "zero_quantized_gradients. See docs/parallelism.md#qgz.")

COMPRESS_NO_REPLICA_MSG = (
    "comm_compression enabled but the mesh has NO replica batch axis "
    "(pure-fsdp ZeRO-3): there is no pure-DP all-reduce hop to compress, so "
    "NO bytes are saved on the wire — the group is ignored. Add a replica "
    "axis (a 'data' mesh axis, or split fsdp via mics_shard_size < world so "
    "'fsdp_out' replicates). See docs/performance.md#wire-compression--"
    "overlap.")


class DeepSpeedTPUEngine:
    def __init__(self, model: torch.nn.Module, config, params=None,
                 loss_fn: Optional[Callable] = None,
                 lr_scheduler: Optional[Callable[[int], float]] = None,
                 client_optimizer=None, device=None,
                 mesh: Optional[Mesh] = None,
                 tensor_rules: Optional[Callable] = None):
        self.config = config if isinstance(config, DeepSpeedTPUConfig) \
            else DeepSpeedTPUConfig(config)
        config = self.config
        self.device = resolve_device(device)
        # --- the hierarchical ZeRO world (MiCS / ZeRO++ hpZ) -------------
        zc = config.zero_config
        self._mics = zc.mics_shard_size is not None and zc.mics_shard_size > 0
        self._hpz = int(zc.zero_hpz_partition_size or 1)
        if self._mics and self._hpz > 1:
            raise ValueError(
                "mics_shard_size and zero_hpz_partition_size are mutually "
                "exclusive: MiCS already replicates across shard groups, so an "
                "hpZ secondary shard would be a no-op")
        inner = zc.mics_shard_size if self._mics else (
            self._hpz if self._hpz > 1 else 0)
        if inner and mesh is None:
            if config.mesh.fsdp == -1:
                raise ValueError("MiCS/hpZ needs an explicit mesh.fsdp size "
                                 "to split")
            if config.mesh.fsdp_outer == 1 and config.mesh.fsdp > inner:
                if config.mesh.fsdp % inner:
                    raise ValueError(f"fsdp={config.mesh.fsdp} not divisible "
                                     f"by shard group {inner}")
                config.mesh.fsdp_outer = config.mesh.fsdp // inner
                config.mesh.fsdp = inner
        # --- the mesh: one rank per process over torch.distributed --------
        self.mesh = mesh if mesh is not None else \
            create_mesh(config.mesh, device=self.device)
        set_global_mesh(self.mesh)
        if inner and self.mesh.shape["fsdp"] != inner \
                and self.mesh.shape["fsdp_out"] == 1:
            log_dist(f"MiCS/hpZ shard group {inner} != mesh fsdp "
                     f"{self.mesh.shape['fsdp']}; using mesh layout as-is",
                     ranks=[0])
        self.dp_world_size = get_data_parallel_world_size(self.mesh)
        config.resolve_batch_sizes(self.dp_world_size)
        self.train_batch_size = config.train_batch_size
        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.compute_dtype = config.precision_dtype
        self.zero_stage = config.zero_config.stage
        self.loss_fn = loss_fn
        # model-parallel placement rules: on a tensor axis the model's own
        # Megatron rules (``tensor_rules`` of the port's models), else the
        # expert rules by default on an expert axis, as moe_tensor_rules
        # shards the expert leaves
        tp = self.mesh.shape["tensor"]
        if tensor_rules is None and tp > 1:
            tensor_rules = getattr(model, "tensor_rules", None)
        if tensor_rules is None and self.mesh.shape["expert"] > 1:
            from deepspeed_tpu_torch.moe.sharded_moe import moe_tensor_rules
            tensor_rules = moe_tensor_rules
        self.tensor_rules = tensor_rules
        # a port model checks that its heads split (before the cut)
        check_heads = getattr(model, "check_tensor_parallel", None)
        if tp > 1 and check_heads is not None:
            check_heads(tp)
        self._refuse_noisy_gating(model)
        self._seq_axes = self.mesh.live_axes(("sequence",))
        if self._seq_axes:
            from deepspeed_tpu_torch.moe.sharded_moe import (
                moe_layers, refuse_sequence_axis)
            if moe_layers(model):
                refuse_sequence_axis(self.mesh)
        self.training = True
        self._compiled = False
        log_dist(f"engine: {config!r} mesh={dict(self.mesh.shape)} "
                 f"device={self.device}", ranks=[0])
        if config.comms_logger.enabled:
            get_comms_logger().configure(enabled=True,
                                         verbose=config.comms_logger.verbose)
        self._offload = None          # the host optimizer of either tier
        self._param_offload = None    # the ZeRO-Infinity streamed trainer
        self.phase_seconds: Dict[str, float] = {}
        self.phase_bytes: Dict[str, int] = {}
        if zc.offload_param.device != "none":
            from deepspeed_tpu_torch.runtime.param_offload import (
                validate_param_offload)
            # fail fast, before any host allocation
            validate_param_offload(config, model)
        elif zc.offload_optimizer.device not in ("none", "cpu", "nvme"):
            raise ValueError("offload_optimizer.device must be none|cpu|nvme, "
                             f"got {zc.offload_optimizer.device!r}")
        tier = "param" if zc.offload_param.device != "none" else \
            "optimizer" if zc.offload_optimizer.device != "none" else None
        if tier == "param" and self.mesh.size > 1 and is_moe(model):
            raise NotImplementedError(
                f"offload_param over the MoE block stack at {self.mesh.size} "
                f"ranks is not ported yet ({ITEM_MOE}: the expert axis with "
                "the memory tiers); the stack streams at one rank")
        if tier is not None and client_optimizer is not None:
            raise ValueError(
                f"offload_{tier} requires a config-typed optimizer (the "
                "update runs in the fused host kernel, not a client optimizer)")

        # --- LR schedule ----------------------------------------------------
        if lr_scheduler is not None:
            self.lr_schedule = lr_scheduler
        elif config.scheduler and config.scheduler.type:
            self.lr_schedule = build_schedule(config.scheduler.type,
                                              dict(config.scheduler.params))
        else:
            base_lr = (config.optimizer.params.get("lr", 1e-3)
                       if config.optimizer else 1e-3)
            self.lr_schedule = constant_lr(lr=base_lr)

        opt_type = config.optimizer.type if config.optimizer else "adamw"
        opt_params = dict(config.optimizer.params) if config.optimizer else {}
        # --- fp32 master weights --------------------------------------------
        for p in model.parameters():
            if p.is_floating_point() and p.dtype != torch.float32:
                p.data = p.data.float()
        if params is not None:
            from deepspeed_tpu_torch.models.convert import load_flax_params
            load_flax_params(model, params)
        self._param_tier = tier == "param"
        # under the parameter tier the weights stay where they are until the
        # trainer takes them to the host (cut to their tensor blocks first)
        self.model = model if self._param_tier else model.to(self.device)
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.requires_grad]
        self._param_names: List[str] = [n for n, _ in named]
        # the tensors gradients are taken against: the fp32 masters (a
        # stage-3 leaf's block), or under the optimizer tier the
        # compute-dtype shadows
        self._masters: List[torch.Tensor] = [p for _, p in named]
        del named
        # the parameter tier streams whole leaves or tensor blocks: no ZeRO
        # placement (the reference's streamed step ignores the stage)
        self._place_zero(0 if self._param_tier else self.zero_stage)
        if self._param_tier:
            # --- ZeRO-Infinity: the weights stream through the card ---------
            from deepspeed_tpu_torch.runtime.param_offload import (
                ParamOffloadTrainer)
            self._param_offload = ParamOffloadTrainer(
                model, config, self.lr_schedule, self.device,
                staging_elems=STAGING_ELEMS, mesh=self.mesh,
                tensor_dim=self._tensor_dim)
            self._offload = self._param_offload.opt
            self.optimizer = self._offload
            self._masters = []
        self._quantized_weights = bool(zc.zero_quantized_weights)
        if self._quantized_weights and not self._hpz_leaves:
            log_dist("zero_quantized_weights (qwZ) takes effect on the hpZ "
                     "secondary gather; set zero_hpz_partition_size > 1 — "
                     "ignored", ranks=[0])
            self._quantized_weights = False
        self._quantized_gradients = bool(zc.zero_quantized_gradients)
        self._qgz_axes: Tuple[str, ...] = ()
        if self._quantized_gradients:
            self._qgz_axes = self._replica_axes
            if self._qgz_axes:
                log_dist("qgZ: int8-wire gradient reduction over replica "
                         f"axes {self._qgz_axes} (hierarchical quantized "
                         "reduce-scatter + regather)", ranks=[0])
            else:
                warnings.warn("qgZ: " + QGZ_NO_REPLICA_MSG, UserWarning,
                              stacklevel=3)
                logger.warning("qgZ: %s", QGZ_NO_REPLICA_MSG)
        self._setup_sparse_gradients(model)
        self._setup_comm_compression(tier)
        self._wire_axes: Tuple[str, ...] = (
            self._replica_axes if self._comm_compress is not None
            else self._qgz_axes or self._sparse_grad_axes)
        self._reduce_plan()
        self._time_reduce = False
        self._reduce_s = 0.0
        if tier == "optimizer":
            # --- ZeRO-Offload: masters and moments in the host optimizer -----
            # each rank's host state is the block its card would hold: the
            # moments' ZeRO block at stages 1-2, the parameter block at
            # stage 3, the whole leaf at stage 0 (tensor blocks first)
            from deepspeed_tpu_torch.runtime.offload import HostOffloadOptimizer
            ocfg = zc.offload_optimizer
            self._staging = Staging(self.device, ocfg.pin_memory, STAGING_ELEMS)
            host = []
            with torch.no_grad():
                for p, t in zip(self._masters, self._opt_tensors()):
                    h = self._staging.to_host(t)
                    if t is not p and h.data_ptr() == t.data_ptr():
                        h = h.clone()     # a view would keep the whole leaf
                    host.append(h)
            self._offload = HostOffloadOptimizer(host, opt_type, opt_params,
                                                 ocfg)
            del host
            self._time_reduce = self.mesh.size > 1
            for p in self._masters:       # the card keeps compute-dtype shadows
                p.data = p.data.to(self.compute_dtype, copy=True)
            self.optimizer = self._offload

        # --- optimizer (the tiers' is the host optimizer above) -------------
        if tier is None:
            if client_optimizer is not None:
                if not (hasattr(client_optimizer, "init")
                        and hasattr(client_optimizer, "step")):
                    raise TypeError("client optimizer must have init(params) "
                                    "and step(params, grads), got "
                                    f"{type(client_optimizer)}")
                self.optimizer = client_optimizer
            else:
                self.optimizer = build_optimizer(opt_type, opt_params,
                                                 lr_schedule=self.lr_schedule)
                if hasattr(self.optimizer, "reduce_leaf_sums"):
                    # LAMB's trust ratio takes the norms of whole leaves
                    self.optimizer.reduce_leaf_sums = self._whole_leaf_sums
            if self._comm_compress is not None:
                # the residuals ride the optimizer's state, beside the moments
                from deepspeed_tpu_torch.comm.compress import (
                    with_error_feedback)
                comp = self._comm_compress
                self.optimizer = with_error_feedback(
                    self.optimizer,
                    lambda: comp.zero_error_feedback(self.device))
            self.optimizer.init(self._opt_tensors())

        self.loss_scale = precision.init_loss_scale(config.fp16)
        self.step_count = 0           # applied updates (the reference's state.step)
        self._skipped_steps = 0
        self.global_steps = 0
        self.micro_steps = 0
        self.global_samples = 0
        self._guard_nonfinite = False
        self._last_metrics: Dict[str, Any] = {}
        # the micro-step protocol: the forward's gradients, the buffer
        self._pending: Optional[Tuple[torch.Tensor, List[torch.Tensor]]] = None
        self._grad_buffer: Optional[List[torch.Tensor]] = None
        self._accum_count = 0
        self._setup_async_pipeline(tier)
        self.timers = SynchronizedWallClockTimer(
            synchronize=config.wall_clock_breakdown)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size,
            steps_per_output=config.steps_per_print,
            synchronize=config.wall_clock_breakdown
            and not self._async_enabled)
        self.monitor = None
        if config.csv_monitor.enabled:
            from deepspeed_tpu_torch.monitor.monitor import CSVMonitor
            self.monitor = CSVMonitor(config.csv_monitor)

    def _setup_async_pipeline(self, tier) -> None:
        """``async_pipeline`` (reference ``engine.py:575-612``): the ring,
        the prefetcher's lifecycle, the cadence (1 while off); off under
        either memory tier, whose host step is synchronous."""
        acfg = self.config.async_pipeline
        self._async_enabled = bool(acfg.enabled)
        if self._async_enabled and tier is not None:
            log_dist("async_pipeline: disabled — offload tiers run a "
                     "host-synchronous optimizer step (nothing to defer)",
                     ranks=[0])
            self._async_enabled = False
        # the configured cadence survives enable/disable toggles
        self._sync_every_cfg = int(acfg.sync_every)
        self._sched = DispatchRing()
        self._staged = StagedPrefetcher()
        self._sched.sync_every = self._sync_every_cfg \
            if self._async_enabled else 1
        self._prefetch_enabled = self._async_enabled and bool(acfg.prefetch)
        self._staged.depth = int(acfg.prefetch_depth)
        self._copy_stream = None        # the prefetch's side stream
        self.staged_waits = 0           # staged batches whose copy was waited on
        if self._async_enabled and self.config.wall_clock_breakdown:
            log_dist("async_pipeline: wall_clock_breakdown forces a device "
                     "sync per timer start/stop — the breakdown timers will "
                     "serialize the pipeline they are measuring", ranks=[0])

    # ------------------------------------------------------------------
    # ZeRO placement over the mesh
    # ------------------------------------------------------------------
    @staticmethod
    def _refuse_noisy_gating(model) -> None:
        """The reference's engine hands the model only a ``dropout`` rng
        stream (``engine.py:80-92``), so a noisy gate, which draws from a
        ``gating`` stream, fails there; the port refuses it here."""
        from deepspeed_tpu_torch.moe.sharded_moe import moe_layers
        for layer in moe_layers(model):
            if layer.cfg.noisy_gate_policy:
                raise NotImplementedError(
                    f"noisy_gate_policy={layer.cfg.noisy_gate_policy!r} "
                    "through train_batch: the reference's engine passes the "
                    "model only a dropout rng stream (engine.py:80-92), none "
                    "for the gate; call the model with a generator instead")

    def _place_zero(self, stage: int) -> None:
        """Each leaf's param and optimizer-state spec (layered on its
        tensor rule; over ``fsdp`` only under MiCS), the dimension its
        moments (and under stage 3 its master) are sharded along, each
        expert leaf cut to this rank's block of the ``expert`` axis and
        each tensor-parallel leaf to its block of ``tensor``, then the
        stage-3 parametrizations that gather a block over the ZeRO axes
        before use (under hpZ from the secondary block,
        ``_compute_copy``)."""
        mesh = self.mesh
        self._zero_axes, self._zero_world = partition.zero_fsdp_axes(
            mesh, mics=self._mics)
        self._batch_axes = tuple(a for a in BATCH_AXES if a in mesh.shape)
        shapes = {n: tuple(p.shape)
                  for n, p in zip(self._param_names, self._masters)}
        # the reference's tree paths, for the wire policies' rules
        self._paths = [n.replace(".", "/") for n in self._param_names]
        self._full_shapes = {self._paths[i]: s
                             for i, s in enumerate(shapes.values())}
        specs = partition.leaf_specs(shapes, mesh, stage, self.tensor_rules,
                                     mics=self._mics)
        self._param_specs = specs["param"]
        self._expert_dim: List[Optional[int]] = [
            partition.sharded_dim(sp, ("expert",))
            if mesh.shape["expert"] > 1 else None
            for sp in self._param_specs]
        self._tensor_dim: List[Optional[int]] = [
            partition.sharded_dim(sp, ("tensor",))
            if mesh.shape["tensor"] > 1 else None
            for sp in self._param_specs]
        with torch.no_grad():
            for dims, axis in ((self._expert_dim, "expert"),
                               (self._tensor_dim, "tensor")):
                for i, d in enumerate(dims):
                    if d is not None:
                        p = self._masters[i]
                        p.data = partition.shard_of(p.data, d, mesh,
                                                    (axis,)).clone()
        self._replica_axes = replica_grad_axes(mesh, self._batch_axes,
                                               self._param_specs) \
            if not self._param_tier else ()
        n = len(shapes)
        self._opt_dim: List[Optional[int]] = [None] * n
        self._param_dim: List[Optional[int]] = [None] * n
        # hpZ at stage 3: (leaf, its parametrization) of every sharded leaf
        self._hpz_leaves: List[Tuple[int, Any]] = []
        hpz = self._hpz > 1 and stage >= 3 and mesh.shape["fsdp_out"] > 1
        self._block_axes = partition.HPZ_BLOCK_AXES if hpz \
            else self._zero_axes
        if self._zero_world <= 1 or stage < 1:
            return
        for i in range(n):
            self._opt_dim[i] = partition.sharded_dim(specs["opt"][i],
                                                     self._zero_axes)
            if stage >= 3:
                self._param_dim[i] = partition.sharded_dim(
                    self._param_specs[i], self._zero_axes)
        if stage < 3:
            return
        from torch.nn.utils import parametrize
        for i, name in enumerate(self._param_names):
            dim = self._param_dim[i]
            if dim is None:
                continue
            owner, attr = name.rsplit(".", 1)
            module = self.model.get_submodule(owner)
            sharded = partition.ShardedParam(
                dim, ("fsdp",) if hpz else self._zero_axes, mesh,
                self.compute_dtype, block_axes=self._block_axes,
                secondary=hpz)
            parametrize.register_parametrization(module, attr, sharded,
                                                 unsafe=True)
            self._masters[i] = module.parametrizations[attr].original
            if hpz:
                self._hpz_leaves.append((i, sharded))

    @contextlib.contextmanager
    def _compute_copy(self):
        """hpZ: this micro-batch's secondary blocks (reference
        ``_hpz_constrain``, ``engine.py:741-764``): each sharded leaf's
        compute-dtype block gathered over ``fsdp_out`` once, its backward a
        reduce-scatter over ``fsdp_out``; under qwZ a leaf of two or more
        dimensions goes as int8 codes and per-row scales
        (``partition.QwzHop``, straight-through). Set on the
        parametrizations for the forward, the recompute and the backward,
        cleared after."""
        if not self._hpz_leaves:
            yield
            return
        try:
            for i, pz in self._hpz_leaves:
                block = self._masters[i].to(self.compute_dtype)
                if self._quantized_weights and block.dim() >= 2:
                    sec = partition.QwzHop.apply(
                        block, pz.dim, ("fsdp_out",), self._zero_axes)
                else:
                    sec = partition.GatherParam.apply(
                        block, pz.dim, ("fsdp_out",), partition.HPZ_LABEL)
                pz.secondary = sec
            yield
        finally:
            for _, pz in self._hpz_leaves:
                pz.secondary = None

    def _setup_sparse_gradients(self, model) -> None:
        """The embedding leaves whose gradients go over the sparse wire
        (reference ``engine.py:455-492``): 2-D, at least 512 rows, ``embed``
        in the path; none when the model ties its embeddings (the head's
        gradient is dense over the vocabulary)."""
        self.sparse_gradients_enabled = self.config.sparse_gradients_enabled
        self._sparse_grad_axes: Tuple[str, ...] = ()
        self._sparse_grad_paths: Tuple[str, ...] = ()
        if not self.sparse_gradients_enabled:
            return
        mcfg = getattr(model, "cfg", None)
        tied = bool(getattr(mcfg, "tie_embeddings", False) or
                    getattr(mcfg, "tie_word_embeddings", False))
        axes = self._replica_axes
        paths = () if tied else tuple(
            p for p, shape in self._full_shapes.items()
            if len(shape) == 2 and shape[0] >= 512 and "embed" in p.lower())
        if axes and paths:
            self._sparse_grad_axes = axes
            self._sparse_grad_paths = paths
            log_dist(f"sparse_gradients: sparse wire reduction over {axes} "
                     f"for {len(paths)} embedding leaves (top-k rows = batch "
                     "tokens — exact for lookup-only embedding grads)",
                     ranks=[0])
        else:
            log_dist("sparse_gradients: "
                     + ("model ties its embeddings (dense head grads) — "
                        if tied else
                        "no replica batch axis or no embedding-like leaf — ")
                     + "gradients reduce densely", ranks=[0])

    def _setup_comm_compression(self, tier) -> None:
        """``comm_compression`` (reference ``engine.py:495-575``): the
        bucket plan over the replica axes, on the gradients this rank
        reduces (a block where ZeRO shards it), in the reference's
        tree-flatten order, the sparse embedding leaves left out. It owns
        the wire: qgZ defers to it."""
        ccfg = self.config.comm_compression
        self._comm_compress = None
        self._overlap_meta: List[Dict[str, Any]] = []
        self._overlap_wire_total = 0
        self._new_ef = ()
        if not ccfg.enabled:
            return
        if tier is not None:
            log_dist("comm_compression: disabled — offload tiers run a "
                     "host-synchronous optimizer step whose reductions keep "
                     "today's wire format", ranks=[0])
            return
        if not self._replica_axes:
            warnings.warn(COMPRESS_NO_REPLICA_MSG, UserWarning, stacklevel=4)
            logger.warning(COMPRESS_NO_REPLICA_MSG)
            return
        from deepspeed_tpu_torch.comm.compress import GradCompressor
        comp = GradCompressor(ccfg, self._replica_axes, self.mesh)
        acc_dtype = self.config.grad_accum_dtype
        comp.build([(self._paths[i], self._reduced_shape(i), acc_dtype)
                    for i in range(len(self._masters))],
                   itemsize=torch.empty((), dtype=acc_dtype).element_size(),
                   exclude_paths=self._sparse_grad_paths,
                   full_sizes={p: math.prod(s) for p, s
                               in self._full_shapes.items()})
        if not comp.buckets:
            log_dist("comm_compression: no leaf meets min_size "
                     f"({ccfg.min_size}) — nothing to compress", ranks=[0])
            return
        self._comm_compress = comp
        self._overlap_meta = comp.bucket_summaries() if ccfg.overlap else []
        self._overlap_wire_total = max(
            sum(b["wire_bytes"] for b in self._overlap_meta), 1)
        if self._quantized_gradients:
            log_dist("comm_compression supersedes zero_quantized_gradients "
                     "on the replica axes (one compression layer owns the "
                     "wire)", ranks=[0])
            self._qgz_axes = ()
            self._quantized_gradients = False
        log_dist(f"comm_compression: {len(comp.buckets)} bucket(s) over "
                 f"{self._replica_axes} (wire={ccfg.wire_dtype}, "
                 f"chunk={ccfg.chunk}, error_feedback="
                 f"{'on' if comp.ef_enabled() else 'off'}, overlap="
                 f"{'per-bucket' if ccfg.overlap else 'fused'})", ranks=[0])

    def _reduced_shape(self, i: int) -> Tuple[int, ...]:
        """The shape of leaf ``i``'s gradient as the wire reduces it: the
        block at stage 3 (or stage 2 where the ZeRO axes are reduced per
        micro-batch), else the leaf."""
        shape = list(self._masters[i].shape)
        if self.zero_stage == 2 and self._opt_dim[i] is not None and not (
                set(self.mesh.live_axes(self._zero_axes))
                & set(self._replica_axes)):
            shape[self._opt_dim[i]] //= self._zero_world
        return tuple(shape)

    def _reduce_plan(self) -> None:
        """Which axes each micro-batch's gradient is summed over (the batch
        axes outside the wire axes, whose reduction waits for the summed
        micro-batches), and which leaves' gradients are held as blocks."""
        mesh = self.mesh
        self._micro_axes = mesh.live_axes(
            [a for a in self._batch_axes if a not in self._wire_axes])
        self._micro_world = mesh.axis_world(self._micro_axes)
        zero_reduced = not (set(mesh.live_axes(self._zero_axes))
                            & set(self._wire_axes))
        self._grad_dim: List[Optional[int]] = [
            self._param_dim[i] if self.zero_stage >= 3 else
            self._opt_dim[i] if self.zero_stage == 2 and zero_reduced else
            None for i in range(len(self._masters))]
        self._sharded_grads = any(d is not None for d in self._grad_dim)

    def _opt_tensors(self) -> List[torch.Tensor]:
        """What the optimizer updates: each leaf's master, or this rank's
        block of it where the moments are sharded (a view below stage 3)."""
        out = []
        for i, p in enumerate(self._masters):
            d = self._opt_dim[i]
            if d is None or self._param_dim[i] is not None:
                out.append(p)
            else:
                out.append(partition.shard_of(p.data, d, self.mesh,
                                              self._zero_axes))
        return out

    # ------------------------------------------------------------------
    # loss and gradients
    # ------------------------------------------------------------------
    def _compute_loss(self, batch) -> torch.Tensor:
        out = self.model(batch, compute_dtype=self.compute_dtype)
        if self.loss_fn is not None:
            out = self.loss_fn(out, batch)
        if isinstance(out, tuple):
            out = out[0]
        return out.float()

    def _grads_one_micro(self, batch, scale: float):
        """Loss and the gradients of ``loss * scale`` with respect to the
        fp32 masters, each reduced over this micro-batch's axes. With qgZ
        and no replica axis every gradient of at least ``MIN_QUANT_SIZE``
        elements then takes the int8 round trip through the kernels (rows
        are its last axis)."""
        with self._compute_copy():
            loss = self._compute_loss(batch)
            grads = list(torch.autograd.grad(loss * scale, self._masters))
        t = self._reduce_clock()
        grads = self._reduce_micro(grads)
        if self._quantized_gradients and not self._qgz_axes:
            grads = [self._round_trip(g, d)
                     for g, d in zip(grads, self._grad_dim)]
        self._reduce_s += self._reduce_clock() - t
        return loss.detach(), grads

    def _reduce_clock(self) -> float:
        """The host clock, after the card's queued work, when the optimizer
        tier times its reductions over ranks (``phase_seconds["reduce"]``);
        0 otherwise."""
        if not self._time_reduce:
            return 0.0
        self._sync()
        return time.perf_counter()

    def _reduce_micro(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum each gradient of the local mean loss over the micro-batch
        axes and divide by their world: the gradient of the mean over the
        global micro-batch. Stage 2 reduce-scatters a sharded leaf into its
        block (stage 3's gather already did in its backward), then sums the
        block over the other axes. Over ``sequence`` the gradients are
        summed, in the same all-reduce. ``grads`` is reduced in place, a
        leaf at a time, so one extra leaf is alive at once."""
        if self._micro_world <= 1 and not self._seq_axes:
            return grads
        zero = set(self._zero_axes)
        for i, d in enumerate(self._grad_dim):
            g = grads[i]
            axes = self._micro_axes
            if d is not None:
                if self.zero_stage == 2:
                    g = partition.reduce_scatter_full(g, d, self._zero_axes)
                axes = tuple(a for a in axes if a not in zero)
            axes = self.mesh.live_axes(axes + self._seq_axes)
            if axes:
                g = comm.all_reduce(g, axes)
            grads[i] = g / self._micro_world if self._micro_world > 1 else g
        return grads

    def _round_trip(self, g: torch.Tensor, dim: Optional[int]):
        """The int8 round trip of a reduced gradient, row by row over its
        last axis. A block split along its last axis is gathered first, so
        its rows are the full leaf's rows, then cut again."""
        if dim is None or dim != g.dim() - 1:
            return _int8_round_trip(g)
        full = partition.gather_full(g, dim, self._block_axes)
        return partition.shard_of(_int8_round_trip(full), dim, self.mesh,
                                  self._block_axes).contiguous()

    def _grads_phase(self, stacked: Dict[str, torch.Tensor], scale: float):
        """(mean loss over the ranks, per-micro gradients summed in
        grad_accum_dtype; with wire axes, then mean-reduced over them:
        ``comm_compression``'s buckets, or per leaf sparse, int8 (qgZ) or
        in full precision)."""
        gas = self.gradient_accumulation_steps
        acc_dtype = self.config.grad_accum_dtype
        acc: Optional[List[torch.Tensor]] = None
        loss_sum = torch.zeros((), device=self.device)
        # with wire axes the phase is manual over them: an MoE layer gates
        # and dispatches over the other batch axes only
        for i in range(gas):
            with (token_axes(self._micro_axes) if self._wire_axes
                  else contextlib.nullcontext()):
                loss, grads = self._grads_one_micro(
                    {k: v[i] for k, v in stacked.items()}, scale)
            loss_sum += loss
            if acc is None:           # 0 + g: the first sum is the cast itself
                acc = [g.to(acc_dtype) for g in grads]
            else:
                for a, g in zip(acc, grads):
                    a.add_(g.to(acc_dtype))
            del grads
        loss = loss_sum / gas
        t = self._reduce_clock()
        if self._comm_compress is not None:
            sync = self._comm_compress.make_sync_fn(
                fallback_leaf_sync=self._make_grad_sync(self._replica_axes))
            ef = self.optimizer.state.error_feedback
            reduced, self._new_ef = sync(dict(zip(self._paths, acc)),
                                         stacked, ef)
            acc = [reduced.pop(p) for p in self._paths]
            del reduced
        elif self._wire_axes:         # a leaf at a time: each sum is freed
            sync = self._make_grad_sync(self._wire_axes)
            for i in range(len(acc)):
                acc[i] = sync(self._paths[i], acc[i], stacked)
        self._reduce_s += self._reduce_clock() - t
        return self._global_loss(loss), acc

    def _batch_token_count(self, stacked: Dict[str, torch.Tensor]) -> int:
        """k for the sparse wire (reference ``engine.py:872-881``): the
        tokens of the batch the replica group's member reduces, the
        largest integer leaf of the stacked [gas, micro, ...] batch; a
        lookup-only embedding gradient touches at most one row per token.
        A rank holds its rows over every batch axis, the reference's
        manual region those over the wire axes only, so this rank's count
        is multiplied by the world of the other batch axes (whose members'
        gradients the per-micro-batch reduction already summed)."""
        local = max((v.numel() for v in stacked.values()
                     if not v.is_floating_point()
                     and v.dtype != torch.bool), default=0)
        return local * self._micro_world

    def _sparse_wire_policy(self, axes):
        """The sparse-embedding wire rule (reference ``engine.py:883-911``),
        shared by the per-leaf sync and ``comm_compression``'s fallback:
        ``fn(path, g, k_tokens) -> reduced | None`` (None: not a leaf that
        gains, the caller's dense policy applies), or None without sparse
        leaves. The win test is the reference's on the whole leaf,
        ``k (d + 1) world < v d`` with ``k = min(v, k_tokens)``; a rank's
        block keeps ``min(its rows, k_tokens)`` rows, every row it can
        touch."""
        if not self._sparse_grad_paths or not axes:
            return None
        from deepspeed_tpu_torch.runtime.sparse_tensor import sparse_grad_sync
        sparse_paths = set(self._sparse_grad_paths)
        world = self.mesh.axis_world(axes)

        def leaf_rule(p, g, k_tokens):
            if p not in sparse_paths or not k_tokens:
                return None
            v, d = self._full_shapes[p]
            k = min(v, k_tokens)
            if k * (d + 1) * world < v * d:
                return sparse_grad_sync(g, axes, min(g.shape[0], k_tokens))
            return None

        return leaf_rule

    def _make_grad_sync(self, axes):
        """The per-leaf wire policy (reference ``engine.py:913-957``):
        ``fn(path, g, batch)`` sends embedding leaves over the sparse wire
        (``_sparse_wire_policy``), the rest int8 (qgZ) or as a
        full-precision mean. Under ``comm_compression`` (qgZ off) it is
        the sync of the leaves outside every bucket."""
        sparse_rule = self._sparse_wire_policy(axes)
        qgz_on = bool(self._qgz_axes)

        def leaf_sync(path, g, batch):
            if sparse_rule is not None:
                out = sparse_rule(path, g, self._batch_token_count(batch))
                if out is not None:
                    return out
            if qgz_on:
                return quantized_grad_sync([g], axes)[0]
            return comm.all_reduce(g, axes, comm.ReduceOp.AVG)

        return leaf_sync

    def _emit_overlap_spans(self, t0: float, t1: float) -> None:
        """Per-bucket ``comm/overlap`` spans on the ``COMM_OVERLAP_TID``
        track (reference ``engine.py:1319-1340``): the step's window [t0,
        t1] divided over the buckets in proportion to their wire bytes. The
        split is synthetic, as the reference's is: the port's buckets run
        one after another after the backward, so the spans say how the
        window would divide, not when each bucket ran."""
        comp = self._comm_compress
        window = max(t1 - t0, 0.0)
        end = t0
        tracer = get_tracer()
        for b in self._overlap_meta:
            dur = window * (b["wire_bytes"] / self._overlap_wire_total)
            end += dur
            tracer.complete("comm/overlap", dur, cat="comm", end_ts=end,
                            tid=COMM_OVERLAP_TID, bucket=b["index"],
                            bytes=b["bytes"], wire_bytes=b["wire_bytes"],
                            world=comp.world, op="quantized_all_reduce",
                            step=self.global_steps)

    def _global_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """This rank's loss summed over ``sequence`` (its ranks' losses are
        parts of one mean), then averaged over the batch axes."""
        if self._seq_axes:
            loss = comm.all_reduce(loss, self._seq_axes)
        if self.mesh.live_axes(self._batch_axes):
            loss = comm.all_reduce(loss, self._batch_axes, comm.ReduceOp.AVG)
        return loss

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """``precision.global_grad_norm`` over the full leaves: the squared
        sums of blocks held by several ranks are summed over the ZeRO axes,
        an expert leaf's over ``expert`` and a tensor-parallel leaf's over
        ``tensor``, first (one all-reduce each); a replicated leaf counts
        once."""
        return self._norm_of_squares([g.float().square().sum()
                                      for g in grads])

    def _norm_of_squares(self, sq: List[torch.Tensor]) -> torch.Tensor:
        """The global norm from each reduced gradient's sum of squares
        (``_global_norm``'s reduction over the ranks)."""
        sq = partition.sum_over_blocks(sq, (
            (self._grad_dim, self._zero_axes),
            (self._expert_dim, ("expert",)),
            (self._tensor_dim, ("tensor",))))
        if not sq:
            return torch.zeros(())
        return torch.stack(sq).sum().sqrt()

    def _whole_leaf_sums(self, sums: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per-leaf sums over the optimizer's tensors (``_opt_tensors``: a
        ZeRO block where the moments are sharded, an expert or tensor
        block) summed over the ranks that cut each leaf: LAMB's whole-leaf
        norms."""
        zero = [d if d is not None else p
                for d, p in zip(self._opt_dim, self._param_dim)]
        return partition.sum_over_blocks(sums, (
            (zero, self._zero_axes),
            (self._expert_dim, ("expert",)),
            (self._tensor_dim, ("tensor",))))

    def _update(self, grads: List[torch.Tensor]) -> StepOutput:
        """Overflow skip + dynamic loss scale + clipping + optimizer update
        (reference ``engine.py:1018``), on this rank's blocks."""
        fp16 = self.config.fp16
        overflow = False
        if fp16.enabled or self._guard_nonfinite:
            overflow = self._agree_overflow(precision.has_inf_or_nan(grads))
            if overflow:                  # the norm of the neutralised grads
                grads = [torch.where(torch.isfinite(g), g, 0.0) for g in grads]
        clipped, grad_norm = precision.clip_by_global_norm(
            grads, self.config.gradient_clipping, self._global_norm(grads))
        lr = float(self.lr_schedule(self.step_count))
        if overflow:
            self._skipped_steps += 1
        else:
            self._apply(clipped)
            self.step_count += 1
            if self._comm_compress is not None and self._new_ef:
                # an overflow keeps the old residuals, as it keeps the moments
                self.optimizer.state = self.optimizer.state._replace(
                    error_feedback=self._new_ef)
        self._new_ef = ()
        self.loss_scale = precision.update_loss_scale(self.loss_scale,
                                                      overflow, fp16)
        return StepOutput(loss=None, grad_norm=grad_norm, lr=lr,
                          overflow=overflow)

    def _agree_overflow(self, flag: torch.Tensor) -> bool:
        """This rank's overflow flag, on every rank if it is on any (a max
        over the batch, expert and tensor axes), so all ranks skip a step
        together."""
        axes = self.mesh.live_axes(self._batch_axes + ("expert", "tensor"))
        if axes:
            flag = comm.all_reduce(flag.float(), axes, comm.ReduceOp.MAX) > 0
        return bool(flag)

    def _apply(self, grads: List[torch.Tensor]) -> None:
        """The optimizer step on this rank's blocks; then the blocks of
        replicated masters whose moments are sharded are all-gathered."""
        params = self._opt_tensors()
        opt_grads = []
        for i, g in enumerate(grads):
            d = self._opt_dim[i]
            if d is not None and self._grad_dim[i] is None:
                g = partition.shard_of(g, d, self.mesh, self._zero_axes)
            opt_grads.append(g)
        self.optimizer.step(params, opt_grads)
        with torch.no_grad():
            for i, p in enumerate(params):
                d = self._opt_dim[i]
                if d is not None and self._param_dim[i] is None:
                    self._masters[i].data.copy_(partition.gather_full(
                        p.contiguous(), d, self._zero_axes))

    # ------------------------------------------------------------------
    # train_batch
    # ------------------------------------------------------------------
    @staticmethod
    def stack_microbatches(data_iter, gas: int):
        """Pull ``gas`` micro-batches and stack every leaf to [gas, ...]."""
        micro = [next(data_iter) for _ in range(gas)]
        return {k: (torch.stack([m[k] for m in micro])
                    if isinstance(micro[0][k], torch.Tensor)
                    else np.stack([np.asarray(m[k]) for m in micro]))
                for k in micro[0]}

    def train_batch(self, data_iter: Optional[Iterator] = None,
                    batch: Optional[Dict[str, Any]] = None,
                    stacked: Optional[bool] = None) -> torch.Tensor:
        """One full training batch: ``gas`` micro-batches and the optimizer
        update. Pass an iterator of micro-batches, or ``batch`` whose leaves
        are stacked [gas, micro, ...]; when gas == 1 an unstacked batch is
        accepted (``stacked=True`` overrides). Returns the mean loss as a
        device scalar (no host sync). With the async pipeline's prefetch,
        ``data_iter``'s batches are staged a step ahead (keep passing the
        same iterator)."""
        gas = self.gradient_accumulation_steps
        fused = self._param_offload is None and self._offload is None
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs data_iter or batch")
            if self._prefetch_enabled and fused:
                batch = next(self._ensure_prefetcher(data_iter))
            else:
                batch = self.stack_microbatches(data_iter, gas)
        elif gas == 1 and not stacked and not isinstance(batch, StagedBatch):
            batch = {k: v[None] for k, v in batch.items()}
        if isinstance(batch, StagedBatch):
            device_batch = self._use_staged(batch)
        else:
            for k, v in batch.items():
                if v.shape[0] != gas:
                    raise ValueError(f"batch['{k}'] has {v.shape[0]} "
                                     f"micro-batches, gas is {gas}")
            device_batch = _to_device(self._local_rows(batch, 1), self.device,
                                      non_blocking=self._async_enabled)
        # async: the timer sees the dispatch; the drain books the window
        step_timer = self.timers(TRAIN_BATCH_DISPATCH_TIMER
                                 if self._async_enabled else TRAIN_BATCH_TIMER)
        if self._async_enabled:
            self._sched.rearm_if_idle()
        self.tput_timer.start()
        step_timer.start()
        if self._param_offload is not None:
            out = self._param_offload_step(device_batch)
        elif self._offload is not None:
            out = self._offload_step(device_batch)
            # the reference records inside its host update, before the
            # step counts
            self._record_metrics(out, sync=True)
        else:
            overlap = self._comm_compress is not None and get_tracer().enabled
            t0 = time.monotonic()
            scale = self.loss_scale.scale
            loss, acc = self._grads_phase(device_batch, scale)
            # unscale + average over gas in fp32, after the sum
            grads = [a.float().div_(scale * gas) for a in acc]
            del acc
            out = self._update(grads)._replace(loss=loss)
            if overlap:
                self._emit_overlap_spans(t0, time.monotonic())
        step_timer.stop()
        self.tput_timer.stop(global_step=True)
        self.global_steps += 1
        self.micro_steps += gas
        self.global_samples += self.train_batch_size
        if fused or self._param_offload is not None:
            self._record_metrics(out, sync=not fused)
        return out.loss

    def _local_rows(self, batch: Dict[str, Any], dim: int) -> Dict[str, Any]:
        """This rank's rows of a global batch along ``dim``: block c of
        ``dp`` equal blocks, c its row-major coordinate over the batch
        axes; over a sequence axis, first the global labels, mask and
        positions (``sequence_batch``), then this rank's block of dim
        ``dim + 1``."""
        out = dict(batch)
        if self._seq_axes:
            out = sequence_batch(out)
        for axes, world, d, what in (
                (self._batch_axes, self.dp_world_size, dim, "rows"),
                (self._seq_axes, self.mesh.axis_world(self._seq_axes),
                 dim + 1, "positions")):
            if world == 1:
                continue
            c = self.mesh.axis_index(axes)
            for k, v in out.items():
                n = v.shape[d]
                if n % world:
                    raise ValueError(f"batch['{k}'] has {n} {what} on dim "
                                     f"{d}, not divisible by {world} ranks "
                                     f"over {axes}")
                sl = [slice(None)] * v.ndim
                sl[d] = slice(c * (n // world), (c + 1) * (n // world))
                out[k] = v[tuple(sl)]
        return out

    # ------------------------------------------------------------------
    # the async step pipeline (reference engine.py:1553-1812)
    # ------------------------------------------------------------------
    @property
    def _metric_ring(self) -> List[Dict[str, Any]]:
        return self._sched.pending

    def _record_metrics(self, out: StepOutput, sync: bool = False) -> None:
        """Step-output fan-out. Pipeline off, or ``sync`` (the tiers, the
        micro-step protocol): ``_last_metrics`` and the monitor's events at
        ``steps_per_print`` boundaries now. Pipeline on: the outputs wait
        on the ring (nothing is read back), drained every ``sync_every``
        steps."""
        if self._async_enabled and not sync:
            due = self._sched.push({
                "step": self.global_steps, "samples": self.global_samples,
                "loss": out.loss, "grad_norm": out.grad_norm, "lr": out.lr,
                "overflow": out.overflow})
            if due:
                self._drain_metric_ring()
            return
        self._last_metrics = {"lr": out.lr, "grad_norm": out.grad_norm,
                              "loss": out.loss, "overflow": out.overflow}
        if self.monitor is not None and self.monitor.enabled:
            events = self._monitor_step_events(
                self.global_steps, self.global_samples, out.loss, out.lr,
                self.loss_scale.scale)
            if events:
                self.monitor.write_events(events)

    def _monitor_step_events(self, step, samples, loss, lr, loss_scale):
        """``Train/Samples`` events of one step at the ``steps_per_print``
        boundary: the one source of the synchronous record and the drain."""
        if step % self.config.steps_per_print != 0:
            return []
        events = [("Train/Samples/train_loss", float(loss), samples),
                  ("Train/Samples/lr", float(lr), samples)]
        if self.config.fp16.enabled:
            events.append(("Train/Samples/loss_scale", float(loss_scale),
                           samples))
        return events

    def _drain_metric_ring(self) -> List[Dict[str, Any]]:
        """The designated readback of the async pipeline: one transfer
        (``DispatchRing.drain``) moves every pending step's outputs to the
        host, which also proves their device work done. Then the host
        fan-out: ``_last_metrics``, the window booked into
        ``TRAIN_BATCH_TIMER`` and the throughput timer, the monitor's
        events (+ ``steps_per_sec``), and the ordered entry queue of
        ``take_drained_metrics``. The loss scale is a host value here; it
        is the drain-time scale of every entry, as in the reference."""
        res = self._sched.drain(extra=self.loss_scale.scale)
        if res is None:
            return []
        scale = float(res.extra)
        entries = [{"step": int(e["step"]), "samples": int(e["samples"]),
                    "loss": float(e["loss"]),
                    "grad_norm": float(e["grad_norm"]),
                    "lr": float(e["lr"]), "overflow": bool(e["overflow"]),
                    "loss_scale": scale} for e in res.payloads]
        last = entries[-1]
        self._last_metrics = {"lr": last["lr"], "grad_norm": last["grad_norm"],
                              "loss": last["loss"],
                              "overflow": last["overflow"]}
        window = 0.0
        tracer = get_tracer()
        if res.anchored:
            window = res.window_s
            self.timers(TRAIN_BATCH_TIMER).record_external(
                window, count=len(entries))
            tracer.complete("engine/steps_reconciled", window, cat="train",
                            steps=len(entries), last_step=last["step"])
        for e in entries:
            if e["overflow"]:
                tracer.instant("engine/overflow_step", cat="train",
                               step=e["step"])
        self.tput_timer.mark_edge()
        if self.monitor is not None and self.monitor.enabled:
            events = []
            for e in entries:
                events.extend(self._monitor_step_events(
                    e["step"], e["samples"], e["loss"], e["lr"],
                    e["loss_scale"]))
            if window > 0:
                events.append(("Train/Samples/steps_per_sec",
                               len(entries) / window, last["samples"]))
            if events:
                self.monitor.write_events(events)
        self._sched.store(entries)
        return entries

    def flush_metrics(self) -> List[Dict[str, Any]]:
        """Drain the ring now (one transfer); returns the newly drained
        host entries, [] when nothing is pending."""
        return self._drain_metric_ring()

    def take_drained_metrics(self) -> List[Dict[str, Any]]:
        """Pop the drained host entries not consumed yet, in order, one a
        step: step, samples, loss, grad_norm, lr, overflow, loss_scale."""
        return self._sched.take()

    def requeue_drained_metrics(self, entries: List[Dict[str, Any]]) -> None:
        """Put taken entries back at the front of the queue, in order."""
        self._sched.requeue(entries)

    def configure_async_pipeline(self, enabled: Optional[bool] = None,
                                 sync_every: Optional[int] = None,
                                 prefetch: Optional[bool] = None,
                                 prefetch_depth: Optional[int] = None):
        """Reconfigure the pipeline at run time. The ring is drained first,
        so no step crosses a change un-drained; an active prefetcher is
        closed, dropping its staged batches (the source iterator is already
        past them)."""
        self.flush_metrics()
        self._staged.close()
        if enabled is not None:
            if enabled and self._offload is not None:
                raise ValueError(
                    "async_pipeline cannot be enabled on a host-offload "
                    "engine: the fused host optimizer step is synchronous "
                    "by construction")
            self._async_enabled = bool(enabled)
        if sync_every is not None:
            if int(sync_every) < 1:
                raise ValueError(f"sync_every must be >= 1, got {sync_every}")
            self._sync_every_cfg = int(sync_every)
        self._sched.sync_every = self._sync_every_cfg \
            if self._async_enabled else 1
        if prefetch is not None:
            self._prefetch_enabled = bool(prefetch)
        self._prefetch_enabled = self._prefetch_enabled and self._async_enabled
        if prefetch_depth is not None:
            self._staged.depth = max(1, int(prefetch_depth))
        self.tput_timer.synchronize = (self.config.wall_clock_breakdown
                                       and not self._async_enabled)
        self._sched.reset_anchor()
        return self

    def _ensure_prefetcher(self, data_iter) -> PrefetchLoader:
        """One staged-batch prefetcher per source iterator (a new source
        closes the old one): a worker thread stacks ``gas`` micro-batches
        and stages them (``_stage_batch``)."""
        gas = self.gradient_accumulation_steps

        def stacked_batches():
            while True:
                try:
                    yield self.stack_microbatches(data_iter, gas)
                except StopIteration:
                    return

        def build():
            return PrefetchLoader(stacked_batches(),
                                  stage_fn=self._stage_batch,
                                  depth=self._staged.depth)

        return self._staged.ensure(data_iter, build)

    def _stage_batch(self, stacked: Dict[str, Any]) -> StagedBatch:
        """The prefetch worker's staging: this rank's rows of a stacked
        global batch, on the card from pinned memory on a side stream, with
        the copy's event; on the CPU a plain copy."""
        for k, v in stacked.items():
            if v.shape[0] != self.gradient_accumulation_steps:
                raise ValueError(f"batch['{k}'] has {v.shape[0]} micro-"
                                 f"batches, gas is "
                                 f"{self.gradient_accumulation_steps}")
        local = self._local_rows(stacked, 1)
        if self.device.type != "cuda":
            return StagedBatch(_to_device(local, self.device))
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            arrays = _to_device(local, self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return StagedBatch(arrays, event)

    def _use_staged(self, batch: StagedBatch) -> Dict[str, torch.Tensor]:
        """A staged batch on the compute stream: the stream waits for the
        side stream's copy, and the allocator learns the tensors are used
        here."""
        if batch.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(batch.event)
            for t in batch.arrays.values():
                t.record_stream(stream)
            self.staged_waits += 1
        return batch.arrays

    # ------------------------------------------------------------------
    # the memory tiers
    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _offload_step(self, device_batch) -> StepOutput:
        """The optimizer tier's step (reference ``_train_batch_offloaded``
        and ``_offload_host_update``, ``engine.py:1231-1306``), on this
        rank's blocks: the gradients reduced as the in-HBM stages reduce
        them (stage 2 reduce-scatters into the block), the norm and the
        overflow flag over every rank's blocks, the host update of this
        rank's block a chunk at a time, and at stages 1-2 the new
        compute-dtype shadow blocks all-gathered over the ZeRO axes (stage
        3 keeps its block behind the parametrization)."""
        with get_tracer().span("engine/train_step", cat="train",
                               step=self.global_steps, mode="offload"):
            t0 = time.perf_counter()
            self._reduce_s = 0.0
            loss, acc = self._grads_phase(device_batch, self.loss_scale.scale)
            out = self._host_update(acc, t0)
        return out._replace(loss=loss)

    def _host_update(self, acc: List[torch.Tensor], t0: float) -> StepOutput:
        """The optimizer tier's host half on a finished gradient list (the
        summed micro-batch gradients in ``grad_accum_dtype``, reduced;
        emptied here): divided by ``scale * gas`` in fp32, the norm and the
        overflow flag agreed over the ranks, then per leaf block down to
        the host, the host update, the compute-dtype shadow up and at
        stages 1-2 its all-gather; ``phase_seconds`` from ``t0``. Shared by
        ``train_batch`` and the micro-step protocol's ``step``."""
        cfg, gas = self.config, self.gradient_accumulation_steps
        denom = self.loss_scale.scale * gas
        # fp32 / (scale * gas), then the overflow check and the clipping
        # norm, on the card one leaf at a time
        check = cfg.fp16.enabled or self._guard_nonfinite
        sq, bad = [], []
        for a in acc:
            g = a.float() / denom
            sq.append(g.square().sum())
            if check:
                bad.append(torch.logical_not(torch.isfinite(g).all()))
            del g
        grad_norm = self._norm_of_squares(sq)
        clip = cfg.gradient_clipping
        factor = (torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
                  if clip > 0 else None)
        overflow = self._agree_overflow(torch.stack(bad).any()) \
            if check else False
        lr = float(self.lr_schedule(self.step_count))
        self._sync()
        t_dev = time.perf_counter()
        secs = {"d2h": 0.0, "shadow": 0.0, "h2d": 0.0}
        nbytes = {"d2h": 0, "h2d": 0}
        if any(self._gathers(i) for i in range(len(self._masters))):
            secs["gather"] = 0.0
        stage = self._staging
        held = {}                  # the leaf whose block is in flight

        def block_of(i):
            """Leaf i's gradient block and shadow block (flat device
            tensors), made once a leaf."""
            if held.get("i") != i:
                held.clear()
                g, p = acc[i], self._masters[i]
                shadow = p.data
                if self._gathers(i):
                    d = self._opt_dim[i]
                    if self._grad_dim[i] is None:
                        g = partition.shard_of(g, d, self.mesh,
                                               self._zero_axes)
                    shadow = torch.empty(
                        partition.shard_of(p.data, d, self.mesh,
                                           self._zero_axes).shape,
                        dtype=p.dtype, device=p.device)
                held.update(i=i, g=g.contiguous().view(-1),
                            shadow=shadow)
            return held["g"], held["shadow"]

        def grads_of(i, a, b):
            t = time.perf_counter()
            g = block_of(i)[0][a:b].float() / denom
            if factor is not None:
                g = g * factor
            host = stage.down(g)
            nbytes["d2h"] += host.numel() * host.element_size()
            secs["d2h"] += time.perf_counter() - t
            return host

        def shadow_up(i, a, b, master):
            t = time.perf_counter()
            shadow = block_of(i)[1]
            up = stage.up_buffer(shadow.dtype, b - a)
            if shadow.dtype == torch.bfloat16:
                to_bf16(master, out=up)
            else:
                up.copy_(master)
            t_cast = time.perf_counter()
            stage.up(shadow.view(-1)[a:b], up)
            nbytes["h2d"] += up.numel() * up.element_size()
            secs["shadow"] += t_cast - t
            t_up = time.perf_counter()
            secs["h2d"] += t_up - t_cast
            if self._gathers(i) and b == shadow.numel():
                with comm.op_label(OFFLOAD_LABEL), torch.no_grad():
                    self._masters[i].data.copy_(partition.gather_full(
                        shadow, self._opt_dim[i], self._zero_axes))
                self._sync()
                secs["gather"] += time.perf_counter() - t_up

        if overflow:
            self._skipped_steps += 1
        else:
            self._offload.step(grads_of, lr=lr, after=shadow_up,
                               chunk=stage.elems)
            self.step_count += 1
        held.clear()
        acc.clear()
        self.loss_scale = precision.update_loss_scale(self.loss_scale,
                                                      overflow, cfg.fp16)
        t_end = time.perf_counter()
        reduce = {"reduce": self._reduce_s} if self._time_reduce else {}
        self.phase_seconds = {"device_fwd_bwd": t_dev - t0 - self._reduce_s,
                              **reduce, **secs,
                              "host_optimizer": (t_end - t_dev)
                              - sum(secs.values())}
        self.phase_bytes = nbytes
        return StepOutput(loss=None, grad_norm=grad_norm, lr=lr,
                          overflow=overflow)

    def _gathers(self, i: int) -> bool:
        """Whether leaf i's host block is a block of a leaf the card holds
        whole (stages 1-2), so its shadow is all-gathered after the
        update."""
        return self._opt_dim[i] is not None and self._param_dim[i] is None

    def _param_offload_step(self, device_batch) -> StepOutput:
        """The parameter tier's step (reference
        ``_train_batch_param_offload``, ``engine.py:1199-1229``): the
        streamed step at the schedule's lr of the applied step, which is
        the lr reported."""
        applied = self.global_steps
        with get_tracer().span("engine/train_step", cat="train",
                               step=applied, mode="param_offload"):
            loss, norm = self._param_offload.train_batch(device_batch,
                                                         step=applied)
        self.step_count += 1
        po = self._param_offload
        self.phase_seconds = dict(po.phase_seconds)
        self.phase_bytes = {"h2d": po.bytes_streamed, "d2h": po.bytes_down}
        return StepOutput(loss=torch.tensor(loss, dtype=torch.float32),
                          grad_norm=torch.tensor(norm, dtype=torch.float32),
                          lr=float(self.lr_schedule(applied)), overflow=False)

    def set_nonfinite_guard(self, enabled: bool = True) -> None:
        """Treat non-finite gradients as an overflow in every precision
        (skip the update, keep the parameters), as the reference's
        resilience step guard does."""
        self._guard_nonfinite = bool(enabled)

    # ------------------------------------------------------------------
    # the micro-step protocol (reference engine.py:1814-1959)
    # ------------------------------------------------------------------
    def _reject_param_offload(self, api: str) -> None:
        if self._param_offload is not None:     # the reference's refusal
            raise NotImplementedError(
                f"{api} is not supported with offload_param: the streamed "
                "step cannot keep per-microbatch grads device-resident "
                "between calls — use train_batch()")

    def _micro_grads(self, batch: Dict[str, torch.Tensor], scale: float):
        """One micro-batch's (global loss, gradients) for ``forward``:
        ``_grads_one_micro``'s gradients (reduced over the micro-batch
        axes) cast to ``grad_accum_dtype``, then reduced over the wire
        axes too, as the reference's compat path does a micro-batch at a
        time (``engine.py:1831-1846``): ``comm_compression``'s buckets with
        no error feedback, or per leaf sparse, int8 (qgZ) or a
        full-precision mean."""
        acc_dtype = self.config.grad_accum_dtype
        with (token_axes(self._micro_axes) if self._wire_axes
              else contextlib.nullcontext()):
            loss, grads = self._grads_one_micro(batch, scale)
        grads = [g.to(acc_dtype) for g in grads]
        t = self._reduce_clock()
        if self._comm_compress is not None:
            sync = self._comm_compress.make_sync_fn(
                fallback_leaf_sync=self._make_grad_sync(self._replica_axes))
            reduced, _ = sync(dict(zip(self._paths, grads)), batch, ())
            grads = [reduced.pop(p) for p in self._paths]
        elif self._wire_axes:
            sync = self._make_grad_sync(self._wire_axes)
            for i in range(len(grads)):
                grads[i] = sync(self._paths[i], grads[i], batch)
        self._reduce_s += self._reduce_clock() - t
        return self._global_loss(loss), grads

    def forward(self, batch) -> torch.Tensor:
        """This rank's rows of the global micro-batch ``batch`` [B, ...]:
        the loss (a device scalar, the mean over the global micro-batch)
        and its gradients, reduced and kept for ``backward`` (the
        reference's compat shim, ``engine.py:1882``)."""
        self._reject_param_offload("forward()")
        timer = self.timers(FORWARD_GLOBAL_TIMER)
        timer.start()
        device_batch = _to_device(self._local_rows(batch, 0), self.device)
        loss, grads = self._micro_grads(device_batch, self.loss_scale.scale)
        self._pending = (loss, grads)
        timer.stop()
        return loss

    def backward(self, loss=None) -> None:
        """Fold the last ``forward``'s gradients into the accumulation
        buffer (in ``grad_accum_dtype``) and count a micro step. ``loss``
        is ignored, as in the reference (``engine.py:1897``)."""
        if self._pending is None:
            raise RuntimeError("backward() called without a preceding "
                               "forward()")
        timer = self.timers(BACKWARD_GLOBAL_TIMER)
        timer.start()
        _, grads = self._pending
        self._pending = None
        if self._grad_buffer is None:    # the first fold is the cast itself
            self._grad_buffer = grads
        else:
            for a, g in zip(self._grad_buffer, grads):
                a.add_(g)
        del grads
        self._accum_count += 1
        self.micro_steps += 1
        timer.stop()

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._accum_count >= self.gradient_accumulation_steps

    def step(self) -> None:
        """At the accumulation boundary, the update from the buffer divided
        by ``scale * gas`` in fp32 (``_update``, or under the optimizer
        tier its host update); before it, nothing (``engine.py:1916``)."""
        self._reject_param_offload("step()")
        if not self.is_gradient_accumulation_boundary():
            return
        timer = self.timers(STEP_GLOBAL_TIMER)
        timer.start()
        acc, self._grad_buffer = self._grad_buffer, None
        if self._offload is not None:
            self._reduce_s = 0.0
            out = self._host_update(acc, time.perf_counter())
        else:
            denom = self.loss_scale.scale * self.gradient_accumulation_steps
            grads = [a.float().div_(denom) for a in acc]
            del acc
            out = self._update(grads)
        # the reference's step records a loss of 0 (the forward returned it)
        self._record_metrics(out._replace(loss=torch.zeros(
            (), device=self.device)), sync=True)
        self._accum_count = 0
        self.global_steps += 1
        self.global_samples += self.train_batch_size
        timer.stop()

    def __call__(self, batch):
        """The module call-through (``engine(batch)`` -> ``forward``)."""
        return self.forward(batch)

    # ------------------------------------------------------------------
    # not ported yet
    # ------------------------------------------------------------------
    @staticmethod
    def _waits(api: str, item: str):
        raise NotImplementedError(f"{api} is not ported yet (ROADMAP Queue 1 "
                                  f"item {item})")

    # ------------------------------------------------------------------
    # checkpointing (checkpoint/engine.py)
    # ------------------------------------------------------------------
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[dict] = None,
                        async_save: Optional[bool] = None) -> str:
        """Write one logical checkpoint of whole leaves (reference
        ``engine.save_checkpoint``; JAX ``engine.py:2031-2056``). Every rank
        calls it; the ring of the async pipeline is drained first, so no
        step's metrics are pending in the snapshot. ``async_save`` (default
        the ``checkpoint.async_save`` config) returns once the state is
        snapshotted; ``checkpoint.engine.wait_pending_checkpoint`` waits for
        the commit."""
        with get_tracer().span("ckpt/save", cat="ckpt",
                               step=self.global_steps, tag=tag or "auto"):
            self.flush_metrics()
            from deepspeed_tpu_torch.checkpoint.engine import (
                save_engine_checkpoint)
            return save_engine_checkpoint(self, save_dir, tag=tag,
                                          client_state=client_state or {},
                                          async_save=async_save)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        strict_provenance: bool = True):
        """Restore a checkpoint saved at any world, mesh, ZeRO stage or
        memory tier (JAX ``engine.py:2058-2088``): each rank reads its block
        of every whole leaf. A different model, or a changed
        ``train_batch_size`` unless ``strict_provenance=False``, raises
        ``CheckpointProvenanceError``; a torn tag raises
        ``CheckpointCorruptionError``. Returns ``(path, client_state)``,
        ``(None, {})`` when ``load_dir`` has no ``latest``."""
        from deepspeed_tpu_torch.checkpoint.engine import load_engine_checkpoint
        with get_tracer().span("ckpt/load", cat="ckpt", tag=tag or "latest"):
            return load_engine_checkpoint(
                self, load_dir, tag=tag,
                load_optimizer_states=load_optimizer_states,
                strict_provenance=strict_provenance)

    def _master_cuts(self, i: int) -> List[Tuple[Optional[int], Tuple[str, ...]]]:
        """How this rank's master of leaf i is cut from the whole leaf, in
        the order ``_place_zero`` cuts: its expert block, its tensor block,
        then at stage 3 its ZeRO block (the device shadow under the
        optimizer tier)."""
        return [(self._expert_dim[i], ("expert",)),
                (self._tensor_dim[i], ("tensor",)),
                (self._param_dim[i], tuple(self._block_axes))]

    def _opt_cuts(self, i: int) -> List[Tuple[Optional[int], Tuple[str, ...]]]:
        """How this rank's optimizer tensors of leaf i (``_opt_tensors``;
        under either tier also the host master) are cut from the whole
        leaf: the master's cuts, the ZeRO block of the moments below stage
        3."""
        if self._param_dim[i] is not None:
            return self._master_cuts(i)
        return self._master_cuts(i)[:2] + [(self._opt_dim[i],
                                            tuple(self._zero_axes))]

    def _whole_leaf(self, t: torch.Tensor, cuts) -> torch.Tensor:
        """The whole leaf from this rank's block ``t`` cut by ``cuts``,
        gathered over each cut's axes (every rank must call it); ``t``
        itself where nothing cuts it. A host block is gathered on the host
        where the process group is gloo, which takes CPU tensors, else
        through the card, and comes back to the host."""
        cuts = [(d, axes) for d, axes in cuts if d is not None]
        if not cuts:
            return t
        import torch.distributed as dist
        host = t.device.type == "cpu"
        x = t.detach() if not host or dist.get_backend() == "gloo" \
            else t.detach().to(self.device)
        for d, axes in reversed(cuts):
            x = partition.gather_full(x.contiguous(), d, axes)
        return x.cpu() if host else x

    # the reference's telemetry and data-efficiency calls
    # (engine.py:1341-1550)
    def dump_trace(self, path=None, tail_s=None):
        self._waits("dump_trace (the tracer's sinks)", "7: telemetry")

    def trace_summary(self, prefix=None):
        self._waits("trace_summary (the tracer's sinks)", "7: telemetry")

    def memory_ledger(self):
        self._waits("memory_ledger (telemetry/memory)", "7: telemetry")

    def memory_forensics(self, error=None, **kwargs):
        self._waits("memory_forensics (telemetry/memory)", "7: telemetry")

    def dump_memory_report(self, path=None):
        self._waits("dump_memory_report (telemetry/memory)", "7: telemetry")

    def start_profile_trace(self, log_dir):
        self._waits("start_profile_trace (profiling)", "7: profiling")

    def stop_profile_trace(self):
        self._waits("stop_profile_trace (profiling)", "7: profiling")

    def set_custom_curriculum_learning_schedule(self, schedule_fn):
        self._waits("set_custom_curriculum_learning_schedule (data_pipeline)",
                    "7: data efficiency")

    def curriculum_seqlen(self):
        self._waits("curriculum_seqlen (data_pipeline)", "7: data efficiency")

    def random_ltd_reserved_length(self):
        self._waits("random_ltd_reserved_length (data_pipeline)",
                    "7: data efficiency")

    # ------------------------------------------------------------------
    # eval and introspection
    # ------------------------------------------------------------------
    def compile(self, backend=None, **compile_kwargs):
        """API parity with the reference's ``engine.compile()``: recorded,
        nothing compiled (the step runs eagerly)."""
        self._compiled = True
        log_dist("engine.compile(): recorded; the train step runs eagerly",
                 ranks=[0])
        return self

    def train(self, mode: bool = True):
        """Module-mode parity (reference ``nn.Module.train/eval``):
        tracked for API compatibility."""
        self.training = bool(mode)
        return self

    def eval(self):
        return self.train(False)

    def eval_batch(self, batch) -> torch.Tensor:
        """The loss of a global batch [B, ...]: each rank's rows, the mean
        over the ranks."""
        self._reject_param_offload("eval_batch()")
        with torch.no_grad(), self._compute_copy():
            loss = self._compute_loss(_to_device(self._local_rows(batch, 0),
                                                 self.device))
        return self._global_loss(loss)

    def get_lr(self) -> List[float]:
        return [float(self.lr_schedule(self.step_count))]

    def get_global_grad_norm(self) -> float:
        v = self._last_metrics.get("grad_norm")
        return float(v) if v is not None else 0.0

    def cur_scale(self) -> float:
        return float(self.loss_scale.scale)

    @property
    def skipped_steps(self) -> int:
        return self._skipped_steps

    def zero_optimization_stage(self) -> int:
        return self.zero_stage

    def train_micro_batch_size_per_gpu(self) -> int:
        return self.micro_batch_size

    def named_masters(self):
        """(name, full fp32 master) pairs, in the order gradients come;
        under either memory tier the host optimizer's masters. A block
        (stage 3, a tier's host block, an expert or tensor block) is
        gathered: every rank must call it."""
        if self._offload is not None:
            return [(n, self._whole_leaf(m, self._opt_cuts(i))) for i, (n, m)
                    in enumerate(zip(self._param_names,
                                     self._offload.masters()))]
        return [(n, self._whole_leaf(p, self._master_cuts(i))) for i, (n, p)
                in enumerate(zip(self._param_names, self._masters))]

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.named_masters()}

    def get_params(self):
        """The fp32 masters as the flax parameter tree (nested dicts of
        tensors), as the reference's ``get_params`` returns its params."""
        from deepspeed_tpu_torch.models.convert import to_flax_tree
        return to_flax_tree((n, p.detach()) for n, p in self.named_masters())
