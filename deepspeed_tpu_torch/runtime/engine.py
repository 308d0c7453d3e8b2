"""The training engine, cut to the fused ``train_batch`` path.

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
- ``_update`` is the reference's (``:1018-1057``): overflow check under
  fp16 or the non-finite guard, clipping by the global norm, the Adam
  update, and on overflow the old parameters, optimizer state and step
  kept while ``skipped_steps`` grows and the loss scale moves.

JAX keeps the skip decision on the device with ``jnp.where``; eager
PyTorch reads the overflow flag once per step, and only under fp16 or the
guard, and then skips the update instead of computing and discarding it.
Without them a step never waits for the device. The micro-step protocol
(``forward``/``backward``/``step``), the async metric ring and the batch
prefetcher are not ported yet (ROADMAP Queue 1 item 5).

The memory tiers (reference ``engine.py:238-338,1199-1306``), at a world
of one rank:

- ``offload_optimizer`` (ZeRO-Offload, ``cpu`` or ``nvme``): the module
  holds compute-dtype parameters on the card; the fp32 masters and moments
  live only in the host optimizer (``runtime/offload.py``). A step's
  gradients are accumulated as above, then cast to fp32 and divided by
  ``scale * gas`` on the card, where the overflow check and the clipping
  norm are taken leaf by leaf (no second full copy); each leaf's clipped
  fp32 gradient goes down through bounded pinned buffers
  (``runtime/staging.py``) into the fused host step at the schedule's lr,
  and the new bf16 shadow goes back up. An overflow skips the host step,
  shrinks the loss scale and counts in ``skipped_steps``.
- ``offload_param`` (ZeRO-Infinity): ``runtime/param_offload.py`` streams
  the weights through the card one layer group at a time.

Both emit the ``engine/train_step`` span (``mode`` ``offload`` or
``param_offload``) and keep each phase's seconds in ``phase_seconds``.
"""

import contextlib
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
from deepspeed_tpu_torch.config.config import ITEM_DIST, DeepSpeedTPUConfig
from deepspeed_tpu_torch.moe.sharded_moe import token_axes
from deepspeed_tpu_torch.ops.cpu_adam import to_bf16
from deepspeed_tpu_torch.ops.optimizers import build_optimizer
from deepspeed_tpu_torch.ops.quant import dequantize_int8, quantize_int8
from deepspeed_tpu_torch.runtime import precision
from deepspeed_tpu_torch.runtime.lr_schedules import build_schedule, constant_lr
from deepspeed_tpu_torch.runtime.staging import STAGING_ELEMS, Staging
from deepspeed_tpu_torch.runtime.zero import partition
from deepspeed_tpu_torch.runtime.zero.qgz import (MIN_QUANT_SIZE,
                                                  quantized_grad_sync,
                                                  replica_grad_axes)
from deepspeed_tpu_torch.telemetry.tracer import get_tracer
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                             ThroughputTimer, TRAIN_BATCH_TIMER)


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


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(v))).to(device)
            for k, v in batch.items()}


QGZ_NO_REPLICA_MSG = (
    "zero_quantized_gradients=true but the mesh has NO replica batch axis "
    "(pure-fsdp ZeRO-3): there is no pure-DP all-reduce hop to compress, so "
    "NO bytes are saved on the wire. Gradients still pay the int8 "
    "round-trip quantization noise (reference-fidelity numerics). Either "
    "add a replica axis (a 'data' mesh axis, or split fsdp via "
    "mics_shard_size < world so 'fsdp_out' replicates) or disable "
    "zero_quantized_gradients. See docs/parallelism.md#qgz.")


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
        # --- the mesh: one rank per process over torch.distributed --------
        self.mesh = mesh if mesh is not None else \
            create_mesh(config.mesh, device=self.device)
        set_global_mesh(self.mesh)
        self.dp_world_size = get_data_parallel_world_size(self.mesh)
        config.resolve_batch_sizes(self.dp_world_size)
        self.train_batch_size = config.train_batch_size
        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.compute_dtype = config.precision_dtype
        self.zero_stage = config.zero_config.stage
        self.loss_fn = loss_fn
        # model-parallel placement rules (the expert rules by default on an
        # expert axis, as moe_tensor_rules shards the expert leaves)
        if tensor_rules is None and self.mesh.shape["expert"] > 1:
            from deepspeed_tpu_torch.moe.sharded_moe import moe_tensor_rules
            tensor_rules = moe_tensor_rules
        self.tensor_rules = tensor_rules
        self._refuse_noisy_gating(model)
        self.training = True
        self._compiled = False
        log_dist(f"engine: {config!r} mesh={dict(self.mesh.shape)} "
                 f"device={self.device}", ranks=[0])
        if config.comms_logger.enabled:
            get_comms_logger().configure(enabled=True,
                                         verbose=config.comms_logger.verbose)
        zc = config.zero_config
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
        if tier is not None and self.mesh.size > 1:
            raise NotImplementedError(
                f"offload_{tier} over {self.mesh.size} ranks is not ported "
                f"yet ({ITEM_DIST}: the memory tiers at world > 1); the "
                "tiers run at one rank")
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
        if tier == "param":
            # --- ZeRO-Infinity: the weights stream through the card ---------
            from deepspeed_tpu_torch.runtime.param_offload import (
                ParamOffloadTrainer)
            self._param_offload = ParamOffloadTrainer(
                model, config, self.lr_schedule, self.device,
                staging_elems=STAGING_ELEMS)
            self.model = model
            self._offload = self._param_offload.opt
            self.optimizer = self._offload
            self._param_names = list(self._param_offload.names)
            self._masters = []
        else:
            self.model = model.to(self.device)
            named = [(n, p) for n, p in self.model.named_parameters()
                     if p.requires_grad]
            self._param_names: List[str] = [n for n, _ in named]
            # the tensors gradients are taken against: the fp32 masters (a
            # stage-3 leaf's block), or under the optimizer tier the
            # compute-dtype shadows
            self._masters: List[torch.Tensor] = [p for _, p in named]
            del named
        self._place_zero()
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
        self._reduce_plan()
        if tier == "optimizer":
            # --- ZeRO-Offload: masters and moments in the host optimizer -----
            from deepspeed_tpu_torch.runtime.offload import HostOffloadOptimizer
            ocfg = zc.offload_optimizer
            self._staging = Staging(self.device, ocfg.pin_memory, STAGING_ELEMS)
            host = [self._staging.to_host(p.data) for p in self._masters]
            self._offload = HostOffloadOptimizer(host, opt_type, opt_params,
                                                 ocfg)
            del host
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
            self.optimizer.init(self._opt_tensors())

        self.loss_scale = precision.init_loss_scale(config.fp16)
        self.step_count = 0           # applied updates (the reference's state.step)
        self._skipped_steps = 0
        self.global_steps = 0
        self.micro_steps = 0
        self.global_samples = 0
        self._guard_nonfinite = False
        self._last_metrics: Dict[str, Any] = {}
        self.timers = SynchronizedWallClockTimer(
            synchronize=config.wall_clock_breakdown)
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size,
            steps_per_output=config.steps_per_print,
            synchronize=config.wall_clock_breakdown)

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

    def _place_zero(self) -> None:
        """Each leaf's param and optimizer-state spec (layered on its
        tensor rule), the dimension its moments (and under stage 3 its
        master) are sharded along, the stage-3 parametrizations that gather
        a block before use, and each expert leaf cut to this rank's block
        of the ``expert`` axis."""
        mesh, stage = self.mesh, self.zero_stage
        self._zero_axes, self._zero_world = partition.zero_fsdp_axes(mesh)
        self._batch_axes = tuple(a for a in BATCH_AXES if a in mesh.shape)
        shapes = {n: tuple(p.shape)
                  for n, p in zip(self._param_names, self._masters)}
        specs = partition.leaf_specs(shapes, mesh, stage, self.tensor_rules)
        self._param_specs = specs["param"]
        self._expert_dim: List[Optional[int]] = [
            partition.sharded_dim(sp, ("expert",))
            if mesh.shape["expert"] > 1 else None
            for sp in self._param_specs]
        with torch.no_grad():
            for i, d in enumerate(self._expert_dim):
                if d is not None:
                    p = self._masters[i]
                    p.data = partition.shard_of(p.data, d, mesh,
                                                ("expert",)).clone()
        self._replica_axes = replica_grad_axes(mesh, self._batch_axes,
                                               self._param_specs) \
            if self._param_offload is None else ()
        n = len(shapes)
        self._opt_dim: List[Optional[int]] = [None] * n
        self._param_dim: List[Optional[int]] = [None] * n
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
            parametrize.register_parametrization(
                module, attr, partition.ShardedParam(
                    dim, self._zero_axes, mesh, self.compute_dtype),
                unsafe=True)
            self._masters[i] = module.parametrizations[attr].original

    def _reduce_plan(self) -> None:
        """Which axes each micro-batch's gradient is summed over, and which
        leaves' gradients are held as blocks."""
        mesh = self.mesh
        self._micro_axes = mesh.live_axes(
            [a for a in self._batch_axes if a not in self._qgz_axes])
        self._micro_world = mesh.axis_world(self._micro_axes)
        zero_reduced = not (set(mesh.live_axes(self._zero_axes))
                            & set(self._qgz_axes))
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
        loss = self._compute_loss(batch)
        grads = list(torch.autograd.grad(loss * scale, self._masters))
        grads = self._reduce_micro(grads)
        if self._quantized_gradients and not self._qgz_axes:
            grads = [self._round_trip(g, d)
                     for g, d in zip(grads, self._grad_dim)]
        return loss.detach(), grads

    def _reduce_micro(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum each gradient of the local mean loss over the micro-batch
        axes and divide by their world: the gradient of the mean over the
        global micro-batch. Stage 2 reduce-scatters a sharded leaf into its
        block (stage 3's gather already did in its backward), then sums the
        block over the other axes."""
        if self._micro_world <= 1:
            return grads
        zero = set(self._zero_axes)
        out = []
        for g, d in zip(grads, self._grad_dim):
            axes = self._micro_axes
            if d is not None:
                if self.zero_stage == 2:
                    g = partition.reduce_scatter_full(g, d, self._zero_axes)
                axes = tuple(a for a in axes if a not in zero)
            if axes:
                g = comm.all_reduce(g, axes)
            out.append(g / self._micro_world)
        return out

    def _round_trip(self, g: torch.Tensor, dim: Optional[int]):
        """The int8 round trip of a reduced gradient, row by row over its
        last axis. A block split along its last axis is gathered first, so
        its rows are the full leaf's rows, then cut again."""
        if dim is None or dim != g.dim() - 1:
            return _int8_round_trip(g)
        full = partition.gather_full(g, dim, self._zero_axes)
        return partition.shard_of(_int8_round_trip(full), dim, self.mesh,
                                  self._zero_axes).contiguous()

    def _grads_phase(self, stacked: Dict[str, torch.Tensor], scale: float):
        """(mean loss over the ranks, per-micro gradients summed in
        grad_accum_dtype; under qgZ with replica axes, then mean-reduced
        over them with int8 on the wire)."""
        gas = self.gradient_accumulation_steps
        acc_dtype = self.config.grad_accum_dtype
        acc: Optional[List[torch.Tensor]] = None
        loss_sum = torch.zeros((), device=self.device)
        # under qgZ the phase is manual over the replica axes: an MoE layer
        # gates and dispatches over the other batch axes only
        for i in range(gas):
            with (token_axes(self._micro_axes) if self._qgz_axes
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
        if self._qgz_axes:            # a leaf at a time: each sum is freed
            for i in range(len(acc)):
                acc[i] = quantized_grad_sync([acc[i]], self._qgz_axes)[0]
        if self.mesh.live_axes(self._batch_axes):
            loss = comm.all_reduce(loss, self._batch_axes, comm.ReduceOp.AVG)
        return loss, acc

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """``precision.global_grad_norm`` over the full leaves: the squared
        sums of blocks held by several ranks are summed over the ZeRO axes,
        and an expert leaf's over ``expert``, first (one all-reduce each);
        a replicated leaf counts once."""
        sq = [g.float().square().sum() for g in grads]
        for dims, axes in ((self._grad_dim, self._zero_axes),
                           (self._expert_dim, ("expert",))):
            idx = [i for i, d in enumerate(dims) if d is not None]
            if not idx:
                continue
            red = comm.all_reduce(torch.stack([sq[i] for i in idx]), axes)
            for k, i in enumerate(idx):
                sq[i] = red[k]
        if not sq:
            return torch.zeros(())
        return torch.stack(sq).sum().sqrt()

    def _update(self, grads: List[torch.Tensor]) -> StepOutput:
        """Overflow skip + dynamic loss scale + clipping + optimizer update
        (reference ``engine.py:1018``), on this rank's blocks."""
        fp16 = self.config.fp16
        overflow = False
        if fp16.enabled or self._guard_nonfinite:
            flag = precision.has_inf_or_nan(grads)
            axes = self.mesh.live_axes(self._batch_axes + ("expert",))
            if axes:
                flag = comm.all_reduce(flag.float(), axes,
                                       comm.ReduceOp.MAX) > 0
            overflow = bool(flag)
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
        self.loss_scale = precision.update_loss_scale(self.loss_scale,
                                                      overflow, fp16)
        return StepOutput(loss=None, grad_norm=grad_norm, lr=lr,
                          overflow=overflow)

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
        device scalar (no host sync)."""
        gas = self.gradient_accumulation_steps
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs data_iter or batch")
            batch = self.stack_microbatches(data_iter, gas)
        elif gas == 1 and not stacked:
            batch = {k: v[None] for k, v in batch.items()}
        for k, v in batch.items():
            if v.shape[0] != gas:
                raise ValueError(f"batch['{k}'] has {v.shape[0]} micro-batches, "
                                 f"gas is {gas}")
        device_batch = _to_device(self._local_rows(batch, 1), self.device)
        step_timer = self.timers(TRAIN_BATCH_TIMER)
        self.tput_timer.start()
        step_timer.start()
        if self._param_offload is not None:
            out = self._param_offload_step(device_batch)
        elif self._offload is not None:
            out = self._offload_step(device_batch)
        else:
            scale = self.loss_scale.scale
            loss, acc = self._grads_phase(device_batch, scale)
            # unscale + average over gas in fp32, after the sum
            grads = [a.float().div_(scale * gas) for a in acc]
            del acc
            out = self._update(grads)._replace(loss=loss)
        loss = out.loss
        step_timer.stop()
        self.tput_timer.stop(global_step=True)
        self.global_steps += 1
        self.micro_steps += gas
        self.global_samples += self.train_batch_size
        self._last_metrics = {"lr": out.lr, "grad_norm": out.grad_norm,
                              "loss": out.loss, "overflow": out.overflow}
        return loss

    def _local_rows(self, batch: Dict[str, Any], dim: int) -> Dict[str, Any]:
        """This rank's rows of a global batch along ``dim``: block c of
        ``dp`` equal blocks, c its row-major coordinate over the batch
        axes."""
        dp = self.dp_world_size
        if dp == 1:
            return batch
        c = self.mesh.axis_index(self._batch_axes)
        out = {}
        for k, v in batch.items():
            rows = v.shape[dim]
            if rows % dp:
                raise ValueError(f"batch['{k}'] has {rows} rows, not "
                                 f"divisible by the {dp} data-parallel ranks")
            n = rows // dp
            sl = [slice(None)] * v.ndim
            sl[dim] = slice(c * n, (c + 1) * n)
            out[k] = v[tuple(sl)]
        return out

    # ------------------------------------------------------------------
    # the memory tiers
    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _offload_step(self, device_batch) -> StepOutput:
        """The optimizer tier's step (reference ``_train_batch_offloaded``
        and ``_offload_host_update``, ``engine.py:1231-1306``)."""
        cfg, gas = self.config, self.gradient_accumulation_steps
        scale = self.loss_scale.scale
        denom = scale * gas
        with get_tracer().span("engine/train_step", cat="train",
                               step=self.global_steps, mode="offload"):
            t0 = time.perf_counter()
            loss, acc = self._grads_phase(device_batch, scale)
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
            grad_norm = torch.stack(sq).sum().sqrt()
            clip = cfg.gradient_clipping
            factor = (torch.clamp(clip / (grad_norm + 1e-6), max=1.0)
                      if clip > 0 else None)
            overflow = bool(torch.stack(bad).any()) if check else False
            lr = float(self.lr_schedule(self.step_count))
            self._sync()
            t_dev = time.perf_counter()
            secs = {"d2h": 0.0, "shadow": 0.0, "h2d": 0.0}
            nbytes = {"d2h": 0, "h2d": 0}
            stage = self._staging

            def grads_of(i, a, b):
                t = time.perf_counter()
                g = acc[i].view(-1)[a:b].float() / denom
                if factor is not None:
                    g = g * factor
                host = stage.down(g)
                nbytes["d2h"] += host.numel() * host.element_size()
                secs["d2h"] += time.perf_counter() - t
                return host

            def shadow_up(i, a, b, master):
                t = time.perf_counter()
                p = self._masters[i]
                up = stage.up_buffer(p.dtype, b - a)
                if p.dtype == torch.bfloat16:
                    to_bf16(master, out=up)
                else:
                    up.copy_(master)
                t_cast = time.perf_counter()
                stage.up(p.data.view(-1)[a:b], up)
                nbytes["h2d"] += up.numel() * up.element_size()
                secs["shadow"] += t_cast - t
                secs["h2d"] += time.perf_counter() - t_cast

            if overflow:
                self._skipped_steps += 1
            else:
                self._offload.step(grads_of, lr=lr, after=shadow_up,
                                   chunk=stage.elems)
                self.step_count += 1
            del acc
            self.loss_scale = precision.update_loss_scale(self.loss_scale,
                                                          overflow, cfg.fp16)
            t_end = time.perf_counter()
        self.phase_seconds = {"device_fwd_bwd": t_dev - t0, **secs,
                              "host_optimizer": (t_end - t_dev) - sum(secs.values())}
        self.phase_bytes = nbytes
        return StepOutput(loss=loss, grad_norm=grad_norm, lr=lr,
                          overflow=overflow)

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
    # not ported yet
    # ------------------------------------------------------------------
    def _unported(self, api: str):
        if self._param_offload is not None:     # the reference's refusal
            raise NotImplementedError(
                f"{api} is not supported with offload_param: the streamed "
                "step cannot keep per-microbatch grads device-resident "
                "between calls — use train_batch()")
        raise NotImplementedError(
            f"{api} (the micro-step protocol) is not ported yet (ROADMAP "
            "Queue 1 item 5: training carry-overs); use train_batch()")

    @staticmethod
    def _waits(api: str, item: str):
        raise NotImplementedError(f"{api} is not ported yet (ROADMAP Queue 1 "
                                  f"item {item})")

    def save_checkpoint(self, save_dir, tag=None, **kwargs):
        raise NotImplementedError(
            "save_checkpoint (checkpoint and resilience) is not ported yet "
            "(ROADMAP Queue 1 item 6); the memory tiers' state round-trips "
            "through engine.optimizer.state_dict() / load_state_dict()")

    def load_checkpoint(self, load_dir, tag=None, **kwargs):
        raise NotImplementedError(
            "load_checkpoint (checkpoint and resilience) is not ported yet "
            "(ROADMAP Queue 1 item 6); the memory tiers' state round-trips "
            "through engine.optimizer.state_dict() / load_state_dict()")

    def forward(self, batch):
        self._unported("forward()")

    def backward(self, loss=None):
        self._unported("backward()")

    def step(self):
        self._unported("step()")

    def __call__(self, batch):
        """The module call-through (``engine(batch)`` -> ``forward``)."""
        return self.forward(batch)

    def is_gradient_accumulation_boundary(self) -> bool:
        # the micro-step protocol's count; train_batch leaves it at 0
        return self._accum_count >= self.gradient_accumulation_steps

    _accum_count = 0

    # the reference's telemetry, data-efficiency and async-pipeline calls
    # (engine.py:1341-1750)
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

    def flush_metrics(self):
        self._waits("flush_metrics (the async step pipeline)",
                    "5: training carry-overs")

    def take_drained_metrics(self):
        self._waits("take_drained_metrics (the async step pipeline)",
                    "5: training carry-overs")

    def requeue_drained_metrics(self, entries):
        self._waits("requeue_drained_metrics (the async step pipeline)",
                    "5: training carry-overs")

    def configure_async_pipeline(self, enabled=None, **kwargs):
        self._waits("configure_async_pipeline (the async step pipeline)",
                    "5: training carry-overs")

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
        if self._param_offload is not None:
            self._unported("eval_batch()")
        with torch.no_grad():
            loss = self._compute_loss(_to_device(self._local_rows(batch, 0),
                                                 self.device))
        if self.mesh.live_axes(self._batch_axes):
            loss = comm.all_reduce(loss, self._batch_axes, comm.ReduceOp.AVG)
        return loss

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
        under either memory tier the host optimizer's masters. Under stage
        3 the blocks are gathered: every rank must call it."""
        if self._offload is not None:
            return list(zip(self._param_names, self._offload.masters()))
        out = []
        for name, p, d, e in zip(self._param_names, self._masters,
                                 self._param_dim, self._expert_dim):
            if d is not None:
                p = partition.gather_full(p.detach(), d, self._zero_axes)
            if e is not None:
                p = partition.gather_full(p.detach(), e, ("expert",))
            out.append((name, p))
        return out

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.named_masters()}

    def get_params(self):
        """The fp32 masters as the flax parameter tree (nested dicts of
        tensors), as the reference's ``get_params`` returns its params."""
        if self._param_offload is not None:
            return self._param_offload.masters_tree()
        from deepspeed_tpu_torch.models.convert import to_flax_tree
        return to_flax_tree((n, p.detach()) for n, p in self.named_masters())
