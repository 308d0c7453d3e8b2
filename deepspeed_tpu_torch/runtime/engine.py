"""The training engine, cut to the fused ``train_batch`` path.

Port of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedTPUEngine``,
reference ``deepspeed/runtime/engine.py``) on one device, ZeRO stage 0:

- ``_compute_loss`` runs the model with every floating master cast to the
  compute dtype at its use (the reference's ``cast_to_compute``), so each
  micro-batch's gradient is the gradient with respect to the fp32 master
  through the cast;
- the gradient-accumulation loop sums those gradients in
  ``grad_accum_dtype`` into buffers of that dtype (autograd's own ``.grad``
  would sum in fp32), and only after the sum divides by ``scale * gas`` in
  fp32 (reference ``:993``);
- with ``zero_quantized_gradients`` (qgZ) each micro-batch gradient takes
  the int8 round trip through the quantize/dequantize kernels before it is
  accumulated (reference ``:781-805``);
- ``_update`` is the reference's (``:1018-1057``): overflow check under
  fp16 or the non-finite guard, clipping by the global norm, the Adam
  update, and on overflow the old parameters, optimizer state and step kept
  while ``skipped_steps`` grows and the loss scale moves.

JAX keeps the skip decision on the device with ``jnp.where``; eager
PyTorch reads the overflow flag once per step, and only under fp16 or the
guard, and then skips the update instead of computing and discarding it.
Without them a step never waits for the device. The micro-step protocol
(``forward``/``backward``/``step``), the async metric ring and the batch
prefetcher are not ported yet (ROADMAP Queue 1).

The memory tiers (reference ``engine.py:238-338,1199-1306``):

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

import time
import warnings
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig
from deepspeed_tpu_torch.ops.cpu_adam import to_bf16
from deepspeed_tpu_torch.ops.optimizers import build_optimizer
from deepspeed_tpu_torch.ops.quant import dequantize_int8, quantize_int8
from deepspeed_tpu_torch.runtime import precision
from deepspeed_tpu_torch.runtime.lr_schedules import build_schedule, constant_lr
from deepspeed_tpu_torch.runtime.staging import STAGING_ELEMS, Staging
from deepspeed_tpu_torch.runtime.zero.qgz import MIN_QUANT_SIZE
from deepspeed_tpu_torch.telemetry.tracer import get_tracer
from deepspeed_tpu_torch.utils.device import resolve_device
from deepspeed_tpu_torch.utils.logging import log_dist
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


class DeepSpeedTPUEngine:
    def __init__(self, model: torch.nn.Module, config, params=None,
                 loss_fn: Optional[Callable] = None,
                 lr_scheduler: Optional[Callable[[int], float]] = None,
                 client_optimizer=None, device=None):
        self.config = config if isinstance(config, DeepSpeedTPUConfig) \
            else DeepSpeedTPUConfig(config)
        config = self.config
        self.device = resolve_device(device)
        self.dp_world_size = 1
        config.resolve_batch_sizes(self.dp_world_size)
        self.train_batch_size = config.train_batch_size
        self.micro_batch_size = config.train_micro_batch_size_per_gpu
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.compute_dtype = config.precision_dtype
        self.zero_stage = config.zero_config.stage
        self.loss_fn = loss_fn
        log_dist(f"engine: {config!r} device={self.device}", ranks=[0])
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
        if tier is not None and client_optimizer is not None:
            raise ValueError(
                f"offload_{tier} requires a config-typed optimizer (the "
                "update runs in the fused host kernel, not a client optimizer)")
        # qgZ on one card: no data-parallel reduction to put int8 on, so
        # every micro-batch gradient takes the int8 round trip instead, the
        # numerics of the reference's quantized-gradient collectives
        # (reference engine.py:381-418, the no-replica-axis case)
        self._quantized_gradients = bool(
            config.zero_config.zero_quantized_gradients)
        if self._quantized_gradients:
            warnings.warn(
                "qgZ: zero_quantized_gradients=true on one device: there is "
                "no data-parallel all-reduce hop to compress, so NO bytes "
                "are saved on the wire. Gradients still pay the int8 "
                "round-trip quantization noise (reference-fidelity "
                "numerics). Disable zero_quantized_gradients, or wait for "
                "the distribution slice (ROADMAP Queue 1).",
                UserWarning, stacklevel=3)

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
            # the tensors gradients are taken against: the fp32 masters, or
            # under the optimizer tier the compute-dtype shadows
            self._masters: List[torch.Tensor] = [p for _, p in named]
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
            self.optimizer.init(self._masters)

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
        fp32 masters (fp32 tensors). With qgZ every gradient of at least
        ``MIN_QUANT_SIZE`` elements goes through the int8 kernels (rows are
        its last axis) before it is accumulated."""
        loss = self._compute_loss(batch)
        grads = list(torch.autograd.grad(loss * scale, self._masters))
        if self._quantized_gradients:
            grads = [_int8_round_trip(g) for g in grads]
        return loss.detach(), grads

    def _grads_phase(self, stacked: Dict[str, torch.Tensor], scale: float):
        """(mean loss, per-micro gradients summed in grad_accum_dtype)."""
        gas = self.gradient_accumulation_steps
        acc_dtype = self.config.grad_accum_dtype
        acc: Optional[List[torch.Tensor]] = None
        loss_sum = torch.zeros((), device=self.device)
        for i in range(gas):
            loss, grads = self._grads_one_micro(
                {k: v[i] for k, v in stacked.items()}, scale)
            loss_sum += loss
            if acc is None:           # 0 + g: the first sum is the cast itself
                acc = [g.to(acc_dtype) for g in grads]
            else:
                for a, g in zip(acc, grads):
                    a.add_(g.to(acc_dtype))
            del grads
        return loss_sum / gas, acc

    def _update(self, grads: List[torch.Tensor]) -> StepOutput:
        """Overflow skip + dynamic loss scale + clipping + optimizer update
        (reference ``engine.py:1018``)."""
        fp16 = self.config.fp16
        overflow = False
        if fp16.enabled or self._guard_nonfinite:
            overflow = bool(precision.has_inf_or_nan(grads))
            if overflow:                  # the norm of the neutralised grads
                grads = [torch.where(torch.isfinite(g), g, 0.0) for g in grads]
        clipped, grad_norm = precision.clip_by_global_norm(
            grads, self.config.gradient_clipping)
        lr = float(self.lr_schedule(self.step_count))
        if overflow:
            self._skipped_steps += 1
        else:
            self.optimizer.step(self._masters, clipped)
            self.step_count += 1
        self.loss_scale = precision.update_loss_scale(self.loss_scale,
                                                      overflow, fp16)
        return StepOutput(loss=None, grad_norm=grad_norm, lr=lr,
                          overflow=overflow)

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
        device_batch = _to_device(batch, self.device)
        for k, v in device_batch.items():
            if v.shape[0] != gas:
                raise ValueError(f"batch['{k}'] has {v.shape[0]} micro-batches, "
                                 f"gas is {gas}")
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
            "Queue 1); use train_batch()")

    def save_checkpoint(self, save_dir, tag=None, **kwargs):
        raise NotImplementedError(
            "save_checkpoint (checkpoint and resilience) is not ported yet "
            "(ROADMAP Queue 1); the memory tiers' state round-trips through "
            "engine.optimizer.state_dict() / load_state_dict()")

    def load_checkpoint(self, load_dir, tag=None, **kwargs):
        raise NotImplementedError(
            "load_checkpoint (checkpoint and resilience) is not ported yet "
            "(ROADMAP Queue 1); the memory tiers' state round-trips through "
            "engine.optimizer.state_dict() / load_state_dict()")

    def forward(self, batch):
        self._unported("forward()")

    def backward(self, loss=None):
        self._unported("backward()")

    def step(self):
        self._unported("step()")

    # ------------------------------------------------------------------
    # eval and introspection
    # ------------------------------------------------------------------
    def eval_batch(self, batch) -> torch.Tensor:
        if self._param_offload is not None:
            self._unported("eval_batch()")
        with torch.no_grad():
            return self._compute_loss(_to_device(batch, self.device))

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

    def named_masters(self):
        """(name, fp32 master) pairs, in the order gradients come; under
        either memory tier the host optimizer's masters."""
        if self._offload is not None:
            return list(zip(self._param_names, self._offload.masters()))
        return list(zip(self._param_names, self._masters))

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in self.named_masters()}
