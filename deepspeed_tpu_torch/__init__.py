"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The package mirrors ``deepspeed_tpu``'s module paths (the counterpart of
``deepspeed_tpu/inference/v2/engine_v2.py`` is
``deepspeed_tpu_torch/inference/v2/engine_v2.py``). It imports ``torch`` and
never ``jax`` or ``deepspeed_tpu``; modules it needs from the JAX package are
kept here as copies. Every Pallas kernel on a ported path becomes a kernel
written by hand for Hopper under ``csrc/``, built with ``nvcc`` on first use
(``ops/build.py``).

Ported so far:

- serving engine (slice 1) — ``InferenceEngineV2`` over the paged KV cache,
  serving the Llama family, with the paged-attention kernel
  (``csrc/paged_attention.cu``);
- training (slice 2) — ``initialize()`` -> ``DeepSpeedTPUEngine.train_batch``
  on ``LlamaForCausalLM``, with the flash-attention forward, dQ and dK/dV
  kernels (``csrc/flash_attention.cu``);
- the quantized paths (slice 3) — ZeRO-Inference (``inference/
  zero_inference.py``, resident and host-streamed), qgZ on the training
  path and the engine's host KV tier, with the int8 and fp8 quantize and
  dequantize kernels (``csrc/quant.cu``);
- DS4Sci evoformer attention (slice 4) — ``ops/evoformer_attn.py``'s
  ``DS4Sci_EvoformerAttention``, forward and backward, with its five
  kernels (``csrc/evoformer.cu``);
- the op-level kernels (slice 5) — ``SparseSelfAttention``, ``rms_norm`` and
  ``fused_bias_act`` (``csrc/{sparse_attention,rms_norm,fused_bias_act}.cu``);
- the serving layer as one replica — ``serving/``: ``InferenceServer``
  (bounded queue, backpressure, deadlines, drain, the degradation ladder,
  the host-KV tier planner, step-fault isolation), the HTTP front door
  (``python -m deepspeed_tpu_torch.serving.cli``) and ``bench_serve``;
- the memory tiers — ``offload_optimizer`` (``runtime/offload.py``: fp32
  masters and moments on the host or NVMe, the fused host optimizers of
  ``ops/cpu_adam.py``, the async file I/O of ``ops/async_io.py``) and
  ``offload_param`` (``runtime/param_offload.py``: the weights streamed
  through the card a layer group at a time), at one rank. Their host
  sources, ``csrc/cpu_adam.cpp`` and ``csrc/aio.cpp``, are built by ``g++``
  on first use (``ops/build.py``). On the CPU: ``python -m pytest
  tests/test_torch_offload.py tests/test_torch_param_offload.py``; on the
  card, ``chip_smoke.py``'s ``train_offload``, ``train_param_offload`` and
  ``train_offload_parity`` phases;
- distribution — ``comm/`` on ``torch.distributed`` (the named-axis mesh,
  the collective facade, the quantized collectives, comm logging, the
  commguard), ``testing.py``'s multi-process harness, ZeRO stages 1-3
  (``runtime/zero/partition.py``) and qgZ's int8 wire over replica ranks
  (``runtime/zero/qgz.py``). ``init_distributed`` starts the process group
  (NCCL on the card, gloo for ``device="cpu"``), ``initialize(...,
  mesh=)`` trains over it. On the CPU: ``python -m pytest
  tests/test_torch_comm.py tests/test_torch_zero.py``; on the card,
  ``chip_smoke.py``'s ``train_zero``, ``train_zero_ranks`` and
  ``train_qgz_ranks`` phases;
- MoE — ``moe/sharded_moe.py`` (top-k gating, ``MOELayer`` with expert
  parallelism over the mesh's ``expert`` axis and the int8 dispatch wire),
  ``models/mixtral.py`` and ``models/qwen2_moe.py`` (training and HF
  interop), their serving policies (``inference/v2/modules.py``). On the
  CPU: ``python -m pytest tests/test_torch_moe.py
  tests/test_torch_moe_dist.py``; on the card, ``chip_smoke.py``'s
  ``serve_moe``, ``train_moe`` and ``train_moe_ranks`` phases;
- the training carry-overs — ``forward`` / ``backward`` / ``step`` on
  the engine (DeepSpeed's ``loss = engine(batch); engine.backward(loss);
  engine.step()``), the optimizers other than Adam (``ops/optimizers.py``:
  LAMB, Lion, Adagrad, SGD, RMSprop), ``initialize(training_data=)``'s
  loader (``runtime/dataloader.py``) and the ``async_pipeline`` group
  (``runtime/sched.py``'s ring, the staged prefetch, ``flush_metrics``).
  On the CPU: ``python -m pytest tests/test_torch_micro_steps.py
  tests/test_torch_optimizers.py tests/test_torch_async_pipeline.py``; on
  the card, ``chip_smoke.py``'s ``train_micro_steps``, ``train_async`` and
  ``train_optimizers`` phases;
- tensor parallelism — ``module_inject/`` (the parallel layers and their
  collectives, AutoTP's policies, the fused-QKV splitters), the Megatron
  rules and layout of ``models/llama.py`` (and the MoE models'), the
  engine's ``tensor`` axis under ZeRO stages 0-3, and ``init_inference``
  with the v1 ``InferenceEngine`` (``inference/engine.py``). On the CPU:
  ``python -m pytest tests/test_torch_tp.py``; on the card,
  ``chip_smoke.py``'s ``infer_tp_ranks`` and ``train_tp_ranks`` phases.

Importing this package starts no work and touches no device: the
reference's re-exports (``DeepSpeedTPUConfig``, ``DeepSpeedTPUEngine``,
``log_dist``, ``logger``, ``init_distributed``) load on first use.
"""

from typing import Any, Callable, Optional

__version__ = "0.2.0"

_LAZY = {
    "DeepSpeedTPUConfig": "deepspeed_tpu_torch.config.config",
    "DeepSpeedTPUEngine": "deepspeed_tpu_torch.runtime.engine",
    "log_dist": "deepspeed_tpu_torch.utils.logging",
    "logger": "deepspeed_tpu_torch.utils.logging",
    "init_distributed": "deepspeed_tpu_torch.comm.mesh",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def get_accelerator():
    """reference ``deepspeed_tpu.accelerator.get_accelerator``."""
    raise NotImplementedError(
        "get_accelerator (accelerator/) is not ported yet (ROADMAP Queue 1 "
        "item 7); the port runs on the card unless device='cpu' is given")


def init_inference(model=None, config=None, params=None, mesh=None,
                   tensor_rules=None, device=None, **kwargs):
    """reference: deepspeed.init_inference (deepspeed/__init__.py:291);
    JAX ``deepspeed_tpu/__init__.py:160-176``.

    When ``tensor_rules`` is not given and tp_size > 1, AutoTP resolves a
    policy from the model's architecture (reference: auto-injection via
    ``replace_transformer_layer``/``AutoTP``, module_inject/replace_module.py:183).
    ``params``: the full parameters (a flat state dict or the flax tree),
    cut to this rank's blocks; ``mesh``: by default ``data=-1,
    tensor=tp_size`` over the started process group; ``device``: the card
    unless the caller names the CPU.
    """
    from deepspeed_tpu_torch.inference.config import InferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    inf_config = config if isinstance(config, InferenceConfig) \
        else InferenceConfig.from_dict(config, **kwargs)
    if tensor_rules is None and inf_config.tp_size > 1:
        from deepspeed_tpu_torch.module_inject.auto_tp import AutoTP
        tensor_rules = AutoTP.infer_rules(
            model, params=params if params is not None else model)
    return InferenceEngine(model, inf_config, params=params, mesh=mesh,
                           tensor_rules=tensor_rules, device=device)


def add_config_arguments(parser):
    """reference: deepspeed.add_config_arguments (deepspeed/__init__.py:268)."""
    group = parser.add_argument_group("DeepSpeed-TPU", "DeepSpeed-TPU configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed-TPU (helper flag for config parsing)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to the DeepSpeed-TPU json config file")
    return parser


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, config: Any = None,
               config_params: Any = None, loss_fn: Optional[Callable] = None,
               device=None, mesh=None, tensor_rules: Optional[Callable] = None,
               collate_fn: Optional[Callable] = None):
    """Build the training engine (reference ``deepspeed.initialize``;
    ``deepspeed_tpu/__init__.py:28``). Returns ``(engine, optimizer,
    dataloader, lr_schedule)`` for a non-pipeline model; ``dataloader`` is
    None unless ``training_data`` (an indexable dataset of samples) is
    given, then a ``runtime.dataloader.DeepSpeedTPUDataLoader`` of global
    micro-batches (``micro_batch_size * dp_world_size`` samples, stacked by
    ``collate_fn`` or numpy), the same on every rank.

    ``model`` is an ``nn.Module`` whose ``forward(batch, compute_dtype=)``
    returns the loss (``models.llama.LlamaForCausalLM``);
    ``model_parameters`` is None (keep the module's weights) or the flax
    parameter tree (numpy leaves) to load as fp32 masters (the module's
    own weights come from its seed). ``device`` defaults to the card; pass
    ``device="cpu"`` to train on the CPU. ``zero_optimization``'s
    ``offload_optimizer`` and ``offload_param`` (``cpu`` or ``nvme``) put
    the optimizer state, and the weights, in host memory or files; the
    returned optimizer is then the host optimizer. ``mesh`` is a
    ``comm.mesh.Mesh`` over the started process group; by default the
    config's ``mesh`` group over every rank (one rank when
    ``init_distributed`` was not called). ``tensor_rules(name, leaf) ->
    spec | None`` places model-parallel leaves (``moe.sharded_moe.
    moe_tensor_rules``, ``models.mixtral.mixtral_tensor_rules``: each rank
    keeps its block of the experts over the mesh's ``expert`` axis; the
    expert rules are the default on such a mesh)."""
    from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedTPUEngine
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if model is None:
        raise ValueError("initialize needs a model (an nn.Module)")
    ds_config = config if isinstance(config, DeepSpeedTPUConfig) \
        else DeepSpeedTPUConfig(config)
    engine = DeepSpeedTPUEngine(
        model, ds_config, params=model_parameters, loss_fn=loss_fn,
        lr_scheduler=lr_scheduler if callable(lr_scheduler) else None,
        client_optimizer=optimizer, device=device, mesh=mesh,
        tensor_rules=tensor_rules)
    dataloader = None
    if training_data is not None:
        from deepspeed_tpu_torch.runtime.dataloader import (
            DeepSpeedTPUDataLoader)
        # every rank loads the global batch; the engine keeps its rows
        dataloader = DeepSpeedTPUDataLoader(
            training_data,
            batch_size=engine.micro_batch_size * engine.dp_world_size,
            collate_fn=collate_fn)
    return engine, engine.optimizer, dataloader, engine.lr_schedule
