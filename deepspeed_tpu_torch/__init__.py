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
  (``python -m deepspeed_tpu_torch.serving.cli``) and ``bench_serve``.

Importing this package starts no work and touches no device.
"""

from typing import Any, Callable, Optional

__version__ = "0.2.0"


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, config: Any = None,
               config_params: Any = None, loss_fn: Optional[Callable] = None,
               device=None):
    """Build the training engine (reference ``deepspeed.initialize``;
    ``deepspeed_tpu/__init__.py:28``). Returns ``(engine, optimizer, None,
    lr_schedule)`` for a non-pipeline model.

    ``model`` is an ``nn.Module`` whose ``forward(batch, compute_dtype=)``
    returns the loss (``models.llama.LlamaForCausalLM``);
    ``model_parameters`` is None (keep the module's weights) or the flax
    parameter tree (numpy leaves) to load as fp32 masters (the module's
    own weights come from its seed). ``device`` defaults to the card; pass
    ``device="cpu"`` to train on the CPU."""
    from deepspeed_tpu_torch.config.config import DeepSpeedTPUConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedTPUEngine
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if training_data is not None:
        raise NotImplementedError(
            "training_data (the data loader) is not ported yet (ROADMAP "
            "Queue 1); pass batches to train_batch()")
    if model is None:
        raise ValueError("initialize needs a model (an nn.Module)")
    ds_config = config if isinstance(config, DeepSpeedTPUConfig) \
        else DeepSpeedTPUConfig(config)
    engine = DeepSpeedTPUEngine(
        model, ds_config, params=model_parameters, loss_fn=loss_fn,
        lr_scheduler=lr_scheduler if callable(lr_scheduler) else None,
        client_optimizer=optimizer, device=device)
    return engine, engine.optimizer, None, engine.lr_schedule
