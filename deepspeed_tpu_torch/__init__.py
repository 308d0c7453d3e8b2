"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The package mirrors ``deepspeed_tpu``'s module paths (the counterpart of
``deepspeed_tpu/inference/v2/engine_v2.py`` is
``deepspeed_tpu_torch/inference/v2/engine_v2.py``). It imports ``torch`` and
never ``jax`` or ``deepspeed_tpu``; modules it needs from the JAX package are
kept here as copies. Every Pallas kernel on a ported path becomes a kernel
written by hand for Hopper under ``csrc/``, built with ``nvcc`` on first use
(``ops/build.py``).

Ported so far: the serving path — ``InferenceEngineV2`` over the paged KV
cache, serving the Llama family, with the paged-attention kernel
(``csrc/paged_attention.cu``).

Importing this package starts no work and touches no device.
"""

__version__ = "0.1.0"
