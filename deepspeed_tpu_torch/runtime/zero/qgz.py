"""qgZ (ZeRO++ quantized gradients): what the one-card training path reads.

Port of the constant of ``deepspeed_tpu/runtime/zero/qgz.py`` that the
engine's per-micro-batch int8 round trip uses. The int8-wire gradient
reduction over replica axes (``replica_grad_axes``,
``quantized_grad_sync``, the partial-manual gradient phase) needs more
than one card and comes with the distribution slice (ROADMAP Queue 1,
"Distribution and memory tiers").
"""

# leaves below this many elements keep full precision: norm scales and
# biases are bandwidth-irrelevant and the most quantization-sensitive
MIN_QUANT_SIZE = 2048
