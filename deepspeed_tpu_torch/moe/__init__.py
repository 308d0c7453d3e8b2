"""Top-k gating and the expert-parallel MoE layer (``sharded_moe.py``)."""
