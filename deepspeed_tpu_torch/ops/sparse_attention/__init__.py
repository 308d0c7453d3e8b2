"""Block-sparse attention (port of ``deepspeed_tpu/ops/sparse_attention``)."""
from deepspeed_tpu_torch.ops.sparse_attention.attention import (  # noqa: F401
    SparseAttentionFunction, SparseLayout, SparseSelfAttention,
    block_sparse_attention, dense_mask_from_layout, sparse_attention,
    sparse_attention_bwd, sparse_attention_cuda, sparse_attention_fwd,
    sparse_attention_reference)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_configs import (  # noqa: F401
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, LocalSlidingWindowSparsityConfig, SparsityConfig,
    VariableSparsityConfig)
