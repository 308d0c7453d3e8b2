"""Module injection / automatic tensor parallelism
(port of ``deepspeed_tpu/module_inject/``; reference ``deepspeed/module_inject/``)."""

from deepspeed_tpu_torch.module_inject.auto_tp import GENERIC_POLICY, AutoTP  # noqa: F401
from deepspeed_tpu_torch.module_inject.fusedqkv_utils import (  # noqa: F401
    qkv_sizes,
    shard_qkv_param,
    split_fused_qkv,
    unfuse_qkv,
)
from deepspeed_tpu_torch.module_inject.layers import (  # noqa: F401
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from deepspeed_tpu_torch.module_inject.policies import (  # noqa: F401
    POLICIES,
    TPPolicy,
    get_policy,
)
