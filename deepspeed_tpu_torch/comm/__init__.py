"""Communication on ``torch.distributed``: the named-axis mesh, the
collective facade, the quantized collectives, comm-volume logging and the
commguard, and ``comm_compression``'s bucketed error-feedback gradient sync
(``compress.GradCompressor``) (port of ``deepspeed_tpu/comm``;
``compressed.py`` is not ported yet, ROADMAP Queue 1 item 2)."""

from deepspeed_tpu_torch.comm.comm import (
    ReduceOp,
    all_gather,
    all_reduce,
    all_to_all,
    barrier,
    broadcast_one_to_all,
    device_broadcast,
    ppermute,
    quantized_all_reduce,
    quantized_reduce_scatter,
    reduce_scatter,
)
from deepspeed_tpu_torch.comm.comms_logging import (
    CommsLogger,
    canonical_op_kind,
    get_comms_logger,
)
from deepspeed_tpu_torch.comm.compress import (
    CommCompressionConfig,
    CommCompressState,
    GradCompressor,
    TensorEF,
)
from deepspeed_tpu_torch.comm.guard import (
    COMM_FAULT_EXIT_CODE,
    CommFaultError,
    CommGuard,
    CommGuardConfig,
    CommInitError,
    CommOutcome,
    CommPeerLostError,
    CommWedgeError,
    bounded_init,
    classify_exception,
    comm_trace_tail,
    note_comm_op,
    set_comm_op_listener,
)
from deepspeed_tpu_torch.comm.mesh import (
    BATCH_AXES,
    FSDP_AXES,
    MESH_AXES,
    Mesh,
    create_mesh,
    get_data_parallel_world_size,
    get_expert_parallel_group,
    get_expert_parallel_rank,
    get_expert_parallel_world_size,
    get_global_mesh,
    get_model_parallel_world_size,
    get_pipe_parallel_world_size,
    get_seq_data_parallel_world_size,
    get_sequence_parallel_world_size,
    init_distributed,
    set_global_mesh,
)

__all__ = [
    "ReduceOp", "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
    "ppermute", "quantized_all_reduce", "quantized_reduce_scatter",
    "broadcast_one_to_all", "barrier", "device_broadcast", "CommsLogger",
    "canonical_op_kind", "CommCompressionConfig", "CommCompressState",
    "GradCompressor", "TensorEF", "get_comms_logger",
    "COMM_FAULT_EXIT_CODE", "CommFaultError", "CommGuard", "CommGuardConfig",
    "CommInitError", "CommOutcome", "CommPeerLostError", "CommWedgeError",
    "bounded_init", "classify_exception", "comm_trace_tail", "note_comm_op",
    "set_comm_op_listener", "MESH_AXES", "BATCH_AXES", "FSDP_AXES", "Mesh",
    "create_mesh", "init_distributed", "get_global_mesh", "set_global_mesh",
    "get_data_parallel_world_size", "get_seq_data_parallel_world_size",
    "get_model_parallel_world_size", "get_expert_parallel_world_size",
    "get_expert_parallel_group", "get_expert_parallel_rank",
    "get_sequence_parallel_world_size", "get_pipe_parallel_world_size",
]
