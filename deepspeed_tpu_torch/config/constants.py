"""Config keys and defaults the training and serving paths read.

Copy of the part of ``deepspeed_tpu/config/constants.py`` that the port's
config parses; the keys are the reference's JSON space.
"""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"

FP16 = "fp16"
BF16 = "bf16"
ZERO_OPTIMIZATION = "zero_optimization"
GRADIENT_CLIPPING = "gradient_clipping"
STEPS_PER_PRINT = "steps_per_print"
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
DATA_TYPES = "data_types"                 # reference: constants.py:426
GRAD_ACCUM_DTYPE = "grad_accum_dtype"     # reference: constants.py:427
# legacy spelling of the bf16 group accepted for drop-in compatibility
BF16_LEGACY = "bfloat16"
RESILIENCE = "resilience"                 # only its step guard is read
SERVING = "serving"                       # serving group (admission,
#                                           degradation ladder, host KV
#                                           offload tier, fault isolation;
#                                           serving/server.py
#                                           ServingConfig.from_ds_config)

STEPS_PER_PRINT_DEFAULT = 10
GRADIENT_CLIPPING_DEFAULT = 0.0
GRADIENT_ACCUMULATION_STEPS_DEFAULT = 1
