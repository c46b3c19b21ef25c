"""Training substrate of the port: AdamW with its ZeRO-1 sharding,
schedules, the train step and int8 error-feedback gradient compression."""
from repro_torch.train.optimizer import (
    AdamWConfig,
    AdamWState,
    Sharded,
    adamw_update,
    global_norm,
    init_adamw,
    params_from_master,
    shard_state,
    zero1_grad_constraint,
    zero1_spec,
    zero1_state_shardings,
)
from repro_torch.train.schedule import constant, inverse_sqrt, linear_warmup_cosine
from repro_torch.train.step import (
    TrainState,
    init_train_state,
    make_train_step,
    shard_train_state,
    zero1_specs,
)

__all__ = [
    "AdamWConfig", "AdamWState", "Sharded", "TrainState", "adamw_update",
    "constant", "global_norm", "init_adamw", "init_train_state",
    "inverse_sqrt", "linear_warmup_cosine", "make_train_step",
    "params_from_master", "shard_state", "shard_train_state",
    "zero1_grad_constraint", "zero1_spec", "zero1_specs",
    "zero1_state_shardings",
]
