"""Training substrate of the port: AdamW, schedules, the train step and
int8 error-feedback gradient compression (ZeRO-1 waits for ROADMAP
Queue 1 item 6)."""
from repro_torch.train.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    global_norm,
    init_adamw,
    params_from_master,
)
from repro_torch.train.schedule import constant, inverse_sqrt, linear_warmup_cosine
from repro_torch.train.step import TrainState, init_train_state, make_train_step

__all__ = [
    "AdamWConfig", "AdamWState", "TrainState", "adamw_update", "constant",
    "global_norm", "init_adamw", "init_train_state", "inverse_sqrt",
    "linear_warmup_cosine", "make_train_step", "params_from_master",
]
