"""Model library of the port (the ssm family: mamba2)."""
from repro_torch.models.model import (
    Mamba2LM,
    decode_step,
    forward,
    from_reference,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)

__all__ = ["Mamba2LM", "decode_step", "forward", "from_reference",
           "init_cache", "init_params", "loss_fn", "prefill"]
