"""Model library of the port (the ssm family: mamba2; the dense family:
olmo, gemma2, stablelm, starcoder2, qwen2-vl; the moe family: olmoe,
deepseek-moe; the hybrid family: zamba2; the encdec family: whisper)."""
from repro_torch.models.model import (
    DenseLM,
    EncDecLM,
    HybridLM,
    Mamba2LM,
    decode_step,
    forward,
    from_reference,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)

__all__ = ["DenseLM", "EncDecLM", "HybridLM", "Mamba2LM", "decode_step",
           "forward", "from_reference", "init_cache", "init_params",
           "loss_fn", "prefill"]
