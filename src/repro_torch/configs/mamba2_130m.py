"""mamba2-130m [ssm]: SSD (state-space duality), attention-free.

24L d_model=768 d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]

The same values as ``repro/configs/mamba2_130m.py`` with one deliberate
difference: ``CONFIG`` sets ``use_flash_kernel=True``, so the prefill's SSD
runs through the hand-written CUDA kernel (``kernels/csrc/ssd_scan.cu``),
which is the serving path on the card.  In the JAX package the knob
defaults to off.  ``SMOKE`` keeps the default; tests set the knob the same
way on both sides.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    d_ff=0,
    vocab=50280,
    attention=AttentionConfig(n_heads=1, n_kv_heads=1, head_dim=64, rope=None),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    norm="rmsnorm",
    act="silu_gated",
    tie_embeddings=True,
    use_flash_kernel=True,   # the one difference from the JAX config
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    d_ff=0,
    vocab=256,
    attention=AttentionConfig(n_heads=1, n_kv_heads=1, head_dim=16, rope=None),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=16),
    norm="rmsnorm",
    act="silu_gated",
    tie_embeddings=True,
    remat="none",
)
