"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64
[arXiv:2411.15242; unverified]

The same values as ``repro/configs/zamba2_7b.py`` with one deliberate
difference: ``CONFIG`` sets ``use_flash_kernel=True``, so the prefill's
SSD runs through the hand-written CUDA kernel
(``kernels/csrc/ssd_scan.cu``) and the shared block's attention through
the flash-attention kernel (``kernels/csrc/flash_attention.cu``, its
head_dim 112 zero-padded to 128), which is the serving path on the card.
In the JAX package the knob defaults to off.  ``SMOKE`` keeps the
default; tests set the knob the same way on both sides.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, RopeConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    d_ff=14336,
    vocab=32000,
    attention=AttentionConfig(
        n_heads=32, n_kv_heads=32, head_dim=112,
        rope=RopeConfig(theta=10000.0),
    ),
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4, chunk=256),
    norm="rmsnorm",
    act="gelu_gated",
    shared_attn_every=6,   # one shared transformer block per 6 Mamba2 layers
    tie_embeddings=True,
    use_flash_kernel=True,   # the one difference from the JAX config
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    d_ff=128,
    vocab=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                              rope=RopeConfig()),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=32),
    norm="rmsnorm",
    act="gelu_gated",
    shared_attn_every=2,
    tie_embeddings=True,
    remat="none",
)
