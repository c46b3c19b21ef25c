"""olmo-1b [dense]: non-parametric LayerNorm.

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304
[arXiv:2402.00838; hf]

The same values as ``repro/configs/olmo_1b.py`` with one deliberate
difference: ``CONFIG`` sets ``use_flash_kernel=True``, so the prefill's
attention runs through the hand-written CUDA flash-attention kernel
(``kernels/csrc/flash_attention.cu``), which is the serving path on the
card.  In the JAX package the knob defaults to off.  ``SMOKE`` keeps the
default; tests set the knob the same way on both sides.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, RopeConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    d_ff=8192,
    vocab=50304,
    attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                              rope=RopeConfig(theta=10000.0)),
    norm="nonparametric",  # OLMo: LN without affine parameters
    act="silu_gated",
    tie_embeddings=True,   # OLMo ties input/output embeddings
    use_flash_kernel=True,   # the one difference from the JAX config
)

SMOKE = ModelConfig(
    name="olmo-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=256,
    vocab=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                              rope=RopeConfig()),
    norm="nonparametric",
    act="silu_gated",
    tie_embeddings=True,
    remat="none",
)
