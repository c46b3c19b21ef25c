"""stablelm-1.6b [dense].

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352
[hf:stabilityai/stablelm-2-1_6b; unverified]

The same values as ``repro/configs/stablelm_1_6b.py`` with one deliberate
difference: ``CONFIG`` sets ``use_flash_kernel=True``, so the prefill's
attention runs through the hand-written CUDA flash-attention kernel
(``kernels/csrc/flash_attention.cu``; head_dim 64).  ``SMOKE`` keeps the
default; tests set the knob the same way on both sides.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, RopeConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    d_ff=5632,
    vocab=100352,
    attention=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=64,
                              rope=RopeConfig(theta=10000.0, partial_pct=0.25)),
    norm="layernorm",      # stablelm-2 uses LayerNorm
    act="silu_gated",
    tie_embeddings=False,
    use_flash_kernel=True,   # the one difference from the JAX config
)

SMOKE = ModelConfig(
    name="stablelm-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=160,
    vocab=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                              rope=RopeConfig(partial_pct=0.25)),
    norm="layernorm",
    act="silu_gated",
    remat="none",
)
