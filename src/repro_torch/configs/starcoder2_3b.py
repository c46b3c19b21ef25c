"""starcoder2-3b [dense]: GQA, RoPE.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152
[arXiv:2402.19173; hf]

The same values as ``repro/configs/starcoder2_3b.py`` with one deliberate
difference: ``CONFIG`` sets ``use_flash_kernel=True``, so the prefill's
attention runs through the hand-written CUDA flash-attention kernel
(``kernels/csrc/flash_attention.cu``; 12 query heads a KV group) while the
prompt is no wider than the sliding window.  ``SMOKE`` keeps the default;
tests set the knob the same way on both sides.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, RopeConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    d_ff=12288,
    vocab=49152,
    attention=AttentionConfig(n_heads=24, n_kv_heads=2, head_dim=128,
                              rope=RopeConfig(theta=100000.0),
                              sliding_window=4096, pattern="local"),
    norm="layernorm",      # starcoder2 uses LayerNorm with bias
    act="gelu",            # plain (non-gated) GELU MLP
    tie_embeddings=True,
    use_flash_kernel=True,   # the one difference from the JAX config
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=256,
    vocab=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                              rope=RopeConfig(), sliding_window=32,
                              pattern="local"),
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    remat="none",
)
