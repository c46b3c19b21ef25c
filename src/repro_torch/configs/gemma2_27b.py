"""gemma2-27b [dense]: local+global alternating attention, logit softcap.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
[arXiv:2408.00118; hf]

The same values as ``repro/configs/gemma2_27b.py`` with one deliberate
difference: ``CONFIG`` sets ``use_flash_kernel=True``, so the prefill's
attention (the tanh softcap 50 inside it) runs through the hand-written
CUDA flash-attention kernel (``kernels/csrc/flash_attention.cu``) on every
layer whose window is not narrower than the prompt.  ``SMOKE`` keeps the
default; tests set the knob the same way on both sides.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, RopeConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    d_ff=36864,
    vocab=256000,
    attention=AttentionConfig(
        n_heads=32, n_kv_heads=16, head_dim=128,
        rope=RopeConfig(theta=10000.0),
        softcap=50.0,                 # attention logit softcap
        sliding_window=4096,
        pattern="alternating",        # local, global, local, ...
        query_scale=(4608 // 32) ** -0.5,  # query_pre_attn_scalar = d_model/n_heads
    ),
    norm="rmsnorm_one",               # gemma scales by (1 + w)
    act="gelu_gated",
    logit_softcap=30.0,               # final logit softcap
    post_block_norm=True,             # post-attention / post-ffn RMSNorms
    tie_embeddings=True,
    use_flash_kernel=True,   # the one difference from the JAX config
)

SMOKE = ModelConfig(
    name="gemma2-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    d_ff=256,
    vocab=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                              rope=RopeConfig(), softcap=50.0,
                              sliding_window=32, pattern="alternating",
                              query_scale=16.0 ** -0.5),
    norm="rmsnorm_one",
    act="gelu_gated",
    logit_softcap=30.0,
    post_block_norm=True,
    tie_embeddings=True,
    remat="none",
)
