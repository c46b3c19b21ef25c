"""qwen2-vl-7b [vlm]: M-RoPE, dynamic resolution (backbone only).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064
[arXiv:2409.12191; hf]

Backbone only: the vision tower is a stub.  The ``patches`` frontend has
no patch embedding, here or in the JAX package: its input is token ids
plus (B, 3, S) M-RoPE position triples (t/h/w) as the ViT would emit them
(``configs.specs.input_specs``); text alone gives three identical streams.

The same values as ``repro/configs/qwen2_vl_7b.py`` with one deliberate
difference: ``CONFIG`` sets ``use_flash_kernel=True``, so the prefill's
attention runs through the hand-written CUDA flash-attention kernel
(``kernels/csrc/flash_attention.cu``; 7 query heads a KV group).
``SMOKE`` keeps the default; tests set the knob the same way on both
sides.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, RopeConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    d_ff=18944,
    vocab=152064,
    attention=AttentionConfig(
        n_heads=28, n_kv_heads=4, head_dim=128,
        rope=RopeConfig(theta=1000000.0, mrope_sections=(16, 24, 24)),
    ),
    norm="rmsnorm",
    act="silu_gated",
    frontend="patches",
    tie_embeddings=False,
    use_flash_kernel=True,   # the one difference from the JAX config
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    d_ff=160,
    vocab=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                              rope=RopeConfig(mrope_sections=(2, 3, 3))),
    norm="rmsnorm",
    act="silu_gated",
    frontend="patches",
    remat="none",
)
