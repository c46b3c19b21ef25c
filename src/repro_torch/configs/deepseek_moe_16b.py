"""deepseek-moe-16b [moe]: 2 shared + 64 routed top-6, fine-grained experts.

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6
[arXiv:2401.06066; hf]

The same values as ``repro/configs/deepseek_moe_16b.py`` with one deliberate
difference: ``CONFIG`` sets ``use_flash_kernel=True``, so the prefill's
attention runs through the hand-written CUDA flash-attention kernel
(``kernels/csrc/flash_attention.cu``), which is the serving path on the
card.  In the JAX package the knob defaults to off.  ``SMOKE`` keeps the
default; tests set the knob the same way on both sides.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig, RopeConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    d_ff=1408,
    vocab=102400,
    attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                              rope=RopeConfig(theta=10000.0)),
    moe=MoEConfig(n_experts=64, top_k=6, expert_dff=1408, n_shared=2,
                  shared_dff=1408, capacity_factor=1.25, group_size=512),
    norm="rmsnorm",
    act="silu_gated",
    tie_embeddings=False,
    use_flash_kernel=True,   # the one difference from the JAX config
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    d_ff=128,
    vocab=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                              rope=RopeConfig()),
    # capacity_factor sized so smoke tests never drop tokens (prefill/decode
    # equivalence is exact only without capacity drops)
    moe=MoEConfig(n_experts=8, top_k=3, expert_dff=96, n_shared=2,
                  shared_dff=96, capacity_factor=8.0, group_size=64),
    norm="rmsnorm",
    act="silu_gated",
    remat="none",
)
