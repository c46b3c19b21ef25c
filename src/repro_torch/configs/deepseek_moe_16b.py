"""deepseek-moe-16b [moe]: 2 shared + 64 routed top-6, fine-grained experts.

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6
[arXiv:2401.06066; hf]

Data only: the same values as ``repro/configs/deepseek_moe_16b.py``,
field for field.
The moe family is not ported yet: ``models.init_params`` raises for it
(ROADMAP Queue 1 item 9.4).
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
