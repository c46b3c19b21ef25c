"""Model/shape configuration schema: the port's copy of
``repro/configs/base.py`` -- the dataclasses, the four input shapes of the
(arch x shape) table and the rule of which shapes an arch takes.

One ``ModelConfig`` instance fully determines a network; each ported
architecture file (``src/repro_torch/configs/<id>.py``) exports ``CONFIG``
(the published configuration) and ``SMOKE`` (a reduced same-family config
for CPU tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class RopeConfig:
    theta: float = 10000.0
    partial_pct: float = 1.0           # stablelm: 0.25 (rotate first 25% of dims)
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 64
    rope: Optional[RopeConfig] = field(default_factory=RopeConfig)
    softcap: Optional[float] = None     # gemma2 attn logit softcap (50.0)
    sliding_window: Optional[int] = None
    # 'global' | 'local' | 'alternating' (gemma2: local, global, local, ...)
    pattern: str = "global"
    query_scale: Optional[float] = None  # override 1/sqrt(head_dim)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    expert_dff: int = 128
    n_shared: int = 0                  # deepseek: 2 always-on shared experts
    shared_dff: Optional[int] = None   # defaults to expert_dff per shared expert
    capacity_factor: float = 1.25
    group_size: int = 512              # GShard-style dispatch group (tokens)
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    head_dim: int = 64                 # SSD head dim
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256                   # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'encdec'
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 128
    d_ff: int = 512
    vocab: int = 1000
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # norm: 'rmsnorm' | 'rmsnorm_one' (gemma (1+w)) | 'layernorm' |
    #       'layernorm_nobias' | 'nonparametric' (olmo)
    norm: str = "rmsnorm"
    norm_eps: float = 1e-5
    # act: 'silu_gated' | 'gelu_gated' | 'gelu'
    act: str = "silu_gated"
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None  # gemma2 final logit softcap (30.0)
    post_block_norm: bool = False          # gemma2 post-attn/post-ffn norms
    # hybrid (zamba2): a shared transformer block applied every N ssm layers
    shared_attn_every: int = 0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0                       # encoder frames (stub frontend)
    # modality stub: 'none' | 'audio_frames' (whisper) | 'patches' (qwen2-vl
    # uses token ids + M-RoPE positions; patches arrive pre-embedded)
    frontend: str = "none"
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # remat: 'none' | 'full' | 'dots'
    remat: str = "full"
    # perf knobs (hillclimbing)
    # the hand-written kernel: for the ssm family the CUDA SSD chunked scan,
    # for the dense family the CUDA flash attention of the prefill
    use_flash_kernel: bool = False
    seq_shard_activations: bool = False    # sequence-parallel residual stream
    kv_cache_quant: bool = False           # int8 KV cache (+f32 per-token scales)

    # -- derived ----------------------------------------------------------
    @property
    def d_head_total(self) -> int:
        return self.attention.n_heads * self.attention.head_dim

    @property
    def n_params_estimate(self) -> int:
        """Rough dense-equivalent parameter count (reporting only)."""
        a = self.attention
        d = self.d_model
        attn = d * a.head_dim * (a.n_heads + 2 * a.n_kv_heads) + a.n_heads * a.head_dim * d
        if self.family in ("ssm", "hybrid"):
            s = self.ssm
            di = s.expand * d
            nheads = di // s.head_dim
            ssm_p = d * (2 * di + 2 * s.d_state + nheads) + di * d
            per_layer = ssm_p
            if self.family == "hybrid":
                # shared transformer block params are reused, but each
                # INVOCATION costs flops: count it once per application for
                # the compute estimate (n_layers // shared_attn_every uses).
                gated = 3 if self.act.endswith("gated") else 2
                shared = attn + gated * d * self.d_ff
                n_inv = self.n_layers // max(self.shared_attn_every, 1)
                emb_h = self.vocab * d * (1 if self.tie_embeddings else 2)
                return self.n_layers * ssm_p + n_inv * shared + emb_h
        elif self.family == "moe":
            m = self.moe
            gated = 3 if self.act.endswith("gated") else 2
            experts = m.n_experts * gated * d * m.expert_dff
            shared = m.n_shared * gated * d * (m.shared_dff or m.expert_dff)
            per_layer = attn + experts + shared + d * m.n_experts
        else:
            gated = 3 if self.act.endswith("gated") else 2
            per_layer = attn + gated * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        n_l = self.n_layers + self.n_enc_layers
        return n_l * per_layer + emb

    @property
    def decode_active_params_estimate(self) -> int:
        """Per-token compute params during DECODE (enc-dec: decoder only,
        the encoder ran once at prefill)."""
        if self.family != "encdec":
            return self.n_active_params_estimate
        a = self.attention
        d = self.d_model
        attn = d * a.head_dim * (a.n_heads + 2 * a.n_kv_heads) + a.n_heads * a.head_dim * d
        gated = 3 if self.act.endswith("gated") else 2
        per_dec = 2 * attn + gated * d * self.d_ff  # self-attn + cross-attn + mlp
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_dec + emb

    @property
    def n_active_params_estimate(self) -> int:
        """Active (per-token) parameters — differs for MoE."""
        if self.family != "moe":
            return self.n_params_estimate
        m = self.moe
        gated = 3 if self.act.endswith("gated") else 2
        a = self.attention
        d = self.d_model
        attn = d * a.head_dim * (a.n_heads + 2 * a.n_kv_heads) + a.n_heads * a.head_dim * d
        active = m.top_k * gated * d * m.expert_dff + \
            m.n_shared * gated * d * (m.shared_dff or m.expert_dff)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + active + d * m.n_experts) + emb

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets lowered in the dry-run."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                          kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                         kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                        kind="decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}

# Archs allowed to run long_500k (sub-quadratic context handling).
LONG_CONTEXT_ARCHS = frozenset({"mamba2-130m", "zamba2-7b"})


def shape_applicable(arch_id: str, shape: ShapeConfig,
                     cfg: ModelConfig) -> bool:
    if shape.name == "long_500k" and arch_id not in LONG_CONTEXT_ARCHS:
        return False
    return True
