"""whisper-large-v3 [audio]: enc-dec, conv frontend (stub).

32L d_model=1280 20H (GQA kv=20) d_ff=5120 vocab=51866
[arXiv:2212.04356; unverified]

Backbone only: the audio conv frontend is a stub — input_specs() provides
precomputed frame embeddings (B, enc_seq, d_model).  n_layers counts the
DECODER layers per the assignment; the encoder mirrors it (whisper-large
has 32 encoder + 32 decoder layers).

The same values as ``repro/configs/whisper_large_v3.py`` with one
deliberate difference: ``CONFIG`` sets ``use_flash_kernel=True``, so the
prefill's attention -- the encoder's unmasked self-attention, the
decoder's causal self-attention and its cross-attention over the
encoder's 1,500 frames -- runs through the hand-written CUDA
flash-attention kernel (``kernels/csrc/flash_attention.cu``), which is
the serving path on the card.  In the JAX package the knob defaults to
off.  ``SMOKE`` keeps the default; tests set the knob the same way on
both sides.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, RopeConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,           # decoder layers
    n_enc_layers=32,       # encoder layers
    enc_seq=1500,          # whisper audio frames after conv frontend
    d_model=1280,
    d_ff=5120,
    vocab=51866,
    attention=AttentionConfig(n_heads=20, n_kv_heads=20, head_dim=64,
                              rope=None),  # whisper: learned/sinusoidal pos, no rope
    norm="layernorm",
    act="gelu",
    frontend="audio_frames",
    tie_embeddings=True,
    use_flash_kernel=True,   # the one difference from the JAX config
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="encdec",
    n_layers=2,
    n_enc_layers=2,
    enc_seq=16,
    d_model=64,
    d_ff=128,
    vocab=256,
    attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16, rope=None),
    norm="layernorm",
    act="gelu",
    frontend="audio_frames",
    tie_embeddings=True,
    remat="none",
)
