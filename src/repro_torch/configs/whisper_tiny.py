"""whisper-tiny [audio] — enc-dec, 4L d_model=384 6H d_ff=1536 vocab=51865.
Conv frontend is a STUB: the caller supplies precomputed frame embeddings
(encoder_seq x d_model). [arXiv:2212.04356; unverified]"""
from repro_torch.config import AttentionConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,                 # decoder layers
    encoder_layers=4,
    encoder_seq=1500,             # 30 s of audio at 50 Hz after conv stub
    d_model=384,
    d_ff=1536,
    vocab_size=51_865,
    attention=AttentionConfig(
        num_heads=6, num_kv_heads=6, head_dim=64,
        qk_norm=False, qkv_bias=True, rope_theta=10_000.0, causal=True,
    ),
    act="gelu",
    source="arXiv:2212.04356; unverified",
))
