"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936. GQA, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.config import AttentionConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    d_ff=8960,
    vocab_size=151_936,
    attention=AttentionConfig(
        num_heads=12, num_kv_heads=2, head_dim=128,
        qk_norm=False, qkv_bias=True, rope_theta=1_000_000.0,
    ),
    tie_embeddings=True,
    act="silu",
    source="arXiv:2407.10671; hf",
))
