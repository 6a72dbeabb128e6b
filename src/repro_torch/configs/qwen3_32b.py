"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936. qk_norm, GQA. [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.config import AttentionConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    d_ff=25_600,
    vocab_size=151_936,
    attention=AttentionConfig(
        num_heads=64, num_kv_heads=8, head_dim=128,
        qk_norm=True, qkv_bias=False, rope_theta=1_000_000.0,
    ),
    act="silu",
    source="hf:Qwen/Qwen3-8B; hf",
))
