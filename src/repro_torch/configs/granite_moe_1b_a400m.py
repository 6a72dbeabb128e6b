"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.config import (AttentionConfig, ModelConfig, MoEConfig,
                                register)

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    d_ff=512,
    vocab_size=49_155,
    attention=AttentionConfig(
        num_heads=16, num_kv_heads=8, head_dim=64,
        qk_norm=False, qkv_bias=False, rope_theta=10_000.0,
    ),
    moe=MoEConfig(num_experts=32, top_k=8, d_expert=512),
    tie_embeddings=True,
    act="silu",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
))
