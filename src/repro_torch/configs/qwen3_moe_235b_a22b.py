"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) moe_d_ff=1536
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B family; hf]"""
from repro_torch.config import (AttentionConfig, ModelConfig, MoEConfig,
                                register)

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    d_ff=1536,                    # MoE expert FFN width (per assignment)
    vocab_size=151_936,
    attention=AttentionConfig(
        num_heads=64, num_kv_heads=4, head_dim=128,
        qk_norm=True, qkv_bias=False, rope_theta=1_000_000.0,
    ),
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536),
    act="silu",
    source="hf:Qwen/Qwen3-30B-A3B; hf",
))
