"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
ssm_state=64. Mamba2 backbone + ONE shared attention block applied every 6
mamba layers (weight-shared, zamba-style). [arXiv:2411.15242; hf]"""
from repro_torch.config import AttentionConfig, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    d_ff=10_240,
    vocab_size=32_000,
    attention=AttentionConfig(
        num_heads=32, num_kv_heads=32, head_dim=80,
        qk_norm=False, qkv_bias=False, rope_theta=10_000.0,
    ),
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk_size=128),
    hybrid_attn_every=6,
    act="silu",
    source="arXiv:2411.15242; hf",
))
