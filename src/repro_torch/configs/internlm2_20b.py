"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544. GQA. [arXiv:2403.17297; hf]"""
from repro_torch.config import AttentionConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    d_ff=16_384,
    vocab_size=92_544,
    attention=AttentionConfig(
        num_heads=48, num_kv_heads=8, head_dim=128,
        qk_norm=False, qkv_bias=False, rope_theta=1_000_000.0,
    ),
    act="silu",
    source="arXiv:2403.17297; hf",
))
