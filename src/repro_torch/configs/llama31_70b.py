"""llama31-70b — the paper's multi-device TP serving workload (Table 3).
80L hidden=8192 64H (GQA kv=8) d_ff=28672 vocab=128256."""
from repro_torch.config import AttentionConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama31-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    d_ff=28_672,
    vocab_size=128_256,
    attention=AttentionConfig(
        num_heads=64, num_kv_heads=8, head_dim=128,
        qk_norm=False, qkv_bias=False, rope_theta=500_000.0,
    ),
    act="silu",
    source="paper Table 3 / arXiv:2407.21783",
))
