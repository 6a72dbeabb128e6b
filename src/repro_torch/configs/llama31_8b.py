"""llama31-8b — the paper's own end-to-end LLM workload (Table 3).
32L hidden=4096 32H (GQA kv=8) d_ff=14336 vocab=128256."""
from repro_torch.config import AttentionConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama31-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    d_ff=14_336,
    vocab_size=128_256,
    attention=AttentionConfig(
        num_heads=32, num_kv_heads=8, head_dim=128,
        qk_norm=False, qkv_bias=False, rope_theta=500_000.0,
    ),
    act="silu",
    source="paper Table 3 / arXiv:2407.21783",
))
