"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152. llama-arch small. [hf:HuggingFaceTB/SmolLM-135M family; hf]"""
from repro_torch.config import AttentionConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    d_ff=2560,
    vocab_size=49_152,
    attention=AttentionConfig(
        num_heads=15, num_kv_heads=5, head_dim=64,
        qk_norm=False, qkv_bias=False, rope_theta=10_000.0,
    ),
    tie_embeddings=True,
    act="silu",
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
))
