"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. InternViT frontend is a STUB: the caller supplies precomputed
patch embeddings (vision_tokens per image) prepended to the text sequence.
[arXiv:2404.16821; hf]"""
from repro_torch.config import AttentionConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    d_ff=16_384,
    vocab_size=92_553,
    attention=AttentionConfig(
        num_heads=48, num_kv_heads=8, head_dim=128,
        qk_norm=False, qkv_bias=False, rope_theta=1_000_000.0,
    ),
    vision_tokens=256,            # pixel-unshuffled InternViT tile -> 256 tokens
    act="silu",
    source="arXiv:2404.16821; hf",
))
