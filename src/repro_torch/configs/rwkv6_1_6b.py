"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536.
Finch: data-dependent decay. [arXiv:2404.05892; unverified]"""
from repro_torch.config import ModelConfig, RWKVConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    d_ff=7168,
    vocab_size=65_536,
    rwkv=RWKVConfig(head_size=64, decay_lora=64, token_shift=True),
    act="relu",                   # rwkv channel-mix uses squared relu
    source="arXiv:2404.05892; unverified",
))
