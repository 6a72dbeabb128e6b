"""Architecture registry of the port (importing registers every config)."""
from repro_torch.configs import (  # noqa: F401
    granite_moe_1b_a400m,
    internlm2_20b,
    internvl2_26b,
    llama31_8b,
    llama31_70b,
    qwen2_1_5b,
    qwen3_32b,
    qwen3_moe_235b_a22b,
    rm1,
    rm2,
    rwkv6_1_6b,
    smollm_360m,
    whisper_tiny,
    zamba2_2_7b,
)
