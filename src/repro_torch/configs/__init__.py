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

# the LM archs of the dry run's cells, in the reference's order
ASSIGNED_LM_ARCHS = [
    "qwen3-moe-235b-a22b",
    "granite-moe-1b-a400m",
    "qwen2-1.5b",
    "qwen3-32b",
    "internlm2-20b",
    "smollm-360m",
    "internvl2-26b",
    "rwkv6-1.6b",
    "zamba2-2.7b",
    "whisper-tiny",
]
