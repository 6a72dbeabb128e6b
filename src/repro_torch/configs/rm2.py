"""RM2 — memory-intensive DLRM-DCNv2 (paper Table 3): embedding dominated."""
from repro_torch.config import DLRMConfig, register

CONFIG = register(DLRMConfig(
    name="rm2",
    num_tables=20,
    num_embeddings=1_000_000,
    embedding_dim=64,
    gathers_per_table=20,
    bottom_mlp=(256, 64, 64),
    top_mlp=(128, 64, 1),
    cross_rank=64,
    cross_layers=2,
))
