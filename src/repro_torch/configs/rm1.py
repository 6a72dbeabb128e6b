"""RM1 — compute-intensive DLRM-DCNv2 (paper Table 3)."""
from repro_torch.config import DLRMConfig, register

CONFIG = register(DLRMConfig(
    name="rm1",
    num_tables=10,
    num_embeddings=1_000_000,
    embedding_dim=128,
    gathers_per_table=10,
    bottom_mlp=(512, 256, 64),
    top_mlp=(1024, 1024, 512, 256, 1),
    cross_rank=512,
    cross_layers=3,
))
