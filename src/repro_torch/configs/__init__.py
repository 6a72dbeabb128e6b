"""Architecture registry of the port (importing registers every config)."""
from repro_torch.configs import rm1, rm2, smollm_360m  # noqa: F401
