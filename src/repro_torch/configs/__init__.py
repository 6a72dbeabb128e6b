"""Architecture registry of the port (importing registers every config)."""
from repro_torch.configs import smollm_360m  # noqa: F401
