"""Model factory (port of ``repro.models.api.build_model``, dense family)."""
from __future__ import annotations

from typing import Union

from repro_torch.config import ModelConfig, get_config
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: Union[str, ModelConfig], *, device="cuda"
                ) -> TransformerLM:
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port builds dense decoders only")
    return TransformerLM(cfg, device=device)
