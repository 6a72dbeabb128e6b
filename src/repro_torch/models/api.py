"""Model factory (port of ``repro.models.api.build_model``: the dense and
MoE decoders and DLRM)."""
from __future__ import annotations

from typing import Union

from repro_torch.config import DLRMConfig, ModelConfig, get_config
from repro_torch.models.dlrm import DLRM
from repro_torch.models.transformer import TransformerLM


def build_model(cfg: Union[str, ModelConfig, DLRMConfig], *, device="cuda",
                **kw) -> Union[TransformerLM, DLRM]:
    """The model for ``cfg``; ``kw`` goes to the model (``use_batched`` for
    DLRM, True by default)."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    if isinstance(cfg, DLRMConfig):
        return DLRM(cfg, device=device, **kw)
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r}: the port builds dense and MoE decoders "
            "and DLRM only")
    return TransformerLM(cfg, device=device, **kw)
