"""Model factory (port of ``repro.models.api.build_model``): every LM
family of the reference and DLRM."""
from __future__ import annotations

from repro_torch.config import DLRMConfig, get_config
from repro_torch.models.dlrm import DLRM
from repro_torch.models.rwkv6 import RWKV6LM
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.whisper import WhisperEncDec
from repro_torch.models.zamba2 import Zamba2LM


def build_model(cfg, *, device="cuda", **kw):
    """The model for ``cfg`` (a config or its ``--arch`` id), dispatched on
    its family as the reference does: ``ssm`` -> RWKV6LM, ``hybrid`` ->
    Zamba2LM, ``audio`` -> WhisperEncDec, the rest (dense, MoE, VLM) ->
    TransformerLM; a DLRMConfig -> DLRM.  ``kw`` goes to the model
    (``remat``, ``q_chunk``; ``use_batched`` for DLRM)."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    if isinstance(cfg, DLRMConfig):
        return DLRM(cfg, device=device, **kw)
    if cfg.family == "ssm":
        kw.pop("q_chunk", None)  # attention-free
        return RWKV6LM(cfg, device=device, **kw)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg, device=device, **kw)
    if cfg.family == "audio":
        return WhisperEncDec(cfg, device=device, **kw)
    return TransformerLM(cfg, device=device, **kw)
