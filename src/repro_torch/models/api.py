"""Model factory and input stand-ins (port of ``repro.models.api``):
every LM family of the reference and DLRM.

``input_specs`` / ``dlrm_input_specs`` give the dry run's model inputs as
meta tensors (the reference's ``jax.ShapeDtypeStruct`` stand-ins): the
shapes and dtypes of a step's inputs, with no data and no allocation.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.config import (AUDIO, VLM, DLRMConfig, ModelConfig,
                                ShapeCell, get_config)
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


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """Model-input stand-ins of one (arch x shape) dry-run cell, as meta
    tensors.

    train / prefill: ``tokens`` (B, S) [+ ``extra_embeds``, the VLM's
    vision stub (B, vision_tokens, D), whose text then shrinks so that the
    whole context is ``cell.seq_len``, or whisper's (B, encoder_seq, D)
    frames], bf16 as the reference's; decode: ``tokens`` (B,), one new
    token a request (the K/V cache comes from the model).  Tokens are the
    reference's int32, which the port's embedding takes as it is.
    """
    B, S = cell.global_batch, cell.seq_len
    if cell.kind not in ("train", "prefill"):
        return {"tokens": _meta((B,), torch.int32)}
    if cfg.family == VLM:
        n_img = cfg.vision_tokens
        return {"extra_embeds": _meta((B, n_img, cfg.d_model),
                                      torch.bfloat16),
                "tokens": _meta((B, S - n_img), torch.int32)}
    if cfg.family == AUDIO:
        return {"extra_embeds": _meta((B, cfg.encoder_seq, cfg.d_model),
                                      torch.bfloat16),
                "tokens": _meta((B, S), torch.int32)}
    return {"tokens": _meta((B, S), torch.int32)}


def dlrm_input_specs(cfg: DLRMConfig, batch: int) -> Dict[str, torch.Tensor]:
    """DLRM's batch stand-ins as meta tensors: ``dense`` (B, 13) f32,
    ``indices`` (B, T, L) int32 and ``label`` (B,) int32."""
    return {
        "dense": _meta((batch, cfg.dense_features), torch.float32),
        "indices": _meta((batch, cfg.num_tables, cfg.gathers_per_table),
                         torch.int32),
        "label": _meta((batch,), torch.int32),
    }
