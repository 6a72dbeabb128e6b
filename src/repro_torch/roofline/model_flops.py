"""Analytic model FLOPs per (arch x shape): 6·N·D to train, 2·N·D to
infer, plus the attention and linear-state terms (port of
``repro.roofline.model_flops``).  The dry run divides them by the step's
counted FLOPs for its useful-compute ratio."""
from __future__ import annotations

from repro_torch.config import HYBRID, SSM, ModelConfig, ShapeCell


def _attn_flops_per_token(cfg: ModelConfig, ctx: int, *, causal_avg: bool):
    """qk + pv FLOPs of ONE query token against ``ctx`` keys (forward)."""
    if cfg.attention is None:
        return 0.0
    a = cfg.attention
    eff = ctx / 2 if causal_avg else ctx
    per_layer = 4.0 * eff * a.num_heads * a.head_dim  # 2 qk + 2 pv
    n_attn = (cfg.num_layers // cfg.hybrid_attn_every
              if cfg.family == HYBRID else cfg.num_layers)
    return per_layer * n_attn


def _state_flops_per_token(cfg: ModelConfig):
    """Linear-state update + read FLOPs per token (rwkv6 / mamba2)."""
    if cfg.family == SSM and cfg.rwkv is not None:
        N = cfg.rwkv.head_size
        return 4.0 * cfg.d_model * N * cfg.num_layers
    if cfg.family == HYBRID and cfg.ssm is not None:
        d_inner = cfg.ssm.expand * cfg.d_model
        return 4.0 * d_inner * cfg.ssm.d_state * cfg.num_layers
    return 0.0


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    n_active = cfg.num_active_params()
    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        tokens = B * S
        return (6.0 * n_active * tokens
                + 3.0 * tokens * _attn_flops_per_token(cfg, S, causal_avg=True)
                + 3.0 * tokens * _state_flops_per_token(cfg))
    if cell.kind == "prefill":
        tokens = B * S
        return (2.0 * n_active * tokens
                + tokens * _attn_flops_per_token(cfg, S, causal_avg=True)
                + tokens * _state_flops_per_token(cfg))
    # decode: one token per request against a ctx of S
    return (2.0 * n_active * B
            + B * _attn_flops_per_token(cfg, S, causal_avg=False)
            + B * _state_flops_per_token(cfg))
