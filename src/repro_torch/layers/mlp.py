"""SwiGLU feed-forward block (port of ``repro.layers.mlp``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_init(gen, d_in, d_out, dtype, device):
    """A (d_in, d_out) weight, normal scaled by d_in^-0.5."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device) * d_in ** -0.5
    return w.to(dtype)


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32, device="cpu"):
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, params["w_gate"])
    u = torch.matmul(x, params["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.matmul(h, params["w_down"])


def mlp_init(gen, d_model, d_ff, act: str, dtype=torch.float32, device="cpu"):
    if act != "silu":
        raise NotImplementedError(f"activation {act!r}: the port has SwiGLU")
    return swiglu_init(gen, d_model, d_ff, dtype, device)


def mlp_apply(params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act != "silu":
        raise NotImplementedError(f"activation {act!r}: the port has SwiGLU")
    return swiglu(params, x)
