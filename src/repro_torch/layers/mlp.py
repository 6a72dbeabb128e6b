"""Feed-forward blocks: SwiGLU (llama/qwen) and GELU (whisper) (port of
``repro.layers.mlp``), and their tensor-parallel form over a mesh axis
(:func:`mlp_apply_tp`)."""
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


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32, device="cpu"):
    return {
        "w_in": dense_init(gen, d_model, d_ff, dtype, device),
        "b_in": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w_out": dense_init(gen, d_ff, d_model, dtype, device),
        "b_out": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation; so is this."""
    h = torch.matmul(x, params["w_in"]) + params["b_in"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return torch.matmul(h, params["w_out"]) + params["b_out"]


def mlp_init(gen, d_model, d_ff, act: str, dtype=torch.float32, device="cpu"):
    """``"gelu"`` builds the GELU MLP, any other ``act`` the SwiGLU (the
    reference's rule)."""
    if act == "gelu":
        return gelu_mlp_init(gen, d_model, d_ff, dtype, device)
    return swiglu_init(gen, d_model, d_ff, dtype, device)


def mlp_apply(params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return gelu_mlp(params, x)
    return swiglu(params, x)


def mlp_apply_tp(params, x: torch.Tensor, act: str, tp) -> torch.Tensor:
    """:func:`mlp_apply` with Megatron's split: ``w_gate``/``w_up``
    (``w_in``) column-parallel, so each rank holds its block of the hidden
    units, and ``w_down`` (``w_out``) row-parallel over the same block,
    its partial products summed over the axis in float32 (``tp``: a
    ``TensorParallel``).  The biases are whole on every rank: ``b_in``'s
    block is added before the activation, ``b_out`` after the sum.  x
    (whole on every rank) and ``b_in`` enter the split through
    ``tp.enter``, so the gradients that flow back to them are whole."""
    x = tp.enter(x)
    if act == "gelu":
        lo, hi = tp.bounds(params["b_in"].shape[-1])
        h = (torch.matmul(x, params["w_in"])
             + tp.enter(params["b_in"])[..., lo:hi])
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        return tp.psum(torch.matmul(h, params["w_out"])) + params["b_out"]
    g = torch.matmul(x, params["w_gate"])
    u = torch.matmul(x, params["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return tp.psum(torch.matmul(h, params["w_down"]))


def mlp_apply_mesh(params, x: torch.Tensor, act: str, tp, path
                   ) -> torch.Tensor:
    """:func:`mlp_apply_tp` where the rules split the MLP (its params at
    ``path`` in the tree ``tp`` reads), else :func:`mlp_apply` whole."""
    if tp.split(*path, "w_in" if act == "gelu" else "w_gate"):
        return mlp_apply_tp(params, x, act, tp)
    return mlp_apply(params, x, act)
