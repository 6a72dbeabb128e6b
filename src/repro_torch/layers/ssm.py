"""Mamba2-style SSD block (port of ``repro.layers.ssm``, used by zamba2):
the chunked form for training and prefill, and a single decode step.

Recurrence (per head h, head_dim P, state N):
    h_t = a_t * h_{t-1} + (dt_t * x_t) (x) B_t        a_t scalar per head
    y_t = h_t C_t + D * x_t
Chunked form: within a chunk, a masked (C.B) "attention" product; between
chunks, a loop over chunk states.  Every decay exponent is <= 0: the
differences are masked to ``-inf`` before ``exp``.

``A_log``, ``D`` and ``dt_bias`` are float32 leaves in every model dtype,
as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.config import SSMConfig
from repro_torch.layers.norm import rmsnorm, rmsnorm_init


class SSMDims(NamedTuple):
    d_inner: int
    num_heads: int
    conv_dim: int


def ssm_dims(d_model: int, s: SSMConfig) -> SSMDims:
    d_inner = s.expand * d_model
    num_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return SSMDims(d_inner, num_heads, conv_dim)


def ssm_init(gen: torch.Generator, d_model: int, s: SSMConfig,
             dtype=torch.float32, device="cpu"):
    dims = ssm_dims(d_model, s)
    in_dim = 2 * dims.d_inner + 2 * s.d_state + dims.num_heads  # z,x,B,C,dt
    f32 = torch.float32

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=f32, device=device)
                * scale).to(dtype)

    return {
        "in_proj": normal((d_model, in_dim), d_model ** -0.5),
        "conv_w": normal((s.d_conv, dims.conv_dim), 0.1),
        "conv_b": torch.zeros((dims.conv_dim,), dtype=dtype, device=device),
        "A_log": torch.zeros((dims.num_heads,), dtype=f32, device=device),
        "D": torch.ones((dims.num_heads,), dtype=f32, device=device),
        "dt_bias": torch.zeros((dims.num_heads,), dtype=f32, device=device),
        "norm": rmsnorm_init(dims.d_inner, dtype, device),
        "out_proj": normal((dims.d_inner, d_model), dims.d_inner ** -0.5),
    }


def _split_in(proj, dims: SSMDims, s: SSMConfig):
    """proj (..., in_dim) -> z, xBC, dt."""
    return torch.split(proj, [dims.d_inner, dims.conv_dim, dims.num_heads],
                       dim=-1)


def _causal_conv(xBC, w, b, prev=None):
    """Depthwise causal conv1d. xBC (B,S,C); w (K,C); prev (B,K-1,C) or
    None.  Returns (silu(conv), the last K-1 inputs for the next call)."""
    K = w.shape[0]
    if prev is None:
        prev = torch.zeros(xBC.shape[:1] + (K - 1,) + xBC.shape[2:],
                           dtype=xBC.dtype, device=xBC.device)
    xp = torch.cat([prev, xBC], dim=1)
    S = xBC.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K)) + b
    new_prev = xp[:, -(K - 1):] if K > 1 else prev
    return F.silu(out.float()).to(xBC.dtype), new_prev


def ssm_chunked(params, x, s: SSMConfig, d_model: int):
    """x (B,S,D) -> (B,S,D). Training / prefill form."""
    dims = ssm_dims(d_model, s)
    B, S, _ = x.shape
    proj = torch.matmul(x, params["in_proj"])
    z, xBC, dt_raw = _split_in(proj, dims, s)
    xBC, _ = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xs, Bm, Cm = torch.split(xBC, [dims.d_inner, s.d_state, s.d_state],
                             dim=-1)
    H, P, N = dims.num_heads, s.head_dim, s.d_state
    xs = xs.reshape(B, S, H, P)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])    # (B,S,H)
    la_step = -torch.exp(params["A_log"]) * dt              # log a_t <= 0

    Lc = min(s.chunk_size, S)
    assert S % Lc == 0, (S, Lc)
    nc = S // Lc

    def reshape_c(t):
        return t.reshape((B, nc, Lc) + tuple(t.shape[2:]))

    xs_c, B_c, C_c = reshape_c(xs), reshape_c(Bm), reshape_c(Cm)
    la_c = reshape_c(la_step)                               # (B,nc,Lc,H)
    dtx = xs_c * dt.reshape(B, nc, Lc, H)[..., None].to(xs_c.dtype)

    la_incl = torch.cumsum(la_c, dim=2)                     # (B,nc,Lc,H)
    idx = torch.arange(Lc, device=x.device)
    mask = idx[:, None] >= idx[None, :]                     # j <= i

    # intra-chunk: A[b,c,i,j,h] = (C_i.B_j) exp(la_i - la_j), j <= i
    cb = torch.einsum("bcin,bcjn->bcij", C_c, B_c).float()  # (B,nc,Lc,Lc)
    ddiff = la_incl[:, :, :, None, :] - la_incl[:, :, None, :, :]
    ddiff = torch.where(mask[:, :, None], ddiff, -torch.inf)
    A = cb[..., None] * torch.exp(ddiff)                    # (B,nc,i,j,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", A.to(xs_c.dtype), dtx)

    # inter-chunk state loop: a chunk's contribution to the state is
    # sum_j exp(la_end - la_j) dtx_j (x) B_j
    dec_to_end = torch.exp(la_incl[:, :, -1:, :] - la_incl)  # (B,nc,Lc,H)
    chunk_state = torch.einsum("bcjh,bcjhp,bcjn->bchpn", dec_to_end.float(),
                               dtx.float(), B_c.float())
    chunk_decay = torch.exp(la_incl[:, :, -1, :])           # (B,nc,H)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                   # (B,nc,H,P,N)

    # inter-chunk output: y_i += (C_i exp(la_incl_i)) . h_prev_chunk
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", C_c.float(), h_prevs,
                           torch.exp(la_incl).float())
    y = y_intra.float() + y_inter
    y = y + xs_c.float() * params["D"][None, None, None, :, None]
    y = y.reshape(B, S, dims.d_inner).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z.float()).to(x.dtype))
    return torch.matmul(y, params["out_proj"])


def ssm_init_state(batch: int, d_model: int, s: SSMConfig,
                   dtype=torch.float32, device="cpu"):
    dims = ssm_dims(d_model, s)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, dims.conv_dim),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, dims.num_heads, s.head_dim, s.d_state),
                         dtype=torch.float32, device=device),
    }


def ssm_step(params, x, state, s: SSMConfig, d_model: int):
    """Single decode step. x (B,1,D) -> (B,1,D), new state."""
    dims = ssm_dims(d_model, s)
    B = x.shape[0]
    proj = torch.matmul(x, params["in_proj"])
    z, xBC, dt_raw = _split_in(proj, dims, s)
    xBC, new_conv = _causal_conv(xBC, params["conv_w"], params["conv_b"],
                                 prev=state["conv"])
    xs, Bm, Cm = torch.split(xBC, [dims.d_inner, s.d_state, s.d_state],
                             dim=-1)
    H, P = dims.num_heads, s.head_dim
    xs = xs.reshape(B, H, P)
    Bm, Cm = Bm[:, 0].float(), Cm[:, 0].float()             # (B,N)
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"])  # (B,H)
    a = torch.exp(-torch.exp(params["A_log"]) * dt)         # (B,H)
    dtx = xs.float() * dt[..., None]
    h = (state["h"] * a[:, :, None, None]
         + torch.einsum("bhp,bn->bhpn", dtx, Bm))
    y = torch.einsum("bhpn,bn->bhp", h, Cm)
    y = y + xs.float() * params["D"][None, :, None]
    y = y.reshape(B, 1, dims.d_inner).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z.float()).to(x.dtype))
    return torch.matmul(y, params["out_proj"]), {"conv": new_conv, "h": h}
