"""The decoder-only transformer in plain float32 PyTorch: one whole
sequence at a time, no cache, no kernels, no batching.

It follows the equations the port serves (``repro_torch.models.
transformer``), which are the published Llama-style block: RMSNorm (eps
from the configuration) before attention and before the feed-forward,
grouped-query attention with rotary embeddings (half rotation, the
configuration's theta) scaled by head_dim^-0.5, a SwiGLU, or a top-k
mixture of SwiGLU experts whose router softmax is renormalised over the
chosen experts (the lower index first among equal gates), the final
RMSNorm and a tied output head.  Granite's scalar multipliers (embedding,
attention, residual, logits) are not applied, as the port applies none.

``fp8=True`` is the control, the same model computed in fp8: both
operands of every product (projections, router, experts, q.k, p.v and the
head) are rounded to float8 e4m3 first, with a scale per row of the left
operand and per column of the right one; products accumulate, and norms,
softmax, RoPE, SiLU and the residual stream stay, in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    w = w.float()
    if fp8:
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x, positions, theta):
    """x (S, H, hd) rotated by positions (S,), half rotation."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, kv_heads, fp8):
    """Causal softmax attention: q (S, H, hd), k/v (S, KV, hd)."""
    S, H, hd = q.shape
    g = H // kv_heads
    if fp8:
        q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, 0)
    qg = q.reshape(S, kv_heads, g, hd).permute(1, 2, 0, 3)    # (KV,G,S,hd)
    kt = k.permute(1, 2, 0)[:, None]                          # (KV,1,hd,S)
    scores = (qg @ kt) * hd ** -0.5                           # (KV,G,S,S)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    if fp8:
        w = _fp8(w, -1)
    out = w @ v.permute(1, 0, 2)[:, None]                     # (KV,G,S,hd)
    return out.permute(2, 0, 1, 3).reshape(S, H * hd)


def _swiglu(x, wg, wu, wd, fp8):
    return _linear(F.silu(_linear(x, wg, fp8)) * _linear(x, wu, fp8), wd,
                   fp8)


def _moe(x, p, layer, experts, top_k, fp8):
    gates = torch.softmax(_linear(x, p["router"][layer], fp8), dim=-1)
    val, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    val, idx = val[:, :top_k], idx[:, :top_k]
    val = val / val.sum(-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(x)
    for e in range(experts):
        rows, which = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        y = _swiglu(x[rows], p["w_gate"][layer, e], p["w_up"][layer, e],
                    p["w_down"][layer, e], fp8)
        out.index_add_(0, rows, y * val[rows, which][:, None])
    return out


@torch.no_grad()
def logits(w: dict, d, tokens: torch.Tensor, rows: torch.Tensor, *,
           fp8: bool = False) -> torch.Tensor:
    """Float32 logits (len(rows), V) at positions ``rows`` of the sequence
    ``tokens`` (S,), from the weights ``w`` (the benchmark's layout) of
    the model ``d`` (``harness.model.Dims``)."""
    x = w["embed"]["table"][tokens.long()].float()
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    lay = w["layers"]
    for i in range(d.layers):
        a = lay["attn"]
        h = _rmsnorm(x, lay["ln1"]["scale"][i], d.eps)
        q = _linear(h, a["wq"][i], fp8).reshape(-1, d.heads, d.head_dim)
        k = _linear(h, a["wk"][i], fp8).reshape(-1, d.kv_heads, d.head_dim)
        v = _linear(h, a["wv"][i], fp8).reshape(-1, d.kv_heads, d.head_dim)
        q, k = _rope(q, pos, d.rope_theta), _rope(k, pos, d.rope_theta)
        x = x + _linear(_attention(q, k, v, d.kv_heads, fp8), a["wo"][i],
                        fp8)
        h = _rmsnorm(x, lay["ln2"]["scale"][i], d.eps)
        if d.moe:
            x = x + _moe(h, lay["moe"], i, d.experts, d.top_k, fp8)
        else:
            m = lay["mlp"]
            x = x + _swiglu(h, m["w_gate"][i], m["w_up"][i], m["w_down"][i],
                            fp8)
    x = _rmsnorm(x[rows.long()], w["final_norm"]["scale"], d.eps)
    return _linear(x, w["embed"]["table"].t(), fp8)
