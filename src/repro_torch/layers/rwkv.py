"""RWKV6 "Finch" layers (port of ``repro.layers.rwkv``): time mix with a
data-dependent decay, and channel mix.

Recurrence (per head, head_size N):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
w_t is data-dependent (a low-rank LoRA on the shifted input).  Training
and prefill run the chunked form (:func:`time_mix_chunked`: products
within a chunk, a loop over chunk states between chunks); decode runs
:func:`time_mix_step`.  The decay differences are masked to ``-inf``
before ``exp``, so every exponent taken is <= 0.

The leaves ``w0``, ``w1``, ``w2`` and ``u`` are float32 in every model
dtype, as in the reference.  The products run in plain PyTorch, as the
reference leaves them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import RWKVConfig
from repro_torch.layers.norm import layernorm, layernorm_init

CHUNK = 32


def _dense(gen, i, o, dtype, device, scale=None):
    s = scale if scale is not None else i ** -0.5
    w = torch.randn((i, o), generator=gen, dtype=torch.float32,
                    device=device) * s
    return w.to(dtype)


def rwkv_time_mix_init(gen: torch.Generator, d: int, r: RWKVConfig,
                       dtype=torch.float32, device="cpu"):
    H = d // r.head_size

    def half():
        return torch.full((d,), 0.5, dtype=dtype, device=device)

    f32 = torch.float32
    return {
        "mix_r": half(), "mix_k": half(), "mix_v": half(), "mix_w": half(),
        "wr": _dense(gen, d, d, dtype, device),
        "wk": _dense(gen, d, d, dtype, device),
        "wv": _dense(gen, d, d, dtype, device),
        "wo": _dense(gen, d, d, dtype, device),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x W1) W2))
        "w0": torch.full((d,), -2.0, dtype=f32, device=device),
        "w1": _dense(gen, d, r.decay_lora, f32, device),
        "w2": _dense(gen, r.decay_lora, d, f32, device, scale=0.1),
        "u": torch.zeros((H, r.head_size), dtype=f32, device=device),
        "ln_out": layernorm_init(d, dtype, device),
    }


def rwkv_channel_mix_init(gen: torch.Generator, d: int, d_ff: int,
                          dtype=torch.float32, device="cpu"):
    return {
        "mix_k": torch.full((d,), 0.5, dtype=dtype, device=device),
        "mix_r": torch.full((d,), 0.5, dtype=dtype, device=device),
        "wk": _dense(gen, d, d_ff, dtype, device),
        "wv": _dense(gen, d_ff, d, dtype, device),
        "wr": _dense(gen, d, d, dtype, device),
    }


def _token_shift(x, prev=None):
    """x (B,S,D) -> x shifted right by one; prev (B,D) fills position 0."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _lerp(x, x_sh, mix):
    return x + (x_sh - x) * mix


def _decay(params, xw):
    """Log decay per channel, clamped to <= ~0: (B,S,D) f32."""
    lora = torch.tanh(xw.float() @ params["w1"]) @ params["w2"]
    return -torch.exp(torch.clamp(params["w0"] + lora, -20.0, 8.0))


def time_mix_chunked(params, x, r_cfg: RWKVConfig):
    """Training / prefill form. x (B,S,D) -> (B,S,D)."""
    B, S, D = x.shape
    N = r_cfg.head_size
    H = D // N
    x_sh = _token_shift(x)
    rr = _lerp(x, x_sh, params["mix_r"]) @ params["wr"]
    kk = _lerp(x, x_sh, params["mix_k"]) @ params["wk"]
    vv = _lerp(x, x_sh, params["mix_v"]) @ params["wv"]
    lw = _decay(params, _lerp(x, x_sh, params["mix_w"]))  # (B,S,D) log-decay

    Lc = min(CHUNK, S)
    assert S % Lc == 0, (S, Lc)
    nc = S // Lc

    def rs(t):
        return t.reshape(B, nc, Lc, H, N)

    r, k, v, lw = rs(rr), rs(kk), rs(vv), rs(lw)
    la_incl = torch.cumsum(lw, dim=2)                     # (B,nc,Lc,H,N)
    la_excl = la_incl - lw
    idx = torch.arange(Lc, device=x.device)
    mask_lt = idx[:, None] > idx[None, :]                 # j < i

    rf, kf, vf = r.float(), k.float(), v.float()
    # intra: A_ij = sum_n r_in k_jn exp(la_excl_i - la_incl_j), j < i;
    # masked before exp (for j >= i the difference is positive)
    ddiff = la_excl[:, :, :, None] - la_incl[:, :, None]  # (B,nc,i,j,H,N)
    ddiff = torch.where(mask_lt[:, :, None, None], ddiff, -torch.inf)
    A = torch.einsum("bcihn,bcjhn,bcijhn->bcijh", rf, kf, torch.exp(ddiff))
    diag = torch.einsum("bcihn,hn,bcihn->bcih", rf, params["u"], kf)
    A = A + diag[:, :, :, None, :] * torch.eye(
        Lc, device=x.device)[None, None, :, :, None]
    y_intra = torch.einsum("bcijh,bcjhn->bcihn", A, vf)

    # inter-chunk state loop: h maps the k dim to the v dim, (B,H,N,N)
    dec_to_end = torch.exp(la_incl[:, :, -1:] - la_incl)  # (B,nc,Lc,H,N)
    chunk_state = torch.einsum("bcjhn,bcjhm->bchnm", kf * dec_to_end, vf)
    chunk_decay = torch.exp(la_incl[:, :, -1])            # (B,nc,H,N)
    h = torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, ..., None] + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                 # (B,nc,H,N,N)

    y_inter = torch.einsum("bcihn,bchnm->bcihm", rf * torch.exp(la_excl),
                           h_prevs)
    y = (y_intra + y_inter).reshape(B, S, D).to(x.dtype)
    y = layernorm(params["ln_out"], y)
    return y @ params["wo"]


def time_mix_step(params, x, state, r_cfg: RWKVConfig):
    """Decode step. x (B,1,D); state {"shift": (B,D), "S": (B,H,N,N)}."""
    B, _, D = x.shape
    N = r_cfg.head_size
    H = D // N
    x_sh = state["shift"][:, None]
    rr = (_lerp(x, x_sh, params["mix_r"]) @ params["wr"]).reshape(B, H, N)
    kk = (_lerp(x, x_sh, params["mix_k"]) @ params["wk"]).reshape(B, H, N)
    vv = (_lerp(x, x_sh, params["mix_v"]) @ params["wv"]).reshape(B, H, N)
    lw = _decay(params, _lerp(x, x_sh, params["mix_w"])).reshape(B, H, N)
    rf, kf, vf = rr.float(), kk.float(), vv.float()
    S_prev = state["S"]
    kv = torch.einsum("bhn,bhm->bhnm", kf, vf)
    out = torch.einsum("bhn,bhnm->bhm", rf,
                       S_prev + params["u"][..., None] * kv)
    S_new = torch.exp(lw)[..., None] * S_prev + kv
    y = layernorm(params["ln_out"], out.reshape(B, 1, D).to(x.dtype))
    return y @ params["wo"], {"shift": x[:, 0], "S": S_new}


def channel_mix(params, x, prev=None):
    """x (B,S,D) -> (out (B,S,D), last x (B,D)) for decode chaining."""
    x_sh = _token_shift(x, prev)
    k = _lerp(x, x_sh, params["mix_k"]) @ params["wk"]
    k = torch.square(F.relu(k.float())).to(x.dtype)
    r = torch.sigmoid((_lerp(x, x_sh, params["mix_r"])
                       @ params["wr"]).float())
    return (k @ params["wv"]) * r.to(x.dtype), x[:, -1]


def rwkv_init_state(batch: int, d: int, r: RWKVConfig, dtype=torch.float32,
                    device="cpu"):
    H = d // r.head_size
    return {
        "tm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
        "cm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
        "S": torch.zeros((batch, H, r.head_size, r.head_size),
                         dtype=torch.float32, device=device),
    }
