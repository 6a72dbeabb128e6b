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


def _projections(params, x, x_sh):
    """r, k, v (B,S,D') and the log decay (B,S,D') from the lerped
    inputs (D' the width of the params' columns)."""
    rr = _lerp(x, x_sh, params["mix_r"]) @ params["wr"]
    kk = _lerp(x, x_sh, params["mix_k"]) @ params["wk"]
    vv = _lerp(x, x_sh, params["mix_v"]) @ params["wv"]
    return rr, kk, vv, _decay(params, _lerp(x, x_sh, params["mix_w"]))


def _wkv_chunked(rr, kk, vv, lw, u, N: int):
    """The chunked recurrence over heads of width N: rr/kk/vv (B,S,H*N),
    lw (B,S,H*N) f32, u (H,N) -> y (B,S,H*N) f32."""
    B, S, D = rr.shape
    H = D // N
    Lc = min(CHUNK, S)
    assert S % Lc == 0, (S, Lc)
    nc = S // Lc

    def rs(t):
        return t.reshape(B, nc, Lc, H, N)

    r, k, v, lw = rs(rr), rs(kk), rs(vv), rs(lw)
    la_incl = torch.cumsum(lw, dim=2)                     # (B,nc,Lc,H,N)
    la_excl = la_incl - lw
    idx = torch.arange(Lc, device=rr.device)
    mask_lt = idx[:, None] > idx[None, :]                 # j < i

    rf, kf, vf = r.float(), k.float(), v.float()
    # intra: A_ij = sum_n r_in k_jn exp(la_excl_i - la_incl_j), j < i;
    # masked before exp (for j >= i the difference is positive)
    ddiff = la_excl[:, :, :, None] - la_incl[:, :, None]  # (B,nc,i,j,H,N)
    ddiff = torch.where(mask_lt[:, :, None, None], ddiff, -torch.inf)
    A = torch.einsum("bcihn,bcjhn,bcijhn->bcijh", rf, kf, torch.exp(ddiff))
    diag = torch.einsum("bcihn,hn,bcihn->bcih", rf, u, kf)
    A = A + diag[:, :, :, None, :] * torch.eye(
        Lc, device=rr.device)[None, None, :, :, None]
    y_intra = torch.einsum("bcijh,bcjhn->bcihn", A, vf)

    # inter-chunk state loop: h maps the k dim to the v dim, (B,H,N,N)
    dec_to_end = torch.exp(la_incl[:, :, -1:] - la_incl)  # (B,nc,Lc,H,N)
    chunk_state = torch.einsum("bcjhn,bcjhm->bchnm", kf * dec_to_end, vf)
    chunk_decay = torch.exp(la_incl[:, :, -1])            # (B,nc,H,N)
    h = torch.zeros((B, H, N, N), dtype=torch.float32, device=rr.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, ..., None] + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                 # (B,nc,H,N,N)

    y_inter = torch.einsum("bcihn,bchnm->bcihm", rf * torch.exp(la_excl),
                           h_prevs)
    return (y_intra + y_inter).reshape(B, S, D)


def _wkv_step(rr, kk, vv, lw, u, S_prev, N: int):
    """One step of the recurrence: rr/kk/vv (B,1,H*N), lw f32, u (H,N),
    S_prev (B,H,N,N) -> (out (B,H*N) f32, S_new)."""
    B, _, D = rr.shape
    H = D // N
    rf, kf, vf = (t.reshape(B, H, N).float() for t in (rr, kk, vv))
    kv = torch.einsum("bhn,bhm->bhnm", kf, vf)
    out = torch.einsum("bhn,bhnm->bhm", rf, S_prev + u[..., None] * kv)
    S_new = torch.exp(lw.reshape(B, H, N))[..., None] * S_prev + kv
    return out.reshape(B, D), S_new


def time_mix_chunked(params, x, r_cfg: RWKVConfig):
    """Training / prefill form. x (B,S,D) -> (B,S,D)."""
    rr, kk, vv, lw = _projections(params, x, _token_shift(x))
    y = _wkv_chunked(rr, kk, vv, lw, params["u"], r_cfg.head_size)
    y = layernorm(params["ln_out"], y.to(x.dtype))
    return y @ params["wo"]


def time_mix_step(params, x, state, r_cfg: RWKVConfig):
    """Decode step. x (B,1,D); state {"shift": (B,D), "S": (B,H,N,N)}."""
    B, _, D = x.shape
    rr, kk, vv, lw = _projections(params, x, state["shift"][:, None])
    out, S_new = _wkv_step(rr, kk, vv, lw, params["u"], state["S"],
                           r_cfg.head_size)
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


# ---------------------------------------------------------------- on a mesh
def time_mix_aligned(tp, d: int, r_cfg: RWKVConfig,
                     path=("layers", "tm")) -> bool:
    """Whether the rules' cuts give each rank whole heads of the time mix:
    ``wr``/``wk``/``wv`` split on their output, ``wo`` on its input, and
    the heads dividing over the axis (the state's rule)."""
    H = d // r_cfg.head_size
    return (all(tp.split(*path, n) for n in ("wr", "wk", "wv", "wo"))
            and H % tp.size == 0)


def _tm_inputs_tp(params, x, x_sh, tp, path, N: int):
    """This rank's heads' r, k, v, log decay (B,S,D') and u (H',N) from x
    and x_sh (whole; already through ``tp.enter``).  The decay's LoRA is a
    Megatron pair over its rank (``w1`` column, ``w2`` row) where the
    rules split it, its sum then entering the rank's slice of D; ``u``,
    which the rules cut on N, is gathered."""
    lo, hi = tp.bounds(x.shape[-1])
    mix = {n: tp.enter(params[n]) for n in ("mix_r", "mix_k", "mix_v",
                                            "mix_w")}
    rr = _lerp(x, x_sh, mix["mix_r"]) @ params["wr"]
    kk = _lerp(x, x_sh, mix["mix_k"]) @ params["wk"]
    vv = _lerp(x, x_sh, mix["mix_v"]) @ params["wv"]
    xw = _lerp(x, x_sh, mix["mix_w"]).float()
    if tp.split(*path, "w1"):
        lora = tp.enter(tp.psum(torch.tanh(xw @ params["w1"])
                                @ params["w2"]))
    else:
        lora = (torch.tanh(xw @ tp.enter(params["w1"]))
                @ tp.enter(params["w2"]))
    lw = -torch.exp(torch.clamp(tp.enter(params["w0"])[lo:hi]
                                + lora[..., lo:hi], -20.0, 8.0))
    u = params["u"]
    u = tp.gather_split(u, -1) if tp.split(*path, "u") else tp.enter(u)
    return rr, kk, vv, lw, u[lo // N:hi // N]


def _tm_out_tp(params, y, tp):
    """The rank's heads' y (B,S,D') through ``ln_out`` (a LayerNorm over
    the whole width: y gathered for it) and ``wo`` row-parallel."""
    lo, hi = tp.bounds(y.shape[-1] * tp.size)
    ln = {k: tp.enter(v) for k, v in params["ln_out"].items()}
    y = layernorm(ln, tp.gather_split(y, -1))[..., lo:hi]
    return tp.psum(y @ params["wo"])


def time_mix_chunked_tp(params, x, r_cfg: RWKVConfig, tp,
                        path=("layers", "tm")):
    """:func:`time_mix_chunked` on a mesh: x (B,S,D) whole on every rank;
    each rank its heads (:func:`time_mix_aligned`), or the whole mix on
    every rank with the split leaves gathered where the cuts do not line
    up."""
    if not time_mix_aligned(tp, x.shape[-1], r_cfg, path):
        return time_mix_chunked(tp.whole(params, *path), x, r_cfg)
    xin = tp.enter(x)
    rr, kk, vv, lw, u = _tm_inputs_tp(params, xin, _token_shift(xin), tp,
                                      path, r_cfg.head_size)
    y = _wkv_chunked(rr, kk, vv, lw, u, r_cfg.head_size)
    return _tm_out_tp(params, y.to(x.dtype), tp)


def time_mix_step_tp(params, x, shift, S_prev, r_cfg: RWKVConfig, tp,
                     path=("layers", "tm")):
    """:func:`time_mix_step` on a mesh (no gradient): x (B,1,D) whole,
    ``shift`` (B,D) the previous input whole, S_prev this rank's heads'
    state (all of them where the cuts do not line up).  Returns (out
    (B,1,D), S_new)."""
    if not time_mix_aligned(tp, x.shape[-1], r_cfg, path):
        out, st = time_mix_step(tp.whole(params, *path), x,
                                {"shift": shift, "S": S_prev}, r_cfg)
        return out, st["S"]
    N = r_cfg.head_size
    rr, kk, vv, lw, u = _tm_inputs_tp(params, x, shift[:, None], tp, path, N)
    out, S_new = _wkv_step(rr, kk, vv, lw, u, S_prev, N)
    return _tm_out_tp(params, out[:, None].to(x.dtype), tp), S_new


def channel_mix_tp(params, x, tp, prev=None, path=("layers", "cm")):
    """:func:`channel_mix` on a mesh: x (B,S,D) whole on every rank.  The
    rules split ``wk`` on F but ``wv`` (a _COL name) on its output D, and
    ``wr`` on D: each rank's relu^2 block of F is gathered whole for its
    block of ``wv``'s columns, its output block gated by its block of r
    and gathered whole.  Where those cuts are not all there, the whole mix
    runs on every rank with the split leaves gathered."""
    if not all(tp.split(*path, n) for n in ("wk", "wv", "wr")):
        return channel_mix(tp.whole(params, *path), x, prev)
    xin = tp.enter(x)
    x_sh = _token_shift(xin, prev)
    k = _lerp(xin, x_sh, tp.enter(params["mix_k"])) @ params["wk"]
    k = tp.gather_split(torch.square(F.relu(k.float())).to(x.dtype), -1)
    r = torch.sigmoid((_lerp(xin, x_sh, tp.enter(params["mix_r"]))
                       @ params["wr"]).float())
    y = (k @ params["wv"]) * r.to(x.dtype)
    return tp.gather_whole(y, -1), x[:, -1]


def rwkv_init_state(batch: int, d: int, r: RWKVConfig, dtype=torch.float32,
                    device="cpu"):
    H = d // r.head_size
    return {
        "tm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
        "cm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
        "S": torch.zeros((batch, H, r.head_size, r.head_size),
                         dtype=torch.float32, device=device),
    }
