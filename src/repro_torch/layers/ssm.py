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


def _ssd_chunked(xs, Bm, Cm, dt_raw, heads, s: SSMConfig):
    """The chunked SSD over the heads of ``xs`` (B,S,H,P): Bm/Cm (B,S,N)
    shared by every head, dt_raw (B,S,H), ``heads`` their A_log, D and
    dt_bias (H,).  Returns y (B,S,H*P) in xs' dtype (D's skip included)."""
    B, S, H, P = xs.shape
    N = s.d_state
    dt = F.softplus(dt_raw.float() + heads["dt_bias"])      # (B,S,H)
    la_step = -torch.exp(heads["A_log"]) * dt               # log a_t <= 0

    Lc = min(s.chunk_size, S)
    assert S % Lc == 0, (S, Lc)
    nc = S // Lc

    def reshape_c(t):
        return t.reshape((B, nc, Lc) + tuple(t.shape[2:]))

    xs_c, B_c, C_c = reshape_c(xs), reshape_c(Bm), reshape_c(Cm)
    la_c = reshape_c(la_step)                               # (B,nc,Lc,H)
    dtx = xs_c * dt.reshape(B, nc, Lc, H)[..., None].to(xs_c.dtype)

    la_incl = torch.cumsum(la_c, dim=2)                     # (B,nc,Lc,H)
    idx = torch.arange(Lc, device=xs.device)
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
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xs.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                   # (B,nc,H,P,N)

    # inter-chunk output: y_i += (C_i exp(la_incl_i)) . h_prev_chunk
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", C_c.float(), h_prevs,
                           torch.exp(la_incl).float())
    y = y_intra.float() + y_inter
    y = y + xs_c.float() * heads["D"][None, None, None, :, None]
    return y.reshape(B, S, H * P).to(xs.dtype)


def _ssd_step(xs, Bm, Cm, dt_raw, heads, h_prev):
    """One SSD step: xs (B,H,P), Bm/Cm (B,N), dt_raw (B,H), h_prev
    (B,H,P,N) -> (y (B,H*P) in xs' dtype, h)."""
    B, H, P = xs.shape
    Bm, Cm = Bm.float(), Cm.float()
    dt = F.softplus(dt_raw.float() + heads["dt_bias"])      # (B,H)
    a = torch.exp(-torch.exp(heads["A_log"]) * dt)          # (B,H)
    dtx = xs.float() * dt[..., None]
    h = h_prev * a[:, :, None, None] + torch.einsum("bhp,bn->bhpn", dtx, Bm)
    y = torch.einsum("bhpn,bn->bhp", h, Cm)
    y = y + xs.float() * heads["D"][None, :, None]
    return y.reshape(B, H * P).to(xs.dtype), h


def _heads(params):
    return {k: params[k] for k in ("A_log", "D", "dt_bias")}


def ssm_chunked(params, x, s: SSMConfig, d_model: int):
    """x (B,S,D) -> (B,S,D). Training / prefill form."""
    dims = ssm_dims(d_model, s)
    B, S, _ = x.shape
    proj = torch.matmul(x, params["in_proj"])
    z, xBC, dt_raw = _split_in(proj, dims, s)
    xBC, _ = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xs, Bm, Cm = torch.split(xBC, [dims.d_inner, s.d_state, s.d_state],
                             dim=-1)
    y = _ssd_chunked(xs.reshape(B, S, dims.num_heads, s.head_dim), Bm, Cm,
                     dt_raw, _heads(params), s)
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
    y, h = _ssd_step(xs.reshape(B, dims.num_heads, s.head_dim), Bm[:, 0],
                     Cm[:, 0], dt_raw[:, 0], _heads(params), state["h"])
    y = rmsnorm(params["norm"],
                y[:, None] * F.silu(z.float()).to(x.dtype))
    return torch.matmul(y, params["out_proj"]), {"conv": new_conv, "h": h}


# ---------------------------------------------------------------- on a mesh
def ssm_aligned(tp, d_model: int, s: SSMConfig, path=("mamba", "ssm")
                ) -> bool:
    """Whether each rank can run whole SSD heads: the heads divide over the
    axis (the state's rule), and with them ``out_proj``'s rows."""
    return (ssm_dims(d_model, s).num_heads % tp.size == 0
            and tp.split(*path, "out_proj"))


def _ssm_in_tp(params, x, s: SSMConfig, d_model: int, tp, path, prev):
    """This rank's heads' z (..., H'P), x (..., H', P), dt_raw (..., H')
    and the shared B, C, from x (whole, through ``tp.enter``), and the new
    conv state (the rank's block of ``conv_dim`` where the rules split
    ``conv_w``, else whole).  ``in_proj`` is cut contiguously over its
    concatenated output (z, xBC, dt), which no head split follows: its
    block of the projection is gathered whole; the depthwise conv runs on
    the rank's block of channels and its output is gathered whole."""
    dims = ssm_dims(d_model, s)
    P = s.head_dim
    if tp.split(*path, "in_proj"):
        proj = tp.gather_split(torch.matmul(x, params["in_proj"]), -1)
    else:
        proj = torch.matmul(x, tp.enter(params["in_proj"]))
    z, xBC, dt_raw = _split_in(proj, dims, s)
    conv_b = tp.enter(params["conv_b"])
    if tp.split(*path, "conv_w"):
        lo, hi = tp.bounds(dims.conv_dim)
        xBC, new_prev = _causal_conv(xBC[..., lo:hi], params["conv_w"],
                                     conv_b[lo:hi], prev)
        xBC = tp.gather_split(xBC, -1)
    else:
        xBC, new_prev = _causal_conv(xBC, tp.enter(params["conv_w"]), conv_b,
                                     prev)
    xs, Bm, Cm = torch.split(xBC, [dims.d_inner, s.d_state, s.d_state],
                             dim=-1)
    hlo, hhi = tp.bounds(dims.num_heads)
    xs = xs[..., hlo * P:hhi * P]
    heads = {k: tp.enter(v)[hlo:hhi] for k, v in _heads(params).items()}
    return (z[..., hlo * P:hhi * P], xs.reshape(xs.shape[:-1] + (-1, P)),
            Bm, Cm, dt_raw[..., hlo:hhi], heads, new_prev)


def _ssm_out_tp(params, y, z, tp):
    """The rank's heads' y gated by z, through the norm over the whole
    ``d_inner`` (gathered for it) and ``out_proj`` row-parallel."""
    g = tp.gather_split(y * F.silu(z.float()).to(y.dtype), -1)
    lo, hi = tp.bounds(g.shape[-1])
    norm = {k: tp.enter(v) for k, v in params["norm"].items()}
    return tp.psum(torch.matmul(rmsnorm(norm, g)[..., lo:hi],
                                params["out_proj"]))


def ssm_chunked_tp(params, x, s: SSMConfig, d_model: int, tp,
                   path=("mamba", "ssm")):
    """:func:`ssm_chunked` on a mesh: x (B,S,D) whole on every rank; each
    rank its SSD heads (:func:`ssm_aligned`), or the whole layer on every
    rank with the split leaves gathered."""
    if not ssm_aligned(tp, d_model, s, path):
        return ssm_chunked(tp.whole(params, *path), x, s, d_model)
    z, xs, Bm, Cm, dt_raw, heads, _ = _ssm_in_tp(
        params, tp.enter(x), s, d_model, tp, path, None)
    return _ssm_out_tp(params, _ssd_chunked(xs, Bm, Cm, dt_raw, heads, s),
                       z, tp)


def ssm_step_tp(params, x, state, s: SSMConfig, d_model: int, tp,
                path=("mamba", "ssm")):
    """:func:`ssm_step` on a mesh (no gradient): x (B,1,D) whole, ``state``
    this rank's shard of it (``conv`` its block of channels where the
    rules split ``conv_w``, ``h`` its heads).  Returns (out, state)."""
    if not ssm_aligned(tp, d_model, s, path):
        dims = ssm_dims(d_model, s)
        conv = state["conv"]
        split = conv.shape[-1] != dims.conv_dim
        out, st = ssm_step(tp.whole(params, *path), x, {
            "conv": tp.gather(conv, -1) if split else conv,
            "h": state["h"]}, s, d_model)
        if split:
            lo, hi = tp.bounds(dims.conv_dim)
            st["conv"] = st["conv"][..., lo:hi]
        return out, st
    z, xs, Bm, Cm, dt_raw, heads, conv = _ssm_in_tp(
        params, x, s, d_model, tp, path, state["conv"])
    y, h = _ssd_step(xs[:, 0], Bm[:, 0], Cm[:, 0], dt_raw[:, 0], heads,
                     state["h"])
    return _ssm_out_tp(params, y[:, None], z, tp), {"conv": conv, "h": h}
