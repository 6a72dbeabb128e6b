"""Ragged paged attention over the fused KV pool: the plain PyTorch version
and the wrapper of the hand-written CUDA kernel (port of the ragged half
of ``repro.core.attention_api``).

* :func:`ragged_lane_metadata` derives per-lane ``(token_req, token_pos,
  kv_lens)`` from the ``cu_q_lens``/``cu_kv_lens``/``seq_slot`` prefix sums.
* :func:`_chunked_partials` is the per-lane flash partial math over a flat
  BlockList; :func:`paged_attention_ragged` normalises it.  Together they
  are the plain version: the CPU path, and what the kernel is held to.
* :func:`paged_attention_ragged_op` is the wrapper the model calls.  For a
  CUDA tensor it launches the kernel (``kernels/csrc/
  paged_attention_ragged.cu``) or raises; for a CPU tensor it takes the
  plain version.  Nothing falls back.

Shapes: q (T, H, HD); kv_pool (NB, BS, 2*KV, HD) with ``[K0,V0,K1,V1,...]``
on the head axis; BlockList arrays (Tb,); cu_q_lens/cu_kv_lens (S+1,);
seq_slot (S,).  GQA maps q head ``h`` to kv head ``h // (H // KV)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import paged_kv

NEG_INF = -1e30
# Lane chunk of the plain version: bounds its (lanes, H, Tb, BS) score
# tensor to about this many elements.  Each lane's softmax is independent,
# so chunking the lanes leaves every lane's arithmetic unchanged.
_PLAIN_SCORE_ELEMS = 1 << 26


def ragged_lane_metadata(cu_q_lens, cu_kv_lens, seq_slot, num_lanes: int,
                         num_slots: int):
    """Per-lane ``token_req``/``token_pos`` (num_lanes,) and slot-keyed
    ``kv_lens`` (num_slots,), integer-exact with the reference.

    Sequence ``j`` owns lanes ``[cu_q_lens[j], cu_q_lens[j+1])`` (found with
    ``searchsorted(side="right")``, which skips empty entries), holds
    ``cu_kv_lens[j+1] - cu_kv_lens[j]`` keys and lives in ``seq_slot[j]``.
    Lanes past ``cu_q_lens[-1]`` are padding: owner ``num_slots``.
    Out-of-range slots write no ``kv_lens`` entry (JAX's ``mode="drop"``).
    """
    dev = cu_q_lens.device
    nseq = seq_slot.shape[0]
    cu_q = cu_q_lens.to(torch.int32)
    cu_kv = cu_kv_lens.to(torch.int32)
    lanes = torch.arange(num_lanes, dtype=torch.int32, device=dev)
    j = torch.searchsorted(cu_q, lanes, right=True).to(torch.int32) - 1
    j = j.clamp(0, nseq - 1).long()
    nq = cu_q[1:] - cu_q[:-1]
    kvl = cu_kv[1:] - cu_kv[:-1]
    in_range = lanes < cu_q[-1]
    token_req = torch.where(in_range, seq_slot.to(torch.int32)[j],
                            num_slots).to(torch.int32)
    token_pos = torch.where(in_range, kvl[j] - nq[j] + (lanes - cu_q[j]),
                            0).to(torch.int32)
    slot = seq_slot.long()
    ok = (slot >= 0) & (slot < num_slots)
    # Dropped writes land in a spare last entry that is cut off.
    kv_lens = torch.zeros((num_slots + 1,), dtype=torch.int32, device=dev)
    kv_lens.scatter_(0, torch.where(ok, slot, num_slots), kvl)
    return token_req, token_pos, kv_lens[:num_slots]


def _chunked_partials(q, pool_k, pool_v, block_list, block_req, block_pos,
                      kv_lens, token_req, token_pos, scale: float):
    """Per-lane flash partials ``(m, l, o)`` — (T, KV, G), (T, KV, G),
    (T, KV, G, HD) — of every query lane against the blocks of the flat
    BlockList, with ownership, causal and length masking.  A lane that
    owns no valid key has ``m == -1e30`` and ``l == 0``."""
    T, H, HD = q.shape
    NB, BS, KV, _ = pool_k.shape
    B = kv_lens.shape[0]
    G = H // KV
    bl = block_list.long().clamp(0, NB - 1)
    k = pool_k[bl]                                      # (Tb, BS, KV, HD)
    v = pool_v[bl]
    qg = q.reshape(T, KV, G, HD)
    scores = torch.einsum("tkgd,uskd->tkgus", qg, k).float() * scale
    arange = torch.arange(BS, device=q.device, dtype=torch.int32)
    key_pos = block_pos[:, None].to(torch.int32) * BS + arange[None]
    breq = block_req.long().clamp(0, B - 1)
    valid = ((block_req[None, :] == token_req[:, None])      # (T, Tb)
             & (block_req[None, :] < B)
             & (token_req[:, None] < B))
    valid = (valid[:, :, None]
             & (key_pos[None] <= token_pos[:, None, None])        # causal
             & (key_pos[None] < kv_lens[breq][None, :, None]))    # (T,Tb,BS)
    mask = valid[:, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    m = torch.amax(scores, dim=(-2, -1)).clamp_min(NEG_INF)        # (T,KV,G)
    p = torch.exp(scores - m[..., None, None])
    p = torch.where(mask, p, 0.0)
    l = p.sum(dim=(-2, -1))
    o = torch.einsum("tkgus,uskd->tkgd", p.to(v.dtype), v).float()
    return m, l, o


def paged_attention_ragged(q, kv_pool, block_list, block_req, block_pos,
                           cu_q_lens, cu_kv_lens, seq_slot,
                           *, sm_scale: Optional[float] = None):
    """The plain version: ragged prefill+decode attention in PyTorch ops.

    Lane metadata from :func:`ragged_lane_metadata`, the math of
    :func:`_chunked_partials` on split views of the fused pool, output
    ``o / max(l, 1e-30)`` in q's dtype (lanes with no valid key give 0).
    """
    T, H, HD = q.shape
    S = seq_slot.shape[0]
    Tb, BS = block_list.shape[0], kv_pool.shape[1]
    scale = sm_scale if sm_scale is not None else HD ** -0.5
    pool_k, pool_v = paged_kv.fused_kv_views(kv_pool)
    token_req, token_pos, kv_lens = ragged_lane_metadata(
        cu_q_lens, cu_kv_lens, seq_slot, T, S)
    out = torch.empty_like(q)
    step = max(1, _PLAIN_SCORE_ELEMS // max(1, H * Tb * BS))
    for s in range(0, T, step):
        e = min(s + step, T)
        m, l, o = _chunked_partials(q[s:e], pool_k, pool_v, block_list,
                                    block_req, block_pos, kv_lens,
                                    token_req[s:e], token_pos[s:e], scale)
        res = o / torch.clamp_min(l, 1e-30)[..., None]
        out[s:e] = res.reshape(e - s, H, HD).to(q.dtype)
    return out


def _check_cuda_inputs(q, kv_pool, ints):
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if kv_pool.dtype != q.dtype:
        raise TypeError(f"kv_pool dtype {kv_pool.dtype} != q dtype {q.dtype}")
    if q.dim() != 3 or kv_pool.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (T, H, HD) and kv_pool "
                         f"{tuple(kv_pool.shape)} (NB, BS, 2*KV, HD)")
    H, HD = q.shape[1], q.shape[2]
    KV2 = kv_pool.shape[2]
    if kv_pool.shape[3] != HD or KV2 % 2 or H % (KV2 // 2):
        raise ValueError(f"q {tuple(q.shape)} and kv_pool "
                         f"{tuple(kv_pool.shape)} disagree on heads")
    if HD not in (16, 32, 64, 128) or H // (KV2 // 2) > 64:
        raise ValueError(f"head_dim {HD} / group {H // (KV2 // 2)}: the "
                         "kernel takes head_dim 16/32/64/128 and <= 64 q "
                         "heads per kv head")
    for name, t in (("q", q), ("kv_pool", kv_pool)) + tuple(ints.items()):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("kv_pool", kv_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "loads 16 bytes at a time)")
    for name, t in ints.items():
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor, got "
                            f"{t.dtype} {tuple(t.shape)}")
    Tb, S = ints["block_list"].shape[0], ints["seq_slot"].shape[0]
    if ints["block_req"].shape[0] != Tb or ints["block_pos"].shape[0] != Tb:
        raise ValueError("block_list/block_req/block_pos lengths differ")
    if (ints["cu_q_lens"].shape[0] != S + 1
            or ints["cu_kv_lens"].shape[0] != S + 1):
        raise ValueError("cu_q_lens/cu_kv_lens must have len(seq_slot) + 1 "
                         "entries")
    if not 1 <= S <= 1024:
        raise ValueError(f"{S} sequence entries: the kernel takes 1..1024")


def ragged_scratch_ints(num_seqs: int, num_entries: int) -> int:
    """int32 scratch the kernel needs: per-sequence page lists (block and
    position) of up to ``num_entries`` pages each, then their counts."""
    return 2 * num_seqs * num_entries + num_seqs


class _RaggedAttentionOp:
    """Ragged paged attention, chosen by the device of ``q``.

    CUDA: checks dtypes, shapes, devices and contiguity, allocates the
    output and the kernel's scratch with ``torch.empty``, launches on the
    current stream and adds one to :attr:`launches`.  CPU: the plain
    :func:`paged_attention_ragged`.
    """

    def __init__(self):
        self.launches = 0           # kernel launches, a plain integer

    def __call__(self, q, kv_pool, block_list, block_req, block_pos,
                 cu_q_lens, cu_kv_lens, seq_slot, *,
                 sm_scale: Optional[float] = None):
        if q.device.type != "cuda":
            return paged_attention_ragged(q, kv_pool, block_list, block_req,
                                          block_pos, cu_q_lens, cu_kv_lens,
                                          seq_slot, sm_scale=sm_scale)
        from repro_torch.kernels import paged_attention as kernel

        ints = {"block_list": block_list, "block_req": block_req,
                "block_pos": block_pos, "cu_q_lens": cu_q_lens,
                "cu_kv_lens": cu_kv_lens, "seq_slot": seq_slot}
        _check_cuda_inputs(q, kv_pool, ints)
        T, H, HD = q.shape
        NB, BS, KV2, _ = kv_pool.shape
        Tb, S = block_list.shape[0], seq_slot.shape[0]
        scale = float(sm_scale if sm_scale is not None else HD ** -0.5)
        out = torch.empty_like(q)
        scratch = torch.empty((ragged_scratch_ints(S, Tb),),
                              dtype=torch.int32, device=q.device)
        err = kernel.library().paged_attention_ragged(
            q.data_ptr(), kv_pool.data_ptr(), out.data_ptr(),
            block_list.data_ptr(), block_req.data_ptr(), block_pos.data_ptr(),
            cu_q_lens.data_ptr(), cu_kv_lens.data_ptr(), seq_slot.data_ptr(),
            scratch.data_ptr(), T, H, KV2 // 2, HD, NB, BS, Tb, S,
            0 if q.dtype == torch.float32 else 1, scale,
            torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"paged_attention_ragged kernel launch "
                               f"failed: cudaError {err}")
        self.launches += 1
        return out


paged_attention_ragged_op = _RaggedAttentionOp()
