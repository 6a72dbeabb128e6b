"""Paged attention: the plain PyTorch versions and the wrappers of the
hand-written CUDA kernels (port of ``repro.core.attention_api``).

Plain versions, the CPU path and what the kernels are held to:

* :func:`paged_attention_base`: vLLM_base, the padded (B, MAXB) BlockTable
  gathered whole, pad blocks included.
* :func:`paged_attention_opt`: vLLM_opt, the flat BlockList of effectual
  blocks with a segment softmax per request (decode shape, one query per
  request).
* :func:`paged_attention_chunked`: flat token lanes (decode tokens and
  prompt-chunk tokens mixed) over split K/V pools.
* :func:`paged_attention_ragged`: the same lanes described by
  ``cu_q_lens``/``cu_kv_lens``/``seq_slot`` over the fused pool.
  :func:`ragged_lane_metadata` derives per-lane ``(token_req, token_pos,
  kv_lens)`` from the prefix sums, and both run the lane-chunked per-lane
  flash math of :func:`_chunked_partials`, so chunked and ragged are
  bitwise equal on the same lanes, as in the reference.

Wrappers the model calls, each chosen by the device of ``q``: for a CUDA
tensor it launches its kernel or raises; for a CPU tensor it takes its
plain version.  Nothing falls back.  Each counts its launches in
``launches``.

* :data:`paged_attention_ragged_op`: ``kernels/csrc/paged_attention_ragged.cu``.
* :data:`paged_attention_chunked_op`: ``kernels/csrc/paged_attention_chunked.cu``.
* :data:`paged_attention_op`: ``kernels/csrc/paged_attention_decode.cu``.

Shapes: q (T, H, HD) (decode: (B, H, HD)); kv_pool (NB, BS, 2*KV, HD)
with ``[K0,V0,K1,V1,...]`` on the head axis; split pools (NB, BS, KV, HD);
BlockList arrays (Tb,); cu_q_lens/cu_kv_lens (S+1,); seq_slot (S,).  GQA
maps q head ``h`` to kv head ``h // (H // KV)``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import paged_kv
from repro_torch.kernels.launch import KernelOp, Launch

NEG_INF = -1e30
# Lane chunk of the plain version: bounds its (lanes, H, Tb, BS) score
# tensor to about this many elements.  Each lane's softmax is independent,
# so chunking the lanes leaves every lane's arithmetic unchanged.
_PLAIN_SCORE_ELEMS = 1 << 26
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 64             # q heads per kv head: a tile's 64 rows


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


def _q_grouped(q, num_kv: int):
    B, H, HD = q.shape
    return q.reshape(B, num_kv, H // num_kv, HD)


def paged_attention_base(q, pool_k, pool_v, block_table, seq_lens,
                         *, sm_scale: Optional[float] = None):
    """vLLM_base: the padded BlockTable (B, MAXB), pad blocks gathered too.

    q (B, H, HD); pools (NB, BS, KV, HD); seq_lens (B,).  Keys at
    positions >= seq_len are masked; softmax in f32, weights cast to the
    pool's dtype for the PV product.
    """
    B, H, HD = q.shape
    NB, BS, KV, _ = pool_k.shape
    MAXB = block_table.shape[1]
    scale = sm_scale if sm_scale is not None else HD ** -0.5
    idx = block_table.reshape(-1).long()
    k = pool_k[idx].reshape(B, MAXB, BS, KV, HD)     # the redundant gather
    v = pool_v[idx].reshape(B, MAXB, BS, KV, HD)
    qg = _q_grouped(q, KV)
    scores = torch.einsum("bkgd,bmskd->bkgms", qg, k).float() * scale
    pos = (torch.arange(MAXB, device=q.device)[:, None] * BS
           + torch.arange(BS, device=q.device)[None, :])      # (MAXB, BS)
    mask = pos[None] < seq_lens.long()[:, None, None]
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    w = torch.softmax(scores.reshape(B, KV, qg.shape[2], -1), dim=-1)
    w = w.reshape(scores.shape).to(v.dtype)
    out = torch.einsum("bkgms,bmskd->bkgd", w, v)
    return out.reshape(B, H, HD)


def _segment(values, seg, num_segments: int, reduce: str):
    """Reduce ``values`` (T, ...) over segment ids ``seg`` (T,) into
    (num_segments, ...); empty segments read -inf (amax) or 0 (sum)."""
    shape = (num_segments,) + tuple(values.shape[1:])
    index = seg.long().reshape((-1,) + (1,) * (values.dim() - 1))
    index = index.expand_as(values)
    if reduce == "amax":
        out = torch.full(shape, float("-inf"), dtype=values.dtype,
                         device=values.device)
        return out.scatter_reduce(0, index, values, "amax")
    return torch.zeros(shape, dtype=values.dtype,
                       device=values.device).index_add_(0, seg.long(), values)


def _opt_partials(q, pool_k, pool_v, block_list, block_req, block_pos,
                  seq_lens, num_reqs: int, scale: float):
    """Per-request (max, sumexp, weighted-V) from a flat BlockList:
    (B, KV, G), (B, KV, G), (B, KV, G, HD).  Pad entries (``block_req``
    outside ``[0, num_reqs)``) land in a spare segment that is dropped."""
    B, H, HD = q.shape
    NB, BS, KV, _ = pool_k.shape
    bl = block_list.long().clamp(0, NB - 1)
    k = pool_k[bl]                                        # (T, BS, KV, HD)
    v = pool_v[bl]
    breq = block_req.long()
    req = breq.clamp(0, B - 1)
    qg = _q_grouped(q, KV)[req]                           # (T, KV, G, HD)
    scores = torch.einsum("tkgd,tskd->tkgs", qg, k).float() * scale
    pos = (block_pos.long()[:, None] * BS
           + torch.arange(BS, device=q.device)[None])     # (T, BS)
    real = (breq >= 0) & (breq < num_reqs)
    valid = (pos < seq_lens.long()[req][:, None]) & real[:, None]
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    seg = torch.where(real, breq, B)                      # pad -> dropped
    m = _segment(scores.amax(dim=-1), seg, B + 1, "amax")[:B]
    m = m.clamp_min(NEG_INF)
    p = torch.exp(scores - m[seg.clamp(0, B - 1)][..., None])
    p = torch.where(valid[:, None, None], p, 0.0)
    l = _segment(p.sum(dim=-1), seg, B + 1, "sum")[:B]
    o_t = torch.einsum("tkgs,tskd->tkgd", p.to(v.dtype), v).float()
    o = _segment(o_t, seg, B + 1, "sum")[:B]
    return m, l, o


def paged_attention_opt(q, pool_k, pool_v, block_list, block_req, block_pos,
                        seq_lens, *, sm_scale: Optional[float] = None):
    """vLLM_opt: the flat BlockList, only effectual blocks touched.

    q (B, H, HD) one query per request; pools (NB, BS, KV, HD); BlockList
    arrays (Tb,) keyed by request; seq_lens (B,).  A request with no entry
    reads 0.
    """
    B, H, HD = q.shape
    scale = sm_scale if sm_scale is not None else HD ** -0.5
    m, l, o = _opt_partials(q, pool_k, pool_v, block_list, block_req,
                            block_pos, seq_lens, B, scale)
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, HD).to(q.dtype)


def _chunked_partials(q, pool_k, pool_v, block_list, block_req, block_pos,
                      kv_lens, token_req, token_pos, scale: float):
    """Per-lane flash partials ``(m, l, o)`` — (T, KV, G), (T, KV, G),
    (T, KV, G, HD) — of every query lane against the blocks of the flat
    BlockList, with ownership, causal and length masking.  A lane that
    owns no valid key has ``m == -1e30`` and ``l == 0``."""
    T, H, HD = q.shape
    NB, BS, KV, _ = pool_k.shape
    B = kv_lens.shape[0]
    bl = block_list.long().clamp(0, NB - 1)
    k = pool_k[bl]                                      # (Tb, BS, KV, HD)
    v = pool_v[bl]
    qg = q.reshape(T, KV, H // KV, HD)
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


def paged_attention_chunked(q, pool_k, pool_v, block_list, block_req,
                            block_pos, kv_lens, token_req, token_pos,
                            *, sm_scale: Optional[float] = None):
    """The plain version of chunked paged attention over flat token lanes.

    q (T, H, HD); pools (NB, BS, KV, HD) (strided views are fine);
    BlockList arrays (Tb,) keyed by slot; kv_lens (B,) valid keys per slot
    after this step's append; token_req/token_pos (T,) each lane's owner
    (``>= B``: a padding lane) and position.  A lane attends to its owner's
    keys with ``key_pos <= token_pos`` and ``key_pos < kv_lens[owner]``;
    lanes with no valid key read 0.  Lanes are taken a chunk at a time
    (:data:`_PLAIN_SCORE_ELEMS`), which leaves each lane's arithmetic as
    it is.
    """
    T, H, HD = q.shape
    Tb, BS = block_list.shape[0], pool_k.shape[1]
    scale = sm_scale if sm_scale is not None else HD ** -0.5
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


def paged_attention_ragged(q, kv_pool, block_list, block_req, block_pos,
                           cu_q_lens, cu_kv_lens, seq_slot,
                           *, sm_scale: Optional[float] = None):
    """The plain version of ragged prefill+decode attention: lane metadata
    from :func:`ragged_lane_metadata`, then :func:`paged_attention_chunked`
    on split views of the fused pool (lanes with no valid key give 0)."""
    T = q.shape[0]
    S = seq_slot.shape[0]
    pool_k, pool_v = paged_kv.fused_kv_views(kv_pool)
    token_req, token_pos, kv_lens = ragged_lane_metadata(
        cu_q_lens, cu_kv_lens, seq_slot, T, S)
    return paged_attention_chunked(q, pool_k, pool_v, block_list, block_req,
                                   block_pos, kv_lens, token_req, token_pos,
                                   sm_scale=sm_scale)


# ----------------------------------------------------------------- wrappers
def _check_q_and_pools(q, pools: Dict[str, torch.Tensor], num_kv: int):
    """dtype, shape, device and 16-byte alignment of q and the pools (the
    kernels load 16 bytes at a time).  q must be contiguous; a pool may be
    strided, with a contiguous head dim."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype}: the kernels take float32 or "
                        "bfloat16")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"q {tuple(q.shape)} must be a contiguous "
                         "(T, H, HD) tensor")
    H, HD = q.shape[1], q.shape[2]
    if HD not in _HEAD_DIMS or H % num_kv or H // num_kv > _MAX_GROUP:
        raise ValueError(f"q {tuple(q.shape)} over {num_kv} kv heads: the "
                         f"kernels take head_dim {_HEAD_DIMS} and <= "
                         f"{_MAX_GROUP} q heads per kv head")
    vec = 16 // q.element_size()
    for name, t in (("q", q),) + tuple(pools.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:-1]):
            raise ValueError(f"{name} must be 16-byte aligned, with strides "
                             "of whole 16-byte vectors")
    for name, t in pools.items():
        if t.dim() != 4 or t.shape[3] != HD or t.stride(3) != 1:
            raise ValueError(f"{name} {tuple(t.shape)} must be (NB, BS, "
                             f"heads, {HD}) with a contiguous head dim")


def _check_ints(dev, ints: Dict[str, torch.Tensor]):
    for name, t in ints.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-D int32 tensor, "
                            f"got {t.dtype} {tuple(t.shape)}")
    Tb = ints["block_list"].shape[0]
    if ints["block_req"].shape[0] != Tb or ints["block_pos"].shape[0] != Tb:
        raise ValueError("block_list/block_req/block_pos lengths differ")


def _check_split_pools(q, pool_k, pool_v):
    if pool_k.shape != pool_v.shape or pool_k.stride() != pool_v.stride():
        raise ValueError(f"pool_k {tuple(pool_k.shape)} {pool_k.stride()} "
                         f"and pool_v {tuple(pool_v.shape)} "
                         f"{pool_v.stride()} differ")
    _check_q_and_pools(q, {"pool_k": pool_k, "pool_v": pool_v},
                       pool_k.shape[2] if pool_k.dim() == 4 else 1)


def _scale(sm_scale, HD) -> float:
    return float(sm_scale if sm_scale is not None else HD ** -0.5)


def ragged_scratch_ints(num_seqs: int, num_entries: int) -> int:
    """int32 scratch the ragged kernel needs: per-sequence page lists
    (block and position) of up to ``num_entries`` pages each, then their
    counts."""
    return 2 * num_seqs * num_entries + num_seqs


class _RaggedAttentionOp(KernelOp):
    """Ragged paged attention over the fused pool; plain version
    :func:`paged_attention_ragged`.  The fused pool must be contiguous."""

    name = "paged_attention_ragged"

    def plain(self, *args, **kw):
        return paged_attention_ragged(*args, **kw)

    def prepare(self, q, kv_pool, block_list, block_req, block_pos,
                cu_q_lens, cu_kv_lens, seq_slot, *,
                sm_scale: Optional[float] = None) -> Launch:
        from repro_torch.kernels import paged_attention as kernel

        if kv_pool.dim() != 4 or kv_pool.shape[2] % 2:
            raise ValueError(f"kv_pool {tuple(kv_pool.shape)} must be "
                             "(NB, BS, 2*KV, HD)")
        if not kv_pool.is_contiguous():
            raise ValueError("kv_pool must be contiguous")
        _check_q_and_pools(q, {"kv_pool": kv_pool}, kv_pool.shape[2] // 2)
        ints = {"block_list": block_list, "block_req": block_req,
                "block_pos": block_pos, "cu_q_lens": cu_q_lens,
                "cu_kv_lens": cu_kv_lens, "seq_slot": seq_slot}
        _check_ints(q.device, ints)
        T, H, HD = q.shape
        NB, BS, KV2, _ = kv_pool.shape
        Tb, S = block_list.shape[0], seq_slot.shape[0]
        if cu_q_lens.shape[0] != S + 1 or cu_kv_lens.shape[0] != S + 1:
            raise ValueError("cu_q_lens/cu_kv_lens must have len(seq_slot) "
                             "+ 1 entries")
        if not 1 <= S <= 1024:
            raise ValueError(f"{S} sequence entries: the kernel takes "
                             "1..1024")
        out = torch.empty_like(q)
        scratch = torch.empty((ragged_scratch_ints(S, Tb),),
                              dtype=torch.int32, device=q.device)
        argv = (q.data_ptr(), kv_pool.data_ptr(), out.data_ptr(),
                block_list.data_ptr(), block_req.data_ptr(),
                block_pos.data_ptr(), cu_q_lens.data_ptr(),
                cu_kv_lens.data_ptr(), seq_slot.data_ptr(),
                scratch.data_ptr(), T, H, KV2 // 2, HD, NB, BS, Tb, S,
                _DTYPE_CODE[q.dtype], _scale(sm_scale, HD),
                torch.cuda.current_stream(q.device).cuda_stream)
        fn = kernel.library(kernel.SOURCE).paged_attention_ragged
        return Launch(fn, argv, out, scratch)


class _ChunkedAttentionOp(KernelOp):
    """Chunked paged attention over flat token lanes and split pools
    (strided views of the fused pool are read in place); plain version
    :func:`paged_attention_chunked`.

    ``q_chunk`` is the kernel's lane tile, capped at 64 // G lanes (a
    tile's 64 rows).  ``prefetch_depth`` chose the TPU kernel's page DMA
    ring; the CUDA kernel stages each 64-key tile through shared memory and
    ignores it.  Neither changes a result.
    """

    name = "paged_attention_chunked"

    def plain(self, q, *args, q_chunk: int = 16, prefetch_depth: int = 0,
              **kw):
        _check_tunables(q_chunk, prefetch_depth)
        return paged_attention_chunked(q, *args, **kw)

    def prepare(self, q, pool_k, pool_v, block_list, block_req, block_pos,
                kv_lens, token_req, token_pos, *,
                sm_scale: Optional[float] = None, q_chunk: int = 16,
                prefetch_depth: int = 0) -> Launch:
        from repro_torch.kernels import paged_attention as kernel

        _check_tunables(q_chunk, prefetch_depth)
        _check_split_pools(q, pool_k, pool_v)
        ints = {"block_list": block_list, "block_req": block_req,
                "block_pos": block_pos, "kv_lens": kv_lens,
                "token_req": token_req, "token_pos": token_pos}
        _check_ints(q.device, ints)
        T, H, HD = q.shape
        NB, BS, KV, _ = pool_k.shape
        Tb, B = block_list.shape[0], kv_lens.shape[0]
        if token_req.shape[0] != T or token_pos.shape[0] != T:
            raise ValueError("token_req/token_pos must have one entry per "
                             "lane of q")
        if B < 1:
            raise ValueError("kv_lens must have at least one slot")
        out = torch.empty_like(q)
        scratch = torch.empty((2 * B * Tb + B + T + 1,), dtype=torch.int32,
                              device=q.device)
        sb, sr, sh, _ = pool_k.stride()
        argv = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                out.data_ptr(), block_list.data_ptr(), block_req.data_ptr(),
                block_pos.data_ptr(), kv_lens.data_ptr(),
                token_req.data_ptr(), token_pos.data_ptr(),
                scratch.data_ptr(), T, H, KV, HD, NB, BS, Tb, B,
                int(q_chunk), sb, sr, sh, _DTYPE_CODE[q.dtype],
                _scale(sm_scale, HD),
                torch.cuda.current_stream(q.device).cuda_stream)
        fn = kernel.library(kernel.CHUNKED_SOURCE).paged_attention_chunked
        return Launch(fn, argv, out, scratch)


def _check_tunables(q_chunk: int, prefetch_depth: int) -> None:
    if int(q_chunk) < 1:
        raise ValueError(f"q_chunk must be >= 1, got {q_chunk}")
    if int(prefetch_depth) < 0:
        raise ValueError(f"prefetch_depth must be >= 0, got "
                         f"{prefetch_depth}")


class _DecodeAttentionOp(KernelOp):
    """Decode-shape BlockList paged attention, one query per request, over
    split pools; plain version :func:`paged_attention_opt`.  A request with
    no BlockList entry reads 0."""

    name = "paged_attention_decode"

    def plain(self, *args, **kw):
        return paged_attention_opt(*args, **kw)

    def prepare(self, q, pool_k, pool_v, block_list, block_req, block_pos,
                seq_lens, *, sm_scale: Optional[float] = None) -> Launch:
        from repro_torch.kernels import paged_attention as kernel

        _check_split_pools(q, pool_k, pool_v)
        ints = {"block_list": block_list, "block_req": block_req,
                "block_pos": block_pos, "seq_lens": seq_lens}
        _check_ints(q.device, ints)
        B, H, HD = q.shape
        NB, BS, KV, _ = pool_k.shape
        Tb = block_list.shape[0]
        if seq_lens.shape[0] != B or B < 1:
            raise ValueError(f"seq_lens {tuple(seq_lens.shape)} must have "
                             f"one entry per query of q {tuple(q.shape)}")
        out = torch.empty_like(q)
        scratch = torch.empty((2 * B * Tb + B,), dtype=torch.int32,
                              device=q.device)
        sb, sr, sh, _ = pool_k.stride()
        argv = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                out.data_ptr(), block_list.data_ptr(), block_req.data_ptr(),
                block_pos.data_ptr(), seq_lens.data_ptr(),
                scratch.data_ptr(), B, H, KV, HD, NB, BS, Tb, sb, sr, sh,
                _DTYPE_CODE[q.dtype], _scale(sm_scale, HD),
                torch.cuda.current_stream(q.device).cuda_stream)
        fn = kernel.library(kernel.DECODE_SOURCE).paged_attention_decode
        return Launch(fn, argv, out, scratch)


paged_attention_ragged_op = _RaggedAttentionOp()
paged_attention_chunked_op = _ChunkedAttentionOp()
paged_attention_op = _DecodeAttentionOp()
