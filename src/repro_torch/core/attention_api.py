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

``with_stats=True`` makes a wrapper return ``(out, m, l)``: the output as
before and each row's softmax max and sum, float32 (T, KV, G), which the
kernels write beside the output (``paged::RowStats``) and the plain
versions take from the partials (``*_stats``).  The output stays the
normalised one, in q's dtype, and its bits do not change when the
statistics are asked for: the kernels' epilogues stay as they were and a
row costs two more floats, where the unnormalised float32 accumulator
would be a second output twice the bf16 one's bytes.  The sharded ops of a
sequence-sharded pool (:func:`paged_attention_ragged_sharded`,
:func:`paged_attention_chunked_sharded`, :func:`paged_attention_sharded`)
take each rank's triple and combine them (:func:`combine_partials`).

Shapes: q (T, H, HD) (decode: (B, H, HD)); kv_pool (NB, BS, 2*KV, HD)
with ``[K0,V0,K1,V1,...]`` on the head axis; split pools (NB, BS, KV, HD);
BlockList arrays (Tb,); cu_q_lens/cu_kv_lens (S+1,); seq_slot (S,).  GQA
maps q head ``h`` to kv head ``h // (H // KV)``.

Tunables, with the reference's names (its ``paged_attention_ragged``
family) and what each means on the card; :data:`TUNABLE_DEFAULTS` holds
the port's defaults, which give the kernels' bits of before the keys
existed.  A tunable changes speed, and the split also the bits of the
online softmax; never the function.  The plain versions check the keys
and ignore them.

* ``num_kv_pages_per_block``: pages per split of the decode tile, so
  ``split_keys = pages * BS`` keys, whole 64-key stages and at most
  :data:`MAX_SPLIT_KEYS`; 0 (the default) is the kernels' own split of
  :data:`SPLIT_KEYS` keys at any block size.  All three kernels take it,
  and at an equal split decode == chunked == ragged bit for bit on decode
  lanes.
* ``num_queries_per_block``: query rows (lanes x G) per tensor-core tile
  of a bf16 owner of two or more lanes in the ragged kernel, from G to
  128; the tile takes ``rows // G`` lanes.  Counted in rows, one value
  means the same tile height at every G.  The chunked kernel's tile is
  ``min(q_chunk, 128 // G)`` lanes: its own tunable, ``q_chunk``.
* ``vmem_limit_bytes``: a cap on the dynamic shared memory a launch
  requests, 0 for none.  A cap below the kernel's request is refused:
  the wrapper raises ``ValueError`` naming both sizes.
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
_MMA_ROWS = 128             # query rows of the tensor-core tile
STAGE_KEYS = 64             # keys per stage of the decode tile
# Keys per split of the decode tile: the port's default, and at most
# kMaxSplitKeys of kernels/csrc/paged_decode_tile.cuh (whose page list in
# shared memory is sized for it).
SPLIT_KEYS = 256
MAX_SPLIT_KEYS = 512


# The port's defaults of the ragged family's tunables, the same at every
# block size and G: the reference's registry defaults stand here
# (``kernels/paged_attention/ops.py``).  They give the kernels' bits of
# before the keys existed: 128 rows a tensor-core tile (``128 // G`` lanes)
# and, at 0 pages, splits of :data:`SPLIT_KEYS` keys.
TUNABLE_DEFAULTS = {"num_queries_per_block": _MMA_ROWS,
                    "num_kv_pages_per_block": 0, "vmem_limit_bytes": 0}


def split_keys_for(block_size: int, num_kv_pages_per_block: int) -> int:
    """Keys per split of the decode tile: :data:`SPLIT_KEYS` at 0 pages,
    else ``pages * block_size``."""
    return (num_kv_pages_per_block * block_size if num_kv_pages_per_block
            else SPLIT_KEYS)


def check_tunables(block_size: int, group: int, *,
                   num_queries_per_block: Optional[int] = None,
                   num_kv_pages_per_block: Optional[int] = None,
                   vmem_limit_bytes: int = 0) -> Dict[str, int]:
    """The tunables with None taken from :data:`TUNABLE_DEFAULTS`, checked:
    ``ValueError`` on a negative page count, on a page count whose split is
    not whole 64-key stages or is above :data:`MAX_SPLIT_KEYS` keys, on
    rows per tile outside ``[G, 128]`` and on a negative cap."""
    out = dict(TUNABLE_DEFAULTS)
    for k, v in (("num_queries_per_block", num_queries_per_block),
                 ("num_kv_pages_per_block", num_kv_pages_per_block),
                 ("vmem_limit_bytes", vmem_limit_bytes)):
        if v is not None:
            out[k] = int(v)
    rows, pages = out["num_queries_per_block"], out["num_kv_pages_per_block"]
    split = pages * block_size
    if pages < 0 or pages and (split % STAGE_KEYS or split > MAX_SPLIT_KEYS):
        raise ValueError(
            f"num_kv_pages_per_block={pages} at block size {block_size}: a "
            f"split of {split} keys; the decode tile takes whole "
            f"{STAGE_KEYS}-key stages, at most {MAX_SPLIT_KEYS} keys")
    if not group <= rows <= _MMA_ROWS:
        raise ValueError(
            f"num_queries_per_block={rows} at G {group}: the tensor-core "
            f"tile takes {group}..{_MMA_ROWS} query rows (rows // G lanes)")
    if out["vmem_limit_bytes"] < 0:
        raise ValueError(f"vmem_limit_bytes={out['vmem_limit_bytes']} < 0")
    return out


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
    return paged_attention_opt_stats(q, pool_k, pool_v, block_list,
                                     block_req, block_pos, seq_lens,
                                     sm_scale=sm_scale)[0]


def paged_attention_opt_stats(q, pool_k, pool_v, block_list, block_req,
                              block_pos, seq_lens,
                              *, sm_scale: Optional[float] = None):
    """:func:`paged_attention_opt` with each row's ``(m, l)`` (B, KV, G)
    from :func:`_opt_partials`, as :func:`paged_attention_chunked_stats`
    returns them."""
    B, H, HD = q.shape
    scale = sm_scale if sm_scale is not None else HD ** -0.5
    m, l, o = _opt_partials(q, pool_k, pool_v, block_list, block_req,
                            block_pos, seq_lens, B, scale)
    out = o / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, HD).to(q.dtype), m, l


def combine_partials(out, m, l, mesh, axis: str = "model"):
    """The log-sum-exp combine of per-rank attention over disjoint keys
    (the reference's ``paged_attention_*_sharded`` combine, inside which
    its ``o_r`` is ``out * l`` here): out (T, H, HD) each rank's normalised
    output, m / l (T, KV, G) float32 its rows' statistics.  With
    ``M = max_r m_r`` (one MAX) and ``w_r = l_r exp(m_r - M)``, the result
    is ``sum_r w_r out_r / max(sum_r w_r, 1e-30)``: the numerators and the
    denominators travel in ONE float32 buffer, ``(T, KV, G, HD + 1)``, so a
    layer takes one MAX and one SUM.  A row with no key on a rank has
    ``l_r == 0`` there and weighs nothing; a row with no key anywhere gives
    0, as on one device.  Returned in ``out``'s dtype, the same bits on
    every rank."""
    from repro_torch.distributed import collectives

    T, H, HD = out.shape
    KV, G = m.shape[1], m.shape[2]
    m_all = collectives.all_reduce(m.clone(), mesh, axis, collectives.MAX)
    w = l * torch.exp(m - m_all)                          # (T, KV, G)
    buf = torch.empty((T, KV, G, HD + 1), dtype=torch.float32,
                      device=out.device)
    buf[..., :HD] = out.reshape(T, KV, G, HD).float() * w[..., None]
    buf[..., HD] = w
    collectives.all_reduce(buf, mesh, axis, collectives.SUM)
    res = buf[..., :HD] / torch.clamp_min(buf[..., HD], 1e-30)[..., None]
    return res.reshape(T, H, HD).to(out.dtype)


def paged_attention_chunked_sharded(q, pool_k, pool_v, block_list,
                                    block_req, block_pos, kv_lens, token_req,
                                    token_pos, *, mesh, axis: str = "model",
                                    sm_scale: Optional[float] = None, **kw):
    """Chunked paged attention over a sequence-sharded pool: each rank's
    lanes against its pool shard and LOCAL BlockList (rows of
    :meth:`BlockAllocator.build_sharded_block_lists`) through
    :data:`paged_attention_chunked_op` with its statistics (the kernel on a
    card, :func:`paged_attention_chunked_stats` on the CPU), then
    :func:`combine_partials` over ``axis``.  ``kw``: the op's tunables."""
    out, m, l = paged_attention_chunked_op(
        q, pool_k, pool_v, block_list, block_req, block_pos, kv_lens,
        token_req, token_pos, sm_scale=sm_scale, with_stats=True, **kw)
    return combine_partials(out, m, l, mesh, axis)


def paged_attention_ragged_sharded(q, kv_pool, block_list, block_req,
                                   block_pos, cu_q_lens, cu_kv_lens, seq_slot,
                                   *, mesh, axis: str = "model",
                                   sm_scale: Optional[float] = None, **kw):
    """Ragged attention over a sequence-sharded FUSED pool: the replicated
    cu prefix sums, each rank's pool shard and LOCAL BlockList through
    :data:`paged_attention_ragged_op` with its statistics, then
    :func:`combine_partials`."""
    out, m, l = paged_attention_ragged_op(
        q, kv_pool, block_list, block_req, block_pos, cu_q_lens, cu_kv_lens,
        seq_slot, sm_scale=sm_scale, with_stats=True, **kw)
    return combine_partials(out, m, l, mesh, axis)


def paged_attention_sharded(q, pool_k, pool_v, block_list, block_req,
                            block_pos, seq_lens, *, mesh, axis: str = "model",
                            sm_scale: Optional[float] = None, **kw):
    """Decode-shape (the paper path's) attention over a sequence-sharded
    pool: :data:`paged_attention_op` with its statistics on each rank's
    shard and LOCAL BlockList, then :func:`combine_partials`."""
    out, m, l = paged_attention_op(
        q, pool_k, pool_v, block_list, block_req, block_pos, seq_lens,
        sm_scale=sm_scale, with_stats=True, **kw)
    return combine_partials(out, m, l, mesh, axis)


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
    return paged_attention_chunked_stats(
        q, pool_k, pool_v, block_list, block_req, block_pos, kv_lens,
        token_req, token_pos, sm_scale=sm_scale)[0]


def paged_attention_chunked_stats(q, pool_k, pool_v, block_list, block_req,
                                  block_pos, kv_lens, token_req, token_pos,
                                  *, sm_scale: Optional[float] = None):
    """:func:`paged_attention_chunked` with each row's softmax statistics:
    ``(out (T, H, HD), m (T, KV, G), l (T, KV, G))``, m and l float32 from
    :func:`_chunked_partials` (``m == -1e30``, ``l == 0`` for a lane with no
    valid key), ``out = o / max(l, 1e-30)`` in q's dtype.  What the
    kernels write when asked for their statistics, and what the sharded
    combine (:func:`combine_partials`) reads."""
    T, H, HD = q.shape
    Tb, BS, KV = block_list.shape[0], pool_k.shape[1], pool_k.shape[2]
    scale = sm_scale if sm_scale is not None else HD ** -0.5
    out = torch.empty_like(q)
    m_all = torch.empty((T, KV, H // KV), dtype=torch.float32,
                        device=q.device)
    l_all = torch.empty_like(m_all)
    step = max(1, _PLAIN_SCORE_ELEMS // max(1, H * Tb * BS))
    for s in range(0, T, step):
        e = min(s + step, T)
        m, l, o = _chunked_partials(q[s:e], pool_k, pool_v, block_list,
                                    block_req, block_pos, kv_lens,
                                    token_req[s:e], token_pos[s:e], scale)
        res = o / torch.clamp_min(l, 1e-30)[..., None]
        out[s:e] = res.reshape(e - s, H, HD).to(q.dtype)
        m_all[s:e], l_all[s:e] = m, l
    return out, m_all, l_all


def paged_attention_ragged(q, kv_pool, block_list, block_req, block_pos,
                           cu_q_lens, cu_kv_lens, seq_slot,
                           *, sm_scale: Optional[float] = None):
    """The plain version of ragged prefill+decode attention: lane metadata
    from :func:`ragged_lane_metadata`, then :func:`paged_attention_chunked`
    on split views of the fused pool (lanes with no valid key give 0)."""
    return paged_attention_ragged_stats(
        q, kv_pool, block_list, block_req, block_pos, cu_q_lens, cu_kv_lens,
        seq_slot, sm_scale=sm_scale)[0]


def paged_attention_ragged_stats(q, kv_pool, block_list, block_req,
                                 block_pos, cu_q_lens, cu_kv_lens, seq_slot,
                                 *, sm_scale: Optional[float] = None):
    """:func:`paged_attention_ragged` with each row's ``(m, l)``, as
    :func:`paged_attention_chunked_stats` returns them."""
    T = q.shape[0]
    S = seq_slot.shape[0]
    pool_k, pool_v = paged_kv.fused_kv_views(kv_pool)
    token_req, token_pos, kv_lens = ragged_lane_metadata(
        cu_q_lens, cu_kv_lens, seq_slot, T, S)
    return paged_attention_chunked_stats(
        q, pool_k, pool_v, block_list, block_req, block_pos, kv_lens,
        token_req, token_pos, sm_scale=sm_scale)


def chunked_bf16_share(got, q, pool_k, pool_v, block_list, block_req,
                       block_pos, kv_lens, token_req, token_pos,
                       *, sm_scale: Optional[float] = None) -> float:
    """Largest ``|got - want| / (2^-7 (M + |want|) + 1e-4)`` of a bf16
    chunked result: ``want`` the plain version on float32 q and K with v as
    it is, ``M`` the same on ``|v|`` (the weights' mean of |v|).  At most 1
    passes.  The flash kernel's limit (``kernels/flash_attention/ref.py``
    ``bf16_share``), for the same reason: with the scores in float32, as
    the kernels take them, a bf16 kernel differs from ``want`` only where
    each rounds the weights and the output to bfloat16."""
    from repro_torch.kernels.flash_attention.ref import (BF16_FLOOR,
                                                         BF16_REL)

    ints = (block_list, block_req, block_pos, kv_lens, token_req, token_pos)
    qf, kf = q.float(), pool_k.float()
    want = paged_attention_chunked(qf, kf, pool_v, *ints,
                                   sm_scale=sm_scale).float()
    m = paged_attention_chunked(qf, kf, pool_v.abs(), *ints,
                                sm_scale=sm_scale).float()
    return ((got.float() - want).abs()
            / (BF16_REL * (m + want.abs()) + BF16_FLOOR)).max().item()


def ragged_bf16_share(got, q, kv_pool, block_list, block_req, block_pos,
                      cu_q_lens, cu_kv_lens, seq_slot,
                      *, sm_scale: Optional[float] = None) -> float:
    """:func:`chunked_bf16_share` of a bf16 ragged result, on the lanes
    :func:`ragged_lane_metadata` derives."""
    token_req, token_pos, kv_lens = ragged_lane_metadata(
        cu_q_lens, cu_kv_lens, seq_slot, q.shape[0], seq_slot.shape[0])
    return chunked_bf16_share(got, q, *paged_kv.fused_kv_views(kv_pool),
                              block_list, block_req, block_pos, kv_lens,
                              token_req, token_pos, sm_scale=sm_scale)


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


def _outputs(q, num_kv: int, with_stats: bool):
    """A launch's output, ``torch.empty_like(q)``, and with ``with_stats``
    the float32 (2, T, H) buffer the kernel writes each row's ``(m, l)``
    into: returns ``(out, (out, m, l) or None, stats pointer or None)``,
    m and l (T, KV, G) views of the buffer."""
    out = torch.empty_like(q)
    if not with_stats:
        return out, None, None
    T, H, _ = q.shape
    buf = torch.empty((2, T, num_kv, H // num_kv), dtype=torch.float32,
                      device=q.device)
    return out, (out, buf[0], buf[1]), buf.data_ptr()


def _scale(sm_scale, HD) -> float:
    return float(sm_scale if sm_scale is not None else HD ** -0.5)


def ragged_scratch_ints(num_seqs: int, num_entries: int,
                        num_kv: int) -> int:
    """int32 scratch the ragged kernel needs: per-sequence page lists
    (block and position) of up to ``num_entries`` pages each, their counts,
    then the decode tile's arrival counters, one per (sequence, kv
    head)."""
    return 2 * num_seqs * num_entries + num_seqs + num_seqs * num_kv


def split_capacity(num_owners: int, num_entries: int, block_size: int,
                   split_keys: int = SPLIT_KEYS) -> int:
    """Splits of ``split_keys`` keys the decode tile's workspace holds:
    every owner of one lane has at least one, and its pages add one per
    ``split_keys`` keys, so when each of the ``num_entries`` BlockList
    entries belongs to one owner there are at most ``ceil(num_entries *
    block_size / split_keys) + num_owners`` (no host sync: the owners' key
    counts stay on the card)."""
    return -(-num_entries * block_size // split_keys) + num_owners


def _launch_tunables(source: str, q, block_size: int, group: int, kw):
    """The checked tunables of a launch (:func:`check_tunables`), and the
    split in keys; ``ValueError`` naming both sizes when the kernel's
    shared memory exceeds ``vmem_limit_bytes``."""
    from repro_torch.kernels import paged_attention as kernel

    tun = check_tunables(block_size, group, **kw)
    cap = tun["vmem_limit_bytes"]
    if cap:
        need = kernel.smem_bytes(source, q.shape[2], _DTYPE_CODE[q.dtype],
                                 group)
        if need > cap:
            raise ValueError(
                f"vmem_limit_bytes={cap}: {source} at head dim "
                f"{q.shape[2]}, {q.dtype}, G {group} requests {need} bytes "
                "of shared memory")
    return tun, split_keys_for(block_size, tun["num_kv_pages_per_block"])


def _scratch(q, ints: int, max_splits: int):
    """One int32 buffer for a paged kernel: ``ints`` int32 of lists and
    counts, then, 16-byte aligned, the decode tile's workspace of
    ``max_splits`` x KV records of G x (HD + 2) float32 (each split's sums,
    max and denominator per row).  Returns the buffer and the workspace's
    address."""
    _, H, HD = q.shape
    off = -(-ints // 4) * 4
    buf = torch.empty((off + max_splits * H * (HD + 2),), dtype=torch.int32,
                      device=q.device)
    return buf, buf.data_ptr() + 4 * off


class _RaggedAttentionOp(KernelOp):
    """Ragged paged attention over the fused pool; plain version
    :func:`paged_attention_ragged`.  The fused pool must be contiguous.
    In bf16 the tiles of a sequence with two or more lanes run on the
    tensor cores, ``num_queries_per_block // G`` lanes a tile, a sequence
    of one lane (a decode lane, either dtype) on the split decode tile, its
    keys in splits of ``num_kv_pages_per_block`` pages, the rest (float32
    prefill, padding) on the SIMT tile; either way a lane's bits are the
    chunked kernel's at the same split.  ``vmem_limit_bytes`` caps the
    launch's shared memory (module docstring).  Tunables left None take
    :data:`TUNABLE_DEFAULTS`."""

    name = "paged_attention_ragged"

    def plain(self, q, kv_pool, *args, num_queries_per_block=None,
              num_kv_pages_per_block=None, vmem_limit_bytes: int = 0,
              with_stats: bool = False, **kw):
        check_tunables(kv_pool.shape[1], q.shape[1] * 2 // kv_pool.shape[2],
                       num_queries_per_block=num_queries_per_block,
                       num_kv_pages_per_block=num_kv_pages_per_block,
                       vmem_limit_bytes=vmem_limit_bytes)
        if with_stats:
            return paged_attention_ragged_stats(q, kv_pool, *args, **kw)
        return paged_attention_ragged(q, kv_pool, *args, **kw)

    def prepare(self, q, kv_pool, block_list, block_req, block_pos,
                cu_q_lens, cu_kv_lens, seq_slot, *,
                sm_scale: Optional[float] = None,
                num_queries_per_block: Optional[int] = None,
                num_kv_pages_per_block: Optional[int] = None,
                vmem_limit_bytes: int = 0,
                with_stats: bool = False) -> Launch:
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
        tun, split_keys = _launch_tunables(
            kernel.SOURCE, q, BS, H * 2 // KV2,
            dict(num_queries_per_block=num_queries_per_block,
                 num_kv_pages_per_block=num_kv_pages_per_block,
                 vmem_limit_bytes=vmem_limit_bytes))
        out, stats, ptr = _outputs(q, KV2 // 2, with_stats)
        splits = split_capacity(S, Tb, BS, split_keys)
        scratch, partials = _scratch(
            q, ragged_scratch_ints(S, Tb, KV2 // 2), splits)
        argv = (q.data_ptr(), kv_pool.data_ptr(), out.data_ptr(), ptr,
                block_list.data_ptr(), block_req.data_ptr(),
                block_pos.data_ptr(), cu_q_lens.data_ptr(),
                cu_kv_lens.data_ptr(), seq_slot.data_ptr(),
                scratch.data_ptr(), partials, T, H, KV2 // 2, HD, NB, BS, Tb,
                S, splits, split_keys,
                tun["num_queries_per_block"] // (H * 2 // KV2),
                tun["vmem_limit_bytes"], _DTYPE_CODE[q.dtype],
                _scale(sm_scale, HD),
                torch.cuda.current_stream(q.device).cuda_stream)
        fn = kernel.library(kernel.SOURCE).paged_attention_ragged
        return Launch(fn, argv, stats or out, scratch)


class _ChunkedAttentionOp(KernelOp):
    """Chunked paged attention over flat token lanes and split pools
    (strided views of the fused pool are read in place); plain version
    :func:`paged_attention_chunked`.

    ``q_chunk`` is the kernel's lane tile, capped at 128 // G lanes for an
    owner whose tiles run on the tensor cores (bf16, two or more lanes in
    the call: a tile's 128 rows) and at 64 // G for the SIMT tile's (f32
    owners of two or more lanes, padding: its 64 rows); an owner of one
    lane runs on the split decode tile.  ``prefetch_depth`` chose the TPU
    kernel's page DMA ring; the CUDA kernel stages each 64-key stage
    through shared memory and ignores it.  Neither changes a result.
    ``num_kv_pages_per_block`` and ``vmem_limit_bytes`` are the ragged
    kernel's (module docstring): at an equal split a lane's bits are the
    ragged kernel's.
    """

    name = "paged_attention_chunked"

    def plain(self, q, pool_k, *args, q_chunk: int = 16,
              prefetch_depth: int = 0, num_kv_pages_per_block=None,
              vmem_limit_bytes: int = 0, with_stats: bool = False, **kw):
        _check_tunables(q_chunk, prefetch_depth)
        check_tunables(pool_k.shape[1], q.shape[1] // pool_k.shape[2],
                       num_kv_pages_per_block=num_kv_pages_per_block,
                       vmem_limit_bytes=vmem_limit_bytes)
        if with_stats:
            return paged_attention_chunked_stats(q, pool_k, *args, **kw)
        return paged_attention_chunked(q, pool_k, *args, **kw)

    def prepare(self, q, pool_k, pool_v, block_list, block_req, block_pos,
                kv_lens, token_req, token_pos, *,
                sm_scale: Optional[float] = None, q_chunk: int = 16,
                prefetch_depth: int = 0,
                num_kv_pages_per_block: Optional[int] = None,
                vmem_limit_bytes: int = 0,
                with_stats: bool = False) -> Launch:
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
        tun, split_keys = _launch_tunables(
            kernel.CHUNKED_SOURCE, q, BS, H // KV,
            dict(num_kv_pages_per_block=num_kv_pages_per_block,
                 vmem_limit_bytes=vmem_limit_bytes))
        out, stats, ptr = _outputs(q, KV, with_stats)
        splits = split_capacity(B, Tb, BS, split_keys)
        scratch, partials = _scratch(
            q, 2 * B * Tb + 3 * B + T + 1 + B * KV, splits)
        sb, sr, sh, _ = pool_k.stride()
        argv = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                out.data_ptr(), ptr, block_list.data_ptr(),
                block_req.data_ptr(),
                block_pos.data_ptr(), kv_lens.data_ptr(),
                token_req.data_ptr(), token_pos.data_ptr(),
                scratch.data_ptr(), partials, T, H, KV, HD, NB, BS, Tb, B,
                int(q_chunk), splits, split_keys, tun["vmem_limit_bytes"], sb,
                sr, sh, _DTYPE_CODE[q.dtype], _scale(sm_scale, HD),
                torch.cuda.current_stream(q.device).cuda_stream)
        fn = kernel.library(kernel.CHUNKED_SOURCE).paged_attention_chunked
        return Launch(fn, argv, stats or out, scratch)


def _check_tunables(q_chunk: int, prefetch_depth: int) -> None:
    if int(q_chunk) < 1:
        raise ValueError(f"q_chunk must be >= 1, got {q_chunk}")
    if int(prefetch_depth) < 0:
        raise ValueError(f"prefetch_depth must be >= 0, got "
                         f"{prefetch_depth}")


class _DecodeAttentionOp(KernelOp):
    """Decode-shape BlockList paged attention, one query per request, over
    split pools; plain version :func:`paged_attention_opt`.  Each request
    runs on the split decode tile, as a decode lane of the ragged and
    chunked kernels does, with the same bits at the same split
    (``num_kv_pages_per_block``; ``vmem_limit_bytes`` as theirs: module
    docstring).  A request with no BlockList entry reads 0."""

    name = "paged_attention_decode"

    def plain(self, q, pool_k, *args, num_kv_pages_per_block=None,
              vmem_limit_bytes: int = 0, with_stats: bool = False, **kw):
        check_tunables(pool_k.shape[1], q.shape[1] // pool_k.shape[2],
                       num_kv_pages_per_block=num_kv_pages_per_block,
                       vmem_limit_bytes=vmem_limit_bytes)
        if with_stats:
            return paged_attention_opt_stats(q, pool_k, *args, **kw)
        return paged_attention_opt(q, pool_k, *args, **kw)

    def prepare(self, q, pool_k, pool_v, block_list, block_req, block_pos,
                seq_lens, *, sm_scale: Optional[float] = None,
                num_kv_pages_per_block: Optional[int] = None,
                vmem_limit_bytes: int = 0,
                with_stats: bool = False) -> Launch:
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
        tun, split_keys = _launch_tunables(
            kernel.DECODE_SOURCE, q, BS, H // KV,
            dict(num_kv_pages_per_block=num_kv_pages_per_block,
                 vmem_limit_bytes=vmem_limit_bytes))
        out, stats, ptr = _outputs(q, KV, with_stats)
        splits = split_capacity(B, Tb, BS, split_keys)
        scratch, partials = _scratch(q, 2 * B * Tb + B + B * KV, splits)
        sb, sr, sh, _ = pool_k.stride()
        argv = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                out.data_ptr(), ptr, block_list.data_ptr(),
                block_req.data_ptr(),
                block_pos.data_ptr(), seq_lens.data_ptr(),
                scratch.data_ptr(), partials, B, H, KV, HD, NB, BS, Tb,
                splits, split_keys, tun["vmem_limit_bytes"], sb, sr, sh,
                _DTYPE_CODE[q.dtype], _scale(sm_scale, HD),
                torch.cuda.current_stream(q.device).cuda_stream)
        fn = kernel.library(kernel.DECODE_SOURCE).paged_attention_decode
        return Launch(fn, argv, stats or out, scratch)


paged_attention_ragged_op = _RaggedAttentionOp()
paged_attention_chunked_op = _ChunkedAttentionOp()
paged_attention_op = _DecodeAttentionOp()
