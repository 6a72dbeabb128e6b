// Ragged paged attention over the fused head-interleaved KV pool, for
// Hopper (sm_90a).  One launch serves prefill-chunk and decode lanes mixed.
//
// Replaces the TPU kernel paged_attention_ragged_pallas / _ragged_kernel
// (src/repro/kernels/paged_attention/kernel.py:471 / :400) and computes
// what repro_torch.core.attention_api.paged_attention_ragged computes:
//
//   q          (T, H, HD)           float32 or bfloat16
//   kv_pool    (NB, BS, 2*KV, HD)   K of kv-head k at row 2k, its V at 2k+1
//   block_list, block_req, block_pos (Tb,) int32: flat BlockList keyed by
//              engine slot; entries with block_req >= S are padding
//   cu_q, cu_kv (S+1,) int32; seq_slot (S,) int32
//   out        (T, H, HD)
//
// Sequence j owns lanes [cu_q[j], cu_q[j+1]); its lanes are its LAST
// nq = cu_q[j+1]-cu_q[j] positions of kvl = cu_kv[j+1]-cu_kv[j] valid keys.
// A lane attends to the keys of its slot with key_pos <= lane_pos and
// key_pos < kvl; q head h reads kv head h / G.  Softmax and sums run in
// f32 with the -1e30 sentinel, and a lane with no valid key writes 0.
// Lanes past cu_q[S], and lanes of a sequence whose slot is out of range,
// are such lanes.  Slots are assumed distinct, as the engine renders them.
//
// Which tile serves which rows (paged_attention_mma.cuh): in bfloat16,
// the tiles of a sequence with two or more lanes in the launch (prefill
// chunks) run on paged::attend_tile_mma, 128 query rows per block on the
// tensor cores (wgmma at HD 64/128, mma.sync at 16/32, K/V in bf16 through
// a two-stage cp.async ring); a sequence of one lane (a decode lane, f32
// or bf16) runs on the decode tile (paged_decode_tile.cuh): its keys cut
// into splits of kSplitKeys, one block per (split, kv head), combined in
// this launch; everything else runs on the SIMT paged::attend_tile, 64
// rows per block: float32 sequences of two or more lanes and padding
// tiles.  The choice is the sequence's alone, and the chunked and decode
// kernels make it the same way; a row's result on each tile depends only
// on its sequence's page list, its position and kvl, so the kernels stay
// bitwise equal on the same lanes.
//
// Bound on the H100: the larger of the bytes (the K/V rows the step's
// sequences hold, q, out and the lists, at 3.35 TB/s) and the operations
// (4*HD per (head, valid key) pair, at 989 TFLOP/s in bf16 or 67 in f32);
// a serving step's bytes bound is the larger.  entry_lists_kernel compacts
// each sequence's pages once per launch (and resets the decode tile's
// arrival counters); ragged_attention_kernel runs the decode tile's split
// blocks first, then one block per (sequence, query tile of that
// sequence's lanes, kv head): the G query heads of the kv head ride in a
// tile's rows, so each KV byte of a sequence is read once per query tile,
// and a decode lane's keys are read once, spread over its splits.  An
// instance holds every tile its dtype uses, chosen per block at run time,
// in one launch: 256 threads, dynamic shared memory for the largest tile,
// two blocks per SM at bf16 HD <= 64.
// Not done yet: TMA copies and warp specialisation in the tensor-core tile.

#include "paged_attention_mma.cuh"

namespace {

using paged::kListThreads;
using paged::kRows;
using paged::kThreads;
constexpr int kMaxSeqs = 1024;  // S limit (cu_q is staged in shared memory)

// For sequence j, the pages (pool block, block position) of its BlockList
// entries that hold a key below kvl_j, in BlockList order:
// list_blk/list_pos[j * Tb + c], c < counts[j]; and its decode tile's
// arrival counters counters[j * KV, (j + 1) * KV) reset to 0.
__global__ void entry_lists_kernel(const int* __restrict__ block_list,
                                   const int* __restrict__ block_req,
                                   const int* __restrict__ block_pos, int Tb,
                                   const int* __restrict__ cu_q,
                                   const int* __restrict__ cu_kv,
                                   const int* __restrict__ seq_slot, int S,
                                   int BS, int NB, int KV,
                                   int* __restrict__ list_blk,
                                   int* __restrict__ list_pos,
                                   int* __restrict__ counts,
                                   int* __restrict__ counters) {
  const int j = blockIdx.x;
  for (int h = threadIdx.x; h < KV; h += kListThreads)
    counters[j * KV + h] = 0;
  const int slot = seq_slot[j];
  const int nq = cu_q[j + 1] - cu_q[j];
  const int kvl = cu_kv[j + 1] - cu_kv[j];
  if (slot < 0 || slot >= S || nq <= 0) {  // uniform across the block
    if (threadIdx.x == 0) counts[j] = 0;
    return;
  }
  const size_t at = static_cast<size_t>(j) * Tb;
  const int n = paged::compact_entries(block_list, block_req, block_pos, Tb,
                                       slot, kvl, BS, NB, list_blk + at,
                                       list_pos + at);
  if (threadIdx.x == 0) counts[j] = n;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads,
                                  paged::PagedKernel<T, HD>::kMinBlocks)
    ragged_attention_kernel(const T* __restrict__ q,
                            const T* __restrict__ kv_pool,
                            T* __restrict__ out, const int* __restrict__ cu_q,
                            const int* __restrict__ cu_kv,
                            const int* __restrict__ list_blk,
                            const int* __restrict__ list_pos,
                            const int* __restrict__ counts,
                            int* __restrict__ counters,
                            float* __restrict__ partials, int num_lanes,
                            int H, int KV, int BS, int S, int Tb, int tq,
                            int tq_mma, int split_blocks, int max_splits,
                            float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int sCu[kMaxSeqs + 1];
  __shared__ int sInfo[3];

  const int tid = threadIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const long long fused = 2LL * KV * HD;      // one pool row, K and V heads
  const paged::Pool<T> pool{kv_pool, kv_pool + HD, BS * fused, fused,
                            2LL * HD};
  if (blockIdx.x < split_blocks) {          // the decode tile's splits
    // sequence j's splits: one lane (at cu_q[j] < num_lanes), keys counts[j]
    // pages
    const auto nsplit = [=](int j) {
      const int lane = cu_q[j];
      return paged::decode_owner(cu_q[j + 1] - lane) && lane >= 0 &&
                     lane < num_lanes
                 ? paged::num_splits(static_cast<long long>(counts[j]) * BS)
                 : 0;
    };
    paged::run_splits(split_blocks, S, nsplit,
                      [&](int j, int split, int w, int h) {
      const int kvl = cu_kv[j + 1] - cu_kv[j];
      const size_t list0 = static_cast<size_t>(j) * Tb;
      paged::decode_split<T, HD>(
          q, out, H, G, h, cu_q[j], kvl - 1, kvl, list_blk + list0,
          list_pos + list0, counts[j], BS, pool, scale, split, nsplit(j), w,
          KV, max_splits, partials, counters + j * KV + h,
          reinterpret_cast<unsigned char*>(smem));
    });
    return;
  }
  for (int i = tid; i <= S; i += kThreads) sCu[i] = cu_q[i];
  __syncthreads();

  // Which tile is this block?  Sequences in order, each cut into tiles of
  // tq_mma lanes (a tensor-core sequence) or tq (none for a decode-tile
  // sequence), then the padding lanes past cu_q[S] in tiles of tq.
  if (tid == 0) {
    int b = blockIdx.x - split_blocks, seq = -2, lane0 = 0, n = 0;
    for (int j = 0; j < S; ++j) {
      const int nq = sCu[j + 1] - sCu[j];
      const int len = paged::mma_owner<T>(nq) ? tq_mma : tq;
      const int nt =
          nq > 0 && !paged::decode_owner(nq) ? (nq + len - 1) / len : 0;
      if (b < nt) {
        seq = j;
        lane0 = sCu[j] + b * len;
        n = min(len, sCu[j + 1] - lane0);
        break;
      }
      b -= nt;
    }
    if (seq == -2) {
      const int start = max(sCu[S], 0);
      const int np = num_lanes > start ? (num_lanes - start + tq - 1) / tq : 0;
      if (b < np) {
        seq = -1;
        lane0 = start + b * tq;
        n = tq;
      }
    }
    n = min(n, num_lanes - lane0);         // never write past the lanes
    sInfo[0] = n > 0 ? seq : -2;
    sInfo[1] = lane0;
    sInfo[2] = n;
  }
  __syncthreads();
  const int seq = sInfo[0];
  if (seq == -2) return;
  const int lane0 = sInfo[1];
  const int nrows = sInfo[2] * G;

  // A lane of sequence j sits at position kvl - nq + (its index among the
  // sequence's lanes); a padding tile (seq == -1) has no keys.
  int kvl = 0, first = -1, count = 0, nq = 0;
  if (seq >= 0) {
    nq = sCu[seq + 1] - sCu[seq];
    kvl = cu_kv[seq + 1] - cu_kv[seq];
    first = kvl - nq + (lane0 - sCu[seq]);
    count = counts[seq];
  }
  const size_t list0 = static_cast<size_t>(seq < 0 ? 0 : seq) * Tb;
  if constexpr (paged::PagedKernel<T, HD>::kMma) {
    if (paged::mma_owner<T>(nq)) {           // uniform across the block
      const auto row_pos = [=](int r) { return first + r / G; };
      paged::attend_tile_mma<HD>(q, out, H, G, kvh, lane0, nrows, row_pos,
                                 kvl, list_blk + list0, list_pos + list0,
                                 count, BS, pool, scale, smem);
      return;
    }
  }
  const int pos = seq >= 0 ? first + (tid >> 2) / G : -1;
  paged::attend_tile<T, HD>(q, out, H, G, kvh, lane0, nrows, pos, kvl,
                            list_blk + list0, list_pos + list0, count, BS,
                            pool, scale, smem);
}

// The per-sequence page lists share one scratch buffer of
// 2 * S * Tb + S + S * KV int32: list_blk, then list_pos, counts and the
// decode tile's arrival counters; beside it the decode tile's workspace,
// max_splits x KV records of partial_floats(G, HD) floats.
struct Lists {
  const int* blk;
  const int* pos;
  const int* counts;
  int* counters;
  float* partials;
  int max_splits;
};

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kv_pool, void* out,
                   const int* cu_q, const int* cu_kv, Lists lists,
                   int T_lanes, int H, int KV, int BS, int S, int Tb,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = paged::PagedKernel<T, HD>::kSmem;
  static bool configured = false;
  const cudaError_t err = paged::configure<T, HD>(
      ragged_attention_kernel<T, HD>, &configured);
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  const int tq = kRows / G;
  const int tq_mma = paged::kMmaRows / G;
  // the split blocks, which loop when there are more splits, then enough
  // tile blocks (a tensor-core sequence's tiles are longer)
  const int split_blocks =
      paged::split_grid_x(lists.max_splits, KV, paged::kSplitGridBlocks);
  const dim3 grid(split_blocks + (T_lanes + tq - 1) / tq + S + 1, KV);
  ragged_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv_pool),
      static_cast<T*>(out), cu_q, cu_kv, lists.blk, lists.pos, lists.counts,
      lists.counters, lists.partials, T_lanes, H, KV, BS, S, Tb, tq, tq_mma,
      split_blocks, lists.max_splits, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int HD, const void* q, const void* kv_pool, void* out,
                      const int* cu_q, const int* cu_kv, Lists lists,
                      int T_lanes, int H, int KV, int BS, int S, int Tb,
                      float scale, cudaStream_t stream) {
  switch (HD) {
    case 16:
      return launch<T, 16>(q, kv_pool, out, cu_q, cu_kv, lists, T_lanes, H,
                           KV, BS, S, Tb, scale, stream);
    case 32:
      return launch<T, 32>(q, kv_pool, out, cu_q, cu_kv, lists, T_lanes, H,
                           KV, BS, S, Tb, scale, stream);
    case 64:
      return launch<T, 64>(q, kv_pool, out, cu_q, cu_kv, lists, T_lanes, H,
                           KV, BS, S, Tb, scale, stream);
    case 128:
      return launch<T, 128>(q, kv_pool, out, cu_q, cu_kv, lists, T_lanes, H,
                            KV, BS, S, Tb, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  scratch holds
// 2 * S * Tb + S + S * KV int32 (see Lists); partials max_splits x KV x
// partial_floats(H / KV, HD) floats, max_splits >= 1 (the decode tile's
// splits over all sequences of one lane: at most ceil(Tb * BS /
// kSplitKeys) + S when each BlockList entry belongs to one sequence).  q,
// kv_pool, out and partials must be 16-byte aligned.  dtype: 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError() after the launches (0 = ok).
extern "C" int paged_attention_ragged(
    const void* q, const void* kv_pool, void* out, const void* block_list,
    const void* block_req, const void* block_pos, const void* cu_q_lens,
    const void* cu_kv_lens, const void* seq_slot, void* scratch,
    void* partials, int T_lanes, int H, int KV, int HD, int NB, int BS,
    int Tb, int S, int max_splits, int dtype, float scale, void* stream) {
  if (S < 1 || S > kMaxSeqs || KV < 1 || H % KV != 0 || H / KV > kRows ||
      BS < 1 || NB < 1 || max_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* list_blk = static_cast<int*>(scratch);
  int* list_pos = list_blk + static_cast<size_t>(S) * Tb;
  int* counts = list_pos + static_cast<size_t>(S) * Tb;
  int* counters = counts + S;
  const int* cq = static_cast<const int*>(cu_q_lens);
  const int* ck = static_cast<const int*>(cu_kv_lens);
  entry_lists_kernel<<<S, kListThreads, 0, st>>>(
      static_cast<const int*>(block_list), static_cast<const int*>(block_req),
      static_cast<const int*>(block_pos), Tb, cq, ck,
      static_cast<const int*>(seq_slot), S, BS, NB, KV, list_blk, list_pos,
      counts, counters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T_lanes == 0) return 0;
  const Lists lists{list_blk, list_pos, counts, counters,
                    static_cast<float*>(partials), max_splits};
  if (dtype == 0)
    err = launch_hd<float>(HD, q, kv_pool, out, cq, ck, lists, T_lanes, H, KV,
                           BS, S, Tb, scale, st);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(HD, q, kv_pool, out, cq, ck, lists,
                                   T_lanes, H, KV, BS, S, Tb, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Dynamic shared memory, in bytes, of the attention instance for head dim
// HD and dtype (0 float32, 1 bfloat16); 0 for a head dim it does not take.
extern "C" int paged_attention_ragged_smem_bytes(int HD, int dtype) {
  return paged::paged_smem_bytes(HD, dtype);
}
