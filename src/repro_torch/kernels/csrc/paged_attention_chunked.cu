// Chunked paged attention over flat token lanes and split K/V pools, for
// Hopper (sm_90a).  The engine's attn_impl="chunked" step runs it in every
// layer, on the split views of the fused pool.
//
// Replaces the TPU kernel paged_attention_chunked_pallas / _chunked_kernel
// and _chunked_kernel_prefetch (src/repro/kernels/paged_attention/
// kernel.py:293 / :190 / :229) and computes what
// repro_torch.core.attention_api.paged_attention_chunked computes:
//
//   q          (T, H, HD)             float32 or bfloat16, contiguous
//   pool_k/v   (NB, BS, KV, HD)       any strides with a contiguous head dim:
//              the fused pool's views are read in place, never copied
//   block_list, block_req, block_pos (Tb,) int32: flat BlockList keyed by
//              slot; entries with block_req outside [0, B) are padding
//   kv_lens    (B,) int32  valid keys per slot after this step's append
//   token_req, token_pos (T,) int32: each lane's owner (outside [0, B):
//              a padding lane) and its sequence position
//   out        (T, H, HD)
//
// A lane attends to the keys of its owner with key_pos <= token_pos and
// key_pos < kv_lens[owner]; q head h reads kv head h / G.  Lanes with no
// valid key, padding lanes included, write 0.
//
// Design: slot_lists_kernel compacts each slot's pages once per launch
// (and resets the decode tile's arrival counters); lane_tiles_kernel
// counts each owner's lanes in the launch, notes the lane of each owner,
// cuts the lanes into runs of equal owner (padding lanes are one owner) and
// each run into tiles; chunked_attention_kernel runs the decode tile's
// split blocks first, then walks the tiles, one block per (tile, kv head).
// Owners may interleave (lanes A B A): each run is its own tile.
//
// Which tile serves which rows (paged_attention_mma.cuh), the rule the
// ragged and decode kernels follow too: in bfloat16, an owner with two or
// more lanes in the launch (a prefill chunk) runs its tiles on
// paged::attend_tile_mma, 128 query rows per block on the tensor cores
// (wgmma at HD 64/128, mma.sync at 16/32, K/V in bf16 through a two-stage
// cp.async ring), in tiles of min(q_chunk, 128 / G) lanes; an owner of one
// lane (a decode lane, f32 or bf16) runs on the decode tile
// (paged_decode_tile.cuh), its keys cut into splits of split_keys (a launch
// argument), one block per (split, kv head), combined in this launch; a cap
// on the dynamic shared memory (smem_cap, 0: none) below the launch's
// request refuses the launch; everything else runs
// on the SIMT paged::attend_tile in tiles of min(q_chunk, 64 / G) lanes:
// float32 owners of two or more lanes and padding lanes.  A row's result on
// each tile depends only on its owner's page list, its position and the
// owner's key count, never on its tile or the rest of the launch: so this
// launch is bitwise equal to the ragged kernel on the same lanes whatever
// q_chunk is, and on decode lanes to the decode kernel.  An instance holds
// every tile its dtype uses, chosen per block at run time, in one launch:
// 256 threads, dynamic shared memory for the largest tile, two blocks per
// SM at bf16 HD <= 64.
// The reference's prefetch_depth only chooses how the TPU stages pages
// (a DMA ring); this kernel takes no such choice.
// Bound on the H100: the larger of the bytes (the K/V rows the lanes'
// owners hold, q, out and the lists, at 3.35 TB/s) and the operations
// (4*HD per (head, valid key) pair, at 989 TFLOP/s in bf16 or 67 in f32);
// a serving step's bytes bound is the larger.
// Not done yet: TMA copies and warp specialisation in the tensor-core
// tile.

#include "paged_attention_mma.cuh"

namespace {

using paged::kListThreads;
using paged::kRows;
using paged::kThreads;

__device__ __forceinline__ int owner_of(int req, int B) {
  return req >= 0 && req < B ? req : B;
}

// One block of kListThreads threads.  First each owner's lanes in the
// launch into lane_count[0, B), and a lane of each owner into
// owner_lane[0, B) (its only lane for an owner of one lane); then the first
// lane of every tile, in lane order, into tile_start[0, *num_tiles).  Lane
// t opens a tile when it opens a run of equal owner, or when it lies a
// multiple of its owner's tile length past its run's start: tq_mma lanes
// for an owner of lane_count >= kMmaMinLanes, else tq (tq_mma == tq in
// float32).  Tile k spans [tile_start[k], tile_start[k + 1]), the last one
// up to T.
__global__ void lane_tiles_kernel(const int* __restrict__ token_req, int T,
                                  int B, int tq, int tq_mma,
                                  int* __restrict__ lane_count,
                                  int* __restrict__ owner_lane,
                                  int* __restrict__ tile_start,
                                  int* __restrict__ num_tiles) {
  __shared__ int warp_val[kListThreads / 32];
  __shared__ int carry[2];        // last run start so far, tiles so far
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int b = tid; b < B; b += kListThreads) lane_count[b] = 0;
  if (tid == 0) carry[0] = carry[1] = 0;
  __syncthreads();
  for (int base = 0; base < T; base += kListThreads) {
    const int t = base + tid;
    const int own = t < T ? owner_of(token_req[t], B) : B;
    const unsigned peers = __match_any_sync(0xffffffffu, own);
    if (own < B && lane == __ffs(peers) - 1) {
      atomicAdd(&lane_count[own], __popc(peers));
      owner_lane[own] = t;
    }
  }
  __syncthreads();                // the counts are complete and visible
  for (int base = 0; base < T; base += kListThreads) {
    const int t = base + tid;
    const bool in = t < T;
    const int own = in ? owner_of(token_req[t], B) : -1;
    const bool opens = in && (t == 0 || owner_of(token_req[t - 1], B) != own);
    int v = opens ? t : -1;       // inclusive max-scan: this lane's run start
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = max(v, u);
    }
    if (lane == 31) warp_val[warp] = v;
    __syncthreads();
    int run_start = max(v, carry[0]);
    for (int w = 0; w < warp; ++w) run_start = max(run_start, warp_val[w]);
    const int len =
        in && own < B && __ldcg(&lane_count[own]) >= paged::kMmaMinLanes
            ? tq_mma : tq;
    const bool starts = in && (t - run_start) % len == 0;
    const unsigned mask = __ballot_sync(0xffffffffu, starts);
    __syncthreads();              // warp_val and carry[0] are read
    if (lane == 0) warp_val[warp] = __popc(mask);
    __syncthreads();
    int before = 0, chunk = 0;
#pragma unroll
    for (int w = 0; w < kListThreads / 32; ++w) {
      const int c = warp_val[w];
      if (w < warp) before += c;
      chunk += c;
    }
    if (starts)
      tile_start[carry[1] + before + __popc(mask & ((1u << lane) - 1u))] = t;
    __syncthreads();              // carry[1] is read
    if (tid == kListThreads - 1) {
      carry[0] = run_start;
      carry[1] += chunk;
    }
    __syncthreads();
  }
  if (tid == 0) *num_tiles = carry[1];
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads,
                                  paged::PagedKernel<T, HD>::kMinBlocks)
    chunked_attention_kernel(const T* __restrict__ q,
                             const paged::Pool<T> pool, T* __restrict__ out,
                             const int* __restrict__ token_req,
                             const int* __restrict__ token_pos,
                             const int* __restrict__ kv_lens,
                             const int* __restrict__ lane_count,
                             const int* __restrict__ tile_start,
                             const int* __restrict__ num_tiles,
                             const int* __restrict__ list_blk,
                             const int* __restrict__ list_pos,
                             const int* __restrict__ counts,
                             const int* __restrict__ owner_lane,
                             int* __restrict__ counters,
                             float* __restrict__ partials,
                             paged::RowStats stats, int num_lanes,
                             int H, int KV, int B, int BS, int Tb,
                             int split_blocks, int max_splits, int split_keys,
                             float scale) {
  extern __shared__ __align__(16) float smem[];
  const int kvh = blockIdx.y;
  const int G = H / KV;
  if (blockIdx.x < split_blocks) {          // the decode tile's splits
    const auto nsplit = [=](int b) {
      return paged::decode_owner(lane_count[b])
                 ? paged::num_splits(static_cast<long long>(counts[b]) * BS,
                                     split_keys)
                 : 0;
    };
    paged::run_splits(split_blocks, B, nsplit,
                      [&](int b, int split, int w, int h) {
      const int lane = owner_lane[b];
      const size_t list0 = static_cast<size_t>(b) * Tb;
      paged::decode_split<T, HD>(
          q, out, H, G, h, lane, token_pos[lane], kv_lens[b],
          list_blk + list0, list_pos + list0, counts[b], BS, pool, scale,
          split, nsplit(b), split_keys, w, KV, max_splits, partials,
          counters + b * KV + h, reinterpret_cast<unsigned char*>(smem),
          stats);
    });
    return;
  }
  const int row = threadIdx.x >> 2;
  const int ntiles = *num_tiles;
  for (int k = blockIdx.x - split_blocks; k < ntiles;
       k += gridDim.x - split_blocks) {
    const int lane0 = tile_start[k];
    const int n = (k + 1 < ntiles ? tile_start[k + 1] : num_lanes) - lane0;
    const int own = token_req[lane0];
    const bool real = own >= 0 && own < B;
    int kvl = 0, count = 0, lanes = 0;
    if (real) {
      kvl = kv_lens[own];
      count = counts[own];
      lanes = lane_count[own];
    }
    if (real && paged::decode_owner(lanes)) continue;  // split blocks
    const size_t list0 = static_cast<size_t>(real ? own : 0) * Tb;
    if constexpr (paged::PagedKernel<T, HD>::kMma) {
      if (paged::mma_owner<T>(lanes)) {      // uniform across the block
        const auto row_pos = [=](int r) { return token_pos[lane0 + r / G]; };
        // synchronises before it touches shared memory
        paged::attend_tile_mma<HD>(q, out, H, G, kvh, lane0, n * G, row_pos,
                                   kvl, list_blk + list0, list_pos + list0,
                                   count, BS, pool, scale, smem, stats);
        continue;
      }
    }
    const int pos = real && row < n * G ? token_pos[lane0 + row / G] : -1;
    __syncthreads();            // the previous tile's shared reads are done
    paged::attend_tile<T, HD>(q, out, H, G, kvh, lane0, n * G, pos, kvl,
                              list_blk + list0, list_pos + list0, count, BS,
                              pool, scale, smem, stats);
  }
}

// The launch tunables: keys per decode split, and the cap on the dynamic
// shared memory (0: none).
struct Tunables {
  int split_keys;
  int smem_cap;
};

// The scratch buffer: list_blk, list_pos (B * Tb each), counts (B),
// lane_count (B), tile_start (T), num_tiles (1), owner_lane (B), the decode
// tile's arrival counters (B * KV); beside it the decode tile's workspace,
// partials, max_splits x KV records of partial_floats(G, HD) floats.
template <typename T, int HD>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   void* out, const int* token_req, const int* token_pos,
                   const int* kv_lens, int* scratch, float* partials,
                   paged::RowStats stats, int max_splits, Tunables tun,
                   int T_lanes, int H, int KV,
                   int B, int BS, int Tb, int tq, long long sb, long long sr,
                   long long sh, float scale, cudaStream_t stream) {
  static bool configured = false;
  const cudaError_t err = paged::configure<T, HD>(
      chunked_attention_kernel<T, HD>, &configured);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = paged::PagedKernel<T, HD>::kSmem;
  if (tun.smem_cap > 0 && smem > static_cast<size_t>(tun.smem_cap))
    return cudaErrorInvalidValue;
  const int* list_blk = scratch;
  const int* list_pos = list_blk + static_cast<size_t>(B) * Tb;
  const int* counts = list_pos + static_cast<size_t>(B) * Tb;
  const int* lane_count = counts + B;
  const int* tile_start = lane_count + B;
  const int* num_tiles = tile_start + T_lanes;
  const int* owner_lane = num_tiles + 1;
  int* counters = scratch + (2 * static_cast<size_t>(B) * Tb + 3 * B +
                             T_lanes + 1);
  const paged::Pool<T> pool{static_cast<const T*>(pool_k),
                            static_cast<const T*>(pool_v), sb, sr, sh};
  // The split blocks, which loop when there are more splits, then enough
  // tile blocks for one pass over the tiles when the lanes hold at most B +
  // 1 runs (the engine's renders; a tensor-core owner's tiles are longer);
  // more runs loop.
  const int tiles = (T_lanes + tq - 1) / tq + B + 1;
  const int split_blocks =
      paged::split_grid_x(max_splits, KV, paged::kSplitGridBlocks);
  const dim3 grid(split_blocks + min(tiles, T_lanes), KV);
  chunked_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), pool, static_cast<T*>(out), token_req,
      token_pos, kv_lens, lane_count, tile_start, num_tiles, list_blk,
      list_pos, counts, owner_lane, counters, partials, stats, T_lanes, H,
      KV, B,
      BS, Tb, split_blocks, max_splits, tun.split_keys, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int HD, const void* q, const void* pool_k,
                      const void* pool_v, void* out, const int* token_req,
                      const int* token_pos, const int* kv_lens, int* scratch,
                      float* partials, paged::RowStats stats, int max_splits,
                      Tunables tun,
                      int T_lanes, int H, int KV, int B, int BS, int Tb,
                      int tq, long long sb, long long sr, long long sh,
                      float scale, cudaStream_t stream) {
  switch (HD) {
    case 16:
      return launch<T, 16>(q, pool_k, pool_v, out, token_req, token_pos,
                           kv_lens, scratch, partials, stats, max_splits, tun,
                           T_lanes, H, KV, B, BS, Tb, tq, sb, sr, sh, scale,
                           stream);
    case 32:
      return launch<T, 32>(q, pool_k, pool_v, out, token_req, token_pos,
                           kv_lens, scratch, partials, stats, max_splits, tun,
                           T_lanes, H, KV, B, BS, Tb, tq, sb, sr, sh, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, pool_k, pool_v, out, token_req, token_pos,
                           kv_lens, scratch, partials, stats, max_splits, tun,
                           T_lanes, H, KV, B, BS, Tb, tq, sb, sr, sh, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, pool_k, pool_v, out, token_req, token_pos,
                            kv_lens, scratch, partials, stats, max_splits, tun,
                            T_lanes, H, KV, B, BS, Tb, tq, sb, sr, sh, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  stats: nullptr, or 2 * T * H
// float32 that receive each (lane, q head) row's softmax max m, then its
// sum l (paged::RowStats; the output is the same either way).  scratch
// holds 2 * B * Tb + 3 * B + T + 1 + B * KV int32; partials max_splits x KV x
// partial_floats(H / KV, HD) floats, max_splits >= 1 (the decode tile's
// splits over all owners of one lane: at most ceil(Tb * BS / split_keys) +
// B).  q, out, pool_k, pool_v and partials must be 16-byte aligned, and sb,
// sr, sh (the pools' strides in elements over blocks, rows and kv heads)
// multiples of 16 bytes.  split_keys: whole 64-key stages, at most
// kMaxSplitKeys; smem_cap: 0 (none) or the cap a launch must fit under.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launches (0 = ok).
extern "C" int paged_attention_chunked(
    const void* q, const void* pool_k, const void* pool_v, void* out,
    void* stats,
    const void* block_list, const void* block_req, const void* block_pos,
    const void* kv_lens, const void* token_req, const void* token_pos,
    void* scratch, void* partials, int T_lanes, int H, int KV, int HD,
    int NB, int BS, int Tb, int B, int q_chunk, int max_splits,
    int split_keys, int smem_cap, long long sb, long long sr, long long sh,
    int dtype, float scale, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kRows || BS < 1 ||
      NB < 1 || q_chunk < 1 || T_lanes < 0 || Tb < 0 || max_splits < 1 ||
      !paged::valid_split(split_keys) || smem_cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* ints = static_cast<int*>(scratch);
  int* list_blk = ints;
  int* list_pos = list_blk + static_cast<size_t>(B) * Tb;
  int* counts = list_pos + static_cast<size_t>(B) * Tb;
  int* lane_count = counts + B;
  int* tile_start = lane_count + B;
  int* owner_lane = tile_start + T_lanes + 1;
  int* counters = owner_lane + B;
  const int* kvl = static_cast<const int*>(kv_lens);
  const int* treq = static_cast<const int*>(token_req);
  paged::slot_lists_kernel<<<B, kListThreads, 0, st>>>(
      static_cast<const int*>(block_list), static_cast<const int*>(block_req),
      static_cast<const int*>(block_pos), Tb, kvl, BS, NB, KV, list_blk,
      list_pos, counts, counters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || T_lanes == 0) return static_cast<int>(err);
  const int G = H / KV;
  const int tq = min(q_chunk, kRows / G);
  const int tq_mma = dtype == 1 ? min(q_chunk, paged::kMmaRows / G) : tq;
  lane_tiles_kernel<<<1, kListThreads, 0, st>>>(treq, T_lanes, B, tq, tq_mma,
                                                lane_count, owner_lane,
                                                tile_start,
                                                tile_start + T_lanes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* tpos = static_cast<const int*>(token_pos);
  float* part = static_cast<float*>(partials);
  const Tunables tun{split_keys, smem_cap};
  float* m_out = static_cast<float*>(stats);
  const paged::RowStats rs{m_out, m_out == nullptr ? nullptr
                                                   : m_out + static_cast<size_t>(T_lanes) * H};
  if (dtype == 0)
    err = launch_hd<float>(HD, q, pool_k, pool_v, out, treq, tpos, kvl, ints,
                           part, rs, max_splits, tun, T_lanes, H, KV, B, BS,
                           Tb, tq, sb, sr, sh, scale, st);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(HD, q, pool_k, pool_v, out, treq, tpos,
                                   kvl, ints, part, rs, max_splits, tun,
                                   T_lanes, H, KV, B, BS, Tb, tq, sb, sr, sh,
                                   scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Dynamic shared memory, in bytes, of the attention instance for head dim
// HD and dtype (0 float32, 1 bfloat16); 0 for a head dim it does not take.
extern "C" int paged_attention_chunked_smem_bytes(int HD, int dtype) {
  return paged::paged_smem_bytes(HD, dtype);
}
