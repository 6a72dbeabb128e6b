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
// Bound on the H100: the bytes of the KV pages the step's sequences hold,
// plus q and out, at 3.35 TB/s; the arithmetic (4*HD operations per
// (head, valid key) pair) is far below the card's rate.  What the design
// does about it:
//   * entry_lists_kernel scans the BlockList ONCE per sequence and keeps
//     the (pool block, position) of that sequence's entries, in BlockList
//     order, that hold a key below kvl.  The BlockList is as long as the
//     pool and mostly padding, so the attention blocks never scan it and
//     read only their own pages.  Skipping an entry is exact, since a fully
//     masked update leaves the running max, sum and accumulator unchanged.
//   * ragged_attention_kernel runs one block per (sequence, query tile of
//     that sequence's lanes, kv head).  The G query heads of the kv head
//     ride in the same tile (rows = lanes x G <= 64), so every K/V row read
//     from the pool serves all of them; each KV byte of a sequence is read
//     once per query tile.
//   * keys stream through shared memory 64 rows at a time, gathered across
//     pages with 16-byte loads, so BS = 16 pages fill a tile and BS = 128
//     pages split into two.  A warp whose rows are all past the tile's
//     lanes (a decode tile has G rows) skips the arithmetic.
// Not done yet: cp.async/TMA double buffering, wgmma/mma for the two
// products (the scalar products are bound by shared-memory reads), and
// splitting a long sequence's keys across blocks for decode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;   // 64 rows x 4 threads per row
constexpr int kRows = 64;       // query rows (lane, head) per block
constexpr int kKeys = 64;       // key rows per shared-memory tile
constexpr int kMaxSeqs = 1024;  // S limit (cu_q is staged in shared memory)
constexpr int kListThreads = 1024;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// The reference casts softmax weights to the KV type before the PV product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// 16-byte vector loads: VEC elements of T, widened to float in shared memory.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* src,
                                              float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

// For sequence j, the pages (pool block, block position) of its BlockList
// entries that hold a key below kvl_j, in BlockList order:
// list_blk/list_pos[j * Tb + c], c < counts[j].
__global__ void entry_lists_kernel(const int* __restrict__ block_list,
                                   const int* __restrict__ block_req,
                                   const int* __restrict__ block_pos, int Tb,
                                   const int* __restrict__ cu_q,
                                   const int* __restrict__ cu_kv,
                                   const int* __restrict__ seq_slot, int S,
                                   int BS, int NB, int* __restrict__ list_blk,
                                   int* __restrict__ list_pos,
                                   int* __restrict__ counts) {
  __shared__ int warp_counts[kListThreads / 32];
  const int j = blockIdx.x;
  const int slot = seq_slot[j];
  const int nq = cu_q[j + 1] - cu_q[j];
  const int kvl = cu_kv[j + 1] - cu_kv[j];
  if (slot < 0 || slot >= S || nq <= 0) {  // uniform across the block
    if (threadIdx.x == 0) counts[j] = 0;
    return;
  }
  const size_t base_out = static_cast<size_t>(j) * Tb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int running = 0;
  for (int base = 0; base < Tb; base += kListThreads) {
    const int e = base + threadIdx.x;
    const bool hit = e < Tb && block_req[e] == slot &&
                     static_cast<long long>(block_pos[e]) * BS < kvl;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_counts[warp] = __popc(mask);
    __syncthreads();
    int before = 0, chunk = 0;
#pragma unroll
    for (int w = 0; w < kListThreads / 32; ++w) {
      const int c = warp_counts[w];
      if (w < warp) before += c;
      chunk += c;
    }
    if (hit) {
      const size_t at =
          base_out + running + before + __popc(mask & ((1u << lane) - 1u));
      list_blk[at] = min(max(block_list[e], 0), NB - 1);
      list_pos[at] = block_pos[e];
    }
    running += chunk;
    __syncthreads();
  }
  if (threadIdx.x == 0) counts[j] = running;
}

template <int HD>
constexpr size_t smem_floats() {
  return kRows * (HD + 1) + kKeys * (HD + 1) + kKeys * HD +
         kRows * (kKeys + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) ragged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kv_pool,
    T* __restrict__ out, const int* __restrict__ cu_q,
    const int* __restrict__ cu_kv, const int* __restrict__ list_blk,
    const int* __restrict__ list_pos, const int* __restrict__ counts,
    int num_lanes, int H, int KV, int BS, int S, int Tb, int tq,
    float scale) {
  constexpr int VEC = Vec<T>::kN;
  constexpr int VPR = HD / VEC;              // vectors per K or V row
  extern __shared__ float smem[];
  float* sQ = smem;                        // [kRows][HD + 1]
  float* sK = sQ + kRows * (HD + 1);       // [kKeys][HD + 1]
  float* sV = sK + kKeys * (HD + 1);       // [kKeys][HD]
  float* sP = sV + kKeys * HD;             // [kRows][kKeys + 1]
  __shared__ int sCu[kMaxSeqs + 1];
  __shared__ int sKeyPos[kKeys];
  __shared__ long long sKeyRow[kKeys];     // fused-pool row of each key
  __shared__ int sInfo[3];

  const int tid = threadIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  for (int i = tid; i <= S; i += kThreads) sCu[i] = cu_q[i];
  __syncthreads();

  // Which tile is this block?  Sequences in order, each cut into
  // ceil(nq / tq) tiles, then the padding lanes past cu_q[S].
  if (tid == 0) {
    int b = blockIdx.x, seq = -2, lane0 = 0, n = 0;
    for (int j = 0; j < S; ++j) {
      const int nq = sCu[j + 1] - sCu[j];
      const int nt = nq > 0 ? (nq + tq - 1) / tq : 0;
      if (b < nt) {
        seq = j;
        lane0 = sCu[j] + b * tq;
        n = min(tq, sCu[j + 1] - lane0);
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

#pragma unroll
  for (int it = 0; it < (kRows * VPR + kThreads - 1) / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    if (idx < kRows * VPR) {
      const int r = idx / VPR, d = (idx % VPR) * VEC;
      float* dst = sQ + r * (HD + 1) + d;
      if (r < nrows) {
        Vec<T>::load(q + (static_cast<size_t>(lane0 + r / G) * H + kvh * G +
                          r % G) * HD + d, dst);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) dst[i] = 0.f;
      }
    }
  }

  const int row = tid >> 2;   // this thread's query row
  const int part = tid & 3;   // its quarter of the keys and of the dims
  // rows 8w..8w+7 live in warp w: a warp with no query row skips the math
  const bool warp_busy = (tid >> 5) * 8 < nrows;
  int kvl = 0, pos = -1, nkeys = 0;
  if (seq >= 0) {
    const int nq = sCu[seq + 1] - sCu[seq];
    kvl = cu_kv[seq + 1] - cu_kv[seq];
    pos = kvl - nq + (lane0 - sCu[seq]) + row / G;
    nkeys = counts[seq] * BS;
  }
  const bool row_ok = row < nrows;
  const size_t list0 = static_cast<size_t>(seq < 0 ? 0 : seq) * Tb;
  const int fused = 2 * KV;

  float m = kNegInf, l = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < nkeys; k0 += kKeys) {
    __syncthreads();            // the previous tile's reads are done
    if (tid < kKeys) {
      const int kr = k0 + tid;
      int kp = INT_MAX;
      long long kvrow = 0;
      if (kr < nkeys) {
        const int c = kr / BS, off = kr - (kr / BS) * BS;
        kp = list_pos[list0 + c] * BS + off;
        kvrow = static_cast<long long>(list_blk[list0 + c]) * BS + off;
      }
      sKeyPos[tid] = kp;
      sKeyRow[tid] = kvrow;
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < (kKeys * VPR + kThreads - 1) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      if (idx < kKeys * VPR) {
        const int kk = idx / VPR, d = (idx % VPR) * VEC;
        const T* src = kv_pool + (sKeyRow[kk] * fused + 2 * kvh) * HD + d;
        Vec<T>::load(src, sK + kk * (HD + 1) + d);
        Vec<T>::load(src + HD, sV + kk * HD + d);
      }
    }
    __syncthreads();
    if (!warp_busy) continue;

    float s[kKeys / 4];
    unsigned valid = 0;
    float tmax = kNegInf;
#pragma unroll
    for (int i = 0; i < kKeys / 4; ++i) {
      const int kk = part + 4 * i;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d)
        dot += sQ[row * (HD + 1) + d] * sK[kk * (HD + 1) + d];
      const int kp = sKeyPos[kk];
      const bool ok = row_ok && kp < kvl && kp <= pos;
      s[i] = ok ? dot * scale : kNegInf;
      valid |= (ok ? 1u : 0u) << i;
      tmax = fmaxf(tmax, s[i]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys / 4; ++i) {
      const float p = (valid >> i) & 1u ? expf(s[i] - m_new) : 0.f;
      psum += p;
      sP[row * (kKeys + 1) + part + 4 * i] = round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();               // a row's P is written and read in one warp
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) acc[i] *= corr;
#pragma unroll 8
    for (int kk = 0; kk < kKeys; ++kk) {
      const float p = sP[row * (kKeys + 1) + kk];
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) acc[i] += p * sV[kk * HD + part + 4 * i];
    }
  }

  if (row_ok) {
    const float den = fmaxf(l, 1e-30f);
    T* dst = out + (static_cast<size_t>(lane0 + row / G) * H + kvh * G +
                    row % G) * HD;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i)
      dst[part + 4 * i] = from_f32<T>(acc[i] / den);
  }
}

// The per-sequence page lists share one scratch buffer of
// 2 * S * Tb + S int32: list_blk, then list_pos, then counts.
struct Lists {
  const int* blk;
  const int* pos;
  const int* counts;
};

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kv_pool, void* out,
                   const int* cu_q, const int* cu_kv, Lists lists,
                   int T_lanes, int H, int KV, int BS, int S, int Tb,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<HD>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int G = H / KV;
  const int tq = kRows / G;
  const dim3 grid((T_lanes + tq - 1) / tq + S + 1, KV);
  ragged_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv_pool),
      static_cast<T*>(out), cu_q, cu_kv, lists.blk, lists.pos, lists.counts,
      T_lanes, H, KV, BS, S, Tb, tq, scale);
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

// Plain C entry point, bound with ctypes.  scratch holds 2 * S * Tb + S
// int32 (see Lists).  q, kv_pool and out must be 16-byte aligned.  dtype:
// 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launches (0 = ok).
extern "C" int paged_attention_ragged(
    const void* q, const void* kv_pool, void* out, const void* block_list,
    const void* block_req, const void* block_pos, const void* cu_q_lens,
    const void* cu_kv_lens, const void* seq_slot, void* scratch, int T_lanes,
    int H, int KV, int HD, int NB, int BS, int Tb, int S, int dtype,
    float scale, void* stream) {
  if (S < 1 || S > kMaxSeqs || KV < 1 || H % KV != 0 || H / KV > kRows ||
      BS < 1 || NB < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* list_blk = static_cast<int*>(scratch);
  int* list_pos = list_blk + static_cast<size_t>(S) * Tb;
  int* counts = list_pos + static_cast<size_t>(S) * Tb;
  const int* cq = static_cast<const int*>(cu_q_lens);
  const int* ck = static_cast<const int*>(cu_kv_lens);
  entry_lists_kernel<<<S, kListThreads, 0, st>>>(
      static_cast<const int*>(block_list), static_cast<const int*>(block_req),
      static_cast<const int*>(block_pos), Tb, cq, ck,
      static_cast<const int*>(seq_slot), S, BS, NB, list_blk, list_pos,
      counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T_lanes == 0) return 0;
  const Lists lists{list_blk, list_pos, counts};
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
