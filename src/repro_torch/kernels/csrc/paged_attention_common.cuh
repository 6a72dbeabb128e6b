// Device code shared by the port's three paged-attention kernels for
// Hopper (sm_90a): paged_attention_ragged.cu, paged_attention_chunked.cu
// and paged_attention_decode.cu.
//
// Each kernel enumerates its own query tiles (ragged: from cu_q_lens;
// chunked: runs of equal token_req; decode: one request per tile) and then
// hands the tile to attend_tile below, which holds every query row's
// arithmetic.  A row's result depends only on its owner's page list, its
// position and the owner's key count, never on the other rows of its tile,
// so a lane that sees the same keys gets bitwise the same output from all
// three kernels.
//
// Bound on the H100: the bytes of the K/V rows the owners hold, plus q and
// out, at 3.35 TB/s.  What the shared design does about it:
//   * compact_entries scans the BlockList ONCE per owner and keeps the
//     (pool block, position) of that owner's entries, in BlockList order,
//     that hold a key below its length.  The BlockList is as long as the
//     pool and mostly padding, so attention blocks never scan it and read
//     only their own pages.  Skipping an entry is exact, since a fully
//     masked update leaves the running max, sum and accumulator unchanged.
//   * attend_tile serves one (owner, query tile, kv head): the G query
//     heads of the kv head ride in the tile (rows = lanes x G <= 64), so
//     every K/V row read serves all of them.
//   * keys stream through shared memory 64 rows at a time, gathered across
//     pages with 16-byte loads through the pool's strides, so the fused
//     pool and its split K/V views are read in place, never copied.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace paged {

constexpr int kThreads = 256;   // 64 rows x 4 threads per row
constexpr int kRows = 64;       // query rows (lane, head) per block
constexpr int kKeys = 64;       // key rows per shared-memory tile
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

// A paged K/V pool seen through strides, in elements: the K row of pool
// block b, offset o, kv head h starts at k + b*sb + o*sr + h*sh, its V row
// at the same offset from v, and the head dim is contiguous.  The fused
// pool (NB, BS, 2*KV, HD) is k = pool, v = pool + HD, sh = 2*HD; split
// pools (NB, BS, KV, HD) have sh = HD.
template <typename T>
struct Pool {
  const T* k;
  const T* v;
  long long sb, sr, sh;
};

// Block-wide, kListThreads threads: the pages (pool block, block position)
// of the BlockList entries with block_req == slot that hold a key below
// kvl, in BlockList order, into list_blk/list_pos.  Returns their count, in
// every thread.  Pool blocks are clamped into [0, NB).  Each thread takes
// kListPer neighbouring entries a pass, their loads in flight together.
constexpr int kListPer = 4;
__device__ __forceinline__ int compact_entries(
    const int* __restrict__ block_list, const int* __restrict__ block_req,
    const int* __restrict__ block_pos, int Tb, int slot, int kvl, int BS,
    int NB, int* __restrict__ list_blk, int* __restrict__ list_pos) {
  __shared__ int warp_counts[kListThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int running = 0;
  for (int base = 0; base < Tb; base += kListThreads * kListPer) {
    const int e0 = base + threadIdx.x * kListPer;
    int req[kListPer], pos[kListPer], n = 0;
#pragma unroll
    for (int i = 0; i < kListPer; ++i) {
      req[i] = -1;
      pos[i] = 0;
      if (e0 + i < Tb) {
        req[i] = block_req[e0 + i];
        pos[i] = block_pos[e0 + i];
      }
    }
    bool hit[kListPer];
#pragma unroll
    for (int i = 0; i < kListPer; ++i) {
      hit[i] = req[i] == slot && static_cast<long long>(pos[i]) * BS < kvl;
      n += hit[i];
    }
    int incl = n;                   // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_counts[warp] = incl;
    __syncthreads();
    int at = running + incl - n, chunk = 0;
#pragma unroll
    for (int w = 0; w < kListThreads / 32; ++w) {
      const int c = warp_counts[w];
      if (w < warp) at += c;
      chunk += c;
    }
#pragma unroll
    for (int i = 0; i < kListPer; ++i) {
      if (hit[i]) {
        list_blk[at] = min(max(block_list[e0 + i], 0), NB - 1);
        list_pos[at] = pos[i];
        ++at;
      }
    }
    running += chunk;
    __syncthreads();
  }
  return running;
}

// Page lists keyed by slot (chunked and decode): block b compacts slot b's
// entries below kv_lens[b] into list_blk/list_pos[b * Tb + c],
// c < counts[b], and resets slot b's arrival counters of the decode tile
// (paged_decode_tile.cuh), counters[b * KV, (b + 1) * KV), to 0.
__global__ void slot_lists_kernel(const int* __restrict__ block_list,
                                  const int* __restrict__ block_req,
                                  const int* __restrict__ block_pos, int Tb,
                                  const int* __restrict__ kv_lens, int BS,
                                  int NB, int KV, int* __restrict__ list_blk,
                                  int* __restrict__ list_pos,
                                  int* __restrict__ counts,
                                  int* __restrict__ counters) {
  const int b = blockIdx.x;
  for (int h = threadIdx.x; h < KV; h += kListThreads)
    counters[b * KV + h] = 0;
  const size_t at = static_cast<size_t>(b) * Tb;
  const int n = compact_entries(block_list, block_req, block_pos, Tb, b,
                                kv_lens[b], BS, NB, list_blk + at,
                                list_pos + at);
  if (threadIdx.x == 0) counts[b] = n;
}

template <int HD>
constexpr size_t smem_floats() {
  return kRows * (HD + 1) + kKeys * (HD + 1) + kKeys * HD +
         kRows * (kKeys + 1);
}

// One query tile, kThreads threads, smem_floats<HD>() floats of dynamic
// shared memory.  Rows r < nrows are (lane lane0 + r / G, q head
// kvh * G + r % G) of q (lanes, H, HD), all of one owner whose pages are
// list_blk/list_pos[0, count) and which holds kvl keys.  This thread's row
// is threadIdx.x / 4, at sequence position row_pos: it attends to key
// positions kp < kvl with kp <= row_pos.  Softmax and sums run in f32 with
// the -1e30 sentinel; rows with no valid key write 0.  The caller
// synchronises before reusing shared memory for another tile.
template <typename T, int HD>
__device__ __forceinline__ void attend_tile(
    const T* __restrict__ q, T* __restrict__ out, int H, int G, int kvh,
    int lane0, int nrows, int row_pos, int kvl,
    const int* __restrict__ list_blk, const int* __restrict__ list_pos,
    int count, int BS, const Pool<T>& pool, float scale, float* smem) {
  constexpr int VEC = Vec<T>::kN;
  constexpr int VPR = HD / VEC;            // vectors per K or V row
  float* sQ = smem;                        // [kRows][HD + 1]
  float* sK = sQ + kRows * (HD + 1);       // [kKeys][HD + 1]
  float* sV = sK + kKeys * (HD + 1);       // [kKeys][HD]
  float* sP = sV + kKeys * HD;             // [kRows][kKeys + 1]
  __shared__ int sKeyPos[kKeys];
  __shared__ long long sKeyOff[kKeys];     // pool offset of each key row

  const int tid = threadIdx.x;
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
  const bool row_ok = row < nrows;
  const int nkeys = count * BS;
  const long long head = kvh * pool.sh;

  float m = kNegInf, l = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < nkeys; k0 += kKeys) {
    __syncthreads();            // the previous tile's reads are done
    if (tid < kKeys) {
      const int kr = k0 + tid;
      int kp = INT_MAX;
      long long off = 0;
      if (kr < nkeys) {
        const int c = kr / BS, o = kr - (kr / BS) * BS;
        kp = list_pos[c] * BS + o;
        off = list_blk[c] * pool.sb + o * pool.sr + head;
      }
      sKeyPos[tid] = kp;
      sKeyOff[tid] = off;
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < (kKeys * VPR + kThreads - 1) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      if (idx < kKeys * VPR) {
        const int kk = idx / VPR, d = (idx % VPR) * VEC;
        const long long off = sKeyOff[kk] + d;
        Vec<T>::load(pool.k + off, sK + kk * (HD + 1) + d);
        Vec<T>::load(pool.v + off, sV + kk * HD + d);
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
      const bool ok = row_ok && kp < kvl && kp <= row_pos;
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

// Opts a kernel into smem bytes of dynamic shared memory, once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool* configured) {
  if (*configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) *configured = true;
  return err;
}

}  // namespace paged
