// BatchedTable embedding bag (the paper's §4.1 FBGEMM case study) for
// Hopper (sm_90a): one launch pools every (table, bag) pair.
//
// Replaces the TPU kernel batched_embedding_pallas / _embed_kernel
// (src/repro/kernels/batched_embedding/kernel.py:41 / :27) and computes
// what repro_torch.core.embedding_api.batched_table_lookup computes:
//
//   table      (R, D)            float32 or bfloat16, rows of all tables
//                                concatenated
//   ids        (num_bags * L,)   int32 global row ids (local id + offset
//                                of its table), bag b owns [b*L, (b+1)*L)
//   out        (num_bags, D)     out[b] = sum_l table[ids[b*L + l]]
//
// Sums run in float32 and are written in the table's dtype.  An id in
// [-R, 0) reads row id + R; a bag holding an id outside [-R, R) is written
// as NaN, and that id is never read (jnp.take's fill mode, without a sync).
//
// The row window, batched_embedding_window (a rank's part of a row-sharded
// table, for repro_torch.core.embedding_api.batched_table_lookup_sharded,
// the port of the reference's batched_table_lookup_sharded,
// src/repro/core/embedding_api.py:58): the table holds global rows
// [lo, hi) only, at local row id - lo, and an id outside the window adds
// nothing (the rank that owns it adds it; a SUM over the ranks combines).
// No id wraps and no bag is NaN there, as in the reference's sharded
// lookup.  The same instances with kWindow false are batched_embedding.
//
// Bound on the H100: the bytes of the rows gathered (plus the ids and the
// output) at 3.35 TB/s; one add per element read is far below the card's
// rate.  The rows are picked by data, so the gather is latency-bound unless
// many rows are in flight at once.  What the design does about it:
//   * a group of G lanes (G a power of two <= 32, G >= the row's 16-byte
//     vectors when the row fits in 32) serves one bag; each lane owns
//     NV 16-byte vectors of the row, so a row is read with full 16-byte
//     loads by neighbouring lanes on neighbouring addresses;
//   * the group loads G of the bag's ids at once, coalesced, and
//     broadcasts them with __shfl_sync;
//   * kUnroll rows are loaded into registers before the first is summed,
//     so every lane keeps kUnroll x NV loads in flight; with 256-thread
//     blocks and several blocks per SM, rows of many bags and tables are
//     fetched together (the paper's chip-wide memory-level parallelism);
//   * every row offset is id * V computed in 64 bits: RM2's table is
//     20 M x 64 x 4 B = 5.1 GB, past 2^31.
// Not done yet: cp.async/TMA staging, L2 persistence for hot rows, load
// cache policies, fusing the table-offset add into the kernel.
//
// The backward, batched_embedding_backward (the gradient of that function;
// the TPU side has no kernel for it: JAX differentiates the reference
// function batched_table_lookup, src/repro/core/embedding_api.py:45, into
// a scatter-add) computes, into a dense float32 (R, D) gradient that the
// wrapper zeroes first,
//
//   grad_table[g] += grad_out[b]   for every id g of bag b,
//
// with the forward's id rule: an id in [-R, 0) adds into row id + R, an id
// outside [-R, R) adds nothing (what jax.grad of the reference gives).
// float32 only (DLRM's parameters are float32 in both packages).  Bound:
// grad_out, the ids and a read and a write of each distinct row touched at
// 3.35 TB/s; the adds run as red.global.add.f32 in the L2.  Design: one
// group of G lanes per bag, as the forward, reads grad_out[b] once into
// registers with 16-byte loads, loads G ids at once and broadcasts them,
// and adds the row into each of the bag's L rows with atomicAdd (the
// result is unused, so it compiles to a reduction); row offsets are 64-bit.
// Float atomics land in no fixed order, so the last bits of a row that
// several bags touch change from run to run: compare with a tolerance,
// never bitwise.  Not done yet: a sorted, deterministic segment reduction,
// red.global.add.v4.f32, staging.
//
// The backward's row window, batched_embedding_backward_window (the
// gradient of batched_embedding_window, for a rank's part of a row-sharded
// table in training): the same instances with kWindow on, into a
// (hi - lo, D) gradient: an id in [lo, hi) adds into row id - lo, any other
// id adds nothing (no wrap, as the window's forward).  With kWindow off a
// launch computes what it did before the window.  Bound: as the backward's,
// over the rows of the window the bags touch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // rows in flight per lane
constexpr int kMaxVectors = 128;  // 16-byte vectors per row: 2048 bytes

template <typename T>
struct Elems {
  static constexpr int kPerVec = 16 / sizeof(T);
};

__device__ __forceinline__ void accumulate(float (&acc)[4], uint4 v, float) {
  acc[0] += __uint_as_float(v.x);
  acc[1] += __uint_as_float(v.y);
  acc[2] += __uint_as_float(v.z);
  acc[3] += __uint_as_float(v.w);
}

// A 32-bit word holds two bf16 values, element 2i in the low half; a bf16
// value is the top half of the float32 with the same bits.
__device__ __forceinline__ void accumulate(float (&acc)[8], uint4 v,
                                           __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] += __uint_as_float(w[i] << 16);
    acc[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&acc)[4], float) {
  return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                    __float_as_uint(acc[2]), __float_as_uint(acc[3]));
}

__device__ __forceinline__ uint4 pack(const float (&acc)[8], __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i]));
    const uint32_t hi =
        __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One group of G lanes per bag, kThreads / G bags per block.  V is the
// number of 16-byte vectors of a row; lane j of a group owns vectors
// j, j + G, ..., j + (NV - 1) * G that are below V.
template <typename T, int G, int NV, bool kWindow>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const uint4* __restrict__ table,
                         const int* __restrict__ ids, uint4* __restrict__ out,
                         long long num_bags, int L, int V, long long R,
                         long long lo, long long hi) {
  constexpr int kE = Elems<T>::kPerVec;
  const int lane = threadIdx.x % G;
  const long long bag =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const bool live = bag < num_bags;
  const int* bag_ids = ids + (live ? bag * L : 0);

  float acc[NV][kE];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[j][e] = 0.f;
  bool bad = false;

  // L is the same for every bag, so every lane of the warp runs the same
  // iterations and the full-mask shuffles below are safe; lanes of a bag
  // past num_bags load nothing.
  for (int l0 = 0; l0 < L; l0 += G) {
    const int n = min(G, L - l0);
    const int mine = (live && lane < n) ? __ldg(bag_ids + l0 + lane) : 0;
    for (int k = 0; k < n; k += kUnroll) {
      uint4 buf[kUnroll][NV];
      bool use[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int id = __shfl_sync(0xffffffffu, mine, k + u, G);
        use[u] = live && k + u < n;
        long long g;
        bool ok;
        if constexpr (kWindow) {               // rows [lo, hi) only
          g = static_cast<long long>(id) - lo;
          ok = use[u] && id >= lo && id < hi;
        } else {
          g = id < 0 ? static_cast<long long>(id) + R
                     : static_cast<long long>(id);
          ok = use[u] && g >= 0 && g < R;
          bad |= use[u] && !ok;
        }
        const uint4* row = table + (ok ? g : 0) * V;    // 64-bit offset
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int v = lane + j * G;
          buf[u][j] = (ok && v < V) ? __ldg(row + v) : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!use[u]) continue;   // a window's miss loaded zeros: adds 0
#pragma unroll
        for (int j = 0; j < NV; ++j) accumulate(acc[j], buf[u][j], T());
      }
    }
  }
  if (!live) return;
  if (bad) {
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[j][e] = __int_as_float(0x7fc00000);
  }
  uint4* dst = out + bag * V;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lane + j * G;
    if (v < V) dst[v] = pack(acc[j], T());
  }
}

template <typename T, int G, int NV, bool kWindow>
cudaError_t launch(const void* table, const void* ids, void* out,
                   long long num_bags, int L, int V, long long R,
                   long long lo, long long hi, cudaStream_t st) {
  constexpr int kBags = kThreads / G;
  const long long blocks = (num_bags + kBags - 1) / kBags;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  embedding_bag_kernel<T, G, NV, kWindow>
      <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          static_cast<const uint4*>(table), static_cast<const int*>(ids),
          static_cast<uint4*>(out), num_bags, L, V, R, lo, hi);
  return cudaGetLastError();
}

template <typename T, bool kWindow>
cudaError_t launch_width(const void* table, const void* ids, void* out,
                         long long num_bags, int L, int V, long long R,
                         long long lo, long long hi, cudaStream_t st) {
#define REPRO_EMB_LAUNCH(G, NV)                                         \
  launch<T, G, NV, kWindow>(table, ids, out, num_bags, L, V, R, lo, hi, \
                            st)
  if (V <= 1) return REPRO_EMB_LAUNCH(1, 1);
  if (V <= 2) return REPRO_EMB_LAUNCH(2, 1);
  if (V <= 4) return REPRO_EMB_LAUNCH(4, 1);
  if (V <= 8) return REPRO_EMB_LAUNCH(8, 1);
  if (V <= 16) return REPRO_EMB_LAUNCH(16, 1);
  if (V <= 32) return REPRO_EMB_LAUNCH(32, 1);
  if (V <= 64) return REPRO_EMB_LAUNCH(32, 2);
  return REPRO_EMB_LAUNCH(32, 4);
#undef REPRO_EMB_LAUNCH
}

// The backward: one group of G lanes per bag, as the forward; lane j of a
// group holds vectors j, j + G, ... of grad_out[b] and adds them into the
// rows of the bag's ids.  kWindow: grad_table holds rows [lo, hi) (R is
// hi - lo), an id adds into row id - lo when it lies in the window.
template <int G, int NV, bool kWindow>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_backward_kernel(const float4* __restrict__ grad_out,
                                  const int* __restrict__ ids,
                                  float* __restrict__ grad_table,
                                  long long num_bags, int L, int V,
                                  long long R, long long lo) {
  const int lane = threadIdx.x % G;
  const long long bag =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const bool live = bag < num_bags;
  const int* bag_ids = ids + (live ? bag * L : 0);

  float4 g[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lane + j * G;
    g[j] = (live && v < V) ? __ldg(grad_out + bag * V + v)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // As in the forward, every lane of the warp runs the same iterations, so
  // the full-mask shuffles are safe; lanes of a bag past num_bags add
  // nothing.
  for (int l0 = 0; l0 < L; l0 += G) {
    const int n = min(G, L - l0);
    const int mine = (live && lane < n) ? __ldg(bag_ids + l0 + lane) : 0;
    for (int k = 0; k < n; ++k) {
      const int id = __shfl_sync(0xffffffffu, mine, k, G);
      long long row;
      if (kWindow) {
        row = static_cast<long long>(id) - lo;
      } else {
        row = id < 0 ? static_cast<long long>(id) + R
                     : static_cast<long long>(id);
      }
      if (!live || row < 0 || row >= R) continue;
      float* dst = grad_table + row * (4LL * V);        // 64-bit offset
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int v = lane + j * G;
        if (v >= V) continue;
        atomicAdd(dst + 4 * v, g[j].x);
        atomicAdd(dst + 4 * v + 1, g[j].y);
        atomicAdd(dst + 4 * v + 2, g[j].z);
        atomicAdd(dst + 4 * v + 3, g[j].w);
      }
    }
  }
}

template <int G, int NV, bool kWindow>
cudaError_t launch_backward(const void* grad_out, const void* ids,
                            void* grad_table, long long num_bags, int L,
                            int V, long long R, long long lo,
                            cudaStream_t st) {
  constexpr int kBags = kThreads / G;
  const long long blocks = (num_bags + kBags - 1) / kBags;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  embedding_bag_backward_kernel<G, NV, kWindow>
      <<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
          static_cast<const float4*>(grad_out), static_cast<const int*>(ids),
          static_cast<float*>(grad_table), num_bags, L, V, R, lo);
  return cudaGetLastError();
}

template <bool kWindow>
cudaError_t launch_backward_width(const void* grad_out, const void* ids,
                                  void* grad_table, long long num_bags, int L,
                                  int V, long long R, long long lo,
                                  cudaStream_t st) {
#define REPRO_EMB_BACKWARD(G, NV)                                          \
  launch_backward<G, NV, kWindow>(grad_out, ids, grad_table, num_bags, L, \
                                  V, R, lo, st)
  if (V <= 1) return REPRO_EMB_BACKWARD(1, 1);
  if (V <= 2) return REPRO_EMB_BACKWARD(2, 1);
  if (V <= 4) return REPRO_EMB_BACKWARD(4, 1);
  if (V <= 8) return REPRO_EMB_BACKWARD(8, 1);
  if (V <= 16) return REPRO_EMB_BACKWARD(16, 1);
  if (V <= 32) return REPRO_EMB_BACKWARD(32, 1);
  if (V <= 64) return REPRO_EMB_BACKWARD(32, 2);
  return REPRO_EMB_BACKWARD(32, 4);
#undef REPRO_EMB_BACKWARD
}

}  // namespace

// table (R, D), ids (num_bags * L,) int32, out (num_bags, D); dtype 0 is
// float32, 1 bfloat16.  D * sizeof(elt) must be a multiple of 16 and at
// most 2048 bytes, and table and out 16-byte aligned (the wrapper checks).
// Returns the cudaError_t of the launch (0 on success); launches nothing
// for num_bags == 0.
extern "C" int batched_embedding(const void* table, const void* ids,
                                 void* out, long long num_bags, int L, int D,
                                 long long R, int dtype, void* stream) {
  const int elt = dtype == 0 ? 4 : 2;
  const long long row_bytes = static_cast<long long>(D) * elt;
  if (num_bags < 0 || L < 0 || D < 1 || R < 1 || row_bytes % 16 != 0 ||
      row_bytes / 16 > kMaxVectors || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_bags == 0) return 0;
  const int V = static_cast<int>(row_bytes / 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_width<float, false>(table, ids, out, num_bags, L, V, R, 0,
                                       R, st)
          : launch_width<__nv_bfloat16, false>(table, ids, out, num_bags, L,
                                               V, R, 0, R, st);
  return static_cast<int>(err);
}

// The row window: table (hi - lo, D) holds global rows [lo, hi); ids
// (num_bags * L,) int32 global row ids; out[b] = sum of table[id - lo]
// over the bag's ids in [lo, hi), the others adding nothing (see the
// header).  0 <= lo < hi; the rest as batched_embedding.
extern "C" int batched_embedding_window(const void* table, const void* ids,
                                        void* out, long long num_bags, int L,
                                        int D, long long lo, long long hi,
                                        int dtype, void* stream) {
  const int elt = dtype == 0 ? 4 : 2;
  const long long row_bytes = static_cast<long long>(D) * elt;
  if (num_bags < 0 || L < 0 || D < 1 || lo < 0 || hi <= lo ||
      row_bytes % 16 != 0 || row_bytes / 16 > kMaxVectors ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_bags == 0) return 0;
  const int V = static_cast<int>(row_bytes / 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_width<float, true>(table, ids, out, num_bags, L, V,
                                      hi - lo, lo, hi, st)
          : launch_width<__nv_bfloat16, true>(table, ids, out, num_bags, L,
                                              V, hi - lo, lo, hi, st);
  return static_cast<int>(err);
}

// grad_out (num_bags, D) float32, ids (num_bags * L,) int32 (the forward's
// global ids), grad_table (R, D) float32, zeroed by the caller; adds
// grad_out[b] into the row of every id of bag b (see the header).  D * 4
// must be a multiple of 16 and at most 2048 bytes, and grad_out and
// grad_table 16-byte aligned (the wrapper checks).  Returns the
// cudaError_t of the launch (0 on success); launches nothing for
// num_bags == 0.
extern "C" int batched_embedding_backward(const void* grad_out,
                                          const void* ids, void* grad_table,
                                          long long num_bags, int L, int D,
                                          long long R, void* stream) {
  const long long row_bytes = static_cast<long long>(D) * 4;
  if (num_bags < 0 || L < 0 || D < 1 || R < 1 || row_bytes % 16 != 0 ||
      row_bytes / 16 > kMaxVectors)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_bags == 0) return 0;
  return static_cast<int>(launch_backward_width<false>(
      grad_out, ids, grad_table, num_bags, L, static_cast<int>(row_bytes / 16),
      R, 0, static_cast<cudaStream_t>(stream)));
}

// The backward's row window: grad_table (hi - lo, D) float32, zeroed by the
// caller, holds global rows [lo, hi); adds grad_out[b] into row id - lo of
// every id of bag b in [lo, hi) (see the header).  0 <= lo < hi; the rest
// as batched_embedding_backward.
extern "C" int batched_embedding_backward_window(
    const void* grad_out, const void* ids, void* grad_table,
    long long num_bags, int L, int D, long long lo, long long hi,
    void* stream) {
  const long long row_bytes = static_cast<long long>(D) * 4;
  if (num_bags < 0 || L < 0 || D < 1 || lo < 0 || hi <= lo ||
      row_bytes % 16 != 0 || row_bytes / 16 > kMaxVectors)
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_bags == 0) return 0;
  return static_cast<int>(launch_backward_width<true>(
      grad_out, ids, grad_table, num_bags, L, static_cast<int>(row_bytes / 16),
      hi - lo, lo, static_cast<cudaStream_t>(stream)));
}
