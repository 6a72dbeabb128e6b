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
template <typename T, int G, int NV>
__global__ void __launch_bounds__(kThreads)
    embedding_bag_kernel(const uint4* __restrict__ table,
                         const int* __restrict__ ids, uint4* __restrict__ out,
                         long long num_bags, int L, int V, long long R) {
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
        const long long g = id < 0 ? static_cast<long long>(id) + R
                                   : static_cast<long long>(id);
        const bool ok = use[u] && g >= 0 && g < R;
        bad |= use[u] && !ok;
        const uint4* row = table + (ok ? g : 0) * V;    // 64-bit offset
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int v = lane + j * G;
          buf[u][j] = (ok && v < V) ? __ldg(row + v) : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!use[u]) continue;
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

template <typename T, int G, int NV>
cudaError_t launch(const void* table, const void* ids, void* out,
                   long long num_bags, int L, int V, long long R,
                   cudaStream_t st) {
  constexpr int kBags = kThreads / G;
  const long long blocks = (num_bags + kBags - 1) / kBags;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  embedding_bag_kernel<T, G, NV><<<static_cast<unsigned>(blocks), kThreads,
                                   0, st>>>(
      static_cast<const uint4*>(table), static_cast<const int*>(ids),
      static_cast<uint4*>(out), num_bags, L, V, R);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const void* table, const void* ids, void* out,
                         long long num_bags, int L, int V, long long R,
                         cudaStream_t st) {
  if (V <= 1) return launch<T, 1, 1>(table, ids, out, num_bags, L, V, R, st);
  if (V <= 2) return launch<T, 2, 1>(table, ids, out, num_bags, L, V, R, st);
  if (V <= 4) return launch<T, 4, 1>(table, ids, out, num_bags, L, V, R, st);
  if (V <= 8) return launch<T, 8, 1>(table, ids, out, num_bags, L, V, R, st);
  if (V <= 16)
    return launch<T, 16, 1>(table, ids, out, num_bags, L, V, R, st);
  if (V <= 32)
    return launch<T, 32, 1>(table, ids, out, num_bags, L, V, R, st);
  if (V <= 64)
    return launch<T, 32, 2>(table, ids, out, num_bags, L, V, R, st);
  return launch<T, 32, 4>(table, ids, out, num_bags, L, V, R, st);
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
          ? launch_width<float>(table, ids, out, num_bags, L, V, R, st)
          : launch_width<__nv_bfloat16>(table, ids, out, num_bags, L, V, R,
                                        st);
  return static_cast<int>(err);
}
