// GUPS-style random row gather and scatter (paper Fig 9) for Hopper
// (sm_90a).
//
// Replaces the TPU kernels gather_pallas and scatter_pallas
// (src/repro/kernels/gather_scatter/kernel.py:28, :48) and computes what
// repro_torch.kernels.gather_scatter.ref computes:
//
//   gather   out[i] = table[idx[i]]          table (R, D), idx (N,) int32
//   scatter  table[idx[i]] = src[i], in place, the last write winning
//
// An id in [-R, 0) stands for row id + R.  Outside [-R, R) the gather
// writes a row of NaN (jnp.take's fill) and the scatter drops the write
// (mode="drop"); neither reads a row there, and nothing syncs the host.
// Rows are moved as raw bytes: float32 or bfloat16 only decides the NaN.
//
// Bound on the H100: bytes at 3.35 TB/s.  Gather: the distinct rows read,
// N rows written and the ids.  Scatter: the winning source row of each
// distinct target read, the distinct target rows written and the ids.
// The rows are picked by data, so each one costs a dependent chain (the
// id, then the row), and a narrow row half-fills the 32-byte sector the
// memory system moves.  What the design does:
//   * a row belongs to a group of L = min(2^ceil(log2 V), 32) lanes, V the
//     row's words (16-byte vectors where rows are a multiple of 16 bytes
//     and 16-byte aligned, else elements); lane j of a group moves words
//     j, j + L, ... of its row, so a warp holds 32 / L narrow rows at once
//     or walks a wide row in steps of 32 words, and widths that are not a
//     power of two of words (48, 80, 2064 bytes) take a masked tail;
//   * a warp takes its rows in batches (Batch<L, Rg>): it reads the
//     batch's ids with coalesced loads (one per lane), hands each group
//     its rows with __shfl_sync, then every thread issues kUnroll loads
//     before any store: kUnroll rows of at most 32 words, or kUnroll words
//     of fewer, wider rows, so that kUnroll loads are in flight per
//     thread; rows and columns come from the lane and the loop counters,
//     with no division;
//   * the gather reads table rows through the non-coherent path (__ldg);
//     what a call touches once, the scatter's source rows and what either
//     kernel writes (the gather's output, the scatter's table rows), it
//     loads and stores streaming (__ldcs, __stcs), so that it does not
//     evict from the 50 MB L2 the table rows and winners still to be read;
//   * every row offset is computed in 64 bits: Fig 9's widest table is
//     4 M x 2048 B = 8.2 GB, past 2^31.
// Repeated ids in the scatter: the last write wins, as the Pallas
// kernel's sequential grid leaves it.  winner[g], an int32 scratch of R
// entries, is reset to -1 on every call (cudaMemsetAsync; 0.005 ms of the
// 0.1055 ms 16-byte Fig 9 scatter on an H100 80GB HBM3 at 700 W,
// PERF.md §6), then winner_kernel leaves in it the largest draw naming
// row g; no state outlives a call.  The copy reads idx[i] and winner[g]
// once per row, in the lane that holds the id, and a draw that lost reads
// no source row.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;              // loads in flight per thread
constexpr long long kMaxBlocks = 0x7fffffffLL;

__device__ __forceinline__ long long wrap(int id, long long R) {
  const long long g = id < 0 ? static_cast<long long>(id) + R
                             : static_cast<long long>(id);
  return g >= 0 && g < R ? g : -1;
}

// A warp takes its draws in batches: G = 32 / L groups of L lanes, Rg
// rows a group (row u * G + g of a batch belongs to group g), and kCols =
// kUnroll / Rg column steps of a row in flight, so that every thread has
// kUnroll loads in flight: Rg = kUnroll for rows of at most 32 words, fewer
// for wider rows, whose words a lane then loads from one row.  kIds ids a
// lane cover the batch: lane l holds the id of row s * 32 + l in slot s.
template <int L, int Rg>
struct Batch {
  static constexpr int G = 32 / L;
  static constexpr int kRows = Rg * G;
  static constexpr int kCols = kUnroll / Rg;
  static constexpr int kIds = (kRows + 31) / 32;
  // the slot and the lane that hold row u * G + g: since G divides 32, the
  // slot does not depend on g
  __host__ __device__ static constexpr int slot(int u) { return u * G / 32; }
  __host__ __device__ static constexpr int lane0(int u) {
    return u * G % 32;
  }
};

// mine[u]: the table row of draw base + u * G + g, or -1 where there is
// none (an id outside [-R, R), past N, or, given winner, a draw that did
// not win its row).  The ids, and the winners, are read once per row, by
// the lane that holds the id, and handed to the group with __shfl_sync.
template <int L, int Rg>
__device__ __forceinline__ void batch_rows(const int* __restrict__ idx,
                                           const int* __restrict__ winner,
                                           long long R, long long N,
                                           long long base, int lane, int g,
                                           long long (&mine)[Rg]) {
  using B = Batch<L, Rg>;
  long long row[B::kIds];
#pragma unroll
  for (int s = 0; s < B::kIds; ++s) {
    const long long i = base + s * 32 + lane;
    row[s] = i < N && s * 32 + lane < B::kRows ? wrap(__ldg(idx + i), R) : -1;
  }
  if (winner != nullptr) {
#pragma unroll
    for (int s = 0; s < B::kIds; ++s)
      if (row[s] >= 0 && __ldg(winner + row[s]) != base + s * 32 + lane)
        row[s] = -1;
  }
#pragma unroll
  for (int u = 0; u < Rg; ++u)
    mine[u] = __shfl_sync(0xffffffffu, row[B::slot(u)], B::lane0(u) + g);
}

// One warp per batch, grid-stride over batches.
template <typename W, int L, int Rg>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const W* __restrict__ table, const int* __restrict__ idx,
                  W* __restrict__ out, long long R, long long N, int V,
                  W nan) {
  using B = Batch<L, Rg>;
  const int lane = threadIdx.x & 31, g = lane / L, j = lane % L;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long base =
           (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) *
           B::kRows;
       base < N; base += warps * B::kRows) {
    long long mine[Rg];
    batch_rows<L, Rg>(idx, nullptr, R, N, base, lane, g, mine);
    for (int c0 = j; c0 < V; c0 += L * B::kCols) {
      W v[Rg][B::kCols];
#pragma unroll
      for (int u = 0; u < Rg; ++u)
#pragma unroll
        for (int k = 0; k < B::kCols; ++k)
          if (c0 + k * L < V)
            v[u][k] = mine[u] >= 0 ? __ldg(table + mine[u] * V + c0 + k * L)
                                   : nan;
#pragma unroll
      for (int u = 0; u < Rg; ++u) {
        const long long i = base + u * B::G + g;
#pragma unroll
        for (int k = 0; k < B::kCols; ++k)
          if (i < N && c0 + k * L < V)
            __stcs(out + i * V + c0 + k * L, v[u][k]);
      }
    }
  }
}

// winner[g] = the largest draw naming row g.
__global__ void __launch_bounds__(kThreads)
    winner_kernel(const int* __restrict__ idx, int* __restrict__ winner,
                  long long R, long long N) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < N; i += stride) {
    const long long g = wrap(__ldg(idx + i), R);
    if (g >= 0) atomicMax(winner + g, static_cast<int>(i));
  }
}

// The batches of gather_kernel; only the draw that won its row copies it.
template <typename W, int L, int Rg>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(W* __restrict__ table, const int* __restrict__ idx,
                   const W* __restrict__ src, const int* __restrict__ winner,
                   long long R, long long N, int V) {
  using B = Batch<L, Rg>;
  const int lane = threadIdx.x & 31, g = lane / L, j = lane % L;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long base =
           (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32) *
           B::kRows;
       base < N; base += warps * B::kRows) {
    long long mine[Rg];
    batch_rows<L, Rg>(idx, winner, R, N, base, lane, g, mine);
    for (int c0 = j; c0 < V; c0 += L * B::kCols) {
      W v[Rg][B::kCols];
#pragma unroll
      for (int u = 0; u < Rg; ++u)
#pragma unroll
        for (int k = 0; k < B::kCols; ++k)
          if (mine[u] >= 0 && c0 + k * L < V)
            v[u][k] = __ldcs(src + (base + u * B::G + g) * V + c0 + k * L);
#pragma unroll
      for (int u = 0; u < Rg; ++u)
#pragma unroll
        for (int k = 0; k < B::kCols; ++k)
          if (mine[u] >= 0 && c0 + k * L < V)
            __stcs(table + mine[u] * V + c0 + k * L, v[u][k]);
    }
  }
}

unsigned blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

// Blocks for N draws in batches of Batch<L, Rg>::kRows, one warp a batch.
template <int L, int Rg>
unsigned batch_blocks(long long N) {
  const long long rows = Batch<L, Rg>::kRows;
  return blocks_for((N + rows - 1) / rows * 32);
}

// The batch shapes (case, L, Rg): rows of V <= 32 words take L, the least
// power of two >= V, and Rg = kUnroll; wider rows take L = 32 and Rg =
// kUnroll / K for K = 1, 2 or 4 of their column steps, so that a lane
// loads up to kUnroll words of one row at once.
#define ROW_SHAPES(X)                                                      \
  X(0, 1, kUnroll) X(1, 2, kUnroll) X(2, 4, kUnroll) X(3, 8, kUnroll)      \
  X(4, 16, kUnroll) X(5, 32, kUnroll) X(6, 32, 2) X(7, 32, 1)

int row_shape(int V) {
  if (V > 32) return (V + 31) / 32 >= 4 ? 7 : 6;
  int shape = 0;
  for (int L = 1; L < V; L *= 2) ++shape;
  return shape;
}

template <typename W>
void launch_gather(const W* table, const int* ids, W* out, long long R,
                   long long N, int V, W nan, cudaStream_t st) {
  switch (row_shape(V)) {
#define GATHER_CASE(C, L, Rg)                                               \
  case C:                                                                   \
    gather_kernel<W, L, Rg><<<batch_blocks<L, Rg>(N), kThreads, 0, st>>>(   \
        table, ids, out, R, N, V, nan);                                     \
    break;
    ROW_SHAPES(GATHER_CASE)
#undef GATHER_CASE
  }
}

template <typename W>
void launch_scatter(W* table, const int* ids, const W* src, const int* win,
                    long long R, long long N, int V, cudaStream_t st) {
  switch (row_shape(V)) {
#define SCATTER_CASE(C, L, Rg)                                              \
  case C:                                                                   \
    scatter_kernel<W, L, Rg><<<batch_blocks<L, Rg>(N), kThreads, 0, st>>>(  \
        table, ids, src, win, R, N, V);                                     \
    break;
    ROW_SHAPES(SCATTER_CASE)
#undef SCATTER_CASE
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Checks shared by both entry points; sets the element size.
bool valid(long long R, long long N, int row_bytes, int dtype, int* elt) {
  *elt = dtype == 0 ? 4 : 2;
  return R >= 1 && N >= 0 && N <= 0x7fffffffLL && row_bytes >= 1 &&
         (dtype == 0 || dtype == 1) && row_bytes % *elt == 0;
}

}  // namespace

// table (R, row_bytes / elt), idx (N,) int32, out (N, row_bytes / elt);
// dtype 0 float32, 1 bfloat16.  Returns the cudaError_t of the launch (0
// on success); launches nothing for N == 0.
extern "C" int vector_gather(const void* table, const void* idx, void* out,
                             long long R, long long N, int row_bytes,
                             int dtype, void* stream) {
  int elt;
  if (!valid(R, N, row_bytes, dtype, &elt))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  if (row_bytes % 16 == 0 && aligned16(table) && aligned16(out)) {
    const uint32_t w = dtype == 0 ? 0x7fc00000u : 0x7fc07fc0u;
    launch_gather(static_cast<const uint4*>(table), ids,
                  static_cast<uint4*>(out), R, N, row_bytes / 16,
                  make_uint4(w, w, w, w), st);
  } else if (dtype == 0) {
    launch_gather(static_cast<const uint32_t*>(table), ids,
                  static_cast<uint32_t*>(out), R, N, row_bytes / 4,
                  0x7fc00000u, st);
  } else {
    launch_gather(static_cast<const uint16_t*>(table), ids,
                  static_cast<uint16_t*>(out), R, N, row_bytes / 2,
                  static_cast<uint16_t>(0x7fc0), st);
  }
  return static_cast<int>(cudaGetLastError());
}

// table (R, row_bytes / elt) written in place, idx (N,) int32, src
// (N, row_bytes / elt), winner (R,) int32 scratch (its contents on entry
// do not matter).  Returns the cudaError_t of the launches (0 on
// success); launches nothing for N == 0.
extern "C" int vector_scatter(void* table, const void* idx, const void* src,
                              void* winner, long long R, long long N,
                              int row_bytes, int dtype, void* stream) {
  int elt;
  if (!valid(R, N, row_bytes, dtype, &elt))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  int* win = static_cast<int*>(winner);
  cudaError_t err = cudaMemsetAsync(win, 0xff, R * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  winner_kernel<<<blocks_for(N), kThreads, 0, st>>>(ids, win, R, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (row_bytes % 16 == 0 && aligned16(table) && aligned16(src)) {
    launch_scatter(static_cast<uint4*>(table), ids,
                   static_cast<const uint4*>(src), win, R, N, row_bytes / 16,
                   st);
  } else if (elt == 4) {
    launch_scatter(static_cast<uint32_t*>(table), ids,
                   static_cast<const uint32_t*>(src), win, R, N,
                   row_bytes / 4, st);
  } else {
    launch_scatter(static_cast<uint16_t*>(table), ids,
                   static_cast<const uint16_t*>(src), win, R, N,
                   row_bytes / 2, st);
  }
  return static_cast<int>(cudaGetLastError());
}
