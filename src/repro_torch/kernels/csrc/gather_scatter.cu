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
// Bound on the H100: bytes at 3.35 TB/s.  Gather: N rows read, N rows
// written and the ids.  Scatter: N rows of src read, the distinct target
// rows written and the ids.  The rows are picked by data, so the kernel
// is latency-bound unless many rows are in flight.  What the design does:
//   * one thread per 16-byte vector of a row (rows of a multiple of 16
//     bytes, 16-byte aligned), or per element otherwise, chosen at launch;
//     the threads of a row sit side by side, so a row is read with
//     neighbouring loads, and a grid as large as the work keeps every row
//     in flight at once;
//   * every row offset is computed in 64 bits: Fig 9's table is
//     4 M x 2048 B = 8.2 GB, past 2^31.
// Duplicate ids in the scatter race if every draw writes.  The last write
// wins as the Pallas kernel's sequential grid leaves it: a first pass takes
// atomicMax of the draw index per target row into an int32 scratch of R
// entries (set to -1 first), then only the winning draw copies its row.
// The scratch moves 4 R bytes (the reset) and about 8 N (the atomics and
// the reads) beyond the bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 0x7fffffffLL;

template <typename W>
__device__ __forceinline__ W load(const W* p) {
  return __ldg(p);
}

__device__ __forceinline__ long long wrap(int id, long long R) {
  return id < 0 ? static_cast<long long>(id) + R : static_cast<long long>(id);
}

// One thread per word W of the output (V words per row), grid-stride.
template <typename W>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const W* __restrict__ table, const int* __restrict__ idx,
                  W* __restrict__ out, long long R, long long N, int V,
                  W nan) {
  const long long total = N * V;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       t < total; t += stride) {
    const long long i = t / V;
    const int j = static_cast<int>(t - i * V);
    const long long g = wrap(__ldg(idx + i), R);
    out[t] = (g >= 0 && g < R) ? load(table + g * V + j) : nan;
  }
}

// winner[g] = the largest draw i with idx[i] naming row g.
__global__ void __launch_bounds__(kThreads)
    winner_kernel(const int* __restrict__ idx, int* __restrict__ winner,
                  long long R, long long N) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < N; i += stride) {
    const long long g = wrap(__ldg(idx + i), R);
    if (g >= 0 && g < R) atomicMax(winner + g, static_cast<int>(i));
  }
}

// Each draw that won its row copies it; the others and the dropped ids
// write nothing.
template <typename W>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(W* __restrict__ table, const int* __restrict__ idx,
                   const W* __restrict__ src, const int* __restrict__ winner,
                   long long R, long long N, int V) {
  const long long total = N * V;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       t < total; t += stride) {
    const long long i = t / V;
    const int j = static_cast<int>(t - i * V);
    const long long g = wrap(__ldg(idx + i), R);
    if (g >= 0 && g < R && __ldg(winner + g) == i)
      table[g * V + j] = load(src + t);
  }
}

unsigned blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<unsigned>(b < 1 ? 1 : b);
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
    const int V = row_bytes / 16;
    const uint32_t w = dtype == 0 ? 0x7fc00000u : 0x7fc07fc0u;
    gather_kernel<uint4><<<blocks_for(N * V), kThreads, 0, st>>>(
        static_cast<const uint4*>(table), ids, static_cast<uint4*>(out), R, N,
        V, make_uint4(w, w, w, w));
  } else if (dtype == 0) {
    const int V = row_bytes / 4;
    gather_kernel<uint32_t><<<blocks_for(N * V), kThreads, 0, st>>>(
        static_cast<const uint32_t*>(table), ids, static_cast<uint32_t*>(out),
        R, N, V, 0x7fc00000u);
  } else {
    const int V = row_bytes / 2;
    gather_kernel<uint16_t><<<blocks_for(N * V), kThreads, 0, st>>>(
        static_cast<const uint16_t*>(table), ids, static_cast<uint16_t*>(out),
        R, N, V, static_cast<uint16_t>(0x7fc0));
  }
  return static_cast<int>(cudaGetLastError());
}

// table (R, row_bytes / elt) written in place, idx (N,) int32, src
// (N, row_bytes / elt), winner (R,) int32 scratch.  Returns the cudaError_t
// of the launches (0 on success); launches nothing for N == 0.
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
    const int V = row_bytes / 16;
    scatter_kernel<uint4><<<blocks_for(N * V), kThreads, 0, st>>>(
        static_cast<uint4*>(table), ids, static_cast<const uint4*>(src), win,
        R, N, V);
  } else if (elt == 4) {
    const int V = row_bytes / 4;
    scatter_kernel<uint32_t><<<blocks_for(N * V), kThreads, 0, st>>>(
        static_cast<uint32_t*>(table), ids, static_cast<const uint32_t*>(src),
        win, R, N, V);
  } else {
    const int V = row_bytes / 2;
    scatter_kernel<uint16_t><<<blocks_for(N * V), kThreads, 0, st>>>(
        static_cast<uint16_t*>(table), ids, static_cast<const uint16_t*>(src),
        win, R, N, V);
  }
  return static_cast<int>(cudaGetLastError());
}
