// STREAM ADD, SCALE and TRIAD (paper Alg 1, Fig 8) for Hopper (sm_90a).
//
// Replaces the TPU kernels add_pallas, scale_pallas and triad_pallas, all
// through _call (src/repro/kernels/stream/kernel.py:55, :61, :67, :34), and
// computes what repro_torch.kernels.stream.ref computes, over n elements
// seen as (n / 128, 128) rows:
//
//   ADD    out = a + b
//   SCALE  out = s * a
//   TRIAD  out = s * a + b
//
// float32 or bfloat16; s arrives already rounded to the array's dtype (the
// Pallas kernels cast it first).  Every result is rounded as the plain
// PyTorch version rounds it, so the two agree bitwise: the product and the
// sum are separate roundings (__fmul_rn / __fadd_rn keep nvcc from
// contracting TRIAD into one FMA), and in bfloat16 each op computes in
// float32 and rounds to bfloat16, TRIAD's product before its add.
//
// Bound on the H100: bytes, 3 * n * elt (ADD, TRIAD) or 2 * n * elt
// (SCALE) at 3.35 TB/s; one or two operations per element are far below
// the card's rate.  What the design does about it:
//   * a persistent grid sized to the card (SMs x resident blocks, queried
//     once per device), not to the tile count, so no tile height leaves
//     SMs idle;
//   * the arrays are cut into units of at most kUnitBytes per array: as
//     many whole tiles of block_rows x 128 elements as fit, or a
//     unit-sized piece of a larger tile, so a tile's pieces spread over
//     blocks where the tiles are fewer than the grid;
//   * each thread holds the next unit's 16-byte vectors in registers
//     before it stores the current unit's, so a block keeps a unit of
//     loads in flight while it stores.  Loads and stores carry no cache
//     hint: with streaming (evict-first) ones, launches back to back
//     outside a CUDA graph each took 3% longer at 2^28 (PERF.md §6);
//   * the units go out in order: block g takes units g and g + grid, and
//     the rest from a work queue (a counter the last block resets), so the
//     resident blocks sweep each array in one front.  Dealt round robin to
//     the end instead, the blocks drift apart and the card is about 4% slower
//     at 2^28 (PERF.md §6); a call whose units fit in the first two
//     rounds never touches the queue.
// A ring of shared-memory stages fed by 1-D bulk copies (TMA), with
// block_rows tiles as the copy granule, on the same grid and unit order
// was slower, at 2^28 and more so inside the L2 (PERF.md §6), so the
// tile height is no longer a copy size on this card: it only sets where
// units begin.
// The wrapper refuses rows % block_rows != 0, where the Pallas grid would
// leave the tail rows unwritten.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kUnitBytes = 16384;         // one unit of one array, at most
constexpr int kVecs = kUnitBytes / 16 / kThreads;   // a thread's, per array
constexpr int kDealt = 2;                 // rounds dealt before the queue
constexpr int kMaxDevices = 64;
constexpr int kQueues = 64;               // work queues per device
enum Op { kAdd = 0, kScale = 1, kTriad = 2 };

__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float bf16_round(float x) {
  return __uint_as_float(bf16_bits(x) << 16);
}

template <int OP>
__device__ __forceinline__ float apply_f32(float x, float y, float s) {
  if (OP == kAdd) return __fadd_rn(x, y);
  if (OP == kScale) return __fmul_rn(s, x);
  return __fadd_rn(__fmul_rn(s, x), y);
}

// bfloat16: compute in float32, round each op's result to bfloat16.
template <int OP>
__device__ __forceinline__ uint32_t apply_bf16(float x, float y, float s) {
  if (OP == kAdd) return bf16_bits(__fadd_rn(x, y));
  if (OP == kScale) return bf16_bits(__fmul_rn(s, x));
  return bf16_bits(__fadd_rn(bf16_round(__fmul_rn(s, x)), y));
}

template <int OP>
__device__ __forceinline__ uint4 apply(uint4 x, uint4 y, float s, float) {
  return make_uint4(
      __float_as_uint(apply_f32<OP>(__uint_as_float(x.x), __uint_as_float(y.x), s)),
      __float_as_uint(apply_f32<OP>(__uint_as_float(x.y), __uint_as_float(y.y), s)),
      __float_as_uint(apply_f32<OP>(__uint_as_float(x.z), __uint_as_float(y.z), s)),
      __float_as_uint(apply_f32<OP>(__uint_as_float(x.w), __uint_as_float(y.w), s)));
}

// A 32-bit word holds two bfloat16 values, element 2i in the low half.
template <int OP>
__device__ __forceinline__ uint4 apply(uint4 x, uint4 y, float s,
                                       __nv_bfloat16) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = apply_bf16<OP>(lo(xs[i]), lo(ys[i]), s) |
           (apply_bf16<OP>(hi(xs[i]), hi(ys[i]), s) << 16);
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// ---- the kernel ---------------------------------------------------------

// The work of one call.  Each array is cut into units: `group` whole tiles
// where a tile fits in a unit (the last unit may hold fewer), else
// `pieces` unit-sized pieces of one tile (the last shorter).
struct Plan {
  long long tile_bytes;
  long long tiles;
  long long units;
  long long dealt;  // units dealt round robin: kDealt x grid
  int group;        // tiles per unit (1 where a tile spans units)
  int pieces;       // units per tile (1 where a tile fits in a unit)
  int unit_bytes;   // a unit of one array, at most
  // the work queue of the launch's stream: next unit past `dealt`, blocks
  // done; zero between launches (the last block resets it)
  unsigned long long* queue;
};

// One queue per stream (up to kQueues streams a device, then shared by
// hashing), so launches on two streams never take units from one counter.
__device__ unsigned long long queues[kQueues][2];

// Where unit u lies in each array: its offset and its bytes.
__device__ __forceinline__ int unit_at(const Plan& p, long long u,
                                       long long* off) {
  if (p.pieces == 1) {
    const long long t0 = u * p.group;
    const long long left = p.tiles - t0;
    *off = t0 * p.tile_bytes;
    return static_cast<int>((left < p.group ? left : p.group) * p.tile_bytes);
  }
  const long long t = u / p.pieces;
  const long long j = u - t * p.pieces;
  *off = t * p.tile_bytes + j * p.unit_bytes;
  const long long left = p.tile_bytes - j * p.unit_bytes;
  return static_cast<int>(left < p.unit_bytes ? left : p.unit_bytes);
}

// A thread's vectors of one unit: vector threadIdx.x + k * kThreads.
struct Held {
  uint4 x[kVecs];
  uint4 y[kVecs];
  long long off;
  int vecs;
};

template <int OP>
__device__ __forceinline__ void load(const Plan& p, const char* a,
                                     const char* b, long long u, Held& h) {
  h.vecs = unit_at(p, u, &h.off) >> 4;
  const uint4* pa = reinterpret_cast<const uint4*>(a + h.off);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = threadIdx.x + k * kThreads;
    if (v < h.vecs) {
      h.x[k] = pa[v];
      if constexpr (OP != kScale)   // SCALE has no b
        h.y[k] = reinterpret_cast<const uint4*>(b + h.off)[v];
    }
  }
}

template <typename T, int OP>
__device__ __forceinline__ void store(char* out, const Held& h, float s) {
  uint4* po = reinterpret_cast<uint4*>(out + h.off);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = threadIdx.x + k * kThreads;
    if (v < h.vecs) {
      uint4 y = make_uint4(0, 0, 0, 0);
      if constexpr (OP != kScale) y = h.y[k];
      po[v] = apply<OP>(h.x[k], y, s, T());
    }
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const char* __restrict__ a, const char* __restrict__ b,
                  char* __restrict__ out, Plan p, float s) {
  __shared__ long long taken;
  const long long grid = gridDim.x;
  // the block's i-th unit, or -1 past the last (every thread calls it)
  auto take = [&](long long i) -> long long {
    if (i < kDealt) {
      const long long u = blockIdx.x + i * grid;
      return u < p.units ? u : -1;
    }
    if (p.units <= p.dealt) return -1;
    __syncthreads();   // everyone has read the last unit taken
    if (threadIdx.x == 0)
      taken = p.dealt + static_cast<long long>(atomicAdd(&p.queue[0], 1ULL));
    __syncthreads();
    return taken < p.units ? taken : -1;
  };
  // two units in registers: the next one loads while the current stores
  Held h0, h1;
  long long i = 0;
  long long u = take(i++);
  if (u >= 0) load<OP>(p, a, b, u, h0);
  while (u >= 0) {
    u = take(i++);
    if (u >= 0) load<OP>(p, a, b, u, h1);
    store<T, OP>(out, h0, s);
    if (u < 0) break;
    u = take(i++);
    if (u >= 0) load<OP>(p, a, b, u, h0);
    store<T, OP>(out, h1, s);
  }
  // the last block done resets the queue for the stream's next launch;
  // every block took its last unit before it counts itself done
  if (threadIdx.x == 0 && p.units > p.dealt) {
    __threadfence();
    if (atomicAdd(&p.queue[1], 1ULL) == grid - 1) {
      p.queue[0] = 0;
      p.queue[1] = 0;
    }
  }
}

// Per device and kernel instance: the SM count and the resident blocks per
// SM, queried once; per device, the queues' address and the stream that
// owns each queue.  Filled on first use, under a lock.
struct Card {
  int sms;
  int per_sm;
};
Card cards[kMaxDevices][2][3];
unsigned long long* queue_base[kMaxDevices];
cudaStream_t queue_owner[kMaxDevices][kQueues];
int queues_owned[kMaxDevices];
std::mutex setup;

template <typename T, int OP>
cudaError_t card_of(int dev, Card* out) {
  Card& c = cards[dev][sizeof(T) == 4 ? 0 : 1][OP];
  if (c.sms == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, stream_kernel<T, OP>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (sms < 1 || per_sm < 1) return cudaErrorInvalidConfiguration;
    c.per_sm = per_sm;
    c.sms = sms;
  }
  *out = c;
  return cudaSuccess;
}

// The work queue of `stream` on `dev` (call under the lock).
cudaError_t queue_of(int dev, cudaStream_t stream, unsigned long long** q) {
  if (queue_base[dev] == nullptr) {
    void* base = nullptr;
    const cudaError_t err = cudaGetSymbolAddress(&base, queues);
    if (err != cudaSuccess) return err;
    queue_base[dev] = static_cast<unsigned long long*>(base);
  }
  int k = 0;
  while (k < queues_owned[dev] && queue_owner[dev][k] != stream) ++k;
  if (k == queues_owned[dev]) {
    if (k < kQueues) {
      queue_owner[dev][k] = stream;
      ++queues_owned[dev];
    } else {
      k = static_cast<int>(reinterpret_cast<uintptr_t>(stream) % kQueues);
    }
  }
  *q = queue_base[dev] + 2 * k;
  return cudaSuccess;
}

// The plan of one call on `stream`, and its grid: min(units, SMs x blocks
// per SM).
template <typename T, int OP>
cudaError_t plan_of(long long n, int block_rows, cudaStream_t stream,
                    Plan* p, Card* c, unsigned* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> hold(setup);
    err = card_of<T, OP>(dev, c);
    if (err == cudaSuccess) err = queue_of(dev, stream, &p->queue);
  }
  if (err != cudaSuccess) return err;
  p->tile_bytes = static_cast<long long>(block_rows) * kLanes * sizeof(T);
  p->tiles = n / kLanes / block_rows;
  if (p->tile_bytes <= kUnitBytes) {
    p->group = static_cast<int>(kUnitBytes / p->tile_bytes);
    p->pieces = 1;
    p->unit_bytes = static_cast<int>(p->group * p->tile_bytes);
    p->units = (p->tiles + p->group - 1) / p->group;
  } else {
    p->group = 1;
    p->pieces = static_cast<int>((p->tile_bytes + kUnitBytes - 1) /
                                 kUnitBytes);
    p->unit_bytes = kUnitBytes;
    p->units = p->tiles * p->pieces;
  }
  const long long most = static_cast<long long>(c->sms) * c->per_sm;
  *grid = static_cast<unsigned>(p->units < most ? p->units : most);
  p->dealt = static_cast<long long>(kDealt) * *grid;
  return cudaSuccess;
}

template <typename T, int OP>
cudaError_t launch(const void* a, const void* b, void* out, long long n,
                   int block_rows, float s, cudaStream_t st) {
  Plan p;
  Card c;
  unsigned grid;
  cudaError_t err = plan_of<T, OP>(n, block_rows, st, &p, &c, &grid);
  if (err != cudaSuccess) return err;
  stream_kernel<T, OP><<<grid, kThreads, 0, st>>>(
      static_cast<const char*>(a), static_cast<const char*>(b),
      static_cast<char*>(out), p, s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_op(int op, const void* a, const void* b, void* out,
                      long long n, int block_rows, float s, cudaStream_t st) {
  if (op == kAdd) return launch<T, kAdd>(a, b, out, n, block_rows, s, st);
  if (op == kScale) return launch<T, kScale>(a, b, out, n, block_rows, s, st);
  return launch<T, kTriad>(a, b, out, n, block_rows, s, st);
}

template <typename T>
cudaError_t plan_op(int op, long long n, int block_rows, cudaStream_t st,
                    long long* out) {
  Plan p;
  Card c;
  unsigned grid;
  cudaError_t err =
      op == kAdd     ? plan_of<T, kAdd>(n, block_rows, st, &p, &c, &grid)
      : op == kScale ? plan_of<T, kScale>(n, block_rows, st, &p, &c, &grid)
                     : plan_of<T, kTriad>(n, block_rows, st, &p, &c, &grid);
  if (err != cudaSuccess) return err;
  const long long values[7] = {grid,     p.units,  p.unit_bytes, c.sms,
                               c.per_sm, kThreads,
                               p.units > p.dealt ? p.units - p.dealt : 0};
  for (int i = 0; i < 7; ++i) out[i] = values[i];
  return cudaSuccess;
}

bool valid(int op, long long n, int block_rows, int dtype) {
  return n >= 0 && n % kLanes == 0 && block_rows >= 1 && op >= 0 && op <= 2 &&
         (dtype == 0 || dtype == 1) && (n / kLanes) % block_rows == 0 &&
         static_cast<long long>(block_rows) * kLanes <= 0x7fffffffLL / 4;
}

}  // namespace

// op 0 ADD (a, b), 1 SCALE (a; b unused), 2 TRIAD (a, b); n elements of
// dtype 0 float32 or 1 bfloat16, 16-byte aligned; n a multiple of 128 and
// n / 128 a multiple of block_rows (the wrapper checks).  Returns the
// cudaError_t of the launch (0 on success); launches nothing for n == 0.
extern "C" int stream(int op, const void* a, const void* b, void* out,
                      long long n, float scalar, int block_rows, int dtype,
                      void* stream) {
  if (!valid(op, n, block_rows, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_op<float>(op, a, b, out, n, block_rows, scalar, st)
          : launch_op<__nv_bfloat16>(op, a, b, out, n, block_rows, scalar, st);
  return static_cast<int>(err);
}

// What stream() launches for these arguments on the current device and
// `stream`, into out[7]: grid, units, bytes of a unit of one array, SMs,
// resident blocks per SM, threads per block, and the units the blocks take
// from the work queue.  Returns a cudaError_t.
extern "C" int stream_plan(int op, long long n, int block_rows, int dtype,
                           void* stream, long long* out) {
  if (!valid(op, n, block_rows, dtype) || n == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? plan_op<float>(op, n, block_rows, st, out)
                 : plan_op<__nv_bfloat16>(op, n, block_rows, st, out);
  return static_cast<int>(err);
}
