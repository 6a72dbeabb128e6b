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
//   * one block per block_rows x 128 elements, so block_rows stays the
//     granularity knob that Fig 8's sweep turns, as the Pallas grid's tile
//     height was;
//   * 16-byte loads and stores, neighbouring threads on neighbouring
//     addresses;
//   * each thread starts kUnroll loads of each input before its first
//     store, so enough bytes are in flight to cover the memory latency.
// The grid is exactly rows / block_rows blocks: the wrapper refuses
// rows % block_rows != 0, where the Pallas grid would leave the tail rows
// unwritten.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;
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

// One block per tile of vpb 16-byte vectors (block_rows x 128 elements).
template <typename T, int OP>
__global__ void __launch_bounds__(kMaxThreads)
    stream_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                  uint4* __restrict__ out, int vpb, float s) {
  const long long base = static_cast<long long>(blockIdx.x) * vpb;
  const int step = blockDim.x;
  for (int v0 = threadIdx.x; v0 < vpb; v0 += step * kUnroll) {
    uint4 x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * step;
      if (v < vpb) {
        x[u] = __ldg(a + base + v);
        y[u] = OP == kScale ? make_uint4(0, 0, 0, 0) : __ldg(b + base + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * step;
      if (v < vpb) out[base + v] = apply<OP>(x[u], y[u], s, T());
    }
  }
}

template <typename T>
cudaError_t launch_op(int op, const void* a, const void* b, void* out,
                      long long tiles, int vpb, float s, cudaStream_t st) {
  const int threads = vpb < kMaxThreads ? vpb : kMaxThreads;
  const uint4* pa = static_cast<const uint4*>(a);
  const uint4* pb = static_cast<const uint4*>(b);
  uint4* po = static_cast<uint4*>(out);
  const unsigned grid = static_cast<unsigned>(tiles);
  if (op == kAdd)
    stream_kernel<T, kAdd><<<grid, threads, 0, st>>>(pa, pb, po, vpb, s);
  else if (op == kScale)
    stream_kernel<T, kScale><<<grid, threads, 0, st>>>(pa, pb, po, vpb, s);
  else
    stream_kernel<T, kTriad><<<grid, threads, 0, st>>>(pa, pb, po, vpb, s);
  return cudaGetLastError();
}

}  // namespace

// op 0 ADD (a, b), 1 SCALE (a; b unused), 2 TRIAD (a, b); n elements of
// dtype 0 float32 or 1 bfloat16, 16-byte aligned; n a multiple of 128 and
// n / 128 a multiple of block_rows (the wrapper checks).  Returns the
// cudaError_t of the launch (0 on success); launches nothing for n == 0.
extern "C" int stream(int op, const void* a, const void* b, void* out,
                      long long n, float scalar, int block_rows, int dtype,
                      void* stream) {
  const int elt = dtype == 0 ? 4 : 2;
  if (n < 0 || n % kLanes != 0 || block_rows < 1 || op < 0 || op > 2 ||
      (dtype != 0 && dtype != 1) || (n / kLanes) % block_rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long tiles = n / kLanes / block_rows;
  const long long vpb = static_cast<long long>(block_rows) * kLanes * elt / 16;
  if (tiles > 0x7fffffffLL || vpb > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_op<float>(op, a, b, out, tiles,
                                    static_cast<int>(vpb), scalar, st)
                 : launch_op<__nv_bfloat16>(op, a, b, out, tiles,
                                            static_cast<int>(vpb), scalar,
                                            st);
  return static_cast<int>(err);
}
