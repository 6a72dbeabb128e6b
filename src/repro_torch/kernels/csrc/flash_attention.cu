// Dense GQA flash attention, optionally causal, for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas / _flash_kernel
// (src/repro/kernels/flash_attention/kernel.py:66 / :24) and computes what
// repro_torch.kernels.flash_attention.ref.flash_attention_ref computes:
//
//   q (B, S, H, HD), k and v (B, S, KV, HD) -> out (B, S, H, HD) in q's
//   dtype; q head h reads kv head h / G, G = H / KV.
//
// Per query row it follows _flash_kernel's arithmetic: the score is
// (q . k) * scale in float32; under the causal mask (row >= col) a masked
// score is -1e30 and its weight 0; an online softmax keeps the running max
// m, sum l and accumulator in float32; the weights are rounded to v's dtype
// before the PV product (kernel.py:53) but summed into l unrounded; the
// output is acc / max(l, 1e-30).  That arithmetic is paged::attend_tile's
// (paged_attention_common.cuh), the one per-row function of the three
// paged-attention kernels: a batch's dense K/V is a pool of one block
// (strides sb = S*KV*HD, sr = KV*HD, sh = HD) whose page list is the single
// entry (block b, position 0) of kend keys, so the four kernels cannot drift
// apart.
//
// Bound on the H100: operations, 4 * B * H * S^2 * HD (half of it when
// causal) at 989 TFLOP/s in bf16 or 67 TFLOP/s in float32, against q, k, v
// and out moved once at 3.35 TB/s.  What this first design does:
//   * one block per (query tile, kv head, batch): the G query heads of the
//     kv head ride in the tile's 64 rows (64 / G positions x G heads), so
//     every K/V row read from memory serves all of them;
//   * keys stream through shared memory 64 rows at a time with 16-byte
//     loads; 4 threads per row split the keys for QK and the head dim for
//     PV;
//   * under the causal mask a tile stops at its last row's position: the
//     key tiles wholly above the diagonal are skipped, which is exact,
//     since a fully masked update leaves m, l and acc unchanged; the
//     heaviest tiles (late positions) are launched first.
// The products run on the SIMT cores, not the tensor cores: far from the
// operations bound.  Not done yet: wgmma or mma.sync for QK and PV,
// TMA/cp.async double buffering, several kv heads or batches per block.
// The TPU tiles bq/bk are not this kernel's: the result does not depend
// on them.

#include <climits>

#include "paged_attention_common.cuh"

namespace {

using paged::kRows;
using paged::kThreads;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int H,
                 int KV, int G, int P, int ntiles, int causal, float scale) {
  extern __shared__ float smem[];
  __shared__ int list_blk, list_pos;
  const int tile = ntiles - 1 - static_cast<int>(blockIdx.x);
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int p0 = tile * P;
  const int npos = min(P, S - p0);         // query positions in the tile
  // keys past the tile's last position are all masked under causal
  const int kend = causal ? p0 + npos : S;
  // without the mask every row sees all S keys
  const int row_pos = causal ? p0 + (threadIdx.x >> 2) / G : INT_MAX;
  if (threadIdx.x == 0) {
    list_blk = b;
    list_pos = 0;
  }
  const long long sr = static_cast<long long>(KV) * HD;
  const paged::Pool<T> pool{k, v, S * sr, sr, HD};
  const long long at = static_cast<long long>(b) * S * H * HD;
  // attend_tile synchronises before it reads the list
  paged::attend_tile<T, HD>(q + at, out + at, H, G, kvh, p0, npos * G,
                            row_pos, S, &list_blk, &list_pos, 1, kend, pool,
                            scale, smem);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, int causal, float scale,
                   cudaStream_t st) {
  static bool configured = false;
  constexpr size_t smem = paged::smem_floats<HD>() * sizeof(float);
  const cudaError_t err =
      paged::allow_smem(flash_kernel<T, HD>, smem, &configured);
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  const int P = kRows / G;                 // positions per tile
  const int ntiles = (S + P - 1) / P;
  const dim3 grid(ntiles, KV, B);
  flash_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, G, P, ntiles,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int H, int KV, int HD, int causal,
                      float scale, cudaStream_t st) {
  switch (HD) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, H, KV, causal, scale, st);
    case 32: return launch<T, 32>(q, k, v, out, B, S, H, KV, causal, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, B, S, H, KV, causal, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, H, KV, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, HD), k and v (B, S, KV, HD), out (B, S, H, HD), contiguous
// and 16-byte aligned; dtype 0 float32, 1 bfloat16; HD in {16, 32, 64,
// 128}; H a multiple of KV with H / KV <= 64.  Returns the cudaError_t of
// the launch (0 on success); launches nothing when B * S == 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int H, int KV, int HD,
                               int causal, float scale, int dtype,
                               void* stream) {
  if (B < 0 || S < 0 || KV < 1 || H < KV || H % KV != 0 || H / KV > kRows ||
      KV > 65535 || B > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_hd<float>(q, k, v, out, B, S, H, KV, HD, causal,
                                    scale, st)
                 : launch_hd<__nv_bfloat16>(q, k, v, out, B, S, H, KV, HD,
                                            causal, scale, st);
  return static_cast<int>(err);
}
