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
// output is acc / max(l, 1e-30).  A batch's dense K/V is a pool of one
// block (strides sb = S*KV*HD, sr = KV*HD, sh = HD) whose page list is the
// single entry (block b, position 0) of kend keys, handed to one of the
// paged kernels' per-tile functions, chosen by dtype at compile time:
//   * bfloat16: paged::attend_tile_mma (attend_tile_mma.cuh), 128 query
//     rows per block on the tensor cores, K/V in bf16 through a two-stage
//     cp.async ring: wgmma at HD 64 and 128, mma.sync at HD 16 and 32,
//     narrower than the 64 columns of wgmma's 128-byte swizzle;
//   * float32: paged::attend_tile (paged_attention_common.cuh), 64 rows on
//     the SIMT cores.  A tensor-core f32 product would be TF32, and the
//     f32 result is held to the plain version at 2e-5.
//
// Bound on the H100: operations, 4 * B * H * S^2 * HD (half of it when
// causal) at 989 TFLOP/s in bf16 or 67 TFLOP/s in float32, against q, k, v
// and out moved once at 3.35 TB/s.  What the design does about it:
//   * one block per (query tile, kv head, batch): the G query heads of the
//     kv head ride in the tile's rows (rows / G positions x G heads), so
//     every K/V row read from memory serves all of them;
//   * in bf16 both products run on the tensor cores, the next 64 keys'
//     copies in flight while this 64's products run (attend_tile_mma.cuh
//     says how); two blocks of 256 threads share an SM;
//   * under the causal mask a tile stops at its last row's position: the
//     key tiles wholly above the diagonal are skipped, which is exact,
//     since a fully masked update leaves m, l and acc unchanged; the
//     heaviest tiles (late positions) of every (kv head, batch) are
//     launched first, so no heavy tile starts in the last wave.
// Left (bf16): TMA copies, warp specialisation that overlaps one
// warpgroup's softmax with the other's products, a persistent grid; the
// float32 tile stays on the SIMT cores.  The TPU tiles bq/bk are not
// this kernel's: the result does not depend on them.

#include <climits>
#include <type_traits>

#include "attend_tile_mma.cuh"
#include "paged_attention_common.cuh"

namespace {

// The tile each dtype takes: its rows, threads, blocks per SM the
// registers are sized for, and dynamic shared memory.
template <typename T, int HD> struct Tile;
template <int HD> struct Tile<float, HD> {   // paged::attend_tile, SIMT
  static constexpr int kRows = paged::kRows;
  static constexpr int kThreads = paged::kThreads;
  static constexpr int kMinBlocks = 1;
  static constexpr size_t kSmem = paged::smem_floats<HD>() * sizeof(float);
};
template <int HD> struct Tile<__nv_bfloat16, HD> {  // attend_tile_mma
  static constexpr int kRows = paged::kMmaRows;
  static constexpr int kThreads = paged::kMmaThreads;
  static constexpr int kMinBlocks = 2;
  static constexpr size_t kSmem = paged::mma_smem_bytes<HD>();
};

template <typename T, int HD>
__global__ void __launch_bounds__(Tile<T, HD>::kThreads,
                                  Tile<T, HD>::kMinBlocks)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int H,
                 int KV, int G, int P, int ntiles, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int list_blk, list_pos;
  // heaviest tiles first across every (kv head, batch)
  const int per_tile = static_cast<int>(gridDim.x) / ntiles;   // KV * B
  const int tile = ntiles - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int kvh = static_cast<int>(blockIdx.x) % per_tile % KV;
  const int b = static_cast<int>(blockIdx.x) % per_tile / KV;
  const int p0 = tile * P;
  const int npos = min(P, S - p0);         // query positions in the tile
  // keys past the tile's last position are all masked under causal
  const int kend = causal ? p0 + npos : S;
  if (threadIdx.x == 0) {
    list_blk = b;
    list_pos = 0;
  }
  const long long sr = static_cast<long long>(KV) * HD;
  const paged::Pool<T> pool{k, v, S * sr, sr, HD};
  const long long at = static_cast<long long>(b) * S * H * HD;
  // both tiles synchronise before they read the list
  if constexpr (std::is_same<T, float>::value) {
    // without the mask every row sees all S keys
    const int row_pos = causal ? p0 + (threadIdx.x >> 2) / G : INT_MAX;
    paged::attend_tile<T, HD>(q + at, out + at, H, G, kvh, p0, npos * G,
                              row_pos, S, &list_blk, &list_pos, 1, kend,
                              pool, scale, smem);
  } else {
    const auto row_pos = [=](int r) { return causal ? p0 + r / G : INT_MAX; };
    paged::attend_tile_mma<HD>(
        q + at, out + at, H, G, kvh, p0, npos * G, row_pos, S, &list_blk,
        &list_pos, 1, kend, pool, scale, smem);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, int causal, float scale,
                   cudaStream_t st) {
  static bool configured = false;
  constexpr size_t smem = Tile<T, HD>::kSmem;
  if (!configured && !std::is_same<T, float>::value) {
    // as much of the SM's 256 KB as shared memory as it takes for two
    // blocks (the default split may leave room for one)
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err =
      paged::allow_smem(flash_kernel<T, HD>, smem, &configured);
  if (err != cudaSuccess) return err;
  const int G = H / KV;
  const int P = Tile<T, HD>::kRows / G;    // positions per tile
  const int ntiles = (S + P - 1) / P;
  if (static_cast<long long>(ntiles) * KV * B > INT_MAX)
    return cudaErrorInvalidValue;
  const dim3 grid(ntiles * KV * B);
  flash_kernel<T, HD><<<grid, Tile<T, HD>::kThreads, smem, st>>>(
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

template <int HD>
size_t smem_bytes(int dtype) {
  return dtype == 0 ? Tile<float, HD>::kSmem : Tile<__nv_bfloat16, HD>::kSmem;
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
  if (B < 0 || S < 0 || KV < 1 || H < KV || H % KV != 0 ||
      H / KV > paged::kRows || KV > 65535 || B > 65535 ||
      (dtype != 0 && dtype != 1))
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

// Dynamic shared memory, in bytes, of the instance for head dim HD and
// dtype (0 float32, 1 bfloat16); 0 for a head dim the kernel does not take.
extern "C" int flash_attention_smem_bytes(int HD, int dtype) {
  switch (HD) {
    case 16: return static_cast<int>(smem_bytes<16>(dtype));
    case 32: return static_cast<int>(smem_bytes<32>(dtype));
    case 64: return static_cast<int>(smem_bytes<64>(dtype));
    case 128: return static_cast<int>(smem_bytes<128>(dtype));
    default: return 0;
  }
}
