// Which tile serves a query tile of the three paged-attention kernels
// (paged_attention_ragged.cu, paged_attention_chunked.cu,
// paged_attention_decode.cu), for Hopper (sm_90a).  Each decides it here,
// the same way, from the owner (the sequence, slot or request whose keys a
// tile reads) alone:
//   * bf16, an owner with kMmaMinLanes or more query lanes in the launch
//     (prefill chunks): paged::attend_tile_mma (attend_tile_mma.cuh), 128
//     query rows per block on the tensor cores, kMmaRows / G lanes a tile;
//   * an owner with exactly one lane in the launch (a decode lane), float32
//     or bf16, at any G <= kRows: paged::decode_split (paged_decode_tile.cuh),
//     its G rows over splits of kSplitKeys keys, one block per (split, kv
//     head), combined in the launch.  Every request of the decode kernel is
//     such an owner;
//   * everything else: paged::attend_tile (paged_attention_common.cuh), 64
//     rows on the SIMT cores, kRows / G lanes a tile: float32 owners of two
//     or more lanes (a tensor-core f32 product would be TF32) and padding.
// A row's result on each tile depends only on its owner's page list, its
// position and the owner's key count, never on its tile or the rest of the
// launch (the keys stream in list order, 64 per stage, and the decode
// tile's splits are cut from the list alone), so the rule keeps the ragged
// and chunked kernels bitwise equal, and the decode kernel equal to both on
// decode lanes.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "attend_tile_mma.cuh"
#include "paged_attention_common.cuh"
#include "paged_decode_tile.cuh"

namespace paged {

static_assert(kThreads == kMmaThreads, "one block size for both tiles");

constexpr int kMmaMinLanes = 2;

// Whether an owner with `lanes` query lanes in the launch runs its tiles
// on attend_tile_mma.
template <typename T>
__host__ __device__ constexpr bool mma_owner(int lanes) {
  return std::is_same<T, __nv_bfloat16>::value && lanes >= kMmaMinLanes;
}

// Whether an owner with `lanes` query lanes in the launch runs on the
// decode tile.
__host__ __device__ constexpr bool decode_owner(int lanes) {
  return lanes == 1;
}

// Launch shape of a ragged or chunked instance that may run any of the
// three tiles: dynamic shared memory for the largest (the decode tile's at
// G = kRows is the largest at every head dim), and the blocks per SM its
// registers are sized for.  bf16 at HD <= 64 holds two blocks of 256
// threads per SM (128 registers each, as flash); at HD 128 the tiles'
// shared memory leaves room for one, so the registers are not capped, nor
// in float32.
template <typename T, int HD>
struct PagedKernel {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kMinBlocks = kMma && HD <= 64 ? 2 : 1;
  static constexpr size_t kSimt = smem_floats<HD>() * sizeof(float);
  static constexpr size_t kTensor = kMma ? mma_smem_bytes<HD>() : 0;
  static constexpr size_t kDecode = DecodeTile<T, HD>::smem_bytes(kRows);
  static constexpr size_t kTwo = kSimt > kTensor ? kSimt : kTensor;
  static constexpr size_t kSmem = kTwo > kDecode ? kTwo : kDecode;
};

// Opts a ragged or chunked instance into its dynamic shared memory, and a
// bf16 one into the largest shared-memory carveout (two blocks per SM),
// once per kernel.
template <typename T, int HD, typename Kernel>
cudaError_t configure(Kernel kernel, bool* configured) {
  if (*configured) return cudaSuccess;
  if (PagedKernel<T, HD>::kMma) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  return allow_smem(kernel, PagedKernel<T, HD>::kSmem, configured);
}

// Dynamic shared memory, in bytes, of a ragged or chunked instance for head
// dim HD and dtype (0 float32, 1 bfloat16); 0 for a head dim the kernels do
// not take.
inline int paged_smem_bytes(int HD, int dtype) {
  switch (HD) {
    case 16:
      return static_cast<int>(dtype ? PagedKernel<__nv_bfloat16, 16>::kSmem
                                    : PagedKernel<float, 16>::kSmem);
    case 32:
      return static_cast<int>(dtype ? PagedKernel<__nv_bfloat16, 32>::kSmem
                                    : PagedKernel<float, 32>::kSmem);
    case 64:
      return static_cast<int>(dtype ? PagedKernel<__nv_bfloat16, 64>::kSmem
                                    : PagedKernel<float, 64>::kSmem);
    case 128:
      return static_cast<int>(dtype ? PagedKernel<__nv_bfloat16, 128>::kSmem
                                    : PagedKernel<float, 128>::kSmem);
    default:
      return 0;
  }
}

}  // namespace paged
