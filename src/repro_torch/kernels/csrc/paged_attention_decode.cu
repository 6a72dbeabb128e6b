// Decode-shape BlockList paged attention (the paper's vLLM_opt, "gather
// only effectual blocks", Fig 16b), for Hopper (sm_90a).  The paper path
// TransformerLM.decode_step_paged runs it in every layer.
//
// Replaces the TPU kernel paged_attention_pallas / _paged_kernel
// (src/repro/kernels/paged_attention/kernel.py:89 / :30) and computes what
// repro_torch.core.attention_api.paged_attention_opt computes:
//
//   q          (B, H, HD)             float32 or bfloat16, contiguous: one
//              query per request
//   pool_k/v   (NB, BS, KV, HD)       any strides with a contiguous head dim
//   block_list, block_req, block_pos (Tb,) int32: flat BlockList keyed by
//              request; entries with block_req outside [0, B) are padding
//   seq_lens   (B,) int32  valid keys per request
//   out        (B, H, HD)
//
// Request b attends to its keys at positions < seq_lens[b]; q head h reads
// kv head h / G.  A request with no entry writes 0 (the Pallas kernel
// leaves its output unwritten).  The call is the chunked kernel's with
// token_req = arange(B) and token_pos = seq_lens - 1: the mask
// key_pos < seq_len is the same as key_pos <= seq_len - 1.  The TPU kernel
// walks the BlockList sorted by request and resets its accumulators at
// each request's first entry; here paged::slot_lists_kernel compacts each
// request's pages in BlockList order (sorted or not), and every request,
// an owner of one lane, runs on the decode tile (paged_decode_tile.cuh),
// as the ragged and chunked kernels run their decode lanes: its keys cut
// into splits of kSplitKeys, one block per (split, kv head), the splits
// combined in this launch by the last of them to finish.  So a request's
// bits equal the chunked and ragged kernels' on the same lane.
// Bound on the H100: the bytes of the K/V rows the requests hold, plus q
// and out, at 3.35 TB/s.  The splits spread a request's keys over many
// SMs, every warp of a block works on the request's G rows, and the next
// 64 keys' copies are in flight while the current ones are used.

#include "paged_decode_tile.cuh"

namespace {

using paged::kListThreads;
using paged::kRows;
using paged::kThreads;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(T) == 2 && HD <= 64 ? 3 : 1)
    decode_attention_kernel(
    const T* __restrict__ q, const paged::Pool<T> pool, T* __restrict__ out,
    const int* __restrict__ seq_lens, const int* __restrict__ list_blk,
    const int* __restrict__ list_pos, const int* __restrict__ counts,
    int* __restrict__ counters, float* __restrict__ partials, int B, int H,
    int KV, int BS, int Tb, int max_splits, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const auto nsplit = [=](int b) {
    return paged::num_splits(static_cast<long long>(counts[b]) * BS);
  };
  paged::run_splits(gridDim.x, B, nsplit,
                    [&](int b, int split, int w, int h) {
    const int kvl = seq_lens[b];
    const size_t list0 = static_cast<size_t>(b) * Tb;
    paged::decode_split<T, HD>(q, out, H, H / KV, h, b, kvl - 1, kvl,
                               list_blk + list0, list_pos + list0, counts[b],
                               BS, pool, scale, split, nsplit(b), w, KV,
                               max_splits, partials, counters + b * KV + h,
                               smem);
  });
}

// The scratch buffer: list_blk, list_pos (B * Tb each), counts (B), the
// decode tile's arrival counters (B * KV).
template <typename T, int HD>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   void* out, const int* seq_lens, int* scratch,
                   float* partials, int max_splits, int B, int H, int KV,
                   int BS, int Tb, long long sb, long long sr, long long sh,
                   float scale, cudaStream_t stream) {
  using Tile = paged::DecodeTile<T, HD>;
  static bool configured = false;
  const cudaError_t err = paged::allow_smem(
      decode_attention_kernel<T, HD>, Tile::smem_bytes(kRows), &configured);
  if (err != cudaSuccess) return err;
  const int* list_blk = scratch;
  const int* list_pos = list_blk + static_cast<size_t>(B) * Tb;
  const int* counts = list_pos + static_cast<size_t>(B) * Tb;
  int* counters = scratch + (2 * static_cast<size_t>(B) * Tb + B);
  const paged::Pool<T> pool{static_cast<const T*>(pool_k),
                            static_cast<const T*>(pool_v), sb, sr, sh};
  const dim3 grid(
      paged::split_grid_x(max_splits, KV, paged::kDecodeGridBlocks), KV);
  decode_attention_kernel<T, HD>
      <<<grid, kThreads, Tile::smem_bytes(H / KV), stream>>>(
          static_cast<const T*>(q), pool, static_cast<T*>(out), seq_lens,
          list_blk, list_pos, counts, counters, partials, B, H, KV, BS, Tb,
          max_splits, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int HD, const void* q, const void* pool_k,
                      const void* pool_v, void* out, const int* seq_lens,
                      int* scratch, float* partials, int max_splits, int B,
                      int H, int KV, int BS, int Tb, long long sb,
                      long long sr, long long sh, float scale,
                      cudaStream_t stream) {
  switch (HD) {
    case 16:
      return launch<T, 16>(q, pool_k, pool_v, out, seq_lens, scratch,
                           partials, max_splits, B, H, KV, BS, Tb, sb, sr, sh,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, pool_k, pool_v, out, seq_lens, scratch,
                           partials, max_splits, B, H, KV, BS, Tb, sb, sr, sh,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, pool_k, pool_v, out, seq_lens, scratch,
                           partials, max_splits, B, H, KV, BS, Tb, sb, sr, sh,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, pool_k, pool_v, out, seq_lens, scratch,
                            partials, max_splits, B, H, KV, BS, Tb, sb, sr,
                            sh, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  scratch holds
// 2 * B * Tb + B + B * KV int32: list_blk, list_pos, counts and the decode
// tile's arrival counters; partials max_splits x KV x partial_floats(H /
// KV, HD) floats, max_splits >= 1 (the splits over all requests: at most
// ceil(Tb * BS / kSplitKeys) + B).  q, out, pool_k, pool_v and partials
// must be 16-byte aligned, and sb, sr, sh (the pools' strides in elements
// over blocks, rows and kv heads) multiples of 16 bytes.  dtype: 0 =
// float32, 1 = bfloat16.  Returns cudaGetLastError() after the launches
// (0 = ok).
extern "C" int paged_attention_decode(
    const void* q, const void* pool_k, const void* pool_v, void* out,
    const void* block_list, const void* block_req, const void* block_pos,
    const void* seq_lens, void* scratch, void* partials, int B, int H, int KV,
    int HD, int NB, int BS, int Tb, int max_splits, long long sb,
    long long sr, long long sh, int dtype, float scale, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kRows || BS < 1 || NB < 1 ||
      Tb < 0 || max_splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* list_blk = static_cast<int*>(scratch);
  int* list_pos = list_blk + static_cast<size_t>(B) * Tb;
  int* counts = list_pos + static_cast<size_t>(B) * Tb;
  int* counters = counts + B;
  const int* lens = static_cast<const int*>(seq_lens);
  paged::slot_lists_kernel<<<B, kListThreads, 0, st>>>(
      static_cast<const int*>(block_list), static_cast<const int*>(block_req),
      static_cast<const int*>(block_pos), Tb, lens, BS, NB, KV, list_blk,
      list_pos, counts, counters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part = static_cast<float*>(partials);
  int* ints = static_cast<int*>(scratch);
  if (dtype == 0)
    err = launch_hd<float>(HD, q, pool_k, pool_v, out, lens, ints, part,
                           max_splits, B, H, KV, BS, Tb, sb, sr, sh, scale,
                           st);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(HD, q, pool_k, pool_v, out, lens, ints,
                                   part, max_splits, B, H, KV, BS, Tb, sb, sr,
                                   sh, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Dynamic shared memory, in bytes, of the attention instance for head dim
// HD and dtype (0 float32, 1 bfloat16) at G = H / KV query heads per kv
// head; 0 for a head dim or G it does not take.
extern "C" int paged_attention_decode_smem_bytes(int HD, int dtype, int G) {
  if (G < 1 || G > kRows) return 0;
  switch (HD) {
    case 16:
      return static_cast<int>(
          dtype ? paged::DecodeTile<__nv_bfloat16, 16>::smem_bytes(G)
                : paged::DecodeTile<float, 16>::smem_bytes(G));
    case 32:
      return static_cast<int>(
          dtype ? paged::DecodeTile<__nv_bfloat16, 32>::smem_bytes(G)
                : paged::DecodeTile<float, 32>::smem_bytes(G));
    case 64:
      return static_cast<int>(
          dtype ? paged::DecodeTile<__nv_bfloat16, 64>::smem_bytes(G)
                : paged::DecodeTile<float, 64>::smem_bytes(G));
    case 128:
      return static_cast<int>(
          dtype ? paged::DecodeTile<__nv_bfloat16, 128>::smem_bytes(G)
                : paged::DecodeTile<float, 128>::smem_bytes(G));
    default:
      return 0;
  }
}
