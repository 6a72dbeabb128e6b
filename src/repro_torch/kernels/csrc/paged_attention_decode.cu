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
// request's pages in BlockList order (sorted or not), and one block per
// (request, kv head) runs paged::attend_tile over them.
// Bound on the H100: the bytes of the K/V rows the requests hold, plus q
// and out, at 3.35 TB/s.  A tile holds the G query heads of one request
// (G of 64 rows); splitting a long request's keys across blocks is left
// for later.

#include "paged_attention_common.cuh"

namespace {

using paged::kListThreads;
using paged::kRows;
using paged::kThreads;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const paged::Pool<T> pool, T* __restrict__ out,
    const int* __restrict__ seq_lens, const int* __restrict__ list_blk,
    const int* __restrict__ list_pos, const int* __restrict__ counts, int H,
    int KV, int BS, int Tb, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kvl = seq_lens[b];
  const size_t list0 = static_cast<size_t>(b) * Tb;
  paged::attend_tile<T, HD>(q, out, H, H / KV, blockIdx.y, b, H / KV,
                            kvl - 1, kvl, list_blk + list0, list_pos + list0,
                            counts[b], BS, pool, scale, smem);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   void* out, const int* seq_lens, const int* scratch, int B,
                   int H, int KV, int BS, int Tb, long long sb, long long sr,
                   long long sh, float scale, cudaStream_t stream) {
  constexpr size_t smem = paged::smem_floats<HD>() * sizeof(float);
  static bool configured = false;
  const cudaError_t err = paged::allow_smem(decode_attention_kernel<T, HD>,
                                            smem, &configured);
  if (err != cudaSuccess) return err;
  const int* list_blk = scratch;
  const int* list_pos = list_blk + static_cast<size_t>(B) * Tb;
  const int* counts = list_pos + static_cast<size_t>(B) * Tb;
  const paged::Pool<T> pool{static_cast<const T*>(pool_k),
                            static_cast<const T*>(pool_v), sb, sr, sh};
  decode_attention_kernel<T, HD><<<dim3(B, KV), kThreads, smem, stream>>>(
      static_cast<const T*>(q), pool, static_cast<T*>(out), seq_lens,
      list_blk, list_pos, counts, H, KV, BS, Tb, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int HD, const void* q, const void* pool_k,
                      const void* pool_v, void* out, const int* seq_lens,
                      const int* scratch, int B, int H, int KV, int BS,
                      int Tb, long long sb, long long sr, long long sh,
                      float scale, cudaStream_t stream) {
  switch (HD) {
    case 16:
      return launch<T, 16>(q, pool_k, pool_v, out, seq_lens, scratch, B, H,
                           KV, BS, Tb, sb, sr, sh, scale, stream);
    case 32:
      return launch<T, 32>(q, pool_k, pool_v, out, seq_lens, scratch, B, H,
                           KV, BS, Tb, sb, sr, sh, scale, stream);
    case 64:
      return launch<T, 64>(q, pool_k, pool_v, out, seq_lens, scratch, B, H,
                           KV, BS, Tb, sb, sr, sh, scale, stream);
    case 128:
      return launch<T, 128>(q, pool_k, pool_v, out, seq_lens, scratch, B, H,
                            KV, BS, Tb, sb, sr, sh, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  scratch holds 2 * B * Tb + B
// int32: list_blk, list_pos, counts.  q, out, pool_k and pool_v must be
// 16-byte aligned, and sb, sr, sh (the pools' strides in elements over
// blocks, rows and kv heads) multiples of 16 bytes.  dtype: 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError() after the launches (0 = ok).
extern "C" int paged_attention_decode(
    const void* q, const void* pool_k, const void* pool_v, void* out,
    const void* block_list, const void* block_req, const void* block_pos,
    const void* seq_lens, void* scratch, int B, int H, int KV, int HD, int NB,
    int BS, int Tb, long long sb, long long sr, long long sh, int dtype,
    float scale, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kRows || BS < 1 || NB < 1 ||
      Tb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* list_blk = static_cast<int*>(scratch);
  int* list_pos = list_blk + static_cast<size_t>(B) * Tb;
  int* counts = list_pos + static_cast<size_t>(B) * Tb;
  const int* lens = static_cast<const int*>(seq_lens);
  paged::slot_lists_kernel<<<B, kListThreads, 0, st>>>(
      static_cast<const int*>(block_list), static_cast<const int*>(block_req),
      static_cast<const int*>(block_pos), Tb, lens, BS, NB, list_blk,
      list_pos, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0)
    err = launch_hd<float>(HD, q, pool_k, pool_v, out, lens, list_blk, B, H,
                           KV, BS, Tb, sb, sr, sh, scale, st);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(HD, q, pool_k, pool_v, out, lens, list_blk,
                                   B, H, KV, BS, Tb, sb, sr, sh, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
