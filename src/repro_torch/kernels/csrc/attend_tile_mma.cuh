// A bf16 attention tile on Hopper's tensor cores (sm_90a): the counterpart
// of paged::attend_tile (paged_attention_common.cuh) with the same
// arguments, row layout and arithmetic.  flash_attention.cu runs every bf16
// tile on it; the ragged and chunked paged-attention kernels run on it the
// bf16 tiles of owners with two or more query lanes (prefill chunks), and
// keep decode lanes on attend_tile (paged_attention_mma.cuh says why).
//
// Bound on the H100: operations, 4 x rows x keys x HD at 989 TFLOP/s in
// bf16.  attend_tile runs both products as scalar f32 FMAs on operands
// widened in shared memory, so shared-memory bandwidth holds it near 10
// TFLOP/s.  This tile:
//   * runs S = Q K^T and O += P V on the tensor cores, 128 query rows per
//     block of 8 warps, each warp owning 16 rows.  Two ways, by head dim:
//       - HD 64 and 128: wgmma m64nNk16 per warpgroup (4 warps, 64 rows),
//         Q, K and V read by the tensor cores straight from shared memory,
//         no ldmatrix, in the 128-byte swizzled layout that is wgmma's
//         canonical one;
//       - HD 16 and 32, narrower than that swizzle's 64 columns: mma.sync
//         m16n8k16 per warp, Q loaded once through ldmatrix and held in
//         registers, K through ldmatrix, V through ldmatrix.trans, rows
//         padded by 16 bytes so the 8 rows an ldmatrix reads fall in 8 bank
//         groups;
//     either way the f32 score fragment, rounded to bf16, is the A operand
//     of the PV product as it lies in registers, so P never touches shared
//     memory;
//   * keeps K and V in bf16 in shared memory and streams 64 keys per stage
//     through a two-stage ring filled by 16-byte cp.async.cg copies
//     (commit_group / wait_group): the next stage's copies are in flight
//     while this stage's products run, one barrier per stage.  Each thread
//     copies one key row's K and V chunks, its address computed from the
//     page list and the pool's strides as attend_tile computes it; keys
//     past the list or at or past kvl, and Q rows past nrows, are
//     zero-filled (source size 0), so no stale shared memory reaches a
//     product (0 x NaN would be NaN where the mask holds);
//   * masks per element only where it must: a warp (under wgmma its
//     warpgroup) skips a stage whose keys all lie above every one of its
//     rows (exact: a fully masked update leaves m, l and acc unchanged);
//     a warp computes a stage whose keys all lie at or below every one of
//     its rows without the mask; and the accumulator is rescaled only when
//     a row's max moved (acc * 1 is acc).
// The arithmetic is _flash_kernel's (src/repro/kernels/flash_attention/
// kernel.py:24-63) in its order: score = dot * scale in f32; a masked
// score is -1e30 and its weight is set to 0; per row m and l in f32 with
// corr = exp(m_prev - m_new); l sums the unrounded weights, which are
// rounded to bf16 only as the PV operand; out = acc / max(l, 1e-30),
// rounded to bf16.  The exponentials are exp2 with log2(e) folded in (one
// FFMA and one MUFU.EX2, flushing subnormal results to 0) where
// attend_tile calls expf.  No atomics: two calls give the same bits.
//
// Left for later: TMA copies with mbarriers, warp specialisation (a
// producer warp, consumer warpgroups that overlap one's softmax with the
// other's products), a persistent grid.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "paged_attention_common.cuh"

namespace paged {

constexpr int kMmaThreads = 256;   // 8 warps x 16 query rows
constexpr int kMmaRows = 128;      // query rows (lane, head) per block
constexpr int kMmaKeys = 64;       // keys per pipeline stage
constexpr int kMmaStages = 2;

// Whether attend_tile_mma<HD> runs its products as wgmma (else mma.sync).
__host__ __device__ constexpr bool mma_wgmma(int hd) { return hd >= 64; }

// Bytes of one row of Q, K or V in shared memory: unpadded in 128-byte
// swizzled atoms for wgmma, padded by 16 bytes for mma.sync.
template <int HD>
__host__ __device__ constexpr int mma_row_bytes() {
  return (mma_wgmma(HD) ? HD : HD + 8) * 2;
}

// Dynamic shared memory of attend_tile_mma: Q, then the K and V rings
// (and 1 KB to start wgmma's swizzle atoms at a 1024-byte boundary).
template <int HD>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(kMmaRows + 2 * kMmaStages * kMmaKeys) *
             mma_row_bytes<HD>() + (mma_wgmma(HD) ? 1024 : 0);
}

namespace mma {

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !full.
__device__ __forceinline__ void copy16(uint32_t dst, const void* src,
                                       bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A wgmma shared-memory descriptor for the 128-byte swizzle is two words.
// The low word holds the start address and the leading-dimension byte
// offset (for an N-major operand, between its 64-column atoms); the high
// word the stride-dimension byte offset (between 8-row groups of 128-byte
// rows: 1024) and the swizzle mode.
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | (lbo >> 4) << 16;
}
constexpr uint32_t kDescHi = (1024 >> 4) | 1u << 30;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared memory written through the generic proxy (cp.async) becomes
// visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Pins a wgmma accumulator register: no read of it moves above this point.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// S (64 x 64 keys, f32) = Q (64 x 16, smem) K^T (16 x 64, smem), this
// warp's 16 rows in m16n8 accumulator order: d[j] holds keys 8j..8j+7.
// The descriptors' low words are a + ao and b + bo, added here so that the
// compiler keeps one base register per operand; hi is their shared high
// word.  Adds to d when accumulate != 0.
__device__ __forceinline__ void wgmma_qk(float (&d)[8][4], uint32_t a,
                                         uint32_t ao, uint32_t b, uint32_t bo,
                                         uint32_t hi, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 la, lb;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "add.u32 la, %32, %33;\nadd.u32 lb, %34, %35;\n"
      "mov.b64 da, {la, %36};\nmov.b64 db, {lb, %36};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a), "r"(ao), "r"(b), "r"(bo), "r"(hi), "r"(accumulate));
}

// acc (64 x N, f32) += P (64 x 16 keys, registers: this warp's 16 rows
// as the m16n8k16 A fragment) V (16 keys x N, smem, N-major); the
// descriptor of V as its low word b + bo and its high word.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4], uint32_t b,
                                         uint32_t bo, uint32_t hi);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint32_t b, uint32_t bo,
                                             uint32_t hi) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 lb;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %39, 0;\nadd.u32 lb, %36, %37;\n"
      "mov.b64 db, {lb, %38};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(bo),
        "r"(hi), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint32_t b, uint32_t bo,
                                             uint32_t hi) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 lb;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %71, 0;\nadd.u32 lb, %68, %69;\n"
      "mov.b64 db, {lb, %70};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(bo),
        "r"(hi), "r"(1));
}

// 2^x, flushing subnormal results to 0 (one MUFU.EX2).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16, lo in the low half: one A-operand register.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace mma

// One query tile in bf16 on the tensor cores, kMmaThreads threads,
// mma_smem_bytes<HD>() bytes of dynamic shared memory at smem (16-byte
// aligned).  HD 64 and 128 run the products as wgmma of the block's two
// warpgroups, HD 16 and 32 as mma.sync of each warp.  The
// arguments are attend_tile's, except that row_pos is a callable:
// row_pos(r) is row r's sequence position.  Rows r < nrows (nrows <=
// kMmaRows) are (lane lane0 + r / G, q head kvh * G + r % G) of q (lanes,
// H, HD); all belong to one owner whose pages are list_blk/list_pos[0,
// count) and which holds kvl keys.  Row r attends to key positions kp <
// kvl with kp <= row_pos(r); a row with no valid key writes 0.
// Synchronises before it reads the list (and so before it reuses shared
// memory), and has no copy or product in flight when it returns.
template <int HD, typename RowPos>
__device__ __forceinline__ void attend_tile_mma(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    int H, int G, int kvh, int lane0, int nrows, RowPos row_pos, int kvl,
    const int* __restrict__ list_blk, const int* __restrict__ list_pos,
    int count, int BS, const Pool<__nv_bfloat16>& pool, float scale,
    void* smem) {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128, "head dim");
  constexpr bool kWgmma = mma_wgmma(HD);
  using bf16 = __nv_bfloat16;
  constexpr int kWarps = kMmaThreads / 32;
  constexpr int TPK = kMmaThreads / kMmaKeys;  // threads per key row
  constexpr int CPR = HD / 8;              // 16-byte chunks per row
  constexpr int KSTEPS = HD / 16;          // k steps of Q K^T
  // Row r, 16-byte chunk c of a region of n rows lies at at(n, r, c):
  // padded rows for mma.sync; for wgmma, atoms of 64 columns x n rows of
  // 128 bytes, chunk c of row r at chunk c ^ (r % 8) of its atom row.
  constexpr uint32_t kRowB = mma_row_bytes<HD>();
  auto at = [](int n, int r, int c) -> uint32_t {
    if constexpr (kWgmma)
      return (c >> 3) * (n * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    else
      return r * kRowB + c * 16;
  };
  constexpr uint32_t kStageBytes = kMmaKeys * kRowB;
  constexpr int NT = kMmaKeys / 8;         // 8-key n tiles of S
  constexpr float kLog2e = 1.4426950408889634f;
  const uint32_t sQ = kWgmma ? (mma::shared_addr(smem) + 1023) & ~1023u
                             : mma::shared_addr(smem);
  const uint32_t sK = sQ + kMmaRows * kRowB;
  const uint32_t sV = sK + kMmaStages * kStageBytes;
  __shared__ __align__(16) int sKeyPos[kMmaStages][kMmaKeys];
  // per loading warp
  __shared__ __align__(16) int sKeyMin[kMmaStages][kWarps];
  __shared__ __align__(16) int sKeyMax[kMmaStages][kWarps];
  __shared__ __align__(16) int sWarpHi[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;     // MMA fragment coordinates
  const int nkeys = count * BS;
  const bf16* k_head = pool.k + kvh * pool.sh;
  const bf16* v_head = pool.v + kvh * pool.sh;

  __syncthreads();   // the list is written; earlier reads of smem are done

  for (int idx = tid; idx < kMmaRows * CPR; idx += kMmaThreads) {
    const int r = idx / CPR, c = idx - (idx / CPR) * CPR;
    const bool ok = r < nrows;
    const bf16* src =
        ok ? q + (static_cast<size_t>(lane0 + r / G) * H + kvh * G + r % G) *
                     HD + c * 8
           : q;
    mma::copy16(sQ + at(kMmaRows, r, c), src, ok);
  }

  // Thread tid copies key row tid / TPK of a stage, chunks tid % TPK +
  // TPK i of its K and of its V row.
  auto load_stage = [&](int stage, int k0) {
    const int kk = tid / TPK, part = tid % TPK;
    const int kr = k0 + kk;
    int kp = INT_MAX;
    long long off = 0;
    if (kr < nkeys) {
      const int c = kr / BS, o = kr - (kr / BS) * BS;
      kp = list_pos[c] * BS + o;
      off = list_blk[c] * pool.sb + o * pool.sr;
    }
    const bool ok = kp < kvl;
    if (!ok) kp = INT_MAX;
#pragma unroll
    for (int c = part; c < CPR; c += TPK) {
      const uint32_t to = stage * kStageBytes + at(kMmaKeys, kk, c);
      mma::copy16(sK + to, k_head + off + c * 8, ok);
      mma::copy16(sV + to, v_head + off + c * 8, ok);
    }
    if (part == 0) sKeyPos[stage][kk] = kp;
    const int lo = __reduce_min_sync(0xffffffffu, kp);
    const int hi = __reduce_max_sync(0xffffffffu, kp);
    if (lane == 0) {
      sKeyMin[stage][warp] = lo;
      sKeyMax[stage][warp] = hi;
    }
  };

  // This thread's rows: h = 0, 1 is row warp * 16 + g + 8 h.  Row r sees
  // keys kp <= lim: kp < kvl and kp <= row_pos(r); a row past nrows sees
  // none (lim -1).  Over the warp's real rows: the largest lim (a stage of
  // keys all above it is skipped, by the whole warpgroup under wgmma) and
  // the smallest (a stage of keys all at or below it needs no mask).
  int lim[2];
  int hi_lim = -1, lo_lim = INT_MAX;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + g + 8 * h;
    lim[h] = r < nrows ? min(row_pos(r), kvl - 1) : -1;
    hi_lim = max(hi_lim, lim[h]);
    if (r < nrows) lo_lim = min(lo_lim, lim[h]);
  }
  int warp_hi = __reduce_max_sync(0xffffffffu, hi_lim);
  const int warp_lo = __reduce_min_sync(0xffffffffu, lo_lim);
  if constexpr (kWgmma) {
    if (lane == 0) sWarpHi[warp] = warp_hi;
    __syncthreads();
    const int4 w4 = *reinterpret_cast<const int4*>(&sWarpHi[warp & ~3]);
    warp_hi = max(max(w4.x, w4.y), max(w4.z, w4.w));
  }

  uint32_t qf[kWgmma ? 1 : KSTEPS][4];   // mma.sync: Q's A fragments
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // The running max m and sum l of this thread's two rows wait in shared
  // memory between stages: at HD 128 the accumulator (64 registers) and S
  // (32) leave no room for them under two blocks per SM.
  __shared__ float2 sM[kMmaThreads], sL[kMmaThreads];
  sM[tid] = make_float2(kNegInf, kNegInf);
  sL[tid] = make_float2(0.f, 0.f);
  // mma.sync: this lane's ldmatrix row address in Q (its warp's rows,
  // chunk 0), K (keys 0..15, chunk 0) and V (the same)
  const uint32_t q_lane =
      sQ + (warp * 16 + (lane & 15)) * kRowB + (lane >> 4) * 16;
  const uint32_t k_lane = sK + ((lane & 7) + ((lane >> 4) << 3)) * kRowB +
                          ((lane >> 3) & 1) * 16;
  const uint32_t v_lane =
      sV + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kRowB + (lane >> 4) * 16;
  // wgmma: the low descriptor word of this warpgroup's 64 rows of Q
  const uint32_t q_desc = mma::desc_lo(sQ + (warp >> 2) * 64 * 128, 16);

  // Group i holds key tile i (group 0 also Q); tiles past the keys are
  // empty groups.
  const int ntiles = (nkeys + kMmaKeys - 1) / kMmaKeys;
#pragma unroll
  for (int i = 0; i < kMmaStages - 1; ++i) {
    if (i < ntiles) load_stage(i, i * kMmaKeys);
    mma::commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kMmaStages;
    mma::wait<kMmaStages - 2>();           // tile t has landed
    if constexpr (kWgmma) mma::fence_async_shared();
    __syncthreads();                       // ... for every thread, and
                                           // tile t - 1's stage is free
    {
      const int next = t + kMmaStages - 1;
      if (next < ntiles) load_stage(next % kMmaStages, next * kMmaKeys);
      mma::commit();
    }
    if constexpr (!kWgmma) {
      if (t == 0) {
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          mma::ldmatrix_x4(qf[ks], q_lane + ks * 32);
      }
    }
    int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
    for (int w = 0; w < kWarps; w += 4) {
      const int4 lo = *reinterpret_cast<const int4*>(&sKeyMin[st][w]);
      const int4 hi = *reinterpret_cast<const int4*>(&sKeyMax[st][w]);
      kmin = min(kmin, min(min(lo.x, lo.y), min(lo.z, lo.w)));
      kmax = max(kmax, max(max(hi.x, hi.y), max(hi.z, hi.w)));
    }
    // uniform over the warpgroup under wgmma (warp_hi is), so the
    // warpgroup skips the stage's wgmma together
    if (kmin > warp_hi) continue;
    const bool masked = kmax > warp_lo;    // uniform over the warp only
    const uint32_t k_s = st * kStageBytes;   // this stage's K and V
    // S = Q K^T.  s[j][0..1]: row h 0, keys 8 j + 2 tig + {0, 1};
    // s[j][2..3]: row h 1
    float s[NT][4];
    if constexpr (kWgmma) {
      // k step ks: atom ks / 4, 32 bytes into its rows
      const uint32_t k_desc = mma::desc_lo(sK + k_s, 16);
      mma::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint32_t in = (ks & 3) * 32;
        mma::wgmma_qk(s, q_desc, ((ks >> 2) * kMmaRows * 128 + in) >> 4,
                      k_desc, ((ks >> 2) * kMmaKeys * 128 + in) >> 4,
                      mma::kDescHi, ks);
      }
      mma::wgmma_commit();
      mma::wgmma_wait();
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mma::fence_operand(s[j][e]);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          mma::ldmatrix_x4(b, k_lane + k_s + np * 16 * kRowB + ks * 32);
          mma::mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
          mma::mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
        }
      }
    }
    // the score, dot * scale in f32; under the mask -1e30, weight 0
    unsigned valid = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
    if (masked) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int2 kp = *reinterpret_cast<const int2*>(
            &sKeyPos[st][8 * j + 2 * tig]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if ((e & 1 ? kp.y : kp.x) > lim[e >> 1]) {
            s[j][e] = kNegInf;
            valid &= ~(1u << (4 * j + e));
          }
        }
      }
    }
    const float2 m2 = sM[tid];
    const float m[2] = {m2.x, m2.y};
    float mn[2], ml[2], corr[2], ps[2] = {0.f, 0.f};
    bool rescale = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mn[h] = fmaxf(m[h], mx);
      ml[h] = mn[h] * kLog2e;
      corr[h] = mma::ex2((m[h] - mn[h]) * kLog2e);
      rescale |= corr[h] != 1.f;
    }
    // acc * 1 is acc: skip the rescale when no row's max moved
    if (__any_sync(0xffffffffu, rescale)) {
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[i][0] *= corr[0]; acc[i][1] *= corr[0];
        acc[i][2] *= corr[1]; acc[i][3] *= corr[1];
      }
    }
    // O += P V.  The weights of n tiles 2 kt, 2 kt + 1 (keys 16 kt..16 kt
    // + 15), rounded to bf16, are the A operand of key step kt; only a
    // masked stage tests each weight.  masked is uniform over the warp, not
    // over the warpgroup, so under wgmma it chooses how the weights are
    // made and the warpgroup then issues one wgmma sequence together.
    auto weights = [&](auto kMasked, int kt, uint32_t (&pa)[4]) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kt + jj;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = mma::ex2(fmaf(s[j][e], kLog2e, -ml[e >> 1]));
          if (decltype(kMasked)::value && !((valid >> (4 * j + e)) & 1u))
            p[e] = 0.f;
        }
        ps[0] += p[0] + p[1];
        ps[1] += p[2] + p[3];
        pa[2 * jj] = mma::pack_bf16(p[0], p[1]);
        pa[2 * jj + 1] = mma::pack_bf16(p[2], p[3]);
      }
    };
    if constexpr (kWgmma) {
      uint32_t pa[NT / 2][4];
      if (masked) {
#pragma unroll
        for (int kt = 0; kt < NT / 2; ++kt)
          weights(std::true_type{}, kt, pa[kt]);
      } else {
#pragma unroll
        for (int kt = 0; kt < NT / 2; ++kt)
          weights(std::false_type{}, kt, pa[kt]);
      }
      mma::wgmma_fence();                // acc and P are written
#pragma unroll
      for (int kt = 0; kt < NT / 2; ++kt)
        // keys 16 kt..16 kt + 15: two 8-row groups 1024 bytes apart; the
        // head dim's 64-column atoms kMmaKeys * 128 bytes apart
        mma::wgmma_pv<HD>(acc, pa[kt], mma::desc_lo(sV + k_s, kMmaKeys * 128),
                          (kt * 16 * 128) >> 4, mma::kDescHi);
      mma::wgmma_commit();
      mma::wgmma_wait();                 // before the stage is reused
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) mma::fence_operand(acc[i][e]);
    } else {
      auto weights_times_v = [&](auto kMasked) {
#pragma unroll
        for (int kt = 0; kt < NT / 2; ++kt) {
          uint32_t pa[4];
          weights(kMasked, kt, pa);
#pragma unroll
          for (int dp = 0; dp < HD / 16; ++dp) {
            uint32_t b[4];
            mma::ldmatrix_x4_trans(
                b, v_lane + k_s + kt * 16 * kRowB + dp * 32);
            mma::mma_bf16(acc[2 * dp], pa, b[0], b[1]);
            mma::mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
          }
        }
      };
      if (masked)
        weights_times_v(std::true_type{});
      else
        weights_times_v(std::false_type{});
    }
    float l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = ps[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = (h ? sL[tid].y : sL[tid].x) * corr[h] + sum;
    }
    sM[tid] = make_float2(mn[0], mn[1]);
    sL[tid] = make_float2(l[0], l[1]);
  }
  mma::wait<0>();
  const float l[2] = {sL[tid].x, sL[tid].y};

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + g + 8 * h;
    if (row >= nrows) continue;
    const float den = fmaxf(l[h], 1e-30f);
    bf16* dst = out + (static_cast<size_t>(lane0 + row / G) * H + kvh * G +
                       row % G) * HD + 2 * tig;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) = __floats2bfloat162_rn(
          acc[i][2 * h] / den, acc[i][2 * h + 1] / den);
  }
}

}  // namespace paged
