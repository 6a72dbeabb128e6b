// The decode tile of the port's three paged-attention kernels, for Hopper
// (sm_90a): one query lane of one owner (a decode lane), the G query heads
// of one kv head, over one split of the owner's keys (flash-decoding).
// paged_attention_mma.cuh says which owners run on it; the ragged, chunked
// and decode kernels (paged_attention_{ragged,chunked,decode}.cu) each run
// its split blocks beside their other tiles, in the same launch.
//
// Bound on the H100: the bytes of the owner's K/V rows at 3.35 TB/s.  A
// decode owner brings only G query rows (3 at smollm-360m, 4 at Fig 17's
// widths), so paged::attend_tile's 64-row tile left 7 of its 8 warps idle
// and walked all the owner's keys in one block per kv head.  This tile:
//   * cuts the owner's compacted key list (list_blk/list_pos, in the order
//     compact_entries gives) into splits of kSplitKeys keys, one block per
//     (split, kv head), so a long owner's keys stream through many SMs at
//     once.  The boundaries depend on the list alone, so the three kernels,
//     and a lane with or without neighbours in its launch, cut the same
//     splits and get the same bits;
//   * streams a split's keys 64 per stage through a cp.async ring of three
//     stages in bf16, two in float32 (K and V in the pool's dtype, rows
//     padded by 16 bytes so 8 neighbouring rows fall in 8 bank groups): the
//     next stages' copies are in flight while this stage's products run,
//     two barriers a stage, and Q is read while the first copies fly.
//     Keys past the split, at or past kvl or above the lane's position are
//     zero-filled and masked;
//   * uses every warp: warp w scores rows w, w + 8, ... (each lane two
//     keys) and takes the row's softmax with warp shuffles; then the PV
//     sums run over (key slice, row, 16-byte chunk of the head dim) on all
//     256 threads, each key slice's sums kept in registers for the whole
//     split and added up once, in slice order, at its end;
//   * combines the splits in the same launch: each split writes its (acc,
//     m, l) to the workspace, and the last split block of an (owner, kv
//     head) to arrive, counted on a counter the launch's list kernel reset,
//     rescales every split by exp(m_s - m) and sums them in split order,
//     never in arrival order, so two calls give the same bits.  An owner of
//     one split writes its output directly.
// The arithmetic is attend_tile's: score = dot * scale in f32; a masked
// key's weight is 0; per row m and l in f32 with corr = exp(m_prev -
// m_new); the weights, relative to the split's running max, are rounded to
// the KV dtype for the PV product (f32 stays on SIMT FMAs, no TF32); out =
// acc / max(l, 1e-30).  Rows with no valid key write 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "attend_tile_mma.cuh"
#include "paged_attention_common.cuh"

namespace paged {

constexpr int kSplitKeys = 256;   // keys per split: whole 64-key stages
// Split blocks per launch over all kv heads, beside other tiles: two per
// SM of the H100, about what the ragged and chunked kernels keep resident.
// They run first in their launch, so a larger grid of mostly idle blocks
// would hold the SMs from the tiles.  The decode kernel, which runs split
// blocks alone, takes eight per SM.  A launch with more splits loops.
constexpr int kSplitGridBlocks = 2 * 132;
constexpr int kDecodeGridBlocks = 8 * 132;
static_assert(kSplitKeys % kKeys == 0, "a split is whole 64-key stages");

// The splits of an owner whose compacted list holds nkeys keys: at least
// one, so an owner with no key still writes its zeros.
__host__ __device__ constexpr int num_splits(long long nkeys) {
  return nkeys <= kSplitKeys
             ? 1
             : static_cast<int>((nkeys + kSplitKeys - 1) / kSplitKeys);
}

// Floats of one split's workspace record for one kv head: acc (G x HD),
// then m (G) and l (G).
__host__ __device__ constexpr int partial_floats(int G, int HD) {
  return G * (HD + 2);
}

// Split blocks along x of a launch whose workspace holds max_splits splits,
// at most `blocks` over all KV kv heads.
inline int split_grid_x(int max_splits, int KV, int blocks) {
  const int cap = blocks / KV > 1 ? blocks / KV : 1;
  return max_splits < cap ? max_splits : cap;
}

template <typename T, int HD>
struct DecodeTile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kChunks = HD / kVec;           // 16-byte chunks a row
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(T)) + 16;
  static constexpr int kStageBytes = kKeys * kRowBytes;
  // stages in the ring: three in bf16 (two in flight during a stage's
  // products); two in float32, whose rows are twice as wide
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  static constexpr int kRing = kStages * kStageBytes;  // K or V
  // (row, chunk) items of the PV sums a thread owns at most (G = kRows)
  static constexpr int kIters =
      kRows * kChunks > kThreads ? kRows * kChunks / kThreads : 1;
  static constexpr int kPStride = kKeys + 1;
  static constexpr size_t kPosOff = 2 * kRing;        // after the K, V rings
  // a split's pages: at most kSplitKeys / BS + 1, kSplitKeys + 1 at BS 1
  static constexpr size_t kPageOff = kPosOff + kStages * kKeys * sizeof(int);
  static constexpr size_t kQOff =
      kPageOff + 2 * (kSplitKeys + 4) * sizeof(int);
  static_assert(2 * kRing >= kThreads * kVec * sizeof(float),
                "the slice sums fit over the rings");

  // Dynamic shared memory at G query rows: the K and V rings, the stages'
  // key positions, the split's pages (pool block and block position), then
  // f32 Q (G x HD), the weights (G x 65) and m, l and corr (G each).
  __host__ __device__ static constexpr size_t smem_bytes(int G) {
    return kQOff + static_cast<size_t>(G) * (HD + kPStride + 3) *
                       sizeof(float);
  }
};

// Block-wide, kThreads threads: the owner and split of the w-th split of a
// launch whose owners 0..n-1 hold nsplit(j) splits each (0 for an owner
// that does not run on the decode tile), numbered in owner order.  Returns
// false, in every thread, when the launch holds w splits or fewer.
template <typename NSplit>
__device__ __forceinline__ bool find_split(int w, int n, NSplit nsplit,
                                           int* owner, int* split) {
  __shared__ int sSum[kThreads / 32];
  __shared__ int sHit[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();                  // the previous call's readers are done
  if (tid == 0) sHit[0] = -1;
  int carry = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int j = base + tid;
    const int c = j < n ? nsplit(j) : 0;
    int incl = c;                   // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) sSum[warp] = incl;
    __syncthreads();
    int first = carry + incl - c;
#pragma unroll
    for (int x = 0; x < kThreads / 32; ++x) {
      const int s = sSum[x];
      if (x < warp) first += s;
      carry += s;
    }
    if (w >= first && w < first + c) {
      sHit[0] = j;
      sHit[1] = w - first;
    }
    __syncthreads();
    if (sHit[0] >= 0) {
      *owner = sHit[0];
      *split = sHit[1];
      return true;
    }
  }
  return false;
}

// Runs run(owner, split, w, kvh) for every split of a launch whose grid is
// (gridDim.x, KV) and whose blocks x < split_x serve the decode tile, over
// owners 0..n-1 of nsplit(j) splits each (find_split).  The items (split w,
// kv head kvh) are numbered kv head fastest and dealt to the split blocks
// in launch order, so the first blocks to run hold the work and the split
// blocks past it exit at once; a launch with more items than split blocks
// loops.  The ragged and chunked kernels put their split blocks before
// their other tiles, so that a step's long prefill tiles do not keep its
// short splits waiting for an SM.
template <typename NSplit, typename Run>
__device__ __forceinline__ void run_splits(int split_x, int n, NSplit nsplit,
                                           Run run) {
  const int KV = gridDim.y;
  int owner, split;
  for (int item = blockIdx.y * split_x + blockIdx.x;
       find_split(item / KV, n, nsplit, &owner, &split);
       item += split_x * KV)
    run(owner, split, item / KV, item % KV);
}

// One split of one decode-tile owner: kThreads threads and
// DecodeTile<T, HD>::smem_bytes(G) bytes of dynamic shared memory at smem.
// The owner's query lane `lane` (a row of q and out, (lanes, H, HD)) sits
// at position row_pos and attends to the key positions kp < kvl with kp <=
// row_pos of its pages list_blk/list_pos[0, count).  This block serves kv
// head kvh and split `split` of the owner's nsplit, the w-th split of the
// launch.  partials holds max_splits x KV records of partial_floats(G, HD)
// floats, indexed w * KV + kvh; counter is the owner's arrival count for
// kvh, which the launch's list kernel reset to 0.  An owner whose splits do
// not fit in partials (only possible if BlockList entries belong to more
// than one owner) writes 0.  The caller synchronises before it reuses
// shared memory.
template <typename T, int HD>
__device__ __forceinline__ void decode_split(
    const T* __restrict__ q, T* __restrict__ out, int H, int G, int kvh,
    int lane, int row_pos, int kvl, const int* __restrict__ list_blk,
    const int* __restrict__ list_pos, int count, int BS, const Pool<T>& pool,
    float scale, int split, int nsplit, int w, int KV, int max_splits,
    float* __restrict__ partials, int* __restrict__ counter,
    unsigned char* smem) {
  using Tile = DecodeTile<T, HD>;
  constexpr int VEC = Tile::kVec, CH = Tile::kChunks;
  constexpr int TPK = kThreads / kKeys;      // threads copying one key row
  const int tid = threadIdx.x, lane_id = tid & 31, warp = tid >> 5;
  const size_t row0 = (static_cast<size_t>(lane) * H + kvh * G) * HD;
  if (nsplit > 1 && w - split + nsplit > max_splits) {   // uniform
    if (split == 0)
      for (int i = tid; i < G * HD; i += kThreads)
        out[row0 + i] = from_f32<T>(0.f);
    return;
  }
  const uint32_t sK = mma::shared_addr(smem);
  const uint32_t sV = sK + Tile::kRing;
  int* sPos = reinterpret_cast<int*>(smem + Tile::kPosOff);   // [stage][64]
  int* sBlk = reinterpret_cast<int*>(smem + Tile::kPageOff);  // split's pages
  int* sPage = sBlk + kSplitKeys + 4;
  float* sQ = reinterpret_cast<float*>(smem + Tile::kQOff);   // [G][HD]
  float* sP = sQ + G * HD;                                    // [G][65]
  float* sM = sP + G * Tile::kPStride;
  float* sL = sM + G;
  float* sCorr = sL + G;

  const int k_begin = split * kSplitKeys;
  const int k_end = min(count * BS, k_begin + kSplitKeys);
  const int ntiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys
                                     : 0;
  // The split's pages, read once: no stage waits on the lists in memory.
  const int c_begin = k_begin / BS;
  for (int c = c_begin + tid; c < (k_end + BS - 1) / BS; c += kThreads) {
    sBlk[c - c_begin] = list_blk[c];
    sPage[c - c_begin] = list_pos[c];
  }
  __syncthreads();
  const int lim = min(row_pos, kvl - 1);     // valid keys: kp <= lim
  const long long head = kvh * pool.sh;
  const int kk = tid / TPK, part = tid % TPK;
  // This thread's share of stage st (keys k0 + kk): TPK threads a key row,
  // its K and V chunks part, part + TPK, ...; invalid keys zero-filled and
  // their position INT_MAX.
  const auto load_stage = [&](int st, int k0) {
    const int kr = k0 + kk;
    int kp = INT_MAX;
    long long off = 0;
    if (kr < k_end) {
      const int c = kr / BS, o = kr - c * BS;
      kp = sPage[c - c_begin] * BS + o;
      off = sBlk[c - c_begin] * pool.sb + o * pool.sr + head;
    }
    const bool ok = kp <= lim;
    const uint32_t to = st * Tile::kStageBytes + kk * Tile::kRowBytes;
#pragma unroll
    for (int c = part; c < CH; c += TPK) {
      mma::copy16(sK + to + c * 16, pool.k + off + c * VEC, ok);
      mma::copy16(sV + to + c * 16, pool.v + off + c * VEC, ok);
    }
    if (part == 0) sPos[st * kKeys + kk] = ok ? kp : INT_MAX;
  };

  // The PV items: (key slice ks, item it = g * CH + c) for u = tid + j *
  // kThreads, ks = u / items; ns key slices, the most (a power of two, at
  // most kKeys) with ns * items <= kThreads; slice ks takes the stage's
  // keys ks, ks + ns, ...
  const int items = G * CH;
  int ns = 1;
  while (ns < kKeys && 2 * ns * items <= kThreads) ns *= 2;
  float acc[Tile::kIters][VEC];
#pragma unroll
  for (int j = 0; j < Tile::kIters; ++j)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[j][v] = 0.f;

  // Group i holds stage i; stages past the split are empty groups.  Q is
  // read while the first stages' copies are in flight.
#pragma unroll
  for (int i = 0; i < Tile::kStages - 1; ++i) {
    if (i < ntiles) load_stage(i, k_begin + i * kKeys);
    mma::commit();
  }
  for (int i = tid; i < G * CH; i += kThreads)   // G heads, contiguous
    Vec<T>::load(q + row0 + i * VEC, sQ + i * VEC);
  if (tid < G) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % Tile::kStages;
    mma::wait<Tile::kStages - 2>();  // stage t has landed (this thread's)
    __syncthreads();                 // ... every thread's; stage t - 1 read
    {
      const int next = t + Tile::kStages - 1;
      if (next < ntiles)
        load_stage(next % Tile::kStages, k_begin + next * kKeys);
      mma::commit();
    }

    // Scores and softmax: warp w takes rows w, w + 8, ..., lane l keys l
    // and l + 32.
    const unsigned char* kst = smem + st * Tile::kStageBytes;
    const T* k0 = reinterpret_cast<const T*>(kst + lane_id * Tile::kRowBytes);
    const T* k1 =
        reinterpret_cast<const T*>(kst + (lane_id + 32) * Tile::kRowBytes);
    const bool ok0 = sPos[st * kKeys + lane_id] != INT_MAX;
    const bool ok1 = sPos[st * kKeys + lane_id + 32] != INT_MAX;
    for (int g = warp; g < G; g += kThreads / 32) {
      const float* qg = sQ + g * HD;
      float e0[4] = {0.f, 0.f, 0.f, 0.f}, e1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float a[VEC], b[VEC];
        Vec<T>::load(k0 + c * VEC, a);
        Vec<T>::load(k1 + c * VEC, b);
#pragma unroll
        for (int v = 0; v < VEC; v += 4) {    // four sums a key, dim % 4
          const float4 x = *reinterpret_cast<const float4*>(qg + c * VEC + v);
          e0[0] += x.x * a[v];
          e0[1] += x.y * a[v + 1];
          e0[2] += x.z * a[v + 2];
          e0[3] += x.w * a[v + 3];
          e1[0] += x.x * b[v];
          e1[1] += x.y * b[v + 1];
          e1[2] += x.z * b[v + 2];
          e1[3] += x.w * b[v + 3];
        }
      }
      const float d0 = (e0[0] + e0[1]) + (e0[2] + e0[3]);
      const float d1 = (e1[0] + e1[1]) + (e1[2] + e1[3]);
      const float s0 = ok0 ? d0 * scale : kNegInf;
      const float s1 = ok1 ? d1 * scale : kNegInf;
      float tmax = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, tmax);
      const float corr = expf(m_old - m_new);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      float psum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      sP[g * Tile::kPStride + lane_id] = round_to<T>(p0);
      sP[g * Tile::kPStride + lane_id + 32] = round_to<T>(p1);
      const float l_new = sL[g] * corr + psum;
      __syncwarp();                  // every lane has read m and l
      if (lane_id == 0) {
        sM[g] = m_new;
        sL[g] = l_new;
        sCorr[g] = corr;
      }
    }
    __syncthreads();                 // the weights and corr are written

    const unsigned char* vst = smem + Tile::kRing + st * Tile::kStageBytes;
#pragma unroll
    for (int j = 0; j < Tile::kIters; ++j) {
      const int u = tid + j * kThreads, ks = u / items;
      if (ks >= ns) continue;
      const int it = u - ks * items, g = it / CH, c = it - g * CH;
      const float corr = sCorr[g];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[j][v] *= corr;
      const float* pg = sP + g * Tile::kPStride;
      for (int k = ks; k < kKeys; k += ns) {
        float vv[VEC];
        Vec<T>::load(
            reinterpret_cast<const T*>(vst + k * Tile::kRowBytes) + c * VEC,
            vv);
        const float p = pg[k];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[j][v] += p * vv[v];
      }
    }
  }
  mma::wait<0>();
  __syncthreads();                   // the rings are free; m and l final

  if (ns > 1) {                      // items <= kThreads / 2: j = 0 only
    float* red = reinterpret_cast<float*>(smem);   // [ns][items][VEC]
    if (tid < ns * items)
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[tid * VEC + v] = acc[0][v];
    __syncthreads();
    if (tid < items) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float o = red[tid * VEC + v];
        for (int ks = 1; ks < ns; ++ks) o += red[(ks * items + tid) * VEC + v];
        acc[0][v] = o;
      }
    }
  }
  // Item u of this thread: its row's sums, final over the split.
  float* rec = partials + (static_cast<size_t>(w) * KV + kvh) *
                              partial_floats(G, HD);
#pragma unroll
  for (int j = 0; j < Tile::kIters; ++j) {
    const int u = tid + j * kThreads;
    if (u >= items) continue;
    if (nsplit == 1) {
      const float den = fmaxf(sL[u / CH], 1e-30f);
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        out[row0 + u * VEC + v] = from_f32<T>(acc[j][v] / den);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) rec[u * VEC + v] = acc[j][v];
    }
  }
  if (nsplit == 1) return;
  if (tid < G) {
    rec[G * HD + tid] = sM[tid];
    rec[G * HD + G + tid] = sL[tid];
  }
  __shared__ int sLast;
  __threadfence();                   // this split's record is visible ...
  __syncthreads();
  if (tid == 0) sLast = atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!sLast) return;                // ... before the last split combines
  __threadfence();
  // The owner's splits w0 .. w0 + nsplit - 1, in split order.
  const size_t stride = static_cast<size_t>(KV) * partial_floats(G, HD);
  const float* first = partials + (static_cast<size_t>(w - split) * KV + kvh) *
                                      partial_floats(G, HD);
  for (int u = tid; u < G * HD; u += kThreads) {
    const int g = u / HD;
    float m = kNegInf;
    for (int s = 0; s < nsplit; ++s)
      m = fmaxf(m, __ldcg(first + s * stride + G * HD + g));
    float o = 0.f, l = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float* r = first + s * stride;
      const float f = expf(__ldcg(r + G * HD + g) - m);
      o += f * __ldcg(r + u);
      l += f * __ldcg(r + G * HD + G + g);
    }
    out[row0 + u] = from_f32<T>(o / fmaxf(l, 1e-30f));
  }
}

}  // namespace paged
