// The KNN kernels' shared device code for Hopper (sm_90a): what K3 (knn_i8.cu,
// int8 rows) and K2 (knn_bf16.cu, bf16 rows) run around their own row loads,
// in their fused top-k and in their score-only twins.
//
// Each kernel's launch 1 is a persistent grid of 8-warp blocks walking
// 128-row block tiles, each warp 16 rows: the rows are the M side of
// mma.sync m16n8k16 (or, at 64 queries, of one wgmma m64n64k16 per 4
// warps), the queries the N side, staged once per block in shared memory.
// A lane's A fragment of a 64-column block comes from columns 16 t .. 16 t
// + 15 of its rows g and g + 8: k positions 2t, 2t+1 of k-step s are
// columns 16 t + 4 s, +1, and 2t+8, 2t+9 are +2, +3. The queries are
// staged with the same permutation (stage_queries), so dot products are
// unchanged. A tile's sums then go to one of two epilogues:
//
// - the top-k (topk_offer_tile). A (score, row) pair is one 64-bit key in
//   the stable descending sort's order (higher score first, equal scores
//   lower row first, -inf rows ranked like any other), so one integer
//   comparison ranks and breaks ties. Each query keeps, in shared memory,
//   its sorted k best and a candidate buffer; a row enters the buffer only
//   if its key beats the k-th best, and a warp merges a buffer past half
//   full with a bitonic sort, between the block barriers that end each
//   tile. Each block writes its k best per query to a workspace
//   (topk_block_finish); launch 2 (knn_topk_merge_kernel) merges the
//   blocks' lists by the same key.
// - the store (store_tile), for k past the top-k's lists: each warp stages
//   its 16 rows x n queries of scores in shared memory and writes them out
//   row-contiguous per query with 16-byte streaming stores, as the signed
//   64-bit keys of score_key (the selection's order).

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
using u64 = unsigned long long;

constexpr int kWarps = 8;          // warps per block
constexpr int kTileRows = 16;      // slab rows per warp tile (mma M)
constexpr int kMaxQueryTiles = 8;  // n8 query tiles per block (64 queries)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kTopkKMax = 64;         // largest k
constexpr int kMergeThreads = 256;    // launch 2: threads per query
constexpr int kMergeMaxKeys = 4096;   // launch 2: keys sorted at once

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// (score, row) -> a key ordered as the stable descending sort ranks:
// higher score first, on equal scores the lower row. The score's bits map
// to an unsigned order (-0 as +0; a NaN that the card produces ranks
// first, as torch.sort puts it), the row is stored complemented. 0 is no
// key: below every real one.
__device__ __forceinline__ u64 topk_key(float s, long long row) {
  uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | ~static_cast<uint32_t>(row);
}

__device__ __forceinline__ float key_score(u64 key) {
  const uint32_t u = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__device__ __forceinline__ long long key_row(u64 key) {
  return static_cast<long long>(~static_cast<uint32_t>(key));
}

// Bitonic sort of n keys (a power of two) in shared memory, descending, by
// the threads first, first + step, ... of a warp (kBlock false) or block.
template <bool kBlock>
__device__ void sort_desc(u64* a, int n, int first, int step) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = first; i < n / 2; i += step) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const u64 x = a[lo], y = a[hi];
        if ((x < y) == ((lo & size) == 0)) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      if (kBlock)
        __syncthreads();
      else
        __syncwarp();
    }
}

// One query's keys, by one warp: [0, k) its k best, sorted; [k, k + cnt)
// new candidates (cnt past the buffer counts refused appends). Sorts the
// used power-of-two prefix, so [0, k) again holds the k best.
__device__ void merge_list(u64* a, int* cnt, int k, int S, int lane) {
  const int n = k + min(*cnt, S - k);
  int P = 32;
  while (P < n) P <<= 1;
  for (int i = n + lane; i < P; i += 32) a[i] = 0ull;
  __syncwarp();
  sort_desc<false>(a, P, lane, 32);
  if (lane == 0) *cnt = 0;
  __syncwarp();
}

constexpr int kTopkTile = kWarps * kTileRows;  // rows per block tile
// keys a query keeps in shared memory: its k best and a buffer of 128 - k
// candidates (a power of two, for the bitonic merge)
constexpr int kTopkKeys = 128;
// wgmma's B descriptor: bytes between core matrices along k (8 query
// groups of 128 bytes) and along the queries
constexpr uint32_t kWgLbo = 1024, kWgSbo = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wgmma m64n64k16 (f32 += bf16 x bf16): A, the warp's 16 rows, in
// registers in mma.sync's fragment layout; B, 64 queries x 16 k, in shared
// memory without swizzle, K-major: 8 x 8 core matrices of 128 bytes, LBO
// bytes apart along k and SBO along the queries. The sum's layout is
// mma.sync's m16n8 layout for each 8 queries.
__device__ __forceinline__ u64 wg_desc(const void* p, uint32_t lbo,
                                       uint32_t sbo) {
  return static_cast<u64>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<u64>(lbo >> 4) << 16) |
         (static_cast<u64>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_64x64(float (&d)[8][4],
                                            const uint32_t (&a)[4], u64 b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

// Shared memory of launch 1 before any ring: keys [NQ][kTopkKeys], counts
// [NQ], queries [NQ][DP] bf16
size_t topk_lists_smem(int nt, int DP) {
  return static_cast<size_t>(8 * nt) *
         (sizeof(u64) * kTopkKeys + sizeof(int) + sizeof(bf16) * DP);
}

// Launch 1's prologue: the block's NQ queries q0 .. q0 + nq - 1 of q (B,
// D) staged in qs, zero-padded to NQ x DP (the caller's barrier ends it).
// mma.sync (WG false): the 8-byte unit u of query row r sits at unit u ^ (r
// & 3), so the B-fragment reads are free of bank conflicts without
// padding. wgmma: column c (64 j + 16 t + 4 s + 2 hi + e) is k position 2 t
// + e + 8 hi of k-step 4 j + s, stored in core matrix (k chunk 2 (4 j + s),
// query group r / 8) at row r % 8.
template <int NQ, bool WG>
__device__ __forceinline__ void stage_queries(const bf16* q, int q0, int nq,
                                              int D, int DP, bf16* qs) {
  for (int e = threadIdx.x; e < NQ * DP; e += blockDim.x) {
    const int r = e / DP, c = e % DP;
    const bf16 v = r < nq && c < D
                       ? q[static_cast<long long>(q0 + r) * D + c]
                       : __float2bfloat16(0.f);
    if constexpr (WG) {
      const int w = c & 63, kc = 2 * (4 * (c >> 6) + ((w >> 2) & 3)) +
                                 ((w >> 1) & 1);
      qs[(kc * (NQ / 8) + (r >> 3)) * 64 + (r & 7) * 8 + 2 * (w >> 4) +
         (w & 1)] = v;
    } else {
      qs[r * DP + ((((c >> 2) ^ (r & 3))) << 2) + (c & 3)] = v;
    }
  }
}

// The top-k's lists emptied (the caller's barrier ends it)
template <int NQ>
__device__ __forceinline__ void topk_lists_init(u64* keys, int* cnt) {
  for (int e = threadIdx.x; e < NQ * kTopkKeys; e += blockDim.x)
    keys[e] = 0ull;
  for (int e = threadIdx.x; e < NQ; e += blockDim.x) cnt[e] = 0;
}

// A row's score from its dot product, rounded as the plain versions round
// it: dots * fa (cos) or dots * fa - fb (l2sq), -inf where !ok
__device__ __forceinline__ float tile_score(float d, bool ok, float fa,
                                            float fb, bool l2sq) {
  return !ok ? -INFINITY
         : l2sq ? __fsub_rn(__fmul_rn(d, fa), fb)
                : __fmul_rn(d, fa);
}

// One tile's scores into the block's lists, by every thread of the block
// (it ends at a block barrier). acc[n][c] is the dot product of row r0 + 8
// (c >> 1) with query 8 n + 2 t + (c & 1); the row's score is, rounded as
// the plain versions round it, dots * fa (cos) or dots * fa - fb (l2sq),
// -inf where !ok; rows with !in are past the extent's end.
template <int NT>
__device__ __forceinline__ void topk_offer_tile(
    const float (&acc)[NT][4], u64* keys, int* cnt, int k, int nq,
    long long r0, const bool (&in)[2], const bool (&ok)[2],
    const float (&fa)[2], const float (&fb)[2], bool l2sq, int warp,
    int lane) {
  constexpr int S = kTopkKeys;
  const int t = lane & 3;
  const int C = S - k, hw = C / 2;  // buffer size and its merge mark
  // the k-th best score of each of the lane's queries (-inf while a
  // list has fewer than k keys): a cheap first test before the key's
  float ts[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const u64 th = keys[(8 * n + 2 * t + e) * S + k - 1];
      ts[n][e] = th ? key_score(th) : -INFINITY;
    }
  bool crossed = false;  // a buffer this thread appended to is past hw
  // false if not a candidate or appended, true if its query's buffer is
  // full
  auto consider = [&](int n, int c) -> bool {
    const int h = c >> 1, qi = 8 * n + 2 * t + (c & 1);
    if (qi >= nq || !in[h]) return false;
    const float s = tile_score(acc[n][c], ok[h], fa[h], fb[h], l2sq);
    if (s < ts[n][c & 1]) return false;
    const u64 key = topk_key(s, r0 + 8 * h);
    if (key <= keys[qi * S + k - 1]) return false;
    const int pos = atomicAdd(&cnt[qi], 1);
    if (pos >= C) return true;
    keys[qi * S + k + pos] = key;
    crossed |= pos + 1 >= hw;
    return false;
  };
  uint32_t pend = 0;  // bit 4 n + c: waits for a merge
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (consider(n, c)) pend |= 1u << (4 * n + c);
  bool more = pend != 0 || crossed;
  while (__syncthreads_or(more)) {
    for (int qi = warp; qi < nq; qi += kWarps)
      if (cnt[qi] >= hw) merge_list(keys + qi * S, cnt + qi, k, S, lane);
    __syncthreads();
    crossed = false;
    const uint32_t was = pend;
    pend = 0;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (((was >> (4 * n + c)) & 1u) && consider(n, c))
          pend |= 1u << (4 * n + c);
    more = pend != 0 || crossed;
  }
}

// Launch 1's epilogue: final merges (every append is visible after the
// last barrier of topk_offer_tile), then the block's k best keys of its
// queries into ws (gridDim.x, B, k).
__device__ __forceinline__ void topk_block_finish(u64* keys, int* cnt, int k,
                                                  int nq, int B, int q0,
                                                  u64* ws, int warp,
                                                  int lane) {
  constexpr int S = kTopkKeys;
  for (int qi = warp; qi < nq; qi += kWarps)
    if (cnt[qi] > 0) merge_list(keys + qi * S, cnt + qi, k, S, lane);
  __syncthreads();
  for (int e = threadIdx.x; e < nq * k; e += blockDim.x) {
    const int qi = e / k, r = e % k;
    ws[(static_cast<long long>(blockIdx.x) * B + q0 + qi) * k + r] =
        keys[qi * S + r];
  }
}

// The store epilogue's staging: a warp's scores of a query's 16 rows at a
// stride of kStgLd floats, so that the fragment writes (queries 2 t + e,
// rows g, g + 8) fall in 32 distinct banks and each query's rows start
// 16-byte aligned.
constexpr int kStgLd = 20;

// Shared memory of a score kernel before any ring: each warp's staging
// [NQ][kStgLd] f32, then the queries [NQ][DP] bf16
size_t score_lists_smem(int nt, int DP) {
  return static_cast<size_t>(8 * nt) *
         (sizeof(float) * kWarps * kStgLd + sizeof(bf16) * DP);
}

// (score, row) -> the selection's signed 64-bit key
// (ops/knn_kernels.py::score_keys): the high word is the score's bits as
// an order-preserving int32 (sign and magnitude to two's complement, so
// -0 is +0), the low word the row complemented. A higher key ranks first:
// higher score, then lower row.
__device__ __forceinline__ long long score_key(float s, long long row) {
  const int b = __float_as_int(s);
  const int o = b < 0 ? -(b & 0x7FFFFFFF) : b;
  return static_cast<long long>(
      (static_cast<u64>(static_cast<uint32_t>(o)) << 32) |
      static_cast<u64>(~static_cast<uint32_t>(row)));
}

// The store epilogue of one warp's 16-row tile (rows row0 .. row0 + 15 of
// the N), by the warp: acc as topk_offer_tile takes it, scored by
// tile_score into the warp's staging stg, then each query's rows out to
// row q0 + qi of out (B, N), each score as its 64-bit key score_key, four
// rows a lane as two 16-byte streaming stores where vec (N % 4 == 0), else
// one by one. Rows past N are not written.
template <int NT>
__device__ __forceinline__ void store_tile(
    const float (&acc)[NT][4], float* stg, long long* out, bool vec,
    long long N, int q0, int nq, long long row0, const bool (&ok)[2],
    const float (&fa)[2], const float (&fb)[2], bool l2sq, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int h = c >> 1;
      stg[(8 * n + 2 * t + (c & 1)) * kStgLd + g + 8 * h] =
          tile_score(acc[n][c], ok[h], fa[h], fb[h], l2sq);
    }
  __syncwarp();
  for (int e = lane; e < 4 * nq; e += 32) {
    const int qi = e >> 2, p4 = 4 * (e & 3);
    const long long row = row0 + p4;
    if (row >= N) continue;
    const float4 v = *reinterpret_cast<const float4*>(stg + qi * kStgLd + p4);
    long long* o = out + static_cast<long long>(q0 + qi) * N + row;
    const long long k0 = score_key(v.x, row), k1 = score_key(v.y, row + 1),
                    k2 = score_key(v.z, row + 2), k3 = score_key(v.w, row + 3);
    if (vec) {
      __stcs(reinterpret_cast<longlong2*>(o), make_longlong2(k0, k1));
      __stcs(reinterpret_cast<longlong2*>(o) + 1, make_longlong2(k2, k3));
    } else {
      const long long kk[4] = {k0, k1, k2, k3};
      for (int i = 0; i < 4 && row + i < N; ++i) __stcs(o + i, kk[i]);
    }
  }
  __syncwarp();  // the staging is read before the next tile writes it
}

// Launch 2: block q merges the G blocks' k best keys of query q, M keys
// at a time ([0, k) the best so far, [k, M) the next chunk), and writes
// scores and rows.
__global__ void __launch_bounds__(kMergeThreads)
knn_topk_merge_kernel(const u64* ws, int G, int B, int k, int M,
                      float* out_s, long long* out_row) {
  extern __shared__ u64 mk[];
  const int q = blockIdx.x;
  const long long total = static_cast<long long>(G) * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) mk[i] = 0ull;
  for (long long c0 = 0; c0 < total; c0 += M - k) {
    for (int i = threadIdx.x; i < M - k; i += blockDim.x) {
      const long long e = c0 + i;
      mk[k + i] = e < total ? ws[((e / k) * B + q) * k + e % k] : 0ull;
    }
    __syncthreads();
    sort_desc<true>(mk, M, threadIdx.x, blockDim.x);
  }
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    out_s[static_cast<long long>(q) * k + r] = key_score(mk[r]);
    out_row[static_cast<long long>(q) * k + r] = key_row(mk[r]);
  }
}

cudaError_t launch_topk_merge(const u64* ws, int G, int B, int k,
                              float* out_s, long long* out_row,
                              cudaStream_t s) {
  const long long total = static_cast<long long>(G) * k + k;
  int M = 128;
  while (M < kMergeMaxKeys && M < total) M <<= 1;
  knn_topk_merge_kernel<<<B, kMergeThreads, sizeof(u64) * M, s>>>(
      ws, G, B, k, M, out_s, out_row);
  return cudaGetLastError();
}

struct TopkConfig {
  int nt, stg;
  size_t smem;
};

constexpr size_t kMaxSmemTopk = 227 * 1024;  // a block's most on sm_90
// two blocks on one SM: 228 KB less 1 KB the runtime keeps for each
constexpr size_t kTwoBlockSmem = (228 * 1024) / 2 - 1024;

// n8 query tiles per block: enough for B, at most 8
int topk_query_tiles(int B) {
  int nt = 1;
  while (nt < kMaxQueryTiles && 8 * nt < B) nt *= 2;
  return nt;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Launch 1's grid.x on the current device, written to *blocks: the blocks
// of `kernel` resident at `smem` bytes each, at most one per block tile of
// N rows.
template <typename K>
cudaError_t topk_grid(K kernel, size_t smem, long long N, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kWarps * 32, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (N + kTopkTile - 1) / kTopkTile;
  const long long want = static_cast<long long>(per_sm) * sms;
  *blocks = static_cast<int>(tiles < want ? tiles : want);
  return cudaSuccess;
}

}  // namespace
