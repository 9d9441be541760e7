// The int8 KNN slab's kernels for Hopper (sm_90a), bound to Python
// with ctypes (ops/knn_kernels.py).
//
// K3 top-k, the int8 score fused with the top-k: replaces the whole of
// pathway_tpu/ops/knn.py::_shared_search_i8_fn (an XLA function on the
// TPU: score block, lax.top_k per 2^19-row chunk and the merge of
// _chunked_search) for one extent and k <= 64. For queries q (B, D) bf16,
// already normalised for cos and cast, and N int8 rows with per-row f32
// `scales` and int-domain squared norms `vsq`:
//   dots = q . bf16(v)   (int8 widens to bf16 exactly, products are exact
//                         in f32, sums in f32)
//   cos:  dots * rsqrt(vsq + 1e-12)            (the row scale cancels)
//   l2sq: 2 dots scale - vsq scale^2           (-||q - v||^2 + ||q||^2)
//   invalid rows: -inf,
// each rounded as the plain version rounds it; the result is the k best
// rows per query in the stable descending sort's order: higher score
// first, equal scores lower row first, -inf (invalid) rows ranked like
// any other. Bound: the slab read, N (D + 5) bytes, since no score reaches
// device memory.
//
// K3 score, the same scores written out for k > 64 (a filter's escalated
// fetch), each as the selection's 64-bit key (score_key), (B, N) int64:
// the score block of _shared_search_i8_fn, which
// ops/knn.py::search_extent calls per 2^19-row chunk (the reference's
// _CHUNK_ROWS) before an exact selection (torch.topk of the keys). Bound:
// the slab read and the key write, N (D + 5) + 8 B N bytes; the write is
// 57% of it at B = 64, so it leaves as full 16-byte stores.
//
// Both are one launch-1 mainloop (i8_rows) with two epilogues. A
// persistent grid of two 8-warp blocks an SM walks 128-row block tiles,
// each warp 16 rows (mma.sync m16n8k16; at 33-64 queries a block one
// wgmma m64n64k16 per 4 warps, which reads the queries once for the 4); at
// B <= 8 the rows stream through a cp.async ring in shared memory, else
// through registers loaded ahead across a tile's end (see i8_config).
// Codes widen to bf16 with no conversion instruction (byte permutes and
// one bf16x2 subtraction per pair). K3 top-k's epilogue is the running
// top-k of knn_topk.cuh (the block's lists, a workspace, and launch 2,
// which merges the blocks' lists); K3 score's is knn_topk.cuh's store
// epilogue: each warp stages its 16 rows x n queries in shared memory and
// writes each query's rows contiguously with streaming 16-byte stores. The
// keys, lists, merges, wgmma helpers, query staging and both epilogues
// live in knn_topk.cuh, shared with K2 (knn_bf16.cu).
//
// K4, the quantizing scatter: replaces
// pathway_tpu/ops/knn.py::_quantize_i8 inside _shared_scatter_i8_fn and
// the int8 fused-ingest step. For each row v of `rows` (n, D) f32 with a
// local slot:
//   m = max|v|; scale = max(m * f32(1/127), 1e-30);
//   q = clamp(rint(v / scale), -127, 127)   (round half to even);
//   vsq = float(sum q^2) summed in int32;
// and q, scale, vsq, valid are written in place at the slot. A slot
// outside [0, R) (the sentinel slot of a ragged padding row) is a no-op.
// The scale is the JAX package's `m / 127.0` as XLA compiles it (a
// multiply by the rounded reciprocal); v / scale is an IEEE division
// (__fdiv_rn, whatever the flags) and rint rounds half to even, so codes,
// scales and vsq are bit-identical to what the JAX index stores. Bytes
// bound it: per row 4 D read, D + 9 written (codes, scale, vsq, valid)
// and its 8-byte slot. So each row is read once, at full width: a lane
// loads its share as 16-byte float4s into registers (3 at D = 384), the
// max and the codes both come from those registers, and a lane stores its
// codes as packed 4-byte words, so one warp store writes 128 contiguous
// bytes. A warp takes kQuantRows rows: all their loads issue before the
// first reduction, and the rows' shuffles interleave. Rows
// with D % 4 != 0, a row stride that is not a multiple of 4 floats or an
// unaligned base take the scalar body (one warp a row, lane-strided
// 4-byte loads, read twice), which gives the same bits: a max and an
// integer sum do not depend on their order.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "knn_topk.cuh"

namespace {

// ------------------------------------------------------------------------
// K3: int8 score + top-k, and the score alone (shared parts: knn_topk.cuh)
// ------------------------------------------------------------------------

// 16 bytes of slab row `row` from column `col`; zero past N rows or D
// columns. `vec` (D % 16 == 0 and a 16-byte aligned base) takes one
// streaming 16-byte load, else bytes one by one.
__device__ __forceinline__ uint4 load16(const int8_t* slab, long long row,
                                        long long N, int D, int col,
                                        bool vec) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (row >= N || col >= D) return out;
  const int8_t* p = slab + row * D + col;
  if (vec) return __ldcs(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && col + i < D; ++i)
    w[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[i]))
                 << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// a - b on bf16 pairs (as a + b * -1), exact on the integers used here
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(b), "r"(0xBF80BF80u), "r"(a));
  return d;
}

// The four int8 codes of w -> bf16 pairs (bytes 0-1 -> lo, 2-3 -> hi),
// exact, with no integer-to-float conversion (a quarter-rate pipe that
// would take ~90% of its issue at HBM rate): a code c is
// (128 + (c & 127)) - (128 + (c & 128)), two bf16 of exponent 2^7 whose
// mantissas are byte permutes of c, and one bf16x2 subtraction.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t m = w & 0x7F7F7F7Fu, s = w & 0x80808080u;
  lo = bf16x2_sub(__byte_perm(m, 0x43u, 0x4140),
                  __byte_perm(s, 0x43u, 0x4140));
  hi = bf16x2_sub(__byte_perm(m, 0x43u, 0x4342),
                  __byte_perm(s, 0x43u, 0x4342));
}

struct I8Params {
  const bf16* q;
  const int8_t* slab;
  const float* scales;
  const float* vsq;
  const uint8_t* valid;
  u64* ws;    // top-k: (gridDim.x, B, k), each block's k best keys per query
  long long* out;  // score: (B, N) keys score_key(score, row)
  long long N;
  int B, D, DP, metric, k;
  bool vec;   // D % 16 == 0 and a 16-byte aligned slab
  bool vec_out;  // score: N % 4 == 0 (16-byte stores)
};

// Shared memory of launch 1 before the ring (the top-k's lists or the
// score's staging, then the queries), then (stg > 0) the ring: stg stages
// of each warp's 16 rows x DP
size_t i8_smem(bool store, int nt, int DP, int stg) {
  return (store ? score_lists_smem(nt, DP) : topk_lists_smem(nt, DP)) +
         static_cast<size_t>(stg) * kTopkTile * DP;
}

// Launch 1's mainloop, for K3 top-k and K3 score alike. Each warp scores
// 16 rows of a block tile against the block's NT n8 query tiles, staged in
// qs, and hands each tile's sums to epi(acc, r0, in, ok, fa, fb). STG = 0:
// a lane loads its 16-byte pieces of the rows into registers, two
// 64-column blocks ahead (any D); STG = 2 (vec): each warp streams its rows
// into a ring of STG stages in shared memory with cp.async, a tile ahead,
// in 512-byte contiguous requests that hold no registers while in flight.
// The products are mma.sync m16n8k16, one per warp and n8 query tile, or
// at 64 queries (WG) one wgmma m64n64k16 per 4 warps, which reads the
// queries from shared memory once for the 4 and issues 1/32 the
// instructions.
template <int NT, int STG, bool WG, typename Epi>
__device__ __forceinline__ void i8_rows(const I8Params& p, const bf16* qs,
                                        int8_t* ring, Epi&& epi) {
  constexpr int NQ = 8 * NT;  // queries per block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nj = p.DP / 64;
  const bf16* qrow = qs + g * p.DP;
  const long long stride = static_cast<long long>(gridDim.x) * kTopkTile;
  // ring rows: the 16-byte chunk c of an odd row sits at chunk c ^ sw_odd,
  // so that the rows g and g + 1 a quarter-warp reads fall in distinct
  // banks (a row of 64 odd-many bytes is already offset by half the banks)
  const int sw_odd = (p.DP / 64) & 1 ? 0 : 4;
  const int cpr = max(p.D / 16, 1);  // the chunks of a row holding codes
  // chunk e = lane + 32 i of a warp's 16 contiguous rows is chunk c of
  // row r, stepped without a division
  const int r_lane = lane / cpr, c_lane = lane % cpr;
  const int r_step = 32 / cpr, c_step = 32 % cpr;
  auto issue = [&](long long tile0, int stage) {
    const long long r0w = tile0 + warp * kTileRows;
    int8_t* dst = ring + (stage * kWarps + warp) * kTileRows * p.DP;
    const int8_t* src = p.slab + r0w * p.D;
    const long long rows = p.N - r0w;
    const int n = static_cast<int>(
        rows < kTileRows ? rows : static_cast<long long>(kTileRows)) * cpr;
    int r = r_lane, c = c_lane;
    for (int e = lane; e < n; e += 32) {
      cp_async16(dst + r * p.DP + 16 * (c ^ (r & 1 ? sw_odd : 0)),
                 src + 16 * e);
      r += r_step;
      c += c_step;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  };
  if constexpr (STG > 0) {
    for (int st = 0; st + 1 < STG; ++st) {
      const long long tile0 =
          static_cast<long long>(blockIdx.x) * kTopkTile + st * stride;
      if (tile0 < p.N) issue(tile0, st);
      cp_async_commit();
    }
  }

  // each row's vsq, scale (l2sq) and validity, loaded a tile ahead of its
  // use (a load at the tile's start would stall every warp at the block
  // barrier that ends the top-k's tile)
  float vs_n[2], sc_n[2];
  bool ok_n[2];
  auto load_rows = [&](long long r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = r + 8 * h;
      const bool in = row < p.N;
      vs_n[h] = in ? p.vsq[row] : 0.f;
      sc_n[h] = in && p.metric ? p.scales[row] : 0.f;
      ok_n[h] = in && p.valid[row] != 0;
    }
  };
  load_rows(static_cast<long long>(blockIdx.x) * kTopkTile +
            warp * kTileRows + g);
  // register path: the 64-column blocks j + 1 and j + 2 load while j
  // multiplies (two ahead measured faster than one, three or five at
  // B = 64), and past a tile's end they are the next tile's first blocks,
  // so loads stay in flight through the epilogue
  constexpr int PF = 2;
  uint4 va[PF + 1], vb[PF + 1];
  auto load_ahead = [&](long long r0cur, int jn, uint4& a, uint4& b) {
    long long r = r0cur;
    while (jn >= nj) {  // a later tile
      jn -= nj;
      r += stride;
    }
    a = load16(p.slab, r, p.N, p.D, 64 * jn + 16 * t, p.vec);
    b = load16(p.slab, r + 8, p.N, p.D, 64 * jn + 16 * t, p.vec);
  };
  if constexpr (STG == 0) {
#pragma unroll
    for (int i = 0; i < PF; ++i)
      load_ahead(static_cast<long long>(blockIdx.x) * kTopkTile +
                     warp * kTileRows + g,
                 i, va[i], vb[i]);
  }
  int it = 0;
  for (long long base = static_cast<long long>(blockIdx.x) * kTopkTile;
       base < p.N; base += stride, ++it) {
    // the lane's rows: r0 and r0 + 8
    const long long r0 = base + warp * kTileRows + g;
    // their score factors: cos dots * fa, fa = rsqrt(vsq + 1e-12); l2sq
    // (dots * fa) - fb, with fa = 2 scale, fb = vsq scale^2, rounded as the
    // plain version rounds them
    float fa[2], fb[2];
    bool in[2], ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      in[h] = r0 + 8 * h < p.N;
      ok[h] = ok_n[h];
      fa[h] = p.metric ? 2.f * sc_n[h] : rsqrtf(vs_n[h] + 1e-12f);
      fb[h] = p.metric ? vs_n[h] * (sc_n[h] * sc_n[h]) : 0.f;
    }
    load_rows(r0 + stride);
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    // one 64-column block j: A fragments from the 16 bytes va (row r0) and
    // vb (row r0 + 8) at columns 64 j + 16 t; k positions 2t, 2t+1 <-
    // columns 16t + 4s, +1 and 2t+8, 2t+9 <- +2, +3, for the slab and the
    // queries alike
    auto mma_block = [&](int j, const uint4& va, const uint4& vb) {
      if constexpr (WG) {
        uint32_t a[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          widen4(word(va, s), a[s][0], a[s][2]);
          widen4(word(vb, s), a[s][1], a[s][3]);
        }
        __syncwarp();
        wg_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)  // k chunk 2 (4 j + s), query group 0
          wgmma_64x64(acc, a[s],
                      wg_desc(qs + 2 * (4 * j + s) * (NQ / 8) * 64, kWgLbo,
                              kWgSbo),
                      j | s);
        wg_commit();
        wg_wait();
      } else {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int unit = (16 * j + 4 * t + s) ^ (g & 3);
          uint32_t a[4];
          widen4(word(va, s), a[0], a[2]);
          widen4(word(vb, s), a[1], a[3]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint2 bq = *reinterpret_cast<const uint2*>(
                qrow + n * 8 * p.DP + 4 * unit);
            mma_bf16(acc[n], a, bq.x, bq.y);
          }
        }
      }
    };
    if constexpr (STG > 0) {
      const long long next = base + (STG - 1) * stride;
      if (next < p.N) issue(next, (it + STG - 1) % STG);
      cp_async_commit();
      cp_async_wait<STG - 1>();
      __syncwarp();
      const int8_t* src =
          ring + ((it % STG) * kWarps + warp) * kTileRows * p.DP;
      const int sw = g & 1 ? sw_odd : 0;  // rows g and g + 8 alike
      for (int j = 0; j < nj; ++j) {
        const int c = 16 * ((4 * j + t) ^ sw);
        mma_block(j, *reinterpret_cast<const uint4*>(src + g * p.DP + c),
                  *reinterpret_cast<const uint4*>(src + (g + 8) * p.DP + c));
      }
    } else {
      for (int j = 0; j < nj; ++j) {
        load_ahead(r0, j + PF, va[PF], vb[PF]);
        mma_block(j, va[0], vb[0]);
#pragma unroll
        for (int i = 0; i < PF; ++i) {
          va[i] = va[i + 1];
          vb[i] = vb[i + 1];
        }
      }
    }
    epi(acc, r0, in, ok, fa, fb);
  }
}

// K3 top-k, launch 1: the mainloop into the block's running top-k lists,
// then each block's k best keys per query into the workspace.
template <int NT, int STG>
__global__ void __launch_bounds__(kWarps * 32, 2)
knn_topk_i8_kernel(const I8Params p) {
  constexpr int NQ = 8 * NT;
  // 64 queries from registers: one wgmma per k-step for each 4 warps
  constexpr bool WG = NT == 8 && STG == 0;
  constexpr int S = kTopkKeys;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);          // [NQ][S]
  int* cnt = reinterpret_cast<int*>(keys + NQ * S);  // [NQ]
  bf16* qs = reinterpret_cast<bf16*>(cnt + NQ);        // [NQ][DP]
  int8_t* ring = reinterpret_cast<int8_t*>(qs + NQ * p.DP);
  const int q0 = blockIdx.y * NQ;
  const int nq = min(NQ, p.B - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_queries<NQ, WG>(p.q, q0, nq, p.D, p.DP, qs);
  topk_lists_init<NQ>(keys, cnt);
  __syncthreads();
  i8_rows<NT, STG, WG>(
      p, qs, ring,
      [&](const float (&acc)[NT][4], long long r0, const bool (&in)[2],
          const bool (&ok)[2], const float (&fa)[2], const float (&fb)[2]) {
        topk_offer_tile<NT>(acc, keys, cnt, p.k, nq, r0, in, ok, fa, fb,
                            p.metric != 0, warp, lane);
      });
  topk_block_finish(keys, cnt, p.k, nq, p.B, q0, p.ws, warp, lane);
}

// K3 score, for k past the top-k's lists: the same mainloop into the store
// epilogue (knn_topk.cuh::store_tile), with no block barrier after the
// prologue; wgmma at 64 queries from the ring too (see i8_config).
template <int NT, int STG>
__global__ void __launch_bounds__(kWarps * 32, 2)
knn_score_i8_kernel(const I8Params p) {
  constexpr int NQ = 8 * NT;
  constexpr bool WG = NT == 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stg = reinterpret_cast<float*>(smem);  // [kWarps][NQ][kStgLd]
  bf16* qs = reinterpret_cast<bf16*>(stg + kWarps * NQ * kStgLd);
  int8_t* ring = reinterpret_cast<int8_t*>(qs + NQ * p.DP);
  const int q0 = blockIdx.y * NQ;
  const int nq = min(NQ, p.B - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wstg = stg + warp * NQ * kStgLd;
  stage_queries<NQ, WG>(p.q, q0, nq, p.D, p.DP, qs);
  __syncthreads();
  i8_rows<NT, STG, WG>(
      p, qs, ring,
      [&](const float (&acc)[NT][4], long long r0, const bool (&)[2],
          const bool (&ok)[2], const float (&fa)[2], const float (&fb)[2]) {
        store_tile<NT>(acc, wstg, p.out, p.vec_out, p.N, q0, nq,
                       r0 - (lane >> 2), ok, fa, fb, p.metric != 0, lane);
      });
}

// n8 query tiles per block (enough for B, at most 8, within the shared
// memory a block may take) and the ring's stages: 2 where two blocks of
// the ring kernel fit on an SM (B <= 8 at D = 384), else the register
// path, which also runs two blocks an SM. On an H100 at 10M x 384 rows,
// two blocks (16 warps) an SM are what hides the latency of each tile's
// load, products and merge in K3 top-k: one block with a deeper ring was
// slower at B = 1, and the ring at one block slower than the register
// path at B = 32 and 64. K3 score, which has no barrier per tile, takes
// the ring with wgmma at 33-64 queries even at one block an SM, which
// wrote its keys faster at B = 64 than the register path (PERF.md).
TopkConfig i8_config(bool store, int B, int DP, bool vec) {
  int nt = topk_query_tiles(B);
  for (;;) {
    TopkConfig c;
    c.nt = nt;
    const size_t ring_max =
        store && nt == kMaxQueryTiles ? kMaxSmemTopk : kTwoBlockSmem;
    c.stg = vec && i8_smem(store, nt, DP, 2) <= ring_max ? 2 : 0;
    c.smem = i8_smem(store, nt, DP, c.stg);
    if (c.smem <= kMaxSmemTopk || nt == 1) return c;
    nt /= 2;
  }
}

// f(kernel) for the launch-1 kernel (STORE: K3 score, else K3 top-k) of c
template <bool STORE, int NT, typename F>
cudaError_t with_stages(int stg, F f) {
  if constexpr (STORE)
    return stg ? f(knn_score_i8_kernel<NT, 2>) : f(knn_score_i8_kernel<NT, 0>);
  else
    return stg ? f(knn_topk_i8_kernel<NT, 2>) : f(knn_topk_i8_kernel<NT, 0>);
}

template <bool STORE, typename F>
cudaError_t with_i8_kernel(const TopkConfig& c, F f) {
  switch (c.nt) {
    case 1: return with_stages<STORE, 1>(c.stg, f);
    case 2: return with_stages<STORE, 2>(c.stg, f);
    case 4: return with_stages<STORE, 4>(c.stg, f);
    default: return with_stages<STORE, 8>(c.stg, f);
  }
}

// The operands of both K3 launches; false if the kernels cannot take them
bool i8_params(I8Params& p, const void* q, const void* slab,
               const void* scales, const void* vsq, const void* valid, int B,
               long long N, int D, int metric) {
  if (B < 1 || N < 1 || D < 1 || N > 0x7FFFFFFFLL ||
      (metric != 0 && metric != 1))
    return false;
  p.q = static_cast<const bf16*>(q);
  p.slab = static_cast<const int8_t*>(slab);
  p.scales = static_cast<const float*>(scales);
  p.vsq = static_cast<const float*>(vsq);
  p.valid = static_cast<const uint8_t*>(valid);
  p.ws = nullptr;
  p.out = nullptr;
  p.N = N;
  p.B = B;
  p.D = D;
  p.DP = (D + 63) / 64 * 64;
  p.metric = metric;
  p.k = 0;
  p.vec = D % 16 == 0 && reinterpret_cast<uintptr_t>(slab) % 16 == 0;
  p.vec_out = false;
  return true;
}

// ------------------------------------------------------------------------
// K4: quantizing scatter
// ------------------------------------------------------------------------

constexpr int kQuantThreads = 256;  // 8 warps
// rows a warp of the vector body holds in flight: 1, 2, 4 and 8 were timed
// on the bulk write (NVIDIA H100 80GB HBM3, 700 W; PERF.md) and 1 was
// the fastest: fewer registers let more warps stay resident, which keeps
// more rows in flight per SM than more rows a warp do
constexpr int kQuantRows = 1;
constexpr float kInv127 = 0.007874015718698502f;  // f32(1 / 127)

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float quant_scale(float m) {
  return fmaxf(__fmul_rn(m, kInv127), 1e-30f);
}

__device__ __forceinline__ int quant_code(float v, float scale) {
  return static_cast<int>(
      fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f));
}

// The scalar body: one warp per row, 8 rows a block.
__global__ void __launch_bounds__(kQuantThreads)
knn_quantize_scatter_kernel(const float* rows, long long ld,
                            const long long* slots, const uint8_t* valid_vals,
                            int n, int D, long long R, int8_t* slab,
                            float* scales, float* vsq, uint8_t* valid) {
  const int i = (blockIdx.x * kQuantThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const long long slot = slots[i];
  if (slot < 0 || slot >= R) return;  // sentinel: dropped
  const float* v = rows + i * ld;
  float m = 0.f;
  for (int c = lane; c < D; c += 32) m = fmaxf(m, fabsf(v[c]));
  const float scale = quant_scale(warp_max(m));
  int8_t* out = slab + slot * D;
  int sq = 0;
  for (int c = lane; c < D; c += 32) {
    const int qi = quant_code(v[c], scale);
    out[c] = static_cast<int8_t>(qi);
    sq += qi * qi;
  }
  sq = warp_sum(sq);
  if (lane == 0) {
    scales[slot] = scale;
    vsq[slot] = __int2float_rn(sq);
    valid[slot] = valid_vals ? valid_vals[i] : 1;
  }
}

// The vector body: D % 4 == 0, rows 16-byte aligned with a row stride of a
// multiple of 4 floats, D <= 128 V. Each warp takes kQuantRows rows; lane
// l holds float4 l + 32 j of each (j < V) in registers.
template <int V>
__global__ void __launch_bounds__(kQuantThreads)
knn_quantize_scatter_vec(const float* rows, long long ld,
                         const long long* slots, const uint8_t* valid_vals,
                         int n, int D, long long R, int8_t* slab,
                         float* scales, float* vsq, uint8_t* valid) {
  const int warp = (blockIdx.x * kQuantThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int i0 = warp * kQuantRows;
  if (i0 >= n) return;
  const int D4 = D >> 2;
  long long slot[kQuantRows];
  bool live[kQuantRows];
#pragma unroll
  for (int r = 0; r < kQuantRows; ++r) {
    slot[r] = i0 + r < n ? slots[i0 + r] : -1;
    live[r] = slot[r] >= 0 && slot[r] < R;  // sentinel: dropped
  }
  float4 v[kQuantRows][V];
#pragma unroll
  for (int r = 0; r < kQuantRows; ++r) {
    const float4* row =
        reinterpret_cast<const float4*>(rows + (i0 + r) * ld);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      v[r][j] = live[r] && c < D4 ? __ldcs(row + c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float m[kQuantRows];
#pragma unroll
  for (int r = 0; r < kQuantRows; ++r) {
    m[r] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j)
      m[r] = fmaxf(fmaxf(m[r], fmaxf(fabsf(v[r][j].x), fabsf(v[r][j].y))),
                   fmaxf(fabsf(v[r][j].z), fabsf(v[r][j].w)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < kQuantRows; ++r)
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
  int sq[kQuantRows];
#pragma unroll
  for (int r = 0; r < kQuantRows; ++r) {
    sq[r] = 0;
    if (!live[r]) continue;  // warp-uniform
    const float scale = quant_scale(m[r]);
    uint32_t* out = reinterpret_cast<uint32_t*>(slab + slot[r] * D);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = lane + 32 * j;
      const int a = quant_code(v[r][j].x, scale);
      const int b = quant_code(v[r][j].y, scale);
      const int d = quant_code(v[r][j].z, scale);
      const int e = quant_code(v[r][j].w, scale);
      sq[r] += a * a + b * b + d * d + e * e;
      if (c < D4)
        out[c] = static_cast<uint32_t>(a & 0xff) |
                 static_cast<uint32_t>(b & 0xff) << 8 |
                 static_cast<uint32_t>(d & 0xff) << 16 |
                 static_cast<uint32_t>(e & 0xff) << 24;
    }
    if (lane == 0) scales[slot[r]] = scale;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < kQuantRows; ++r)
      sq[r] += __shfl_xor_sync(0xffffffffu, sq[r], o);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kQuantRows; ++r) {
      if (!live[r]) continue;
      vsq[slot[r]] = __int2float_rn(sq[r]);
      valid[slot[r]] = valid_vals ? valid_vals[i0 + r] : 1;
    }
  }
}

template <int V>
cudaError_t launch_quantize_vec(const float* rows, long long ld,
                                const long long* slots,
                                const uint8_t* valid_vals, int n, int D,
                                long long R, int8_t* slab, float* scales,
                                float* vsq, uint8_t* valid, cudaStream_t s) {
  constexpr int per_block = kQuantThreads / 32 * kQuantRows;
  knn_quantize_scatter_vec<V><<<(n + per_block - 1) / per_block,
                                kQuantThreads, 0, s>>>(
      rows, ld, slots, valid_vals, n, D, R, slab, scales, vsq, valid);
  return cudaGetLastError();
}

}  // namespace

// K3 score. q (B, D) bf16 contiguous; slab (N, D) int8 contiguous; scales,
// vsq (N,) f32 (scales read only for l2sq); valid (N,) bytes; out (B, N)
// int64 keys score_key(score, row). metric: 0 = cos, 1 = l2sq; N < 2^31.
// Returns the cudaError_t of the launch.
extern "C" int pt_knn_score_i8(const void* q, const void* slab,
                               const void* scales, const void* vsq,
                               const void* valid, void* out, int B,
                               long long N, int D, int metric, void* stream) {
  I8Params p;
  if (!i8_params(p, q, slab, scales, vsq, valid, B, N, D, metric))
    return static_cast<int>(cudaErrorInvalidValue);
  p.out = static_cast<long long*>(out);
  p.vec_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const TopkConfig c = i8_config(true, B, p.DP, p.vec);
  if (c.smem > kMaxSmemTopk) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (B + 8 * c.nt - 1) / (8 * c.nt);
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_i8_kernel<true>(c, [&](auto kernel) {
    int blocks = 0;
    const cudaError_t e = topk_grid(kernel, c.smem, N, &blocks);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(blocks, groups), kWarps * 32, c.smem, s>>>(p);
    return cudaGetLastError();
  }));
}

// K4. rows (n, D) f32 with row stride ld (elements), last dim contiguous;
// slots (n,) int64 local rows of the extent (outside [0, R): dropped);
// valid_vals (n,) bytes or null (all valid); slab (R, D) int8, scales,
// vsq (R,) f32 and valid (R,) bytes are written in place. The vector body
// takes D % 4 == 0 up to D = 1024 with 16-byte aligned rows (base and
// stride); the scalar body the rest. One launch, no allocation and no
// host sync, so a CUDA graph can capture it.
extern "C" int pt_knn_quantize_scatter(const void* rows, long long ld,
                                       const void* slots,
                                       const void* valid_vals, int n, int D,
                                       long long R, void* slab, void* scales,
                                       void* vsq, void* valid, void* stream) {
  if (n < 1 || D < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rows);
  const long long* sl = static_cast<const long long*>(slots);
  const uint8_t* vv = static_cast<const uint8_t*>(valid_vals);
  int8_t* q = static_cast<int8_t*>(slab);
  float* sc = static_cast<float*>(scales);
  float* vs = static_cast<float*>(vsq);
  uint8_t* va = static_cast<uint8_t*>(valid);
  const bool vec = D % 4 == 0 && D <= 1024 && ld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(slab) % 4 == 0;
  if (vec) {
    // float4s per lane: 128 floats per lane-column of the warp
    switch ((D + 127) / 128) {
      case 1: return static_cast<int>(launch_quantize_vec<1>(
          r, ld, sl, vv, n, D, R, q, sc, vs, va, s));
      case 2: return static_cast<int>(launch_quantize_vec<2>(
          r, ld, sl, vv, n, D, R, q, sc, vs, va, s));
      case 3: return static_cast<int>(launch_quantize_vec<3>(
          r, ld, sl, vv, n, D, R, q, sc, vs, va, s));
      case 4: return static_cast<int>(launch_quantize_vec<4>(
          r, ld, sl, vv, n, D, R, q, sc, vs, va, s));
      default: return static_cast<int>(launch_quantize_vec<8>(
          r, ld, sl, vv, n, D, R, q, sc, vs, va, s));
    }
  }
  const int blocks = (n + kQuantThreads / 32 - 1) / (kQuantThreads / 32);
  knn_quantize_scatter_kernel<<<blocks, kQuantThreads, 0, s>>>(
      r, ld, sl, vv, n, D, R, q, sc, vs, va);
  return static_cast<int>(cudaGetLastError());
}

// K3 top-k, launch 1's grid.x for these arguments on the current device
// (resident blocks, at most one per block tile), written to *blocks: the
// wrapper allocates the (blocks, B, k) workspace from it.
extern "C" int pt_knn_topk_i8_blocks(int B, long long N, int D, int k,
                                     int* blocks) {
  if (B < 1 || N < 1 || D < 1 || k < 1 || k > kTopkKMax || k > N ||
      N > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // as pt_knn_topk_i8 chooses for a 16-byte aligned slab
  const TopkConfig c = i8_config(false, B, (D + 63) / 64 * 64, D % 16 == 0);
  if (c.smem > kMaxSmemTopk) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_i8_kernel<false>(c, [&](auto kernel) {
    return topk_grid(kernel, c.smem, N, blocks);
  }));
}

// K3 top-k. q (B, D) bf16 contiguous; slab (N, D) int8 contiguous; scales,
// vsq (N,) f32 (scales read only for l2sq); valid (N,) bytes; ws (G, B, k)
// 64-bit scratch, G from pt_knn_topk_i8_blocks; out_s (B, k) f32 and
// out_row (B, k) int64 rows, best first. 1 <= k <= 64, k <= N. Two
// launches; returns the cudaError_t of the first that fails, else 0.
extern "C" int pt_knn_topk_i8(const void* q, const void* slab,
                              const void* scales, const void* vsq,
                              const void* valid, void* ws, int G, void* out_s,
                              void* out_row, int B, long long N, int D,
                              int metric, int k, void* stream) {
  I8Params p;
  if (!i8_params(p, q, slab, scales, vsq, valid, B, N, D, metric) || G < 1 ||
      k < 1 || k > kTopkKMax || k > N)
    return static_cast<int>(cudaErrorInvalidValue);
  p.ws = static_cast<u64*>(ws);
  p.k = k;
  const TopkConfig c = i8_config(false, B, p.DP, p.vec);
  if (c.smem > kMaxSmemTopk) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (B + 8 * c.nt - 1) / (8 * c.nt);
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = with_i8_kernel<false>(c, [&](auto kernel) {
    const cudaError_t a = allow_smem(kernel, c.smem);
    if (a != cudaSuccess) return a;
    kernel<<<dim3(G, groups), kWarps * 32, c.smem, s>>>(p);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_topk_merge(p.ws, G, B, k,
                                            static_cast<float*>(out_s),
                                            static_cast<long long*>(out_row),
                                            s));
}

extern "C" const char* pt_knn_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
