// K2, the bf16 KNN slab's fused score + top-k for Hopper (sm_90a), and its
// score-only twin, bound to Python with ctypes
// (ops/knn_kernels.py::topk_bf16, score_bf16).
//
// Replaces pathway_tpu/ops/knn.py::_shared_search_fn (an XLA function on
// the TPU: score block, lax.top_k per 2^19-row chunk and the merge of
// _chunked_search) for one bf16 extent and k <= 64. For queries q (B, D)
// bf16, already normalised for cos and cast, and N bf16 rows v:
//   dots = q . v              (bf16 products, f32 sums)
//   ||v||^2 = sum v^2         (f32, from the same loaded rows)
//   cos:  dots * rsqrt(||v||^2 + 1e-12)
//   l2sq: 2 dots - ||v||^2    (-||q - v||^2 + ||q||^2)
//   invalid rows: -inf,
// each rounded as the plain version (score_float_reference) rounds it. The
// result is the k best rows per query in the stable descending sort's
// order: higher score first, equal scores lower row first, -inf rows
// ranked like any other.
//
// What bounds it: bytes. The slab is read once, N (2 D + 1) bytes, and no
// score reaches device memory; at the serving batch (B <= 64) the product
// is below the tensor cores' rate. Design: K3 top-k's (knn_topk.cuh) with
// bf16 rows, which feed the MMA with no widening. A persistent grid of two
// 8-warp blocks an SM walks 128-row block tiles, each warp 16 rows, whose
// A fragments are the 32 bytes at columns 16 t .. 16 t + 15 of the lane's
// rows g and g + 8 per 64-column block: mma.sync m16n8k16 against each n8
// query tile, or at 33-64 queries one wgmma m64n64k16 per 4 warps. At
// B <= 8 the rows stream through a cp.async ring in shared memory, half a
// row a stage (two stages of 768-byte rows would not fit two blocks an
// SM); else a lane loads its pieces into registers, ahead of their use
// and across a tile's end, so loads stay in flight through the epilogue
// and its barrier (see bf16_config). The same pieces give each row's
// ||v||^2 (FMA on the lane's 16 columns, then a sum over the quad's four
// lanes). The scores go through K3's running top-k in shared memory and
// its merge launch.
//
// K2's score twin (knn_score_bf16_kernel), for k > 64 (a filter's escalated
// fetch): the same scores written out, each as the selection's 64-bit key
// (score_key), (B, N) int64: the score block of _shared_search_fn, which
// ops/knn.py::search_extent calls per 2^19-row chunk (the reference's
// _CHUNK_ROWS) before an exact selection. Bound: the slab read and the key
// write, N (2 D + 1) + 8 B N bytes. The same mainloop (bf16_rows)
// into knn_topk.cuh's store epilogue: each warp stages its 16 rows x n
// queries in shared memory and writes each query's rows contiguously with
// streaming 16-byte stores.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "knn_topk.cuh"

namespace {

// 16 bf16 of one row: a lane's columns 16 t .. 16 t + 15 of a 64-column
// block, elements 0-7 in lo and 8-15 in hi
struct Piece {
  uint4 lo, hi;
};

// 32-bit word i (elements 2 i, 2 i + 1) of a piece
__device__ __forceinline__ uint32_t pword(const Piece& v, int i) {
  return i < 4 ? word(v.lo, i) : word(v.hi, i - 4);
}

// the piece of slab row `row` from column `col`; zero past N rows or D
// columns. `vec` (D % 16 == 0 and a 16-byte aligned slab) takes two
// streaming 16-byte loads, else elements one by one.
__device__ __forceinline__ Piece load_piece(const bf16* slab, long long row,
                                            long long N, int D, int col,
                                            bool vec) {
  Piece out{make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
  if (row >= N || col >= D) return out;
  const bf16* p = slab + row * D + col;
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
    out.lo = __ldcs(v);
    out.hi = __ldcs(v + 1);
    return out;
  }
  const uint16_t* e = reinterpret_cast<const uint16_t*>(p);
  uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && col + i < D; ++i)
    w[i >> 1] |= static_cast<uint32_t>(e[i]) << (16 * (i & 1));
  out.lo = make_uint4(w[0], w[1], w[2], w[3]);
  out.hi = make_uint4(w[4], w[5], w[6], w[7]);
  return out;
}

// ss[0] += the squares of a piece's even elements, ss[1] of its odd ones
// (a bf16 is the high half of its f32)
__device__ __forceinline__ void add_squares(const Piece& v, float (&ss)[2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t w = pword(v, i);
    const float lo = __uint_as_float(w << 16);
    const float hi = __uint_as_float(w & 0xFFFF0000u);
    ss[0] = fmaf(lo, lo, ss[0]);
    ss[1] = fmaf(hi, hi, ss[1]);
  }
}

struct Bf16Params {
  const bf16* q;
  const bf16* slab;
  const uint8_t* valid;
  u64* ws;    // top-k: (gridDim.x, B, k), each block's k best keys per query
  long long* out;  // score: (B, N) keys score_key(score, row)
  long long N;
  int B, D, DP, metric, k;
  bool vec;      // D % 16 == 0 and a 16-byte aligned slab
  bool vec_out;  // score: N % 4 == 0 (16-byte stores)
};

// Shared memory of launch 1: the top-k's lists or the score's staging,
// then the queries, then (ring) two stages of each warp's 16 rows x DP / 2
// columns
size_t bf16_smem(bool store, int nt, int DP, bool ring) {
  return (store ? score_lists_smem(nt, DP) : topk_lists_smem(nt, DP)) +
         (ring ? static_cast<size_t>(2) * kTopkTile * DP : 0);
}

// Launch 1's mainloop, for K2 and its score twin alike. Each warp scores
// 16 rows of a block tile against the block's NT n8 query tiles, staged in
// qs, and hands each tile's sums to epi(acc, r0, in, ok, fa, fb). RING
// false: a lane loads its pieces of the rows into registers, PF 64-column
// blocks ahead (any D). RING (D % 128 == 0, a 16-byte aligned slab): each
// warp streams its rows, half a row at a time, into a ring of two stages
// in shared memory with cp.async, the next half in flight while this one
// multiplies, in requests that hold no registers while in flight; half a
// row keeps the ring of two 8-warp blocks an SM within the SM's shared
// memory. The products are mma.sync m16n8k16, one per warp and n8 query
// tile, or at 64 queries (WG) one wgmma m64n64k16 per 4 warps, which reads
// the queries from shared memory once for the 4.
template <int NT, bool RING, bool WG, typename Epi>
__device__ __forceinline__ void bf16_rows(const Bf16Params& p,
                                          const bf16* qs, bf16* ring,
                                          Epi&& epi) {
  constexpr int NQ = 8 * NT;  // queries per block
  // register path: 64-column blocks loaded ahead, one at 64 queries, else
  // two
  constexpr int PF = WG ? 1 : 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nj = p.DP / 64;
  const bf16* qrow = qs + g * p.DP;
  const long long stride = static_cast<long long>(gridDim.x) * kTopkTile;
  const long long first = static_cast<long long>(blockIdx.x) * kTopkTile +
                          warp * kTileRows + g;

  // ring rows of HW elements; the 16-byte chunk c of an odd row sits at
  // chunk c ^ 1, so that the rows g and g + 1 a quarter-warp reads fall in
  // distinct banks
  const int HW = p.DP / 2, cpr = HW / 8;
  // chunk e = lane + 32 i of a warp's 16 rows is chunk c of row r, stepped
  // without a division
  const int r_lane = lane / cpr, c_lane = lane % cpr;
  const int r_step = 32 / cpr, c_step = 32 % cpr;
  // half h of the warp's rows of the block tile at tile0, into a stage
  auto issue = [&](long long tile0, int h, int stage) {
    const long long r0w = tile0 + warp * kTileRows;
    const long long rows = p.N - r0w;
    if (rows <= 0) return;
    const int n = static_cast<int>(
        rows < kTileRows ? rows : static_cast<long long>(kTileRows)) * cpr;
    bf16* dst = ring + (stage * kWarps + warp) * kTileRows * HW;
    const bf16* src = p.slab + r0w * p.D + h * HW;
    int r = r_lane, c = c_lane;
    for (int e = lane; e < n; e += 32) {
      cp_async16(dst + r * HW + 8 * (c ^ (r & 1)),
                 src + static_cast<long long>(r) * p.D + 8 * c);
      r += r_step;
      c += c_step;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  };
  if constexpr (RING) {
    issue(static_cast<long long>(blockIdx.x) * kTopkTile, 0, 0);
    cp_async_commit();
  }

  // each row's validity, loaded a tile ahead of its use
  bool ok_n[2];
  auto load_valid = [&](long long r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = r + 8 * h;
      ok_n[h] = row < p.N && p.valid[row] != 0;
    }
  };
  load_valid(first);
  Piece va[PF + 1], vb[PF + 1];
  auto load_ahead = [&](long long r0cur, int jn, Piece& a, Piece& b) {
    long long r = r0cur;
    while (jn >= nj) {  // a later tile
      jn -= nj;
      r += stride;
    }
    a = load_piece(p.slab, r, p.N, p.D, 64 * jn + 16 * t, p.vec);
    b = load_piece(p.slab, r + 8, p.N, p.D, 64 * jn + 16 * t, p.vec);
  };
  if constexpr (!RING) {
#pragma unroll
    for (int i = 0; i < PF; ++i) load_ahead(first, i, va[i], vb[i]);
  }

  int it = 0;  // ring halves consumed
  for (long long base = static_cast<long long>(blockIdx.x) * kTopkTile;
       base < p.N; base += stride) {
    // the lane's rows: r0 and r0 + 8
    const long long r0 = base + warp * kTileRows + g;
    bool in[2], ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      in[h] = r0 + 8 * h < p.N;
      ok[h] = ok_n[h];
    }
    load_valid(r0 + stride);
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float ss[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [row h][even, odd]
    // one 64-column block j: the A fragment of k-step s is words 2 s (k
    // 2t, 2t+1) and 2 s + 1 (k 2t+8, 2t+9) of rows r0 (a) and r0 + 8 (b)
    auto mma_block = [&](int j, const Piece& a, const Piece& b) {
      if constexpr (WG) {
        uint32_t f[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          f[s][0] = pword(a, 2 * s);
          f[s][1] = pword(b, 2 * s);
          f[s][2] = pword(a, 2 * s + 1);
          f[s][3] = pword(b, 2 * s + 1);
        }
        __syncwarp();
        wg_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)  // k chunk 2 (4 j + s), query group 0
          wgmma_64x64(acc, f[s],
                      wg_desc(qs + 2 * (4 * j + s) * (NQ / 8) * 64, kWgLbo,
                              kWgSbo),
                      j | s);
        wg_commit();
        wg_wait();
      } else {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int unit = (16 * j + 4 * t + s) ^ (g & 3);
          const uint32_t f[4] = {pword(a, 2 * s), pword(b, 2 * s),
                                 pword(a, 2 * s + 1), pword(b, 2 * s + 1)};
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint2 bq = *reinterpret_cast<const uint2*>(
                qrow + n * 8 * p.DP + 4 * unit);
            mma_bf16(acc[n], f, bq.x, bq.y);
          }
        }
      }
      add_squares(a, ss[0]);
      add_squares(b, ss[1]);
    };
    if constexpr (RING) {
      for (int h = 0; h < 2; ++h, ++it) {
        __syncwarp();  // every lane is done with the stage issued next
        const long long next = h ? base + stride : base;
        if (next < p.N) issue(next, h ^ 1, (it + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncwarp();
        const bf16* src = ring + ((it & 1) * kWarps + warp) * kTileRows * HW;
        const int sw = g & 1;  // rows g and g + 8 alike
        for (int jj = 0; jj < nj / 2; ++jj) {
          const int lo = 8 * ((8 * jj + 2 * t) ^ sw);
          const int hi = 8 * ((8 * jj + 2 * t + 1) ^ sw);
          const Piece a{*reinterpret_cast<const uint4*>(src + g * HW + lo),
                        *reinterpret_cast<const uint4*>(src + g * HW + hi)};
          const Piece b{
              *reinterpret_cast<const uint4*>(src + (g + 8) * HW + lo),
              *reinterpret_cast<const uint4*>(src + (g + 8) * HW + hi)};
          mma_block(h * (nj / 2) + jj, a, b);
        }
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
    // ||v||^2 of rows r0 and r0 + 8 over the quad's four lanes; the score
    // factors as tile_score takes them: cos dots * fa, fa = rsqrt(
    // ||v||^2 + 1e-12); l2sq dots * 2 - ||v||^2
    float fa[2], fb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float n2 = ss[h][0] + ss[h][1];
      n2 += __shfl_xor_sync(0xffffffffu, n2, 1);
      n2 += __shfl_xor_sync(0xffffffffu, n2, 2);
      fa[h] = p.metric ? 2.f : rsqrtf(n2 + 1e-12f);
      fb[h] = p.metric ? n2 : 0.f;
    }
    epi(acc, r0, in, ok, fa, fb);
  }
}

// K2, launch 1: the mainloop into the block's running top-k lists, then
// each block's k best keys per query into the workspace.
template <int NT, bool RING>
__global__ void __launch_bounds__(kWarps * 32, 2)
knn_topk_bf16_kernel(const Bf16Params p) {
  constexpr int NQ = 8 * NT;  // queries per block
  constexpr bool WG = NT == 8 && !RING;
  constexpr int S = kTopkKeys;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);          // [NQ][S]
  int* cnt = reinterpret_cast<int*>(keys + NQ * S);  // [NQ]
  bf16* qs = reinterpret_cast<bf16*>(cnt + NQ);        // [NQ][DP]
  bf16* ring = qs + NQ * p.DP;  // [2][kWarps][kTileRows][DP / 2]
  const int q0 = blockIdx.y * NQ;
  const int nq = min(NQ, p.B - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_queries<NQ, WG>(p.q, q0, nq, p.D, p.DP, qs);
  topk_lists_init<NQ>(keys, cnt);
  __syncthreads();
  bf16_rows<NT, RING, WG>(
      p, qs, ring,
      [&](const float (&acc)[NT][4], long long r0, const bool (&in)[2],
          const bool (&ok)[2], const float (&fa)[2], const float (&fb)[2]) {
        topk_offer_tile<NT>(acc, keys, cnt, p.k, nq, r0, in, ok, fa, fb,
                            p.metric != 0, warp, lane);
      });
  topk_block_finish(keys, cnt, p.k, nq, p.B, q0, p.ws, warp, lane);
}

// K2's score twin, for k past the top-k's lists: the same mainloop into
// the store epilogue (knn_topk.cuh::store_tile), with no block barrier
// after the prologue; wgmma at 64 queries from the ring too (see
// bf16_config).
template <int NT, bool RING>
__global__ void __launch_bounds__(kWarps * 32, 2)
knn_score_bf16_kernel(const Bf16Params p) {
  constexpr int NQ = 8 * NT;
  constexpr bool WG = NT == 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stg = reinterpret_cast<float*>(smem);  // [kWarps][NQ][kStgLd]
  bf16* qs = reinterpret_cast<bf16*>(stg + kWarps * NQ * kStgLd);
  bf16* ring = qs + NQ * p.DP;
  const int q0 = blockIdx.y * NQ;
  const int nq = min(NQ, p.B - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wstg = stg + warp * NQ * kStgLd;
  stage_queries<NQ, WG>(p.q, q0, nq, p.D, p.DP, qs);
  __syncthreads();
  bf16_rows<NT, RING, WG>(
      p, qs, ring,
      [&](const float (&acc)[NT][4], long long r0, const bool (&)[2],
          const bool (&ok)[2], const float (&fa)[2], const float (&fb)[2]) {
        store_tile<NT>(acc, wstg, p.out, p.vec_out, p.N, q0, nq,
                       r0 - (lane >> 2), ok, fa, fb, p.metric != 0, lane);
      });
}

// n8 query tiles per block (enough for B, at most 8, within the shared
// memory a block may take) and the ring (stg 2) where two blocks of the
// ring kernel fit on an SM (B <= 8 at D = 384; D % 128 == 0 and a 16-byte
// aligned slab), else the register path. The score twin takes the ring
// with wgmma at 33-64 queries even at one block an SM, which wrote its
// keys faster at B = 64 than the register path (PERF.md).
TopkConfig bf16_config(bool store, int B, int D, bool vec) {
  const int DP = (D + 63) / 64 * 64;
  TopkConfig c;
  c.nt = topk_query_tiles(B);
  while (c.nt > 1 && bf16_smem(store, c.nt, DP, false) > kMaxSmemTopk)
    c.nt /= 2;
  const size_t ring_max =
      store && c.nt == kMaxQueryTiles ? kMaxSmemTopk : kTwoBlockSmem;
  c.stg = vec && D % 128 == 0 && bf16_smem(store, c.nt, DP, true) <= ring_max
              ? 2
              : 0;
  c.smem = bf16_smem(store, c.nt, DP, c.stg > 0);
  return c;
}

// f(kernel) for the launch-1 kernel (STORE: the score twin, else K2) of c
template <bool STORE, int NT, typename F>
cudaError_t with_ring(int stg, F f) {
  if constexpr (STORE)
    return stg ? f(knn_score_bf16_kernel<NT, true>)
               : f(knn_score_bf16_kernel<NT, false>);
  else
    return stg ? f(knn_topk_bf16_kernel<NT, true>)
               : f(knn_topk_bf16_kernel<NT, false>);
}

template <bool STORE, typename F>
cudaError_t with_bf16_kernel(const TopkConfig& c, F f) {
  switch (c.nt) {
    case 1: return with_ring<STORE, 1>(c.stg, f);
    case 2: return with_ring<STORE, 2>(c.stg, f);
    case 4: return with_ring<STORE, 4>(c.stg, f);
    default: return with_ring<STORE, 8>(c.stg, f);
  }
}

// The operands of both launch-1 kernels; false if they cannot take them
bool bf16_params(Bf16Params& p, const void* q, const void* slab,
                 const void* valid, int B, long long N, int D, int metric) {
  if (B < 1 || N < 1 || D < 1 || N > 0x7FFFFFFFLL ||
      (metric != 0 && metric != 1))
    return false;
  p.q = static_cast<const bf16*>(q);
  p.slab = static_cast<const bf16*>(slab);
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

}  // namespace

// K2, launch 1's grid.x for these arguments on the current device
// (resident blocks, at most one per block tile), written to *blocks: the
// wrapper allocates the (blocks, B, k) workspace from it.
extern "C" int pt_knn_topk_bf16_blocks(int B, long long N, int D, int k,
                                       int* blocks) {
  if (B < 1 || N < 1 || D < 1 || k < 1 || k > kTopkKMax || k > N ||
      N > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // as pt_knn_topk_bf16 chooses for a 16-byte aligned slab
  const TopkConfig c = bf16_config(false, B, D, D % 16 == 0);
  if (c.smem > kMaxSmemTopk) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_bf16_kernel<false>(c, [&](auto kernel) {
    return topk_grid(kernel, c.smem, N, blocks);
  }));
}

// K2. q (B, D) bf16 contiguous; slab (N, D) bf16 contiguous; valid (N,)
// bytes; ws (G, B, k) 64-bit scratch, G from pt_knn_topk_bf16_blocks;
// out_s (B, k) f32 and out_row (B, k) int64 rows, best first. metric: 0 =
// cos, 1 = l2sq; 1 <= k <= 64, k <= N. Two launches; returns the
// cudaError_t of the first that fails, else 0.
extern "C" int pt_knn_topk_bf16(const void* q, const void* slab,
                                const void* valid, void* ws, int G,
                                void* out_s, void* out_row, int B,
                                long long N, int D, int metric, int k,
                                void* stream) {
  Bf16Params p;
  if (!bf16_params(p, q, slab, valid, B, N, D, metric) || G < 1 || k < 1 ||
      k > kTopkKMax || k > N)
    return static_cast<int>(cudaErrorInvalidValue);
  p.ws = static_cast<u64*>(ws);
  p.k = k;
  const TopkConfig c = bf16_config(false, B, D, p.vec);
  if (c.smem > kMaxSmemTopk) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (B + 8 * c.nt - 1) / (8 * c.nt);
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = with_bf16_kernel<false>(c, [&](auto kernel) {
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

// K2's score twin. q (B, D) bf16 contiguous; slab (N, D) bf16 contiguous;
// valid (N,) bytes; out (B, N) int64 keys score_key(score, row).
// metric: 0 = cos, 1 = l2sq; N < 2^31. Returns the cudaError_t of the
// launch.
extern "C" int pt_knn_score_bf16(const void* q, const void* slab,
                                 const void* valid, void* out, int B,
                                 long long N, int D, int metric,
                                 void* stream) {
  Bf16Params p;
  if (!bf16_params(p, q, slab, valid, B, N, D, metric))
    return static_cast<int>(cudaErrorInvalidValue);
  p.out = static_cast<long long*>(out);
  p.vec_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const TopkConfig c = bf16_config(true, B, D, p.vec);
  if (c.smem > kMaxSmemTopk) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (B + 8 * c.nt - 1) / (8 * c.nt);
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_bf16_kernel<true>(c, [&](auto kernel) {
    int blocks = 0;
    const cudaError_t e = topk_grid(kernel, c.smem, N, &blocks);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(blocks, groups), kWarps * 32, c.smem, s>>>(p);
    return cudaGetLastError();
  }));
}

extern "C" const char* pt_knn_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
