// The int8 KNN slab's two kernels for Hopper (sm_90a), bound to Python
// with ctypes (ops/knn_kernels.py).
//
// K3, the int8 score: replaces the score block of
// pathway_tpu/ops/knn.py::_shared_search_i8_fn (an XLA function on the
// TPU). For queries q (B, D) bf16, already normalised for cos and cast,
// and a chunk of N int8 rows with per-row f32 `scales` and int-domain
// squared norms `vsq`:
//   dots = q . bf16(v)   (int8 widens to bf16 exactly, products are exact
//                         in f32, sums in f32)
//   cos:  dots * rsqrt(vsq + 1e-12)            (the row scale cancels)
//   l2sq: 2 dots scale - vsq scale^2           (-||q - v||^2 + ||q||^2)
//   invalid rows: -inf.
// Output: (B, N) f32 scores, row-major. The top-k stays a stable sort in
// ops/knn.py::search_extent (a fused score + top-k is K2's later work).
//
// What bounds it: bytes. Each slab byte is read once; at the serving
// batch (B <= 64) the product is far below the tensor cores' rate, and at
// B = 1 the (B, N) score write is ~1% of the traffic. Design: the slab is
// the M side of mma.sync m16n8k16 (16 rows per warp tile), the queries the
// N side (8 per n-tile, up to 64 per block, staged in shared memory
// zero-padded). A lane loads 16 contiguous bytes of each of its two rows
// per 64 columns (row-contiguous 64-byte runs per quad, streaming loads),
// widens them to bf16 in registers and feeds them as A fragments
// directly. The reduction dimension is permuted inside each 64-column
// block (lane t's bytes 4s..4s+3 of its 16 are the k positions 2t, 2t+1,
// 2t+8, 2t+9 of k-step s), and the query fragments are read with the same
// permutation, so the dot products are unchanged. Blocks loop over row
// tiles (a grid of a few blocks per SM), so each block stages its queries
// once.
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
// scales and vsq are bit-identical to what the JAX index stores. One warp
// per row: bytes bound it (4 D bytes in, D + 9 out per row).

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------------
// K3: int8 score
// ------------------------------------------------------------------------

constexpr int kWarps = 8;          // warps per block
constexpr int kTileRows = 16;      // slab rows per warp tile (mma M)
constexpr int kQPad = 4;           // bf16 padding of a staged query row
constexpr int kMaxQueryTiles = 8;  // n8 query tiles per block (64 queries)
constexpr size_t kMaxSmem = 200 * 1024;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two int8 (bytes `shift / 8` and the next of w) -> a bf16 pair, exact
__device__ __forceinline__ uint32_t widen2(uint32_t w, int shift) {
  const float lo = static_cast<float>(static_cast<int8_t>(w >> shift));
  const float hi = static_cast<float>(static_cast<int8_t>(w >> (shift + 8)));
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

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

struct ScoreParams {
  const bf16* q;
  const int8_t* slab;
  const float* scales;
  const float* vsq;
  const uint8_t* valid;
  float* out;
  long long N;
  int B, D, DP, metric;  // DP: D rounded up to 64; metric 0 = cos, 1 = l2sq
  bool vec;
};

template <int NT>
__global__ void __launch_bounds__(kWarps * 32)
knn_score_i8_kernel(const ScoreParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [8 NT][DP + kQPad]
  const int ld = p.DP + kQPad;
  const int q0 = blockIdx.y * 8 * NT;
  const int nq = min(8 * NT, p.B - q0);
  for (int e = threadIdx.x; e < 8 * NT * p.DP; e += blockDim.x) {
    const int r = e / p.DP, c = e % p.DP;
    qs[r * ld + c] = r < nq && c < p.D
                         ? p.q[static_cast<long long>(q0 + r) * p.D + c]
                         : __float2bfloat16(0.f);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nj = p.DP / 64;
  const long long n_tiles = (p.N + kTileRows - 1) / kTileRows;
  for (long long tile = static_cast<long long>(blockIdx.x) * kWarps + warp;
       tile < n_tiles; tile += static_cast<long long>(gridDim.x) * kWarps) {
    const long long ra = tile * kTileRows + g, rb = ra + 8;
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    uint4 va = load16(p.slab, ra, p.N, p.D, 16 * t, p.vec);
    uint4 vb = load16(p.slab, rb, p.N, p.D, 16 * t, p.vec);
    for (int j = 0; j < nj; ++j) {
      const int col = 64 * j + 16 * t;
      uint4 na = make_uint4(0u, 0u, 0u, 0u), nb = na;
      if (j + 1 < nj) {  // the next 64 columns load while these multiply
        na = load16(p.slab, ra, p.N, p.D, col + 64, p.vec);
        nb = load16(p.slab, rb, p.N, p.D, col + 64, p.vec);
      }
      const uint32_t wa[4] = {va.x, va.y, va.z, va.w};
      const uint32_t wb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // k positions 2t, 2t+1 <- columns col + 4s, +1; 2t+8, 2t+9 <- +2, +3
        const uint32_t a[4] = {widen2(wa[s], 0), widen2(wb[s], 0),
                               widen2(wa[s], 16), widen2(wb[s], 16)};
        const bf16* qc = qs + g * ld + col + 4 * s;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint2 bq = *reinterpret_cast<const uint2*>(qc + n * 8 * ld);
          mma_bf16(acc[n], a, bq.x, bq.y);
        }
      }
      va = na;
      vb = nb;
    }
    // lane holds rows ra (acc[n][0..1]) and rb (acc[n][2..3]) for queries
    // q0 + 8n + 2t and + 1
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = h ? rb : ra;
      if (row >= p.N) continue;
      const bool ok = p.valid[row] != 0;
      const float vs = p.vsq[row];
      const float sc = p.metric ? p.scales[row] : 0.f;
      const float rn = rsqrtf(vs + 1e-12f);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 8 * n + 2 * t + e;
          if (qi >= nq) continue;
          const float dots = acc[n][2 * h + e];
          const float score =
              !ok ? -INFINITY
                  : p.metric ? 2.f * dots * sc - vs * (sc * sc) : dots * rn;
          p.out[static_cast<long long>(q0 + qi) * p.N + row] = score;
        }
    }
  }
}

size_t score_smem(int nt, int DP) {
  return sizeof(bf16) * 8 * nt * (DP + kQPad);
}

template <int NT>
cudaError_t launch_score(const ScoreParams& p, cudaStream_t stream) {
  const size_t smem = score_smem(NT, p.DP);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_score_i8_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (p.N + kTileRows - 1) / kTileRows;
  const long long want = (tiles + kWarps - 1) / kWarps;
  const long long cap = 4LL * sms;  // a few resident blocks per SM
  const dim3 grid(static_cast<unsigned>(want < cap ? want : cap),
                  (p.B + 8 * NT - 1) / (8 * NT));
  knn_score_i8_kernel<NT><<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// K4: quantizing scatter
// ------------------------------------------------------------------------

constexpr int kQuantThreads = 256;  // 8 rows per block, one warp each
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
  m = warp_max(m);
  const float scale = fmaxf(__fmul_rn(m, kInv127), 1e-30f);
  int8_t* out = slab + slot * D;
  int sq = 0;
  for (int c = lane; c < D; c += 32) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[c], scale)), -127.f), 127.f);
    const int qi = static_cast<int>(r);
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

}  // namespace

// K3. q (B, D) bf16 contiguous; slab (N, D) int8 contiguous; scales, vsq
// (N,) f32 (scales read only for l2sq); valid (N,) bytes; out (B, N) f32.
// metric: 0 = cos, 1 = l2sq. Returns the cudaError_t of the launch.
extern "C" int pt_knn_score_i8(const void* q, const void* slab,
                               const void* scales, const void* vsq,
                               const void* valid, void* out, int B,
                               long long N, int D, int metric, void* stream) {
  if (B < 1 || N < 1 || D < 1 || (metric != 0 && metric != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  ScoreParams p;
  p.q = static_cast<const bf16*>(q);
  p.slab = static_cast<const int8_t*>(slab);
  p.scales = static_cast<const float*>(scales);
  p.vsq = static_cast<const float*>(vsq);
  p.valid = static_cast<const uint8_t*>(valid);
  p.out = static_cast<float*>(out);
  p.N = N;
  p.B = B;
  p.D = D;
  p.DP = (D + 63) / 64 * 64;
  p.metric = metric;
  p.vec = D % 16 == 0 && reinterpret_cast<uintptr_t>(slab) % 16 == 0;
  // n8 query tiles per block: enough for B, at most 8, within the
  // shared memory a block may take
  int nt = 1;
  while (nt < kMaxQueryTiles && 8 * nt < B) nt *= 2;
  while (nt > 1 && score_smem(nt, p.DP) > kMaxSmem) nt /= 2;
  if (score_smem(nt, p.DP) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (nt) {
    case 1: e = launch_score<1>(p, s); break;
    case 2: e = launch_score<2>(p, s); break;
    case 4: e = launch_score<4>(p, s); break;
    default: e = launch_score<8>(p, s); break;
  }
  return static_cast<int>(e);
}

// K4. rows (n, D) f32 with row stride ld (elements), last dim contiguous;
// slots (n,) int64 local rows of the extent (outside [0, R): dropped);
// valid_vals (n,) bytes or null (all valid); slab (R, D) int8, scales,
// vsq (R,) f32 and valid (R,) bytes are written in place.
extern "C" int pt_knn_quantize_scatter(const void* rows, long long ld,
                                       const void* slots,
                                       const void* valid_vals, int n, int D,
                                       long long R, void* slab, void* scales,
                                       void* vsq, void* valid, void* stream) {
  if (n < 1 || D < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kQuantThreads / 32 - 1) / (kQuantThreads / 32);
  knn_quantize_scatter_kernel<<<blocks, kQuantThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), ld,
      static_cast<const long long*>(slots),
      static_cast<const uint8_t*>(valid_vals), n, D, R,
      static_cast<int8_t*>(slab), static_cast<float*>(scales),
      static_cast<float*>(vsq), static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pt_knn_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
