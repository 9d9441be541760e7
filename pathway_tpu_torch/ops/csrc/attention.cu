// Encoder attention for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces pathway_tpu/ops/attention.py::_attn_kernel (the Pallas TPU
// kernel behind flash_attention). Same function, per (batch, head):
//   S = Q K^T * D^-1/2 with f32 accumulation; keys whose mask is 0 get the
//   finite fill -FLT_MAX (the Pallas kernel's f32 min, never -inf, so a
//   row with every key masked gives a uniform softmax, i.e. mean(V));
//   P = softmax(S) in f32, normalised, then rounded to V's dtype; O = P V
//   with f32 accumulation, cast to Q's dtype.
// q, k, v are (B, S, H, D) in bf16 or f32, read in place with the strides
// the wrapper passes (last dim contiguous, 16-byte aligned rows); mask is
// (B, S) bytes; the output is a contiguous (B, S, H, D) tensor in q's
// dtype. S <= 1024, D a multiple of 8 up to 128.
//
// Segment ids (the ragged encoder path; replaces the block-diagonal mask
// of pathway_tpu/models/encoder.py::_segment_attention): with a (B, S)
// int32 `seg`, key j is valid for query i iff seg[j] >= 0 and seg[j] ==
// seg[i] (mask is then not read). Each query row keeps its segment id in
// registers, each key's is staged in shared memory beside its limit, and
// a mismatch gives the same -FLT_MAX fill as a masked key, so a padding
// row (seg -1: no key is valid for it) averages V over all S rows. The
// bf16 kernels take it as a template flag, so the unsegmented main path
// pays nothing for it.
//
// What bounds it: bytes. At the encoder's main-path shape (B=512, S=96,
// H=6, D=64, bf16) the function moves ~151 MB (q, k, v read once, O
// written once) for ~7.2 GFLOP, ~48 FLOP/byte, far below the H100's bf16
// tensor-core balance of ~295 FLOP/byte. So the design reads each input
// byte from device memory once and keeps everything else on chip.
//
// bf16 (the encoder's compute dtype, the main path): tensor cores.
//   - Both products are warp-level HMMA (mma.sync m16n8k16, bf16 operands,
//     f32 accumulators). One warp owns 16 query rows; its Q A-fragments are
//     loaded once with ldmatrix and stay in registers. mma.sync, not
//     wgmma: bytes bound the function, HMMA already gives far more
//     arithmetic than the bound needs, and 16-row warp tiles fit S = 96
//     without padding to wgmma's 64-row granularity.
//   - K and V come in through shared memory as bf16 (never widened) with
//     16-byte cp.async. Rows are padded by 16 bytes (row stride D' + 8
//     elements, D' = D rounded up to 16): the stride is an odd number of
//     16-byte chunks, so the 8 row addresses of every ldmatrix fall in 8
//     different bank groups for every D'; an XOR swizzle needs at least 8
//     chunks per row, which D' < 64 does not have.
//   - S <= 128 (ingest and most queries): one block per (batch, head)
//     covers all query rows (S = 96 -> 6 warps), so that pair's K and V
//     are read from device memory exactly once. Q and K arrive as one
//     cp.async group and V as a second, which lands while QK^T runs. A
//     warp's whole score rows fit in its registers (S / 2 floats a lane),
//     so QK^T runs once and the row max and sum are exact, as in the
//     Pallas kernel, before P is formed.
//   - S > 128: one block per (batch, head, 128-query tile); K (pass 1)
//     and K + V (pass 2) stream through shared memory in 64-key tiles,
//     double-buffered with cp.async; one loop runs both passes so pass
//     2's first tile loads during pass 1's last. Pass 1 keeps the running
//     row max m and sum l in f32; pass 2 recomputes QK^T (tensor-core time
//     is cheap here) and forms P with the final m and l.
//   - Either way P is rounded where the Pallas kernel rounds it: p =
//     exp(s - m) / l in f32 (as one ex2 of log2-scaled scores times 1/l),
//     rounded to bf16, its C-fragments packed straight into the
//     A-fragments of the P.V HMMA, O accumulated in f32. Neither scores
//     nor P touch memory. FA2's deferred normalisation is not used: it
//     would round exp(s - m) instead of P.
//   - Tile padding is not masking: key columns past S get -inf, i.e.
//     probability exactly 0 (never the -FLT_MAX mask fill, which would
//     spread a fully masked row over the padding). Key validity and
//     padding are one per-key limit staged in shared memory, applied by
//     one min per (query, key) in `logit`; segment ids add a second min
//     there. Padded K/V rows and head-dim columns past D are
//     zero-filled by cp.async; query rows past S are computed and not
//     stored.
//   - O goes out through the warp's own Q rows in shared memory, so each
//     row leaves as whole 16-byte stores.
//   Left for a later PR: wgmma with TMA loads and warp specialisation, a
//   persistent grid that overlaps one (batch, head)'s loads with another's
//   compute, and for S > 128 fewer exponentials (its exact two passes take
//   two ex2 per score; by instruction count the SFU, not memory, should
//   set its pace there).
//
// f32 (off the main path): the first, FMA design, chosen by dtype at
// dispatch. Tensor cores would mean TF32, which the port keeps off to
// hold f32 to 1e-4. One block per (32-query tile, head, batch): each
// thread dots one key row with the tile's query rows, one warp per row
// does the softmax, then P V with V staged in 64-row tiles.

#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSeq = 1024;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* mask;
  const int* seg;  // (B, S) segment ids, or null
  void* out;
  int S, H, D;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;   // D^-1/2 (f32 kernel)
  float scale2;  // D^-1/2 * log2(e) (bf16 kernels: exp as one ex2)
};

// ------------------------------------------------------------------------
// bf16: tensor cores
// ------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kChunk = 32;        // keys per compute step of a warp
constexpr int kResidentSeq = 128; // S up to this: one block per (b, h)
constexpr int kStreamQ = 128;     // query rows per block above it
constexpr int kStreamK = 64;      // keys per cp.async stage above it
constexpr int kMmaThreads = 256;  // 8 warps of 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-fills the destination when !fill
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for a 16x16 bf16 A (row) and 16x8 bf16 B (col) fragment
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one SFU instruction (2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Per-key upper limit of a log2-domain score, staged once per block for
// keys [0, n) of one batch row: +inf for a valid key, -FLT_MAX (the mask
// fill) for a masked one (mask 0, or a negative segment id when seg is
// given), -inf (probability exactly 0) for tile padding past S. With seg,
// each key's segment id goes to kseg too.
__device__ __forceinline__ void stage_limits(float* lim, int* kseg,
                                             const uint8_t* mask,
                                             const int* seg, int S, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const bool pad = j >= S;
    const bool ok = pad ? false : seg ? seg[j] >= 0 : mask[j] != 0;
    lim[j] = pad ? -INFINITY : ok ? INFINITY : -FLT_MAX;
    if (seg) kseg[j] = pad ? 0 : seg[j];
  }
}

// The masked log2-domain score of one (query, key): one min applies key
// validity and padding; with segments a second min gives -FLT_MAX to a
// key of another segment (padding keeps its -inf).
template <bool SEG>
__device__ __forceinline__ float logit(float acc, float scale2, float limit,
                                      int qseg, int kseg) {
  const float x = fminf(acc * scale2, limit);
  return SEG ? fminf(x, qseg == kseg ? INFINITY : -FLT_MAX) : x;
}

// Rows [r0, r0 + n) of a (S, D) bf16 matrix with row stride ld into shared
// memory with row stride DP + 8; rows past S and columns past D are
// zero-filled. One cp.async of 16 bytes per (row, 8 columns).
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, int r0, int n, int S,
                                          int D) {
  constexpr int kLd = DP + 8, kChunks = DP / 8;
  for (int e = threadIdx.x; e < n * kChunks; e += blockDim.x) {
    const int i = e / kChunks, c = e % kChunks, r = r0 + i;
    const bool ok = r < S && c * 8 < D;
    cp_async16(dst + i * kLd + c * 8, ok ? src + r * ld + c * 8 : src, ok);
  }
}

// One warp's 16 query rows. Lane (g = lane / 4, t = lane % 4) holds rows
// g and g + 8; in a chunk's score fragment s[n] its keys are 8n + 2t and
// 8n + 2t + 1. Scores are kept in the log2 domain (QK^T * D^-1/2 *
// log2(e)), so each exp(s - m) of the softmax is one ex2 of a difference.
// With SEG, qseg holds the segment ids of rows g and g + 8.
template <int DP, bool SEG>
struct WarpRows {
  static constexpr int kLd = DP + 8;
  int lane, row0;
  int qseg[2];
  uint32_t qa[DP / 16][4];  // Q A-fragments, one per 16 head-dim columns
  float o[DP / 8][4];       // O C-fragments, one per 8 head-dim columns

  // seg: this batch row's segment ids (SEG only); rows past S get 0
  __device__ void init(const bf16* qs, int lane_, int row0_, const int* seg,
                       int S) {
    lane = lane_;
    row0 = row0_;
    if (SEG) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + (lane >> 2) + 8 * r;
        qseg[r] = row < S ? seg[row] : 0;
      }
    }
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      ldsm_x4(qa[ks], qs + (lane & 15) * kLd + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  }

  // Masked log2-domain scores of keys [key0, key0 + 32) (kc: their K rows)
  __device__ void scores(float (&s)[kChunk / 8][4], const bf16* kc, int key0,
                         float scale2, const float* lim,
                         const int* kseg) const {
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
#pragma unroll
      for (int np = 0; np < kChunk / 16; ++np) {
        uint32_t b[4];  // keys 16np + 0..7 and 8..15, columns 16ks + 0..15
        ldsm_x4(b, kc + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                       ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[ks], b[2], b[3]);
      }
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
      const int kj = key0 + n * 8 + 2 * t;
      const float2 lk = *reinterpret_cast<const float2*>(lim + kj);
      int2 kg = make_int2(0, 0);
      if (SEG) kg = *reinterpret_cast<const int2*>(kseg + kj);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = logit<SEG>(s[n][e], scale2, e & 1 ? lk.y : lk.x,
                             qseg[e >> 1], e & 1 ? kg.y : kg.x);
    }
  }

  // O += P V over one chunk, P = e / l rounded to bf16, given e = 2^(s -
  // m) and rinv = 1 / l; the C-fragments of e become the A-fragments of P
  __device__ void pv(const float (&e)[kChunk / 8][4], const bf16* vc,
                     const float (&rinv)[2]) {
    uint32_t pa[kChunk / 16][4];  // P A-fragments, 16 keys each
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // key halves 0..7, 8..15
        const float(&f)[4] = e[2 * ks + h];
        pa[ks][2 * h] = pack_bf16(f[0] * rinv[0], f[1] * rinv[0]);
        pa[ks][2 * h + 1] = pack_bf16(f[2] * rinv[1], f[3] * rinv[1]);
      }
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks)
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t b[4];  // keys 16ks + 0..15, columns 16dp + 0..7 and 8..15
        ldsm_x4_trans(b, vc + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                  * kLd + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa[ks], b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa[ks], b[2], b[3]);
      }
  }

  // O rows [row0, row0 + 16) through the warp's own rows qs (its Q
  // fragments are in registers), then 16-byte stores of rows < S
  __device__ void store(bf16* qs, bf16* out, long long row_stride,
                        int S, int D) const {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      *reinterpret_cast<uint32_t*>(qs + g * kLd + n * 8 + 2 * t) =
          pack_bf16(o[n][0], o[n][1]);
      *reinterpret_cast<uint32_t*>(qs + (g + 8) * kLd + n * 8 + 2 * t) =
          pack_bf16(o[n][2], o[n][3]);
    }
    __syncwarp();
    const int chunks = D / 8;
    for (int e = lane; e < 16 * chunks; e += 32) {
      const int i = e / chunks, c = e % chunks;
      if (row0 + i < S)
        *reinterpret_cast<uint4*>(out + (row0 + i) * row_stride + c * 8) =
            *reinterpret_cast<const uint4*>(qs + i * kLd + c * 8);
    }
  }
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Q, K, V rows, then per key its limit (float) and segment id (int)
__host__ __device__ constexpr size_t resident_smem(int S, int DP) {
  return sizeof(bf16) * (round_up(S, 16) + 2 * round_up(S, kChunk)) *
             (DP + 8) + (sizeof(float) + sizeof(int)) * round_up(S, kChunk);
}

__host__ __device__ constexpr size_t streamed_smem(int DP) {
  return sizeof(bf16) * (kStreamQ + 4 * kStreamK) * (DP + 8) +
         (sizeof(float) + sizeof(int)) * kMaxSeq;
}

// S <= 128 (NC = ceil(S / 32) chunks of keys): one block per (head,
// batch), one warp per 16 query rows. Q, K and V are read once into
// shared memory; each warp keeps its rows' whole scores in registers, so
// QK^T runs once and the max and sum are exact before P is formed.
template <int DP, int NC, bool SEG>
__global__ void __launch_bounds__(NC * 64)
attention_mma_resident(const Params p) {
  constexpr int kLd = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.S, D = p.D;
  const int nq = round_up(S, 16);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + nq * kLd;
  bf16* vs = ks + NC * kChunk * kLd;
  float* lim = reinterpret_cast<float*>(vs + NC * kChunk * kLd);
  int* kseg = reinterpret_cast<int*>(lim + NC * kChunk);
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_rows<DP>(qs, qp, p.q_ss, 0, nq, S, D);
  load_rows<DP>(ks, kp, p.k_ss, 0, NC * kChunk, S, D);
  cp_async_commit();
  load_rows<DP>(vs, vp, p.v_ss, 0, NC * kChunk, S, D);
  cp_async_commit();
  const int* seg = SEG ? p.seg + static_cast<long long>(b) * S : nullptr;
  stage_limits(lim, kseg, p.mask + static_cast<long long>(b) * S, seg, S,
               NC * kChunk);
  cp_async_wait<1>();  // Q and K landed; V may still be in flight
  __syncthreads();

  WarpRows<DP, SEG> w;
  bf16* wq = qs + warp * 16 * kLd;
  w.init(wq, lane, warp * 16, seg, S);
  float s[NC][kChunk / 8][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
    w.scores(s[c], ks + c * kChunk * kLd, c * kChunk, p.scale2, lim, kseg);
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, rinv[2];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[c][n][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[c][n][e] = exp2_approx(s[c][n][e] - m[e >> 1]);
        l[e >> 1] += s[c][n][e];
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) rinv[r] = 1.f / quad_sum(l[r]);
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NC; ++c)
    w.pv(s[c], vs + c * kChunk * kLd, rinv);
  const long long row_stride = static_cast<long long>(p.H) * D;
  w.store(wq, static_cast<bf16*>(p.out) +
                  (static_cast<long long>(b) * S * p.H + h) * D,
          row_stride, S, D);
}

// S > 128: one block per (128-query tile, head, batch). One loop of 2 NT
// steps over the NT key tiles: steps < NT are pass 1 (K only: running
// max m and sum l), the rest pass 2 (K and V: scores recomputed, P formed
// with the final m and l, O += P V); step i + 1's tile loads while step i
// computes.
template <int DP, bool SEG>
__global__ void __launch_bounds__(kMmaThreads)
attention_mma_streamed(const Params p) {
  constexpr int kLd = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.S, D = p.D;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kbuf = qs + kStreamQ * kLd;       // [2][kStreamK][kLd]
  bf16* vbuf = kbuf + 2 * kStreamK * kLd; // [2][kStreamK][kLd]
  float* lim = reinterpret_cast<float*>(vbuf + 2 * kStreamK * kLd);
  int* kseg = reinterpret_cast<int*>(lim + kMaxSeq);
  const int q0 = blockIdx.x * kStreamQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int nt = (S + kStreamK - 1) / kStreamK;

  auto issue = [&](int step) {
    const int t = step < nt ? step : step - nt, stage = step & 1;
    load_rows<DP>(kbuf + stage * kStreamK * kLd, kp, p.k_ss, t * kStreamK,
                  kStreamK, S, D);
    if (step >= nt)
      load_rows<DP>(vbuf + stage * kStreamK * kLd, vp, p.v_ss,
                    t * kStreamK, kStreamK, S, D);
    cp_async_commit();
  };
  load_rows<DP>(qs, qp + q0 * p.q_ss, p.q_ss, 0, kStreamQ, S - q0, D);
  cp_async_commit();
  issue(0);
  const int* seg = SEG ? p.seg + static_cast<long long>(b) * S : nullptr;
  stage_limits(lim, kseg, p.mask + static_cast<long long>(b) * S, seg, S,
               nt * kStreamK);

  WarpRows<DP, SEG> w;
  bf16* wq = qs + warp * 16 * kLd;
  // this lane's running max and sum (rows g, g + 8), combined across the
  // quad after pass 1
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, rinv[2];
  for (int step = 0; step < 2 * nt; ++step) {
    if (step + 1 < 2 * nt) {
      issue(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (step == 0) w.init(wq, lane, q0 + warp * 16, seg, S);
    if (step == nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mr = quad_max(m[r]);
        rinv[r] = 1.f / quad_sum(l[r] * exp2_approx(m[r] - mr));
        m[r] = mr;
      }
    }
    const int t = step < nt ? step : step - nt, stage = step & 1;
    const bf16* kt = kbuf + stage * kStreamK * kLd;
    const bf16* vt = vbuf + stage * kStreamK * kLd;
#pragma unroll
    for (int c = 0; c < kStreamK; c += kChunk) {
      const int key0 = t * kStreamK + c;
      if (key0 >= S) break;
      float s[kChunk / 8][4];
      w.scores(s, kt + c * kLd, key0, p.scale2, lim, kseg);
      if (step < nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[r];
#pragma unroll
          for (int n = 0; n < kChunk / 8; ++n)
            mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < kChunk / 8; ++n)
            sum += exp2_approx(s[n][2 * r] - mx) +
                   exp2_approx(s[n][2 * r + 1] - mx);
          l[r] = l[r] * exp2_approx(m[r] - mx) + sum;
          m[r] = mx;
        }
      } else {
#pragma unroll
        for (int n = 0; n < kChunk / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = exp2_approx(s[n][e] - m[e >> 1]);
        w.pv(s, vt + c * kLd, rinv);
      }
    }
    __syncthreads();  // this stage is refilled by step + 2's issue
  }
  const long long row_stride = static_cast<long long>(p.H) * D;
  w.store(wq, static_cast<bf16*>(p.out) +
                  (static_cast<long long>(b) * S * p.H + h) * D,
          row_stride, S, D);
}

// The dynamic shared-memory opt-in is per device, so it is set on every
// launch that needs more than 48 KB (a cheap host call), to the most any
// supported S needs, so concurrent launches with other S never lower it
// under each other.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, size_t most) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(most));
}

template <int DP, int NC, bool SEG>
cudaError_t launch_resident(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = resident_smem(p.S, DP);
  const cudaError_t e = opt_in(attention_mma_resident<DP, NC, SEG>, smem,
                               resident_smem(NC * kChunk, DP));
  if (e != cudaSuccess) return e;
  const int threads = round_up(p.S, 16) / 16 * 32;
  attention_mma_resident<DP, NC, SEG>
      <<<dim3(p.H, B), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP, bool SEG>
cudaError_t launch_mma(const Params& p, int B, cudaStream_t stream) {
  static_assert(kResidentSeq == 4 * kChunk, "resident NC is 1..4");
  switch ((p.S + kChunk - 1) / kChunk) {
    case 1: return launch_resident<DP, 1, SEG>(p, B, stream);
    case 2: return launch_resident<DP, 2, SEG>(p, B, stream);
    case 3: return launch_resident<DP, 3, SEG>(p, B, stream);
    case 4: return launch_resident<DP, 4, SEG>(p, B, stream);
    default: break;
  }
  const size_t smem = streamed_smem(DP);
  const cudaError_t e = opt_in(attention_mma_streamed<DP, SEG>, smem, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.S + kStreamQ - 1) / kStreamQ, p.H, B);
  attention_mma_streamed<DP, SEG><<<grid, kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_mma(const Params& p, int B, cudaStream_t stream) {
  return p.seg ? launch_mma<DP, true>(p, B, stream)
               : launch_mma<DP, false>(p, B, stream);
}

cudaError_t dispatch_mma(const Params& p, int B, cudaStream_t stream) {
  switch (round_up(p.D, 16)) {  // D' : D zero-padded to a multiple of 16
#define PT_CASE(dp) \
  case dp:          \
    return launch_mma<dp>(p, B, stream);
    PT_CASE(16) PT_CASE(32) PT_CASE(48) PT_CASE(64) PT_CASE(80) PT_CASE(96)
    PT_CASE(112) PT_CASE(128)
#undef PT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------------
// f32: FMA kernel
// ------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockQ = 32;                      // query rows per block
constexpr int kRowsPerWarp = kBlockQ / kWarps;   // output rows per warp
constexpr int kTileV = 64;                       // V rows per stage

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [r0, r0 + n) of a (rows, D) matrix with row stride ld into
// shared memory, zero-filling up to `rows_total` rows.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long ld, int n,
                                           int rows_total) {
  for (int e = threadIdx.x * 8; e < rows_total * D; e += kThreads * 8) {
    const int r = e / D, c = e % D;  // D % 8 == 0: a chunk stays in a row
    float t[8];
    if (r < n) {
      load8(src + r * ld + c, t);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) t[i] = 0.f;
    }
    float4* d = reinterpret_cast<float4*>(dst + r * D + c);
    d[0] = make_float4(t[0], t[1], t[2], t[3]);
    d[1] = make_float4(t[4], t[5], t[6], t[7]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_fma_kernel(const Params p) {
  extern __shared__ __align__(16) float fsmem[];
  const int S = p.S;
  const int s_pad = (S + 3) & ~3;
  float* sc = fsmem;                       // [kBlockQ][s_pad] scores -> P
  float* stage = fsmem + kBlockQ * s_pad;  // Q tile, later V tiles

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = min(kBlockQ, S - q0);
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const uint8_t* mk = p.mask + static_cast<long long>(b) * S;
  const int* sg = p.seg ? p.seg + static_cast<long long>(b) * S : nullptr;
  __shared__ int qseg[kBlockQ];  // the tile's query segment ids (seg only)

  // 1. scores
  stage_rows<D>(stage, qp + q0 * p.q_ss, p.q_ss, nq, kBlockQ);
  if (sg && tid < nq) qseg[tid] = sg[q0 + tid];
  __syncthreads();
  for (int j = tid; j < S; j += kThreads) {
    float kr[D];
    const float* krow = kp + j * p.k_ss;
#pragma unroll
    for (int c = 0; c < D; c += 8) load8(krow + c, kr + c);
    const int ks = sg ? sg[j] : 0;
    const bool key_ok = sg ? ks >= 0 : mk[j] != 0;
    for (int r = 0; r < nq; ++r) {
      const bool valid = key_ok && (!sg || ks == qseg[r]);
      const float4* qr = reinterpret_cast<const float4*>(stage + r * D);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 qq = qr[c];
        a0 = fmaf(qq.x, kr[4 * c], a0);
        a1 = fmaf(qq.y, kr[4 * c + 1], a1);
        a2 = fmaf(qq.z, kr[4 * c + 2], a2);
        a3 = fmaf(qq.w, kr[4 * c + 3], a3);
      }
      sc[r * s_pad + j] = valid ? ((a0 + a1) + (a2 + a3)) * p.scale : -FLT_MAX;
    }
  }
  __syncthreads();

  // 2. softmax over each row
  for (int r = warp; r < nq; r += kWarps) {
    float* row = sc + r * s_pad;
    float m = -FLT_MAX;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32) row[j] = row[j] / sum;
    for (int j = S + lane; j < s_pad; j += 32) row[j] = 0.f;
  }

  // 3. O = P V
  constexpr int C = (D + 31) / 32;
  float acc[kRowsPerWarp][C];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kTileV) {
    const int nt = min(kTileV, S - t0);
    __syncthreads();  // softmax done / previous tile consumed
    stage_rows<D>(stage, vp + t0 * p.v_ss, p.v_ss, nt, kTileV);
    __syncthreads();
    const int nt4 = (nt + 3) & ~3;  // zero rows of V meet zero columns of P
    for (int j = 0; j < nt4; j += 4) {
      float vv[4][C];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < D ? stage[(j + jj) * D + d] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + i * kWarps;
        if (r < nq) {
          const float4 pp =
              *reinterpret_cast<const float4*>(sc + r * s_pad + t0 + j);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float a = acc[i][c];
            a = fmaf(pp.x, vv[0][c], a);
            a = fmaf(pp.y, vv[1][c], a);
            a = fmaf(pp.z, vv[2][c], a);
            a = fmaf(pp.w, vv[3][c], a);
            acc[i][c] = a;
          }
        }
      }
    }
  }

  float* op = static_cast<float*>(p.out);
  const int H = p.H;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    if (r >= nq) continue;
    float* orow = op + ((static_cast<long long>(b) * S + q0 + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = acc[i][c];
    }
  }
}

size_t fma_smem(int S, int D) {
  const int s_pad = (S + 3) & ~3;
  const int stage_rows = kBlockQ > kTileV ? kBlockQ : kTileV;
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * s_pad +
                          static_cast<size_t>(stage_rows) * D);
}

template <int D>
cudaError_t launch_fma(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = fma_smem(p.S, D);
  const cudaError_t e =
      opt_in(attention_fma_kernel<D>, smem, fma_smem(kMaxSeq, D));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.S + kBlockQ - 1) / kBlockQ, p.H, B);
  attention_fma_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch_fma(const Params& p, int B, cudaStream_t stream) {
  switch (p.D) {
#define PT_CASE(d) \
  case d:          \
    return launch_fma<d>(p, B, stream);
    PT_CASE(8) PT_CASE(16) PT_CASE(24) PT_CASE(32) PT_CASE(40) PT_CASE(48)
    PT_CASE(56) PT_CASE(64) PT_CASE(72) PT_CASE(80) PT_CASE(88) PT_CASE(96)
    PT_CASE(104) PT_CASE(112) PT_CASE(120) PT_CASE(128)
#undef PT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; seg is null or (B, S) int32. Strides
// are in elements. Returns the cudaError_t of the launch (0 on success).
extern "C" int pt_attention_forward(
    const void* q, const void* k, const void* v, const void* mask,
    const void* seg, void* out,
    int dtype, int B, int S, int H, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, void* stream) {
  if (S < 1 || S > kMaxSeq || B < 1 || H < 1 || D % 8 || D < 8 || D > 128)
    return cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.mask = static_cast<const uint8_t*>(mask);
  p.seg = static_cast<const int*>(seg);
  p.out = out;
  p.S = S; p.H = H; p.D = D;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale = 1.0f / sqrtf(static_cast<float>(D));
  p.scale2 = p.scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = dtype == 1 ? dispatch_mma(p, B, s)
                        : dtype == 0 ? dispatch_fma(p, B, s)
                                     : cudaErrorInvalidValue;
  return static_cast<int>(e);
}

extern "C" const char* pt_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
