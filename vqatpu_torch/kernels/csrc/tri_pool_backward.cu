// Backward of the weighted trilinear pool: its four cotangents in one pass
// over vt, the three products on the tensor cores.
//
// Replaces the VJP of `trilinear_pool_pallas`, `_tri_pool_bwd`
// (vqatpu/kernels/trilinear.py:415-426), whose einsums JAX leaves to XLA.
// For a cotangent g [B, D], with gP[b,(j,l),d] = qt[b,j,d] at[b,l,d] g[b,d]
// and U[b,(j,l),d] = sum_i w[b,i,j,l] vt[b,i,d]:
//
//   gvt[b,i,d]  = sum_{j,l} w[b,i,j,l] gP[b,(j,l),d]
//   gqt[b,j,d]  = g[b,d] sum_l at[b,l,d] U[b,(j,l),d]
//   gat[b,l,d]  = g[b,d] sum_j qt[b,j,d] U[b,(j,l),d]
//   gw[b,i,j,l] = sum_d vt[b,i,d] gP[b,(j,l),d]
//
// Layouts: g [B,D] f32, vt [B,V,D], qt [B,Q,D], at [B,A,D] contiguous; w
// [B,V,Q,A] f32 with any strides (one glimpse of the [B,V,Q,A,G] attention,
// read in place as the forward reads it).  gvt, gqt and gat come out in
// their primals' dtypes, contiguous; gw [B,V,Q,A] f32, contiguous.
//
// What bounds it on the H100: bytes, about as much as the products.  At
// B=256, V=50, Q=12, A=3, D=1024 (float32) it must read vt (52.4 MB), qt
// (12.6), at (3.1), w (1.8) and g (1.0) and write the four cotangents
// (70.0 MB): 141 MB, 42 us at 3.35 TB/s.  Its three V x Q*A x D products a
// sample are 2.83 GFLOP, 42 us on the f32 CUDA cores (67 TFLOP/s), where
// an earlier design of this kernel ran them at 3.8x the bound.  On the
// tensor cores, each float32 operand as three bf16 terms, they take six
// bf16 products each and, in 16-row, 8- and 16-wide tiles, 25 GFLOP: 25 us
// at 989 TFLOP/s.
//
// Design:
// - Persistent: one block an SM (8 warps of 32 d, 2 a scheduler; its
//   shared memory, up to 226 KB at float32, allows no second) walks units
//   of (sample b, 256-d span, pass over NQ question tokens), blocks
//   blockIdx.x, blockIdx.x + gridDim.x, ... .  A unit streams its box rows
//   once, VR = 16 a chunk, vt and w through a two-slot ring of cp.async
//   copies, zero past V, D, Q and A; the next unit's operands (qt's rows,
//   at's, g: a second buffer) and first chunk arrive while a unit ends,
//   so that only the kernel's first unit waits for them.  p, wv and U
//   never reach device memory.
// - Operands as bf16 terms (split_bf16x3, mma.cuh): w always, gP always,
//   vt at float32, each split once as it reaches shared memory (gP once a
//   unit) into planes that ldmatrix reads: w [i][p], gP [d][p] and vt
//   [i][d], rows padded to fall in distinct banks.  A bf16 vt is read from
//   the ring as it is, one term.  w's planes are shared (split by all
//   threads, then a barrier); vt's and gP's rows are each warp's own d, so
//   each warp splits its own, without one.
// - Each product of a 16 x 8 x 16 tile sums its term pairs in fresh
//   fragments (the first with zero accumulators in), smallest first, and
//   adds them to the float32 sum in registers (FADD, rounded to nearest),
//   so the tensor cores' truncating sums never run longer than one k16
//   step: float32 cotangents stay as close to float64 as cuBLAS's float32
//   products (chip_smoke.py holds them to twice its error; summing gw's and
//   gvt's k16 steps in the tensor cores reached 2.1x on gvt).
// - The pairs a product sums (Pairs): a float32 x float32 product the six
//   down to 2^-16 of the leading one (a0b0; a0b1, a1b0; a0b2, a1b1, a2b0);
//   the three below 2^-24 fall under float32's rounding.  An exact bf16
//   operand against a split one all three.  gvt at bf16 (rounded to bf16,
//   2^-9, as it is stored) w's and gP's first two terms, three pairs, down
//   to 2^-16.  Float32: 6 pairs in all three products; bf16: U and gw 3
//   (exact products), gvt 3.
// - Per warp and chunk, with mma.sync.m16n8k16 (bf16 in, f32 sums), each
//   pair's products of all of a step's tiles started together:
//   U[d,p] += sum_i vt[i,d] w[i,p] (M = the warp's 32 d, N = the pairs, K =
//   the chunk's rows; U's fragments stay in registers for the unit);
//   gw[i,p] = sum_d vt[i,d] gP[p,d] (M = rows, N = pairs, K = the warp's
//   d); gvt[i,d] = sum_p w[i,p] gP[p,d] (M = rows, N = the warp's d, K =
//   pairs), through the warp's shared buffer (at float32, its own columns
//   of vt's planes) to 4 rows x 128 bytes a store.  The next chunk's
//   copies are asked for after U's MMAs and the last chunk's gw parts
//   flushed after gw's, so that they go out while the MMAs run.  At bf16
//   gw and gvt take all their n8 tiles at once; at float32 two at a time,
//   which leaves registers for vt's three terms (no spills).
// - The 8 warps' gw parts meet in shared memory, double-buffered, and are
//   added in warp order a chunk later.  gw sums over all of D: with D >
//   256 each span writes its part to a scratch buffer of the caller's, [B,
//   spans, V, Q*A], and a second small kernel adds the spans in order.  No
//   atomics: the same inputs give the same bits, and a sample's bits do
//   not depend on the batch.
// - Epilogue of a unit: U through shared memory (over gP's planes), then
//   with a d a thread gqt = g sum_l at U and gat's sums over j, the plain
//   version's order of sums (trilinear_pool_grads).
// - Instances by A: <12, 3> (A <= 3: the free-form model's Q <= 12 in one
//   pass), <6, 6> (A <= 6: Visual7W's Q = 12 in 2 passes) and <4, 8>.
//   Further passes stream vt again (from L2) and add gvt into what the
//   earlier passes stored (in a float32 scratch where gvt is bf16); gat's
//   sums are carried across passes in shared memory.
// - V=50 pads to 64 rows: every product's row tile is 16.  Shared memory
//   is addressed through 32-bit bases with constant offsets, and the copy
//   and flush loops stay rolled: otherwise ptxas keeps each address in a
//   register and spills.

// Measured on an NVIDIA H100 80GB HBM3 at 700 W, cold L2 (chip_smoke.py):
// 154.3 us at B=256 float32 (3.6x the bound; the f32-FMA design 159.1,
// the four torch.bmm 471.7), 113.5 / 114.6 us bf16 at glimpse 0 / 1
// (148.7 / 152.9), 296.9 us at Q*A=72 (353.9), bf16 219.2 / 221.7 (325.1 /
// 336.8), 81.9 us at D=512 (86.3).  The splits, copies and flushes run
// between the MMAs, not under them: one block an SM keeps every warp in
// the same phase (python3 -m vqatpu_torch.kernels.probe, section 4).
// Variants there: sums in the tensor cores without the FADD, within 1-2%
// at float32 but 1.4-3.1x cuBLAS's float64 error; all n8 tiles at once at
// float32, equal and spilling; the flush before the barrier, 2-5% slower;
// the next unit's operands at its last chunk, within 1%.
//
// Needs D % (16 / sizeof(TV)) == 0 (4 f32, 8 bf16), Q <= 32, A <= 8 and
// 16-byte aligned g, vt, qt, at and cotangents; the entry points refuse
// anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;               // warps of a block, 32 d each
constexpr int THREADS = 32 * WARPS;
constexpr int DSPAN = 32 * WARPS;      // d a block: 256
constexpr int VR = 16;                 // box rows a chunk: one row tile
constexpr int STAGES = 2;              // ring depth
constexpr int USTRIDE = DSPAN + 4;     // a row of U in shared memory
constexpr int VPROW = DSPAN + 8;       // a row of a vt plane, bf16
constexpr int RSTRIDE = 40;            // a row of a warp's gw part or gvt tile: 8 mod 32
constexpr int MAX_Q = 32;
constexpr int MAX_A = 8;
constexpr int SUM_THREADS = 256;

template <int NQ, int NA>
struct Shape {
  static constexpr int P = NQ * NA;          // (j, l) pairs of a pass
  static constexpr int NT = (P + 7) / 8;     // n8 tiles over the pairs
  static constexpr int NP = (NT + 1) / 2;    // ldmatrix_x4 loads of them
  static constexpr int KS = (P + 15) / 16;   // k16 steps over the pairs
  static constexpr int PROW = KS * 16 + 8;   // a row of a w or gP plane, bf16
  static_assert(P % 2 == 0 && NT * 8 <= RSTRIDE && NP * 16 <= KS * 16,
                "pairs in twos; a gw part row holds the n8 tiles");
};

// Shared memory in bytes: the ring; the vt planes (float32 vt only); the
// w planes; the gP planes (U over them in a unit's epilogue); two buffers
// of the warps' gw parts; each warp's gvt tile on its way to device
// memory (with a float32 vt, in the warp's own columns of the vt planes);
// gat's sums over j carried from pass to pass; and two buffers of a
// unit's operands (qt's NQ rows, at's NA rows, g; zero past Q, A and D),
// the next unit's arriving while this one runs.
template <typename TV, typename TQ, int NQ, int NA>
struct Smem {
  using S = Shape<NQ, NA>;
  static constexpr bool split_vt = sizeof(TV) == 4;
  static constexpr int vts = split_vt ? DSPAN : VPROW;  // a ring row of vt
  static constexpr int stage_w = VR * vts * (int)sizeof(TV);
  static constexpr int stage = stage_w + VR * S::P * 4;
  static constexpr int vplanes = STAGES * stage;
  static constexpr int wplanes = vplanes + (split_vt ? 3 * VR * VPROW * 2 : 0);
  static constexpr int gplanes = wplanes + 3 * VR * S::PROW * 2;
  static constexpr int red = gplanes + 3 * DSPAN * S::PROW * 2;
  static constexpr int gvts = red + 2 * WARPS * VR * RSTRIDE * 4;
  static constexpr int msum = gvts + (split_vt ? 0 : WARPS * VR * RSTRIDE * 4);
  static constexpr int ops = msum + NA * DSPAN * 4;
  static constexpr int ops_g = (NQ + NA) * DSPAN * (int)sizeof(TQ);  // g's row
  static constexpr int ops_size = ops_g + DSPAN * 4;
  static constexpr int bytes = ops + 2 * ops_size;
  static_assert(S::P * USTRIDE * 4 <= 3 * DSPAN * S::PROW * 2, "U over the gP planes");
  static_assert(stage_w % 16 == 0 && stage % 16 == 0 && wplanes % 16 == 0 &&
                    gplanes % 16 == 0 && red % 16 == 0 && ops % 16 == 0 &&
                    ops_g % 16 == 0,
                "16-byte aligned regions");
};

// The term pairs a product of an operand in TA bf16 terms and one in TB
// sums, smallest first: a(k) and b(k) are pair k's terms.
template <int TA, int TB>
struct Pairs;
template <>
struct Pairs<3, 3> {  // a2b0, a1b1, a0b2, a1b0, a0b1, a0b0
  static constexpr int n = 6;
  __host__ __device__ static constexpr int a(int k) { return k == 0 ? 2 : k == 1 || k == 3; }
  __host__ __device__ static constexpr int b(int k) { return k == 2 ? 2 : k == 1 || k == 4; }
};
template <>
struct Pairs<1, 3> {  // a b2, a b1, a b0
  static constexpr int n = 3;
  __host__ __device__ static constexpr int a(int) { return 0; }
  __host__ __device__ static constexpr int b(int k) { return 2 - k; }
};
template <>
struct Pairs<2, 2> {  // a1b0, a0b1, a0b0
  static constexpr int n = 3;
  __host__ __device__ static constexpr int a(int k) { return k == 0; }
  __host__ __device__ static constexpr int b(int k) { return k == 1; }
};

// c[m][n0 + n] += the pairs' products of tile (m, n0 + n), n < N2, of one
// k16 step: a[m][term] the A fragments, b[n / 2][term] the B fragments of
// n8 tiles n0 + n and n0 + n + 1 (ldmatrix_x4's four registers).  Each
// tile's pairs are summed in fresh fragments (the first product's
// accumulators in are zero), then added to c by FADD.  A pair's products
// of all the tiles are started together, so that back-to-back MMAs are
// independent.
template <typename PR, int N2 = 2, int M, int N, int TA, int TB, int NB>
__device__ __forceinline__ void mma_tiles(float (&c)[M][N][4], const unsigned (&a)[M][TA][4],
                                          const unsigned (&b)[NB][TB][4], int n0) {
  static_assert(N2 <= 2 * NB, "B fragments for every tile");
  float t[M][N2][4];
#pragma unroll
  for (int k = 0; k < PR::n; ++k)
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < N2; ++n) {
        const unsigned b0 = b[n / 2][PR::b(k)][n % 2 * 2], b1 = b[n / 2][PR::b(k)][n % 2 * 2 + 1];
        if (k == 0)
          mma_bf16_zero(t[m][n], a[m][PR::a(k)], b0, b1);
        else
          mma_bf16(t[m][n], a[m][PR::a(k)], b0, b1);
      }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][n0 + n][e] += t[m][n][e];
}

// x and y as their three bf16 terms each (split_bf16x3), packed in twos:
// t[k] holds x's term k in its lower half
__device__ __forceinline__ void split2(float x, float y, unsigned (&t)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    t[k] = *reinterpret_cast<const unsigned*>(&h);
    const float2 f = __bfloat1622float2(h);
    x -= f.x, y -= f.y;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(bf16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

template <typename TV, typename TQ, int NQ, int NA>
__global__ void __launch_bounds__(THREADS, 1)
tri_pool_backward_mma_kernel(const float* __restrict__ g, const TV* __restrict__ vt,
                             const TQ* __restrict__ qt, const TQ* __restrict__ at,
                             const float* __restrict__ w, long long w_sb, long long w_sv,
                             long long w_sq, long long w_sa, TV* __restrict__ gvt,
                             TQ* __restrict__ gqt, TQ* __restrict__ gat,
                             float* __restrict__ part, float* __restrict__ acc, int B,
                             int V, int Q, int A, int D, int n_spans) {
  using S = Shape<NQ, NA>;
  using L = Smem<TV, TQ, NQ, NA>;
  constexpr int P = S::P, NT = S::NT, NP = S::NP, KS = S::KS, PROW = S::PROW;
  constexpr int PP = P / 2;                     // pairs of pairs
  constexpr bool F32 = L::split_vt;
  constexpr int TV_ = F32 ? 3 : 1;              // vt's terms
  constexpr int TG = F32 ? 3 : 2;               // w's and gP's terms in gvt
  using PU = Pairs<TV_, 3>;                     // U: vt x w
  using PG = Pairs<TG, TG>;                     // gvt: w x gP
  using PW = Pairs<TV_, 3>;                     // gw: vt x gP
  constexpr int VTS = L::vts;
  constexpr int VPL = F32 ? VR * VPROW : 0;     // a vt plane, elements
  constexpr int WPL = VR * PROW, GPL = DSPAN * PROW;
  constexpr int EPU = 16 / (int)sizeof(TV);     // vt elements of a 16-byte unit
  constexpr int UPR = DSPAN / EPU;              // 16-byte units of a vt row
  constexpr int QPU = 16 / (int)sizeof(TQ);     // qt or at elements of a unit
  static_assert(VR == 16 && STAGES == 2, "a stage one row tile; two ring slots");
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  bf16* vpl = reinterpret_cast<bf16*>(smem + L::vplanes);  // [3][VR][VPROW]
  bf16* wpl = reinterpret_cast<bf16*>(smem + L::wplanes);  // [3][VR][PROW]
  bf16* gpl = reinterpret_cast<bf16*>(smem + L::gplanes);  // [3][DSPAN][PROW]
  float* red = reinterpret_cast<float*>(smem + L::red);    // [2][WARPS][VR][RSTRIDE]
  float* us = reinterpret_cast<float*>(smem + L::gplanes); // [P][USTRIDE]
  float* ms = reinterpret_cast<float*>(smem + L::msum);    // [NA][DSPAN]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = lane / 4, tig = lane % 4;
  const int wd = warp * 32;  // this warp's 32 d in the span
  // where element (row, col) of this warp's 16 x 32 gvt tile waits: its
  // own columns of the vt planes (d < 16 in plane 0's, the rest in plane
  // 1's, f32), or [VR][RSTRIDE] of its own
  float* gs = reinterpret_cast<float*>(F32 ? smem + L::vplanes : smem + L::gvts);
  auto gvt_tile = [&](int row, int col) {
    return F32 ? gs + col / 16 * (VPL / 2) + row * (VPROW / 2) + wd / 2 + col % 16
               : gs + (warp * VR + row) * RSTRIDE + col;
  };
  // this lane's row and column in ldmatrix_x4's four 8x8 matrices, which
  // lie at (row, column) (0, 0), (8, 0), (0, 8), (8, 8) (lr, lc) or at
  // (0, 0), (0, 8), (8, 0), (8, 8) (tr, tc)
  const int lr = (lane & 7) + (lane >> 3 & 1) * 8, lc = (lane >> 4) * 8;
  const int tr = (lane & 7) + (lane >> 4) * 8, tc = (lane >> 3 & 1) * 8;
  const int QA = Q * A;
  // at least one chunk a unit (of zeros where V = 0), so that every unit
  // asks for the next one's operands
  const int n_chunks = V > 0 ? (V + VR - 1) / VR : 1;
  const int n_passes = (Q + NQ - 1) / NQ;
  const int n_items = B * n_spans;
  // offsets inside one sample's w fit an int (the entry point checks)
  const int sv = (int)w_sv, sq = (int)w_sq, sa = (int)w_sa;

  // the w planes' columns [P, KS * 16) stay zero (the gP planes' are
  // written with each unit's gP)
  if constexpr (KS * 8 > PP) {
    constexpr int ZP = KS * 8 - PP;  // bf16 twos a row
    for (int x = tid; x < 3 * VR * ZP; x += THREADS)
      *reinterpret_cast<unsigned*>(wpl + x / ZP * PROW + P + 2 * (x % ZP)) = 0u;
  }

  // A unit is one pass of one item (sample b, d span): its operands into
  // buffer ob, and its box rows [c*VR, c*VR + VR) of vt (the span's d)
  // and of w (the pass's pairs) into ring slot `slot`
  auto load_ops = [&](int it, int pass, int ob) {
    const int b = it / n_spans, d0 = it % n_spans * DSPAN, j0 = pass * NQ;
    char* o = smem + L::ops + ob * L::ops_size;
#pragma unroll 1
    for (int x = tid; x < (NQ + NA) * (DSPAN / QPU); x += THREADS) {
      const int r = x / (DSPAN / QPU), col = x % (DSPAN / QPU) * QPU;
      const bool is_q = r < NQ, ok = d0 + col < D && (is_q ? j0 + r < Q : r - NQ < A);
      const TQ* src = is_q ? qt + ((size_t)b * Q + j0 + r) * D : at + ((size_t)b * A + r - NQ) * D;
      cp_async<16>(reinterpret_cast<TQ*>(o) + r * DSPAN + col, ok ? src + d0 + col : qt, ok);
    }
#pragma unroll 1
    for (int x = tid; x < DSPAN / 4; x += THREADS) {
      const bool ok = d0 + 4 * x < D;
      cp_async<16>(reinterpret_cast<float*>(o + L::ops_g) + 4 * x,
                   ok ? g + (size_t)b * D + d0 + 4 * x : g, ok);
    }
  };
  auto load = [&](int it, int pass, int c, int slot) {
    const int b = it / n_spans, d0 = it % n_spans * DSPAN, j0 = pass * NQ, i0 = c * VR;
    const TV* vb = vt + (size_t)b * V * D;
    const float* wb = w + b * w_sb;
    char* st = smem + slot * L::stage;
    TV* vs = reinterpret_cast<TV*>(st);
#pragma unroll 1
    for (int x = tid; x < VR * UPR; x += THREADS) {
      const int r = x / UPR, col = x % UPR * EPU;
      const bool ok = i0 + r < V && d0 + col < D;
      cp_async<16>(vs + r * VTS + col, ok ? vb + (size_t)(i0 + r) * D + d0 + col : vt, ok);
    }
    float* ws = reinterpret_cast<float*>(st + L::stage_w);
#pragma unroll 1
    for (int x = tid; x < VR * P; x += THREADS) {
      const int r = x / P, p = x % P, j = j0 + p / NA, l = p % NA, i = i0 + r;
      const bool ok = i < V && j < Q && l < A;
      cp_async<4>(ws + x, ok ? wb + (i * sv + j * sq + l * sa) : wb, ok);
    }
  };

  if (blockIdx.x < n_items) {
    load_ops(blockIdx.x, 0, 0);
    load(blockIdx.x, 0, 0, 0);
  }
  cp_async_commit();
  int k = 0, ob = 0;  // chunks streamed so far (ring slot k % 2), operand buffer
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int b = it / n_spans, span = it % n_spans, d0 = span * DSPAN;
    float* pb = part + ((size_t)b * n_spans + span) * V * QA;  // [V][Q*A]
    for (int pass = 0; pass < n_passes; ++pass, ob ^= 1) {
      const int j0 = pass * NQ;
      // the unit after this one, whose operands and first chunk are asked
      // for at this one's last chunk
      const int nit = pass + 1 < n_passes ? it : it + gridDim.x;
      const int npass = pass + 1 < n_passes ? pass + 1 : 0;
      const TQ* oq = reinterpret_cast<const TQ*>(smem + L::ops + ob * L::ops_size);
      const TQ* oa = oq + NQ * DSPAN;
      const float* og = reinterpret_cast<const float*>(smem + L::ops + ob * L::ops_size + L::ops_g);

      // the warps' gw parts of chunk c, added in warp order, into the
      // span's part of gw (gw itself with one span)
      auto flush = [&](int c) {
        const float* rs = red + (c & 1) * WARPS * VR * RSTRIDE;
#pragma unroll 1
        for (int x = tid; x < VR * P; x += THREADS) {
          const int r = x / P, p = x % P, i = c * VR + r, j = j0 + p / NA, l = p % NA;
          if (i < V && j < Q && l < A) {
            float s = rs[r * RSTRIDE + p];
#pragma unroll
            for (int kw = 1; kw < WARPS; ++kw) s += rs[(kw * VR + r) * RSTRIDE + p];
            pb[(size_t)i * QA + j * A + l] = s;
          }
        }
      };

      cp_async_wait<0>();
      __syncthreads();  // this unit's operands and first chunk have landed
      // gP = qt at g of this unit into its planes [d][p], zero in the
      // columns [P, KS * 16) (U went over them): a row d a thread, 8
      // pairs a 16-byte store (distinct banks)
      {
        const float gd = og[tid];
        auto gp = [&](int p) {
          return p < P ? to_f32(oq[p / NA * DSPAN + tid]) * to_f32(oa[p % NA * DSPAN + tid]) * gd
                       : 0.f;
        };
#pragma unroll
        for (int p8 = 0; p8 < KS * 2; ++p8) {
          unsigned t[3][4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            unsigned x2[3];
            split2(gp(p8 * 8 + 2 * h), gp(p8 * 8 + 2 * h + 1), x2);
#pragma unroll
            for (int pl = 0; pl < 3; ++pl) t[pl][h] = x2[pl];
          }
#pragma unroll
          for (int pl = 0; pl < 3; ++pl)
            *reinterpret_cast<uint4*>(gpl + pl * GPL + tid * PROW + p8 * 8) =
                make_uint4(t[pl][0], t[pl][1], t[pl][2], t[pl][3]);
        }
      }

      float u[2][NT][4];  // U's tiles: the warp's two m16 tiles of d
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) u[mt][nt][e] = 0.f;

      for (int c = 0; c < n_chunks; ++c, ++k) {
        if (c > 0) {
          cp_async_wait<0>();
          __syncthreads();  // chunk c has landed; chunk c-1 is done everywhere
        }
        const char* st = smem + k % STAGES * L::stage;
        // w's terms into their planes
        {
          const float* ws = reinterpret_cast<const float*>(st + L::stage_w);
#pragma unroll 1
          for (int x = tid; x < VR * PP; x += THREADS) {
            const int r = x / PP, pr = x % PP;
            const float2 v = *reinterpret_cast<const float2*>(ws + r * P + 2 * pr);
            unsigned x2[3];
            split2(v.x, v.y, x2);
#pragma unroll
            for (int t = 0; t < 3; ++t)
              *reinterpret_cast<unsigned*>(wpl + t * WPL + r * PROW + 2 * pr) = x2[t];
          }
        }
        __syncthreads();  // w's planes are in place
        // a float32 vt's terms into the planes, each warp its own 32 d (the
        // only ones it reads): 4 rows x 128 bytes a step
        if constexpr (F32) {
          const float* vs = reinterpret_cast<const float*>(st) + wd + lane % 8 * 4;
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int r = lane / 8 + 4 * h;
            const float4 v = *reinterpret_cast<const float4*>(vs + r * DSPAN);
            unsigned lo[3], hi[3];
            split2(v.x, v.y, lo);
            split2(v.z, v.w, hi);
#pragma unroll
            for (int t = 0; t < 3; ++t)
              *reinterpret_cast<uint2*>(vpl + t * VPL + r * VPROW + wd + lane % 8 * 4) =
                  make_uint2(lo[t], hi[t]);
          }
          __syncwarp();
        }
        // the shared addresses of this lane's ldmatrix rows: w's planes and
        // vt's (its planes, or the ring's slot), lanes at (lr, lc) or (tr,
        // tc), and gP's at the warp's d; plane t, tile and step offsets
        // are constants
        const unsigned vp = smem_addr(F32 ? vpl : reinterpret_cast<const bf16*>(st));
        const unsigned v_l = vp + 2 * (lr * VPROW + wd + lc);
        const unsigned v_t = vp + 2 * (tr * VPROW + wd + tc);
        const unsigned w_l = smem_addr(wpl) + 2 * (lr * PROW + lc);
        const unsigned g_l = smem_addr(gpl) + 2 * ((wd + lr) * PROW + lc);
        const unsigned g_t = smem_addr(gpl) + 2 * ((wd + tr) * PROW + tc);

        // U[d, p] += sum_i vt[i, d] w[i, p]: A vt (ldmatrix.trans of [i][d]),
        // B w (ldmatrix.trans of [i][p]), two n8 tiles a load
        {
          unsigned a[2][TV_][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int t = 0; t < TV_; ++t)
              ldmatrix_x4_trans(a[mt][t], v_t + 2 * (t * VPL + mt * 16));
#pragma unroll
          for (int np = 0; np < NP; ++np) {
            unsigned bw[1][3][4];
#pragma unroll
            for (int t = 0; t < 3; ++t)
              ldmatrix_x4_trans(bw[0][t], w_l + 2 * (t * WPL + np * 16));
            if (2 * np + 1 < NT)
              mma_tiles<PU>(u, a, bw, 2 * np);
            else
              mma_tiles<PU, 1>(u, a, bw, 2 * np);
          }
        }

        // the next chunk: this unit's, or the next unit's first; the next
        // unit's operands a chunk earlier where there is one.  Asked for
        // here and chunk c-1's gw flushed below, between the products, so
        // that they go out while the MMAs before them run.
        if (nit < n_items && c == (n_chunks > 1 ? n_chunks - 2 : 0))
          load_ops(nit, npass, ob ^ 1);
        if (c + 1 < n_chunks)
          load(it, pass, c + 1, (k + 1) % STAGES);
        else if (nit < n_items)
          load(nit, npass, 0, (k + 1) % STAGES);
        cp_async_commit();

        // each product's fragments are loaded after the last one's MMAs:
        // a fence against ptxas holding two products' fragments at once
        __syncwarp();

        // gw[i, p] = sum_d vt[i, d] gP[p, d] over the warp's 32 d: A vt
        // ([i][d]), B gP (ldmatrix.trans of [d][p]); into the warp's part
        {
          unsigned a[2][1][TV_][4];
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int t = 0; t < TV_; ++t)
              ldmatrix_x4(a[ks][0][t], v_l + 2 * (t * VPL + ks * 16));
          // all the n8 tiles at once (bf16 vt), or two at a time (the
          // float32 one's three terms leave no registers for more)
          float* rd = red + ((c & 1) * WARPS + warp) * VR * RSTRIDE;
          auto put = [&](const float (&o)[4], int nt) {
            const int p = nt * 8 + 2 * tig;
            store2(rd + group * RSTRIDE + p, o[0], o[1]);
            store2(rd + (group + 8) * RSTRIDE + p, o[2], o[3]);
          };
          if constexpr (F32) {
#pragma unroll
            for (int np = 0; np < NP; ++np) {  // n8 tiles 2 np and 2 np + 1
              float o[1][2][4] = {};
#pragma unroll
              for (int ks = 0; ks < 2; ++ks) {
                unsigned bg[1][3][4];
#pragma unroll
                for (int t = 0; t < 3; ++t)
                  ldmatrix_x4_trans(bg[0][t], g_l + 2 * (t * GPL + ks * 16 * PROW + np * 16));
                if (2 * np + 1 < NT)
                  mma_tiles<PW>(o, a[ks], bg, 0);
                else
                  mma_tiles<PW, 1>(o, a[ks], bg, 0);
              }
#pragma unroll
              for (int h = 0; h < 2 && 2 * np + h < NT; ++h) put(o[0][h], 2 * np + h);
            }
          } else {
            float o[1][NT][4] = {};
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              unsigned bg[NP][3][4];
#pragma unroll
              for (int np = 0; np < NP; ++np)
#pragma unroll
                for (int t = 0; t < 3; ++t)
                  ldmatrix_x4_trans(bg[np][t], g_l + 2 * (t * GPL + ks * 16 * PROW + np * 16));
              mma_tiles<PW, NT>(o, a[ks], bg, 0);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) put(o[0][nt], nt);
          }
        }
        if (c > 0) flush(c - 1);
        __syncwarp();

        // gvt[i, d] = sum_p w[i, p] gP[p, d]: A w ([i][p]), B gP ([d][p]),
        // two n8 tiles of d a load; the warp's 16 x 32 tile through its
        // shared buffer, then 4 rows x 128 bytes a store (added to the
        // earlier passes' sums, loaded first)
        {
          const int dd = d0 + wd + lane % 8 * 4;  // this lane's 4 d of a row
          float4 e[4];
          if (pass > 0) {
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const int i = c * VR + lane / 8 + 4 * h;
              e[h] = i < V && dd < D
                         ? *reinterpret_cast<const float4*>(acc + ((size_t)b * V + i) * D + dd)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
          // the warp's four n8 tiles of d at once (bf16 vt), or two at a
          // time
          constexpr int NH = F32 ? 2 : 1;  // parts of the warp's d
#pragma unroll
          for (int hh = 0; hh < NH; ++hh) {
            float o[1][4 / NH][4] = {};
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              unsigned aw[1][TG][4], bg[2 / NH][TG][4];
#pragma unroll
              for (int t = 0; t < TG; ++t) {
                ldmatrix_x4(aw[0][t], w_l + 2 * (t * WPL + ks * 16));
#pragma unroll
                for (int np = 0; np < 2 / NH; ++np)
                  ldmatrix_x4(bg[np][t],
                              g_t + 2 * (t * GPL + (hh + np) * 16 * PROW + ks * 16));
              }
              mma_tiles<PG, 4 / NH>(o, aw, bg, 0);
            }
#pragma unroll
            for (int n = 0; n < 4 / NH; ++n) {
              const int col = (4 / NH * hh + n) * 8 + 2 * tig;
              store2(gvt_tile(group, col), o[0][n][0], o[0][n][1]);
              store2(gvt_tile(group + 8, col), o[0][n][2], o[0][n][3]);
            }
          }
          __syncwarp();
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int i = c * VR + lane / 8 + 4 * h;
            float4 x = *reinterpret_cast<const float4*>(gvt_tile(lane / 8 + 4 * h, lane % 8 * 4));
            if (pass > 0) x = make_float4(e[h].x + x.x, e[h].y + x.y, e[h].z + x.z, e[h].w + x.w);
            if (i < V && dd < D) {
              const size_t o_ = ((size_t)b * V + i) * D + dd;
              if (pass + 1 < n_passes)
                store4(acc + o_, x);
              else
                store4(gvt + o_, x);
            }
          }
          __syncwarp();  // the buffer is free for the next stage
        }
      }
      __syncthreads();  // the last chunk's gw parts are in place
      flush(n_chunks - 1);

      // epilogue: U [P][USTRIDE] over the gP planes, then a d a thread
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = nt * 8 + 2 * tig + e % 2;
            if (p < P) us[p * USTRIDE + wd + mt * 16 + group + 8 * (e / 2)] = u[mt][nt][e];
          }
      __syncthreads();
      const int d = d0 + tid;  // a d a thread
      if (d < D) {
        float m[NA];  // gat's sums over j, carried in ms
#pragma unroll
        for (int l = 0; l < NA; ++l) m[l] = pass > 0 ? ms[l * DSPAN + tid] : 0.f;
        const float ge = og[tid];
        float av[NA];
#pragma unroll
        for (int l = 0; l < NA; ++l) av[l] = to_f32(oa[l * DSPAN + tid]);
#pragma unroll
        for (int jj = 0; jj < NQ; ++jj) {
          const int j = j0 + jj;
          if (j >= Q) continue;
          const float qv = to_f32(oq[jj * DSPAN + tid]);
          float s0 = 0.f;
#pragma unroll
          for (int l = 0; l < NA; ++l) {
            if (l >= A) continue;
            const float x = us[(jj * NA + l) * USTRIDE + tid];
            s0 = fmaf(av[l], x, s0);
            m[l] = fmaf(qv, x, m[l]);
          }
          gqt[((size_t)b * Q + j) * D + d] = from_f32<TQ>(s0 * ge);
        }
#pragma unroll
        for (int l = 0; l < NA; ++l) {
          if (pass + 1 < n_passes)
            ms[l * DSPAN + tid] = m[l];
          else if (l < A)
            gat[((size_t)b * A + l) * D + d] = from_f32<TQ>(m[l] * ge);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// gw[b, e] = sum over the spans s, in order, of part[b, s, e]
__global__ void __launch_bounds__(SUM_THREADS)
tri_pool_backward_gw_sum_kernel(const float* __restrict__ part, float* __restrict__ gw,
                                int n_spans, long long per, long long total) {
  for (long long e = blockIdx.x * (long long)SUM_THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * SUM_THREADS) {
    const float* p = part + e / per * n_spans * per + e % per;
    float s = p[0];
    for (int k = 1; k < n_spans; ++k) s += p[k * per];
    gw[e] = s;
  }
}

// one block an SM (its shared memory), each walking the units of items
// blockIdx.x, blockIdx.x + gridDim.x, ...
template <typename TV, typename TQ, int NQ, int NA>
cudaError_t launch(int blocks, cudaStream_t stream, int device, const float* g,
                   const TV* vt, const TQ* qt, const TQ* at, const float* w,
                   long long w_sb, long long w_sv, long long w_sq, long long w_sa, TV* gvt,
                   TQ* gqt, TQ* gat, float* part, float* acc, int B, int V, int Q, int A,
                   int D, int n_spans) {
  constexpr int smem = Smem<TV, TQ, NQ, NA>::bytes;
  static_assert(smem <= 227 * 1024, "fits a block's shared memory");
  constexpr int MAX_DEVICES = 64;
  static bool raised[MAX_DEVICES] = {};
  auto kernel = tri_pool_backward_mma_kernel<TV, TQ, NQ, NA>;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  kernel<<<blocks, THREADS, smem, stream>>>(g, vt, qt, at, w, w_sb, w_sv, w_sq, w_sa, gvt,
                                            gqt, gat, part, acc, B, V, Q, A, D, n_spans);
  return cudaGetLastError();
}

// question tokens a pass of the instance that takes A
int pass_tokens(int A) { return A <= 3 ? 12 : A <= 6 ? 6 : 4; }

// scratch floats backward() needs: gvt's float32 sums across passes where
// gvt is bf16 (a float32 gvt holds its own), then each span's part of gw
// where D spans more than one
void scratch_floats(int B, int V, int Q, int A, int D, bool vt_bf16,
                    long long& acc, long long& part) {
  const int n_spans = (D + DSPAN - 1) / DSPAN;
  const bool passes = Q > pass_tokens(A);
  acc = vt_bf16 && passes ? (long long)B * V * D : 0;
  part = n_spans > 1 ? (long long)B * n_spans * V * Q * A : 0;
}

template <typename TV, typename TQ>
int backward(const float* g, const TV* vt, const TQ* qt, const TQ* at, const float* w,
             long long w_sb, long long w_sv, long long w_sq, long long w_sa, TV* gvt,
             TQ* gqt, TQ* gat, float* gw, float* scratch, long long scratch_size,
             int B, int V, int Q, int A, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || V < 0 || D < 0 || Q < 1 || A < 1 || Q > MAX_Q || A > MAX_A ||
      D % (16 / (int)sizeof(TV)) != 0 ||
      ((uintptr_t)g | (uintptr_t)vt | (uintptr_t)qt | (uintptr_t)at | (uintptr_t)gvt |
       (uintptr_t)gqt | (uintptr_t)gat) % 16 != 0 ||
      w_sv < 0 || w_sq < 0 || w_sa < 0 ||
      (V - 1LL) * w_sv + (Q - 1LL) * w_sq + (A - 1LL) * w_sa > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;  // D == 0: gw is zero, which the caller sets
  const int n_spans = (D + DSPAN - 1) / DSPAN;
  long long acc_floats, part_floats;
  scratch_floats(B, V, Q, A, D, sizeof(TV) == 2, acc_floats, part_floats);
  if (scratch_size < acc_floats + part_floats || (acc_floats + part_floats > 0 && !scratch))
    return (int)cudaErrorInvalidValue;
  float* acc = sizeof(TV) == 4 ? reinterpret_cast<float*>(gvt) : scratch;
  float* part = n_spans > 1 ? scratch + acc_floats : gw;
  const long long per = (long long)V * Q * A;
  constexpr int MAX_DEVICES = 64;
  static int sms[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  const long long items = (long long)B * n_spans;
  if (items > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(items < sms[device] ? items : sms[device]);
  cudaStream_t s = (cudaStream_t)stream;
  if (A <= 3)
    err = launch<TV, TQ, 12, 3>(blocks, s, device, g, vt, qt, at, w, w_sb, w_sv, w_sq, w_sa,
                                gvt, gqt, gat, part, acc, B, V, Q, A, D, n_spans);
  else if (A <= 6)
    err = launch<TV, TQ, 6, 6>(blocks, s, device, g, vt, qt, at, w, w_sb, w_sv, w_sq, w_sa,
                               gvt, gqt, gat, part, acc, B, V, Q, A, D, n_spans);
  else
    err = launch<TV, TQ, 4, 8>(blocks, s, device, g, vt, qt, at, w, w_sb, w_sv, w_sq, w_sa,
                               gvt, gqt, gat, part, acc, B, V, Q, A, D, n_spans);
  if (err != cudaSuccess || part_floats == 0) return (int)err;
  const long long total = B * per;
  const long long sum_blocks = (total + SUM_THREADS - 1) / SUM_THREADS;
  tri_pool_backward_gw_sum_kernel<<<(unsigned)(sum_blocks < 4096 ? sum_blocks : 4096),
                                    SUM_THREADS, 0, s>>>(part, gw, n_spans, per, total);
  return (int)cudaGetLastError();
}

}  // namespace

// the floats of scratch the entry points below need for these shapes,
// into *floats; vt_bf16 nonzero for tri_pool_backward_bf16
extern "C" int tri_pool_backward_scratch(int B, int V, int Q, int A, int D,
                                         int vt_bf16, long long* floats) {
  long long acc, part;
  scratch_floats(B, V, Q, A, D, vt_bf16 != 0, acc, part);
  *floats = acc + part;
  return 0;
}

extern "C" int tri_pool_backward(const float* g, const float* vt, const float* qt,
                                 const float* at, const float* w, long long w_sb,
                                 long long w_sv, long long w_sq, long long w_sa,
                                 float* gvt, float* gqt, float* gat, float* gw,
                                 float* scratch, long long scratch_size, int B, int V,
                                 int Q, int A, int D, int device, void* stream) {
  return backward(g, vt, qt, at, w, w_sb, w_sv, w_sq, w_sa, gvt, gqt, gat, gw, scratch,
                  scratch_size, B, V, Q, A, D, device, stream);
}

// vt and gvt bf16; qt, at, gqt and gat bf16 when qa_bf16 is nonzero, else f32
extern "C" int tri_pool_backward_bf16(const float* g, const __nv_bfloat16* vt,
                                      const void* qt, const void* at, const float* w,
                                      long long w_sb, long long w_sv, long long w_sq,
                                      long long w_sa, __nv_bfloat16* gvt, void* gqt,
                                      void* gat, float* gw, float* scratch,
                                      long long scratch_size, int B, int V, int Q,
                                      int A, int D, int qa_bf16, int device,
                                      void* stream) {
  if (qa_bf16)
    return backward(g, vt, (const __nv_bfloat16*)qt, (const __nv_bfloat16*)at, w, w_sb,
                    w_sv, w_sq, w_sa, gvt, (__nv_bfloat16*)gqt, (__nv_bfloat16*)gat, gw,
                    scratch, scratch_size, B, V, Q, A, D, device, stream);
  return backward(g, vt, (const float*)qt, (const float*)at, w, w_sb, w_sv, w_sq, w_sa,
                  gvt, (float*)gqt, (float*)gat, gw, scratch, scratch_size, B, V, Q, A,
                  D, device, stream);
}
