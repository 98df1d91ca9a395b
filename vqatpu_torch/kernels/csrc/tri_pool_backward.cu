// Backward of the weighted trilinear pool: its four cotangents in one pass
// over vt.
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
// What bounds it on the H100: both, about equally.  At B=256, V=50, Q=12,
// A=3, D=1024 (float32) it must read vt (52.4 MB), qt (12.6), at (3.1), w
// (1.8) and g (1.0) and write the four cotangents (70.0 MB): 141 MB, 42 us
// at 3.35 TB/s.  Its three V x Q*A x D products a sample, 2.83 GFLOP, take
// 42 us on the f32 CUDA cores (67 TFLOP/s).  At Q*A=72 the products double
// and bind.  Before this kernel the port ran the einsums as four torch.bmm
// calls that wrote and reread p = qt*at and wv [B, Q*A, D] (37.7 MB each)
// and, at bf16, a float32 copy of vt.
//
// Design:
// - Block (b, y) takes sample b's d span [256 y, 256 y + 256) and streams
//   its box rows once: vt and w, VR rows a stage, through a STAGES-deep
//   ring of cp.async copies in shared memory (the forward's ring,
//   tri_pool.cu), zero past V, D, Q and A.  p, wv and U never reach device
//   memory, and a bf16 vt is widened in registers, not copied.
// - 4 warps; a warp's lanes are 4 along the (j, l) pairs and 8 along d.  A
//   thread holds PPL = P/4 pairs x 8 d of gP (computed once a pass) and of
//   the U accumulators: 9 x 8 each at the model's P = 36.  Per box row it
//   reads its 8 vt and its PPL w from the ring (4 lanes share each read)
//   and does 3 x PPL x 8 FMAs: U += w vt, its part of gvt (summed over its
//   pairs) and its part of gw (summed over its d).
// - Those parts are summed across lanes by transposed butterflies
//   (`fold`): gvt's 8 d over the 4 pair lanes (6 shuffles, 2 d a lane,
//   stored at once, a warp's 64 d coalesced), gw's pairs over the 8 d
//   lanes (7 shuffles for 8 pairs, 3 for a ninth).  The 4 warps' gw parts
//   meet in shared memory, double-buffered, and are added in warp order
//   while the next stage is multiplied.
// - gw sums over all of D: with D > 256 each span writes its part to a
//   scratch buffer of the caller's, [B, spans, V, Q*A], and a second small
//   kernel adds the spans in order.  No atomics: the same inputs give the
//   same bits.
// - Epilogue of a pass: U through shared memory (the ring's space), then
//   with 2 d a thread gqt = g sum_l at U and gat's sums over j, the plain
//   version's order of sums (trilinear_pool_grads).
// - Instances by A: <12, 3> (A <= 3: the free-form model's Q <= 12 in one
//   pass), <6, 6> (A <= 6: Visual7W's Q = 12 in 2 passes) and <4, 8>.  A
//   pass covers NQ question tokens; further passes stream vt again (from
//   L2) and add gvt into what the earlier passes stored (in a float32
//   scratch where gvt is bf16); gat's sums are carried across passes.
// - bf16 operands (compute_dtype="bfloat16": vt bf16, qt and at bf16 at
//   glimpse 0 and f32 at glimpse 1): the same f32 FMAs on the CUDA cores,
//   sums in f32, each bf16 cotangent rounded once as it is stored.  The
//   tensor cores (the forward's split_bf16x3 route) are left for later.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, cold L2 (chip_smoke.py):
// 159.1 us at B=256 float32 (3.8x the bound; the four torch.bmm 470.8 us),
// 148.7 / 152.9 us bf16 at glimpse 0 / 1 (532.4 / 514.9), 353.9 us at
// Q*A=72 (726.9).  The row loop is 328 instructions, 216 of them FFMA, and
// issues about half the time with 2 warps a scheduler (241-255
// registers); the SM clock holds 1980 MHz.  4 box rows a stage were 2-5%
// slower, 3 stages up to 5% at Q*A=72, one block an SM or d outer in the
// row loop within 1% (python3 -m vqatpu_torch.kernels.probe).
//
// Needs D % (16 / sizeof(TV)) == 0 (4 f32, 8 bf16), Q <= 32, A <= 8 and
// 16-byte aligned g, vt, qt, at and cotangents; the entry points refuse
// anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int LJ = 4;                   // lanes of a warp along the pairs
constexpr int LD = 32 / LJ;             // lanes along d
constexpr int ND = 8;                   // d a thread
constexpr int DSPAN = WARPS * LD * ND;  // d a block: 256
constexpr int VR = 8;                   // box rows a ring stage
constexpr int STAGES = 4;               // ring depth
constexpr int USTRIDE = DSPAN + 4;      // a row of U in shared memory
constexpr int MAX_Q = 32;
constexpr int MAX_A = 8;
constexpr int SUM_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

template <int NQ, int NA>
struct Shape {
  static constexpr int P = NQ * NA;              // (j, l) pairs of a pass
  static constexpr int PPL = P / LJ;             // pairs of a thread
  static constexpr int WG = (PPL + 3) / 4 * 4;   // a lane's w floats, padded
  static constexpr int WROW = LJ * WG;           // a w row in the ring
  static_assert(P % LJ == 0 && PPL >= 8 && PPL < 16,
                "8 pairs a thread fold transposed, the rest plainly");
};

// floats of the ring a vt row of the d span takes
template <typename TV>
__host__ __device__ constexpr int vrow() { return DSPAN * (int)sizeof(TV) / 4; }

// shared memory in floats: the ring and gw's two buffers of warp parts
// while the box rows stream; U over them in a pass's epilogue
template <typename TV, int NQ, int NA>
struct Smem {
  using S = Shape<NQ, NA>;
  static constexpr int stage = VR * (vrow<TV>() + S::WROW);
  static constexpr int red = STAGES * stage;  // [2][WARPS][VR][P]
  static constexpr int loop = red + 2 * WARPS * VR * S::P;
  static constexpr int u = S::P * USTRIDE;    // [P][USTRIDE], at 0
  static constexpr int bytes = 4 * (loop > u ? loop : u);
};

// 8 operands from 16-byte aligned p, as f32; `n` of them are in range
// (a multiple of 4), the rest read as zero
__device__ __forceinline__ void load8(const float* p, int n, float (&x)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 v = n >= 4 * (h + 1) ? *reinterpret_cast<const float4*>(p + 4 * h)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    x[4 * h] = v.x, x[4 * h + 1] = v.y, x[4 * h + 2] = v.z, x[4 * h + 3] = v.w;
  }
}

__device__ __forceinline__ void widen(unsigned u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ void load8(const bf16* p, int n, float (&x)[8]) {
  const uint4 u = n >= 8 ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
  widen(u.x, x[0], x[1]);
  widen(u.y, x[2], x[3]);
  widen(u.z, x[4], x[5]);
  widen(u.w, x[6], x[7]);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  float2 r;
  widen(*reinterpret_cast<const unsigned*>(p), r.x, r.y);
  return r;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One step of a transposed butterfly: x[0, N) of each lane, summed with
// the lane `o` away, of which this lane keeps half (the upper half where
// its bit `o` is set) in x[0, N/2).  After steps o, o/2, ..., each lane
// holds the full sum of one of the N values, the one whose index is that
// lane's bits o, o/2, ... read as a binary number.
template <int N, int M>
__device__ __forceinline__ void fold(float (&x)[M], int o, int lane) {
  static_assert(N % 2 == 0 && N <= M, "fold halves N of the M values");
  const bool upper = (lane & o) != 0;
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const float send = upper ? x[k] : x[k + N / 2];
    const float keep = upper ? x[k + N / 2] : x[k];
    x[k] = keep + __shfl_xor_sync(FULL, send, o);
  }
}

template <typename TV, typename TQ, int NQ, int NA>
__global__ void __launch_bounds__(THREADS, 2)
tri_pool_backward_kernel(const float* __restrict__ g, const TV* __restrict__ vt,
                         const TQ* __restrict__ qt, const TQ* __restrict__ at,
                         const float* __restrict__ w, long long w_sb, long long w_sv,
                         long long w_sq, long long w_sa, TV* __restrict__ gvt,
                         TQ* __restrict__ gqt, TQ* __restrict__ gat,
                         float* __restrict__ part, float* __restrict__ acc,
                         int V, int Q, int A, int D) {
  using S = Shape<NQ, NA>;
  using L = Smem<TV, NQ, NA>;
  constexpr int P = S::P, PPL = S::PPL, WG = S::WG, WROW = S::WROW;
  constexpr int VROW = vrow<TV>();
  constexpr int EPU = 16 / (int)sizeof(TV);  // vt elements of a 16-byte unit
  constexpr int UPR = DSPAN / EPU;           // 16-byte units of a vt row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* red = smem + L::red;
  float* us = smem;

  const int b = blockIdx.x, span = blockIdx.y, n_spans = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pg = lane % LJ, dg = lane / LJ;
  const int d0 = span * DSPAN;
  const int dd = warp * (LD * ND) + dg * ND;  // this thread's 8 d in the span
  const int dn = D - (d0 + dd);               // of which in range: min(8, dn)
  // the 2 d of gvt's sums a lane keeps after folding over the pair lanes
  const int kb = (pg >> 1) * 4 + (pg & 1) * 2;
  const int QA = Q * A;
  const int n_chunks = (V + VR - 1) / VR;
  const int n_passes = (Q + NQ - 1) / NQ;
  const TV* vb = vt + (size_t)b * V * D;
  const float* wb = w + b * w_sb;
  // offsets inside one sample's w fit an int (the entry point checks)
  const int sv = (int)w_sv, sq = (int)w_sq, sa = (int)w_sa;
  float* pb = part + ((size_t)b * n_spans + span) * V * QA;  // [V][Q*A]

  float gd[ND];
  load8(g + (size_t)b * D + d0 + dd, dn, gd);
  float m[NA][2];  // gat's sums over j, the epilogue's 2 d, across passes
#pragma unroll
  for (int l = 0; l < NA; ++l) m[l][0] = m[l][1] = 0.f;

  for (int pass = 0; pass < n_passes; ++pass) {
    const int j0 = pass * NQ;

    // gP of this thread's pairs p = pg * PPL + q and d, zero past Q, A, D
    float gp[PPL][ND];
#pragma unroll
    for (int q = 0; q < PPL; ++q) {
      const int p = pg * PPL + q, j = j0 + p / NA, l = p % NA;
      const bool ok = j < Q && l < A;
      float qv[ND], av[ND];
      load8(ok ? qt + ((size_t)b * Q + j) * D + d0 + dd : qt, ok ? dn : 0, qv);
      load8(ok ? at + ((size_t)b * A + l) * D + d0 + dd : at, ok ? dn : 0, av);
#pragma unroll
      for (int k = 0; k < ND; ++k) gp[q][k] = qv[k] * av[k] * gd[k];
    }

    // box rows [c*VR, c*VR + VR) of vt (this block's d) and of w (this
    // pass's pairs, a lane group's PPL padded to WG) into ring slot c % STAGES
    auto load = [&](int c) {
      float* st = smem + (c % STAGES) * L::stage;
      const int i0 = c * VR;
      for (int x = tid; x < VR * UPR; x += THREADS) {
        const int r = x / UPR, col = x % UPR * EPU;
        const bool ok = i0 + r < V && d0 + col < D;
        cp_async<16>(reinterpret_cast<TV*>(st) + r * DSPAN + col,
                     ok ? vb + (size_t)(i0 + r) * D + d0 + col : vt, ok);
      }
      float* ws = st + VR * VROW;
      for (int x = tid; x < VR * WROW; x += THREADS) {
        const int r = x / WROW, q = x % WG, p = x % WROW / WG * PPL + q;
        const int j = j0 + p / NA, l = p % NA, i = i0 + r;
        const bool ok = q < PPL && i < V && j < Q && l < A;
        cp_async<4>(ws + x, ok ? wb + (i * sv + j * sq + l * sa) : wb, ok);
      }
    };
    // the 4 warps' gw parts of chunk c, added in warp order, into the
    // span's part of gw (gw itself with one span)
    auto flush = [&](int c) {
      const float* rs = red + (c & 1) * WARPS * VR * P;
      for (int x = tid; x < VR * P; x += THREADS) {
        const int r = x / P, p = x % P, i = c * VR + r, j = j0 + p / NA, l = p % NA;
        if (i < V && j < Q && l < A) {
          float s = rs[x];
#pragma unroll
          for (int k = 1; k < WARPS; ++k) s += rs[k * VR * P + x];
          pb[(size_t)i * QA + j * A + l] = s;
        }
      }
    };

    float u[PPL][ND];
#pragma unroll
    for (int q = 0; q < PPL; ++q)
#pragma unroll
      for (int k = 0; k < ND; ++k) u[q][k] = 0.f;

#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) {
      if (c < n_chunks) load(c);
      cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // chunk c has landed; chunk c-1 is done everywhere
      if (c > 0) flush(c - 1);
      if (c + STAGES - 1 < n_chunks) load(c + STAGES - 1);
      cp_async_commit();
      const float* st = smem + (c % STAGES) * L::stage;
      const float* ws = st + VR * VROW + pg * WG;
      float* rd = red + (c & 1) * WARPS * VR * P + warp * VR * P + pg * PPL;
      // not unrolled: 144 accumulators and gP of at most 255 registers
#pragma unroll 1
      for (int r = 0; r < VR; ++r) {
        float v[ND], wr[WG];
        load8(reinterpret_cast<const TV*>(st + r * VROW) + dd, ND, v);
#pragma unroll
        for (int k = 0; k < WG / 4; ++k) {
          const float4 x = *reinterpret_cast<const float4*>(ws + r * WROW + 4 * k);
          wr[4 * k] = x.x, wr[4 * k + 1] = x.y, wr[4 * k + 2] = x.z, wr[4 * k + 3] = x.w;
        }
        float sv_[ND], sw[PPL];
#pragma unroll
        for (int k = 0; k < ND; ++k) sv_[k] = 0.f;
#pragma unroll
        for (int q = 0; q < PPL; ++q) {
          sw[q] = 0.f;
#pragma unroll
          for (int k = 0; k < ND; ++k) {
            u[q][k] = fmaf(wr[q], v[k], u[q][k]);
            sv_[k] = fmaf(wr[q], gp[q][k], sv_[k]);
            sw[q] = fmaf(v[k], gp[q][k], sw[q]);
          }
        }
        // gvt: over the pair lanes (lane bits 1, 0); 2 d a lane remain
        fold<8>(sv_, 2, lane);
        fold<4>(sv_, 1, lane);
        const int i = c * VR + r;
        if (i < V && kb < dn) {
          const size_t o = ((size_t)b * V + i) * D + d0 + dd + kb;
          float a0 = sv_[0], a1 = sv_[1];
          if (pass > 0) {
            const float2 e = load2(acc + o);
            a0 = e.x + a0, a1 = e.y + a1;
          }
          if (pass + 1 < n_passes)
            store2(acc + o, a0, a1);
          else
            store2(gvt + o, a0, a1);
        }
        // gw: over the d lanes (lane bits 4, 3, 2); lane dg keeps pair dg
        // of its 8, and every lane the rest
        fold<8>(sw, 16, lane);
        fold<4>(sw, 8, lane);
        fold<2>(sw, 4, lane);
#pragma unroll
        for (int q = 8; q < PPL; ++q) {
          sw[q] += __shfl_xor_sync(FULL, sw[q], 4);
          sw[q] += __shfl_xor_sync(FULL, sw[q], 8);
          sw[q] += __shfl_xor_sync(FULL, sw[q], 16);
        }
        rd[r * P + dg] = sw[0];
#pragma unroll
        for (int q = 8; q < PPL; ++q)
          if (dg == 0) rd[r * P + q] = sw[q];
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    if (n_chunks > 0) flush(n_chunks - 1);
    __syncthreads();  // U goes over the ring and gw's buffers

    // epilogue: U [P][USTRIDE] through shared memory, then 2 d a thread
#pragma unroll
    for (int q = 0; q < PPL; ++q)
#pragma unroll
      for (int k = 0; k < ND; k += 4)
        *reinterpret_cast<float4*>(us + (pg * PPL + q) * USTRIDE + dd + k) =
            make_float4(u[q][k], u[q][k + 1], u[q][k + 2], u[q][k + 3]);
    __syncthreads();
    const int de = 2 * tid, d = d0 + de;
    if (de < DSPAN && d < D) {
      const float2 ge = load2(g + (size_t)b * D + d);
      float2 av[NA];
#pragma unroll
      for (int l = 0; l < NA; ++l)
        av[l] = l < A ? load2(at + ((size_t)b * A + l) * D + d) : make_float2(0.f, 0.f);
#pragma unroll
      for (int jj = 0; jj < NQ; ++jj) {
        const int j = j0 + jj;
        if (j >= Q) continue;
        const float2 qv = load2(qt + ((size_t)b * Q + j) * D + d);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int l = 0; l < NA; ++l) {
          if (l >= A) continue;
          const float2 x = *reinterpret_cast<const float2*>(us + (jj * NA + l) * USTRIDE + de);
          s0 = fmaf(av[l].x, x.x, s0);
          s1 = fmaf(av[l].y, x.y, s1);
          m[l][0] = fmaf(qv.x, x.x, m[l][0]);
          m[l][1] = fmaf(qv.y, x.y, m[l][1]);
        }
        store2(gqt + ((size_t)b * Q + j) * D + d, s0 * ge.x, s1 * ge.y);
      }
      if (pass + 1 == n_passes) {
#pragma unroll
        for (int l = 0; l < NA; ++l)
          if (l < A)
            store2(gat + ((size_t)b * A + l) * D + d, m[l][0] * ge.x, m[l][1] * ge.y);
      }
    }
    __syncthreads();  // the next pass's ring goes over U
  }
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

template <typename TV, typename TQ, int NQ, int NA>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* g, const TV* vt,
                   const TQ* qt, const TQ* at, const float* w, long long w_sb,
                   long long w_sv, long long w_sq, long long w_sa, TV* gvt, TQ* gqt,
                   TQ* gat, float* part, float* acc, int V, int Q, int A, int D) {
  constexpr int smem = Smem<TV, NQ, NA>::bytes;
  static_assert(smem <= 48 * 1024, "fits the default shared memory");
  tri_pool_backward_kernel<TV, TQ, NQ, NA><<<grid, THREADS, smem, stream>>>(
      g, vt, qt, at, w, w_sb, w_sv, w_sq, w_sa, gvt, gqt, gat, part, acc, V, Q, A, D);
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
  const dim3 grid(B, n_spans);
  cudaStream_t s = (cudaStream_t)stream;
  if (A <= 3)
    err = launch<TV, TQ, 12, 3>(grid, s, g, vt, qt, at, w, w_sb, w_sv, w_sq, w_sa, gvt,
                                gqt, gat, part, acc, V, Q, A, D);
  else if (A <= 6)
    err = launch<TV, TQ, 6, 6>(grid, s, g, vt, qt, at, w, w_sb, w_sv, w_sq, w_sa, gvt,
                               gqt, gat, part, acc, V, Q, A, D);
  else
    err = launch<TV, TQ, 4, 8>(grid, s, g, vt, qt, at, w, w_sb, w_sv, w_sq, w_sa, gvt,
                               gqt, gat, part, acc, V, Q, A, D);
  if (err != cudaSuccess || part_floats == 0) return (int)err;
  const long long total = B * per;
  const long long blocks = (total + SUM_THREADS - 1) / SUM_THREADS;
  tri_pool_backward_gw_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
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
