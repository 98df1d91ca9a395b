// Weighted trilinear pool (the CTI joint embedding of one glimpse).
//
// Replaces the Pallas kernel `trilinear_pool_pallas`
// (vqatpu/kernels/trilinear.py:369-429, body `_tri_pool_kernel` :344-366).
//
//   out[b,d] = sum_{i,j,l} vt[b,i,d] * w[b,i,j,l] * qt[b,j,d] * at[b,l,d]
//
// Layouts: vt [B,V,D], qt [B,Q,D], at [B,A,D] contiguous; w [B,V,Q,A] with
// any strides, because the model passes one glimpse of its [B,V,Q,A,G]
// attention (`att[..., g]`, stride G) and the kernel reads it in place
// rather than paying a copy; out [B,D].
//
// What bounds it on the H100: bytes.  At the serving bucket B=128, V=50,
// Q=12, A=3, D=1024 it must read vt (26.2 MB) and qt (6.3 MB), 35.5 MB in
// all with at, w and out: 10.6 us at 3.35 TB/s.  Its 0.47 GFLOP would take
// 7.1 us on the f32 CUDA cores.
//
// Design:
// - V is contracted first, as the plain version does (trilinear_pool_ref,
//   after JAX's trilinear_pool_xla :177-185).  Each thread owns 2 adjacent
//   d and accumulates u[j,l] = sum_i w[i,j,l] * vt[i,d] for the NQ x NA
//   (j, l) pairs of a pass: 72 accumulators at Q=12, A=3.  Per box row that
//   is one float2 load of vt, NQ*NA/4 float4 loads of the w row (the same
//   address across the warp, a broadcast) and 2*NQ*NA FMAs: 8 FMAs per
//   shared load.
// - vt and w stream through a STAGES-deep ring in dynamic shared memory, VR
//   box rows per stage, filled with cp.async: vt as 16-byte copies, w one
//   float at a time (it is a strided glimpse), zero-filled past V, Q, A and
//   D, so the inner loop has no bounds.  While one stage is used, the next
//   STAGES-1 are in flight.
// - Epilogue: m[l] = sum_j qt[j,d] * u[j,l], then out = sum_l at[l,d] * m[l],
//   the plain version's order of sums.  qt and at are read once, coalesced.
//   A Q above NQ runs in passes over blocks of NQ question tokens, with m
//   carried across them; each pass streams vt and w again (from L2).
// - Grid (B, D/256) of 128 threads: at B=128, 512 blocks, four per SM.
// - Instances: <12, 3> for Q <= 12, A <= 3 (the model's; one pass; padded
//   pairs are zero), <4, 8> for the rest up to Q <= 32, A <= 8.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, cold L2 (chip_smoke.py):
// 28.9 us at B=128 and 50.6 us at B=256, 2.7x and 2.4x the bound; the first
// version, one thread per d with Q*A shared loads of w per box row, took
// 79.3 us at B=128.  Rings of 2 or 6 stages, 8 box rows a stage, and 256
// threads a block measured 1-9% slower at B=128 and 256 (python3 -m
// vqatpu_torch.kernels.probe).  Like K1's, its copies are
// 16-byte (vt) and 4-byte (w) cp.async requests, a cycle or so each.
//
// bf16 operands (`compute_dtype="bfloat16"`): vt is bf16, and qt and at
// are bf16 at glimpse 0 and f32 at glimpse 1, where the residual has
// promoted the question and answer states (vqatpu/models/ffoe.py:321-322);
// w, the sums and out stay f32, as in the Pallas kernel, whose dots take
// the bf16 operands with preferred_element_type=f32 (:362).
// tri_pool_mma_kernel, on the tensor cores; the float32 instance above
// stays off them.
//
// What bounds it on the H100: bytes.  At B=128 it must read vt (13.1 MB),
// qt and at (3.9 MB bf16), w (0.9 MB) and write out: 18.5 MB, 5.5 us at
// 3.35 TB/s.  The CUDA-core instance (the kernel above with vt's and
// qt/at's types as template parameters) ran f32 FMAs at 6x that, and at
// glimpse 0 slower than float32: its V loop took 18.5 us in block 0 against 15.1 us
// at glimpse 1 and its qt epilogue 5.8 against 4.5 us (probe timeline),
// from the same source, so how the compiler scheduled the bf16-qt
// instance, not bytes, held it.
//
// Design:
// - V first, as the plain version: U[(j,l), d] = sum_i w[i,j,l] vt[i,d]
//   is a GEMM per sample with d as M (the block's 256 d, 16 m16 tiles:
//   2 a warp), the Q*A pairs as N (5 n8 tiles at 36) and V as K (4 k16
//   steps, zero past V).  A fragments are vt transposed by ldmatrix.trans
//   from [i][d] rows padded to 528 B; B fragments two n8 tiles an
//   ldmatrix from the w planes.
// - w is the f32 attention and is not rounded: each w, as it is loaded,
//   becomes three bf16 terms (w0 = bf16(w), w1 = bf16(w - w0), w2 =
//   bf16(w - w0 - w1); split_bf16x3), three planes [p][i], and three MMAs
//   a tile run into the same f32 accumulators.  A bf16 x bf16 product is
//   exact in f32 and the three terms rebuild the model's attention bit for
//   bit (tests/test_torch_kernels.py), so only the sums' order differs
//   from f32.  The split triples the MMAs: 960 a block, 2.0 GFLOP at
//   B=128, about 2 us at the tensor cores' peak.
// - One block takes a sample's 256-d spans in turn (up to 4, as many as
//   keep every SM busy at this B: all 4 at B=128, one at B=1), each span a
//   step; with Q > 12 or A > 3 a span runs passes of 6 question tokens
//   (the <6, 8> instance), and with V > 64 a pass runs steps of 64 boxes.
//   A step's vt rows, qt's rows and at's rows reach shared memory by
//   16-byte cp.async into a ring of three buffers, so two steps' copies
//   are in flight while one is multiplied.  w (f32, as it lies, a 4-byte
//   copy each) comes with the first step and is split once per sample;
//   again only where the steps change its (pass, rows).
// - Epilogue: U through shared memory (rows of 260 words, so the C
//   fragment's writes spread over the banks), summed over a pass's steps,
//   then with one d a thread m[l] = sum_j qt[j,d] U[(j,l),d] and out =
//   sum_l at[l,d] m[l], the plain version's order of sums, m carried
//   across passes.
// - 8 warps, one block an SM: 217 KB of shared memory at f32 qt/at, 194
//   KB at bf16.  A block per (sample, span), w split in each, would run
//   B=128's 512 blocks at two an SM in two waves whose products do not
//   overlap the next wave's copies (22.4 us measured).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, cold L2 (chip_smoke.py):
// at glimpse 0, 19.7 us a single call and 15.9 us back to back at B=128,
// 33.7 and 29.4 us at B=256, 3.6x and 3.1x the bound; at glimpse 1 (f32
// qt, at) 19.9 / 16.0 and 34.5 / 29.7 us.  The CUDA-core instance took
// 32.0 and 57.7 us (glimpse 0), 28.0 and 48.8 us (glimpse 1) in the same
// run.
// 112-124 registers, no spills.  The timeline of block 0 at B=128 (python3 -m
// vqatpu_torch.kernels.probe): the first step's operands and w in shared
// memory at 4.6 us, the split 0.6 us, then 2.1-2.8 us a step, of which
// the products 1.2 us (960 MMAs by 8 warps) and the epilogue 0.7 us.
// What holds it: the steps' products and epilogues, one block an SM, and
// the split's tripled MMAs; two step buffers measure 20.4 us, two spans a
// block 22.3 us, 16 warps of 16 d 22.6 us.
//
// Needs D % (16 / sizeof(TV)) == 0 (4 f32, 8 bf16) and 16-byte aligned vt,
// qt, at and out; the entry points refuse anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int DSPAN = 2 * THREADS;  // d per block, 2 per thread
constexpr int VR = 4;               // box rows per ring stage
constexpr int STAGES = 4;           // ring depth
constexpr int MAX_Q = 32;
constexpr int MAX_A = 8;

// floats of the ring a vt row of the d span takes
template <typename TV>
__host__ __device__ constexpr int vspan() { return DSPAN * (int)sizeof(TV) / 4; }

template <typename TV, int NQ, int NA>
__host__ __device__ constexpr int stage_floats() { return VR * (vspan<TV>() + NQ * NA); }

// 2 adjacent operands as f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// ONE_PASS: the caller guarantees Q <= NQ, so m is not live in the V loop
template <typename TV, typename TQ, int NQ, int NA, bool ONE_PASS>
__global__ void __launch_bounds__(THREADS, 4)
tri_pool_kernel(const TV* __restrict__ vt, const TQ* __restrict__ qt,
                const TQ* __restrict__ at, const float* __restrict__ w,
                long long w_sb, long long w_sv, long long w_sq, long long w_sa,
                float* __restrict__ out, int V, int Q, int A, int D) {
  constexpr int P = NQ * NA;          // (j, l) pairs of a pass
  constexpr int STAGE = stage_floats<TV, NQ, NA>();
  constexpr int EPU = 16 / (int)sizeof(TV);  // vt elements of a 16-byte unit
  constexpr int UPR = DSPAN / EPU;    // 16-byte units of a vt row
  constexpr int TPF = 4 / (int)sizeof(TV);   // vt elements of a ring float
  static_assert(P % 4 == 0, "w rows are read as float4");
  static_assert(VR * UPR % THREADS == 0, "vt units per thread");
  extern __shared__ float4 ring4[];
  float* ring = reinterpret_cast<float*>(ring4);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int d0 = blockIdx.y * DSPAN;
  const int d = d0 + 2 * tid;  // D % 4 == 0: d < D means d + 1 < D
  // this thread's 16-byte units of a vt chunk: rows tid / UPR + k * RSTEP,
  // columns d0 + tid % UPR * EPU
  constexpr int RSTEP = THREADS / UPR;
  const int dd = d0 + tid % UPR * EPU;
  const TV* vsrc = vt + ((size_t)b * V + tid / UPR) * D + dd;
  TV* vdst = reinterpret_cast<TV*>(ring) + tid * EPU;
  const float* wb = w + b * w_sb;
  // offsets inside one sample's w fit an int (the entry point checks)
  const int sv = (int)w_sv, sq = (int)w_sq, sa = (int)w_sa;
  const int n_chunks = (V + VR - 1) / VR;

  float m[NA][2];
#pragma unroll
  for (int l = 0; l < NA; ++l) m[l][0] = m[l][1] = 0.f;

  for (int j0 = 0; j0 < (ONE_PASS ? 1 : Q); j0 += NQ) {
    // box rows [c*VR, c*VR + VR) of vt (this block's d) and of w (this
    // pass's pairs) into ring slot c % STAGES
    auto load = [&](int c) {
      const int slot = (c % STAGES) * STAGE;
      float* ws = ring + slot + VR * vspan<TV>();
      const int i0 = c * VR;
#pragma unroll
      for (int k = 0; k < VR / RSTEP; ++k) {
        const int i = i0 + tid / UPR + k * RSTEP;
        const bool ok = i < V && dd < D;
        cp_async<16>(vdst + slot * TPF + k * RSTEP * DSPAN,
                     ok ? vsrc + (size_t)(i0 + k * RSTEP) * D : vt, ok);
      }
      for (int x = tid; x < VR * P; x += THREADS) {
        const int r = x / P, jj = x % P / NA, l = x % NA;
        const bool ok = i0 + r < V && j0 + jj < Q && l < A;
        cp_async<4>(ws + x, ok ? wb + ((i0 + r) * sv + (j0 + jj) * sq + l * sa) : wb,
                    ok);
      }
    };

    float u[P][2];
#pragma unroll
    for (int p = 0; p < P; ++p) u[p][0] = u[p][1] = 0.f;

    __syncthreads();  // the previous pass is done with the ring
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) {
      if (c < n_chunks) load(c);
      cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // chunk c has landed; slot (c-1) % STAGES is free
      if (c + STAGES - 1 < n_chunks) load(c + STAGES - 1);
      cp_async_commit();
      const float* vs = ring + (c % STAGES) * STAGE;
      const float* ws = vs + VR * vspan<TV>();
      // not unrolled: 72 accumulators of 128 registers (0 spilled)
#pragma unroll 1
      for (int r = 0; r < VR; ++r) {
        const float2 v = load2(reinterpret_cast<const TV*>(vs) + r * DSPAN + 2 * tid);
        const float4* wr = reinterpret_cast<const float4*>(ws + r * P);
#pragma unroll
        for (int p = 0; p < P / 4; ++p) {
          const float4 x = wr[p];
          u[4 * p][0] = fmaf(x.x, v.x, u[4 * p][0]);
          u[4 * p][1] = fmaf(x.x, v.y, u[4 * p][1]);
          u[4 * p + 1][0] = fmaf(x.y, v.x, u[4 * p + 1][0]);
          u[4 * p + 1][1] = fmaf(x.y, v.y, u[4 * p + 1][1]);
          u[4 * p + 2][0] = fmaf(x.z, v.x, u[4 * p + 2][0]);
          u[4 * p + 2][1] = fmaf(x.z, v.y, u[4 * p + 2][1]);
          u[4 * p + 3][0] = fmaf(x.w, v.x, u[4 * p + 3][0]);
          u[4 * p + 3][1] = fmaf(x.w, v.y, u[4 * p + 3][1]);
        }
      }
    }

    if (d < D) {
#pragma unroll
      for (int jj = 0; jj < NQ; ++jj) {
        if (j0 + jj >= Q) continue;
        const float2 q = load2(qt + ((size_t)b * Q + j0 + jj) * D + d);
#pragma unroll
        for (int l = 0; l < NA; ++l) {
          m[l][0] = fmaf(q.x, u[jj * NA + l][0], m[l][0]);
          m[l][1] = fmaf(q.y, u[jj * NA + l][1], m[l][1]);
        }
      }
    }
  }

  if (d < D) {
    float2 o = make_float2(0.f, 0.f);
#pragma unroll
    for (int l = 0; l < NA; ++l) {
      if (l >= A) continue;
      const float2 a = load2(at + ((size_t)b * A + l) * D + d);
      o.x = fmaf(a.x, m[l][0], o.x);
      o.y = fmaf(a.y, m[l][1], o.y);
    }
    *reinterpret_cast<float2*>(out + (size_t)b * D + d) = o;
  }
}

template <typename TV, typename TQ, int NQ, int NA, bool ONE_PASS>
cudaError_t launch(dim3 grid, cudaStream_t stream, const TV* vt,
                   const TQ* qt, const TQ* at, const float* w,
                   long long w_sb, long long w_sv, long long w_sq, long long w_sa,
                   float* out, int V, int Q, int A, int D) {
  constexpr int smem = STAGES * stage_floats<TV, NQ, NA>() * (int)sizeof(float);
  static_assert(smem <= 48 * 1024, "the ring fits the default shared memory");
  tri_pool_kernel<TV, TQ, NQ, NA, ONE_PASS><<<grid, THREADS, smem, stream>>>(
      vt, qt, at, w, w_sb, w_sv, w_sq, w_sa, out, V, Q, A, D);
  return cudaGetLastError();
}

template <typename TV, typename TQ>
int forward(const TV* vt, const TQ* qt, const TQ* at, const float* w,
            long long w_sb, long long w_sv, long long w_sq, long long w_sa,
            float* out, int B, int V, int Q, int A, int D, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q < 1 || A < 1 || Q > MAX_Q || A > MAX_A || D % (16 / (int)sizeof(TV)) != 0 ||
      ((uintptr_t)vt | (uintptr_t)qt | (uintptr_t)at | (uintptr_t)out) % 16 != 0 ||
      w_sv < 0 || w_sq < 0 || w_sa < 0 ||
      (V - 1LL) * w_sv + (Q - 1LL) * w_sq + (A - 1LL) * w_sa > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  const dim3 grid(B, (D + DSPAN - 1) / DSPAN);
  cudaStream_t s = (cudaStream_t)stream;
  if (Q <= 12 && A <= 3)
    return (int)launch<TV, TQ, 12, 3, true>(grid, s, vt, qt, at, w, w_sb, w_sv,
                                            w_sq, w_sa, out, V, Q, A, D);
  return (int)launch<TV, TQ, 4, 8, false>(grid, s, vt, qt, at, w, w_sb, w_sv,
                                          w_sq, w_sa, out, V, Q, A, D);
}

// ---------------------------------------------------------------------------
// bf16 vt on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int MWARPS = 8;                  // warps of a block
constexpr int MTHREADS = 32 * MWARPS;
constexpr int MTW = 2;                     // m16 tiles (32 d) of a warp
constexpr int MDSPAN = MWARPS * MTW * 16;  // d a step: 256
constexpr int KV = 64;                     // box rows a step
constexpr int MAX_SPANS = 4;               // d spans a block takes in turn
constexpr int NBUF = 3;                    // step buffers: NBUF-1 in flight
// padded shared rows: vt [i][d] bf16 (528 B: ldmatrix's eight rows in eight
// 16-byte bank groups), a w plane [p][i] bf16 (144 B, the same), U [p][d]
// f32 (260 words: the C fragment's columns 2*tig of the four tig lanes
// fall 8 banks apart)
constexpr int VTROW = MDSPAN + 8;
constexpr int WPROW = KV + 8;
constexpr int UROW = MDSPAN + 4;

// n8 tiles of the (j, l) pairs; the w planes have their rows rounded up
// to 16, so ldmatrix can read the tiles two at a time
template <int NQ, int NA>
__host__ __device__ constexpr int ntiles() { return (NQ * NA + 7) / 8; }

// Shared memory, in bytes: NBUF buffers of a step's operands (the vt
// tile, qt's rows of the pass and at's rows, of one d span), w as it
// arrives (f32 [i][p]), the three w planes and U.
template <typename TQ, int NQ, int NA>
struct MmaSmem {
  static constexpr int PM = (ntiles<NQ, NA>() + 1) / 2 * 16;
  static constexpr int vt = 0;
  static constexpr int qt = KV * VTROW * 2;
  static constexpr int at = qt + NQ * MDSPAN * (int)sizeof(TQ);
  static constexpr int buffer = at + NA * MDSPAN * (int)sizeof(TQ);
  static constexpr int wstage = NBUF * buffer;
  static constexpr int planes = wstage + KV * PM * 4;
  static constexpr int u = planes + 3 * PM * WPROW * 2;
  static constexpr int bytes = u + ntiles<NQ, NA>() * 8 * UROW * 4;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Block (b, y) takes d spans [y * spans, y * spans + spans) of sample b in
// turn; each span runs its passes of NQ question tokens (one where Q <=
// NQ), each pass its steps of KV box rows (one where V <= KV).  The
// operands of steps k+1 .. k+NBUF-1 are in flight, each in a buffer of its
// own, while step k is multiplied.  w's planes are built for the first
// step and again only where a step's (pass, rows) differ from the last
// one's.
template <typename TQ, int NQ, int NA>
__global__ void __launch_bounds__(MTHREADS, 1)
tri_pool_mma_kernel(const bf16* __restrict__ vt, const TQ* __restrict__ qt,
                    const TQ* __restrict__ at, const float* __restrict__ w,
                    long long w_sb, long long w_sv, long long w_sq, long long w_sa,
                    float* __restrict__ out, int V, int Q, int A, int D, int spans) {
  using L = MmaSmem<TQ, NQ, NA>;
  constexpr int NTP = ntiles<NQ, NA>();
  constexpr int PM = L::PM;                   // rows (j, l) = jj * NA + l
  constexpr int UPR = MDSPAN / 8;             // 16-byte units of a vt row
  constexpr int EPU = 16 / (int)sizeof(TQ);   // qt or at of a 16-byte unit
  static_assert(KV * UPR % MTHREADS == 0 && KV * PM % (2 * MTHREADS) == 0,
                "whole copies per thread");
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* wst = reinterpret_cast<float*>(smem + L::wstage);  // [KV][PM]
  bf16* ws = reinterpret_cast<bf16*>(smem + L::planes);     // [3][PM][WPROW]
  float* us = reinterpret_cast<float*>(smem + L::u);        // [NTP*8][UROW]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int group = lane / 4, tig = lane % 4;
  const int n_spans = (D + MDSPAN - 1) / MDSPAN;
  const int s0 = blockIdx.y * spans;
  const int s1 = s0 + spans < n_spans ? s0 + spans : n_spans;
  const int n_passes = (Q + NQ - 1) / NQ;
  const int n_chunks = (V + KV - 1) / KV;
  const int per_span = n_passes * n_chunks;
  const int n_steps = (s1 - s0) * per_span;
  // one pass of one chunk: the planes stay from the first step on
  const bool one_plane = per_span == 1;
  const bf16* vb = vt + (size_t)b * V * D;
  const float* wb = w + b * w_sb;
  // offsets inside one sample's w fit an int (the entry point checks)
  const int sv = (int)w_sv, sq = (int)w_sq, sa = (int)w_sa;

  // rows of a [B, n, D] operand (q or a) of this sample, d from d0, into
  // shared memory; zero past `valid` rows and past D
  auto stage_rows = [&](TQ* dst, const TQ* src, int rows, int valid, int d0) {
    const int upr = MDSPAN / EPU;
    for (int u = tid; u < rows * upr; u += MTHREADS) {
      const int r = u / upr, dd = d0 + u % upr * EPU;
      const bool ok = r < valid && dd < D;
      cp_async<16>(dst + r * MDSPAN + u % upr * EPU,
                   ok ? src + (size_t)r * D + dd : src, ok);
    }
  };
  // step k's vt rows, qt's pass rows and at's rows into buffer k % NBUF,
  // zero past V, D, Q and A
  auto load_step = [&](int k) {
    char* buf = smem + (k % NBUF) * L::buffer;
    const int d0 = (s0 + k / per_span) * MDSPAN;
    const int j0 = k % per_span / n_chunks * NQ;
    const int i0 = k % n_chunks * KV;
    bf16* vs = reinterpret_cast<bf16*>(buf + L::vt);
#pragma unroll 2
    for (int c = 0; c < KV * UPR / MTHREADS; ++c) {
      const int u = tid + c * MTHREADS;
      const int r = u / UPR, dd = d0 + u % UPR * 8;
      const bool ok = i0 + r < V && dd < D;
      cp_async<16>(vs + r * VTROW + u % UPR * 8,
                   ok ? vb + (size_t)(i0 + r) * D + dd : vt, ok);
    }
    stage_rows(reinterpret_cast<TQ*>(buf + L::qt), qt + ((size_t)b * Q + j0) * D,
               NQ, Q - j0, d0);
    stage_rows(reinterpret_cast<TQ*>(buf + L::at), at + (size_t)b * A * D, NA, A, d0);
  };
  // w of step k's rows and pass, as it lies (a 4-byte copy each), zero
  // past V, Q and A
  auto load_w = [&](int k) {
    const int j0 = k % per_span / n_chunks * NQ;
    const int i0 = k % n_chunks * KV;
#pragma unroll 2
    for (int c = 0; c < KV * PM / MTHREADS; ++c) {
      const int x = tid + c * MTHREADS;
      const int r = x / PM, p = x % PM, jj = p / NA, l = p % NA;
      const bool ok = i0 + r < V && jj < NQ && j0 + jj < Q && l < A;
      cp_async<4>(wst + x, ok ? wb + ((i0 + r) * sv + (j0 + jj) * sq + l * sa) : wb,
                  ok);
    }
  };

  // a group for each step: w joins step 0's
  load_step(0);
  load_w(0);
  cp_async_commit();
#pragma unroll
  for (int k = 1; k < NBUF - 1; ++k) {
    if (k < n_steps) load_step(k);
    cp_async_commit();
  }

  float m[NA] = {};
  for (int k = 0; k < n_steps; ++k) {
    const int span = s0 + k / per_span;
    const int pass = k % per_span / n_chunks;
    const int chunk = k % n_chunks;
    const int i0 = chunk * KV;
    const char* buf = smem + (k % NBUF) * L::buffer;
    const bf16* vs = reinterpret_cast<const bf16*>(buf + L::vt);

    __syncthreads();  // step k-1 is done with its buffer
    if (k + NBUF - 1 < n_steps) load_step(k + NBUF - 1);
    cp_async_commit();
    // step k's operands (and w); where the planes change every step, also
    // the later steps', since w follows in a group of its own
    if (one_plane)
      cp_async_wait<NBUF - 1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    if (k == 0 || !one_plane) {
      // w split into three bf16 planes [p][i], two rows i a thread so
      // that each plane takes one 4-byte store
#pragma unroll 2
      for (int c = 0; c < KV * PM / 2 / MTHREADS; ++c) {
        const int x = tid + c * MTHREADS;
        const int r = x / PM * 2, p = x % PM;
        bf16 lo[3], hi[3];
        split_bf16x3(wst[r * PM + p], lo[0], lo[1], lo[2]);
        split_bf16x3(wst[(r + 1) * PM + p], hi[0], hi[1], hi[2]);
#pragma unroll
        for (int pl = 0; pl < 3; ++pl)
          *reinterpret_cast<__nv_bfloat162*>(ws + (pl * PM + p) * WPROW + r) =
              __halves2bfloat162(lo[pl], hi[pl]);
      }
      __syncthreads();
      if (!one_plane && k + 1 < n_steps) {
        load_w(k + 1);
        cp_async_commit();
      }
    }

    // U[p, d] += sum_i vt[i, d] w[i, p], d the M dimension: A is vt
    // transposed by ldmatrix, B a w plane, two n8 tiles an ldmatrix;
    // three products a tile, one per plane, into the same f32
    // accumulators
    float acc[MTW][NTP][4];
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    const int n_rows = V - i0 < KV ? V - i0 : KV;
    for (int kk = 0; kk < n_rows; kk += 16) {
      unsigned a[MTW][4];
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt)
        ldmatrix_x4_trans(a[mt], vs + (kk + (lane & 7) + (lane >> 4) * 8) * VTROW +
                                     (warp * MTW + mt) * 16 + (lane >> 3 & 1) * 8);
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) {
#pragma unroll
        for (int nt = 0; nt < NTP; nt += 2) {
          unsigned bb[4];
          ldmatrix_x4(bb, ws + (pl * PM + nt * 8 + (lane & 7) + (lane >> 4) * 8) * WPROW +
                              kk + (lane >> 3 & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MTW; ++mt) {
            mma_bf16(acc[mt][nt], a[mt], bb[0], bb[1]);
            if (nt + 1 < NTP) mma_bf16(acc[mt][nt + 1], a[mt], bb[2], bb[3]);
          }
        }
      }
    }

    // U summed over the steps of a pass through shared memory: the first
    // chunk writes it, the others add to it (each element by the thread
    // that wrote it); after the last, m[l] = sum_j qt[j, d] U[(j, l), d]
    // with one d a thread, in the plain version's order of sums
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* u = us + (nt * 8 + 2 * tig + e % 2) * UROW + (warp * MTW + mt) * 16 +
                     group + 8 * (e / 2);
          *u = chunk == 0 ? acc[mt][nt][e] : *u + acc[mt][nt][e];
        }
    if (chunk + 1 < n_chunks) continue;
    __syncthreads();
    if (pass == 0) {
#pragma unroll
      for (int l = 0; l < NA; ++l) m[l] = 0.f;
    }
    const TQ* qs = reinterpret_cast<const TQ*>(buf + L::qt);
    const int j0 = pass * NQ;
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj) {
      if (j0 + jj >= Q) continue;
      const float q = to_f32(qs[jj * MDSPAN + tid]);
#pragma unroll
      for (int l = 0; l < NA; ++l) m[l] = fmaf(q, us[(jj * NA + l) * UROW + tid], m[l]);
    }
    const int d = span * MDSPAN + tid;
    if (pass + 1 == n_passes && d < D) {
      const TQ* as = reinterpret_cast<const TQ*>(buf + L::at);
      float o = 0.f;
#pragma unroll
      for (int l = 0; l < NA; ++l) {
        if (l >= A) continue;
        o = fmaf(to_f32(as[l * MDSPAN + tid]), m[l], o);
      }
      out[(size_t)b * D + d] = o;
    }
  }
}

template <typename TQ, int NQ, int NA>
cudaError_t launch_mma(dim3 grid, int spans, cudaStream_t stream, int device,
                       const bf16* vt, const TQ* qt, const TQ* at, const float* w,
                       long long w_sb, long long w_sv, long long w_sq, long long w_sa,
                       float* out, int V, int Q, int A, int D) {
  constexpr int smem = MmaSmem<TQ, NQ, NA>::bytes;
  constexpr int MAX_DEVICES = 64;
  static bool raised[MAX_DEVICES] = {};
  auto kernel = tri_pool_mma_kernel<TQ, NQ, NA>;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  kernel<<<grid, MTHREADS, smem, stream>>>(vt, qt, at, w, w_sb, w_sv, w_sq,
                                           w_sa, out, V, Q, A, D, spans);
  return cudaGetLastError();
}

template <typename TQ>
int forward_mma(const bf16* vt, const TQ* qt, const TQ* at, const float* w,
                long long w_sb, long long w_sv, long long w_sq, long long w_sa,
                float* out, int B, int V, int Q, int A, int D, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q < 1 || A < 1 || Q > MAX_Q || A > MAX_A || D % 8 != 0 ||
      ((uintptr_t)vt | (uintptr_t)qt | (uintptr_t)at | (uintptr_t)out) % 16 != 0 ||
      w_sv < 0 || w_sq < 0 || w_sa < 0 ||
      (V - 1LL) * w_sv + (Q - 1LL) * w_sq + (A - 1LL) * w_sa > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  // one block an SM: a block takes as many of a sample's d spans (up to
  // MAX_SPANS) as keep every SM busy, so B=1 spreads its spans over
  // blocks and B >= SMs / spans takes all of a sample's in one
  constexpr int MAX_DEVICES = 64;
  static int sms[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_spans = (D + MDSPAN - 1) / MDSPAN;
  const long long want = ((long long)B * n_spans + sms[device] - 1) / sms[device];
  const int spans = (int)(want < 1 ? 1 : want > MAX_SPANS ? MAX_SPANS : want);
  const dim3 grid(B, (n_spans + spans - 1) / spans);
  cudaStream_t s = (cudaStream_t)stream;
  if (Q <= 12 && A <= 3)
    return (int)launch_mma<TQ, 12, 3>(grid, spans, s, device, vt, qt, at, w, w_sb,
                                      w_sv, w_sq, w_sa, out, V, Q, A, D);
  return (int)launch_mma<TQ, 6, 8>(grid, spans, s, device, vt, qt, at, w, w_sb,
                                   w_sv, w_sq, w_sa, out, V, Q, A, D);
}

}  // namespace

extern "C" int tri_pool_forward(const float* vt, const float* qt,
                                const float* at, const float* w,
                                long long w_sb, long long w_sv, long long w_sq,
                                long long w_sa, float* out, int B, int V,
                                int Q, int A, int D, int device, void* stream) {
  return forward(vt, qt, at, w, w_sb, w_sv, w_sq, w_sa, out, B, V, Q, A, D,
                 device, stream);
}

// vt bf16; qt and at bf16 when qa_bf16 is nonzero, else f32
extern "C" int tri_pool_forward_bf16(const __nv_bfloat16* vt, const void* qt,
                                     const void* at, const float* w,
                                     long long w_sb, long long w_sv, long long w_sq,
                                     long long w_sa, float* out, int B, int V,
                                     int Q, int A, int D, int qa_bf16,
                                     int device, void* stream) {
  if (qa_bf16)
    return forward_mma(vt, (const __nv_bfloat16*)qt, (const __nv_bfloat16*)at, w,
                       w_sb, w_sv, w_sq, w_sa, out, B, V, Q, A, D, device, stream);
  return forward_mma(vt, (const float*)qt, (const float*)at, w, w_sb, w_sv, w_sq,
                     w_sa, out, B, V, Q, A, D, device, stream);
}
