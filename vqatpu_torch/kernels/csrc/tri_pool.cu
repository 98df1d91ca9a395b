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
// the bf16 operands with preferred_element_type=f32 (:362).  The same
// kernel with vt's type TV and qt/at's type TQ as template parameters: the
// ring holds vt as TV, so a 16-byte copy carries 8 bf16 and a thread's 2 d
// are one 4-byte shared read, widened to f32 in registers (a bf16 is the
// top half of an f32); qt and at are read the same way.  Instances <bf16,
// bf16> and <bf16, f32> beside <f32, f32>; the bound falls by vt's halved
// bytes (about 6 us at B=128).  A simple, correct instance: the FMAs stay
// f32 on the CUDA cores.
//
// Needs D % (16 / sizeof(TV)) == 0 (4 f32, 8 bf16) and 16-byte aligned vt,
// qt, at and out; the entry points refuse anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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
    return forward(vt, (const __nv_bfloat16*)qt, (const __nv_bfloat16*)at, w,
                   w_sb, w_sv, w_sq, w_sa, out, B, V, Q, A, D, device, stream);
  return forward(vt, (const float*)qt, (const float*)at, w, w_sb, w_sv, w_sq,
                 w_sa, out, B, V, Q, A, D, device, stream);
}
