// Fused rank-contraction GEMM + masked softmax over (V, Q, A) per glimpse.
//
// Replaces the Pallas kernel `fused_rank_softmax`
// (vqatpu/kernels/trilinear.py:303-327, body `_rank_softmax_kernel` :258-275).
//
//   att[b,i,j,l,g] = softmax over all (i,j,l) of
//                    sum_k v_r[b,i,k] * tqa[b,j,l,k,g]        (k = r*X + x)
//
// with masked boxes set to -1e30 and then multiplied by the mask, and the
// denominator clamped at 1e-30, so a fully masked sample (the padded rows of
// a serving bucket) comes out as zeros and never as NaN.
//
// Layouts: v_r [B,V,RX], tqa [B,QA,RX,G] (precontract_qa's [B,Q,A,R,X,G]),
// mask [B,V] bool, att [B,V,QA,G] -- the model's [B,V,Q,A,G] layout, written
// in place, with no transpose.
//
// What bounds it on the H100: bytes, narrowly.  At the serving bucket B=128,
// V=50, RX=512, QA=36, G=2 it must read v_r (13.1 MB) and tqa (18.9 MB) and
// write att (1.8 MB): 10.1 us at 3.35 TB/s, against 7.0 us for its
// 0.47 GFLOP at the 67 TFLOP/s of the f32 CUDA cores (14 FLOP per byte,
// below the card's f32 balance of 20).  The parity contract keeps the
// product in f32 and off the tensor cores.
//
// Design:
// - One block per (sample, glimpse group).  A group holds both glimpses of
//   the model (GG = 2 when G is even and 2*QA fits the tile), so v_r[b] is
//   read once, tqa[b] is read as contiguous rows of KC*G floats, and att
//   rows are written coalesced.  B=128 is one block per SM, B=256 two.
// - The [RX] axis is walked in chunks of KC = 32 through a STAGES-deep ring
//   in dynamic shared memory, filled with 16-byte cp.async copies (4- or
//   8-byte copies when the group is narrower than G): while one chunk is
//   multiplied, the next STAGES-1 are in flight.  Ragged rows and chunks are
//   zero-filled by the copy itself.
// - Register tiling: each thread owns TM = 4 rows x (4 / GG) qa x GG
//   glimpses of the [V-tile, QA*GG] output and reads its operands as float4,
//   8 shared loads for 64 FMAs.  Rows and qa are interleaved across the
//   threads (row rg + s*RG, qa cq + t*CQ), so the padded shared rows are
//   read without bank conflicts and the stores stay coalesced.
// - The masked softmax runs in the epilogue from registers: each thread's
//   max and sum per glimpse, warp shuffles, then one warp across the warps.
//   The logits never reach device memory when V fits one tile (VT = 56 at
//   QA = 36, G = 2).  Larger V (2048 boxes) loops over V tiles with a
//   running max and sum, parks the masked logits in `att`, and rescales
//   them in a second pass in which each thread rereads only what it wrote.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, cold L2 (chip_smoke.py):
// 35.4 us at B=128 and 52.6 us at B=256, 3.5x and 2.6x the bound; the first
// version, one block per (b, g) without register tiles, took 158.8 us at
// B=128.  What holds it back, from the clock64 timeline of one block at
// B=1 (python3 -m vqatpu_torch.kernels.probe): requesting the first
// STAGES-1 chunks takes 1.8 us, about 1.2 cycles of the SM per 16-byte
// cp.async; each chunk then takes 1.4 us while the next chunk's copies are
// issued and 1.1 us for the last three, whose 512 FMAs a warp run at half
// the issue rate; the epilogue takes 5 us of the 28.8.  Rings of 2 or 5
// stages, or chunks of 16 columns, measured no faster.  The f32 FMAs and
// the copy issue are the next limits: tensor cores (3xTF32) and TMA.
//
// bf16 operands (`compute_dtype="bfloat16"`, where the Pallas kernel takes
// bf16 v_r and tqa and multiplies with preferred_element_type=f32, :268):
// the same kernel with the operand type T a template parameter.  The ring
// holds T, so a 16-byte copy carries 8 bf16 and a stage half the bytes; each
// shared read of 4 operands is 8 bytes, widened to f32 in registers (a bf16
// is the top half of an f32), so the products are exact and the sums, the
// softmax and att are f32 as in the f32 instance.  Rows are padded by one
// 16-byte unit either way.  Where a glimpse group is not contiguous in tqa
// (G other than 1 or 2) a bf16 element is 2 bytes, below cp.async's
// smallest copy, so those rows are copied through registers.  The bound
// halves in bytes (about 5 us at B=128); the FMAs stay f32 on the CUDA
// cores, so this instance is for correctness first: tensor-core MMA
// (mma.sync m16n8k16 or wgmma, f32 accumulators) is later work.
//
// Needs RX % (16 / sizeof(T)) == 0 (4 f32, 8 bf16) and 16-byte aligned v_r
// and tqa (the 16-byte copies), and QA <= 256; the entry points refuse
// anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int KC = 32;            // RX columns per ring stage
constexpr int STAGES = 4;         // ring depth
constexpr int TM = 4;             // rows of a thread's micro-tile
constexpr int MAX_RG = 16;        // row groups: V tile <= 64 rows
constexpr int MAX_COLS = 256;     // QA * GG columns per block
constexpr int MAX_QA = 256;
constexpr float NEG_BIG = -1e30f;

// operands of T in one 16-byte unit: 4 f32, 8 bf16
template <typename T>
__host__ __device__ constexpr int unit() { return 16 / (int)sizeof(T); }

// padded shared row of the v_r tile
template <typename T>
__host__ __device__ constexpr int vrow() { return KC + unit<T>(); }

// padded shared row of the tqa tile: KC columns of GG glimpses
template <typename T>
__host__ __device__ constexpr int wrow(int gg) { return KC * gg + unit<T>(); }

// glimpses per block
int glimpse_group(int QA, int G) {
  return (G % 2 == 0 && 2 * QA <= MAX_COLS) ? 2 : 1;
}

struct Tiling {
  int gg, cq, rg, threads;
  size_t smem;  // bytes of the ring
};

template <typename T>
Tiling tiling(int QA, int G) {
  Tiling t;
  t.gg = glimpse_group(QA, G);
  const int tq = 4 / t.gg;
  t.cq = (QA + tq - 1) / tq;
  t.rg = MAX_THREADS / t.cq < MAX_RG ? MAX_THREADS / t.cq : MAX_RG;
  t.threads = (t.rg * t.cq + 31) / 32 * 32;
  const size_t stage =
      (size_t)t.cq * tq * wrow<T>(t.gg) + (size_t)t.rg * TM * vrow<T>();
  t.smem = STAGES * stage * sizeof(T);
  return t;
}

__device__ __forceinline__ float lane(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// 4 consecutive operands from shared memory as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// (m, s) <- the running max and sum of two partial softmax reductions
__device__ __forceinline__ void combine(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both partials empty
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

template <typename T, int GG, bool CONTIG>
__global__ void __launch_bounds__(MAX_THREADS, 2)
rank_softmax_kernel(const T* __restrict__ v_r, const T* __restrict__ tqa,
                    const unsigned char* __restrict__ mask, float* __restrict__ att,
                    int V, int RX, int QA, int G, int CQ, int RG) {
  constexpr int TQ = 4 / GG;
  constexpr int WROW = wrow<T>(GG);
  constexpr int VROW = vrow<T>();
  constexpr int U = unit<T>();
  extern __shared__ float4 ring4[];
  T* ring = reinterpret_cast<T*>(ring4);
  __shared__ float red_m[MAX_THREADS / 32][GG];
  __shared__ float red_s[MAX_THREADS / 32][GG];

  const int b = blockIdx.x;
  const int g0 = blockIdx.y * GG;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int VT = RG * TM;
  const int QAP = CQ * TQ;
  const int w_stage = QAP * WROW;
  const int stage = w_stage + VT * VROW;
  const bool active = tid < RG * CQ;
  const int cq = tid % CQ, rg = tid / CQ;

  const T* vb = v_r + (size_t)b * V * RX;
  const T* tb = tqa + (size_t)b * QA * RX * G;
  const unsigned char* mb = mask + (size_t)b * V;
  float* ob = att + (size_t)b * V * QA * G;
  const int n_tiles = (V + VT - 1) / VT;
  const int n_chunks = (RX + KC - 1) / KC;

  float run_m[GG], run_s[GG];
#pragma unroll
  for (int g = 0; g < GG; ++g) {
    run_m[g] = -INFINITY;
    run_s[g] = 0.f;
  }
  float acc[TM][TQ][GG];

  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = t * VT;

    // chunk c of tqa (QAP rows of KC*GG floats) and of v_r (VT rows of KC)
    // into ring slot c % STAGES
    auto load = [&](int c) {
      T* ws = ring + (c % STAGES) * stage;
      T* vs = ws + w_stage;
      const int k0 = c * KC;
      if constexpr (CONTIG) {
        constexpr int UPR = KC * GG / U;  // 16-byte units per row
        for (int u = tid; u < QAP * UPR; u += nthreads) {
          const int qa = u / UPR, cu = u % UPR;
          const bool ok = qa < QA && k0 + cu * U / GG < RX;
          cp_async<16>(ws + qa * WROW + cu * U,
                       ok ? tb + ((size_t)qa * RX + k0) * G + cu * U : tb, ok);
        }
      } else {
        for (int u = tid; u < QAP * KC; u += nthreads) {
          const int qa = u / KC, kk = u % KC;
          const bool ok = qa < QA && k0 + kk < RX;
          if constexpr (sizeof(T) * GG >= 4) {
            cp_async<(int)sizeof(T) * GG>(
                ws + qa * WROW + kk * GG,
                ok ? tb + ((size_t)qa * RX + k0 + kk) * G + g0 : tb, ok);
          } else {  // one bf16: through registers
            ws[qa * WROW + kk * GG] =
                ok ? tb[((size_t)qa * RX + k0 + kk) * G + g0] : T(0.f);
          }
        }
      }
      constexpr int VU = KC / U;
      for (int u = tid; u < VT * VU; u += nthreads) {
        const int r = u / VU, cu = u % VU;
        const bool ok = i0 + r < V && k0 + cu * U < RX;
        cp_async<16>(vs + r * VROW + cu * U,
                     ok ? vb + (size_t)(i0 + r) * RX + k0 + cu * U : vb, ok);
      }
    };

#pragma unroll
    for (int s = 0; s < TM; ++s)
#pragma unroll
      for (int q = 0; q < TQ; ++q)
#pragma unroll
        for (int g = 0; g < GG; ++g) acc[s][q][g] = 0.f;

    __syncthreads();  // the previous tile is done with the ring
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
      if (active) {
        const T* ws = ring + (c % STAGES) * stage;
        const T* vs = ws + w_stage;
#pragma unroll
        for (int kk = 0; kk < KC; kk += 4) {
          float4 a[TM];
#pragma unroll
          for (int s = 0; s < TM; ++s)
            a[s] = load4(vs + (rg + s * RG) * VROW + kk);
          float4 w[TQ][GG];  // k = kk..kk+3 times the group's glimpses
#pragma unroll
          for (int q = 0; q < TQ; ++q)
#pragma unroll
            for (int h = 0; h < GG; ++h)
              w[q][h] = load4(ws + (cq + q * CQ) * WROW + kk * GG + 4 * h);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int s = 0; s < TM; ++s)
#pragma unroll
              for (int q = 0; q < TQ; ++q)
#pragma unroll
                for (int g = 0; g < GG; ++g) {
                  const int e = j * GG + g;
                  acc[s][q][g] = fmaf(lane(a[s], j), lane(w[q][e / 4], e % 4),
                                      acc[s][q][g]);
                }
        }
      }
    }

    // masked logits of this tile into the thread's running max and sum
#pragma unroll
    for (int g = 0; g < GG; ++g) {
      float tmax = -INFINITY;
#pragma unroll
      for (int s = 0; s < TM; ++s) {
        const int i = i0 + rg + s * RG;
        if (!active || i >= V) continue;
        const bool keep = mb[i] != 0;
#pragma unroll
        for (int q = 0; q < TQ; ++q) {
          if (cq + q * CQ >= QA) continue;
          if (!keep) acc[s][q][g] = NEG_BIG;
          tmax = fmaxf(tmax, acc[s][q][g]);
        }
      }
      const float m = fmaxf(run_m[g], tmax);
      if (m == -INFINITY) continue;  // nothing of this thread yet
      float sum = run_s[g] * expf(run_m[g] - m);
#pragma unroll
      for (int s = 0; s < TM; ++s) {
        const int i = i0 + rg + s * RG;
        if (!active || i >= V || !mb[i]) continue;
#pragma unroll
        for (int q = 0; q < TQ; ++q) {
          if (cq + q * CQ < QA) sum += expf(acc[s][q][g] - m);
        }
      }
      run_m[g] = m;
      run_s[g] = sum;
    }
    if (n_tiles > 1) {
#pragma unroll
      for (int s = 0; s < TM; ++s) {
        const int i = i0 + rg + s * RG;
        if (!active || i >= V) continue;
#pragma unroll
        for (int q = 0; q < TQ; ++q) {
          const int qa = cq + q * CQ;
          if (qa >= QA) continue;
#pragma unroll
          for (int g = 0; g < GG; ++g)
            ob[((size_t)i * QA + qa) * G + g0 + g] = acc[s][q][g];
        }
      }
    }
  }

  // block-wide max and sum per glimpse: warp shuffles, then one warp over
  // the warps
#pragma unroll
  for (int g = 0; g < GG; ++g) {
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, run_m[g], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, run_s[g], off);
      combine(run_m[g], run_s[g], m2, s2);
    }
  }
  const int warp = tid / 32, lane_id = tid % 32, n_warps = nthreads / 32;
  if (lane_id == 0) {
#pragma unroll
    for (int g = 0; g < GG; ++g) {
      red_m[warp][g] = run_m[g];
      red_s[warp][g] = run_s[g];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int g = 0; g < GG; ++g) {
      float m = lane_id < n_warps ? red_m[lane_id][g] : -INFINITY;
      float s = lane_id < n_warps ? red_s[lane_id][g] : 0.f;
      for (int off = 16; off > 0; off >>= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
        const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
        combine(m, s, m2, s2);
      }
      // every lane of warp 0 has read its red_* entries by this shuffle
      if (lane_id == 0) {
        red_m[0][g] = m;
        red_s[0][g] = s;
      }
    }
  }
  __syncthreads();
  float m[GG], den[GG];
#pragma unroll
  for (int g = 0; g < GG; ++g) {
    m[g] = red_m[0][g];
    den[g] = fmaxf(red_s[0][g], 1e-30f);
  }

  // normalise: from registers, or rereading the parked logits
  if (!active) return;
  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = t * VT;
#pragma unroll
    for (int s = 0; s < TM; ++s) {
      const int i = i0 + rg + s * RG;
      if (i >= V) continue;
      const bool keep = mb[i] != 0;
#pragma unroll
      for (int q = 0; q < TQ; ++q) {
        const int qa = cq + q * CQ;
        if (qa >= QA) continue;
        float* o = ob + ((size_t)i * QA + qa) * G + g0;
        float y[GG];
#pragma unroll
        for (int g = 0; g < GG; ++g) {
          const float x = n_tiles == 1 ? acc[s][q][g] : o[g];
          y[g] = keep ? expf(x - m[g]) / den[g] : 0.f;
        }
        if constexpr (GG == 2 && CONTIG) {
          *reinterpret_cast<float2*>(o) = make_float2(y[0], y[1]);
        } else {
#pragma unroll
          for (int g = 0; g < GG; ++g) o[g] = y[g];
        }
      }
    }
  }
}

template <typename T, int GG, bool CONTIG>
cudaError_t launch(const Tiling& t, dim3 grid, cudaStream_t stream, int device,
                   const T* v_r, const T* tqa, const unsigned char* mask,
                   float* att, int V, int RX, int QA, int G) {
  // the ring can exceed the 48 KB default: allow, once per device, the most
  // any tiling of this instance asks for
  constexpr int MAX_DEVICES = 64;
  static bool raised[MAX_DEVICES] = {};
  constexpr size_t most =
      STAGES * ((size_t)MAX_COLS / GG * wrow<T>(GG) + (size_t)MAX_RG * TM * vrow<T>()) *
      sizeof(T);
  auto kernel = rank_softmax_kernel<T, GG, CONTIG>;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  kernel<<<grid, t.threads, t.smem, stream>>>(v_r, tqa, mask, att, V, RX, QA, G,
                                              t.cq, t.rg);
  return cudaGetLastError();
}

template <typename T>
int forward(const T* v_r, const T* tqa, const unsigned char* mask, float* att,
            int B, int V, int RX, int QA, int G, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (QA < 1 || QA > MAX_QA || RX % unit<T>() != 0 ||
      ((uintptr_t)v_r | (uintptr_t)tqa) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || V == 0 || G == 0) return 0;
  const Tiling t = tiling<T>(QA, G);
  const dim3 grid(B, G / t.gg);
  cudaStream_t s = (cudaStream_t)stream;
  if (t.gg == 2)
    err = G == 2 ? launch<T, 2, true>(t, grid, s, device, v_r, tqa, mask, att, V, RX, QA, G)
                 : launch<T, 2, false>(t, grid, s, device, v_r, tqa, mask, att, V, RX, QA, G);
  else
    err = G == 1 ? launch<T, 1, true>(t, grid, s, device, v_r, tqa, mask, att, V, RX, QA, G)
                 : launch<T, 1, false>(t, grid, s, device, v_r, tqa, mask, att, V, RX, QA, G);
  return (int)err;
}

}  // namespace

extern "C" int rank_softmax_forward(const float* v_r, const float* tqa,
                                    const unsigned char* mask, float* att,
                                    int B, int V, int RX, int QA, int G,
                                    int device, void* stream) {
  return forward(v_r, tqa, mask, att, B, V, RX, QA, G, device, stream);
}

extern "C" int rank_softmax_forward_bf16(const __nv_bfloat16* v_r,
                                         const __nv_bfloat16* tqa,
                                         const unsigned char* mask, float* att,
                                         int B, int V, int RX, int QA, int G,
                                         int device, void* stream) {
  return forward(v_r, tqa, mask, att, B, V, RX, QA, G, device, stream);
}
