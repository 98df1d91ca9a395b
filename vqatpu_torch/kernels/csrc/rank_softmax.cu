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
// rank_softmax_mma_kernel, on the tensor cores.  The float32 instances
// above stay off them (the parity contract).
//
// What bounds it on the H100: bytes.  At B=128 it must read v_r (6.6 MB)
// and tqa (9.4 MB) and write att (1.8 MB): 17.8 MB, 5.3 us at 3.35 TB/s.
// Its 0.47 GFLOP take 0.5 us at the bf16 tensor cores' 989 TFLOP/s, and
// 7.0 us as f32 FMAs on the CUDA cores, which is what held the CUDA-core
// instance (the kernel above at T = bf16, each operand widened in
// registers): no faster than float32, every 32-column chunk 1.4 us of FMA
// issue.
//
// Design:
// - Per sample and glimpse pair the logits are a small GEMM, [V, RX] x
//   [RX, QA*2], run as mma.sync m16n8k16 with bf16 operands and f32
//   accumulators (a bf16 product is exact in f32, as in the Pallas dot).
//   wgmma buys nothing here: with the products off the CUDA cores what is
//   left is bytes and the copies' issue, and its 64-row tiles and
//   shared-memory descriptors cost more than they give at M = V = 50.
// - One block per (sample, glimpse group), as above.  Warp (wm, wn) owns
//   m16 tile wm of a 64-row V tile and NT = 6 n8 tiles, an n8 tile being
//   8 qa of one glimpse with the two glimpses of a qa block side by side:
//   8 warps at QA = 36 (10 tiles; the second n group's last two repeat
//   the last qa block, so no warp branches on QA).
// - tqa's rows interleave the glimpses ([qa][k][g]), so neither k nor n
//   is contiguous for a column (qa, g): one 8-byte read gives (k, g0)
//   (k, g1) (k+1, g0) (k+1, g1), and two __byte_perm make the (k, k+1)
//   pairs of both glimpses, the B registers of two n8 tiles.  A fragments
//   by ldmatrix; G = 1 reads its k-contiguous rows directly.  A whole
//   chunk runs with no branch, so one step's reads are issued ahead of the
//   last one's MMAs.
// - A ring of 4 stages of 64 RX columns, filled by TMA: per stage one
//   thread asks for a box of v_r (64 rows) and one (G = 1) or two (G = 2,
//   32 k each) of tqa through tensor maps made on the host, and the
//   stage's mbarrier counts the bytes; out of bounds (rows past V or QA,
//   columns past RX) the copies write zeros.  The rows are 128 bytes,
//   swizzled (16-byte chunk ^ row % 8), so ldmatrix's rows fall in
//   different banks; column n of a G = 2 tile is qa 2*(n%4) + n/4 of its
//   block, so a half-warp's four 8-byte rows do too.  Where the glimpse
//   group is not contiguous (G other than 1 or 2) 16-byte cp.async copies
//   fill a ring of padded rows (144 B, 288 B) instead (TENSOR_MAPS =
//   false takes that path everywhere).  With 16-byte cp.async, issuing
//   the copies held block 0 for 2.6 us before its first stages were
//   requested, and per-row bulk copies (one warp asking for ~86 rows a
//   stage) were slower still; the tensor maps take one instruction a box.
// - Epilogue from the C fragments (rows group, group+8; columns 2*tig,
//   2*tig+1): masked rows become NEG_BIG; block max per glimpse (warp
//   shuffles, one exchange); the exponentials once, kept in registers (or
//   written over the logits parked in att when V spans several tiles);
//   block sums; att = e / sum, clamped at 1e-30 so a fully masked sample
//   gives exact zeros, both glimpses of an (i, qa) as one float2.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, cold L2 (chip_smoke.py):
// 17.5 us a single call and 13.6 us back to back at B=128, 26.4 and 20.6
// us at B=256, 3.3x and 2.5x the bound (a single call's floor is 5.0 us);
// the CUDA-core instance took 34.8 and 54.2 us in the same run.  104-128
// registers, no spills; 73 KB of ring at QA = 36, two blocks an SM.  The
// timeline of block 0 at B=128 (python3 -m vqatpu_torch.kernels.probe):
// the first three stages requested by 1.6 us, the chunks landing mostly
// 0.6 us apart (18 KB a stage: about an SM's share of the card's bytes a
// second), each chunk's MMAs 0.3-0.5 us, the loop done at 9.4 us, the
// epilogue 2.3 us.  With the cp.async ring the first stages took 2.6 us
// to request and the kernel 17.8 us (14.1 against 16.4 us at B=1).
// What is left is bytes in flight: one block an SM at B=128 keeps three
// 18 KB stages in flight, and the epilogue waits for the last of them; a
// 6-stage ring measured no faster (18.2 us), nor 12 warps (17.7 us).
//
// Needs RX % (16 / sizeof(T)) == 0 (4 f32, 8 bf16) and 16-byte aligned v_r
// and tqa (the 16-byte copies), and QA <= 256; the entry points refuse
// anything else.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16 operands on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int MKC = 64;            // RX columns per ring stage: 128-byte rows
constexpr int MSTAGES = 4;         // ring depth
constexpr int NT = 6;              // n8 tiles of a warp
constexpr int MAX_WARPS = 16;
constexpr int MAX_MT = 4;          // m16 tiles of a V tile: <= 64 rows
constexpr bool TENSOR_MAPS = true; // TMA where tqa's glimpse group is contiguous

// Shared rows of the 16-byte cp.async ring, in bf16, padded: a v_r row
// (144 B, so ldmatrix's eight row addresses fall in eight different 16-byte
// bank groups) and a tqa row of one qa (GG = 2: 288 B, so the four rows a
// half-warp reads as 8-byte words cover the 32 banks once; GG = 1: 144 B).
// The TMA ring has unpadded 128-byte rows, swizzled instead (below).
__host__ __device__ constexpr int mvrow() { return MKC + 8; }
__host__ __device__ constexpr int mwrow(int gg) { return gg == 2 ? 2 * MKC + 16 : MKC + 8; }

struct MmaTiling {
  int gg, ng, mt, threads;  // glimpses, n groups, m16 tiles, threads
  bool tma;                 // the ring filled by tensor-map copies
  size_t smem;              // bytes of the ring
};

// warps = mt x ng: warp (wm, wn) owns the V tile's m16 tile wm and the n8
// tiles [wn * NT, wn * NT + NT) of the QAP/8 * GG tiles; a tile is 8 qa of
// one glimpse, the two glimpses of a qa block side by side
MmaTiling mma_tiling(int QA, int G) {
  MmaTiling t;
  t.gg = glimpse_group(QA, G);
  t.tma = TENSOR_MAPS && t.gg == G;
  const int qap = (QA + 7) / 8 * 8;
  t.ng = (qap / 8 * t.gg + NT - 1) / NT;
  t.mt = MAX_WARPS / t.ng < MAX_MT ? MAX_WARPS / t.ng : MAX_MT;
  t.threads = 32 * t.mt * t.ng;
  t.smem = t.tma ? MSTAGES * (size_t)(t.mt * 16 + t.gg * qap) * MKC * sizeof(bf16) + 1024
                 : MSTAGES * ((size_t)t.mt * 16 * mvrow() + (size_t)qap * mwrow(t.gg)) *
                       sizeof(bf16);
  return t;
}

template <int GG, bool CONTIG>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
rank_softmax_mma_kernel(const bf16* __restrict__ v_r, const bf16* __restrict__ tqa,
                        const unsigned char* __restrict__ mask,
                        float* __restrict__ att, int V, int RX, int QA, int G,
                        int MT, const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap tmap) {
  constexpr int WROW = mwrow(GG);
  constexpr int VROW = mvrow();
  constexpr int U = 8;  // bf16 of a 16-byte copy
  constexpr bool TMA = CONTIG && TENSOR_MAPS;
  extern __shared__ float4 ring4[];
  __shared__ float red_m[MAX_WARPS][GG];
  __shared__ float red_s[MAX_WARPS][GG];
  __shared__ alignas(8) unsigned long long full[MSTAGES];

  // the 128-byte swizzle repeats every 1024 bytes: the TMA ring starts on
  // such a boundary (its size has 1024 bytes to spare)
  bf16* ring = reinterpret_cast<bf16*>(ring4);
  if constexpr (TMA)
    ring += (1024 - (unsigned)__cvta_generic_to_shared(ring4) % 1024) % 1024 / sizeof(bf16);

  const int b = blockIdx.x;
  const int g0 = blockIdx.y * GG;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int group = lane / 4, tig = lane % 4;
  const int wm = warp % MT, wn = warp / MT;
  const int VT = MT * 16;
  const int QAP = (QA + 7) / 8 * 8;
  const int w_stage = TMA ? GG * QAP * MKC : QAP * WROW;
  const int stage = w_stage + VT * (TMA ? MKC : VROW);

  const bf16* vb = v_r + (size_t)b * V * RX;
  const bf16* tb = tqa + (size_t)b * QA * RX * G;
  const unsigned char* mb = mask + (size_t)b * V;
  float* ob = att + (size_t)b * V * QA * G;
  const int n_tiles = (V + VT - 1) / VT;
  const int n_chunks = (RX + MKC - 1) / MKC;

  // Where element (row r, column c) of a stage's tiles lies.  TMA rows are
  // 128 bytes with the 16-byte chunks of row r permuted by chunk ^ (r % 8)
  // (CU_TENSOR_MAP_SWIZZLE_128B), so ldmatrix's eight rows and a warp's
  // 4-byte reads fall in different banks; tqa's GG = 2 rows (64 k of two
  // glimpses) come as two boxes of 32 k.  With the swizzle, column n of an
  // n8 tile is qa 2*(n%4) + n/4 of its block, so that the four rows a
  // half-warp reads as 8-byte words fall in different chunks too.
  auto a_at = [&](const bf16* vs, int r, int c) {
    return TMA ? vs + r * MKC + ((c / 8 ^ r % 8) * 8 + c % 8) : vs + r * VROW + c;
  };
  auto b_at = [&](const bf16* ws, int qa, int k) {  // (qa, k, glimpse 0)
    if constexpr (!TMA) return ws + qa * WROW + k * GG;
    const int kh = GG == 2 ? k % 32 : k;
    const bf16* base = ws + (GG == 2 ? k / 32 * QAP * MKC : 0) + qa * MKC;
    return base + ((kh * GG / 8 ^ qa % 8) * 8 + kh * GG % 8);
  };
  auto col = [](int n) { return TMA && GG == 2 ? n % 4 * 2 + n / 4 : n; };

  if constexpr (TMA) {
    if (tid == 0) {
      for (int s = 0; s < MSTAGES; ++s) mbar_init(&full[s], 1);
      fence_barrier_init();
    }
  }

  // chunk `it` (tile it / n_chunks, RX columns from k0) of tqa (QA rows of
  // MKC*GG bf16) and of v_r (the tile's rows) into ring slot it % MSTAGES,
  // zero past QA, RX and V.  TMA: one thread asks for the stage's boxes
  // (one of v_r, GG of tqa), whose bytes the slot's mbarrier counts; the
  // copies fill what lies out of bounds with zeros.  Otherwise 16-byte
  // cp.async (4-byte, or one bf16 through registers, where the glimpse
  // group is not contiguous).
  auto load = [&](int it) {
    bf16* ws = ring + (it % MSTAGES) * stage;
    bf16* vs = ws + w_stage;
    const int i0 = it / n_chunks * VT;
    const int k0 = it % n_chunks * MKC;
    if constexpr (TMA) {
      if (tid != 0) return;
      unsigned long long* bar = &full[it % MSTAGES];
      fence_proxy_async();  // the slot's last reads came before this
      mbar_arrive_expect_tx(bar, (unsigned)(stage * sizeof(bf16)));
      tma_load_3d(vs, &vmap, k0, i0, b, bar);
#pragma unroll
      for (int h = 0; h < GG; ++h)
        tma_load_3d(ws + h * QAP * MKC, &tmap, k0 * GG + h * MKC, 0, b, bar);
    } else {
      if constexpr (CONTIG) {
        constexpr int UPR = MKC * GG / U;
        for (int u = tid; u < QAP * UPR; u += nthreads) {
          const int qa = u / UPR, cu = u % UPR;
          const bool ok = qa < QA && k0 + cu * U / GG < RX;
          cp_async<16>(ws + qa * WROW + cu * U,
                       ok ? tb + ((size_t)qa * RX + k0) * G + cu * U : tb, ok);
        }
      } else {
        for (int u = tid; u < QAP * MKC; u += nthreads) {
          const int qa = u / MKC, kk = u % MKC;
          const bool ok = qa < QA && k0 + kk < RX;
          if constexpr (GG == 2) {
            cp_async<4>(ws + qa * WROW + kk * GG,
                        ok ? tb + ((size_t)qa * RX + k0 + kk) * G + g0 : tb, ok);
          } else {  // one bf16: through registers
            ws[qa * WROW + kk] = ok ? tb[((size_t)qa * RX + k0 + kk) * G + g0]
                                    : __float2bfloat16_rn(0.f);
          }
        }
      }
      constexpr int VU = MKC / U;
      for (int u = tid; u < VT * VU; u += nthreads) {
        const int r = u / VU, cu = u % VU;
        const bool ok = i0 + r < V && k0 + cu * U < RX;
        cp_async<16>(vs + r * VROW + cu * U,
                     ok ? vb + (size_t)(i0 + r) * RX + k0 + cu * U : vb, ok);
      }
    }
  };

  float run_m[GG];
#pragma unroll
  for (int g = 0; g < GG; ++g) run_m[g] = -INFINITY;
  float acc[NT][4];
  bool keep_r[2];  // the thread's two rows of the C fragment are kept

  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = t * VT;
    const int it0 = t * n_chunks;
    const int ia = i0 + wm * 16 + group;
    const bool in_r[2] = {ia < V, ia + 8 < V};
    keep_r[0] = in_r[0] && mb[ia] != 0;
    keep_r[1] = in_r[1] && mb[ia + 8] != 0;

#pragma unroll
    for (int s = 0; s < NT; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][e] = 0.f;

    __syncthreads();  // the previous tile is done with the ring
#pragma unroll
    for (int c = 0; c < MSTAGES - 1; ++c) {
      if (c < n_chunks) load(it0 + c);
      if constexpr (!TMA) cp_async_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int it = it0 + c;
      if constexpr (TMA) {
        mbar_wait(&full[it % MSTAGES], (unsigned)(it / MSTAGES) & 1u);
        __syncthreads();  // slot (it-1) % MSTAGES is free
      } else {
        cp_async_wait<MSTAGES - 2>();
        __syncthreads();  // chunk c has landed; slot (it-1) % MSTAGES is free
      }
      if (c + MSTAGES - 1 < n_chunks) load(it + MSTAGES - 1);
      if constexpr (!TMA) cp_async_commit();
      const bf16* ws = ring + (it % MSTAGES) * stage;
      const bf16* vs = ws + w_stage;
      // Every warp multiplies NT tiles with no branch on QA: tiles past
      // the last qa block read its rows again, and their columns are never
      // used.  A whole chunk runs with no branch at all, so the reads of
      // one 16-column step can be issued ahead of the last one's products;
      // where the chunk ends 8 columns into a step (RX is a multiple of 8)
      // the A and B registers of the upper 8 are zeroed (the ring holds
      // zeros there already, from either copy).
      auto step = [&](int kk, bool half) {
        unsigned a[4];
        ldmatrix_x4(a, a_at(vs, wm * 16 + (lane & 15), kk + (lane >> 4) * 8));
        if (half) a[2] = a[3] = 0u;
        if constexpr (GG == 2) {
          // one 8-byte read: (k, g0) (k, g1) (k+1, g0) (k+1, g1) of one
          // qa; two byte permutes make the (k, k+1) pairs of both
          // glimpses, the B fragments of two n8 tiles
          uint2 lo[NT / 2], hi[NT / 2];
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            const int qb = min((wn * NT + 2 * p) / 2, QAP / 8 - 1);
            const int qa = qb * 8 + col(group);
            lo[p] = *reinterpret_cast<const uint2*>(b_at(ws, qa, kk + 2 * tig));
            hi[p] = half ? make_uint2(0u, 0u)
                         : *reinterpret_cast<const uint2*>(b_at(ws, qa, kk + 8 + 2 * tig));
          }
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            mma_bf16(acc[2 * p], a, __byte_perm(lo[p].x, lo[p].y, 0x5410),
                     __byte_perm(hi[p].x, hi[p].y, 0x5410));
            mma_bf16(acc[2 * p + 1], a, __byte_perm(lo[p].x, lo[p].y, 0x7632),
                     __byte_perm(hi[p].x, hi[p].y, 0x7632));
          }
        } else {
          // the rows are k-contiguous: each B register is one 4-byte read
          unsigned b0[NT], b1[NT];
#pragma unroll
          for (int s = 0; s < NT; ++s) {
            const int qa = min(wn * NT + s, QAP / 8 - 1) * 8 + group;
            b0[s] = *reinterpret_cast<const unsigned*>(b_at(ws, qa, kk + 2 * tig));
            b1[s] = half ? 0u
                         : *reinterpret_cast<const unsigned*>(b_at(ws, qa, kk + 8 + 2 * tig));
          }
#pragma unroll
          for (int s = 0; s < NT; ++s) mma_bf16(acc[s], a, b0[s], b1[s]);
        }
      };
      const int cols = RX - c * MKC;
      if (cols >= MKC) {
#pragma unroll
        for (int kk = 0; kk < MKC; kk += 16) step(kk, false);
      } else {
        for (int kk = 0; kk < cols; kk += 16) step(kk, kk + 8 >= cols);
      }
    }

    // The C fragment: acc[s][e] is row ia + 8*(e/2), qa (tile/GG)*8 +
    // col(2*tig + e%2), glimpse g0 + s%GG, for tile wn*NT + s.  Only rows
    // below V and qa below QA are read from here on, so the padding's
    // values never reach att.  Masked rows become NEG_BIG; the thread's
    // max per glimpse; with more than one V tile the masked logits are
    // parked in att.
#pragma unroll
    for (int s = 0; s < NT; ++s) {
      const int tile = wn * NT + s;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qa = tile / GG * 8 + col(2 * tig + e % 2);
        if (!in_r[e / 2] || qa >= QA) continue;
        if (!keep_r[e / 2]) acc[s][e] = NEG_BIG;
        run_m[s % GG] = fmaxf(run_m[s % GG], acc[s][e]);
        if (n_tiles > 1)
          ob[((size_t)(ia + 8 * (e / 2)) * QA + qa) * G + g0 + s % GG] = acc[s][e];
      }
    }
  }

  // block max per glimpse: warp shuffles, then every thread over the warps
  const int n_warps = nthreads / 32;
#pragma unroll
  for (int g = 0; g < GG; ++g) {
    for (int off = 16; off > 0; off >>= 1)
      run_m[g] = fmaxf(run_m[g], __shfl_xor_sync(0xffffffffu, run_m[g], off));
    if (lane == 0) red_m[warp][g] = run_m[g];
  }
  __syncthreads();
  float m[GG], sum[GG];
#pragma unroll
  for (int g = 0; g < GG; ++g) {
    m[g] = red_m[0][g];
#pragma unroll
    for (int w = 1; w < MAX_WARPS; ++w)
      if (w < n_warps) m[g] = fmaxf(m[g], red_m[w][g]);
    sum[g] = 0.f;
  }

  // the exponentials, once: kept in acc (one V tile: the thread's rows'
  // flags are still in registers) or written over the parked logits; the
  // thread's sums.  __expf (ex2.approx): its few ulp of error on
  // arguments <= 0 stay far below K1's 1e-5 tolerance, and the accurate
  // expf took 1 us more of the epilogue (probe)
  if (n_tiles == 1) {
#pragma unroll
    for (int s = 0; s < NT; ++s) {
      const int tile = wn * NT + s;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qa = tile / GG * 8 + col(2 * tig + e % 2);
        const float y = keep_r[e / 2] && qa < QA ? __expf(acc[s][e] - m[s % GG]) : 0.f;
        acc[s][e] = y;
        sum[s % GG] += y;
      }
    }
  } else {
    for (int t = 0; t < n_tiles; ++t) {
      const int ia = t * VT + wm * 16 + group;
#pragma unroll
      for (int s = 0; s < NT; ++s) {
        const int tile = wn * NT + s;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = ia + 8 * (e / 2);
          const int qa = tile / GG * 8 + col(2 * tig + e % 2);
          if (i >= V || qa >= QA) continue;
          float* o = ob + ((size_t)i * QA + qa) * G + g0 + s % GG;
          const float y = mb[i] != 0 ? __expf(*o - m[s % GG]) : 0.f;
          sum[s % GG] += y;
          *o = y;
        }
      }
    }
  }

  // block sum per glimpse, the same way
#pragma unroll
  for (int g = 0; g < GG; ++g) {
    for (int off = 16; off > 0; off >>= 1)
      sum[g] += __shfl_xor_sync(0xffffffffu, sum[g], off);
    if (lane == 0) red_s[warp][g] = sum[g];
  }
  __syncthreads();
  float inv[GG];
#pragma unroll
  for (int g = 0; g < GG; ++g) {
    float den = red_s[0][g];
#pragma unroll
    for (int w = 1; w < MAX_WARPS; ++w)
      if (w < n_warps) den += red_s[w][g];
    inv[g] = 1.f / fmaxf(den, 1e-30f);
  }

  // normalise; GG = 2 writes the two glimpses of one (i, qa) as one float2
  // (G is even, so the pair is 8-byte aligned)
  for (int t = 0; t < n_tiles; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = t * VT + wm * 16 + group + 8 * h;
      if (i >= V) continue;
      float* orow = ob + (size_t)i * QA * G + g0;
#pragma unroll
      for (int s = 0; s < NT; s += GG) {
        const int tile = wn * NT + s;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qa = tile / GG * 8 + col(2 * tig + c);
          if (qa >= QA) continue;
          float* o = orow + qa * G;
          float y[GG];
#pragma unroll
          for (int g = 0; g < GG; ++g)
            y[g] = (n_tiles == 1 ? acc[s + g][2 * h + c] : o[g]) * inv[g];
          if constexpr (GG == 2) {
            *reinterpret_cast<float2*>(o) = make_float2(y[0], y[1]);
          } else {
            o[0] = y[0];
          }
        }
      }
    }
  }
}

template <int GG, bool CONTIG>
cudaError_t launch_mma(const MmaTiling& t, dim3 grid, cudaStream_t stream,
                       int device, const bf16* v_r, const bf16* tqa,
                       const unsigned char* mask, float* att, int V, int RX,
                       int QA, int G, const CUtensorMap& vmap,
                       const CUtensorMap& tmap) {
  // the ring can exceed the 48 KB default: allow, per device, the most
  // this instance has been asked for
  constexpr int MAX_DEVICES = 64;
  static size_t raised[MAX_DEVICES] = {};
  auto kernel = rank_softmax_mma_kernel<GG, CONTIG>;
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (t.smem > raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.smem);
    if (err != cudaSuccess) return err;
    raised[device] = t.smem;
  }
  kernel<<<grid, t.threads, t.smem, stream>>>(v_r, tqa, mask, att, V, RX, QA, G,
                                              t.mt, vmap, tmap);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (so the
// library needs no -lcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  return encode;
}

// A [n2][n1][n0] bf16 tensor in boxes of [1][rows][MKC], 128-byte swizzled,
// zero out of bounds
bool tensor_map(CUtensorMap* map, const bf16* base, cuuint64_t n0, cuuint64_t n1,
                cuuint64_t n2, cuuint32_t rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {n0, n1, n2};
  const cuuint64_t strides[2] = {n0 * sizeof(bf16), n0 * n1 * sizeof(bf16)};
  const cuuint32_t box[3] = {MKC, rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(base),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int forward_mma(const bf16* v_r, const bf16* tqa, const unsigned char* mask,
                float* att, int B, int V, int RX, int QA, int G, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (QA < 1 || QA > MAX_QA || RX % unit<bf16>() != 0 ||
      ((uintptr_t)v_r | (uintptr_t)tqa) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || V == 0 || G == 0) return 0;
  const MmaTiling t = mma_tiling(QA, G);
  const dim3 grid(B, G / t.gg);
  CUtensorMap vmap = {}, tmap = {};
  if (t.tma && !(tensor_map(&vmap, v_r, RX, V, B, t.mt * 16) &&
                 tensor_map(&tmap, tqa, (cuuint64_t)RX * G, QA, B, (QA + 7) / 8 * 8)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (t.gg == 2)
    err = G == 2 ? launch_mma<2, true>(t, grid, s, device, v_r, tqa, mask, att,
                                       V, RX, QA, G, vmap, tmap)
                 : launch_mma<2, false>(t, grid, s, device, v_r, tqa, mask, att,
                                        V, RX, QA, G, vmap, tmap);
  else
    err = G == 1 ? launch_mma<1, true>(t, grid, s, device, v_r, tqa, mask, att,
                                       V, RX, QA, G, vmap, tmap)
                 : launch_mma<1, false>(t, grid, s, device, v_r, tqa, mask, att,
                                        V, RX, QA, G, vmap, tmap);
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
  return forward_mma(v_r, tqa, mask, att, B, V, RX, QA, G, device, stream);
}
