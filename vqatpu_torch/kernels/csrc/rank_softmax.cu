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
// What bounds it on the H100: bytes.  At the serving bucket B=128, V=50,
// RX=512, QA=36, G=2 it must read v_r (13.1 MB) and tqa (18.9 MB) and write
// att (1.8 MB): ~10 us at 3.35 TB/s, against ~7 us for its 0.47 GFLOP on the
// f32 CUDA cores.
//
// Design: one block per (b, g), 256 threads.  The [RX, QA] slice of tqa for
// this g is staged through shared memory in chunks of KC rows (41 KB in all,
// under the 48 KB of static shared memory), next to a [VT, KC] tile of v_r.
// Each thread holds up to 8 logits of a [VT, QA] output tile in registers,
// so the logits never reach device memory when V fits one tile (VT = 56 at
// QA = 36; serving has V = 50).  Larger V (2048 boxes) loops over V tiles
// with a running max and sum per thread, parks the masked logits in `att`,
// and rescales them in a second pass.  The block's max and sum are combined
// with warp shuffles.  This first version keeps the GEMM on the CUDA cores;
// wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int KC = 32;           // rows of the RX axis staged per chunk
constexpr int MAX_VT = 64;       // V rows per tile
constexpr int PER_THREAD = 8;    // logits per thread: VT * QA <= 2048
constexpr int MAX_QA = 256;
constexpr float NEG_BIG = -1e30f;

// (m, s) <- the running max and sum of two partial softmax reductions
__device__ __forceinline__ void combine(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both partials empty
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

__global__ void __launch_bounds__(THREADS)
rank_softmax_kernel(const float* __restrict__ v_r, const float* __restrict__ tqa,
                    const unsigned char* __restrict__ mask, float* __restrict__ att,
                    int V, int RX, int QA, int G, int VT) {
  __shared__ float w_s[KC * (MAX_QA + 1)];
  __shared__ float v_s[MAX_VT * (KC + 1)];
  __shared__ float red_m[THREADS / 32];
  __shared__ float red_s[THREADS / 32];

  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int tid = threadIdx.x;
  const int QAP = QA + 1;  // padded row: no bank conflicts on the staging stores
  const float* vb = v_r + (size_t)b * V * RX;
  const float* tb = tqa + (size_t)b * QA * RX * G;
  const unsigned char* mb = mask + (size_t)b * V;
  float* ob = att + (size_t)b * V * QA * G;
  const int n_tiles = (V + VT - 1) / VT;

  float run_m = -INFINITY, run_s = 0.f;
  float x[PER_THREAD];
  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = t * VT;
    const int rows = min(VT, V - i0);
    float acc[PER_THREAD];
#pragma unroll
    for (int s = 0; s < PER_THREAD; ++s) acc[s] = 0.f;

    for (int k0 = 0; k0 < RX; k0 += KC) {
      const int kc = min(KC, RX - k0);
      for (int idx = tid; idx < KC * QA; idx += THREADS) {
        const int kk = idx % KC, n = idx / KC;
        w_s[kk * QAP + n] = kk < kc ? tb[((size_t)n * RX + k0 + kk) * G + g] : 0.f;
      }
      for (int idx = tid; idx < VT * KC; idx += THREADS) {
        const int ii = idx / KC, kk = idx % KC;
        v_s[ii * (KC + 1) + kk] =
            (ii < rows && kk < kc) ? vb[(size_t)(i0 + ii) * RX + k0 + kk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < PER_THREAD; ++s) {
        const int o = tid + s * THREADS;
        if (o < rows * QA) {
          const float* vrow = v_s + (o / QA) * (KC + 1);
          const float* wcol = w_s + o % QA;
          float a = acc[s];
#pragma unroll 8
          for (int kk = 0; kk < KC; ++kk) a = fmaf(vrow[kk], wcol[kk * QAP], a);
          acc[s] = a;
        }
      }
      __syncthreads();
    }

    // masked logits of this tile into the thread's running max and sum
#pragma unroll
    for (int s = 0; s < PER_THREAD; ++s) {
      const int o = tid + s * THREADS;
      if (o < rows * QA) {
        const int i = i0 + o / QA;
        const bool keep = mb[i] != 0;
        const float xv = keep ? acc[s] : NEG_BIG;
        x[s] = xv;
        if (xv > run_m) {
          run_s *= expf(run_m - xv);
          run_m = xv;
        }
        if (keep) run_s += expf(xv - run_m);
        if (n_tiles > 1) ob[((size_t)i * QA + o % QA) * G + g] = xv;
      }
    }
  }

  // block-wide max and sum: warp shuffles, then one warp over the warps
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, run_m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, run_s, off);
    combine(run_m, run_s, m2, s2);
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    red_m[warp] = run_m;
    red_s[warp] = run_s;
  }
  __syncthreads();
  if (warp == 0) {
    float m = lane < THREADS / 32 ? red_m[lane] : -INFINITY;
    float s = lane < THREADS / 32 ? red_s[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
      combine(m, s, m2, s2);
    }
    if (lane == 0) {
      red_m[0] = m;
      red_s[0] = s;
    }
  }
  __syncthreads();
  const float m = red_m[0];
  const float den = fmaxf(red_s[0], 1e-30f);

  // normalise; each thread rereads only the logits it parked itself
  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = t * VT;
    const int rows = min(VT, V - i0);
#pragma unroll
    for (int s = 0; s < PER_THREAD; ++s) {
      const int o = tid + s * THREADS;
      if (o < rows * QA) {
        const int i = i0 + o / QA;
        const size_t idx = ((size_t)i * QA + o % QA) * G + g;
        const float xv = n_tiles == 1 ? x[s] : ob[idx];
        ob[idx] = mb[i] ? expf(xv - m) / den : 0.f;
      }
    }
  }
}

}  // namespace

extern "C" int rank_softmax_forward(const float* v_r, const float* tqa,
                                    const unsigned char* mask, float* att,
                                    int B, int V, int RX, int QA, int G,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (QA < 1 || QA > MAX_QA) return (int)cudaErrorInvalidValue;
  if (B == 0 || V == 0 || G == 0) return 0;
  const int vt = max(1, min(MAX_VT, THREADS * PER_THREAD / QA));
  rank_softmax_kernel<<<B * G, THREADS, 0, (cudaStream_t)stream>>>(
      v_r, tqa, mask, att, V, RX, QA, G, vt);
  return (int)cudaGetLastError();
}
