// Masked softmax over (V, Q, A) per glimpse, and its backward.
//
// `masked_softmax_vqa_forward` replaces the Pallas kernel
// `masked_softmax_vqa_pallas` (vqatpu/kernels/trilinear.py:207-224, body
// `_softmax_kernel` :192-204):
//
//   att[b,i,j,l,g] = softmax over all (i,j,l) of logits[b,i,j,l,g]
//
// with masked boxes set to -1e30 and then multiplied by the mask, and the
// denominator clamped at 1e-30, so a fully masked sample comes out as zeros
// and never as NaN (:197-203).
//
// `softmax_vqa_backward` is the VJP of that softmax, and of K1's
// (`_softmax_bwd` :237-240, the first step of `_rank_softmax_bwd` :320-321):
//
//   dl[b,i,j,l,g] = att * (g - sum over (i,j,l) of g * att)
//
// Masked entries have att == 0, so their dl is 0.
//
// Layouts: logits, att, g and dl are the model's [B,V,QA,G] (QA = Q*A),
// contiguous, read and written in place with stride G: the JAX wrapper's
// transposes to [B,G,V,QA] (:210, :224) have no counterpart here.  mask is
// [B,V] bool.
//
// What bounds them on the H100: bytes.  At B=256, V=50, QA=36, G=2 the
// forward must read the logits (3.7 MB) and write att (3.7 MB): ~2.2 us at
// 3.35 TB/s.  The backward reads att and g and writes dl, 11.1 MB: ~3.3 us.
// Their operations (a few per element) are far below the bytes.
//
// Design: one block per (b, g), 256 threads, a grid-stride loop over the
// V*QA elements of the slice, so any V works (V = 2048 boxes is one loop of
// 288 elements per thread).  The forward keeps a running max and sum per
// thread (online softmax), combines them across the block with warp
// shuffles, and then makes a second pass that rereads the logits (from L2
// at these sizes) and writes att.  The backward makes one pass for the dot
// product and one for dl.  Reads are strided by G, so each 32-byte sector
// serves the G blocks of one sample; the other glimpse's block finds the
// sector in L2.  A block per sample reading all G glimpses at once would
// read each sector once; that is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// (m, s) <- the running max and sum of two partial softmax reductions
__device__ __forceinline__ void combine(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both partials empty
  s = s * expf(m - mx) + s2 * expf(m2 - mx);
  m = mx;
}

__global__ void __launch_bounds__(THREADS)
masked_softmax_kernel(const float* __restrict__ logits,
                      const unsigned char* __restrict__ mask,
                      float* __restrict__ att, int V, int QA, int G) {
  __shared__ float red_m[WARPS];
  __shared__ float red_s[WARPS];
  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int tid = threadIdx.x;
  const long long n = (long long)V * QA;
  const float* lb = logits + (size_t)b * n * G + g;
  float* ob = att + (size_t)b * n * G + g;
  const unsigned char* mb = mask + (size_t)b * V;

  // masked entries are -1e30 with exp * 0: they add nothing to the sum, and
  // to the max only where the whole slice is masked, which gives zeros
  // either way
  float run_m = -INFINITY, run_s = 0.f;
  for (long long idx = tid; idx < n; idx += THREADS) {
    if (!mb[idx / QA]) continue;
    const float x = lb[idx * G];
    if (x > run_m) {
      run_s *= expf(run_m - x);
      run_m = x;
    }
    run_s += expf(x - run_m);
  }

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
    float m = lane < WARPS ? red_m[lane] : -INFINITY;
    float s = lane < WARPS ? red_s[lane] : 0.f;
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

  for (long long idx = tid; idx < n; idx += THREADS)
    ob[idx * G] = mb[idx / QA] ? expf(lb[idx * G] - m) / den : 0.f;
}

__global__ void __launch_bounds__(THREADS)
softmax_backward_kernel(const float* __restrict__ att,
                        const float* __restrict__ grad,
                        float* __restrict__ dl, int V, int QA, int G) {
  __shared__ float red[WARPS];
  const int b = blockIdx.x / G;
  const int g = blockIdx.x % G;
  const int tid = threadIdx.x;
  const long long n = (long long)V * QA;
  const size_t base = (size_t)b * n * G + g;
  const float* ab = att + base;
  const float* gb = grad + base;
  float* db = dl + base;

  float dot = 0.f;
  for (long long idx = tid; idx < n; idx += THREADS)
    dot = fmaf(gb[idx * G], ab[idx * G], dot);
  for (int off = 16; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) red[warp] = dot;
  __syncthreads();
  if (warp == 0) {
    float s = lane < WARPS ? red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) red[0] = s;
  }
  __syncthreads();
  dot = red[0];

  for (long long idx = tid; idx < n; idx += THREADS) {
    const float a = ab[idx * G];
    db[idx * G] = a * (gb[idx * G] - dot);
  }
}

}  // namespace

extern "C" int masked_softmax_vqa_forward(const float* logits,
                                          const unsigned char* mask,
                                          float* att, int B, int V, int QA,
                                          int G, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (QA < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || V == 0 || G == 0) return 0;
  masked_softmax_kernel<<<B * G, THREADS, 0, (cudaStream_t)stream>>>(
      logits, mask, att, V, QA, G);
  return (int)cudaGetLastError();
}

extern "C" int softmax_vqa_backward(const float* att, const float* grad,
                                    float* dl, int B, int V, int QA, int G,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (QA < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || V == 0 || G == 0) return 0;
  softmax_backward_kernel<<<B * G, THREADS, 0, (cudaStream_t)stream>>>(
      att, grad, dl, V, QA, G);
  return (int)cudaGetLastError();
}
