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
// Q=12, A=3, D=1024 it must read vt (26.2 MB) and qt (6.3 MB), ~35.5 MB in
// all with at, w and out: ~10.6 us at 3.35 TB/s.  Its 0.47 GFLOP would take
// ~7 us on the f32 CUDA cores.
//
// Design: grid (B, D/256), one thread per d, so every load of vt, qt and at
// is coalesced across d and each is read exactly once.  qt[b,:,d] and
// at[b,:,d] stay in registers; w[b] is shared by all d and is staged in
// shared memory in V tiles (32 KB each; the whole w[b] does not fit at
// V = 2048).  Each thread accumulates sum_l at * sum_i vt * sum_j w * qt in
// f32.  The Q and A loops are unrolled to a compile-time bound (12x3, the
// model's, or 32x8) so the registers stay registers.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int W_TILE = 8192;  // floats of w staged per V tile

template <int MQ, int MA>
__global__ void __launch_bounds__(THREADS)
tri_pool_kernel(const float* __restrict__ vt, const float* __restrict__ qt,
                const float* __restrict__ at, const float* __restrict__ w,
                long long w_sb, long long w_sv, long long w_sq, long long w_sa,
                float* __restrict__ out, int V, int Q, int A, int D, int VT) {
  __shared__ float w_s[W_TILE];
  const int b = blockIdx.x;
  const int d = blockIdx.y * THREADS + threadIdx.x;
  const bool active = d < D;
  const int QA = Q * A;

  float q[MQ];
  float acc[MA];
#pragma unroll
  for (int j = 0; j < MQ; ++j)
    q[j] = (active && j < Q) ? qt[((size_t)b * Q + j) * D + d] : 0.f;
#pragma unroll
  for (int l = 0; l < MA; ++l) acc[l] = 0.f;

  const float* wb = w + b * w_sb;
  const float* vb = vt + (size_t)b * V * D;
  for (int i0 = 0; i0 < V; i0 += VT) {
    const int rows = min(VT, V - i0);
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < rows * QA; idx += THREADS) {
      const int ii = idx / QA, r = idx % QA;
      w_s[idx] = wb[(i0 + ii) * w_sv + (r / A) * w_sq + (r % A) * w_sa];
    }
    __syncthreads();
    if (active) {
      for (int ii = 0; ii < rows; ++ii) {
        const float vi = vb[(size_t)(i0 + ii) * D + d];
        const float* wr = w_s + ii * QA;
#pragma unroll
        for (int l = 0; l < MA; ++l) {
          if (l < A) {
            float z = 0.f;
#pragma unroll
            for (int j = 0; j < MQ; ++j)
              if (j < Q) z = fmaf(wr[j * A + l], q[j], z);
            acc[l] = fmaf(vi, z, acc[l]);
          }
        }
      }
    }
  }
  if (active) {
    float o = 0.f;
#pragma unroll
    for (int l = 0; l < MA; ++l)
      if (l < A) o = fmaf(at[((size_t)b * A + l) * D + d], acc[l], o);
    out[(size_t)b * D + d] = o;
  }
}

}  // namespace

extern "C" int tri_pool_forward(const float* vt, const float* qt,
                                const float* at, const float* w,
                                long long w_sb, long long w_sv, long long w_sq,
                                long long w_sa, float* out, int B, int V,
                                int Q, int A, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Q > 32 || A > 8 || Q * A < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || D == 0) return 0;
  const int vt_rows = max(1, W_TILE / (Q * A));
  const dim3 grid(B, (D + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (Q <= 12 && A <= 3)
    tri_pool_kernel<12, 3><<<grid, THREADS, 0, s>>>(
        vt, qt, at, w, w_sb, w_sv, w_sq, w_sa, out, V, Q, A, D, vt_rows);
  else
    tri_pool_kernel<32, 8><<<grid, THREADS, 0, s>>>(
        vt, qt, at, w, w_sb, w_sv, w_sq, w_sa, out, V, Q, A, D, vt_rows);
  return (int)cudaGetLastError();
}
