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
// contiguous: one sample is a slice of n = V*QA*G contiguous floats, the
// glimpse of element e is e % G and its box e / (QA*G).  The JAX wrapper's
// transposes to [B,G,V,QA] (:210, :224) have no counterpart here.  mask is
// [B,V] bool.
//
// What bounds them on the H100: bytes.  At B=256, V=50, QA=36, G=2 the
// forward must read the logits (3.7 MB) and write att (3.7 MB): 2.2 us at
// 3.35 TB/s.  The backward reads att and g and writes dl, 11.1 MB: 3.3 us.
// Their operations (a few per element) are far below the bytes.
//
// Design: one block per sample, covering all G glimpses of its slice.
// - Loads are 16 bytes (a "unit" of 4 floats), neighbouring threads on
//   neighbouring units, so every 32-byte sector is read once, by one block.
//   A slice whose base is not 16-byte aligned (n not a multiple of 4, or a
//   misaligned view) has up to 3 floats before its first whole unit and up
//   to 3 after its last; threads 0..5 take those one float each.  Where the
//   tensors of one call are misaligned against each other, the kernel runs
//   on units of 1 float instead (VW = 1), with the same code.
// - The block is sized to the slice (threads_for): RES = 8 floats of each
//   input a thread (2 units), in a multiple of lcm(32, G) threads, up to
//   1024: 480 threads at full width.  A first design with 128 threads and
//   32 floats a thread left too few warps on an SM (B = 256 blocks on 132
//   SMs) to hide the latency of each thread's 32 exps and divides.
// - A thread's units lie T units apart, and T is a multiple of G, so the
//   glimpse of each of a unit's VW positions is fixed per thread and found
//   once: each thread keeps one partial per position, not per glimpse, and
//   folds them into per-glimpse partials only to reduce.  The reduction is
//   warp shuffles, one exchange of the warps' partials through shared
//   memory, shuffles in warp 0, and one broadcast of the G totals.
// - Resident path (n <= RES * 1024: V <= 113 at QA = 36, G = 2): each
//   thread issues all its loads into registers before the first use,
//   computes from them, and writes the output from them: one HBM pass, no
//   reread.
//   - backward: the G dot products, one reduction, then dl from registers.
//   - forward: the sample's V mask bytes go to shared memory once (while
//     the logits are in flight); a unit's box is one 32-bit divide per unit
//     where QA*G % 4 == 0 and the slice is aligned, per float otherwise.
//     Per glimpse the max from registers, then exp(x - m) once per element,
//     held in registers, then the sum, then the store scaled by one
//     reciprocal of the clamped sum per glimpse.
// - Looped path (larger slices, e.g. V = 2048): 1024 threads (960 at G = 3)
//   loop over the same units with 32-bit indices; the backward rereads att
//   and g for dl, the forward keeps a running max and sum per position and
//   rereads the logits for att (the second pass is served from L2 at these
//   sizes).
// The holdbacks of the earlier design (a block per (b, g) reading with
// stride G, two passes from L2, a 64-bit divide per element for the mask,
// short dependent loops of 4-byte loads) are each gone on the resident
// path.  Slices of more than 2^31 - 1 floats are refused.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int MAX_G = 8;            // glimpses; the wrapper raises beyond
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int RES = 8;              // floats of each input a thread holds

// Threads of a block for slices of n floats at G glimpses: a multiple of
// lcm(32, G), enough for RES floats a thread where that fits in
// MAX_THREADS (`resident`), else as many as fit.
int threads_for(int n, int G, bool& resident) {
  int a = G, b = 32;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  const int step = 32 * (G / a);  // lcm(32, G)
  const int most = MAX_THREADS / step * step;
  const long long need = ((long long)n + RES * step - 1) / (RES * step) * step;
  resident = need <= most;
  return resident ? (int)need : most;
}

template <int VW>
struct Pack {
  float v[VW];
};

template <int VW>
__device__ __forceinline__ Pack<VW> load_pack(const float* p);
template <>
__device__ __forceinline__ Pack<4> load_pack<4>(const float* p) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  return {{t.x, t.y, t.z, t.w}};
}
template <>
__device__ __forceinline__ Pack<1> load_pack<1>(const float* p) {
  return {{__ldg(p)}};
}

template <int VW>
__device__ __forceinline__ void store_pack(float* p, const Pack<VW>& x);
template <>
__device__ __forceinline__ void store_pack<4>(float* p, const Pack<4>& x) {
  *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
}
template <>
__device__ __forceinline__ void store_pack<1>(float* p, const Pack<1>& x) {
  *p = x.v[0];
}

// One sample's slice of n floats starting at `p`: `head` floats before the
// first 16-byte-aligned unit, `units` whole units of VW floats, then the
// tail.  `edge` is the float that thread `t` takes outside the units, or -1.
template <int VW>
struct Slice {
  int head, units, tail_start, edges;

  __device__ Slice(const float* p, int n) {
    head = VW == 4 ? min(n, (int)(((16 - ((size_t)p & 15)) & 15) >> 2)) : 0;
    units = (n - head) / VW;
    tail_start = head + units * VW;
    edges = head + n - tail_start;
  }
  __device__ int edge(int t) const {
    return t >= edges ? -1 : t < head ? t : tail_start + t - head;
  }
  __device__ int first(int u) const { return head + u * VW; }
};

struct Max {
  static constexpr float id = -INFINITY;
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Sum {
  static constexpr float id = 0.f;
  __device__ float operator()(float a, float b) const { return a + b; }
};

// per-glimpse totals of the block: thread partials per position `acc[j]`
// (glimpse gpos[j]) and one edge partial (glimpse eg, -1 for none) in;
// `tot[j]` (and `etot`) out, the total of each position's glimpse.  The
// scratch `red` [warps][MAX_G] and `out` [MAX_G] are this call's own.
template <int VW, class Op>
__device__ __forceinline__ void block_reduce(const float (&acc)[VW],
                                             const int (&gpos)[VW], float e,
                                             int eg, int G, Op op,
                                             float (*red)[MAX_G], float* out,
                                             float (&tot)[VW], float& etot) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int gg = 0; gg < MAX_G; ++gg) {
    if (gg >= G) break;  // uniform across the block
    float v = eg == gg ? e : Op::id;
#pragma unroll
    for (int j = 0; j < VW; ++j)
      if (gpos[j] == gg) v = op(v, acc[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[warp][gg] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int gg = 0; gg < MAX_G; ++gg) {
      if (gg >= G) break;
      float v = lane < warps ? red[lane][gg] : Op::id;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) out[gg] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < VW; ++j) tot[j] = out[gpos[j]];
  etot = eg >= 0 ? out[eg] : Op::id;
}

// the glimpse of each position of this thread's units
template <int VW>
__device__ __forceinline__ void positions(int (&gpos)[VW], int head, int G) {
#pragma unroll
  for (int j = 0; j < VW; ++j) gpos[j] = (head + VW * threadIdx.x + j) % G;
}

template <int VW, bool RESIDENT>
__global__ void __launch_bounds__(MAX_THREADS)
softmax_backward_kernel(const float* __restrict__ att,
                        const float* __restrict__ grad,
                        float* __restrict__ dl, int n, int G) {
  __shared__ float red[MAX_WARPS][MAX_G];
  __shared__ float out[MAX_G];
  const size_t off = (size_t)blockIdx.x * n;
  const float* a = att + off;
  const float* g = grad + off;
  float* d = dl + off;
  const Slice<VW> s(a, n);
  const int tid = threadIdx.x, T = blockDim.x;
  int gpos[VW];
  positions(gpos, s.head, G);
  const int ee = s.edge(tid);
  const int eg = ee >= 0 ? ee % G : -1;
  float ea = 0.f, egr = 0.f;
  if (ee >= 0) {
    ea = a[ee];
    egr = g[ee];
  }

  float acc[VW], dot[VW], edot;
#pragma unroll
  for (int j = 0; j < VW; ++j) acc[j] = 0.f;
  if constexpr (RESIDENT) {
    constexpr int UPT = RES / VW;
    Pack<VW> pa[UPT], pg[UPT];
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = tid + i * T;
      if (u < s.units) {
        pa[i] = load_pack<VW>(a + s.first(u));
        pg[i] = load_pack<VW>(g + s.first(u));
      } else {
#pragma unroll
        for (int j = 0; j < VW; ++j) pa[i].v[j] = pg[i].v[j] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < UPT; ++i)
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[j] = fmaf(pg[i].v[j], pa[i].v[j], acc[j]);
    block_reduce(acc, gpos, ea * egr, eg, G, Sum(), red, out, dot, edot);
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = tid + i * T;
      if (u < s.units) {
        Pack<VW> o;
#pragma unroll
        for (int j = 0; j < VW; ++j) o.v[j] = pa[i].v[j] * (pg[i].v[j] - dot[j]);
        store_pack<VW>(d + s.first(u), o);
      }
    }
  } else {
#pragma unroll 4
    for (int u = tid; u < s.units; u += T) {
      const Pack<VW> xa = load_pack<VW>(a + s.first(u));
      const Pack<VW> xg = load_pack<VW>(g + s.first(u));
#pragma unroll
      for (int j = 0; j < VW; ++j) acc[j] = fmaf(xg.v[j], xa.v[j], acc[j]);
    }
    block_reduce(acc, gpos, ea * egr, eg, G, Sum(), red, out, dot, edot);
#pragma unroll 4
    for (int u = tid; u < s.units; u += T) {
      const Pack<VW> xa = load_pack<VW>(a + s.first(u));
      const Pack<VW> xg = load_pack<VW>(g + s.first(u));
      Pack<VW> o;
#pragma unroll
      for (int j = 0; j < VW; ++j) o.v[j] = xa.v[j] * (xg.v[j] - dot[j]);
      store_pack<VW>(d + s.first(u), o);
    }
  }
  if (ee >= 0) d[ee] = ea * (egr - edot);
}

// which of a unit's VW floats (first float e0) lie in real boxes, as bits;
// `box_mask(box)` reads the mask.  One divide per unit where its floats
// share a box (`whole`), one per float otherwise.
template <int VW, class M>
__device__ __forceinline__ unsigned keep_bits(int e0, int qag, bool whole,
                                              M box_mask) {
  if (whole) return box_mask((unsigned)e0 / (unsigned)qag) ? (1u << VW) - 1 : 0u;
  unsigned k = 0;
#pragma unroll
  for (int j = 0; j < VW; ++j)
    if (box_mask((unsigned)(e0 + j) / (unsigned)qag)) k |= 1u << j;
  return k;
}

template <int VW, bool RESIDENT>
__global__ void __launch_bounds__(MAX_THREADS)
masked_softmax_kernel(const float* __restrict__ logits,
                      const unsigned char* __restrict__ mask,
                      float* __restrict__ att, int n, int V, int qag, int G) {
  __shared__ float red_m[MAX_WARPS][MAX_G], out_m[MAX_G];
  __shared__ float red_s[MAX_WARPS][MAX_G], out_s[MAX_G];
  // the resident path's mask: V <= n <= RES * MAX_THREADS
  __shared__ unsigned char smask[RESIDENT ? RES * MAX_THREADS : 1];
  const size_t off = (size_t)blockIdx.x * n;
  const float* x = logits + off;
  float* o = att + off;
  const unsigned char* mb = mask + (size_t)blockIdx.x * V;
  const Slice<VW> s(x, n);
  const int tid = threadIdx.x, T = blockDim.x;
  // a unit's floats share a box when boxes start on unit boundaries
  const bool whole = VW == 1 || (qag % VW == 0 && s.head == 0);
  int gpos[VW];
  positions(gpos, s.head, G);
  const int ee = s.edge(tid);
  const int eg = ee >= 0 ? ee % G : -1;
  float ex = ee >= 0 ? x[ee] : 0.f;

  float acc[VW], m[VW], inv[VW], em, esum;
  if constexpr (RESIDENT) {
    constexpr int UPT = RES / VW;
    Pack<VW> px[UPT];
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = tid + i * T;
      if (u < s.units) {
        px[i] = load_pack<VW>(x + s.first(u));
      } else {
#pragma unroll
        for (int j = 0; j < VW; ++j) px[i].v[j] = 0.f;
      }
    }
    for (int i = tid; i < V; i += T) smask[i] = mb[i];
    __syncthreads();
    const auto box_mask = [&](unsigned box) { return smask[box] != 0; };
    const bool ek = ee >= 0 && box_mask((unsigned)ee / (unsigned)qag);
    unsigned keep[UPT];
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[j] = -INFINITY;
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = tid + i * T;
      keep[i] = u < s.units ? keep_bits<VW>(s.first(u), qag, whole, box_mask) : 0u;
#pragma unroll
      for (int j = 0; j < VW; ++j)
        if (keep[i] >> j & 1) acc[j] = fmaxf(acc[j], px[i].v[j]);
    }
    block_reduce(acc, gpos, ek ? ex : -INFINITY, eg, G, Max(), red_m, out_m, m, em);
    // exp once per element, kept in registers; masked and absent floats 0
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[j] = 0.f;
#pragma unroll
    for (int i = 0; i < UPT; ++i)
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        px[i].v[j] = keep[i] >> j & 1 ? expf(px[i].v[j] - m[j]) : 0.f;
        acc[j] += px[i].v[j];
      }
    ex = ek ? expf(ex - em) : 0.f;
    block_reduce(acc, gpos, ex, eg, G, Sum(), red_s, out_s, inv, esum);
#pragma unroll
    for (int j = 0; j < VW; ++j) inv[j] = 1.f / fmaxf(inv[j], 1e-30f);  // of the sums
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int u = tid + i * T;
      if (u < s.units) {
#pragma unroll
        for (int j = 0; j < VW; ++j) px[i].v[j] *= inv[j];
        store_pack<VW>(o + s.first(u), px[i]);
      }
    }
    if (ee >= 0) o[ee] = ex * (1.f / fmaxf(esum, 1e-30f));
  } else {
    const auto box_mask = [&](unsigned box) { return __ldg(mb + box) != 0; };
    const bool ek = ee >= 0 && box_mask((unsigned)ee / (unsigned)qag);
    // a running max and sum per position (online softmax)
    float rs[VW];
#pragma unroll
    for (int j = 0; j < VW; ++j) {
      acc[j] = -INFINITY;
      rs[j] = 0.f;
    }
#pragma unroll 2
    for (int u = tid; u < s.units; u += T) {
      const Pack<VW> px = load_pack<VW>(x + s.first(u));
      const unsigned k = keep_bits<VW>(s.first(u), qag, whole, box_mask);
#pragma unroll
      for (int j = 0; j < VW; ++j) {
        if (!(k >> j & 1)) continue;
        if (px.v[j] > acc[j]) {
          rs[j] *= expf(acc[j] - px.v[j]);
          acc[j] = px.v[j];
        }
        rs[j] += expf(px.v[j] - acc[j]);
      }
    }
    block_reduce(acc, gpos, ek ? ex : -INFINITY, eg, G, Max(), red_m, out_m, m, em);
    // each position's sum, rescaled to its glimpse's max
#pragma unroll
    for (int j = 0; j < VW; ++j)
      rs[j] = acc[j] == -INFINITY ? 0.f : rs[j] * expf(acc[j] - m[j]);
    ex = ek ? expf(ex - em) : 0.f;
    block_reduce(rs, gpos, ex, eg, G, Sum(), red_s, out_s, inv, esum);
#pragma unroll
    for (int j = 0; j < VW; ++j) inv[j] = 1.f / fmaxf(inv[j], 1e-30f);  // of the sums
#pragma unroll 2
    for (int u = tid; u < s.units; u += T) {
      Pack<VW> px = load_pack<VW>(x + s.first(u));
      const unsigned k = keep_bits<VW>(s.first(u), qag, whole, box_mask);
#pragma unroll
      for (int j = 0; j < VW; ++j)
        px.v[j] = k >> j & 1 ? expf(px.v[j] - m[j]) * inv[j] : 0.f;
      store_pack<VW>(o + s.first(u), px);
    }
    if (ee >= 0) o[ee] = ex * (1.f / fmaxf(esum, 1e-30f));
  }
}

// the shared checks of both entry points: 0 to launch, -1 for nothing to
// do, else a cudaError_t; `n` is the floats of one sample's slice
int prepare(int device, int B, int V, int QA, int G, int& n, int& threads,
            bool& resident) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (QA < 1 || B < 0 || V < 0 || G < 0 || G > MAX_G)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || V == 0 || G == 0) return -1;
  const long long nn = (long long)V * QA * G;
  if (nn > INT_MAX) return (int)cudaErrorInvalidValue;
  n = (int)nn;
  threads = threads_for(n, G, resident);
  return 0;
}

// 16-byte units where the tensors of a call are aligned alike
bool same_phase(const void* a, const void* b) {
  return ((size_t)a & 15) == ((size_t)b & 15);
}

}  // namespace

extern "C" int masked_softmax_vqa_forward(const float* logits,
                                          const unsigned char* mask,
                                          float* att, int B, int V, int QA,
                                          int G, int device, void* stream) {
  int n = 0, threads = 0;
  bool resident = false;
  const int ok = prepare(device, B, V, QA, G, n, threads, resident);
  if (ok != 0) return ok < 0 ? 0 : ok;
  const bool vec = same_phase(logits, att);
  const cudaStream_t st = (cudaStream_t)stream;
  const int qag = QA * G;
  if (vec && resident)
    masked_softmax_kernel<4, true><<<B, threads, 0, st>>>(logits, mask, att, n, V, qag, G);
  else if (vec)
    masked_softmax_kernel<4, false><<<B, threads, 0, st>>>(logits, mask, att, n, V, qag, G);
  else if (resident)
    masked_softmax_kernel<1, true><<<B, threads, 0, st>>>(logits, mask, att, n, V, qag, G);
  else
    masked_softmax_kernel<1, false><<<B, threads, 0, st>>>(logits, mask, att, n, V, qag, G);
  return (int)cudaGetLastError();
}

extern "C" int softmax_vqa_backward(const float* att, const float* grad,
                                    float* dl, int B, int V, int QA, int G,
                                    int device, void* stream) {
  int n = 0, threads = 0;
  bool resident = false;
  const int ok = prepare(device, B, V, QA, G, n, threads, resident);
  if (ok != 0) return ok < 0 ? 0 : ok;
  const bool vec = same_phase(att, grad) && same_phase(att, dl);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec && resident)
    softmax_backward_kernel<4, true><<<B, threads, 0, st>>>(att, grad, dl, n, G);
  else if (vec)
    softmax_backward_kernel<4, false><<<B, threads, 0, st>>>(att, grad, dl, n, G);
  else if (resident)
    softmax_backward_kernel<1, true><<<B, threads, 0, st>>>(att, grad, dl, n, G);
  else
    softmax_backward_kernel<1, false><<<B, threads, 0, st>>>(att, grad, dl, n, G);
  return (int)cudaGetLastError();
}
