// Float32 matrix products on the tensor cores, at float32 accuracy:
//
//   C[m, n] = sum_r A(m, r) * B(n, r)
//
// with each float32 operand split in the kernel into three bf16 terms,
// x = x0 + x1 + x2 (split_pair), and six bf16 products a k-step: a0b0,
// a0b1, a1b0, a0b2, a2b0, a1b1.  Each bf16 x bf16 product is exact in f32;
// the three left out (a1b2, a2b1, a2b2) are below 2^-22 of a0b0.  So the
// sums keep float32's accuracy (the card tests hold the error against
// float64 to at most twice cuBLAS float32's), with TF32 off, and no bf16
// copy of an operand ever reaches device memory.
//
// It replaces no TPU kernel: the JAX package leaves these products to XLA
// (`x @ v.T` of the weight-normed linears, vqatpu/ops/linear.py:56, and the
// fused v-tucker GEMM, vqatpu/ops/trilinear.py:41-71).  It takes the
// v-side tucker products of CTI and TanModel (M = B*V ~ 51k rows, K = 2048,
// N = 512 and 1024), which cuBLAS runs in FFMA on the SIMT cores (its
// `sm80_xmma_gemm_f32f32 ... tn` forward, CUTLASS's `simt_sgemm ... nt` for
// the weight gradient) at 63-71% of the 67 TFLOP/s float32 peak.
//
// Three products share the kernel (A_RC / B_RC: the operand is stored
// row-contiguous, [R][rows], rather than [rows][R]):
//   forward   y = x w^T:   A = x [M][K],   B = w [N][K]    (<false, false>)
//   weight    dw = dy^T x: A = dy [M][N],  B = x [M][K]    (<true, true>)
//   input     dx = dy w:   A = dy [M][N],  B = w [N][K]    (<false, true>)
//
// What bounds it on the H100: operations.  The six bf16 products of a
// float32 one run at 989 / 6 = 165 TFLOP/s at best, 2.5x the 67 TFLOP/s
// float32 peak; a 51,200 x 2048 x 1024 forward reads 430 MB (0.13 ms at
// 3.35 TB/s) for 0.215 TFLOP (1.30 ms at 165 TFLOP/s, 3.2 ms at 67).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, cold L2 (chip_smoke.py
// phase 16): that forward 2.05 ms against cuBLAS float32's 4.39; forward
// plus weight gradient 0.50-0.52x cuBLAS's time at the four v-tucker shapes.
//
// Design (per block: two consumer warpgroups and a producer warpgroup,
// persistent over 128 x 128 output tiles):
// - One producer thread keeps a ring of STAGES float32 stages in flight
//   with TMA: each stage is 32 of the reduction for the tile's 128 rows of
//   A and of B, 128-byte swizzled.  A [rows][R] operand is one 128 x 32
//   box, a [R][rows] one four 32 x 32 boxes; ragged edges come in as zeros.
//   The producer warpgroup hands its registers to the consumers
//   (setmaxnreg).
// - Each consumer warpgroup owns 64 rows of the tile.  It reads its rows of
//   A from the stage straight into wgmma's A fragments (registers), split
//   into three bf16 terms; the 256 consumer threads together split B into
//   three bf16 tiles in shared memory (8 x 16-byte core matrices, no
//   swizzle), a ring of three, so that one named barrier a stage keeps the
//   writes clear of both warpgroups' products in flight.  Where A is
//   [rows][R], a stage's 32 positions are permuted (phys_k) so that the
//   A fragments' float2 reads fall in distinct banks; B's split follows.
//   Then twelve wgmma.m64n128k16 (two k16 slices x six term pairs),
//   asynchronous: the next stage's split runs while they do.
// - The tensor cores' float32 sums truncate, and over all of K = 2048
//   (or M = 51,200 for the weight gradient) that cost 7-90x cuBLAS's error
//   against float64.  So each stage's twelve products start from zero in
//   a second set of accumulators, smallest term pairs first, and FADD
//   (rounded to nearest) adds them to the sum before the next stage's are
//   issued: 0.2-1.0x cuBLAS float32's error at the cells' shapes and at
//   ragged ones (one sum of the tensor cores over two stages reached 4.3x).
// - The weight gradient reduces over M ~ 51k rows onto few tiles (32 or
//   64 of 128 x 128 for N = 512, 1024 at K = 2048): where the tiles leave
//   SMs idle the reduction is split into S contiguous ranges.  Split 0
//   stores its sum in C and split s > 0 in a scratch of partial sums (at
//   most sms x 128 x 128 floats, 8.7 MB); a second kernel then adds them
//   to C in the order of s.  No block waits on another and there are no
//   float atomics: the order of the sum is fixed by the shapes and the
//   card's SM count alone, so the gradient is bitwise the same from run
//   to run.
// - The epilogue stores the float32 sums as they are; the weight norm's
//   scale, the bias and the activation stay outside.
//
// Tried on the card and dropped: the B split on three warps of the
// producer warpgroup, alone (they fell behind: the weight gradient took
// 1.3x the time) or sharing it with the consumers (no faster); sums over
// two stages in the tensor cores (4.3x cuBLAS's error at K = 64).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma.cuh"

namespace {

constexpr int BM = 128;  // output rows a tile: 64 for each consumer warpgroup
constexpr int BN = 128;  // output columns a tile
constexpr int BK = 32;   // reduction a stage: one 128-byte float32 row
constexpr int STAGES = 4;
constexpr int SPLIT_BUFS = 3;
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int PRODUCER_REGS = 40;         // 128 * (2 * 232 + 40) <= 65536
constexpr int CONSUMER_REGS = 232;
constexpr int RC_BOX = 32;  // a [R][rows] operand comes in 32 x 32 boxes
constexpr unsigned OPERAND_BYTES = BM * BK * sizeof(float);  // = BN * BK * 4
constexpr unsigned STAGE_BYTES = 2 * OPERAND_BYTES;
constexpr int TERM_BYTES = BN * BK * 2;  // one bf16 term of B
constexpr int SPLIT_BYTES = 3 * TERM_BYTES;
constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + SPLIT_BUFS * SPLIT_BYTES + 1024;
// the split B tiles: 8 rows x 16 bytes a core matrix; LBO the step between
// core matrices along the reduction, SBO between groups of 8 rows
constexpr int LBO = 128;
constexpr int SBO = 512;
constexpr int CONSUMER_BARRIER = 1;
constexpr int SUM_THREADS = 256;
// B's runs of 8 positions that each consumer thread splits a stage
constexpr int SPLIT_TASKS = BN * BK / 8 / CONSUMERS;

static_assert(BM == BN, "A and B stages share one size");
static_assert(SMEM <= 232448, "shared memory of one block");

// Element (row r, reduction k) of a stage's operand, in floats from its
// base.  128-byte rows, the 16-byte chunks of row i permuted by chunk ^ (i % 8)
// (CU_TENSOR_MAP_SWIZZLE_128B): [r][k] for a [rows][R] operand, [k][r % 32]
// boxes for a [R][rows] one.
template <bool RC>
__device__ __forceinline__ int staged(int r, int k) {
  if constexpr (RC)
    return (r / RC_BOX) * (RC_BOX * BK) + k * RC_BOX + ((((r % 32) / 4) ^ (k % 8)) * 4) + r % 4;
  else
    return r * BK + (((k / 4) ^ (r % 8)) * 4) + k % 4;
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  unsigned u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// Two floats as three bf16 terms each, x = h + m + l, each term packed as a
// bf16 pair (x0 in the lower half): h rounded to nearest (split_bf16x3's
// first term), m the upper half of the residual x - h (truncated, so it is
// taken with a byte permute, not a conversion), l what is left of it,
// rounded to nearest.  |m| <= 2^-8 |x| and |l| < 2^-15 |x|, so the products
// left out (a1b2, a2b1, a2b2) stay below 2^-22 of a0b0; on the card the
// float64 error held within 0.2-1.0x cuBLAS's (0.2-1.2x with m rounded
// too), and the stage took 3-4% less time.
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& h, unsigned& m,
                                           unsigned& l) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h2), r1 = x1 - __high2float(h2);
  const unsigned u0 = __float_as_uint(r0), u1 = __float_as_uint(r1);
  m = __byte_perm(u0, u1, 0x7632);
  const float l0 = r0 - __uint_as_float(u0 & 0xFFFF0000u);
  const float l1 = r1 - __uint_as_float(u1 & 0xFFFF0000u);
  l = bits(__floats2bfloat162_rn(l0, l1));
  h = bits(h2);
}

// The reduction index of a stage that position k (0..31, in the order of
// wgmma's fragments and of the split B tile) holds.  PERM, where A is
// [rows][R]: position 8c + 2t + e holds 4c + 16 (t / 2) + 2 (t % 2) + e, so
// that the float2 of A's fragments that a half-warp's lanes read for one
// register fall in eight distinct 16-byte chunks, that is in distinct
// banks (in order, lanes t and t ^ 1 of rows g and g ^ 1 would share one).
// The product is the same sum in another order.
template <bool PERM>
__device__ __forceinline__ int phys_k(int k) {
  if constexpr (PERM) {
    const int c = k / 8, t = k % 8 / 2;
    return 4 * c + 16 * (t / 2) + 2 * (t % 2) + k % 2;
  } else {
    return k;
  }
}

// A's wgmma fragments for one stage: [term][k16 slice][register].  Per
// warp the m16n8k16 A layout: register q holds row group + 8 * (q % 2),
// positions 2 * tig + 8 * (q / 2) and the one after it.
struct AFrag {
  unsigned t[3][2][4];
};

template <bool RC, bool PERM>
__device__ __forceinline__ void load_a(const float* s, int r0, int tig, AFrag& a) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + (q & 1) * 8, k = phys_k<PERM>(16 * j + 2 * tig + (q >> 1) * 8);
      float x0, x1;
      if constexpr (RC) {
        x0 = s[staged<true>(r, k)];
        x1 = s[staged<true>(r, k + 1)];
      } else {
        const float2 v = *reinterpret_cast<const float2*>(s + staged<false>(r, k));
        x0 = v.x;
        x1 = v.y;
      }
      split_pair(x0, x1, a.t[0][j][q], a.t[1][j][q], a.t[2][j][q]);
    }
  }
}

// The stage's B tile as three bf16 tiles at `dst`, each [BN][BK] in core
// matrices: row r, position k at (r / 8) * SBO + (k / 8) * LBO + (r % 8) *
// 16 + (k % 8) * 2 bytes.  A task is a run of 8 positions of one row;
// consumer thread `tid` takes tasks tid, tid + CONSUMERS, ..., reading all
// of them before it splits any.  Each 8 lanes (one pass of a 16-byte
// access) take 8 rows, so that their reads and writes fall in distinct
// banks.
template <bool RC, bool PERM>
__device__ __forceinline__ void split_b(const float* s, unsigned char* dst, int tid) {
  float x[SPLIT_TASKS][8];
#pragma unroll
  for (int n = 0; n < SPLIT_TASKS; ++n) {
    const int id = tid + n * CONSUMERS;
    const int r = RC ? id % BN : id / 32 * 8 + id % 8;
    const int c = RC ? id / BN : id / 8 % 4;
    if constexpr (RC) {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[n][e] = s[staged<true>(r, phys_k<PERM>(8 * c + e))];
    } else {
      // positions 8c..8c+3 and 8c+4..8c+7, each four in a row
      const float4 u = *reinterpret_cast<const float4*>(s + staged<false>(r, phys_k<PERM>(8 * c)));
      const float4 v =
          *reinterpret_cast<const float4*>(s + staged<false>(r, phys_k<PERM>(8 * c + 4)));
      x[n][0] = u.x, x[n][1] = u.y, x[n][2] = u.z, x[n][3] = u.w;
      x[n][4] = v.x, x[n][5] = v.y, x[n][6] = v.z, x[n][7] = v.w;
    }
  }
#pragma unroll
  for (int n = 0; n < SPLIT_TASKS; ++n) {
    const int id = tid + n * CONSUMERS;
    const int r = RC ? id % BN : id / 32 * 8 + id % 8;
    const int c = RC ? id / BN : id / 8 % 4;
    uint4 h, m, l;
    split_pair(x[n][0], x[n][1], h.x, m.x, l.x);
    split_pair(x[n][2], x[n][3], h.y, m.y, l.y);
    split_pair(x[n][4], x[n][5], h.z, m.z, l.z);
    split_pair(x[n][6], x[n][7], h.w, m.w, l.w);
    const int off = (r / 8) * SBO + c * LBO + (r % 8) * 16;
    *reinterpret_cast<uint4*>(dst + off) = h;
    *reinterpret_cast<uint4*>(dst + TERM_BYTES + off) = m;
    *reinterpret_cast<uint4*>(dst + 2 * TERM_BYTES + off) = l;
  }
}

// wgmma's shared-memory matrix descriptor of a K-major tile without
// swizzle: start address, LBO and SBO in 16-byte units, layout type 0
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of `d` across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = a * b (+ d where `keep`) over 64 x 128 x 16: A bf16 from registers, B
// bf16 K-major from shared memory, f32 accumulators
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const unsigned (&a)[4],
                                                 uint64_t b, int keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(keep));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMER_BARRIER), "n"(CONSUMERS) : "memory");
}

// The work of a launch: T = tiles_m * tiles_n output tiles, each reduced in
// S splits; unit u is split u / T of tile u % T, the tile's columns
// fastest (so the blocks on one row band of A run together and read it
// from device memory once).
struct Work {
  int tiles_n, T, S, k_steps;
  __device__ __forceinline__ void unit(int u, int& tm, int& tn, int& s, int& k0,
                                       int& k1) const {
    s = u / T;
    const int t = u % T;
    tm = t / tiles_n;
    tn = t % tiles_n;
    k0 = (int)((long long)k_steps * s / S);
    k1 = (int)((long long)k_steps * (s + 1) / S);
  }
};

// one stage of an operand: the tile's 128 rows from `row0`, reduction from k0
template <bool RC>
__device__ __forceinline__ void load_operand(const CUtensorMap* map, float* dst, int row0,
                                             int k0, unsigned long long* bar) {
  if constexpr (RC) {
#pragma unroll
    for (int j = 0; j < BM / RC_BOX; ++j)
      tma_load_2d(dst + j * RC_BOX * BK, map, row0 + j * RC_BOX, k0, bar);
  } else {
    tma_load_2d(dst, map, k0, row0, bar);
  }
}

// The block's ring of STAGES float32 stages (TMA -> consumers), each slot
// a pair of mbarriers; a thread's place in it is its slot and the parity of
// the slot's phase.
struct Ring {
  unsigned long long *full, *empty;
  int slot = 0;
  unsigned phase = 0;
  __device__ __forceinline__ void next() {
    if (++slot == STAGES) slot = 0, phase ^= 1;
  }
  __device__ __forceinline__ const float* stage(const float* stages) const {
    return stages + (size_t)slot * (STAGE_BYTES / 4);
  }
};

// The TMA thread: every stage of this block's units.
template <bool A_RC, bool B_RC>
__device__ __forceinline__ void load_stages(const CUtensorMap* amap, const CUtensorMap* bmap,
                                            float* stages, Ring ring, const Work& w) {
  for (int u = blockIdx.x; u < w.T * w.S; u += gridDim.x) {
    int tm, tn, s, k0, k1;
    w.unit(u, tm, tn, s, k0, k1);
    for (int ks = k0; ks < k1; ++ks, ring.next()) {
      mbar_wait(&ring.empty[ring.slot], ring.phase ^ 1);  // the first round passes
      mbar_arrive_expect_tx(&ring.full[ring.slot], STAGE_BYTES);
      float* sa = stages + (size_t)ring.slot * (STAGE_BYTES / 4);
      load_operand<A_RC>(amap, sa, tm * BM, ks * BK, &ring.full[ring.slot]);
      load_operand<B_RC>(bmap, sa + OPERAND_BYTES / 4, tn * BN, ks * BK,
                         &ring.full[ring.slot]);
    }
  }
}

// The two consumer warpgroups: each stage's B split, A into registers, the
// products, each tile's store.
template <bool A_RC, bool B_RC>
__device__ __forceinline__ void consume(const float* stages, unsigned char* splits,
                                        Ring ring, const Work& w, float* __restrict__ C,
                                        int Mo, int No, float* __restrict__ partial) {
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int group = lane / 4, tig = lane % 4;
  const int r0 = 64 * wg + 16 * warp + group;  // the row of a0 in the tile
  float acc[64];
  AFrag fa0, fa1;
  int it = 0;
  bool pending = false;

  // the products of a stage run in the tensor cores into `part` (the first
  // with zero accumulators in), smallest term pairs first; then FADD
  // (rounded to nearest) adds `part` to `acc`.  The tensor cores' sums
  // truncate, so their chains stay that short.
  float part[64] = {};
  auto flush = [&]() {
    wgmma_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    pending = false;
  };
  // one stage: split B, A into registers, then its twelve products.  The
  // split B tiles are a ring of three: a stage's split follows the
  // barrier of the stage before, which each warpgroup reaches only once
  // the products that last read the same tile, three stages back, are done.
  auto step = [&](AFrag& a) {
    mbar_wait(&ring.full[ring.slot], ring.phase);
    const float* sa = ring.stage(stages);
    unsigned char* sb = splits + (size_t)(it % SPLIT_BUFS) * SPLIT_BYTES;
    split_b<B_RC, !A_RC>(sa + OPERAND_BYTES / 4, sb, tid);
    load_a<A_RC, !A_RC>(sa, r0, tig, a);
    fence_proxy_async();  // the split's writes, before wgmma reads them
    consumer_sync();
    if (tid == 0) mbar_arrive(&ring.empty[ring.slot]);
    ring.next();
    ++it;
    if (pending) flush();
    wgmma_fence();
    // (A term, B term) of the six products, smallest first
    constexpr int TA[6] = {1, 2, 0, 1, 0, 0}, TB[6] = {1, 0, 2, 0, 1, 0};
#pragma unroll
    for (int p = 0; p < 6; ++p) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wgmma_m64n128k16(part, a.t[TA[p]][j], b_desc(sb + TB[p] * TERM_BYTES + j * 2 * LBO),
                         p + j > 0);
    }
    wgmma_commit();
    pending = true;
  };

  for (int u = blockIdx.x; u < w.T * w.S; u += gridDim.x) {
    int tm, tn, s, k0, k1;
    w.unit(u, tm, tn, s, k0, k1);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int ks = k0; ks < k1; ks += 2) {
      step(fa0);
      if (ks + 1 < k1) step(fa1);
    }
    flush();

    // split 0's sum goes to C, split s's to partial sum s - 1
    float* out0 = s == 0 ? C : partial + (size_t)(s - 1) * Mo * No;
    const int row = tm * BM + r0, col = tn * BN + 2 * tig;
    const bool pairs = No % 2 == 0;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row + 8 * half, c = col + 8 * jn;
        if (r >= Mo || c >= No) continue;
        const float v0 = acc[4 * jn + 2 * half], v1 = acc[4 * jn + 2 * half + 1];
        float* out = out0 + (size_t)r * No + c;
        if (pairs) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          out[0] = v0;
          if (c + 1 < No) out[1] = v1;
        }
      }
    }
  }
}

template <bool A_RC, bool B_RC>
__global__ void __launch_bounds__(THREADS, 1)
linear_f32_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap, float* __restrict__ C,
                  int Mo, int No, Work w, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  __shared__ alignas(8) unsigned long long bars[2 * STAGES];
  // the 128-byte swizzle repeats every 1024 bytes
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  base += (1024 - (unsigned)__cvta_generic_to_shared(base) % 1024) % 1024;
  float* stages = reinterpret_cast<float*>(base);
  unsigned char* splits = base + (size_t)STAGES * STAGE_BYTES;
  Ring ring{bars, bars + STAGES};

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();
  // the producer warpgroup, one thread of which asks for the stages, gives
  // up registers to the consumers' sums
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) load_stages<A_RC, B_RC>(&amap, &bmap, stages, ring, w);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    consume<A_RC, B_RC>(stages, splits, ring, w, C, Mo, No, partial);
  }
}

// C[e] += partial[0][e] + ... + partial[n - 1][e], in that order, four
// floats a thread (`per`, the floats of C, a multiple of 4)
__global__ void __launch_bounds__(SUM_THREADS)
linear_f32_split_sum_kernel(float* __restrict__ C, const float* __restrict__ partial, int n,
                            long long per) {
  for (long long e = 4 * (blockIdx.x * (long long)SUM_THREADS + threadIdx.x); e < per;
       e += 4LL * gridDim.x * SUM_THREADS) {
    float4 v = *reinterpret_cast<const float4*>(C + e);
    for (int k = 0; k < n; ++k) {
      const float4 p = __ldcs(reinterpret_cast<const float4*>(partial + k * per + e));
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    *reinterpret_cast<float4*>(C + e) = v;
  }
}

// cuTensorMapEncodeTiled, fetched from libcuda by the runtime (so the
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

// An operand stored [outer][inner] float32, in boxes of 32 inner x `rows`
// outer, 128-byte swizzled, zero out of bounds
bool operand_map(CUtensorMap* map, const float* p, int inner, int outer, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(float)};
  const cuuint32_t box[2] = {32, (cuuint32_t)rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count(int device) {
  constexpr int MAX_DEVICES = 64;
  static int count[MAX_DEVICES] = {};
  if (count[device] == 0)
    cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device);
  return count[device];
}

// The work of C [Mo][No] summed over R: its tiles and, where `split`, the
// splits of the reduction: one, unless the tiles leave SMs idle; then as
// many as fill them, each at least 8 stages long.
Work work_for(int Mo, int No, int R, int sms, bool split) {
  Work w;
  w.tiles_n = (No + BN - 1) / BN;
  w.T = (Mo + BM - 1) / BM * w.tiles_n;
  w.k_steps = (R + BK - 1) / BK;
  w.S = 1;
  if (split && w.T < sms) {
    w.S = sms / w.T;
    if (w.S > w.k_steps / 8) w.S = w.k_steps / 8;
    if (w.S < 1) w.S = 1;
  }
  return w;
}

// the floats of partial sums that a split reduction keeps beside C
long long partial_floats(const Work& w, int Mo, int No) {
  return (long long)(w.S - 1) * Mo * No;
}

// C [Mo][No] = sum over R of A(m, r) B(n, r); A stored [Mo][R] or, with
// A_RC, [R][Mo]; B likewise.  Given `partial` (partial_size floats, at
// least partial_floats) the reduction may be split.
template <bool A_RC, bool B_RC>
int gemm(const float* a, const float* b, float* c, int Mo, int No, int R, float* partial,
         long long partial_size, int device, void* stream) {
  constexpr int MAX_DEVICES = 64;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Mo < 0 || No < 0 || R < 1 ||
      ((uintptr_t)a | (uintptr_t)b) % 16 != 0 || (A_RC ? Mo : R) % 4 != 0 ||
      (B_RC ? No : R) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (Mo == 0 || No == 0) return 0;
  CUtensorMap amap = {}, bmap = {};
  if (!(A_RC ? operand_map(&amap, a, Mo, R, RC_BOX) : operand_map(&amap, a, R, Mo, BM)) ||
      !(B_RC ? operand_map(&bmap, b, No, R, RC_BOX) : operand_map(&bmap, b, R, No, BN)))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count(device);
  const Work w = work_for(Mo, No, R, sms, partial != nullptr);
  if (partial_size < partial_floats(w, Mo, No)) return (int)cudaErrorInvalidValue;
  const int units = w.T * w.S;
  static bool raised[MAX_DEVICES] = {};
  auto kernel = linear_f32_kernel<A_RC, B_RC>;
  if (!raised[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    raised[device] = true;
  }
  kernel<<<units < sms ? units : sms, THREADS, SMEM, (cudaStream_t)stream>>>(
      amap, bmap, c, Mo, No, w, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess || w.S == 1) return (int)err;
  const long long per = (long long)Mo * No;
  const long long sum_blocks = (per / 4 + SUM_THREADS - 1) / SUM_THREADS;
  linear_f32_split_sum_kernel<<<(unsigned)(sum_blocks < 4096 ? sum_blocks : 4096), SUM_THREADS,
                                0, (cudaStream_t)stream>>>(c, partial, w.S - 1, per);
  return (int)cudaGetLastError();
}

}  // namespace

// y [M][N] = x [M][K] w[N][K]^T
extern "C" int linear_f32_forward(const float* x, const float* w, float* y, int M, int N,
                                  int K, int device, void* stream) {
  return gemm<false, false>(x, w, y, M, N, K, nullptr, 0, device, stream);
}

// dx [M][K] = dy [M][N] w [N][K]
extern "C" int linear_f32_dgrad(const float* dy, const float* w, float* dx, int M, int N,
                                int K, int device, void* stream) {
  return gemm<false, true>(dy, w, dx, M, K, N, nullptr, 0, device, stream);
}

// the floats of scratch that linear_f32_wgrad needs for these shapes on
// this device, into *floats
extern "C" int linear_f32_wgrad_scratch(int M, int N, int K, int device, long long* floats) {
  if (device < 0 || device >= 64 || M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  *floats = M > 0 && N > 0 && K > 0
                ? partial_floats(work_for(N, K, M, sm_count(device), true), N, K)
                : 0;
  return 0;
}

// dw [N][K] = dy [M][N]^T x [M][K]; `scratch`: scratch_size floats, at
// least linear_f32_wgrad_scratch's
extern "C" int linear_f32_wgrad(const float* dy, const float* x, float* dw, int M, int N,
                                int K, float* scratch, long long scratch_size, int device,
                                void* stream) {
  return gemm<true, true>(dy, x, dw, N, K, M, scratch, scratch_size, device, stream);
}
