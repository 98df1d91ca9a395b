"""Where K1's and K2's time goes on one CUDA card, and how designs next to
theirs and to those of ``csrc/softmax_vqa.cu`` compare.  Run from the
repository root on a machine with the card: ``python3 -m
vqatpu_torch.kernels.probe``.  Prints its findings; it is not part of
``chip_smoke.py``'s checks.

1. Timelines: copies of ``csrc/rank_softmax.cu`` and ``csrc/tri_pool.cu``
   that record ``clock64`` on block 0's first thread at a kernel's steps
   (K1: the first ring stages requested, each RX chunk landed and
   multiplied, the epilogue's steps; K2: operands landed, w split,
   products, each step done), K1 at B=1 and B=128 and K2 at B=128 with
   the model's shapes, for the float32 kernels, the CUDA-core design of
   the bf16 instances (their entry points routed back to the float32
   templates: ``K1_CUDA_CORES``, ``K2_CUDA_CORES``) and the tensor-core
   ones (K1 with its TMA ring and with 16-byte ``cp.async``).  Cycles
   become µs by ``%globaltimer`` over the same span.
2. Variants: copies of the two sources with one constant changed (ring
   depth, chunk, rows per stage, warps, d spans a block, step buffers,
   the copies, the exponential), built side by side and timed with the
   shipped kernels and the CUDA-core design on the same inputs (cold L2, as
   ``chip_smoke.py`` times), float32 and bf16 instances at B=1, 128 and
   256, each checked against the plain version first.  Copies of
   ``csrc/softmax_vqa.cu`` with another number of floats a thread (and
   so of threads a block), timed the same way and back to back over
   input copies that exceed the L2, forward (K3) and backward.
3. The floor of that timing: a launch that does no work (a 4-byte
   ``zero_``), timed the same way, and timed back to back (many launches
   between two events, :func:`~vqatpu_torch.kernels.timing.time_back_to_back_ms`),
   which leaves out the single call's event overhead.
4. K2's backward (``csrc/tri_pool_backward.cu``): the shipped kernel and
   copies with a few lines changed (:data:`KB_VARIANTS`: where sums and
   copies happen, tiles at once), each held to ``trilinear_pool_grads``
   (at float32 also printing each cotangent's float64 error over the
   plain version's) and timed as in 2 at B=256 free-form and Visual7W
   shapes, float32 and bf16; a clock64 timeline of block 0's first unit
   (:data:`KB_TIMELINE`); the
   instruction mix of the float32 instance's stage loop (``cuobjdump
   -sass``: the shortest loop that holds all its HMMA); each instance's
   registers (``ptxas``), shared memory, and so blocks an SM and warps a
   scheduler; and the SM clock and power that ``nvidia-smi`` reads while
   the kernel runs for 2 s.

The copies are made by replacing lines of the sources; a source edited
so that a line is gone makes this script stop with that line's text.
"""

from __future__ import annotations

import collections
import ctypes
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from vqatpu_torch.kernels import build
from vqatpu_torch.kernels import trilinear as K
from vqatpu_torch.kernels.timing import (copies_for, sleep_cycles_per_ms,
                                         time_back_to_back_ms, time_ms)

V, REAL, Q, A, R, X, G, D = 50, 44, 12, 3, 32, 16, 2, 1024
PROBE_DIR = build.BUILD_DIR / "probe"

STAMPS = r'''
__device__ long long probe_clk[64];
__device__ unsigned long long probe_ns[2];
#define STAMP(k)                                                            \
  do {                                                                      \
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)             \
      probe_clk[k] = clock64();                                             \
  } while (0)
#define STAMP_NS(k)                                                         \
  do {                                                                      \
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {           \
      unsigned long long t;                                                 \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));                 \
      probe_ns[k] = t;                                                      \
    }                                                                       \
  } while (0)
'''
READ_STAMPS = r'''
extern "C" int probe_read(long long* clk, unsigned long long* ns) {
  cudaError_t err = cudaMemcpyFromSymbol(clk, probe_clk, sizeof(probe_clk));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(ns, probe_ns, sizeof(probe_ns));
  return (int)err;
}
'''
# stamps: 0 start, 1 first stages requested, 2+2c chunk c landed, 3+2c its
# FMAs done, 40 loop done, 41 max and sum folded, 42 block reduction done,
# 43 normalised
TIMELINE = [
    ("namespace {\n", STAMPS + "namespace {\n"),
    ("  const int b = blockIdx.x;\n",
     "  STAMP(0);\n  STAMP_NS(0);\n  const int b = blockIdx.x;\n"),
    ("    for (int c = 0; c < n_chunks; ++c) {\n"
     "      cp_async_wait<STAGES - 2>();\n"
     "      __syncthreads();  // chunk c has landed; slot (c-1) % STAGES is free\n",
     "    STAMP(1);\n"
     "    for (int c = 0; c < n_chunks; ++c) {\n"
     "      cp_async_wait<STAGES - 2>();\n"
     "      __syncthreads();  // chunk c has landed; slot (c-1) % STAGES is free\n"
     "      STAMP(2 + 2 * c);\n"),
    ("        }\n      }\n    }\n\n"
     "    // masked logits of this tile into the thread's running max and sum\n",
     "        }\n      }\n      STAMP(3 + 2 * c);\n    }\n\n    STAMP(40);\n"
     "    // masked logits of this tile into the thread's running max and sum\n"),
    ("  // block-wide max and sum per glimpse",
     "  STAMP(41);\n  // block-wide max and sum per glimpse"),
    ("  // normalise: from registers, or rereading the parked logits\n",
     "  STAMP(42);\n  // normalise: from registers, or rereading the parked logits\n"),
]
KERNEL_END = "\ntemplate <typename T, int GG, bool CONTIG>\ncudaError_t launch("
# K2's stamps: 0 start, 1 the V loop done, 2 the qt epilogue done, 3 the
# output written
K2_TIMELINE = [
    ("namespace {\n", STAMPS + "namespace {\n"),
    ("  const int b = blockIdx.x;\n",
     "  STAMP(0);\n  STAMP_NS(0);\n  const int b = blockIdx.x;\n"),
    ("    if (d < D) {\n#pragma unroll\n      for (int jj = 0; jj < NQ; ++jj) {\n",
     "    STAMP(1);\n"
     "    if (d < D) {\n#pragma unroll\n      for (int jj = 0; jj < NQ; ++jj) {\n"),
    ("  if (d < D) {\n    float2 o = make_float2(0.f, 0.f);\n",
     "  STAMP(2);\n  if (d < D) {\n    float2 o = make_float2(0.f, 0.f);\n"),
]
K2_KERNEL_END = ("\ntemplate <typename TV, typename TQ, int NQ, int NA, bool ONE_PASS>"
                 "\ncudaError_t launch(")
# the CUDA-core design of the bf16 instances: the _bf16 entry points
# routed back to the float32 templates, instantiated at bf16 (f32 FMAs on
# the CUDA cores, operands widened in registers)
K1_CUDA_CORES = [("  return forward_mma(v_r, tqa, mask, att, B, V, RX, QA, G, device, stream);",
           "  return forward(v_r, tqa, mask, att, B, V, RX, QA, G, device, stream);")]
K2_CUDA_CORES = [("    return forward_mma(vt, (const __nv_bfloat16*)qt",
           "    return forward(vt, (const __nv_bfloat16*)qt"),
          ("  return forward_mma(vt, (const float*)qt", "  return forward(vt, (const float*)qt")]
# the tensor-core K1's stamps: 0 start, 1 first stages requested, 2+2c
# chunk c landed (and the next requested), 3+2c its MMAs done, 40 loop
# done, 41 masked and the thread's max, 44 the warps' maxima exchanged
# (every warp past its products), 45 the exponentials, 42 block sums
# done, 43 normalised
K1_MMA_TIMELINE = [
    ("namespace {\n", STAMPS + "namespace {\n"),
    ("  const int g0 = blockIdx.y * GG;\n  const int tid = threadIdx.x;\n"
     "  const int nthreads = blockDim.x;\n  const int warp = tid / 32, lane = tid % 32;\n",
     "  STAMP(0);\n  STAMP_NS(0);\n"
     "  const int g0 = blockIdx.y * GG;\n  const int tid = threadIdx.x;\n"
     "  const int nthreads = blockDim.x;\n  const int warp = tid / 32, lane = tid % 32;\n"),
    ("    for (int c = 0; c < n_chunks; ++c) {\n      const int it = it0 + c;\n",
     "    STAMP(1);\n"
     "    for (int c = 0; c < n_chunks; ++c) {\n      const int it = it0 + c;\n"),
    ("      if (c + MSTAGES - 1 < n_chunks) load(it + MSTAGES - 1);\n",
     "      if (c + MSTAGES - 1 < n_chunks) load(it + MSTAGES - 1);\n"
     "      STAMP(2 + 2 * c);\n"),
    ("step(kk, kk + 8 >= cols);\n      }\n    }\n\n    // The C fragment",
     "step(kk, kk + 8 >= cols);\n      }\n      STAMP(3 + 2 * c);\n    }\n\n"
     "    STAMP(40);\n    // The C fragment"),
    ("  // block max per glimpse", "  STAMP(41);\n  // block max per glimpse"),
    ("  // normalise; GG = 2 writes", "  STAMP(42);\n  // normalise; GG = 2 writes"),
    ("  __syncthreads();\n  float m[GG], sum[GG];\n",
     "  __syncthreads();\n  STAMP(44);\n  float m[GG], sum[GG];\n"),
    ("  // block sum per glimpse, the same way\n",
     "  STAMP(45);\n  // block sum per glimpse, the same way\n"),
]
K1_MMA_END = "\ntemplate <int GG, bool CONTIG>\ncudaError_t launch_mma("
# the tensor-core K2's stamps: 0 start, 1 the first step's operands and w
# in shared memory, 2 w split into its planes, 3 the first step's products
# done, 10+k step k done (its span's output written), 4 the end
K2_MMA_TIMELINE = [
    ("namespace {\n", STAMPS + "namespace {\n"),
    ("  const int n_spans = (D + MDSPAN - 1) / MDSPAN;\n",
     "  STAMP(0);\n  STAMP_NS(0);\n  const int n_spans = (D + MDSPAN - 1) / MDSPAN;\n"),
    ("    if (k == 0 || !one_plane) {\n",
     "    if (k == 0) STAMP(1);\n    if (k == 0 || !one_plane) {\n"),
    ("      if (!one_plane && k + 1 < n_steps) {\n",
     "      if (k == 0) STAMP(2);\n      if (!one_plane && k + 1 < n_steps) {\n"),
    ("    // U summed over the steps of a pass",
     "    if (k == 0) STAMP(3);\n    // U summed over the steps of a pass"),
    ("      out[(size_t)b * D + d] = o;\n    }\n  }\n}\n",
     "      out[(size_t)b * D + d] = o;\n    }\n    STAMP(10 + k);\n  }\n}\n"),
]
K2_MMA_END = "\ntemplate <typename TQ, int NQ, int NA>\ncudaError_t launch_mma("
K1_MMA_VARIANTS = {
    "16-byte cp.async copies": [("constexpr bool TENSOR_MAPS = true;",
                                 "constexpr bool TENSOR_MAPS = false;")],
    "12 warps (4 n8 tiles a warp)": [("constexpr int NT = 6;", "constexpr int NT = 4;")],
    "ring of 3 stages": [("constexpr int MSTAGES = 4;", "constexpr int MSTAGES = 3;")],
    "ring of 6 stages": [("constexpr int MSTAGES = 4;", "constexpr int MSTAGES = 6;")],
    "accurate exponentials (expf)": [(
        "? __expf(acc[s][e] - m[s % GG]) : 0.f;", "? expf(acc[s][e] - m[s % GG]) : 0.f;")],
}
K2_MMA_VARIANTS = {
    "4 warps (128 d a step)": [("constexpr int MWARPS = 8;", "constexpr int MWARPS = 4;")],
    "two d spans a block": [("constexpr int MAX_SPANS = 4;", "constexpr int MAX_SPANS = 2;")],
    "two step buffers": [("constexpr int NBUF = 3;", "constexpr int NBUF = 2;")],
    "16 warps (16 d a warp)": [
        ("constexpr int MWARPS = 8;", "constexpr int MWARPS = 16;"),
        ("constexpr int MTW = 2;", "constexpr int MTW = 1;"),
        ("    if (pass + 1 == n_passes && d < D) {",
         "    if (pass + 1 == n_passes && tid < MDSPAN && d < D) {")],
}
K1_VARIANTS = {
    "ring of 2 stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")],
    "ring of 5 stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 5;")],
    "chunks of 16, 8 stages": [
        ("constexpr int KC = 32;", "constexpr int KC = 16;"),
        ("constexpr int STAGES = 4;", "constexpr int STAGES = 8;")],
}
# one exchange: every thread sums the warps' partials itself, with no
# second stage in warp 0 and one __syncthreads a reduction fewer
ONE_EXCHANGE = ("""  __syncthreads();
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
""", """  __syncthreads();
  float tg[MAX_G];
#pragma unroll
  for (int gg = 0; gg < MAX_G; ++gg) {
    tg[gg] = Op::id;
    if (gg < G)
      for (int w = 0; w < warps; ++w) tg[gg] = op(tg[gg], red[w][gg]);
  }
  etot = Op::id;
#pragma unroll
  for (int j = 0; j < VW; ++j) {
    tot[j] = tg[0];
#pragma unroll
    for (int gg = 1; gg < MAX_G; ++gg)
      if (gpos[j] == gg) tot[j] = tg[gg];
  }
#pragma unroll
  for (int gg = 0; gg < MAX_G; ++gg)
    if (eg == gg) etot = tg[gg];
  (void)out;
""")
# the mask read from device memory (L1/L2) for each unit, not copied to
# shared memory behind a __syncthreads
MASK_FROM_GLOBAL = [
    ("    for (int i = tid; i < V; i += T) smask[i] = mb[i];\n"
     "    __syncthreads();\n", ""),
    ("return smask[box] != 0; };", "return __ldg(mb + box) != 0; };")]
K3_VARIANTS = {
    "one exchange a reduction": [ONE_EXCHANGE],
    "mask from device memory": MASK_FROM_GLOBAL,
    "one exchange and mask from device memory": [ONE_EXCHANGE] + MASK_FROM_GLOBAL,
    "4 floats a thread": [("constexpr int RES = 8;", "constexpr int RES = 4;")],
    "16 floats a thread": [
        ("constexpr int RES = 8;", "constexpr int RES = 16;"),
        ("constexpr int MAX_THREADS = 1024;", "constexpr int MAX_THREADS = 512;")],
    "32 floats a thread": [
        ("constexpr int RES = 8;", "constexpr int RES = 32;"),
        ("constexpr int MAX_THREADS = 1024;", "constexpr int MAX_THREADS = 256;")],
}
K2_VARIANTS = {
    "ring of 2 stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")],
    "ring of 6 stages": [("constexpr int STAGES = 4;", "constexpr int STAGES = 6;")],
    "8 box rows a stage": [("constexpr int VR = 4;", "constexpr int VR = 8;")],
    "256 threads a block": [
        ("constexpr int THREADS = 128;", "constexpr int THREADS = 256;"),
        ("__launch_bounds__(THREADS, 4)", "__launch_bounds__(THREADS, 2)")],
}

# K2's backward: one line of csrc/tri_pool_backward.cu changed
# mma_tiles summing each tile's pairs and k16 steps in c itself
MMA_FRESH = """        if (k == 0)
          mma_bf16_zero(t[m][n], a[m][PR::a(k)], b0, b1);
        else
          mma_bf16(t[m][n], a[m][PR::a(k)], b0, b1);"""
MMA_CHAINED = """        mma_bf16(c[m][n0 + n], a[m][PR::a(k)], b0, b1);"""
MMA_ADD = """#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[m][n0 + n][e] += t[m][n][e];
"""
KB_VARIANTS = {
    "sums in the tensor cores (no FADD)": [(MMA_FRESH, MMA_CHAINED), (MMA_ADD, "")],
    "all n8 tiles of gw and gvt at once at float32": [
        ("          if constexpr (F32) {\n#pragma unroll\n            for (int np = 0; np < NP; ++np) {",
         "          if constexpr (false) {\n#pragma unroll\n            for (int np = 0; np < NP; ++np) {"),
        ("constexpr int NH = F32 ? 2 : 1;", "constexpr int NH = 1;")],
    "gw flushed before the barrier": [
        ("        if (c > 0) flush(c - 1);\n", "\n"),
        ("          __syncthreads();  // chunk c has landed; chunk c-1 is done everywhere\n        }\n",
         "          __syncthreads();  // chunk c has landed; chunk c-1 is done everywhere\n"
         "          flush(c - 1);\n        }\n")],
    "next unit's operands at its last chunk": [
        ("c == (n_chunks > 1 ? n_chunks - 2 : 0)", "c == n_chunks - 1")],
}
# K2's backward's stamps, block 0's first unit (item, pass): 0 the kernel's
# start, 1 the unit's operands and first chunk landed, 2 gP's planes; for
# chunk c < 8, 3+5c landed, 4+5c w split and a float32 vt split (the
# warp's d), 5+5c U's products (and the next chunk asked for), 6+5c gw's
# (and chunk c-1's gw parts flushed), 7+5c gvt's (stored); 45 the last gw
# part
# flushed, 46 U in shared memory, 48 the unit's end; 47 the kernel's end
KB_FIRST = "if (it == blockIdx.x && pass == 0) "
KB_TIMELINE = [
    ("namespace {\n", STAMPS + "namespace {\n"),
    ("  const int sv = (int)w_sv, sq = (int)w_sq, sa = (int)w_sa;\n",
     "  const int sv = (int)w_sv, sq = (int)w_sq, sa = (int)w_sa;\n"
     "  STAMP(0);\n  STAMP_NS(0);\n"),
    ("      __syncthreads();  // this unit's operands and first chunk have landed\n",
     "      __syncthreads();  // this unit's operands and first chunk have landed\n"
     f"      {KB_FIRST}STAMP(1);\n"),
    ("      float u[2][NT][4];", f"      {KB_FIRST}STAMP(2);\n      float u[2][NT][4];"),
    ("          __syncthreads();  // chunk c has landed; chunk c-1 is done everywhere\n        }\n",
     "          __syncthreads();  // chunk c has landed; chunk c-1 is done everywhere\n"
     f"        }}\n        {KB_FIRST}if (c < 8) STAMP(3 + 5 * c);\n"),
    ("        // the shared addresses of this lane's ldmatrix rows: w's planes and\n",
     f"        {KB_FIRST}if (c < 8) STAMP(4 + 5 * c);\n"
     "        // the shared addresses of this lane's ldmatrix rows: w's planes and\n"),
    ("        // each product's fragments are loaded after the last one's MMAs:\n",
     f"        {KB_FIRST}if (c < 8) STAMP(5 + 5 * c);\n"
     "        // each product's fragments are loaded after the last one's MMAs:\n"),
    ("        // gvt[i, d] = sum_p w[i, p] gP[p, d]: A w ([i][p]), B gP ([d][p]),",
     f"        {KB_FIRST}if (c < 8) STAMP(6 + 5 * c);\n"
     "        // gvt[i, d] = sum_p w[i, p] gP[p, d]: A w ([i][p]), B gP ([d][p]),"),
    ("          __syncwarp();  // the buffer is free for the next stage\n        }\n",
     "          __syncwarp();  // the buffer is free for the next stage\n        }\n"
     f"        {KB_FIRST}if (c < 8) STAMP(7 + 5 * c);\n"),
    ("      flush(n_chunks - 1);\n", f"      flush(n_chunks - 1);\n      {KB_FIRST}STAMP(45);\n"),
    ("      __syncthreads();\n      const int d = d0 + tid;  // a d a thread\n",
     f"      __syncthreads();\n      {KB_FIRST}STAMP(46);\n      const int d = d0 + tid;  // a d a thread\n"),
    ("            gat[((size_t)b * A + l) * D + d] = from_f32<TQ>(m[l] * ge);\n        }\n      }\n",
     "            gat[((size_t)b * A + l) * D + d] = from_f32<TQ>(m[l] * ge);\n"
     f"        }}\n      }}\n      {KB_FIRST}STAMP(48);\n"),
]
KB_END = "\n// gw[b, e] = sum over the spans s, in order, of part[b, s, e]"
# (label, B, Q, A, vt dtype, qt/at dtype) of K2's backward in section 4
KB_SHAPES = (("B=256", 256, Q, A, "f32", "f32"),
             ("B=256 bf16 glimpse 0", 256, Q, A, "bf16", "bf16"),
             ("MC 256 rows, Q*A=72", 256, Q, 6, "f32", "f32"),
             ("MC 256 rows, Q*A=72, bf16 glimpse 0", 256, Q, 6, "bf16", "bf16"))


def edited(source: str, edits) -> str:
    for old, new in edits:
        if old not in source:
            raise SystemExit(f"probe: the source no longer has {old!r}")
        source = source.replace(old, new, 1)
    return source


REGISTERS = {}  # K2 backward library: {kernel: registers a thread}


def build_all(sources):
    """Compile {name: source text} side by side; {name: ctypes library}."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        (PROBE_DIR / header.name).write_bytes(header.read_bytes())
    jobs = {}
    for name, text in sources.items():
        cu = PROBE_DIR / f"{name}.cu"
        cu.write_text(text)
        jobs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(PROBE_DIR / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"probe: {name} did not build\n{out}")
        spills = sorted({line.strip() for line in out.splitlines()
                         if "spill" in line and " 0 bytes spill stores" not in line})
        if spills:
            print(f"{name}: spills {spills}")
        if name.startswith("kb"):
            fn, REGISTERS[name] = None, {}
            for line in out.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                fn = m.group(1) if m else fn
                m = re.search(r"Used (\d+) registers", line)
                if m and fn:
                    REGISTERS[name][fn] = int(m.group(1))
        lib = ctypes.CDLL(str(PROBE_DIR / f"lib{name}.so"))
        kernel = {"k1": "rank_softmax", "k2": "tri_pool",
                  "k3": "softmax_vqa", "kb": "tri_pool_backward"}[name[:2]]
        for fn, argtypes in build.ENTRY_POINTS[kernel].items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs


def inputs(b: int, dev: torch.device):
    g = torch.Generator(device=dev).manual_seed(b)
    v_r = torch.randn(b, V, R, X, device=dev, generator=g)
    tqa = torch.randn(b, Q, A, R, X, G, device=dev, generator=g) / (R * X) ** 0.5
    mask = torch.zeros(b, V, dtype=torch.bool, device=dev)
    mask[:, :REAL] = True
    vt = torch.randn(b, V, D, device=dev, generator=g)
    qt = torch.randn(b, Q, D, device=dev, generator=g)
    at = torch.randn(b, A, D, device=dev, generator=g)
    att = torch.rand(b, V, Q, A, G, device=dev, generator=g)
    return (v_r, tqa, mask), (vt, qt, at, att[..., 0])


# the instances of each kernel a library is timed at: K1 float32 and with
# bf16 operands; K2 float32 and with bf16 vt, qt/at bf16 (glimpse 0) or
# float32 (glimpse 1), as the bf16 model passes them
INSTANCES = {"k1": ("f32", "bf16"),
             "k2": ("f32", "bf16 glimpse 0", "bf16 glimpse 1")}


def caller(name, lib, k1, k2, inst="f32"):
    """The bare launch of library ``lib``'s kernel on these inputs (cast
    for instance ``inst`` of :data:`INSTANCES`) and the plain version's
    output to hold it to."""
    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    bf = torch.bfloat16
    if name.startswith("k1"):
        v_r, tqa, mask = k1
        fn = lib.rank_softmax_forward
        if inst != "f32":
            v_r, tqa, fn = v_r.to(bf), tqa.to(bf), lib.rank_softmax_forward_bf16
        out = torch.empty(*v_r.shape[:2], Q, A, G, device=v_r.device)
        b = v_r.shape[0]
        return out, K.fused_rank_softmax_ref(v_r, tqa, mask), lambda: fn(
            v_r.data_ptr(), tqa.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, V, R * X, Q * A, G, 0, stream())
    vt, qt, at, w = k2
    out = torch.empty(vt.shape[0], D, device=vt.device)
    args = (vt.shape[0], V, Q, A, D)
    fn = lib.tri_pool_forward
    if inst != "f32":
        vt = vt.to(bf)
        if inst.endswith("glimpse 0"):
            qt, at = qt.to(bf), at.to(bf)
        args += (int(qt.dtype == bf),)
        fn = lib.tri_pool_forward_bf16
    return out, K.trilinear_pool_ref(vt, qt, at, w), lambda: fn(
        vt.data_ptr(), qt.data_ptr(), at.data_ptr(), w.data_ptr(), *w.stride(),
        out.data_ptr(), *args, 0, stream())


def softmax_calls(lib, b: int, dev: torch.device):
    """Bare launches of library ``lib``'s K3 forward and softmax backward
    at the model's shapes for ``b`` samples, each on its own copy of the
    inputs and outputs, enough copies to exceed the L2; with the plain
    versions' outputs to hold the first copy's to."""
    g = torch.Generator(device=dev).manual_seed(b)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    shape = (b, V, Q, A, G)
    mask = torch.zeros(b, V, dtype=torch.bool, device=dev)
    mask[:, :REAL] = True
    n_copies = copies_for(5 * b * V * Q * A * G * 4)
    fwd, bwd, first = [], [], None
    for _ in range(n_copies):
        logits = 3 * torch.randn(shape, device=dev, generator=g)
        cot = torch.randn(shape, device=dev, generator=g)
        att_in = K.masked_softmax_vqa_ref(logits, mask)
        att, dl = torch.empty_like(logits), torch.empty_like(logits)
        fwd.append(lambda lg=logits, o=att: lib.masked_softmax_vqa_forward(
            lg.data_ptr(), mask.data_ptr(), o.data_ptr(), b, V, Q * A, G, 0,
            stream))
        bwd.append(lambda a=att_in, c=cot, o=dl: lib.softmax_vqa_backward(
            a.data_ptr(), c.data_ptr(), o.data_ptr(), b, V, Q * A, G, 0,
            stream))
        if first is None:
            first = ((att, K.masked_softmax_vqa_ref(logits, mask)),
                     (dl, K.softmax_vqa_backward_ref(att_in, cot)))
    return fwd, bwd, first


def backward_call(lib, label, b, q, a, vt_dtype, qa_dtype, dev, f64=False):
    """The bare launch of library ``lib``'s K2 backward on seeded inputs
    of shape ``label`` (one strided glimpse of ``w``), its outputs, and
    the plain version's to hold them to (with ``f64``, and the plain
    version's in float64 last)."""
    g = torch.Generator(device=dev).manual_seed(b + q * a)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    vt, qt, at = (torch.randn(b, n, D, device=dev, generator=g).to(dt[x])
                  for n, x in ((V, vt_dtype), (q, qa_dtype), (a, qa_dtype)))
    w = torch.rand(b, V, q, a, G, device=dev, generator=g)[..., 0]
    cot = torch.randn(b, D, device=dev, generator=g)
    outs = [torch.empty_like(x) for x in (vt, qt, at)] + [
        torch.empty(b, V, q, a, device=dev)]
    floats = ctypes.c_longlong()
    assert lib.tri_pool_backward_scratch(b, V, q, a, D, int(vt_dtype == "bf16"),
                                         ctypes.addressof(floats)) == 0
    scratch = torch.empty(floats.value, device=dev)
    args = [cot.data_ptr(), vt.data_ptr(), qt.data_ptr(), at.data_ptr(),
            w.data_ptr(), *w.stride(), *(x.data_ptr() for x in outs),
            scratch.data_ptr(), scratch.numel(), b, V, q, a, D]
    fn = lib.tri_pool_backward
    if vt_dtype == "bf16":
        fn, args = lib.tri_pool_backward_bf16, args + [int(qa_dtype == "bf16")]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    # the launch holds its tensors: it passes only their addresses
    held = (cot, vt, qt, at, w, outs, scratch)
    call = (outs, K.trilinear_pool_grads(cot, vt, qt, at, w),
            lambda held=held: fn(*args, 0, stream))
    if f64:
        call += (K.trilinear_pool_grads(cot, vt, qt, at, w, dtype=torch.float64),)
    return call


def stage_loop_mix(lib_path) -> str:
    """The instruction mix of the float32 <12, 3> backward's stage loop:
    the shortest backward branch's span that holds all its HMMA."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    body = next(f for f in sass.split("Function : ")
                if f.startswith("_ZN") and "kernelIffLi12ELi3E" in f.split()[0])
    ins = re.findall(r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)"
                     r"([^;]*);", body)
    at = {int(x, 16): i for i, (x, _, _) in enumerate(ins)}
    best = None
    for i, (x, op, rest) in enumerate(ins):
        target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if target and int(target.group(1), 16) < int(x, 16):
            ops = collections.Counter(o for _, o, _ in ins[at[int(target.group(1), 16)]:i + 1])
            if best is None or (ops["HMMA"], -sum(ops.values())) > (
                    best["HMMA"], -sum(best.values())):
                best = ops
    rest = {o: n for o, n in best.most_common(12) if o not in ("HMMA", "FFMA")}
    return (f"{sum(best.values())} instructions a stage, {best['HMMA']} HMMA, "
            f"{best['FFMA']} FFMA; the rest {rest}")


def kb_residency(source: str, regs: int, f32: bool, nq: int, na: int,
                 qt_bytes: int) -> str:
    """Blocks and warps a scheduler that K2's backward (``source``'s WARPS
    and STAGES; Smem's layout) keeps on an H100 SM at ``regs`` registers a
    thread for the instance <nq, na> with vt float32 (``f32``) or bf16 and
    qt of ``qt_bytes``: 64K registers and 228 KB of shared memory (1 KB of
    it a block's own) an SM, 4 schedulers."""
    warps, stages = (int(re.search(rf"constexpr int {k} = (\d+);", source).group(1))
                     for k in ("WARPS", "STAGES"))
    span, vr, pairs = 32 * warps, 16, nq * na
    prow = -(-pairs // 16) * 16 + 8
    smem = (stages * vr * ((span * 4 if f32 else (span + 8) * 2) + pairs * 4)
            + (3 * vr * (span + 8) * 2 if f32 else 0) + 3 * vr * prow * 2
            + 3 * span * prow * 2 + (2 if f32 else 3) * warps * vr * 40 * 4
            + na * span * 4 + 2 * ((nq + na) * span * qt_bytes + span * 4))
    blocks = min(65536 // (-(-regs // 8) * 8 * 32 * warps), 233472 // (smem + 1024))
    return (f"{regs} registers, {smem} bytes of shared memory: {blocks} blocks, "
            f"{blocks * warps / 4:g} warps a scheduler")


def clocks_while(launch, seconds: float = 2.0) -> str:
    """``nvidia-smi``'s SM clock and power samples (every 200 ms) while
    ``launch`` runs back to back for ``seconds``."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            launch()
        torch.cuda.synchronize()
    smi.terminate()
    samples = smi.communicate()[0].strip().splitlines()
    return "; ".join(samples[2:-1])


def timeline(lib, kind, k1, k2, inst, last, flush):
    """Run the stamped kernel of ``lib`` once, cold L2, after 3 warm runs;
    its stamps in µs from the first and the SM's cycles per µs (from
    ``%globaltimer`` between stamp 0 and stamp ``last``)."""
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    _, _, launch = caller(kind, lib, k1, k2, inst)
    for _ in range(3):
        launch()
    flush.zero_()
    torch.cuda._sleep(1_000_000)
    launch()
    torch.cuda.synchronize()
    clk = np.zeros(64, np.int64)
    ns = np.zeros(2, np.uint64)
    assert lib.probe_read(clk.ctypes.data, ns.ctypes.data) == 0
    per_us = (clk[last] - clk[0]) / ((int(ns[1]) - int(ns[0])) / 1e3)
    return (clk - clk[0]) / per_us, per_us


def kb_timeline(lib, shape, flush, dev) -> str:
    """K2's backward's stamps (:data:`KB_TIMELINE`) for block 0's first
    unit of one cold-L2 launch at ``shape`` (a :data:`KB_SHAPES` entry), in
    µs from the kernel's start, after 3 warm runs."""
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    _, _, launch = backward_call(lib, *shape, dev)
    for _ in range(3):
        launch()
    flush.zero_()
    torch.cuda._sleep(1_000_000)
    launch()
    torch.cuda.synchronize()
    clk = np.zeros(64, np.int64)
    ns = np.zeros(2, np.uint64)
    assert lib.probe_read(clk.ctypes.data, ns.ctypes.data) == 0
    us = (clk - clk[0]) / ((clk[47] - clk[0]) / ((int(ns[1]) - int(ns[0])) / 1e3))
    n_chunks = -(-V // 16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = "; ".join("/".join(f"{us[3 + 5 * c + k]:.2f}" for k in range(5))
                       for c in range(n_chunks))
    return (f"operands and first chunk landed {us[1]:.2f}, gP's planes {us[2]:.2f}; "
            f"chunk landed/split/U/gw/gvt {chunks}; last gw flushed {us[45]:.2f}; "
            f"U stored {us[46]:.2f}; unit done {us[48]:.2f}; the block's "
            f"{-(-shape[1] * (D // 256) // sms)} items done {us[47]:.2f}")


def stamped(source, edits, kernel_end, last):
    """``source`` with the stamp ``edits``, the last stamp (``last``) at
    the closing brace of the kernel that ends before ``kernel_end``, and
    the function that reads the stamps."""
    text = edited(source, edits) + READ_STAMPS
    close = text.rindex("}\n", 0, text.index(kernel_end))
    return (text[:close] + f"  STAMP({last});\n  STAMP_NS(1);\n"
            + text[close:])


def main() -> int:
    if not torch.cuda.is_available():
        print("probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    k1_src = (build.CSRC / "rank_softmax.cu").read_text()
    k2_src = (build.CSRC / "tri_pool.cu").read_text()
    k3_src = (build.CSRC / "softmax_vqa.cu").read_text()
    k1_cuda_cores = edited(k1_src, K1_CUDA_CORES)
    k2_cuda_cores = edited(k2_src, K2_CUDA_CORES)
    f32, bf = ("f32",), ("bf16",)
    k2_bf = INSTANCES["k2"][1:]
    # name: (source, the instances its K1 or K2 is timed at)
    sources = {
        "k1_timeline": (stamped(k1_cuda_cores, TIMELINE, KERNEL_END, 43), ()),
        "k1_mma_timeline": (stamped(k1_src, K1_MMA_TIMELINE, K1_MMA_END, 43), ()),
        "k1_mma_cp_async_timeline": (stamped(
            edited(k1_src, K1_MMA_VARIANTS["16-byte cp.async copies"]),
            K1_MMA_TIMELINE, K1_MMA_END, 43), ()),
        "k2_timeline": (stamped(k2_cuda_cores, K2_TIMELINE, K2_KERNEL_END, 3), ()),
        "k2_mma_timeline": (stamped(k2_src, K2_MMA_TIMELINE, K2_MMA_END, 4), ()),
        "k1 shipped": (k1_src, INSTANCES["k1"]),
        "k1 CUDA-core design": (k1_cuda_cores, bf),
        "k2 shipped": (k2_src, INSTANCES["k2"]),
        "k2 CUDA-core design": (k2_cuda_cores, k2_bf)}
    sources.update({f"k1 {n}": (edited(k1_src, e), f32)
                    for n, e in K1_VARIANTS.items()})
    sources.update({f"k1 mma {n}": (edited(k1_src, e), bf)
                    for n, e in K1_MMA_VARIANTS.items()})
    sources.update({f"k2 {n}": (edited(k2_src, e), f32)
                    for n, e in K2_VARIANTS.items()})
    sources.update({f"k2 mma {n}": (edited(k2_src, e), k2_bf)
                    for n, e in K2_MMA_VARIANTS.items()})
    sources["k3 shipped, 8 floats a thread"] = (k3_src, ())
    sources.update({f"k3 {n}": (edited(k3_src, e), ())
                    for n, e in K3_VARIANTS.items()})
    kb_src = (build.CSRC / "tri_pool_backward.cu").read_text()
    sources["kb shipped"] = (kb_src, ())
    sources["kb_timeline"] = (stamped(kb_src, KB_TIMELINE, KB_END, 47), ())
    sources.update({f"kb {n}": (edited(kb_src, e), ())
                    for n, e in KB_VARIANTS.items()})
    libs = build_all({n.replace(" ", "_").replace(",", "").replace("(", "")
                      .replace(")", ""): src for n, (src, _) in sources.items()})
    names = dict(zip(libs, sources))
    insts = {key: sources[n][1] for key, n in names.items()}

    flush = torch.empty(128 * 2**20 // 4, device=dev)
    cycles_per_ms = sleep_cycles_per_ms()
    tiny = [torch.zeros(1, device=dev) for _ in range(20)]
    floor, _ = time_ms(tiny[0].zero_, flush, cycles_per_ms)
    floor_b2b = time_back_to_back_ms([x.zero_ for x in tiny], cycles_per_ms)
    print(f"a launch with no work (4-byte zero_), cold L2: {floor * 1e3:.1f} µs; "
          f"back to back: {floor_b2b * 1e3:.2f} µs a launch")
    with torch.inference_mode():
        for b in (1, 128):
            k1, k2 = inputs(b, dev)
            for key, inst, n_chunks in (
                    ("k1_timeline", "f32", R * X // 32),
                    ("k1_timeline", "bf16", R * X // 32),
                    ("k1_mma_timeline", "bf16", R * X // 64),
                    ("k1_mma_cp_async_timeline", "bf16", R * X // 64)):
                us, per_us = timeline(libs[key], "k1", k1, k2, inst, 43, flush)
                chunks = " ".join(f"{us[2 + 2 * c]:.1f}/{us[3 + 2 * c]:.1f}"
                                  for c in range(n_chunks))
                steps = (("max and sum", "block reduction") if "mma" not in key
                         else ("masked and the thread's max",
                               "block max, exponentials and sums"))
                design = ("CUDA-core design" if "mma" not in key else
                          "tensor cores, 16-byte cp.async" if "cp_async" in key
                          else "tensor cores, TMA")
                split = ("" if "mma" not in key else
                         f" (maxima exchanged {us[44]:.2f}, exponentials "
                         f"{us[45]:.2f})")
                print(f"K1 {inst} ({design}) timeline, block 0 at B={b} (µs "
                      f"from its start, {per_us:.0f} cycles/µs): first stages "
                      f"requested {us[1]:.2f}; chunk landed/multiplied "
                      f"{chunks}; loop done {us[40]:.2f}; {steps[0]} "
                      f"{us[41]:.2f}; {steps[1]} {us[42]:.2f}{split}; "
                      f"normalised {us[43]:.2f}")
        k1, k2 = inputs(128, dev)
        for inst in INSTANCES["k2"]:
            us, per_us = timeline(libs["k2_timeline"], "k2", k1, k2, inst, 3,
                                  flush)
            print(f"K2 {inst} (CUDA-core design for bf16) timeline, block 0 at "
                  f"B=128 (µs from its start): V loop done {us[1]:.2f}; qt "
                  f"epilogue {us[2]:.2f}; output written {us[3]:.2f}")
        for inst in INSTANCES["k2"][1:]:
            us, per_us = timeline(libs["k2_mma_timeline"], "k2", k1, k2, inst,
                                  4, flush)
            steps = " ".join(f"{us[10 + k]:.2f}" for k in range(D // 256))
            print(f"K2 {inst} (tensor cores) timeline, block 0 at B=128 (µs "
                  f"from its start): the first step's operands and w in "
                  f"shared memory {us[1]:.2f}; w split {us[2]:.2f}; the first "
                  f"step's products {us[3]:.2f}; steps done {steps}; end "
                  f"{us[4]:.2f}")
        for b in (1, 128, 256):
            k1, k2 = inputs(b, dev)
            row = []
            for key, lib in libs.items():
                for inst in insts[key]:
                    out, want, launch = caller(key, lib, k1, k2, inst)
                    assert launch() == 0
                    torch.cuda.synchronize()
                    err = ((out - want).abs().max() / want.abs().max()).item()
                    if err > 2e-4:
                        raise SystemExit(f"probe: {names[key]} {inst} is off "
                                         f"by {err:.2e}")
                    ms, _ = time_ms(launch, flush, cycles_per_ms)
                    row.append(f"{names[key]} {inst} {ms * 1e3:.1f}")
            print(f"B={b}, µs, cold L2: " + "; ".join(row))
        for b in (128, 256):
            for key, lib in libs.items():
                if not key.startswith("k3"):
                    continue
                fwd, bwd, first = softmax_calls(lib, b, dev)
                times = []
                for calls, (out, want) in zip((fwd, bwd), first):
                    assert calls[0]() == 0
                    torch.cuda.synchronize()
                    err = (out - want).abs().max().item()
                    if err > 1e-5:
                        raise SystemExit(f"probe: {names[key]} is off by {err:.2e}")
                    ms, _ = time_ms(calls[0], flush, cycles_per_ms)
                    b2b = time_back_to_back_ms(calls * -(-20 // len(calls)),
                                               cycles_per_ms)
                    times.append(f"{ms * 1e3:.1f} / {b2b * 1e3:.2f}")
                print(f"B={b} {names[key]}, µs single call / back to back: "
                      f"K3 {times[0]}, softmax backward {times[1]}")
        for label, *shape in KB_SHAPES:
            row = []
            for key, lib in libs.items():
                if not key.startswith("kb") or key == "kb_timeline":
                    continue
                f32 = shape[3] == "f32"
                outs, want, launch, *ref = backward_call(lib, label, *shape, dev, f32)
                assert launch() == 0
                torch.cuda.synchronize()
                rel = 1e-4 if f32 else 2.0 ** -7
                err = max(((x.float() - y).abs().max() / y.abs().max()).item()
                          for x, y in zip(outs, want))
                if err > rel:
                    raise SystemExit(f"probe: {names[key]} is off by {err:.2e}")
                # each cotangent's float64 error over the plain version's
                vs64 = "" if not f32 else " (float64 error / the plain version's " + " ".join(
                    f"{(x.double() - r).abs().max().item() / (y.double() - r).abs().max().item():.2f}"
                    for x, y, r in zip(outs, want, ref[0])) + ")"
                ms, _ = time_ms(launch, flush, cycles_per_ms)
                row.append(f"{names[key]} {ms * 1e3:.1f}{vs64}")
            print(f"K2 backward {label}, µs, cold L2: " + "; ".join(row))
        print(f"K2 backward, float32 <12, 3> stage loop: "
              f"{stage_loop_mix(PROBE_DIR / 'libkb_shipped.so')}")
        for key in libs:
            if not key.startswith("kb") or key == "kb_timeline":
                continue
            for fn, regs in REGISTERS[key].items():
                m = re.search(r"mma_kernelI(\w+?)Li(\d+)ELi(\d+)E", fn)
                if m:
                    print(f"K2 backward {names[key]} <{m.group(2)}, {m.group(3)}> "
                          f"{'float32' if m.group(1) == 'ff' else 'bf16 vt'}"
                          f"{', qt bf16' if 'S1_' in m.group(1) else ''}: "
                          + kb_residency(sources[names[key]][0], regs,
                                         m.group(1) == "ff", int(m.group(2)),
                                         int(m.group(3)),
                                         2 if "S1_" in m.group(1) else 4))
        for shape in KB_SHAPES:
            print(f"K2 backward {shape[0]} timeline, block 0 (µs from its start): "
                  + kb_timeline(libs["kb_timeline"], shape, flush, dev))
        _, _, launch = backward_call(libs["kb_shipped"], *KB_SHAPES[0], dev)
        print(f"K2 backward at B=256 back to back, nvidia-smi clocks.sm, "
              f"clocks.max.sm, power.draw: {clocks_while(launch)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
