// n-way Gaunt chain collocation kernel for Hopper (sm_90a), f32 storage.
//
// Replaces the TPU kernel `repro/kernels/gaunt_fused.py::_make_chain_kernel`
// (line 122; launched by `_chain_runner`'s pallas_call).  It computes, for
// every row b,
//
//     out[b, :] = ((prod_i  x_i[b, :] . T_i)  * gs[b] + gb[b]) . P
//
// with T_i [d_i, G] the operand sampling matrices on the alias-free N x N
// torus grid (G = N*N, N = 2*sum(L_i) + 2), P [G, dout] the projection, and
// the optional affine gate (gs, gb) applied to the product samples before
// the projection.  'grid' entries and exits are only other T and P.
//
// Bound on the H100 (main path: n = 3, d_i = 9, G = 196, dout = 9, gated).
// With 'sh' entries the 14 x 14 torus grid covers the sphere twice: only
// Gd = 86 of its G = 196 samples are distinct points, and a repeated point
// has the same product value in every row, so the function needs Gd:
//   operations per row = 2*Gd*sum(d_i) (sampling)  + Gd*(n-1) (product)
//                      + 2*Gd           (gate)     + 2*Gd*dout (projection)
//                      = 4644 + 172 + 172 + 1548 = 6536 FLOP
//   bytes per row      = 4*(sum(d_i) + dout + 2) = 152 B (T and P are
//                        40 KB in all, read once per block from L2)
// At 8192 rows: 54 MFLOP and 1.26 MB, i.e. 0.80 us at 67 TFLOP/s of f32 on
// CUDA cores against 0.38 us at 3.35 TB/s: compute-bound on f32 FMAs, with
// 43 FLOP per byte.  The products are far too thin (K = 9) for wgmma to pay.
// This kernel evaluates all G samples (2.3x the needed operations); folding
// the repeated columns of T and summing their rows of P is exact and left
// for a later change.
//
// Design.  A TPU grid runs in order and can accumulate the output across
// the sample axis; CUDA blocks run in parallel, so the sample loop (g) runs
// inside the block instead.  One block takes ROWS = 32 rows and 256 threads:
//   - the block's x rows are staged once in shared memory;
//   - per tile of GT samples, T_i[:, tile] and P[tile, :] are staged in
//     shared memory (GT = G when everything fits the smem budget: the main
//     path stages all of T and P, 58 KB, one tile);
//   - phase 1: one thread per (row, sample) forms v = prod_i x_i . T_i[:, g]
//     and the gate, writing v to shared memory;
//   - phase 2: one thread per (row, output) accumulates v . P[:, k] into a
//     shared-memory output tile, which persists across sample tiles, so any
//     dout (a grid exit at sum(L) = 6 has dout = 182) and any G fit.
// All shared reads in the inner loops are broadcasts or unit-stride, so
// they are free of bank conflicts.  Occupancy: 8192 rows are 256 blocks on
// 132 SMs, 3 blocks (768 threads) per SM by shared memory.
//
// Interface: plain C, loaded with ctypes.  The launch uses the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxOps = 4;
constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr size_t kSmemBudget = 96 * 1024;         // preferred per-block smem
constexpr size_t kSmemMax = 227 * 1024;           // Hopper's per-block limit

struct ChainArgs {
  const float* x[kMaxOps];
  const float* T[kMaxOps];
  int d[kMaxOps];
  int n;
  const float* P;
  const float* gs;   // null: ungated
  const float* gb;
  float* out;
  int B, G, dout, GT;
};

__host__ __device__ inline size_t smem_floats(int dsum, int gt, int dout) {
  return (size_t)kRows * dsum      // x rows
       + (size_t)dsum * gt         // T tile
       + (size_t)gt * dout         // P tile
       + (size_t)kRows * gt        // product samples
       + (size_t)kRows * dout      // output accumulator
       + 2 * kRows;                // gate scale and shift
}

__global__ void __launch_bounds__(kThreads)
gaunt_chain_kernel(ChainArgs a) {
  extern __shared__ float smem[];
  int dsum = 0;
  for (int i = 0; i < a.n; ++i) dsum += a.d[i];
  float* sX = smem;
  float* sT = sX + kRows * dsum;
  float* sP = sT + (size_t)dsum * a.GT;
  float* sV = sP + (size_t)a.GT * a.dout;
  float* sO = sV + kRows * a.GT;
  float* sG = sO + kRows * a.dout;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, a.B - row0);
  const bool gated = a.gs != nullptr;

  // stage the block's rows of every operand: sX[r][off_i + j]
  int off = 0;
  for (int i = 0; i < a.n; ++i) {
    const int d = a.d[i];
    const float* xg = a.x[i] + (size_t)row0 * d;
    for (int e = tid; e < nrows * d; e += kThreads) {
      const int r = e / d;
      sX[r * dsum + off + (e - r * d)] = xg[e];
    }
    off += d;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    sG[r] = (gated && r < nrows) ? a.gs[row0 + r] : 0.f;
    sG[kRows + r] = (gated && r < nrows) ? a.gb[row0 + r] : 0.f;
  }
  for (int e = tid; e < kRows * a.dout; e += kThreads) sO[e] = 0.f;

  for (int g0 = 0; g0 < a.G; g0 += a.GT) {
    const int gt = min(a.GT, a.G - g0);
    __syncthreads();  // the previous tile's readers are done
    int toff = 0;
    for (int i = 0; i < a.n; ++i) {
      const int d = a.d[i];
      const float* Tg = a.T[i];
      for (int e = tid; e < d * gt; e += kThreads) {
        const int j = e / gt;
        const int g = e - j * gt;
        sT[toff + e] = Tg[(size_t)j * a.G + g0 + g];
      }
      toff += d * gt;
    }
    const float* Pg = a.P + (size_t)g0 * a.dout;
    for (int e = tid; e < gt * a.dout; e += kThreads) sP[e] = Pg[e];
    __syncthreads();

    // phase 1: product samples (and gate) for every (row, sample) of the tile
    for (int e = tid; e < nrows * gt; e += kThreads) {
      const int r = e / gt;
      const int g = e - r * gt;
      const float* xr = sX + r * dsum;
      float v = 1.f;
      int xo = 0, to = 0;
      for (int i = 0; i < a.n; ++i) {
        const int d = a.d[i];
        float s = 0.f;
        for (int j = 0; j < d; ++j) s = fmaf(xr[xo + j], sT[to + j * gt + g], s);
        v *= s;
        xo += d;
        to += d * gt;
      }
      if (gated) v = fmaf(v, sG[r], sG[kRows + r]);
      sV[r * gt + g] = v;
    }
    __syncthreads();

    // phase 2: project the tile's samples into the output accumulator
    for (int e = tid; e < nrows * a.dout; e += kThreads) {
      const int r = e / a.dout;
      const int k = e - r * a.dout;
      const float* vr = sV + r * gt;
      float acc = sO[e];
      for (int g = 0; g < gt; ++g) acc = fmaf(vr[g], sP[g * a.dout + k], acc);
      sO[e] = acc;
    }
  }
  __syncthreads();
  float* og = a.out + (size_t)row0 * a.dout;
  for (int e = tid; e < nrows * a.dout; e += kThreads) og[e] = sO[e];
}

}  // namespace

extern "C" {

// Shared memory (bytes) a launch with these sizes uses, or 0 when no tiling
// of the sample axis fits the per-block limit.
size_t gaunt_chain_smem_bytes(int dsum, int G, int dout, int* gt_out) {
  int gt = G;
  while (gt > 32 && smem_floats(dsum, gt, dout) * sizeof(float) > kSmemBudget)
    gt = ((gt - 1) / 32) * 32;
  const size_t bytes = smem_floats(dsum, gt, dout) * sizeof(float);
  if (gt_out) *gt_out = gt;
  return bytes > kSmemMax ? 0 : bytes;
}

int gaunt_chain_forward(const void* x0, const void* x1, const void* x2,
                        const void* x3, const void* t0, const void* t1,
                        const void* t2, const void* t3, int d0, int d1, int d2,
                        int d3, int n, const void* P, const void* gs,
                        const void* gb, void* out, int B, int G, int dout,
                        void* stream) {
  if (n < 2 || n > kMaxOps || B < 0 || G <= 0 || dout <= 0)
    return (int)cudaErrorInvalidValue;
  ChainArgs a;
  const void* xs[kMaxOps] = {x0, x1, x2, x3};
  const void* ts[kMaxOps] = {t0, t1, t2, t3};
  const int ds[kMaxOps] = {d0, d1, d2, d3};
  int dsum = 0;
  for (int i = 0; i < kMaxOps; ++i) {
    a.x[i] = static_cast<const float*>(xs[i]);
    a.T[i] = static_cast<const float*>(ts[i]);
    a.d[i] = i < n ? ds[i] : 0;
    if (i < n) {
      if (ds[i] <= 0) return (int)cudaErrorInvalidValue;
      dsum += ds[i];
    }
  }
  a.n = n;
  a.P = static_cast<const float*>(P);
  a.gs = static_cast<const float*>(gs);
  a.gb = static_cast<const float*>(gb);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.G = G;
  a.dout = dout;
  const size_t smem = gaunt_chain_smem_bytes(dsum, G, dout, &a.GT);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  // above 48 KB a block needs the opt-in, which holds for the current device
  // only: set it at every such launch (a cheap host call)
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gaunt_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + kRows - 1) / kRows);
  gaunt_chain_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
