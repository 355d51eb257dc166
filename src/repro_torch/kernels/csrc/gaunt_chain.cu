// n-way Gaunt chain collocation kernel for Hopper (sm_90a), f32 FMAs, with
// f32 or bf16 storage of the rows and the sampling matrices.
//
// Replaces the TPU kernel `repro/kernels/gaunt_fused.py::_make_chain_kernel`
// (line 122; launched by `_chain_runner`'s pallas_call), at both of its
// storage dtypes.  It computes, for every row b,
//
//     out[b, :] = ((prod_i  x_i[b, :] . T_i)  * gs[b] + gb[b]) . P
//
// with T_i [d_i, G] the operand sampling matrices, P [G, dout] the
// projection, and the optional affine gate (gs, gb) applied to the product
// samples before the projection.  'grid' entries and exits are only other
// T and P.
//
// The fold.  With 'sh' entries the alias-free N x N torus grid covers the
// sphere twice: (t, p) and (2 pi - t, p + pi) are one point, and each pole
// row is one point.  Two samples at one point have the same product value
// in every row (the gate is per row), so the wrapper passes one sample per
// distinct point with the P rows of its class summed
// (`constants.chain_matrices_folded`): the main path's G = 196 torus samples
// become Gd = 86.  Chains with a 'grid' entry are functions on the torus and
// run unfolded; the kernel takes any G.
//
// Storage (the reference's `sdt`).  With f32 storage every operand is f32.
// With bf16 storage (the force field's compute_dtype='bfloat16') the rows
// x_i and the matrices T_i are bf16, read as bf16 and widened to f32 as
// they are staged; P, the gate scalars, every FMA and the output stay f32,
// as the reference's `preferred_element_type=f32` keeps them.  One template
// over the storage type: nothing but the staging differs.
//
// Bound on the H100 (main path: n = 3, d_i = 9, Gd = 86, dout = 9, gated):
//   operations per row = 2*Gd*sum(d_i) (sampling)  + Gd*(n-1) (product)
//                      + 2*Gd           (gate)     + 2*Gd*dout (projection)
//                      = 4644 + 172 + 172 + 1548 = 6536 FLOP
//   bytes per row      = 4*(sum(d_i) + dout + 2) = 152 B at f32 storage,
//                        2*sum(d_i) + 4*(dout + 2) = 98 B at bf16
// At 8192 rows: 54 MFLOP and 1.26 MB (0.81 MB at bf16), i.e. 0.00080 ms at
// 67 TFLOP/s of f32 on CUDA cores against 0.00038 ms (0.00024 ms) at 3.35
// TB/s: compute-bound on f32 FMAs at either storage.
// The sampling products have K = 9, too thin to pay for tensor cores, and a
// call this small is set by its latency: staging, two phases, launch.
//
// Design.  One block takes ROWS = 64 rows with 256 threads (8192 rows: 128
// blocks, about one an SM):
//   - the block's x rows (transposed, [k][row]) and gate scalars are staged
//     once; per tile of up to GT = 96 samples, T_i[:, tile] and P[tile, :]
//     are staged (the folded main path: all of T and P, 12.4 KB, one tile;
//     larger G loops over tiles);
//   - phase 1, register-tiled: each thread forms 4 rows x 6 samples (rows
//     4 ty .. 4 ty + 3, samples tx + 16 j) of every x_i . T_i from float4
//     reads of x and unit-stride reads of T, multiplies them, applies the
//     gate and writes the product tile to shared memory;
//   - phase 2: four lanes share one row, each summing every fourth sample
//     for 16 output columns at a time (float4 reads of P), and two warp
//     shuffles finish each sum, so no thread walks a G-long dependent chain
//     and all 256 threads take part; the sums add into a shared output tile
//     that persists across sample tiles (any dout: a grid exit at sum(L) =
//     6 has dout = 182), written out coalesced at the end.
// Shared memory at the main shape is 57 KB.
//
// What is left: folding the launch into its neighbours (the call is
// launch- and latency-bound).
//
// Interface: plain C, loaded with ctypes.  The launch uses the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxOps = 4;
constexpr int kRows = 64;
constexpr int kThreads = 256;
constexpr int kRT = 4;                 // rows per thread in phase 1
constexpr int kST = 6;                 // samples per thread in phase 1
constexpr int kGT = 16 * kST;          // samples per tile (16 thread columns)
constexpr int kXS = kRows + 4;         // stride of the transposed x tile
constexpr int kVS = kGT + 4;           // stride of the product tile (4 mod 32)
constexpr int kOC = 16;                // output columns per phase-2 pass
constexpr size_t kSmemMax = 227 * 1024;

// S is the storage type of the rows and of T (float or __nv_bfloat16)
template <typename S>
struct ChainArgs {
  const S* x[kMaxOps];
  const S* T[kMaxOps];
  int d[kMaxOps];
  int n;
  const float* P;
  const float* gs;  // null: ungated
  const float* gb;
  float* out;
  int B, G, dout;
};

// stride of the P tile and of the output tile: dout rounded up to the
// phase-2 pass, plus 4 (float4 rows, no bank conflicts between the four
// lanes of a row)
__host__ __device__ inline int out_stride(int dout) {
  return (dout + kOC - 1) / kOC * kOC + 4;
}

__host__ __device__ inline size_t smem_floats(int dsum, int dout) {
  const int ps = out_stride(dout);
  return (size_t)dsum * kGT      // T tile [k][sample]
       + (size_t)kGT * ps        // P tile [sample][column]
       + (size_t)dsum * kXS      // x rows, transposed [k][row]
       + (size_t)kRows * kVS     // product tile [row][sample]
       + (size_t)kRows * ps      // output accumulator [row][column]
       + 2 * kRows;              // gate scale and shift
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S>
__global__ void __launch_bounds__(kThreads)
gaunt_chain_kernel(ChainArgs<S> a) {
  extern __shared__ __align__(16) float smem[];
  int dsum = 0;
  for (int i = 0; i < a.n; ++i) dsum += a.d[i];
  const int ps = out_stride(a.dout);
  float* sT = smem;
  float* sP = sT + dsum * kGT;
  float* sX = sP + kGT * ps;
  float* sV = sX + dsum * kXS;
  float* sO = sV + kRows * kVS;
  float* sG = sO + kRows * ps;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, a.B - row0);
  const bool gated = a.gs != nullptr;

  // the block's rows of every operand, transposed: sX[off_i + k][r]; zero
  // past the ragged edge
  int off = 0;
  for (int i = 0; i < a.n; ++i) {
    const int d = a.d[i];
    const S* xg = a.x[i] + (size_t)row0 * d;
    for (int e = tid; e < kRows * d; e += kThreads) {
      const int r = e / d;
      const int k = e - r * d;
      sX[(off + k) * kXS + r] = r < nrows ? widen(__ldg(xg + e)) : 0.f;
    }
    off += d;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    sG[r] = (gated && r < nrows) ? a.gs[row0 + r] : 0.f;
    sG[kRows + r] = (gated && r < nrows) ? a.gb[row0 + r] : 0.f;
  }
  for (int e = tid; e < kRows * ps; e += kThreads) sO[e] = 0.f;

  const int tx = tid & 15, ty = tid >> 4;  // phase 1: samples tx + 16 j, rows 4 ty + i
  const int pr = tid >> 2, pl = tid & 3;   // phase 2: row pr, every fourth sample from pl
  for (int g0 = 0; g0 < a.G; g0 += kGT) {
    const int gt = min(kGT, a.G - g0);
    __syncthreads();  // the previous tile's readers are done
    int toff = 0;
    for (int i = 0; i < a.n; ++i) {
      const int d = a.d[i];
      const S* Tg = a.T[i];
      for (int e = tid; e < d * kGT; e += kThreads) {
        const int k = e / kGT;
        const int g = e - k * kGT;
        sT[(toff + k) * kGT + g] = g < gt ? widen(__ldg(Tg + (size_t)k * a.G + g0 + g)) : 0.f;
      }
      toff += d;
    }
    for (int e = tid; e < gt * ps; e += kThreads) {
      const int g = e / ps;
      const int c = e - g * ps;
      sP[e] = c < a.dout ? __ldg(a.P + (size_t)(g0 + g) * a.dout + c) : 0.f;
    }
    __syncthreads();

    // phase 1: the gated product samples of 4 rows x 6 samples a thread
    float v[kRT][kST];
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int j = 0; j < kST; ++j) v[r][j] = 1.f;
    int xo = 0;
    for (int i = 0; i < a.n; ++i) {
      float s[kRT][kST];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int j = 0; j < kST; ++j) s[r][j] = 0.f;
      const int d = a.d[i];
#pragma unroll 3
      for (int k = 0; k < d; ++k) {
        const float4 xv = *reinterpret_cast<const float4*>(sX + (xo + k) * kXS + kRT * ty);
        const float* tr = sT + (xo + k) * kGT + tx;
        const float xs[kRT] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < kST; ++j) {
          const float tv = tr[16 * j];
#pragma unroll
          for (int r = 0; r < kRT; ++r) s[r][j] = fmaf(xs[r], tv, s[r][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int j = 0; j < kST; ++j) v[r][j] *= s[r][j];
      xo += d;
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int row = kRT * ty + r;
      const float sc = gated ? sG[row] : 1.f, sh = sG[kRows + row];
#pragma unroll
      for (int j = 0; j < kST; ++j) sV[row * kVS + tx + 16 * j] = fmaf(v[r][j], sc, sh);
    }
    __syncthreads();

    // phase 2: out[row, c] += sum_g V[row, g] P[g, c], the sample sum split
    // over the four lanes of a row and finished by shuffles
    const float* vr = sV + pr * kVS;
    for (int c0 = 0; c0 < a.dout; c0 += kOC) {
      float acc[kOC];
#pragma unroll
      for (int c = 0; c < kOC; ++c) acc[c] = 0.f;
      for (int g = pl; g < gt; g += 4) {
        const float vv = vr[g];
        const float4* pg = reinterpret_cast<const float4*>(sP + g * ps + c0);
#pragma unroll
        for (int q = 0; q < kOC / 4; ++q) {
          const float4 w = pg[q];
          acc[4 * q] = fmaf(vv, w.x, acc[4 * q]);
          acc[4 * q + 1] = fmaf(vv, w.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(vv, w.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(vv, w.w, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int c = 0; c < kOC; ++c) {
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 1);
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 2);
      }
      // the four lanes hold the same sums: lane pl adds the columns = pl mod 4
#pragma unroll
      for (int c = 0; c < kOC; ++c)
        if ((c & 3) == pl) sO[pr * ps + c0 + c] += acc[c];
    }
  }
  __syncthreads();
  float* og = a.out + (size_t)row0 * a.dout;
  for (int e = tid; e < nrows * a.dout; e += kThreads) {
    const int r = e / a.dout;
    og[e] = sO[r * ps + (e - r * a.dout)];
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) a launch with these sizes uses, or 0 when it is
// above the per-block limit.
size_t gaunt_chain_smem_bytes(int dsum, int dout) {
  if (dsum <= 0 || dout <= 0) return 0;
  const size_t bytes = smem_floats(dsum, dout) * sizeof(float);
  return bytes > kSmemMax ? 0 : bytes;
}

}  // extern "C"

namespace {

template <typename S>
int chain_forward(const void* const* xs, const void* const* ts, const int* ds, int n,
                  const void* P, const void* gs, const void* gb, void* out, int B, int G,
                  int dout, void* stream) {
  if (n < 2 || n > kMaxOps || B < 0 || G <= 0 || dout <= 0)
    return (int)cudaErrorInvalidValue;
  ChainArgs<S> a;
  int dsum = 0;
  for (int i = 0; i < kMaxOps; ++i) {
    a.x[i] = static_cast<const S*>(xs[i]);
    a.T[i] = static_cast<const S*>(ts[i]);
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
  const size_t smem = gaunt_chain_smem_bytes(dsum, dout);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  // above 48 KB a block needs the opt-in, which holds for the current device
  // only: set it at every such launch (a cheap host call)
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gaunt_chain_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + kRows - 1) / kRows);
  gaunt_chain_kernel<S><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows x_i [B, d_i] and T_i [d_i, G] f32 (the `_bf16` entry: bf16); P
// [G, dout], the gate scalars gs, gb [B] (null: ungated) and out [B, dout]
// f32.  Operands past n are ignored.
int gaunt_chain_forward(const void* x0, const void* x1, const void* x2,
                        const void* x3, const void* t0, const void* t1,
                        const void* t2, const void* t3, int d0, int d1, int d2,
                        int d3, int n, const void* P, const void* gs,
                        const void* gb, void* out, int B, int G, int dout,
                        void* stream) {
  const void* xs[kMaxOps] = {x0, x1, x2, x3};
  const void* ts[kMaxOps] = {t0, t1, t2, t3};
  const int ds[kMaxOps] = {d0, d1, d2, d3};
  return chain_forward<float>(xs, ts, ds, n, P, gs, gb, out, B, G, dout, stream);
}

int gaunt_chain_forward_bf16(const void* x0, const void* x1, const void* x2,
                             const void* x3, const void* t0, const void* t1,
                             const void* t2, const void* t3, int d0, int d1, int d2,
                             int d3, int n, const void* P, const void* gs,
                             const void* gb, void* out, int B, int G, int dout,
                             void* stream) {
  const void* xs[kMaxOps] = {x0, x1, x2, x3};
  const void* ts[kMaxOps] = {t0, t1, t2, t3};
  const int ds[kMaxOps] = {d0, d1, d2, d3};
  return chain_forward<__nv_bfloat16>(xs, ts, ds, n, P, gs, gb, out, B, G, dout, stream);
}

}  // extern "C"
