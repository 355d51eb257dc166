// Pairwise Gaunt collocation kernel for Hopper (sm_90a), f32 storage and
// f32 FMAs.
//
// Replaces the TPU kernel `repro/kernels/gaunt_fused.py::_kernel` (line 116;
// launched by the pallas_call in `gaunt_fused_pallas`).  For every row b,
//
//     out[b, :] = ((x1[b, :] . T1) * (x2[b, :] . T2)) . P
//
// with T1 [d1, G], T2 [d2, G] the operands' real SH sampled on the product
// grid and P [G, dout] the projection back to SH degrees <= Lout.  The
// wrapper passes the grid folded to its distinct sphere points
// (`constants.pair_matrices`): the torus grid covers the sphere twice, so
// G = 314 of the 676 torus samples at L = (6, 6, 6).  Sizes the kernel
// takes: d up to 81 (L = 8), dout up to 304, any G.
//
// Bound on the H100 at the full-width shape, (L1, L2, Lout) = (6, 6, 6),
// 81,920 rows (640 nodes x 128 channels), d1 = d2 = dout = 49, G = 314.
// The fewest operations of the exact algorithms are the sparse
// contraction's over the real Gaunt tensor: 6,460 nonzeros in 2,337
// (i, j) pairs, so one product per pair and one FMA per nonzero,
//   operations per row = 2,337 + 2 * 6,460 = 15,257 FLOP
//   bytes per row      = 4*(d1 + d2 + dout) = 588 B
// That is 1.250 GFLOP and 48.2 MB: 0.0187 ms at 67 TFLOP/s of f32 against
// 0.0144 ms at 3.35 TB/s, so the bound is set by f32 operations.  This
// kernel runs the collocation algorithm instead, 2*G*(d1 + d2) (sampling)
// + G (product) + 2*G*dout (projection) = 92,630 FLOP per row (0.113 ms of
// f32 FMAs alone): x6 the sparse count at this shape, but dense and
// regular where the sparse one gathers scattered nonzeros.  Both of its stages
// are real products (K = d for the sampling, K = G for the projection);
// tensor cores in TF32 would break the port's f32 parity tier, and a
// 3xTF32 wgmma split is later work.
//
// Design.  The TPU kernel keeps T1, T2 and P whole in VMEM for each row
// block; at L = 8 they are 375 KB each, above a Hopper block's 227 KB.  So
// the sample axis is a loop inside the block, and the output tile persists
// in registers across sample tiles.  One block takes ROWS = 64 rows with
// 256 threads (a 16 x 16 thread grid):
//   - the block's x1 and x2 rows are staged once in shared memory,
//     transposed ([k][row]) so a thread reads its 4 rows as one float4;
//   - per tile of 64 samples, T1, T2 and P are staged in shared memory
//     (samples past G and output columns past dout are zero);
//   - stage 1: each thread forms a 4 rows x 4 samples micro-tile of
//     x1 . T1 and of x2 . T2 (register-tiled outer products over k) and
//     writes their product V to shared memory;
//   - stage 2: each thread accumulates a 4 rows x TN columns micro-tile of
//     V . P, columns tx + 16 j, in registers (TN = ceil(dout / 16), a
//     template parameter rounded up to an instantiated size).
// Rows past B are read as zero and never written: the wrapper does not pad.
// Shared memory at (6, 6, 6) is 85 KB, so two blocks share an SM; at
// (8, 8, 16) it is 181 KB.
//
// Interface: plain C, loaded with ctypes.  The launch uses the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;             // rows per block
constexpr int kTile = 64;             // samples per tile
constexpr int kXS = kRows + 4;        // row stride of the transposed x tiles
constexpr int kVS = kTile + 4;        // row stride of the product tile
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kTNs[] = {1, 2, 3, 4, 6, 8, 11, 13, 16, 19};

__host__ __device__ inline size_t smem_floats(int d1, int d2, int tn) {
  return (size_t)(d1 + d2) * kXS      // x1^T, x2^T [d][row]
       + (size_t)(d1 + d2) * kTile    // T1, T2 tiles [d][sample]
       + (size_t)kTile * 16 * tn      // P tile [sample][16 TN]
       + (size_t)kRows * kVS;         // product tile [row][sample]
}

inline int pick_tn(int dout) {
  const int need = (dout + 15) / 16;
  for (int tn : kTNs)
    if (tn >= need) return tn;
  return 0;
}

template <int TN>
__global__ void __launch_bounds__(kThreads)
gaunt_pair_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                  const float* __restrict__ T1, const float* __restrict__ T2,
                  const float* __restrict__ P, float* __restrict__ out,
                  int B, int d1, int d2, int G, int dout) {
  constexpr int PS = 16 * TN;
  extern __shared__ __align__(16) float smem[];
  float* sX1 = smem;
  float* sX2 = sX1 + (size_t)d1 * kXS;
  float* sT1 = sX2 + (size_t)d2 * kXS;
  float* sT2 = sT1 + (size_t)d1 * kTile;
  float* sP = sT2 + (size_t)d2 * kTile;
  float* sV = sP + (size_t)kTile * PS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);

  // the block's rows, transposed; zero past the ragged edge
  for (int e = tid; e < kRows * d1; e += kThreads) {
    const int r = e / d1;
    const int k = e - r * d1;
    sX1[k * kXS + r] = r < nrows ? x1[(size_t)(row0 + r) * d1 + k] : 0.f;
  }
  for (int e = tid; e < kRows * d2; e += kThreads) {
    const int r = e / d2;
    const int k = e - r * d2;
    sX2[k * kXS + r] = r < nrows ? x2[(size_t)(row0 + r) * d2 + k] : 0.f;
  }

  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int g0 = 0; g0 < G; g0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < d1 * kTile; e += kThreads) {
      const int k = e / kTile;
      const int g = e - k * kTile;
      sT1[e] = g0 + g < G ? T1[(size_t)k * G + g0 + g] : 0.f;
    }
    for (int e = tid; e < d2 * kTile; e += kThreads) {
      const int k = e / kTile;
      const int g = e - k * kTile;
      sT2[e] = g0 + g < G ? T2[(size_t)k * G + g0 + g] : 0.f;
    }
    for (int e = tid; e < kTile * PS; e += kThreads) {
      const int g = e / PS;
      const int c = e - g * PS;
      sP[e] = (g0 + g < G && c < dout) ? P[(size_t)(g0 + g) * dout + c] : 0.f;
    }
    __syncthreads();

    // stage 1: V[4 rows][4 samples] = (x1 . T1) * (x2 . T2)
    float v1[4][4], v2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v1[i][j] = v2[i][j] = 0.f;
    for (int k = 0; k < d1; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(sX1 + k * kXS + ty * 4);
      const float4 t = *reinterpret_cast<const float4*>(sT1 + k * kTile + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v1[i][j] = fmaf(av[i], tv[j], v1[i][j]);
    }
    for (int k = 0; k < d2; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(sX2 + k * kXS + ty * 4);
      const float4 t = *reinterpret_cast<const float4*>(sT2 + k * kTile + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v2[i][j] = fmaf(av[i], tv[j], v2[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 o = make_float4(v1[i][0] * v2[i][0], v1[i][1] * v2[i][1],
                                   v1[i][2] * v2[i][2], v1[i][3] * v2[i][3]);
      *reinterpret_cast<float4*>(sV + (ty * 4 + i) * kVS + tx * 4) = o;
    }
    __syncthreads();

    // stage 2: acc[4 rows][TN columns] += V . P over the tile's samples
    for (int g = 0; g < kTile; g += 4) {
      float vv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 q = *reinterpret_cast<const float4*>(sV + (ty * 4 + i) * kVS + g);
        vv[i][0] = q.x;
        vv[i][1] = q.y;
        vv[i][2] = q.z;
        vv[i][3] = q.w;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float p[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) p[j] = sP[(g + s) * PS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(vv[i][s], p[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < nrows) {
      float* o = out + (size_t)(row0 + r) * dout;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + 16 * j;
        if (c < dout) o[c] = acc[i][j];
      }
    }
  }
}

template <int TN>
int launch(const float* x1, const float* x2, const float* T1, const float* T2,
           const float* P, float* out, int B, int d1, int d2, int G, int dout,
           cudaStream_t stream) {
  const size_t smem = smem_floats(d1, d2, TN) * sizeof(float);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  // above 48 KB a block needs the opt-in, which holds for the current device
  // only: set it at every such launch (a cheap host call)
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gaunt_pair_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + kRows - 1) / kRows);
  gaunt_pair_kernel<TN><<<grid, kThreads, smem, stream>>>(x1, x2, T1, T2, P, out,
                                                          B, d1, d2, G, dout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) a launch with these sizes uses, or 0 when the sizes
// are outside what the kernel takes.
size_t gaunt_pair_smem_bytes(int d1, int d2, int dout) {
  const int tn = pick_tn(dout);
  if (tn == 0 || d1 <= 0 || d2 <= 0) return 0;
  const size_t bytes = smem_floats(d1, d2, tn) * sizeof(float);
  return bytes > kSmemMax ? 0 : bytes;
}

int gaunt_pair_forward(const void* x1, const void* x2, const void* T1,
                       const void* T2, const void* P, void* out, int B, int d1,
                       int d2, int G, int dout, void* stream) {
  if (B < 0 || G <= 0 || d1 <= 0 || d2 <= 0 || dout <= 0)
    return (int)cudaErrorInvalidValue;
  if (gaunt_pair_smem_bytes(d1, d2, dout) == 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const float* a = static_cast<const float*>(x1);
  const float* b = static_cast<const float*>(x2);
  const float* t1 = static_cast<const float*>(T1);
  const float* t2 = static_cast<const float*>(T2);
  const float* p = static_cast<const float*>(P);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_tn(dout)) {
    case 1: return launch<1>(a, b, t1, t2, p, o, B, d1, d2, G, dout, s);
    case 2: return launch<2>(a, b, t1, t2, p, o, B, d1, d2, G, dout, s);
    case 3: return launch<3>(a, b, t1, t2, p, o, B, d1, d2, G, dout, s);
    case 4: return launch<4>(a, b, t1, t2, p, o, B, d1, d2, G, dout, s);
    case 6: return launch<6>(a, b, t1, t2, p, o, B, d1, d2, G, dout, s);
    case 8: return launch<8>(a, b, t1, t2, p, o, B, d1, d2, G, dout, s);
    case 11: return launch<11>(a, b, t1, t2, p, o, B, d1, d2, G, dout, s);
    case 13: return launch<13>(a, b, t1, t2, p, o, B, d1, d2, G, dout, s);
    case 16: return launch<16>(a, b, t1, t2, p, o, B, d1, d2, G, dout, s);
    case 19: return launch<19>(a, b, t1, t2, p, o, B, d1, d2, G, dout, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
