// Mamba-2 SSD (state-space duality) scan for Hopper (sm_90a), f32 arithmetic.
//
// Replaces the TPU kernel `repro/kernels/mamba2.py::_ssd_kernel` (line 86;
// launched by the pallas_call in `mamba2_ssd_pallas`).  For every (batch b,
// head h), over the sequence in chunks of C steps (la = cumsum of A dt
// within the chunk, a sequential f32 sum):
//
//     M[i][j] = exp(la_i - la_j) (C_i . B_j) dt_j      (j <= i; 0 above)
//     y       = M x + exp(la) * (C h^T) + D x
//     h      <- exp(la_C) h + (x * exp(la_C - la) dt)^T B
//
// with the state h [P][N] carried from chunk to chunk; it writes the final
// h as well (the prefill -> decode handoff), and adds the D skip, which the
// Pallas kernel leaves outside.  The heads of group g = h / (H/G) share B
// and C, which are read per group (never repeated to the heads).  x, B and
// C are float32 or bfloat16 (read as they are, upcast on load: exact); dt,
// A, D, y and h are float32.  Exponentials are taken only for j <= i, where
// la_i - la_j <= 0, and exp(la), exp(la_C - la) are <= 1: no decay, however
// strong, overflows.  la is summed in order, one f32 add a step, with the
// product and the add kept apart (no FMA), as the plain version does: at
// full width A dt reaches ~-16 a step, la several hundred within a chunk,
// and la_i - la_j cancels, so another summation order would round apart.
//
// Bound on the H100 at zamba2-2.7b's prefill, x [4, 2048, 80, 64], N = 64,
// G = 1: the decay is one scalar per head and step, so the recurrence
// runs in rescaled form (h~ = h / prod a, O(P) a token to rescale): an
// FMA per state entry to add (dt x) B^T and an FMA per entry for y = h C,
// 4 P N FLOP per (token, head), the exact algorithm with the fewest
// operations (the convention of the WKV6 bound): 10.7 GFLOP, 0.160 ms at
// 67 TFLOP/s of f32; the bytes (bf16 x, B, C and f32 dt read once, f32 y
// and h written once) are 0.26 GB, 0.08 ms at 3.35 TB/s.  So operations
// bound it.  This kernel runs the chunked form, ~1.8x the rescaled
// recurrence's operations (C B^T over the lower triangle, recomputed by
// each P tile and each head of a group; M x; C h^T; the h update), all
// out of shared memory in f32 FMAs; tensor cores (3xTF32 splits to hold
// the f32 tier) and one C B^T per group and chunk shared by its heads are
// later work.
//
// Design.  The TPU grid is (B*H, T/C) with the chunk axis sequential and h
// in VMEM scratch; on Hopper the blocks run in no order, so a block owns
// one (b, h) and a tile of 32 of its P columns, and loops over the chunks
// with h in shared memory.  The P columns are independent (y[:, p] and
// h[p, :] need only x[:, p] and the chunk's M), so the tiles of one head
// exchange nothing; each recomputes M.  At full width that is 320 (b, h)
// pairs x 2 tiles = 640 blocks.  256 threads; per chunk:
//   1. stage B, C ([i][n], zero past C and N), x ([i][p]) and dt in f32;
//   2. C B^T: the 136 4 x 4 tiles on or below the diagonal, one per
//      thread, in registers; meanwhile the last thread sums la in order;
//   3. M from those tiles (masked before the exponential); 64 other
//      threads take exp(la_i) and exp(la_C - la_i) dt_i;
//   4. y: thread (ty, tx) forms rows 4ty.. and columns 2tx.. of M x (the
//      loop stops at the diagonal) and of C h^T, adds D x, stores f32;
//   5. h: thread (ty, tx) updates columns 2ty.. and state entries 4tx..
//      of its own h entries.
// Shared memory is 68.5 KB whatever the sizes (strides fixed for 64, rows
// skewed by 4 floats against bank conflicts), so three blocks share an SM.
// C and N up to 64, P any (tiled by 32), H a multiple of G.  x, B and C
// may be views into a wider token row (the model splits them from one
// conv output): each comes with its token stride, and [H][P] or [G][N]
// within a token is dense; y is dense.
//
// Interface: plain C, loaded with ctypes.  The launch uses the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMax = 64;             // chunk C and state size N up to this
constexpr int kPT = 32;              // P columns per block
constexpr int kTile = 4;             // micro-tile side (rows)
constexpr int kSide = kMax / kTile;  // 16
constexpr int kS = kMax + 4;         // row stride of the [i][n], [i][j], [p][n] arrays

constexpr size_t kSmemFloats = (size_t)3 * kMax * kS  // B, C, M
                             + (size_t)kMax * kPT     // x
                             + (size_t)kPT * kS       // h
                             + 4 * kMax;              // la, dt, exp(la), exp(la_C - la) dt

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads, 3)
ssd_kernel(const Tin* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const Tin* __restrict__ Bm,
           const Tin* __restrict__ Cm, const float* __restrict__ D, float* __restrict__ y,
           float* __restrict__ h_out, int T, int H, int P, int G, int N, int C, long long sx,
           long long sb, long long sc) {
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;             // [i][n]
  float* sC = sB + kMax * kS;   // [i][n]
  float* sM = sC + kMax * kS;   // [i][j]
  float* sX = sM + kMax * kS;   // [i][p], row stride kPT
  float* sH = sX + kMax * kPT;  // [p][n]
  float* sla = sH + kPT * kS;   // [i]: la
  float* sdt = sla + kMax;      // [i]: dt
  float* sel = sdt + kMax;      // [i]: exp(la_i)
  float* swd = sel + kMax;      // [i]: exp(la_C - la_i) dt_i

  const int nPT = (P + kPT - 1) / kPT;
  const int pt = blockIdx.x % nPT;
  const int bh = blockIdx.x / nPT;
  const int b = bh / H, hh = bh - b * H;
  const int g = hh / (H / G);
  const int p_base = pt * kPT;
  const int PW = min(kPT, P - p_base);  // live columns of this tile
  const int Np = (N + 3) & ~3;          // N in whole float4s (the padding is zero)
  const int tid = threadIdx.x;
  const int ty = tid / kSide, tx = tid % kSide;
  const float Ah = A[hh];
  const float Dh = D[hh];

  for (int idx = tid; idx < kPT * kS; idx += kThreads) sH[idx] = 0.f;

  // the C B^T tile of this thread: the tid-th 4 x 4 tile on or below the
  // diagonal
  const int nt = (C + kTile - 1) / kTile;
  int ay = 0;
  while ((ay + 1) * (ay + 2) / 2 <= tid) ++ay;
  const int ax = tid - ay * (ay + 1) / 2;
  const bool m_on = tid < nt * (nt + 1) / 2;

  const size_t rowY = (size_t)H * P;  // token stride of y (x's is sx)
  const bool pairs = (P % 2) == 0;     // y rows are float2-aligned

  for (int t0 = 0; t0 < T; t0 += C) {
    const size_t tok0 = (size_t)b * T + t0;

    // 1. stage the chunk in f32, zero past C, N and the tile's columns
    for (int idx = tid; idx < kMax * kMax; idx += kThreads) {
      const int i = idx / kMax, n = idx - i * kMax;
      float bv = 0.f, cv = 0.f;
      if (i < C && n < N) {
        const size_t gn = (size_t)g * N + n;
        bv = to_f(Bm[(tok0 + i) * sb + gn]);
        cv = to_f(Cm[(tok0 + i) * sc + gn]);
      }
      sB[i * kS + n] = bv;
      sC[i * kS + n] = cv;
    }
    for (int idx = tid; idx < kMax * kPT; idx += kThreads) {
      const int i = idx / kPT, p = idx - i * kPT;
      sX[idx] = (i < C && p < PW)
                    ? to_f(x[(tok0 + i) * sx + (size_t)hh * P + p_base + p]) : 0.f;
    }
    if (tid < kMax) sdt[tid] = tid < C ? dt[(tok0 + tid) * H + hh] : 0.f;
    __syncthreads();

    // 2. C B^T on or below the diagonal, in registers; la in order
    float cb[kTile][kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int c = 0; c < kTile; ++c) cb[a][c] = 0.f;
    if (m_on) {
      const int i0 = ay * kTile, j0 = ax * kTile;
      for (int n = 0; n < Np; n += 4) {
        float4 ci[kTile];
#pragma unroll
        for (int a = 0; a < kTile; ++a) ci[a] = ld4(sC + (i0 + a) * kS + n);
#pragma unroll
        for (int c = 0; c < kTile; ++c) {
          const float4 bj = ld4(sB + (j0 + c) * kS + n);
#pragma unroll
          for (int a = 0; a < kTile; ++a) cb[a][c] = dot4(ci[a], bj, cb[a][c]);
        }
      }
    }
    if (tid == kThreads - 1) {
      float run = 0.f;
      for (int i = 0; i < C; ++i) {
        run = __fadd_rn(run, __fmul_rn(Ah, sdt[i]));
        sla[i] = run;
      }
    }
    __syncthreads();

    // 3. M, masked before the exponential; the per-step exponentials
    if (m_on) {
      const int i0 = ay * kTile, j0 = ax * kTile;
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        const int i = i0 + a;
#pragma unroll
        for (int c = 0; c < kTile; ++c) {
          const int j = j0 + c;
          float m = 0.f;
          if (j <= i && i < C) m = expf(sla[i] - sla[j]) * cb[a][c] * sdt[j];
          sM[i * kS + j] = m;
        }
      }
    }
    if (tid >= kThreads - kMax) {
      const int i = tid - (kThreads - kMax);
      float el = 0.f, wd = 0.f;
      if (i < C) {
        el = expf(sla[i]);
        wd = expf(sla[C - 1] - sla[i]) * sdt[i];
      }
      sel[i] = el;
      swd[i] = wd;
    }
    __syncthreads();

    // 4. y rows 4ty.. columns 2tx..: M x + exp(la) (C h^T) + D x
    {
      const int i0 = ty * kTile, p0 = tx * 2;
      if (i0 < C && p0 < PW) {
        float acc[kTile][2], acc2[kTile][2];
#pragma unroll
        for (int a = 0; a < kTile; ++a) {
          acc[a][0] = acc[a][1] = 0.f;
          acc2[a][0] = acc2[a][1] = 0.f;
        }
        const int jn = min(C, i0 + kTile);  // M is zero above the diagonal
        for (int j = 0; j < jn; j += 4) {
          float4 m[kTile];
          float2 xv[4];
#pragma unroll
          for (int a = 0; a < kTile; ++a) m[a] = ld4(sM + (i0 + a) * kS + j);
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = ld2(sX + (j + q) * kPT + p0);
#pragma unroll
          for (int a = 0; a < kTile; ++a) {
            acc[a][0] = fmaf(m[a].x, xv[0].x, acc[a][0]);
            acc[a][1] = fmaf(m[a].x, xv[0].y, acc[a][1]);
            acc[a][0] = fmaf(m[a].y, xv[1].x, acc[a][0]);
            acc[a][1] = fmaf(m[a].y, xv[1].y, acc[a][1]);
            acc[a][0] = fmaf(m[a].z, xv[2].x, acc[a][0]);
            acc[a][1] = fmaf(m[a].z, xv[2].y, acc[a][1]);
            acc[a][0] = fmaf(m[a].w, xv[3].x, acc[a][0]);
            acc[a][1] = fmaf(m[a].w, xv[3].y, acc[a][1]);
          }
        }
        for (int n = 0; n < Np; n += 4) {
          float4 c4[kTile];
#pragma unroll
          for (int a = 0; a < kTile; ++a) c4[a] = ld4(sC + (i0 + a) * kS + n);
          const float4 h0 = ld4(sH + p0 * kS + n);
          const float4 h1 = ld4(sH + (p0 + 1) * kS + n);
#pragma unroll
          for (int a = 0; a < kTile; ++a) {
            acc2[a][0] = dot4(c4[a], h0, acc2[a][0]);
            acc2[a][1] = dot4(c4[a], h1, acc2[a][1]);
          }
        }
#pragma unroll
        for (int a = 0; a < kTile; ++a) {
          const int i = i0 + a;
          if (i < C) {
            const float2 xi = ld2(sX + i * kPT + p0);
            const float v0 = acc[a][0] + sel[i] * acc2[a][0] + Dh * xi.x;
            const float v1 = acc[a][1] + sel[i] * acc2[a][1] + Dh * xi.y;
            float* yp = y + (tok0 + i) * rowY + (size_t)hh * P + p_base + p0;
            if (pairs && p0 + 1 < PW) {
              *reinterpret_cast<float2*>(yp) = make_float2(v0, v1);
            } else {
              yp[0] = v0;
              if (p0 + 1 < PW) yp[1] = v1;
            }
          }
        }
      }
    }
    __syncthreads();

    // 5. h columns 2ty.., state entries 4tx..: exp(la_C) h + (x w)^T B,
    //    own entries only
    {
      const int p0 = ty * 2, n0 = tx * 4;
      if (p0 < PW && n0 < Np) {
        float acc[2][4];
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
        for (int j = 0; j < C; ++j) {
          const float w = swd[j];
          const float2 xv = ld2(sX + j * kPT + p0);
          const float xw0 = xv.x * w, xw1 = xv.y * w;
          const float4 b4 = ld4(sB + j * kS + n0);
          acc[0][0] = fmaf(xw0, b4.x, acc[0][0]);
          acc[0][1] = fmaf(xw0, b4.y, acc[0][1]);
          acc[0][2] = fmaf(xw0, b4.z, acc[0][2]);
          acc[0][3] = fmaf(xw0, b4.w, acc[0][3]);
          acc[1][0] = fmaf(xw1, b4.x, acc[1][0]);
          acc[1][1] = fmaf(xw1, b4.y, acc[1][1]);
          acc[1][2] = fmaf(xw1, b4.z, acc[1][2]);
          acc[1][3] = fmaf(xw1, b4.w, acc[1][3]);
        }
        const float edc = expf(sla[C - 1]);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float* hp = sH + (p0 + c) * kS + n0;
          const float4 h4 = ld4(hp);
          *reinterpret_cast<float4*>(hp) =
              make_float4(edc * h4.x + acc[c][0], edc * h4.y + acc[c][1],
                          edc * h4.z + acc[c][2], edc * h4.w + acc[c][3]);
        }
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < PW * N; idx += kThreads) {
    const int p = idx / N, n = idx - p * N;
    h_out[((size_t)bh * P + p_base + p) * N + n] = sH[p * kS + n];
  }
}

template <typename Tin>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* D, float* y, float* h_out, int Bt, int T, int H, int P, int G,
           int N, int C, long long sx, long long sb, long long sc, cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nPT = (P + kPT - 1) / kPT;
  ssd_kernel<Tin><<<Bt * H * nPT, kThreads, smem, stream>>>(
      static_cast<const Tin*>(x), dt, A, static_cast<const Tin*>(Bm),
      static_cast<const Tin*>(Cm), D, y, h_out, T, H, P, G, N, C, sx, sb, sc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mamba2_ssd_forward(const void* x, const float* dt, const float* A,
                                  const void* Bm, const void* Cm, const float* D, float* y,
                                  float* h_out, int Bt, int T, int H, int P, int G, int N,
                                  int C, long long sx, long long sb, long long sc, int bf16,
                                  cudaStream_t stream) {
  if (Bt <= 0 || T <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || C <= 0 ||
      N > kMax || C > kMax || T % C != 0 || H % G != 0 || sx < (long long)H * P ||
      sb < (long long)G * N || sc < (long long)G * N)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, h_out, Bt, T, H, P, G, N, C, sx,
                                 sb, sc, stream);
  return launch<float>(x, dt, A, Bm, Cm, D, y, h_out, Bt, T, H, P, G, N, C, sx, sb, sc,
                       stream);
}
