// RWKV6 (Finch) WKV kernel for Hopper (sm_90a), f32 storage and f32 FMAs.
//
// Replaces the TPU kernel `repro/kernels/wkv6.py::_wkv6_kernel` (line 91;
// launched by the pallas_call in `wkv6_pallas`).  For every (batch b,
// head h), over the sequence in chunks of C steps (lw = cumsum of log w
// within the chunk, lw_prev its one-step shift, lw_prev_0 = 0):
//
//     A[i][j] = sum_k r[i][k] k[j][k] exp(lw_prev[i][k] - lw[j][k])  (j < i)
//     A[i][i] = sum_k r[i][k] u[k] k[i][k]
//     o       = A v + (r * exp(lw_prev)) S
//     S      <- exp(lw_C) * S + (k * exp(lw_C - lw))^T v
//
// with the state S [K][V] carried from chunk to chunk, and it writes the
// final S as well (the prefill -> decode handoff).  Exponentials are taken
// only where j < i, of arguments <= 0 (clamped there against rounding), so
// no decay, however strong, gives inf * 0.  Logs and exponentials are base
// 2 (log2 w summed, 2^ of the differences): the same values.
//
// Bound on the H100 at the full-width shape of rwkv6-3b's prefill,
// r, k, w, v [4, 2048, 40, 64] f32 (327,680 (token, head) pairs): the exact
// algorithm with the fewest operations is the sequential recurrence in
// rescaled form, 4 K V = 16,384 FLOP per (token, head), 5.37 GFLOP, 0.080 ms
// at 67 TFLOP/s of f32; the inputs read once and o and S written once are
// 422 MB, 0.126 ms at 3.35 TB/s.  So bytes bound it.  This kernel runs the
// chunked form: per chunk C^2 K / 2 masked exponentials (the special-
// function unit does 16 a clock on an SM) and three C x C x K-sized
// products, all out of shared memory, so its time is set by the
// exponentials and the shared-memory reads, not by the 422 MB.  Tensor
// cores for the three products (3xTF32 or bf16 splits, to hold the f32
// tier) and fewer exponentials (factoring exp(lw_prev_i - lw_j) through a
// sub-chunk boundary) are later work.
//
// Design.  The TPU grid is (B*H, T/C) with the chunk axis sequential and
// S in VMEM scratch; on Hopper the blocks run in no order, so one block
// owns one (b, h) and loops over the chunks, with S in shared memory.
// 256 threads; every product is register-tiled in 4 x 4 micro-tiles read
// as float4 from shared memory.  Per chunk:
//   1. stage r, k and log2 w transposed ([k][i], so 4 consecutive steps
//      are one float4) and v ([i][v]);
//   2. cumsum log2 w along i: 4 threads per k, a segment each, the segment
//      totals passed by warp shuffles;
//   3. A: the 136 tiles on or below the diagonal, one per thread; tiles
//      below it need no mask, the 16 on it mask j > i and take u at j = i;
//      stored transposed for step 5;
//   4. r <- r * 2^lw_prev in place, k * 2^(lw_C - lw) into a [i][k] copy,
//      2^lw_C;
//   5. o: thread (ty, tx) forms rows 4ty.. and columns 4tx.. of A v
//      (A is zero above the diagonal: the loop stops there) plus
//      (r 2^lw_prev) S, and stores them as float4 to device memory;
//   6. S: thread (ty, tx) updates its own 4 x 4 entries of S.
// Shared memory is 102.9 KB whatever C, K and V are (strides fixed for 64),
// so two blocks share an SM: the 160 (b, h) of the full-width shape are all
// resident at once on the 132 SMs.  C = K = V = 64 (the model's shape) is
// compiled with those sizes as constants; other sizes up to 64 (V a
// multiple of 4, for the float4 stores of o) run the same code with them
// read at run time.
//
// Interface: plain C, loaded with ctypes.  The launch uses the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMax = 64;        // K, V and C up to this
constexpr int kTile = 4;        // micro-tile side
constexpr int kSide = kMax / kTile;  // 16 tiles a side: 16 x 16 threads
constexpr int kCP = kMax + 4;   // i-stride of the [k][i] arrays: float4-aligned
constexpr int kRS = kMax;       // row stride of the [i][v] and [k][v] arrays

constexpr size_t kSmemFloats = (size_t)3 * kMax * kCP   // rT, kT, lT (lT later ktR)
                             + (size_t)kMax * kRS       // v
                             + (size_t)kMax * kCP       // At
                             + (size_t)kMax * kRS       // S
                             + 2 * kMax;                // u, 2^lw_C

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

template <int FIX>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, float* __restrict__ o,
            float* __restrict__ S_out, int T, int H, int K_, int V_, int C_) {
  const int K = FIX ? FIX : K_;
  const int V = FIX ? FIX : V_;
  const int C = FIX ? FIX : C_;
  extern __shared__ __align__(16) float smem[];
  float* rT = smem;                 // [k][i]: r, then r * 2^lw_prev
  float* kT = rT + kMax * kCP;      // [k][i]: k
  float* lT = kT + kMax * kCP;      // [k][i]: log2 w, then lw; then ktR [i][k]
  float* sv = lT + kMax * kCP;      // [i][v]
  float* At = sv + kMax * kRS;      // [j][i]: A transposed
  float* sS = At + kMax * kCP;      // [k][v]
  float* su = sS + kMax * kRS;      // [k]
  float* sdc = su + kMax;           // [k]: 2^lw_C
  float* ktR = lT;                  // [i][k] (row stride kRS): k * 2^(lw_C - lw)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int ty = tid / kSide, tx = tid % kSide;

  for (int idx = tid; idx < kMax * kRS; idx += kThreads) sS[idx] = 0.f;
  if (tid < K) su[tid] = u[h * K + tid];

  // the A tile of this thread: the tid-th tile on or below the diagonal
  const int nt = (C + kTile - 1) / kTile;
  int ay = 0;
  while ((ay + 1) * (ay + 2) / 2 <= tid) ++ay;
  const int ax = tid - ay * (ay + 1) / 2;
  const bool a_on = tid < nt * (nt + 1) / 2;

  const size_t rowK = (size_t)H * K;
  const size_t rowV = (size_t)H * V;
  const int seg = (C + 3) / 4;  // scan: 4 threads per k row

  for (int t0 = 0; t0 < T; t0 += C) {
    const size_t baseK = ((size_t)b * T + t0) * rowK + (size_t)h * K;
    const size_t baseV = ((size_t)b * T + t0) * rowV + (size_t)h * V;

    // 1. stage the chunk, r, k and log2 w transposed
    for (int idx = tid; idx < C * K; idx += kThreads) {
      const int i = idx / K, kk = idx - i * K;
      const size_t g = baseK + (size_t)i * rowK + kk;
      rT[kk * kCP + i] = r[g];
      kT[kk * kCP + i] = k[g];
      lT[kk * kCP + i] = log2f(fminf(fmaxf(w[g], 1e-12f), 1.f));
    }
    for (int idx = tid; idx < C * V; idx += kThreads) {
      const int i = idx / V, vv = idx - i * V;
      sv[i * kRS + vv] = v[baseV + (size_t)i * rowV + vv];
    }
    __syncthreads();

    // 2. lw = cumsum of log2 w along i: 4 threads per k row, each a
    //    segment; the segment totals pass by shuffles within the 4 lanes
    {
      const int kk = tid / 4, s = tid % 4;
      const int lo = s * seg, hi = min(C, lo + seg);
      float run = 0.f;
      if (kk < K)
        for (int i = lo; i < hi; ++i) {
          run += lT[kk * kCP + i];
          lT[kk * kCP + i] = run;
        }
      const int lane0 = (threadIdx.x & 31) & ~3;
      float off = 0.f;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float tot = __shfl_sync(0xffffffffu, run, lane0 + q);
        if (q < s) off += tot;
      }
      if (kk < K)
        for (int i = lo; i < hi; ++i) lT[kk * kCP + i] += off;
    }
    __syncthreads();

    // 3. A[i][j] on or below the diagonal, 4 x 4 per thread, into At[j][i]
    if (a_on) {
      const int i0 = ay * kTile, j0 = ax * kTile;
      float acc[kTile][kTile];
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int c = 0; c < kTile; ++c) acc[a][c] = 0.f;
      const bool diag = ax == ay;
      for (int kk = 0; kk < K; ++kk) {
        const float* lrow = lT + kk * kCP;
        const float4 r4 = ld4(rT + kk * kCP + i0);
        const float4 l4 = ld4(lrow + i0);
        const float4 k4 = ld4(kT + kk * kCP + j0);
        const float4 lj4 = ld4(lrow + j0);
        const float ri[kTile] = {r4.x, r4.y, r4.z, r4.w};
        const float lp[kTile] = {i0 > 0 ? lrow[i0 - 1] : 0.f, l4.x, l4.y, l4.z};
        const float kj[kTile] = {k4.x, k4.y, k4.z, k4.w};
        const float lj[kTile] = {lj4.x, lj4.y, lj4.z, lj4.w};
        if (!diag) {
#pragma unroll
          for (int a = 0; a < kTile; ++a)
#pragma unroll
            for (int c = 0; c < kTile; ++c)
              acc[a][c] = fmaf(ri[a] * kj[c], ex2(fminf(lp[a] - lj[c], 0.f)), acc[a][c]);
        } else {
          const float uk = su[kk];
#pragma unroll
          for (int a = 0; a < kTile; ++a)
#pragma unroll
            for (int c = 0; c < kTile; ++c) {
              const float e = c < a ? ex2(fminf(lp[a] - lj[c], 0.f)) : (c == a ? uk : 0.f);
              acc[a][c] = fmaf(ri[a] * kj[c], e, acc[a][c]);
            }
        }
      }
#pragma unroll
      for (int c = 0; c < kTile; ++c)
        st4(At + (j0 + c) * kCP + i0, acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
    }
    __syncthreads();

    // 4. r <- r * 2^lw_prev (in place), k * 2^(lw_C - lw) -> ktR over lT,
    //    2^lw_C; read everything first, write after the barrier
    constexpr int kPer = kMax * kMax / kThreads;
    float rw[kPer], kt[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = tid + e * kThreads;
      if (idx < C * K) {
        const int i = idx / K, kk = idx - i * K;
        const float* lrow = lT + kk * kCP;
        rw[e] = rT[kk * kCP + i] * ex2(i > 0 ? lrow[i - 1] : 0.f);
        kt[e] = kT[kk * kCP + i] * ex2(lrow[C - 1] - lrow[i]);
      }
    }
    const float dc = tid < K ? ex2(lT[tid * kCP + C - 1]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int idx = tid + e * kThreads;
      if (idx < C * K) {
        const int i = idx / K, kk = idx - i * K;
        rT[kk * kCP + i] = rw[e];
        ktR[i * kRS + kk] = kt[e];
      }
    }
    if (tid < K) sdc[tid] = dc;
    __syncthreads();

    // 5. o tile [i0..i0+3][v0..v0+3] = A v + (r 2^lw_prev) S
    {
      const int i0 = ty * kTile, v0 = tx * kTile;
      if (i0 < C && v0 < V) {
        float acc[kTile][kTile];
#pragma unroll
        for (int a = 0; a < kTile; ++a)
#pragma unroll
          for (int c = 0; c < kTile; ++c) acc[a][c] = 0.f;
        const int jn = min(C, i0 + kTile);  // A is zero above the diagonal
        for (int jj = 0; jj < jn; ++jj) {
          const float4 a4 = ld4(At + jj * kCP + i0);
          const float4 x4 = ld4(sv + jj * kRS + v0);
          const float aa[kTile] = {a4.x, a4.y, a4.z, a4.w};
          const float xx[kTile] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int a = 0; a < kTile; ++a)
#pragma unroll
            for (int c = 0; c < kTile; ++c) acc[a][c] = fmaf(aa[a], xx[c], acc[a][c]);
        }
        for (int kk = 0; kk < K; ++kk) {
          const float4 a4 = ld4(rT + kk * kCP + i0);
          const float4 x4 = ld4(sS + kk * kRS + v0);
          const float aa[kTile] = {a4.x, a4.y, a4.z, a4.w};
          const float xx[kTile] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int a = 0; a < kTile; ++a)
#pragma unroll
            for (int c = 0; c < kTile; ++c) acc[a][c] = fmaf(aa[a], xx[c], acc[a][c]);
        }
#pragma unroll
        for (int a = 0; a < kTile; ++a)
          if (i0 + a < C)
            st4(o + baseV + (size_t)(i0 + a) * rowV + v0, acc[a][0], acc[a][1], acc[a][2],
                acc[a][3]);
      }
    }
    __syncthreads();

    // 6. S tile [k0..k0+3][v0..v0+3] <- 2^lw_C S + ktR^T v (own entries only)
    {
      const int k0 = ty * kTile, v0 = tx * kTile;
      if (k0 < K && v0 < V) {
        float acc[kTile][kTile];
#pragma unroll
        for (int a = 0; a < kTile; ++a) {
          const float4 s4 = ld4(sS + (k0 + a) * kRS + v0);
          const float d = sdc[k0 + a];
          acc[a][0] = d * s4.x; acc[a][1] = d * s4.y; acc[a][2] = d * s4.z; acc[a][3] = d * s4.w;
        }
        for (int i = 0; i < C; ++i) {
          const float4 a4 = ld4(ktR + i * kRS + k0);
          const float4 x4 = ld4(sv + i * kRS + v0);
          const float aa[kTile] = {a4.x, a4.y, a4.z, a4.w};
          const float xx[kTile] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int a = 0; a < kTile; ++a)
#pragma unroll
            for (int c = 0; c < kTile; ++c) acc[a][c] = fmaf(aa[a], xx[c], acc[a][c]);
        }
#pragma unroll
        for (int a = 0; a < kTile; ++a)
          st4(sS + (k0 + a) * kRS + v0, acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < K * V; idx += kThreads) {
    const int kk = idx / V, vv = idx - kk * V;
    S_out[(size_t)bh * K * V + idx] = sS[kk * kRS + vv];
  }
}

template <int FIX>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           float* o, float* S_out, int B, int T, int H, int K, int V, int C,
           cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<FIX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<FIX><<<B * H, kThreads, smem, stream>>>(r, k, v, w, u, o, S_out, T, H, K, V, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int wkv6_forward(const float* r, const float* k, const float* v, const float* w,
                            const float* u, float* o, float* S_out, int B, int T, int H,
                            int K, int V, int C, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || H <= 0 || K <= 0 || V <= 0 || C <= 0 || K > kMax ||
      V > kMax || C > kMax || T % C != 0 || V % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (C == kMax && K == kMax && V == kMax)
    return launch<kMax>(r, k, v, w, u, o, S_out, B, T, H, K, V, C, stream);
  return launch<0>(r, k, v, w, u, o, S_out, B, T, H, K, V, C, stream);
}
