// Mamba-2 SSD (state-space duality) scan for Hopper (sm_90a): two passes,
// f32 arithmetic.
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
// product and the add kept apart (no FMA), by one function that both passes
// call (`chunk_la`), as the plain version sums it: at full width A dt
// reaches -31.99 a step (zamba2-2.7b's layer 0 on random weights), la
// several hundred within a chunk, and la_i - la_j cancels, so another
// summation order would round apart.
//
// Bound on the H100 at zamba2-2.7b's prefill, x [4, 2048, 80, 64], N = 64,
// G = 1: the decay is one scalar per head and step, so the recurrence
// runs in rescaled form (h~ = h / prod a, O(P) a token to rescale): an
// FMA per state entry to add (dt x) B^T and an FMA per entry for y = h C,
// 4 P N FLOP per (token, head), the exact algorithm with the fewest
// operations (the convention of the WKV6 bound): 10.7 GFLOP, 0.160 ms at
// 67 TFLOP/s of f32; the bytes (bf16 x, B, C and f32 dt read once, f32 y
// and h written once) are 0.26 GB, 0.08 ms at 3.35 TB/s.  So operations
// bound it.  This kernel runs the chunked form (C B^T over the lower
// triangle, M x, C h^T, the h update), all out of shared memory in f32
// FMAs, plus the scratch h_start written and read once (335.5 MB at full
// width, outside the bound); tensor cores (3xTF32 to hold the f32 tier)
// and one C B^T per group and chunk shared by its heads are later work.
//
// Design.  The TPU grid is (B*H, T/C) with the chunk axis sequential and h
// in VMEM scratch.  Only h crosses chunks, and h at a chunk's start is all
// a chunk's output needs of the chunks before it, so the work splits in
// two launches on the caller's stream:
//
//   1. ssd_state_kernel, sequential over the chunks: grid (B*H, P/32),
//      128 threads, 640 blocks at full width (five an SM: all resident).
//      A thread keeps a 4 x 4 tile of h (4 P columns, 4 state entries) in
//      registers; a warp holds all 32 columns and 16 state entries.  The
//      next chunk's B, x (raw, bf16 or f32) and dt are copied into shared
//      memory by cp.async (4 bytes a lane, a warp a row) while this chunk
//      is computed.  Per chunk: B to f32; one thread sums la (`chunk_la`)
//      and its warp forms wd_j = exp(la_C - la_j) dt_j; meanwhile every
//      thread writes its h, the state at the chunk's start, to the scratch
//      h_start; then x wd to f32 and h <- exp(la_C) h; then the next
//      chunk's copies are issued and h += (x wd)^T B (a float4 of B and
//      one of x wd a step, 16 FMAs).  No C x C work; three barriers a
//      chunk.  After the last chunk h is the final state.  Shared memory
//      38.7 KB with bf16 x and B (50.9 KB with f32: four blocks an SM).
//   2. ssd_out_kernel, every chunk on its own: grid (B*H*ceil(P/64),
//      T/C), 256 threads, 10,240 blocks at full width.  Warps 0-6 stage B,
//      C ([i][n], row stride 68 floats), x ([j][p]) and h_start ([n][p], as
//      the state pass wrote it) in f32 while warp 7 stages dt and sums la
//      as the state pass does (the same function on the same dt: the same
//      la, bit for bit).  Then C B^T on and below the diagonal over all 256
//      threads: the 120 4 x 4 tiles below the diagonal (C = 64) two
//      threads a tile, two rows each (2 x 4 entries), and the 16 tiles on
//      the diagonal one thread each (its 10 entries on or below the
//      diagonal), all over the whole of N.  M, masked before the
//      exponential, then overwrites B in shared memory (B is spent once
//      C B^T is in registers), and y = M x + exp(la_i) (C h_start^T) + D x
//      in 4 x 4 (i, p) register tiles, one per thread (the M x loop stops
//      at the diagonal), stored in f32.  Shared memory 68.1 KB: three
//      blocks an SM (without the alias, 85.5 KB and two).
//
// The scratch h_start is [B*H, T/C, N, P] f32 (h transposed, so that the
// output pass stages it as C h^T wants it, with the P columns contiguous;
// 167.8 MB at full width), allocated by the wrapper; chunk 0's slice is
// zero.  C and N up to 64, P any (tiled by 32 in the state pass, by 64 in
// the output pass), H a multiple of G, T/C at most 65535.  x, B and C may
// be views into a wider token row (the model splits them from one conv
// output): each comes with its token stride, and [H][P] or [G][N] within a
// token is dense; y is dense.
//
// Interface: plain C, loaded with ctypes.  mamba2_ssd_forward enqueues both
// launches on the caller's stream, allocates nothing (the wrapper passes y,
// the final h and the scratch), and returns the first cudaGetLastError()
// that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMax = 64;              // chunk C and state size N up to this
constexpr int kS = kMax + 4;          // row stride of the [i][n] and [i][j] arrays
constexpr int kStateThreads = 128;
constexpr int kSPT = 32;              // P columns per state-pass block
constexpr int kOutThreads = 256;
constexpr int kOPT = 64;              // P columns per output-pass block

constexpr size_t kStateSmemFloats = (size_t)kMax * kS     // B
                                  + (size_t)kMax * kSPT   // x wd
                                  + 2 * kMax;             // la, wd
constexpr size_t kOutSmemFloats = (size_t)2 * kMax * kS    // B (then M), C
                                + (size_t)2 * kMax * kOPT  // x, h_start^T
                                + 2 * kMax;                // dt, la

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// la_i = sum_{s <= i} A dt_s, one product and one add a step, in order and
// never fused: both passes call this on the same dt, so they see the same
// la, bit for bit, and it is the plain version's `_cumsum_seq` order
__device__ __forceinline__ void chunk_la(const float* sdt, float Ah, int C, float* sla) {
  float run = 0.f;
  for (int i = 0; i < C; ++i) {
    run = __fadd_rn(run, __fmul_rn(Ah, sdt[i]));
    sla[i] = run;
  }
}

// the state pass's shared memory: the raw chunk (B, x as Tin, dt), copied
// one chunk ahead by cp.async, then B, x wd, dt's la and wd in f32
template <typename Tin>
constexpr size_t state_smem_bytes() {
  return ((size_t)kMax * kMax + (size_t)kMax * kSPT) * sizeof(Tin)
         + (kStateSmemFloats + kMax) * sizeof(float);
}

// cp.async of 4 bytes from device to shared memory, and the group commit
// and wait
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// start copying chunk c's B rows ([i][n], row stride kMax), x rows ([i][p],
// row stride kSPT) and dt, raw, into shared memory: a warp a row, 4 bytes
// a lane (one f32 or two bf16).  Where a bf16 row is not 4-byte aligned
// (odd N, P or token stride), the chunk is loaded and stored instead.
template <typename Tin>
__device__ __forceinline__ void fetch_state_chunk(const Tin* __restrict__ x,
                                                  const float* __restrict__ dt,
                                                  const Tin* __restrict__ Bm, Tin* braw,
                                                  Tin* xraw, float* dtraw, size_t tok0, int hh,
                                                  int g, int H, int P, int N, int C, int PW,
                                                  int p_base, long long sx, long long sb,
                                                  bool async) {
  constexpr int E = 4 / sizeof(Tin);  // elements per 4-byte copy
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = kStateThreads / 32;
  const Tin* xb = x + tok0 * sx + (size_t)hh * P + p_base;
  const Tin* bb = Bm + tok0 * sb + (size_t)g * N;
  if (async) {
    for (int i = warp; i < C; i += kWarps) {
      for (int q = E * lane; q < N; q += 32 * E)
        cp_async4(braw + i * kMax + q, bb + (size_t)i * sb + q);
      for (int q = E * lane; q < PW; q += 32 * E)
        cp_async4(xraw + i * kSPT + q, xb + (size_t)i * sx + q);
    }
    if (threadIdx.x < C) cp_async4(dtraw + threadIdx.x, dt + (tok0 + threadIdx.x) * H + hh);
    cp_commit();
  } else {
    for (int i = warp; i < C; i += kWarps) {
      for (int q = lane; q < N; q += 32) braw[i * kMax + q] = bb[(size_t)i * sb + q];
      for (int q = lane; q < PW; q += 32) xraw[i * kSPT + q] = xb[(size_t)i * sx + q];
    }
    if (threadIdx.x < C) dtraw[threadIdx.x] = dt[(tok0 + threadIdx.x) * H + hh];
  }
}

template <typename Tin>
__global__ void __launch_bounds__(kStateThreads, 5)
ssd_state_kernel(const Tin* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const Tin* __restrict__ Bm,
                 float* __restrict__ h_start, float* __restrict__ h_out, int T, int H, int P,
                 int G, int N, int C, long long sx, long long sb) {
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;              // [j][n]
  float* sX = sB + kMax * kS;    // [j][p], row stride kSPT: x wd
  float* sla = sX + kMax * kSPT;
  float* swd = sla + kMax;       // [j]: exp(la_C - la_j) dt_j
  float* dtraw = swd + kMax;     // [j]: dt, raw
  Tin* braw = reinterpret_cast<Tin*>(dtraw + kMax);  // [j][n], row stride kMax
  Tin* xraw = braw + kMax * kMax;                    // [j][p], row stride kSPT

  const int bh = blockIdx.x;
  const int b = bh / H, hh = bh - b * H;
  const int g = hh / (H / G);
  const int p_base = blockIdx.y * kSPT;
  const int PW = min(kSPT, P - p_base);  // live columns of this tile
  const int nch = T / C;
  const int tid = threadIdx.x;
  // this thread's h tile: a warp holds all 32 columns and 16 state
  // entries, so a step reads 192 distinct bytes of shared memory a warp
  const int p0 = 4 * (tid % 8), n0 = 16 * (tid / 32) + 4 * ((tid / 8) % 4);
  const bool on = p0 < PW && n0 < N;
  const bool vecP = P % 4 == 0, vecN = N % 4 == 0;
  const float Ah = A[hh];
  // 4-byte copies need 4-byte aligned rows (always so for f32)
  const bool async = sizeof(Tin) == 4 ||
                     ((((size_t)x | (size_t)Bm) & 3) == 0 && sx % 2 == 0 && sb % 2 == 0 &&
                      N % 2 == 0 && P % 2 == 0);

  float h[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) h[a][e] = 0.f;

  fetch_state_chunk(x, dt, Bm, braw, xraw, dtraw, (size_t)b * T, hh, g, H, P, N, C, PW,
                    p_base, sx, sb, async);
  for (int c = 0; c < nch; ++c) {
    cp_wait_all();
    __syncthreads();  // chunk c is in; the last chunk's update is done

    // 1. B in f32 (zero past C and N); la and wd by warp 0; h at the
    //    chunk's start to the scratch ([n][p])
#pragma unroll 4
    for (int idx = tid; idx < kMax * kMax; idx += kStateThreads) {
      const int i = idx / kMax, n = idx % kMax;
      sB[i * kS + n] = (i < C && n < N) ? to_f(braw[idx]) : 0.f;
    }
    if (tid < 32) {
      if (tid == 0) chunk_la(dtraw, Ah, C, sla);
      __syncwarp();
      for (int j = tid; j < C; j += 32) swd[j] = expf(sla[C - 1] - sla[j]) * dtraw[j];
    }
    if (on) {
      float* hs = h_start + ((size_t)bh * nch + c) * N * P + p_base + p0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n0 + e >= N) break;
        float* row = hs + (size_t)(n0 + e) * P;
        if (vecP) {
          st4(row, h[0][e], h[1][e], h[2][e], h[3][e]);
        } else {
#pragma unroll
          for (int a = 0; a < 4; ++a)
            if (p0 + a < PW) row[a] = h[a][e];
        }
      }
    }
    __syncthreads();

    // 2. x wd in f32 (zero past C and the tile's columns); h <- exp(la_C) h
#pragma unroll 4
    for (int idx = tid; idx < kMax * kSPT; idx += kStateThreads) {
      const int i = idx / kSPT, p = idx % kSPT;
      sX[idx] = (i < C && p < PW) ? to_f(xraw[idx]) * swd[i] : 0.f;
    }
    const float edc = expf(sla[C - 1]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[a][e] *= edc;
    __syncthreads();  // the raw chunk is spent

    // 3. the next chunk's copies in flight while h += (x wd)^T B: per step
    //    a float4 of B (the thread's state entries) and one of x wd (its
    //    columns)
    if (c + 1 < nch)
      fetch_state_chunk(x, dt, Bm, braw, xraw, dtraw, (size_t)b * T + (size_t)(c + 1) * C,
                        hh, g, H, P, N, C, PW, p_base, sx, sb, async);
    if (on) {
#pragma unroll 4
      for (int j = 0; j < C; ++j) {
        const float4 b4 = ld4(sB + j * kS + n0);
        const float4 x4 = ld4(sX + j * kSPT + p0);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) h[a][e] = fmaf(at(x4, a), at(b4, e), h[a][e]);
      }
    }
  }

  if (on) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (p0 + a >= PW) break;
      float* hp = h_out + ((size_t)bh * P + p_base + p0 + a) * N + n0;
      if (vecN) {
        st4(hp, h[a][0], h[a][1], h[a][2], h[a][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n0 + e < N) hp[e] = h[a][e];
      }
    }
  }
}

constexpr int kStageThreads = kOutThreads - 32;  // warps 0-6 stage the chunk
constexpr int kStagePer = (kMax * kMax + kStageThreads - 1) / kStageThreads;  // a thread's share

template <typename Tin>
__global__ void __launch_bounds__(kOutThreads, 3)
ssd_out_kernel(const Tin* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const Tin* __restrict__ Bm,
               const Tin* __restrict__ Cm, const float* __restrict__ D,
               const float* __restrict__ h_start, float* __restrict__ y, int T, int H, int P,
               int G, int N, int C, long long sx, long long sb, long long sc) {
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;              // [j][n]; then M [i][j]
  float* sM = sB;
  float* sC = sB + kMax * kS;    // [i][n]
  float* sX = sC + kMax * kS;    // [j][p], row stride kOPT
  float* sH = sX + kMax * kOPT;  // [n][p], row stride kOPT: h at the chunk's start
  float* sdt = sH + kMax * kOPT;
  float* sla = sdt + kMax;

  const int nPT = (P + kOPT - 1) / kOPT;
  const int pt = blockIdx.x % nPT;
  const int bh = blockIdx.x / nPT;
  const int c = blockIdx.y;
  const int b = bh / H, hh = bh - b * H;
  const int g = hh / (H / G);
  const int p_base = pt * kOPT;
  const int PW = min(kOPT, P - p_base);
  const int nch = T / C;
  const int Np = (N + 3) & ~3;  // N in whole float4s (the padding is zero)
  const int tid = threadIdx.x;
  const size_t tok0 = (size_t)b * T + (size_t)c * C;
  const float Ah = A[hh];
  const float Dh = D[hh];

  // 1. warps 0-6 stage the chunk in f32 (zero past C, N and the tile's
  //    columns), each array's loads issued before its stores; meanwhile
  //    warp 7 stages dt and one of its threads sums la
  if (tid < kStageThreads) {
    Tin rb[kStagePer], rc[kStagePer];
#pragma unroll
    for (int e = 0; e < kStagePer; ++e) {
      const int idx = tid + e * kStageThreads, i = idx / kMax, n = idx % kMax;
      if (idx < kMax * kMax && i < C && n < N) {
        const size_t gn = (size_t)g * N + n;
        rb[e] = Bm[(tok0 + i) * sb + gn];
        rc[e] = Cm[(tok0 + i) * sc + gn];
      }
    }
#pragma unroll
    for (int e = 0; e < kStagePer; ++e) {
      const int idx = tid + e * kStageThreads, i = idx / kMax, n = idx % kMax;
      const bool in = i < C && n < N;
      if (idx < kMax * kMax) {
        sB[i * kS + n] = in ? to_f(rb[e]) : 0.f;
        sC[i * kS + n] = in ? to_f(rc[e]) : 0.f;
      }
    }
    Tin rx[kStagePer];
    float rh[kStagePer];
    const float* hs = h_start + ((size_t)bh * nch + c) * N * P + p_base;
#pragma unroll
    for (int e = 0; e < kStagePer; ++e) {
      const int idx = tid + e * kStageThreads, i = idx / kOPT, p = idx % kOPT;
      if (idx < kMax * kOPT && i < C && p < PW)
        rx[e] = x[(tok0 + i) * sx + (size_t)hh * P + p_base + p];
      rh[e] = (idx < kMax * kOPT && i < N && p < PW) ? hs[(size_t)i * P + p] : 0.f;  // i is n
    }
#pragma unroll
    for (int e = 0; e < kStagePer; ++e) {
      const int idx = tid + e * kStageThreads, i = idx / kOPT, p = idx % kOPT;
      if (idx < kMax * kOPT) {
        sX[idx] = (i < C && p < PW) ? to_f(rx[e]) : 0.f;
        sH[idx] = rh[e];
      }
    }
  } else {
    for (int i = tid - kStageThreads; i < kMax; i += 32)
      sdt[i] = i < C ? dt[(tok0 + i) * H + hh] : 0.f;
    __syncwarp();
    if (tid == kStageThreads) chunk_la(sdt, Ah, C, sla);
  }
  __syncthreads();

  // 2. C B^T on and below the diagonal, in registers, over all threads:
  //    threads 0 .. 2 n_off - 1 take the tiles below the diagonal's 4 x 4
  //    tiles, two a tile (rows 2 half, 2 half + 1 of it, 4 columns); the
  //    next nt threads one diagonal tile each (its 10 entries with
  //    column <= row, at a (a + 1) / 2 + column).
  const int nt = (C + 3) / 4;
  const int n_off = nt * (nt - 1) / 2;
  const bool off = tid < 2 * n_off;
  const int dg = tid - 2 * n_off;
  const bool diag = !off && dg < nt;
  int i0 = 0, j0 = 0;
  float cb[10];
#pragma unroll
  for (int e = 0; e < 10; ++e) cb[e] = 0.f;
  if (off) {
    const int q = tid >> 1;
    int ay = 1;
    while ((ay + 1) * ay / 2 <= q) ++ay;
    const int ax = q - ay * (ay - 1) / 2;
    i0 = 4 * ay + 2 * (tid & 1);
    j0 = 4 * ax;
    for (int n = 0; n < Np; n += 4) {
      const float4 c0 = ld4(sC + i0 * kS + n), c1 = ld4(sC + (i0 + 1) * kS + n);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 bj = ld4(sB + (j0 + cc) * kS + n);
        cb[cc] = dot4(c0, bj, cb[cc]);
        cb[4 + cc] = dot4(c1, bj, cb[4 + cc]);
      }
    }
  } else if (diag) {
    i0 = j0 = 4 * dg;
    for (int n = 0; n < Np; n += 4) {
      float4 ci[4], bj[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ci[a] = ld4(sC + (i0 + a) * kS + n);
        bj[a] = ld4(sB + (i0 + a) * kS + n);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int cc = 0; cc <= a; ++cc)
          cb[a * (a + 1) / 2 + cc] = dot4(ci[a], bj[cc], cb[a * (a + 1) / 2 + cc]);
    }
  }
  __syncthreads();  // C B^T is in registers: B is spent

  // 3. M over B, masked before the exponential (j <= i: la_i - la_j <= 0)
  if (off) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + r;
      float m[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = j0 + cc;
        m[cc] = i < C ? expf(sla[i] - sla[j]) * cb[4 * r + cc] * sdt[j] : 0.f;
      }
      st4(sM + i * kS + j0, m[0], m[1], m[2], m[3]);
    }
  } else if (diag) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + a;
      float m[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = j0 + cc;
        m[cc] = (cc <= a && i < C)
                    ? expf(sla[i] - sla[j]) * cb[cc <= a ? a * (a + 1) / 2 + cc : 0] * sdt[j]
                    : 0.f;
      }
      st4(sM + i * kS + j0, m[0], m[1], m[2], m[3]);
    }
  }
  __syncthreads();

  // 4. y rows 4ty.., columns 4tx..: M x + exp(la) (C h_start^T) + D x
  const int yi = 4 * (tid / 16), yp = 4 * (tid % 16);
  if (yi < C && yp < PW) {
    float acc[4][4], acc2[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = acc2[a][e] = 0.f;
    const int jn = min(C, yi + 4);  // M is zero above the diagonal
    for (int j = 0; j < jn; j += 4) {
      float4 m[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        m[a] = ld4(sM + (yi + a) * kS + j);
        xv[a] = ld4(sX + (j + a) * kOPT + yp);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(at(m[a], q), at(xv[q], e), acc[a][e]);
    }
    for (int n = 0; n < Np; n += 4) {
      float4 cv[4], hv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        cv[a] = ld4(sC + (yi + a) * kS + n);
        hv[a] = ld4(sH + (n + a) * kOPT + yp);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[a][e] = fmaf(at(cv[a], q), at(hv[q], e), acc2[a][e]);
    }
    const size_t rowY = (size_t)H * P;
    const bool vec = P % 4 == 0;  // then PW is too, and the row is float4-aligned
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = yi + a;
      if (i >= C) break;
      const float el = expf(sla[i]);
      const float4 xi = ld4(sX + i * kOPT + yp);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[a][e] + el * acc2[a][e] + Dh * at(xi, e);
      float* yr = y + (tok0 + i) * rowY + (size_t)hh * P + p_base + yp;
      if (vec) {
        st4(yr, v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (yp + e < PW) yr[e] = v[e];
      }
    }
  }
}

template <typename Tin>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* D, float* y, float* h_out, float* h_start, int Bt, int T, int H,
           int P, int G, int N, int C, long long sx, long long sb, long long sc,
           cudaStream_t stream) {
  const size_t smem_s = state_smem_bytes<Tin>();
  const size_t smem_o = kOutSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_out_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_o);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's 228 KB as shared memory: five state blocks (four with
  // f32 x and B), three output blocks an SM
  err = cudaFuncSetAttribute(ssd_state_kernel<Tin>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_out_kernel<Tin>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const Tin* xt = static_cast<const Tin*>(x);
  const Tin* bt = static_cast<const Tin*>(Bm);
  const dim3 grid_s(Bt * H, (P + kSPT - 1) / kSPT);
  ssd_state_kernel<Tin><<<grid_s, kStateThreads, smem_s, stream>>>(
      xt, dt, A, bt, h_start, h_out, T, H, P, G, N, C, sx, sb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_o(Bt * H * ((P + kOPT - 1) / kOPT), T / C);
  ssd_out_kernel<Tin><<<grid_o, kOutThreads, smem_o, stream>>>(
      xt, dt, A, bt, static_cast<const Tin*>(Cm), D, h_start, y, T, H, P, G, N, C, sx, sb,
      sc);
  return (int)cudaGetLastError();
}

}  // namespace

// x [Bt,T,H,P] and B, C [Bt,T,G,N]: float32 (bf16 == 0) or bfloat16
// (bf16 == 1), token rows with token strides sx, sb, sc; dt [Bt,T,H], A
// [H], D [H] float32; y [Bt,T,H,P], h_out [Bt,H,P,N] and the scratch
// h_start [Bt*H, T/C, N, P] float32, contiguous.
extern "C" int mamba2_ssd_forward(const void* x, const float* dt, const float* A,
                                  const void* Bm, const void* Cm, const float* D, float* y,
                                  float* h_out, float* h_start, int Bt, int T, int H, int P,
                                  int G, int N, int C, long long sx, long long sb,
                                  long long sc, int bf16, cudaStream_t stream) {
  if (Bt <= 0 || T <= 0 || H <= 0 || P <= 0 || G <= 0 || N <= 0 || C <= 0 ||
      N > kMax || C > kMax || T % C != 0 || T / C > 65535 || H % G != 0 ||
      sx < (long long)H * P || sb < (long long)G * N || sc < (long long)G * N)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, h_out, h_start, Bt, T, H, P, G, N,
                                 C, sx, sb, sc, stream);
  return launch<float>(x, dt, A, Bm, Cm, D, y, h_out, h_start, Bt, T, H, P, G, N, C, sx,
                       sb, sc, stream);
}
