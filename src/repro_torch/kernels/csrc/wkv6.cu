// RWKV6 (Finch) WKV kernel for Hopper (sm_90a): two passes, f32 FMAs.
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
// with the state S [K][V] carried from chunk to chunk; the final S is
// written as well (the prefill -> decode handoff).  Exponentials are taken
// only of arguments <= 0 (masked to j < i, clamped at 0 against rounding),
// so no decay, however strong, gives inf * 0.  Logs and exponentials are
// base 2 (log2 w summed, 2^ of the differences): the same values.
//
// r, k and v are float32 or bfloat16 (all three alike; a bf16 value is
// upcast on load, exactly, so bf16 in gives the same o and S as its f32
// upcast in); w and u are float32; o and S are float32.
//
// Design.  The TPU grid is (B*H, T/C) with the chunk axis sequential and S
// in VMEM scratch.  Only S depends on earlier chunks, and S at a chunk's
// start is all a chunk's output needs of them, so the work splits in two
// launches on the caller's stream:
//
//   1. wkv6_state_kernel, sequential over the chunks: grid (B*H, K/16),
//      128 threads, 640 blocks at full width.  Row k of S needs only
//      column k of k and w (and all of v), so a block owns 16 rows of one
//      head's S (4 x 2 entries a thread, in registers) and scans and
//      rescales only its 16 columns.  Per chunk: each thread scans its
//      segment of one column of log2 w in registers (lw); S goes to the
//      scratch S_start [B*H, T/C, K, V] (the chunk's start); k <- k 2^(lw_C
//      - lw) into shared memory; S <- 2^lw_C S + k^T v, one broadcast
//      float4 of k and two columns of raw v a step.  No C x C work, two
//      barriers a chunk.  The next chunk's v is copied into the other half
//      of a double buffer by cp.async, and its k and w are loaded into
//      registers, while this chunk is computed.  The last chunk's update is
//      the final S.
//   2. wkv6_out_kernel, every chunk on its own: grid (B*H, T/C), 256
//      threads, 5,120 blocks at full width.  Stage r, k, log2 w, v and
//      S_start (every load issued before the first store); lw by the same
//      two scan functions as the state pass (the same sums in the same
//      order: both passes see the same lw, bit for bit); A on and below the
//      diagonal in 4 x 4 micro-tiles: the 120 tiles below the diagonal
//      (C = 64) two threads a tile, K split in two (quads of k taken
//      alternately), each entry's exponential factored through a pivot
//      between its row and its column (both factors <= 1, see step 3); the
//      16 tiles on the diagonal by all 256 threads, 16 a tile, one quad of
//      k each, summed by warp shuffles, with masked exponentials; then
//      o = A v + (r 2^lw_prev) S_start in 4 x 4 tiles, stored as float4.
//
// The output pass's arrays in shared memory are row-major [i][k] with a row
// stride of 68 floats (float4-aligned, rows spread over the banks), so a
// chunk is staged without a transpose; A is stored [j][i] over k and
// log2 w once those are spent.  Pad rows (i >= C) and columns (k >= K) are
// staged as zeros.  The output pass takes 86.5 KB of shared memory (two
// blocks an SM), the state pass 22.1 KB with bf16 v and 38.5 KB with f32
// (five blocks an SM: all 640 blocks are resident at once).  C = K = V = 64
// (the model's shape) is compiled with those sizes as constants; other
// sizes up to 64 (V a multiple of 4) run the same code with them read at
// run time.
//
// Bound on the H100 at the full-width shape of rwkv6-3b's prefill,
// r, k, v [4, 2048, 40, 64] bf16 and w f32 (327,680 (token, head) pairs):
// the exact algorithm with the fewest operations is the sequential
// recurrence in rescaled form, 4 K V = 16,384 FLOP per (token, head), 5.37
// GFLOP, 0.080 ms at 67 TFLOP/s of f32; r, k, v (bf16), w (f32) read once
// and o and the final S (f32) written once are 296.2 MB, 0.0884 ms at 3.35
// TB/s (422.1 MB, 0.126 ms with f32 r, k, v).  So bytes bound it.  This
// kernel moves more: S_start, 83.9 MB written and read again, and v read
// by each of the state pass's four row blocks (mostly from L2).  What
// holds each pass: the output pass's A (exponentials and FMAs out of
// shared memory), then its staging loads and its o products; the state
// pass's 32 dependent chunk steps a block, led by the k^T v update (f32
// FMAs, bound by instruction issue), then the scan, the loads' issue and
// the rescale.  Left for later: A v, (r 2^lw_prev) S and k^T v on tensor
// cores (mma.sync in 3xTF32, to hold the f32 tier; the pivot makes the
// tiles below the diagonal a product too).
//
// Interface: plain C, loaded with ctypes.  wkv6_forward enqueues both
// launches on the caller's stream, allocates nothing (the wrapper passes
// o, S and the S_start scratch), and returns the first cudaGetLastError()
// that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMax = 64;           // K, V and C up to this
constexpr int kKP = kMax + 4;      // row stride of the output pass's [i][k] and [j][i] arrays
constexpr int kVP = kMax;          // row stride of the [i][v] and [k][v] arrays
constexpr int kSeg = 8;            // cumsum segments along a k column
constexpr int kSegRows = kMax / kSeg;  // rows of a segment, at most
constexpr int kOutThreads = 256;
constexpr int kStateThreads = 128;
constexpr int kKT = 16;            // rows of S (columns of k, w) per state-pass block
constexpr int kKTP = kKT + 4;      // row stride of the state pass's [i][k] array

// the state pass's shared memory: v (raw T) for this chunk and the next,
// then k 2^(lw_C - lw), the segment totals and 2^lw_C
template <typename T>
constexpr size_t state_smem_bytes() {
  return 2 * kMax * kVP * sizeof(T)
         + ((size_t)kMax * kKTP + (size_t)kSeg * kKT + kKT) * sizeof(float);
}
constexpr size_t kOutSmemFloats = (size_t)2 * kMax * kKP      // r, k
                                + (size_t)(kMax + 1) * kKP    // log2 w, then lw
                                + (size_t)2 * kMax * kVP      // v, S_start
                                + kMax                        // u
                                + (size_t)kSeg * kMax;        // cumsum segment totals

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float log2w(float w) {
  return log2f(fminf(fmaxf(w, 1e-12f), 1.f));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float at(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// four consecutive elements of T as one load (16 bytes of f32, 8 of bf16;
// the wrapper checks that the tensors are 16-byte aligned), upcast apart
// from the load so that a batch of loads is in flight together
template <typename T> struct Quad;
template <> struct Quad<float> { using type = float4; };
template <> struct Quad<__nv_bfloat16> { using type = uint2; };

template <typename T>
__device__ __forceinline__ typename Quad<T>::type ldq(const T* p) {
  return *reinterpret_cast<const typename Quad<T>::type*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float4 to_f4(float4 x) { return x; }
__device__ __forceinline__ float4 to_f4(uint2 x) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// lw = cumsum of log2 w along the chunk.  A column is cut into kSeg
// segments of seg = ceil(C / kSeg) rows; scan_segment sums a segment in
// order (in registers), and segment s adds segment_offset, the totals of
// segments 0 .. s - 1 summed in order.  Both passes form lw with these two
// functions, so they see the same lw, bit for bit.
__device__ __forceinline__ float scan_segment(float (&x)[kSegRows], int n) {
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < kSegRows; ++e)
    if (e < n) {
      run += x[e];
      x[e] = run;
    }
  return run;
}

__device__ __forceinline__ float segment_offset(const float* tot, int s, int ld) {
  float off = 0.f;
  for (int q = 0; q < s; ++q) off += tot[q * ld];
  return off;
}

// the output pass's cumsum, in place in rows 1..C of lwb (row stride ld;
// row i + 1 holds step i; row 0 is lw_prev_0), columns 0 .. ncols - 1:
// (column, segment) items, kOutThreads at a time
__device__ __forceinline__ void chunk_cumsum(float* lwb, int ld, float* tot, int C,
                                             int ncols) {
  constexpr int kItems = kSeg * kMax / kOutThreads;
  const int seg = (C + kSeg - 1) / kSeg;
  float x[kItems][kSegRows];
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int it = threadIdx.x + m * kOutThreads;
    const int q = it % ncols, lo = (it / ncols) * seg, n = max(0, min(C, lo + seg) - lo);
    if (it < kSeg * ncols) {
#pragma unroll
      for (int e = 0; e < kSegRows; ++e)
        if (e < n) x[m][e] = lwb[(lo + e + 1) * ld + q];
      tot[it] = scan_segment(x[m], n);
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int it = threadIdx.x + m * kOutThreads;
    const int q = it % ncols, s = it / ncols, lo = s * seg, n = max(0, min(C, lo + seg) - lo);
    if (it < kSeg * ncols) {
      const float off = s > 0 ? segment_offset(tot + q, s, ncols) : 0.f;
#pragma unroll
      for (int e = 0; e < kSegRows; ++e)
        if (e < n) lwb[(lo + e + 1) * ld + q] = s > 0 ? x[m][e] + off : x[m][e];
    }
  }
  __syncthreads();
}

constexpr int kStatePerV = kMax * kMax / 4 / kStateThreads;  // v quads a thread copies

// cp.async of N bytes from device to shared memory, and the group commit
// and wait
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(N));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// start loading chunk c of the state pass: v (all columns, raw) by
// cp.async into vraw, and this thread's segment of column kt0 + q of k and
// w into registers (raw: upcast when used)
template <typename T>
__device__ __forceinline__ void fetch_state_chunk(const T* __restrict__ k,
                                                  const T* __restrict__ v,
                                                  const float* __restrict__ w, T* vraw, int c,
                                                  int b, int h, int kt0, int q, int lo, int nrow,
                                                  int T_, int H, int K, int V, int C,
                                                  T (&pk)[kSegRows], float (&pw)[kSegRows]) {
  const size_t rowK = (size_t)H * K, rowV = (size_t)H * V;
  const size_t t0 = (size_t)b * T_ + (size_t)c * C;
  const size_t baseK = (t0 + lo) * rowK + (size_t)h * K + kt0 + q;
  const size_t baseV = t0 * rowV + (size_t)h * V;
  if (V * sizeof(T) % 16 == 0) {  // 16 bytes a copy (C = K = V = 64 always)
    constexpr int kPer = 16 / sizeof(T);
    const int Vc = V / kPer;
#pragma unroll
    for (int e = 0; e < kMax * kMax / kPer / kStateThreads; ++e) {
      const int idx = threadIdx.x + e * kStateThreads;
      const int i = idx / Vc, qq = kPer * (idx - i * Vc);
      if (i < C) cp_async<16>(vraw + i * kVP + qq, v + baseV + (size_t)i * rowV + qq);
    }
  } else {  // a quad of 4 elements a copy (V a multiple of 4)
    const int Vq = V / 4;
#pragma unroll
    for (int e = 0; e < kStatePerV; ++e) {
      const int idx = threadIdx.x + e * kStateThreads;
      const int i = idx / Vq, qq = 4 * (idx - i * Vq);
      if (i < C) cp_async<4 * sizeof(T)>(vraw + i * kVP + qq, v + baseV + (size_t)i * rowV + qq);
    }
  }
  cp_commit();
#pragma unroll
  for (int e = 0; e < kSegRows; ++e)
    if (e < nrow) {
      pk[e] = k[baseK + (size_t)e * rowK];
      pw[e] = w[baseK + (size_t)e * rowK];
    }
}

template <typename T, int FIX>
__global__ void __launch_bounds__(kStateThreads, 5)
wkv6_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, float* __restrict__ S_start,
                  float* __restrict__ S_out, int T_, int H, int K_, int V_, int C_) {
  const int K = FIX ? FIX : K_;
  const int V = FIX ? FIX : V_;
  const int C = FIX ? FIX : C_;
  extern __shared__ __align__(16) float smem[];
  T* vraw = reinterpret_cast<T*>(smem);  // 2 x [i][v]: v of this chunk and the next, raw
  float* sk = smem + kMax * kVP * sizeof(T) / 2;  // [i][k]: k * 2^(lw_C - lw)
  float* tot = sk + kMax * kKTP;                  // [segment][k]: segment totals
  float* sdc = tot + kSeg * kKT;                  // [k]: 2^lw_C

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kt0 = blockIdx.y * kKT, nk = min(kKT, K - kt0);
  const int tid = threadIdx.x;
  const int n = T_ / C;
  // the scan: this thread's column q of the block's k and w, segment s
  const int q = tid % kKT, s = tid / kKT, seg = (C + kSeg - 1) / kSeg;
  const int lo = s * seg, nrow = q < nk ? max(0, min(C, lo + seg) - lo) : 0;
  // the update: this thread's S entries, rows kt0 + kr .. + 3 (a warp's
  // rows), columns vc, vc + 1
  const int kr = 4 * (tid >> 5), vc = 2 * (tid & 31);
  const bool von = vc < V;
  float S[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a) S[a][0] = S[a][1] = 0.f;

  T pk[kSegRows];
  float pw[kSegRows];
  fetch_state_chunk(k, v, w, vraw, 0, b, h, kt0, q, lo, nrow, T_, H, K, V, C, pk, pw);

  for (int c = 0; c < n; ++c) {
    T* vcur = vraw + (c & 1) * kMax * kVP;
    // this thread's segment of lw, in registers
    float lw[kSegRows], kf[kSegRows];
#pragma unroll
    for (int e = 0; e < kSegRows; ++e)
      if (e < nrow) {
        lw[e] = log2w(pw[e]);
        kf[e] = to_f(pk[e]);
      }
    tot[s * kKT + q] = scan_segment(lw, nrow);
    cp_wait_all();
    __syncthreads();  // segment totals and this chunk's v are in
    // the next chunk's loads are in flight while this one is computed (its
    // v into the other buffer, last read in the chunk before this one)
    if (c + 1 < n)
      fetch_state_chunk(k, v, w, vraw + ((c + 1) & 1) * kMax * kVP, c + 1, b, h, kt0, q, lo,
                        nrow, T_, H, K, V, C, pk, pw);

    // S at the chunk's start, for the output pass
    float* dst = S_start + (((size_t)bh * n + c) * K + kt0 + kr) * V + vc;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (von && kr + a < nk)
        *reinterpret_cast<float2*>(dst + (size_t)a * V) = make_float2(S[a][0], S[a][1]);

    // k <- k * 2^(lw_C - lw) (lw falls along the chunk: the argument is <= 0)
    const float off = s > 0 ? segment_offset(tot + q, s, kKT) : 0.f;
    const float lwC = segment_offset(tot + q, kSeg, kKT);  // = lw of step C - 1
#pragma unroll
    for (int e = 0; e < kSegRows; ++e)
      if (e < nrow) sk[(lo + e) * kKTP + q] = kf[e] * ex2(lwC - (s > 0 ? lw[e] + off : lw[e]));
    if (s == 0 && q < nk) sdc[q] = ex2(lwC);
    __syncthreads();

    // S <- 2^lw_C S + k~^T v: per step one float4 of k~ (the same for the
    // whole warp) and two columns of v
    if (von) {
      const float4 dc = ld4(sdc + kr);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        S[a][0] *= at(dc, a);
        S[a][1] *= at(dc, a);
      }
#pragma unroll 8
      for (int i = 0; i < C; ++i) {
        const float4 a4 = ld4(sk + i * kKTP + kr);
        const float2 x = ld2(vcur + i * kVP + vc);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          S[a][0] = fmaf(at(a4, a), x.x, S[a][0]);
          S[a][1] = fmaf(at(a4, a), x.y, S[a][1]);
        }
      }
    }
    // no barrier here: the next write of tot, sdc and sk, and the next
    // copy into this chunk's v buffer, all come after the next chunk's
    // first barrier, which every thread reaches only after this update
  }

  float* dst = S_out + ((size_t)bh * K + kt0 + kr) * V + vc;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    if (von && kr + a < nk)
      *reinterpret_cast<float2*>(dst + (size_t)a * V) = make_float2(S[a][0], S[a][1]);
}

template <typename T, int FIX>
__global__ void __launch_bounds__(kOutThreads, 2)
wkv6_out_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ w, const float* __restrict__ u,
                const float* __restrict__ S_start, float* __restrict__ o, int T_, int H,
                int K_, int V_, int C_) {
  const int K = FIX ? FIX : K_;
  const int V = FIX ? FIX : V_;
  const int C = FIX ? FIX : C_;
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;                    // [i][k]: r, then r * 2^lw_prev
  float* sk = sr + kMax * kKP;         // [i][k]: k; then [j][i]: A, first half of K
  float* lwb = sk + kMax * kKP;        // [i + 1][k]: log2 w, lw; then [j][i]: A, second half
  float* sv = lwb + (kMax + 1) * kKP;  // [i][v]
  float* sS = sv + kMax * kVP;         // [k][v]: S at the chunk's start
  float* su = sS + kMax * kVP;         // [k]
  float* tot = su + kMax;              // [segment][k]

  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int n = T_ / C;
  const int nt = (C + 3) / 4, kq = (K + 3) / 4;  // 4 x 4 tiles a side; float4 quads of k
  const int Cp = 4 * nt, Kp = 4 * kq, Vq = V / 4;
  const size_t rowK = (size_t)H * K, rowV = (size_t)H * V;
  const size_t t0 = (size_t)b * T_ + (size_t)c * C;
  const size_t baseK = t0 * rowK + (size_t)h * K, baseV = t0 * rowV + (size_t)h * V;

  // 1. stage the chunk (pad rows and columns as zeros) and S at its start:
  //    every load is issued before the first is stored, so the block waits
  //    for one round trip to device memory, not one per row group
  constexpr int kQPer = kMax * kMax / 4 / kOutThreads;  // quads of each array a thread stages
  const float* Sg = S_start + ((size_t)bh * n + c) * K * V;
  {
    typename Quad<T>::type qv[kQPer];
    float4 qs[kQPer];
#pragma unroll
    for (int e = 0; e < kQPer; ++e) {
      const int idx = tid + e * kOutThreads;
      const int i = idx / Vq, q = 4 * (idx - i * Vq);
      if (i < C) qv[e] = ldq(v + baseV + (size_t)i * rowV + q);
      if (i < K) qs[e] = ld4(Sg + (size_t)i * V + q);
    }
    if (K % 4 == 0) {  // r, k and w as quads too
      typename Quad<T>::type qr[kQPer], qk[kQPer];
      float4 qw[kQPer];
#pragma unroll
      for (int e = 0; e < kQPer; ++e) {
        const int idx = tid + e * kOutThreads;
        const int i = idx / kq, q = 4 * (idx - i * kq);
        if (i < C) {
          const size_t g = baseK + (size_t)i * rowK + q;
          qr[e] = ldq(r + g);
          qk[e] = ldq(k + g);
          qw[e] = ld4(w + g);
        }
      }
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int e = 0; e < kQPer; ++e) {
        const int idx = tid + e * kOutThreads;
        const int i = idx / kq, q = 4 * (idx - i * kq);
        if (i < Cp) {
          const bool in = i < C;
          st4(sr + i * kKP + q, in ? to_f4(qr[e]) : zero);
          st4(sk + i * kKP + q, in ? to_f4(qk[e]) : zero);
          st4(lwb + (i + 1) * kKP + q,
              in ? make_float4(log2w(qw[e].x), log2w(qw[e].y), log2w(qw[e].z), log2w(qw[e].w))
                 : zero);
        }
      }
    } else {
      for (int idx = tid; idx < Cp * Kp; idx += kOutThreads) {
        const int i = idx / Kp, q = idx - i * Kp;
        const bool in = i < C && q < K;
        const size_t g = baseK + (size_t)i * rowK + q;
        sr[i * kKP + q] = in ? to_f(r[g]) : 0.f;
        sk[i * kKP + q] = in ? to_f(k[g]) : 0.f;
        lwb[(i + 1) * kKP + q] = in ? log2w(w[g]) : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < kQPer; ++e) {
      const int idx = tid + e * kOutThreads;
      const int i = idx / Vq, q = 4 * (idx - i * Vq);
      if (i < C) st4(sv + i * kVP + q, to_f4(qv[e]));
      if (i < Kp) st4(sS + i * kVP + q, i < K ? qs[e] : make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
  if (tid < Kp) {
    lwb[tid] = 0.f;
    su[tid] = tid < K ? u[h * K + tid] : 0.f;
  }
  __syncthreads();

  // 2. lw, as the state pass forms it
  chunk_cumsum(lwb, kKP, tot, C, K);

  // 3. A below the diagonal's 4 x 4 tiles: threads 0 .. 2 n_off - 1, two a
  //    tile (alternate quads of k).  Row i (lw_prev_i) and column j < i
  //    (lw_j) of such a tile have the pivot L = lw of the tile's last
  //    column between them (lw falls along the chunk), so
  //    2^(lw_prev_i - lw_j) = 2^(lw_prev_i - L) 2^(L - lw_j) with both
  //    factors <= 1: nothing overflows, and a factor underflows only where
  //    the product does.  Each k is then a rank-1 update of the tile, with
  //    7 exponentials for its 16 entries.
  const int n_off = nt * (nt - 1) / 2;
  const bool a_on = tid < 2 * n_off;
  const int half = tid & 1;
  int ay = 1, ax = 0;
  if (a_on) {
    const int q = tid >> 1;
    while ((ay + 1) * ay / 2 <= q) ++ay;
    ax = q - ay * (ay - 1) / 2;
  }
  const int i0 = 4 * ay, j0 = 4 * ax;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[a][cc] = 0.f;
  if (a_on) {
    for (int q4 = half; q4 < kq; q4 += 2) {
      const int kk = 4 * q4;
      float4 rv[4], lp[4], kv[4], lj[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        rv[a] = ld4(sr + (i0 + a) * kKP + kk);
        lp[a] = ld4(lwb + (i0 + a) * kKP + kk);      // lw_prev of row i0 + a
        kv[a] = ld4(sk + (j0 + a) * kKP + kk);
        lj[a] = ld4(lwb + (j0 + a + 1) * kKP + kk);  // lw of row j0 + a
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float L = at(lj[3], e);
        float ra[4], kc[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ra[a] = at(rv[a], e) * ex2(fminf(at(lp[a], e) - L, 0.f));
#pragma unroll
        for (int cc = 0; cc < 3; ++cc)
          kc[cc] = at(kv[cc], e) * ex2(fminf(L - at(lj[cc], e), 0.f));
        kc[3] = at(kv[3], e);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[a][cc] = fmaf(ra[a], kc[cc], acc[a][cc]);
      }
    }
  }

  // 3b. the nt tiles on the diagonal, by all threads: 16 lanes a tile, one
  //     quad of k each, summed by shuffles within the 16 lanes; each entry
  //     below the diagonal with its own masked exponential, u on it.  dg
  //     holds the tile's entries (a, c <= a) at a (a + 1) / 2 + c.
  float dg[10];
#pragma unroll
  for (int e = 0; e < 10; ++e) dg[e] = 0.f;
  const int dt = tid >> 4;
  if (dt < nt && (tid & 15) < kq) {
    const int d0 = 4 * dt, kk = 4 * (tid & 15);
    float4 rv[4], lp[4], kv[4], lj[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rv[a] = ld4(sr + (d0 + a) * kKP + kk);
      lp[a] = ld4(lwb + (d0 + a) * kKP + kk);
      kv[a] = ld4(sk + (d0 + a) * kKP + kk);
      lj[a] = ld4(lwb + (d0 + a + 1) * kKP + kk);
    }
    const float4 u4 = ld4(su + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int cc = 0; cc <= a; ++cc) {
          const float x = cc < a ? ex2(fminf(at(lp[a], e) - at(lj[cc], e), 0.f)) : at(u4, e);
          dg[a * (a + 1) / 2 + cc] = fmaf(at(rv[a], e) * at(kv[cc], e), x, dg[a * (a + 1) / 2 + cc]);
        }
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int e = 0; e < 10; ++e) dg[e] += __shfl_xor_sync(0xffffffffu, dg[e], off);

  // 4. r * 2^lw_prev into registers (lw_prev <= 0), before k and lw are
  //    overwritten by A
  constexpr int kRwPer = kMax * kMax / 4 / kOutThreads;
  float4 rw[kRwPer];
#pragma unroll
  for (int e = 0; e < kRwPer; ++e) {
    const int idx = tid + e * kOutThreads;
    const int i = idx / kq, q = 4 * (idx - i * kq);
    if (i < Cp) {
      const float4 r4 = ld4(sr + i * kKP + q), l4 = ld4(lwb + i * kKP + q);
      rw[e] = make_float4(r4.x * ex2(l4.x), r4.y * ex2(l4.y), r4.z * ex2(l4.z),
                          r4.w * ex2(l4.w));
    }
  }
  __syncthreads();
  if (a_on) {
    float* At = half ? lwb : sk;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      st4(At + (j0 + cc) * kKP + i0, acc[0][cc], acc[1][cc], acc[2][cc], acc[3][cc]);
  }
  if ((tid & 15) == 0 && dt < nt) {  // the diagonal tile, zero above the diagonal
    const int d0 = 4 * dt;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      st4(sk + (d0 + cc) * kKP + d0, cc == 0 ? dg[0] : 0.f, cc <= 1 ? dg[1 + cc] : 0.f,
          cc <= 2 ? dg[3 + cc] : 0.f, dg[6 + cc]);
      st4(lwb + (d0 + cc) * kKP + d0, 0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int e = 0; e < kRwPer; ++e) {
    const int idx = tid + e * kOutThreads;
    const int i = idx / kq, q = 4 * (idx - i * kq);
    if (i < Cp) *reinterpret_cast<float4*>(sr + i * kKP + q) = rw[e];
  }
  __syncthreads();

  // 5. o tile [oi..oi+3][v0..v0+3] = A v + (r 2^lw_prev) S_start
  {
    const int oi = 4 * (tid / 16), v0 = 4 * (tid % 16);
    if (oi < C && v0 < V) {
      float oc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) oc[a][cc] = 0.f;
      const int jn = min(C, oi + 4);  // A is zero above the diagonal
      for (int j = 0; j < jn; ++j) {
        const float4 a0 = ld4(sk + j * kKP + oi), a1 = ld4(lwb + j * kKP + oi);
        const float4 x4 = ld4(sv + j * kVP + v0);
        const float aa[4] = {a0.x + a1.x, a0.y + a1.y, a0.z + a1.z, a0.w + a1.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) oc[a][cc] = fmaf(aa[a], at(x4, cc), oc[a][cc]);
      }
      for (int q4 = 0; q4 < kq; ++q4) {
        float4 ra[4], s4[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          ra[a] = ld4(sr + (oi + a) * kKP + 4 * q4);
          s4[a] = ld4(sS + (4 * q4 + a) * kVP + v0);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              oc[a][cc] = fmaf(at(ra[a], e), at(s4[e], cc), oc[a][cc]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (oi + a < C)
          st4(o + baseV + (size_t)(oi + a) * rowV + v0, oc[a][0], oc[a][1], oc[a][2], oc[a][3]);
    }
  }
}

template <typename T, int FIX>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           float* o, float* S_out, float* S_start, int B, int T_, int H, int K, int V, int C,
           cudaStream_t stream) {
  const size_t smem_s = state_smem_bytes<T>();
  const size_t smem_o = kOutSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wkv6_state_kernel<T, FIX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wkv6_out_kernel<T, FIX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_o);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's 228 KB as shared memory: five state blocks, two output
  // blocks an SM
  err = cudaFuncSetAttribute(wkv6_state_kernel<T, FIX>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wkv6_out_kernel<T, FIX>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const dim3 grid_s(B * H, (K + kKT - 1) / kKT);
  wkv6_state_kernel<T, FIX><<<grid_s, kStateThreads, smem_s, stream>>>(
      kt, vt, w, S_start, S_out, T_, H, K, V, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_o(B * H, T_ / C);
  wkv6_out_kernel<T, FIX><<<grid_o, kOutThreads, smem_o, stream>>>(
      rt, kt, vt, w, u, S_start, o, T_, H, K, V, C);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* w, const float* u,
             float* o, float* S_out, float* S_start, int B, int T_, int H, int K, int V,
             int C, cudaStream_t stream) {
  if (C == kMax && K == kMax && V == kMax)
    return launch<T, kMax>(r, k, v, w, u, o, S_out, S_start, B, T_, H, K, V, C, stream);
  return launch<T, 0>(r, k, v, w, u, o, S_out, S_start, B, T_, H, K, V, C, stream);
}

}  // namespace

// r, k, v: float32 (bf16 == 0) or bfloat16 (bf16 == 1), [B,T,H,K] and
// [B,T,H,V]; w [B,T,H,K] and u [H,K] float32; o [B,T,H,V], S_out [B,H,K,V]
// and the scratch S_start [B*H, T/C, K, V] float32, all contiguous.
extern "C" int wkv6_forward(const void* r, const void* k, const void* v, const float* w,
                            const float* u, float* o, float* S_out, float* S_start, int B,
                            int T, int H, int K, int V, int C, int bf16,
                            cudaStream_t stream) {
  if (B <= 0 || T <= 0 || H <= 0 || K <= 0 || V <= 0 || C <= 0 || K > kMax ||
      V > kMax || C > kMax || T % C != 0 || V % 4 != 0 || T / C > 65535)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, o, S_out, S_start, B, T, H, K, V, C,
                                   stream);
  return dispatch<float>(r, k, v, w, u, o, S_out, S_start, B, T, H, K, V, C, stream);
}
