// Pairwise Gaunt collocation kernel for Hopper (sm_90a): both products on
// tensor cores with f32 accumulation, at f32 storage (3xTF32 throughout) or
// at bf16 storage (bf16 sampling, 3xTF32 projection).
//
// Replaces the TPU kernel `repro/kernels/gaunt_fused.py::_kernel` (line 116;
// launched by the pallas_call in `gaunt_fused_pallas`), at both of its
// storage dtypes.  For every row b,
//
//     out[b, :] = ((x1[b, :] . T1) * (x2[b, :] . T2)) . P
//
// with T1 [d1, G], T2 [d2, G] the operands' real SH sampled on the product
// grid and P [G, dout] the projection back to SH degrees <= Lout.  The grid
// is folded to its distinct sphere points (`constants.pair_matrices`): the
// torus grid covers the sphere twice, so G = 314 of the 676 torus samples
// at L = (6, 6, 6).
//
// Bound on the H100 at the full-width shape, (L1, L2, Lout) = (6, 6, 6),
// 81,920 rows (640 nodes x 128 channels), d1 = d2 = dout = 49, G = 314.
// The fewest operations of the exact algorithms are the sparse
// contraction's over the real Gaunt tensor: 6,460 nonzeros in 2,337
// (i, j) pairs, so one product per pair and one FMA per nonzero,
//   operations per row = 2,337 + 2 * 6,460 = 15,257 FLOP
//   bytes per row      = 4*(d1 + d2 + dout) = 588 B
// That is 1.250 GFLOP and 48.2 MB: 0.01865 ms at 67 TFLOP/s of f32 against
// 0.0144 ms at 3.35 TB/s, so the bound is set by f32 operations.  This
// kernel runs the collocation algorithm instead: 2*G*(d1 + d2) + G +
// 2*G*dout = 92,630 FLOP per row, x6 the sparse count, 0.113 ms of f32 FMAs
// alone, so on CUDA cores it could never pass ~16% of the bound.  Both of
// its stages are dense products (K = d for the sampling, K = G for the
// projection), so here they run on the tensor cores.
//
// Why 3xTF32.  One TF32 product keeps 11 significant bits of each operand:
// emulated on 4,096 seeded rows it is 4.6e-4 from the f64 product at
// (6, 6, 6), outside the port's 3e-4 f32 tier.  Split every operand as
// a = hi + lo, both TF32 (lo = a - hi, rounded again), and accumulate
// lo*hi + hi*lo + hi*hi in f32: the same emulation gives 6.6e-7 (plain f32:
// 6.4e-7) and 8.7e-7 against plain f32, inside the 1e-5 the pair kernel is
// held to.  The lo*lo term is below f32's rounding and is dropped.  The
// rounding is cvt.rna.tf32.f32's (to nearest, ties away from zero), done
// as two integer operations on the bits, which is the same result at full
// issue rate; `constants.tf32_split` does the same on the host.  The work
// after padding (d to 56, G to 320, dout to 56) is three m16n8k8 products
// per 8 x 8 x 16 step: 26.4 G TF32 FLOP at full width.
//
// Design.
//   - mma.sync.m16n8k8 tf32, one warp per 16 rows.  wgmma is not used: its
//     tf32 form reads both operands K-major from shared memory, and the
//     projection's A operand (the product V) is made in registers.
//   - Constants pre-split.  T1, T2 and P are split into hi and lo once per
//     shape on the host, zero-padded to the fragment tiles, and stored in
//     B-fragment order (`constants.pair_fragments`): a thread's hi and lo
//     of one 8 x 8 B tile are one 16-byte load, and a tile of 32 samples is
//     one contiguous run.  Zero T columns give V = 0; zero P rows add 0.
//   - V stays in registers.  The C fragment of x . T for 8 samples leaves
//     thread (g, t) the samples 2t and 2t+1 (rows g, g+8); the projection's
//     A fragment asks it for k-indices t and t+4.  P's rows are permuted
//     within each group of 8 samples as [0, 2, 4, 6, 1, 3, 5, 7]
//     (`constants.PAIR_SAMPLE_ORDER`), so the accumulators of v1 and v2,
//     multiplied, are the A fragment as they stand: no shared-memory round
//     trip and no barrier between the two products.
//   - Staging.  A block takes 128 rows (8 warps of one m-tile each).  Its
//     x1 and x2 rows are copied once into shared memory by cp.async with
//     the first T tile (f32, zero-filled past d and past B, row stride = 4
//     mod 8 so the A-fragment reads are free of bank conflicts) and split
//     as they are read.  The sample axis is a loop of 32-sample tiles: the
//     tile's T fragments and P fragments are copied by cp.async, each into
//     one buffer, T's copy overlapping the projection and P's the next
//     tile's sampling; three barriers a tile.  The output accumulator stays
//     in registers across tiles.  Rows past B are zero and never written.
//   - Output columns.  A block holds at most 8 output n-tiles (64 columns,
//     32 accumulators a thread); a larger dout (up to 289 at L = 16) is
//     split over blockIdx.y, each such block recomputing V for its rows.
//   - Occupancy.  Shared memory at (6, 6, 6) is 102 KB and registers are
//     capped at 128, so two blocks (16 warps) share an SM; 640 blocks at
//     full width.  At (8, 8, 16) it is 155 KB, one block an SM.  Resident
//     warps count for more than fragment traffic here: in a throwaway
//     sweep on the card, two m-tiles a warp (half the B-fragment reads, 8
//     warps an SM), 16-sample tiles, 4, 5 or 10 warps a block were all
//     slower than this shape.
// Small batches: a block walks all G samples whatever its rows, so at the
// Fig. 1(a) sweep's 512 rows (4 blocks) the call takes one block's latency
// over the sample loop; a smaller row tile would not shorten it, a split of
// the sample axis over blocks would.  The engine measures its candidates
// there; calls that small are set by launches and the host (PERF.md §5).
//
// What is left: the sparse contraction over the Gaunt tensor's nonzeros
// (x6 fewer operations than collocation; the bound above), and wgmma with
// V staged through shared memory if a profile shows mma.sync issue-bound.
//
// Interface: plain C, loaded with ctypes.  The launch uses the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows per block: 16 per warp
constexpr int kNT = 4;              // sample n-tiles (of 8) per staged tile
constexpr int kMaxON = 8;           // output n-tiles (of 8 columns) per block
constexpr size_t kSmemMax = 227 * 1024;

// Per storage mode: the k depth of one sampling product (8 at f32, 16 at
// bf16) and the bytes of one lane's T fragment (hi and lo of two TF32
// values; four bf16 values).  A staged row holds 8 KT + 4 32-bit words in
// both modes (f32: 8 KT + 4 values; bf16: 16 KT + 8), 4 mod 8, so the
// A-fragment reads are free of bank conflicts.
template <bool kBf16> struct Mode {
  static constexpr int kK = kBf16 ? 16 : 8;
  static constexpr int kLaneBytes = kBf16 ? 8 : 16;
};

// bytes of shared memory: the T1 and T2 fragments of one tile, the P
// fragments of one tile for ON output n-tiles, the x1 and x2 rows
template <bool kBf16>
__host__ __device__ inline size_t smem_bytes(int KT1, int KT2, int ON) {
  return (size_t)kNT * (KT1 + KT2) * 32 * Mode<kBf16>::kLaneBytes +
         (size_t)kNT * ON * 32 * 16 + (size_t)kRows * (8 * KT1 + 4 + 8 * KT2 + 4) * 4;
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero) with the low 13
// bits cleared, in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32; b = (hi b0, hi b1, lo b0, lo b1).  The small cross
// terms go first, then hi . hi.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float4 b) {
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(c, ah, bh0, bh1);
}

// c += a . b, bf16 x bf16 -> f32: a the four A registers (two bf16 each),
// b the lane's two B registers
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
// 4 bytes, or zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v[n] = x . T over the tile's kNT sample n-tiles.  xr points at this
// thread's element (row g, column t) of the warp's 16 staged rows (stride
// S); sF holds the tile's fragments [n][kt][lane].
__device__ __forceinline__ void sample(float (&v)[kNT][4], const float* xr, int S,
                                       int KT, const float4* sF, int lane) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) v[n][0] = v[n][1] = v[n][2] = v[n][3] = 0.f;
  // unrolled as far as the full-width shape's 7 k-tiles (d = 49), so that
  // ptxas loads the B fragments of later k-tiles ahead of the products
#pragma unroll 7
  for (int kt = 0; kt < KT; ++kt) {
    const float* p = xr + 8 * kt;
    uint32_t ah[4], al[4];
    split(p[0], ah[0], al[0]);          // (g, t)
    split(p[8 * S], ah[1], al[1]);      // (g + 8, t)
    split(p[4], ah[2], al[2]);          // (g, t + 4)
    split(p[8 * S + 4], ah[3], al[3]);  // (g + 8, t + 4)
#pragma unroll
    for (int n = 0; n < kNT; ++n) mma3(v[n], ah, al, sF[(n * KT + kt) * 32 + lane]);
  }
}

// The same at bf16 storage: one m16n8k16 product per 16-deep k-tile.  xr
// points at this thread's 32-bit word (row g, columns 2t and 2t + 1) of the
// warp's 16 staged bf16 rows (stride S words); sF holds the tile's
// fragments [n][kt][lane], one uint2 a lane.
__device__ __forceinline__ void sample_bf16(float (&v)[kNT][4], const uint32_t* xr, int S,
                                            int KT, const uint2* sF, int lane) {
#pragma unroll
  for (int n = 0; n < kNT; ++n) v[n][0] = v[n][1] = v[n][2] = v[n][3] = 0.f;
#pragma unroll 4
  for (int kt = 0; kt < KT; ++kt) {
    const uint32_t* p = xr + 8 * kt;
    // (g, 2t..2t+1), (g+8, 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9)
    const uint32_t a[4] = {p[0], p[8 * S], p[4], p[8 * S + 4]};
#pragma unroll
    for (int n = 0; n < kNT; ++n) mma_bf16(v[n], a, sF[(n * KT + kt) * 32 + lane]);
  }
}

// the block's rows of one bf16 operand, 16-bit loads into the padded
// layout (S words a row), zero past d and past B
__device__ __forceinline__ void stage_rows_bf16(uint32_t* sX, const unsigned short* x,
                                                int row0, int B, int d, int S, int tid) {
  unsigned short* sh = reinterpret_cast<unsigned short*>(sX);
  const int Sh = 2 * S;
  for (int e = tid; e < kRows * Sh; e += kThreads) {
    const int r = e / Sh, k = e - r * Sh;
    sh[e] = (k < d && row0 + r < B) ? __ldg(x + (size_t)(row0 + r) * d + k) : (unsigned short)0;
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
gaunt_pair_kernel(const void* __restrict__ x1, const void* __restrict__ x2,
                  const float4* __restrict__ F1, const float4* __restrict__ F2,
                  const float4* __restrict__ FP, float* __restrict__ out, int B,
                  int d1, int d2, int dout, int KT1, int KT2, int NS, int NO, int ON) {
  extern __shared__ float4 smem4[];
  // float4s of one tile's T1 and T2 fragments (at bf16 a float4 holds two lanes)
  const int n1 = kNT * KT1 * 2 * Mode<kBf16>::kLaneBytes;
  const int n2 = kNT * KT2 * 2 * Mode<kBf16>::kLaneBytes;
  float4* sT1 = smem4;                      // [kNT][KT1][32] lane fragments
  float4* sT2 = sT1 + n1;                   // [kNT][KT2][32]
  float4* sP = sT2 + n2;                    // [kNT][ON][32]
  const int S1 = 8 * KT1 + 4, S2 = 8 * KT2 + 4;  // words a staged row
  float* sX1 = reinterpret_cast<float*>(sP + kNT * ON * 32);  // [kRows][S1]
  float* sX2 = sX1 + kRows * S1;                               // [kRows][S2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRows;
  const int o0 = blockIdx.y * ON;  // the block's first output n-tile
  const int on = min(ON, NO - o0);
  const int ntiles = NS / kNT;

  auto stage_T = [&](int tile) {
    const float4* g1 = F1 + (size_t)tile * n1;
    const float4* g2 = F2 + (size_t)tile * n2;
    for (int e = tid; e < n1; e += kThreads) cp_async16(sT1 + e, g1 + e);
    for (int e = tid; e < n2; e += kThreads) cp_async16(sT2 + e, g2 + e);
  };
  auto stage_P = [&](int tile) {
    const int per = on * 32;  // float4s of one sample k-tile in this block's columns
    for (int e = tid; e < kNT * per; e += kThreads) {
      const int n = e / per, r = e - n * per;
      cp_async16(sP + n * ON * 32 + r, FP + ((size_t)(tile * kNT + n) * NO + o0) * 32 + r);
    }
  };

  // f32: the block's rows, zero past d and past B, with the first T tile;
  // then the first P tile.  bf16: the rows by 16-bit loads while the first
  // T and P tiles are in flight (the first barrier below publishes them).
  if constexpr (!kBf16) {
    const float* xf1 = static_cast<const float*>(x1);
    const float* xf2 = static_cast<const float*>(x2);
    for (int e = tid; e < kRows * S1; e += kThreads) {
      const int r = e / S1, k = e - r * S1;
      const bool in = k < d1 && row0 + r < B;
      cp_async4(sX1 + e, in ? xf1 + (size_t)(row0 + r) * d1 + k : xf1, in);
    }
    for (int e = tid; e < kRows * S2; e += kThreads) {
      const int r = e / S2, k = e - r * S2;
      const bool in = k < d2 && row0 + r < B;
      cp_async4(sX2 + e, in ? xf2 + (size_t)(row0 + r) * d2 + k : xf2, in);
    }
  }
  stage_T(0);
  cp_async_commit();
  stage_P(0);
  cp_async_commit();
  if constexpr (kBf16) {
    stage_rows_bf16(reinterpret_cast<uint32_t*>(sX1), static_cast<const unsigned short*>(x1),
                    row0, B, d1, S1, tid);
    stage_rows_bf16(reinterpret_cast<uint32_t*>(sX2), static_cast<const unsigned short*>(x2),
                    row0, B, d2, S2, tid);
  }

  float acc[kMaxON][4];
#pragma unroll
  for (int o = 0; o < kMaxON; ++o) acc[o][0] = acc[o][1] = acc[o][2] = acc[o][3] = 0.f;
  const float* xr1 = sX1 + (warp * 16 + g) * S1 + t;
  const float* xr2 = sX2 + (warp * 16 + g) * S2 + t;

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<1>();  // this tile's T, and the rows (P may still be in flight)
    __syncthreads();
    float v1[kNT][4], v2[kNT][4];
    if constexpr (kBf16) {
      sample_bf16(v1, reinterpret_cast<const uint32_t*>(xr1), S1, KT1,
                  reinterpret_cast<const uint2*>(sT1), lane);
      sample_bf16(v2, reinterpret_cast<const uint32_t*>(xr2), S2, KT2,
                  reinterpret_cast<const uint2*>(sT2), lane);
    } else {
      sample(v1, xr1, S1, KT1, sT1, lane);
      sample(v2, xr2, S2, KT2, sT2, lane);
    }
    cp_async_wait<0>();  // this tile's P
    __syncthreads();     // ... visible to all, and every warp is done with sT
    if (tile + 1 < ntiles) stage_T(tile + 1);
    cp_async_commit();

    // projection: the product samples are the A fragment (P's rows permuted)
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      uint32_t ah[4], al[4];
      split(v1[n][0] * v2[n][0], ah[0], al[0]);  // (g, sample 2t):         k = t
      split(v1[n][2] * v2[n][2], ah[1], al[1]);  // (g + 8, sample 2t):     k = t
      split(v1[n][1] * v2[n][1], ah[2], al[2]);  // (g, sample 2t + 1):     k = t + 4
      split(v1[n][3] * v2[n][3], ah[3], al[3]);  // (g + 8, sample 2t + 1): k = t + 4
#pragma unroll
      for (int o = 0; o < kMaxON; ++o)
        if (o < on) mma3(acc[o], ah, al, sP[(n * ON + o) * 32 + lane]);
    }
    __syncthreads();  // every warp is done with sP
    if (tile + 1 < ntiles) stage_P(tile + 1);
    cp_async_commit();
  }

  // accumulator (row g, column 2t + i) and (row g + 8, column 2t + i)
  const int r = row0 + warp * 16 + g;
#pragma unroll
  for (int o = 0; o < kMaxON; ++o) {
    if (o >= on) break;
    const int c = 8 * (o0 + o) + 2 * t;
    if (r < B) {
      float* dst = out + (size_t)r * dout;
      if (c < dout) dst[c] = acc[o][0];
      if (c + 1 < dout) dst[c + 1] = acc[o][1];
    }
    if (r + 8 < B) {
      float* dst = out + (size_t)(r + 8) * dout;
      if (c < dout) dst[c] = acc[o][2];
      if (c + 1 < dout) dst[c + 1] = acc[o][3];
    }
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// shared memory (bytes) of a launch at these sizes, or 0 when they are
// outside what the kernel takes
template <bool kBf16>
size_t pair_smem(int d1, int d2, int dout) {
  if (d1 <= 0 || d2 <= 0 || dout <= 0) return 0;
  const int K = Mode<kBf16>::kK, NO = ceil_div(dout, 8);
  const size_t bytes = smem_bytes<kBf16>(ceil_div(d1, K), ceil_div(d2, K),
                                         NO < kMaxON ? NO : kMaxON);
  return bytes > kSmemMax ? 0 : bytes;
}

template <bool kBf16>
int pair_forward(const void* x1, const void* x2, const void* F1, const void* F2,
                 const void* FP, void* out, int B, int d1, int d2, int dout, int NS,
                 void* stream) {
  if (B < 0 || NS <= 0 || NS % kNT != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = pair_smem<kBf16>(d1, d2, dout);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int K = Mode<kBf16>::kK;
  const int KT1 = ceil_div(d1, K), KT2 = ceil_div(d2, K), NO = ceil_div(dout, 8);
  const int ON = NO < kMaxON ? NO : kMaxON;
  // above 48 KB a block needs the opt-in, which holds for the current device
  // only: set it at every launch (a cheap host call), with the carveout
  // that lets two blocks share an SM
  cudaError_t e = cudaFuncSetAttribute(gaunt_pair_kernel<kBf16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(gaunt_pair_kernel<kBf16>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(ceil_div(B, kRows), ceil_div(NO, ON));
  gaunt_pair_kernel<kBf16><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, static_cast<const float4*>(F1), static_cast<const float4*>(F2),
      static_cast<const float4*>(FP), static_cast<float*>(out), B, d1, d2, dout, KT1, KT2,
      NS, NO, ON);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) a launch with these sizes uses, or 0 when the sizes
// are outside what the kernel takes.
size_t gaunt_pair_smem_bytes(int d1, int d2, int dout) {
  return pair_smem<false>(d1, d2, dout);
}
size_t gaunt_pair_bf16_smem_bytes(int d1, int d2, int dout) {
  return pair_smem<true>(d1, d2, dout);
}

// x1 [B, d1], x2 [B, d2] f32; F1 [NS, ceil(d1/8), 32, 4], F2 [NS,
// ceil(d2/8), 32, 4], FP [NS, ceil(dout/8), 32, 4] the split fragments
// (`constants.pair_fragments`), NS = G padded to a multiple of 32, over 8;
// out [B, dout] f32.
int gaunt_pair_forward(const void* x1, const void* x2, const void* F1, const void* F2,
                       const void* FP, void* out, int B, int d1, int d2, int dout, int NS,
                       void* stream) {
  return pair_forward<false>(x1, x2, F1, F2, FP, out, B, d1, d2, dout, NS, stream);
}

// x1 [B, d1], x2 [B, d2] bf16; F1 [NS, ceil(d1/16), 32, 4], F2 [NS,
// ceil(d2/16), 32, 4] bf16 fragments and FP as above
// (`constants.pair_fragments_bf16`); out [B, dout] f32.
int gaunt_pair_forward_bf16(const void* x1, const void* x2, const void* F1, const void* F2,
                            const void* FP, void* out, int B, int d1, int d2, int dout,
                            int NS, void* stream) {
  return pair_forward<true>(x1, x2, F1, F2, FP, out, B, d1, d2, dout, NS, stream);
}

}  // extern "C"
