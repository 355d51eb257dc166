// Direct full 2D convolution of centred coefficient grids, and its adjoint,
// for Hopper (sm_90a), complex64 (and complex128 on the generic kernels).
//
// Replaces no TPU kernel.  The reference's 'direct' route is XLA's
// `lax.conv_general_dilated` (`repro/core/gaunt.py:131`), which XLA fuses on
// its own; in PyTorch the same sums written as n2^2 in-place slice adds
// wrote a temporary product and a strided update per shift, and autograd
// turned every slice add into a copy of the whole gradient grid.  Two
// operations close under differentiation (`kernels/direct_conv.py`):
//
//     full_conv(A[na], B[nb]) -> O[N],  O[p] = sum_{i+d=p} A[i] B[d],  N = na+nb-1
//     valid_corr(G[N], K[k])  -> R[m],  R[i] = sum_d G[i+d] K[d],      m = N-k+1
//
// on square grids (2D indices), with the backward of full_conv two
// valid_corrs of the output gradient (gA = corr(gO, conj B), gB = corr(gO,
// conj A)) and the backward of valid_corr a full_conv and a valid_corr.
// The adjoint kernel computes both valid_corrs of one G in one pass.
//
// Layout.  Operands are [E, C or 1, n, n] (complex, contiguous): E lead
// rows (edges), C channels, and an operand of channel count 1 shared by
// the C channels of its row (the general conv's filter grid, shared by the
// 256 channels of an edge).  An output is [E, C, n, n], or [E, 1, n, n]
// summed over the channels (the gradient of a shared operand).  Each
// operand may be read conjugated (a flag), so no conjugate is written out.
//
// Bound on the H100 (the general conv at the served shape: E = 16 x 32 x
// 32 edges, C = 256, A 5 x 5 per channel, B 7 x 7 shared, O 11 x 11):
//   forward  reads A (839 MB) and B (6.4 MB), writes O (4.06 GB):
//            4.9 GB, 1.46 ms at 3.35 TB/s; 25 x 49 complex multiply-adds
//            a channel, 41 GFLOP, 0.61 ms at 67 TFLOP/s
//   adjoint  reads gO (4.06 GB), A and B, writes gA (839 MB) and gB (6.4 MB):
//            5.8 GB, 1.72 ms; 82 GFLOP, 1.2 ms
// so bytes set the bound, and the design moves each byte once:
//   - fast kernels (complex64, grid sizes 3, 5, 7, 9 as template
//     parameters): a block takes one row and sweeps its channels in chunks
//     of 32; lane = channel, warp = one row of the output grid.  The
//     shared grid is staged once; each chunk's per-channel operands stream
//     into shared memory with coalesced cp.async copies, double-buffered,
//     so the next chunk loads while the block computes the current one
//     (without that overlap the kernels ran at 55% and 41% of the bound).
//     Each thread keeps one output row in registers and sums whole-row
//     products of unrolled 1D convolutions (no index arithmetic in the
//     inner loop, one shared-memory read per operand element and row),
//     and the chunk's outputs leave through shared memory as one
//     contiguous coalesced store.  Strides of odd length in float2 keep
//     the 32 lanes' reads free of bank conflicts.
//   - the adjoint runs both valid_corrs off one staging of the gradient
//     chunk (warps 0..na-1 the rows of gA, the rest the rows of gB); a
//     gradient summed over channels stays in registers across the chunks a
//     block sweeps and is reduced over the lanes by shuffles at the end, so
//     no [E, C, n, n] partial is ever written.  Where too few rows fill the
//     card, the wrapper splits a row's chunks over S blocks (S = 1 at the
//     served shape) and sums a summed gradient's S partials.
//   - generic kernels (any sizes, complex64 or complex128): one thread an
//     output element, operands read through the cache.  Only shapes the
//     fast kernels do not take reach them; none of the benchmark's does.
//
// Interface: plain C, loaded with ctypes.  A launch uses the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr size_t kSmemMax = 227 * 1024;

template <typename T> struct Cplx;
template <> struct Cplx<float> { using V = float2; };
template <> struct Cplx<double> { using V = double2; };

template <typename V>
__device__ __forceinline__ V ld(const V* p, bool conj) {
  V v = *p;
  if (conj) v.y = -v.y;
  return v;
}

// acc += a * b
template <typename V>
__device__ __forceinline__ void cmac(V& acc, const V& a, const V& b) {
  acc.x += a.x * b.x - a.y * b.y;
  acc.y += a.x * b.y + a.y * b.x;
}

// ---------------------------------------------------------------------------
// fast kernels (complex64, template sizes)
// ---------------------------------------------------------------------------

// asynchronous 8-byte copies into shared memory (cp.async): a block's next
// chunk streams in while it computes the current one
__device__ __forceinline__ void copy_async(float2* dst, const float2* src, int n, int tid,
                                           int nthr) {
  for (int i = tid; i < n; i += nthr) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src + i));
  }
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void copy_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float2 cj(float2 v, bool conj) {
  if (conj) v.y = -v.y;
  return v;
}

// O[e, c] = full_conv(A[e, c], B[e, c or 0]), conjugated with conj_o.  A
// block is (row e, split s) and sweeps the 32-channel chunks s, s + S, ...;
// NA + NB - 1 warps, warp p the output row p.  A's chunks are double
// buffered (cp.async); a shared B is staged once.
template <int NA, int NB>
__global__ void __launch_bounds__(kLanes * (NA + NB - 1))
conv_full_fast(const float2* __restrict__ A, const float2* __restrict__ B,
               float2* __restrict__ O, int C, int nchunk, int S, int b_shared, int conj_b,
               int conj_o) {
  constexpr int N = NA + NB - 1, SA = NA * NA, SB = NB * NB, SO = N * N;
  extern __shared__ float2 smem[];
  float2* sA = smem;                                  // [2][32][SA]
  float2* sB = sA + 2 * kLanes * SA;                  // [32 or 1][SB]
  float2* sO = sB + (b_shared ? SB : kLanes * SB);    // [32][SO]

  const int64_t e = blockIdx.x / S;
  const int s = blockIdx.x % S;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % kLanes, p = tid / kLanes;  // output row p
  if (b_shared)
    for (int i = tid; i < SB; i += nthr) sB[i] = ld(B + e * SB + i, conj_b);
  if (s < nchunk)
    copy_async(sA, A + (e * C + s * kLanes) * SA, min(kLanes, C - s * kLanes) * SA, tid, nthr);
  copy_commit();
  int buf = 0;
  for (int chunk = s; chunk < nchunk; chunk += S, buf ^= 1) {
    const int c0 = chunk * kLanes, nc = min(kLanes, C - c0), next = chunk + S;
    if (next < nchunk)
      copy_async(sA + (buf ^ 1) * kLanes * SA, A + (e * C + next * kLanes) * SA,
                 min(kLanes, C - next * kLanes) * SA, tid, nthr);
    copy_commit();
    if (!b_shared)
      for (int i = tid; i < nc * SB; i += nthr) sB[i] = ld(B + (e * C + c0) * SB + i, conj_b);
    copy_wait_all_but_last();
    __syncthreads();
    if (lane < nc) {
      float2 acc[N];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = make_float2(0.f, 0.f);
      const float2* a_c = sA + buf * kLanes * SA + lane * SA;
      const float2* b_c = sB + (b_shared ? 0 : lane * SB);
      const int lo = max(0, p - NB + 1), hi = min(NA - 1, p);
      for (int i = lo; i <= hi; ++i) {  // A row i, B row p - i
        float2 av[NA], bv[NB];
#pragma unroll
        for (int x = 0; x < NA; ++x) av[x] = a_c[i * NA + x];
#pragma unroll
        for (int y = 0; y < NB; ++y) bv[y] = b_c[(p - i) * NB + y];
#pragma unroll
        for (int x = 0; x < NA; ++x)
#pragma unroll
          for (int y = 0; y < NB; ++y) cmac(acc[x + y], av[x], bv[y]);
      }
      float2* o = sO + lane * SO + p * N;
#pragma unroll
      for (int j = 0; j < N; ++j) o[j] = cj(acc[j], conj_o);
    }
    __syncthreads();
    float2* gO = O + (e * C + c0) * SO;
#pragma unroll 4
    for (int i = tid; i < nc * SO; i += nthr) gO[i] = sO[i];
  }
}

// one output row r of a valid correlation, M columns, K x K kernel, the
// kernel's values read conjugated where ks = -1:
// acc[x] += sum_d sum_y G[r + d][x + y] K[d][y]  (G rows of M + K - 1)
template <int M, int K>
__device__ __forceinline__ void corr_row(float2* acc, const float2* g, const float2* k, int r,
                                         float ks) {
  constexpr int N = M + K - 1;
#pragma unroll
  for (int d = 0; d < K; ++d) {
    float2 gr[N], kr[K];
#pragma unroll
    for (int j = 0; j < N; ++j) gr[j] = g[(r + d) * N + j];
#pragma unroll
    for (int y = 0; y < K; ++y) {
      kr[y] = k[d * K + y];
      kr[y].y *= ks;
    }
#pragma unroll
    for (int x = 0; x < M; ++x)
#pragma unroll
      for (int y = 0; y < K; ++y) cmac(acc[x], gr[x + y], kr[y]);
  }
}

struct AdjArgs {
  const float2* G;   // [E, C, N, N]
  const float2* K1;  // [E, C or 1, NB, NB]  (null: no R1)
  const float2* K2;  // [E, C or 1, NA, NA]  (null: no R2)
  float2* R1;        // [E, C, NA, NA], or [S, E, NA, NA] summed over channels
  float2* R2;        // [E, C, NB, NB], or [S, E, NB, NB] summed over channels
  int64_t E;
  int C, nchunk, S;
  int k1_shared, k2_shared, r1_sum, r2_sum;
  int conj_k1, conj_k2, conj_r;
};

// R1 = valid_corr(G, K1) (NA x NA) and R2 = valid_corr(G, K2) (NB x NB),
// conjugated with conj_r, off one staging of G's chunk.  A block is (row e,
// split s) and sweeps the chunks s, s + S, ...; G's chunks and those of a
// per-channel K are double buffered (cp.async), a shared K is staged once;
// warps 0..W1-1 take R1's rows, the rest R2's.
template <int NA, int NB>
__global__ void __launch_bounds__(kLanes * (NA + NB))
corr_pair_fast(AdjArgs a) {
  constexpr int N = NA + NB - 1, SA = NA * NA, SB = NB * NB, SG = N * N;
  constexpr int MX = NA > NB ? NA : NB;
  const bool has1 = a.K1 != nullptr, has2 = a.K2 != nullptr;
  const int W1 = has1 ? NA : 0;
  // per-channel K chunks take two buffers, a shared K one
  const int n1 = has1 ? (a.k1_shared ? SB : 2 * kLanes * SB) : 0;
  const int n2 = has2 ? (a.k2_shared ? SA : 2 * kLanes * SA) : 0;
  extern __shared__ float2 smem[];
  float2* sG = smem;                                  // [2][32][SG]
  float2* sK1 = sG + 2 * kLanes * SG;
  float2* sK2 = sK1 + n1;
  float2* sR1 = sK2 + n2;                             // [32][SA]
  float2* sR2 = sR1 + (has1 && !a.r1_sum ? kLanes * SA : 0);  // [32][SB]

  const int64_t e = blockIdx.x / a.S;
  const int s = blockIdx.x % a.S;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % kLanes, w = tid / kLanes;
  const bool role1 = w < W1;
  const int r = role1 ? w : w - W1;
  const bool sum_out = role1 ? a.r1_sum : a.r2_sum;
  // a per-channel K is read conjugated as it is used, a shared one as staged
  const float ks = (role1 ? (!a.k1_shared && a.conj_k1) : (!a.k2_shared && a.conj_k2))
                       ? -1.f : 1.f;
  if (has1 && a.k1_shared)
    for (int i = tid; i < SB; i += nthr) sK1[i] = ld(a.K1 + e * SB + i, a.conj_k1);
  if (has2 && a.k2_shared)
    for (int i = tid; i < SA; i += nthr) sK2[i] = ld(a.K2 + e * SA + i, a.conj_k2);

  auto prefetch = [&](int chunk, int b) {
    const int c0 = chunk * kLanes, nc = min(kLanes, a.C - c0);
    copy_async(sG + b * kLanes * SG, a.G + (e * a.C + c0) * SG, nc * SG, tid, nthr);
    if (has1 && !a.k1_shared)
      copy_async(sK1 + b * kLanes * SB, a.K1 + (e * a.C + c0) * SB, nc * SB, tid, nthr);
    if (has2 && !a.k2_shared)
      copy_async(sK2 + b * kLanes * SA, a.K2 + (e * a.C + c0) * SA, nc * SA, tid, nthr);
  };

  float2 acc[MX];
#pragma unroll
  for (int j = 0; j < MX; ++j) acc[j] = make_float2(0.f, 0.f);

  if (s < a.nchunk) prefetch(s, 0);
  copy_commit();
  int buf = 0;
  for (int chunk = s; chunk < a.nchunk; chunk += a.S, buf ^= 1) {
    const int c0 = chunk * kLanes, nc = min(kLanes, a.C - c0);
    if (chunk + a.S < a.nchunk) prefetch(chunk + a.S, buf ^ 1);
    copy_commit();
    copy_wait_all_but_last();
    __syncthreads();

    if (lane < nc) {
      const float2* g = sG + buf * kLanes * SG + lane * SG;
      if (role1) {
        corr_row<NA, NB>(acc, g, sK1 + (a.k1_shared ? 0 : buf * kLanes * SB + lane * SB),
                         r, ks);
        if (!a.r1_sum) {
#pragma unroll
          for (int x = 0; x < NA; ++x) {
            sR1[lane * SA + r * NA + x] = cj(acc[x], a.conj_r);
            acc[x] = make_float2(0.f, 0.f);
          }
        }
      } else {
        corr_row<NB, NA>(acc, g, sK2 + (a.k2_shared ? 0 : buf * kLanes * SA + lane * SA),
                         r, ks);
        if (!a.r2_sum) {
#pragma unroll
          for (int x = 0; x < NB; ++x) {
            sR2[lane * SB + r * NB + x] = cj(acc[x], a.conj_r);
            acc[x] = make_float2(0.f, 0.f);
          }
        }
      }
    }
    __syncthreads();
    if (has1 && !a.r1_sum) {
      float2* g = a.R1 + (e * a.C + c0) * SA;
      for (int i = tid; i < nc * SA; i += nthr) g[i] = sR1[i];
    }
    if (has2 && !a.r2_sum) {
      float2* g = a.R2 + (e * a.C + c0) * SB;
      for (int i = tid; i < nc * SB; i += nthr) g[i] = sR2[i];
    }
  }

  if (sum_out) {  // the channels' sum: over the lanes, then lane 0 writes row r
    const int M = role1 ? NA : NB;
#pragma unroll
    for (int x = 0; x < MX; ++x) {
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2) {
        acc[x].x += __shfl_xor_sync(0xffffffffu, acc[x].x, off);
        acc[x].y += __shfl_xor_sync(0xffffffffu, acc[x].y, off);
      }
    }
    if (lane == 0) {
      float2* g = (role1 ? a.R1 : a.R2) + ((int64_t)s * a.E + e) * M * M + r * M;
      for (int x = 0; x < M; ++x) g[x] = cj(acc[x], a.conj_r);
    }
  }
}

// ---------------------------------------------------------------------------
// generic kernels (any sizes; complex64 or complex128)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void conv_full_generic(const typename Cplx<T>::V* __restrict__ A,
                                  const typename Cplx<T>::V* __restrict__ B,
                                  typename Cplx<T>::V* __restrict__ O, int64_t E, int C,
                                  int na, int nb, int a_shared, int b_shared, int conj_a,
                                  int conj_b) {
  using V = typename Cplx<T>::V;
  const int N = na + nb - 1, SO = N * N;
  const int64_t total = E * C * SO;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int p = (int)(idx % SO);
    const int64_t ec = idx / SO;
    const int c = (int)(ec % C);
    const int64_t e = ec / C;
    const int pi = p / N, pj = p % N;
    const V* a = A + (a_shared ? e : e * C + c) * na * na;
    const V* b = B + (b_shared ? e : e * C + c) * nb * nb;
    V acc;
    acc.x = 0;
    acc.y = 0;
    for (int i = max(0, pi - nb + 1); i <= min(na - 1, pi); ++i)
      for (int j = max(0, pj - nb + 1); j <= min(na - 1, pj); ++j)
        cmac(acc, ld(a + i * na + j, conj_a), ld(b + (pi - i) * nb + (pj - j), conj_b));
    O[idx] = acc;
  }
}

// R = valid_corr(G, K): [E, C, m, m], or [E, 1, m, m] summed over channels
template <typename T>
__global__ void corr_generic(const typename Cplx<T>::V* __restrict__ G,
                             const typename Cplx<T>::V* __restrict__ K,
                             typename Cplx<T>::V* __restrict__ R, int64_t E, int C, int N,
                             int k, int k_shared, int r_sum, int conj_g, int conj_k) {
  using V = typename Cplx<T>::V;
  const int m = N - k + 1, SR = m * m;
  const int Cr = r_sum ? 1 : C;
  const int64_t total = E * Cr * SR;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; idx < total;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int p = (int)(idx % SR);
    const int64_t er = idx / SR;
    const int rc = (int)(er % Cr);
    const int64_t e = er / Cr;
    const int ri = p / m, rj = p % m;
    V acc;
    acc.x = 0;
    acc.y = 0;
    for (int c = r_sum ? 0 : rc; c < (r_sum ? C : rc + 1); ++c) {
      const V* g = G + (e * C + c) * N * N;
      const V* kk = K + (k_shared ? e : e * C + c) * k * k;
      for (int di = 0; di < k; ++di)
        for (int dj = 0; dj < k; ++dj)
          cmac(acc, ld(g + (ri + di) * N + rj + dj, conj_g), ld(kk + di * k + dj, conj_k));
    }
    R[idx] = acc;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

inline bool fast_size(int n) { return n == 3 || n == 5 || n == 7 || n == 9; }

template <typename KernelT>
int opt_in(KernelT kernel, size_t smem) {
  // above 48 KB a block needs the opt-in, which holds for the current
  // device only: set it at every such launch (a cheap host call)
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return (int)cudaSuccess;
}

template <int NA, int NB>
int launch_full_fast(const void* A, const void* B, void* O, int64_t E, int C, int S,
                     int b_shared, int conj_b, int conj_o, cudaStream_t stream) {
  constexpr int N = NA + NB - 1;
  const size_t smem = sizeof(float2) *
      (2 * kLanes * NA * NA + (b_shared ? NB * NB : kLanes * NB * NB) + kLanes * N * N);
  const int rc = opt_in(conv_full_fast<NA, NB>, smem);
  if (rc != 0) return rc;
  const int nchunk = (C + kLanes - 1) / kLanes;
  const int64_t blocks = E * S;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  conv_full_fast<NA, NB><<<(unsigned)blocks, kLanes * N, smem, stream>>>(
      static_cast<const float2*>(A), static_cast<const float2*>(B), static_cast<float2*>(O),
      C, nchunk, S, b_shared, conj_b, conj_o);
  return (int)cudaGetLastError();
}

// shared memory of a fast adjoint launch (double-buffered G and per-channel
// K chunks, a shared K once, per-channel outputs staged)
size_t corr_smem(int na, int nb, bool has1, bool has2, int k1_shared, int k2_shared,
                 int r1_sum, int r2_sum) {
  const size_t N = na + nb - 1, sa = na * na, sb = nb * nb;
  return sizeof(float2) * (2 * kLanes * N * N
                           + (has1 ? (k1_shared ? sb : 2 * kLanes * sb) : 0)
                           + (has2 ? (k2_shared ? sa : 2 * kLanes * sa) : 0)
                           + (has1 && !r1_sum ? kLanes * sa : 0)
                           + (has2 && !r2_sum ? kLanes * sb : 0));
}

template <int NA, int NB>
int launch_corr_fast(AdjArgs a, cudaStream_t stream) {
  const bool has1 = a.K1 != nullptr, has2 = a.K2 != nullptr;
  const size_t smem = corr_smem(NA, NB, has1, has2, a.k1_shared, a.k2_shared, a.r1_sum,
                                a.r2_sum);
  const int rc = opt_in(corr_pair_fast<NA, NB>, smem);
  if (rc != 0) return rc;
  const int64_t blocks = a.E * a.S;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int threads = kLanes * ((has1 ? NA : 0) + (has2 ? NB : 0));
  corr_pair_fast<NA, NB><<<(unsigned)blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// every (na, nb) of the fast sizes
#define DIRECT_CONV_FAST_SWITCH(na, nb, CALL)                              \
  switch ((na) * 16 + (nb)) {                                              \
    case 3 * 16 + 3: return CALL(3, 3);  case 3 * 16 + 5: return CALL(3, 5); \
    case 3 * 16 + 7: return CALL(3, 7);  case 3 * 16 + 9: return CALL(3, 9); \
    case 5 * 16 + 3: return CALL(5, 3);  case 5 * 16 + 5: return CALL(5, 5); \
    case 5 * 16 + 7: return CALL(5, 7);  case 5 * 16 + 9: return CALL(5, 9); \
    case 7 * 16 + 3: return CALL(7, 3);  case 7 * 16 + 5: return CALL(7, 5); \
    case 7 * 16 + 7: return CALL(7, 7);  case 7 * 16 + 9: return CALL(7, 9); \
    case 9 * 16 + 3: return CALL(9, 3);  case 9 * 16 + 5: return CALL(9, 5); \
    case 9 * 16 + 7: return CALL(9, 7);  case 9 * 16 + 9: return CALL(9, 9); \
    default: return (int)cudaErrorInvalidValue;                            \
  }

// a grid-stride launch: up to 8 blocks of 256 threads an SM's worth
int generic_blocks(int64_t total) {
  const int64_t b = (total + 255) / 256;
  return (int)(b < 65536 * 8 ? (b > 0 ? b : 1) : 65536 * 8);
}

}  // namespace

extern "C" {

// 1 where the fast adjoint kernel takes these sizes and operands (sizes 3,
// 5, 7, 9 and its shared memory within a block's); the forward's fits at
// every fast size.
int direct_conv_adjoint_fast(int na, int nb, int has1, int has2, int k1_shared,
                             int k2_shared, int r1_sum, int r2_sum) {
  return fast_size(na) && fast_size(nb)
      && corr_smem(na, nb, has1, has2, k1_shared, k2_shared, r1_sum, r2_sum) <= kSmemMax;
}

// O [E, C, N, N] = full_conv(A, B): A [E, C or 1, na, na], B [E, C or 1,
// nb, nb] (a_shared / b_shared: channel count 1), conj_* read an operand
// conjugated; f64: complex128, else complex64; fast: the fast kernels
// (complex64, sizes 3, 5, 7, 9, A not shared unless C is 1), whose blocks
// split each row's channel chunks S ways.
int direct_conv_full(const void* A, const void* B, void* O, long long E, int C, int na,
                     int nb, int a_shared, int b_shared, int conj_a, int conj_b, int S,
                     int fast, int f64, void* stream) {
  if (E < 0 || C <= 0 || na <= 0 || nb <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if (E == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fast) {
    if (f64 || !fast_size(na) || !fast_size(nb) || (a_shared && C > 1)
        || S > (C + kLanes - 1) / kLanes)
      return (int)cudaErrorInvalidValue;
    // A streams in unconjugated: full_conv(A*, B) = (full_conv(A, B*))*
    const int conj_o = conj_a;
    conj_b ^= conj_a;
#define FULL_CALL(x, y) launch_full_fast<x, y>(A, B, O, E, C, S, b_shared, conj_b, conj_o, st)
    DIRECT_CONV_FAST_SWITCH(na, nb, FULL_CALL)
#undef FULL_CALL
  }
  const int64_t total = (int64_t)E * C * (na + nb - 1) * (na + nb - 1);
  if (f64) {
    conv_full_generic<double><<<generic_blocks(total), 256, 0, st>>>(
        static_cast<const double2*>(A), static_cast<const double2*>(B),
        static_cast<double2*>(O), E, C, na, nb, a_shared, b_shared, conj_a, conj_b);
  } else {
    conv_full_generic<float><<<generic_blocks(total), 256, 0, st>>>(
        static_cast<const float2*>(A), static_cast<const float2*>(B), static_cast<float2*>(O),
        E, C, na, nb, a_shared, b_shared, conj_a, conj_b);
  }
  return (int)cudaGetLastError();
}

// The adjoint pass over one G [E, C, N, N], N = na + nb - 1:
//   R1 = valid_corr(G, K1), K1 [E, C or 1, nb, nb] -> R1 [E, C, na, na]
//   R2 = valid_corr(G, K2), K2 [E, C or 1, na, na] -> R2 [E, C, nb, nb]
// (a null K skips its output).  r*_sum: the output is summed over the
// channels into [S, E, n, n]: the fast kernels split each row's channel
// chunks S ways, one partial a split; the generic ones take S = 1 and
// launch once an output.
int direct_conv_adjoint(const void* G, const void* K1, const void* K2, void* R1, void* R2,
                        long long E, int C, int na, int nb, int k1_shared, int k2_shared,
                        int r1_sum, int r2_sum, int S, int conj_g, int conj_k1, int conj_k2,
                        int fast, int f64, void* stream) {
  if (E < 0 || C <= 0 || na <= 0 || nb <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  if ((K1 == nullptr) != (R1 == nullptr) || (K2 == nullptr) != (R2 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (E == 0 || (K1 == nullptr && K2 == nullptr)) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nchunk = (C + kLanes - 1) / kLanes;
  if (fast) {
    if (f64 || !fast_size(na) || !fast_size(nb) || S > nchunk)
      return (int)cudaErrorInvalidValue;
    AdjArgs a;
    a.G = static_cast<const float2*>(G);
    a.K1 = static_cast<const float2*>(K1);
    a.K2 = static_cast<const float2*>(K2);
    a.R1 = static_cast<float2*>(R1);
    a.R2 = static_cast<float2*>(R2);
    a.E = E;
    a.C = C;
    a.nchunk = nchunk;
    a.S = S;
    a.k1_shared = k1_shared;
    a.k2_shared = k2_shared;
    a.r1_sum = r1_sum;
    a.r2_sum = r2_sum;
    // G streams in unconjugated: valid_corr(G*, K) = (valid_corr(G, K*))*
    a.conj_k1 = conj_k1 ^ conj_g;
    a.conj_k2 = conj_k2 ^ conj_g;
    a.conj_r = conj_g;
#define CORR_CALL(x, y) launch_corr_fast<x, y>(a, st)
    DIRECT_CONV_FAST_SWITCH(na, nb, CORR_CALL)
#undef CORR_CALL
  }
  if (S != 1) return (int)cudaErrorInvalidValue;
  const int N = na + nb - 1;
  for (int o = 0; o < 2; ++o) {
    const void* K = o == 0 ? K1 : K2;
    void* R = o == 0 ? R1 : R2;
    if (K == nullptr) continue;
    const int k = o == 0 ? nb : na, m = N - k + 1;
    const int ks = o == 0 ? k1_shared : k2_shared, rs = o == 0 ? r1_sum : r2_sum;
    const int ck = o == 0 ? conj_k1 : conj_k2;
    const int64_t total = (int64_t)E * (rs ? 1 : C) * m * m;
    if (f64) {
      corr_generic<double><<<generic_blocks(total), 256, 0, st>>>(
          static_cast<const double2*>(G), static_cast<const double2*>(K),
          static_cast<double2*>(R), E, C, N, k, ks, rs, conj_g, ck);
    } else {
      corr_generic<float><<<generic_blocks(total), 256, 0, st>>>(
          static_cast<const float2*>(G), static_cast<const float2*>(K),
          static_cast<float2*>(R), E, C, N, k, ks, rs, conj_g, ck);
    }
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
