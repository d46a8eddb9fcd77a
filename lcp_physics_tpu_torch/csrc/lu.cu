// Pivotless LU factorization (K1) and substitution (K2) for batches of
// small KKT systems, n <= 88, with every world's rows held in registers.
//
// Replaces the TPU kernels lcp_physics_tpu/ops/linalg.py::_lu_kernel (via
// plu_factor) and ::_solve_kernel (via plu_solve).  Same algorithm: in-place
// Doolittle LU without pivoting (the regularized KKT matrices are
// quasi-definite), pivots guarded by safe_inv and multiplied by their
// reciprocal; trans=0 solves K x = r (unit-lower L, then U), trans=1 solves
// K^T x = r (U^T, then unit-upper L^T).  Each world's matrix stays unpadded
// and batch-major (B, n, n) in memory.
//
// What bounds it on an H100: the bytes (a (4096, 16, 16) f32 factor moves
// 2 MB: 2.5 us at 3.35 TB/s) and the latency of n dependent pivot steps.
// The first design gave each world a CTA with the matrix in shared memory
// and two __syncthreads per pivot (K1), and each substitution step a warp
// reduction, a lane-0 write and a __syncwarp, reading the factor from
// global memory once per step (K2): 30 and 15 us at the forward slice's
// (4096, 16) f32.  This design:
//
// - Fixes the size at compile time in a bucket NB >= n (8, 16, 24, 32, 48,
//   64, 88; ops/linalg.py::lane_shape picks it).  Rows and columns past n
//   are zeros in registers, never in memory, and the pivot loop stops at n:
//   the same leading n x n factor as an identity padding, whose pivot
//   steps past n change nothing there.  Every loop over a row unrolls, so
//   register indices are compile-time and no index division remains.
// - K1 rounds as the plain version: its updates in the plain version's
//   order, each the product and then the difference (no FMA), so its
//   factor is the plain version's bit for bit at every n.
// - K1, NB <= 32 (lu_factor_reg): lane i of a world owns row i in
//   registers; L = NB lanes a world at NB = 8 and 16 (four and two worlds a
//   warp), 32 above; 128-thread CTAs.  Pivot step k shuffles row k from
//   lane k to the world's lanes and each lane i > k forms l = a[i][k] *
//   (1 / a[k][k]) and a[i][j] -= l * a[k][j], j > k.  No shared memory
//   and no barrier.
// - K1, NB > 32 (lu_factor_cta): a row of 88 doubles does not fit a lane
//   with the rest of a warp's rows, so a world takes a CTA of ceil(NB/32)
//   warps, a lane still owning one row in registers (176 registers at NB =
//   88 f64).  The pivot row goes through a double-buffered shared row
//   (16-byte stores and loads), one __syncthreads per pivot; the pivot
//   loop runs rolled, each step shifting the rows left by one column
//   (unrolled, NB = 88 took ~8k instructions a thread and was slower).
// - K2 (lu_solve_reg, NB <= 32) in column (axpy) form: a lane holds its
//   world's row i (trans 0) or column i (trans 1) of the factor in
//   registers and its unknown; each of the 2n steps is one shuffle of the
//   unknown just fixed and one FMA in every lane it feeds.  For NB > 32
//   (lu_solve_warp) a world takes a warp, a lane holds ceil(NB/32)
//   unknowns and loads, 8 steps at a time, the factor's entries of the
//   rows those steps update.
//   The column form sums in another order than the plain version's dot
//   products: f64 agrees with it to 1e-10, which the card tests hold.
// - Loads are 16-byte vectors where rows allow them (n * sizeof(T) % 16
//   == 0 and aligned tensors; the paths' n = 16, 24 at f32 and 56 at f64
//   do): a lane reads its own contiguous row, the warp the contiguous
//   rows of its worlds.  Columns (trans 1) are read across lanes, which is
//   coalesced as it stands.
// - Keeps warps whole: a world past B in the ragged last CTA runs on zeros
//   (K1) or on world B - 1 (K2) and stores nothing, so every shuffle has
//   all its lanes.

#include "common.cuh"

constexpr int CTA_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

// a - l * u with the product rounded first, as the plain version's
// separate multiply and subtract round it (no FMA contraction): K1's
// factor is then the plain version's bit for bit.
template <typename T>
__device__ __forceinline__ T sub_mul(T a, T l, T u) {
  if constexpr (sizeof(T) == 4)
    return __fsub_rn(a, __fmul_rn(l, u));
  else
    return __dsub_rn(a, __dmul_rn(l, u));
}

// Lanes of a warp a world takes in the register kernels (NB <= 32).
__host__ __device__ constexpr int reg_lanes(int NB) {
  return NB <= 16 ? NB : 32;
}
// Threads of the CTA a world takes in lu_factor_cta (NB > 32).
__host__ __device__ constexpr int cta_threads(int NB) {
  return (NB + 31) / 32 * 32;
}

// a[j] = src[j] for j < n, 0 past n (16-byte loads when vec).
template <typename T, int NB>
__device__ __forceinline__ void load_row(T (&a)[NB], const T* src, int n,
                                         bool vec) {
  using V = typename Vec16<T>::type;
  constexpr int VW = 16 / (int)sizeof(T);
  if (vec) {
#pragma unroll
    for (int j = 0; j < NB; j += VW) {
      V v{};
      if (j < n) v = *reinterpret_cast<const V*>(src + j);
      const T* u = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int t = 0; t < VW; ++t) a[j + t] = u[t];
    }
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j) a[j] = j < n ? src[j] : T(0);
  }
}

// dst[j] = a[j] for j < n (16-byte stores when vec).
template <typename T, int NB>
__device__ __forceinline__ void store_row(T* dst, const T (&a)[NB], int n,
                                          bool vec) {
  using V = typename Vec16<T>::type;
  constexpr int VW = 16 / (int)sizeof(T);
  if (vec) {
#pragma unroll
    for (int j = 0; j < NB; j += VW) {
      V v;
      T* u = reinterpret_cast<T*>(&v);
#pragma unroll
      for (int t = 0; t < VW; ++t) u[t] = a[j + t];
      if (j < n) *reinterpret_cast<V*>(dst + j) = v;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < n) dst[j] = a[j];
  }
}

template <typename T, int NB>
__device__ __forceinline__ void zero(T (&a)[NB]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) a[j] = T(0);
}

// Whether every row of a (B, n, n) tensor at p starts on 16 bytes.
template <typename T>
static bool rows_aligned(const T* p, int n) {
  return reinterpret_cast<size_t>(p) % 16 == 0 && (n * sizeof(T)) % 16 == 0;
}

// K1, NB <= 32: 128 / L worlds a CTA, lane i of a world owns row i.
template <typename T, int NB>
__global__ void __launch_bounds__(CTA_THREADS)
    lu_factor_reg(const T* __restrict__ K, T* __restrict__ LU, int B, int n,
                  bool vec) {
  constexpr int L = reg_lanes(NB);
  const int i = threadIdx.x % L;
  const size_t w = (size_t)blockIdx.x * (CTA_THREADS / L) + threadIdx.x / L;
  const bool own = w < (size_t)B && i < n;
  const size_t row = (w * n + i) * n;
  T a[NB];
  if (own)
    load_row(a, K + row, n, vec);
  else
    zero(a);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (k >= n) break;
    const T l = a[k] * safe_inv(__shfl_sync(FULL, a[k], k, L));
#pragma unroll
    for (int j = k + 1; j < NB; ++j) {
      const T u = __shfl_sync(FULL, a[j], k, L);
      if (own && i > k) a[j] = sub_mul(a[j], l, u);
    }
    if (own && i > k) a[k] = l;
  }
  if (own) store_row(LU + row, a, n, vec);
}

// One pivot step of lu_factor_cta on the first W slots of a thread's
// shifted row (W a bucket >= the row's live width): a[j - 1] = a[j] - l *
// pivot[j].  Slots at or past the live width are never read again.
template <int W, typename T, int NB>
__device__ __forceinline__ void shift_update(T (&a)[NB], T l, const T* pv) {
  using V = typename Vec16<T>::type;
  constexpr int VW = 16 / (int)sizeof(T);
#pragma unroll
  for (int jj = 0; jj < W; jj += VW) {
    const V v = *reinterpret_cast<const V*>(pv + jj);
    const T* u = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int t = 0; t < VW; ++t)
      if (jj + t > 0) a[jj + t - 1] = sub_mul(a[jj + t], l, u[t]);
  }
}

// shift_update in the least bucket that holds the live width w.
template <typename T, int NB>
__device__ __forceinline__ void shift_update_w(T (&a)[NB], T l, const T* pv,
                                               int w) {
  if constexpr (NB > 64)
    if (w > 64) return shift_update<NB>(a, l, pv);
  if constexpr (NB > 48)
    if (w > 48) return shift_update<(NB > 64 ? 64 : NB)>(a, l, pv);
  if (w > 32) return shift_update<48>(a, l, pv);
  if (w > 16) return shift_update<32>(a, l, pv);
  shift_update<16>(a, l, pv);
}

// K1, NB > 32: one world a CTA of cta_threads(NB), thread i owns row i.
// The pivot loop is not unrolled (the unrolled triangle is ~8k
// instructions a thread at NB = 88, past the instruction cache); instead
// a thread shifts its row left by one each step, so that the pivot column
// is always a[0] and every register index stays compile-time, and updates
// only the least bucket of slots that holds the row's live width.  It
// stores each multiplier as it forms it and its U row at the end; the
// pivot thread publishes the pivot's reciprocal with its row.
template <typename T, int NB>
__global__ void __launch_bounds__(cta_threads(NB))
    lu_factor_cta(const T* __restrict__ K, T* __restrict__ LU, int n,
                  bool vec) {
  using V = typename Vec16<T>::type;
  constexpr int VW = 16 / (int)sizeof(T);
  // two pivot rows, each with its pivot's reciprocal in slot NB
  __shared__ __align__(16) T piv[2][NB + VW];
  const int i = threadIdx.x;
  const bool own = i < n;
  const size_t row = ((size_t)blockIdx.x * n + i) * n;
  T a[NB];  // before step k: a[j] = entry (i, k + j) for j < n - k
  if (own)
    load_row(a, K + row, n, vec);
  else
    zero(a);
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    T* pv = piv[k & 1];  // step k + 1 writes the other row: one barrier
    if (i == k) {
#pragma unroll
      for (int jj = 0; jj < NB; jj += VW) {
        V v;
        T* u = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int t = 0; t < VW; ++t) u[t] = a[jj + t];
        *reinterpret_cast<V*>(pv + jj) = v;
      }
      pv[NB] = safe_inv(a[0]);
    }
    __syncthreads();
    if (own && i > k) {
      const T l = a[0] * pv[NB];
      LU[row + k] = l;
      shift_update_w(a, l, pv, n - k);
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)  // the U row, unchanged since step i
    if (own && j < n - i) LU[row + i + j] = a[j];
}

// K2, NB <= 32: 128 / L worlds a CTA; lane i holds row i (TRANS 0) or
// column i (TRANS 1) of its world's factor and its unknown v.
template <typename T, int NB, int TRANS>
__global__ void __launch_bounds__(CTA_THREADS)
    lu_solve_reg(const T* __restrict__ LU, const T* __restrict__ r,
                 T* __restrict__ x, int B, int n, bool vec) {
  constexpr int L = reg_lanes(NB);
  const int i = threadIdx.x % L;
  const size_t wr = (size_t)blockIdx.x * (CTA_THREADS / L) + threadIdx.x / L;
  const bool live = wr < (size_t)B;
  const size_t w = live ? wr : (size_t)B - 1;
  const bool own = i < n;
  const T* M = LU + w * n * n;
  T a[NB];
  T v = T(0), d = T(1);
  if (own) {
    if constexpr (TRANS == 0) {
      load_row(a, M + (size_t)i * n, n, vec);
    } else {
#pragma unroll
      for (int j = 0; j < NB; ++j) a[j] = j < n ? M[(size_t)j * n + i] : T(0);
    }
    v = r[w * n + i];
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j == i) d = a[j];
  } else {
    zero(a);
  }
  const T dinv = safe_inv(d);
  // forward: L y = r (TRANS 0, unit diagonal) or U^T z = r (TRANS 1)
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (k >= n) break;
    const T fk = __shfl_sync(FULL, TRANS == 0 ? v : v * dinv, k, L);
    if (i > k)
      v -= a[k] * fk;
    else if (TRANS == 1 && i == k)
      v = fk;
  }
  // backward: U x = y (TRANS 0) or L^T x = z (TRANS 1, unit diagonal)
#pragma unroll
  for (int k = NB - 1; k >= 0; --k) {
    if (k >= n) continue;
    const T fk = __shfl_sync(FULL, TRANS == 0 ? v * dinv : v, k, L);
    if (i < k)
      v -= a[k] * fk;
    else if (TRANS == 0 && i == k)
      v = fk;
  }
  if (live && own) x[w * n + i] = v;
}

constexpr int CHUNK = 8;  // steps whose factor entries lu_solve_warp loads at once

// c[rr][t] = M[i][k0 + t] (TRANS 0: row segments, 16-byte loads when vec)
// or M[k0 + t][i] (TRANS 1: coalesced across lanes), i = lane + 32 rr,
// for the rows lo <= i < hi (hi <= n) and k0 + t < n: the rows that the
// CHUNK steps from k0 update.  Every load is predicated:
// with an early break or continue here instead (and c partly unset),
// nvcc 12.8 gave wrong unknowns at n = 56, 57, 60, 63 and 88 on the card,
// where a host emulation of the same source was right.
template <int TRANS, typename T, int R>
__device__ __forceinline__ void load_chunk(T (&c)[R][CHUNK], const T* M,
                                           int n, int lane, int lo, int hi,
                                           int k0, bool vec) {
  using V = typename Vec16<T>::type;
  constexpr int VW = 16 / (int)sizeof(T);
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int i = lane + 32 * rr;
    const bool row = i >= lo && i < hi;
    if (TRANS == 0 && vec) {
#pragma unroll
      for (int t = 0; t < CHUNK; t += VW)
        if (row && k0 + t < n) {
          const V u = *reinterpret_cast<const V*>(M + (size_t)i * n + k0 + t);
          const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int s = 0; s < VW; ++s) c[rr][t + s] = e[s];
        }
    } else {
#pragma unroll
      for (int t = 0; t < CHUNK; ++t)
        if (row && k0 + t < n)
          c[rr][t] = TRANS == 0 ? M[(size_t)i * n + k0 + t]
                                : M[(size_t)(k0 + t) * n + i];
    }
  }
}

// K2, NB > 32: one world a warp, 4 worlds a CTA; lane l holds the unknowns
// i = l + 32 rr, rr < R, and loads its entries of the factor CHUNK steps
// at a time.
template <typename T, int NB, int TRANS>
__global__ void __launch_bounds__(CTA_THREADS)
    lu_solve_warp(const T* __restrict__ LU, const T* __restrict__ r,
                  T* __restrict__ x, int B, int n, bool vec) {
  constexpr int R = (NB + 31) / 32;
  const int lane = threadIdx.x & 31;
  const size_t wr = (size_t)blockIdx.x * (CTA_THREADS / 32) + threadIdx.x / 32;
  const bool live = wr < (size_t)B;
  const size_t w = live ? wr : (size_t)B - 1;
  const T* M = LU + w * n * n;
  T v[R], dinv[R], c[R][CHUNK] = {};
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int i = lane + 32 * rr;
    v[rr] = i < n ? r[w * n + i] : T(0);
    dinv[rr] = safe_inv(i < n ? M[(size_t)i * n + i] : T(1));
  }
  // forward: L y = r (TRANS 0, unit diagonal) or U^T z = r (TRANS 1)
#pragma unroll
  for (int kr = 0; kr < R; ++kr) {
#pragma unroll
    for (int kl = 0; kl < 32; ++kl) {
      const int k = 32 * kr + kl;
      if (k >= n) break;
      if (kl % CHUNK == 0) load_chunk<TRANS>(c, M, n, lane, k + 1, n, k, vec);
      const T fk =
          __shfl_sync(FULL, TRANS == 0 ? v[kr] : v[kr] * dinv[kr], kl);
#pragma unroll
      for (int rr = kr; rr < R; ++rr) {
        const int i = lane + 32 * rr;
        if (i > k && i < n)
          v[rr] -= c[rr][kl % CHUNK] * fk;
        else if (TRANS == 1 && i == k)
          v[rr] = fk;
      }
    }
  }
  // backward: U x = y (TRANS 0) or L^T x = z (TRANS 1, unit diagonal)
#pragma unroll
  for (int kr = R - 1; kr >= 0; --kr) {
#pragma unroll
    for (int kl = 31; kl >= 0; --kl) {
      const int k = 32 * kr + kl;
      if (kl % CHUNK == CHUNK - 1 && k - (CHUNK - 1) < n)
        load_chunk<TRANS>(c, M, n, lane, 0, k < n ? k : n, k - (CHUNK - 1),
                          vec);
      if (k >= n) continue;
      const T fk =
          __shfl_sync(FULL, TRANS == 0 ? v[kr] * dinv[kr] : v[kr], kl);
#pragma unroll
      for (int rr = 0; rr <= kr; ++rr) {
        const int i = lane + 32 * rr;
        if (i < k)
          v[rr] -= c[rr][kl % CHUNK] * fk;
        else if (TRANS == 0 && i == k)
          v[rr] = fk;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int i = lane + 32 * rr;
      if (i < n) x[w * n + i] = v[rr];
    }
  }
}

// The wrapper (ops/linalg.py::lane_shape) picks the bucket NB and the
// worlds per CTA W; a shape other than the kernel's is refused.
template <typename T, int NB>
static int launch_factor_nb(const T* K, T* LU, int B, int n, int W,
                            cudaStream_t s) {
  const bool vec = rows_aligned(K, n) && rows_aligned(LU, n);
  if constexpr (NB <= 32) {
    if (W != CTA_THREADS / reg_lanes(NB)) return (int)cudaErrorInvalidValue;
    if (B > 0)
      lu_factor_reg<T, NB><<<(B + W - 1) / W, CTA_THREADS, 0, s>>>(K, LU, B,
                                                                   n, vec);
  } else {
    if (W != 1) return (int)cudaErrorInvalidValue;
    if (B > 0)
      lu_factor_cta<T, NB><<<B, cta_threads(NB), 0, s>>>(K, LU, n, vec);
  }
  return (int)cudaGetLastError();
}

template <typename T, int NB, int TRANS>
static int launch_solve_nb(const T* LU, const T* r, T* x, int B, int n,
                           int W, cudaStream_t s) {
  const bool vec = rows_aligned(LU, n);
  if constexpr (NB <= 32) {
    if (W != CTA_THREADS / reg_lanes(NB)) return (int)cudaErrorInvalidValue;
    if (B > 0)
      lu_solve_reg<T, NB, TRANS><<<(B + W - 1) / W, CTA_THREADS, 0, s>>>(
          LU, r, x, B, n, vec);
  } else {
    if (W != CTA_THREADS / 32) return (int)cudaErrorInvalidValue;
    if (B > 0)
      lu_solve_warp<T, NB, TRANS><<<(B + W - 1) / W, CTA_THREADS, 0, s>>>(
          LU, r, x, B, n, vec);
  }
  return (int)cudaGetLastError();
}

#define LCP_LU_BUCKETS(CASE) \
  CASE(8) CASE(16) CASE(24) CASE(32) CASE(48) CASE(64) CASE(88)

template <typename T>
static int launch_factor(const T* K, T* LU, int B, int n, int NB, int W,
                         void* stream) {
  clear_last_error();
  if (n < 0 || n > NB) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (NB) {
#define LCP_CASE(NB_) \
  case NB_:           \
    return launch_factor_nb<T, NB_>(K, LU, B, n, W, s);
    LCP_LU_BUCKETS(LCP_CASE)
#undef LCP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_solve(const T* LU, const T* r, T* x, int B, int n,
                        int trans, int NB, int W, void* stream) {
  clear_last_error();
  if (n < 0 || n > NB || (trans != 0 && trans != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (NB) {
#define LCP_CASE(NB_)                                                     \
  case NB_:                                                               \
    return trans ? launch_solve_nb<T, NB_, 1>(LU, r, x, B, n, W, s)       \
                 : launch_solve_nb<T, NB_, 0>(LU, r, x, B, n, W, s);
    LCP_LU_BUCKETS(LCP_CASE)
#undef LCP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Registers, local (spill and stack) bytes and static shared bytes of the
// bucket-NB kernel of ``kind`` (0 the factor, 1 the substitution, 2 the
// transposed substitution): out = {regs a thread, local bytes a thread,
// shared bytes a CTA}.
template <typename T, int NB>
static cudaError_t attrs_nb(int kind, cudaFuncAttributes* fa) {
  if constexpr (NB <= 32) {
    if (kind == 0) return cudaFuncGetAttributes(fa, lu_factor_reg<T, NB>);
    return kind == 1 ? cudaFuncGetAttributes(fa, lu_solve_reg<T, NB, 0>)
                     : cudaFuncGetAttributes(fa, lu_solve_reg<T, NB, 1>);
  } else {
    if (kind == 0) return cudaFuncGetAttributes(fa, lu_factor_cta<T, NB>);
    return kind == 1 ? cudaFuncGetAttributes(fa, lu_solve_warp<T, NB, 0>)
                     : cudaFuncGetAttributes(fa, lu_solve_warp<T, NB, 1>);
  }
}

template <typename T>
static int attrs(int kind, int NB, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaErrorInvalidValue;
  if (kind < 0 || kind > 2) return (int)e;
  switch (NB) {
#define LCP_CASE(NB_)                  \
  case NB_:                            \
    e = attrs_nb<T, NB_>(kind, &fa);   \
    break;
    LCP_LU_BUCKETS(LCP_CASE)
#undef LCP_CASE
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  return 0;
}

extern "C" {
int lcp_lu_factor_f32(const float* K, float* LU, int B, int n, int NB, int W,
                      void* s) {
  return launch_factor<float>(K, LU, B, n, NB, W, s);
}
int lcp_lu_factor_f64(const double* K, double* LU, int B, int n, int NB,
                      int W, void* s) {
  return launch_factor<double>(K, LU, B, n, NB, W, s);
}
int lcp_lu_solve_f32(const float* LU, const float* r, float* x, int B, int n,
                     int trans, int NB, int W, void* s) {
  return launch_solve<float>(LU, r, x, B, n, trans, NB, W, s);
}
int lcp_lu_solve_f64(const double* LU, const double* r, double* x, int B,
                     int n, int trans, int NB, int W, void* s) {
  return launch_solve<double>(LU, r, x, B, n, trans, NB, W, s);
}
int lcp_lu_attrs(int kind, int f64, int NB, int* out) {
  return f64 ? attrs<double>(kind, NB, out) : attrs<float>(kind, NB, out);
}
}
