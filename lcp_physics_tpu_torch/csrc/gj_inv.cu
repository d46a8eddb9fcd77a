// Gauss-Jordan inverses of the diagonal panels of the blocked LU, one world
// per CTA (K4) or per cluster of CTAs (K5), no pivoting (the panels are
// quasi-definite: every leading principal block is nonsingular).
//
// gj_inv_blocked_kernel replaces the TPU kernel
// lcp_physics_tpu/ops/linalg.py::_gj_inv_kernel_blocked (via
// _gj_inv_blocked_call): float32 (B, P, P) panels, P % 16 == 0, P <= 128,
// inverted in place by rank-16 steps.  Per block step kb, with pivot block
// column C = A[:, kb:kb+16] and pivot block D = A[kb:kb+16, kb:kb+16]: one
// warp inverts D by scalar Gauss-Jordan on [D | I] (lane j holds column j
// of the 16 x 32 block in registers, pivots guarded by safe_inv); then
// Rp = D^-1 A[kb:kb+16, :] with its own block column set to exactly D^-1
// (the TPU kernel's "exact swap": leaving D^-1 D there instead made it
// 7.5x less accurate); then every column becomes A - C Rp, the block
// column -C Rp, and the pivot rows Rp.
//
// gj_inv_kernel replaces lcp_physics_tpu/ops/linalg.py::_gj_inv_kernel
// (the scalar branch of _gj_inverse): float32 or float64 (B, P, P) panels,
// P <= 128, one pivot per step.  The TPU kernel eliminates on the augmented
// [K | I]; this one works in place: per pivot k, row k is scaled by
// 1/A[k][k], the other entries lose A[i][k] * row[j], column k becomes
// -A[i][k]/A[k][k] and the pivot 1/A[k][k] -- the same arithmetic as the
// augmented form's right half.
//
// What bounds the blocked kernel on an H100: neither bytes (a 64-panel is
// 16 KB, read once) nor FLOPs, but the latency of P/16 dependent block
// steps, at 2 panels an SM on the training path's B = 256.  Its first
// design kept the panel in shared memory and loaded two shared operands per
// FMA of the rank-16 update, with a runtime e / P and e % P per entry, and
// took 35 us per (256, 64, 64) launch.  This design takes P as a template
// parameter and gives each of 256 threads a fixed (P/16) x (P/16) tile of
// the panel in registers from load to store: a rank-16 update loads P/16
// + P/16 operands per (P/16)^2 FMAs (16-byte loads where P/16 is a
// multiple of 4), shared memory holds only the block column (double
// buffered), the pivot rows, Rp and D^-1 (33 KB at P = 128), and a block
// step has three barriers.  D^-1 stays one warp's 16 pivots in registers,
// that warp chosen by a vote so the compiler issues plain shuffles (inside
// a plain `if (warp == 0)` it wrapped each in a convergence sequence).  Its
// dependent chain is the largest part of a block step; a ninth warp that
// inverted the next pivot block while the others finished the update
// (look-ahead), and shuffling each pivot column before its reciprocal,
// both measured slower (PERF.md).
//
// What bounds the scalar kernel: the latency of P dependent pivots, not
// bytes (a (32, 128, 128) f64 launch moves 8 MB: 2.5 us) nor FLOPs (2P^3
// a panel, ~16 us of one SM's f64 FMA rate).  Its first design gave a
// world one CTA of 512 threads over the panel in shared memory (128 KB at
// f64, so one CTA an SM and 32 of 132 SMs busy at B = 32), two
// __syncthreads a pivot, a reload of the pivot and its reciprocal in every
// thread, a runtime e / P and e % P per entry: 0.57 ms, 229x its bound.
// This design fixes the size at compile time in a bucket, spreads a world
// over a thread-block cluster of PB / 32 CTAs with their rows in
// registers, and delays the update of the other CTAs' rows to one rank-32
// product per 32 pivots, with the finished rows passed over distributed
// shared memory: one __syncthreads a pivot in one CTA and one cluster
// barrier a group (details below).  Most of the time is the 128 pivots'
// dependent chain: two designs that took the barrier out of it (the
// group's column block copied into every warp, a pivot then needing only
// a __syncwarp; or the pivot rows passed through a ring in shared memory
// with an mbarrier each) were no faster (PERF.md).

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int GJB = 16;  // the blocked kernel's rank

// n contiguous floats at p (16-byte loads when n % 4 == 0 and p is
// 16-byte aligned).
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      out[j] = v.x;
      out[j + 1] = v.y;
      out[j + 2] = v.z;
      out[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = p[j];
  }
}

// One panel per CTA of 256 threads; thread (ty, tx) of a 16 x 16 grid owns
// rows ty*TS .. ty*TS+TS-1 and the same columns from tx*TS, TS = P / 16.
template <int P>
__global__ void __launch_bounds__(256)
    gj_inv_blocked_kernel(const float* __restrict__ K, float* __restrict__ out) {
  constexpr int TS = P / GJB;
  __shared__ __align__(16) float Cs[2][GJB * P];  // block column, [c][i]
  __shared__ __align__(16) float R1[GJB * P];     // pivot rows, [r][j]
  __shared__ __align__(16) float Rp[GJB * P];     // D^-1 R1, [r][j]
  __shared__ __align__(16) float Dv[GJB * GJB];   // D^-1
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int i0 = ty * TS, j0 = tx * TS;
  const size_t off = (size_t)blockIdx.x * P * P;
  float a[TS][TS];
#pragma unroll
  for (int r = 0; r < TS; ++r)
#pragma unroll
    for (int c = 0; c < TS; ++c) a[r][c] = K[off + (i0 + r) * P + j0 + c];
#pragma unroll 1
  for (int s = 0; s < P / GJB; ++s) {
    const int kb = s * GJB;
    float* Cb = Cs[s & 1];  // double buffered: the last step may still read
    // publish the block column and the pivot rows
#pragma unroll
    for (int r = 0; r < TS; ++r)
#pragma unroll
      for (int c = 0; c < TS; ++c) {
        const int i = i0 + r, j = j0 + c;
        if (j >= kb && j < kb + GJB) Cb[(j - kb) * P + i] = a[r][c];
        if (i >= kb && i < kb + GJB) R1[(i - kb) * P + j] = a[r][c];
      }
    __syncthreads();
    // warp 0 (a vote, so the compiler sees a whole warp and issues plain
    // shuffles, not a convergence sequence around each)
    if (__all_sync(0xffffffffu, warp == 0)) {
      float d[GJB];  // column `lane` of [D | I]
#pragma unroll
      for (int i = 0; i < GJB; ++i)
        d[i] = lane < GJB ? Cb[lane * P + kb + i]
                          : (i == lane - GJB ? 1.f : 0.f);
#pragma unroll
      for (int k = 0; k < GJB; ++k) {
        const float piv = __shfl_sync(0xffffffffu, d[k], k);
        const float rj = d[k] * safe_inv(piv);
#pragma unroll
        for (int i = 0; i < GJB; ++i) {
          const float ci = __shfl_sync(0xffffffffu, d[i], k);
          d[i] = i == k ? rj : d[i] - ci * rj;
        }
      }
      if (lane >= GJB) {
#pragma unroll
        for (int i = 0; i < GJB; ++i) Dv[i * GJB + lane - GJB] = d[i];
      }
    }
    __syncthreads();
    {  // row ty of Rp, columns j0 .. j0+TS-1
      float dr[GJB], v[TS];
      load_row<GJB>(Dv + ty * GJB, dr);
#pragma unroll
      for (int c = 0; c < TS; ++c) v[c] = 0.f;
#pragma unroll
      for (int cc = 0; cc < GJB; ++cc) {
        float rv[TS];
        load_row<TS>(R1 + cc * P + j0, rv);
#pragma unroll
        for (int c = 0; c < TS; ++c) v[c] += dr[cc] * rv[c];
      }
#pragma unroll
      for (int c = 0; c < TS; ++c) {
        const int j = j0 + c;
        Rp[ty * P + j] = (j >= kb && j < kb + GJB) ? Dv[ty * GJB + j - kb] : v[c];
      }
    }
    __syncthreads();
    float u[TS][TS];
#pragma unroll
    for (int r = 0; r < TS; ++r)
#pragma unroll
      for (int c = 0; c < TS; ++c) u[r][c] = 0.f;
#pragma unroll
    for (int cc = 0; cc < GJB; ++cc) {
      float cv[TS], rv[TS];
      load_row<TS>(Cb + cc * P + i0, cv);
      load_row<TS>(Rp + cc * P + j0, rv);
#pragma unroll
      for (int r = 0; r < TS; ++r)
#pragma unroll
        for (int c = 0; c < TS; ++c) u[r][c] += cv[r] * rv[c];
    }
#pragma unroll
    for (int r = 0; r < TS; ++r) {
      const int i = i0 + r;
      const bool prow = i >= kb && i < kb + GJB;
#pragma unroll
      for (int c = 0; c < TS; ++c) {
        const int j = j0 + c;
        if (prow) a[r][c] = Rp[(i - kb) * P + j];
        else if (j >= kb && j < kb + GJB) a[r][c] = -u[r][c];
        else a[r][c] = a[r][c] - u[r][c];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TS; ++r)
#pragma unroll
    for (int c = 0; c < TS; ++c) out[off + (i0 + r) * P + j0 + c] = a[r][c];
}

// ---- the scalar kernel (K5) -------------------------------------------
//
// A world's panel, padded to the bucket PB (32, 64, 96, 128), is spread
// over a cluster of CS = PB / 32 CTAs; CTA r of the cluster holds rows
// 32r .. 32r+31 in registers (warp w rows 4w .. 4w+3 of them, lane l
// columns l, l+32, ...).  Its 32 pivots (columns 32r .. 32r+31) form group
// r.  Per group g, in order:
//
// 1. CTA g applies the group's 32 scalar pivots to its own rows: per pivot
//    t the warp owning row t scales it by safe_inv of the current pivot
//    entry and publishes it in a double-buffered shared row; one
//    __syncthreads; every other row loses col * row (col shuffled from the
//    lane owning the pivot column) and its pivot-column entry becomes
//    -col * dinv.  That is the plain version's step on these 32 rows: each
//    pivot stays a scalar pivot on the current entry.
// 2. CTA g keeps its finished rows Rp (32 x PB) in shared memory; a
//    cluster barrier publishes them.
// 3. Every other CTA copies Rp over distributed shared memory and applies
//    the group's 32 pivots to its rows at once: a row x with entries x_G in
//    the group's columns becomes x - x_G Rp outside them and -x_G Rp inside
//    (the augmented elimination's row operations, composed; no pivot block
//    is inverted).
//
// After the last group a cluster barrier keeps every Rp alive until read,
// and each CTA stores its rows.  Rows and columns from P to PB are the
// identity, set in the predicated loads and never stored: a pivot on a
// padded row subtracts 0 * x from the real entries, so the leading P x P
// block is the unpadded inverse (tests/test_torch_linalg.py shows it bit
// for bit on the plain version).
template <typename T, int NC>
__device__ __forceinline__ T pick(const T (&v)[NC], int c) {
  T r = v[0];
#pragma unroll
  for (int k = 1; k < NC; ++k)
    if (c == k) r = v[k];
  return r;
}

constexpr int GJ_ROWS = 32;      // rows a CTA of the scalar kernel holds
constexpr int GJ_THREADS = 256;  // 8 warps of GJ_RW rows
constexpr int GJ_RW = GJ_ROWS / (GJ_THREADS / 32);

// The scalar kernel's shared memory: its rows Rp and the copy of another
// CTA's (GJ_ROWS x PB each), and two pivot rows with their reciprocals.
// ops/linalg.py::gj_shape repeats the count.
template <typename T>
constexpr int gj_smem_bytes(int PB) {
  return (2 * GJ_ROWS * PB + 2 * PB + 2) * (int)sizeof(T);
}

template <typename T, int PB>
__global__ void __launch_bounds__(GJ_THREADS)
    gj_inv_kernel(const T* __restrict__ K, T* __restrict__ out, int P) {
  constexpr int NC = PB / 32;       // columns a lane holds
  constexpr int CS = PB / GJ_ROWS;  // CTAs a world
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* strip = reinterpret_cast<T*>(smem_raw);  // this CTA's Rp
  T* rbuf = strip + GJ_ROWS * PB;             // the group owner's Rp
  T* prow = rbuf + GJ_ROWS * PB;              // [2][PB]
  T* pdinv = prow + 2 * PB;                   // [2]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const size_t w = blockIdx.x / CS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = rank * GJ_ROWS + warp * GJ_RW;  // this thread's first row
  const T* Kw = K + w * P * P;
  T a[GJ_RW][NC];
#pragma unroll
  for (int rr = 0; rr < GJ_RW; ++rr)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = i0 + rr, j = lane + 32 * c;
      a[rr][c] = (i < P && j < P) ? Kw[(size_t)i * P + j]
                                  : (i == j ? T(1) : T(0));
    }
#pragma unroll 1
  for (int g = 0; g < CS; ++g) {
    if (g == rank) {
      // the group's pivots on this CTA's rows; column 32g + t is lane t's
      // slot g
#pragma unroll 1
      for (int t = 0; t < GJ_ROWS; ++t) {
        const int buf = t & 1;
        if (warp == t / GJ_RW) {  // warp-uniform
          const int rt = t % GJ_RW;
#pragma unroll
          for (int rr = 0; rr < GJ_RW; ++rr) {
            if (rr != rt) continue;
            const T piv = __shfl_sync(0xffffffffu, pick(a[rr], g), t);
            const T dinv = safe_inv(piv);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const T v = a[rr][c] * dinv;
              prow[buf * PB + lane + 32 * c] = v;
              a[rr][c] = (c == g && lane == t) ? dinv : v;
            }
            if (lane == 0) pdinv[buf] = dinv;
          }
        }
        __syncthreads();
        const T dinv = pdinv[buf];
        T pr[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) pr[c] = prow[buf * PB + lane + 32 * c];
#pragma unroll
        for (int rr = 0; rr < GJ_RW; ++rr) {
          if (warp * GJ_RW + rr == t) continue;  // warp-uniform
          const T col = __shfl_sync(0xffffffffu, pick(a[rr], g), t);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            a[rr][c] = (c == g && lane == t) ? -col * dinv
                                             : a[rr][c] - col * pr[c];
        }
      }
#pragma unroll
      for (int rr = 0; rr < GJ_RW; ++rr)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          strip[(warp * GJ_RW + rr) * PB + lane + 32 * c] = a[rr][c];
    }
    cluster.sync();  // group g's rows are published
    if (g != rank) {
      using V = typename Vec16<T>::type;
      constexpr int NV = GJ_ROWS * PB * (int)sizeof(T) / 16;
      const V* src =
          reinterpret_cast<const V*>(cluster.map_shared_rank(strip, g));
      V* dst = reinterpret_cast<V*>(rbuf);
      for (int e = threadIdx.x; e < NV; e += GJ_THREADS) dst[e] = src[e];
      __syncthreads();
      T xg[GJ_RW], u[GJ_RW][NC];
#pragma unroll
      for (int rr = 0; rr < GJ_RW; ++rr) {
        xg[rr] = pick(a[rr], g);
#pragma unroll
        for (int c = 0; c < NC; ++c) u[rr][c] = T(0);
      }
#pragma unroll 4
      for (int t = 0; t < GJ_ROWS; ++t) {
        T rp[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) rp[c] = rbuf[t * PB + lane + 32 * c];
#pragma unroll
        for (int rr = 0; rr < GJ_RW; ++rr) {
          const T x = __shfl_sync(0xffffffffu, xg[rr], t);
#pragma unroll
          for (int c = 0; c < NC; ++c) u[rr][c] += x * rp[c];
        }
      }
#pragma unroll
      for (int rr = 0; rr < GJ_RW; ++rr)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          a[rr][c] = c == g ? -u[rr][c] : a[rr][c] - u[rr][c];
    }
  }
  cluster.sync();  // every Rp has been read
  T* ow = out + w * P * P;
#pragma unroll
  for (int rr = 0; rr < GJ_RW; ++rr)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int i = i0 + rr, j = lane + 32 * c;
      if (i < P && j < P) ow[(size_t)i * P + j] = a[rr][c];
    }
}

template <typename Kern>
static int raise_smem(Kern kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int P>
static int launch_blocked_p(const float* K, float* out, int B, void* stream) {
  if (B > 0)
    gj_inv_blocked_kernel<P><<<B, 256, 0, (cudaStream_t)stream>>>(K, out);
  return (int)cudaGetLastError();
}

static int launch_blocked(const float* K, float* out, int B, int P,
                          void* stream) {
  clear_last_error();
  switch (P) {
    case 16: return launch_blocked_p<16>(K, out, B, stream);
    case 32: return launch_blocked_p<32>(K, out, B, stream);
    case 48: return launch_blocked_p<48>(K, out, B, stream);
    case 64: return launch_blocked_p<64>(K, out, B, stream);
    case 80: return launch_blocked_p<80>(K, out, B, stream);
    case 96: return launch_blocked_p<96>(K, out, B, stream);
    case 112: return launch_blocked_p<112>(K, out, B, stream);
    case 128: return launch_blocked_p<128>(K, out, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The scalar kernel's bucket for P: the least of 32, 64, 96, 128 that
// holds it (ops/linalg.py::gj_shape repeats the rule).
static int gj_bucket(int P) { return (P + 31) / 32 * 32; }

template <typename T, int PB>
static int launch_scalar_pb(const T* K, T* out, int B, int P,
                            cudaStream_t stream) {
  const int smem = gj_smem_bytes<T>(PB);
  const int e = raise_smem(gj_inv_kernel<T, PB>, smem);
  if (e != 0) return e;
  if (B <= 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * (PB / GJ_ROWS));
  cfg.blockDim = dim3(GJ_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = PB / GJ_ROWS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(&cfg, gj_inv_kernel<T, PB>, K,
                                            out, P);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

// A launch whose bucket PB or cluster size CS is not gj_bucket's is
// refused, as is a cluster launch the card refuses.
template <typename T>
static int launch_scalar(const T* K, T* out, int B, int P, int PB, int CS,
                         void* stream) {
  clear_last_error();
  if (P <= 0 || P > 128 || PB != gj_bucket(P) || CS != PB / GJ_ROWS)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (PB) {
    case 32: return launch_scalar_pb<T, 32>(K, out, B, P, s);
    case 64: return launch_scalar_pb<T, 64>(K, out, B, P, s);
    case 96: return launch_scalar_pb<T, 96>(K, out, B, P, s);
    case 128: return launch_scalar_pb<T, 128>(K, out, B, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int scalar_attrs(int PB, int* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaErrorInvalidValue;
  switch (PB) {
    case 32: e = cudaFuncGetAttributes(&fa, gj_inv_kernel<T, 32>); break;
    case 64: e = cudaFuncGetAttributes(&fa, gj_inv_kernel<T, 64>); break;
    case 96: e = cudaFuncGetAttributes(&fa, gj_inv_kernel<T, 96>); break;
    case 128: e = cudaFuncGetAttributes(&fa, gj_inv_kernel<T, 128>); break;
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = gj_smem_bytes<T>(PB);
  return 0;
}

extern "C" {
int lcp_gj_inv_blocked_f32(const float* K, float* out, int B, int P,
                           void* s) {
  return launch_blocked(K, out, B, P, s);
}
int lcp_gj_inv_f32(const float* K, float* out, int B, int P, int PB, int CS,
                   void* s) {
  return launch_scalar<float>(K, out, B, P, PB, CS, s);
}
int lcp_gj_inv_f64(const double* K, double* out, int B, int P, int PB,
                   int CS, void* s) {
  return launch_scalar<double>(K, out, B, P, PB, CS, s);
}
// Registers and local bytes a thread, and dynamic shared bytes a CTA, of
// the scalar kernel at bucket PB: out = {regs, local, shared}.
int lcp_gj_inv_attrs(int f64, int PB, int* out) {
  clear_last_error();
  return f64 ? scalar_attrs<double>(PB, out) : scalar_attrs<float>(PB, out);
}
}
