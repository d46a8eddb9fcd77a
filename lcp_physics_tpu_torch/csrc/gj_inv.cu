// Gauss-Jordan inverses of the diagonal panels of the blocked LU, one world
// per CTA, no pivoting (the panels are quasi-definite: every leading
// principal block is nonsingular).
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
// [K | I] (256 KB per world at f64, more than a CTA's shared memory); this
// one works in place: per pivot k, row k is scaled by 1/A[k][k], the
// other entries lose A[i][k] * row[j], column k becomes -A[i][k]/A[k][k]
// and the pivot 1/A[k][k] -- the same arithmetic as the augmented form's
// right half, in 128 KB at f64.
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
// The scalar kernel keeps the first design (latency of P barrier-separated
// pivots over the panel in shared memory; one CTA per world).

#include "common.cuh"

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

template <typename T>
__global__ void gj_inv_kernel(const T* __restrict__ K, T* __restrict__ out,
                              int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);  // P x P
  T* rowk = A + P * P;                    // scaled pivot row
  T* colk = rowk + P;                     // pivot column
  const size_t off = (size_t)blockIdx.x * P * P;
  const int nn = P * P;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < nn; e += nt) A[e] = K[off + e];
  __syncthreads();
  for (int k = 0; k < P; ++k) {
    const T dinv = safe_inv(A[k * P + k]);
    for (int t = tid; t < P; t += nt) {
      rowk[t] = A[k * P + t] * dinv;
      colk[t] = A[t * P + k];
    }
    __syncthreads();
    for (int e = tid; e < nn; e += nt) {
      const int i = e / P, j = e % P;
      T v;
      if (i == k)
        v = j == k ? dinv : rowk[j];
      else if (j == k)
        v = -colk[i] * dinv;
      else
        v = A[e] - colk[i] * rowk[j];
      A[e] = v;
    }
    __syncthreads();
  }
  for (int e = tid; e < nn; e += nt) out[off + e] = A[e];
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

template <typename T>
static int launch_scalar(const T* K, T* out, int B, int P, void* stream) {
  clear_last_error();
  if (P <= 0 || P > 128) return (int)cudaErrorInvalidValue;
  const int smem = (P * P + 2 * P) * (int)sizeof(T);
  const int e = raise_smem(gj_inv_kernel<T>, smem);
  if (e != 0) return e;
  if (B > 0)
    gj_inv_kernel<T><<<B, 512, smem, (cudaStream_t)stream>>>(K, out, P);
  return (int)cudaGetLastError();
}

extern "C" {
int lcp_gj_inv_blocked_f32(const float* K, float* out, int B, int P,
                           void* s) {
  return launch_blocked(K, out, B, P, s);
}
int lcp_gj_inv_f32(const float* K, float* out, int B, int P, void* s) {
  return launch_scalar<float>(K, out, B, P, s);
}
int lcp_gj_inv_f64(const double* K, double* out, int B, int P, void* s) {
  return launch_scalar<double>(K, out, B, P, s);
}
}
