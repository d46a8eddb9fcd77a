// Gauss-Jordan inverses of the diagonal panels of the blocked LU, one world
// per CTA, the panel in shared memory, no pivoting (the panels are
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
// column -C Rp, and the pivot rows Rp.  C is copied out before the
// update overwrites it.
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
// What bounds them on an H100: latency, not bandwidth or FLOPs.  A panel is
// at most 128 KB read once; the work is P (scalar) or P/16 (blocked)
// dependent, barrier-separated elimination steps over the whole panel.  The
// design answers with one CTA per world, many worlds in flight, and the
// panel resident in shared memory from load to store (above 48 KB only as
// dynamic shared memory, so the launch raises the limit as lu.cu does).

#include "common.cuh"

constexpr int GJB = 16;  // the blocked kernel's rank

__global__ void gj_inv_blocked_kernel(const float* __restrict__ K,
                                      float* __restrict__ out, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* A = reinterpret_cast<float*>(smem_raw);  // P x P
  float* Cs = A + P * P;                          // P x 16 pivot block column
  float* Rp = Cs + P * GJB;                       // 16 x P new pivot rows
  float* Dv = Rp + GJB * P;                       // 16 x 16 inverse pivot block
  const size_t off = (size_t)blockIdx.x * P * P;
  const int nn = P * P;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < nn; e += nt) A[e] = K[off + e];
  __syncthreads();
  for (int kb = 0; kb < P; kb += GJB) {
    for (int e = tid; e < P * GJB; e += nt)
      Cs[e] = A[(e / GJB) * P + kb + e % GJB];
    __syncthreads();
    if (warp == 0) {
      float a[GJB];  // column `lane` of [D | I]
#pragma unroll
      for (int i = 0; i < GJB; ++i)
        a[i] = lane < GJB ? Cs[(kb + i) * GJB + lane]
                          : (i == lane - GJB ? 1.f : 0.f);
#pragma unroll
      for (int k = 0; k < GJB; ++k) {
        const float piv = __shfl_sync(0xffffffffu, a[k], k);
        const float rj = a[k] * safe_inv(piv);
#pragma unroll
        for (int i = 0; i < GJB; ++i) {
          const float ci = __shfl_sync(0xffffffffu, a[i], k);
          a[i] = i == k ? rj : a[i] - ci * rj;
        }
      }
      if (lane >= GJB) {
#pragma unroll
        for (int i = 0; i < GJB; ++i) Dv[i * GJB + lane - GJB] = a[i];
      }
    }
    __syncthreads();
    for (int e = tid; e < GJB * P; e += nt) {
      const int r = e / P, j = e % P;
      float v;
      if (j >= kb && j < kb + GJB) {
        v = Dv[r * GJB + j - kb];
      } else {
        v = 0.f;
#pragma unroll
        for (int c = 0; c < GJB; ++c) v += Dv[r * GJB + c] * A[(kb + c) * P + j];
      }
      Rp[e] = v;
    }
    __syncthreads();
    for (int e = tid; e < nn; e += nt) {
      const int i = e / P, j = e % P;
      if (i >= kb && i < kb + GJB) {
        A[e] = Rp[(i - kb) * P + j];
      } else {
        float u = 0.f;
#pragma unroll
        for (int c = 0; c < GJB; ++c) u += Cs[i * GJB + c] * Rp[c * P + j];
        A[e] = (j >= kb && j < kb + GJB) ? -u : A[e] - u;
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < nn; e += nt) out[off + e] = A[e];
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

static int launch_blocked(const float* K, float* out, int B, int P,
                          void* stream) {
  clear_last_error();
  if (P <= 0 || P % GJB || P > 128) return (int)cudaErrorInvalidValue;
  const int smem = (P * P + 2 * P * GJB + GJB * GJB) * (int)sizeof(float);
  const int e = raise_smem(gj_inv_blocked_kernel, smem);
  if (e != 0) return e;
  if (B > 0)
    gj_inv_blocked_kernel<<<B, 256, smem, (cudaStream_t)stream>>>(K, out, P);
  return (int)cudaGetLastError();
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
