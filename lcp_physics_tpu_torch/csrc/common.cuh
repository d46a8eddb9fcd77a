// Helpers shared by the port's CUDA kernels.
#pragma once

#include <cmath>

#include <cuda_runtime.h>

// Reciprocal with the JAX package's pivot guard (ops/linalg.py _safe_inv):
// a pivot below 1e-20 in magnitude is replaced by +-1e-20.
template <typename T>
__device__ __forceinline__ T safe_inv(T d) {
  const T tiny = T(1e-20);
  const T safe = fabs(d) < tiny ? (d < T(0) ? -tiny : tiny) : d;
  return T(1) / safe;
}

// The 16-byte vector of T, for vector loads and stores.
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max/min that propagate NaN like jnp.maximum/jnp.minimum (fmax does not)
template <typename T>
__device__ inline T nmax(T a, T b) {
  return (a > b || isnan(a)) ? a : b;
}
template <typename T>
__device__ inline T nmin(T a, T b) {
  return (a < b || isnan(a)) ? a : b;
}
template <typename T>
__device__ inline T clip(T v, T lo, T hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct SumOp {
  template <typename T> __device__ T operator()(T a, T b) const { return a + b; }
};
struct MaxOp {  // NaN-propagating, like jnp.max
  template <typename T> __device__ T operator()(T a, T b) const { return nmax(a, b); }
};
struct MinOp {
  template <typename T> __device__ T operator()(T a, T b) const { return a < b ? a : b; }
};
struct NanMinOp {  // NaN-propagating, like jnp.min
  template <typename T> __device__ T operator()(T a, T b) const { return nmin(a, b); }
};

// Block-wide reduction; every thread gets the result.  Callers order their
// shared-memory writes before it with __syncthreads.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int nw = blockDim.x >> 5;
  if (nw == 1) return v;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < nw; ++w) r = op(r, red[w]);
  return r;
}

template <typename T>
__device__ inline void copy_vec(T* dst, const T* src, int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
}

// Clears an error left by an earlier runtime call of this library, so the
// cudaGetLastError() an entry point returns names its own launch only.
inline void clear_last_error() { (void)cudaGetLastError(); }

// Each library links its own CUDA runtime, whose current device is not
// PyTorch's: the wrappers select the tensors' device before a launch.
extern "C" int lcp_set_device(int device) {
  return (int)cudaSetDevice(device);
}

extern "C" const char* lcp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
