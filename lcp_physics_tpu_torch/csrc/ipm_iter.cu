// One Mehrotra interior-point iteration for one engine-layout contact
// system per CTA, against the explicit inverse of its rotated Schur system
// (K2 = 2C + q rows, 88 < K2 <= 256).
//
// Replaces the TPU kernel lcp_physics_tpu/ops/ipm_iter.py::_iter_kernel (via
// fused_iter_ipm).  Same iteration, step for step: residuals in the
// original row layout with the products on Ghat2 = [G_c; sqrt2 G_f1; A];
// merit, best iterate, stall count and the it >= lim + 2 guard; the
// rotated Schur scalars; the predictor solve and the corrector as a delta
// solve (r1 and ry zero), each one matvec against the given inverse, with
// the closed-form u and gamma recoveries; one z-recovery from the summed
// wk; the ratio tests, the 0.99 step, the tiny floor, the pinning of padded
// rows and the non-finite halt.  The wrapper (ops/ipm_iter.py) builds the
// inverse before each launch and reads the done flags after it.
//
// The TPU kernel keeps 128 worlds on the vector lanes, computes each
// world's matvecs as one outer-batch MXU product with a diagonal
// extraction, and skips a tile once all its lanes are done.  Here a world
// already done copies its iterate, best iterate and state through; that is
// the same result, because a done world is frozen (only its stall count,
// which nothing reads, would move).
//
// What bounds it on an H100: bytes.  An iteration multiplies by the K2 x K2
// block of the inverse twice (predictor and corrector) and by Ghat2 (K2 x
// n) four times (Ghat2 z, Ghat2^T lam, Ghat2 Q^-1 r1, Ghat2^T wk); at the
// dense 64-circle scene (K2 = 256, n = 192, f32) the two matrices are
// 0.45 MB a world, and the arithmetic is 2 flops per byte read once.  The
// first design gave each column of the transposed product one thread (192
// of 256 threads busy, 8 loads in flight each) with about ten
// barrier-separated phases between the products: 0.27 ms at B = 256, 7.3x
// its bound.  Here one CTA a world keeps the world's vectors (X,
// residuals, directions, scalars, about 42 KB at that shape) in shared
// memory and reads both matrices from device memory (L2) for each
// product.  Row products give a row to a warp, eight rows a pass, with
// 16-byte loads where the rows allow them; the transposed product gives a
// warp 32 columns, each lane 4 of them at stride 8 and a quarter of the
// rows, so that a lane keeps 32 loads in flight and the four quarters meet
// in two shuffles.  Its shared memory is the vectors' alone, which
// fused_iter_supported counts, so it runs every admitted shape (n up to
// about 2,800 at f64); Ghat2 z and Ghat2^T lam stay two passes, since one
// pass would need a warp's column partials, past that count.  A cluster
// variant that held the matrices in the shared memory of a cluster of
// CTAs, read once a launch by bulk copies, ran 0.42 ms at B = 256: a
// world's vectors in every CTA of its cluster left 33 worlds on the card
// at once (PERF.md).
//
// Full f32 or f64 throughout: the solve products and the residual
// products share one precision.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = 8;  // a row product from device memory
constexpr int SMEM_LIMIT = 232448;  // shared bytes one CTA may use (sm_90)

template <typename T>
struct IterArgs {
  const T *inv, *Ghat, *qinv, *p, *h, *b, *mu, *valid, *rmask;
  const T *Xin, *bestin, *statein;
  T *Xout, *bestout, *stateout;
  int n, m, q, C, Kp, it, not_improved_lim;
  T tol, tiny, reg, dinv_min, dinv_max, stall_rtol;
};

// Shared-memory arrays of one world, carved from one buffer.
template <typename T>
struct Smem {
  T* X;                                          // z | s | lam | nu
  T *qinv, *p, *rx, *r1, *tn, *dz;               // n
  T *h, *rmask, *rz, *lam_safe, *d_inv, *r2, *dlam_a, *ds_a, *dlam, *ds,
      *r4c;                                      // m
  T *b, *ry, *nun;                               // q
  T *mu, *valid, *Dginv, *cn, *delta, *g_u, *tu; // C
  T *lamk, *y0, *y, *rhs2, *wk_a, *wk;           // K2
  T* red;                                        // 32
};

// Assigns the arrays (when S is not null) and returns the element count.
// ops/ipm_iter.py::smem_bytes repeats the count for the dispatch.
template <typename T>
__host__ __device__ inline size_t carve(Smem<T>* S, T* base, int n, int m,
                                        int q, int C) {
  const int K2 = 2 * C + q, q1 = q > 0 ? q : 1;
  size_t off = 0;
  auto take = [&](T** dst, size_t count) {
    if (S) *dst = base + off;
    off += count;
  };
  Smem<T> dummy;
  Smem<T>* d = S ? S : &dummy;
  take(&d->X, (size_t)n + 2 * m + q);
  T** vn[] = {&d->qinv, &d->p, &d->rx, &d->r1, &d->tn, &d->dz};
  T** vm[] = {&d->h,      &d->rmask,  &d->rz,   &d->lam_safe,
              &d->d_inv,  &d->r2,     &d->dlam_a, &d->ds_a,
              &d->dlam,   &d->ds,     &d->r4c};
  T** vq[] = {&d->b, &d->ry, &d->nun};
  T** vc[] = {&d->mu, &d->valid, &d->Dginv, &d->cn, &d->delta, &d->g_u,
              &d->tu};
  T** vk[] = {&d->lamk, &d->y0, &d->y, &d->rhs2, &d->wk_a, &d->wk};
  for (T** a : vn) take(a, n);
  for (T** a : vm) take(a, m);
  for (T** a : vq) take(a, q1);
  for (T** a : vc) take(a, C);
  for (T** a : vk) take(a, K2);
  take(&d->red, 32);
  return off;
}

// out[r] = sum_j M[r * ld + j] x[j], r < rows, j < cols, from device
// memory: a warp per row, ROWS_PER_PASS rows per pass, lanes on
// consecutive columns, 16 bytes a lane a load where the rows allow it (VN
// = 16 / sizeof(T) entries).
template <typename T, int VN>
__device__ void rows_dot_v(const T* __restrict__ M, int ld, int rows,
                           int cols, const T* x, T* out) {
  using V = typename std::conditional<VN == 1, T,
                                      typename Vec16<T>::type>::type;
  constexpr int R = ROWS_PER_PASS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int r0 = warp * R; r0 < rows; r0 += nw * R) {
    T acc[R];
#pragma unroll
    for (int u = 0; u < R; ++u) acc[u] = T(0);
#pragma unroll 2
    for (int j = lane * VN; j < cols; j += 32 * VN) {
      T xj[VN];
#pragma unroll
      for (int k = 0; k < VN; ++k) xj[k] = x[j + k];
#pragma unroll
      for (int u = 0; u < R; ++u)
        if (r0 + u < rows) {
          const V v =
              *reinterpret_cast<const V*>(M + (size_t)(r0 + u) * ld + j);
          const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
          for (int k = 0; k < VN; ++k) acc[u] += e[k] * xj[k];
        }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const T v = warp_sum(acc[u]);
      if (lane == 0 && r0 + u < rows) out[r0 + u] = v;
    }
  }
}

template <typename T>
__device__ void rows_dot(const T* __restrict__ M, int ld, int rows, int cols,
                         const T* x, T* out) {
  constexpr int VN = 16 / (int)sizeof(T);
  if ((reinterpret_cast<uintptr_t>(M) | ((size_t)ld * sizeof(T))) % 16 == 0
      && cols % VN == 0)
    rows_dot_v<T, VN>(M, ld, rows, cols, x, out);
  else
    rows_dot_v<T, 1>(M, ld, rows, cols, x, out);
}

// out[j] = sum_r M[r * ld + j] x[r], j < cols, r < rows, from device
// memory: a warp per 32 columns; lane (q, c) = (lane / 8, lane % 8) sums
// columns c, c + 8, c + 16, c + 24 of the tile over rows q, q + 4, ...
// (8-lane groups read 8 consecutive entries of a row; 8 rows unrolled, so
// 32 loads in flight a lane), then the four row quarters meet in two
// shuffles.
constexpr int COLS_U = 4;
template <typename T>
__device__ void cols_dot(const T* __restrict__ M, int ld, int rows, int cols,
                         const T* x, T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int rq = lane >> 3, cc = lane & 7;
  for (int c0 = warp * 32; c0 < cols; c0 += nw * 32) {
    T acc[COLS_U];
#pragma unroll
    for (int u = 0; u < COLS_U; ++u) acc[u] = T(0);
#pragma unroll 8
    for (int r = rq; r < rows; r += 4) {
      const T xr = x[r];
#pragma unroll
      for (int u = 0; u < COLS_U; ++u) {
        const int j = c0 + cc + 8 * u;
        if (j < cols) acc[u] += M[(size_t)r * ld + j] * xr;
      }
    }
#pragma unroll
    for (int u = 0; u < COLS_U; ++u) {
      T v = acc[u];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      const int j = c0 + cc + 8 * u;
      if (rq == 0 && j < cols) out[j] = v;
    }
  }
}

// A world's products, both matrices from device memory; each ends with
// its result in shared memory and a barrier behind it.
template <typename T>
struct Mats {
  const T *inv, *Gh;
  int ldi, K2, n;
  // Ghat2 z and Ghat2^T lamk
  __device__ void ghat_z_lamk(const T* z, const T* lamk, T* y0, T* rx) {
    rows_dot(Gh, n, K2, n, z, y0);
    cols_dot(Gh, n, K2, n, lamk, rx);
    __syncthreads();
  }
  __device__ void ghat_rows(const T* x, T* out) {
    rows_dot(Gh, n, K2, n, x, out);
    __syncthreads();
  }
  __device__ void inv_rows(const T* x, T* out) {
    rows_dot(inv, ldi, K2, K2, x, out);
    __syncthreads();
  }
  __device__ void ghat_cols(const T* x, T* out) {
    cols_dot(Gh, n, K2, n, x, out);
    __syncthreads();
  }
};

// The iteration over a world's vectors in shared memory.
template <typename T>
struct Iter {
  const IterArgs<T>& a;
  Smem<T>& S;
  Mats<T>& mat;
  int n, m, q, C, K2, mg;
  T sq2, rcount;

  // Rotated reduced solve (trans=0) of the rhs [r1; r2m; ry] without the
  // z-recovery: wk = S2^-1 rhs2 and dlam (m).  With y = Ghat2 (Q^-1 r1)
  // and ry given; without them r1 and ry are zero (the corrector delta).
  __device__ void kkt_parts(const T* r2m, const T* y, const T* ry, T* wk,
                            T* dlam) {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int i = tid; i < C; i += nt) {
      const T tD = S.Dginv[i] * r2m[mg + i];
      const T ru = (r2m[C + i] + r2m[2 * C + i]) / sq2;
      const T rv = (r2m[C + i] - r2m[2 * C + i]) / sq2;
      const T t_c = y ? r2m[i] - y[i] : r2m[i];
      const T t_v = y ? rv - y[C + i] : rv;
      const T t_u = ru - sq2 * S.valid[i] * tD;
      S.rhs2[i] = t_c;
      S.rhs2[C + i] = t_v - (S.delta[i] / S.g_u[i]) * t_u;
      S.tu[i] = t_u;
    }
    for (int k = tid; k < q; k += nt)
      S.rhs2[2 * C + k] = y ? ry[k] - y[2 * C + k] : T(0);
    __syncthreads();
    mat.inv_rows(S.rhs2, wk);
    for (int i = tid; i < C; i += nt) {
      const T w_c = wk[i], w_v = wk[C + i];
      const T w_u =
          (S.tu[i] - sq2 * S.cn[i] * w_c - S.delta[i] * w_v) / S.g_u[i];
      dlam[i] = w_c;
      dlam[C + i] = (w_u + w_v) / sq2;
      dlam[2 * C + i] = (w_u - w_v) / sq2;
      dlam[mg + i] = -S.Dginv[i] * (r2m[mg + i]
                                    - (-S.mu[i] * w_c + sq2 * S.valid[i] * w_u));
    }
    __syncthreads();
  }

  // min(1, largest alpha keeping s + alpha ds and lam + alpha dl >= 0 on
  // real rows), NaN-propagating
  __device__ T max_step(const T* ds, const T* dl) {
    const T* s = S.X + n;
    const T* lam = S.X + n + m;
    T r = T(INFINITY);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      if (S.rmask[i] > T(0)) {
        if (ds[i] < T(0)) r = nmin(r, -s[i] / ds[i]);
        if (dl[i] < T(0)) r = nmin(r, -lam[i] / dl[i]);
      }
    }
    return nmin(T(1), block_reduce(r, S.red, NanMinOp()));
  }

  __device__ void run(size_t w) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const int L = n + 2 * m + q;
    const T* z = S.X;
    const T* s = S.X + n;
    const T* lam = S.X + n + m;
    const T* nu = S.X + n + 2 * m;

    // ---- residuals, merit -------------------------------------------
    for (int i = tid; i < C; i += nt) {
      S.lamk[i] = lam[i];
      S.lamk[C + i] = (lam[C + i] - lam[2 * C + i]) / sq2;
    }
    for (int k = tid; k < q; k += nt) S.lamk[2 * C + k] = nu[k];
    __syncthreads();
    // [G_c z; sqrt2 G_f1 z; A z] and Ghat2^T [lam_c; lam_v; nu], one pass
    mat.ghat_z_lamk(z, S.lamk, S.y0, S.rx);
    T part_mu = T(0), part_res = T(0);
    for (int j = tid; j < n; j += nt) {
      const T r = (T(1) / S.qinv[j]) * z[j] + S.p[j] + S.rx[j];
      S.rx[j] = r;
      part_res = nmax(part_res, fabs(r));
    }
    for (int r = tid; r < m; r += nt) {
      T g;  // (G z + F lam) of row r
      if (r < C) {
        g = S.y0[r];
      } else if (r < mg) {
        const int i = (r - C) % C;
        const T gf1 = S.y0[C + i] / sq2;
        g = (r < 2 * C ? gf1 : -gf1) + -(S.valid[i] * lam[mg + i]);
      } else {
        const int i = r - mg;
        g = -S.mu[i] * lam[i] + S.valid[i] * (lam[C + i] + lam[2 * C + i]);
      }
      const T v = g + s[r] - S.h[r];
      S.rz[r] = v;
      if (S.rmask[r] > T(0)) {
        part_res = nmax(part_res, fabs(v));
        part_mu += s[r] * lam[r];
      }
    }
    for (int k = tid; k < q; k += nt) {
      const T v = S.y0[2 * C + k] - S.b[k];
      S.ry[k] = v;
      part_res = nmax(part_res, fabs(v));
    }
    const T mu_c = block_reduce(part_mu, S.red, SumOp()) / rcount;
    const T merit = mu_c + block_reduce(part_res, S.red, MaxOp());

    // ---- merit, best-iterate and stall bookkeeping ------------------
    const T* st = a.statein + w * 4;
    const T best = st[0];
    const bool improved = merit < best;
    const bool sig =
        a.stall_rtol > T(0) ? merit < best * (T(1) - a.stall_rtol) : improved;
    const T stall = sig ? T(0) : st[3] + T(1);
    const int lim = a.not_improved_lim;
    const bool stalled = lim > 0 && stall >= T(lim) && a.it >= lim + 2;
    const bool new_done = merit < a.tol || stalled;
    for (int e = tid; e < L; e += nt)
        a.bestout[w * L + e] = improved ? S.X[e] : a.bestin[w * L + e];

    // ---- rotated Schur scalars, predictor rhs -----------------------
    for (int r = tid; r < m; r += nt) {
      const T ls = nmax(lam[r], a.tiny);
      S.lam_safe[r] = ls;
      S.d_inv[r] = clip(s[r] / ls, a.dinv_min, a.dinv_max);
      S.r2[r] = -S.rz[r] + (s[r] * lam[r]) / ls;
    }
    for (int j = tid; j < n; j += nt) {
      S.r1[j] = -S.rx[j];
      S.tn[j] = S.qinv[j] * S.r1[j];
    }
    for (int k = tid; k < q; k += nt) S.ry[k] = -S.ry[k];
    __syncthreads();
    for (int i = tid; i < C; i += nt) {
      const T Dg = T(1) / (S.d_inv[mg + i] + a.reg);
      const T cf = -S.valid[i] * Dg;
      const T a1 = -(S.d_inv[C + i] + a.reg) + cf;
      const T a2 = -(S.d_inv[2 * C + i] + a.reg) + cf;
      S.Dginv[i] = Dg;
      S.cn[i] = S.valid[i] * S.mu[i] * Dg;
      S.delta[i] = T(0.5) * (a1 - a2);
      S.g_u[i] = T(0.5) * (a1 + a2) + cf;
    }
    mat.ghat_rows(S.tn, S.y);              // Ghat2 (Q^-1 r1)

    // ---- predictor --------------------------------------------------
    kkt_parts(S.r2, S.y, S.ry, S.wk_a, S.dlam_a);
    for (int r = tid; r < m; r += nt)
      S.ds_a[r] = -(s[r] * lam[r]) / S.lam_safe[r] - S.d_inv[r] * S.dlam_a[r];
    __syncthreads();
    const T alpha_a = max_step(S.ds_a, S.dlam_a);
    T part = T(0);
    for (int r = tid; r < m; r += nt)
      if (S.rmask[r] > T(0))
        part += (s[r] + alpha_a * S.ds_a[r]) * (lam[r] + alpha_a * S.dlam_a[r]);
    const T mu_aff = block_reduce(part, S.red, SumOp()) / rcount;
    const T sg = clip(mu_aff / nmax(mu_c, a.tiny), T(0), T(1));
    const T sigma = sg * sg * sg;

    // ---- corrector, as a delta on the predictor ---------------------
    for (int r = tid; r < m; r += nt) {
      const T r4 = s[r] * lam[r];
      const T r4c = r4 + S.ds_a[r] * S.dlam_a[r] - sigma * mu_c;
      S.r4c[r] = r4c;
      S.r2[r] = (r4c - r4) / S.lam_safe[r];
    }
    __syncthreads();
    kkt_parts(S.r2, nullptr, nullptr, S.wk, S.dlam);
    for (int k = tid; k < K2; k += nt) S.wk[k] = S.wk_a[k] + S.wk[k];
    for (int r = tid; r < m; r += nt) {
      const T dl = S.dlam_a[r] + S.dlam[r];
      S.dlam[r] = dl;
      S.ds[r] = -S.r4c[r] / S.lam_safe[r] - S.d_inv[r] * dl;
    }
    __syncthreads();
    mat.ghat_cols(S.wk, S.dz);             // Ghat2^T wk
    for (int j = tid; j < n; j += nt) S.dz[j] = S.qinv[j] * (S.r1[j] - S.dz[j]);
    const T alpha = T(0.99) * max_step(S.ds, S.dlam);

    // ---- new iterate, committed if finite ---------------------------
    T bad = T(0);
    for (int j = tid; j < n; j += nt) {
      const T v = z[j] + alpha * S.dz[j];
      S.dz[j] = v;
      if (!isfinite(v)) bad = T(1);
    }
    for (int r = tid; r < m; r += nt) {
      const bool real = S.rmask[r] > T(0);  // padded rows pinned
      const T sn = real ? nmax(s[r] + alpha * S.ds[r], a.tiny) : S.h[r];
      const T ln = real ? nmax(lam[r] + alpha * S.dlam[r], a.tiny) : a.tiny;
      if (!isfinite(sn) || !isfinite(ln)) bad = T(1);
      S.ds[r] = sn;
      S.dlam[r] = ln;
    }
    for (int k = tid; k < q; k += nt) {
      const T v = nu[k] + alpha * S.wk[2 * C + k];
      S.nun[k] = v;
      if (!isfinite(v)) bad = T(1);
    }
    const bool any_bad = block_reduce(bad, S.red, MaxOp()) > T(0);
    const bool halt = new_done || any_bad;
    T* Xo = a.Xout + w * L;
    for (int e = tid; e < L; e += nt) {
      T v;
      if (halt) v = S.X[e];
      else if (e < n) v = S.dz[e];
      else if (e < n + m) v = S.ds[e - n];
      else if (e < n + 2 * m) v = S.dlam[e - n - m];
      else v = S.nun[e - n - 2 * m];
      Xo[e] = v;
    }
    if (tid == 0) {
      T* so = a.stateout + w * 4;
      so[0] = nmin(merit, best);
      so[1] = halt ? T(1) : T(0);
      so[2] = new_done ? T(a.it) : st[2];
      so[3] = stall;
    }
  }
};

// Loads the world's vectors into S and returns the count of real rows
// (at least 1).  Every thread; ends with a barrier.
template <typename T>
__device__ T load_world(const IterArgs<T>& a, Smem<T>& S, size_t w) {
  const int n = a.n, m = a.m, q = a.q, C = a.C;
  const int L = n + 2 * m + q;
  copy_vec(S.X, a.Xin + w * L, L);
  copy_vec(S.qinv, a.qinv + w * n, n);
  copy_vec(S.p, a.p + w * n, n);
  copy_vec(S.h, a.h + w * m, m);
  copy_vec(S.rmask, a.rmask + w * m, m);
  copy_vec(S.b, a.b + w * q, q);
  copy_vec(S.mu, a.mu + w * C, C);
  copy_vec(S.valid, a.valid + w * C, C);
  __syncthreads();
  T cnt = T(0);
  for (int r = threadIdx.x; r < m; r += blockDim.x) cnt += S.rmask[r];
  cnt = block_reduce(cnt, S.red, SumOp());
  return cnt > T(1) ? cnt : T(1);
}

// A done world is frozen: one CTA copies it through.
template <typename T>
__device__ void copy_through(const IterArgs<T>& a, size_t w) {
  const int L = a.n + 2 * a.m + a.q;
  copy_vec(a.Xout + w * L, a.Xin + w * L, L);
  copy_vec(a.bestout + w * L, a.bestin + w * L, L);
  copy_vec(a.stateout + w * 4, a.statein + w * 4, 4);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ipm_iter_kernel(IterArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, K2 = 2 * C + a.q;
  const size_t w = blockIdx.x;
  if (a.statein[w * 4 + 1] > T(0.5)) {
    copy_through(a, w);
    return;
  }
  Smem<T> S;
  carve<T>(&S, reinterpret_cast<T*>(smem_raw), a.n, a.m, a.q, C);
  const T rcount = load_world(a, S, w);
  Mats<T> mat{a.inv + w * a.Kp * a.Kp, a.Ghat + w * K2 * a.n, a.Kp, K2,
              a.n};
  Iter<T> iter{a, S, mat, a.n, a.m, a.q, C, K2, 3 * C, sqrt(T(2)), rcount};
  iter.run(w);
}

// The wrapper (ops/ipm_iter.py) checks the size against the card's limit;
// the entry refuses an inverse narrower than K2 and a size past the limit.
template <typename T>
static int launch(IterArgs<T> a, int B, void* stream) {
  clear_last_error();
  const size_t smem =
      carve<T>(nullptr, nullptr, a.n, a.m, a.q, a.C) * sizeof(T);
  if (a.Kp < 2 * a.C + a.q || smem > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      ipm_iter_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (B > 0)
    ipm_iter_kernel<T><<<B, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#define LCP_IPM_ITER_ENTRY(NAME, T)                                          \
  int NAME(const T* inv, const T* Ghat, const T* qinv, const T* p,           \
           const T* h, const T* b, const T* mu, const T* valid,              \
           const T* rmask, const T* Xin, const T* bestin, const T* statein,  \
           T* Xout, T* bestout, T* stateout, int B, int n, int m, int q,     \
           int C, int Kp, int it, double tol, double tiny, double reg,       \
           double dinv_min, double dinv_max, int not_improved_lim,           \
           double stall_rtol, void* stream) {                                \
    IterArgs<T> a{inv,   Ghat,    qinv,     p,    h,       b,                \
                  mu,    valid,   rmask,    Xin,  bestin,  statein,          \
                  Xout,  bestout, stateout, n,    m,       q,                \
                  C,     Kp,      it,       not_improved_lim, T(tol),        \
                  T(tiny), T(reg), T(dinv_min), T(dinv_max), T(stall_rtol)}; \
    return launch<T>(a, B, stream);                                          \
  }

extern "C" {
LCP_IPM_ITER_ENTRY(lcp_ipm_iter_f32, float)
LCP_IPM_ITER_ENTRY(lcp_ipm_iter_f64, double)

// Shared memory one world needs.
long long lcp_ipm_iter_smem_bytes(int n, int m, int q, int C, int f64) {
  return f64 ? (long long)(carve<double>(nullptr, nullptr, n, m, q, C) * 8)
             : (long long)(carve<float>(nullptr, nullptr, n, m, q, C) * 4);
}

// Registers and local bytes a thread of the kernel: out = {regs, local}.
int lcp_ipm_iter_attrs(int f64, int* out) {
  clear_last_error();
  cudaFuncAttributes fa;
  const cudaError_t e =
      f64 ? cudaFuncGetAttributes(&fa, ipm_iter_kernel<double>)
          : cudaFuncGetAttributes(&fa, ipm_iter_kernel<float>);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return 0;
}
}
