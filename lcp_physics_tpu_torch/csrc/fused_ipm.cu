// The whole Mehrotra interior-point loop for one engine-layout contact
// system per CTA, in two variants: the friction-pair ROTATED one
// (K = 2C + q <= 48) and the UNROTATED one (K = (1 + fd)C + q <= 48).
//
// Replaces the TPU kernel lcp_physics_tpu/ops/ipm.py::_fused_ipm_kernel
// (via fused_ipm; rot=True and rot=False).  Same algorithm, step for step:
// residuals in the original row layout with the matvecs on Ghat (rotated:
// [G_c; sqrt2 G_f1; A], unrotated: [G_kept; A]); the Schur system (rotated:
// S = -P - diag(dmain) + (v-row, c-col) band; unrotated: S = -P - diag(dmain)
// + the per-contact bands cn = valid mu Dginv at (friction row, normal
// column) and cf = -valid Dginv at (friction row, friction column of the
// same contact, every pair of directions)); an in-place pivotless
// Gauss-Jordan explicit inverse; each KKT solve one inverse matvec plus one
// refinement step; predictor and corrector with ratio tests and row_mask
// pinning; stall exit with the it >= lim + 2 guard, non-finite halt and
// best-iterate return.  The wrapper (ops/ipm.py::fused_ipm) forms P =
// Ghat Q^-1 Ghat^T and Ghat outside.  The TPU kernel's (K, K) structure
// masks of the unrotated bands are index arithmetic here: row C(1+d)+i
// meets column i and columns C(1+d2)+i.
//
// The TPU kernel keeps a tile of worlds on the vector lanes and skips a
// tile once every lane in it is done.  Here a world leaves the loop as
// soon as it is done; that is the same result, because a done world is
// frozen and its best iterate can never change again.  A world that is
// done at the top of an iteration skips that iteration's factor and
// solves, whose result the TPU kernel discards.
//
// What bounds it on an H100: latency of about K + 40 dependent,
// __syncthreads-separated steps per iteration (K Gauss-Jordan pivots over
// a K x K matrix, the matvecs and block reductions), not bytes: a world's
// inputs are a few KB, read once.  The design keeps every operand of the
// loop in shared memory (S, P, Ghat when it fits, the iterate, the best
// iterate and the direction vectors), gives each world its own CTA with
// threads over rows, and keeps the scalar state (best merit, stall count,
// iteration count) in registers, identical in every thread.

#include <cmath>

#include "common.cuh"

template <typename T>
struct IpmArgs {
  const T *P, *Ghat, *qinv, *p, *h, *b, *mu, *valid, *rmask;
  const T *z0, *s0, *lam0, *nu0;
  T *z, *s, *lam, *nu, *mu_out, *resid;
  int* iters;
  int n, m, q, C, fd, max_iter, not_improved_lim, ghat_smem;
  T tol, tiny, reg, dinv_min, dinv_max, stall_rtol;
};

// Rows of the Schur system: rotated 2C + q, unrotated (1 + fd)C + q.
__host__ __device__ inline int schur_rows(int C, int fd, int q, bool rot) {
  return rot ? 2 * C + q : (1 + fd) * C + q;
}

// Shared-memory arrays of one world, carved from one buffer.
template <typename T>
struct Smem {
  T *P, *S, *Gh;
  T *qinv, *qd, *p, *h, *b, *mu, *valid, *rmask;
  T *z, *s, *lam, *nu, *bz, *bs, *blam, *bnu;
  T *rx, *rz, *ry, *lamk, *y, *y1;
  T *lam_safe, *d_inv, *Dginv, *cn, *cf, *delta, *g_u, *dmain, *bn;
  T *rowbuf, *colbuf, *tn, *r1, *r2, *ryn, *tu, *rhs2, *x, *res, *wk;
  T *dz, *dlam, *dnu, *ds, *dlam_a, *ds_a, *r4c, *red;
};

// Assigns the arrays (when S is not null) and returns the element count.
template <typename T>
__host__ __device__ inline size_t carve(Smem<T>* S, T* base, int n, int m,
                                        int q, int C, int K, int ghat_smem) {
  const int q1 = q > 0 ? q : 1;
  size_t off = 0;
  auto take = [&](T** dst, size_t count) {
    if (S) *dst = base + off;
    off += count;
  };
  Smem<T> dummy;
  Smem<T>* d = S ? S : &dummy;
  take(&d->P, (size_t)K * K);
  take(&d->S, (size_t)K * K);
  if (ghat_smem) take(&d->Gh, (size_t)K * n);
  T** vn[] = {&d->qinv, &d->qd, &d->p, &d->z, &d->bz, &d->rx, &d->tn,
              &d->r1, &d->dz};
  T** vm[] = {&d->h, &d->rmask, &d->s, &d->lam, &d->bs, &d->blam, &d->rz,
              &d->lam_safe, &d->d_inv, &d->r2, &d->dlam, &d->ds,
              &d->dlam_a, &d->ds_a, &d->r4c};
  T** vq[] = {&d->b, &d->nu, &d->bnu, &d->ry, &d->ryn, &d->dnu};
  T** vc[] = {&d->mu, &d->valid, &d->Dginv, &d->cn, &d->cf, &d->delta,
              &d->g_u, &d->bn, &d->tu};
  T** vk[] = {&d->lamk, &d->y, &d->y1, &d->dmain, &d->rowbuf, &d->colbuf,
              &d->rhs2, &d->x, &d->res, &d->wk};
  for (T** a : vn) take(a, n);
  for (T** a : vm) take(a, m);
  for (T** a : vq) take(a, q1);
  for (T** a : vc) take(a, C);
  for (T** a : vk) take(a, K);
  take(&d->red, 32);
  return off;
}

template <typename T, bool ROT>
struct Ipm {
  const IpmArgs<T>& a;
  Smem<T>& S;
  const T* Gh;
  // mg: kept inequality rows (1 + fd)C; kq: first equality row of the
  // Schur system (rotated 2C, unrotated mg)
  int n, m, q, C, fd, K, mg, kq;
  T sq2, rcount;

  // rx (n), rz (m), ry (q) at the current iterate; returns (mu_c, resid).
  __device__ void measures(T& mu_c, T& resid) {
    const int tid = threadIdx.x, nt = blockDim.x;
    if constexpr (ROT) {
      for (int i = tid; i < C; i += nt) {
        S.lamk[i] = S.lam[i];
        S.lamk[C + i] = (S.lam[C + i] - S.lam[2 * C + i]) / sq2;
      }
    } else {
      for (int k = tid; k < mg; k += nt) S.lamk[k] = S.lam[k];
    }
    for (int k = tid; k < q; k += nt) S.lamk[kq + k] = S.nu[k];
    for (int k = tid; k < K; k += nt) {
      T acc = T(0);
      for (int j = 0; j < n; ++j) acc += Gh[k * n + j] * S.z[j];
      S.y[k] = acc;  // rotated [G_c z; sqrt2 G_f1 z; A z], else [G_kept z; A z]
    }
    __syncthreads();
    T part_mu = T(0), part_res = T(0);
    for (int j = tid; j < n; j += nt) {
      T acc = T(0);
      for (int k = 0; k < K; ++k) acc += Gh[k * n + j] * S.lamk[k];
      const T r = S.qd[j] * S.z[j] + S.p[j] + acc;
      S.rx[j] = r;
      part_res = nmax(part_res, fabs(r));
    }
    for (int r = tid; r < m; r += nt) {
      T gz;
      if (r < C) {
        gz = S.y[r];
      } else if (r < mg) {
        const int i = (r - C) % C;
        T g;
        if constexpr (ROT) {
          const T gf1 = S.y[C + i] / sq2;
          g = r < 2 * C ? gf1 : -gf1;
        } else {
          g = S.y[r];
        }
        gz = g - S.valid[i] * S.lam[mg + i];
      } else {
        const int i = r - mg;
        T bsum = T(0);
        for (int d = 0; d < fd; ++d) bsum += S.lam[C * (1 + d) + i];
        gz = -S.mu[i] * S.lam[i] + S.valid[i] * bsum;
      }
      const T v = gz + S.s[r] - S.h[r];
      S.rz[r] = v;
      if (S.rmask[r] > T(0)) {
        part_res = nmax(part_res, fabs(v));
        part_mu += S.s[r] * S.lam[r];
      }
    }
    for (int k = tid; k < q; k += nt) {
      const T v = S.y[kq + k] - S.b[k];
      S.ry[k] = v;
      part_res = nmax(part_res, fabs(v));
    }
    mu_c = block_reduce(part_mu, S.red, SumOp()) / rcount;
    resid = block_reduce(part_res, S.red, MaxOp());
    __syncthreads();
  }

  // Row i of S x from S's structured form (S.S holds the inverse by now).
  __device__ T apply_S_row(int i, const T* x) {
    T acc = T(0);
    for (int j = 0; j < K; ++j) acc += S.P[i * K + j] * x[j];
    T ax = -acc - S.dmain[i] * x[i];
    if constexpr (ROT) {
      if (i >= C && i < 2 * C) ax += S.bn[i - C] * x[i - C];
    } else {
      if (i >= C && i < mg) {
        const int ci = (i - C) % C;
        T xf = T(0);
        for (int d = 0; d < fd; ++d) xf += x[C * (1 + d) + ci];
        ax = ax + (S.cn[ci] * x[ci] + S.cf[ci] * xf);
      }
    }
    return ax;
  }

  // out = S^-1 rhs plus one refinement step against the structured S.
  __device__ void solve_S(const T* rhs, T* out) {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int i = tid; i < K; i += nt) {
      T acc = T(0);
      for (int j = 0; j < K; ++j) acc += S.S[i * K + j] * rhs[j];
      S.x[i] = acc;
    }
    __syncthreads();
    for (int i = tid; i < K; i += nt) S.res[i] = rhs[i] - apply_S_row(i, S.x);
    __syncthreads();
    for (int i = tid; i < K; i += nt) {
      T acc = T(0);
      for (int j = 0; j < K; ++j) acc += S.S[i * K + j] * S.res[j];
      out[i] = S.x[i] + acc;
    }
    __syncthreads();
  }

  // KKT solve (trans=0) for rhs [r1; r2; ryn] with S.y1 = Ghat (qinv r1)
  // precomputed; dz and dnu may be null.  Rotated: _rot_factor_factory's
  // solve; unrotated: factor_schur_gamma's with the ConeF coupling.
  __device__ void kkt_solve(T* dz, T* dlam, T* dnu) {
    const int tid = threadIdx.x, nt = blockDim.x;
    const T* r2 = S.r2;
    if constexpr (ROT) {
      for (int i = tid; i < C; i += nt) {
        const T tD = S.Dginv[i] * r2[mg + i];
        const T ru = (r2[C + i] + r2[2 * C + i]) / sq2;
        const T rv = (r2[C + i] - r2[2 * C + i]) / sq2;
        const T t_u = ru - sq2 * S.valid[i] * tD;
        S.rhs2[i] = r2[i] - S.y1[i];
        S.rhs2[C + i] = (rv - S.y1[C + i]) - (S.delta[i] / S.g_u[i]) * t_u;
        S.tu[i] = t_u;
      }
    } else {
      for (int k = tid; k < mg; k += nt) {
        T v = r2[k] - S.y1[k];
        if (k >= C) {  // the gamma rows' coupling: -valid Dginv tg
          const int ci = (k - C) % C;
          v = v + (-S.valid[ci] * (S.Dginv[ci] * r2[mg + ci]));
        }
        S.rhs2[k] = v;
      }
    }
    for (int k = tid; k < q; k += nt) S.rhs2[kq + k] = S.ryn[k] - S.y1[kq + k];
    __syncthreads();
    solve_S(S.rhs2, S.wk);
    if constexpr (ROT) {
      for (int i = tid; i < C; i += nt) {
        const T w_c = S.wk[i], w_v = S.wk[C + i];
        const T w_u = (S.tu[i] - sq2 * S.cn[i] * w_c - S.delta[i] * w_v) / S.g_u[i];
        dlam[i] = w_c;
        dlam[C + i] = (w_u + w_v) / sq2;
        dlam[2 * C + i] = (w_u - w_v) / sq2;
        dlam[mg + i] = -S.Dginv[i]
                       * (r2[mg + i] - (-S.mu[i] * w_c + sq2 * S.valid[i] * w_u));
      }
    } else {
      for (int k = tid; k < mg; k += nt) dlam[k] = S.wk[k];
      for (int i = tid; i < C; i += nt) {
        T wf = T(0);  // every friction direction of contact i
        for (int d = 0; d < fd; ++d) wf += S.wk[C * (1 + d) + i];
        dlam[mg + i] = -S.Dginv[i]
                       * (r2[mg + i] - (-S.mu[i] * S.wk[i] + S.valid[i] * wf));
      }
    }
    if (dnu)
      for (int k = tid; k < q; k += nt) dnu[k] = S.wk[kq + k];
    if (dz)
      for (int j = tid; j < n; j += nt) {
        T acc = T(0);
        for (int k = 0; k < K; ++k) acc += Gh[k * n + j] * S.wk[k];
        dz[j] = S.qinv[j] * (S.r1[j] - acc);
      }
    __syncthreads();
  }

  // The Schur system S of the scaling d_inv, formed in S.S, with its
  // diagonal dmain and band coefficients kept for apply_S_row.
  __device__ void assemble() {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int i = tid; i < C; i += nt) {
      const T Dg = T(1) / (S.d_inv[mg + i] + a.reg);
      const T cn = S.valid[i] * S.mu[i] * Dg;
      const T cf = -S.valid[i] * Dg;
      S.Dginv[i] = Dg;
      S.cn[i] = cn;
      if constexpr (ROT) {
        const T a1 = -(S.d_inv[C + i] + a.reg) + cf;
        const T a2 = -(S.d_inv[2 * C + i] + a.reg) + cf;
        const T alpha_r = T(0.5) * (a1 + a2);
        const T delta = T(0.5) * (a1 - a2);
        const T g_u = alpha_r + cf;
        S.delta[i] = delta;
        S.g_u[i] = g_u;
        S.dmain[i] = S.d_inv[i] + a.reg;
        S.dmain[C + i] = -(alpha_r - cf - delta * delta / g_u);
        S.bn[i] = -sq2 * cn * delta / g_u;
      } else {
        S.cf[i] = cf;
      }
    }
    if constexpr (ROT) {
      for (int k = tid; k < q; k += nt) S.dmain[2 * C + k] = a.reg;
    } else {
      for (int k = tid; k < K; k += nt)
        S.dmain[k] = k < mg ? S.d_inv[k] + a.reg : a.reg;
    }
    __syncthreads();
    for (int e = tid; e < K * K; e += nt) {
      const int i = e / K, j = e - (e / K) * K;
      T v = -S.P[e];
      if (i == j) v = v - S.dmain[j];
      if constexpr (ROT) {
        if (i - C == j && j < C) v = v + S.bn[j];
      } else {
        if (i >= C && i < mg) {
          const int ci = (i - C) % C;
          if (j == ci) v = v + S.cn[ci];
          if (j >= C && j < mg && (j - C) % C == ci) v = v + S.cf[ci];
        }
      }
      S.S[e] = v;
    }
    __syncthreads();
  }

  // min(1, largest alpha keeping s + alpha ds, lam + alpha dlam >= 0 on
  // real rows)
  __device__ T max_step(const T* ds, const T* dl) {
    const T inf = T(INFINITY);
    T r = inf;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      if (S.rmask[i] > T(0)) {
        if (ds[i] < T(0)) r = fmin(r, -S.s[i] / ds[i]);
        if (dl[i] < T(0)) r = fmin(r, -S.lam[i] / dl[i]);
      }
    }
    r = block_reduce(r, S.red, MinOp());
    return r < T(1) ? r : T(1);
  }

  __device__ void run() {
    const int tid = threadIdx.x, nt = blockDim.x;
    const T big = (sizeof(T) == 8 ? T(1.7976931348623157e308)
                                  : T(3.4028234663852886e38)) / T(8);
    T best_merit = big, stall = T(0);
    int iters = a.max_iter;
    const int lim = a.not_improved_lim;
    T mu_c, resid;
    for (int it = 0; it < a.max_iter; ++it) {
      measures(mu_c, resid);
      const T merit = mu_c + resid;
      const bool improved = merit < best_merit;
      if (improved) {
        copy_vec(S.bz, S.z, n);
        copy_vec(S.bs, S.s, m);
        copy_vec(S.blam, S.lam, m);
        copy_vec(S.bnu, S.nu, q);
      }
      const bool sig = a.stall_rtol > T(0)
                           ? merit < best_merit * (T(1) - a.stall_rtol)
                           : improved;
      best_merit = nmin(merit, best_merit);
      stall = sig ? T(0) : stall + T(1);
      const bool stalled = lim > 0 && stall >= T(lim) && it >= lim + 2;
      if (merit < a.tol || stalled) {
        iters = it;  // done: frozen from here on
        break;
      }

      // ---- Schur assembly + in-place Gauss-Jordan inverse -------------
      for (int r = tid; r < m; r += nt) {
        const T ls = nmax(S.lam[r], a.tiny);
        S.lam_safe[r] = ls;
        S.d_inv[r] = clip(S.s[r] / ls, a.dinv_min, a.dinv_max);
      }
      __syncthreads();
      assemble();
      for (int k = 0; k < K; ++k) {
        for (int j = tid; j < K; j += nt) {
          S.rowbuf[j] = S.S[k * K + j];
          S.colbuf[j] = S.S[j * K + k];
        }
        __syncthreads();
        const T dinv = safe_inv(S.rowbuf[k]);
        for (int e = tid; e < K * K; e += nt) {
          const int i = e / K, j = e - (e / K) * K;
          T v;
          if (i == k && j == k) v = dinv;
          else if (i == k) v = S.rowbuf[j] * dinv;
          else if (j == k) v = -S.colbuf[i] * dinv;
          else v = S.S[e] - S.colbuf[i] * (S.rowbuf[j] * dinv);
          S.S[e] = v;
        }
        __syncthreads();
      }

      // ---- predictor -------------------------------------------------
      for (int j = tid; j < n; j += nt) {
        S.r1[j] = -S.rx[j];
        S.tn[j] = S.qinv[j] * S.r1[j];
      }
      for (int r = tid; r < m; r += nt)
        S.r2[r] = -S.rz[r] + (S.s[r] * S.lam[r]) / S.lam_safe[r];
      for (int k = tid; k < q; k += nt) S.ryn[k] = -S.ry[k];
      __syncthreads();
      for (int k = tid; k < K; k += nt) {  // Ghat (qinv r1), shared by both solves
        T acc = T(0);
        for (int j = 0; j < n; ++j) acc += Gh[k * n + j] * S.tn[j];
        S.y1[k] = acc;
      }
      __syncthreads();
      kkt_solve(nullptr, S.dlam_a, nullptr);
      for (int r = tid; r < m; r += nt)
        S.ds_a[r] = -(S.s[r] * S.lam[r]) / S.lam_safe[r] - S.d_inv[r] * S.dlam_a[r];
      __syncthreads();
      const T alpha_a = max_step(S.ds_a, S.dlam_a);
      T part = T(0);
      for (int r = tid; r < m; r += nt)
        if (S.rmask[r] > T(0))
          part += (S.s[r] + alpha_a * S.ds_a[r]) * (S.lam[r] + alpha_a * S.dlam_a[r]);
      const T mu_aff = block_reduce(part, S.red, SumOp()) / rcount;
      const T sg = clip(mu_aff / nmax(mu_c, a.tiny), T(0), T(1));
      const T sigma = sg * sg * sg;

      // ---- corrector -------------------------------------------------
      for (int r = tid; r < m; r += nt) {
        const T r4c = S.s[r] * S.lam[r] + S.ds_a[r] * S.dlam_a[r] - sigma * mu_c;
        S.r4c[r] = r4c;
        S.r2[r] = -S.rz[r] + r4c / S.lam_safe[r];
      }
      __syncthreads();
      kkt_solve(S.dz, S.dlam, S.dnu);
      for (int r = tid; r < m; r += nt)
        S.ds[r] = -S.r4c[r] / S.lam_safe[r] - S.d_inv[r] * S.dlam[r];
      __syncthreads();
      const T alpha = T(0.99) * max_step(S.ds, S.dlam);

      // new iterate into the direction arrays, committed if all finite
      T bad = T(0);
      for (int j = tid; j < n; j += nt) {
        const T v = S.z[j] + alpha * S.dz[j];
        S.dz[j] = v;
        if (!isfinite(v)) bad = T(1);
      }
      for (int r = tid; r < m; r += nt) {
        const bool real = S.rmask[r] > T(0);  // padded rows pinned
        const T sn = real ? nmax(S.s[r] + alpha * S.ds[r], a.tiny) : S.h[r];
        const T ln = real ? nmax(S.lam[r] + alpha * S.dlam[r], a.tiny) : a.tiny;
        if (!isfinite(sn) || !isfinite(ln)) bad = T(1);
        S.ds[r] = sn;
        S.dlam[r] = ln;
      }
      for (int k = tid; k < q; k += nt) S.dnu[k] = S.nu[k] + alpha * S.dnu[k];
      if (block_reduce(bad, S.red, MaxOp()) > T(0)) break;  // halt, frozen
      copy_vec(S.z, S.dz, n);
      copy_vec(S.s, S.ds, m);
      copy_vec(S.lam, S.dlam, m);
      copy_vec(S.nu, S.dnu, q);
      __syncthreads();
    }

    // return the best iterate seen (non-monotone tails)
    measures(mu_c, resid);
    if (best_merit < mu_c + resid) {
      copy_vec(S.z, S.bz, n);
      copy_vec(S.s, S.bs, m);
      copy_vec(S.lam, S.blam, m);
      copy_vec(S.nu, S.bnu, q);
      __syncthreads();
    }
    measures(mu_c, resid);
    const size_t w = blockIdx.x;
    for (int j = tid; j < n; j += nt) a.z[w * n + j] = S.z[j];
    for (int r = tid; r < m; r += nt) {
      a.s[w * m + r] = S.s[r];
      a.lam[w * m + r] = S.lam[r];
    }
    for (int k = tid; k < q; k += nt) a.nu[w * q + k] = S.nu[k];
    if (tid == 0) {
      a.mu_out[w] = mu_c;
      a.resid[w] = resid;
      a.iters[w] = iters;
    }
  }
};

template <typename T, bool ROT>
__global__ void __launch_bounds__(256) fused_ipm_kernel(IpmArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, m = a.m, q = a.q, C = a.C;
  const int K = schur_rows(C, a.fd, q, ROT);
  Smem<T> S;
  carve<T>(&S, reinterpret_cast<T*>(smem_raw), n, m, q, C, K, a.ghat_smem);
  const size_t w = blockIdx.x;
  copy_vec(S.P, a.P + w * K * K, K * K);
  if (a.ghat_smem) copy_vec(S.Gh, a.Ghat + w * K * n, K * n);
  copy_vec(S.qinv, a.qinv + w * n, n);
  copy_vec(S.p, a.p + w * n, n);
  copy_vec(S.h, a.h + w * m, m);
  copy_vec(S.rmask, a.rmask + w * m, m);
  copy_vec(S.b, a.b + w * q, q);
  copy_vec(S.mu, a.mu + w * C, C);
  copy_vec(S.valid, a.valid + w * C, C);
  copy_vec(S.z, a.z0 + w * n, n);
  copy_vec(S.bz, a.z0 + w * n, n);
  copy_vec(S.s, a.s0 + w * m, m);
  copy_vec(S.bs, a.s0 + w * m, m);
  copy_vec(S.lam, a.lam0 + w * m, m);
  copy_vec(S.blam, a.lam0 + w * m, m);
  copy_vec(S.nu, a.nu0 + w * q, q);
  copy_vec(S.bnu, a.nu0 + w * q, q);
  __syncthreads();
  T cnt = T(0);
  for (int j = threadIdx.x; j < n; j += blockDim.x) S.qd[j] = T(1) / S.qinv[j];
  for (int r = threadIdx.x; r < m; r += blockDim.x) cnt += S.rmask[r];
  cnt = block_reduce(cnt, S.red, SumOp());
  __syncthreads();
  const int mg = m - C;
  Ipm<T, ROT> ipm{a, S, a.ghat_smem ? S.Gh : a.Ghat + w * K * n,
                  n, m, q, C, a.fd, K, mg, ROT ? 2 * C : mg,
                  sqrt(T(2)), cnt > T(1) ? cnt : T(1)};
  ipm.run();
}

template <typename T>
static size_t smem_bytes(int n, int m, int q, int C, int fd, int rot,
                         int ghat_smem) {
  return carve<T>(nullptr, nullptr, n, m, q, C, schur_rows(C, fd, q, rot),
                  ghat_smem) * sizeof(T);
}

// The wrapper (ops/ipm.py) checks the size against the card's limit and
// decides whether Ghat fits in shared memory (a.ghat_smem).
template <typename T, bool ROT>
static int launch(IpmArgs<T> a, int B, void* stream) {
  clear_last_error();
  const size_t smem = smem_bytes<T>(a.n, a.m, a.q, a.C, a.fd, ROT, a.ghat_smem);
  cudaError_t e = cudaFuncSetAttribute(
      fused_ipm_kernel<T, ROT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int rows = a.n > a.m ? a.n : a.m;
  const int K = schur_rows(a.C, a.fd, a.q, ROT);
  rows = rows > K ? rows : K;
  int threads = (rows + 31) / 32 * 32;
  threads = threads > 256 ? 256 : threads;
  if (B > 0)
    fused_ipm_kernel<T, ROT><<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#define LCP_FUSED_IPM_ENTRY(NAME, T)                                          \
  int NAME(const T* P, const T* Ghat, const T* qinv, const T* p, const T* h,  \
           const T* b, const T* mu, const T* valid, const T* rmask,           \
           const T* z0, const T* s0, const T* lam0, const T* nu0, T* z, T* s, \
           T* lam, T* nu, T* mu_out, T* resid, int* iters, int B, int n,      \
           int m, int q, int C, int fd, int rot, int max_iter, double tol,    \
           double tiny, double reg, double dinv_min, double dinv_max,         \
           int not_improved_lim, double stall_rtol, int ghat_smem,           \
           void* stream) {                                                    \
    IpmArgs<T> a{P,  Ghat, qinv,  p,   h,      b,     mu,    valid,          \
                 rmask, z0, s0,   lam0, nu0,   z,     s,     lam,            \
                 nu, mu_out, resid, iters, n, m, q, C, fd, max_iter,          \
                 not_improved_lim, ghat_smem, T(tol), T(tiny), T(reg),        \
                 T(dinv_min), T(dinv_max), T(stall_rtol)};                    \
    return rot ? launch<T, true>(a, B, stream)                                \
               : launch<T, false>(a, B, stream);                              \
  }

extern "C" {
LCP_FUSED_IPM_ENTRY(lcp_fused_ipm_f32, float)
LCP_FUSED_IPM_ENTRY(lcp_fused_ipm_f64, double)

// Shared memory one world needs (Ghat in shared memory or not).
long long lcp_fused_ipm_smem_bytes(int n, int m, int q, int C, int fd,
                                   int rot, int f64, int ghat_smem) {
  return f64 ? (long long)smem_bytes<double>(n, m, q, C, fd, rot, ghat_smem)
             : (long long)smem_bytes<float>(n, m, q, C, fd, rot, ghat_smem);
}
}
